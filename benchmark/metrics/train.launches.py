"""Kernel-launch runtime calls a train step (``_spans.KERNEL_LAUNCHES``)
started inside the program's span ``dgtd.train.step``, on any thread."""

from benchmark.metrics._spans import calls, is_kernel_launch


def read(run):
    return calls(run, "dgtd.train.step", is_kernel_launch)
