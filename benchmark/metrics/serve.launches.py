"""Kernel-launch runtime calls a served batch (``_spans.KERNEL_LAUNCHES``)
started inside the program's span ``dgtd.predict``, on any thread."""

from benchmark.metrics._spans import calls, is_kernel_launch


def read(run):
    return calls(run, "dgtd.predict", is_kernel_launch)
