"""Kernel-launch runtime calls a depther batch (``_spans.KERNEL_LAUNCHES``)
started inside the program's span ``dgtd.depther``, on any thread."""

from benchmark.metrics._spans import calls, is_kernel_launch


def read(run):
    if run.cell.mode != "depth":
        return None
    return calls(run, "dgtd.depther", is_kernel_launch)
