"""Device ms a step of the optimizer instance's ``step`` (clipping, AdamW,
clearing the gradients): the operations the profiler puts in the range
that ``drivers/train.py`` opens around it in a traced run, their intervals
united, over the traced steps."""

from benchmark.drivers.train import OPTIMIZER_RANGE


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.range_device_s(OPTIMIZER_RANGE)
    return None if not secs else secs * 1e3 / run.trace.units
