"""% of the traced window in which no operation ran on the card: the
union of the profiler's device intervals, overlaps counted once."""

from benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run, "depth")
