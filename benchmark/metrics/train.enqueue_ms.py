"""Host wall time (ms) of one train step (the batch's copy and
``train_step``), begun after the card is synchronised; the median of a
traced run's calls."""

from benchmark.metrics._common import median


def read(run):
    return median(run, "train_enqueue_ms")
