"""Host wall time (ms) of one served batch's sequence up to its map's
copy enqueued, begun after the card is synchronised; the median of a
traced run's calls."""

from benchmark.metrics._common import median


def read(run):
    return median(run, "serve_enqueue_ms")
