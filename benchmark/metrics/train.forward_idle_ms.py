"""The device's idle ms a train step inside the host intervals of the
program's span ``dgtd.train.forward``: what the card waited for while the
host ran the forward and the losses (``_spans.idle_ms``)."""

from benchmark.metrics._spans import idle_ms


def read(run):
    return idle_ms(run, "dgtd.train.forward")
