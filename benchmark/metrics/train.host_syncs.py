"""Blocking runtime calls a train step (a synchronize of stream, device or
event, or a ``cudaMemcpy`` that is not ``Async``) started inside the
program's span ``dgtd.train.step``, on any thread."""

from benchmark.metrics._spans import calls, is_host_sync


def read(run):
    return calls(run, "dgtd.train.step", is_host_sync)
