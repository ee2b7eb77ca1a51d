"""Blocking runtime calls a depther batch (a synchronize, a ``cudaMemcpy``
that is not ``Async``) started inside the program's span ``dgtd.depther``,
on any thread: 0 where the batched call enqueues without waiting."""

from benchmark.metrics._spans import calls, is_host_sync


def read(run):
    if run.cell.mode != "depth":
        return None
    return calls(run, "dgtd.depther", is_host_sync)
