"""Device ms a train step of the operations launched inside the program's span
``dgtd.train.forward`` (``model.loss``: the train forward and its losses),
on any thread, their intervals united (``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "dgtd.train.forward")
