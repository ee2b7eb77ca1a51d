"""Device ms a train step of the operations launched inside the program's span
``dgtd.train.backward`` (``loss.backward()``), on any thread: on CUDA the
kernels are launched from autograd's device thread while the step's thread
waits inside the span (``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "dgtd.train.backward")
