"""Device ms a served batch of the operations launched inside the program's
span ``dgtd.decode`` (HitNet's decoder: CIM, translayers, the refinement
iterations, SAM), their intervals united (``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "dgtd.decode")
