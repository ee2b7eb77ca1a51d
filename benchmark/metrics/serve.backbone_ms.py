"""Device ms a served batch of the operations launched inside the program's
span ``dgtd.backbone`` (the PVTv2-b2 stages, the prompts added), their
intervals united (``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "dgtd.backbone")
