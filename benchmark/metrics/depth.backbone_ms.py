"""Device ms a depther batch of the operations launched inside the program's
span ``dgtd.depther.backbone`` (centre padding, patch embedding, position
resize and the 24 DINOv2 blocks), their intervals united
(``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    if run.cell.mode != "depth":
        return None
    return device_ms(run, "dgtd.depther.backbone")
