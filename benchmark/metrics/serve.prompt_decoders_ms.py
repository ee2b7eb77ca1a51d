"""Device ms a served batch of the operations launched inside the program's
span ``dgtd.prompt_decoders`` (``cod``'s 28 prompt decoders), their
intervals united (``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "dgtd.prompt_decoders")
