"""Device ms a depther batch of the operations launched inside the program's
span ``dgtd.depther.head`` (the DPT head's reassembly and fusion, the
expectation over the bins in fp32, the resize to the input), their
intervals united (``_spans.device_ms``)."""

from benchmark.metrics._spans import device_ms


def read(run):
    if run.cell.mode != "depth":
        return None
    return device_ms(run, "dgtd.depther.head")
