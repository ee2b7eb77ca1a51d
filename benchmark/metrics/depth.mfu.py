"""% of the H100's 989 TFLOP/s bf16 dense peak: the depther's forward
FLOPs an image (counted on the reference) times the traced images over
the traced window."""

from benchmark.metrics._common import mfu


def read(run):
    return mfu(run, "depth", "forward")
