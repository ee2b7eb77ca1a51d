"""% of roofline of the fused diffusion-stencil kernels in a train step:
the forward's and the backward's bounds from their call shapes over their
device time, by kernel name in the profiler's trace."""

from benchmark.metrics._common import stencil_roofline


def read(run):
    return stencil_roofline(run, "train", ("fwd", "bwd"))
