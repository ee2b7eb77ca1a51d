"""% of roofline of the fused diffusion-stencil forward kernel in a served
batch: its bound from the call shapes over its device time, by kernel name
in the profiler's trace."""

from benchmark.metrics._common import stencil_roofline


def read(run):
    return stencil_roofline(run, "serve", ("fwd",))
