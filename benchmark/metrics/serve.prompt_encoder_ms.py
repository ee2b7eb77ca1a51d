"""Device ms a served batch of the kernels of the prompt encoder (texture,
affinities, stencil, ConvNeXt tower): the operations the profiler puts in
the range that ``drivers/serve.py`` opens in a forward pre-hook on
``hitnet.backbone.prompt_encoder`` and closes in its forward hook."""

from benchmark.drivers.serve import PROMPT_ENCODER_RANGE


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.range_device_s(PROMPT_ENCODER_RANGE)
    return None if not secs else secs * 1e3 / run.trace.units
