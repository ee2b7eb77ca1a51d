"""The port's ops: what ``dgtd_tpu/ops/__init__.py`` exports, under the
port's names, and the LayerNorm."""

from .diffusion import (  # noqa: F401
    diffusion_nhwc,
    diffusion_nhwc_tap_major,
    diffusion_planes,
    to_tap_major,
)
from .layernorm import layer_norm  # noqa: F401
from .msda import (  # noqa: F401
    MSDeformAttn,
    MSDeformAttnFn,
    ms_deform_attn,
    ms_deform_attn_fwd,
    ms_deform_attn_plain,
)
