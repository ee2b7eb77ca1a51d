"""DQnet, the earlier depth-prompt model (counterpart of
``dgtd_tpu/models/dqnet.py``).

HitNet's decoder on a PVTv2 whose blocks take *depth adapter* prompts in
place of texture diffusion: the depth map is resized bilinearly to a fixed
``cross_size`` grid (44), each stage's ``DepthPrompt`` maps it to one
prompt a block (Linear ``depth_adapter`` 1 -> C/2, a ``lightweight_mlp_{i}``
C/2 -> C/2 with exact GELU per block, a shared Linear C/2 -> C), and
``PVTv2.forward`` resizes each prompt to its stage grid and adds it to the
tokens. The loss is the staged BCE+IoU only; there is no texture.

The reference's ``Depth_prompt.forward`` uses an undefined ``prompt`` (its
``lightweight_mlp`` line is commented out), so it crashes if run; like the
JAX package, this restores the evident intent,
``prompt_i = shared_mlp(gelu(lightweight_mlp_i(depth_adapter(depth))))``.
Keys follow the JAX package's tree: ``backbone`` (PVTv2) and
``depth_generator{s}`` at top level, the decoder under HitNet's names.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import MODELS
from ..utils.image import resize_bilinear
from .cod import SegModel
from .hitnet import HitNetDecoder
from .layers import linear
from .pvt import PVT_V2_CONFIGS, PVTv2


class DepthPrompt(nn.Module):
    """One stage's depth prompts: NHWC depth cues (B, g, g, 1) -> ``depth``
    NHWC prompts (B, g, g, embed_dim)."""

    def __init__(self, embed_dim: int, depth: int, scale_factor: int = 2):
        super().__init__()
        hidden = embed_dim // scale_factor
        self.depth = depth
        self.depth_adapter = linear(1, hidden)
        for i in range(depth):
            setattr(self, f"lightweight_mlp_{i}", linear(hidden, hidden))
        self.shared_mlp = linear(hidden, embed_dim)

    def forward(self, cues) -> List[torch.Tensor]:
        adapted = self.depth_adapter(cues)
        return [self.shared_mlp(F.gelu(getattr(self, f"lightweight_mlp_{i}")(adapted))) for i in range(self.depth)]


class DQnetNet(HitNetDecoder):
    """forward(image, depth) NCHW -> (None, [4 stage logits], second logits)."""

    def __init__(self, variant: str = "b2", channel: int = 32, cross_size: int = 44):
        super().__init__()
        dims, _, _, depths, _ = PVT_V2_CONFIGS[variant]
        self.cross_size = cross_size
        for s in range(4):
            setattr(self, f"depth_generator{s}", DepthPrompt(dims[s], depths[s]))
        self.backbone = PVTv2(variant)
        self.build_decoder(dims, channel, refine_iters=4)

    def forward(self, image, depth):
        g = self.cross_size
        cues = resize_bilinear(depth, (g, g)).permute(0, 2, 3, 1)
        prompts = [[p.permute(0, 3, 1, 2) for p in getattr(self, f"depth_generator{s}")(cues)] for s in range(4)]
        stage_preds, pred2 = self.decode(image, *self.backbone(image, prompts))
        return None, stage_preds, pred2


@MODELS.register
class DQnet(SegModel, DQnetNet):
    """The registered depth-prompt model: ``variant``, ``channel`` and
    ``cross_size`` are its settings; the reference's recipe keys are
    accepted and unused; any other key raises ``TypeError`` (a typo would
    otherwise train a default model)."""

    use_ssim = False
    _IGNORED = ("filter_ratio", "using_depth", "using_sam", "finetune", "binary_thresh", "pretrain_sam", "head")
    _SETTINGS = ("variant", "channel", "cross_size")

    def __init__(self, dtype: torch.dtype = torch.bfloat16, seed=0, win_size=None, **kwargs: Any):
        unknown = set(kwargs) - set(self._SETTINGS) - set(self._IGNORED)
        if unknown:
            raise TypeError(f"DQnet: unknown model args {sorted(unknown)}")
        DQnetNet.__init__(self, **{k: v for k, v in kwargs.items() if k in self._SETTINGS})
        self.finish_init(dtype, seed)
