"""HitNet: prompt-injected PVTv2 + the iterative refinement decoder
(counterpart of ``dgtd_tpu/models/hitnet.py``).

All refinement iterations share the decoder modules. Keys follow the
reference's ``Hitnet`` (``Translayer2_0``, ``decoder_level1``, ``SAM``, ...).
``DQnet`` (``models/dqnet.py``) runs the same decoder over its own backbone.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.trace import span
from ..utils.image import resize_bilinear
from .diffusion import PromptDecoder, PromptEncoder
from .layers import BasicConv2d, CABStack, SAMFusion, conv2d
from .pvt import PVT_V2_CONFIGS, PVTv2


class HitNetDecoder(nn.Module):
    """The decoder over the four PVT stage maps: CIM, translayers, the
    ``refine_iters`` refinement iterations and the SAM fusion. A subclass
    builds its backbone, then calls :meth:`build_decoder`, and decodes with
    :meth:`decode`; the decoder's keys sit beside the backbone's."""

    def build_decoder(self, dims: Sequence[int], channel: int, refine_iters: int) -> None:
        ch = channel
        self.refine_iters = refine_iters
        self.decoder_level1 = CABStack(dims[0])
        self.Translayer2_0 = BasicConv2d(dims[0], ch, 1)
        self.Translayer2_1 = BasicConv2d(dims[1], ch, 1)
        self.Translayer3_1 = BasicConv2d(dims[2], ch, 1)
        self.Translayer4_1 = BasicConv2d(dims[3], ch, 1)
        self.decoder_level4 = CABStack(ch)
        self.decoder_level3 = CABStack(2 * ch)
        self.decoder_level2 = CABStack(3 * ch)
        self.conv4 = BasicConv2d(3 * ch, ch, 3, padding=1)
        self.compress_out = BasicConv2d(2 * ch, ch, 8, stride=4, padding=2)
        self.compress_out2 = BasicConv2d(2 * ch, ch, 1)
        self.out_CFM = conv2d(ch, 1, 1)
        self.SAM = SAMFusion(ch)
        self.out_SAM = conv2d(ch, 1, 1)

    def decode(self, image, x1, x2, x3, x4, heights=None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Stage maps (strides 4/8/16/32) -> ([refine_iters stage logits],
        second logits), at the image's resolution. ``heights``: the global
        heights of (image, x1, x2, x3, x4) under a data×space layout (their
        own by default); every resize targets a global size."""
        H, h1, h2, h3, h4 = heights or [t.shape[-2] for t in (image, x1, x2, x3, x4)]
        cim = self.decoder_level1(x1, h1)
        x2_t = self.Translayer2_1(x2, h2)
        x3_t = self.Translayer3_1(x3, h3)
        x4_t = self.Translayer4_1(x4, h4)
        s8, s16 = (h2, x2.shape[-1]), (h3, x3.shape[-1])
        full = (H, image.shape[-1])

        stage_preds: List[torch.Tensor] = []
        cfm = None
        for it in range(self.refine_iters):
            if cfm is not None:
                x4_up = resize_bilinear(x4_t, s8, align_corners=True, exact=False, in_h=h4)
                x4_t = self.compress_out(torch.cat([x4_up, cfm], dim=1), h2)
                # compress_out's output rows need not be x4's
                h4 = self.compress_out.conv.out_rows(h2)
            x4_f = self.decoder_level4(x4_t, h4)
            x3_f = self.decoder_level3(
                torch.cat([x3_t, resize_bilinear(x4_f, s16, align_corners=True, exact=False, in_h=h4)], dim=1), h3)
            if it > 0:
                x2_t = self.compress_out2(torch.cat([x2_t, cfm], dim=1), h2)
            x2_f = self.decoder_level2(
                torch.cat([x2_t, resize_bilinear(x3_f, s8, align_corners=True, exact=False, in_h=h3)], dim=1), h2)
            cfm = self.conv4(x2_f, h2)
            stage_preds.append(resize_bilinear(self.out_CFM(cfm), full, in_h=h2))

        t2 = self.Translayer2_0(cim, h1)
        t2 = resize_bilinear(t2, s8, align_corners=True, exact=False, in_h=h1)
        pred2 = resize_bilinear(self.out_SAM(self.SAM(cfm, t2, h2)), full, in_h=h2)
        return stage_preds, pred2


class HitNet(HitNetDecoder):
    """forward(image, depth) NCHW -> (texture, [refine_iters stage logits],
    second logits), all at the input resolution. Train or eval follows the
    module's mode (BatchNorm statistics, DropPath); ``drop_path_rate`` (PVT)
    and ``convnext_drop_path_rate`` are the recipe's 0.1 and 0.4.

    The ablation axes of ``docs/ABLATIONS.md``: ``use_prompts=False`` builds
    no prompt modules (plain HitNet, texture None); ``inject_prompts=False``
    builds them, so that their keys exist (``baseline``'s checkpoints hold
    them), and runs none of them: texture None, no stencil, and their
    parameters get no gradient. ``fft_at_grid`` and the diffusion settings
    go to the prompt encoder, ``remat`` to the PVT and ConvNeXt blocks."""

    def __init__(self, channel=32, variant="b2", latent_dim=24, grid=12, freq_rate=0.3,
                 diffusion_kernel=7, diffusion_steps=4, fft_at_grid=False,
                 convnext_dims=(128, 256, 512, 1024), convnext_depths=(3, 3, 27, 3), remat=False,
                 refine_iters=4, use_prompts=True, inject_prompts=True,
                 drop_path_rate=0.1, convnext_drop_path_rate=0.4):
        super().__init__()
        dims, _, _, depths, _ = PVT_V2_CONFIGS[variant]
        self.use_prompts = use_prompts
        self.inject_prompts = inject_prompts
        self.fft_at_grid = fft_at_grid
        prompt_encoder = prompt_decoder = None
        if use_prompts:
            prompt_encoder = PromptEncoder(latent_dim, grid, freq_rate, diffusion_kernel, diffusion_steps,
                                           fft_at_grid, convnext_dims, convnext_depths, convnext_drop_path_rate,
                                           remat)
            prompt_decoder = nn.ModuleList(PromptDecoder(dims[s], depths[s], latent_dim) for s in range(4))
        self.backbone = PVTv2(variant, prompt_encoder=prompt_encoder, prompt_decoder=prompt_decoder,
                              drop_path_rate=drop_path_rate, remat=remat)
        self.build_decoder(dims, channel, refine_iters)

    def forward(self, image, depth, H=None):
        """``H``: the image's global height under a data×space layout
        (``parallel/space.py``), where image and depth are this rank's
        bands and so are the outputs."""
        bb = self.backbone
        H = image.shape[-2] if H is None else H
        texture = prompts = prompt_h = None
        if self.use_prompts and self.inject_prompts:
            with span("dgtd.prompt_encoder"):
                texture, embedding = bb.prompt_encoder(image, depth, H)
            prompt_h = bb.prompt_encoder.encoder2.out_rows(H)
            with span("dgtd.prompt_decoders"):
                prompts = [dec(embedding, prompt_h) for dec in bb.prompt_decoder]
        with span("dgtd.backbone"):
            outs = bb(image, prompts, H, prompt_h)
        with span("dgtd.decode"):
            stage_preds, pred2 = self.decode(image, *outs, heights=[H, *bb.heights(H)])
        return texture, stage_preds, pred2
