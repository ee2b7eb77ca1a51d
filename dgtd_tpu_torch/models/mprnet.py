"""The MPRNet block family the reference carries (counterpart of
``dgtd_tpu/models/mprnet.py``): the resizers, the 3-level CAB encoder and
decoder, and the original-resolution subnetwork. No recipe reaches them (the
reference's one use is commented out), so no checkpoint holds their keys;
the keys follow MPRNet's own modules.

NCHW. MPRNet's ``nn.Upsample(scale_factor=…)`` resizes become
``resize_scale``: the same output size, floor(size·scale), with the
source indices of a resize to that size, as the JAX package computes them.

Under a data×space layout (``parallel/space.py``) every map is this rank's
band and each ``forward`` takes ``h``, the global height of its input's
level, as ``CAB`` does; a level's global height after x0.5 is
floor(h/2). The x0.5 resize of an even band runs on the band, the x2 one
on the gathered level (``utils/image.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..utils.image import resize_scale
from .layers import CAB, CABStack, conv2d


def _scaled(h: Optional[int], scale: float) -> Optional[int]:
    """The global height of a level of ``h`` rows resized by ``scale``
    (None stays None)."""
    return None if h is None else int(np.floor(h * scale))


class _Scale(nn.Module):
    """Bilinear resize by ``scale`` (no parameters)."""

    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x, h=None):
        return resize_scale(x, self.scale, in_h=h)


class DownSample(nn.Module):
    """x0.5 bilinear, then a 1x1 conv widening ``in_channels`` by ``s_factor``."""

    def __init__(self, in_channels: int, s_factor: int = 32):
        super().__init__()
        self.down = nn.Sequential(_Scale(0.5), conv2d(in_channels, in_channels + s_factor, 1, bias=False))

    def forward(self, x, h=None):
        scale, conv = self.down
        return conv(scale(x, h))


class UpSample(nn.Module):
    """x2 bilinear, then a 1x1 conv narrowing ``in_channels + s_factor`` to
    ``in_channels``."""

    def __init__(self, in_channels: int, s_factor: int = 32):
        super().__init__()
        self.up = nn.Sequential(_Scale(2.0), conv2d(in_channels + s_factor, in_channels, 1, bias=False))

    def forward(self, x, h=None):
        scale, conv = self.up
        return conv(scale(x, h))


class SkipUpSample(UpSample):
    """:class:`UpSample`, plus the skip."""

    def forward(self, x, skip, h=None):
        return super().forward(x, h) + skip


def _up_chain(ups: nn.Sequential, x, h=None):
    """``ups``' :class:`UpSample` s in turn, each at its input's height."""
    for up in ups:
        x = up(x, h)
        h = _scaled(h, 2.0)
    return x


class Encoder(nn.Module):
    """3-level CAB encoder on ``n_feat`` channels, widening by
    ``scale_unetfeats`` a level; with ``csff`` it adds 1x1 convs of the
    previous stage's encoder and decoder features. Returns the three
    levels' features."""

    def __init__(self, n_feat: int, kernel: int = 3, reduction: int = 4, bias: bool = False,
                 scale_unetfeats: int = 32, csff: bool = False):
        super().__init__()
        widths = [n_feat + i * scale_unetfeats for i in range(3)]
        for i, c in enumerate(widths):
            setattr(self, f"encoder_level{i + 1}", CABStack(c, 2, kernel, reduction, bias))
        self.down12 = DownSample(widths[0], scale_unetfeats)
        self.down23 = DownSample(widths[1], scale_unetfeats)
        self.csff = csff
        if csff:
            for i, c in enumerate(widths):
                setattr(self, f"csff_enc{i + 1}", conv2d(c, c, 1, bias=bias))
                setattr(self, f"csff_dec{i + 1}", conv2d(c, c, 1, bias=bias))

    def forward(self, x, encoder_outs: Optional[Sequence[torch.Tensor]] = None,
                decoder_outs: Optional[Sequence[torch.Tensor]] = None, h: Optional[int] = None
                ) -> List[torch.Tensor]:
        fuse = encoder_outs is not None and decoder_outs is not None
        outs: List[torch.Tensor] = []
        for level in range(3):
            x = getattr(self, f"encoder_level{level + 1}")(x, h)
            if fuse:
                x = (x + getattr(self, f"csff_enc{level + 1}")(encoder_outs[level])
                     + getattr(self, f"csff_dec{level + 1}")(decoder_outs[level]))
            outs.append(x)
            if level < 2:
                x = getattr(self, f"down{level + 1}{level + 2}")(x, h)
                h = _scaled(h, 0.5)
        return outs


class Decoder(nn.Module):
    """3-level CAB decoder with attended skips: the encoder's [enc1, enc2,
    enc3] -> [dec1, dec2, dec3]."""

    def __init__(self, n_feat: int, kernel: int = 3, reduction: int = 4, bias: bool = False,
                 scale_unetfeats: int = 32):
        super().__init__()
        widths = [n_feat + i * scale_unetfeats for i in range(3)]
        for i, c in enumerate(widths):
            setattr(self, f"decoder_level{i + 1}", CABStack(c, 2, kernel, reduction, bias))
        self.skip_attn1 = CAB(widths[0], kernel, reduction, bias)
        self.skip_attn2 = CAB(widths[1], kernel, reduction, bias)
        self.up21 = SkipUpSample(widths[0], scale_unetfeats)
        self.up32 = SkipUpSample(widths[1], scale_unetfeats)

    def forward(self, outs: Sequence[torch.Tensor], h: Optional[int] = None) -> List[torch.Tensor]:
        """``h``: enc1's global height under a data×space layout."""
        enc1, enc2, enc3 = outs
        h2 = _scaled(h, 0.5)
        h3 = _scaled(h2, 0.5)
        dec3 = self.decoder_level3(enc3, h3)
        dec2 = self.decoder_level2(self.up32(dec3, self.skip_attn2(enc2, h2), h3), h2)
        dec1 = self.decoder_level1(self.up21(dec2, self.skip_attn1(enc1, h), h2), h)
        return [dec1, dec2, dec3]


class ORB(nn.Module):
    """Original-resolution block: ``num_cab`` CABs and a k x k conv, plus the
    residual."""

    def __init__(self, n_feat: int, kernel: int = 3, reduction: int = 4, bias: bool = False, num_cab: int = 8):
        super().__init__()
        self.body = nn.Sequential(*[CAB(n_feat, kernel, reduction, bias) for _ in range(num_cab)],
                                  conv2d(n_feat, n_feat, kernel, padding=kernel // 2, bias=False))

    def forward(self, x, h=None):
        y = x
        for m in self.body:
            y = m(y, h)
        return y + x


class ORSNet(nn.Module):
    """Original-resolution subnetwork: 3 ORBs on ``n_feat +
    scale_orsnetfeats`` channels, each followed by 1x1 convs of the encoder's
    and decoder's features upsampled to the input's resolution."""

    def __init__(self, n_feat: int, scale_orsnetfeats: int, kernel: int = 3, reduction: int = 4,
                 bias: bool = False, scale_unetfeats: int = 32, num_cab: int = 8):
        super().__init__()
        wide = n_feat + scale_orsnetfeats
        for i in range(3):
            setattr(self, f"orb{i + 1}", ORB(wide, kernel, reduction, bias, num_cab))
        s = scale_unetfeats
        self.up_enc1 = UpSample(n_feat, s)
        self.up_dec1 = UpSample(n_feat, s)
        self.up_enc2 = nn.Sequential(UpSample(n_feat + s, s), UpSample(n_feat, s))
        self.up_dec2 = nn.Sequential(UpSample(n_feat + s, s), UpSample(n_feat, s))
        for i in range(3):
            setattr(self, f"conv_enc{i + 1}", conv2d(n_feat, wide, 1, bias=bias))
            setattr(self, f"conv_dec{i + 1}", conv2d(n_feat, wide, 1, bias=bias))

    def forward(self, x, encoder_outs: Sequence[torch.Tensor], decoder_outs: Sequence[torch.Tensor],
                h: Optional[int] = None):
        """``h``: x's global height (the first encoder level's) under a
        data×space layout."""
        h2 = _scaled(h, 0.5)
        h3 = _scaled(h2, 0.5)
        enc = [encoder_outs[0], self.up_enc1(encoder_outs[1], h2), _up_chain(self.up_enc2, encoder_outs[2], h3)]
        dec = [decoder_outs[0], self.up_dec1(decoder_outs[1], h2), _up_chain(self.up_dec2, decoder_outs[2], h3)]
        for i in range(3):
            x = getattr(self, f"orb{i + 1}")(x, h)
            x = x + getattr(self, f"conv_enc{i + 1}")(enc[i]) + getattr(self, f"conv_dec{i + 1}")(dec[i])
        return x
