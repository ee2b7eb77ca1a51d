"""Losses: structure-weighted BCE+IoU and the SSIM texture term (counterpart
of ``dgtd_tpu/models/losses.py``).

NCHW in; every reduction is taken in fp32 whatever the autocast state. The
stage weighting keeps the reference's quirk: iteration 0 is weighted 0, and
the SSIM term is the SSIM of the min-max-normalized texture against the
input, which carries no parameter gradient (the texture is an FFT of the
input).

Under a data×space layout (``parallel/space.py``) ``structure_loss`` takes
this rank's band of the logits and its whole rows of the label: the pixel
weight is computed on the whole label and banded, and the per-image sums
are summed over the space group with their gradient. The SSIM term takes
the texture gathered whole (``models/cod.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..parallel import space
from ..parallel.dist import data_group, global_extrema
from ..utils.image import avg_pool, normalize_01, reflect_pad


def structure_loss(logits: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Pixel weight ``1 + 5·|avgpool31(gt) − gt|``; weighted BCE-with-logits
    plus weighted IoU, per image, averaged. (B, 1, H, W) logits and targets;
    under a data×space layout the logits' band of the targets' H rows."""
    logits, gts = logits.float(), gts.float()
    h = gts.shape[-2]
    weit = 1.0 + 5.0 * (avg_pool(gts, 31, 1, 15) - gts).abs()
    weit, gts = space.band_rows(weit), space.band_rows(gts)
    bce = F.binary_cross_entropy_with_logits(logits, gts, reduction="none")
    preds = torch.sigmoid(logits)
    wsum, wbce, inter, union = (weit.sum((2, 3)), (weit * bce).sum((2, 3)), (preds * gts * weit).sum((2, 3)),
                                ((preds + gts) * weit).sum((2, 3)))
    if space.banded(h):
        wsum, wbce, inter, union = space.sum_over_space(torch.stack([wsum, wbce, inter, union]))
    wbce = wbce / wsum
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return (wbce + wiou).mean()


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """3x3 average-pool SSIM after a reflection pad of 1; the mean of
    ``(1 − SSIM)/2`` clamped to [0, 1]."""
    x, y = reflect_pad(x.float(), 1), reflect_pad(y.float(), 1)
    c1, c2 = 0.01**2, 0.03**2
    mu_x, mu_y = avg_pool(x, 3), avg_pool(y, 3)
    sigma_x = avg_pool(x * x, 3) - mu_x * mu_x
    sigma_y = avg_pool(y * y, 3) - mu_y * mu_y
    sigma_xy = avg_pool(x * y, 3) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return ((1.0 - num / den) / 2.0).clamp(0.0, 1.0).mean()


def staged_losses(stage_logits: Sequence[torch.Tensor], pred2_logits: torch.Tensor,
                  label: torch.Tensor, gamma: float = 0.2) -> torch.Tensor:
    """``Σ_i (gamma·i)·L(stage i) + L(pred2)``; iteration 0 is weighted 0 and
    not computed."""
    total = torch.zeros((), dtype=torch.float32, device=label.device)
    for i, logit in enumerate(stage_logits):
        if i:
            total = total + (gamma * i) * structure_loss(logit, label)
    return total + structure_loss(pred2_logits, label)


def texture_ssim_loss(texture: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """SSIM between the batch-normalized texture map and the input image.
    Under data parallelism the min and max are the global batch's (the data
    group's: under a data×space layout the texture and image are a data
    row's whole rows)."""
    group = data_group()
    if group is None:
        return ssim_loss(normalize_01(texture), image)
    lo, hi = global_extrema(texture.min(), texture.max(), group)
    return ssim_loss((texture - lo) / (hi - lo + 1e-8), image)
