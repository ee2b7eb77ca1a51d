"""The training losses of the reference, float32, NCHW.

``structure_loss``: pixel weight 1 + 5·|avgpool₃₁(gt) − gt|, the weighted
BCE with logits plus the weighted IoU of the sigmoid, per image, averaged.
The staged sum weights refinement iteration i by 0.2·i (iteration 0 by 0)
and adds the second logits' loss. ``cod`` adds the SSIM term: the mean of
(1 − SSIM)/2, clamped to [0, 1], of the texture min-max normalized over the
whole batch against the normalized image, both reflection-padded by 1,
with 3×3 average pools and c1 = 0.01², c2 = 0.03².
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import avg_pool


def structure_loss(logits: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    weit = 1.0 + 5.0 * (avg_pool(gts, 31, 1, 15) - gts).abs()
    bce = F.binary_cross_entropy_with_logits(logits, gts, reduction="none")
    wbce = (weit * bce).sum((2, 3)) / weit.sum((2, 3))
    pred = torch.sigmoid(logits)
    inter = (pred * gts * weit).sum((2, 3))
    union = ((pred + gts) * weit).sum((2, 3))
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return (wbce + wiou).mean()


def staged_loss(stage_preds, pred2, label, gamma: float = 0.2) -> torch.Tensor:
    total = structure_loss(pred2, label)
    for i, logit in enumerate(stage_preds):
        if i:
            total = total + (gamma * i) * structure_loss(logit, label)
    return total


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = F.pad(x, (1, 1, 1, 1), mode="reflect"), F.pad(y, (1, 1, 1, 1), mode="reflect")
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = avg_pool(x, 3), avg_pool(y, 3)
    sx, sy, sxy = avg_pool(x * x, 3) - mx * mx, avg_pool(y * y, 3) - my * my, avg_pool(x * y, 3) - mx * my
    ssim = ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sx + sy + c2))
    return ((1.0 - ssim) / 2.0).clamp(0.0, 1.0).mean()


def texture_loss(texture: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    lo, hi = texture.min(), texture.max()
    return ssim_loss((texture - lo) / (hi - lo + 1e-8), image)


def model_loss(arch: dict, outputs, image, label):
    """(total, {"loss_seg", ["loss_ssim"], "loss"}) of a model's train
    forward; ``cod`` adds the SSIM term, ``DQnet`` does not."""
    texture, stage_preds, pred2 = outputs
    seg = staged_loss(stage_preds, pred2, label)
    terms = {"loss_seg": seg}
    total = seg
    if arch["model"] == "cod" and texture is not None:
        terms["loss_ssim"] = texture_loss(texture, image)
        total = total + terms["loss_ssim"]
    terms["loss"] = total
    return total, terms
