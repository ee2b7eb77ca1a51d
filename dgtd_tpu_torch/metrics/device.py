"""Per-image metric statistics on the prediction's device (counterpart of
``dgtd_tpu/metrics/device.py``).

The SOD metrics' only O(H·W) work is per-image reductions: the two 256-bin
threshold histograms (F- and E-measure curves), the MAE sum, the S-measure,
and the min/max of py_sod_metrics' mapminmax. ``batch_statistics`` computes
them for a whole batch in plain PyTorch on the card, so that only a few KB
an image go to the host, where the evaluators do O(256) work an image
(``evaluators.py::process_stats``).

Quantization follows the host path (``sod_metrics.prepare``) step for step:
``floor(prob·255)`` in fp32 clipped to 0–255 (the host's fp32
``(pred·255).astype(uint8)``), gt = ``floor(label·255) > 128``, then
mapminmax of u8/255 and the requantization in float64, as numpy does them. So
the histograms equal the host's exactly; the JAX package does the mapminmax
in fp32, which puts ~2% of (value, min, max) triples in another bin than the
host does (none when min is near 0 and max near 255).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

EPS = float(np.spacing(1))
_BINS = 256


def _masked_mean(p: torch.Tensor, mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return (p * mask).sum(dim=(1, 2)) / n.clamp(min=1.0)


def _s_object_part(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """2x / (x² + 1 + σ) over the masked pixels of each image, σ the MATLAB
    std (ddof = 1); 0 for an empty mask. (B,)"""
    cnt = mask.sum(dim=(1, 2))
    x = _masked_mean(p, mask, cnt)
    var = (((p - x[:, None, None]) * mask) ** 2).sum(dim=(1, 2)) / (cnt - 1.0).clamp(min=1.0)
    score = 2.0 * x / (x ** 2 + 1.0 + var.sqrt() + EPS)
    return torch.where(cnt > 0, score, torch.zeros_like(score))


def _region_ssim(p: torch.Tensor, g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fan's SSIM of each image's masked quadrant, (N - 1) normalization;
    a one-pixel quadrant scores 1 if prediction and gt agree there, else 0,
    as the host's ``_region_ssim`` does. (B,)"""
    n = mask.sum(dim=(1, 2))
    x = _masked_mean(p, mask, n)
    y = _masked_mean(g, mask, n)
    dp, dg = (p - x[:, None, None]) * mask, (g - y[:, None, None]) * mask
    denom = (n - 1.0).clamp(min=1.0)
    sigma_x = (dp ** 2).sum(dim=(1, 2)) / denom
    sigma_y = (dg ** 2).sum(dim=(1, 2)) / denom
    sigma_xy = (dp * dg).sum(dim=(1, 2)) / denom
    alpha = 4.0 * x * y * sigma_xy
    beta = (x ** 2 + y ** 2) * (sigma_x + sigma_y)
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    ssim = torch.where(alpha != 0, alpha / (beta + EPS), torch.where(beta == 0, one, zero))
    return torch.where(n == 1, torch.where(x == y, one, zero), ssim)


def _smeasure(p: torch.Tensor, gt: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """S-measure of each (H, W) image of p (float64, mapminmax'd) against
    gt (bool), py_sod_metrics semantics. (B,)"""
    b, h, w = p.shape
    gtf = gt.to(p.dtype)
    y = gtf.mean(dim=(1, 2))
    obj = y * _s_object_part(p * gtf, gtf) + (1.0 - y) * _s_object_part((1.0 - p) * (1.0 - gtf), 1.0 - gtf)

    # the centroid from exact integer sums, rounded half to even (MATLAB's
    # round as numpy's argwhere().mean().round() gives it), 1-based
    rows = torch.arange(h, device=p.device).view(1, h, 1)
    cols = torch.arange(w, device=p.device).view(1, 1, w)
    cnt = gt.sum(dim=(1, 2))
    ys = (rows * gt).sum(dim=(1, 2)).to(torch.float64) / cnt.clamp(min=1)
    xs = (cols * gt).sum(dim=(1, 2)).to(torch.float64) / cnt.clamp(min=1)
    cy = torch.where(cnt > 0, torch.round(ys), torch.full_like(ys, round(h / 2))) + 1
    cx = torch.where(cnt > 0, torch.round(xs), torch.full_like(xs, round(w / 2))) + 1
    top = rows < cy.view(b, 1, 1)
    left = cols < cx.view(b, 1, 1)
    quadrants = [(top & left), (top & ~left), (~top & left), (~top & ~left)]
    masks = [q.to(p.dtype) for q in quadrants]
    weights = [m.sum(dim=(1, 2)) / float(h * w) for m in masks[:3]]
    weights.append(1.0 - weights[0] - weights[1] - weights[2])  # py_sod_metrics' w4
    region = sum(wq * _region_ssim(p, gtf, m) for wq, m in zip(weights, masks))

    sm = (alpha * obj + (1 - alpha) * region).clamp(min=0.0)
    mean_p = p.mean(dim=(1, 2))
    return torch.where(y == 0, 1.0 - mean_p, torch.where(y == 1, mean_p, sm))


def batch_statistics(prob: torch.Tensor, label: torch.Tensor) -> Dict[str, torch.Tensor]:
    """prob, label: (B, H, W) or (B, H, W, 1) floats in [0, 1], on any device.

    Returns, on that device, per image: ``fg_hist`` and ``bg_hist`` (B, 256)
    int64 counts, ``gt_count`` (B,) int64, ``mae_sum`` (B,) float64, ``sm``
    (B,) float64 and ``n_pixels`` (B,) int64. No Python loop over images."""
    with torch.inference_mode():
        if prob.ndim == 4:
            prob = prob[..., 0]
        if label.ndim == 4:
            label = label[..., 0]
        b, h, w = prob.shape
        n = h * w
        pred_u8 = torch.floor(prob.float() * 255.0).clamp(0, 255)
        gt = torch.floor(label.float() * 255.0) > 128

        p = pred_u8.to(torch.float64) / 255.0
        pmin = p.amin(dim=(1, 2), keepdim=True)
        pmax = p.amax(dim=(1, 2), keepdim=True)
        spread = pmax > pmin
        p_norm = torch.where(spread, (p - pmin) / torch.where(spread, pmax - pmin, torch.ones_like(pmax)), p)
        q = (p_norm * 255.0).to(torch.int64).clamp(0, 255)

        # one bincount over (image, gt, bin): counts, no one-hot
        index = (torch.arange(b, device=q.device).view(b, 1, 1) * 2 + gt) * _BINS + q
        hist = torch.bincount(index.reshape(-1), minlength=b * 2 * _BINS).view(b, 2, _BINS)
        return {
            "fg_hist": hist[:, 1],
            "bg_hist": hist[:, 0],
            "gt_count": gt.sum(dim=(1, 2)),
            "mae_sum": (p_norm - gt.to(torch.float64)).abs().sum(dim=(1, 2)),
            "sm": _smeasure(p_norm, gt),
            "n_pixels": torch.full((b,), n, dtype=torch.int64, device=q.device),
        }


#: the columns of the one host copy, in order, with their widths
_LAYOUT = (("fg_hist", _BINS), ("bg_hist", _BINS), ("gt_count", 1), ("mae_sum", 1), ("sm", 1), ("n_pixels", 1))


def statistics_to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``batch_statistics``' tensors as numpy arrays, copied to the host in
    one transfer: every column packed into one (B, 516) float64 tensor, which
    holds the counts exactly."""
    packed = torch.cat([stats[k].to(torch.float64).reshape(len(stats["sm"]), width) for k, width in _LAYOUT], dim=1)
    host = packed.cpu().numpy()
    out, col = {}, 0
    for k, width in _LAYOUT:
        block = host[:, col : col + width]
        out[k] = block if width > 1 else block[:, 0]
        col += width
    for k in ("fg_hist", "bg_hist", "gt_count", "n_pixels"):
        out[k] = out[k].astype(np.int64)
    return out
