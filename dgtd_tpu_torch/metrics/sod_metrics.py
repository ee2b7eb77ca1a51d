"""SOD metric algorithms on the host, numpy float64 (the port's own copy of
``dgtd_tpu/metrics/sod_metrics.py``).

The ``py_sod_metrics`` algorithms that the reference's metric wrappers call:
E-measure after the specification kept in the reference's commented numpy
implementation (``twig/metric/Emeasure.py``); S-measure is Fan et al.'s
structure measure (alpha = 0.5, MATLAB conventions: std with ddof = 1, the
centroid rounded half to even); F-measure uses beta² = 0.3 over 256-threshold
cumulative histograms.

Every per-image function takes ``pred`` as float in [0, 1] (after min-max
normalization) and ``gt`` as bool; ``prepare`` reproduces py_sod_metrics'
``prepare_data`` (pred / 255, then mapminmax; gt > 128).

The threshold curves come from two 256-bin histograms per image, the only
O(H·W) work, which ``metrics/device.py`` can compute on the card; everything
after them is O(256) numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

EPS = np.spacing(1)


def prepare(pred_u8: np.ndarray, gt_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [0,255] pred/gt -> (float pred in [0,1] mapminmax'd, bool gt)."""
    gt = gt_u8 > 128
    pred = pred_u8.astype(np.float64) / 255.0
    if pred.max() != pred.min():
        pred = (pred - pred.min()) / (pred.max() - pred.min())
    return pred, gt


def adaptive_threshold(pred: np.ndarray) -> float:
    return min(2.0 * float(pred.mean()), 1.0)


def threshold_histograms(pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """256-bin histograms of quantized pred over gt-fg and gt-bg pixels.

    Returns (fg_hist, bg_hist), each shape (256,), following py_sod_metrics'
    ``np.histogram(pred*255, bins=linspace(0,256,257))`` binning.
    """
    q = (pred * 255).astype(np.uint8)
    fg_hist = np.bincount(q[gt], minlength=256).astype(np.float64)
    bg_hist = np.bincount(q[~gt], minlength=256).astype(np.float64)
    return fg_hist, bg_hist


# ---------------------------------------------------------------------------
# F-measure
# ---------------------------------------------------------------------------


def fmeasure_curve(
    fg_hist: np.ndarray, bg_hist: np.ndarray, gt_fg_numel: int, beta: float = 0.3
) -> np.ndarray:
    """(256,) F-beta curve over descending thresholds."""
    tps = np.cumsum(np.flip(fg_hist))
    ps = tps + np.cumsum(np.flip(bg_hist))
    ps = np.where(ps == 0, 1, ps)
    t = max(gt_fg_numel, 1)
    precisions = tps / ps
    recalls = tps / t
    numerator = (1 + beta) * precisions * recalls
    denominator = np.where(numerator == 0, 1, beta * precisions + recalls)
    return numerator / denominator


def adaptive_fmeasure(pred: np.ndarray, gt: np.ndarray, beta: float = 0.3) -> float:
    thr = adaptive_threshold(pred)
    binary = pred >= thr
    inter = np.count_nonzero(binary & gt)
    if inter == 0:
        return 0.0
    pre = inter / np.count_nonzero(binary)
    rec = inter / np.count_nonzero(gt)
    return (1 + beta) * pre * rec / (beta * pre + rec)


# ---------------------------------------------------------------------------
# E-measure (enhanced alignment; spec: twig/metric/Emeasure.py:42-242)
# ---------------------------------------------------------------------------


def _em_from_counts(fg_fg, fg_bg, gt_fg_numel, gt_size):
    """Vectorized enhanced-alignment sum given pred-fg∩gt-fg / pred-fg∩gt-bg counts."""
    fg = fg_fg + fg_bg
    bg = gt_size - fg
    if gt_fg_numel == 0:
        enhanced = bg
    elif gt_fg_numel == gt_size:
        enhanced = fg
    else:
        bg_fg = gt_fg_numel - fg_fg
        bg_bg = bg - bg_fg
        parts = (fg_fg, fg_bg, bg_fg, bg_bg)
        mean_pred = fg / gt_size
        mean_gt = gt_fg_numel / gt_size
        combos = (
            (1 - mean_pred, 1 - mean_gt),
            (1 - mean_pred, 0 - mean_gt),
            (0 - mean_pred, 1 - mean_gt),
            (0 - mean_pred, 0 - mean_gt),
        )
        enhanced = 0.0
        for part, (dp, dg) in zip(parts, combos):
            align = 2 * (dp * dg) / (dp**2 + dg**2 + EPS)
            enhanced = enhanced + ((align + 1) ** 2 / 4) * part
    return enhanced / (gt_size - 1 + EPS)


def emeasure_curve(
    fg_hist: np.ndarray, bg_hist: np.ndarray, gt_fg_numel: int, gt_size: int
) -> np.ndarray:
    fg_fg = np.cumsum(np.flip(fg_hist))
    fg_bg = np.cumsum(np.flip(bg_hist))
    return _em_from_counts(fg_fg, fg_bg, gt_fg_numel, gt_size)


def adaptive_emeasure(pred: np.ndarray, gt: np.ndarray) -> float:
    thr = adaptive_threshold(pred)
    binary = pred >= thr
    fg_fg = float(np.count_nonzero(binary & gt))
    fg_bg = float(np.count_nonzero(binary & ~gt))
    return float(_em_from_counts(fg_fg, fg_bg, int(np.count_nonzero(gt)), gt.size))


# ---------------------------------------------------------------------------
# S-measure (Fan et al. 2017, alpha = 0.5)
# ---------------------------------------------------------------------------


def _s_object_part(x_vals: np.ndarray) -> float:
    if x_vals.size == 0:
        return 0.0
    x = x_vals.mean()
    sigma_x = x_vals.std(ddof=1) if x_vals.size > 1 else 0.0
    return 2.0 * x / (x**2 + 1.0 + sigma_x + EPS)


def _s_object(pred: np.ndarray, gt: np.ndarray) -> float:
    fg = pred * gt
    bg = (1.0 - pred) * (~gt)
    u = gt.mean()
    return u * _s_object_part(fg[gt]) + (1 - u) * _s_object_part(bg[~gt])


def _region_ssim(pred: np.ndarray, gt: np.ndarray) -> float:
    h, w = pred.shape
    n = h * w
    if n <= 1:
        return 1.0 if (pred == gt).all() else 0.0
    x = pred.mean()
    y = gt.mean()
    sigma_x = ((pred - x) ** 2).sum() / (n - 1)
    sigma_y = ((gt - y) ** 2).sum() / (n - 1)
    sigma_xy = ((pred - x) * (gt - y)).sum() / (n - 1)
    alpha = 4 * x * y * sigma_xy
    beta = (x**2 + y**2) * (sigma_x + sigma_y)
    if alpha != 0:
        return alpha / (beta + EPS)
    return 1.0 if beta == 0 else 0.0


def _s_region(pred: np.ndarray, gt: np.ndarray) -> float:
    h, w = gt.shape
    if np.count_nonzero(gt) == 0:
        cx, cy = int(round(w / 2)) + 1, int(round(h / 2)) + 1
    else:
        ys, xs = np.argwhere(gt).mean(axis=0).round()
        cx, cy = int(xs) + 1, int(ys) + 1
    area = h * w
    gtf = gt.astype(np.float64)
    w1 = (cx * cy) / area
    w2 = (cy * (w - cx)) / area
    w3 = ((h - cy) * cx) / area
    w4 = 1.0 - w1 - w2 - w3
    score = (
        w1 * _region_ssim(pred[0:cy, 0:cx], gtf[0:cy, 0:cx])
        + w2 * _region_ssim(pred[0:cy, cx:w], gtf[0:cy, cx:w])
        + w3 * _region_ssim(pred[cy:h, 0:cx], gtf[cy:h, 0:cx])
        + w4 * _region_ssim(pred[cy:h, cx:w], gtf[cy:h, cx:w])
    )
    return score


def smeasure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    y = gt.mean()
    if y == 0:
        sm = 1.0 - pred.mean()
    elif y == 1:
        sm = float(pred.mean())
    else:
        sm = max(alpha * _s_object(pred, gt) + (1 - alpha) * _s_region(pred, gt), 0.0)
    return float(sm)


# ---------------------------------------------------------------------------
# MAE & weighted F
# ---------------------------------------------------------------------------


def mae(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - gt.astype(np.float64))))


def weighted_fmeasure(pred: np.ndarray, gt: np.ndarray, beta: float = 1.0) -> float:
    """Margolin et al. 'How to Evaluate Foreground Maps' weighted F-measure.

    (The reference registers this metric but ships it disabled —
    twig/metric/WeightedFmeasure.py:1-37.)
    """
    from scipy.ndimage import convolve, distance_transform_edt

    if np.all(~gt):
        return 0.0
    e = np.abs(pred - gt.astype(np.float64))
    dst, idx = distance_transform_edt(1 - gt.astype(np.float64), return_indices=True)
    et = e.copy()
    et[~gt] = et[idx[0][~gt], idx[1][~gt]]
    k = _matlab_gauss2d((7, 7), 5)
    ea = convolve(et, k, mode="constant", cval=0)
    min_e_ea = np.where(gt & (ea < e), ea, e)
    b = np.where(~gt, 2 - np.exp(np.log(0.5) / 5 * dst), np.ones_like(gt, dtype=np.float64))
    ew = min_e_ea * b
    tpw = np.sum(gt) - np.sum(ew[gt])
    fpw = np.sum(ew[~gt])
    r = 1 - np.mean(ew[gt])
    p = tpw / (tpw + fpw + EPS)
    return float((1 + beta) * r * p / (r + beta * p + EPS))


def _matlab_gauss2d(shape=(7, 7), sigma=5.0):
    m, n = [(ss - 1) / 2 for ss in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


# ---------------------------------------------------------------------------
# mIoU (reference twig/metric/mIOU.py:8-71, vectorized)
# ---------------------------------------------------------------------------


def miou(pred_classes: np.ndarray, gt_classes: np.ndarray, num_classes: int) -> float:
    """Reference mean-IoU semantics (twig/metric/mIOU.py:32-58): per-class
    IoU from the confusion matrix; a class with zero diagonal count
    contributes 0 but the mean still divides by ``num_classes`` (the
    reference's ``if nii == 0: continue`` inside a ``/num_classes`` mean).

    The reference builds the confusion matrix with a per-pixel Python loop
    (mIOU.py:28-29); this is the same matrix via one bincount.
    """
    mask = (gt_classes >= 0) & (gt_classes < num_classes)
    idx = num_classes * gt_classes[mask].astype(int) + pred_classes[mask].astype(int)
    cm = np.bincount(idx, minlength=num_classes**2).reshape(num_classes, num_classes)
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(1) + cm.sum(0) - inter
    iou = np.where(inter > 0, inter / np.maximum(union, 1), 0.0)
    return float(iou.sum() / num_classes)
