"""Streaming SOD evaluators (counterpart of ``dgtd_tpu/metrics/evaluators.py``).

The reference wraps *cumulative* py_sod_metrics evaluators: each batch steps
the evaluator and appends the cumulative result so far, and the reported
number is the mean of what was appended (``twig/metric/Smeasure.py:18-37``).
With the recipes' val batch of 1 that is the mean over k of the metric of the
first k images, not the plain mean over the images.

Each evaluator reports both:
  * ``<prefix>/<name>``: the parity reduction, that quirk reproduced;
  * ``<prefix>/<name>_strict``: the plain per-image mean (curve metrics: the
    maximum of the mean curve), what py_sod_metrics reports on its own.

``process`` takes full probability maps; ``process_stats`` takes the per-image
statistics of ``metrics/device.py::batch_statistics`` (host numpy arrays) for
the evaluators with ``supports_device_stats``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.registry import METRICS
from . import sod_metrics as S


class BaseSODMetric:
    """uint8 quantization, per-image stepping and the two reductions."""

    default_prefix = "COD"
    name = "metric"
    #: whether ``process_stats`` can consume ``batch_statistics``
    supports_device_stats = False

    def __init__(self, collect_device: str = "cpu", prefix: Optional[str] = None, data_range: float = 1.0):
        self.prefix = prefix or self.default_prefix
        self.reset()

    def reset(self):
        self._appended: List[float] = []
        self._count = 0

    def _step(self, pred: np.ndarray, gt: np.ndarray) -> None:
        raise NotImplementedError

    def _step_stats(self, stats, i: int) -> None:
        raise NotImplementedError

    def _cumulative_value(self) -> float:
        raise NotImplementedError

    def process_stats(self, stats) -> None:
        """One batch of per-image statistics; the same cumulative append as
        ``process``."""
        for i in range(len(stats["sm"])):
            self._step_stats(stats, i)
            self._count += 1
        self._appended.append(self._cumulative_value())

    def process(self, preds, gts) -> None:
        """preds, gts: (B, H, W) or (B, H, W, 1) float arrays in [0, 1]."""
        preds = np.asarray(preds)
        gts = np.asarray(gts)
        # each rank on its own: mixed ranks must not broadcast
        if preds.ndim == 4:
            preds = preds[..., 0]
        if gts.ndim == 4:
            gts = gts[..., 0]
        if preds.shape != gts.shape:
            raise ValueError(f"pred/gt shape mismatch: {preds.shape} vs {gts.shape}")
        preds_u8 = (preds * 255).astype(np.uint8)
        gts_u8 = (gts * 255).astype(np.uint8)
        for p, g in zip(preds_u8, gts_u8):
            pred, gt = S.prepare(p, g)
            self._step(pred, gt)
            self._count += 1
        self._appended.append(self._cumulative_value())

    def compute(self) -> Dict[str, float]:
        parity = float(np.mean(self._appended)) if self._appended else float("nan")
        return {
            f"{self.prefix}/{self.name}": parity,
            f"{self.prefix}/{self.name}_strict": self._cumulative_value(),
        }


class _MeanMetric(BaseSODMetric):
    """A per-image value averaged over the images."""

    def reset(self):
        super().reset()
        self._sum = 0.0

    def _cumulative_value(self):
        return self._sum / max(self._count, 1)


@METRICS.register
class Smeasure(_MeanMetric):
    """S-measure (``twig/metric/Smeasure.py:8-37``)."""

    name = "Smeasure"
    supports_device_stats = True

    def _step(self, pred, gt):
        self._sum += S.smeasure(pred, gt)

    def _step_stats(self, stats, i):
        self._sum += float(stats["sm"][i])


@METRICS.register
class MAE(_MeanMetric):
    """MAE (``twig/metric/MAE.py:8-37``)."""

    name = "MAE"
    supports_device_stats = True

    def _step(self, pred, gt):
        self._sum += S.mae(pred, gt)

    def _step_stats(self, stats, i):
        self._sum += float(stats["mae_sum"][i]) / float(stats["n_pixels"][i])


@METRICS.register
class WeightedFmeasure(_MeanMetric):
    """Weighted F-measure (registered but disabled in the reference's
    recipes, ``twig/metric/WeightedFmeasure.py:1-37``); host only."""

    name = "WeightedFmeasure"

    def _step(self, pred, gt):
        self._sum += S.weighted_fmeasure(pred, gt)


class _CurveMetric(BaseSODMetric):
    """The maximum over the running mean 256-point curve."""

    supports_device_stats = True

    def reset(self):
        super().reset()
        self._curve_sum = np.zeros(256, np.float64)

    def _cumulative_value(self):
        return float((self._curve_sum / max(self._count, 1)).max())

    def _curve(self, fg_hist, bg_hist, gt_count: int, n_pixels: int) -> np.ndarray:
        raise NotImplementedError

    def _step(self, pred, gt):
        fg_hist, bg_hist = S.threshold_histograms(pred, gt)
        self._curve_sum += self._curve(fg_hist, bg_hist, int(np.count_nonzero(gt)), gt.size)

    def _step_stats(self, stats, i):
        self._curve_sum += self._curve(
            np.asarray(stats["fg_hist"][i], np.float64), np.asarray(stats["bg_hist"][i], np.float64),
            int(stats["gt_count"][i]), int(stats["n_pixels"][i]),
        )


@METRICS.register
class Fmeasure(_CurveMetric):
    """Max F-measure over 256 thresholds (``twig/metric/Fmeasure.py:8-37``)."""

    name = "Fmeasure"

    def _curve(self, fg_hist, bg_hist, gt_count, n_pixels):
        return S.fmeasure_curve(fg_hist, bg_hist, gt_count)


@METRICS.register
class Emeasure(_CurveMetric):
    """Max E-measure over 256 thresholds (``twig/metric/Emeasure.py:8-36``)."""

    name = "Emeasure"

    def _curve(self, fg_hist, bg_hist, gt_count, n_pixels):
        return S.emeasure_curve(fg_hist, bg_hist, gt_count, n_pixels)


@METRICS.register
class meanIntersectionOverUnion:
    """Multi-class mIoU with the reference's contract
    (``twig/metric/mIOU.py:32-58``): pred is an (N, H, W, C) score map, argmax
    over classes; gt an (N, H, W, 1) map in [0, 1], scaled by 255 and clamped
    to ``num_classes - 1``; one mIoU per ``process`` call (zero-diagonal
    classes count 0 in a mean over ``num_classes``), averaged over the calls.

    Beyond the reference: a one-channel pred with ``num_classes=2`` is
    thresholded at ``threshold`` into classes {0, 1}. Neither recipe uses it.
    """

    def __init__(self, num_classes: int = 2, threshold: float = 0.5, prefix: str = "COD"):
        self.num_classes = num_classes
        self.threshold = threshold
        self.prefix = prefix
        self.reset()

    def reset(self):
        self._ious: List[float] = []

    def process(self, preds, gts):
        preds = np.asarray(preds, np.float32)
        gts = np.asarray(gts, np.float32)
        if preds.ndim == 3:
            preds = preds[..., None]
        if gts.ndim == 4:
            gts = gts[..., 0]
        if preds.shape[-1] == 1:
            pc = (preds[..., 0] >= self.threshold).astype(np.int64)
            gc = (gts >= 0.5).astype(np.int64)
        else:
            # softmax is monotone per pixel: the argmax of the scores suffices
            pc = np.argmax(preds, axis=-1).astype(np.int64)
            gc = np.minimum(gts * 255.0, self.num_classes - 1).astype(np.int64)
        self._ious.append(S.miou(pc, gc, self.num_classes))

    def compute(self):
        return {f"{self.prefix}/mIoU": float(np.mean(self._ious)) if self._ious else float("nan")}
