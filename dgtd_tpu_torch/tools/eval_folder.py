"""Score a folder of saved prediction maps against ground truth (counterpart
of ``dgtd_tpu/tools/eval_folder.py``), with the port's host metrics.

    python -m dgtd_tpu_torch.tools.eval_folder --pred-dir <maps/> --gt-dir <GT/> \\
        [--metrics Smeasure MAE Fmeasure Emeasure WeightedFmeasure] [--no-strict-pairing]

Files pair by basename stem (a prediction's ``_output``, ``_pred`` or
``_mask`` suffix stripped), or by sorted order with
``--no-strict-pairing``. Predictions are read as 8-bit grayscale, scaled to
[0, 1] and resized (bilinear) to each GT's size, one image a step. Both
reductions are reported: ``parity`` (the reference's cumulative-average
quirk) and ``strict`` (the plain per-image mean). Host only: no device.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

DEFAULT_METRICS = ("Smeasure", "MAE", "Fmeasure", "Emeasure", "WeightedFmeasure")

#: prediction-name decorations stripped before stem matching (the val pass
#: writes ``{name}_output.png``)
PRED_SUFFIXES = ("_output", "_pred", "_mask")


def _stem(fname: str, strip_suffixes=()) -> str:
    stem = os.path.splitext(fname)[0]
    for s in strip_suffixes:
        if stem.endswith(s):
            return stem[: -len(s)]
    return stem


def pair_files(preds, gts, strict_pairing: bool = True):
    """(prediction, GT) filename pairs: by stem, or by sorted order."""
    if len(preds) != len(gts):
        raise SystemExit(f"{len(preds)} predictions vs {len(gts)} GT masks — must pair 1:1")
    if not strict_pairing:
        return list(zip(preds, gts))
    gt_by_stem = {_stem(g): g for g in gts}
    if len(gt_by_stem) != len(gts):
        raise SystemExit("duplicate GT basename stems — cannot pair by stem")
    pairs = [(p, gt_by_stem.get(_stem(p, PRED_SUFFIXES))) for p in preds]
    unmatched = [p for p, g in pairs if g is None]
    if unmatched:
        raise SystemExit(
            f"{len(unmatched)} predictions have no GT stem match (e.g. {unmatched[0]!r}); rename, or pass "
            "--no-strict-pairing to pair by sorted order (only safe when both folders use one naming scheme)")
    return pairs


def run_eval(pred_dir: str, gt_dir: str, metric_names=DEFAULT_METRICS, strict_pairing: bool = True):
    """Returns ({metric: value}, number of images)."""
    from PIL import Image

    from ..metrics import evaluators as _evaluators  # noqa: F401  (registers them)
    from ..core.registry import METRICS
    from ..utils.files import list_images

    pairs = pair_files(list_images(pred_dir), list_images(gt_dir), strict_pairing)
    metrics = [METRICS.get(n)() for n in metric_names]
    for p, g in pairs:
        with Image.open(os.path.join(gt_dir, g)) as gm:
            gt = np.asarray(gm.convert("L"), np.float32) / 255.0
        with Image.open(os.path.join(pred_dir, p)) as pm:
            pm = pm.convert("L")
            if pm.size != (gt.shape[1], gt.shape[0]):
                pm = pm.resize((gt.shape[1], gt.shape[0]), Image.BILINEAR)
            pred = np.asarray(pm, np.float32) / 255.0
        for m in metrics:  # one image a step, as the reference's val loop at batch 1
            m.process(pred[None, :, :, None], gt[None, :, :, None])
    results = {}
    for m in metrics:
        results.update(m.compute())
    return {k: float(v) for k, v in results.items()}, len(pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pred-dir", required=True, help="folder of prediction maps")
    ap.add_argument("--gt-dir", required=True, help="folder of ground-truth masks")
    ap.add_argument("--metrics", nargs="+", default=list(DEFAULT_METRICS))
    ap.add_argument("--no-strict-pairing", action="store_true",
                    help="pair by sorted order without the basename-stem check")
    args = ap.parse_args(argv)
    results, n = run_eval(args.pred_dir, args.gt_dir, args.metrics, strict_pairing=not args.no_strict_pairing)
    for k in sorted(results):
        print(f"{k:<28}{results[k]:.5f}")
    print(json.dumps({"n_images": n, **{k: round(v, 6) for k, v in results.items()}}))
    return results


if __name__ == "__main__":
    main()
