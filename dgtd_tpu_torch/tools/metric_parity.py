"""End-to-end metric parity: the reference PyTorch stack against the port,
on the same weights, through predict and the SOD metrics (counterpart of
``dgtd_tpu/tools/metric_parity.py``).

    python -m dgtd_tpu_torch.tools.metric_parity \\
        --image-dir <Imgs/> --gt-dir <GT/> --depth-dir <Depth/> \\
        --checkpoint <reference .pth> [--model cod|baseline] [--size 384] [--device cpu]

For every image (sorted, preprocessed once and shared by both stacks):
  * the reference: its ``twig/model/cod.py`` (or ``baseline.py``) imported
    on the CPU with ``tools/ref_oracle.py``'s stubs, the checkpoint loaded,
    predict-mode output ``sigmoid(interpolate(P1[-1] + P2))``
    (cod.py:149-219);
  * the port: the same state dict loaded straight into the port's model
    (one weight schema, the reference's ``hitnet.*`` keys; no conversion),
    fp32 ``predict`` on ``--device`` (CUDA unless asked otherwise).
Both prediction sets then go through the port's metric evaluators (the
reference's ValLoop: batch 1, cumulative averages) and the per-metric
differences are printed as a table and one JSON line.

The reference is not in the repository: without it the tool raises
``FileNotFoundError`` naming the path it looked for.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.device_norm import IMAGENET_MEAN, IMAGENET_STD

METRIC_NAMES = ("Emeasure", "Fmeasure", "Smeasure", "MAE")


def load_folder(image_dir: str, gt_dir: str, depth_dir: Optional[str], size: int):
    """The datasets' preprocessing (cod10k_camo_train.py:32-38,78): RGB
    resized bilinearly to size², /255, ImageNet-normalized; GT and depth as
    8-bit 'L', resized the same way, /255. Depths pair 1:1 by sorted order.
    Yields (file name, image (S,S,3), depth (S,S,1), gt (S,S,1)), float32."""
    from PIL import Image

    from ..utils.files import list_images as ls

    files = ls(image_dir)
    gts = ls(gt_dir)
    if len(files) != len(gts):
        raise SystemExit(f"{len(files)} images vs {len(gts)} GT masks — must pair 1:1")
    depths = ls(depth_dir) if depth_dir else None
    if depths is not None and len(depths) != len(files):
        raise SystemExit(f"{len(depths)} depths vs {len(files)} images — must pair 1:1")

    def gray(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("L").resize((size, size), Image.BILINEAR), np.float32) / 255.0

    for i, fname in enumerate(files):
        with Image.open(os.path.join(image_dir, fname)) as im:
            rgb = np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR), np.float32) / 255.0
        img = (rgb - IMAGENET_MEAN) / IMAGENET_STD
        gt = gray(os.path.join(gt_dir, gts[i]))
        dep = gray(os.path.join(depth_dir, depths[i])) if depths is not None else np.zeros((size, size), np.float32)
        yield fname, img, dep[..., None], gt[..., None]


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The reference-schema state dict of a ``.pth`` (bare, or under
    ``state_dict`` or ``model``)."""
    if path.endswith(".npz"):
        raise SystemExit(
            "metric_parity needs the reference .pth (both stacks start from the same state dict); "
            "a JAX .npz feeds the port only"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for wrap in ("state_dict", "model"):
        if isinstance(ckpt, dict) and wrap in ckpt:
            ckpt = ckpt[wrap]
    return ckpt


def build_reference_predict(model_name: str, state_dict):
    """The reference model on the CPU; returns predict(img (S,S,3),
    dep (S,S,1)) -> prob (S,S,1)."""
    from .ref_oracle import cpu_cuda_calls, load_reference_cod, load_reference_module

    if model_name == "cod":
        ref = load_reference_cod()
        make = ref.cod
    elif model_name == "baseline":
        ref = load_reference_module(os.path.join("twig", "model", "baseline.py"))
        make = ref.baseline
    else:
        raise SystemExit(f"unsupported --model {model_name}")
    with cpu_cuda_calls():
        model = make()
    if state_dict is not None:
        missing, _ = model.load_state_dict(state_dict, strict=False)
        if missing:
            print(f"reference load: {len(missing)} missing keys (kept at init)")
    model.eval()

    def predict(img_hwc: np.ndarray, dep_hw1: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(img_hwc.transpose(2, 0, 1)[None].copy())
        d = torch.from_numpy(dep_hw1.transpose(2, 0, 1)[None].copy())
        with torch.no_grad(), cpu_cuda_calls():
            _, stages, pred2 = model.hitnet(x, d)
            # predict mode (cod.py:149-155): last stage + P2, bilinear to
            # the label's size, sigmoid
            out = torch.nn.functional.interpolate(stages[-1] + pred2, size=x.shape[2:], mode="bilinear").sigmoid()
        return out.numpy()[0].transpose(1, 2, 0)

    return predict


def build_our_predict(model_name: str, state_dict, fp32: bool = True, device=None):
    """The same state dict in the port's model (its keys are the
    reference's): predict on ``device``; a weight the state dict lacks
    raises (only BatchNorm's step counters and the reference's dead modules
    may go unmatched)."""
    from .. import models as _models  # noqa: F401  (registers the models)
    from ..core.device import resolve_device
    from ..core.registry import MODELS
    from ..convert import is_dead_key

    device = resolve_device(device)
    model = MODELS.get(model_name)(dtype=torch.float32 if fp32 else torch.bfloat16, seed=None)
    result = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in result.missing_keys if not is_dead_key(k)]
    if missing:
        raise SystemExit(f"the state dict left {len(missing)} weights of the port's {model_name} at init: {missing[:5]}")
    model.to(device).eval()

    def run(img_hwc: np.ndarray, dep_hw1: np.ndarray) -> np.ndarray:
        prob = model.predict(torch.from_numpy(img_hwc[None]).to(device), torch.from_numpy(dep_hw1[None]).to(device))[0]
        return prob.cpu().numpy()[0]

    return run


def make_metrics():
    from ..core.registry import METRICS
    from ..metrics import evaluators as _evaluators  # noqa: F401  (registers the metrics)

    return [METRICS.get(n)() for n in METRIC_NAMES]


def run_parity(image_dir: str, gt_dir: str, depth_dir: Optional[str], checkpoint: Optional[str],
               model_name: str = "cod", size: int = 384, state_dict=None, device=None) -> Dict:
    """Run both stacks over the folder; returns {'reference': {...}, 'ours':
    {...}, 'delta': {...}, 'pred_max_abs_delta': float, 'n_images': int}."""
    if state_dict is None:
        state_dict = load_state_dict(checkpoint)
    ref_predict = build_reference_predict(model_name, state_dict)
    our_predict = build_our_predict(model_name, state_dict, device=device)

    ref_metrics, our_metrics = make_metrics(), make_metrics()
    max_pred_delta, n = 0.0, 0
    for fname, img, dep, gt in load_folder(image_dir, gt_dir, depth_dir, size):
        p_ref = ref_predict(img, dep)
        p_our = our_predict(img, dep)
        max_pred_delta = max(max_pred_delta, float(np.abs(p_ref - p_our).max()))
        # the reference's ValLoop: one image a process() call (batch 1, config/cod.yml:28)
        for m in ref_metrics:
            m.process(p_ref[None], gt[None])
        for m in our_metrics:
            m.process(p_our[None], gt[None])
        n += 1
        print(f"{n}: {fname}  pred|Δ|={max_pred_delta:.2e}", flush=True)

    ref_vals: Dict[str, float] = {}
    our_vals: Dict[str, float] = {}
    for m in ref_metrics:
        ref_vals.update(m.compute())
    for m in our_metrics:
        our_vals.update(m.compute())
    delta = {k: abs(ref_vals[k] - our_vals[k]) for k in ref_vals}
    return {"reference": ref_vals, "ours": our_vals, "delta": delta, "pred_max_abs_delta": max_pred_delta,
            "n_images": n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--gt-dir", required=True)
    ap.add_argument("--depth-dir", default=None)
    ap.add_argument("--checkpoint", required=True, help="reference-schema .pth")
    ap.add_argument("--model", default="cod", choices=["cod", "baseline"])
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--device", default=None, help="the port's device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    result = run_parity(args.image_dir, args.gt_dir, args.depth_dir, args.checkpoint, model_name=args.model,
                        size=args.size, device=args.device)
    print(f"\n{'metric':<24}{'reference':>12}{'ours':>12}{'|delta|':>12}")
    for k in sorted(result["reference"]):
        print(f"{k:<24}{result['reference'][k]:>12.5f}{result['ours'][k]:>12.5f}{result['delta'][k]:>12.2e}")
    print(f"\nmax per-pixel prediction delta: {result['pred_max_abs_delta']:.2e}")
    print(json.dumps({
        "n_images": result["n_images"],
        "pred_max_abs_delta": result["pred_max_abs_delta"],
        "metric_max_abs_delta": max(result["delta"].values()),
        **{f"ref:{k}": round(v, 6) for k, v in result["reference"].items()},
        **{f"ours:{k}": round(v, 6) for k, v in result["ours"].items()},
    }))
    return result


if __name__ == "__main__":
    main()
