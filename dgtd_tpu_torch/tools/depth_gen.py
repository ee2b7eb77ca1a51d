"""Offline depth maps for the RGB-D datasets (counterpart of
``dgtd_tpu/tools/depth_gen.py``).

Writes one ``<stem>_depth.png`` an image, which the datasets read through
``depth_dir``. Estimators:
  * ``dinov2``: DINOv2 ViT-*/14 + DPT head (``models/dinov2.py``,
    ``models/dpt.py``) from local files: the official
    ``dinov2_vit*14_pretrain.pth`` and ``dinov2_vit*14_nyu_dpt_head.pth``,
    or JAX ``.npz`` files (``dgtd_tpu.tools.convert_ckpt dinov2`` /
    ``dpt_head``). A missing file, a missing parameter or a mismatched
    shape raises; nothing falls back to ``sobel``;
  * ``dpt``: a local Hugging Face DPT checkpoint (``transformers``);
  * ``sobel``: weights-free pseudo-depth (blur + inverted gradient).

Rendering: ``--render gray`` (default) saves the min-max normalized depth;
``--render magma`` saves the reference's magma_r RGB, which the datasets
re-read as 8-bit grayscale. The depth is resized back to the source size as
floats before rendering.

    python -m dgtd_tpu_torch.tools.depth_gen --image-dir data/Imgs --out-dir data/depth \\
        [--estimator dinov2|dpt|sobel] [--backbone-ckpt ...] [--head-ckpt ...] [--arch vitl14] \\
        [--render gray|magma] [--long-side 518] [--fp32] [--device cpu]

Runs on CUDA unless ``--device`` names another device (a missing card
raises), one image at a time, in bf16 autocast unless ``--fp32``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from ..core.device import resolve_device

# DINOv2 depth-eval preprocessing: images on [0, 255], ImageNet mean and std
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)
ARCHS = ("vits14", "vitb14", "vitl14", "vitg14")


def sobel_pseudo_depth(img: np.ndarray) -> np.ndarray:
    """Weights-free pseudo-depth: smoothed inverse gradient magnitude in [0, 1]."""
    gray = img.mean(axis=-1)
    gy, gx = np.gradient(gray)
    mag = np.sqrt(gx**2 + gy**2)
    for _ in range(3):  # box blur x3, about a gaussian
        p = np.pad(mag, 1, mode="edge")
        mag = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] + mag) / 5.0
    mag = mag / (mag.max() + 1e-8)
    return 1.0 - mag


def render_depth(values: np.ndarray, colormap: str = "magma_r") -> np.ndarray:
    """Min-max normalize, then colormap to RGB uint8 (the reference's
    ``render_depth``)."""
    import matplotlib

    lo, hi = values.min(), values.max()
    norm = (values - lo) / (hi - lo + 1e-12)
    return matplotlib.colormaps[colormap](norm, bytes=True)[..., :3]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Dinov2Depther:
    """The DINOv2 + DPT depther from two checkpoint files, on ``device``.
    The head's kind (classify or regression) and bin count come from
    ``conv_depth``'s output channels. ``seconds`` sums the backbone's and
    the head's time over the calls."""

    def __init__(self, arch: str, backbone_ckpt: str, head_ckpt: str, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16):
        from ..convert import depther_part_state, load_depther_part
        from ..models.dpt import DinoDPTDepther

        for what, path in (("--backbone-ckpt", backbone_ckpt), ("--head-ckpt", head_ckpt)):
            if not path or not os.path.isfile(path):
                raise FileNotFoundError(f"--estimator dinov2 needs {what}: {path!r} is not a file")
        backbone = depther_part_state(backbone_ckpt, "dinov2")
        head = depther_part_state(head_ckpt, "dpt_head")
        if "conv_depth.weight" not in head:
            raise ValueError(f"{head_ckpt} holds no conv_depth.weight: not a DPT head checkpoint")
        n_out = head["conv_depth.weight"].shape[0]
        self.model = DinoDPTDepther(arch=arch, classify=n_out > 1, n_bins=max(n_out, 2), dtype=dtype)
        load_depther_part(self.model.backbone, backbone, "dinov2")
        load_depther_part(self.model.decode_head, head, "dpt_head")
        self.model.to(device).eval()
        self.device = device
        self.seconds = {"backbone": 0.0, "head": 0.0}

    @torch.inference_mode()
    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img (H, W, 3) float32 in [0, 1] -> (H, W) depth in model units."""
        t0 = time.perf_counter()
        x = torch.from_numpy((img * 255.0 - MEAN) / STD).permute(2, 0, 1)[None].to(self.device)
        feats = self.model.features(x)
        _sync(self.device)
        t1 = time.perf_counter()
        out = self.model.head(feats, tuple(x.shape[-2:]))[0, 0].cpu().numpy()
        self.seconds["backbone"] += t1 - t0
        self.seconds["head"] += time.perf_counter() - t1
        return out


def dpt_depth(model, processor, image: Image.Image, device: torch.device) -> np.ndarray:
    inputs = {k: v.to(device) for k, v in processor(images=image, return_tensors="pt").items()}
    with torch.inference_mode():
        out = model(**inputs).predicted_depth[0].float().cpu().numpy()
    out = out - out.min()
    return out / (out.max() + 1e-8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--estimator", choices=["dinov2", "dpt", "sobel"], default="sobel")
    ap.add_argument("--backbone-ckpt", default=None, help="DINOv2 backbone .pth or JAX .npz")
    ap.add_argument("--head-ckpt", default=None, help="DPT head .pth or JAX .npz")
    ap.add_argument("--arch", default="vitl14", choices=ARCHS)
    ap.add_argument("--model-path", default=None, help="local Hugging Face DPT checkpoint dir")
    ap.add_argument("--render", choices=["gray", "magma"], default="gray")
    ap.add_argument("--long-side", type=int, default=0,
                    help="resize so the long side is N before estimating (the depth is resized back to "
                         "the source size); 0 = native resolution")
    ap.add_argument("--suffix", default="_depth.png")
    ap.add_argument("--fp32", action="store_true", help="dinov2 in fp32 (default: bf16 autocast)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI. Returns a summary: images listed and written, the
    seconds of the loop and its parts (decode, backbone, head, write; the
    backbone and head for dinov2 only, "estimate" for the others)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = processor = depther = None
    if args.estimator == "dpt":
        if not args.model_path:
            raise SystemExit("--estimator dpt requires --model-path (a local checkpoint directory)")
        from transformers import AutoImageProcessor, DPTForDepthEstimation

        processor = AutoImageProcessor.from_pretrained(args.model_path)
        model = DPTForDepthEstimation.from_pretrained(args.model_path).to(device).eval()
    elif args.estimator == "dinov2":
        depther = Dinov2Depther(args.arch, args.backbone_ckpt, args.head_ckpt, device,
                                torch.float32 if args.fp32 else torch.bfloat16)
    os.makedirs(args.out_dir, exist_ok=True)

    files = sorted(os.listdir(args.image_dir))
    parts = {"decode": 0.0, "estimate": 0.0, "write": 0.0}
    written = 0
    t_loop = time.perf_counter()
    for i, fname in enumerate(files):
        t0 = time.perf_counter()
        try:
            with Image.open(os.path.join(args.image_dir, fname)) as im:
                im = im.convert("RGB")
                size = im.size
                if args.long_side:
                    scale = args.long_side / max(im.size)
                    im = im.resize((round(im.width * scale), round(im.height * scale)), Image.BILINEAR)
                arr = np.asarray(im, np.float32) / 255.0
        except (OSError, ValueError) as e:
            print(f"skip {fname}: {e}")
            continue
        t1 = time.perf_counter()
        if args.estimator == "dinov2":
            depth = depther(arr)
        elif args.estimator == "dpt":
            depth = dpt_depth(model, processor, im, device)
        else:
            depth = sobel_pseudo_depth(arr)
        t2 = time.perf_counter()
        # resize the float depth before rendering: bilinear blending of
        # colormapped uint8 is not monotonic in the magma_r ramp
        if (depth.shape[1], depth.shape[0]) != size:
            depth = np.asarray(Image.fromarray(depth.astype(np.float32), mode="F").resize(size, Image.BILINEAR))
        if args.render == "magma":
            out_img = Image.fromarray(render_depth(depth))
        else:
            lo, hi = depth.min(), depth.max()
            out_img = Image.fromarray(((depth - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8))
        out_img.save(os.path.join(args.out_dir, os.path.splitext(fname)[0] + args.suffix))
        written += 1
        parts["decode"] += t1 - t0
        parts["estimate"] += t2 - t1
        parts["write"] += time.perf_counter() - t2
        if i % 100 == 0:
            print(f"{i}/{len(files)}")
    seconds = time.perf_counter() - t_loop
    if depther is not None:
        parts.pop("estimate")
        parts.update(depther.seconds)
    print(f"wrote {written} depth maps -> {args.out_dir}")
    return {"images": len(files), "written": written, "seconds": seconds, "parts_s": parts}


if __name__ == "__main__":
    main()
