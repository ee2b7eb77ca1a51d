"""Offline depth maps for the RGB-D datasets (counterpart of
``dgtd_tpu/tools/depth_gen.py``).

Writes one ``<stem>_depth.png`` an image, which the datasets read through
``depth_dir``. Estimators:
  * ``dinov2``: DINOv2 ViT-*/14 + DPT head (``models/dinov2.py``,
    ``models/dpt.py``) from local files: the official
    ``dinov2_vit*14_pretrain.pth`` and ``dinov2_vit*14_nyu_dpt_head.pth``,
    or JAX ``.npz`` files (``dgtd_tpu.tools.convert_ckpt dinov2`` /
    ``dpt_head``). A missing file, a missing parameter or a mismatched
    shape raises; nothing falls back to ``sobel``. The uint8 images are
    normalized on the device (``normalize_image``: ImageNet's mean and std,
    the release's 123.675/58.395, ... on [0, 255]); ``--batch N`` runs up
    to N consecutive images whose resized shape is the same as one batch;
  * ``dpt``: a local Hugging Face DPT checkpoint (``transformers``);
  * ``sobel``: weights-free pseudo-depth (blur + inverted gradient).

Rendering: ``--render gray`` (default) saves the min-max normalized depth;
``--render magma`` saves the reference's magma_r RGB, which the datasets
re-read as 8-bit grayscale. The depth is resized back to the source size as
floats before rendering.

    python -m dgtd_tpu_torch.tools.depth_gen --image-dir data/Imgs --out-dir data/depth \\
        [--estimator dinov2|dpt|sobel] [--backbone-ckpt ...] [--head-ckpt ...] [--arch vitl14] \\
        [--render gray|magma] [--long-side 518] [--batch 1] [--fp32] [--device cpu]

Runs on CUDA unless ``--device`` names another device (a missing card
raises), in bf16 autocast unless ``--fp32``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from ..core.device import resolve_device
from ..core.trace import span
from ..data.device_norm import normalize_image

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


class Dinov2Depther:
    """The DINOv2 + DPT depther on ``device``, from a built
    :class:`~dgtd_tpu_torch.models.dpt.DinoDPTDepther` (its weights and
    ``dtype`` as they are) or, through :meth:`from_files`, from the two
    checkpoint files.

    :meth:`batch` is the one path: uint8 RGB in, fp32 depth on the card
    out, with no host synchronisation. With ``time_parts`` each batch
    records the backbone's and the head's time (CUDA events on the card,
    the host clock elsewhere); :meth:`parts` sums them once the batches'
    results have reached the host."""

    def __init__(self, model, device: torch.device, time_parts: bool = False):
        self.model = model.to(device).eval()
        self.device = torch.device(device)
        self.time_parts = time_parts
        self._marks = []

    @classmethod
    def from_files(cls, arch: str, backbone_ckpt: str, head_ckpt: str, device: torch.device,
                   dtype: torch.dtype = torch.bfloat16, time_parts: bool = False) -> "Dinov2Depther":
        """The depther of the released ``dinov2_vit*14_pretrain.pth`` and
        ``dinov2_vit*14_*_dpt_head.pth`` (or their JAX ``.npz``). The head's
        kind (classify or regression) and bin count come from
        ``conv_depth``'s output channels."""
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
        model = DinoDPTDepther(arch=arch, classify=n_out > 1, n_bins=max(n_out, 2), dtype=dtype)
        load_depther_part(model.backbone, backbone, "dinov2")
        load_depther_part(model.decode_head, head, "dpt_head")
        return cls(model, device, time_parts)

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    @torch.inference_mode()
    def batch(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 RGB (B, H, W, 3) on the host (pinned, for the copy to
        overlap) -> (B, H, W) fp32 depth in model units on the card. The
        copy, the normalization (``normalize_image``) and the model are
        enqueued; nothing waits for the card."""
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"batch takes uint8 RGB (B, H, W, 3), got {images.dtype} {tuple(images.shape)}")
        with span("dgtd.depther"):
            t0 = self._mark() if self.time_parts else None
            x = normalize_image(images.to(self.device, non_blocking=True)).permute(0, 3, 1, 2)
            feats = self.model.features(x)
            t1 = self._mark() if self.time_parts else None
            depth = self.model.head(feats, tuple(x.shape[-2:]))[:, 0]
            if self.time_parts:
                self._marks.append((t0, t1, self._mark()))
        return depth

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img uint8 (H, W, 3) -> (H, W) depth in model units: a batch of
        one."""
        return self.batch(torch.from_numpy(np.ascontiguousarray(img))[None])[0].cpu().numpy()

    def parts(self) -> dict:
        """Seconds of the backbone and of the head summed over the timed
        batches, all of whose results are on the host."""
        out = {"backbone": 0.0, "head": 0.0}
        for t0, t1, t2 in self._marks:
            if self.device.type == "cuda":
                out["backbone"] += t0.elapsed_time(t1) * 1e-3
                out["head"] += t1.elapsed_time(t2) * 1e-3
            else:
                out["backbone"] += t1 - t0
                out["head"] += t2 - t1
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
    ap.add_argument("--batch", type=int, default=1,
                    help="dinov2: up to N consecutive images of the same resized shape in one batch")
    ap.add_argument("--suffix", default="_depth.png")
    ap.add_argument("--fp32", action="store_true", help="dinov2 in fp32 (default: bf16 autocast)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    return ap.parse_args(argv)


def _write(depth: np.ndarray, size, render: str, path: str) -> None:
    """Resize the float depth back to ``size`` (W, H) before rendering:
    bilinear blending of colormapped uint8 is not monotonic in the magma_r
    ramp."""
    if (depth.shape[1], depth.shape[0]) != size:
        depth = np.asarray(Image.fromarray(depth.astype(np.float32), mode="F").resize(size, Image.BILINEAR))
    if render == "magma":
        out_img = Image.fromarray(render_depth(depth))
    else:
        lo, hi = depth.min(), depth.max()
        out_img = Image.fromarray(((depth - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8))
    out_img.save(path)


def main(argv=None):
    """Run the CLI. Returns a summary: images listed and written, the
    seconds of the loop and its parts (decode, backbone, head, write; the
    backbone and head for dinov2 only, "estimate" for the others)."""
    args = parse_args(argv)
    if args.batch < 1:
        raise ValueError(f"--batch must be at least 1, got {args.batch}")
    device = resolve_device(args.device)
    model = processor = depther = None
    if args.estimator == "dpt":
        if not args.model_path:
            raise SystemExit("--estimator dpt requires --model-path (a local checkpoint directory)")
        from transformers import AutoImageProcessor, DPTForDepthEstimation

        processor = AutoImageProcessor.from_pretrained(args.model_path)
        model = DPTForDepthEstimation.from_pretrained(args.model_path).to(device).eval()
    elif args.estimator == "dinov2":
        depther = Dinov2Depther.from_files(args.arch, args.backbone_ckpt, args.head_ckpt, device,
                                           torch.float32 if args.fp32 else torch.bfloat16, time_parts=True)
    os.makedirs(args.out_dir, exist_ok=True)

    files = sorted(os.listdir(args.image_dir))
    parts = {"decode": 0.0, "estimate": 0.0, "write": 0.0}
    written = 0
    # dinov2: consecutive images of one resized shape, (name, source size, uint8 array)
    group = []

    def save(fname, size, depth):
        nonlocal written
        t0 = time.perf_counter()
        _write(depth, size, args.render, os.path.join(args.out_dir, os.path.splitext(fname)[0] + args.suffix))
        written += 1
        parts["write"] += time.perf_counter() - t0

    def flush():
        if not group:
            return
        images = torch.from_numpy(np.stack([arr for _, _, arr in group]))
        if device.type == "cuda":
            images = images.pin_memory()
        depths = depther.batch(images).cpu().numpy()
        for (fname, size, _), depth in zip(group, depths):
            save(fname, size, depth)
        group.clear()

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
                arr = np.asarray(im, np.uint8)
        except (OSError, ValueError) as e:
            print(f"skip {fname}: {e}")
            continue
        parts["decode"] += time.perf_counter() - t0
        if depther is not None:
            if group and (len(group) == args.batch or group[0][2].shape != arr.shape):
                flush()
            group.append((fname, size, arr))
        else:
            t1 = time.perf_counter()
            if args.estimator == "dpt":
                depth = dpt_depth(model, processor, im, device)
            else:
                depth = sobel_pseudo_depth(arr.astype(np.float32) / 255.0)
            parts["estimate"] += time.perf_counter() - t1
            save(fname, size, depth)
        if i % 100 == 0:
            print(f"{i}/{len(files)}")
    flush()
    seconds = time.perf_counter() - t_loop
    if depther is not None:
        parts.pop("estimate")
        parts.update(depther.parts())
    print(f"wrote {written} depth maps -> {args.out_dir}")
    return {"images": len(files), "written": written, "seconds": seconds, "parts_s": parts}


if __name__ == "__main__":
    main()
