"""Batch inference: images (+ depth maps) -> segmentation masks, on the GPU
(counterpart of the root ``predict.py``).

    python -m dgtd_tpu_torch.predict --checkpoint weights.pth \\
        --image-dir data/Imgs --depth-dir data/depth --out-dir masks \\
        [--model cod|baseline|DQnet] [--size 384] [--batch 8] [--fp32] \\
        [-o variant=b0] [-o diffusion_kernel=11] [--device cpu]
    python -m dgtd_tpu_torch.predict --bundle bundle/ --image-dir ... --out-dir ... [--device cpu]

``--checkpoint`` takes a port ``state_dict`` (``.pth``; a reference
``epoch_N.pth`` loads too) or a JAX flat ``.npz``, carried across by
``convert.state_dict_from_flax``. Depth maps pair with images by sorted order;
without ``--depth-dir`` a zero depth plane is used. ``-o`` sets the model's
arguments (an ablation axis of ``docs/ABLATIONS.md``, a smaller variant).
``--bundle`` serves a bundle of ``tools/export_serving.py`` instead, one
image a call at its own size. Runs on CUDA unless ``--device`` names another
device; a missing card raises.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import models as _models  # noqa: F401  (registers the models)
from .core.config import parse_overrides
from .core.device import resolve_device
from .core.registry import MODELS
from .data.device_norm import IMAGENET_MEAN, IMAGENET_STD, normalize_image, scale_plane
from .utils.files import list_images


def read_checkpoint(path: str) -> dict:
    """The port's state dict from a ``.pth`` (a bare state dict or one under
    ``model`` or ``state_dict``) or from a JAX flat ``.npz``, carried across
    by ``convert.state_dict_from_flax``."""
    if path.endswith(".npz"):
        from .convert import state_dict_from_flax

        with np.load(path) as z:
            return state_dict_from_flax({k: z[k] for k in z.files})
    state = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("model", "state_dict"):
        if isinstance(state, dict) and wrap in state:
            state = state[wrap]
    return state


def load_checkpoint(model: torch.nn.Module, path: str):
    """Load a ``.pth`` state_dict or a JAX flat ``.npz`` into ``model``,
    leniently (a partial checkpoint is a legitimate debugging input). Returns
    (loaded keys, model keys left at init, checkpoint keys not used)."""
    state = read_checkpoint(path)
    result = model.load_state_dict(state, strict=False)
    unused = set(result.unexpected_keys)
    loaded = [k for k in state if k not in unused]
    return loaded, list(result.missing_keys), list(result.unexpected_keys)


def paired_depth_files(files, depth_dir):
    """Sorted depth listing, validated 1:1 against the image listing: depths
    pair by sorted index, so a count mismatch means silent mispairing."""
    if not depth_dir:
        return None
    depth_files = list_images(depth_dir)
    if len(depth_files) != len(files):
        raise SystemExit(
            f"--depth-dir has {len(depth_files)} files but the image dir has "
            f"{len(files)} — depths pair to images by sorted order, so the "
            "counts must match exactly (e.g. one *_depth.png per image)"
        )
    return depth_files


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=None, help="port state_dict .pth or JAX flat .npz")
    ap.add_argument(
        "--bundle", default=None,
        help="serve from a bundle dir (tools/export_serving.py) instead of building the model from "
        "code; exclusive with --checkpoint; one image a call at its own size",
    )
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--depth-dir", default=None)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--model", default="cod", help="a registered model: cod, baseline or DQnet")
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument(
        "--uint8-io", action="store_true",
        help="ship post-resize uint8 to the device and normalize there",
    )
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument(
        "-o", "--model-arg", action="append", default=[],
        help="model kwargs, e.g. -o variant=b0 -o convnext_depths=[1,1,2,1]",
    )
    args = ap.parse_args(argv)
    if bool(args.bundle) == bool(args.checkpoint):
        ap.error("exactly one of --checkpoint or --bundle is required")
    return args


def main(argv=None):
    """Run the CLI. Returns a summary dict: images, batches, and the seconds
    of the serving loop (first decode to last PNG written)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.bundle:
        return run_bundle(args, device)
    from PIL import Image

    files = list_images(args.image_dir)
    depth_files = paired_depth_files(files, args.depth_dir)
    os.makedirs(args.out_dir, exist_ok=True)

    model = MODELS.get(args.model)(
        dtype=torch.float32 if args.fp32 else torch.bfloat16, **parse_overrides(args.model_arg)
    )
    loaded, missed, unused = load_checkpoint(model, args.checkpoint)
    print(f"checkpoint: {len(loaded)} loaded / {len(missed)} missed / {len(unused)} unused")
    stats_missed = sum(k.endswith(("running_mean", "running_var")) for k in missed)
    if stats_missed:
        print(
            f"  warning: {stats_missed} BN running-stat buffers left at init "
            "(outputs will differ from the training-time model)"
        )
    model.to(device)

    def load(path, mode, norm):
        with Image.open(path) as im:
            resized = im.convert(mode).resize((args.size, args.size), Image.BILINEAR)
            if args.uint8_io:
                arr = np.asarray(resized, np.uint8)
                return arr[..., None] if arr.ndim == 2 else arr
            arr = np.asarray(resized, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return (arr - IMAGENET_MEAN) / IMAGENET_STD if norm else arr

    def load_chunk(start):
        chunk = files[start : start + args.batch]
        imgs = np.stack([load(os.path.join(args.image_dir, f), "RGB", True) for f in chunk])
        if depth_files:
            deps = np.stack(
                [load(os.path.join(args.depth_dir, d), "L", False) for d in depth_files[start : start + args.batch]]
            )
        else:
            deps = np.zeros(imgs.shape[:3] + (1,), imgs.dtype)
        # pad the tail batch to the served shape
        pad = args.batch - len(chunk)
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
            deps = np.concatenate([deps, np.zeros((pad,) + deps.shape[1:], deps.dtype)])
        return chunk, imgs, deps

    def predict(imgs, deps):
        image = normalize_image(torch.from_numpy(imgs).to(device, non_blocking=True))
        depth = scale_plane(torch.from_numpy(deps).to(device, non_blocking=True))
        prob = model.predict(image, depth)[0]
        host = prob.to("cpu", non_blocking=True)
        done = torch.cuda.Event() if device.type == "cuda" else None
        if done is not None:
            done.record()
        return host, done

    def flush(chunk, host, done):
        if done is not None:
            done.synchronize()
        probs = host.numpy()
        for f, prob in zip(chunk, probs):
            name = os.path.splitext(f)[0]
            Image.fromarray((np.clip(prob[..., 0], 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(args.out_dir, f"{name}_output.png")
            )

    # one-batch-deep pipeline: decode batch N+1 and write batch N-1's PNGs
    # while the device runs batch N
    t0 = time.perf_counter()
    starts = list(range(0, len(files), args.batch))
    done_n = 0
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(load_chunk, starts[0])
        pending = None
        for s in starts[1:] + [None]:
            chunk, imgs, deps = nxt.result()
            if s is not None:
                nxt = pool.submit(load_chunk, s)
            out = predict(imgs, deps)
            if pending is not None:
                flush(pending[0], *pending[1])
                done_n += len(pending[0])
                print(f"{done_n}/{len(files)}")
            pending = (chunk, out)
        flush(pending[0], *pending[1])
        done_n += len(pending[0])
        print(f"{done_n}/{len(files)}")
    return {"images": len(files), "batches": len(starts), "loop_s": time.perf_counter() - t0}


def run_bundle(args, device: torch.device) -> dict:
    """Folder inference through a bundle (the root ``predict.py``'s
    ``_run_bundle``): one image a call at its own size (the bundle buckets
    and resizes), its depth resized to it with PIL's bilinear filter, or a
    zero plane without ``--depth-dir``; writes ``<name>_output.png`` at the
    image's size."""
    from PIL import Image

    from .tools.export_serving import ServingModel

    serving = ServingModel.load(args.bundle, device)
    print(f"bundle: sizes {serving.sizes}, platforms {serving.meta.get('platforms')}, on {device}")
    files = list_images(args.image_dir)
    depth_files = paired_depth_files(files, args.depth_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i, f in enumerate(files):
        with Image.open(os.path.join(args.image_dir, f)) as im:
            rgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
            size = im.size
        img = ((rgb - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)[None]
        if depth_files:
            with Image.open(os.path.join(args.depth_dir, depth_files[i])) as dm:
                dep = np.asarray(dm.convert("L").resize(size, Image.BILINEAR), np.float32)[None, ..., None] / 255.0
        else:
            dep = np.zeros(img.shape[:3] + (1,), np.float32)
        prob = serving(img, dep)
        name = os.path.splitext(f)[0]
        Image.fromarray((np.clip(prob[0, ..., 0], 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(args.out_dir, f"{name}_output.png")
        )
        print(f"{i + 1}/{len(files)}")
    return {"images": len(files), "batches": len(files), "loop_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
