"""Helpers shared by the tests that hold the port's model family to
``dgtd_tpu`` (``tests/test_torch_variants.py``, ``test_torch_ablations.py``,
``test_torch_dqnet.py``): tiny settings, seeded inputs, weights carried
across by ``convert.state_dict_from_flax``, and the JAX loss, gradients and
predictions with DropPath off (the port's drop-path rates are 0 there).
"""

import os
import re

import numpy as np
import torch
from PIL import Image

import flax.linen as fnn
import jax
from flax.traverse_util import flatten_dict, unflatten_dict

from dgtd_tpu.models.layers import DropPath as JaxDropPath
from dgtd_tpu_torch import predict as port_predict
from dgtd_tpu_torch.convert import _split, map_flax_key, state_dict_from_flax
from dgtd_tpu_torch.data.device_norm import IMAGENET_MEAN, IMAGENET_STD
from dgtd_tpu_torch.models import diffusion as MD
from dgtd_tpu_torch.models.layers import DropPath

#: tiny cod: PVT ``tiny``, a 1-block ConvNeXt; 2 refinement iterations, so
#: that every decoder module (compress_out, out_CFM) is in the loss
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2)
NO_DROP = dict(drop_path_rate=0.0, convnext_drop_path_rate=0.0)
#: batch 2 at 64x80 (non-square). At 32x40 the stride-32 map is 1x2 and
#: compress_out's output 1x1, and the JAX package's own fp32 gradient of
#: compress_out strays from a float64 evaluation by more than the bar below
#: (the port's less): the fp32 bar needs maps of a few pixels
SHAPE = (2, 64, 80)
# fp32 on both sides (tests/test_torch_train.py's bar): probabilities to
# 1e-5, the loss to 1e-5 relative, each gradient to 1e-4 of its largest entry
PROB_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def flat_variables(variables) -> dict:
    """JAX variables -> flat {'params/...', 'batch_stats/...'} numpy."""
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(dict(variables)), sep="/").items()}


def nested(flat: dict) -> dict:
    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def flax_from_port(jm, init_args, state: dict, key_of=None) -> dict:
    """The JAX module ``jm``'s variables (flat numpy, ``params/…`` and
    ``batch_stats/…``) holding the port's ``state``: the tree of
    ``jm.init(key, *init_args)`` from ``jax.eval_shape`` (nothing compiled
    or run), each leaf the port entry named by ``key_of(path)`` (default:
    ``convert.map_flax_key``'s) in flax's layout (a conv kernel (kh, kw,
    in, out), a Dense kernel (in, out))."""
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *init_args))
    out = {}
    for key, leaf in flatten_dict(dict(tree), sep="/").items():
        coll, path = _split(key)
        t = state[key_of(path) if key_of else map_flax_key(path, coll)[0]].detach().cpu().numpy()
        t = t.transpose(2, 3, 1, 0) if t.ndim == 4 else t.T if path.endswith("kernel") else t
        assert t.shape == leaf.shape, (key, t.shape, leaf.shape)
        out[key] = t
    return out


def linear_key(path: str) -> str:
    """A flax ``{name: {Dense_0: {kernel, bias}}}`` or bare-array path ->
    the port's key (``WindowFusion``'s)."""
    t = path.split("/")
    return t[0] if len(t) == 1 else f"{t[0]}.{'weight' if t[-1] == 'kernel' else 'bias'}"


CAB_INNER = {"Conv_0/Conv_0": "body.0", "PReLU_0": "body.1", "Conv_1/Conv_0": "body.2",
             "CALayer_0/Conv_0/Conv_0": "CA.conv_du.0", "CALayer_0/Conv_1/Conv_0": "CA.conv_du.2"}


def mpr_key(path: str, num_cab: int = 0) -> str:
    """A flax MPRNet param path -> the port's key (MPRNet's own names)."""
    t = path.split("/")
    leaf = t.pop()
    out = []
    for i, tok in enumerate(t):
        rest = "/".join(t[i:])
        if rest in CAB_INNER:
            out.append(CAB_INNER[rest])
            break
        m = re.fullmatch(r"(up_(?:enc|dec)2)_(\d)", tok)
        if t[i + 1:] == ["Conv_0", "Conv_0"] and (tok.startswith(("down", "up")) or m):
            out += ([m.group(1), m.group(2)] if m else [tok]) + ["down.1" if tok.startswith("down") else "up.1"]
            break
        if tok == "tail":
            out += ["body", str(num_cab)]
            break
        m = re.fullmatch(r"cab(\d+)", tok)
        out.append(m.group(1) if m else tok)
        if t[i + 1:] == ["Conv_0"]:
            break
    return ".".join(out) + "." + {"kernel": "weight", "bias": "bias", "alpha": "weight"}[leaf]


def batch(seed: int, shape=SHAPE) -> dict:
    b, h, w = shape
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(b, h, w, 3).astype(np.float32),
            "depth": rng.rand(b, h, w, 1).astype(np.float32),
            "label": (rng.rand(b, h, w, 1) > 0.5).astype(np.float32)}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _no_drop_path(next_fun, args, kwargs, context):
    if isinstance(context.module, JaxDropPath) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def jax_results(jm, variables, b: dict) -> dict:
    """The JAX model's eval prediction, texture, loss terms and parameter
    gradients on batch ``b`` (DropPath off)."""
    prob, extras = jax.jit(lambda v, i, d: jm.predict(v, i, d))(variables, b["input"], b["depth"])

    def loss_fn(params):
        return jm.loss({**variables, "params": params}, b, rngs={"dropout": jax.random.PRNGKey(1)})

    with fnn.intercept_methods(_no_drop_path):
        (_, (aux, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    texture = extras["texture"]
    return {"prob": np.asarray(prob), "texture": None if texture is None else np.asarray(texture),
            "aux": {k: float(v) for k, v in aux.items()},
            "grads": state_dict_from_flax(flat_variables({"params": grads}))}


def carry(pm: torch.nn.Module, flat: dict) -> torch.nn.Module:
    """Load JAX variables into the port model; only BatchNorm's step
    counters may stay unloaded."""
    result = pm.load_state_dict(state_dict_from_flax(flat), strict=False)
    assert result.unexpected_keys == []
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys), result.missing_keys[:5]
    return pm


def no_drop_path(pm: torch.nn.Module) -> torch.nn.Module:
    """Drop-path rates of 0 (for a model whose constructor takes none)."""
    for m in pm.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return pm


def assert_matches_jax(pm, ref: dict, b: dict, frozen=()) -> None:
    """The port model's prediction, texture, loss terms and every gradient
    against ``jax_results``. Parameters under ``frozen`` must get no
    gradient in the port and an exact 0 in JAX."""
    tb = torch_batch(b)
    prob, extras = pm.predict(tb["input"], tb["depth"])
    np.testing.assert_allclose(prob.numpy(), ref["prob"], rtol=0, atol=PROB_ATOL)
    if ref["texture"] is None:
        assert extras["texture"] is None
    else:
        np.testing.assert_allclose(extras["texture"].numpy(), ref["texture"], rtol=0, atol=PROB_ATOL)
    pm.zero_grad(set_to_none=True)
    loss, aux = pm.loss(tb["input"], tb["depth"], tb["label"])
    loss.backward()
    assert set(aux) == set(ref["aux"])
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(float(aux[k].detach()), v, rtol=LOSS_RTOL, err_msg=k)
    named = dict(pm.named_parameters())
    assert set(named) == set(ref["grads"])
    scale = max(float(v.abs().max()) for v in ref["grads"].values())
    for n, p in named.items():
        want = ref["grads"][n]
        if n.startswith(tuple(frozen)):
            assert p.grad is None and not bool(want.any()), n
            continue
        limit = GRAD_RTOL * max(float(want.abs().max()), 1e-4 * scale)
        diff = float((p.grad - want).abs().max())
        assert diff <= limit, f"{n}: {diff:.3e} > {limit:.3e}"


def serve_and_check(root, pm, model: str, model_args, n: int = 3, size: int = 32):
    """``python -m dgtd_tpu_torch.predict --model <model>`` on CPU over ``n``
    written PNG pairs with ``pm``'s weights: the masks are ``pm``'s own
    predictions (within one grey level) and no stencil runs. Returns the
    CLI's summary."""
    rng = np.random.RandomState(3)
    for sub in ("img", "dep"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (36, 44, 3)).astype(np.uint8)).save(os.path.join(root, "img", f"im{i}.png"))
        Image.fromarray(rng.randint(0, 256, (36, 44)).astype(np.uint8)).save(os.path.join(root, "dep", f"im{i}_depth.png"))
    torch.save(pm.state_dict(), os.path.join(root, "w.pth"))
    calls = []
    planes = MD.diffusion_planes
    MD.diffusion_planes = lambda *a, **k: calls.append(1) or planes(*a, **k)
    try:
        summary = port_predict.main(["--checkpoint", os.path.join(root, "w.pth"), "--model", model,
                                     "--image-dir", os.path.join(root, "img"), "--depth-dir", os.path.join(root, "dep"),
                                     "--out-dir", os.path.join(root, "out"), "--size", str(size), "--batch", "2",
                                     "--fp32", "--device", "cpu"] + list(model_args))
    finally:
        MD.diffusion_planes = planes
    assert summary["images"] == n and calls == []
    for i in range(n):
        with Image.open(os.path.join(root, "img", f"im{i}.png")) as im:
            img = np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR), np.float32) / 255.0
        with Image.open(os.path.join(root, "dep", f"im{i}_depth.png")) as im:
            dep = np.asarray(im.convert("L").resize((size, size), Image.BILINEAR), np.float32) / 255.0
        img = ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        prob = pm.predict(torch.from_numpy(img[None]), torch.from_numpy(dep[None, ..., None]))[0]
        want = (np.clip(prob[0, ..., 0].numpy(), 0, 1) * 255).astype(np.uint8).astype(int)
        with Image.open(os.path.join(root, "out", f"im{i}_output.png")) as im:
            assert np.abs(np.asarray(im).astype(int) - want).max() <= 1
    return summary
