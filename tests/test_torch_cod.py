"""The port's ``cod`` model and serving CLI vs ``dgtd_tpu`` (fp32, CPU).

One JAX init of a tiny ``cod`` is carried across by ``state_dict_from_flax``;
both sides then predict on the same numpy inputs.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.tools.convert_ckpt import export_state_dict
from dgtd_tpu_torch import predict as port_predict
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.models.cod import cod as PortCod
from dgtd_tpu_torch.ops import diffusion as D

TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2)
TINY_ARGS = ["-o", "variant=tiny", "-o", "convnext_dims=[8,16,32,64]", "-o", "convnext_depths=[1,1,1,1]",
             "-o", "channel=8", "-o", "latent_dim=8", "-o", "grid=8", "-o", "refine_iters=2"]
# fp32 on both sides; observed max difference ~1e-7 at the probability surface
PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def carried():
    jm = JaxCod(dtype=jnp.float32, **TINY)
    variables = jm.init(jax.random.PRNGKey(0), (1, 64, 64, 3))
    flat = {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables), sep="/").items()}
    pm = PortCod(dtype=torch.float32, seed=None, **TINY)
    result = pm.load_state_dict(state_dict_from_flax(flat), strict=False)
    assert result.unexpected_keys == []
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    # one compiled JAX predict, always called at batch 2 and 64² (XLA CPU
    # compiles dominate this file's time)
    jax_predict = jax.jit(lambda v, i, d: jm.predict(v, i, d)[0])
    return jm, variables, flat, pm, jax_predict


def _inputs(seed, b, h, w):
    rng = np.random.RandomState(seed)
    return rng.randn(b, h, w, 3).astype(np.float32), rng.rand(b, h, w, 1).astype(np.float32)


def test_tiny_cod_predict_matches_jax(carried):
    _, variables, _, pm, jax_predict = carried
    img, dep = _inputs(0, 2, 64, 64)
    ref = np.asarray(jax_predict(variables, img, dep))
    prob, extras = pm.predict(torch.from_numpy(img), torch.from_numpy(dep))
    assert prob.shape == (2, 64, 64, 1) and prob.dtype == torch.float32
    assert extras["texture"].shape == (2, 64, 64, 3)
    np.testing.assert_allclose(prob.numpy(), ref, rtol=0, atol=PROB_ATOL)


def test_tiny_cod_predict_out_size_and_tensor_match_jax(carried):
    jm, variables, _, pm, _ = carried
    img, dep = _inputs(1, 1, 64, 48)
    ref, (_, stages_ref, pred2_ref) = jax.jit(
        lambda v, i, d: (jm.predict(v, i, d, out_size=(80, 56))[0], jm.tensor(v, i, d))
    )(variables, img, dep)
    prob = pm.predict(torch.from_numpy(img), torch.from_numpy(dep), out_size=(80, 56))[0]
    np.testing.assert_allclose(prob.numpy(), np.asarray(ref), rtol=0, atol=PROB_ATOL)
    _, stages, pred2 = pm.tensor(torch.from_numpy(img), torch.from_numpy(dep))
    assert len(stages) == len(stages_ref) == TINY["refine_iters"]
    # logits are pre-sigmoid: ~4x the probability tolerance
    np.testing.assert_allclose(stages[-1].numpy(), np.asarray(stages_ref[-1]), rtol=0, atol=4 * PROB_ATOL)
    np.testing.assert_allclose(pred2.numpy(), np.asarray(pred2_ref), rtol=0, atol=4 * PROB_ATOL)


def test_tiny_cod_nhwc_layout_matches_the_planes_and_jax(carried):
    """``diffusion_plane_layout=False`` (the NHWC stencil) equals ``True``
    (the plane stencil) and the JAX model under its own flag ``False`` (the
    jnp NHWC stencil; on the CPU its automatic choice too, so the compiled
    predict of this module serves)."""
    from dgtd_tpu.core import flags as jax_flags
    from dgtd_tpu_torch.core import flags as port_flags

    _, variables, _, pm, jax_predict = carried
    img, dep = _inputs(5, 2, 64, 64)
    saved = (jax_flags.diffusion_plane_layout, port_flags.diffusion_plane_layout)
    try:
        jax_flags.set_flag("diffusion_plane_layout", False)
        ref = np.asarray(jax_predict(variables, img, dep))
        probs = {}
        for value in (True, False):
            port_flags.set_flag("diffusion_plane_layout", value)
            probs[value] = pm.predict(torch.from_numpy(img), torch.from_numpy(dep))[0].numpy()
    finally:
        jax_flags.set_flag("diffusion_plane_layout", saved[0])
        port_flags.set_flag("diffusion_plane_layout", saved[1])
    np.testing.assert_allclose(probs[False], probs[True], rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(probs[False], ref, rtol=0, atol=PROB_ATOL)


def test_state_dict_from_flax_agrees_with_export_state_dict(carried):
    _, _, flat, pm, _ = carried
    template = {k: v.numpy() for k, v in pm.state_dict().items()}
    exported, left, missing = export_state_dict(flat, template)
    assert missing == []
    assert all(k.endswith("num_batches_tracked") for k in left)
    ours = state_dict_from_flax(flat)
    assert set(ours) == set(template) - set(left)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), exported[k], err_msg=k)


def _write_inputs(root, n, size=(40, 52)):
    rng = np.random.RandomState(3)
    (root / "img").mkdir()
    (root / "dep").mkdir()
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, size + (3,)).astype(np.uint8)).save(root / "img" / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, size).astype(np.uint8)).save(root / "dep" / f"im{i}_depth.png")


def _read_masks(d, n):
    return np.stack([np.asarray(Image.open(os.path.join(d, f"im{i}_output.png"))) for i in range(n)])


def test_predict_cli_serves_on_cpu(carried, tmp_path):
    """The CLI on CPU: .pth and JAX .npz checkpoints give the same masks, the
    tail batch is padded, uint8 ingest agrees, and the masks match the JAX
    model's predictions."""
    _, variables, flat, pm, jax_predict = carried
    n = 5
    _write_inputs(tmp_path, n)
    pth, npz = tmp_path / "w.pth", tmp_path / "w.npz"
    torch.save(pm.state_dict(), pth)
    np.savez(npz, **flat)
    common = ["--image-dir", str(tmp_path / "img"), "--depth-dir", str(tmp_path / "dep"),
              "--size", "64", "--batch", "2", "--fp32", "--device", "cpu"] + TINY_ARGS
    before = (D.FUSED_LAUNCHES, D.LAUNCHES, D.TILED_LAUNCHES)
    summary = port_predict.main(["--checkpoint", str(pth), "--out-dir", str(tmp_path / "a")] + common)
    assert summary["images"] == n and summary["batches"] == 3
    port_predict.main(["--checkpoint", str(npz), "--out-dir", str(tmp_path / "b")] + common)
    # uint8 ingest: normalized on the device, differs only by input rounding
    port_predict.main(["--checkpoint", str(pth), "--out-dir", str(tmp_path / "c"), "--uint8-io"] + common)
    assert (D.FUSED_LAUNCHES, D.LAUNCHES, D.TILED_LAUNCHES) == before  # CPU path: plain version, no kernel launch
    a, b, c = (_read_masks(tmp_path / d, n) for d in "abc")
    assert a.shape == (n, 64, 64) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() <= 2

    # the JAX model on the same decoded batch: masks agree to one grey level
    from dgtd_tpu.data.datasets import IMAGENET_MEAN, IMAGENET_STD

    imgs, deps = [], []
    for i in range(n):
        with Image.open(tmp_path / "img" / f"im{i}.png") as im:
            imgs.append((np.asarray(im.convert("RGB").resize((64, 64), Image.BILINEAR), np.float32) / 255.0
                         - IMAGENET_MEAN) / IMAGENET_STD)
        with Image.open(tmp_path / "dep" / f"im{i}_depth.png") as im:
            deps.append(np.asarray(im.convert("L").resize((64, 64), Image.BILINEAR), np.float32)[..., None] / 255.0)
    pad = [np.zeros_like(imgs[0])], [np.zeros_like(deps[0])]
    ref = np.concatenate([
        np.asarray(jax_predict(variables, np.stack((imgs + pad[0])[s : s + 2]), np.stack((deps + pad[1])[s : s + 2])))
        for s in range(0, n, 2)
    ])[:n]
    ref_u8 = (np.clip(ref[..., 0], 0, 1) * 255).astype(np.uint8)
    assert np.abs(a.astype(int) - ref_u8.astype(int)).max() <= 1


def test_predict_cli_rejects_mispaired_depths(tmp_path):
    _write_inputs(tmp_path, 3)
    os.remove(tmp_path / "dep" / "im2_depth.png")
    with pytest.raises(SystemExit, match="counts must match"):
        port_predict.main(["--checkpoint", "unused.pth", "--image-dir", str(tmp_path / "img"),
                           "--depth-dir", str(tmp_path / "dep"), "--out-dir", str(tmp_path / "o"),
                           "--device", "cpu", "--size", "64"] + TINY_ARGS)


def test_predict_without_device_raises_when_no_card(monkeypatch, tmp_path):
    """Entry points default to CUDA and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predict.main(["--checkpoint", "unused.pth", "--image-dir", str(tmp_path),
                           "--out-dir", str(tmp_path / "o")])


@pytest.mark.slow
def test_full_width_cod_predict_matches_jax_384():
    """PVTv2-b2 + ConvNeXt-B at the recipe's 384², batch 1, fp32."""
    jm = JaxCod(dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), (1, 384, 384, 3))
    flat = {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables), sep="/").items()}
    pm = PortCod(dtype=torch.float32, seed=None)
    pm.load_state_dict(state_dict_from_flax(flat), strict=False)
    img, dep = _inputs(4, 1, 384, 384)
    ref = np.asarray(jax.jit(lambda v, i, d: jm.predict(v, i, d)[0])(variables, img, dep))
    prob = pm.predict(torch.from_numpy(img), torch.from_numpy(dep))[0].numpy()
    # 27-block ConvNeXt and 16 PVT blocks of fp32 round-off in two orders
    np.testing.assert_allclose(prob, ref, rtol=0, atol=1e-4)
