"""The port's serving bundles (``dgtd_tpu_torch/tools/export_serving.py``,
``python -m dgtd_tpu_torch.predict --bundle``) and the ``dgtd_torch::``
custom ops that let ``torch.export`` trace the kernels' wrappers.

One module-scoped bundle of a tiny ``cod`` at 48² (fp32, CPU), exported
through the tool's ``main`` from a JAX flat checkpoint. The JAX package is
used only for its checkpoint converter (numpy) and ``jax.image.resize``;
no JAX model is compiled.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.models.cod import cod
from dgtd_tpu_torch.ops import diffusion as D
from dgtd_tpu_torch.ops import layernorm as L
from dgtd_tpu_torch.ops import msda as A
from dgtd_tpu_torch.tools import export_serving as E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2)
TINY_YAML = """model:
  type: cod
  variant: tiny
  convnext_dims: [8, 16, 32, 64]
  convnext_depths: [1, 1, 1, 1]
  channel: 8
  latent_dim: 8
  grid: 8
  refine_iters: 2
"""
SIZE = 48
# the program runs the eager model's operations on the same CPU: equal to
# float rounding
BUNDLE_ATOL = 1e-6
# jax.image.resize's weights in float32 and another contraction order
RESIZE_ATOL = 1e-5


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A bundle exported by the tool's main from a JAX flat .npz of a tiny
    cod's weights (seed 3, unlike the seed-0 init that main builds), and the
    eager model those weights load into."""
    from dgtd_tpu.tools.convert_ckpt import convert_state_dict

    root = tmp_path_factory.mktemp("bundle")
    source = cod(dtype=torch.float32, seed=3, **TINY)
    flat, skipped = convert_state_dict({k: v.numpy() for k, v in source.state_dict().items()}, "full")
    assert all(k.endswith("num_batches_tracked") for k in skipped)
    ckpt = str(root / "epoch_1.npz")
    np.savez(ckpt, **flat)
    config = root / "tiny.yml"
    config.write_text(TINY_YAML)
    out = str(root / "bundle")
    meta = E.main(["--config", str(config), "--ckpt", ckpt, "--sizes", str(SIZE), "--platforms", "cpu",
                   "--fp32", "--out", out])
    model = cod(dtype=torch.float32, seed=None, **TINY)
    model.load_state_dict(state_dict_from_flax(flat), strict=False)
    return out, model, meta, flat, E.ServingModel.load(out, "cpu")


def _inputs(seed, h, w):
    rng = np.random.RandomState(seed)
    return rng.randn(1, h, w, 3).astype(np.float32), rng.rand(1, h, w, 1).astype(np.float32)


def test_bundle_files_and_meta(bundle):
    out, _, meta, flat, _ = bundle
    assert sorted(os.listdir(out)) == ["meta.json", "params.npz", f"predict_{SIZE}_cpu.pt2"]
    with open(os.path.join(out, "meta.json")) as f:
        disk = json.load(f)
    assert disk["format_version"] == E.FORMAT_VERSION == 1
    assert disk["sizes"] == [SIZE] and disk["platforms"] == ["cpu"] and disk["model"] == "cod"
    assert disk["artifacts"] == {str(SIZE): {"cpu": f"predict_{SIZE}_cpu.pt2"}}
    assert disk["compute"] == "float32" and disk["ckpt"].endswith("epoch_1.npz")
    assert disk["loaded_params"] == len(state_dict_from_flax(flat))
    assert meta["export_seconds"]["cpu"][str(SIZE)] > 0


def test_params_npz_is_state_dict_from_flax_of_the_ckpt(bundle):
    """(b): a bundle built from a JAX flat --ckpt holds exactly
    ``state_dict_from_flax`` of it, float32, key for key."""
    out, _, _, flat, _ = bundle
    want = state_dict_from_flax(flat)
    with np.load(os.path.join(out, "params.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_program_stores_no_weight_and_calls_the_stencil_op(bundle):
    out = bundle[0]
    exported = torch.export.load(os.path.join(out, f"predict_{SIZE}_cpu.pt2"))
    assert len(exported.state_dict) == 0 and exported.example_inputs is None
    # the constants are made from the input's size (the FFT mask, resize
    # indices), none of them a weight
    with np.load(os.path.join(out, "params.npz")) as z:
        weights = [torch.from_numpy(z[k]) for k in z.files]
    for t in exported.constants.values():
        assert t.numel() <= SIZE * SIZE
        assert not any(t.shape == w.shape and torch.equal(t, w) for w in weights)
    # the forward runs inside the autocast region, a submodule of the graph
    targets = {n.target for m in exported.graph_module.modules() if hasattr(m, "graph")
               for n in m.graph.nodes if n.op == "call_function"}
    assert torch.ops.dgtd_torch.diffusion_planes.default in targets


def test_bundle_matches_eager_predict_fp32(bundle):
    """(a): the bundle's probability map is the eager port's predict."""
    _, model, _, _, serving = bundle
    img, dep = _inputs(0, SIZE, SIZE)
    got = serving(img, dep)
    want = model.predict(torch.from_numpy(img), torch.from_numpy(dep))[0].numpy()
    assert got.shape == (1, SIZE, SIZE, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=BUNDLE_ATOL)


def test_bf16_bundle_matches_eager_bf16_predict(tmp_path):
    """The default compute, bf16 autocast, survives the export: the program
    holds the autocast region and equals eager bf16 ``predict``."""
    model = cod(seed=0, **TINY)
    E.export_bundle(model, str(tmp_path), sizes=[SIZE], platforms=["cpu"])
    img, dep = _inputs(2, SIZE, SIZE)
    got = E.ServingModel.load(str(tmp_path), "cpu")(img, dep)
    want = model.predict(torch.from_numpy(img), torch.from_numpy(dep))[0].numpy()
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["compute"] == "bfloat16"
    np.testing.assert_allclose(got, want, rtol=0, atol=BUNDLE_ATOL)


@pytest.mark.parametrize("hw", [(30, 40), (60, 50)])
def test_non_bucket_sizes_resize_to_the_bucket_and_back(bundle, hw):
    """Smaller than the one bucket, and larger (the largest bucket serves
    it): resize in, predict at the bucket, resize back."""
    _, model, _, _, serving = bundle
    img, dep = _inputs(1, *hw)
    got = serving(img, dep)
    prob = model.predict(torch.from_numpy(E._resize_nhwc(img, SIZE)), torch.from_numpy(E._resize_nhwc(dep, SIZE)))[0]
    want = E._resize_nhwc(prob.numpy(), hw)
    assert got.shape == (1, *hw, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BUNDLE_ATOL)


@pytest.mark.parametrize("shape,size", [
    ((1, 30, 40, 3), (48, 48)),  # growing
    ((1, 96, 80, 1), (48, 48)),  # shrinking: the kernel widens (antialias)
    ((1, 100, 37, 3), (33, 111)),  # one axis each way, factors that are not integers
    ((2, 7, 9, 2), (7, 20)),  # one axis unchanged
])
def test_resize_matches_jax_image_resize(shape, size):
    """(c): the loader's resize is ``jax.image.resize(..., "bilinear")``,
    which antialiases when it shrinks, unlike ``F.interpolate``."""
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]), "bilinear"))
    got = E._resize_nhwc(x, size)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_loading_and_serving_import_no_model_code(bundle):
    """(d): a fresh interpreter loads the bundle and serves with torch, numpy
    and the port's ops: neither the models, the registry nor the config
    loader (nor JAX) is imported."""
    code = (
        "import sys, numpy as np\n"
        "from dgtd_tpu_torch.tools.export_serving import ServingModel\n"
        f"s = ServingModel.load({bundle[0]!r}, 'cpu')\n"
        f"p = s(np.zeros((1, 30, 20, 3), np.float32), np.zeros((1, 30, 20, 1), np.float32))\n"
        "assert p.shape == (1, 30, 20, 1), p.shape\n"
        "bad = [m for m in sys.modules if m.startswith(('dgtd_tpu_torch.models', 'dgtd_tpu_torch.core.registry', "
        "'dgtd_tpu_torch.core.config', 'jax', 'flax', 'dgtd_tpu.')) or m == 'dgtd_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_predict_cli_bundle_writes_masks_at_native_sizes(bundle, tmp_path):
    """(e): ``python -m dgtd_tpu_torch.predict --bundle``: one image a call,
    each mask at its image's size; depths resized to the image."""
    img_dir, dep_dir, out_dir = tmp_path / "img", tmp_path / "dep", tmp_path / "masks"
    img_dir.mkdir()
    dep_dir.mkdir()
    rng = np.random.RandomState(0)
    sizes = {"a": (30, 40), "b": (64, 20)}  # (H, W)
    for name, (h, w) in sizes.items():
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(img_dir / f"{name}.jpg")
        Image.fromarray(rng.randint(0, 255, (h // 2, w // 2), np.uint8)).save(dep_dir / f"{name}_depth.png")
    res = subprocess.run(
        [sys.executable, "-m", "dgtd_tpu_torch.predict", "--bundle", bundle[0], "--image-dir", str(img_dir),
         "--depth-dir", str(dep_dir), "--out-dir", str(out_dir), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for name, (h, w) in sizes.items():
        with Image.open(out_dir / f"{name}_output.png") as m:
            assert m.size == (w, h) and m.mode == "L"


def test_predict_cli_wants_exactly_one_of_checkpoint_and_bundle(tmp_path):
    from dgtd_tpu_torch import predict as P

    common = ["--image-dir", str(tmp_path), "--out-dir", str(tmp_path)]
    for extra in ([], ["--bundle", "b", "--checkpoint", "c.pth"]):
        with pytest.raises(SystemExit):
            P.parse_args(common + extra)


def test_loader_refuses_newer_formats_and_other_platforms(bundle, tmp_path):
    copy = tmp_path / "copy"
    shutil.copytree(bundle[0], copy)
    with open(copy / "meta.json") as f:
        meta = json.load(f)
    with open(copy / "meta.json", "w") as f:
        json.dump({**meta, "format_version": E.FORMAT_VERSION + 1}, f)
    with pytest.raises(ValueError, match="newer"):
        E.ServingModel.load(str(copy), "cpu")
    with open(copy / "meta.json", "w") as f:
        json.dump({**meta, "platforms": ["cuda"]}, f)
    with pytest.raises(ValueError, match="cuda"):
        E.ServingModel.load(str(copy), "cpu")


def test_cuda_is_the_default_and_raises_without_a_card(bundle, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        E.ServingModel.load(bundle[0])
    with pytest.raises(RuntimeError, match="--device cpu"):
        E.export_bundle(bundle[1], str(tmp_path / "b"), sizes=[SIZE])


def test_strict_checkpoint_refuses_a_partial_one(tmp_path):
    model = cod(dtype=torch.float32, seed=0, **TINY)
    state = model.state_dict()
    path = str(tmp_path / "partial.pth")
    torch.save({k: v for k, v in state.items() if "decoder" not in k}, path)
    with pytest.raises(ValueError, match="do not pair"):
        E.load_checkpoint_strict(model, path)
    torch.save({**state, "hitnet.ca.fc1.weight": torch.zeros(1), "stray.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="stray.weight"):
        E.load_checkpoint_strict(model, path)
    full = str(tmp_path / "full.pth")
    torch.save({**state, "hitnet.ca.fc1.weight": torch.zeros(1)}, full)  # a dead module's key may come along
    assert E.load_checkpoint_strict(model, full) == len(state)


def _planes_args(keep):
    g = torch.Generator().manual_seed(0)
    x, raw = torch.rand(3, 6, 7, generator=g), torch.rand(3, 9, 6, 7, generator=g)
    return (x, raw / raw.sum(1, keepdim=True), 3, 2, keep)


def _nhwc_args(keep):
    g = torch.Generator().manual_seed(1)
    raw = torch.rand(2, 5, 6, 3, 9, generator=g)
    return (torch.rand(2, 5, 6, 3, generator=g), D.to_tap_major(raw / raw.sum(-1, keepdim=True)), 3, 3, keep)


def _msda_args():
    g = torch.Generator().manual_seed(2)
    shapes = [4, 5, 2, 3]
    value = torch.rand(2, 4 * 5 + 2 * 3, 2, 4, generator=g)
    loc = torch.rand(2, 7, 2, 2, 3, 2, generator=g)
    aw = torch.rand(2, 7, 2, 2, 3, generator=g)
    return (value, loc, aw, shapes)


def _ln_args():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(5, 12, generator=g), torch.randn(12, generator=g), torch.randn(12, generator=g), 1e-6)


@pytest.mark.parametrize("op,args", [
    (D.diffusion_planes_op, _planes_args(True)),
    (D.diffusion_planes_op, _planes_args(False)),
    (D.diffusion_nhwc_op, _nhwc_args(True)),
    (D.diffusion_nhwc_op, _nhwc_args(False)),
    (A.msda_fwd_op, _msda_args()),
    (L.layer_norm_op, _ln_args()),
], ids=["planes_keep", "planes", "nhwc_keep", "nhwc", "msda_fwd", "layer_norm"])
def test_opcheck(op, args):
    """(f): schema, fake (shape) implementation and tracing of each op."""
    torch.library.opcheck(op, args)


def test_op_cpu_implementations_are_the_plain_versions():
    x, w, k, steps, _ = _planes_args(True)
    out, xs = D.diffusion_planes_op(x, w, k, steps, True)
    torch.testing.assert_close(out, D.diffusion_planes_plain(x, w, k, steps), rtol=0, atol=0)
    torch.testing.assert_close(xs[1], D.diffusion_step_plain(x, w, k), rtol=0, atol=0)
    assert D.diffusion_planes_op(x, w, k, steps, False)[1].shape == (0, *x.shape)
    value, loc, aw, shapes = _msda_args()
    torch.testing.assert_close(A.msda_fwd_op(value, loc, aw, shapes),
                               A.ms_deform_attn_plain(value, ((4, 5), (2, 3)), loc, aw), rtol=0, atol=0)
    xl, s, b, eps = _ln_args()
    torch.testing.assert_close(L.layer_norm_op(xl, s, b, eps), L.layer_norm_plain(xl, s, b, eps), rtol=0, atol=0)
