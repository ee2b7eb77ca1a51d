"""The port's offline depther (``models/dinov2.py``, ``models/dpt.py``, the
``dinov2`` and ``dpt_head`` kinds of ``convert.py``, ``tools/depth_gen.py``
with ``--estimator dinov2``) against ``dgtd_tpu`` on the CPU.

Parameters are made with numpy from a seed in the JAX tree's shapes
(``jax.eval_shape``, nothing compiled) and carried to the port by
``convert.state_dict_from_flax``; the JAX side runs eagerly under
``jax.disable_jit`` at ``tests/test_depther.py``'s tiny widths (DIM 32,
HEADS 2, DEPTH 4, PRE_GRID 3). The official key layout is held by
``tests/test_depther.py``'s torch mirror of the released modules.
"""

import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from dgtd_tpu.models import dinov2 as jax_dinov2
from dgtd_tpu.models.dpt import DinoDPTDepther as JaxDepther
from dgtd_tpu.models.dpt import center_pad as jax_center_pad
from dgtd_tpu.tools import depth_gen as jax_depth_gen
from dgtd_tpu.tools.convert_ckpt import map_dinov2_key, map_dpt_head_key
from dgtd_tpu_torch.convert import depther_part_state, load_depther_part, state_dict_from_flax
from dgtd_tpu_torch.models import dinov2 as port_dinov2
from dgtd_tpu_torch.models.dpt import DinoDPTDepther, center_pad
from dgtd_tpu_torch.tools import depth_gen as port_depth_gen
from test_depther import DIM, HEADS, DEPTH, PRE_GRID, PPC, CH, NBINS, _TDepther

# tests/test_depther.py's bars: the depther 2e-4, the bicubic matrices and
# a block 1e-5
DEPTHER_TOL = dict(rtol=2e-4, atol=2e-4)
TIGHT_TOL = dict(rtol=1e-5, atol=1e-5)
TINY_ARCH = (DIM, DEPTH, HEADS, "mlp")
HEAD_KW = dict(n_bins=NBINS, channels=CH, post_process_channels=PPC, pretrain_grid=PRE_GRID)


def numpy_params(module, *args, seed=0, **kwargs):
    """Flat {path: float32 array} in ``module``'s JAX tree, made with numpy:
    kernels N(0, 1/fan_in), biases N(0, 0.1²), LayerNorm scales and
    LayerScale gammas 1 + N(0, 0.1²), tokens N(0, 0.1²)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))["params"]
    rng = np.random.RandomState(seed)
    out = {}
    for path, s in sorted(flatten_dict(shapes, sep="/").items()):
        leaf = path.rsplit("/", 1)[-1]
        a = rng.randn(*s.shape).astype(np.float32)
        if leaf == "kernel":
            a /= np.sqrt(np.prod(s.shape[:-1]))
        elif leaf in ("scale", "gamma"):
            a = 1.0 + 0.1 * a
        else:
            a *= 0.1
        out[path] = a
    return out


def jax_apply(module, flat, *args, **kwargs):
    with jax.disable_jit():
        return module.apply({"params": unflatten_dict(flat, sep="/")}, *args, **kwargs)


@pytest.fixture
def tiny_arch(monkeypatch):
    """The tiny backbone registered in both packages as ``tiny``."""
    monkeypatch.setitem(jax_dinov2.DINOV2_ARCHS, "tiny", TINY_ARCH)
    monkeypatch.setitem(port_dinov2.DINOV2_ARCHS, "tiny", TINY_ARCH)


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- parts


@pytest.mark.parametrize("grid_hw", [(5, 5), (4, 7), (PRE_GRID, PRE_GRID)], ids=["square", "non_square", "native"])
def test_interpolate_pos_embed_matches_jax(grid_hw):
    pe = np.random.RandomState(1).randn(1, PRE_GRID ** 2 + 1, 8).astype(np.float32)
    ref = np.asarray(jax_dinov2.interpolate_pos_embed(jnp.asarray(pe), grid_hw))
    got = port_dinov2.interpolate_pos_embed(torch.from_numpy(pe), grid_hw).numpy()
    assert got.shape == ref.shape == (1, grid_hw[0] * grid_hw[1] + 1, 8)
    np.testing.assert_allclose(got, ref, **TIGHT_TOL)


@pytest.mark.parametrize("shape,multiple", [((1, 5, 9, 3), 4), ((2, 40, 50, 3), 14), ((1, 28, 14, 3), 14)])
def test_center_pad_matches_jax(shape, multiple):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = np.asarray(jax_center_pad(jnp.asarray(x), multiple))
    got = center_pad(nhwc_to_nchw(x), multiple).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ffn", ["mlp", "swiglufused"])
def test_block_matches_jax(ffn):
    """A block at dim 24: the exact-GELU MLP, and the fused SwiGLU at its
    aligned hidden width (int(24·4·2/3) + 7) // 8 · 8 = 64."""
    dim, heads = 24, 2
    x = np.random.RandomState(5).randn(2, 7, dim).astype(np.float32)
    jb = jax_dinov2.DinoBlock(dim, heads, ffn_layer=ffn)
    flat = numpy_params(jb, jnp.zeros((2, 7, dim)), seed=6)
    ref = np.asarray(jax_apply(jb, flat, jnp.asarray(x)))
    state = state_dict_from_flax({f"blocks_0/{k}": v for k, v in flat.items()}, "dinov2")
    pb = port_dinov2.DinoBlock(dim, heads, ffn_layer=ffn)
    pb.load_state_dict({k[len("blocks.0."):]: v for k, v in state.items()})
    assert port_dinov2.swiglu_hidden(dim) == 64
    with torch.no_grad():
        got = pb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TIGHT_TOL)


@pytest.mark.parametrize("final_norm", [False, True])
def test_intermediate_layers_match_jax(final_norm):
    """``DinoViT`` on a 42x56 input (a 3x4 patch grid, off the 3x3
    pretrain grid): every block's patches and cls token."""
    jm = jax_dinov2.DinoViT(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, pretrain_grid=PRE_GRID)
    x = np.random.RandomState(7).randn(2, 42, 56, 3).astype(np.float32)
    flat = numpy_params(jm, jnp.zeros(x.shape), seed=8)
    ref = jax_apply(jm, flat, jnp.asarray(x), out_indices=(0, 1, 2, 3), final_norm=final_norm)
    pm = port_dinov2.DinoViT(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, pretrain_grid=PRE_GRID)
    pm.load_state_dict(state_dict_from_flax(flat, "dinov2"))
    with torch.no_grad():
        got = pm(nhwc_to_nchw(x), out_indices=(0, 1, 2, 3), final_norm=final_norm)
    assert len(got) == len(ref) == 4
    for (gp, gc), (rp, rc) in zip(got, ref):
        assert tuple(gp.shape) == (2, DIM, 3, 4)
        np.testing.assert_allclose(gp.permute(0, 2, 3, 1).numpy(), np.asarray(rp), **TIGHT_TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), **TIGHT_TOL)


# ---------------------------------------------------------------- the depther


@pytest.mark.parametrize("classify", [True, False], ids=["classify", "regression"])
def test_depther_matches_jax(tiny_arch, classify):
    """40x50 (centre padding to 42x56, pos-embed interpolation, the odd-grid
    fusion resize), batch 2, weights carried across by both kinds."""
    kw = dict(arch="tiny", out_indices=(0, 1, 2, 3), classify=classify, **HEAD_KW)
    jm = JaxDepther(**kw)
    x = np.random.RandomState(3).randn(2, 40, 50, 3).astype(np.float32)
    flat = numpy_params(jm, jnp.zeros(x.shape), seed=4)
    ref = np.asarray(jax_apply(jm, flat, jnp.asarray(x)))
    pm = DinoDPTDepther(**kw)
    assert load_depther_part(pm.backbone, state_dict_from_flax(flat, "dinov2"), "dinov2") == []
    assert load_depther_part(pm.decode_head, state_dict_from_flax(flat, "dpt_head"), "dpt_head") == []
    with torch.no_grad():
        got = pm(nhwc_to_nchw(x))
    assert tuple(got.shape) == (2, 1, 40, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **DEPTHER_TOL)


@pytest.mark.parametrize("bins,norm", [("UD", "softmax"), ("SID", "linear"), ("SID", "sigmoid")])
def test_head_strategies_match_jax(bins, norm):
    """The classify head's other bin spacings and normalizations, on
    backbone-shaped features of a 3x4 patch grid."""
    from dgtd_tpu.models.dpt import DPTHead as JaxHead
    from dgtd_tpu_torch.models.dpt import DPTHead

    rng = np.random.RandomState(10)
    feats = [(rng.randn(2, 3, 4, DIM).astype(np.float32), rng.randn(2, DIM).astype(np.float32)) for _ in PPC]
    jh = JaxHead(channels=CH, post_process_channels=PPC, n_bins=NBINS, bins_strategy=bins, norm_strategy=norm)
    jfeats = [(jnp.asarray(f), jnp.asarray(c)) for f, c in feats]
    flat = numpy_params(jh, jfeats, seed=11)
    ref = np.asarray(jax_apply(jh, flat, jfeats))
    ph = DPTHead(DIM, CH, PPC, n_bins=NBINS, bins_strategy=bins, norm_strategy=norm)
    load_depther_part(ph, state_dict_from_flax(flat, "dpt_head"), "dpt_head")
    with torch.no_grad():
        got = ph([(nhwc_to_nchw(f), torch.from_numpy(c)) for f, c in feats])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **DEPTHER_TOL)


def test_default_out_indices_match_jax():
    from dgtd_tpu_torch.models.dpt import default_out_indices

    for depth in (4, 12, 24, 40, 7, 18, 30):
        assert default_out_indices(depth) == JaxDepther()._default_indices(depth)


@pytest.fixture(scope="module")
def official():
    """tests/test_depther.py's torch mirror of the released depther: its
    state dict in the official key layout (``mask_token`` included), its
    output on a 40x50 input."""
    torch.manual_seed(11)
    tm = _TDepther().eval()
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 3, 40, 50).astype(np.float32))
    with torch.no_grad():
        ref = tm(x)
    return tm.state_dict(), x, ref


def test_official_state_dict_loads_and_matches_the_release(tiny_arch, official):
    state, x, ref = official
    pm = DinoDPTDepther(arch="tiny", out_indices=(0, 1, 2, 3), **HEAD_KW)
    backbone = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    head = {k[len("decode_head."):]: v for k, v in state.items() if k.startswith("decode_head.")}
    assert load_depther_part(pm.backbone, backbone, "dinov2") == ["mask_token"]
    assert load_depther_part(pm.decode_head, head, "dpt_head") == []
    with torch.no_grad():
        got = pm(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **DEPTHER_TOL)
    # every port key is one that the JAX converter maps
    assert all(map_dinov2_key(k) for k in pm.backbone.state_dict())
    assert all(map_dpt_head_key(k) for k in pm.decode_head.state_dict())


@pytest.mark.parametrize("part,key", [("dinov2", "blocks.2.attn.qkv.weight"), ("dinov2", "pos_embed"),
                                      ("dpt_head", "fusion_blocks.3.res_conv_unit1.conv2.conv.bias"),
                                      ("dpt_head", "conv_depth.weight")])
def test_a_missing_key_raises(tiny_arch, official, part, key):
    state = official[0]
    prefix = "backbone." if part == "dinov2" else "decode_head."
    sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix) and k[len(prefix):] != key}
    pm = DinoDPTDepther(arch="tiny", out_indices=(0, 1, 2, 3), **HEAD_KW)
    with pytest.raises(ValueError, match="do not pair"):
        load_depther_part(pm.backbone if part == "dinov2" else pm.decode_head, sub, part)


def test_pth_files_load_with_wrappers_and_prefixes(tiny_arch, official, tmp_path):
    """The release's files: a bare backbone state dict, a head under
    ``state_dict`` with ``decode_head.`` keys; and a whole depther's."""
    state = official[0]
    backbone = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    head = {k: v for k, v in state.items() if k.startswith("decode_head.")}
    torch.save(backbone, tmp_path / "b.pth")
    torch.save({"state_dict": head, "meta": {"epoch": 1}}, tmp_path / "h.pth")
    torch.save({"model": state}, tmp_path / "whole.pth")
    for b, h in (("b.pth", "h.pth"), ("whole.pth", "whole.pth")):
        sb = depther_part_state(str(tmp_path / b), "dinov2")
        sh = depther_part_state(str(tmp_path / h), "dpt_head")
        assert set(sb) == set(backbone) and set(sh) == {k[len("decode_head."):] for k in head}


def test_bf16_autocast_runs_and_stays_near_fp32(tiny_arch, official):
    state, x, ref = official
    pm = DinoDPTDepther(arch="tiny", out_indices=(0, 1, 2, 3), dtype=torch.bfloat16, **HEAD_KW)
    pm.load_state_dict({k: v for k, v in state.items() if k != "backbone.mask_token"})
    with torch.no_grad():
        got = pm(x)
    assert got.dtype == torch.float32
    # bf16 rounds the matmuls' inputs (2^-8 relative): the depth within 2% of its range
    assert (got - ref).abs().max().item() <= 0.02 * (ref.max() - ref.min()).item() + 1e-3


# ---------------------------------------------------------------- depth_gen


def write_images(root, sizes, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(os.path.join(root, f"img{i}.png"))


def test_depth_gen_dinov2_matches_the_jax_tool(monkeypatch, tmp_path):
    """``--estimator dinov2`` with the tiny backbone (as ``vits14``) and the
    tool's full-width head, both parts in JAX ``.npz`` files: the port in
    fp32 within one grey level of the JAX tool in fp32."""
    monkeypatch.setitem(jax_dinov2.DINOV2_ARCHS, "vits14", TINY_ARCH)
    monkeypatch.setitem(port_dinov2.DINOV2_ARCHS, "vits14", TINY_ARCH)
    monkeypatch.setattr(jax_depth_gen, "Dinov2Depther",
                        functools.partial(jax_depth_gen.Dinov2Depther, dtype_str="float32"))
    jm = JaxDepther(arch="vits14", n_bins=16)
    flat = numpy_params(jm, jnp.zeros((1, 42, 56, 3)), seed=9)
    for part in ("backbone", "decode_head"):
        np.savez(tmp_path / f"{part}.npz", **{k[len(part) + 1:]: v for k, v in flat.items() if k.startswith(part)})
    write_images(tmp_path / "img", [(60, 80), (45, 60)])
    common = ["--image-dir", str(tmp_path / "img"), "--estimator", "dinov2", "--arch", "vits14",
              "--backbone-ckpt", str(tmp_path / "backbone.npz"), "--head-ckpt", str(tmp_path / "decode_head.npz"),
              "--long-side", "56"]
    with jax.disable_jit():
        jax_depth_gen.main(common + ["--out-dir", str(tmp_path / "jax")])
    summary = port_depth_gen.main(common + ["--out-dir", str(tmp_path / "port"), "--fp32", "--device", "cpu"])
    assert summary["written"] == 2 and set(summary["parts_s"]) == {"decode", "backbone", "head", "write"}
    for name in ("img0_depth.png", "img1_depth.png"):
        a = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        assert a.shape == b.shape and a.std() > 10
        assert np.abs(a - b).max() <= 1
