"""The port's ``DQnet``, ``PretrainInitHook``, ``WindowFusion`` and the
MPRNet blocks vs ``dgtd_tpu`` (fp32, CPU): DQnet's prediction, loss and
every parameter gradient on weights carried across by
``state_dict_from_flax`` (64x80, so the depth prompts are resized from 44²
to non-square stage grids), its key refusals and serving CLI; the init hook
on synthetic towers; the window helpers and fusion modules and the MPRNet
blocks on seeded inputs and weights carried across by their key names.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgtd_tpu.core.registry import MODELS as JAX_MODELS
from dgtd_tpu.models import mprnet as JM
from dgtd_tpu.models import window_fusion as JW
from dgtd_tpu_torch.core.registry import MODELS
from dgtd_tpu_torch.models import mprnet as PM
from dgtd_tpu_torch.models import window_fusion as PW
from dgtd_tpu_torch.train.hooks import PretrainInitHook, our_init
from torch_jax_parity import (SHAPE, assert_matches_jax, batch, carry, flat_variables, jax_results, nested,
                              no_drop_path, serve_and_check)

DQ = dict(variant="tiny", channel=8)
# module outputs, fp32: sums of a few hundred products in another order
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dqnet():
    jm = JAX_MODELS.get("DQnet")(dtype=jnp.float32, **DQ)
    flat = flat_variables(jm.init(jax.random.PRNGKey(0), (1,) + SHAPE[1:] + (3,)))
    return flat, jax_results(jm, nested(flat), batch(0))


def test_dqnet_matches_jax(dqnet):
    """Prediction to 1e-5, no texture, the staged loss alone, every gradient
    to 1e-4 of its scale; the keys are the JAX tree's (backbone and
    depth_generator{s} at top level)."""
    flat, ref = dqnet
    pm = carry(no_drop_path(MODELS.get("DQnet")(dtype=torch.float32, seed=None, **DQ)), flat)
    names = {n.split(".")[0] for n, _ in pm.named_parameters()}
    assert {"backbone", "depth_generator0", "depth_generator3", "SAM", "Translayer2_0"} <= names
    assert pm.frozen_param_prefixes == () and not pm.use_ssim
    assert ref["texture"] is None and set(ref["aux"]) == {"loss", "loss_seg"}
    assert_matches_jax(pm, ref, batch(0))


def test_dqnet_accepts_the_recipe_keys_and_refuses_unknown_ones():
    recipe_keys = dict(win_size=22, filter_ratio=0.9, using_sam=True, using_depth=True, finetune=True,
                       binary_thresh=0.2)
    JAX_MODELS.get("DQnet")(dtype=jnp.float32, **DQ, **recipe_keys)
    pm = MODELS.get("DQnet")(dtype=torch.float32, seed=0, cross_size=20, **DQ, **recipe_keys)
    assert pm.cross_size == 20
    for build in (lambda **k: JAX_MODELS.get("DQnet")(dtype=jnp.float32, **k),
                  lambda **k: MODELS.get("DQnet")(dtype=torch.float32, seed=None, **k)):
        with pytest.raises(TypeError, match="unknown model args"):
            build(grid=12)


def test_pretrain_init_hook_grafts_the_top_level_backbone(dqnet, tmp_path):
    """A PVT .pth and a JAX-converted PVT .npz go into DQnet's top-level
    backbone and nothing else; a cod-shaped hook on DQnet raises naming the
    hook; DQnet has no ConvNeXt tower."""
    logs = []
    model = MODELS.get("DQnet")(dtype=torch.float32, seed=0, **DQ)
    runner = type("R", (), {"model": model, "resumed": False, "log": staticmethod(logs.append)})()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bb = {k: v + 1 for k, v in model.backbone.state_dict().items()}
    torch.save(bb, tmp_path / "pvt.pth")
    PretrainInitHook(backbone_ckpt=str(tmp_path / "pvt.pth")).before_train(runner)
    assert logs[-1] == {"hook": "PretrainInitHook", "loaded": len(bb), "from": str(tmp_path / "pvt.pth"),
                        "into": "backbone"}
    for k, v in model.state_dict().items():
        assert torch.equal(v, bb[k[len("backbone."):]] if k.startswith("backbone.") else before[k]), k

    tower = {k[len("params/backbone/"):]: v for k, v in dqnet[0].items() if k.startswith("params/backbone/")}
    np.savez(tmp_path / "pvt.npz", **tower)
    PretrainInitHook(backbone_ckpt=str(tmp_path / "pvt.npz")).before_train(runner)
    assert logs[-1]["loaded"] == len(tower)
    np.testing.assert_array_equal(model.backbone.block1[0].attn.q.weight.detach().numpy(),
                                  tower["block1_0/SRAttention_0/Dense_0/Dense_0/kernel"].T)

    with pytest.raises(ValueError, match="our_init: the model .DQnet. has no module 'hitnet.backbone'"):
        our_init(backbone_ckpt=str(tmp_path / "pvt.pth")).before_train(runner)
    with pytest.raises(ValueError, match="no ConvNeXt tower"):
        PretrainInitHook(convnext_ckpt=str(tmp_path / "pvt.pth"))


def test_predict_cli_serves_dqnet_on_cpu(tmp_path):
    pm = MODELS.get("DQnet")(dtype=torch.float32, seed=2, **DQ)
    serve_and_check(str(tmp_path), pm, "DQnet", ["-o", "variant=tiny", "-o", "channel=8"])


# ---------------------------------------------------------------- WindowFusion


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _load_linears(module, params):
    """Flax ``{name: {Dense_0: {kernel, bias}}}`` and bare arrays into the
    port module by name."""
    state = {}
    for name, node in params.items():
        if hasattr(node, "items"):
            dense = node["Dense_0"]
            state[f"{name}.weight"] = torch.from_numpy(np.asarray(dense["kernel"]).T.copy())
            if "bias" in dense:
                state[f"{name}.bias"] = torch.from_numpy(np.asarray(dense["bias"]).copy())
        else:
            state[name] = torch.from_numpy(np.asarray(node).copy())
    module.load_state_dict(state, strict=True)
    return module


def test_window_partition_roundtrip_matches_jax():
    x = np.random.RandomState(0).randn(2, 20, 12, 8).astype(np.float32)
    w = PW.window_partition(torch.from_numpy(x), 4)
    assert w.shape == (2 * 15, 4, 4, 8)
    np.testing.assert_array_equal(w.numpy(), np.asarray(JW.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(PW.window_reverse(w, 4, 20, 12).numpy(), x)


@pytest.mark.parametrize("hw", [(8, 12), (10, 13)])
def test_window_fusion_matches_jax(hw):
    """A seeded relative position table (flax initializes it to zeros) and
    maps that need padding to whole windows (10x13 at window 4)."""
    rng = np.random.RandomState(1)
    x, y = (rng.randn(2, *hw, 16).astype(np.float32) for _ in range(2))
    jm = JW.WindowFusion(window=4, num_heads=2)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))["params"])
    params = {**params, "rel_pos_h": rng.randn(7, 8).astype(np.float32),
              "rel_pos_w": rng.randn(7, 8).astype(np.float32)}
    out, gate = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    pm = _load_linears(PW.WindowFusion(16, window=4, num_heads=2), params)
    pout, pgate = pm(_nchw(x), _nchw(y))
    np.testing.assert_allclose(_nhwc(pout), np.asarray(out), **MODULE_TOL)
    np.testing.assert_allclose(_nhwc(pgate), np.asarray(gate), **MODULE_TOL)


def test_new_window_fusion_matches_jax():
    rng = np.random.RandomState(2)
    x, y = (rng.randn(2, 6, 7, 16).astype(np.float32) for _ in range(2))
    jm = JW.NewWindowFusion(num_heads=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(y))["params"])
    out = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    pm = _load_linears(PW.NewWindowFusion(16, num_heads=4), params)
    np.testing.assert_allclose(_nhwc(pm(_nchw(x), _nchw(y))), np.asarray(out), **MODULE_TOL)


# ---------------------------------------------------------------- MPRNet

CAB_INNER = {"Conv_0/Conv_0": "body.0", "PReLU_0": "body.1", "Conv_1/Conv_0": "body.2",
             "CALayer_0/Conv_0/Conv_0": "CA.conv_du.0", "CALayer_0/Conv_1/Conv_0": "CA.conv_du.2"}


def _mpr_key(path: str, num_cab: int) -> str:
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


def _load_mpr(module, params, num_cab=0):
    state = {}
    for path, v in flat_variables({"p": params}).items():
        v = np.array(v)
        state[_mpr_key(path[2:], num_cab)] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v))
    module.load_state_dict(state, strict=True)
    return module


@pytest.mark.parametrize("bias", [False, True])
def test_mprnet_blocks_match_jax(bias):
    """Encoder (with and without cross-stage fusion), Decoder and ORSNet on a
    24x20 map (odd sizes after the first x0.5: 6x5), weights carried across
    by name, every level's output to 1e-5."""
    n_feat, s_unet, s_ors, num_cab = 16, 8, 4, 2
    rng = np.random.RandomState(3)
    x = rng.randn(1, 24, 20, n_feat).astype(np.float32)
    key = jax.random.PRNGKey(5)

    enc = JM.Encoder(scale_unetfeats=s_unet, use_bias=bias)
    ev = jax.device_get(enc.init(key, jnp.asarray(x))["params"])
    enc_outs = enc.apply({"params": ev}, jnp.asarray(x))
    penc = _load_mpr(PM.Encoder(n_feat, bias=bias, scale_unetfeats=s_unet), ev)
    penc_outs = penc(_nchw(x))
    dec = JM.Decoder(scale_unetfeats=s_unet, use_bias=bias)
    dv = jax.device_get(dec.init(key, enc_outs)["params"])
    dec_outs = dec.apply({"params": dv}, enc_outs)
    pdec_outs = _load_mpr(PM.Decoder(n_feat, bias=bias, scale_unetfeats=s_unet), dv)(penc_outs)
    enc2 = JM.Encoder(scale_unetfeats=s_unet, use_bias=bias, csff=True)
    e2v = jax.device_get(enc2.init(key, jnp.asarray(x), enc_outs, dec_outs)["params"])
    enc2_outs = enc2.apply({"params": e2v}, jnp.asarray(x), enc_outs, dec_outs)
    penc2_outs = _load_mpr(PM.Encoder(n_feat, bias=bias, scale_unetfeats=s_unet, csff=True), e2v)(
        _nchw(x), penc_outs, pdec_outs)
    for got, ref in zip(penc_outs + pdec_outs + penc2_outs, list(enc_outs) + list(dec_outs) + list(enc2_outs)):
        assert _nhwc(got).shape == np.asarray(ref).shape
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **MODULE_TOL)

    xo = rng.randn(1, 24, 20, n_feat + s_ors).astype(np.float32)
    ors = JM.ORSNet(scale_unetfeats=s_unet, num_cab=num_cab, use_bias=bias)
    ov = jax.device_get(ors.init(key, jnp.asarray(xo), enc_outs, dec_outs)["params"])
    out = ors.apply({"params": ov}, jnp.asarray(xo), enc_outs, dec_outs)
    pors = _load_mpr(PM.ORSNet(n_feat, s_ors, bias=bias, scale_unetfeats=s_unet, num_cab=num_cab), ov, num_cab)
    np.testing.assert_allclose(_nhwc(pors(_nchw(xo), penc_outs, pdec_outs)), np.asarray(out), **MODULE_TOL)
