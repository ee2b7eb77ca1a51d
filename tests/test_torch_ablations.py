"""The ablation axes of ``docs/ABLATIONS.md`` on the port's ``cod`` vs
``dgtd_tpu`` (fp32, CPU): ``use_ssim=False`` (``cod_no_ssim``),
``fft_at_grid=True`` with the SSIM term off (``fft2``) and ``remat=True``,
each on the prediction, the texture, the loss terms and every parameter
gradient; ``remat`` against no remat with drop-path on; each override row
of the table built through the ``-o`` parser; the refusals.
"""

import os

import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dgtd_tpu.core.config import load_config as jax_load_config
from dgtd_tpu.core.registry import MODELS as JAX_MODELS
from dgtd_tpu_torch.core.config import load_config
from dgtd_tpu_torch.core.registry import MODELS
from dgtd_tpu_torch.models.layers import checkpointed
from dgtd_tpu_torch.models.pvt import Block as PvtBlock
from torch_jax_parity import (NO_DROP, SHAPE, TINY, assert_matches_jax, batch, carry, flat_variables,
                              jax_results, nested, torch_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"use_ssim_false": {"use_ssim": False},
        "fft_at_grid": {"fft_at_grid": True, "use_ssim": False},
        "remat": {"remat": True}}


@pytest.fixture(scope="module")
def cod_tree():
    jm = JAX_MODELS.get("cod")(dtype=jnp.float32, **TINY)
    return flat_variables(jm.init(jax.random.PRNGKey(0), (1,) + SHAPE[1:] + (3,)))


@pytest.fixture(scope="module", params=list(AXES))
def axis(request, cod_tree):
    overrides = AXES[request.param]
    jm = JAX_MODELS.get("cod")(dtype=jnp.float32, **TINY, **overrides)
    return overrides, jax_results(jm, nested(cod_tree), batch(0))


def test_axis_matches_jax(axis, cod_tree):
    """Prediction and texture to 1e-5, the loss terms the model returns (no
    loss_ssim without the SSIM term), every gradient to 1e-4 of its scale."""
    overrides, ref = axis
    pm = carry(MODELS.get("cod")(dtype=torch.float32, seed=None, **TINY, **NO_DROP, **overrides), cod_tree)
    want_aux = {"loss", "loss_seg"} if overrides.get("use_ssim") is False else {"loss", "loss_seg", "loss_ssim"}
    assert set(ref["aux"]) == want_aux
    g = TINY["grid"]
    assert ref["texture"].shape == ((SHAPE[0], g, g, 3) if overrides.get("fft_at_grid") else SHAPE + (3,))
    assert_matches_jax(pm, ref, batch(0))


def _block_calls(pm):
    calls = []
    # a pre-hook: the recompute stops early, once it has what backward needs
    handle = pm.hitnet.backbone.block4[0].register_forward_pre_hook(lambda *a: calls.append(1))
    return calls, handle


def test_remat_gives_the_loss_and_gradients_of_no_remat_with_drop_path_on():
    """The same seeded weights, batch and DropPath generator seed, with and
    without remat: the blocks' forward runs again in backward, draws the
    same masks, and the loss and every gradient come out equal. Rates of
    0.5 at batch 4, so that masks are drawn and drop samples."""
    drop = dict(drop_path_rate=0.5, convnext_drop_path_rate=0.5)
    b = torch_batch(batch(3, (4,) + SHAPE[1:]))
    results = {}
    for remat in (False, True):
        pm = MODELS.get("cod")(dtype=torch.float32, seed=0, **TINY, **drop, remat=remat)
        calls, handle = _block_calls(pm)
        loss, _ = pm.loss(b["input"], b["depth"], b["label"], generator=torch.Generator().manual_seed(5))
        loss.backward()
        handle.remove()
        assert len(calls) == (2 if remat else 1)  # the recompute ran the block again
        results[remat] = (float(loss.detach()), {n: p.grad.clone() for n, p in pm.named_parameters()})
    no_drop = MODELS.get("cod")(dtype=torch.float32, seed=0, **TINY, **NO_DROP)
    assert float(no_drop.loss(b["input"], b["depth"], b["label"])[0].detach()) != results[False][0]  # masks dropped
    assert results[True][0] == results[False][0]
    for n, grad in results[False][1].items():
        torch.testing.assert_close(results[True][1][n], grad, rtol=0, atol=0, msg=n)


def test_remat_only_in_a_train_forward_that_records_gradients():
    pm = MODELS.get("cod")(dtype=torch.float32, seed=0, **TINY, remat=True)
    calls, handle = _block_calls(pm)
    b = torch_batch(batch(4))
    pm.predict(b["input"], b["depth"])
    with torch.no_grad():
        pm.loss(b["input"], b["depth"], b["label"], generator=torch.Generator().manual_seed(0))
    handle.remove()
    assert len(calls) == 2


def test_checkpointed_refuses_a_block_with_batchnorm():
    """The PVT and ConvNeXt blocks hold no BatchNorm (remat ran them above);
    a block that did would update its running statistics in the recompute."""
    with pytest.raises(ValueError, match="BatchNorm"):
        checkpointed(nn.Sequential(nn.Conv2d(3, 3, 1), nn.BatchNorm2d(3)).train(), torch.randn(2, 3, 4, 4))
    blk = PvtBlock(8, 1, 2, 1, drop_path=0.3).train()
    x = torch.randn(2, 16, 8, requires_grad=True)
    out = checkpointed(blk, x, 4, 4)
    out.sum().backward()
    assert x.grad is not None and not any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in blk.modules())


# docs/ABLATIONS.md:11-21, one case a row (fft2 with the SSIM term off, as
# dgtd_tpu requires; win_size is accepted and unused)
ROWS = {
    "iter": ["diffusion_steps=2"],
    "kernel": ["diffusion_kernel=11"],
    "scale": ["grid=4"],
    "dim": ["latent_dim=20"],
    "no_propagation": ["diffusion_steps=0"],
    "pure_hitnet": ["use_prompts=false"],
    "cod_no_ssim": ["use_ssim=false"],
    "cod_no_te": ["inject_prompts=false"],
    "fft": ["freq_rate=0.5"],
    "fft2": ["fft_at_grid=true", "use_ssim=false"],
    "size": ["win_size=30"],
}
TINY_OVERRIDES = [f"model.{k}={list(v) if isinstance(v, tuple) else v}" for k, v in TINY.items()]


@pytest.mark.parametrize("row", list(ROWS))
def test_ablation_row_builds_through_the_override_parser(row):
    """configs/cod.yml with the row's -o overrides: dgtd_tpu accepts it, and
    the port builds it and serves a finite prediction."""
    recipe = os.path.join(ROOT, "configs", "cod.yml")
    overrides = TINY_OVERRIDES + [f"model.{o}" for o in ROWS[row]]
    cfg = load_config(recipe, overrides)
    assert cfg == jax_load_config(recipe, overrides)
    JAX_MODELS.build(dict(cfg["model"]), dtype=jnp.float32)
    pm = MODELS.build(dict(cfg["model"]), dtype=torch.float32, seed=0)
    b = torch_batch(batch(5, (1, 32, 40)))
    prob, extras = pm.predict(b["input"], b["depth"])
    assert prob.shape == (1, 32, 40, 1) and bool(torch.isfinite(prob).all())
    assert (extras["texture"] is None) == (row in ("pure_hitnet", "cod_no_te"))


def test_ssim_with_grid_fft_and_unknown_keys_raise():
    """As in dgtd_tpu: the SSIM term cannot align a grid-sized texture, and
    an unknown model key is a TypeError."""
    for build in (lambda **k: JAX_MODELS.get("cod")(dtype=jnp.float32, **k),
                  lambda **k: MODELS.get("cod")(dtype=torch.float32, seed=None, **TINY, **k)):
        with pytest.raises(ValueError, match="incompatible with fft_at_grid"):
            build(fft_at_grid=True)
        with pytest.raises(TypeError):
            build(not_an_axis=1)
    # baseline's pairing (grid FFT, no SSIM) and dead prompts (no texture) build
    assert not MODELS.get("baseline")(dtype=torch.float32, seed=None, **TINY).use_ssim
    MODELS.get("cod")(dtype=torch.float32, seed=None, **TINY, fft_at_grid=True, use_prompts=False)
