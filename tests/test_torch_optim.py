"""The port's optimizer keys that change the result vs ``dgtd_tpu`` (CPU):
``optim_wrapper.constructor`` (layer decay) and ``optim_wrapper.bf16_state``
(AdamW's moments stored in bf16, v stochastically rounded). Small arrays
through optax; no JAX model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from dgtd_tpu.train.layer_decay import layer_decay_custom_keys as jax_layer_decay_keys
from dgtd_tpu.train.optim import ScaleByAdamBf16State, build_optimizer, scale_by_adam_bf16
from dgtd_tpu_torch.data.datasets import SyntheticSODDataset
from dgtd_tpu_torch.data.loader import DataLoader
from dgtd_tpu_torch.models.cod import cod as PortCod
from dgtd_tpu_torch.models.pvt import PVT_V2_CONFIGS
from dgtd_tpu_torch.train.layer_decay import layer_decay_custom_keys
from dgtd_tpu_torch.train.optim import (AdamWBf16State, Optimizer, adam_bf16_update, lr_mult,
                                        stochastic_round_bf16)
from dgtd_tpu_torch.train.state import train_step

TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2)
B1, B2, EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------- layer decay


@pytest.mark.parametrize("variant", sorted(PVT_V2_CONFIGS))
def test_layer_decay_keys_equal_jax_after_translation(variant):
    """``hitnet/backbone/block{s}_{i}`` is the port's ``hitnet.backbone.block{s}.{i}``."""
    ref = jax_layer_decay_keys(variant, 0.85)
    translated = {}
    for key, mult in ref.items():
        head, last = key.rsplit("/", 1)
        if last.startswith("block"):
            last = last.replace("_", ".")
        translated[f"{head.replace('/', '.')}.{last}"] = mult
    assert layer_decay_custom_keys(variant, 0.85) == translated


def _tiny_step(optim_cfg, model_cfg):
    torch.manual_seed(0)
    model = PortCod(dtype=torch.float32, seed=0, **TINY)
    opt = Optimizer(model.named_parameters(), optim_cfg, 2, 1, model_cfg=model_cfg)
    batch = next(iter(DataLoader(SyntheticSODDataset(n=2, size=32, seed=1), 2, device="cpu", prefetch=0)))
    train_step(model, opt, {k: batch[k] for k in ("input", "label", "depth")}, 0, 1)
    return model, opt


def test_constructor_sets_each_group_lr_to_its_layer_multiplier():
    """A tiny ``cod`` step with the constructor: every parameter's group lr is
    the step's lr times decay ** (num_layers - layer); the recipe's
    custom_keys give way, and every key names a parameter."""
    decay = 0.8
    cfg = {"constructor": "LayerDecayOptimWrapperConstructor",
           "paramwise_cfg": {"decay_factor": decay, "custom_keys": {"hitnet.backbone": {"lr_mult": 0.2}}},
           "optimizer": {"type": "AdamW", "lr": 5e-4, "weight_decay": 0.1}}
    model, opt = _tiny_step(cfg, {"type": "cod", **TINY})
    keys = layer_decay_custom_keys("tiny", decay)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert all(any(n.startswith(k + ".") for n in names) for k in keys)
    lr = opt.lr(0)
    group_of = {id(p): g for g in opt.opt.param_groups for p in g["params"]}
    layer = {"patch_embed1": 0, "block1": 1, "patch_embed2": 2, "block2": 2, "patch_embed3": 3, "block3": 3,
             "patch_embed4": 4, "block4": 4}
    seen = set()
    for n, p in model.named_parameters():
        if id(p) not in group_of:
            continue
        part = n.split(".")[2] if n.startswith("hitnet.backbone.") else None
        want = decay ** (5 - layer[part]) if part in layer else 1.0
        assert lr_mult(n, keys) == pytest.approx(want, rel=1e-12), n
        assert group_of[id(p)]["lr_mult"] == pytest.approx(want, rel=1e-12), n
        assert group_of[id(p)]["lr"] == pytest.approx(lr * want, rel=1e-12), n
        seen.add(round(want, 12))
    assert len(seen) == 6  # five layers and the rest


def test_unknown_constructor_raises():
    lin = torch.nn.Linear(2, 2)
    with pytest.raises(KeyError, match="NoSuchConstructor"):
        Optimizer([("hitnet.w", lin.weight)], {"constructor": "NoSuchConstructor"}, 1, 1)


# ---------------------------------------------------------------- bf16 state


def _bf16_neighbours(v32: np.ndarray):
    """The bf16 values below and above each fp32 value (equal when exact)."""
    bits = v32.astype(np.float32).view(np.uint32)
    lo = bits & np.uint32(0xFFFF0000)
    hi = np.where(bits == lo, lo, lo + np.uint32(0x10000))
    return lo.view(np.float32), hi.view(np.float32)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def test_bf16_state_matches_scale_by_adam_bf16():
    """Three steps on a small tree, each from the same bf16 state on both
    sides: m bit-equal, every v one of the two bf16 neighbours of the JAX
    fp32 v, the update within 1e-6."""
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (13,), "c": (3, 4, 2)}
    tx = scale_by_adam_bf16(B1, B2, EPS)
    m = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()}
    v = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()}
    gen = torch.Generator().manual_seed(3)
    for count in (1, 2, 3):
        grads = {k: (rng.randn(*s) * 10.0 ** rng.randint(-4, 1)).astype(np.float32) for k, s in shapes.items()}
        state = ScaleByAdamBf16State(
            count=jnp.asarray(count - 1, jnp.int32),
            mu={k: jnp.asarray(_bf16_np(t), jnp.bfloat16) for k, t in m.items()},
            nu={k: jnp.asarray(_bf16_np(t), jnp.bfloat16) for k, t in v.items()})
        ref_upd, ref_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state)
        for k in shapes:
            g = torch.from_numpy(grads[k])
            upd, m_new, v_new = adam_bf16_update(g, m[k], v[k], count, B1, B2, EPS, gen)
            assert m_new.dtype == v_new.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_np(m_new), np.asarray(ref_state.mu[k], np.float32),
                                          err_msg=f"m, {k}, step {count}")
            v32 = np.asarray(B2 * state.nu[k].astype(jnp.float32) + (1.0 - B2) * jnp.asarray(grads[k])
                             * jnp.asarray(grads[k]), np.float32)
            lo, hi = _bf16_neighbours(v32)
            got = _bf16_np(v_new)
            assert np.all((got == lo) | (got == hi)), f"v, {k}, step {count}"
            ref_v = np.asarray(ref_state.nu[k], np.float32)
            assert np.all((ref_v == lo) | (ref_v == hi))
            np.testing.assert_allclose(upd.numpy(), np.asarray(ref_upd[k]), rtol=0, atol=1e-6,
                                       err_msg=f"update, {k}, step {count}")
            m[k], v[k] = m_new, v_new


def test_bf16_state_optimizer_matches_the_jax_chain_at_step_one():
    """``optim_wrapper.bf16_state`` through the port's Optimizer against
    ``build_optimizer(bf16_state=True)``: decoupled weight decay, the lr and
    a per-key multiplier placed as optax.adamw places them."""
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(4, 6).astype(np.float32), "b": rng.randn(9).astype(np.float32)}
    grads = {k: rng.randn(*p.shape).astype(np.float32) for k, p in params.items()}
    jparams = {"hitnet": {k: jnp.asarray(p) for k, p in params.items()}}
    tx = build_optimizer(jparams, base_lr=0.01, weight_decay=0.1, max_epochs=2, steps_per_epoch=3,
                         custom_keys={"hitnet/b": 0.5}, bf16_state=True)
    upd, _ = tx.update({"hitnet": {k: jnp.asarray(g) for k, g in grads.items()}}, tx.init(jparams), jparams)
    ref = optax.apply_updates(jparams, upd)["hitnet"]
    tparams = {k: torch.nn.Parameter(torch.from_numpy(p.copy())) for k, p in params.items()}
    opt = Optimizer([(f"hitnet.{k}", p) for k, p in tparams.items()],
                    {"optimizer": {"lr": 0.01, "weight_decay": 0.1}, "bf16_state": True,
                     "paramwise_cfg": {"custom_keys": {"hitnet.b": {"lr_mult": 0.5}}}}, 2, 3)
    assert isinstance(opt.opt, AdamWBf16State)
    for k, p in tparams.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step(0)
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6, err_msg=k)
        st = opt.opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16


def test_stochastic_round_passes_non_finite_values():
    """inf and nan stay as they are (the carry of the random bits would
    turn a nan into a finite value); finite values just below bf16's largest
    stay finite."""
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 3.3e38, -3.3e38, 0.0, 1.5])
    got = stochastic_round_bf16(x, torch.Generator().manual_seed(0))
    assert got.dtype == torch.bfloat16
    assert torch.isinf(got[:2]).all() and (got[:2] > 0).tolist() == [True, False]
    assert torch.isnan(got[2]) and torch.isfinite(got[3:]).all() and got[5] == 0 and got[6] == 1.5


def test_stochastic_round_is_unbiased():
    """10^5 draws of a constant 0.3 of a bf16 ulp above 1.0: the mean is
    the constant within 3 sigma."""
    ulp = 2.0 ** -7
    x = 1.0 + 0.3 * ulp
    n = 100_000
    got = stochastic_round_bf16(torch.full((n,), x), torch.Generator().manual_seed(5)).double()
    assert set(got.unique().tolist()) == {1.0, 1.0 + ulp}
    sigma = ulp * np.sqrt(0.3 * 0.7 / n)
    assert abs(got.mean().item() - x) < 3 * sigma


def test_bf16_state_survives_a_checkpoint_and_resumes_exactly():
    """The bf16 moments go into state_dict and come back in bf16; the
    resumed optimizer's next steps (rounding bits seeded by the step) equal
    the uninterrupted one's."""
    def make():
        torch.manual_seed(0)
        lin = torch.nn.Linear(6, 5)
        return lin, Optimizer([("hitnet." + n, p) for n, p in lin.named_parameters()],
                              {"optimizer": {"lr": 0.01}, "bf16_state": True}, 2, 2)

    def step(lin, opt, i):
        lin(torch.linspace(-1, 1, 12).reshape(2, 6) * (i + 1)).pow(2).sum().backward()
        opt.step(i)

    lin_a, opt_a = make()
    for i in range(4):
        step(lin_a, opt_a, i)
    lin_b, opt_b = make()
    for i in range(2):
        step(lin_b, opt_b, i)
    saved = {"model": {k: v.clone() for k, v in lin_b.state_dict().items()}, "opt": opt_b.state_dict()}
    assert all(st[k].dtype == torch.bfloat16 for st in saved["opt"]["state"].values()
               for k in ("exp_avg", "exp_avg_sq"))
    lin_c, opt_c = make()
    lin_c.load_state_dict(saved["model"])
    opt_c.load_state_dict(saved["opt"])
    assert all(st[k].dtype == torch.bfloat16 for st in opt_c.opt.state.values() for k in ("exp_avg", "exp_avg_sq"))
    for i in range(2, 4):
        step(lin_c, opt_c, i)
    for a, c in zip(lin_a.parameters(), lin_c.parameters()):
        torch.testing.assert_close(c, a, rtol=0, atol=0)
