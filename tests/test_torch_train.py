"""The port's training path vs ``dgtd_tpu`` (fp32, CPU): losses, DropPath,
train-mode BatchNorm, the tiny ``cod`` loss and every parameter gradient
against ``jax.value_and_grad(model.loss)``, and three AdamW steps against the
JAX train step, on weights carried across by ``state_dict_from_flax``.

The JAX side's DropPath is turned off with ``flax.linen.intercept_methods``
(it returns its input), the port's by drop-path rates of 0, so both run the
same deterministic function.
"""

import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from dgtd_tpu.core.config import load_config
from dgtd_tpu.models import cod as JaxCod
from dgtd_tpu.models import losses as JL
from dgtd_tpu.models.layers import BasicConv2d as JaxBasicConv2d
from dgtd_tpu.models.layers import DropPath as JaxDropPath
from dgtd_tpu.train.optim import build_from_config
from dgtd_tpu.train.state import TrainState, make_train_step
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.models import losses as PL
from dgtd_tpu_torch.models.cod import cod as PortCod
from dgtd_tpu_torch.models.layers import BasicConv2d, DropPath, set_drop_path_generator
from dgtd_tpu_torch.train.optim import Optimizer
from dgtd_tpu_torch.train.state import train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
            channel=8, latent_dim=8, grid=8, refine_iters=2)
NO_DROP = dict(drop_path_rate=0.0, convnext_drop_path_rate=0.0)
# fp32 CPU, two frameworks summing in other orders: the loss agrees to ~1e-7
# relative, each gradient to ~1e-5 of its largest entry (observed)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


def _no_drop_path(next_fun, args, kwargs, context):
    if isinstance(context.module, JaxDropPath) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _batch(seed, b=2, size=64):
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(b, size, size, 3).astype(np.float32),
            "depth": rng.rand(b, size, size, 1).astype(np.float32),
            "label": (rng.rand(b, size, size, 1) > 0.5).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads_match(port_model, jax_grads, rtol):
    """Every parameter's gradient within ``rtol`` of its largest entry (with
    a floor of 1e-4 of the largest gradient anywhere, for gradients that are
    zero in exact arithmetic)."""
    ref = state_dict_from_flax(_flat(jax_grads, "params"))
    named = dict(port_model.named_parameters())
    assert set(ref) == set(named)
    scale = max(float(v.abs().max()) for v in ref.values())
    for n, p in named.items():
        limit = rtol * max(float(ref[n].abs().max()), 1e-4 * scale)
        diff = float((p.grad - ref[n]).abs().max())
        assert diff <= limit, f"{n}: {diff:.3e} > {limit:.3e}"


# ---------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 40, 36, 1).astype(np.float32) * 3
    label = (rng.rand(2, 40, 36, 1) > 0.6).astype(np.float32)
    tex = np.abs(rng.randn(2, 40, 36, 3)).astype(np.float32)
    img = rng.randn(2, 40, 36, 3).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(PL.structure_loss(nchw(logits), nchw(label))),
                               float(JL.structure_loss(jnp.asarray(logits), jnp.asarray(label))), **tol)
    np.testing.assert_allclose(float(PL.ssim_loss(nchw(tex), nchw(img))),
                               float(JL.ssim_loss(jnp.asarray(tex), jnp.asarray(img))), **tol)
    np.testing.assert_allclose(float(PL.texture_ssim_loss(nchw(tex), nchw(img))),
                               float(JL.texture_ssim_loss(jnp.asarray(tex), jnp.asarray(img))), **tol)
    stages = [rng.randn(2, 40, 36, 1).astype(np.float32) for _ in range(4)]
    pred2 = rng.randn(2, 40, 36, 1).astype(np.float32)
    got = PL.staged_losses([nchw(s) for s in stages], nchw(pred2), nchw(label))
    ref = JL.staged_losses([jnp.asarray(s) for s in stages], jnp.asarray(pred2), jnp.asarray(label))
    np.testing.assert_allclose(float(got), float(ref), **tol)
    # iteration 0 is weighted 0: changing it changes nothing
    stages[0] = stages[0] * 5
    assert float(PL.staged_losses([nchw(s) for s in stages], nchw(pred2), nchw(label))) == float(got)


def test_losses_are_fp32_under_bf16_inputs():
    rng = np.random.RandomState(1)
    logits = nchw(rng.randn(1, 16, 16, 1).astype(np.float32))
    label = nchw((rng.rand(1, 16, 16, 1) > 0.5).astype(np.float32))
    out = PL.structure_loss(logits.bfloat16(), label)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), float(PL.structure_loss(logits.bfloat16().float(), label)), rtol=1e-6)


# ---------------------------------------------------------------- layers


def test_drop_path_statistics():
    dp = DropPath(0.3).train()
    x = torch.ones(20000, 2, 3)
    assert torch.equal(dp(x), x)  # no generator set: nothing dropped
    dp.generator = torch.Generator().manual_seed(0)
    y = dp(x)
    kept = (y[:, 0, 0] != 0).float()
    # per-sample mask: a sample is all kept (scaled by 1/keep) or all zero
    assert torch.equal(y != 0, kept[:, None, None].expand_as(y).bool())
    torch.testing.assert_close(y[kept.bool()], torch.full_like(y[kept.bool()], 1 / 0.7))
    assert abs(float(kept.mean()) - 0.7) < 0.01  # 20000 draws: sd 0.0032
    assert abs(float(y.mean()) - 1.0) < 0.02
    dp.generator = torch.Generator().manual_seed(0)
    assert torch.equal(dp(x), y)  # the generator alone decides the mask
    assert torch.equal(dp.eval()(x), x)


def test_set_drop_path_generator_reaches_every_block():
    m = PortCod(dtype=torch.float32, seed=None, **TINY)
    g = torch.Generator()
    set_drop_path_generator(m, g)
    dps = [d for d in m.modules() if isinstance(d, DropPath)]
    assert dps and all(d.generator is g for d in dps)
    # the recipe's schedules: linspace(0, 0.1) over the PVT blocks, (0, 0.4) over the ConvNeXt blocks
    pvt = [m.hitnet.backbone.get_submodule(f"block{s}.0").drop_path.rate for s in range(1, 5)]
    np.testing.assert_allclose(pvt, np.linspace(0, 0.1, 4))
    cx = [b.drop_path.rate for st in m.hitnet.backbone.prompt_encoder.encoder2.stages for b in st]
    np.testing.assert_allclose(cx, np.linspace(0, 0.4, 4))
    with pytest.raises(ValueError, match="generator"):
        m.loss(*_torch_batch(_batch(0, 1, 32)).values())


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics for the output; running stats with flax's momentum
    and biased variance (the reference's nn.BatchNorm2d would fold in the
    unbiased one)."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 9, 10, 5).astype(np.float32) * 2 + 1
    jm = JaxBasicConv2d(features=4, kernel=3, padding=1)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    stats = mutated["batch_stats"]["BatchNorm_0"]

    pm = BasicConv2d(5, 4, 3, padding=1)
    p = variables["params"]
    with torch.no_grad():
        pm.conv.weight.copy_(torch.from_numpy(np.transpose(np.array(p["Conv_0"]["Conv_0"]["kernel"]), (3, 2, 0, 1))))
        pm.bn.weight.copy_(torch.from_numpy(np.array(p["BatchNorm_0"]["scale"])))
        pm.bn.bias.copy_(torch.from_numpy(np.array(p["BatchNorm_0"]["bias"])))
    out = pm.train()(nchw(x))
    np.testing.assert_allclose(np.transpose(out.detach().numpy(), (0, 2, 3, 1)), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm.bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6, atol=1e-6)
    # the reference's torch BatchNorm2d: unbiased variance, n/(n-1) larger
    torch_bn = torch.nn.BatchNorm2d(4, momentum=0.1).train()
    torch_bn(pm.conv(nchw(x)).detach())
    n = 3 * 9 * 10
    torch.testing.assert_close((torch_bn.running_var - 0.9) * (n - 1) / n, pm.bn.running_var - 0.9)


# ---------------------------------------------------------------- the slice gate


@pytest.fixture(scope="module")
def carried():
    jm = JaxCod(dtype=jnp.float32, **TINY)
    variables = jm.init(jax.random.PRNGKey(0), (1, 64, 64, 3))
    flat = {**_flat(variables["params"], "params"), **_flat(variables["batch_stats"], "batch_stats")}
    return jm, variables, flat


def _port(flat):
    pm = PortCod(dtype=torch.float32, seed=None, **TINY, **NO_DROP)
    pm.load_state_dict(state_dict_from_flax(flat), strict=False)
    return pm


def test_tiny_cod_loss_and_every_gradient_match_jax(carried):
    jm, variables, flat = carried
    batch = _batch(0)

    def loss_fn(params):
        loss, (aux, mutated) = jm.loss({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                                       rngs={"dropout": jax.random.PRNGKey(1)})
        return loss, (aux, mutated)

    with fnn.intercept_methods(_no_drop_path):
        (loss, (aux, mutated)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    pm = _port(flat)
    ploss, paux = pm.loss(*_torch_batch(batch).values())
    ploss.backward()
    assert not pm.training  # loss ran in train mode and put the module back
    for k in ("loss", "loss_seg", "loss_ssim"):
        np.testing.assert_allclose(float(paux[k].detach()), float(aux[k]), rtol=LOSS_RTOL)
    _assert_grads_match(pm, grads, GRAD_RTOL)
    # BN running statistics after the train-mode forward
    stats = state_dict_from_flax(_flat(mutated["batch_stats"], "batch_stats"))
    sd = pm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_three_adamw_steps_track_the_jax_train_step(carried):
    """configs/cod.yml's optimizer block (AdamW, lr multipliers, cosine by
    epoch: 2 epochs of 2 steps, so the third step runs at half the lr) on the
    same batches."""
    jm, variables, flat = carried
    optim_cfg = load_config(os.path.join(ROOT, "configs", "cod.yml"))["optim_wrapper"]
    tx = build_from_config(variables["params"], optim_cfg, max_epochs=2, steps_per_epoch=2)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]))
    jax_step = make_train_step(jm, tx)

    pm = _port(flat)
    opt = Optimizer(pm.named_parameters(), optim_cfg, max_epochs=2, steps_per_epoch=2)
    with fnn.intercept_methods(_no_drop_path):
        for step in range(3):
            batch = _batch(10 + step)
            state, aux = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
            paux = train_step(pm, opt, _torch_batch(batch), step, seed=1)
            np.testing.assert_allclose(float(paux["loss"]), float(aux["loss"]), rtol=1e-4, err_msg=f"step {step}")

    sd = pm.state_dict()
    for k, v in state_dict_from_flax(_flat(state.batch_stats, "batch_stats")).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    # Adam's first steps move each parameter by about lr·mult whatever the
    # gradient's size, so a gradient near 0 whose sign differs between the
    # two frameworks moves the other way: allow 2·lr·mult per step for those
    params = state_dict_from_flax(_flat(state.params, "params"))
    lr = optim_cfg["optimizer"]["lr"]
    moved_far = 0
    for n, p in pm.named_parameters():
        diff = (p.detach() - params[n]).abs()
        assert float(diff.max()) <= 3 * 2 * lr, n
        moved_far += int((diff > 1e-6).sum())
    assert moved_far <= 1e-3 * sum(p.numel() for p in pm.parameters())


@pytest.mark.slow
def test_full_width_cod_loss_and_gradients_match_jax():
    """PVTv2-b2 + ConvNeXt-B at 384², batch 1, fp32."""
    jm = JaxCod(dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), (1, 384, 384, 3))
    flat = {**_flat(variables["params"], "params"), **_flat(variables["batch_stats"], "batch_stats")}
    batch = _batch(3, b=1, size=384)

    def loss_fn(params):
        return jm.loss({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                       rngs={"dropout": jax.random.PRNGKey(1)})[0]

    with fnn.intercept_methods(_no_drop_path):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    pm = PortCod(dtype=torch.float32, seed=None, **NO_DROP)
    pm.load_state_dict(state_dict_from_flax(flat), strict=False)
    ploss, _ = pm.loss(*_torch_batch(batch).values())
    ploss.backward()
    # 27 ConvNeXt and 16 PVT blocks of fp32 round-off in two orders
    np.testing.assert_allclose(float(ploss), float(loss), rtol=1e-4)
    _assert_grads_match(pm, grads, 1e-2)
