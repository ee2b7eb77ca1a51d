"""The port's diffusion stencil and prompt modules vs ``dgtd_tpu`` (fp32, CPU).

On the CPU ``diffusion_planes`` runs its plain versions; the forward is held
against the Pallas plane kernel in interpret mode and against the jnp
``message_passing_step``, the backward against ``jax.vjp`` of the Pallas plane
entry in interpret mode (which runs the Pallas backward kernels), at the
tolerances of tests/test_diffusion_pallas.py. A tiny ``cod`` at grid 24,
whose stencil planes take the cluster kernels on CUDA, is held to the JAX
model (predict, loss and every gradient).
The CUDA kernels themselves are checked by tests/test_torch_kernels.py and
by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from dgtd_tpu.models.diffusion import MessagePassing as JaxMessagePassing
from dgtd_tpu.models.diffusion import PromptEncoder as JaxPromptEncoder
from dgtd_tpu.models.diffusion import message_passing_step
from dgtd_tpu.ops.diffusion_pallas import diffusion_pallas_v2_planes
from dgtd_tpu_torch.convert import state_dict_from_flax
from dgtd_tpu_torch.models.diffusion import MessagePassing, PromptEncoder
from dgtd_tpu_torch.ops import diffusion as D

STENCIL_TOL = dict(rtol=1e-4, atol=1e-5)


def _planes(rng, p, h, w, k):
    x = rng.randn(p, h, w).astype(np.float32)
    raw = rng.rand(p, k * k, h, w).astype(np.float32)
    return x, raw / (raw.sum(1, keepdims=True) + 1e-5)


@pytest.mark.parametrize("k,p,h,w,steps", [(1, 4, 12, 12, 2), (3, 6, 13, 20, 3), (7, 4, 12, 12, 4), (7, 3, 9, 17, 3),
                                           (9, 2, 12, 12, 3), (11, 2, 13, 20, 2)])
def test_diffusion_planes_matches_pallas_and_jnp(k, p, h, w, steps):
    x, wt = _planes(np.random.RandomState(k * 100 + h), p, h, w, k)
    out = D.diffusion_planes(torch.from_numpy(x), torch.from_numpy(wt), k, steps).numpy()

    pallas = np.asarray(diffusion_pallas_v2_planes(jnp.asarray(x), jnp.asarray(wt), k, steps, True))
    np.testing.assert_allclose(out, pallas, **STENCIL_TOL)

    # jnp reference in NHWC: planes (P=B·C) with B=1 -> (1, H, W, C), taps last
    ref = jnp.asarray(np.transpose(x, (1, 2, 0))[None])
    nw = jnp.asarray(np.transpose(wt, (2, 3, 0, 1))[None])
    for _ in range(steps):
        ref = message_passing_step(ref, nw, k)
    np.testing.assert_allclose(out, np.transpose(np.asarray(ref)[0], (2, 0, 1)), **STENCIL_TOL)


@pytest.mark.parametrize("k,p,h,w,steps", [(1, 4, 12, 12, 2), (3, 6, 13, 20, 3), (7, 4, 12, 12, 4), (7, 3, 9, 17, 3),
                                           (9, 2, 12, 12, 3), (11, 2, 13, 20, 2)])
def test_diffusion_planes_backward_matches_pallas_vjp(k, p, h, w, steps):
    rng = np.random.RandomState(k * 10 + w)
    x, wt = _planes(rng, p, h, w, k)
    g = rng.randn(p, h, w).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: diffusion_pallas_v2_planes(a, b, k, steps, True), jnp.asarray(x), jnp.asarray(wt))
    jdx, jdw = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    xt, wtt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wt).requires_grad_()
    D.diffusion_planes(xt, wtt, k, steps).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **STENCIL_TOL)
    np.testing.assert_allclose(wtt.grad.numpy(), jdw, **STENCIL_TOL)

    # the plain backward chain on its own, from the step inputs
    xs = [torch.from_numpy(x)]
    for _ in range(steps - 1):
        xs.append(D.diffusion_step_plain(xs[-1], torch.from_numpy(wt), k))
    dx, dw = D.diffusion_planes_bwd_plain(torch.from_numpy(g), xs, torch.from_numpy(wt), k)
    np.testing.assert_allclose(dx.numpy(), jdx, **STENCIL_TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, **STENCIL_TOL)


@pytest.mark.parametrize("k,h,w,steps", [(1, 3, 4, 2), (3, 5, 6, 3), (7, 5, 9, 2)])
def test_diffusion_planes_gradcheck_float64(k, h, w, steps):
    g = torch.Generator().manual_seed(k + h)
    x = torch.rand(2, h, w, generator=g, dtype=torch.float64, requires_grad=True)
    raw = torch.rand(2, k * k, h, w, generator=g, dtype=torch.float64)
    wt = (raw / raw.sum(1, keepdim=True)).requires_grad_()
    # thousands of tiny forwards: on one intra-op thread none of them waits
    # on a thread pool that other processes keep busy
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(lambda a, b: D.diffusion_planes(a, b, k, steps), (x, wt))
    finally:
        torch.set_num_threads(threads)


def test_message_passing_gradient_reaches_the_regressor():
    """The stencil's gradient flows through the fp32 affinity normalization
    and its cast into the raw regressor output, as jax.grad does."""
    c, k, steps, grid, out_hw = 4, 3, 2, (6, 7), (12, 14)
    rng = np.random.RandomState(9)
    x = rng.randn(1, *grid, c).astype(np.float32)
    wraw = rng.rand(1, *grid, c * k * k).astype(np.float32)
    jm = JaxMessagePassing(latent_dim=c, kernel=k, steps=steps, out_size=out_hw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(wraw))
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jm.apply(variables, a, b) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(wraw))

    pm = MessagePassing(c, k, steps)
    pm.load_state_dict(_port_subtree(_flat_params(variables), "hitnet/prompt_encoder/message_passing",
                                     "hitnet.backbone.prompt_encoder.message_passing"))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(wraw.transpose(0, 3, 1, 2))).requires_grad_()
    (pm(xt, wt, out_hw) ** 2).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx), **STENCIL_TOL)
    np.testing.assert_allclose(nhwc(wt.grad), np.asarray(jgw), **STENCIL_TOL)


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _port_subtree(flat_module, jax_prefix, port_prefix):
    """Carry a Flax submodule's params across: prefix them to their place in
    the full JAX tree, map, and strip the port prefix."""
    flat = {f"params/{jax_prefix}/{k}": v for k, v in flat_module.items()}
    sd = state_dict_from_flax(flat)
    return {k[len(port_prefix) + 1 :]: v for k, v in sd.items()}


def _flat_params(variables):
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables["params"]), sep="/").items()}


@pytest.mark.parametrize("k,steps,grid,out_hw", [(7, 4, (12, 12), (48, 40)), (3, 2, (9, 13), (27, 26))])
def test_message_passing_matches_flax(k, steps, grid, out_hw):
    c, b = 8, 2
    rng = np.random.RandomState(7)
    x = rng.randn(b, *grid, c).astype(np.float32)
    wraw = rng.rand(b, *grid, c * k * k).astype(np.float32)
    jm = JaxMessagePassing(latent_dim=c, kernel=k, steps=steps, out_size=out_hw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(wraw))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(wraw)))

    pm = MessagePassing(c, k, steps)
    pm.load_state_dict(_port_subtree(_flat_params(variables), "hitnet/prompt_encoder/message_passing",
                                     "hitnet.backbone.prompt_encoder.message_passing"))
    with torch.no_grad():
        out = pm(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                 torch.from_numpy(np.ascontiguousarray(wraw.transpose(0, 3, 1, 2))), out_hw)
    np.testing.assert_allclose(nhwc(out), ref, **STENCIL_TOL)


def test_prompt_encoder_matches_flax():
    kw = dict(latent_dim=8, grid=8, freq_rate=0.3, kernel=7, steps=4)
    dims, depths = (8, 16, 32, 64), (1, 1, 1, 1)
    rng = np.random.RandomState(8)
    img = rng.randn(2, 48, 64, 3).astype(np.float32)
    dep = rng.rand(2, 48, 64, 1).astype(np.float32)
    jm = JaxPromptEncoder(convnext_dims=dims, convnext_depths=depths, **kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(img), jnp.asarray(dep))
    tex_ref, emb_ref = jax.jit(jm.apply)(variables, jnp.asarray(img), jnp.asarray(dep))

    pm = PromptEncoder(convnext_dims=dims, convnext_depths=depths, **kw)
    pm.load_state_dict(_port_subtree(_flat_params(variables), "hitnet/prompt_encoder",
                                     "hitnet.backbone.prompt_encoder"))
    with torch.no_grad():
        tex, emb = pm(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))),
                      torch.from_numpy(np.ascontiguousarray(dep.transpose(0, 3, 1, 2))))
    # FFT round-off feeds the whole tower: fp32 CPU sums in two orders
    np.testing.assert_allclose(nhwc(tex), np.asarray(tex_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(emb), np.asarray(emb_ref), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# NHWC layout with tap-major weights (diffusion_pallas, tests/test_diffusion_pallas.py)
# ---------------------------------------------------------------------------


def _nhwc_inputs(rng, b, h, w, c, k):
    x = rng.randn(b, h, w, c).astype(np.float32)
    raw = rng.rand(b, h, w, c, k * k).astype(np.float32)
    return x, raw / (raw.sum(-1, keepdims=True) + 1e-5)


@pytest.mark.parametrize("k,steps,h,w,c", [(7, 4, 16, 16, 8), (3, 6, 12, 12, 24), (7, 2, 24, 24, 8), (5, 3, 9, 13, 3)])
def test_diffusion_nhwc_matches_pallas(k, steps, h, w, c):
    """The cases of test_diffusion_pallas.py:12-25 plus a rectangular grid."""
    from dgtd_tpu.ops.diffusion_pallas import diffusion_pallas

    x, nw = _nhwc_inputs(np.random.RandomState(0), 2, h, w, c, k)
    ref = np.asarray(diffusion_pallas(jnp.asarray(x), jnp.asarray(nw), k, steps, True))
    before = D.NHWC_LAUNCHES
    out = D.diffusion_nhwc(torch.from_numpy(x), torch.from_numpy(nw), k, steps)
    assert D.NHWC_LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), ref, **STENCIL_TOL)


@pytest.mark.parametrize("k,steps,h,w,c", [(3, 2, 8, 8, 4), (7, 3, 12, 10, 5)])
def test_diffusion_nhwc_gradients_match_jax_grad(k, steps, h, w, c):
    """test_diffusion_pallas.py:37-57: jax.grad through diffusion_pallas (its
    backward is the VJP of the jnp stencil); the port's backward runs the
    plane backward on the transposed tensors and returns dw as (B, H, W, C, k²)."""
    from dgtd_tpu.ops.diffusion_pallas import diffusion_pallas

    x, nw = _nhwc_inputs(np.random.RandomState(2), 1, h, w, c, k)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(diffusion_pallas(a, b, k, steps, True) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(nw))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(nw).requires_grad_()
    (D.diffusion_nhwc(xt, wt, k, steps) ** 2).sum().backward()
    assert wt.grad.shape == (1, h, w, c, k * k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **STENCIL_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), **STENCIL_TOL)


def test_to_tap_major_matches_jax():
    """test_diffusion_pallas.py:28-34: tap t of channel c lands at t·C + c."""
    from dgtd_tpu.ops.diffusion_pallas import to_tap_major as jax_to_tap_major

    nw = np.random.RandomState(1).rand(2, 4, 5, 3, 9).astype(np.float32)
    tm = D.to_tap_major(torch.from_numpy(nw))
    assert tm.shape == (2, 4, 5, 27)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jax_to_tap_major(jnp.asarray(nw))))
    assert tm[0, 2, 3, 3 * 1 + 2] == float(nw[0, 2, 3, 2, 1])


@pytest.mark.parametrize("c", [6, 5])
def test_nhwc_step_matches_pallas_step(c):
    """One NHWC step on tap-major weights vs the Pallas step itself; C = 5
    leaves the CUDA kernel's channel group a ragged tail."""
    from dgtd_tpu.ops.diffusion_pallas import diffusion_step_pallas

    rng = np.random.RandomState(4)
    x, nw = _nhwc_inputs(rng, 2, 12, 12, c, 7)
    wtm = np.ascontiguousarray(nw.transpose(0, 1, 2, 4, 3).reshape(2, 12, 12, 49 * c))
    ref = np.asarray(diffusion_step_pallas(jnp.asarray(x), jnp.asarray(wtm), 7, True))
    out = D.diffusion_nhwc_tap_major(torch.from_numpy(x), torch.from_numpy(wtm), 7, 1)
    np.testing.assert_allclose(out.numpy(), ref, **STENCIL_TOL)


# ---------------------------------------------------------------------------
# tiny cod at grid 24: stencil planes above the fused limit (on CUDA the
# cluster kernels; on the CPU the plain versions, the JAX model fused XLA)
# ---------------------------------------------------------------------------

GRID24 = dict(variant="tiny", convnext_dims=(8, 16, 32, 64), convnext_depths=(1, 1, 1, 1),
              channel=8, latent_dim=8, grid=24, refine_iters=2)
# tests/test_torch_cod.py's and tests/test_torch_train.py's tolerances: the
# probability to 1e-5; the loss to 1e-5 relative, each gradient to 1e-4 of
# its largest entry (floor 1e-4 of the largest gradient anywhere)
PROB_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def cod24():
    from dgtd_tpu.models import cod as JaxCod
    from dgtd_tpu_torch.models.cod import cod as PortCod

    jm = JaxCod(dtype=jnp.float32, **GRID24)
    variables = jm.init(jax.random.PRNGKey(0), (1, 64, 64, 3))
    flat = {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables), sep="/").items()}
    pm = PortCod(dtype=torch.float32, seed=None, drop_path_rate=0.0, convnext_drop_path_rate=0.0, **GRID24)
    result = pm.load_state_dict(state_dict_from_flax(flat), strict=False)
    assert result.unexpected_keys == [] and all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    return jm, variables, pm


def _cod_batch(seed, b=2, size=64):
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(b, size, size, 3).astype(np.float32),
            "depth": rng.rand(b, size, size, 1).astype(np.float32),
            "label": (rng.rand(b, size, size, 1) > 0.5).astype(np.float32)}


def test_tiny_cod_grid24_takes_the_cluster_route(cod24):
    """The prompt encoder's 24 x 24 planes lie above the fused limit and
    within the cluster kernels' reach; on the CPU no kernel is counted."""
    _, _, pm = cod24
    assert pm.hitnet.backbone.prompt_encoder.grid == 24
    assert D.stencil_route(24, 24, 7, torch.float32) == D.stencil_route(24, 24, 7, torch.bfloat16) == "cluster"
    assert D.cluster_split(24, 24) == (2, 12)
    batch = _cod_batch(1, b=1)
    before = (D.FUSED_LAUNCHES, D.CLUSTER_LAUNCHES, D.LAUNCHES, D.TILED_LAUNCHES)
    pm.predict(torch.from_numpy(batch["input"]), torch.from_numpy(batch["depth"]))
    assert (D.FUSED_LAUNCHES, D.CLUSTER_LAUNCHES, D.LAUNCHES, D.TILED_LAUNCHES) == before


def test_tiny_cod_grid24_predict_matches_jax(cod24):
    jm, variables, pm = cod24
    batch = _cod_batch(0)
    ref = np.asarray(jax.jit(lambda v, i, d: jm.predict(v, i, d)[0])(variables, batch["input"], batch["depth"]))
    prob = pm.predict(torch.from_numpy(batch["input"]), torch.from_numpy(batch["depth"]))[0]
    assert prob.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(prob.numpy(), ref, rtol=0, atol=PROB_ATOL)


def test_tiny_cod_grid24_loss_and_every_gradient_match_jax(cod24):
    """jax.value_and_grad(model.loss) against the port's loss and backward
    (the stencil's plain backward here) on the same weights and batch,
    DropPath off on both sides."""
    import flax.linen as fnn

    from dgtd_tpu.models.layers import DropPath as JaxDropPath

    jm, variables, pm = cod24
    batch = _cod_batch(2)

    def no_drop_path(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxDropPath) and context.method_name == "__call__":
            return args[0]
        return next_fun(*args, **kwargs)

    def loss_fn(params):
        return jm.loss({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                       rngs={"dropout": jax.random.PRNGKey(1)})

    with fnn.intercept_methods(no_drop_path):
        (_, (aux, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    pm.zero_grad(set_to_none=True)
    ploss, paux = pm.loss(*(torch.from_numpy(batch[k]) for k in ("input", "depth", "label")))
    ploss.backward()
    for k in ("loss", "loss_seg", "loss_ssim"):
        np.testing.assert_allclose(float(paux[k].detach()), float(aux[k]), rtol=LOSS_RTOL)
    ref = state_dict_from_flax({f"params/{k}": np.asarray(v) for k, v in flatten_dict(
        jax.device_get(grads), sep="/").items()})
    named = dict(pm.named_parameters())
    assert set(ref) == set(named)
    scale = max(float(v.abs().max()) for v in ref.values())
    for n, p in named.items():
        limit = GRAD_RTOL * max(float(ref[n].abs().max()), 1e-4 * scale)
        diff = float((p.grad - ref[n]).abs().max())
        assert diff <= limit, f"{n}: {diff:.3e} > {limit:.3e}"
