"""The port's diffusion stencil and prompt modules vs ``dgtd_tpu`` (fp32, CPU).

On the CPU ``diffusion_planes`` runs its plain versions; the forward is held
against the Pallas plane kernel in interpret mode and against the jnp
``message_passing_step``, the backward against ``jax.vjp`` of the Pallas plane
entry in interpret mode (which runs the Pallas backward kernels), at the
tolerances of tests/test_diffusion_pallas.py.
The CUDA kernel itself is checked by tests/test_torch_kernels.py and by
chip_smoke.py.
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


@pytest.mark.parametrize("k,p,h,w,steps", [(1, 4, 12, 12, 2), (3, 6, 13, 20, 3), (7, 4, 12, 12, 4), (7, 3, 9, 17, 3)])
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


@pytest.mark.parametrize("k,p,h,w,steps", [(1, 4, 12, 12, 2), (3, 6, 13, 20, 3), (7, 4, 12, 12, 4), (7, 3, 9, 17, 3)])
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
    assert torch.autograd.gradcheck(lambda a, b: D.diffusion_planes(a, b, k, steps), (x, wt))


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
