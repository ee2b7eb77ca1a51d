"""The port's multi-scale deformable attention vs ``dgtd_tpu`` (CPU).

On the CPU the port runs its plain versions; the JAX side runs the Pallas
kernels in interpret mode, as tests/test_msda.py does. Tolerances are that
file's: forward rtol 1e-4 / atol 1e-6 (test_pallas_matches_reference);
dValue and dAttentionWeight rtol 1e-4 / atol 1e-6, dLocation rtol 1e-4 /
atol 1e-5 (test_gradients_match_torch, test_pallas_backward_matches_reference_vjp).
Interpret-mode Pallas stays on narrow channels: a 1k-channel call takes
~10 s. The CUDA kernels are held to the plain versions by
tests/test_torch_msda_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgtd_tpu.ops.msda import (
    MSDeformAttn as JaxMSDeformAttn,
    make_ms_deform_attn,
    ms_deform_attn_pallas_dlocw,
    ms_deform_attn_pallas_dvalue,
    ms_deform_attn_pallas_fwd,
)
from dgtd_tpu_torch.convert import msda_state_dict_from_flax
from dgtd_tpu_torch.ops import msda as A

N, M, P = 1, 2, 2
SHAPES = ((6, 4), (3, 2))
SHAPES4 = ((8, 8), (4, 4), (2, 2), (1, 1))  # test_msda.py:134
FWD_TOL = dict(rtol=1e-4, atol=1e-6)
DV_TOL = dict(rtol=1e-4, atol=1e-6)
DLOC_TOL = dict(rtol=1e-4, atol=1e-5)
DAW_TOL = dict(rtol=1e-4, atol=1e-6)


def make_inputs(channels, seed, lq=2, shapes=SHAPES, n=N, m=M, p=P):
    """test_msda.py's inputs: value in [0, 0.01), loc in [0, 1), aw
    normalized over levels x points."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.rand(n, s, m, channels).astype(np.float32) * 0.01
    loc = rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32)
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32) + 1e-5
    aw = aw / aw.sum(axis=(-1, -2), keepdims=True)
    return value, loc, aw


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, order="C"))


@pytest.mark.parametrize("channels", [2, 32, 71])
def test_forward_matches_pallas(channels):
    value, loc, aw = make_inputs(channels, seed=11 + channels)
    ref = np.asarray(ms_deform_attn_pallas_fwd(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(aw),
                                               interpret=True))
    before = A.LAUNCHES
    out = A.ms_deform_attn(t(value), SHAPES, t(loc), t(aw))
    assert A.LAUNCHES == before and out.shape == (N, 2, M * channels)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)


@pytest.fixture(scope="module")
def four_levels():
    """The 4-level layout of test_msda.py:134-151 with the Pallas backward
    kernels' results."""
    rng = np.random.RandomState(5)
    n, m, d, lq, p = 2, 2, 8, 37, 4
    s = sum(h * w for h, w in SHAPES4)
    value = rng.rand(n, s, m, d).astype(np.float32)
    loc = rng.rand(n, lq, m, len(SHAPES4), p, 2).astype(np.float32)
    aw = rng.rand(n, lq, m, len(SHAPES4), p).astype(np.float32)
    g = rng.rand(n, lq, m * d).astype(np.float32)
    jv, jl, ja, jg = (jnp.asarray(a) for a in (value, loc, aw, g))
    dv = np.asarray(ms_deform_attn_pallas_dvalue(jg, value.shape, SHAPES4, jl, ja, interpret=True))
    dloc, daw = (np.asarray(a) for a in ms_deform_attn_pallas_dlocw(jg, jv, SHAPES4, jl, ja, interpret=True))
    return (value, loc, aw, g), (dv, dloc, daw)


def test_dvalue_matches_pallas(four_levels):
    (value, loc, aw, g), (dv, _, _) = four_levels
    before = A.DVALUE_LAUNCHES
    got = A.ms_deform_attn_dvalue(t(g), t(value), SHAPES4, t(loc), t(aw))
    assert A.DVALUE_LAUNCHES == before and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), dv, **DV_TOL)


def test_dlocw_matches_pallas(four_levels):
    (value, loc, aw, g), (_, dloc, daw) = four_levels
    before = A.DLOCW_LAUNCHES
    gl, ga = A.ms_deform_attn_dlocw(t(g), t(value), SHAPES4, t(loc), t(aw))
    assert A.DLOCW_LAUNCHES == before
    np.testing.assert_allclose(gl.numpy(), dloc, **DLOC_TOL)
    np.testing.assert_allclose(ga.numpy(), daw, **DAW_TOL)


def _jax_grads(shapes, value, loc, aw, **op_kw):
    op = make_ms_deform_attn(shapes, use_pallas=True, interpret=True, **op_kw)
    return [np.asarray(a) for a in jax.grad(lambda v, l, a: jnp.sum(op(v, l, a) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))]


def _port_grads(shapes, value, loc, aw):
    ins = [t(a).requires_grad_() for a in (value, loc, aw)]
    (A.ms_deform_attn(ins[0], shapes, ins[1], ins[2]) ** 2).sum().backward()
    return [x.grad.numpy() for x in ins]


@pytest.mark.parametrize("channels,lq", [(2, 2), (32, 2), (71, 2), (16, 150)])
def test_function_gradients_match_jax_grad(channels, lq):
    """lq = 2 is one heavily padded 128-query block of the Pallas kernels,
    lq = 150 two blocks (test_msda.py:96-108)."""
    value, loc, aw = make_inputs(channels, seed=23 + channels, lq=lq)
    jv, jl, ja = _jax_grads(SHAPES, value, loc, aw)
    pv, pl, pa = _port_grads(SHAPES, value, loc, aw)
    np.testing.assert_allclose(pv, jv, **DV_TOL)
    np.testing.assert_allclose(pl, jl, **DLOC_TOL)
    np.testing.assert_allclose(pa, ja, **DAW_TOL)


def _edge_locations(seed):
    """Locations that leave [0, 1] (corners off every side) and locations on
    integer pixel coordinates (x = k exactly, including -1 and W - 1, where
    one corner pair falls off the level)."""
    rng = np.random.RandomState(seed)
    value, loc, aw = make_inputs(8, seed=seed, lq=24)
    loc = (rng.rand(*loc.shape) * 1.6 - 0.3).astype(np.float32)
    for lid, (h, w) in enumerate(SHAPES):
        kx = rng.randint(-1, w + 1, size=loc.shape[:3] + (P,))
        ky = rng.randint(-1, h + 1, size=loc.shape[:3] + (P,))
        half = loc.shape[1] // 2
        loc[:, :half, :, lid, :, 0] = ((kx + 0.5) / w)[:, :half]
        loc[:, :half, :, lid, :, 1] = ((ky + 0.5) / h)[:, :half]
    return value, loc, aw


def test_out_of_range_and_integer_locations():
    value, loc, aw = _edge_locations(41)
    ref = np.asarray(ms_deform_attn_pallas_fwd(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(aw),
                                               interpret=True))
    np.testing.assert_allclose(A.ms_deform_attn(t(value), SHAPES, t(loc), t(aw)).numpy(), ref, **FWD_TOL)
    jv, jl, ja = _jax_grads(SHAPES, value, loc, aw)
    pv, pl, pa = _port_grads(SHAPES, value, loc, aw)
    np.testing.assert_allclose(pv, jv, **DV_TOL)
    np.testing.assert_allclose(pl, jl, **DLOC_TOL)
    np.testing.assert_allclose(pa, ja, **DAW_TOL)


def test_bf16_locations_upcast_to_f32_coordinates():
    """test_msda.py:171-206: bf16 locations round once, the coordinate and
    fraction arithmetic stays fp32; the port agrees with the JAX op on the
    same bf16 inputs and its gradients come back in bf16."""
    rng = np.random.RandomState(11)
    shapes = ((64, 100),)
    b, h, d, lq, p = 1, 2, 8, 9, 4
    value = rng.rand(b, 6400, h, d).astype(np.float32)
    sl = (0.85 + 0.1 * rng.rand(b, lq, h, 1, p, 2)).astype(np.float32)
    aw = rng.rand(b, lq, h, 1, p).astype(np.float32)
    aw /= aw.sum(axis=(-2, -1), keepdims=True)
    op = make_ms_deform_attn(shapes, use_pallas=True, interpret=True)
    want = np.asarray(op(jnp.asarray(value), jnp.asarray(sl, jnp.bfloat16), jnp.asarray(aw, jnp.bfloat16)))

    sl16, aw16 = t(sl).bfloat16(), t(aw).bfloat16()
    out16 = A.ms_deform_attn(t(value), shapes, sl16, aw16)
    np.testing.assert_allclose(out16.numpy(), want, rtol=1e-5, atol=1e-6)
    out_rounded = A.ms_deform_attn(t(value), shapes, sl16.float(), aw16.float())
    torch.testing.assert_close(out16, out_rounded, rtol=1e-6, atol=1e-6)
    out32 = A.ms_deform_attn(t(value), shapes, t(sl), t(aw))
    assert float((out16 - out32).abs().max()) < 0.2

    s = sl16.clone().requires_grad_()
    A.ms_deform_attn(t(value), shapes, s, aw16).sum().backward()
    assert s.grad.dtype == torch.bfloat16 and bool(torch.isfinite(s.grad.float()).all())


def test_bf16_value_output_and_gradients():
    """test_msda.py:209-230: a bf16 value gives a bf16 output and dValue,
    fp32 dLocation and dAttentionWeight for fp32 loc and aw; each matches the
    JAX Pallas path on the same inputs to one bf16 rounding."""
    value, loc, aw = make_inputs(2, seed=3)
    v16 = jnp.asarray(value, jnp.bfloat16)
    op = make_ms_deform_attn(SHAPES, use_pallas=True, interpret=True)
    jout = op(v16, jnp.asarray(loc), jnp.asarray(aw))
    jdv, jdl, jda = jax.grad(lambda v, s, a: jnp.sum(op(v, s, a).astype(jnp.float32) ** 2), argnums=(0, 1, 2))(
        v16, jnp.asarray(loc), jnp.asarray(aw))

    tv = t(np.asarray(v16.astype(jnp.float32))).bfloat16().requires_grad_()
    tl, ta = t(loc).requires_grad_(), t(aw).requires_grad_()
    out = A.ms_deform_attn(tv, SHAPES, tl, ta)
    assert out.dtype == torch.bfloat16
    (out.float() ** 2).sum().backward()
    assert tv.grad.dtype == torch.bfloat16 and tl.grad.dtype == ta.grad.dtype == torch.float32
    assert float(tv.grad.float().abs().max()) > 0
    # both sum in fp32 and round once to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(jout, np.float32), rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(tv.grad.float().numpy(), np.asarray(jdv, np.float32), rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jdl), rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), rtol=2e-2, atol=1e-6)


@pytest.fixture(scope="module")
def layer_pair():
    """The flax layer of test_msda.py:154-168 (d_model 32, 2 levels, 4
    heads, 2 points) with its output and gradients, and the port's layer on
    the carried-across weights."""
    shapes = ((8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(0)
    query = rng.rand(1, 10, 32).astype(np.float32)
    refs = rng.rand(1, 10, 2, 2).astype(np.float32)
    value = rng.rand(1, s, 32).astype(np.float32)
    jm = JaxMSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=2, use_pallas=True, interpret=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(refs), jnp.asarray(value), shapes)
    ins = tuple(jnp.asarray(a) for a in (query, refs, value))

    def loss(params, q, r, v):
        return jnp.sum(jm.apply({"params": params}, q, r, v, shapes) ** 2)

    out = np.asarray(jm.apply(variables, *ins, shapes))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(variables["params"], *ins)
    port = A.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=2, seed=None)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port.load_state_dict(msda_state_dict_from_flax(params))
    return shapes, (query, refs, value), out, grads, port


def _close_to_scale(got, want, rtol=1e-4):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rtol * scale, (float(np.abs(got - want).max()), scale)


def test_layer_matches_flax(layer_pair):
    shapes, ins, out, _, port = layer_pair
    with torch.no_grad():
        got = port(*(t(a) for a in ins), shapes)
    assert got.shape == (1, 10, 32)
    _close_to_scale(got.numpy(), out)


def test_layer_gradients_match_flax(layer_pair):
    """Every parameter's gradient and the inputs' within 1e-4 of its scale."""
    shapes, ins, _, grads, port = layer_pair
    port.zero_grad()
    tins = [t(a).requires_grad_() for a in ins]
    (port(*tins, shapes) ** 2).sum().backward()
    want = msda_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads[0]))
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        _close_to_scale(named[name].grad.numpy(), g.numpy())
    for got, jg in zip(tins, grads[1:]):
        _close_to_scale(got.grad.numpy(), np.asarray(jg))


def test_state_dict_from_flax_layout(layer_pair):
    """Kernels (in, out) land transposed in weight (out, in); a leaf the
    layer lacks is refused."""
    port = layer_pair[4]
    params = {"value_proj": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3), "bias": np.ones(3, np.float32)}}
    sd = msda_state_dict_from_flax({"params": params})
    np.testing.assert_array_equal(sd["value_proj.weight"].numpy(), params["value_proj"]["kernel"].T)
    assert set(sd) == {"value_proj.weight", "value_proj.bias"}
    assert port.sampling_offsets.weight.shape == (4 * 2 * 2 * 2, 32)
    with pytest.raises(ValueError, match="no port key"):
        msda_state_dict_from_flax({"value_proj": {"scale": np.ones(3)}})


def test_layer_init_follows_flax_dense():
    """Seeded init: zero biases, lecun-normal weights truncated at 2 std, with
    the spread of flax's default Dense kernel on the same shape."""
    port = A.MSDeformAttn(d_model=64, n_levels=2, n_heads=4, n_points=2, seed=3)
    jm = JaxMSDeformAttn(d_model=64, n_levels=2, n_heads=4, n_points=2, use_pallas=False)
    shapes = ((4, 4), (2, 2))
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 5, 64)), jnp.zeros((1, 5, 2, 2)), jnp.zeros((1, 20, 64)),
                        shapes)
    for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
        lin = getattr(port, name).requires_grad_(False)
        assert float(lin.bias.abs().max()) == 0.0
        std = (1.0 / 64) ** 0.5 / 0.87962566103423978
        assert float(lin.weight.abs().max()) <= 2 * std + 1e-7
        jstd = float(np.asarray(variables["params"][name]["kernel"]).std())
        assert abs(float(lin.weight.std()) - jstd) < 0.15 * jstd, (name, float(lin.weight.std()), jstd)
    again = A.MSDeformAttn(d_model=64, n_levels=2, n_heads=4, n_points=2, seed=3)
    torch.testing.assert_close(again.value_proj.weight, port.value_proj.weight, rtol=0, atol=0)
