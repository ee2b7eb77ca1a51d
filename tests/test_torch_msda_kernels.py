"""The port's MSDA wrappers: plain versions against the ``grid_sample``
oracle, dispatch and refusals on the CPU, and (on a card) the forward,
dValue and dLocation/dWeight kernels against their plain versions.

This file imports neither JAX nor ``dgtd_tpu``, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest
tests/test_torch_msda_kernels.py`` (the ``cuda``-marked tests skip without a
card). Card tolerances are the CPU parity tests' (tests/test_torch_msda.py):
forward and dValue rtol 1e-4 / atol 1e-6, dLocation atol 1e-5, dWeight atol
1e-6; a bf16 output is held to one bf16 ulp (2^-7 relative), since kernel and
plain both sum in fp32 and round once.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dgtd_tpu_torch.ops import msda as A

SHAPES = ((6, 4), (3, 2))
SHAPES4 = ((8, 8), (4, 4), (2, 2), (1, 1))
FWD_TOL = dict(rtol=1e-4, atol=1e-6)
DV_TOL = dict(rtol=1e-4, atol=1e-6)
DLOC_TOL = dict(rtol=1e-4, atol=1e-5)
DAW_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_OUT_TOL = dict(rtol=2 ** -7, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def grid_sample_oracle(value, shapes, loc, aw):
    """The reference's ``ms_deform_attn_core_pytorch`` (F.grid_sample), as
    tests/test_msda.py holds the JAX reference to it."""
    n, s, m, d = value.shape
    _, lq, _, n_levels, p, _ = loc.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
    a = aw.transpose(1, 2).reshape(n * m, 1, lq, n_levels * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1).view(n, m * d, lq)
    return out.transpose(1, 2).contiguous()


def make_inputs(channels, seed, lq=7, shapes=SHAPES, n=2, m=2, p=3, device="cpu", spread=0.2):
    """value in [0, 0.01) as tests/test_msda.py makes it (dLocation is a
    difference of corner sums over the channels: at 3096 channels of O(1)
    values their fp32 rounding alone would pass atol 1e-5), g in [0, 1);
    loc in [-spread, 1 + spread) (corners off every side) with a third of
    the samples on integer pixel coordinates; aw normalized over levels x
    points."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.rand(n, s, m, channels).astype(np.float32) * 0.01
    loc = (rng.rand(n, lq, m, len(shapes), p, 2) * (1 + 2 * spread) - spread).astype(np.float32)
    for lid, (h, w) in enumerate(shapes):
        third = lq // 3
        loc[:, :third, :, lid, :, 0] = (rng.randint(-1, w + 1, size=(n, third, m, p)) + 0.5) / w
        loc[:, :third, :, lid, :, 1] = (rng.randint(-1, h + 1, size=(n, third, m, p)) + 0.5) / h
    aw = rng.rand(n, lq, m, len(shapes), p).astype(np.float32) + 1e-5
    aw = aw / aw.sum(axis=(-1, -2), keepdims=True)
    g = rng.rand(n, lq, m * channels).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (value, loc, aw, g)]


@pytest.mark.parametrize("channels", [2, 30, 71])
def test_plain_matches_grid_sample_oracle(channels):
    value, loc, aw, _ = make_inputs(channels, seed=channels, spread=0.0)
    out = A.ms_deform_attn_plain(value, SHAPES, loc, aw)
    torch.testing.assert_close(out, grid_sample_oracle(value, SHAPES, loc, aw), rtol=1e-5, atol=1e-7)


def test_plain_float64_matches_oracle():
    value, loc, aw, _ = (x.double() for x in make_inputs(5, seed=7, spread=0.0))
    out = A.ms_deform_attn_plain(value, SHAPES, loc, aw)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, grid_sample_oracle(value, SHAPES, loc, aw), rtol=1e-12, atol=1e-14)


def test_function_gradcheck_float64():
    """Away from integer coordinates, where the bilinear weight has a kink."""
    g = torch.Generator().manual_seed(0)
    value = torch.rand(1, 30, 2, 3, generator=g, dtype=torch.float64, requires_grad=True)
    loc = (0.05 + 0.9 * torch.rand(1, 4, 2, 2, 2, 2, generator=g, dtype=torch.float64)).requires_grad_()
    aw = torch.rand(1, 4, 2, 2, 2, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda v, s, a: A.ms_deform_attn(v, SHAPES, s, a), (value, loc, aw))


def test_cpu_wrappers_take_plain_and_count_no_launch():
    value, loc, aw, g = make_inputs(8, seed=1, shapes=SHAPES4)
    before = (A.LAUNCHES, A.DVALUE_LAUNCHES, A.DLOCW_LAUNCHES)
    out = A.ms_deform_attn_fwd(value, SHAPES4, loc, aw)
    dv = A.ms_deform_attn_dvalue(g, value, SHAPES4, loc, aw)
    dl, da = A.ms_deform_attn_dlocw(g, value, SHAPES4, loc, aw)
    assert (A.LAUNCHES, A.DVALUE_LAUNCHES, A.DLOCW_LAUNCHES) == before
    torch.testing.assert_close(out, A.ms_deform_attn_plain(value, SHAPES4, loc, aw), rtol=0, atol=0)
    torch.testing.assert_close(dv, A.ms_deform_attn_dvalue_plain(g, value, SHAPES4, loc, aw), rtol=0, atol=0)
    rdl, rda = A.ms_deform_attn_dlocw_plain(g, value, SHAPES4, loc, aw)
    torch.testing.assert_close(dl, rdl, rtol=0, atol=0)
    torch.testing.assert_close(da, rda, rtol=0, atol=0)


def test_cpu_function_gradients_are_the_plain_backward():
    """The Function's gradients are the two plain backward functions', cast
    to the caller's dtypes (bf16 value and loc, fp32 aw)."""
    value, loc, aw, g = make_inputs(6, seed=2)
    v16, l16 = value.bfloat16(), loc.bfloat16()
    ins = [v16.clone().requires_grad_(), l16.clone().requires_grad_(), aw.clone().requires_grad_()]
    out = A.ms_deform_attn(ins[0], SHAPES, ins[1], ins[2])
    assert out.dtype == torch.bfloat16
    out.backward(g.bfloat16())
    assert [x.grad.dtype for x in ins] == [torch.bfloat16, torch.bfloat16, torch.float32]
    gb = g.bfloat16()
    dv = A.ms_deform_attn_dvalue_plain(gb, v16, SHAPES, l16.float(), aw)
    dl, da = A.ms_deform_attn_dlocw_plain(gb, v16, SHAPES, l16.float(), aw)
    torch.testing.assert_close(ins[0].grad, dv.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(ins[1].grad, dl.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(ins[2].grad, da, rtol=0, atol=0)


def test_non_cuda_device_raises():
    value = torch.empty(1, 30, 2, 4, device="meta")
    loc = torch.empty(1, 3, 2, 2, 2, 2, device="meta")
    aw = torch.empty(1, 3, 2, 2, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.ms_deform_attn_fwd(value, SHAPES, loc, aw)
    with pytest.raises(ValueError, match="CUDA"):
        A.ms_deform_attn_dlocw(torch.empty(1, 3, 8, device="meta"), value, SHAPES, loc, aw)


def test_layer_forward_shapes_and_seed():
    layer = A.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=2, seed=1)
    g = torch.Generator().manual_seed(0)
    query = torch.rand(2, 5, 32, generator=g)
    refs = torch.rand(2, 5, 2, 2, generator=g)
    value = torch.rand(2, 30, 32, generator=g)
    out = layer(query, refs, value, SHAPES)
    assert out.shape == (2, 5, 32) and bool(torch.isfinite(out).all())
    other = A.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=2, seed=2)
    assert not torch.equal(other.value_proj.weight, layer.value_proj.weight)
    with pytest.raises(ValueError, match="multiple"):
        A.MSDeformAttn(d_model=30, n_heads=8)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _check_kernels(value, loc, aw, g, shapes):
    before = (A.LAUNCHES, A.DVALUE_LAUNCHES, A.DLOCW_LAUNCHES)
    out = A.ms_deform_attn_fwd(value, shapes, loc, aw)
    dv = A.ms_deform_attn_dvalue(g, value, shapes, loc, aw)
    dl, da = A.ms_deform_attn_dlocw(g, value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert (A.LAUNCHES, A.DVALUE_LAUNCHES, A.DLOCW_LAUNCHES) == tuple(b + 1 for b in before)
    assert out.dtype == value.dtype and dv.dtype == dl.dtype == da.dtype == torch.float32
    ref = A.ms_deform_attn_plain(value, shapes, loc, aw)
    tol = FWD_TOL if value.dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(dv, A.ms_deform_attn_dvalue_plain(g, value, shapes, loc, aw), **DV_TOL)
    rdl, rda = A.ms_deform_attn_dlocw_plain(g, value, shapes, loc, aw)
    torch.testing.assert_close(dl, rdl, **DLOC_TOL)
    torch.testing.assert_close(da, rda, **DAW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [2, 30, 32, 64, 71, 1025, 2048, 3096])
def test_cuda_kernels_match_plain(cuda, channels):
    value, loc, aw, g = make_inputs(channels, seed=channels, lq=40, device=cuda)
    _check_kernels(value, loc, aw, g, SHAPES)
    _check_kernels(value.bfloat16(), loc, aw, g.bfloat16(), SHAPES)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_four_levels(cuda):
    value, loc, aw, g = make_inputs(32, seed=4, lq=150, shapes=SHAPES4, n=2, m=8, p=4, device=cuda)
    _check_kernels(value, loc, aw, g, SHAPES4)


@pytest.mark.cuda
def test_cuda_function_gradients_and_launches(cuda):
    value, loc, aw, g = make_inputs(16, seed=9, device=cuda)
    ins = [t.clone().requires_grad_() for t in (value, loc, aw)]
    before = (A.LAUNCHES, A.DVALUE_LAUNCHES, A.DLOCW_LAUNCHES)
    A.ms_deform_attn(ins[0], SHAPES, ins[1], ins[2]).backward(g)
    torch.cuda.synchronize()
    assert (A.LAUNCHES, A.DVALUE_LAUNCHES, A.DLOCW_LAUNCHES) == tuple(b + 1 for b in before)
    refs = [t.clone().requires_grad_() for t in (value, loc, aw)]
    A.ms_deform_attn_plain(refs[0], SHAPES, refs[1], refs[2]).backward(g)
    for got, ref, tol in zip(ins, refs, (DV_TOL, DLOC_TOL, DAW_TOL)):
        torch.testing.assert_close(got.grad, ref.grad, **tol)


@pytest.mark.cuda
def test_cuda_layer_matches_cpu(cuda):
    layer = A.MSDeformAttn(d_model=64, n_levels=4, n_heads=8, n_points=4, seed=0)
    g = torch.Generator().manual_seed(1)
    s = sum(h * w for h, w in SHAPES4)
    query, refs, value = (torch.rand(2, s, 64, generator=g), torch.rand(2, s, 4, 2, generator=g),
                          torch.rand(2, s, 64, generator=g))
    out_cpu = layer(query, refs, value, SHAPES4)
    out_dev = layer.to(cuda)(query.to(cuda), refs.to(cuda), value.to(cuda), SHAPES4)
    scale = float(out_cpu.detach().abs().max())
    assert float((out_dev.detach().cpu() - out_cpu.detach()).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda):
    value, loc, aw, g = make_inputs(4, seed=0, device=cuda)
    with pytest.raises(TypeError):
        A.ms_deform_attn_fwd(value, SHAPES, loc.double(), aw)
    with pytest.raises(TypeError):
        A.ms_deform_attn_fwd(value.half(), SHAPES, loc, aw)
    with pytest.raises(ValueError):
        A.ms_deform_attn_fwd(value, ((6, 4), (3, 3)), loc, aw)
    with pytest.raises(ValueError, match="CUDA"):
        A.ms_deform_attn_fwd(value, SHAPES, loc.cpu(), aw)
    with pytest.raises(ValueError):
        A.ms_deform_attn_dvalue(g.bfloat16(), value, SHAPES, loc, aw)
    with pytest.raises(ValueError):
        A.ms_deform_attn_fwd(value.transpose(2, 3), SHAPES, loc, aw)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose storage starts one element past a
    16-byte boundary (a slice of a larger buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# (channels, shapes, dtype, the plan's staged levels and vector width): every
# route of the forward and dLocation/dWeight kernels
ROUTES = {
    "all_staged_vector": (32, SHAPES4, torch.float32, (0, 1, 2, 3), 4),
    "all_staged_vector_bf16": (32, SHAPES4, torch.bfloat16, (0, 1, 2, 3), 8),
    "all_staged_scalar": (30, SHAPES4, torch.float32, (0, 1, 2, 3), 1),
    "some_staged": (64, ((32, 32), (8, 8), (4, 4)), torch.float32, (1, 2), 4),
    "some_staged_scalar_bf16": (71, ((40, 40), (8, 8), (4, 4)), torch.bfloat16, (1, 2), 1),
    "none_staged": (3096, ((6, 4), (5, 4)), torch.float32, (), 4),
    "none_staged_bf16": (3096, ((8, 6), (7, 6)), torch.bfloat16, (), 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cuda_kernel_routes(cuda, route):
    channels, shapes, dtype, staged, vec = ROUTES[route]
    value, loc, aw, g = make_inputs(channels, seed=len(route), lq=45, shapes=shapes, m=3, p=2, device=cuda)
    value, g = value.to(dtype), g.to(dtype)
    plan = A.msda_plan(shapes, 2, 45, 3, channels, 2, dtype)
    assert (plan.staged, plan.vec) == (staged, vec)
    _check_kernels(value, loc, aw, g, shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_misaligned_base(cuda, dtype):
    """value and g contiguous slices one element off a 16-byte boundary: the
    scalar route at a width that is otherwise vector-loaded."""
    value, loc, aw, g = make_inputs(32, seed=21, lq=60, shapes=SHAPES4, m=4, p=3, device=cuda)
    value, g = _misaligned(value.to(dtype)), _misaligned(g.to(dtype))
    assert A._call_plan(value, SHAPES4, loc, g).vec == 1
    _check_kernels(value, loc, aw, g, SHAPES4)


@pytest.mark.cuda
def test_cuda_kernels_ragged_chunks(cuda):
    """An Lq that the blocks' query chunks do not divide."""
    lq = 157
    plan = A.msda_plan(SHAPES4, 2, lq, 8, 32, 4, torch.float32, sm_count=A._sm_count(cuda.index or 0))
    per = -(-lq // plan.chunks)
    assert plan.chunks > 1 and lq % per != 0
    value, loc, aw, g = make_inputs(32, seed=22, lq=lq, shapes=SHAPES4, m=8, p=4, device=cuda)
    _check_kernels(value, loc, aw, g, SHAPES4)


@pytest.mark.cuda
@pytest.mark.parametrize("override", ["wide", "unstaged"])
def test_cuda_kernels_forced_plans(cuda, monkeypatch, override):
    """The 64-bit-offset instantiation and the empty stage on a small
    shape, by overriding the plan the wrappers take."""
    plan_of = A.msda_plan

    def forced(*args, **kwargs):
        plan = plan_of(*args, **kwargs)
        if override == "wide":
            return plan._replace(wide=True)
        return plan._replace(staged=(), smem_bytes=0)

    monkeypatch.setattr(A, "msda_plan", forced)
    value, loc, aw, g = make_inputs(32, seed=23, lq=70, shapes=SHAPES4, m=8, p=4, device=cuda)
    _check_kernels(value, loc, aw, g, SHAPES4)
    _check_kernels(value.bfloat16(), loc, aw, g.bfloat16(), SHAPES4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_encoder_shape(cuda, dtype):
    """Deformable DETR's encoder shape (N2, Lq = S = 5440, M8, D32, 4
    levels, P4): levels 1-3 staged."""
    shapes = ((64, 64), (32, 32), (16, 16), (8, 8))
    value, loc, aw, g = make_inputs(32, seed=24, lq=5440, shapes=shapes, m=8, p=4, device=cuda)
    value, g = value.to(dtype), g.to(dtype)
    assert A._call_plan(value, shapes, loc, g).staged == (1, 2, 3)
    _check_kernels(value, loc, aw, g, shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["stage_too_large", "vector_on_misaligned", "level_past_the_last"])
def test_cuda_refuses_plans_that_do_not_fit(cuda, monkeypatch, bad):
    """The C functions check the plan they are given."""
    shapes = ((40, 40), (8, 8))
    value, loc, aw, g = make_inputs(64, seed=25, lq=20, shapes=shapes, device=cuda)
    plan_of = A.msda_plan

    def forced(*args, **kwargs):
        plan = plan_of(*args, **kwargs)
        if bad == "stage_too_large":  # 1600 rows of 256 bytes
            return plan._replace(staged=(0, 1))
        if bad == "vector_on_misaligned":
            return plan._replace(vec=4)
        return plan._replace(staged=plan.staged + (2,))

    if bad == "vector_on_misaligned":
        value, g = _misaligned(value), _misaligned(g)
    monkeypatch.setattr(A, "msda_plan", forced)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        A.ms_deform_attn_fwd(value, shapes, loc, aw)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        A.ms_deform_attn_dlocw(g, value, shapes, loc, aw)
