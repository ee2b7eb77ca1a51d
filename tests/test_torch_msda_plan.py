"""The MSDA kernels' plan (``ops/msda.py::msda_plan``) and the gather
counts of ``tools/profile_msda.py``, from shapes and small tensors on the
CPU: no JAX, no card, nothing large allocated."""

import itertools

import numpy as np
import pytest
import torch

from dgtd_tpu_torch.ops import msda as A
from dgtd_tpu_torch.tools import profile_msda as P

ENC = ((64, 64), (32, 32), (16, 16), (8, 8))


@pytest.mark.parametrize("dtype, vec", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_encoder_shape_stages_the_three_small_levels(dtype, vec):
    plan = A.msda_plan(ENC, 2, 5440, 8, 32, 4, dtype)
    item = 4 if dtype == torch.float32 else 2
    assert plan.staged == (1, 2, 3) and A._plan_args(plan)[0] == 0b1110
    assert plan.smem_bytes == (32 * 32 + 16 * 16 + 8 * 8) * 32 * item <= A.SMEM_MAX
    # one wave: 16 heads x 8 chunks, a block an SM of 132
    assert (plan.vec, plan.chunks, plan.wide) == (vec, 8, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_rows_stage_nothing(dtype):
    plan = A.msda_plan(ENC, 2, 5440, 8, 3096, 4, dtype)
    assert plan.staged == () and A._plan_args(plan)[0] == 0 and plan.smem_bytes == 0
    assert plan.chunks == -(-5440 // (A.THREADS // 32))  # one query a warp


def test_levels_staged_smallest_first_while_they_fit():
    # D = 3096 fp32: a row is 12384 bytes; the 6-pixel level fits, the
    # 24-pixel one does not
    plan = A.msda_plan(((6, 4), (3, 2)), 2, 40, 2, 3096, 3, torch.float32)
    assert plan.staged == (1,) and plan.smem_bytes == 6 * 3096 * 4
    plan = A.msda_plan(((32, 32), (8, 8), (4, 4)), 2, 45, 3, 64, 2, torch.float32)
    assert plan.staged == (1, 2)


def test_sixteen_levels_accepted_seventeen_refused():
    plan = A.msda_plan(((2, 2),) * 16, 1, 10, 2, 8, 2, torch.float32)
    assert A._plan_args(plan)[0] == (1 << 16) - 1
    with pytest.raises(ValueError, match="16 levels"):
        A.msda_plan(((2, 2),) * 17, 1, 10, 2, 8, 2, torch.float32)


@pytest.mark.parametrize("dtype, d, aligned, vec", [
    (torch.float32, 32, True, 4), (torch.bfloat16, 32, True, 8), (torch.float32, 12, True, 4),
    (torch.bfloat16, 24, True, 8), (torch.float32, 71, True, 1), (torch.bfloat16, 30, True, 1),
    (torch.float32, 2, True, 1), (torch.float32, 32, False, 1), (torch.bfloat16, 32, False, 1),
])
def test_vector_width(dtype, d, aligned, vec):
    assert A.msda_plan(ENC, 2, 100, 8, d, 4, dtype, aligned=aligned).vec == vec


def test_a_base_one_element_off_takes_the_scalar_route():
    buf = torch.zeros(2 * 30 * 2 * 32 + 1)
    whole, off = buf[:-1].view(2, 30, 2, 32), buf[1:].view(2, 30, 2, 32)
    assert off.is_contiguous() and A.aligned16(whole) and not A.aligned16(off)
    shapes = ((5, 4), (5, 2))
    assert A.msda_plan(shapes, 2, 7, 2, 32, 3, torch.float32, aligned=A.aligned16(whole)).vec == 4
    assert A.msda_plan(shapes, 2, 7, 2, 32, 3, torch.float32, aligned=A.aligned16(off)).vec == 1


def test_offsets_past_32_bits_take_the_wide_kernels():
    assert not A.msda_plan(ENC, 2, 5440, 8, 32, 4, torch.float32).wide
    # a head's value: S * M * D = 5440 * 8 * 65536 > 2^31 - 1
    assert A.msda_plan(ENC, 1, 5440, 8, 65536, 4, torch.bfloat16).wide
    # the queries' locations: Lq * M * L * P * 2 > 2^31 - 1
    assert A.msda_plan(ENC, 1, 2 ** 24, 8, 32, 4, torch.float32).wide
    assert not A.msda_plan(ENC, 1, 2 ** 22, 8, 32, 4, torch.float32).wide


def test_chunks_fill_one_wave_and_follow_the_card():
    assert A.msda_plan(ENC, 2, 5440, 8, 32, 4, torch.float32, sm_count=66).chunks == 4
    # more heads than SMs: one chunk a head
    assert A.msda_plan(ENC, 40, 5440, 8, 32, 4, torch.float32).chunks == 1
    # few queries: no more chunks than one query a warp needs
    assert A.msda_plan(ENC, 2, 40, 8, 32, 4, torch.float32).chunks == 2


def _brute_counts(loc, shapes, row_bytes, staged):
    n, lq, m, n_levels, p, _ = loc.shape
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    staged_b = unstaged_b = 0
    distinct = []
    for ni, qi, mi in itertools.product(range(n), range(lq), range(m)):
        rows = set()
        for lid, pi in itertools.product(range(n_levels), range(p)):
            h, w = shapes[lid]
            x = np.float32(loc[ni, qi, mi, lid, pi, 0]) * np.float32(w) - np.float32(0.5)
            y = np.float32(loc[ni, qi, mi, lid, pi, 1]) * np.float32(h) - np.float32(0.5)
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            for xi, yi in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
                if 0 <= xi < w and 0 <= yi < h:
                    rows.add(int(starts[lid]) + yi * w + xi)
                    if lid in staged:
                        staged_b += row_bytes
                    else:
                        unstaged_b += row_bytes
        distinct.append(len(rows))
    return staged_b, unstaged_b, float(np.mean(distinct))


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_counts_match_a_brute_force_count(seed):
    rng = np.random.RandomState(seed)
    shapes = ((3, 4), (2, 2), (1, 3))
    loc = (rng.rand(2, 5, 3, 3, 2, 2) * 1.4 - 0.2).astype(np.float32)
    # samples on pixel centres share corners with their neighbours
    loc[:, :2] = (rng.randint(0, 2, size=(2, 2, 3, 3, 2, 2)) + 0.5) / 2
    got = P.gather_counts(torch.from_numpy(loc), shapes, 32, 4, (1, 2))
    staged_b, unstaged_b, distinct = _brute_counts(loc, shapes, 128, (1, 2))
    assert got["corner_bytes_staged"] == staged_b and got["corner_bytes_unstaged"] == unstaged_b
    assert got["distinct_rows_per_query_head"] == pytest.approx(distinct, rel=1e-6)


def test_encoder_grid_points_are_pixel_centres():
    shapes = ((4, 6), (2, 3), (1, 2))
    refs = P.encoder_grid_refs(shapes, 2)
    s = sum(h * w for h, w in shapes)
    assert refs.shape == (2, s, 3, 2)
    assert torch.equal(refs, refs[:, :, :1].expand_as(refs))  # the same point on every level
    start = 0
    for h, w in shapes:
        pts = refs[0, start:start + h * w, 0]
        start += h * w
        px, py = pts[:, 0] * w - 0.5, pts[:, 1] * h - 0.5
        assert torch.equal(px, px.round()) and torch.equal(py, py.round())
        cells = (py.long() * w + px.long()).tolist()
        assert cells == list(range(h * w))  # row-major, one query a pixel
