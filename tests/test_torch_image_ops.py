"""The port's image ops and host helpers vs ``dgtd_tpu`` (fp32, CPU).

Inputs come from numpy seeds and go through both packages; the JAX side is
NHWC, the port NCHW.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgtd_tpu.core.config import _parse_value as jax_parse_value
from dgtd_tpu.data import device_norm as jax_norm
from dgtd_tpu.utils import image as J
from dgtd_tpu.utils.files import list_images as jax_list_images
from dgtd_tpu_torch.core.config import _parse_value
from dgtd_tpu_torch.data import device_norm as port_norm
from dgtd_tpu_torch.utils import image as T
from dgtd_tpu_torch.utils.files import list_images


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


# bilinear: the JAX matrices are fp32 matmuls at HIGHEST precision, torch
# interpolates directly; both are fp32 sums of two or four terms
BILINEAR_TOL = dict(rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((12, 12), (384, 384)), ((96, 96), (24, 24)), ((13, 20), (7, 31)), ((7, 31), (13, 20)), ((1, 5), (4, 9))],
)
@pytest.mark.parametrize("align", [False, True])
def test_resize_bilinear_matches_jax(in_hw, out_hw, align):
    x = np.random.RandomState(0).randn(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(J.resize_bilinear(jnp.asarray(x), out_hw, align))
    out = nhwc(T.resize_bilinear(nchw(x), out_hw, align))
    np.testing.assert_allclose(out, ref, **BILINEAR_TOL)


def test_resize_bilinear_inexact_keeps_dtype():
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 2, 6, 10).astype(np.float32))
    out = T.resize_bilinear(x.to(torch.bfloat16), (9, 4), exact=False)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 9, 4)
    assert T.resize_bilinear(x, (6, 10)) is x


@pytest.mark.parametrize("in_hw,out_hw", [((384, 384), (12, 12)), ((13, 20), (5, 7)), ((5, 7), (13, 20)), ((45, 64), (12, 12))])
def test_resize_nearest_matches_jax_exactly(in_hw, out_hw):
    x = np.random.RandomState(2).randn(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(J.resize_nearest(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(nhwc(T.resize_nearest(nchw(x), out_hw)), ref)


@pytest.mark.parametrize("k,hw", [(1, (5, 5)), (3, (6, 9)), (7, (12, 12)), (7, (13, 20))])
def test_extract_patches_matches_jax_tap_order(k, hw):
    x = np.random.RandomState(3).randn(2, *hw, 4).astype(np.float32)
    ref = np.asarray(J.extract_patches(jnp.asarray(x), k, k // 2))  # (B,H,W,C,k²)
    out = T.extract_patches(nchw(x), k, k // 2).numpy()  # (B,C,k²,H,W)
    np.testing.assert_array_equal(np.transpose(out, (0, 3, 4, 1, 2)), ref)


# FFT: pocketfft (numpy/XLA CPU) vs torch's FFT in fp32 — round-off of a
# 64x64 transform pair
@pytest.mark.parametrize("hw,rate", [((64, 64), 0.3), ((48, 80), 0.3), ((33, 20), 0.5)])
def test_fft_high_pass_matches_jax(hw, rate):
    x = np.random.RandomState(4).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(J.fft_high_pass(jnp.asarray(x), rate))
    out = nhwc(T.fft_high_pass(nchw(x), rate))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_device_norm_matches_jax():
    u8 = np.random.RandomState(5).randint(0, 256, (2, 7, 5, 3)).astype(np.uint8)
    ref = np.asarray(jax_norm.normalize_image(jnp.asarray(u8)))
    np.testing.assert_allclose(port_norm.normalize_image(torch.from_numpy(u8)).numpy(), ref, rtol=1e-6, atol=1e-6)
    plane = u8[..., :1]
    np.testing.assert_allclose(
        port_norm.scale_plane(torch.from_numpy(plane)).numpy(),
        np.asarray(jax_norm.scale_plane(jnp.asarray(plane))), rtol=1e-7,
    )
    f = torch.zeros(1, 2, 2, 3)
    assert port_norm.normalize_image(f) is f and port_norm.scale_plane(f) is f
    np.testing.assert_array_equal(port_norm.IMAGENET_MEAN, jax_norm.IMAGENET_MEAN)
    np.testing.assert_array_equal(port_norm.IMAGENET_STD, jax_norm.IMAGENET_STD)


def test_list_images_and_override_parser_match_jax(tmp_path):
    for name in ("b.png", "a.JPG", "notes.txt", ".DS_Store", "c.webp"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub").mkdir()
    assert list_images(str(tmp_path)) == jax_list_images(str(tmp_path)) == ["a.JPG", "b.png", "c.webp"]
    for raw in ("b0", "[1,1,2,1]", "true", "False", "null", "3", "0.5", "(8, 16)", "x=y"):
        assert _parse_value(raw) == jax_parse_value(raw)


@pytest.mark.parametrize("kernel,stride,pad,hw", [(31, 1, 15, (40, 33)), (3, 1, 0, (12, 17)), (3, 2, 1, (9, 10))])
def test_avg_pool_matches_jax(kernel, stride, pad, hw):
    x = np.random.RandomState(kernel + hw[1]).rand(2, *hw, 3).astype(np.float32)
    ref = np.asarray(J.avg_pool(jnp.asarray(x), kernel, stride, pad))
    np.testing.assert_allclose(nhwc(T.avg_pool(nchw(x), kernel, stride, pad)), ref, rtol=1e-5, atol=1e-6)


def test_reflect_pad_and_normalize_01_match_jax():
    x = np.random.RandomState(3).randn(2, 7, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(nhwc(T.reflect_pad(nchw(x), 1)), np.asarray(J.reflect_pad(jnp.asarray(x), 1)))
    # one min and max over the whole batch: image 0, inside image 1's range,
    # does not reach 0 or 1
    x[1] *= 4.0
    got = nhwc(T.normalize_01(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(J.normalize_01(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    assert 0.0 < got[0].min() and got[0].max() < 1.0


def test_normalize_batch_matches_jax():
    rng = np.random.RandomState(4)
    batch = {"input": rng.randint(0, 256, (2, 5, 6, 3)).astype(np.uint8),
             "depth": rng.randint(0, 256, (2, 5, 6, 1)).astype(np.uint8),
             "label": rng.rand(2, 5, 6, 1).astype(np.float32), "raw": ["a", "b"]}
    ref = jax_norm.normalize_batch({k: jnp.asarray(v) if k != "raw" else v for k, v in batch.items()})
    got = port_norm.normalize_batch({k: torch.from_numpy(v) if k != "raw" else v for k, v in batch.items()})
    assert got["raw"] == ["a", "b"]
    for k in ("input", "depth", "label"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw,scale", [((24, 20), 0.5), ((25, 19), 0.5), ((12, 10), 2.0), ((13, 7), 0.37)])
@pytest.mark.parametrize("align", [False, True])
def test_resize_scale_matches_jax(hw, scale, align):
    x = np.random.RandomState(7).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(J.resize_scale(jnp.asarray(x), scale, align))
    out = nhwc(T.resize_scale(nchw(x), scale, align))
    assert out.shape == ref.shape == (2, int(np.floor(hw[0] * scale)), int(np.floor(hw[1] * scale)), 3)
    np.testing.assert_allclose(out, ref, **BILINEAR_TOL)


@pytest.mark.parametrize("kernel,stride,pad", [(3, 2, 1), (2, 2, 0), (3, 1, 1), (5, 3, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_max_pool_matches_jax(kernel, stride, pad, dtype):
    """Padding with the dtype's minimum, so a window of negatives keeps its
    own maximum; integers too."""
    x = (np.random.RandomState(8).randn(2, 11, 9, 3) * 100 - 50).astype(dtype)
    ref = np.asarray(J.max_pool(jnp.asarray(x), kernel, stride, pad))
    out = nhwc(T.max_pool(nchw(x), kernel, stride, pad))
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
