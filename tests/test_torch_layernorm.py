"""The port's LayerNorm vs ``dgtd_tpu``'s ``layer_norm_pallas`` (CPU).

On the CPU the port runs its plain version; the JAX side runs the Pallas
kernel in interpret mode. Tolerances are tests/test_layernorm_pallas.py's:
fp32 rtol 1e-4 / atol 1e-5, bf16 with mean-100 rows 0.05, gradients rtol
1e-3 / atol 1e-4. The CUDA kernel is held to the plain version by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgtd_tpu.ops.layernorm_pallas import layer_norm_pallas
from dgtd_tpu_torch.ops import layernorm as L


@pytest.mark.parametrize("shape", [(3, 7, 130), (5, 64), (2, 3, 32), (300, 33), (4, 1100)])
def test_matches_pallas(shape):
    """C = 130 is test_layernorm_pallas.py's unaligned width; 300 rows pad
    the Pallas kernel's 256-row blocks; C = 1100 takes the kernel's
    block-per-row shape on the card."""
    rng = np.random.RandomState(shape[-1])
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    scale, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-6, True))
    before = L.LAUNCHES
    out = L.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    assert L.LAUNCHES == before and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_bf16_io_fp32_stats():
    """test_layernorm_pallas.py:26-37: mean-100 rows in bf16; a one-pass
    E[x²] − E[x]² variance would fail this."""
    rng = np.random.RandomState(1)
    x = (rng.randn(512, 64) * 3 + 100).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(layer_norm_pallas(xb, jnp.ones(64), jnp.zeros(64), 1e-5, True), np.float32)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
    out = L.layer_norm(xt, torch.ones(64), torch.zeros(64), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0.05, atol=0.05)
    want = torch.nn.functional.layer_norm(xt.float(), (64,), eps=1e-5)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=0.05, atol=0.05)


def test_gradients_match_jax_grad():
    """test_layernorm_pallas.py:40-56, against jax.grad of the Pallas op (its
    backward is the VJP of ``_ln_reference``)."""
    rng = np.random.RandomState(2)
    x, s, b = rng.randn(64, 32).astype(np.float32), rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    jgx, jgs, jgb = jax.grad(lambda x, s, b: jnp.sum(layer_norm_pallas(x, s, b, 1e-6, True) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
    (L.layer_norm(*ins, 1e-6) ** 2).sum().backward()
    for got, want in zip(ins, (jgx, jgs, jgb)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
