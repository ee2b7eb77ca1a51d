"""How the reference computes its products.

``fp32`` is the reference itself: every convolution, linear layer and
matrix product in float32 with TF32 off (the caller turns it off on the
card). ``fp8`` is the control: the same products with each operand rounded
to ``float8_e4m3fn`` under a per-tensor scale (its absolute maximum mapped
to 448, as an fp8 GEMM with per-tensor scaling rounds it), products summed
in float32, the gradient passed straight through the rounding. Norms,
softmax, the losses and the optimizer stay float32 in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        scale = E4M3_MAX / t.detach().abs().amax().clamp_min(1e-30)
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Numerics:
    """The products of one reference run; ``mode`` is "fp32" or "fp8"."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"numerics mode must be fp32 or fp8, got {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mode == "fp32" else _RoundFp8.apply(t)

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)
