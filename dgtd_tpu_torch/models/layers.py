"""Shared conv/attention building blocks in NCHW (counterpart of
``dgtd_tpu/models/layers.py``).

Parameter names follow the reference's ``hitnet.*`` state-dict schema, so a
reference checkpoint loads by key. Initializers follow the JAX package's
torch-parity schemes and take an explicit ``torch.Generator``
(:func:`init_parameters`): a module built by :func:`conv2d` or
:func:`linear` records its scheme in ``init_scheme``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2d(cin, cout, kernel, stride=1, padding=0, groups=1, bias=True, init="torch"):
    """``nn.Conv2d`` tagged with its init scheme: "torch" (U(±1/sqrt(fan_in))
    for weight and bias) or "pvt" (normal(0, sqrt(2/fan_out)), zero bias)."""
    m = nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=bias)
    m.init_scheme = init
    return m


def linear(cin, cout, bias=True, init="trunc"):
    """``nn.Linear`` tagged with its init scheme: "trunc" (trunc_normal(0.02),
    zero bias), "torch" (U(±1/sqrt(fan_in))) or "lecun" (flax's default
    ``nn.Dense``: lecun-normal, a normal truncated at ±2 std whose std is
    sqrt(1/fan_in)/0.8796, zero bias)."""
    m = nn.Linear(cin, cout, bias)
    m.init_scheme = init
    return m


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize every parameter and BN statistic of ``module`` from
    ``generator`` with the JAX package's schemes, in module order."""
    for m in module.modules():
        scheme = getattr(m, "init_scheme", None)
        if isinstance(m, nn.Conv2d):
            if scheme == "pvt":
                fan_out = max(m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups, 1)
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            else:
                fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Linear):
            if scheme == "trunc":
                nn.init.trunc_normal_(m.weight, 0.0, 0.02, -0.04, 0.04, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif scheme == "lecun":
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            else:
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
    return module


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with fp32 statistics; the output keeps
    the input's dtype (the JAX ``LayerNorm`` under a bf16 policy)."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class LayerNorm2d(LayerNorm):
    """The channels-last LayerNorm applied to an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class PReLU(nn.PReLU):
    """torch ``nn.PReLU()`` (one slope, init 0.25), in the input's dtype."""

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm ``DropPath``): in train mode each
    sample is kept with probability ``1 − rate`` and scaled by ``1/keep``.

    The mask is drawn from ``self.generator``, which the caller sets
    explicitly (:func:`set_drop_path_generator`); with none set, nothing is
    dropped. ``cod.loss`` refuses to run without one when a rate is not 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0 or self.generator is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_drop_path_generator(module: nn.Module, generator) -> None:
    """Point every ``DropPath`` under ``module`` at ``generator`` (None clears)."""
    for m in module.modules():
        if isinstance(m, DropPath):
            m.generator = generator


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-5). The reference defines a ReLU
    but never applies it; neither does this.

    Train mode normalizes with the batch statistics (fp32) and updates the
    running ones with flax's rule, momentum 0.9 (torch's 0.1), and flax's
    **biased** batch variance. The reference's ``nn.BatchNorm2d`` folds the
    unbiased variance into ``running_var``, a factor n/(n−1) larger (n = B·H·W
    per channel); the port follows the JAX package, so its running variance
    is that much smaller than the reference's after the same batches."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x):
        y = self.conv(x)
        if not self.training:
            return self.bn(y)
        bn = self.bn
        yf = y.float()
        out = F.batch_norm(yf, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(yf, dim=(0, 2, 3), unbiased=False)
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
            bn.num_batches_tracked.add_(1)
        return out.to(y.dtype)


class CALayer(nn.Module):
    """MPRNet channel attention: global mean -> 1x1 -> ReLU -> 1x1 -> sigmoid."""

    def __init__(self, c, reduction):
        super().__init__()
        mid = max(1, c // reduction)
        self.conv_du = nn.Sequential(
            conv2d(c, mid, 1, bias=False), nn.ReLU(), conv2d(mid, c, 1, bias=False), nn.Sigmoid()
        )

    def forward(self, x):
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class CAB(nn.Module):
    """3x3 conv -> PReLU -> 3x3 conv -> CALayer (reduction 4), plus the
    residual; no biases (the HitNet decoder's setting)."""

    def __init__(self, c):
        super().__init__()
        self.body = nn.Sequential(
            conv2d(c, c, 3, padding=1, bias=False),
            PReLU(),
            conv2d(c, c, 3, padding=1, bias=False),
        )
        self.CA = CALayer(c, reduction=4)

    def forward(self, x):
        return self.CA(self.body(x)) + x


class CABStack(nn.Sequential):
    """Two chained CABs (keys ``<name>.<i>.body...``)."""

    def __init__(self, c):
        super().__init__(CAB(c), CAB(c))


class SAMFusion(nn.Module):
    """Dual squeeze-excitation gated fusion (reference ``SAM``): each input
    gets channel attention and a learned scalar gate; the two are summed."""

    def __init__(self, c):
        super().__init__()
        squeeze = max(1, c // 16)
        self.fc = nn.Sequential(
            linear(c, squeeze, bias=False, init="torch"), nn.ReLU(),
            linear(squeeze, c, bias=False, init="torch"), nn.Sigmoid(),
        )
        self.fc_wight = nn.Sequential(
            linear(c, squeeze, bias=False, init="torch"), nn.ReLU(),
            linear(squeeze, 1, bias=False, init="torch"), nn.Sigmoid(),
        )

    def _branch(self, x):
        y = x.mean(dim=(2, 3))
        g = self.fc(y)[:, :, None, None]
        w = self.fc_wight(y)[:, :, None, None]
        return x * g * w

    def forward(self, x_h, x_l):
        return self._branch(x_h) + self._branch(x_l)
