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
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel import space
from ..parallel.dist import all_reduce_sum, data_group, rank_world


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state-dict keys) that runs on
    this rank's band of H under a data×space layout
    (``parallel/space.py::conv_rows``: the halo geometry, or the gathered
    level where the layout says so). ``h`` is the global height of the
    input's level; a conv wider or more strided than 1x1 needs it under a
    layout. Without one, or for a 1x1 conv, it is ``nn.Conv2d``."""

    def forward(self, x, h=None):
        if not space.split() or self.pointwise:
            return super().forward(x)
        return space.conv_rows(self, x, h)

    @property
    def pointwise(self) -> bool:
        return self.kernel_size == (1, 1) and self.stride == (1, 1) and self.padding == (0, 0)

    def out_rows(self, h: int) -> int:
        """The output's rows for ``h`` input rows."""
        return space.conv_out_rows(h, self.kernel_size[0], self.stride[0], self.padding[0], self.dilation[0])


def conv2d(cin, cout, kernel, stride=1, padding=0, groups=1, bias=True, init="torch"):
    """:class:`Conv2d` tagged with its init scheme: "torch" (U(±1/sqrt(fan_in))
    for weight and bias) or "pvt" (normal(0, sqrt(2/fan_out)), zero bias)."""
    m = Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=bias)
    m.init_scheme = init
    return m


def sequential(seq: nn.Sequential, x, h=None):
    """``seq(x)`` with the input level's global height ``h`` given to each
    :class:`Conv2d` and carried through its stride; -> (output, its h)."""
    for m in seq:
        if isinstance(m, Conv2d):
            x = m(x, h)
            h = None if h is None else m.out_rows(h)
        else:
            x = m(x)
    return x, h


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
    dropped. ``cod.loss`` refuses to run without one when a rate is not 0.
    Under data parallelism (``parallel/dist.py::data_group``) every rank
    draws the global batch's mask from the same generator and takes its own
    rows, so the ranks drop the samples that one process would; under a
    data×space layout the rows are its data row's, so the space ranks of a
    row drop the same samples."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0 or self.generator is None:
            return x
        keep = 1.0 - self.rate
        b = x.shape[0]
        rank, world = rank_world(data_group())
        shape = (b * world,) + (1,) * (x.dim() - 1)
        mask = (torch.rand(shape, generator=self.generator, device=x.device) < keep)[rank * b:(rank + 1) * b]
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_drop_path_generator(module: nn.Module, generator) -> None:
    """Point every ``DropPath`` under ``module`` at ``generator`` (None clears)."""
    for m in module.modules():
        if isinstance(m, DropPath):
            m.generator = generator


def checkpointed(block: nn.Module, *args):
    """``block(*args)`` with activation checkpointing (``torch.utils.checkpoint``,
    non-reentrant): the block's activations are dropped after the forward and
    recomputed in backward (the JAX package's ``nn.remat``).

    The recompute must compute what the forward did. The checkpoint restores
    autocast and the global RNGs, but DropPath draws from explicit
    generators, and ``cod.loss`` clears them and puts the module back in
    eval mode before the backward. So the recompute runs with every
    submodule's mode, every DropPath's generator and each generator's state
    as they were at the forward, and puts back what it found afterwards.
    A BatchNorm would update its running statistics twice: a block that
    holds one raises. Under a data×space layout the recompute runs under
    the forward's layout (``parallel/space.py``), which the thread of a
    CUDA backward does not see."""
    modules = list(block.modules())
    if any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in modules):
        raise ValueError(f"checkpointed: {type(block).__name__} holds a BatchNorm, "
                         "whose statistics the recompute would update again")
    drops = [m for m in modules if isinstance(m, DropPath)]
    saved = ([m.training for m in modules], [m.generator for m in drops],
             {id(g): (g, g.get_state()) for m in drops if (g := m.generator) is not None})
    calls = [0]
    layout = space.current()

    def swap(state):
        """Put ``state`` (modes, generators, generator states) in place;
        returns what was there."""
        modes, gens, gen_states = state
        was = ([m.training for m in modules], [m.generator for m in drops],
               {k: (g, g.get_state()) for k, (g, _) in gen_states.items()})
        for m, t in zip(modules, modes):
            m.training = t
        for m, g in zip(drops, gens):
            m.generator = g
        for g, st in gen_states.values():
            g.set_state(st)
        return was

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return block(*a)
        was = swap(saved)
        try:
            with space.active_space(layout):
                return block(*a)
        finally:
            swap(was)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-5). The reference defines a ReLU
    but never applies it; neither does this.

    Train mode normalizes with the batch statistics (fp32) and updates the
    running ones with flax's rule, momentum 0.9 (torch's 0.1), and flax's
    **biased** batch variance. The reference's ``nn.BatchNorm2d`` folds the
    unbiased variance into ``running_var``, a factor n/(n−1) larger (n = B·H·W
    per channel); the port follows the JAX package, so its running variance
    is that much smaller than the reference's after the same batches.

    Under data parallelism (``parallel/dist.py::data_group``) the statistics
    are the global batch's, as XLA reduces them across the JAX package's
    mesh: the ranks sum their counts and sums, then their squared deviations
    from the global mean, by all-reduces whose backward all-reduces the
    gradient; every rank then writes the same running statistics. Under a
    data×space layout a banded output level sums over every rank of the
    world (each holds distinct pixels); a replicated one over the data
    group only, since the space ranks of a data row hold the same pixels
    (:func:`bn_group`)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x, h=None):
        """``h``: the global height of x's level (``Conv2d``); a train-mode
        forward under a data×space layout needs it, 1x1 too."""
        y = self.conv(x, h)
        if not self.training:
            return self.bn(y)
        bn = self.bn
        yf = y.float()
        group = bn_group(None if h is None else self.conv.out_rows(h))
        if group is None:
            out = F.batch_norm(yf, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(yf, dim=(0, 2, 3), unbiased=False)
        else:
            out, mean, var = _global_batch_norm(yf, bn, group)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
            bn.num_batches_tracked.add_(1)
        return out.to(y.dtype)


def bn_group(out_h):
    """The group a train-mode BatchNorm sums its statistics over, for an
    output level of ``out_h`` global rows: the data group
    (``parallel/dist.py::data_group``; None for one process) without a
    layout that splits H; under one the world for a banded level, the data
    group (None when it is one rank) for a replicated one, whose space
    ranks hold the same pixels (the world would count each of them
    ``space`` times: the same statistics for more traffic)."""
    if not space.split():
        return data_group()
    if out_h is None:
        raise ValueError("a train-mode BatchNorm under a data×space layout needs its level's global height")
    if space.banded(out_h):
        return dist.group.WORLD
    return data_group() if space.current().data > 1 else None


def _global_batch_norm(yf: torch.Tensor, bn: nn.BatchNorm2d, group):
    """Train-mode BatchNorm of an NCHW fp32 ``yf`` with the statistics of the
    global batch over ``group``: (output, mean, biased variance), the
    statistics detached."""
    c = yf.shape[1]
    sums = all_reduce_sum(torch.cat([yf.sum((0, 2, 3)), yf.new_full((1,), yf.numel() // c)]), group)
    n = sums[c]
    mean = (sums[:c] / n).view(1, c, 1, 1)
    dev = yf - mean
    var = (all_reduce_sum((dev * dev).sum((0, 2, 3)), group) / n).view(1, c, 1, 1)
    out = dev * torch.rsqrt(var + bn.eps) * bn.weight.view(1, c, 1, 1) + bn.bias.view(1, c, 1, 1)
    return out, mean.detach().view(c), var.detach().view(c)


class CALayer(nn.Module):
    """MPRNet channel attention: global mean -> 1x1 -> ReLU -> 1x1 -> sigmoid."""

    def __init__(self, c, reduction, bias=False):
        super().__init__()
        mid = max(1, c // reduction)
        self.conv_du = nn.Sequential(
            conv2d(c, mid, 1, bias=bias), nn.ReLU(), conv2d(mid, c, 1, bias=bias), nn.Sigmoid()
        )

    def forward(self, x, h=None):
        return x * self.conv_du(space.spatial_mean(x, h, keepdim=True))


class CAB(nn.Module):
    """k x k conv -> PReLU -> k x k conv -> CALayer, plus the residual; the
    defaults (3x3, reduction 4, no biases) are the HitNet decoder's."""

    def __init__(self, c, kernel=3, reduction=4, bias=False):
        super().__init__()
        self.body = nn.Sequential(
            conv2d(c, c, kernel, padding=kernel // 2, bias=bias),
            PReLU(),
            conv2d(c, c, kernel, padding=kernel // 2, bias=bias),
        )
        self.CA = CALayer(c, reduction, bias)

    def forward(self, x, h=None):
        return self.CA(sequential(self.body, x, h)[0], h) + x


class CABStack(nn.Sequential):
    """``n`` chained CABs (keys ``<name>.<i>.body...``)."""

    def __init__(self, c, n=2, kernel=3, reduction=4, bias=False):
        super().__init__(*[CAB(c, kernel, reduction, bias) for _ in range(n)])

    def forward(self, x, h=None):
        for cab in self:
            x = cab(x, h)
        return x


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

    def _branch(self, x, h):
        y = space.spatial_mean(x, h)
        g = self.fc(y)[:, :, None, None]
        w = self.fc_wight(y)[:, :, None, None]
        return x * g * w

    def forward(self, x_h, x_l, h=None):
        return self._branch(x_h, h) + self._branch(x_l, h)
