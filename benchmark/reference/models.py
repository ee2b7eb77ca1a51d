"""``cod`` and ``DQnet`` as functions of a flat state dict.

``spec(arch)`` lists every tensor of a model's state dict (name, shape,
kind, fan-in) in a fixed order, from the architecture block of a benchmark
configuration file; ``forward(arch, P, image, depth, train, gen, nx)`` runs
the model on NCHW inputs (the ImageNet-normalized image, depth in [0, 1])
and returns (texture or None, [stage logits], second logits). ``train``
picks BatchNorm's batch statistics (and DropPath, with ``gen``) over its
running ones. ``nx`` (:class:`~.numerics.Numerics`) computes every product.

The equations, by module:

* PVTv2: overlapping patch embedding (conv, LayerNorm 1e-5); blocks of
  pre-norm (1e-6) spatial-reduction attention (keys and values from a
  strided conv and LayerNorm 1e-5 of the normed tokens where the ratio is
  above 1; softmax of q·kᵀ/√d) and MixFFN (fc1, depthwise 3×3, exact GELU,
  fc2), each residual branch through DropPath; the prompt of a block, resized
  bilinearly to the stage, added to the tokens before it; a LayerNorm 1e-6
  after each stage.
* Prompt encoder (``cod``): the FFT high-pass texture of the image, its
  nearest downsampling to the grid; sigmoid(1×1 conv) of it as k² affinities
  per latent channel, normalized to sum 1 over the taps (+1e-5); the depth
  resized to the grid through a 1×1 conv to the latent channels; the
  stencil's steps; a 1×1 conv to 3 channels resized to the image, added to
  the image; a ConvNeXt tower (dw 7×7, LayerNorm, 4× MLP with GELU, layer
  scale, DropPath) with an FPN head (1×1 convs, resized to the first
  stage, concatenated, 1×1 conv) to 24 channels.
* Prompt decoders (``cod``): per PVT block, three 3×3 convs with ReLUs
  from the embedding to the stage's channels.
* Depth prompts (``DQnet``): the depth resized to ``cross_size``², per
  stage a Linear 1 → C/2, per block a Linear C/2 → C/2 and GELU, a shared
  Linear C/2 → C.
* HitNet decoder: channel-attention blocks (two 3×3 convs around a PReLU,
  a squeeze of the spatial mean, a residual), conv+BatchNorm translayers,
  ``refine_iters`` refinement iterations, the dual squeeze-excitation
  fusion; stage and second logits resized to the image.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics
from .ops import drop_path, fft_high_pass, layer_norm, resize, resize_nearest, stencil

EMBED_DIM = 24


# ---------------------------------------------------------------------------
# the state dict's tensors
# ---------------------------------------------------------------------------


class _Spec:
    def __init__(self):
        self.items = []

    def conv(self, name, cout, cin, k, groups=1, bias=True):
        self.items.append((f"{name}.weight", (cout, cin // groups, k, k), "weight", cin // groups * k * k))
        if bias:
            self.items.append((f"{name}.bias", (cout,), "bias", 0))

    def linear(self, name, cout, cin, bias=True):
        self.items.append((f"{name}.weight", (cout, cin), "weight", cin))
        if bias:
            self.items.append((f"{name}.bias", (cout,), "bias", 0))

    def norm(self, name, c):
        self.items.append((f"{name}.weight", (c,), "norm_weight", 0))
        self.items.append((f"{name}.bias", (c,), "norm_bias", 0))

    def bn(self, name, c):
        self.norm(name, c)
        self.items.append((f"{name}.running_mean", (c,), "running_mean", 0))
        self.items.append((f"{name}.running_var", (c,), "running_var", 0))
        self.items.append((f"{name}.num_batches_tracked", (), "count", 0))

    def add(self, name, shape, kind):
        self.items.append((name, tuple(shape), kind, 0))


def _pvt_spec(sp: _Spec, pre: str, pvt: dict) -> None:
    dims, ratios, depths, srs = pvt["embed_dims"], pvt["mlp_ratios"], pvt["depths"], pvt["sr_ratios"]
    for s in range(4):
        cin, patch, d = (3 if s == 0 else dims[s - 1]), (7 if s == 0 else 3), dims[s]
        sp.conv(f"{pre}.patch_embed{s + 1}.proj", d, cin, patch)
        sp.norm(f"{pre}.patch_embed{s + 1}.norm", d)
        hid = int(d * ratios[s])
        for i in range(depths[s]):
            b = f"{pre}.block{s + 1}.{i}"
            sp.norm(f"{b}.norm1", d)
            sp.linear(f"{b}.attn.q", d, d)
            sp.linear(f"{b}.attn.kv", 2 * d, d)
            sp.linear(f"{b}.attn.proj", d, d)
            if srs[s] > 1:
                sp.conv(f"{b}.attn.sr", d, d, srs[s])
                sp.norm(f"{b}.attn.norm", d)
            sp.norm(f"{b}.norm2", d)
            sp.linear(f"{b}.mlp.fc1", hid, d)
            sp.conv(f"{b}.mlp.dwconv.dwconv", hid, hid, 3, groups=hid)
            sp.linear(f"{b}.mlp.fc2", d, hid)
        sp.norm(f"{pre}.norm{s + 1}", d)


def _cab_spec(sp: _Spec, name: str, c: int) -> None:
    for j in range(2):
        sp.conv(f"{name}.{j}.body.0", c, c, 3, bias=False)
        sp.add(f"{name}.{j}.body.1.weight", (1,), "prelu")
        sp.conv(f"{name}.{j}.body.2", c, c, 3, bias=False)
        sp.conv(f"{name}.{j}.CA.conv_du.0", max(1, c // 4), c, 1, bias=False)
        sp.conv(f"{name}.{j}.CA.conv_du.2", c, max(1, c // 4), 1, bias=False)


def _basic_spec(sp: _Spec, name: str, cout: int, cin: int, k: int) -> None:
    sp.conv(f"{name}.conv", cout, cin, k, bias=False)
    sp.bn(f"{name}.bn", cout)


def _decoder_spec(sp: _Spec, pre: str, dims, ch: int) -> None:
    p = f"{pre}." if pre else ""
    _cab_spec(sp, f"{p}decoder_level1", dims[0])
    _basic_spec(sp, f"{p}Translayer2_0", ch, dims[0], 1)
    _basic_spec(sp, f"{p}Translayer2_1", ch, dims[1], 1)
    _basic_spec(sp, f"{p}Translayer3_1", ch, dims[2], 1)
    _basic_spec(sp, f"{p}Translayer4_1", ch, dims[3], 1)
    _cab_spec(sp, f"{p}decoder_level4", ch)
    _cab_spec(sp, f"{p}decoder_level3", 2 * ch)
    _cab_spec(sp, f"{p}decoder_level2", 3 * ch)
    _basic_spec(sp, f"{p}conv4", ch, 3 * ch, 3)
    _basic_spec(sp, f"{p}compress_out", ch, 2 * ch, 8)
    _basic_spec(sp, f"{p}compress_out2", ch, 2 * ch, 1)
    sp.conv(f"{p}out_CFM", 1, ch, 1)
    sq = max(1, ch // 16)
    sp.linear(f"{p}SAM.fc.0", sq, ch, bias=False)
    sp.linear(f"{p}SAM.fc.2", ch, sq, bias=False)
    sp.linear(f"{p}SAM.fc_wight.0", sq, ch, bias=False)
    sp.linear(f"{p}SAM.fc_wight.2", 1, sq, bias=False)
    sp.conv(f"{p}out_SAM", 1, ch, 1)


def spec(arch: dict):
    """[(name, shape, kind, fan_in)] of every tensor of the model's state
    dict, in the weight maker's order."""
    sp = _Spec()
    pvt = arch["pvt"]
    dims, depths = pvt["embed_dims"], pvt["depths"]
    if arch["model"] == "cod":
        pe = arch["prompt"]
        pre = "hitnet.backbone"
        _pvt_spec(sp, pre, pvt)
        lat, k = pe["latent_dim"], pe["kernel"]
        e = f"{pre}.prompt_encoder"
        sp.conv(f"{e}.propagation_weight_regressor.reg", lat * k * k, 3, 1)
        sp.conv(f"{e}.encoder1", lat, 1, 1)
        sp.conv(f"{e}.message_passing.conv", 3, lat, 1)
        cd = pe["convnext_dims"]
        sp.conv(f"{e}.encoder2.downsample_layers.0.0", cd[0], 3, 4)
        sp.norm(f"{e}.encoder2.downsample_layers.0.1", cd[0])
        for i in range(1, len(cd)):
            sp.norm(f"{e}.encoder2.downsample_layers.{i}.0", cd[i - 1])
            sp.conv(f"{e}.encoder2.downsample_layers.{i}.1", cd[i], cd[i - 1], 2)
        for i, d in enumerate(cd):
            for j in range(pe["convnext_depths"][i]):
                b = f"{e}.encoder2.stages.{i}.{j}"
                sp.conv(f"{b}.dwconv", d, d, 7, groups=d)
                sp.norm(f"{b}.norm", d)
                sp.linear(f"{b}.pwconv1", 4 * d, d)
                sp.linear(f"{b}.pwconv2", d, 4 * d)
                sp.add(f"{b}.gamma", (d,), "layer_scale")
        for i, d in enumerate(cd):
            sp.conv(f"{e}.encoder2.convs.{i}", EMBED_DIM, d, 1)
        sp.conv(f"{e}.encoder2.fusion_conv", EMBED_DIM, EMBED_DIM * len(cd), 1)
        for s in range(4):
            for i in range(depths[s]):
                b = f"{pre}.prompt_decoder.{s}.decoder.{i}.decoder"
                sp.conv(f"{b}.0", lat, EMBED_DIM, 3)
                sp.conv(f"{b}.2", lat, lat, 3)
                sp.conv(f"{b}.4", dims[s], lat, 3)
        _decoder_spec(sp, "hitnet", dims, arch["channel"])
    elif arch["model"] == "DQnet":
        for s in range(4):
            hid = dims[s] // arch["prompt_scale_factor"]
            g = f"depth_generator{s}"
            sp.linear(f"{g}.depth_adapter", hid, 1)
            for i in range(depths[s]):
                sp.linear(f"{g}.lightweight_mlp_{i}", hid, hid)
            sp.linear(f"{g}.shared_mlp", dims[s], hid)
        _pvt_spec(sp, "backbone", pvt)
        _decoder_spec(sp, "", dims, arch["channel"])
    else:
        raise ValueError(f"the reference has no model {arch['model']!r}")
    return sp.items


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


class _Run:
    """One forward: the state dict, the mode, the DropPath generator and
    the numerics."""

    def __init__(self, P, train: bool, gen, nx: Numerics):
        self.P, self.train, self.gen, self.nx = P, train, gen, nx

    def conv(self, name, x, stride=1, padding=0, groups=1):
        return self.nx.conv(x, self.P[f"{name}.weight"], self.P.get(f"{name}.bias"), stride, padding, groups)

    def linear(self, name, x):
        return self.nx.linear(x, self.P[f"{name}.weight"], self.P.get(f"{name}.bias"))

    def ln(self, name, x, eps):
        return layer_norm(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"], eps)

    def ln2d(self, name, x, eps):
        return self.ln(name, x.permute(0, 2, 3, 1), eps).permute(0, 3, 1, 2)

    def basic(self, name, x, stride=1, padding=0):
        """conv (no bias) and BatchNorm 1e-5: batch statistics (biased
        variance) in train mode, the running ones in eval mode."""
        y = self.conv(f"{name}.conv", x, stride, padding)
        bn = f"{name}.bn"
        return F.batch_norm(y, self.P[f"{bn}.running_mean"], self.P[f"{bn}.running_var"], self.P[f"{bn}.weight"],
                            self.P[f"{bn}.bias"], training=False, eps=1e-5) if not self.train else \
            F.batch_norm(y, None, None, self.P[f"{bn}.weight"], self.P[f"{bn}.bias"], training=True, eps=1e-5)

    def drop(self, x, rate):
        return drop_path(x, rate, self.gen if self.train else None)


def _pvt(r: _Run, pre: str, pvt: dict, dpr_max: float, x, prompts):
    dims, heads, depths, srs = pvt["embed_dims"], pvt["num_heads"], pvt["depths"], pvt["sr_ratios"]
    dpr = np.linspace(0, dpr_max, sum(depths))
    cur, outs = 0, []
    b = x.shape[0]
    for s in range(4):
        patch, stride = (7, 4) if s == 0 else (3, 2)
        x = r.conv(f"{pre}.patch_embed{s + 1}.proj", x, stride, patch // 2)
        h, w = x.shape[-2:]
        d, nh = dims[s], heads[s]
        t = r.ln(f"{pre}.patch_embed{s + 1}.norm", x.flatten(2).transpose(1, 2), 1e-5)
        for i in range(depths[s]):
            blk = f"{pre}.block{s + 1}.{i}"
            rate = float(dpr[cur + i])
            if prompts is not None:
                t = t + resize(prompts[s][i], (h, w)).flatten(2).transpose(1, 2)
            # attention
            y = r.ln(f"{blk}.norm1", t, 1e-6)
            n = y.shape[1]
            q = r.linear(f"{blk}.attn.q", y).reshape(b, n, nh, d // nh).permute(0, 2, 1, 3)
            kvin = y
            if srs[s] > 1:
                m = y.transpose(1, 2).reshape(b, d, h, w)
                m = r.conv(f"{blk}.attn.sr", m, srs[s])
                kvin = r.ln(f"{blk}.attn.norm", m.flatten(2).transpose(1, 2), 1e-5)
            kv = r.linear(f"{blk}.attn.kv", kvin).reshape(b, -1, 2, nh, d // nh).permute(2, 0, 3, 1, 4)
            att = r.nx.matmul(q, kv[0].transpose(-2, -1)) * (d // nh) ** -0.5
            o = r.nx.matmul(att.softmax(-1), kv[1]).transpose(1, 2).reshape(b, n, d)
            t = t + r.drop(r.linear(f"{blk}.attn.proj", o), rate)
            # MixFFN
            y = r.ln(f"{blk}.norm2", t, 1e-6)
            y = r.linear(f"{blk}.mlp.fc1", y)
            hid = y.shape[-1]
            y = r.conv(f"{blk}.mlp.dwconv.dwconv", y.transpose(1, 2).reshape(b, hid, h, w), 1, 1, hid)
            y = r.linear(f"{blk}.mlp.fc2", F.gelu(y.flatten(2).transpose(1, 2)))
            t = t + r.drop(y, rate)
        cur += depths[s]
        t = r.ln(f"{pre}.norm{s + 1}", t, 1e-6)
        x = t.transpose(1, 2).reshape(b, d, h, w)
        outs.append(x)
    return outs


def _convnext(r: _Run, pre: str, pe: dict, x):
    dims, depths = pe["convnext_dims"], pe["convnext_depths"]
    dpr = np.linspace(0, pe["convnext_drop_path_rate"], sum(depths))
    cur, outs = 0, []
    for i, d in enumerate(dims):
        if i == 0:
            x = r.ln2d(f"{pre}.downsample_layers.0.1", r.conv(f"{pre}.downsample_layers.0.0", x, 4), 1e-6)
        else:
            x = r.conv(f"{pre}.downsample_layers.{i}.1", r.ln2d(f"{pre}.downsample_layers.{i}.0", x, 1e-6), 2)
        for j in range(depths[i]):
            b = f"{pre}.stages.{i}.{j}"
            y = r.conv(f"{b}.dwconv", x, 1, 3, d).permute(0, 2, 3, 1)
            y = r.linear(f"{b}.pwconv2", F.gelu(r.linear(f"{b}.pwconv1", r.ln(f"{b}.norm", y, 1e-6))))
            y = r.drop(y * r.P[f"{b}.gamma"], float(dpr[cur + j]))
            x = x + y.permute(0, 3, 1, 2)
        cur += depths[i]
        outs.append(x)
    size = outs[0].shape[-2:]
    lateral = [resize(r.conv(f"{pre}.convs.{i}", o), size) for i, o in enumerate(outs)]
    return r.conv(f"{pre}.fusion_conv", torch.cat(lateral, 1))


def _prompt_encoder(r: _Run, pre: str, pe: dict, image, depth):
    g, k = pe["grid"], pe["kernel"]
    texture = fft_high_pass(image, pe["freq_rate"])
    weights = torch.sigmoid(r.conv(f"{pre}.propagation_weight_regressor.reg", resize_nearest(texture, (g, g))))
    cues = r.conv(f"{pre}.encoder1", resize(depth, (g, g)))
    b, c = cues.shape[:2]
    wt = weights.reshape(b * c, k * k, g, g)
    wt = wt / (wt.sum(1, keepdim=True) + 1e-5)
    diffused = stencil(cues.reshape(b * c, g, g), wt, k, pe["steps"]).reshape(b, c, g, g)
    diffused = resize(r.conv(f"{pre}.message_passing.conv", diffused), image.shape[-2:])
    return texture, _convnext(r, f"{pre}.encoder2", pe, diffused + image)


def _cab(r: _Run, name: str, x):
    for j in range(2):
        c = f"{name}.{j}"
        y = r.conv(f"{c}.body.0", x, 1, 1)
        y = torch.where(y >= 0, y, r.P[f"{c}.body.1.weight"] * y)
        y = r.conv(f"{c}.body.2", y, 1, 1)
        a = torch.sigmoid(r.conv(f"{c}.CA.conv_du.2", F.relu(r.conv(f"{c}.CA.conv_du.0", y.mean((2, 3), True)))))
        x = y * a + x
    return x


def _sam_branch(r: _Run, name: str, x):
    y = x.mean((2, 3))
    g = torch.sigmoid(r.linear(f"{name}.fc.2", F.relu(r.linear(f"{name}.fc.0", y))))
    w = torch.sigmoid(r.linear(f"{name}.fc_wight.2", F.relu(r.linear(f"{name}.fc_wight.0", y))))
    return x * g[:, :, None, None] * w[:, :, None, None]


def _decode(r: _Run, pre: str, refine_iters: int, image, x1, x2, x3, x4):
    p = f"{pre}." if pre else ""
    cim = _cab(r, f"{p}decoder_level1", x1)
    x2_t, x3_t, x4_t = r.basic(f"{p}Translayer2_1", x2), r.basic(f"{p}Translayer3_1", x3), r.basic(
        f"{p}Translayer4_1", x4)
    s8, s16, full = x2.shape[-2:], x3.shape[-2:], image.shape[-2:]
    stage_preds: List[torch.Tensor] = []
    cfm = None
    for it in range(refine_iters):
        if cfm is not None:
            x4_t = r.basic(f"{p}compress_out", torch.cat([resize(x4_t, s8, True), cfm], 1), 4, 2)
        x4_f = _cab(r, f"{p}decoder_level4", x4_t)
        x3_f = _cab(r, f"{p}decoder_level3", torch.cat([x3_t, resize(x4_f, s16, True)], 1))
        if it > 0:
            x2_t = r.basic(f"{p}compress_out2", torch.cat([x2_t, cfm], 1))
        x2_f = _cab(r, f"{p}decoder_level2", torch.cat([x2_t, resize(x3_f, s8, True)], 1))
        cfm = r.basic(f"{p}conv4", x2_f, 1, 1)
        stage_preds.append(resize(r.conv(f"{p}out_CFM", cfm), full))
    t2 = resize(r.basic(f"{p}Translayer2_0", cim), s8, True)
    fused = _sam_branch(r, f"{p}SAM", cfm) + _sam_branch(r, f"{p}SAM", t2)
    return stage_preds, resize(r.conv(f"{p}out_SAM", fused), full)


def forward(arch: dict, P, image, depth, train: bool = False, gen: Optional[torch.Generator] = None,
            nx: Optional[Numerics] = None):
    """NCHW image (normalized) and depth (in [0, 1]) -> (texture or None,
    [stage logits], second logits)."""
    r = _Run(P, train, gen, nx or Numerics())
    pvt = arch["pvt"]
    if arch["model"] == "cod":
        pe, pre = arch["prompt"], "hitnet.backbone"
        texture, emb = _prompt_encoder(r, f"{pre}.prompt_encoder", pe, image, depth)
        prompts = []
        for s in range(4):
            stage = []
            for i in range(pvt["depths"][s]):
                b = f"{pre}.prompt_decoder.{s}.decoder.{i}.decoder"
                y = F.relu(r.conv(f"{b}.0", emb, 1, 1))
                y = F.relu(r.conv(f"{b}.2", y, 1, 1))
                stage.append(r.conv(f"{b}.4", y, 1, 1))
            prompts.append(stage)
        outs = _pvt(r, pre, pvt, arch["drop_path_rate"], image, prompts)
        stage_preds, pred2 = _decode(r, "hitnet", arch["refine_iters"], image, *outs)
        return texture, stage_preds, pred2
    g = arch["cross_size"]
    cues = resize(depth, (g, g)).permute(0, 2, 3, 1)
    prompts = []
    for s in range(4):
        gen_ = f"depth_generator{s}"
        adapted = r.linear(f"{gen_}.depth_adapter", cues)
        prompts.append([r.linear(f"{gen_}.shared_mlp", F.gelu(r.linear(f"{gen_}.lightweight_mlp_{i}", adapted)))
                        .permute(0, 3, 1, 2) for i in range(pvt["depths"][s])])
    outs = _pvt(r, "backbone", pvt, arch["drop_path_rate"], image, prompts)
    stage_preds, pred2 = _decode(r, "", arch["refine_iters"], image, *outs)
    return None, stage_preds, pred2


def probability(arch: dict, P, image, depth, nx: Optional[Numerics] = None) -> torch.Tensor:
    """The served map: sigmoid(last stage logits + second logits), NCHW."""
    _, stage_preds, pred2 = forward(arch, P, image, depth, nx=nx)
    return torch.sigmoid(stage_preds[-1] + pred2)


def fan_in_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))
