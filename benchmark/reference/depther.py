"""The offline depther as a function of a flat state dict: DINOv2 ViT-*/14
(Oquab et al. 2023, arXiv 2304.07193; ``github.com/facebookresearch/dinov2``,
hub ``dinov2_vitl14``) and the DPT depth head of
``dinov2_vitl14_nyu_dpt_head``, as ``create_depther`` builds them.

``spec(arch)`` lists every tensor of the state dict (name, shape, kind,
fan-in) in a fixed order, from the architecture block of a benchmark
configuration file, under the keys of the port's ``DinoDPTDepther``
(``backbone.*`` in the release's backbone layout, ``decode_head.*`` in the
head's); ``make_state(arch, seed, device)`` makes it from a seed;
``forward(arch, P, image_uint8, nx)`` runs the depther on uint8 RGB
(B, H, W, 3) and returns (B, H, W) float32 depth. ``nx``
(:class:`~.numerics.Numerics`) computes every convolution, linear layer and
matrix product. It imports only ``torch``: nothing of the program under
test, and nothing of JAX.

The equations:

* the image on [0, 1] normalized by ImageNet's mean and std (the release's
  123.675/58.395, ... on [0, 255]), zero-padded to a multiple of 14, the
  smaller half before (``CenterPadding``);
* patch embedding, a 14×14 stride-14 conv; the cls token; the 37×37
  position grid resized bicubically to the patch grid by
  ``scale_factor=(h0 + 0.1) / 37`` per axis (``interpolate_offset``);
* ``depth`` pre-LN blocks (LayerNorm 1e-6): x += ls1 · proj(softmax(q·kᵀ/√d)·v)
  over ``num_heads`` heads of the fused qkv; x += ls2 · fc2(GELU(fc1(·)))
  (exact GELU); the tokens of the blocks in ``out_indices`` read out
  without the final norm;
* reassembly: Linear(2D → D) + GELU of [token; cls], a 1×1 conv to each
  post-process width, then ×4 and ×2 transposed convs (kernel = stride),
  identity, and a 3×3 stride-2 conv;
* a 3×3 conv without bias to ``channels`` each; fusion blocks from the
  coarsest map: the skip (bilinearly resized to the running map where the
  grids differ, align_corners False) through a pre-activation residual
  unit x + conv(relu(conv(relu(x)))) and added (not in the first block),
  a second residual unit, a ×2 bilinear resize (align_corners True), a
  1×1 conv;
* a 3×3 conv, ReLU, a 3×3 conv to ``n_bins`` logits; ``linear``
  normalization p = (relu(l) + 0.1) / Σ(relu(l) + 0.1); the depth
  Σ p · bins over ``n_bins`` uniform bins from ``min_depth`` to
  ``max_depth``; bilinear resize (align_corners False) to the unpadded
  input.

Departures from the release: the final LayerNorm's parameters are in the
state (the port keeps them) but unused, as the depther reads the blocks
without it; attention is written out (the release calls xFormers'
memory-efficient kernel); the expectation is a matrix product with the
bins (the release's einsum). Seeded weights only: ``make_state`` gives
LayerScale 0.1 + N(0, 0.02²) where DINOv2 initializes 1e-5 (which would
make every block a near-identity), ``cls_token`` and ``pos_embed``
N(0, 0.02²).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .numerics import Numerics

PATCH = 14
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
#: elements a tensor's span in the buffer is rounded up to (256 bytes)
ALIGN = 64
#: (std, mean) of each kind of float tensor other than a weight, which is
#: N(0, 1/fan_in)
KINDS = {
    "bias": (0.02, 0.0),
    "norm_weight": (0.1, 1.0),
    "norm_bias": (0.1, 0.0),
    "layer_scale": (0.02, 0.1),
    "token": (0.02, 0.0),
}


# ---------------------------------------------------------------------------
# the state dict's tensors
# ---------------------------------------------------------------------------


def spec(arch: dict):
    """[(name, shape, kind, fan_in)] of every tensor of the depther's state
    dict, in the weight maker's order."""
    items = []

    def weight(name, shape, fan_in, bias=True):
        items.append((f"{name}.weight", tuple(shape), "weight", fan_in))
        if bias:
            items.append((f"{name}.bias", (shape[0],), "bias", 0))

    def norm(name, c):
        items.append((f"{name}.weight", (c,), "norm_weight", 0))
        items.append((f"{name}.bias", (c,), "norm_bias", 0))

    d, hid, g = arch["embed_dim"], arch["mlp_hidden"], arch["pretrain_grid"]
    items.append(("backbone.cls_token", (1, 1, d), "token", 0))
    items.append(("backbone.pos_embed", (1, g * g + 1, d), "token", 0))
    weight("backbone.patch_embed.proj", (d, 3, PATCH, PATCH), 3 * PATCH * PATCH)
    for i in range(arch["depth"]):
        b = f"backbone.blocks.{i}"
        norm(f"{b}.norm1", d)
        weight(f"{b}.attn.qkv", (3 * d, d), d)
        weight(f"{b}.attn.proj", (d, d), d)
        items.append((f"{b}.ls1.gamma", (d,), "layer_scale", 0))
        norm(f"{b}.norm2", d)
        weight(f"{b}.mlp.fc1", (hid, d), d)
        weight(f"{b}.mlp.fc2", (d, hid), hid)
        items.append((f"{b}.ls2.gamma", (d,), "layer_scale", 0))
    norm("backbone.norm", d)
    ppc, ch, h = arch["post_process_channels"], arch["channels"], "decode_head"
    r = f"{h}.reassemble_blocks"
    for i in range(len(ppc)):
        weight(f"{r}.readout_projects.{i}.0", (d, 2 * d), 2 * d)
    for i, c in enumerate(ppc):
        weight(f"{r}.projects.{i}.conv", (c, d, 1, 1), d)
    # the transposed convs keep their width ((in, out, k, k) weights), and
    # with the stride at the kernel sum each input once: the fan-in is the
    # input channels
    weight(f"{r}.resize_layers.0", (ppc[0], ppc[0], 4, 4), ppc[0])
    weight(f"{r}.resize_layers.1", (ppc[1], ppc[1], 2, 2), ppc[1])
    weight(f"{r}.resize_layers.3", (ppc[3], ppc[3], 3, 3), ppc[3] * 9)
    for i, c in enumerate(ppc):
        weight(f"{h}.convs.{i}.conv", (ch, c, 3, 3), c * 9, bias=False)
    for i in range(len(ppc)):
        f = f"{h}.fusion_blocks.{i}"
        weight(f"{f}.project.conv", (ch, ch, 1, 1), ch)
        for unit in ((2,) if i == 0 else (1, 2)):
            for conv in (1, 2):
                weight(f"{f}.res_conv_unit{unit}.conv{conv}.conv", (ch, ch, 3, 3), ch * 9)
    weight(f"{h}.project.conv", (ch, ch, 3, 3), ch * 9)
    weight(f"{h}.conv_depth", (arch["n_bins"], ch, 3, 3), ch * 9)
    return items


def make_state(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The depther's state dict for ``seed``, float32 on ``device``: one
    ``torch.randn`` over every tensor, scaled and shifted element-wise by
    each tensor's kind, cut into views that each start on a 256-byte
    boundary of the one buffer (``benchmark/weights.py``'s recipe)."""
    items = spec(arch)
    sizes = [math.prod(s) for _, s, _, _ in items]
    stds = [f ** -0.5 if k == "weight" else KINDS[k][0] for _, _, k, f in items]
    means = [0.0 if k == "weight" else KINDS[k][1] for _, _, k, _ in items]
    spans = [-(-n // ALIGN) * ALIGN for n in sizes]
    counts = torch.tensor(spans, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(spans), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(means, device=device), counts))
    state, off = {}, 0
    for (name, shape, _, _), n, span in zip(items, sizes, spans):
        state[name] = flat[off:off + n].view(shape)
        off += span
    return state


def n_parameters(arch: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in spec(arch))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _pad_to_patch(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    ph, pw = -h % PATCH, -w % PATCH
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def _positions(pos: torch.Tensor, h0: int, w0: int, offset: float) -> torch.Tensor:
    m = int(math.isqrt(pos.shape[1] - 1))
    if (h0, w0) == (m, m):
        return pos
    grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((h0 + offset) / m, (w0 + offset) / m), mode="bicubic",
                         antialias=False)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, h0 * w0, -1)], dim=1)


def _block(arch: dict, P, b: str, x: torch.Tensor, nx: Numerics) -> torch.Tensor:
    n, t, d = x.shape
    heads = arch["num_heads"]
    eps = arch["layer_norm_eps"]
    y = F.layer_norm(x, (d,), P[f"{b}.norm1.weight"], P[f"{b}.norm1.bias"], eps)
    qkv = nx.linear(y, P[f"{b}.attn.qkv.weight"], P[f"{b}.attn.qkv.bias"])
    q, k, v = qkv.reshape(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    attn = torch.softmax(nx.matmul(q, k.transpose(-2, -1)) / math.sqrt(d // heads), dim=-1)
    y = nx.matmul(attn, v).transpose(1, 2).reshape(n, t, d)
    x = x + P[f"{b}.ls1.gamma"] * nx.linear(y, P[f"{b}.attn.proj.weight"], P[f"{b}.attn.proj.bias"])
    y = F.layer_norm(x, (d,), P[f"{b}.norm2.weight"], P[f"{b}.norm2.bias"], eps)
    y = F.gelu(nx.linear(y, P[f"{b}.mlp.fc1.weight"], P[f"{b}.mlp.fc1.bias"]))
    return x + P[f"{b}.ls2.gamma"] * nx.linear(y, P[f"{b}.mlp.fc2.weight"], P[f"{b}.mlp.fc2.bias"])


def backbone(arch: dict, P, x: torch.Tensor, nx: Numerics):
    """[(patch map (B, D, h0, w0), cls (B, D))] of the blocks in
    ``out_indices``, x the padded normalized NCHW image."""
    n = x.shape[0]
    h0, w0 = x.shape[-2] // PATCH, x.shape[-1] // PATCH
    tok = nx.conv(x, P["backbone.patch_embed.proj.weight"], P["backbone.patch_embed.proj.bias"], stride=PATCH)
    tok = tok.flatten(2).transpose(1, 2)
    cls = P["backbone.cls_token"].expand(n, -1, -1)
    tok = torch.cat([cls, tok], dim=1) + _positions(P["backbone.pos_embed"], h0, w0, arch["pos_offset"])
    outs = []
    for i in range(arch["depth"]):
        tok = _block(arch, P, f"backbone.blocks.{i}", tok, nx)
        if i in arch["out_indices"]:
            outs.append((tok[:, 1:].reshape(n, h0, w0, -1).permute(0, 3, 1, 2), tok[:, 0]))
    return outs


def _conv(P, name: str, x, nx: Numerics, stride=1, padding=0):
    return nx.conv(x, P[f"{name}.weight"], P.get(f"{name}.bias"), stride, padding)


def _unit(P, name: str, x, nx: Numerics):
    y = _conv(P, f"{name}.conv1.conv", F.relu(x), nx, padding=1)
    return x + _conv(P, f"{name}.conv2.conv", F.relu(y), nx, padding=1)


def head(arch: dict, P, feats, nx: Numerics) -> torch.Tensor:
    """The DPT head on the backbone's outputs: (B, H', W') depth."""
    r, h = "decode_head.reassemble_blocks", "decode_head"
    maps = []
    for i, (feat, cls) in enumerate(feats):
        n, d, hh, ww = feat.shape
        tokens = feat.flatten(2).transpose(1, 2)
        x = torch.cat([tokens, cls[:, None].expand_as(tokens)], dim=-1)
        x = F.gelu(nx.linear(x, P[f"{r}.readout_projects.{i}.0.weight"], P[f"{r}.readout_projects.{i}.0.bias"]))
        x = _conv(P, f"{r}.projects.{i}.conv", x.transpose(1, 2).reshape(n, d, hh, ww), nx)
        if i in (0, 1):
            w, b = P[f"{r}.resize_layers.{i}.weight"], P[f"{r}.resize_layers.{i}.bias"]
            x = F.conv_transpose2d(nx.q(x), nx.q(w), b, stride=w.shape[-1])
        elif i == 3:
            x = _conv(P, f"{r}.resize_layers.3", x, nx, stride=2, padding=1)
        maps.append(_conv(P, f"{h}.convs.{i}.conv", x, nx, padding=1))
    out = None
    for i in range(len(maps)):
        f = f"{h}.fusion_blocks.{i}"
        if out is None:
            out = maps[-1]
        else:
            skip = maps[-(i + 1)]
            if skip.shape[-2:] != out.shape[-2:]:
                skip = F.interpolate(skip, size=out.shape[-2:], mode="bilinear", align_corners=False)
            out = out + _unit(P, f"{f}.res_conv_unit1", skip, nx)
        out = _unit(P, f"{f}.res_conv_unit2", out, nx)
        out = F.interpolate(out, size=(2 * out.shape[-2], 2 * out.shape[-1]), mode="bilinear", align_corners=True)
        out = _conv(P, f"{f}.project.conv", out, nx)
    logits = _conv(P, f"{h}.conv_depth", F.relu(_conv(P, f"{h}.project.conv", out, nx, padding=1)), nx, padding=1)
    p = F.relu(logits) + 0.1
    p = p / p.sum(dim=1, keepdim=True)
    bins = torch.linspace(arch["min_depth"], arch["max_depth"], arch["n_bins"], device=p.device)
    return nx.matmul(p.permute(0, 2, 3, 1), bins[:, None])[..., 0]


def forward(arch: dict, P, image_uint8: torch.Tensor, nx: Numerics = Numerics()) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> (B, H, W) float32 depth."""
    x = image_uint8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std
    depth = head(arch, P, backbone(arch, P, _pad_to_patch(x), nx), nx)
    size = tuple(image_uint8.shape[1:3])
    return F.interpolate(depth[:, None], size=size, mode="bilinear", align_corners=False)[:, 0]


def count_flops(arch: dict, h: int, w: int, batch: int = 2) -> Dict[str, int]:
    """FLOPs an image of the forward at ``h``×``w``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on meta tensors over
    ``batch`` images, as ``benchmark/yardstick.py::count_flops`` counts:
    convolutions (transposed ones too), linear layers and matrix products,
    the attention's two and the bins' one included; not the norms,
    softmax, resizes or pointwise ops."""
    from torch.utils.flop_counter import FlopCounterMode

    P = {name: torch.empty(shape, device="meta") for name, shape, _, _ in spec(arch)}
    image = torch.empty(batch, h, w, 3, dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            forward(arch, P, image)
    return {"forward": fc.get_total_flops() // batch}
