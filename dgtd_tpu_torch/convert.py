"""Weights carried across from the JAX package.

``state_dict_from_flax(flat)`` takes the JAX ``cod`` model's variables as a
flat ``{'params/...', 'batch_stats/...'}`` mapping of numpy arrays (the
layout ``predict.py`` and ``export_state_dict`` accept; a bare key means
``params/``) and returns the port's ``state_dict``, whose keys are the
reference's ``hitnet.*`` schema.

The port keeps its own copy of the key tables of
``dgtd_tpu/tools/convert_ckpt.py`` (``map_full_key``), written as
(reference key, JAX path) templates with integer placeholders.
Layout changes: conv HWIO -> OIHW, linear (in, out) -> (out, in), LayerNorm
``scale`` -> ``weight``, BatchNorm ``mean``/``var`` -> ``running_mean``/
``running_var``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _conv_to_torch(a):
    return np.transpose(a, (3, 2, 0, 1))


def _lin_to_torch(a):
    return np.transpose(a, (1, 0))


def _ident(a):
    return a


#: (reference key template, JAX path template, collection, flax -> torch transform)
Rule = Tuple[str, str, str, Callable]


def _conv(ref: str, fx: str, bias: bool = True) -> List[Rule]:
    rules = [(f"{ref}.weight", f"{fx}/kernel", "params", _conv_to_torch)]
    if bias:
        rules.append((f"{ref}.bias", f"{fx}/bias", "params", _ident))
    return rules


def _lin(ref: str, fx: str, bias: bool = True) -> List[Rule]:
    rules = [(f"{ref}.weight", f"{fx}/kernel", "params", _lin_to_torch)]
    if bias:
        rules.append((f"{ref}.bias", f"{fx}/bias", "params", _ident))
    return rules


def _ln(ref: str, fx: str) -> List[Rule]:
    return [(f"{ref}.weight", f"{fx}/scale", "params", _ident),
            (f"{ref}.bias", f"{fx}/bias", "params", _ident)]


def _basic_conv(ref: str, fx: str) -> List[Rule]:
    bn = f"{fx}/BatchNorm_0"
    return _conv(f"{ref}.conv", f"{fx}/Conv_0/Conv_0", bias=False) + [
        (f"{ref}.bn.weight", f"{bn}/scale", "params", _ident),
        (f"{ref}.bn.bias", f"{bn}/bias", "params", _ident),
        (f"{ref}.bn.running_mean", f"{bn}/mean", "batch_stats", _ident),
        (f"{ref}.bn.running_var", f"{bn}/var", "batch_stats", _ident),
    ]


def _rules() -> List[Rule]:
    r: List[Rule] = []
    # PVTv2 backbone (official PVTv2 keys)
    bb, fb = "hitnet.backbone", "hitnet/backbone"
    r += _conv(f"{bb}.patch_embed{{s}}.proj", f"{fb}/patch_embed{{s}}/Conv_0/Conv_0")
    r += _ln(f"{bb}.patch_embed{{s}}.norm", f"{fb}/patch_embed{{s}}/LayerNorm_0/LayerNorm_0")
    r += _ln(f"{bb}.norm{{s}}", f"{fb}/norm{{s}}/LayerNorm_0")
    blk, fblk = f"{bb}.block{{s}}.{{i}}", f"{fb}/block{{s}}_{{i}}"
    r += _ln(f"{blk}.norm1", f"{fblk}/LayerNorm_0/LayerNorm_0")
    r += _ln(f"{blk}.norm2", f"{fblk}/LayerNorm_1/LayerNorm_0")
    r += _lin(f"{blk}.attn.q", f"{fblk}/SRAttention_0/Dense_0/Dense_0")
    r += _lin(f"{blk}.attn.kv", f"{fblk}/SRAttention_0/Dense_1/Dense_0")
    r += _lin(f"{blk}.attn.proj", f"{fblk}/SRAttention_0/Dense_2/Dense_0")
    r += _conv(f"{blk}.attn.sr", f"{fblk}/SRAttention_0/Conv_0/Conv_0")
    r += _ln(f"{blk}.attn.norm", f"{fblk}/SRAttention_0/LayerNorm_0/LayerNorm_0")
    r += _lin(f"{blk}.mlp.fc1", f"{fblk}/MixFFN_0/Dense_0/Dense_0")
    r += _conv(f"{blk}.mlp.dwconv.dwconv", f"{fblk}/MixFFN_0/Conv_0/Conv_0")
    r += _lin(f"{blk}.mlp.fc2", f"{fblk}/MixFFN_0/Dense_1/Dense_0")
    # prompt encoder; its ConvNeXt tower follows the official ConvNeXt keys
    pe, fpe = f"{bb}.prompt_encoder", "hitnet/prompt_encoder"
    cx, fcx = f"{pe}.encoder2", f"{fpe}/encoder2"
    r += _conv(f"{cx}.downsample_layers.0.0", f"{fcx}/stem_conv/Conv_0")
    r += _ln(f"{cx}.downsample_layers.0.1", f"{fcx}/stem_norm/LayerNorm_0")
    r += _ln(f"{cx}.downsample_layers.{{i}}.0", f"{fcx}/down_norm{{i}}/LayerNorm_0")
    r += _conv(f"{cx}.downsample_layers.{{i}}.1", f"{fcx}/down_conv{{i}}/Conv_0")
    st, fst = f"{cx}.stages.{{i}}.{{j}}", f"{fcx}/stage{{i}}_block{{j}}"
    r += _conv(f"{st}.dwconv", f"{fst}/Conv_0/Conv_0")
    r += _ln(f"{st}.norm", f"{fst}/LayerNorm_0/LayerNorm_0")
    r += _lin(f"{st}.pwconv1", f"{fst}/Dense_0/Dense_0")
    r += _lin(f"{st}.pwconv2", f"{fst}/Dense_1/Dense_0")
    r += [(f"{st}.gamma", f"{fst}/gamma", "params", _ident)]
    r += _conv(f"{cx}.convs.{{i}}", f"{fcx}/lateral{{i}}/Conv_0")
    r += _conv(f"{cx}.fusion_conv", f"{fcx}/fusion/Conv_0")
    r += _conv(f"{pe}.propagation_weight_regressor.reg", f"{fpe}/weight_regressor/Conv_0")
    r += _conv(f"{pe}.encoder1", f"{fpe}/encoder1/Conv_0")
    r += _conv(f"{pe}.message_passing.conv", f"{fpe}/message_passing/Conv_0/Conv_0")
    # prompt decoders: Sequential indices 0, 2, 4 are convs 0, 1, 2
    for c in range(3):
        r += _conv(f"{bb}.prompt_decoder.{{s}}.decoder.{{i}}.decoder.{2 * c}",
                   f"hitnet/prompt_decoder{{s}}/decoder{{i}}/Conv_{c}/Conv_0")
    # HitNet decoder
    for ref, mine in (("Translayer2_0", "translayer2_0"), ("Translayer2_1", "translayer2_1"),
                      ("Translayer3_1", "translayer3_1"), ("Translayer4_1", "translayer4_1"),
                      ("conv4", "conv4"), ("compress_out", "compress_out"),
                      ("compress_out2", "compress_out2")):
        r += _basic_conv(f"hitnet.{ref}", f"hitnet/{mine}")
    cab, fcab = "hitnet.decoder_level{l}.{i}", "hitnet/decoder_level{l}/cab{i}"
    r += _conv(f"{cab}.body.0", f"{fcab}/Conv_0/Conv_0", bias=False)
    r += [(f"{cab}.body.1.weight", f"{fcab}/PReLU_0/alpha", "params", _ident)]
    r += _conv(f"{cab}.body.2", f"{fcab}/Conv_1/Conv_0", bias=False)
    r += _conv(f"{cab}.CA.conv_du.0", f"{fcab}/CALayer_0/Conv_0/Conv_0", bias=False)
    r += _conv(f"{cab}.CA.conv_du.2", f"{fcab}/CALayer_0/Conv_1/Conv_0", bias=False)
    for i, ref in enumerate(("fc.0", "fc.2", "fc_wight.0", "fc_wight.2")):
        r += _lin(f"hitnet.SAM.{ref}", f"hitnet/sam/Dense_{i}/Dense_0", bias=False)
    r += _conv("hitnet.out_SAM", "hitnet/out_SAM/Conv_0")
    r += _conv("hitnet.out_CFM", "hitnet/out_CFM/Conv_0")
    return r


def _pattern(template: str) -> re.Pattern:
    parts = re.split(r"\{(\w+)\}", template)
    out = []
    for n, part in enumerate(parts):
        out.append(f"(?P<{part}>\\d+)" if n % 2 else re.escape(part))
    return re.compile("".join(out) + "$")


_RULES = _rules()
_FLAX_SIDE = [(_pattern(fx), ref, coll, tf) for ref, fx, coll, tf in _RULES]


def map_flax_key(path: str, collection: str = "params") -> Optional[Tuple[str, Callable]]:
    """JAX variable path (under its collection) -> (port key, transform)."""
    for pat, ref, coll, tf in _FLAX_SIDE:
        if coll != collection:
            continue
        m = pat.match(path)
        if m:
            return ref.format(**m.groupdict()), tf
    return None


def _split(key: str) -> Tuple[str, str]:
    for coll in ("params", "batch_stats"):
        if key.startswith(coll + "/"):
            return coll, key[len(coll) + 1 :]
    return "params", key


def state_dict_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a flat JAX variables mapping. Raises on a
    JAX leaf the key table does not map."""
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for key, val in flat.items():
        coll, path = _split(key)
        hit = map_flax_key(path, coll)
        if hit is None:
            unmapped.append(key)
            continue
        port_key, tf = hit
        out[port_key] = torch.from_numpy(np.array(tf(np.asarray(val, np.float32)), order="C"))
    if unmapped:
        raise ValueError(f"{len(unmapped)} JAX leaves have no port key (first: {unmapped[:5]})")
    return out


#: the linears of the ``MSDeformAttn`` layer, under one name in both packages
MSDA_LINEARS = ("value_proj", "sampling_offsets", "attention_weights", "output_proj")


def msda_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The port's ``MSDeformAttn`` state_dict from the flax layer's params:
    a nested ``{name: {"kernel", "bias"}}`` mapping (``variables["params"]``)
    or a flat one with ``/`` paths, numpy leaves. Kernels (in, out) become
    weights (out, in); biases are copied. Raises on an unmapped leaf."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix[len("params/"):] if prefix.startswith("params/") else prefix] = np.asarray(node, np.float32)

    walk("", params)
    out: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        name, _, leaf = key.partition("/")
        if name not in MSDA_LINEARS or leaf not in ("kernel", "bias"):
            raise ValueError(f"flax MSDeformAttn leaf {key!r} has no port key")
        tf = _lin_to_torch if leaf == "kernel" else _ident
        out[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = torch.from_numpy(np.array(tf(val), order="C"))
    return out
