"""Weights carried across from the JAX package.

``state_dict_from_flax(flat)`` takes a JAX model's variables (``cod``,
``baseline`` or ``DQnet``) as a flat ``{'params/...', 'batch_stats/...'}``
mapping of numpy arrays (the layout ``predict.py`` and ``export_state_dict``
accept; a bare key means ``params/``) and returns the port's
``state_dict``: the reference's ``hitnet.*`` schema for ``cod`` and
``baseline``, the JAX tree's names for ``DQnet`` (``_dqnet_rules``). Its
kinds ``dinov2`` and ``dpt_head`` carry the offline depther's two parts to
the official DINOv2 and mmseg head keys; ``depther_part_state`` reads a
part from a ``.npz`` or a released ``.pth``, ``load_depther_part`` loads it
strictly.

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


def _pvt(bb: str, fb: str) -> List[Rule]:
    """A PVTv2 at port prefix ``bb`` and JAX path ``fb`` (official PVTv2 keys)."""
    r = _conv(f"{bb}.patch_embed{{s}}.proj", f"{fb}/patch_embed{{s}}/Conv_0/Conv_0")
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
    return r


def _decoder(ref: str, fx: str) -> List[Rule]:
    """HitNet's decoder with its modules under port prefix ``ref`` and JAX
    path ``fx`` ("" for the top level)."""
    ref, fx = (f"{ref}." if ref else ""), (f"{fx}/" if fx else "")
    r: List[Rule] = []
    for mine, jax_name in (("Translayer2_0", "translayer2_0"), ("Translayer2_1", "translayer2_1"),
                           ("Translayer3_1", "translayer3_1"), ("Translayer4_1", "translayer4_1"),
                           ("conv4", "conv4"), ("compress_out", "compress_out"),
                           ("compress_out2", "compress_out2")):
        r += _basic_conv(f"{ref}{mine}", f"{fx}{jax_name}")
    cab, fcab = f"{ref}decoder_level{{l}}.{{i}}", f"{fx}decoder_level{{l}}/cab{{i}}"
    r += _conv(f"{cab}.body.0", f"{fcab}/Conv_0/Conv_0", bias=False)
    r += [(f"{cab}.body.1.weight", f"{fcab}/PReLU_0/alpha", "params", _ident)]
    r += _conv(f"{cab}.body.2", f"{fcab}/Conv_1/Conv_0", bias=False)
    r += _conv(f"{cab}.CA.conv_du.0", f"{fcab}/CALayer_0/Conv_0/Conv_0", bias=False)
    r += _conv(f"{cab}.CA.conv_du.2", f"{fcab}/CALayer_0/Conv_1/Conv_0", bias=False)
    for i, name in enumerate(("fc.0", "fc.2", "fc_wight.0", "fc_wight.2")):
        r += _lin(f"{ref}SAM.{name}", f"{fx}sam/Dense_{i}/Dense_0", bias=False)
    r += _conv(f"{ref}out_SAM", f"{fx}out_SAM/Conv_0")
    r += _conv(f"{ref}out_CFM", f"{fx}out_CFM/Conv_0")
    return r


def _cod_rules() -> List[Rule]:
    """``cod`` and ``baseline`` (one tree; only baseline's k = 3 weight
    regressor differs in shape)."""
    bb = "hitnet.backbone"
    r = _pvt(bb, "hitnet/backbone")
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
    return r + _decoder("hitnet", "hitnet")


def _dqnet_rules() -> List[Rule]:
    """``DQnet``: the JAX tree's top-level ``backbone`` and
    ``depth_generator{s}``, the decoder under HitNet's names. There is no
    table of the reference's DQnet keys: its DQnet crashes when run (the
    stale ``prompt`` of its ``Depth_prompt``), so no checkpoint of it is
    known, and the JAX package's converter has no DQnet rules either."""
    dg, fdg = "depth_generator{s}", "depth_generator{s}"
    r = _pvt("backbone", "backbone")
    r += _lin(f"{dg}.depth_adapter", f"{fdg}/depth_adapter/Dense_0")
    r += _lin(f"{dg}.lightweight_mlp_{{i}}", f"{fdg}/lightweight_mlp_{{i}}/Dense_0")
    r += _lin(f"{dg}.shared_mlp", f"{fdg}/shared_mlp/Dense_0")
    return r + _decoder("", "")


def _pattern(template: str) -> re.Pattern:
    parts = re.split(r"\{(\w+)\}", template)
    out = []
    for n, part in enumerate(parts):
        out.append(f"(?P<{part}>\\d+)" if n % 2 else re.escape(part))
    return re.compile("".join(out) + "$")


def _convT_to_torch(a):
    """The JAX non-overlapping transposed conv's (k, k, I, O) -> torch
    ``ConvTranspose2d``'s (I, O, k, k)."""
    return np.transpose(a, (2, 3, 0, 1))


def _dinov2_rules() -> List[Rule]:
    """The DINOv2 backbone: official keys, the JAX ``DinoViT`` paths."""
    r: List[Rule] = [("cls_token", "cls_token", "params", _ident), ("pos_embed", "pos_embed", "params", _ident)]
    r += _conv("patch_embed.proj", "patch_embed/Conv_0")
    r += _ln("norm", "norm/LayerNorm_0")
    blk, fblk = "blocks.{i}", "blocks_{i}"
    r += _ln(f"{blk}.norm1", f"{fblk}/norm1/LayerNorm_0")
    r += _ln(f"{blk}.norm2", f"{fblk}/norm2/LayerNorm_0")
    r += _lin(f"{blk}.attn.qkv", f"{fblk}/attn/qkv/Dense_0")
    r += _lin(f"{blk}.attn.proj", f"{fblk}/attn/proj/Dense_0")
    r += [(f"{blk}.ls1.gamma", f"{fblk}/ls1/gamma", "params", _ident),
          (f"{blk}.ls2.gamma", f"{fblk}/ls2/gamma", "params", _ident)]
    for name in ("fc1", "fc2", "w12", "w3"):  # mlp, or ViT-g/14's fused SwiGLU
        r += _lin(f"{blk}.mlp.{name}", f"{fblk}/mlp_{name}/Dense_0")
    return r


def _dpt_head_rules() -> List[Rule]:
    """The DPT head: mmseg keys, the JAX ``DPTHead`` paths."""
    rb = "reassemble_blocks"
    r = _lin(f"{rb}.readout_projects.{{i}}.0", f"{rb}/readout_projects_{{i}}/Dense_0")
    r += _conv(f"{rb}.projects.{{i}}.conv", f"{rb}/projects_{{i}}/Conv_0")
    for i in (0, 1):  # ConvTranspose2d x4 and x2
        r += [(f"{rb}.resize_layers.{i}.weight", f"{rb}/resize_layers_{i}/kernel", "params", _convT_to_torch),
              (f"{rb}.resize_layers.{i}.bias", f"{rb}/resize_layers_{i}/bias", "params", _ident)]
    r += _conv(f"{rb}.resize_layers.3", f"{rb}/resize_layers_3/Conv_0")
    r += _conv("convs.{i}.conv", "convs_{i}/Conv_0", bias=False)
    r += _conv("fusion_blocks.{i}.res_conv_unit{u}.conv{c}.conv", "fusion_blocks_{i}/res_conv_unit{u}/conv{c}/Conv_0")
    r += _conv("fusion_blocks.{i}.project.conv", "fusion_blocks_{i}/project/Conv_0")
    r += _conv("project.conv", "project/Conv_0")
    return r + _conv("conv_depth", "conv_depth/Conv_0")


#: the kinds of JAX checkpoint: their key tables and the prefix of their
#: paths in a depther's tree. "full": one table for every model (the JAX
#: paths of ``cod``, under ``hitnet/``, and of ``DQnet``, top level, never
#: collide)
_KINDS = {"full": (_cod_rules() + _dqnet_rules(), ""), "dinov2": (_dinov2_rules(), "backbone/"),
          "dpt_head": (_dpt_head_rules(), "decode_head/")}
_FLAX_SIDE = {kind: [(_pattern(fx), ref, coll, tf) for ref, fx, coll, tf in rules]
              for kind, (rules, _) in _KINDS.items()}


def map_flax_key(path: str, collection: str = "params", kind: str = "full") -> Optional[Tuple[str, Callable]]:
    """JAX variable path (under its collection) -> (port key, transform)."""
    for pat, ref, coll, tf in _FLAX_SIDE[kind]:
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


#: keys a checkpoint may lack or carry beyond the model's: the reference's
#: modules that its forward never calls, and BatchNorm's step counters
DEAD_PREFIXES = ("hitnet.ca.", "hitnet.sa.", "hitnet.backbone.prompt_encoder.adaptor.")
DEAD_SUFFIXES = ("num_batches_tracked",)


def is_dead_key(key: str) -> bool:
    return key.startswith(DEAD_PREFIXES) or key.endswith(DEAD_SUFFIXES)


def state_dict_from_flax(flat: Dict[str, np.ndarray], kind: str = "full") -> Dict[str, torch.Tensor]:
    """The port's state_dict from a flat JAX variables mapping. Raises on a
    JAX leaf the key table does not map.

    ``kind`` "full" is a segmentation model's. "dinov2" and "dpt_head" are
    the depther's parts, as ``dgtd_tpu/tools/convert_ckpt.py`` writes them
    (bare paths) or as a depther's tree holds them (under ``backbone/`` and
    ``decode_head/``; the other part's leaves are left out): the official
    DINOv2 keys and the mmseg head keys, without a prefix."""
    prefix = _KINDS[kind][1]
    other = {"backbone/": "decode_head/", "decode_head/": "backbone/"}.get(prefix)
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for key, val in flat.items():
        coll, path = _split(key)
        if prefix and path.startswith(prefix):
            path = path[len(prefix):]
        elif other and path.startswith(other):
            continue
        hit = map_flax_key(path, coll, kind)
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


# ---------------------------------------------------------------------------
# the offline depther's checkpoints
# ---------------------------------------------------------------------------

#: each depther part's key prefix in a whole depther's state dict
DEPTHER_PREFIXES = {"dinov2": "backbone.", "dpt_head": "decode_head."}


def depther_part_state(path: str, kind: str) -> Dict[str, torch.Tensor]:
    """The port's state dict of one depther part (``kind`` "dinov2" or
    "dpt_head") from a file: a JAX flat ``.npz`` (``convert_ckpt``'s bare
    paths, or a depther's tree), or a ``.pth``: the official release (the
    head's keys with or without ``decode_head.``, in ``model`` or
    ``state_dict`` wrappers), a whole depther's state dict (the other part's
    keys left out) or this package's ``tools/convert_ckpt`` output."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return state_dict_from_flax({k: z[k] for k in z.files}, kind)
    state = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("model", "state_dict"):
        if isinstance(state, dict) and wrap in state:
            state = state[wrap]
    prefix = DEPTHER_PREFIXES[kind]
    other = DEPTHER_PREFIXES["dpt_head" if kind == "dinov2" else "dinov2"]
    out: Dict[str, torch.Tensor] = {}
    for key, val in state.items():
        if key.startswith(prefix):
            key = key[len(prefix):]
        elif key.startswith(other):
            continue
        out[key] = val
    return out


def load_depther_part(module: torch.nn.Module, state: Dict[str, torch.Tensor], kind: str) -> List[str]:
    """Load ``state`` into a depther part strictly: a parameter the state
    lacks, a key the module lacks or a shape that differs raises. Only the
    backbone's inference-unused keys (``mask_token``, ``register_tokens``)
    may go unused; returns those it skipped."""
    from .models.dinov2 import UNUSED_KEYS

    skipped = sorted(k for k in state if kind == "dinov2" and k in UNUSED_KEYS)
    result = module.load_state_dict({k: v for k, v in state.items() if k not in skipped}, strict=False)
    if result.missing_keys or result.unexpected_keys:
        raise ValueError(
            f"{kind} checkpoint and model do not pair: {len(result.missing_keys)} parameters missing (first: "
            f"{result.missing_keys[:5]}), {len(result.unexpected_keys)} keys unused (first: "
            f"{result.unexpected_keys[:5]}); wrong --arch or file for this part?")
    return skipped
