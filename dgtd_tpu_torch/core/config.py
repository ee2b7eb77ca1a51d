"""YAML recipes with ``_base_`` includes and dotted ``-o key=value``
overrides (counterpart of ``dgtd_tpu/core/config.py``).

Same schema as the reference recipes (``configs/*.yml``: train_cfg,
train_dataloader, model, optim_wrapper, param_scheduler, default_hooks,
custom_hooks, ...), YAML anchors resolved by the YAML loader, and the same
override rules: integer segments address and create list entries, numeric
segments resolve against YAML integer keys.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Iterable, List, Optional

import yaml


def _parse_value(text: str) -> Any:
    """Parse an override value: python literal if possible, else string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none"):
            return None
        return text


def parse_overrides(items: Iterable[str]) -> Dict[str, Any]:
    """``["variant=b0", "convnext_depths=[1,1,2,1]"]`` -> kwargs dict."""
    out: Dict[str, Any] = {}
    for ov in items:
        k, _, raw = ov.partition("=")
        out[k.strip()] = _parse_value(raw.strip())
    return out


def _deep_update(base: dict, new: dict) -> dict:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _as_int(p: str):
    try:
        return int(p)
    except ValueError:
        return None


#: recipe keys whose values are lists: a numeric segment >= 10 under a
#: missing one of these would skip entries, so it raises
_LIST_TYPED_KEYS = frozenset({"custom_hooks", "val_evaluator", "vis_backends"})


def set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    """Set ``a.b.0.c = value``. Integer segments address list entries (an
    index may be existing or one past the end). Under a missing parent a
    numeric next segment < 10 creates a list, a larger one a dict key; under
    the list-typed keys a numeric segment >= 10 with a missing parent
    raises. A digit segment resolves against an existing YAML integer key."""
    parts = dotted_key.split(".")

    def list_index(node, p):
        try:
            i = int(p)
        except ValueError:
            raise ValueError(
                f"override '{dotted_key}': segment {p!r} addresses a LIST "
                f"(length {len(node)}) and must be an integer index"
            ) from None
        if i > len(node):
            raise ValueError(
                f"override '{dotted_key}': list index {i} skips entries "
                f"(list has {len(node)}) — indices must be existing or one-past-the-end"
            )
        return i

    def dict_key(node, p):
        if p not in node and _as_int(p) is not None and _as_int(p) in node:
            return _as_int(p)
        return p

    node = cfg
    for p, nxt in zip(parts[:-1], parts[1:]):
        if nxt.isdigit() and int(nxt) >= 10 and p in _LIST_TYPED_KEYS and isinstance(node, dict):
            if node.get(dict_key(node, p)) is None:
                raise KeyError(
                    f"override segment '{nxt}' in '{dotted_key}': list index "
                    f">= 10 under missing parent '{p}' skips entries and can "
                    "never resolve — add the parent block to the recipe first"
                )
        empty: Any = [] if nxt.isdigit() and int(nxt) < 10 else {}
        if isinstance(node, list):
            i = list_index(node, p)
            if i == len(node):
                node.append(empty)
            if node[i] is None:
                node[i] = empty
            node = node[i]
        else:
            k = dict_key(node, p)
            if node.get(k) is None:
                node[k] = empty
            node = node[k]
    last = parts[-1]
    if isinstance(node, list):
        i = list_index(node, last)
        if i == len(node):
            node.append(value)
        else:
            node[i] = value
    else:
        node[dict_key(node, last)] = value


def get_dotted(cfg: dict, dotted_key: str, default: Any = None) -> Any:
    node: Any = cfg
    for p in dotted_key.split("."):
        if isinstance(node, list):
            try:
                node = node[int(p)]
            except (ValueError, IndexError):
                return default
        elif isinstance(node, dict) and p in node:
            node = node[p]
        elif isinstance(node, dict) and _as_int(p) is not None and _as_int(p) in node:
            node = node[_as_int(p)]
        else:
            return default
    return node


def load_config(path: str, overrides: Optional[List[str]] = None) -> dict:
    """Load a YAML recipe, merging its ``_base_`` includes (paths relative to
    the recipe) under it, then applying ``"dotted.key=value"`` overrides."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for base in bases:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
        _deep_update(merged, load_config(base_path))
    _deep_update(merged, cfg)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        set_dotted(merged, key.strip(), _parse_value(raw.strip()))
    return merged
