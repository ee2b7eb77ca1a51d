"""``-o key=value`` override parsing (counterpart of ``dgtd_tpu/core/config.py``)."""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterable


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
