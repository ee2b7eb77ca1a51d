"""The numbers that decide ``correct``, each beside its limit.

Training (the first three steps of the object the window trains):

* ``loss_gap``: the largest over the three steps of |L − L_ref| / |L_ref|,
  L the step's total loss.
* ``grad_gap``: the worst leaf's | ‖g‖ − ‖g_ref‖ | over the larger of
  ‖g_ref‖ and the median leaf's ‖g_ref‖, g the first step's gradient as
  the optimizer got it (the program's: AdamW's first moment after one step
  over 1 − β₁).
* ``change_gap``: the same of each leaf's change after three steps, its
  norm taken over the elements whose first reference gradient is at least
  a thousandth of the median leaf's root-mean-square gradient (``drivers/train.py``
  masks them): below that an element moves under Adam by round-off alone,
  as the key half of a PVT block's ``kv.bias`` does under the softmax.
* ``grad_diff``: ‖g − g_ref‖ / ‖g_ref‖ over every parameter of the first
  gradient. The cells compare it in place of ``grad_gap``, whose worst
  leaf is one PReLU slope or a 3-element bias that the fp8 control moves
  no further (PERF.md §2); ``grad_gap`` is printed, not compared.

Serving (the served masks of a sample of the window's batches):

* ``prob_max_gap``: the largest |p − p_ref| over every pixel.
* ``prob_mean_gap``: the mean |p − p_ref|.

A number is within its limit when it is at most the limit; a number that
is not finite is not.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

#: an element whose first reference gradient is under this share of the
#: median leaf's root-mean-square gradient is left out of the change
NEGLIGIBLE_GRAD = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> List[float]:
    """Each leaf's | prog − ref | over the larger of its reference norm and
    the median leaf's; [inf] when the leaves differ."""
    if set(prog) != set(ref) or not ref:
        return [math.inf]
    med = statistics.median(ref.values())
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [3 floats], "grad_norms": {leaf:
    norm}, "change_norms": {leaf: norm}}."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(math.isfinite(x) for x in losses):
        loss_gap = math.inf
    else:
        loss_gap = max(losses)
    grads = _leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    changes = _leaf_gaps(prog["change_norms"], ref["change_norms"])
    return {"loss_gap": loss_gap, "grad_gap": max(grads), "change_gap": max(changes),
            **_differences(prog.get("grads"), ref.get("grads"))}


def _differences(prog, ref) -> Dict[str, float]:
    """``grad_diff`` of the first gradients (leaf tensors by name); none
    where a side has no tensors (the CPU tests' readings)."""
    if prog is None or ref is None:
        return {}
    if set(prog) != set(ref) or not ref:
        return {"grad_diff": math.inf}
    diff = math.sqrt(sum(float((prog[n].float() - ref[n].float()).norm()) ** 2 for n in ref))
    total = math.sqrt(sum(float(ref[n].float().norm()) ** 2 for n in ref))
    out = diff / max(total, 1e-30)
    return {"grad_diff": out if math.isfinite(out) else math.inf}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], k: int = 3) -> List[list]:
    """The ``k`` leaves with the largest gaps: [name, gap, reference norm]."""
    if set(prog) != set(ref) or not ref:
        return []
    med = statistics.median(ref.values())
    gaps = sorted(((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n) for n in ref), reverse=True)
    return [[n, g, ref[n]] for g, n in gaps[:k]]


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """What the train numbers are made of: each step's loss gap and the
    worst leaves of the gradient and of the change."""
    return {"step_loss_gaps": [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])],
            "grad_worst": worst_leaves(prog["grad_norms"], ref["grad_norms"]),
            "change_worst": worst_leaves(prog["change_norms"], ref["change_norms"])}


def serve_diagnostics(prog: List, ref: List) -> dict:
    """Other readings of the served maps' gap: scaled by the reference's
    spread, and in logits."""
    import torch

    p = torch.cat([x.float().flatten() for x in prog])
    r = torch.cat([x.float().flatten() for x in ref])
    zp, zr = torch.logit(p.clamp(1e-6, 1 - 1e-6)), torch.logit(r.clamp(1e-6, 1 - 1e-6))
    return {"prob_mean_gap_rel": float((p - r).abs().mean() / r.std()), "ref_prob_std": float(r.std()),
            "logit_mean_gap_rel": float((zp - zr).abs().mean() / zr.std()),
            "logit_max_gap_rel": float((zp - zr).abs().max() / zr.std())}


def serve_numbers(prog: List, ref: List) -> Dict[str, float]:
    """``prog`` and ``ref``: matching lists of probability maps (float32
    tensors of one shape each)."""
    worst, total, count = 0.0, 0.0, 0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return {"prob_max_gap": math.inf, "prob_mean_gap": math.inf}
        d = (p.float() - r.float()).abs()
        worst = max(worst, float(d.max()))
        total += float(d.sum())
        count += d.numel()
    if len(prog) != len(ref) or count == 0 or not math.isfinite(total):
        return {"prob_max_gap": math.inf, "prob_mean_gap": math.inf}
    return {"prob_max_gap": worst, "prob_mean_gap": total / count}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limit; a limit whose number is
    missing reads infinite."""
    return {n: {"value": numbers.get(n, math.inf), "limit": float(lim["limit"])} for n, lim in limits.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
