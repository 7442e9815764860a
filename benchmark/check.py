"""The comparisons that decide ``correct``.

Serving: every map the window served, held to the reference's sigmoid of
the same image. A served level L = trunc(255 * sigmoid) is right when the
reference's 255 * sigmoid lies in [L, L + 1]; ``gap_levels`` is the widest
distance by which it lies outside, over every pixel of every response
(the load generator keeps the least and greatest map served for each
image, and the distance is convex in L). A response routed to the wrong
request, a padding or chunking fault, or any arithmetic fault reads
levels; f32 rounding reads a small fraction of one.

Training: each of the first ``CHECK_STEPS`` steps' loss; the first
gradient as the optimizer received it (its first moment after one step
over 1 - beta1); the parameters' change after ``CHECK_STEPS`` steps. The
last two per leaf, by the gap between the norms of the program and the
reference, over the larger of the reference's norm of that leaf and of
the median leaf; the worst leaf is the number. Leaves whose reference
gradient is under ``ZERO_GRAD`` of the median leaf's move by round-off
alone and are left out of the change.
"""

from __future__ import annotations

import torch

ZERO_GRAD = 1e-3


def gap_levels(lo: torch.Tensor, hi: torch.Tensor,
               ref_levels: torch.Tensor) -> float:
    """Widest distance of ``ref_levels`` (255 * the reference sigmoid)
    outside [L, L + 1] for L the least and the greatest served level."""
    worst = 0.0
    for lv in (lo.float(), hi.float()):
        d = torch.maximum(lv - ref_levels, ref_levels - (lv + 1.0))
        worst = max(worst, float(d.max().clamp(min=0.0)))
    return worst


def _median(values: list) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def norm_gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = _median(list(rn.values()))
    worst = 0.0
    for k in keys:
        pn = float(prog[k].double().norm())
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` (per step), ``grad`` (first gradient
    per leaf), ``change`` (per leaf after the checked steps)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    gn = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    med = _median(list(gn.values()))
    moved = [k for k in ref["change"] if gn[k] >= ZERO_GRAD * med]
    return {"loss_gap": loss,
            "grad_gap": norm_gap(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": norm_gap(prog["change"], ref["change"], moved)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}})."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
