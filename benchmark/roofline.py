"""The yardstick's arithmetic: peaks, bounds, a kernel's bytes and operations.

Peaks are NVIDIA's data sheet for the H100 SXM (dense): 989 TFLOP/s in
bf16, 67 TFLOP/s in float32 off the tensor cores (the configurations run
float32 with TF32 off), 3.35 TB/s of HBM. They assume the full 700 W; every
run prints the card's power limit beside its numbers.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_S = 3.35e12


def peak_flops(cfg: dict) -> float:
    """The peak of the precision the configuration states."""
    if cfg["dtype"] == "float32" and cfg.get("tf32"):
        return PEAK_FLOPS["tf32"]
    return PEAK_FLOPS[cfg["dtype"]]


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the operations
    at ``peak`` and the bytes at the HBM rate."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


def buckets_of(n: int, buckets) -> list:
    """The shape buckets a served call of ``n`` images runs: the smallest
    bucket that covers what is left, or the largest, repeatedly (the
    artifact's contract: pad the tail, chunk the overflow)."""
    buckets = sorted(buckets)
    out, i = [], 0
    while i < n:
        rem = n - i
        b = next((b for b in buckets if b >= rem), buckets[-1])
        out.append(b)
        i += min(rem, b)
    return out


def dw_chain_work(tails: list, itemsize: int = 4) -> dict:
    """Bytes and operations of the fused depthwise tail over one image's
    tails ``tails`` ((C, H, W) of each launch): the input read once and the
    output written once, plus each launch's (C, 24) float32 parameters;
    per element two stages of 9 multiply-adds, a scale and shift and a
    PReLU."""
    elements = sum(c * h * w for c, h, w in tails)
    return {"bytes_per_img": 2 * itemsize * elements,
            "param_bytes": sum(24 * 4 * c for c, _, _ in tails),
            "flops_per_img": 2.0 * (9 + 9 + 2 + 1) * elements,
            "launches_per_forward": len(tails)}


def dw_chain_bound_s(work: dict, buckets, peak: float) -> float:
    """The least time of the tail's launches over forwards at the padded
    batches ``buckets``."""
    imgs = sum(buckets)
    return bound_s(work["flops_per_img"] * imgs,
                   work["bytes_per_img"] * imgs
                   + work["param_bytes"] * len(buckets), peak)
