"""bf16-vs-f32 training numerics A/B (the port of ``tools/bf16_ab.py``).

Same seed, same synthetic batches, the dynamic-weight-decay recipe
(csnet-L-x2 seed arch, B=24, lr 1e-4, penalty weight 3.0) trained for
--steps steps in f32 and in bf16 compute (bf16 activations; f32
parameters, BN statistics, loss and optimizer). Reports, as markdown:

- loss and penalty trajectories (every --log-every steps);
- BN-gamma agreement: max |gamma_f32 - gamma_bf16| and the Spearman rank
  correlation of |gamma|;
- pruning-decision agreement at quantile thresholds of the trained f32
  gammas (q20/q30/q50): equal layer_config yes/no and per-channel mask
  agreement.

Usage:
  python -m sod100k_tpu_torch.tools.bf16_ab [--steps 60] [--batch 24]
      [--hw 224] [--basewidth 40] [--log-every 10] [--out FILE]
      [--device cpu]

The markdown goes to stdout, or to --out; the progress lines to stderr.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .prune_trajectory import gammas_of


def rank_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (ranks by argsort; ties broken by
    position)."""
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


def _progress(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_ab(*, steps: int = 60, batch: int = 24, hw: int = 224,
           log_every: int = 10, basewidth: int = 40,
           device: str | torch.device = "cuda", log=_progress) -> dict:
    """Train both arms; returns {"lines": the markdown report's lines,
    "curves": {"f32", "bf16"}: [(step, loss, penalty)], "gammas":
    {"f32", "bf16"}: gamma arrays}."""
    from ..arch.csnet import CSNet
    from ..arch.layer_config import init_layers
    from ..data.pipeline import require_device
    from ..prune.finetune import prune
    from ..train.optim import make_adam_dwd
    from ..train.step import make_train_step

    device = require_device(device)
    lc = init_layers(basewidth, [0.5, 0.5])
    rng = np.random.default_rng(0)
    batches = [
        {"image": torch.from_numpy(rng.standard_normal(
            (batch, hw, hw, 3), dtype=np.float32)).to(device),
         "target": torch.from_numpy((rng.random(
             (batch, hw, hw, 1)) > 0.5).astype(np.float32)).to(device)}
        for _ in range(min(steps, 8))]  # cycle a fixed pool

    def train(compute_dtype, tag):
        model = CSNet(lc, seed=7, device=device)
        step = make_train_step(model, make_adam_dwd(model, weight_decay=5e-3),
                               flops_weight=3.0, flops_expand=2.0,
                               batch_size=batch, compute_dtype=compute_dtype)
        curve = []
        for i in range(steps):
            m = step(batches[i % len(batches)], 1e-4, 1.0)
            if (i + 1) % log_every == 0 or i == steps - 1:
                curve.append((i + 1, float(m["loss"]), float(m["penalty"])))
                log(f"# {tag} step {i + 1}: loss {curve[-1][1]:.5f} "
                    f"penalty {curve[-1][2]:.2f}")
        return model, curve

    m32, c32 = train(None, "f32")
    m16, c16 = train(torch.bfloat16, "bf16")
    g32, g16 = gammas_of(m32), gammas_of(m16)
    sd32 = {k: v.cpu() for k, v in m32.state_dict().items()}
    sd16 = {k: v.cpu() for k, v in m16.state_dict().items()}

    lines = ["# bf16-vs-f32 training numerics A/B\n",
             f"csnet-L-x2 seed arch (basewidth {basewidth}), B={batch} "
             f"@{hw}px, {steps} steps, lr 1e-4, dynamic-wd penalty weight "
             "3.0, identical seed/batches. Mixed precision = bf16 "
             "activations, f32 params/BN/loss/optimizer. Regenerate: "
             "`python -m sod100k_tpu_torch.tools.bf16_ab`.\n",
             "\n## Loss / penalty trajectories\n",
             "| step | loss f32 | loss bf16 | penalty f32 | penalty bf16 |",
             "|---|---|---|---|---|"]
    for (s, l32, q32), (_, l16, q16) in zip(c32, c16):
        lines.append(f"| {s} | {l32:.5f} | {l16:.5f} | {q32:.2f} | "
                     f"{q16:.2f} |")
    lines += ["\n## BN-gamma (pruning signal) agreement\n",
              f"- max |gamma_f32 - gamma_bf16| = "
              f"{np.abs(g32 - g16).max():.3e} (gamma range "
              f"[{g32.min():.4f}, {g32.max():.4f}])",
              f"- rank correlation (Spearman) = "
              f"{rank_corr(np.abs(g32), np.abs(g16)):.6f}",
              "\n## Pruning-decision agreement (quantile thresholds)\n",
              "| threshold | kept f32 | kept bf16 | mask agreement | "
              "layer_config equal |",
              "|---|---|---|---|---|"]
    for q in (0.2, 0.3, 0.5):
        th = float(np.quantile(np.abs(g32), q))
        _, lc_a, masks_a = prune(sd32, lc, th)
        _, lc_b, masks_b = prune(sd16, lc, th)
        tot = agree = kept_a = kept_b = 0
        for ma, mb in zip(masks_a, masks_b):
            for ba, bb in zip(ma, mb):
                tot += ba.size
                agree += int((ba == bb).sum())
                kept_a += int(ba.sum())
                kept_b += int(bb.sum())
        lines.append(f"| q{int(q * 100)} = {th:.4g} | {kept_a}/{tot} | "
                     f"{kept_b}/{tot} | {100.0 * agree / tot:.2f}% | "
                     f"{'yes' if lc_a.entries == lc_b.entries else 'NO'} |")
    return {"lines": lines, "curves": {"f32": c32, "bf16": c16},
            "gammas": {"f32": g32, "bf16": g16}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--basewidth", type=int, default=40)
    ap.add_argument("--out", default="",
                    help="write the markdown here instead of stdout")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run_ab(steps=args.steps, batch=args.batch, hw=args.hw,
                 log_every=args.log_every, basewidth=args.basewidth,
                 device=args.device)
    text = "\n".join(res["lines"]) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        _progress(f"wrote {args.out}")
    else:
        sys.stdout.write(text)


if __name__ == "__main__":
    main()
