"""The prune trajectory's spread over seeds: ``tools.prune_trajectory`` run
once per seed, every seed in a process of its own and all at once, each
run held to the JAX package's slow-test invariants
(``prune_trajectory.INVARIANTS``).

Usage:
  python -m sod100k_tpu_torch.tools.prune_seed_spread --seeds 0 1 2 3 4
      --out spread.json [--label 13a] [--device cuda]
      -- <prune_trajectory arguments, without --seed and --json>

Every run has TF32 off in cuDNN and in matmuls, as ``chip_smoke.py``'s
13a has. Writes, for each seed, the tool's JSON result, the layers that
``keep_one_alive`` kept, the finetune's last train loss (~0.2 where the
pruned net is severed), the run's wall seconds, and which invariants it
failed; with the card's name and power limit (``timing.card``). Prints
one markdown row per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from .prune_trajectory import failed_invariants
from .timing import card

_KEPT = re.compile(r"kept 1 channel alive in (\d+) fully-dead")
_FT_LOSS = re.compile(r"finetune final train loss ([0-9.]+)")


def _worker(argv: list[str]) -> str:
    """The ``python -c`` program of one seed's process."""
    return ("import torch\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "from sod100k_tpu_torch.tools import prune_trajectory\n"
            f"prune_trajectory.main({argv!r})\n")


def run_spread(seeds, tool_args, *, device: str = "cuda",
               tmp: str) -> list[dict]:
    """One process per seed, all started together; returns one row per
    seed (the result, kept-alive layers, seconds, failed invariants)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": repo}
    procs = []
    for s in seeds:
        out = os.path.join(tmp, f"seed{s}.json")
        argv = [*tool_args, "--seed", str(s), "--json", out,
                "--device", device]
        log = open(os.path.join(tmp, f"seed{s}.log"), "w+")
        procs.append((s, out, log, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-c", _worker(argv)], cwd=repo, env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True)))
    rows = []
    for s, out, log, t0, proc in procs:
        rc = proc.wait()
        secs = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        if rc != 0:
            rows.append({"seed": s, "rc": rc, "log_tail": text[-2000:]})
            continue
        with open(out) as f:
            res = json.load(f)
        kept = _KEPT.search(text)
        ft_loss = _FT_LOSS.search(text)
        rows.append({"seed": s, "rc": 0, "result": res,
                     "kept_alive": int(kept.group(1)) if kept else 0,
                     "ft_train_loss": float(ft_loss.group(1)) if ft_loss
                     else None,
                     "secs": secs, "failed": failed_invariants(res)})
    return rows


def markdown_rows(label: str, rows: list[dict], where: str) -> list[str]:
    lines = []
    for r in rows:
        if r["rc"]:
            lines.append(f"| {label} | {r['seed']} | exit {r['rc']} |")
            continue
        x = r["result"]
        lines.append(
            f"| {label} | {r['seed']} | {x['gamma_sparsity_pct']} | "
            f"{x['param_drop_pct']} | {r['kept_alive']} | "
            f"{x['mae_pre_prune']} | {x['mae_post_prune']} | "
            f"{x['mae_post_finetune']} | {r['ft_train_loss']} | "
            f"{', '.join(r['failed']) or 'pass'} | {r['secs']:.1f} | "
            f"{where} |")
    return lines


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    tool_args = []
    if "--" in argv:
        cut = argv.index("--")
        argv, tool_args = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    where = card(args.device)
    where = f"{where['device']}, {where['power_limit']}"
    with tempfile.TemporaryDirectory() as tmp:
        rows = run_spread(args.seeds, tool_args, device=args.device,
                          tmp=tmp)
    with open(args.out, "w") as f:
        json.dump({"label": args.label, "tool_args": tool_args,
                   "card": where, "runs": rows}, f,
                  indent=1)
    print("| config | seed | γ sparsity % | drop % | kept alive | pre-prune "
          "| post-prune | finetuned | finetune train loss | invariants | s "
          "| card |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for line in markdown_rows(args.label or " ".join(tool_args), rows,
                              where):
        print(line)
    if any(r["rc"] for r in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
