"""Perf-regression guard on one card: fail when a guarded number regresses
(the port of ``tools/bench_check.py``).

    python -m sod100k_tpu_torch.tools.bench_check
        # run tools.bench, compare the headline row
    python -m sod100k_tpu_torch.tools.bench_check --extras
        # also regenerate the guarded tools.bench_extras rows (every entry
        # but the e2e test ones) and compare this run's fresh rows
    python -m sod100k_tpu_torch.tools.bench_check --extras-json FILE
        # compare the guarded rows of an already-fresh bench_extras JSON
    ... [--tolerance 0.15] [--record] [--reference FILE] [--force]

The reference (``--reference``, default ``bench_reference.json`` beside
this module) holds the rows recorded on one card, with the card's name and
power limit; ``--record`` writes the fresh rows into it. A throughput row
fails when fresh < (1 - tolerance) * recorded, a latency row when fresh >
(1 + tolerance) * recorded.

The check runs on the card only. It refuses, with a non-zero exit: without
a card; on a card whose name or power limit differs from the recorded one
(``--force`` compares anyway); without a reference (record one first);
and when it had nothing to compare. The JAX tool skips with exit 0 where
there is no TPU; a guard that passes without measuring guards nothing.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from . import bench, bench_extras, timing

REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_reference.json")

# rows worth guarding (the headline + one per subsystem); the names are
# bench_extras' metric names (``tools/bench_check.py:37-48``)
GUARDED_EXTRAS = [
    "csnet_l_x2_224_train_step_img_per_sec[f32,B=128]",
    "csnet_l_x2_224_train_step_img_per_sec[bf16,B=128]",
    "csnet_l_x2_224_e2e_train_img_per_sec[resident_preprocess,bf16,B=128]",
    "csnet_l_x2_224_infer_latency_ms[bf16,B=1]",
    "csf_res2net50_336_train_microstep_ms[bf16,B=8]",
    "csf_res2net50_336_infer_img_per_sec[bf16,B=32]",
    "csf_res2net101_336_train_microstep_ms[bf16,B=8]",
    "csf_res2net101_336_infer_img_per_sec[bf16,B=32]",
    "csnet_l_x2_224_serving_artifact_img_per_sec[bf16,B=128]",
    "csnet_l_x2_resident_testall_img_per_sec[bf16,B=128,n=512]",
]
# for these, LOWER is better (latencies); everything else is a throughput
LOWER_IS_BETTER = ("_latency_ms", "_microstep_ms", "_ms[")


def lower_is_better(metric: str) -> bool:
    return any(tag in metric for tag in LOWER_IS_BETTER)


def compare(metric: str, fresh: float, ref: float, tol: float) -> tuple[bool, str]:
    if lower_is_better(metric):
        ok = fresh <= ref * (1.0 + tol)
        rel = fresh / ref - 1.0
        word = "slower" if rel > 0 else "faster"
    else:
        ok = fresh >= ref * (1.0 - tol)
        rel = fresh / ref - 1.0
        word = "faster" if rel > 0 else "slower"
    status = "OK  " if ok else "FAIL"
    return ok, (f"{status} {metric}: fresh {fresh:g} vs recorded {ref:g} "
                f"({abs(rel) * 100:.1f}% {word}, tolerance {tol * 100:.0f}%)")


def _card_of(d: dict) -> dict:
    return {"device": d.get("device"), "power_limit": d.get("power_limit")}


def _same_card(info: dict, other: dict, what: str, force: bool) -> None:
    if _card_of(other) == info:
        return
    msg = (f"{what} was measured on {other.get('device')} "
           f"({other.get('power_limit')}), this card is {info['device']} "
           f"({info['power_limit']})")
    if not force:
        raise SystemExit(f"bench_check: {msg}; pass --force to compare "
                         f"anyway")
    print(f"WARN {msg}; compared under --force")


def fresh_rows(args, info: dict) -> dict:
    """The fresh numbers: the headline row, plus the guarded extras
    rows."""
    fresh: dict[str, float] = {}
    b = bench.run(device="cuda")
    fresh[b["metric"]] = float(b["value"])
    print(f"tools.bench: {b['metric']} = {b['value']}")

    rows = None
    if args.extras and not args.extras_json:
        # only this run's regenerated entries, never rows of a file whose
        # skipped sections are older recordings
        eargs = bench_extras.build_parser().parse_args(["--skip-e2e-test"])
        rows = {e["metric"]: float(e["value"])
                for e in bench_extras.run_entries(eargs, torch.device("cuda"))}
    elif args.extras_json:
        with open(args.extras_json) as f:
            extras = json.load(f)
        _same_card(info, extras, args.extras_json, args.force)
        rows = {e["metric"]: float(e["value"]) for e in extras["entries"]}
    if rows is not None:
        for m in GUARDED_EXTRAS:
            if m in rows:
                fresh[m] = rows[m]
            else:
                print(f"WARN {m}: not regenerated — not compared")
    return fresh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tolerance", type=float, default=0.15)
    ap.add_argument("--extras", action="store_true",
                    help="regenerate the guarded bench_extras rows (slow) "
                         "and compare them too")
    ap.add_argument("--extras-json", default="",
                    help="compare rows from an existing fresh bench_extras "
                         "JSON instead of regenerating")
    ap.add_argument("--record", action="store_true",
                    help="write the fresh numbers as the new reference")
    ap.add_argument("--reference", default=REF_PATH,
                    help="the reference rows (default: %(default)s)")
    ap.add_argument("--force", action="store_true",
                    help="compare on a card other than the recorded one")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("bench_check: no CUDA device is visible; the "
                         "recorded numbers are a card's own")
    info = timing.card("cuda")
    ref = None
    if os.path.isfile(args.reference):
        with open(args.reference) as f:
            ref = json.load(f)
    if not args.record:
        if ref is None:
            raise SystemExit(f"bench_check: no reference at "
                             f"{args.reference}; record one with --record")
        _same_card(info, ref, args.reference, args.force)

    fresh = fresh_rows(args, info)

    if args.record:
        rows = dict(ref["rows"]) if ref and _card_of(ref) == info else {}
        rows.update(fresh)
        with open(args.reference, "w") as f:
            json.dump({**info, "rows": rows}, f, indent=1, sort_keys=True)
        print(f"recorded {len(fresh)} rows into {args.reference} "
              f"[{info['device']}, {info['power_limit']}]")
        return

    failures = compared = 0
    for metric, value in fresh.items():
        if metric not in ref["rows"]:
            print(f"WARN {metric}: no recorded reference (run --record)")
            continue
        ok, msg = compare(metric, value, ref["rows"][metric], args.tolerance)
        print(msg)
        compared += 1
        failures += 0 if ok else 1
    if not compared:
        raise SystemExit("bench_check: no fresh row has a recorded "
                         "reference; nothing was compared")
    if failures:
        raise SystemExit(f"bench_check: {failures} row(s) regressed beyond "
                         f"{args.tolerance * 100:.0f}%")
    print(f"bench_check: all {compared} compared rows within tolerance "
          f"[{info['device']}, {info['power_limit']}]")


if __name__ == "__main__":
    main()
