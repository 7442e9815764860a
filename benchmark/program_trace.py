"""A cell's traced run, with more than ``benchmark.run`` prints: every
reader's value, the trace's splits by the program's spans
(``trace.ProgramTracer``), the batcher's counters and the serving
window by thirds.

    python -m benchmark.program_trace --workload <cell> --seed <n>
        --seconds <s> [--mode trace|record] [--out FILE]

runs the cell as ``benchmark.run`` does (set-up, window, the reference's
check), with ``trace``: as ``--trace 1``, printing one JSON line with
every reader's value, the splits and (serving) the batcher's counters
over the window, and stderr lines by third of the window; ``record``:
untraced, the recorder on for the whole run (its cost, against
``benchmark.run --trace 0``). ``--out`` writes the window's spans as
JSON. ``setup_s`` counts from this module's import, as
``benchmark.run``'s from its own.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import run  # noqa: E402
from .trace import ProgramTracer, _recorder, reduce_program  # noqa: E402

METRICS = {"serve": ("serve.queue_ms", "serve.pad_share",
                     "serve.launch_idle_pct", "resize_roofline"),
           "train": ("train.forward_idle_pct", "train.backward_idle_pct",
                     "train.optimizer_idle_pct")}


def _median_ms(spans: list, name: str):
    d = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans
         if s["name"] == name]
    return statistics.median(d) if d else None


def serving_thirds(tracer: ProgramTracer) -> list:
    """By third of the window: the median ms of ``batcher.queue``,
    ``http.request``, ``http.decode``, ``http.encode`` and
    ``batcher.window``, the padded share of the ``model.call`` spans and
    the idle seconds by span."""
    s = tracer.summary
    t0, t1 = s["t0_ns"], s["t1_ns"]
    out = []
    for a, b in zip(np.linspace(t0, t1, 4)[:-1].astype(np.int64),
                    np.linspace(t0, t1, 4)[1:].astype(np.int64)):
        part = [x for x in s["program_spans"] if a <= x["start_ns"] < b]
        calls = [x["attrs"] for x in part if x["name"] == "model.call"]
        ran = sum(c["images"] + c["padded"] for c in calls)
        idle = reduce_program(tracer.rows, int(a), int(b),
                              s["program_spans"], tracer.owner)
        out.append({
            "queue_ms": _median_ms(part, "batcher.queue"),
            "http_request_ms": _median_ms(part, "http.request"),
            "decode_ms": _median_ms(part, "http.decode"),
            "encode_ms": _median_ms(part, "http.encode"),
            "window_ms": _median_ms(part, "batcher.window"),
            "pad_share": (100.0 * sum(c["padded"] for c in calls) / ran
                          if ran else None),
            "idle_s": idle["idle_by_program_span"]})
    return out


def probe(workload: str, seed: int, seconds: float, mode: str,
          device: str = "cuda:0", out: str | None = None,
          overrides: dict | None = None) -> dict:
    """One run of the cell in ``mode`` (see the module docstring);
    ``overrides`` as ``run.run_cell``'s (tests only)."""
    from . import serve_cell, train_cell

    cell, bench, cfg, traffic = run.cell_files(workload)
    for part, target in (("config", cfg), ("traffic", traffic)):
        target.update((overrides or {}).get(part, {}))
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    kind = {"serve": serve_cell, "train": train_cell}[traffic["kind"]]
    tracers = []

    def make(*args):
        tracers.append(ProgramTracer(*args))
        return tracers[-1]

    rec = _recorder()
    with contextlib.ExitStack() as stack:
        if mode == "trace":
            stack.enter_context(mock.patch.object(kind, "ProgramTracer", make))
        elif mode == "record" and rec is not None:
            rec.enable()
            stack.callback(rec.disable)
        res = kind.run(cfg, traffic, seed, seconds, mode == "trace", device,
                       T_START, run.log)
    line = {"workload": workload, "seed": seed, "mode": mode,
            "correct": bool(res["correct"]), "e2e": res["e2e"],
            "checks": res["checks"]}
    if mode == "record" and rec is not None:
        spans, dropped = rec.drain()
        line["spans_recorded"], line["spans_dropped"] = len(spans), dropped
    if mode != "trace":
        return line
    layer, summary = res["layer"], tracers[0].summary
    names = [m["name"] for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])]
    names += [n for n in METRICS[traffic["kind"]] if n not in names]
    line["metrics"] = {n: run.reader(n)(layer) for n in names}
    line["trace"] = {k: v for k, v in summary.items()
                     if k not in ("program_spans", "kernels")}
    line["trace"]["kernels_s"] = sum(summary["kernels"].values())
    if traffic["kind"] == "serve":
        b, a = layer["before"], layer["after"]
        line["counters"] = {k: a[k] - b[k] for k in a
                            if isinstance(a[k], (int, float)) and k in b}
        line["counters"]["bucket_runs"] = {
            k: n - b.get("bucket_runs", {}).get(k, 0)
            for k, n in a.get("bucket_runs", {}).items()}
    if "program_spans" in summary:
        line["spans_in_window"] = len(summary["program_spans"])
        if traffic["kind"] == "serve":
            thirds = serving_thirds(tracers[0])
            line["thirds"] = thirds
            for i, t in enumerate(thirds):
                run.log(f"# third {i + 1}: {json.dumps(t)}")
        if out:
            with open(out, "w") as f:
                json.dump(summary["program_spans"], f)
    return line


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("trace", "record"), default="trace")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.log(f"# card: {run._power_limit()}")
    t = time.monotonic()
    line = probe(args.workload, args.seed, args.seconds, args.mode,
                 out=args.out)
    line["run_s"] = time.monotonic() - t
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
