"""Run one cell of the port's benchmark on the card and print one JSON line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration in
``benchmark/configs/<config>.json``, its traffic mix in
``benchmark/traffic/<cell>.json`` (``"kind"``: ``serve`` or ``train``),
each per-layer metric's reader in ``benchmark/metrics/<metric>.py``.
With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, from the same run under
``torch.profiler``. The numbers that decide ``correct`` are printed with
their limits as the last lines on standard error and under ``checks``,
the line's last key.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the port, or when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``sod100k_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "sod100k_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``sod100k_tpu_torch`` is not ``sod100k_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, root: str = ROOT) -> tuple:
    """(the workload entry, the benchmark, its configuration, its traffic)
    of cell ``workload``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     f"{workload}.json"))
    return cell, bench, config, traffic


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool, e2e: dict,
                 layer: dict) -> dict:
    """The metrics the line carries: the cell's end-to-end ones, or its
    per-layer ones (a reader that finds nothing leaves its metric out)."""
    out = {}
    if not trace:
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]) and m["name"] in e2e:
                out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = reader(m["name"])(layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, *, root: str = ROOT, overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """Run a cell; returns the result line as a dict. ``overrides`` (tests
    only) replace keys of ``{"config": ..., "traffic": ...}``."""
    import torch

    from . import serve_cell, train_cell

    cell, bench, cfg, traffic = cell_files(workload, root)
    for part, target in (("config", cfg), ("traffic", traffic)):
        target.update((overrides or {}).get(part, {}))
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    kind = {"serve": serve_cell, "train": train_cell}[traffic["kind"]]
    res = kind.run(cfg, traffic, seed, seconds, trace, device,
                   T_START if t_start is None else t_start, log)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(res["peak"])}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": cell_metrics(bench, workload, trace, res["e2e"],
                                    res["layer"]),
            "device": dev}
    summary = res["layer"].get("trace")
    if trace and summary is not None:
        from .trace import breakdown

        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        line["breakdown"] = breakdown(summary)
    line["checks"] = res["checks"]
    return line


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell_files(args.workload)[0]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 3
    if importlib.util.find_spec("sod100k_tpu_torch") is None:
        log("the port (sod100k_tpu_torch) is not in this checkout")
        return 3
    log(f"# card: {_power_limit()}")
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda:0")
    bad = loaded_forbidden()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
