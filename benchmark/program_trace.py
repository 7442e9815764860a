"""A cell's traced run with the program's own spans, for the metrics
``benchmark.run`` cannot read yet.

``ProgramTracer`` is the harness's ``Tracer`` that also turns on the port's
span recorder (``sod100k_tpu_torch.utils.profiler``) for the window and
adds to the trace's summary, every key of which it leaves as ``Tracer``
computes it:

- ``idle_by_program_span``: the idle seconds by the innermost span of the
  thread that owns the device (``serve-dispatcher`` serving, the loop's
  thread training) over each gap's midpoint, or ``NO_SPAN``;
- ``device_by_program_span``: each device event's seconds by the innermost
  such span over the CUDA runtime call that launched it, found by the
  profiler's correlation id, whatever the kernel is called;
- ``program_spans``: the spans of the window (as dicts), and
  ``spans_dropped``.

Both splits are self attributions (a gap or kernel counts once, for its
innermost span); they sum to ``window_s - busy_s`` and to the sum of
``kernels``. The readers of ``idle_by_program_span``, ``resize_roofline``
and the ``*_idle_pct`` metrics in ``benchmark/metrics/`` read this summary.

    python -m benchmark.program_trace --workload <cell> --seed <n>
        --seconds <s> [--mode trace|record] [--out FILE]

runs the cell as ``benchmark.run`` does (set-up, window, the reference's
check), with ``trace``: under ``ProgramTracer``, printing one JSON line
with every reader's value, the splits and (serving) the batcher's
counters over the window, and stderr lines by third of the window;
``record``: untraced, the recorder on for the whole run (its cost,
against ``benchmark.run --trace 0``). ``--out`` writes the window's
spans as JSON. ``setup_s`` counts from this module's import, as
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
from .trace import Tracer, _merge, reduce  # noqa: E402

NO_SPAN = "no program span"
OWNER = {"serve": "serve-dispatcher", "train": "MainThread"}
METRICS = {"serve": ("serve.queue_ms", "serve.pad_share",
                     "serve.launch_idle_pct", "resize_roofline"),
           "train": ("train.forward_idle_pct", "train.backward_idle_pct",
                     "train.optimizer_idle_pct")}


def _recorder():
    """The port's span recorder, or None where the program has none."""
    try:
        from sod100k_tpu_torch.utils import profiler
    except ImportError:
        return None
    return profiler if hasattr(profiler, "enable") else None


def event_rows(events) -> dict:
    """The profiler's events as arrays: device events (start, end,
    correlation id) and the host calls' start by correlation id."""
    dev, launch = [], {}
    for ev in events:
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation():
                s = ev.start_ns()
                dev.append((s, s + ev.duration_ns(), ev.correlation_id()))
        elif ev.correlation_id() > 0:
            launch[ev.correlation_id()] = ev.start_ns()
    arr = np.array(dev, np.int64).reshape(-1, 3)
    return {"start": arr[:, 0], "end": arr[:, 1], "corr": arr[:, 2],
            "launch": launch}


def segments(spans) -> tuple:
    """Spans of one thread (nested, as a thread's stack opens them) as
    disjoint pieces, each labelled with the innermost span over it:
    (starts, ends, labels), sorted."""
    out, stack, cursor = [], [], 0
    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        while stack and stack[-1]["end_ns"] <= s["start_ns"]:
            top = stack.pop()
            if top["end_ns"] > cursor:
                out.append((cursor, top["end_ns"], top["name"]))
                cursor = top["end_ns"]
        if stack and s["start_ns"] > cursor:
            out.append((cursor, s["start_ns"], stack[-1]["name"]))
        stack.append(s)
        cursor = max(cursor, s["start_ns"])
    while stack:
        top = stack.pop()
        if top["end_ns"] > cursor:
            out.append((cursor, top["end_ns"], top["name"]))
            cursor = top["end_ns"]
    return (np.array([o[0] for o in out], np.int64),
            np.array([o[1] for o in out], np.int64), [o[2] for o in out])


def _label(segs, points) -> list:
    starts, ends, labels = segs
    k = np.searchsorted(starts, points, side="right") - 1
    ok = (k >= 0) & (points < ends[np.maximum(k, 0)]) if len(starts) else \
        np.zeros(len(points), bool)
    return [labels[i] if hit else NO_SPAN for i, hit in zip(k, ok)]


def _add(into: dict, names, seconds) -> dict:
    for n, s in zip(names, seconds):
        if s > 0:
            into[n] = into.get(n, 0.0) + float(s)
    return into


def reduce_program(rows: dict, t0: int, t1: int, spans: list,
                   owner: str) -> dict:
    """The two splits of the window [t0, t1] (see the module docstring)
    over the spans (dicts) of thread ``owner``."""
    segs = segments([s for s in spans if s["thread_name"] == owner])
    ds = np.clip(rows["start"], t0, t1)
    de = np.clip(rows["end"], t0, t1)
    if len(ds):
        ms, me = _merge(ds, de)
        gs, ge = np.concatenate([[t0], me]), np.concatenate([ms, [t1]])
    else:
        gs, ge = np.array([t0], np.int64), np.array([t1], np.int64)
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    idle = _add({}, _label(segs, (gs + ge) // 2), (ge - gs) / 1e9)
    launch = rows["launch"]
    at = np.array([launch.get(int(c), -1) for c in rows["corr"]], np.int64)
    names = _label(segs, at)
    device = _add({}, [n if a >= 0 else NO_SPAN for n, a in zip(names, at)],
                  (de - ds) / 1e9)
    return {"idle_by_program_span": idle, "device_by_program_span": device}


def idle_pct(run: dict, *names: str):
    """100 x the idle seconds of spans ``names`` over the window (the
    ``*_idle_pct`` readers); None without the program's spans."""
    trace = run["trace"]
    if trace is None or "idle_by_program_span" not in trace or \
            trace["window_s"] <= 0:
        return None
    idle = trace["idle_by_program_span"]
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / trace["window_s"]


def _window(spans: list, t0: int, t1: int) -> list:
    return [s for s in spans if s["end_ns"] >= t0 and s["start_ns"] <= t1]


class ProgramTracer(Tracer):
    """``Tracer`` with the program's spans (see the module docstring);
    ``owner`` names the thread that owns the device."""

    def __init__(self, device, owner: str):
        super().__init__(device)
        self.owner = owner
        self.rows: dict | None = None
        self._rec = _recorder()

    def start(self) -> None:
        if self._rec is not None:
            self._rec.enable()
        super().start()

    def stop(self, t0_ns: int, t1_ns: int, spans=()) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self.summary = reduce(events, t0_ns, t1_ns, spans)
        self._prof = None
        if self._rec is None:
            return
        self._rec.disable()
        program, dropped = self._rec.drain()
        program = _window([s.as_dict() for s in program], t0_ns, t1_ns)
        self.rows = event_rows(events)
        self.summary.update(reduce_program(self.rows, t0_ns, t1_ns, program,
                                           self.owner))
        self.summary.update(program_spans=program, spans_dropped=dropped,
                            t0_ns=t0_ns, t1_ns=t1_ns)


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
    owner = OWNER[traffic["kind"]]
    tracers = []

    def make(dev):
        tracers.append(ProgramTracer(dev, owner))
        return tracers[-1]

    rec = _recorder()
    with contextlib.ExitStack() as stack:
        if mode == "trace":
            stack.enter_context(mock.patch.object(kind, "Tracer", make))
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
