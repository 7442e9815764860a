"""The device trace of a traced run, reduced to what the metrics read.

``Tracer.start``/``stop`` bracket ``torch.profiler`` before and after the
window. On the card it records CUDA activity only (kernels, copies, sets
and the CUDA runtime calls that launched them, from every thread): a
whole 30 s window of host operations as well is millions of events, and
reducing them outlasts a run. ``stop`` synchronizes first, so every
kernel launched inside the window is in the trace, and clips the trace
to the window's bounds. The reduction keeps:

- ``busy_s``: the union of device activity inside the window;
  ``window_s`` the window's length on the host clock;
- ``kernels``: device seconds by operation name;
- ``idle_gaps``: the seconds with nothing on the device, by what the host
  was doing: inside each kind of span the harness recorded (a serving
  model call) or outside them; without spans, the ``GAPS_NAMED`` longest
  gaps by the innermost CUDA runtime call over their midpoint.

Profiler timestamps and ``time.time_ns()`` share the Unix epoch, so the
window's bounds clip the events and the harness's spans line up.

``ProgramTracer``, which every traced run of a cell uses, is ``Tracer``
that also turns on the port's span recorder
(``sod100k_tpu_torch.utils.profiler``) for the window and adds to the
summary, every key of which it leaves as ``Tracer`` computes it:

- ``idle_by_program_span``: the idle seconds by the innermost span of the
  thread that owns the device (``OWNER``: ``serve-dispatcher`` serving,
  the loop's thread training) over each gap's midpoint, or ``NO_SPAN``;
- ``device_by_program_span``: each device event's seconds by the innermost
  such span over the CUDA runtime call that launched it, found by the
  profiler's correlation id, whatever the kernel is called;
- ``program_spans``: the spans of the window (as dicts), and
  ``spans_dropped``.

Both splits are self attributions (a gap or kernel counts once, for its
innermost span); they sum to ``window_s - busy_s`` and to the sum of
``kernels``. ``resize_roofline`` and the ``*_idle_pct`` readers in
``benchmark/metrics/`` read them.
"""

from __future__ import annotations

import numpy as np
import torch

GAPS_NAMED = 500
NO_HOST_OP = "no CUDA runtime call (host Python, or waiting for work)"
OUTSIDE = "outside the harness's spans (waiting for work)"
SHORTER = "shorter gaps"


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.summary: dict | None = None
        self._prof = None

    def start(self) -> None:
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[
            act.CUDA if self.device.type == "cuda" else act.CPU])
        self._prof.start()

    def stop(self, t0_ns: int, t1_ns: int, spans=()):
        """Stop, and reduce the trace between ``t0_ns`` and ``t1_ns``
        (``time.time_ns()`` readings); ``spans``: (name, start_ns, end_ns)
        host intervals that name the idle gaps they cover. Returns the
        profiler's events."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self.summary = reduce(events, t0_ns, t1_ns, spans)
        self._prof = None
        return events


def _merge(starts: np.ndarray, ends: np.ndarray):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def reduce(events, t0: int, t1: int, spans=()) -> dict:
    dev, host = [], []
    for ev in events:
        on_device = str(ev.device_type()).endswith("CUDA")
        if on_device and ev.is_user_annotation():
            continue
        start = ev.start_ns()
        row = (ev.name(), start, start + ev.duration_ns())
        (dev if on_device else host).append(row)
    window = (t1 - t0) / 1e9
    kernels: dict[str, float] = {}
    if not dev:
        return {"busy_s": 0.0, "window_s": window, "kernels": kernels,
                "idle_gaps": [], "device_events": 0}
    ds = np.clip(np.array([r[1] for r in dev], np.int64), t0, t1)
    de = np.clip(np.array([r[2] for r in dev], np.int64), t0, t1)
    for (name, _, _), a, b in zip(dev, ds, de):
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
    ms, me = _merge(ds, de)
    busy = float((me - ms).sum()) / 1e9
    gs = np.concatenate([[t0], me])
    ge = np.concatenate([ms, [t1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    return {"busy_s": busy, "window_s": window, "kernels": kernels,
            "idle_gaps": _name_gaps(gs, ge, host, spans),
            "device_events": len(dev)}


def _name_gaps(gs, ge, host: list, spans) -> list:
    """Idle seconds by what the host was doing. With harness spans, every
    gap goes to the span over its midpoint (or to ``OUTSIDE``); without,
    the ``GAPS_NAMED`` longest go to the innermost host interval over
    their midpoint and the rest to ``SHORTER``. Sorted, longest first."""
    dur = (ge - gs) / 1e9
    mid = (gs + ge) // 2
    named: dict[str, float] = {}
    if spans:
        sp = sorted(spans, key=lambda r: r[1])
        ss = np.array([r[1] for r in sp], np.int64)
        se = np.array([r[2] for r in sp], np.int64)
        k = np.searchsorted(ss, mid, side="right") - 1
        inside = (k >= 0) & (mid <= se[np.maximum(k, 0)])
        for name in {r[0] for r in sp}:
            hit = np.array([r[0] == name for r in sp])
            named[name] = float(dur[inside & hit[np.maximum(k, 0)]].sum())
        named[OUTSIDE] = float(dur[~inside].sum())
    else:
        longest = np.argsort(-dur, kind="stable")[:GAPS_NAMED]
        hs = np.array([r[1] for r in host], np.int64)
        he = np.array([r[2] for r in host], np.int64)
        for g in longest:
            inside = (np.flatnonzero((hs <= mid[g]) & (he >= mid[g]))
                      if len(host) else np.array([], np.int64))
            name = (host[inside[np.argmax(hs[inside])]][0] if inside.size
                    else NO_HOST_OP)
            named[name] = named.get(name, 0.0) + float(dur[g])
        named[SHORTER] = float(dur.sum() - dur[longest].sum())
    return sorted(((n, v) for n, v in named.items() if v > 0),
                  key=lambda kv: -kv[1])


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in
                          summary["idle_gaps"][:top]]}


NO_SPAN = "no program span"
OWNER = {"serve": "serve-dispatcher", "train": "MainThread"}


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

    def stop(self, t0_ns: int, t1_ns: int, spans=()):
        events = super().stop(t0_ns, t1_ns, spans)
        if self._rec is None:
            return events
        self._rec.disable()
        program, dropped = self._rec.drain()
        program = _window([s.as_dict() for s in program], t0_ns, t1_ns)
        self.rows = event_rows(events)
        self.summary.update(reduce_program(self.rows, t0_ns, t1_ns, program,
                                           self.owner))
        self.summary.update(program_spans=program, spans_dropped=dropped,
                            t0_ns=t0_ns, t1_ns=t1_ns)
        return events
