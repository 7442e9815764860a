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

    def stop(self, t0_ns: int, t1_ns: int, spans=()) -> None:
        """Stop, and reduce the trace between ``t0_ns`` and ``t1_ns``
        (``time.time_ns()`` readings); ``spans``: (name, start_ns, end_ns)
        host intervals that name the idle gaps they cover."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.summary = reduce(self._prof.profiler.kineto_results.events(),
                              t0_ns, t1_ns, spans)
        self._prof = None


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
