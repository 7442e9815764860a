"""A serving cell: the port's HTTP daemon over its serving artifact, driven
by the load generator in its own process.

Set-up goes the users' way: seeded weights made on the device, BN
statistics calibrated by the reference, the family's serving model (for
CSNet and CSF ``serve.export_artifact`` into a temporary directory and
``serve.load_artifact``), ``serve_http.make_server`` with its warm-up of
every bucket. Between the daemon's batcher and the serving model sits
``TimedModel``: it times every call (a call returns host numpy, so it is
synchronised); in a traced run (``trace.ProgramTracer``, the dispatcher
thread's spans) its calls name the device's idle gaps that they cover.
After the window every served map is held to the reference (``check``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import check, roofline, weights
from . import traffic as tr
from .families import family
from .reference.common import tf32
from .trace import OWNER, ProgramTracer


class TimedModel:
    """The serving model as the batcher sees it, each call timed."""

    def __init__(self, model):
        self._model = model
        self.calls: list = []   # (t0, t1, images, t0 and t1 in epoch ns)
        self.recording = False

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, images):
        t0, t0_ns = time.monotonic(), time.time_ns()
        out = self._model(images)
        if self.recording:
            self.calls.append((t0, time.monotonic(), len(images), t0_ns,
                               time.time_ns()))
        return out


class LoadGen:
    """The load generator's process: started with its parameters, it makes
    its pool and says READY (``ready``); ``go`` opens its window;
    ``result`` waits for its JSON line."""

    def __init__(self, params: dict):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.loadgen"], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps(params) + "\n")
        self.proc.stdin.flush()

    def _line(self, what: str) -> str:
        line = self.proc.stdout.readline()
        if not line:
            self.proc.wait(30)
            raise RuntimeError(f"load generator exited "
                               f"({self.proc.returncode}) before {what}")
        return line

    def ready(self) -> None:
        if self._line("READY").strip() != "READY":
            raise RuntimeError("load generator did not say READY")

    def go(self, addr) -> None:
        self.proc.stdin.write(f"GO {addr[0]} {addr[1]}\n")
        self.proc.stdin.flush()

    def result(self) -> dict:
        res = json.loads(self._line("its result"))
        self.proc.wait(60)
        return res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(30)


class Session:
    """A serving cell's set-up: weights, artifact, daemon."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 workdir: str):
        from sod100k_tpu_torch import serve_http

        self.fam = family(cfg)
        self.device = device
        hw = int(cfg["hw"])
        self.pool = tr.make_pool(seed, traffic["pool"], hw)
        self.state = weights.seeded_state(self.fam.spec(), seed, device)
        weights.calibrate(self.fam, self.state, self.pool)
        self.model = TimedModel(self.fam.serving_model(self.state, device,
                                                       workdir))
        self.srv = serve_http.make_server(self.model, port=0,
                                          max_wait_ms=traffic["max_wait_ms"])
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def drive(self, lg: LoadGen,
              tracer: ProgramTracer | None = None) -> tuple:
        """One window: (the load generator's result, batcher snapshots
        before and after, the model calls, the window's opening on the
        monotonic clock); ``tracer`` traces it."""
        lg.ready()
        if tracer is not None:
            tracer.start()
        before = self.srv.batcher.snapshot()
        self.model.calls = []
        self.model.recording = True
        opened, opened_ns = time.monotonic(), time.time_ns()
        lg.go(self.srv.server_address[:2])
        res = lg.result()
        after = self.srv.batcher.snapshot()
        self.model.recording = False
        calls = list(self.model.calls)
        if tracer is not None:
            end_ns = calls[-1][4] if calls else time.time_ns()
            tracer.stop(opened_ns, end_ns, [
                ("serving model call (host side)", c[3], c[4])
                for c in calls])
        return res, before, after, calls, opened

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.batcher.stop()
        self.thread.join(30)


@torch.no_grad()
def reference_levels(fam, state: dict, images: np.ndarray,
                     device) -> torch.Tensor:
    """255 * the reference's sigmoid of ``images``, (N, H, W, 1), on the
    host. On the card, in blocks of as many images as half its free memory
    holds, by the peak of a first one-image block (this resets the card's
    peak statistics)."""
    def levels(part):
        x = torch.from_numpy(part).to(device)
        sig = torch.sigmoid(fam.forward(state, x).float())
        return (sig * 255.0).permute(0, 2, 3, 1).cpu()

    card = device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    out = [levels(images[:1])]
    block = len(images)
    if card:
        one = torch.cuda.max_memory_allocated(device) - base
        block = max(1, int(torch.cuda.mem_get_info(device)[0] // 2 // one))
    for i in range(1, len(images), block):
        out.append(levels(images[i:i + block]))
    return torch.cat(out)


def loadgen_params(cfg, traffic, seed, seconds, workdir) -> dict:
    return {"traffic": traffic, "seed": seed, "seconds": seconds,
            "hw": int(cfg["hw"]), "minmax": os.path.join(workdir, "maps.npz")}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log) -> dict:
    workdir = tempfile.mkdtemp(prefix="sod100k-bench-")
    params = loadgen_params(cfg, traffic, seed, seconds, workdir)
    lg = LoadGen(params)
    tracer = ProgramTracer(device, OWNER["serve"]) if trace else None
    sess = None
    try:
        sess = Session(cfg, traffic, seed, device, workdir)
        res, before, after, calls, opened = sess.drive(lg, tracer)
        setup_s = opened - t_start
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        sess.close()
        fam, state, pool = sess.fam, sess.state, sess.pool
        sess = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        maps = np.load(params["minmax"])
        seen = np.flatnonzero(maps["seen"])
        with tf32(False):
            ref = reference_levels(fam, state, pool[seen], device)
        numbers = {"gap_levels": check.gap_levels(
            torch.from_numpy(maps["lo"][seen]),
            torch.from_numpy(maps["hi"][seen]), ref),
            "failed": float(res["failed"])}
        checked = int(maps["seen"].sum())
    finally:
        lg.close()
        if sess is not None:
            sess.close()
        shutil.rmtree(workdir, ignore_errors=True)
    ok, checks = check.verdict(numbers, traffic["limits"])
    for e in res["errors"]:
        log(f"# request failed: {e}")
    log(f"# window: {res['attempted']} requests, {res['failed']} failed, "
        f"{len(calls)} model calls, {len(seen)} of {traffic['pool']} pool "
        f"images served, {checked} maps checked")
    ms = np.asarray([(c[1] - c[0]) * 1e3 for c in calls])
    thirds = [float(np.median(p)) for p in np.array_split(ms, 3) if len(p)]
    log(f"# model call ms, median by third of the window: {thirds}")
    lat = [float("inf") if v is None else v for v in res["latency_ms"]]
    thirds = [(tr.percentile(p, 50), tr.percentile(p, 95))
              for p in np.array_split(np.asarray(lat), 3) if len(p)]
    log(f"# latency ms: p95 {tr.percentile(lat, 95)}; p50 and p95 by "
        f"third of the window (by due or send time): {thirds}")
    return {
        "correct": ok, "attempted": res["attempted"], "failed": res["failed"],
        "e2e": {"setup_s": setup_s, "serve_p50_ms": tr.percentile(lat, 50)},
        "peak": peak, "checks": checks,
        "layer": {"before": before, "after": after, "calls": calls,
                  "buckets": cfg["buckets"],
                  "flops_per_img": cfg["flops_per_img"],
                  "peak_flops": roofline.peak_flops(cfg),
                  "dw_chain": cfg.get("dw_chain"),
                  "trace": tracer.summary if tracer else None}}
