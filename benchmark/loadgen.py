"""The load generator: its own process, so that building and reading
requests never takes the server's interpreter lock.

    python -m benchmark.loadgen        (driven by the harness over pipes)

Reads one JSON line of parameters on stdin (``traffic``, ``seed``,
``seconds``, ``hw``, ``minmax``: a file to write), makes the seeded image
pool, prints ``READY``, and waits for ``GO <host> <port>``. Then it posts
uint8 ``.npy`` requests to ``/predict`` for ``seconds``: an open loop sends
each request when it is due (``traffic.open_schedule``) and times it from
then, so a stall that delays later sends counts in their latency; a closed
loop's clients each send their next request when the last returns. Every
request due in the window is waited for, up to ``DRAIN_S`` past its close.

Every response is checked for its shape and type; each image's map is
folded into the elementwise least and greatest map seen for its pool image
(``minmax``), which is all the harness needs to hold every served map to
the reference. It prints how late the open loop ran on standard error and
one JSON line on standard output: per-request latency (null for a failed
request) and lateness in ms, attempted, failed, the first errors.
"""

from __future__ import annotations

import http.client
import io
import json
import queue
import sys
import threading
import time

import numpy as np

from . import traffic as tr

DRAIN_S = 60.0
TIMEOUT_S = 120.0
CONNECTIONS = 64   # an open loop's senders: more than ever wait at once


class Maps:
    """The least and greatest served map of each pool image."""

    def __init__(self, n: int, hw: int):
        self.lo = np.full((n, hw, hw, 1), 255, np.uint8)
        self.hi = np.zeros((n, hw, hw, 1), np.uint8)
        self.seen = np.zeros(n, np.int64)
        self.lock = threading.Lock()

    def add(self, idx, maps: np.ndarray) -> None:
        with self.lock:
            for i, m in zip(idx, maps):
                np.minimum(self.lo[i], m, out=self.lo[i])
                np.maximum(self.hi[i], m, out=self.hi[i])
                self.seen[i] += 1


def _body(pool: np.ndarray, idx) -> bytes:
    buf = io.BytesIO()
    np.save(buf, pool[list(idx)])
    return buf.getvalue()


def post(conn: http.client.HTTPConnection, body: bytes, n: int,
         hw: int) -> np.ndarray:
    """One ``/predict`` call; raises on any error or a malformed map."""
    try:
        conn.request("POST", "/predict", body,
                     {"Content-Type": "application/x-npy"})
        r = conn.getresponse()
        data = r.read()
    except (OSError, http.client.HTTPException):
        conn.close()
        raise
    if r.status != 200:
        raise RuntimeError(f"HTTP {r.status}: {data[:200]!r}")
    out = np.load(io.BytesIO(data), allow_pickle=False)
    if out.shape != (n, hw, hw, 1) or out.dtype != np.uint8:
        raise RuntimeError(f"got {out.dtype} {out.shape} for a {n}-image "
                           f"request")
    return out


def _record(errors: list, e: Exception) -> None:
    if len(errors) < 5:
        errors.append(f"{type(e).__name__}: {e}")


def open_loop(addr, sched, pool, maps: Maps, hw: int,
              seconds: float) -> dict:
    n = len(sched)
    latency = [float("inf")] * n
    lateness = [float("nan")] * n
    errors: list = []
    todo: queue.Queue = queue.Queue()

    def worker():
        conn = http.client.HTTPConnection(*addr, timeout=TIMEOUT_S)
        while (item := todo.get()) is not None:
            k, due = item
            idx = sched[k][1]
            lateness[k] = time.monotonic() - due
            try:
                out = post(conn, _body(pool, idx), len(idx), hw)
            except Exception as e:  # a failed request: recorded, not fatal
                _record(errors, e)
                continue
            latency[k] = time.monotonic() - due
            maps.add(idx, out)
        conn.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(CONNECTIONS)]
    for t in threads:
        t.start()
    t0 = time.monotonic() + 0.02
    for k, (due, _) in enumerate(sched):
        wait = t0 + due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        todo.put((k, t0 + due))
    for _ in threads:
        todo.put(None)
    end = t0 + seconds + DRAIN_S
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    return {"latency": latency, "lateness": lateness, "errors": errors,
            "window_s": time.monotonic() - t0}


def closed_loop(addr, traffic: dict, seed: int, pool, maps: Maps, hw: int,
                seconds: float) -> dict:
    clients = int(traffic["clients"])
    latency: list = [[] for _ in range(clients)]
    errors: list = []
    t0 = time.monotonic()
    stop = t0 + seconds

    def client(c):
        conn = http.client.HTTPConnection(*addr, timeout=TIMEOUT_S)
        for idx in tr.closed_requests(traffic, seed, c):
            if time.monotonic() >= stop:
                break
            body = _body(pool, idx)
            sent = time.monotonic()
            try:
                out = post(conn, body, len(idx), hw)
            except Exception as e:  # a failed request: recorded, not fatal
                _record(errors, e)
                latency[c].append(float("inf"))
                continue
            latency[c].append(time.monotonic() - sent)
            maps.add(idx, out)
        conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + DRAIN_S)
    return {"latency": [v for per in latency for v in per], "lateness": [],
            "errors": errors, "window_s": time.monotonic() - t0}


def _ms(values) -> list:
    return [None if not np.isfinite(v) else v * 1e3 for v in values]


def main() -> None:
    params = json.loads(sys.stdin.readline())
    traffic, seed, hw = params["traffic"], params["seed"], params["hw"]
    seconds = float(params["seconds"])
    pool = tr.make_pool(seed, traffic["pool"], hw)
    sched = (tr.open_schedule(traffic, seed, seconds)
             if traffic["loop"] == "open" else None)
    maps = Maps(traffic["pool"], hw)
    print("READY", flush=True)
    go = sys.stdin.readline().split()
    if len(go) != 3 or go[0] != "GO":
        raise SystemExit(f"loadgen: expected 'GO host port', got {go}")
    addr = (go[1], int(go[2]))
    if sched is not None:
        res = open_loop(addr, sched, pool, maps, hw, seconds)
        late = np.asarray([v for v in res["lateness"] if np.isfinite(v)])
        if late.size:
            print(f"# loadgen lateness ms: p50 {np.median(late) * 1e3} "
                  f"p95 {np.percentile(late, 95) * 1e3} max "
                  f"{late.max() * 1e3} over {late.size} sends",
                  file=sys.stderr, flush=True)
    else:
        res = closed_loop(addr, traffic, seed, pool, maps, hw, seconds)
    np.savez(params["minmax"], lo=maps.lo, hi=maps.hi, seen=maps.seen)
    lat = res["latency"]
    print(json.dumps({
        "attempted": len(lat),
        "failed": int(sum(1 for v in lat if not np.isfinite(v))),
        "latency_ms": _ms(lat), "lateness_ms": _ms(res["lateness"]),
        "errors": res["errors"], "window_s": res["window_s"]}), flush=True)


if __name__ == "__main__":
    main()
