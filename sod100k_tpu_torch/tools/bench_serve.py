"""End-to-end throughput of the HTTP serving daemon on one card (the port
of ``tools/bench_serve.py``).

    python -m sod100k_tpu_torch.tools.bench_serve [--hw 224] [--width 40]
        [--buckets 8,32,128] [--dtype bf16] [--wire u8] [--clients 8]
        [--req-batch 16] [--secs 15] [--max-wait-ms 3] [--json FILE]
        [--device cpu]

Exports a recipe-shape CSNet artifact (seeded weights, BN statistics
calibrated on one seeded batch: perf only) with ``serve.export_artifact``,
loads it with ``serve.load_artifact``, starts ``serve_http.make_server``
in-process and drives it closed-loop with concurrent HTTP clients posting
npy batches on the artifact's wire contract. Reports served img/s against
the direct ``ServingModel`` (same artifact, no HTTP or batching layer), so
the daemon's coalescing and transport are the measured delta. Both numbers
include the maps' readback to the host.

The clients are threads of this process under one interpreter lock: each
request's npy encode is timed and reported (``client_encode_ms``) so that
a reader can tell whether the served/direct ratio measures the client
side. A client failure, or a response of the wrong batch size, exits 1.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from ..data.pipeline import require_device
from ..serve import export_artifact, load_artifact
from ..serve_http import make_server
from . import timing
from .bench import seeded_csnet


def _encode_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post_npy(url: str, body: bytes) -> np.ndarray:
    req = urllib.request.Request(
        url + "/predict", data=body,
        headers={"Content-Type": "application/x-npy"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--width", type=int, default=40,
                    help="CSNet base width (40 = csnet-L-x2 scale)")
    ap.add_argument("--buckets", default="8,32,128")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--wire", default="u8", choices=["u8", "f32"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--req-batch", type=int, default=16,
                    help="images per client request")
    ap.add_argument("--secs", type=float, default=15.0)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--json", default="", help="write results here too")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    buckets = [int(b) for b in args.buckets.split(",")]
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = seeded_csnet(device, width=args.width, hw=args.hw)
    with tempfile.TemporaryDirectory() as td:
        _log(f"# exporting buckets {buckets} @ {args.hw}^2 {args.dtype} "
             f"wire={args.wire}")
        path = export_artifact(os.path.join(td, "art"), model, batch=buckets,
                               hw=(args.hw, args.hw), dtype=dtype,
                               wire=args.wire)
        del model
        served_model = load_artifact(path, device)
        srv = make_server(served_model, port=0, max_wait_ms=args.max_wait_ms)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            row = _drive(args, srv, served_model, buckets)
        finally:
            srv.shutdown()
            srv.batcher.stop()
            t.join(timeout=60)
    row.update(timing.card(device))
    print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(row, f, indent=1)
    return row


def _drive(args, srv, model, buckets) -> dict:
    url = f"http://{srv.server_address[0]}:{srv.server_address[1]}"
    rng = np.random.default_rng(0)
    big = max(buckets)

    def mk(n):
        if args.wire == "u8":
            return rng.integers(0, 256, (n, args.hw, args.hw, 3),
                                dtype=np.uint8)
        return rng.standard_normal((n, args.hw, args.hw, 3)).astype(
            np.float32)

    # direct baseline: full-bucket calls, the maps read back to the host
    xb = mk(big)
    model(xb)  # warm (the server's warm-up covered every bucket)
    t0 = time.monotonic()
    iters = 0
    while iters < 5 or time.monotonic() - t0 < max(3.0, args.secs / 3):
        model(xb)
        iters += 1
    direct = big * iters / (time.monotonic() - t0)
    _log(f"# direct ServingModel: {direct:.1f} img/s (B={big} x{iters})")

    served_images = [0] * args.clients
    encode_s = [0.0] * args.clients
    requests = [0] * args.clients
    failures: list = []
    xs = [mk(args.req_batch) for _ in range(args.clients)]
    stop = time.monotonic() + args.secs

    def client(i):
        # a failure is recorded, not swallowed by the thread: a broken
        # response must fail the benchmark, never just deflate img/s
        try:
            while time.monotonic() < stop:
                t_enc = time.perf_counter()
                body = _encode_npy(xs[i])
                encode_s[i] += time.perf_counter() - t_enc
                out = _post_npy(url, body)
                requests[i] += 1
                if out.shape[0] != args.req_batch:
                    raise AssertionError(
                        f"client {i}: got {out.shape} for a "
                        f"{args.req_batch}-image request")
                served_images[i] += args.req_batch
        except Exception as e:  # reported below, and the run exits 1
            failures.append(e)

    before = srv.batcher.snapshot()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.monotonic() - t0
    if failures:
        for e in failures:
            _log(f"# CLIENT FAILED: {type(e).__name__}: {e}")
        raise SystemExit(1)
    s = srv.batcher.snapshot()
    served = sum(served_images) / dt
    disp = s["dispatches"] - before["dispatches"]
    imgs = s["images"] - before["images"]
    return {"direct_img_per_sec": round(direct, 1),
            "served_img_per_sec": round(served, 1),
            "served_over_direct": round(served / direct, 3),
            "clients": args.clients, "req_batch": args.req_batch,
            "dispatches": disp,
            "mean_dispatch_batch": round(imgs / max(disp, 1), 1),
            "client_encode_ms": round(
                sum(encode_s) / max(sum(requests), 1) * 1e3, 3),
            "hw": args.hw, "buckets": buckets,
            "wire": args.wire, "dtype": args.dtype}


if __name__ == "__main__":
    main()
