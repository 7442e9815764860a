"""Serve an artifact over HTTP with dynamic micro-batching (the port of
``cli/serve.py``).

Usage:
  python -m sod100k_tpu_torch.cli.export ... --out art/   # make the artifact
  python -m sod100k_tpu_torch.cli.serve --artifact art/ --port 8000

Then:
  curl -s localhost:8000/healthz
  curl -s --data-binary @dog.png -H 'Content-Type: image/png' \
       localhost:8000/predict > saliency.png
  curl -s localhost:8000/stats

The server owns the card from one dispatcher thread, coalesces concurrent
requests into batched forwards (up to the largest exported bucket, waiting
at most --max-wait-ms after the first request), and warms every bucket at
startup (``serve_http.make_server``). --mesh_devices N serves on N cards
from the one process: a replica per card, each bucket that N divides split
over them (``serve.ServingModel``).
"""

from __future__ import annotations

import argparse
import signal

from ..serve import load_artifact
from ..serve_http import make_server


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", required=True,
                    help="serving artifact directory (cli.export output)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=3.0,
                    help="batching window after the first queued request")
    ap.add_argument("--mesh_devices", type=int, default=None,
                    help="serve data-parallel: 0 = all visible cards, "
                         "N = the first N (default: one card)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the per-bucket warm-up forwards")
    args = ap.parse_args(argv)

    model = load_artifact(args.artifact, device="cuda",
                          mesh_devices=args.mesh_devices)
    srv = make_server(model, args.host, args.port,
                      max_wait_ms=args.max_wait_ms,
                      warmup=not args.no_warmup)
    m = model.meta
    print(f"serving {m['family']} {m['h']}x{m['w']} wire={m.get('wire', 'f32')} "
          f"buckets={model.batches} on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]}  (POST /predict, GET /healthz /stats)",
          flush=True)

    # SIGTERM (the orchestrator's stop signal) drains like ctrl-C: stop
    # accepting, let in-flight forwards finish, join the dispatcher
    def _term(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.batcher.stop()


if __name__ == "__main__":
    main()
