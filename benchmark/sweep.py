"""Find an open-loop serving cell's knee: the highest offered rate that the
daemon sustains without a growing backlog.

    python -m benchmark.sweep --workload <cell> --seed <n> --seconds <s>
        --rates <img/s>,<img/s>,...

One set-up, then one window per rate, each from a new load generator
process with the cell's traffic at that ``rate_img_s``. For each rate it
prints one JSON line: offered and completed images per second, p50 and p95
latency, the median latency of the last third of the requests (by due
time) over that of the first third (a backlog that grows through the
window reads well above 1), the images per dispatch, failures.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np
import torch

from . import traffic as tr
from .run import cell_files
from .serve_cell import LoadGen, Session, loadgen_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    _, _, cfg, traffic = cell_files(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    device = torch.device("cuda:0")
    workdir = tempfile.mkdtemp(prefix="sod100k-sweep-")
    sess = Session(cfg, traffic, args.seed, device, workdir)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            t = {**traffic, "rate_img_s": rate}
            lg = LoadGen(loadgen_params(cfg, t, args.seed, args.seconds,
                                        workdir))
            try:
                res, before, after, _, _ = sess.drive(lg)
            finally:
                lg.close()
            sizes = [len(i) for _, i in
                     tr.open_schedule(t, args.seed, args.seconds)]
            lat = np.array([np.inf if v is None else v
                            for v in res["latency_ms"]])
            third = max(1, len(lat) // 3)
            disp = after["dispatches"] - before["dispatches"]
            print(json.dumps({
                "offered_img_s": rate,
                "completed_img_s": sum(sizes) / res["window_s"],
                "p50_ms": tr.percentile(lat, 50),
                "p95_ms": tr.percentile(lat, 95),
                "last_over_first_third": float(
                    np.median(lat[-third:]) / np.median(lat[:third])),
                "batch_img": (after["images"] - before["images"])
                / max(disp, 1),
                "requests": len(lat), "failed": res["failed"],
                "window_s": res["window_s"]}), flush=True)
    finally:
        sess.close()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
