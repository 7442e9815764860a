"""The controls that the limits of ``correct`` are set against.

    python -m benchmark.control --workload <cell> --seeds 1 2 3 ...

The configurations state float32 with TF32 off, so the control is the
reference put in the program's place and computed with TF32 on (cuDNN's
and cuBLAS's float32 products on the tensor cores), read by the same
numbers as a run: a serving cell's ``gap_levels`` over the cell's whole
image pool, a training cell's ``loss_gap``, ``grad_gap`` and
``change_gap``. A training cell also reads its planted faults, in the
reference put in the program's place: ``half_batch`` (the step sees half
of each batch, the loss the mean over it) and ``unchanged`` (the
parameters never move; reads 1 on ``change_gap`` by construction). Prints
one JSON line per seed; runs on the card at the cell's own size, and in
``tests/test_benchmark_control.py`` at a smaller one.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import check, weights
from . import traffic as tr
from .families import family
from .reference.common import tf32
from .run import cell_files
from .serve_cell import reference_levels
from .train_cell import CHECK_STEPS, _reference, make_batches


def serve_control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    fam = family(cfg)
    pool = tr.make_pool(seed, traffic["pool"], int(cfg["hw"]))
    with tf32(False):
        state = weights.seeded_state(fam.spec(), seed, device)
        weights.calibrate(fam, state, pool)
        ref = reference_levels(fam, state, pool, device)
    with tf32(True):
        low = reference_levels(fam, state, pool, device)
    served = torch.trunc(low).to(torch.uint8)
    return {"gap_levels": check.gap_levels(served, served, ref)}


def train_control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    fam = family(cfg)
    hw, batch = int(cfg["hw"]), int(traffic["batch"])
    steps = CHECK_STEPS
    with tf32(False):
        state = weights.seeded_state(fam.spec(), seed, device)
        images, targets = make_batches(seed, int(traffic["resident_batches"]),
                                       batch, hw, device)
        weights.calibrate(fam, state, images[0])
        ref = _reference(fam, cfg, traffic, state, images, targets, steps)
        half = _reference(fam, cfg, traffic, state,
                          images[:, :batch // 2], targets[:, :batch // 2],
                          steps)
    with tf32(True):
        low = _reference(fam, cfg, traffic, state, images, targets, steps)
    unchanged = {**ref, "change": {k: torch.zeros_like(v)
                                   for k, v in ref["change"].items()}}
    return {"control": check.train_numbers(low, ref),
            "half_batch": check.train_numbers(half, ref),
            "unchanged": check.train_numbers(unchanged, ref)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, _, cfg, traffic = cell_files(args.workload)
    device = torch.device("cuda:0")
    fn = serve_control if traffic["kind"] == "serve" else train_control
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **fn(cfg, traffic, seed, device)}), flush=True)


if __name__ == "__main__":
    main()
