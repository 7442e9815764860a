"""Full-recipe smoke driver (the port of ``cli/smoke.py``): train ->
prune+finetune -> test -> eval -> resident TESTALL sweep, on the card.

Usage:
  python -m sod100k_tpu_torch.cli.smoke --dry-data [--save-dir DIR]
  python -m sod100k_tpu_torch.cli.smoke --data-root /path/to/datasets ...
  python -m sod100k_tpu_torch.cli.smoke --fetch all --data-root DIR

The synthetic tree (``--dry-data``) is DUTS-TR/ECSSD-shaped: images/*.png +
GT/*.png (``data/synth.py::make_synth_split``). A real tree under
--data-root holds DUTS-TR/ (train) and ECSSD/ (val+test); the same chain
runs on it unchanged, and the accuracy tables fall out of cli.eval's
FmeasureResults files.

Reference flow: train.py -> finetune.py --epoch N -> test.py -> eval.py
(SURVEY.md section 3).

Under the SOD100K_* variables (or torchrun's) the chain runs on the
world's processes, one per card: every process is given the same
--save-dir, the primary writes the synthetic tree and the outputs, and
eval runs on the primary. Without --mesh_shape the world is a 1-D data
mesh; --mesh_shape DxS makes its D*S processes a 2-D data x spatial mesh
(CUDA.MESH_SHAPE on the config every stage clones, as the JAX driver
does), so that the whole chain, the resident TESTALL sweep included, runs
with the batch over D and each image's rows over S, e.g.
``SOD100K_MULTIHOST=auto torchrun --nproc-per-node 2 -m
sod100k_tpu_torch.cli.smoke --dry-data --save-dir DIR --mesh_shape 1x2``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

SMOKE_BATCH = 4  # DATA.BATCH_SIZE of the chain's stages


def make_dry_data(root: str, n_train: int = 12, n_test: int = 6,
                  hw=(96, 128)) -> None:
    """DUTS-TR/ECSSD-shaped synthetic directory tree with blobby saliency."""
    from ..data.synth import make_synth_split

    for split, n, seed in (("DUTS-TR", n_train, 3), ("ECSSD", n_test, 4)):
        make_synth_split(os.path.join(root, split), n, hw=hw, jitter=15,
                         seed=seed)


def _print_log(msg, display: bool = True) -> None:
    """print with the drivers' Logger(msg, display=...) calling convention."""
    if display:
        print(msg)


def run_smoke(data_root: str, save_dir: str, *, train_epochs: int = 2,
              finetune_epochs: int = 1, image_hw: int = 64,
              batch_size: int = SMOKE_BATCH, mesh_shape: str = "",
              log=_print_log, device: str | torch.device = "cuda") -> dict:
    from ..config import get_cfg
    from ..parallel import multihost
    from .eval import run_eval
    from .finetune import run_finetune
    from .test import run_test, run_testall_resident
    from .train import run_training

    cfg = get_cfg()
    cfg.TASK = "smoke"
    cfg.PRINT_FREQ = 1
    cfg.MODEL.BASIC_SPLIT = [0.5, 0.5]
    cfg.LOSS.MLOSS = 1
    cfg.DATA.DIR = os.path.join(data_root, "DUTS-TR")
    cfg.DATA.BATCH_SIZE = batch_size
    cfg.DATA.SAVEDIR = save_dir
    cfg.DATA.IMAGE_H = cfg.DATA.IMAGE_W = image_hw
    cfg.VAL.DIR = os.path.join(data_root, "ECSSD")
    cfg.TEST.DATASET_PATH = data_root
    cfg.TEST.DATASETS = ["ECSSD"]
    cfg.TEST.IMAGE_H = cfg.TEST.IMAGE_W = image_hw
    cfg.AUTO.ENABLE = True
    cfg.AUTO.EXPAND = 1.0
    cfg.AUTO.FLOPS.ENABLE = True
    cfg.AUTO.FLOPS.WEIGHT = 3.0
    cfg.SOLVER.METHOD = "Adam_dynamic_weight_decay"
    cfg.SOLVER.LR = 1e-3
    cfg.FINETUNE.THRES = 1e-6
    # one mesh for the whole chain: train on it, prune the gammas it
    # trained, finetune, test and sweep on it
    cfg.CUDA.MESH_SHAPE = mesh_shape
    if mesh_shape:
        log(f"[smoke] the chain on the {mesh_shape} mesh")

    log(f"[smoke 1/5] train {train_epochs} epochs on {cfg.DATA.DIR}")
    trained = run_training(cfg, max_epochs=train_epochs, log=log,
                           device=device)

    log(f"[smoke 2/5] prune + finetune from epoch {train_epochs}")
    ft = run_finetune(cfg, from_epoch=train_epochs,
                      max_epochs=finetune_epochs, log=log, device=device)

    log("[smoke 3/5] test (saliency PNG dump)")
    c = cfg.clone()
    c.TEST.CHECKPOINT = os.path.join(
        cfg.DATA.SAVEDIR, "smoke", "checkpoint",
        f"checkpoint_epoch{train_epochs}.pth.tar")
    c.TEST.MODEL_CONFIG = os.path.join(
        cfg.DATA.SAVEDIR, "smoke", "layer_configs", "layer_config_0.bin")
    tested = run_test(c, log=log, device=device)

    log("[smoke 4/5] eval (MAE / Max-F)")
    # the primary scores the maps it wrote; the other ranks have no report
    best = (run_eval(c, epoch_range=(tested["epoch"], tested["epoch"] + 1),
                     log=log, device=device)
            if multihost.is_primary() else {})

    log("[smoke 5/5] resident TESTALL sweep (metrics on the card, no PNGs)")
    c2 = c.clone()
    c2.CUDA.TEST_RESIDENT = True
    c2.TEST.BEGIN = 1
    c2.TEST.INTERVAL = 1
    resident_best = run_testall_resident(c2, log=log, device=device)

    ok = (trained["best_epoch"] >= 1 and np.isfinite(trained["best_mae"])
          and os.path.isdir(ft["ft_dir"])
          # eval must have scored the tested epoch (run_eval returns
          # epoch=-1 when no sal/GT pairs were found)
          and all(v["epoch"] >= 0 and v["max_f"] > 0.0 for v in best.values())
          and all(v["epoch"] >= 1 and v["max_f"] > 0.0
                  for v in resident_best.values()))
    log(f"[smoke] {'OK' if ok else 'FAILED'}: "
        f"best_mae={trained['best_mae']:.4f} eval={best} "
        f"resident_eval={resident_best}")
    return {"ok": ok, "trained": trained, "finetuned": ft, "eval": best,
            "resident_eval": resident_best, "cfg": cfg}


def _fetch_root(args) -> str | None:
    """--fetch: download the named datasets (or 'all' the smoke needs) into
    --data-root; None when nothing was fetched (offline), so the caller
    falls back to the synthetic tree."""
    from ..data.fetch import DATASETS, fetch_dataset
    from ..data.synth import make_synth_split

    # the smoke chain needs both splits: DATA.DIR=<root>/DUTS-TR and
    # VAL.DIR/TEST=<root>/ECSSD; fetching only one would otherwise fail
    # mid-run after the download finished
    needed = ("DUTS-TR", "ECSSD")
    names = (list(needed) if args.fetch == "all"
             else [n.strip() for n in args.fetch.split(",") if n.strip()])
    unknown = [n for n in names if n not in DATASETS]
    if unknown:
        raise SystemExit(f"--fetch: unknown dataset(s) {unknown}; "
                         f"available: {', '.join(sorted(DATASETS))}")
    root = args.data_root or os.path.join(tempfile.gettempdir(),
                                          "sod100k_datasets")
    fetched = {n: fetch_dataset(n, root) for n in names}
    for n, got in fetched.items():
        if got is None and not args.dry_data:
            # None covers offline and rejected downloads (checksum
            # mismatch, non-zip body, failed validation); the fetch log
            # above names the cause
            raise SystemExit(f"--fetch {n}: fetch failed (offline, or the "
                             "download was rejected; see the [fetch] log "
                             "above) and --dry-data not given")
    if all(got is None for got in fetched.values()):
        return None
    # fill the splits the smoke needs but that were not fetched: synthesize
    # them under --dry-data, otherwise fail before training starts. A split
    # not requested may be pre-placed under --data-root; a requested split
    # trusts only fetch_dataset's validated return value.
    for n in needed:
        if fetched.get(n) is not None:
            continue
        if n not in fetched and os.path.isdir(os.path.join(root, n, "images")):
            continue
        if not args.dry_data:
            raise SystemExit(
                f"--fetch: the smoke also needs {n}/ under {root} (fetch "
                f"it too, e.g. --fetch all, or add --dry-data to synthesize "
                f"the missing split)")
        make_synth_split(os.path.join(root, n), 12 if n == "DUTS-TR" else 6,
                         hw=(96, 128), jitter=15, seed=3 + (n == "ECSSD"))
    return root


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="full-recipe smoke run on the "
                                 "card")
    ap.add_argument("--dry-data", action="store_true",
                    help="synthesize a DUTS-TR/ECSSD-shaped tree")
    ap.add_argument("--data-root", default=None,
                    help="existing dataset root (overrides --dry-data)")
    ap.add_argument("--fetch", default=None, metavar="DATASETS",
                    help="comma-separated datasets to download into "
                    "--data-root first, or 'all' for what the smoke needs "
                    "(DUTS-TR for train + ECSSD for val/test). Offline-safe: "
                    "falls back to --dry-data when the network is "
                    "unreachable; integrity via data.fetch checksums.")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--train-epochs", type=int, default=2)
    ap.add_argument("--image-hw", type=int, default=64)
    ap.add_argument("--mesh_shape", default="", metavar="DxS",
                    help="run the whole chain on a 2-D data x spatial mesh "
                    "of the world's D*S processes, e.g. 1x2")
    args = ap.parse_args(argv)
    if not args.data_root and not args.dry_data and not args.fetch:
        raise SystemExit("pass --data-root DIR, --dry-data, or --fetch NAME")
    from ..parallel import multihost

    if multihost.init_from_env() and (args.fetch or not args.save_dir):
        raise SystemExit("a data-parallel smoke run needs --save-dir, the "
                         "same directory for every process, and no --fetch "
                         "(fetch once in a single process, then pass "
                         "--data-root)")
    if args.mesh_shape:
        from ..arch.csnet import DEEPEST_STRIDE2_FACTOR
        from .common import build_mesh_2d

        # the mesh's refusals before anything is written
        build_mesh_2d(args.mesh_shape, f"--mesh_shape {args.mesh_shape}",
                      batch_size=SMOKE_BATCH, batch_flag="the smoke's batch",
                      image_h=args.image_hw,
                      stride2_factor=DEEPEST_STRIDE2_FACTOR)
    data_root = _fetch_root(args) if args.fetch else args.data_root
    if data_root is None:
        data_root = (os.path.join(args.save_dir, "dry_data")
                     if multihost.is_multihost() else
                     os.path.join(tempfile.gettempdir(), "sod100k_dry_data"))
        if multihost.is_primary():
            make_dry_data(data_root)
    multihost.barrier("smoke-data")
    save_dir = args.save_dir or tempfile.mkdtemp(prefix="sod_smoke_")
    out = run_smoke(data_root, save_dir, train_epochs=args.train_epochs,
                    image_hw=args.image_hw, batch_size=SMOKE_BATCH,
                    mesh_shape=args.mesh_shape)
    raise SystemExit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
