"""Prune-and-finetune driver (the port of ``cli/finetune.py``).

Usage: python -m sod100k_tpu_torch.cli.finetune --config <yml> --epoch N
           [--epochs M]

Flow (reference finetune.py:85-207): rebuild the epoch-0 architecture from
layer_configs/layer_config_0.bin, load checkpoint_epoch{N}, prune BN-gamma
channels below FINETUNE.THRES into a slim layer_config (saved as
layer_config_finetune_{N}.bin), then retrain with plain Adam/SGD + step or
cosine LR on BCE only (no FLOPs penalty), checkpointing under
finetune_checkpoint_epoch{N}/. TEST.ENABLE dumps test-set saliency PNGs
into finetune_{dataset}_{epoch} every TEST.INTERVAL epochs from TEST.BEGIN
(the reference's in-loop periodic test, finetune.py:183-185,304-352).

As in the JAX package, the optimizer is created *after* pruning (the
reference builds it against the pre-prune parameters, finetune.py:112-123
vs :165-173, so the rebuilt model's tensors were never registered with it).

Data parallelism as in ``cli.train``: one process per card from the
SOD100K_* variables or torchrun's, DATA.BATCH_SIZE global, the primary
writes; CUDA.MESH_SHAPE runs it, its validation and its periodic test on
the 2-D data x spatial mesh, as ``cli.train``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..arch import get_arch
from ..arch.layer_config import LayerConfig
from ..arch.csnet import DEEPEST_STRIDE2_FACTOR
from ..config import get_cfg
from ..parallel import mesh, multihost
from ..prune.finetune import build_pruned_csnet, prune
from ..train.checkpoint import save_checkpoint
from ..train.optim import cosine_lr, make_adam, make_sgd, multistep_lr
from ..train.step import make_train_step
from ..utils.profiler import count_params
from .common import (Logger, TrainFeeds, check_preprocess, compute_dtype,
                     init_parallel, load_any_checkpoint, resolve_dirs)


def run_finetune(cfg, from_epoch: int, max_epochs: int | None = None,
                 log=None, *, device: str | torch.device = "cuda") -> dict:
    device, mesh2d = init_parallel(
        cfg, device, log or print, image_h=cfg.DATA.IMAGE_H,
        stride2_factor=DEEPEST_STRIDE2_FACTOR)
    dirs = resolve_dirs(cfg)
    if log is None:
        log = Logger(dirs["base"], "logfinetune", dirs["task"])

    lc0 = LayerConfig.load(
        os.path.join(dirs["layer_configs"], "layer_config_0.bin"))
    ck = os.path.join(dirs["checkpoint"],
                      f"checkpoint_epoch{from_epoch}.pth.tar")
    if not os.path.isfile(ck):
        raise SystemExit(f"=> no checkpoint found at '{ck}'")
    model = get_arch(cfg.MODEL.ARCH)(lc0, device=device)
    load_any_checkpoint(ck, model)
    log(f"=> loaded checkpoint '{ck}' (epoch {from_epoch})")
    log("  + Number of params before: %.4fM" % (count_params(model) / 1e6))

    log("Finetune to slim model.")
    sd, lc, _masks = prune(model.state_dict(), lc0, cfg.FINETUNE.THRES)
    if multihost.is_primary():
        lc.save(os.path.join(dirs["layer_configs"],
                             f"layer_config_finetune_{from_epoch}.bin"))
    model = mesh.replicate(build_pruned_csnet(lc, sd, device=device),
                           mesh2d.world)
    log("  + Number of params after: %.4fM" % (count_params(model) / 1e6))

    sol = cfg.FINETUNE.SOLVER
    if sol.METHOD == "SGD":
        optimizer = make_sgd(model, momentum=sol.MOMENTUM,
                             weight_decay=sol.WEIGHT_DECAY)
    else:
        optimizer = make_adam(model, weight_decay=sol.WEIGHT_DECAY)
    preprocess = check_preprocess(cfg)
    step = make_train_step(
        model, optimizer, flops_weight=0.0, batch_size=cfg.DATA.BATCH_SIZE,
        compute_dtype=compute_dtype(cfg),
        from_u8=preprocess == "hybrid", mesh=mesh2d,
        image_h=cfg.DATA.IMAGE_H)
    feeds = TrainFeeds(cfg, step, model, device, log,
                       resident_seed=7_777_771, tag="FtEpoch", mesh=mesh2d)
    ft_dir = os.path.join(dirs["base"],
                          f"finetune_checkpoint_epoch{from_epoch}")
    os.makedirs(ft_dir, exist_ok=True)

    best_mae, best_epoch = float("inf"), -1
    epochs = max_epochs if max_epochs is not None else sol.MAX_EPOCHS
    for epoch in range(epochs):
        if sol.ADJUST_STEP and sol.LR_SCHEDULER == "cosine":
            lr = cosine_lr(sol.LR, epoch, sol.MAX_EPOCHS)
        elif sol.ADJUST_STEP:
            lr = multistep_lr(sol.LR, sol.STEPS, epoch)
        else:
            lr = sol.LR
        log(f"lr: {lr}")
        feeds.epoch(epoch, lr, 0.0)
        mae = feeds.validate()
        if (cfg.TEST.ENABLE and cfg.TEST.DATASET_PATH
                and (epoch + 1) >= cfg.TEST.BEGIN
                and (epoch + 1) % cfg.TEST.INTERVAL == 0):
            # in-loop periodic test (reference finetune.py:183-185,304-352):
            # saliency-PNG dumps into finetune_{dataset}_{epoch} every
            # TEST.INTERVAL epochs from TEST.BEGIN, how the reference picks
            # its best finetuned epoch in practice
            from .test import dump_saliency_maps

            log("Start testing.")
            dump_saliency_maps(cfg, model, epoch + 1, log=log,
                               dir_prefix="finetune_", mesh2d=mesh2d)
        if mae < best_mae:
            best_mae, best_epoch = mae, epoch + 1
        log(f" epoch: {epoch + 1} mae: {mae} best_epoch: {best_epoch} "
            f"best_mae: {best_mae}")
        save_checkpoint(
            os.path.join(ft_dir, f"checkpoint_epoch{epoch + 1}.pth.tar"),
            model, optimizer, epoch=epoch + 1, arch=cfg.MODEL.ARCH)
    multihost.barrier("finetuned")
    return {"best_mae": best_mae, "best_epoch": best_epoch, "lc": lc,
            "ft_dir": ft_dir}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="SOD prune + finetune (CSNet) on the card")
    parser.add_argument("--config", required=True, metavar="FILE")
    parser.add_argument("--epoch", required=True, type=int,
                        help="training epoch checkpoint to prune from")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override FINETUNE.SOLVER.MAX_EPOCHS")
    args = parser.parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if not cfg.TASK:
        cfg.TASK = cfg.MODEL.ARCH
    run_finetune(cfg, from_epoch=args.epoch, max_epochs=args.epochs)


if __name__ == "__main__":
    main()
