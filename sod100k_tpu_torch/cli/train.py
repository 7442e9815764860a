"""CSNet training driver (the port of ``cli/train.py``).

Usage: python -m sod100k_tpu_torch.cli.train --config <yml> [--epochs N]

Reproduces the reference recipe (train.py:67-181): architecture from AUTO
(init_layers or a predefined pickle), Adam with the dynamic-weight-decay
group split, MultiStepLR stepped at epoch starts, BCE + FLOPs penalty while
epoch < AUTO.FINETUNE, per-epoch val MAE with best-epoch tracking, and
reference-format per-epoch checkpoints, on the card. LOSS.MLOSS is accepted
and has no effect: CSNet returns one map.

On N cards, one process per card: set SOD100K_COORDINATOR=host:port,
SOD100K_NUM_PROCESSES=N and SOD100K_PROCESS_ID in each process, or launch
with ``SOD100K_MULTIHOST=auto torchrun --nproc-per-node N -m
sod100k_tpu_torch.cli.train ...``. DATA.BATCH_SIZE is then the global
batch: each rank trains on its rows, with global-batch BN statistics, and
the primary writes the logs and checkpoints.

With CUDA.MESH_SHAPE "DxS" the D*S processes form a 2-D mesh: the batch
splits over D and each image's rows over S (``parallel.spatial``), e.g.
``SOD100K_MULTIHOST=auto torchrun --nproc-per-node 4 -m
sod100k_tpu_torch.cli.train --config x.yml`` with ``MESH_SHAPE: "2x2"``
under ``CUDA:``. Every front-end runs on it, the resident one
(CUDA.PREPROCESS "resident") included, and so does validation.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..arch.csnet import DEEPEST_STRIDE2_FACTOR
from ..config import get_cfg
from ..interop.torch_ckpt import load_pretrained
from ..parallel import mesh, multihost
from ..train.checkpoint import save_checkpoint
from ..train.optim import make_adam, make_adam_dwd, multistep_lr
from ..train.step import make_train_step
from ..utils.profiler import trace
from .common import (Logger, TrainFeeds, build_model_from_cfg,
                     check_preprocess, compute_dtype, init_parallel,
                     is_torch_optimizer_state, load_any_checkpoint,
                     log_peak_memory, resolve_dirs)


class _FirstSteps:
    """A ``torch.profiler`` trace of an epoch's first ``steps`` steps into
    ``log_dir``; called after each step with the step count."""

    def __init__(self, log_dir: str, steps: int, device, log):
        self.log_dir, self.steps, self.device, self.log = (log_dir, steps,
                                                           device, log)
        self.cm = trace(log_dir)
        self.cm.__enter__()

    def __call__(self, n: int) -> None:
        if n >= self.steps:
            self.close()

    def close(self) -> None:
        if self.cm is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        cm, self.cm = self.cm, None
        cm.__exit__(None, None, None)
        self.log(f"profiler trace written to {self.log_dir}")


def run_training(cfg, max_epochs: int | None = None, log=None, *,
                 device: str | torch.device = "cuda") -> dict:
    device, mesh2d = init_parallel(
        cfg, device, log or print, image_h=cfg.DATA.IMAGE_H,
        stride2_factor=DEEPEST_STRIDE2_FACTOR)
    dirs = resolve_dirs(cfg)
    if log is None:
        log = Logger(dirs["base"], "logtrain", dirs["task"])
    log(cfg, display=False)

    if not cfg.AUTO.ENABLE:
        raise SystemExit("Enable AUTO to train CSNet!")  # train.py:82
    lc, model = build_model_from_cfg(cfg, dirs, log, device=device)
    if cfg.DATA.PRETRAIN:
        load_pretrained(model, cfg.DATA.PRETRAIN)
        log(f"partial-loaded pretrained weights from {cfg.DATA.PRETRAIN}")

    if cfg.SOLVER.METHOD == "Adam_dynamic_weight_decay":
        log("Setting wd of bn in ILBlock to 0.")
        optimizer = make_adam_dwd(model, weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                                  decay_conv3x3_2=cfg.CUDA.WD_QUIRK)
    else:
        optimizer = make_adam(model, weight_decay=cfg.SOLVER.WEIGHT_DECAY)

    start_epoch = 0
    if cfg.DATA.RESUME and os.path.isdir(cfg.DATA.RESUME):
        raise SystemExit(f"DATA.RESUME={cfg.DATA.RESUME} is a directory (an "
                         f"Orbax checkpoint of the JAX package); this "
                         f"package resumes from .pth.tar files only")
    if cfg.DATA.RESUME and os.path.isfile(cfg.DATA.RESUME):
        log(f"=> loading checkpoint '{cfg.DATA.RESUME}'")
        start_epoch, opt_state = load_any_checkpoint(cfg.DATA.RESUME, model)
        if is_torch_optimizer_state(opt_state):
            try:  # torch validates the groups before it changes anything
                optimizer.load_state_dict(opt_state)
            except ValueError as e:
                log(f"optimizer state incompatible ({e}); the optimizer "
                    f"starts fresh")
        else:
            log("optimizer state is not a torch optimizer's (a checkpoint "
                "of the JAX package keeps an optax tree); the model "
                "resumes, the optimizer starts fresh")
        log(f"=> loaded checkpoint (epoch {start_epoch})")

    # rank 0's weights on every rank (all built from one seed and one file)
    mesh.replicate(model, mesh2d.world)
    preprocess = check_preprocess(cfg)
    flops_expand = (cfg.AUTO.FLOPS.EXPAND if cfg.AUTO.FLOPS.EXPAND != -1.0
                    else 2.0)
    step = make_train_step(
        model, optimizer,
        flops_weight=cfg.AUTO.FLOPS.WEIGHT if cfg.AUTO.FLOPS.ENABLE else 0.0,
        flops_expand=flops_expand, batch_size=cfg.DATA.BATCH_SIZE,
        compute_dtype=compute_dtype(cfg),
        from_u8=preprocess == "hybrid", mesh=mesh2d,
        image_h=cfg.DATA.IMAGE_H)
    feeds = TrainFeeds(cfg, step, model, device, log,
                       resident_seed=7_777_777, tag="Epoch", mesh=mesh2d)

    best_mae, best_epoch = float("inf"), -1
    epochs = max_epochs if max_epochs is not None else cfg.SOLVER.MAX_EPOCHS
    history = []
    for epoch in range(start_epoch, epochs):
        t_epoch = time.perf_counter()
        lr = (multistep_lr(cfg.SOLVER.LR, cfg.SOLVER.STEPS, epoch)
              if cfg.SOLVER.ADJUST_STEP else cfg.SOLVER.LR)
        log(f"lr: {lr}")
        if cfg.PRUNE.BNS and cfg.PRUNE.SHOW:
            # BN-gamma observability for the pruning scheme (foo_bns,
            # reference train.py:320-330)
            for name, p in model.named_parameters():
                if ".bns." in name and name.endswith(".weight"):
                    log(f"{name}: {p.detach().cpu().numpy()}", display=False)
        penalty_on = 1.0 if epoch < cfg.AUTO.FINETUNE else 0.0

        tracer = (_FirstSteps(cfg.CUDA.PROFILE_DIR, cfg.CUDA.PROFILE_STEPS,
                              device, log)
                  if cfg.CUDA.PROFILE_DIR and epoch == start_epoch else None)
        try:
            loss, pen, nb = feeds.epoch(epoch, lr, penalty_on, tracer)
        finally:
            if tracer is not None:  # an epoch shorter than PROFILE_STEPS
                tracer.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_secs = time.perf_counter() - t_epoch
        ips = nb * cfg.DATA.BATCH_SIZE / max(epoch_secs, 1e-9)
        log(f"epoch time: {epoch_secs:.1f}s ({ips:.1f} img/s)")
        log_peak_memory(device, log)

        mae = feeds.validate()
        if mae < best_mae:
            best_mae, best_epoch = mae, epoch + 1
        log(f" epoch: {epoch + 1} mae: {mae} best_epoch: {best_epoch} "
            f"best_mae: {best_mae}")
        history.append({"epoch": epoch + 1, "mae": mae, "loss": loss,
                        "secs": epoch_secs, "img_per_sec": ips})
        save_checkpoint(
            os.path.join(dirs["checkpoint"],
                         f"checkpoint_epoch{epoch + 1}.pth.tar"),
            model, optimizer, epoch=epoch + 1, arch=cfg.MODEL.ARCH)
    multihost.barrier("trained")  # the checkpoints exist for every rank
    return {"best_mae": best_mae, "best_epoch": best_epoch, "history": history,
            "lc": lc, "dirs": dirs}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="SOD training (CSNet) on the card")
    parser.add_argument("--config", required=True, metavar="FILE")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override SOLVER.MAX_EPOCHS")
    args = parser.parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if not cfg.TASK:
        cfg.TASK = cfg.MODEL.ARCH
    run_training(cfg, max_epochs=args.epochs)


if __name__ == "__main__":
    main()
