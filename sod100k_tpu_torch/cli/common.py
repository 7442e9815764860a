"""Shared driver plumbing: logging tee, checkpoints, the model from the
config, the training feeds and epochs, and validation.

Port of ``cli/common.py`` and of the parts of ``cli/train.py`` and
``cli/finetune.py`` that both training drivers run. Checkpoints are the
reference's ``{'epoch','arch','state_dict','optimizer'}`` .pth.tar files
(``train/checkpoint.py``), so the JAX package, the reference and this
package read each other's weights; the optimizer entry is package-specific.
Architecture snapshots are the reference's pickled layer_config .bin files.

Every function that touches tensors takes the device it runs on; the
drivers pass the card unless a caller (a test) names the CPU.

Parallelism (``parallel/``): every driver calls ``init_data_parallel`` or
``init_parallel`` first, which joins the processes the SOD100K_* variables
(or torchrun's) describe, gives each rank its own card and returns the
run's mesh (``parallel.mesh.Mesh2D``): the W x 1 data mesh of the world,
or the D x S mesh of CUDA.MESH_SHAPE "DxS", the batch over D and each
image's rows over S (``parallel.spatial``), with the JAX drivers' refusals
(``sod100k_tpu``'s ``cli/common.py::data_mesh_for``). Every front-end,
the resident ones included, runs on that mesh. The primary alone writes
logs, architecture snapshots and checkpoints; the others wait at a
barrier before they read what it wrote.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..arch import get_arch
from ..arch.layer_config import LayerConfig, init_layers
from ..data.image_io import resize_f32_linear
from ..data.pipeline import (SalData, batches, device_prefetch,
                             hybrid_batches, raw_batches, require_device)
from ..interop.torch_ckpt import load_checkpoint
from ..parallel import mesh, multihost
from ..train.checkpoint import save_checkpoint
from ..utils.profiler import FLOP_COUNTER, simplesum

PREPROCESS_MODES = ("host", "hybrid", "device", "resident")


def build_mesh_2d(spec: str, flag: str, *, batch_size: int, batch_flag: str,
                  image_h: int = 0, stride2_factor: int = 0,
                  what: str = "model", log=print) -> mesh.Mesh2D:
    """The D x S mesh of ``spec`` over the world that
    ``init_data_parallel`` joined, with the JAX drivers' refusals, each a
    SystemExit naming ``flag``: a malformed shape, a data axis that does
    not divide the batch, the spatial extent check (where ``image_h`` and
    ``stride2_factor`` are known), a world that is not D*S processes, and a
    spatial group across hosts."""
    try:
        d, s = mesh.parse_mesh_shape(spec)
    except ValueError as e:
        raise SystemExit(str(e))
    if batch_size % d:
        raise SystemExit(f"{flag}: data axis {d} must divide "
                         f"{batch_flag}={batch_size}")
    if image_h and stride2_factor:
        try:
            mesh.check_spatial_extent(image_h, stride2_factor, s, what)
        except ValueError as e:
            raise SystemExit(f"{flag}: {e}")
    try:
        m = mesh.make_mesh_2d(d, s)
        multihost.check_mesh_process_layout(m)
    except ValueError as e:
        raise SystemExit(f"{flag}: {e}")
    if d * s > 1:
        log(f"mesh: {d} data x {s} spatial processes")
    return m


def init_parallel(cfg, device, log=print, *, image_h: int,
                  stride2_factor: int):
    """``init_data_parallel``, then the 2-D mesh when CUDA.MESH_SHAPE asks
    for one (DATA.BATCH_SIZE over its data axis, images of ``image_h``
    rows over its spatial axis). Returns (device, the mesh: the data mesh
    without CUDA.MESH_SHAPE)."""
    device, m = init_data_parallel(device, log)
    if cfg.CUDA.MESH_SHAPE:
        m = build_mesh_2d(cfg.CUDA.MESH_SHAPE,
                          f"CUDA.MESH_SHAPE={cfg.CUDA.MESH_SHAPE}",
                          batch_size=max(cfg.DATA.BATCH_SIZE, 1),
                          batch_flag="DATA.BATCH_SIZE", image_h=image_h,
                          stride2_factor=stride2_factor, log=log)
    return device, m


def init_data_parallel(device, log=print) -> tuple[torch.device,
                                                   mesh.Mesh2D]:
    """Join the data-parallel world the environment describes (no-op
    without it; ``parallel.multihost.init_from_env``) before anything
    touches the card. Returns the device this process runs on (its own
    card when the caller asked for the card) and the world's data mesh
    (W x 1; 1 x 1 for a single process)."""
    multihost.init_from_env(log)
    device = require_device(device)
    if device.type == "cuda" and multihost.is_multihost():
        device = mesh.local_device()
    return device, mesh.data_mesh()


class Logger:
    """Tee to stdout + a timestamped log file (reference log_string
    pattern); under data parallelism only the primary keeps the file."""

    def __init__(self, log_dir: str, prefix: str, task: str):
        self._f = None
        if not multihost.is_primary():
            return
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y_%m_%d-%H_%M_%S")
        self.path = os.path.join(log_dir, f"{prefix}_{task}_{stamp}.txt")
        self._f = open(self.path, "w")

    def __call__(self, msg, display: bool = True) -> None:
        if self._f is not None:
            self._f.write(str(msg) + "\n")
            self._f.flush()
        if display:
            print(msg)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def resolve_dirs(cfg) -> dict:
    task = cfg.TASK or cfg.MODEL.ARCH
    base = os.path.join(cfg.DATA.SAVEDIR, task)
    dirs = {
        "task": task,
        "base": base,
        "checkpoint": os.path.join(base, "checkpoint"),
        "layer_configs": os.path.join(base, "layer_configs"),
    }
    for k in ("base", "checkpoint", "layer_configs"):
        os.makedirs(dirs[k], exist_ok=True)
    return dirs


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def compute_dtype(cfg) -> torch.dtype | None:
    """The activations' dtype CUDA.DTYPE asks for: bfloat16, or None for
    the parameters' float32."""
    return torch.bfloat16 if cfg.CUDA.DTYPE == "bfloat16" else None


def build_model_from_cfg(cfg, dirs: dict, log=print, *,
                         device="cuda") -> tuple[LayerConfig, nn.Module]:
    """Reference build_model flow (csnet.py:882-947): predefined pickled arch
    or a fresh init_layers seed with basewidth 20 * AUTO.EXPAND; saves
    layer_config_0.bin (+ _latest) and the epoch-0 init snapshot, then
    prints the params and FLOPs lines (reference train.py:93-96). MODEL.ARCH
    resolves through the architecture registry."""
    build = get_arch(cfg.MODEL.ARCH)
    if cfg.AUTO.PREDEFINE and os.path.isfile(cfg.AUTO.PREDEFINE):
        log("predefine.")
        lc = LayerConfig.load(cfg.AUTO.PREDEFINE)
    else:
        log("init.")
        basewidth = int(round(20 * max(cfg.AUTO.EXPAND, 1.0)))
        if cfg.AUTO.EXPAND > 1:
            log(f"Expand the basewidth from 20 to {basewidth}")
        lc = init_layers(basewidth, cfg.MODEL.BASIC_SPLIT)
    if multihost.is_primary():
        lc.save(os.path.join(dirs["layer_configs"], "layer_config_0.bin"))
        lc.save(os.path.join(dirs["layer_configs"],
                             "layer_config_latest.bin"))

    model = build(lc, device=require_device(device), seed=cfg.CUDA.SEED)
    save_checkpoint(
        os.path.join(dirs["checkpoint"], "checkpoint_init.pth.tar"), model,
        None, epoch=-1, arch="CSNet")
    # every process sees the primary's files before anything reads them
    multihost.barrier("model-built")
    n, flops = simplesum(model, (cfg.DATA.IMAGE_H, cfg.DATA.IMAGE_W, 3))
    log("  + Number of params: %.4fM" % (n / 1e6))
    log("  + Number of FLOPs: %.4fG (%s)" % (flops / 1e9, FLOP_COUNTER))
    return lc, model


def load_any_checkpoint(path: str, model: nn.Module) -> tuple[int, object]:
    """Load a .pth.tar of either package into ``model`` (strictly on the
    weights; a file of the JAX package lacks the BN ``num_batches_tracked``
    counters, which keep the model's values). Returns (epoch, the file's
    optimizer entry or None)."""
    sd, meta = load_checkpoint(path, map_location=model_device(model))
    current = model.state_dict()
    counters = {k: v for k, v in current.items()
                if k not in sd and k.endswith("num_batches_tracked")}
    model.load_state_dict({**counters, **sd}, strict=True)
    return int(meta.get("epoch", 0)), meta.get("optimizer")


def is_torch_optimizer_state(state) -> bool:
    """Whether a checkpoint's optimizer entry is a torch optimizer's (the
    JAX package keeps an optax tree there)."""
    return isinstance(state, dict) and "param_groups" in state


def val_mae(eval_step, dataset, batch_size: int) -> float:
    """Reference val protocol (train.py:250-293): forward at train size,
    per-image bilinear resize back to native GT resolution (cv2's f32
    INTER_LINEAR, ``image_io.resize_f32_linear``), quantize via
    trunc(x*255)/255, L1 against the native-resolution GT."""
    total, count = 0.0, 0
    for batch in batches(dataset, batch_size, shuffle=False, drop_last=False):
        pred = eval_step(torch.from_numpy(batch["image"])).cpu().numpy()
        for i in range(pred.shape[0]):
            h, w = batch["h"][i], batch["w"][i]
            up = resize_f32_linear(pred[i, ..., 0], (h, w))
            q = np.trunc(up * 255.0) / 255.0
            gt = batch["target"][i][..., 0]  # native-resolution GT (ragged)
            total += float(np.abs(q - gt).mean())
            count += 1
    return total / max(count, 1)


def check_preprocess(cfg) -> str:
    mode = cfg.CUDA.PREPROCESS
    if mode not in PREPROCESS_MODES:
        raise SystemExit(f"CUDA.PREPROCESS must be host|hybrid|device|"
                         f"resident, got {mode!r}")
    return mode


class TrainFeeds:
    """The training and validation data of a config on one device, under
    CUDA.PREPROCESS: host, hybrid or device iterators through
    ``device_prefetch``, or (resident) the uint8 store and the val split
    uploaded once. ``epoch`` runs one epoch of ``step``; ``validate``
    scores the model's val MAE (nan without VAL.DIR).

    On a ``mesh`` (``parallel.mesh.Mesh2D``) DATA.BATCH_SIZE is the global
    batch: every rank draws the same global batches and trains on its data
    index's rows and, under a spatial axis, its band of their rows (the
    device and resident front-ends cut the band after their resize,
    ``Mesh2D.cut_bands``). The resident validation splits its batches over
    the data indices; the host one runs every batch on every rank (the
    same number everywhere). Both run each spatial rank on its band
    (``make_eval_step(mesh=...)``)."""

    def __init__(self, cfg, step, model: nn.Module, device, log, *,
                 resident_seed: int, tag: str, mesh=None):
        from ..data.resident import (build_resident_dataset,
                                     build_resident_val_dataset,
                                     make_resident_epoch_fn,
                                     make_resident_val_fn)
        from ..train.step import make_eval_step

        self.cfg, self.step, self.device, self.log = cfg, step, device, log
        self.mesh = mesh
        self.mode = check_preprocess(cfg)
        self.resident_seed, self.tag = resident_seed, tag
        self.hw = (cfg.DATA.IMAGE_H, cfg.DATA.IMAGE_W)
        self.train_ds = SalData(cfg.DATA.DIR, self.hw, mode="train",
                                seed=cfg.CUDA.SEED, cache=cfg.CUDA.DATA_CACHE)
        self.val_ds = (SalData(cfg.VAL.DIR, self.hw, mode="val",
                               cache=cfg.CUDA.DATA_CACHE)
                       if cfg.VAL.DIR else None)
        # validation always scores in f32, whatever CUDA.DTYPE, so the best
        # epoch does not move between preprocess modes
        self.eval_step = make_eval_step(model, mesh=mesh)
        self.resident = self.resident_val = None
        if self.mode != "resident":
            return
        batch = cfg.DATA.BATCH_SIZE
        if len(self.train_ds) < batch:
            raise SystemExit(
                f"CUDA.PREPROCESS=resident needs at least one full batch: "
                f"dataset has {len(self.train_ds)} images < "
                f"DATA.BATCH_SIZE={batch}")
        store = cfg.CUDA.RESIDENT_STORE_HW
        self.resident = build_resident_dataset(self.train_ds, (store, store),
                                               device=device)
        # the reference crops <=15 px at its 224 train size
        # (prepare_data.py:26-88); express that fraction at the store scale
        max_crop = max(1, round(15 * store / 224))
        self.epoch_fn = make_resident_epoch_fn(
            step, batch_size=batch, out_hw=self.hw, max_crop=max_crop,
            mesh=mesh)
        log(f"resident dataset: {len(self.train_ds)} images @{store}px "
            f"uint8 = {_mib(self.resident):.0f} MiB on {device}")
        if self.val_ds is not None:
            vdata = build_resident_val_dataset(self.val_ds, self.hw, batch,
                                               device=device)
            canvas_hw = vdata.pop("_canvas_hw")
            self.resident_val = vdata
            self.val_fn = make_resident_val_fn(
                make_eval_step(model, from_u8=True, mesh=mesh),
                batch_size=batch,
                canvas_hw=canvas_hw, mesh=mesh)
            log(f"resident val set: {len(self.val_ds)} images, native "
                f"canvas {canvas_hw}, {_mib(vdata):.0f} MiB on {device}")

    def _iterator(self, epoch: int):
        cfg = self.cfg
        kw = dict(shuffle=True, seed=cfg.CUDA.SEED + epoch,
                  num_threads=cfg.DATA.WORKERS)
        make = {"device": raw_batches, "hybrid": hybrid_batches,
                "host": batches}[self.mode]
        return make(self.train_ds, cfg.DATA.BATCH_SIZE, **kw)

    def epoch(self, epoch: int, lr: float, penalty_on: float,
              after_step: Callable[[int], None] | None = None
              ) -> tuple[float, float, int]:
        """One epoch; returns (last loss, last penalty, steps). Logs every
        PRINT_FREQ steps; ``after_step(n)`` runs after the n-th step."""
        cfg, log = self.cfg, self.log
        if self.mode == "resident":
            gen = torch.Generator(self.device).manual_seed(
                cfg.CUDA.SEED * self.resident_seed + epoch)
            loss_arr, pen_arr = self.epoch_fn(self.resident, gen, lr,
                                              penalty_on)
            nb = int(loss_arr.shape[0])
            loss, pen = float(loss_arr[-1]), float(pen_arr[-1])
            log(f"{self.tag}: [{epoch + 1}][{nb} steps, resident]\t"
                f"Loss {loss:.4f}\tFakeFLOPs {pen:.3f}")
            if after_step is not None:
                after_step(nb)
            return loss, pen, nb
        from ..data.device_pipeline import (draw_augment_params,
                                            preprocess_train_batch)

        gen = torch.Generator(self.device).manual_seed(
            cfg.CUDA.SEED * 1_000_003 + epoch)
        m2 = self.mesh
        rows = multihost.process_slice(cfg.DATA.BATCH_SIZE, m2)
        nb, m = 0, None
        for batch in device_prefetch(self._iterator(epoch),
                                     device=self.device, mesh=m2,
                                     bands=self.mode != "device"):
            if self.mode == "device":
                # the draws of the global batch, then this rank's rows
                d = draw_augment_params(gen, cfg.DATA.BATCH_SIZE)
                feed = preprocess_train_batch(
                    batch["image_u8"], batch["gt_u8"], batch["valid_hw"],
                    draws={k: v[rows] for k, v in d.items()},
                    out_hw=self.hw)
                if m2 is not None:
                    feed = m2.cut_bands(feed)
            elif self.mode == "hybrid":
                feed = {"image": batch["image_u8"],
                        "target": batch["target_u8"]}
            else:
                feed = {"image": batch["image"], "target": batch["target"]}
            m = self.step(feed, lr, penalty_on)
            nb += 1
            if after_step is not None:
                after_step(nb)
            if nb % cfg.PRINT_FREQ == 0:
                log(f"{self.tag}: [{epoch + 1}][{nb}]\t"
                    f"Loss {float(m['loss']):.4f}\t"
                    f"FakeFLOPs {float(m['penalty']):.3f}")
        if m is None:
            return 0.0, 0.0, 0
        return float(m["loss"]), float(m["penalty"]), nb

    def validate(self) -> float:
        if self.resident_val is not None:
            return float(self.val_fn(self.resident_val))
        if self.val_ds is not None:
            return val_mae(self.eval_step, self.val_ds,
                           self.cfg.DATA.BATCH_SIZE)
        return float("nan")


def _mib(tensors: dict) -> float:
    return sum(t.numel() * t.element_size() for t in tensors.values()
               if isinstance(t, torch.Tensor)) / 2**20


def log_peak_memory(device: torch.device, log) -> None:
    """Per-epoch device-memory print (reference train.py:185-186)."""
    if device.type == "cuda":
        log(f"max memory allocated: "
            f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
