"""CSF+Res2Net driver (the port of ``cli/csf.py``; reference
CSF+Res2Net/main.py).

Usage:
  train: python -m sod100k_tpu_torch.cli.csf --mode train --train_root <dir>
             --train_list <lst> [--arch res2net50|res2net101]
             [--image_size 0|336] [--dtype bfloat16] [--preprocess resident]
  test:  python -m sod100k_tpu_torch.cli.csf --mode test --model <ckpt>
             --test_fold <dir> [--sal_mode e|p|d|h|s|t|m_r] [--test_batch N]

The reference's argparse surface (main.py:54-84) plus the JAX driver's
extras, on one card: --arch selects the backbone depth; --image_size 0
keeps the reference's native-size protocol through shape-bucketed padded
batches (masked-sum loss), any other value trains at that fixed square
size (336 = the Res2Net-101 recipe); --dtype bfloat16 runs the forward and
backward in bf16 (parameters, frozen BN statistics and Adam stay f32);
--remat recomputes the forward in the backward; --preprocess resident
uploads the uint8 dataset to the card once (a fixed --image_size) and
draws each epoch's order and flips there; --test_batch batches
consecutive same-shape test images per forward.

Training runs data-parallel, one process per card, under the SOD100K_*
variables or torchrun's (``parallel.multihost``): --batch_size is the
global batch, each rank trains on its rows and the gradients are summed
over the ranks once per optimizer apply; it needs a fixed --image_size
or --preprocess resident (the native-size buckets are ragged).
--mesh_devices N checks that the world holds N processes (0: any).
--mesh_shape DxS makes the D*S processes a 2-D mesh: the batch over D and
each image's rows over S (``parallel.spatial``), the lever for the
reference's batch-1 x iter_size-10 recipe, where data parallelism alone
cannot use a second card. It needs a fixed --image_size like every
multi-process run, so the JAX driver's per-bucket fallback to a data-only
layout (for bucket heights its extent check refuses) does not arise here.
--preprocess resident runs on the mesh too: every rank holds the whole
store, draws the same order and flips, and trains on its rows and band.

Test mode runs on one process, or across the world: --test_batch
dispatches split over the processes (1-D, --mesh_devices: each rank its
rows), or over a 2-D --mesh_shape (rows over D, each image's rows over S;
an image height the extent check refuses runs whole on each spatial
rank). The primary writes the same PNGs as one process. --preprocess is
a training flag: test mode ignores it, as the JAX driver does.

Solver semantics (solver.py): frozen-BN backbone, Adam 5e-5 with coupled
L2 5e-4 over the trainable parameters, gradients summed over iter_size
micro-steps, lr / 10 after epoch 15 with a new optimizer (fresh moments),
epoch_N.pth every epoch_save epochs and final.pth ({"epoch", "arch",
"state_dict"}, the reference's key names); the test loop writes
<name>_sal_fuse.png at native size and prints the FPS.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..arch.csf_res2net import (DEEPEST_STRIDE2_FACTOR, CSFNet,
                                fetch_res2net_weights, load_res2net_backbone)
from ..data.csf_dataset import (CSFTestData, CSFTrainData,
                                fixed_size_batches, padded_batches)
from ..data.image_io import write_png
from ..data.resident import build_resident_dataset, make_resident_csf_epoch_fn
from ..interop.torch_ckpt import load_checkpoint
from ..parallel import mesh, multihost
from ..train.checkpoint import save_checkpoint
from ..train.csf_step import (CSFTrainStep, freeze_reference_params,
                              make_csf_optimizer)
from ..train.step import make_eval_step
from .common import build_mesh_2d, init_data_parallel, model_device

LR_DECAY_EPOCH = (15,)  # solver.py:24


def get_test_info(sal_mode: str = "e") -> tuple[str, str]:
    table = {
        "e": ("./data/ECSSD/Imgs/", "./data/ECSSD/test.lst"),
        "p": ("./data/PASCALS/Imgs/", "./data/PASCALS/test.lst"),
        "d": ("./data/DUTOMRON/Imgs/", "./data/DUTOMRON/test.lst"),
        "h": ("./data/HKU-IS/Imgs/", "./data/HKU-IS/test.lst"),
        "s": ("./data/SOD/Imgs/", "./data/SOD/test.lst"),
        "t": ("./data/DUTS-TE/Imgs/", "./data/DUTS-TE/test.lst"),
        "m_r": ("./data/MSRA/Imgs_resized/", "./data/MSRA/test_resized.lst"),
    }
    return table[sal_mode]


def _compute_dtype(config) -> torch.dtype | None:
    name = getattr(config, "dtype", "float32") or "float32"
    return None if name == "float32" else getattr(torch, name)


def _merge_checkpoint(model: CSFNet, path: str) -> None:
    """Overlay a .pth of either package onto ``model``: what the file
    holds replaces the model's value, the rest keeps it (the JAX driver's
    ``merge``, strict=False)."""
    state, _ = load_checkpoint(path, map_location=model_device(model))
    model.load_state_dict(state, strict=False)


def _load_params(config, log=print, *, device) -> CSFNet:
    """The seeded CSFNet with its weights from --load (merged), else the
    --pretrained_model backbone (a missing file is refused), else the
    published ImageNet backbone when it can be downloaded; offline, a
    WARNING and the seeded init."""
    model = CSFNet(config.arch, device=device)
    if config.load:
        _merge_checkpoint(model, config.load)
    elif config.pretrained_model:
        # an explicitly given path must exist: training from the random
        # init after a typo would waste the whole run
        if not os.path.isfile(config.pretrained_model):
            raise SystemExit(
                f"--pretrained_model not found: {config.pretrained_model}")
        load_res2net_backbone(model, config.pretrained_model)
    else:
        path = fetch_res2net_weights(config.arch)
        if path is not None:
            load_res2net_backbone(model, path)
            log(f"loaded ImageNet backbone weights from {path}")
        else:
            log("WARNING: no --pretrained_model and the published "
                f"{config.arch} weights are unreachable (offline?); "
                "training from random backbone init")
    return model


def _epoch_batches(dataset: CSFTrainData, config, epoch: int):
    """The host feed of one epoch: fixed-size batches at --image_size, or
    shape-bucketed padded batches with a pixel mask at 0; the order is
    shuffled with ``seed=epoch``."""
    if config.image_size:
        return fixed_size_batches(dataset, config.batch_size,
                                  (config.image_size, config.image_size),
                                  seed=epoch)
    return padded_batches(dataset, config.batch_size, seed=epoch)


def _mesh_shape(config) -> str:
    return getattr(config, "mesh_shape", "") or ""


def _csf_mesh(config, *, batch_size: int, batch_flag: str, image_h: int = 0,
              log=print) -> mesh.Mesh2D:
    """The mesh a CSF run splits over: the 2-D --mesh_shape, else the data
    mesh of the world (W x 1; 1 x 1 for one process), whose size
    --mesh_devices, when given, must be (JAX ``cli/csf.py:178-188``).
    ``batch_size`` divides over the data axis; ``image_h`` (train mode)
    takes the spatial extent check."""
    spec = _mesh_shape(config)
    flag = f"--mesh_shape {spec}"
    if not spec:
        world = mesh.world_size()
        want = getattr(config, "mesh_devices", 0) or 0
        if want and want != world:
            raise SystemExit(
                f"--mesh_devices {want}: the data-parallel world holds "
                f"{world} process(es), one per card (check the SOD100K_* "
                f"variables or torchrun's --nproc-per-node)")
        spec, flag = f"{world}x1", f"--mesh_devices {world}"
    return build_mesh_2d(spec, flag, batch_size=batch_size,
                         batch_flag=batch_flag, image_h=image_h,
                         stride2_factor=DEEPEST_STRIDE2_FACTOR, what="CSF",
                         log=log)


def run_csf_train(config, log=print, *,
                  device: str | torch.device = "cuda") -> dict:
    spec = _mesh_shape(config)
    resident = getattr(config, "preprocess", "host") == "resident"
    device, _ = init_data_parallel(device, log)
    mesh2d = _csf_mesh(config, batch_size=config.batch_size,
                       batch_flag="--batch_size", image_h=config.image_size,
                       log=log)
    group = mesh2d.world
    # the native-size bucketed batches are ragged per bucket: they cannot
    # be cut into rows or bands (resident epochs draw fixed-size batches)
    if not config.image_size and (spec or (group and not resident)):
        what = f"--mesh_shape {spec}" if spec else "multi-host CSF training"
        raise SystemExit(
            f"{what} needs a fixed --image_size (the native-size bucketed "
            f"batches are ragged per bucket and cannot be sliced across "
            f"processes)")
    run = 0
    while os.path.exists(os.path.join(config.save_folder, f"run-{run}")):
        run += 1
    # every process lists the same runs and agrees on N at the barrier,
    # then the primary alone creates the directory
    multihost.barrier("csf-run-chosen")
    save_folder = os.path.join(config.save_folder, f"run-{run}")
    if multihost.is_primary():
        os.makedirs(os.path.join(save_folder, "models"))
    multihost.barrier("csf-run-made")

    model = mesh.replicate(_load_params(config, log, device=device), group)
    freeze_reference_params(model)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log(f"The number of trainable parameters: {n_params}")
    compute_dtype = _compute_dtype(config)
    if compute_dtype is not None:
        log(f"mixed-precision compute: {config.dtype}")
    step = CSFTrainStep(model, make_csf_optimizer(model, config.wd),
                        iter_size=config.iter_size,
                        batch_size=config.batch_size,
                        compute_dtype=compute_dtype,
                        remat=getattr(config, "remat", False),
                        mesh=mesh2d, image_h=config.image_size)
    dataset = CSFTrainData(config.train_root, config.train_list)

    if resident:
        if not config.image_size:
            raise SystemExit("--preprocess resident needs a fixed "
                             "--image_size (e.g. 336)")
        if len(dataset) < config.batch_size:
            # no full batch: every epoch would run zero steps and still
            # write checkpoints
            raise SystemExit(
                f"--preprocess resident needs at least one full batch: "
                f"dataset has {len(dataset)} images < --batch_size "
                f"{config.batch_size}")
        rdata = build_resident_dataset(
            dataset, store_hw=(config.image_size, config.image_size),
            device=device)
        nbytes = sum(v.nbytes for v in rdata.values())
        log(f"resident CSF dataset: {len(dataset)} images at "
            f"{config.image_size}^2 = {nbytes / 2**20:.0f} MiB on "
            f"{device.type}")
        epoch_fn = make_resident_csf_epoch_fn(
            step, batch_size=config.batch_size, mesh=mesh2d)

    def save(name: str, epoch: int) -> None:
        save_checkpoint(os.path.join(save_folder, "models", name), model,
                        None, epoch=epoch, arch=f"csf_{config.arch}")

    lr = config.lr
    losses = []
    show = max(config.show_every // config.batch_size, 1)

    def report(epoch: int, i: int, r_loss: float) -> None:
        log(f"epoch: [{epoch}/{config.epoch}] iter [{i}] || "
            f"Sal : {r_loss:.4f}  lr {lr}")
        losses.append(r_loss)

    for epoch in range(config.epoch):
        t0 = time.time()
        if resident:
            gen = torch.Generator(device=device).manual_seed(epoch)
            ep_losses = mesh.all_reduce_sum(
                {"loss": epoch_fn(rdata, gen, lr)}, group)["loss"]
            ep_losses = ep_losses.cpu().numpy()
            micro = ep_losses.shape[0]
            images = micro * config.batch_size
            for i in range(show, micro + 1, show):
                report(epoch, i, float(ep_losses[i - show:i].sum()))
        else:
            pending = []  # device loss scalars, read at the show boundary
            micro = images = 0
            for batch in _epoch_batches(dataset, config, epoch):
                images += batch["image"].shape[0]
                pending.append(step(multihost.local_slice_feed(
                    batch, mesh=mesh2d), lr)["loss"])
                micro += 1
                if micro % show == 0:
                    # the ranks' shares summed: the global batch's loss
                    r_loss = mesh.all_reduce_sum(
                        {"loss": torch.stack(pending).sum()}, group)["loss"]
                    report(epoch, micro, float(r_loss))
                    pending.clear()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        dt = time.time() - t0
        log(f"epoch {epoch} time: {dt:.2f}s ({micro} micro-steps, "
            f"{images / dt:.1f} img/s)")
        if (epoch + 1) % config.epoch_save == 0:
            save(f"epoch_{epoch + 1}.pth", epoch + 1)
        if epoch in LR_DECAY_EPOCH:
            lr = lr * 0.1
            step.restart_optimizer()  # the reference re-creates Adam
    save("final.pth", config.epoch)
    multihost.barrier("csf-trained")
    return {"save_folder": save_folder, "losses": losses}


def _to_host(preds: torch.Tensor):
    """Start the copy of a batch's uint8 maps to the host: on the card
    into pinned memory behind an event, so that waiting for this batch
    does not wait for the next one's forward."""
    if preds.device.type != "cuda":
        return preds, None
    host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
    host.copy_(preds, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def run_csf_test(config, log=print, *,
                 device: str | torch.device = "cuda") -> dict:
    if not config.model or not config.test_fold:
        raise SystemExit("--mode test needs --model and --test_fold")
    multihost.init_from_env(log)
    # --test_batch > 1: consecutive same-shape images share a forward; a
    # trailing partial batch is padded with its last image, whose extra
    # maps are dropped
    tb = max(getattr(config, "test_batch", 1) or 1, 1)
    m = _csf_mesh(config, batch_size=tb, batch_flag="--test_batch", log=log)
    device, _ = init_data_parallel(device, log)
    model = CSFNet(config.arch, device=device)
    _merge_checkpoint(model, config.model)
    # u8 in, u8 out: raw pixels in (normalized on the device), trunc(
    # sigmoid * 255) out, which is the reference's (255 * sigmoid).astype(
    # uint8) since the map is written at native size
    kw = dict(from_u8=True, quantize_u8=True,
              compute_dtype=_compute_dtype(config))
    whole_step = make_eval_step(model, **kw)
    band_step = (make_eval_step(model, mesh=m, **kw)
                 if m.spatial > 1 else None)
    rows = m.rows(tb)
    whole_heights = set()  # heights the extent check keeps whole

    def eval_step(x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the dispatch, on its band where the height
        passes the extent check; every row back on every rank."""
        step = whole_step
        if band_step is not None:
            try:
                mesh.check_spatial_extent(x.shape[1], DEEPEST_STRIDE2_FACTOR,
                                          m.spatial, "CSF")
                step = band_step
            except ValueError as e:
                if x.shape[1] not in whole_heights:
                    whole_heights.add(x.shape[1])
                    log(f"--mesh_shape {m.shape}: images of height "
                        f"{x.shape[1]} run whole on each of the {m.spatial} "
                        f"spatial ranks ({e})")
        return mesh.gather_rows(step(x[rows]), m.data_group)

    dataset = CSFTestData(config.test_root, config.test_list)
    primary = multihost.is_primary()
    if primary:
        os.makedirs(config.test_fold, exist_ok=True)
    t0 = time.time()

    # one-deep pipeline: batch k's readback and PNG writes run while the
    # card computes batch k+1, which was decoded while it computed batch k
    def flush(pending) -> None:
        names, (host, done), k = pending
        if done is not None:
            done.synchronize()
        if not primary:
            return
        for name, out in zip(names, host.numpy()[:k, ..., 0]):
            name = os.path.splitext(os.path.basename(name))[0]
            write_png(os.path.join(config.test_fold, name + "_sal_fuse.png"),
                      out)

    pending = None
    buf_names: list = []
    buf_imgs: list = []

    def dispatch() -> None:
        nonlocal pending
        k = len(buf_imgs)
        stack = buf_imgs + [buf_imgs[-1]] * (tb - k)
        preds = _to_host(eval_step(torch.from_numpy(np.stack(stack))))
        if pending is not None:
            flush(pending)
        pending = (list(buf_names), preds, k)
        buf_names.clear()
        buf_imgs.clear()

    for i in range(len(dataset)):
        s = dataset.get_u8(i)
        if buf_imgs and buf_imgs[0].shape != s["image"].shape:
            dispatch()  # shape break: the current same-shape run goes
        buf_names.append(s["name"])
        buf_imgs.append(s["image"])
        if len(buf_imgs) == tb:
            dispatch()
    if buf_imgs:
        dispatch()
    if pending is not None:
        flush(pending)
    multihost.barrier("csf-maps-written")  # readers see every map
    dt = time.time() - t0
    log("Speed: %f FPS" % (len(dataset) / dt))
    log("Test Done!")
    return {"fps": len(dataset) / dt, "n": len(dataset)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="CSF+Res2Net training and test on the card")
    parser.add_argument("--n_color", type=int, default=3)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--wd", type=float, default=5e-4)
    parser.add_argument("--pretrained_model", type=str, default="")
    parser.add_argument("--epoch", type=int, default=24)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_thread", type=int, default=1)
    parser.add_argument("--load", type=str, default="")
    parser.add_argument("--save_folder", type=str, default="./results")
    parser.add_argument("--epoch_save", type=int, default=3)
    parser.add_argument("--iter_size", type=int, default=10)
    parser.add_argument("--show_every", type=int, default=50)
    parser.add_argument("--train_root", type=str, default="")
    parser.add_argument("--train_list", type=str, default="")
    parser.add_argument("--model", type=str, default=None)
    parser.add_argument("--test_fold", type=str, default=None)
    parser.add_argument("--sal_mode", type=str, default="e")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "test"])
    parser.add_argument("--arch", type=str, default="res2net50",
                        choices=["res2net50", "res2net101"])
    parser.add_argument("--image_size", type=int, default=0,
                        help="0 = native-size bucketed batches; else fixed "
                             "square size (336 for the res2net101 recipe)")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype for forward/backward; params, "
                             "frozen BN state and optimizer stay float32 "
                             "(the CSNet driver's CUDA.DTYPE equivalent)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the forward's activations in the "
                             "backward (torch.utils.checkpoint): less peak "
                             "memory, identical gradients")
    parser.add_argument("--test_batch", type=int, default=1,
                        help="test-mode batch size: >1 batches consecutive "
                             "same-shape images per forward (meant for "
                             "uniform-size lists like --sal_mode m_r)")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="the number of data-parallel processes (one "
                             "per card) the run expects; 0 = whatever the "
                             "SOD100K_* or torchrun variables launched")
    parser.add_argument("--mesh_shape", type=str, default="",
                        help="DxS: a 2-D mesh of D*S processes, the batch "
                             "(--batch_size, --test_batch) over D and each "
                             "image's rows over S; training needs a fixed "
                             "--image_size")
    parser.add_argument("--preprocess", type=str, default="host",
                        choices=["host", "resident"],
                        help="resident = upload the uint8 dataset to the "
                             "card once (needs a fixed --image_size) and "
                             "draw each epoch's order and flips there "
                             "(CUDA.PREPROCESS=resident equivalent)")
    return parser


def main(argv=None) -> None:
    config = build_parser().parse_args(argv)
    os.makedirs(config.save_folder, exist_ok=True)
    config.test_root, config.test_list = get_test_info(config.sal_mode)
    if config.mode == "train":
        run_csf_train(config)
    else:
        run_csf_test(config)


if __name__ == "__main__":
    main()
