"""CSNet inference driver (the port of ``cli/test.py``).

Usage: python -m sod100k_tpu_torch.cli.test --config <yml> [--skip-eval]
           [--test_batch N]

Per dataset under TEST.DATASET_PATH: read images/, preprocess per the
reference protocol (fixed TEST.IMAGE_H/W resize or ceil-to-16,
test.py:71-86), run the model on the card, sigmoid, resize the map back to
the native resolution, save uint8 PNGs, then evaluate (eval driver).
TEST.TESTALL sweeps every checkpoint_epoch{N} from TEST.BEGIN; with
CUDA.TEST_RESIDENT the sweep keeps the splits on the card and writes
metrics only.

The resizes are the JAX driver's without cv2: a device-quantized uint8 map
goes back through ``image_io.resize_u8_linear`` (cv2's u8 INTER_LINEAR bit
for bit), an f32 map through ``pipeline.resize_bilinear_np`` and then
*255; ``image_io.write_png`` encodes. The PNG bytes may differ from cv2's,
the decoded pixels do not.

Under data parallelism (one process per card, as ``cli.train``) each
fixed-size batch is split over the ranks and the primary writes every map;
the ceil-to-16 mode runs on the primary alone; the resident sweep splits
its batches over the ranks and every rank logs the whole table.

With CUDA.MESH_SHAPE "DxS" each fixed-size batch splits its rows over the
D data indices and each image's rows over the S spatial indices; the bands
are gathered into whole maps before the PNG writes (the S-measure and
weighted F are not sums over pixels), and the primary writes. The
ceil-to-16 mode still runs on the primary alone. The resident sweep
splits its batches over the D data indices and each image's rows over
the S spatial indices, and every rank logs the whole table.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from ..arch import get_arch
from ..arch.csnet import DEEPEST_STRIDE2_FACTOR
from ..arch.layer_config import LayerConfig
from ..config import get_cfg
from ..data.image_io import resize_u8_linear, write_png
from ..data.pipeline import (_imread_rgb_u8, preprocess_test_image,
                             resize_bilinear_np)
from ..parallel import mesh, multihost
from ..train.step import make_eval_step
from ..utils.profiler import count_params
from .common import (compute_dtype, init_parallel, load_any_checkpoint,
                     model_device)


def run_test(cfg, log=print, *, device: str | torch.device = "cuda") -> dict:
    device, mesh2d = init_parallel(
        cfg, device, log, image_h=cfg.TEST.IMAGE_H,
        stride2_factor=DEEPEST_STRIDE2_FACTOR)
    lc = LayerConfig.load(cfg.TEST.MODEL_CONFIG)
    model = get_arch(cfg.MODEL.ARCH)(lc, device=device)
    epoch, _ = load_any_checkpoint(cfg.TEST.CHECKPOINT, model)
    log(f"=> loaded checkpoint '{cfg.TEST.CHECKPOINT}' (epoch {epoch})")
    log("  + Number of params: %.4fM" % (count_params(model) / 1e6))
    return {"epoch": epoch,
            "datasets": dump_saliency_maps(cfg, model, epoch, log=log,
                                           mesh2d=mesh2d)}


def _save_map(sal_dir: str, name: str, pred: np.ndarray, hw) -> None:
    """One map back at its native size as a uint8 PNG: a device-quantized
    uint8 map resizes in uint8, an f32 map in f32 and then *255."""
    h, w = hw
    if pred.dtype == np.uint8:
        out = resize_u8_linear(pred, (h, w))
    else:
        out = (resize_bilinear_np(pred, (h, w)) * 255).astype(np.uint8)
    write_png(os.path.join(sal_dir, os.path.splitext(name)[0] + ".png"), out)


def dump_saliency_maps(cfg, model: nn.Module, epoch, log=print,
                       dir_prefix: str = "", mesh2d=None) -> dict:
    """Core of the TEST protocol: per dataset under TEST.DATASET_PATH,
    forward + sigmoid + resize-back + uint8 PNG dump into
    {dir_prefix}{dataset}_{epoch}. Used by run_test and by the finetune
    driver's in-loop periodic test (reference finetune.py:183-185,304-352,
    which dumps into finetune_{ds}_{epoch}). Under data parallelism the
    ranks split each fixed-size batch and the primary writes; the
    ceil-to-16 mode runs on the primary alone (its results only there).
    On ``mesh2d`` (by default the world's data mesh) the data indices split
    each fixed-size batch and the spatial indices each image's rows."""
    primary = multihost.is_primary()
    mesh2d = mesh2d or mesh.data_mesh()
    dtype = compute_dtype(cfg)
    device = model_device(model)
    task = cfg.TASK or cfg.MODEL.ARCH
    # fixed-size configs batch images by DATA.BATCH_SIZE; the ceil-to-16
    # native-size mode runs per image like the reference, or in same-shape
    # groups of TEST.BATCH
    fixed = cfg.TEST.IMAGE_H != 0 and cfg.TEST.IMAGE_W != 0
    batch_size = max(cfg.DATA.BATCH_SIZE, 1) if fixed else 1
    native_tb = max(int(cfg.TEST.BATCH or 1), 1) if not fixed else 1
    if fixed and cfg.TEST.BATCH > 1:
        log(f"TEST.BATCH={cfg.TEST.BATCH} applies to the ceil-to-16 mode "
            f"(TEST.IMAGE_H/W = 0) only; fixed-size configs batch by "
            f"DATA.BATCH_SIZE={batch_size}")
    # front-end placement (fixed-size mode only: the ceil-to-16 mode has a
    # per-image output shape, so its resize stays on the host)
    mode = cfg.CUDA.TEST_PREPROCESS if fixed else "host"
    dev_pre, hyb_pre = mode == "device", mode == "hybrid"
    # the uint8 front-ends also quantize the map to uint8 on the card; the
    # host-mode parity path keeps the reference's f32 resize-then-quantize
    quant = dev_pre or hyb_pre
    eval_step = make_eval_step(model, from_u8=hyb_pre, compute_dtype=dtype,
                               quantize_u8=quant,
                               mesh=mesh2d if fixed else None)
    out_hw = (cfg.TEST.IMAGE_H, cfg.TEST.IMAGE_W)
    # the ranks split each fixed-size batch; the ceil-to-16 mode runs
    # whole on the primary, without collectives
    group, rows = None, slice(None)
    if fixed:
        group, rows = mesh2d.data_group, mesh2d.rows(batch_size)
    local_bs = len(range(batch_size)[rows])

    def load(name):
        path = os.path.join(img_dir, name)
        if dev_pre:
            img = _imread_rgb_u8(path)
            return img, img.shape[:2]
        if hyb_pre:  # host resize in uint8; normalization in eval_step
            img = _imread_rgb_u8(path)
            return resize_u8_linear(img, out_hw), img.shape[:2]
        return preprocess_test_image(path, out_hw)

    def forward(loaded) -> torch.Tensor:
        if dev_pre:
            from ..data.device_pipeline import preprocess_infer_batch

            # uint8 upload, resize/normalize on the card; pad to a
            # 64-multiple bucket
            hp = max(-(-max(l[0].shape[0] for l in loaded) // 64) * 64, 64)
            wp = max(-(-max(l[0].shape[1] for l in loaded) // 64) * 64, 64)
            imgs = np.zeros((local_bs, hp, wp, 3), np.uint8)
            hws = np.ones((local_bs, 2), np.int32)
            for i, (im, (h, w)) in enumerate(loaded):
                imgs[i, :h, :w] = im
                hws[i] = (h, w)
            x = preprocess_infer_batch(torch.from_numpy(imgs).to(device),
                                       torch.from_numpy(hws).to(device),
                                       out_hw=out_hw)
            return eval_step(x)
        stack = [l[0] for l in loaded]
        x = np.stack(stack) if hyb_pre else np.concatenate(stack)
        return eval_step(torch.from_numpy(x))

    results = {}
    for dataset in cfg.TEST.DATASETS:
        sal_dir = os.path.join(cfg.DATA.SAVEDIR, task,
                               f"{dir_prefix}{dataset}_{epoch}")
        os.makedirs(sal_dir, exist_ok=True)
        img_dir = os.path.join(cfg.TEST.DATASET_PATH, dataset, "images")
        names = sorted(os.listdir(img_dir))
        t0 = time.time()
        if not fixed and not primary:
            continue
        if native_tb > 1:
            _dump_native_batched(cfg, eval_step, names, img_dir, sal_dir,
                                 tb=native_tb, log=log)
            dt = time.time() - t0
            log(f"Dataset: {dataset}, {len(names)} images, "
                f"{len(names) / dt:.2f} img/s (native batched x{native_tb})")
            results[dataset] = {"n": len(names), "sal_dir": sal_dir,
                                "img_per_sec": len(names) / dt}
            continue

        # one-deep software pipeline: the card computes batch k while the
        # host decodes batch k+1; the readback happens one iteration late
        def flush(pending):
            chunk, hws, dev_preds = pending
            if not primary:
                return
            preds = dev_preds.cpu().numpy()
            for name, hw, pred in zip(chunk, hws.cpu().numpy(), preds):
                _save_map(sal_dir, name, pred[..., 0],
                          (int(hw[0]), int(hw[1])))

        pending = None
        with ThreadPoolExecutor(max_workers=max(cfg.DATA.WORKERS, 1)) as pool:
            for b0 in range(0, len(names), batch_size):
                chunk = names[b0:b0 + batch_size]
                # the trailing partial batch padded with its last image;
                # this rank decodes and runs its rows of the batch
                padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
                loaded = list(pool.map(load, padded[rows]))
                preds = mesh.gather_rows(forward(loaded), group)
                hws = mesh.gather_rows(torch.tensor(
                    [l[1] for l in loaded], dtype=torch.int64,
                    device=preds.device), group)
                if pending is not None:
                    flush(pending)
                pending = (chunk, hws, preds)
            if pending is not None:
                flush(pending)
        dt = time.time() - t0
        log(f"Dataset: {dataset}, {len(names)} images, "
            f"{len(names) / dt:.2f} img/s")
        results[dataset] = {"n": len(names), "sal_dir": sal_dir,
                            "img_per_sec": len(names) / dt}
    multihost.barrier("maps-written")  # readers see every map
    return results


def _dump_native_batched(cfg, eval_step, names, img_dir, sal_dir, *,
                         tb: int, log=print) -> None:
    """Ceil-to-16 native-size protocol, batched (TEST.BATCH, --test_batch).

    Consecutive images whose resized (ceil-to-16, test.py:75-86) shapes
    match are concatenated into one forward; a trailing partial group pads
    by repeating the last image (rows discarded after readback). The PNGs
    equal the per-image loop's where the convolutions do not change their
    arithmetic with the batch size (f32 on the card); on the CPU a map may
    move by one level. The f32 host parity dialect is kept: host normalize
    in, f32 maps out, host resize-back + *255 quantization per image."""
    pending = None  # one-deep pipeline, as the fixed-size loop
    buf: list = []  # [(name, (h, w), img_1hw3_f32)]
    padded_rows = 0  # pad waste: ragged datasets get a warning

    def flush(p):
        group, dev_preds, k = p
        preds = dev_preds.cpu().numpy()[:k]
        for (name, hw, _), pred in zip(group, preds):
            _save_map(sal_dir, name, pred[..., 0], hw)

    def dispatch():
        nonlocal pending, padded_rows
        k = len(buf)
        padded_rows += tb - k
        stack = [b[2] for b in buf] + [buf[-1][2]] * (tb - k)
        preds = eval_step(torch.from_numpy(np.concatenate(stack)))
        if pending is not None:
            flush(pending)
        pending = (list(buf), preds, k)
        buf.clear()

    def load(name):
        img, hw = preprocess_test_image(os.path.join(img_dir, name))
        return name, hw, img

    workers = max(cfg.DATA.WORKERS, 1)
    window = max(tb, workers)  # bounded look-ahead over the decodes
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs: deque = deque()
        idx = 0
        for _ in range(len(names)):
            while idx < len(names) and len(futs) <= window:
                futs.append(pool.submit(load, names[idx]))
                idx += 1
            name, hw, img = futs.popleft().result()
            if buf and buf[0][2].shape != img.shape:
                dispatch()  # shape break: flush the current same-shape run
            buf.append((name, hw, img))
            if len(buf) == tb:
                dispatch()
        if buf:
            dispatch()
        if pending is not None:
            flush(pending)
    total_rows = len(names) + padded_rows
    if total_rows and padded_rows / total_rows > 0.25:
        log(f"test_batch={tb}: {padded_rows}/{total_rows} dispatched rows "
            f"were padding (ragged shapes break same-shape runs); a "
            f"smaller --test_batch will likely be faster on this dataset")


def run_testall_resident(cfg, log=print, *,
                         device: str | torch.device = "cuda") -> dict:
    """Device-resident TESTALL: each TEST.DATASETS split is uploaded once
    (u8 inputs at TEST.IMAGE_H/W + native GTs on a canvas) and every
    checkpoint_epoch{N} is scored there (forward -> native resize-back ->
    PNG-exact quantization -> MAE / 256-threshold P/R/F / E / S / weighted
    F); only metric sums come back. Writes cli.eval-format files under
    distinct "_resident" names (this protocol's u8-resize inputs differ
    sub-1/255 from the reference dialect) and returns the best epoch by
    MaxF per split. No PNG maps. On the run's mesh (CUDA.MESH_SHAPE, or
    the world's data mesh) the data indices split each split's batches and
    the spatial indices each image's rows, every rank logs the whole table
    and the primary writes the files."""
    from ..data.pipeline import SalData
    from ..data.resident import (build_resident_val_dataset,
                                 make_resident_salmetric_fn)
    from ..metrics.salmetric import format_report, result_from_sums

    if not (cfg.TEST.IMAGE_H and cfg.TEST.IMAGE_W):
        raise SystemExit("CUDA.TEST_RESIDENT needs fixed TEST.IMAGE_H/W "
                         "(the ceil-to-16 mode is per-image-shaped)")
    device, mesh2d = init_parallel(
        cfg, device, log, image_h=cfg.TEST.IMAGE_H,
        stride2_factor=DEEPEST_STRIDE2_FACTOR)
    lc = LayerConfig.load(cfg.TEST.MODEL_CONFIG)
    model = get_arch(cfg.MODEL.ARCH)(lc, device=device)
    batch = max(cfg.DATA.BATCH_SIZE, 1)
    in_hw = (cfg.TEST.IMAGE_H, cfg.TEST.IMAGE_W)
    eval_step = make_eval_step(model, from_u8=True,
                               compute_dtype=compute_dtype(cfg), mesh=mesh2d)

    task = cfg.TASK or cfg.MODEL.ARCH
    out_dir = os.path.join(cfg.DATA.SAVEDIR, task)
    ckpt_dir = os.path.join(out_dir, "checkpoint")
    os.makedirs(out_dir, exist_ok=True)

    splits = {}
    for ds in cfg.TEST.DATASETS:
        sd = SalData(os.path.join(cfg.TEST.DATASET_PATH, ds), in_hw,
                     mode="val", cache=cfg.CUDA.DATA_CACHE)
        data = build_resident_val_dataset(
            sd, in_hw, batch, device=device,
            with_wf_tables=cfg.CUDA.RESIDENT_WF,
            wf_budget_bytes=cfg.CUDA.RESIDENT_WF_MAX_MIB * 2**20)
        canvas_hw = data.pop("_canvas_hw")
        wf_skipped = data.pop("_wf_skipped", None)
        if wf_skipped:
            log(f"resident test split {ds}: weighted-F SKIPPED: {wf_skipped}")
        splits[ds] = (data, make_resident_salmetric_fn(
            eval_step, batch_size=batch, canvas_hw=canvas_hw,
            mesh=mesh2d))
        nbytes = sum(v.numel() * v.element_size() for v in data.values())
        log(f"resident test split {ds}: {len(sd)} images "
            f"({nbytes / 2**20:.0f} MiB on {device})")

    best = {ds: {"max_f": 0.0, "epoch": -1} for ds in splits}
    epoch = cfg.TEST.BEGIN
    while True:
        path = os.path.join(ckpt_dir, f"checkpoint_epoch{epoch}.pth.tar")
        if not os.path.isfile(path):
            break
        load_any_checkpoint(path, model)
        for ds, (data, fn) in splits.items():
            res = result_from_sums(fn(data))
            report = (f"epoch {epoch} {ds} [resident]: "
                      f"MaxF {res['max_f']:.6f} MAE {res['mae']:.6f} "
                      f"MeanF {res['mean_f']:.6f} "
                      f"AdpF {res['adaptive_f']:.6f} "
                      f"MaxE {res['max_e']:.6f} "
                      f"MeanE {res['mean_e']:.6f} "
                      f"AdpE {res['adaptive_e']:.6f} "
                      f"S {res['s_measure']:.6f}")
            if "weighted_f" in res:
                report += f" wF {res['weighted_f']:.6f}"
            log(report)
            if multihost.is_primary():
                with open(os.path.join(
                        out_dir, f"FmeasureResults_{ds}_resident.txt"),
                        "a") as flog:
                    flog.write(report + "\n")
                with open(os.path.join(
                        out_dir, f"FmeasureResult_{ds}_{epoch}_resident.txt"),
                        "w") as f:
                    f.write(format_report(res))
            if res["max_f"] > best[ds]["max_f"]:
                best[ds] = {"max_f": res["max_f"], "epoch": epoch}
        epoch += cfg.TEST.INTERVAL
    for ds, b in best.items():
        log(f"best for {ds}: MaxF {b['max_f']:.6f} @ epoch {b['epoch']}")
    return best


def run_testall(cfg, log=print, *,
                device: str | torch.device = "cuda") -> list:
    """TEST.TESTALL protocol: sweep checkpoint_epoch{N} from TEST.BEGIN every
    TEST.INTERVAL epochs (reference test/eval epoch-range traversal)."""
    ckpt_dir = os.path.join(cfg.DATA.SAVEDIR, cfg.TASK or cfg.MODEL.ARCH,
                            "checkpoint")
    results = []
    epoch = cfg.TEST.BEGIN
    while True:
        path = os.path.join(ckpt_dir, f"checkpoint_epoch{epoch}.pth.tar")
        if not os.path.isfile(path):
            break
        c = cfg.clone()
        c.TEST.CHECKPOINT = path
        results.append(run_test(c, log=log, device=device))
        epoch += cfg.TEST.INTERVAL
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="SOD inference (CSNet) on the card")
    parser.add_argument("--config", required=True, metavar="FILE")
    parser.add_argument("--skip-eval", action="store_true")
    parser.add_argument("--test_batch", type=int, default=0, metavar="N",
                        help="ceil-to-16 native-size mode: batch up to N "
                        "consecutive same-resized-shape images per forward "
                        "(the same PNGs; overrides TEST.BATCH). "
                        "Fixed-size configs batch via DATA.BATCH_SIZE.")
    args = parser.parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if args.test_batch:
        cfg.TEST.BATCH = args.test_batch
    if not cfg.TASK:
        cfg.TASK = cfg.MODEL.ARCH
    from .eval import run_eval

    if cfg.TEST.TESTALL:
        if cfg.CUDA.TEST_RESIDENT:
            run_testall_resident(cfg)  # metrics inline; no PNGs, no eval
            return
        runs = run_testall(cfg)
        # the primary scores the maps it wrote (one report, one writer)
        if runs and not args.skip_eval and multihost.is_primary():
            lo = min(r["epoch"] for r in runs)
            hi = max(r["epoch"] for r in runs)
            run_eval(cfg, epoch_range=(lo, hi + 1))
        return
    res = run_test(cfg)
    if not args.skip_eval and multihost.is_primary():
        run_eval(cfg, epoch_range=(res["epoch"], res["epoch"] + 1))


if __name__ == "__main__":
    main()
