"""The secondary benchmarks on one card (the port of
``tools/bench_extras.py``).

    python -m sod100k_tpu_torch.tools.bench_extras [--skip-e2e]
        [--skip-e2e-train] [--skip-e2e-test] [--skip-csf] [--skip-step]
        [--skip-latency] [--skip-serving] [--skip-val] [--data-dir DIR]
        [--out FILE] [--device cpu]

``tools.bench`` stays the one-line headline; this tool measures the other
rows, in the JAX tool's order and under its metric names:

- the serving artifact's forward, CSNet-L-x2 at 224^2, bf16, B=128;
- B=1 latency (CSNet-L-x2 at 224^2, CSF+Res2Net-50 at 336^2) and the
  batched CSF forwards (Res2Net-50 and -101, B=32), bf16;
- the CSNet-L-x2 train step (the dynamic-weight-decay recipe) in f32 at
  B=128 and B=24 and in bf16 at B=128, with the peak card memory;
- the CSF micro-step (Res2Net-50: f32 B=1 and B=8, bf16 B=8 and B=32;
  Res2Net-101: bf16 B=8) and the resident CSF epoch (bf16, B=8, 256
  images at 336^2);
- resident validation and the resident TESTALL sweep (bf16, B=128, 512
  images of 300x400 / 400x300);
- end to end: ``cli.train``'s second epoch for each ``CUDA.PREPROCESS``
  (hybrid, device, host, resident at the recipe's f32 B=24; hybrid,
  device, resident at bf16 B=128), ``cli.test`` for each
  ``CUDA.TEST_PREPROCESS`` (bf16, B=128) and the ceil-to-16 native
  protocol at ``--test_batch`` 1 and 16, and ``cli.csf`` test mode at 336^2
  at ``--test_batch`` 1 and 16.

Forwards are timed as K chained calls (``timing.chain_ms``), steps and
epochs as K calls of a step that carries its state (``timing.calls_ms``),
the resident evaluations as whole calls read back to the host. Every row
names its timing's card (the file's ``device`` and ``power_limit``).

Weights: seeded, with CSNet's BN statistics calibrated on one seeded batch
(fresh x100 weights explode or die in eval mode). The JAX tool skips the
``cli.test`` rows without the shipped checkpoint; here they run on a
seeded, calibrated CSNet-L checkpoint written in the reference format, and
say so (``"weights": "seeded"``). The synthetic DUTS-TR and test splits are
PNG (``data/synth.py``): the card's machine has no JPEG encoder.

Every size the JAX tool fixes is a keyword argument of its entry with the
JAX value as default, so the tests run each entry small on the CPU; the
metric names are the JAX tool's text at any size (where the JAX tool
writes a size into a name as a literal, so does this one; the rows carry
``hw`` and, there, ``batch``).
The merged JSON goes to ``--out`` (default: ``bench_extras.json`` beside
this module), merged by metric name with the rows of an earlier run on the
same card; the fresh entries go to stdout as one JSON list, last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..arch.csf_res2net import CSFNet
from ..arch.csnet import CSNet
from ..arch.layer_config import init_layers
from ..data.pipeline import require_device
from . import timing
from .bench import random_images, seeded_csnet

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "bench_extras.json")
CSNET_HW = 224
CSF_HW = 336


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _quiet(*args, **kwargs) -> None:
    pass


def _bf16_step(model):
    from ..train.step import make_eval_step

    return make_eval_step(model, compute_dtype=torch.bfloat16)


def free_card(device) -> None:
    """Give the allocator's cached blocks back and restart the peak count
    (before each train row, whose peak is its own)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device) -> float | None:
    """The card's peak allocated GiB since ``free_card``; None on the
    CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**30, 3)


def bench_serving_artifact(entries: list, *, device, batch: int = 128,
                           hw: int = CSNET_HW, width: int = 40,
                           k: int = 20) -> None:
    """The serving artifact's forward (the deployment path: the state dict
    and layer config that ``serve.export_artifact`` writes, loaded by
    ``serve.load_artifact``) at its bucket, bf16, chained."""
    from ..serve import export_artifact, load_artifact
    from ..train.step import make_eval_step

    model = seeded_csnet(device, width=width, hw=hw)
    with tempfile.TemporaryDirectory() as td:
        art = export_artifact(os.path.join(td, "art"), model, batch=batch,
                              hw=(hw, hw), dtype=torch.bfloat16)
        sm = load_artifact(art, device)
    del model
    step = make_eval_step(sm.model, compute_dtype=torch.bfloat16)
    ms = timing.chain_ms(step, random_images(5, batch, hw, device), k)
    ips = batch / (ms * 1e-3)
    _log(f"# serving artifact bf16 B={batch}: {ms:.2f} ms/batch = "
         f"{ips:.0f} img/s")
    entries.append({
        "metric": "csnet_l_x2_224_serving_artifact_img_per_sec[bf16,B=128]",
        "value": round(ips, 1), "unit": "images/sec", "hw": hw,
        "batch": batch, "weights": "seeded"})


def bench_inference_latency(entries: list, *, device, hw: int = CSNET_HW,
                            csf_hw: int = CSF_HW, width: int = 40,
                            csf_batch: int = 32, k: int = 50,
                            k_csf: int = 25, k_batch: int = 20) -> None:
    """B=1 latency of CSNet-L-x2 and CSF+Res2Net-50 (the reference's FPS
    protocol is per image, solver.py:76-77) and the batched CSF forwards of
    both backbones, bf16, chained."""
    model = seeded_csnet(device, width=width, hw=hw)
    ms = timing.chain_ms(_bf16_step(model), random_images(2, 1, hw, device), k)
    del model
    _log(f"# csnet B=1 {hw} bf16 latency: {ms:.3f} ms "
         f"({1e3 / ms:.0f} img/s serial)")
    entries.append({"metric": "csnet_l_x2_224_infer_latency_ms[bf16,B=1]",
                    "value": round(ms, 3), "unit": "ms", "hw": hw,
                    "weights": "seeded"})

    csf = CSFNet("res2net50", seed=3, device=device)
    ms = timing.chain_ms(_bf16_step(csf), random_images(3, 1, csf_hw, device),
                         k_csf)
    _log(f"# csf_res2net50 B=1 {csf_hw} bf16 latency: {ms:.3f} ms "
         f"({1e3 / ms:.0f} FPS)")
    entries.append({"metric": "csf_res2net50_336_infer_latency_ms[bf16,B=1]",
                    "value": round(ms, 3), "unit": "ms", "hw": csf_hw})

    xb = random_images(4, csf_batch, csf_hw, device)
    for arch in ("res2net50", "res2net101"):
        if arch != "res2net50":
            csf = CSFNet(arch, seed=3, device=device)
        ms = timing.chain_ms(_bf16_step(csf), xb, k_batch)
        del csf
        ips = csf_batch / (ms * 1e-3)
        _log(f"# csf_{arch} B={csf_batch} {csf_hw} bf16: {ms:.2f} ms/batch "
             f"({ips:.0f} img/s)")
        entries.append({
            "metric": f"csf_{arch}_336_infer_img_per_sec[bf16,B=32]",
            "value": round(ips, 1), "unit": "images/sec", "hw": csf_hw,
            "batch": csf_batch})


def random_batch(batch: int, hw: int, device) -> dict:
    """A train batch: standard-normal images, 0/1 targets."""
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.standard_normal(
                (batch, hw, hw, 3), dtype=np.float32)).to(device),
            "target": torch.from_numpy((rng.random(
                (batch, hw, hw, 1)) > 0.5).astype(np.float32)).to(device)}


def bench_csnet_train_steps(entries: list, *, device, hw: int = CSNET_HW,
                            width: int = 40, k: int = 8,
                            plans=((128, "f32"), (24, "f32"),
                                   (128, "bf16"))) -> None:
    """The CSNet-L-x2 train step with the dynamic-weight-decay penalty
    (Adam-dwd, weight decay 5e-3, flops weight 3.0, expand 2.0), and its
    peak card memory."""
    from ..train.optim import make_adam_dwd
    from ..train.step import make_train_step

    for batch_size, dtype_name in plans:
        free_card(device)
        model = CSNet(init_layers(width, [0.5, 0.5]), seed=0, device=device)
        step = make_train_step(
            model, make_adam_dwd(model, weight_decay=5e-3), flops_weight=3.0,
            flops_expand=2.0, batch_size=batch_size,
            compute_dtype=torch.bfloat16 if dtype_name == "bf16" else None)
        batch = random_batch(batch_size, hw, device)
        ms = timing.calls_ms(lambda: step(batch, 1e-4, 1.0), device, k)
        peak = peak_gib(device)
        del model, step, batch
        ips = batch_size / (ms * 1e-3)
        _log(f"# csnet train step {dtype_name} B={batch_size}: {ms:.1f} "
             f"ms/step = {ips:.0f} img/s, peak {peak} GiB")
        entries.append({
            "metric": f"csnet_l_x2_224_train_step_img_per_sec[{dtype_name},B={batch_size}]",
            "value": round(ips, 1), "unit": "images/sec", "hw": hw,
            "peak_mem_gib": peak, **_tf32(dtype_name == "f32")})


def _tf32(f32: bool) -> dict:
    """An f32 row says whether cuDNN ran its convolutions in TF32
    (PyTorch's default; the f32 parity gates turn it off)."""
    return {"tf32": torch.backends.cudnn.allow_tf32} if f32 else {}


def csf_train_step(arch: str, batch_size: int, device, dtype=None, seed: int = 1,
              remat: bool = False):
    from ..train.csf_step import (CSFTrainStep, freeze_reference_params,
                                  make_csf_optimizer)

    model = CSFNet(arch, seed=seed, device=device)
    freeze_reference_params(model)
    return CSFTrainStep(model, make_csf_optimizer(model), iter_size=10,
                        batch_size=batch_size, compute_dtype=dtype,
                        remat=remat)


def bench_csf_steps(entries: list, *, device, hw: int = CSF_HW, k: int = 4,
                    plans=(("res2net50", ((1, "f32"), (8, "f32"),
                                          (8, "bf16"), (32, "bf16"))),
                           ("res2net101", ((8, "bf16"),)))) -> None:
    """The CSF micro-step (iter_size 10, the reference Solver's), and its
    peak card memory."""
    for arch, combos in plans:
        for batch_size, dtype_name in combos:
            free_card(device)
            step = csf_train_step(arch, batch_size, device,
                             torch.bfloat16 if dtype_name == "bf16" else None)
            batch = random_batch(batch_size, hw, device)
            ms = timing.calls_ms(lambda: step(batch, 5e-5), device, k)
            peak = peak_gib(device)
            del step, batch
            _log(f"# csf_{arch} {hw} train micro-step {dtype_name} "
                 f"B={batch_size}: {ms:.1f} ms "
                 f"({batch_size / (ms * 1e-3):.1f} img/s), peak {peak} GiB")
            suffix = f"[B={batch_size}]" if dtype_name == "f32" \
                else f"[{dtype_name},B={batch_size}]"
            entries.append({
                "metric": f"csf_{arch}_336_train_microstep_ms{suffix}",
                "value": round(ms, 2), "unit": "ms", "hw": hw,
                "peak_mem_gib": peak, **_tf32(dtype_name == "f32")})


def bench_csf_resident_epoch(entries: list, *, device, n: int = 256,
                             batch_size: int = 8, hw: int = CSF_HW,
                             k: int = 2) -> None:
    """A resident CSF epoch (``cli.csf --preprocess resident --dtype
    bfloat16``): the uint8 store on the card, each epoch's order and flips
    drawn there."""
    from ..data.resident import make_resident_csf_epoch_fn

    free_card(device)
    rng = np.random.default_rng(9)
    rdata = {"image_u8": torch.from_numpy(rng.integers(
                 0, 255, (n, hw, hw, 3), dtype=np.uint8)).to(device),
             "gt_u8": torch.from_numpy(rng.integers(
                 0, 255, (n, hw, hw), dtype=np.uint8)).to(device)}
    step = csf_train_step("res2net50", batch_size, device, torch.bfloat16)
    epoch_fn = make_resident_csf_epoch_fn(step, batch_size=batch_size)
    gen = torch.Generator(device=device).manual_seed(0)
    ms = timing.calls_ms(lambda: epoch_fn(rdata, gen, 5e-5), device, k)
    peak = peak_gib(device)
    del step, rdata
    ips = (n // batch_size) * batch_size / (ms * 1e-3)
    _log(f"# csf resident epoch bf16 B={batch_size} (n={n} @{hw}): "
         f"{ms:.0f} ms/epoch = {ips:.1f} img/s")
    entries.append({
        "metric": f"csf_res2net50_336_resident_train_img_per_sec[bf16,B={batch_size}]",
        "value": round(ips, 1), "unit": "images/sec", "hw": hw,
        "peak_mem_gib": peak})


class SynthVal:
    """A DUTS-shaped val split without disk IO: noise images and GTs, the
    orientation alternating (``hw`` then its transpose)."""

    def __init__(self, n: int, seed: int, hw=(300, 400)):
        self.n, self.hw = n, hw
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n

    def _decode_u8(self, i: int):
        h, w = self.hw if i % 2 else self.hw[::-1]
        return (self.rng.integers(0, 255, (h, w, 3), np.uint8),
                self.rng.integers(0, 255, (h, w), np.uint8))


def _resident_eval(kind: str, *, device, n: int, batch: int, hw: int,
                   width: int, native_hw, seed: int):
    """(ms of one whole call read back to the host, the canvas)."""
    from ..data.resident import (build_resident_val_dataset,
                                 make_resident_salmetric_fn,
                                 make_resident_val_fn)
    from ..metrics.salmetric import result_from_sums
    from ..train.step import make_eval_step

    model = seeded_csnet(device, width=width, hw=hw)
    data = build_resident_val_dataset(SynthVal(n, seed, native_hw), (hw, hw),
                                      batch, device=device)
    canvas = data.pop("_canvas_hw")
    step = make_eval_step(model, from_u8=True, compute_dtype=torch.bfloat16)
    if kind == "val":
        fn = make_resident_val_fn(step, batch_size=batch, canvas_hw=canvas)
        run = lambda: float(fn(data))  # noqa: E731
    else:
        fn = make_resident_salmetric_fn(step, batch_size=batch,
                                        canvas_hw=canvas)
        run = lambda: result_from_sums(fn(data))  # noqa: E731
    run()  # warm
    return timing.best_ms(run, device), canvas


def bench_resident_val(entries: list, *, device, n: int = 512,
                       batch: int = 128, hw: int = CSNET_HW, width: int = 40,
                       native_hw=(300, 400)) -> None:
    """Resident validation (``cli.train``'s per-epoch val under
    ``CUDA.PREPROCESS: resident``): the forward, the per-image resize back
    to native size and the quantized L1, the whole split per call."""
    ms, canvas = _resident_eval("val", device=device, n=n, batch=batch,
                                hw=hw, width=width, native_hw=native_hw,
                                seed=11)
    _log(f"# resident val ({n} imgs, canvas {canvas}, bf16 B={batch}): "
         f"{ms:.0f} ms = {n / (ms * 1e-3):.0f} img/s")
    entries.append({
        "metric": f"csnet_l_x2_resident_val_img_per_sec[bf16,B={batch},n={n}]",
        "value": round(n / (ms * 1e-3), 1), "unit": "images/sec", "hw": hw})


def bench_resident_testall(entries: list, *, device, n: int = 512,
                           batch: int = 128, hw: int = CSNET_HW,
                           width: int = 40, native_hw=(300, 400)) -> None:
    """The resident TESTALL sweep (``CUDA.TEST_RESIDENT``): the forward,
    resize back, PNG-exact quantization and the metric suite (MAE, P/R, F,
    E, S) per checkpoint, the sums reduced on the host."""
    ms, canvas = _resident_eval("testall", device=device, n=n, batch=batch,
                                hw=hw, width=width, native_hw=native_hw,
                                seed=13)
    _log(f"# resident testall ({n} imgs, canvas {canvas}, bf16 B={batch}): "
         f"{ms:.0f} ms/checkpoint = {n / (ms * 1e-3):.0f} img/s")
    entries.append({
        "metric": f"csnet_l_x2_resident_testall_img_per_sec[bf16,B={batch},n={n}]",
        "value": round(n / (ms * 1e-3), 1), "unit": "images/sec", "hw": hw})


def make_synth_duts(root: str, n: int = 512, hw=(400, 300)) -> str:
    """A DUTS-TR-shaped synthetic split: 300x400 / 400x300 PNG images and
    GTs."""
    from ..data.synth import make_synth_split

    return make_synth_split(root, n, hw=hw)


E2E_TRAIN = (("hybrid", "float32", 24), ("device", "float32", 24),
             ("host", "float32", 24), ("resident", "float32", 24),
             ("hybrid", "bfloat16", 128), ("device", "bfloat16", 128),
             ("resident", "bfloat16", 128))


def bench_e2e_train(entries: list, data_root: str, *, device, n: int = 512,
                    native_hw=(400, 300), image_hw: int = CSNET_HW,
                    configs=E2E_TRAIN, predefine: str = "",
                    store_hw: int = 256) -> None:
    """``cli.train``'s second epoch (the first pays the first calls) for
    each placement at the reference recipe (B=24 f32) and the
    high-throughput configs (bf16 B=128). ``predefine``: a layer config
    in place of the recipe's basewidth 40."""
    from ..cli.train import run_training
    from ..config import get_cfg

    make_synth_duts(data_root, n, native_hw)
    for mode, dtype, bsz in configs:
        free_card(device)
        cfg = get_cfg()
        cfg.TASK = f"bench_{mode}_{dtype}_{bsz}"
        cfg.MODEL.BASIC_SPLIT = [0.5, 0.5]
        cfg.LOSS.MLOSS = 1
        cfg.DATA.DIR = data_root
        cfg.DATA.BATCH_SIZE = bsz
        cfg.DATA.IMAGE_H = cfg.DATA.IMAGE_W = image_hw
        cfg.CUDA.DTYPE = dtype
        cfg.CUDA.RESIDENT_STORE_HW = store_hw
        cfg.DATA.WORKERS = 4
        cfg.AUTO.ENABLE = True
        cfg.AUTO.EXPAND = 2.0
        cfg.AUTO.PREDEFINE = predefine
        cfg.AUTO.FLOPS.ENABLE = True
        cfg.AUTO.FLOPS.WEIGHT = 3.0
        cfg.SOLVER.METHOD = "Adam_dynamic_weight_decay"
        cfg.CUDA.PREPROCESS = mode
        with tempfile.TemporaryDirectory(prefix="sod_bench_") as save:
            cfg.DATA.SAVEDIR = save
            out = run_training(cfg, max_epochs=2, log=_quiet, device=device)
        peak = peak_gib(device)
        ips = out["history"][-1]["img_per_sec"]
        tag = "" if dtype == "float32" else ",bf16"
        _log(f"# e2e cli.train epoch img/s ({mode} preprocess, {dtype}, "
             f"B={bsz}): {ips:.1f}, peak {peak} GiB")
        entries.append({
            "metric": f"csnet_l_x2_224_e2e_train_img_per_sec[{mode}_preprocess{tag},B={bsz}]",
            "value": round(ips, 1), "unit": "images/sec", "hw": image_hw,
            "peak_mem_gib": peak, **_tf32(dtype == "float32")})


def seeded_csnet_checkpoint(root: str, device, *, width: int = 40,
                            hw: int = CSNET_HW) -> tuple[str, str]:
    """A seeded, BN-calibrated CSNet checkpoint in the reference format
    (``train/checkpoint.py``): (layer config path, checkpoint path)."""
    from ..train.checkpoint import save_checkpoint

    model = seeded_csnet(device, width=width, hw=hw)
    lc_path = os.path.join(root, "csnet-seeded.bin")
    ck_path = os.path.join(root, "csnet-seeded.pth.tar")
    model.lc.save(lc_path)
    save_checkpoint(ck_path, model, None, epoch=0, arch="CSNet")
    return lc_path, ck_path


def bench_e2e_test(entries: list, data_root: str, *, device, n: int = 512,
                   native_hw=(400, 300), image_hw: int = CSNET_HW,
                   batch: int = 128, width: int = 40, native_n: int = 128,
                   uniform_hw: int = 320, test_batches=(1, 16)) -> None:
    """``cli.test`` (decode, preprocess, forward, resize back, PNG dump) for
    each ``CUDA.TEST_PREPROCESS`` at bf16 B=128, then the ceil-to-16 native
    protocol on uniform 320^2 images per ``--test_batch``; each config's
    second run (the first pays the first calls)."""
    from ..cli.test import run_test
    from ..config import get_cfg
    from ..data.synth import make_synth_split

    ds = "SYNTH-TE"
    make_synth_split(os.path.join(data_root, ds), n, hw=native_hw)
    lc_path, ck_path = seeded_csnet_checkpoint(data_root, device,
                                               width=width, hw=image_hw)

    def timed(cfg, dataset):
        with tempfile.TemporaryDirectory(prefix="sod_benchtest_") as save:
            cfg.DATA.SAVEDIR = save
            run_test(cfg, log=_quiet, device=device)
            out = run_test(cfg, log=_quiet, device=device)
        return out["datasets"][dataset]["img_per_sec"]

    def base_cfg(task, dataset):
        cfg = get_cfg()
        cfg.TASK = task
        cfg.TEST.MODEL_CONFIG = lc_path
        cfg.TEST.CHECKPOINT = ck_path
        cfg.TEST.DATASET_PATH = data_root
        cfg.TEST.DATASETS = [dataset]
        cfg.DATA.WORKERS = 4
        cfg.CUDA.DTYPE = "bfloat16"
        return cfg

    for mode in ("hybrid", "device", "host"):
        cfg = base_cfg(f"bench_test_{mode}", ds)
        cfg.TEST.IMAGE_H = cfg.TEST.IMAGE_W = image_hw
        cfg.DATA.BATCH_SIZE = batch
        cfg.CUDA.TEST_PREPROCESS = mode
        ips = timed(cfg, ds)
        _log(f"# e2e cli.test img/s ({mode} preprocess, bf16, B={batch}): "
             f"{ips:.1f}")
        entries.append({
            "metric": f"csnet_l_x2_224_e2e_test_img_per_sec[{mode}_preprocess,bf16,B=128]",
            "value": round(ips, 1), "unit": "images/sec", "hw": image_hw,
            "batch": batch, "weights": "seeded"})

    # the ceil-to-16 native-size protocol (TEST.IMAGE_H/W = 0, the
    # reference test.py:75-98): the per-image loop against --test_batch
    # batching of same-shape images; uniform images give one shape
    ds_u = "SYNTH-TE-UNI"
    make_synth_split(os.path.join(data_root, ds_u), native_n,
                     hw=(uniform_hw, uniform_hw), jitter=0,
                     alternate_orientation=False)
    for tb in test_batches:
        cfg = base_cfg(f"bench_test_native_tb{tb}", ds_u)
        cfg.TEST.IMAGE_H = cfg.TEST.IMAGE_W = 0
        cfg.TEST.BATCH = tb
        ips = timed(cfg, ds_u)
        _log(f"# e2e cli.test native ceil-16 img/s (test_batch={tb}, bf16, "
             f"{uniform_hw}^2 uniform): {ips:.1f}")
        entries.append({
            "metric": f"csnet_l_x2_native320_e2e_test_img_per_sec"
                      f"[test_batch={tb},bf16]",
            "value": round(ips, 1), "unit": "images/sec", "hw": uniform_hw,
            "weights": "seeded"})


def bench_csf_e2e_test(entries: list, data_root: str, *, device,
                       n: int = 256, hw: int = CSF_HW,
                       test_batches=(1, 16)) -> None:
    """``cli.csf`` test mode (the reference's speed protocol,
    solver.py:76-77: decode, forward, native-size ``*_sal_fuse.png``
    dump) on a uniform 336^2 list, the B=1 loop against ``--test_batch``
    batching; u8 in and out, one-deep pipelining; each config's second
    run."""
    from ..cli.csf import build_parser, run_csf_test
    from ..data.image_io import write_png
    from ..train.checkpoint import save_checkpoint

    root = os.path.join(data_root, "CSF-MR")
    lst = os.path.join(root, "test.lst")
    os.makedirs(os.path.join(root, "Imgs"), exist_ok=True)
    rng = np.random.default_rng(3)
    names = []
    for i in range(n):
        write_png(os.path.join(root, "Imgs", f"m{i}.png"),
                  rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8))
        names.append(f"Imgs/m{i}.png")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    # seeded weights serve a speed protocol (the same operations)
    ck = os.path.join(root, "init.pth")
    save_checkpoint(ck, CSFNet("res2net50", seed=0, device="cpu"), None,
                    epoch=0, arch="csf_res2net50")

    for tb in test_batches:
        with tempfile.TemporaryDirectory(prefix="csf_benchtest_") as fold:
            config = build_parser().parse_args([
                "--mode", "test", "--arch", "res2net50", "--model", ck,
                "--test_fold", fold, "--dtype", "bfloat16",
                "--test_batch", str(tb)])
            config.test_root, config.test_list = root, lst
            run_csf_test(config, log=_quiet, device=device)
            fps = run_csf_test(config, log=_quiet, device=device)["fps"]
        _log(f"# e2e cli.csf test FPS ({hw}^2 uniform, bf16, "
             f"test_batch={tb}): {fps:.1f}")
        entries.append({
            "metric": f"csf_res2net50_336_e2e_test_fps[bf16,test_batch={tb}]",
            "value": round(fps, 1), "unit": "images/sec", "hw": hw,
            "weights": "seeded"})


def run_entries(args, device) -> list:
    """The entries the flags keep, in the JAX tool's order."""
    entries: list = []
    if not args.skip_serving:
        bench_serving_artifact(entries, device=device)
    if not args.skip_latency:
        bench_inference_latency(entries, device=device)
    if not args.skip_step:
        bench_csnet_train_steps(entries, device=device)
    if not args.skip_csf:
        bench_csf_steps(entries, device=device)
        bench_csf_resident_epoch(entries, device=device)
    if not args.skip_val:
        bench_resident_val(entries, device=device)
        bench_resident_testall(entries, device=device)
    if not args.skip_e2e and not (args.skip_e2e_train and
                                  args.skip_e2e_test):
        with tempfile.TemporaryDirectory(prefix="sod_bench_data_") as tmp:
            data_root = args.data_dir or tmp
            if not args.skip_e2e_train:
                bench_e2e_train(entries, data_root, device=device)
            if not args.skip_e2e_test:
                bench_e2e_test(entries, data_root, device=device)
                bench_csf_e2e_test(entries, data_root, device=device)
    return entries


def merge_into(path: str, entries: list, info: dict) -> dict:
    """Merge ``entries`` into the JSON at ``path`` by metric name (rows of
    skipped entries keep their earlier values); an earlier file of another
    card, or another power limit, is replaced, not merged."""
    merged: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if {k: old.get(k) for k in info} == info:
            merged = {e["metric"]: e for e in old["entries"]}
        else:
            _log(f"# {path} holds rows of {old.get('device')} "
                 f"({old.get('power_limit')}): replaced")
    merged.update({e["metric"]: e for e in entries})
    out = {**info, "entries": list(merged.values())}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for flag in ("e2e", "e2e-train", "e2e-test", "csf", "step", "latency",
                 "serving", "val"):
        ap.add_argument(f"--skip-{flag}", action="store_true")
    ap.add_argument("--data-dir", default="",
                    help="where the e2e rows write their synthetic splits "
                         "(default: a temporary directory)")
    ap.add_argument("--out", default=OUT, help="the merged JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    entries = run_entries(args, device)
    merge_into(args.out, entries, timing.card(device))
    print(json.dumps(entries), flush=True)
    return entries


if __name__ == "__main__":
    main()
