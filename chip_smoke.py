"""Smoke run of the PyTorch/CUDA port (sod100k_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives CSNet-L (``init_layers(40, [0.5, 0.5])``, full width, 224^2, seeded
random weights with calibrated BN statistics) through the port's serving
entry points, with every ILBlock depthwise tail on the hand-written CUDA
kernel (csrc/dw_chain.cu) and every bilinear resize on the resize kernel
(csrc/resize_bilinear.cu), then its training, pruning and dataset paths,
then CSF+Res2Net-50/101 at 336^2, the drivers and the native SalMetric.
Phases; any failure exits non-zero:

1. build the kernels with nvcc (sm_90a) and print the card's name and
   power limit;
2. kernel against its plain PyTorch version on the card, at the main path's
   shapes, at ragged ones and at one shape on each launch plan's edge: f32
   within atol 2e-5, bf16 within one bf16 ulp (rtol 2^-7, atol 1e-3), each
   of a value the plain function may give (in bf16 an intermediate at a
   rounding tie may round either way: ``dw_chain.check_against_plain``);
3. the model in f32 on the card (kernel path) against the port on the CPU
   (plain path): max |dlogit| < 1e-3, sigmoid mean |d| < 1e-5, 33 kernel
   launches per forward, a sigmoid that is not constant;
4. serving: a bf16 u8-wire artifact with buckets (1, 8, 32), the HTTP
   daemon on 127.0.0.1, 16 requests from 4 client threads, /stats and the
   launch count; each response is nearer its own images' direct
   ServingModel result than any other request's. In bf16 a cuDNN algorithm
   that changes with the bucket flips single bf16 roundings, which the
   fresh x100 net amplifies to most pixels, so the served-vs-direct bar
   (within 1 level on at most 0.1% of pixels) is held by
4b. the same with an f32-compute artifact, which is batch-invariant;
5. at N=32 for each main-path shape, the kernel held against the plain
   version in bf16 and f32 as in phase 2, then times (not gated): the kernel's
   device time per call (torch.profiler self device time of the kernel
   over 20 launches of ``fused_dw_chain_packed``, with CUDA events around
   the same loop as a cross-check; CUDA events alone when the profiler
   misses three windows in a row, and the kernels line's ``ms_by`` and
   ``library_ms_by`` say which), the wrapper's host time per call, the
   bound and the share of it, the plain version, and one bf16 depthwise
   ``F.conv2d`` (one stage, no BN or PReLU) as a yardstick; then the B=32
   bf16 eval forward (host clock, synchronized) with the profiler's device
   time split by kernel, and direct ServingModel img/s at B=32;
6. training, f32, card against CPU from phase 3's weights: one B=2 step
   with the penalty (flops_weight 3.0, flops_expand 2.0, batch_size 2; SGD
   at lr 0, so the gradients stay): loss and penalty within rel 1e-4, the
   gradients within L2-rel 2e-3 globally and each tensor (L2-rel, floor
   1e-6 of the global norm) no further from a CPU f64 step than 3x the
   CPU's own f32 distance on that tensor + 1e-2 (``F64_FLOOR``); BN
   running statistics within L2-rel 1e-4; the card's step taken twice
   (not gated); and train-mode BN on the card takes bf16 input with f32
   parameters (bf16 out, f32 grads);
7. training on the main path: CSNet-L, B=24 bf16 on the u8 wire, Adam
   with dynamic weight decay at lr 1e-3, the penalty on, 30 steps over 4
   seeded blob batches made in memory: finite losses, a positive penalty,
   the last 4 steps' mean loss below the first 4's; then the trained
   model's f32 eval (the kernel, 33 launches, packs built before training)
   equals a fresh load on the card (max |dlogit| <= 1e-5) and the CPU
   (< 1e-3); a checkpoint resumes bit for bit into a new model and
   optimizer, and their next step's loss is within rel 1e-6;
8. pruning at the smallest layer median of |gamma| (every layer keeps at
   least half its channels), 5 finetune steps (penalty off, Adam, cosine
   lr), BN calibration, then the slim model's f32 eval on the card against
   the CPU at phase 3's bars and the kernel against its plain version at
   every slim tail shape of a B=2 and of a B=32 bf16 forward, in f32 and
   bf16;
8b. times (not gated): the B=24 bf16 train step (median of 20, host clock,
   synchronized; the profiler's device time, idle share and top kernels;
   peak memory), the f32 step, and the slim model's B=32 bf16 eval forward,
   whose launches over its 20 timed forwards are checked and reported as
   ``slim_launches`` (per forward);
9. the dataset on the card, from phase 7's trained weights (recalibrated
   BN statistics for the sweeps):
9a. a synthetic split of 1,000 PNG pairs at 300x400, alternating
   orientation (ECSSD's count and about its size), written with
   ``make_synth_split`` to a temporary directory and read back through
   ``SalData``: pair 0 bit-equal to the arrays written;
9b. the TESTALL sweep: ``build_resident_val_dataset`` (B=32, wF tables)
   and ``make_resident_salmetric_fn`` in f32 and bf16: 33 launches per
   forward, every metric finite and in range; the f32 sweep's first 64
   images equal the port on the CPU and the host protocol on the card
   (a B=32 forward, then per image the f32 resize back, trunc, the
   accumulator, S and the host weighted F) at the JAX test's bars; the
   sweep's model is phase 7's with BN statistics recalibrated on 12 of the
   split's images: MAE/maxF/adpF/adpE/S 1e-4, P/R/E
   curves 2e-4, wF 5e-4;
9c. the metric functions alone on a padded batch of 32 (degenerate GTs, an
   all-masked row), card vs CPU: counts bit-equal, MAE/P/R/E and adaptive
   F/E within 1e-6, S and wF within 1e-5;
9d. one resident epoch (a 256^2 store of the split's first 480 pairs,
   B=24 bf16 Adam-dwd, penalty on, max_crop 17, an explicit generator):
   finite losses; the resident val MAE over the 1,000 pairs equals the
   host protocol within 1e-4; one f32 batch with one generator seed twice
   gives the same loss (rel 1e-6); a DUTS-TR-sized store (10,553 pairs at
   256^2) is built and its bytes printed;
9e. times (not gated): sweep img/s with and without wF, device time per
   batch split into the forward and the rest, the epoch beside phase 8b's
   step, the PNG read rate, and whether OpenCV's C++ library is present;
10. CSF+Res2Net (``arch/csf_res2net.py``; PyTorch ops and the resize
   kernel, no depthwise tail: the phase counts 0 fused_dw_chain launches
   and more than 0 resize launches), seeded reference
   init, and the 336^2 store of 10d built from the split's first 160 pairs
   through a .lst file (``CSFTrainData``) before the split goes:
10a. Res2Net-50 f32 card vs CPU at B=2, 336^2 and 301x401 (non-integer
   octave resizes, ceil-mode pools), Res2Net-101 at B=1, 336^2: max
   |dlogit| < 1e-3, sigmoid mean |d| < 1e-5, a map that is not constant;
10b. a Res2Net-50 artifact at 336^2 (u8 wire, buckets 1 and 8) served over
   HTTP, 8 requests of disc images from 2 client threads, as phase 4: bf16
   (each response nearest its own direct result) and f32 (within 1 level);
10c. one masked f32 micro-step at B=1, 224^2, card vs CPU: loss rel 1e-4,
   gradients global L2-rel 2e-3; with iter_size 2 nothing moves on
   micro-step 1, every trainable tensor on 2, no frozen tensor or BN
   statistic ever;
10d. the resident CSF epoch: B=8 bf16, Adam lr 5e-5 wd 5e-4, iter_size 2,
   20 micro-steps: finite losses, the trainable tensors moved and the
   frozen ones not; the trained f32 eval equals a fresh load (<= 1e-5);
   remat gives the plain f32 step's gradients (L2-rel < 1e-5);
10e. a 4-pair .lst split of PNGs through ``padded_batches`` (bucket 32)
   into one masked f32 step: within rel 2e-2 of the native-size loss;
10f. times (not gated): the B=32 bf16 eval forward at 336^2 of both
   backbones (host clock, profiler device time by kernel, idle share), the
   B=1 latency, the B=8 bf16 micro-step (median of 20, device time, peak
   memory), the epoch's img/s;
10g. the resize kernel, f32, at every resize of a Res2Net-50 served
   forward at 336^2 (B = 1, 8, 32: 16 resizes, 16 launches) and of a
   CSNet-L-x2 train-mode forward at 224^2 (B = 24), shapes read off the
   ``ops.resize`` spans: bit-equal to ``F.interpolate`` and within the
   plain version's bar (``resize_kernel.check_against_plain``); times (not
   gated): device time per call (profiler), host time, the bound (the
   source rows and columns read and the output written at 3.35 TB/s;
   beside it the contract's whole input, as ``resize_roofline`` counts),
   the plain version, ``F.interpolate`` as library_ms, per shape and per
   forward;
11. the drivers as a user runs them (``python -m sod100k_tpu_torch.cli.*``)
   on CSNet-L at basewidth 40 over a synthetic tree of 96 DUTS-TR and 48
   ECSSD PNG pairs at 300x400, counting ``fused_dw_chain`` launches
   (``cli_launches``, > 0) over the in-process stages:
11a. a train YAML shaped like the reference's csnet-L-x2_train.yml (B=24 at
   224^2, Adam with dynamic weight decay at lr 1e-4, FLOPS.WEIGHT 3.0,
   FINETUNE.THRES 1e-20 unquoted, GPU: 0) read back through the port's
   YAML reader;
11b. ``cli.train --config <yml> --epochs 1`` in a subprocess: exit 0,
   checkpoint_epoch1.pth.tar, a finite val MAE;
11c. in-process on the card: ``run_finetune`` (one epoch), ``run_test``
   at 224^2 and in the ceil-to-16 mode (the trained weights with BN
   statistics recalibrated on 12 test images), the f32 maps of 4 images
   within one level of the same driver on the CPU in both modes (the
   ceil-to-16 mode's 304x400 and 400x304 forwards give the kernel its own
   tail shapes), ``run_eval`` (full suite, metrics in [0, 1]),
   ``run_testall_resident``;
11d. ``cli.export`` to buckets 1 and 32 at bf16 on the u8 wire, then
   ``cli.serve`` in a subprocess answering 8 .npy requests over HTTP and
   one PNG of the split (decoded, resized and encoded without cv2; the PNG
   map within one level of the .npy answer for the same resized image);
   times (not gated): the driver's epoch against phase 8b's f32 step,
   test, eval and sweep img/s, and the phase's wall time;
12. the CSF driver (``python -m sod100k_tpu_torch.cli.csf``) at
   Res2Net-50's full width over synthetic PNG pairs at 300x400 with .lst
   files, from seeded He-scale checkpoints (no download is tried), and the
   native SalMetric on its dumps, counting ``fused_dw_chain`` launches
   over the in-process stages (``csf_cli_launches``, 0: the CSF path has
   no depthwise tail):
12a. ``--mode train`` in a subprocess, twice: the recipe's native-size
   protocol (``--image_size 0 --batch_size 1 --iter_size 10``, 20 pairs:
   two optimizer steps) and ``--image_size 336 --batch_size 8 --iter_size
   2 --dtype bfloat16 --preprocess resident`` (32 pairs): exit 0,
   final.pth, finite losses;
12b. ``run_csf_test`` on the card from 12a's f32 final.pth over 16 images
   (same-shape runs of 10, 4 and 2): ``--test_batch 4`` within one level
   of B=1, the f32 maps of 4 images within one level of the same driver
   on the CPU, one ``--arch res2net101`` run on 4 images;
12c. the native SalMetric (``csrc/salmetric.cc``, built with the host
   compiler) on 12b's dumps: within abs 1e-5 of the device backend on the
   card, its CLI's stdout equal to ``do_evaluation``'s report, and
   ``cli.eval --dirs --backend native --suite full``;
12d. times (not gated): each subprocess's wall time and its epoch's
   micro-step time beside phase 10f's bare B=8 micro-step, the test
   driver's FPS, native vs device scoring img/s, the phase's wall time.

13. the recipe tools on the card, counting ``fused_dw_chain`` launches
   (``tools_launches``, the trajectory's validations):
13a. in a process of its own, beside 13b and phase 14 (it is ~2,500
   host-bound steps): ``tools.prune_trajectory`` at the JAX package's slow-test
   configuration (600 + 30 epochs, basewidth 8, 32 images at 48^2, B=8, lr
   2e-3, flops weight 30; about 2,500 steps) held to that test's
   invariants (``prune_trajectory.INVARIANTS``): gamma sparsity > 30%,
   parameter drop > 25%, post-prune MAE < pre-prune + 0.05, finetuned MAE
   < 0.15; "finetuned <= 1.6x
   pre-prune" is printed, not gated: the JAX package's own runs of this
   configuration fail it as often as the port's (a pruned net severed
   into a finetune that stalls near train loss 0.2), and
   ``tests/test_torch_trajectory.py`` holds the recovery to the JAX
   package's instead;
13b. ``tools.bf16_ab`` at B=24, 224^2, basewidth 40, 60 steps: finite
   trajectories and gammas, its markdown printed;
14. data parallelism (``sod100k_tpu_torch.parallel``), counting
   ``fused_dw_chain`` launches over the phase (``dp_launches``):
14a. ``python -m sod100k_tpu_torch.cli.train`` under SOD100K_COORDINATOR
   with SOD100K_NUM_PROCESSES=1 (NCCL) against the same run without the
   variables: the same printed loss, the penalty and the checkpoint's
   checksum within rel 1e-5, the val MAE within 5e-3 (CUDA training is not
   bit-reproducible between two processes);
14b. two processes on the one card over gloo (CUDA tensors): the CSNet-L
   step at B=24 (12 + 12), the penalty on, against one process at B=24,
   beside one process's own cuDNN-on-vs-off distance: f32 SGD 2 steps at
   the JAX multi-host oracle's bars (first loss rel 1e-5, second rel 1e-4,
   checksum rel 1e-4); bf16 Adam-dwd 3 steps, checksum rel 1e-4 (its
   losses printed: bf16 engines differ by ~5e-4 on the first loss);
14c. two processes run the resident TESTALL sweep through the driver:
   each rank's table equals one process's to six decimals.
15. the 2-D data x spatial mesh (``sod100k_tpu_torch.parallel.spatial``):
   two ranks share the card over gloo as a 1 x 2 mesh, each holding a band
   of every image's rows, beside 13a as phase 14 runs:
15a. CSNet-L at 224^2, B=2: f32 and bf16 eval forwards on the bands
   against one process, every fused-tail call on band + 2-row halo held
   against the plain version; its band launches are the kernels line's
   ``spatial_launches``;
15b. the CSNet-L train step, f32 SGD, B=2, 2 steps, against one process
   at the JAX 2-D oracle's one-step bars (tests/test_parallel.py:287-300)
   and the parameter checksum after both steps at rel 1e-4;
15c. the Res2Net-50 CSF micro-step at 336^2, B=1, iter_size 2, f32,
   against one process at tests/test_parallel.py:214-228's bars;
15d. ``cli.csf --mode test --mesh_shape 1x2 --test_batch 2`` over 4
   images: the PNGs within one level of one process's.
   Printed, not gated: halo bytes and exchanges per forward and step, ms
   per forward and step on each rank against one process, the phase's
   wall time.
16. the resident programs on the 2-D mesh (``data/resident.py`` under
   ``Mesh2D``): two ranks share the card over gloo as 1 x 2, beside 13a
   after phase 15; the tail kernel's launches over 16b and 16d are the
   kernels line's ``resident_mesh_launches``:
16a. the resident CSNet-L epoch, f32, a 256^2 store, out 224^2, B=4, one
   batch, Adam with dynamic weight decay, the penalty on, against one
   process on the same draws: loss and penalty within rel 1e-5, the state
   after the step within 1e-3 * max(1, max|leaf|);
16b. the resident TESTALL sweep through ``run_testall_resident`` on the
   mesh and the resident validation, f32, on 14c's calibrated CSNet-L and
   split: each rank's table equal to one process's at six decimals, the
   val MAE within 1e-6, ``n`` equal to the split's size, the tail kernel
   launched on every rank's bands;
16c. the resident CSF epoch, Res2Net-50 at 336^2, B=2, one micro-step, the
   draws given: the loss within rel 1e-5 of one process's, the update's
   checksum within rel 1e-4;
16d. ``python -m sod100k_tpu_torch.cli.smoke --dry-data --mesh_shape
   1x2`` (64 px, one train and one finetune epoch) as two ranks: each
   reports ``[smoke] OK`` and a resident sweep epoch >= 1.
17. the measurement tools (``python -m sod100k_tpu_torch.tools.*``) on
   the card, in-process, at a short setting; the tail kernel's launches
   over the phase are the kernels line's ``tools_bench_launches``:
17a. ``tools.bench`` at its defaults: exactly one stdout line, a JSON
   row with the JAX tool's keys and metric name and the card's name and
   power limit, after its parity gate (bf16 MAE <= 1e-3 or f32 <= 1e-5
   against the f32 plain-tail reference); the tail kernel launched 33
   times for each of its forwards;
17b. ``tools.bench_serve --secs 5``: the JAX row's keys, served and
   direct img/s > 0;
17c. ``tools.bench_extras --skip-e2e`` with each timing the best of 1
   (``timing.REPEATS``; 3 in the tool's own runs): every entry's row,
   named as the JAX tool names it, finite and > 0;
17d. ``tools.bench_check --record`` into a temporary reference from 17c's
   rows, then ``tools.bench_check`` against it (a fresh ``tools.bench``
   row within 15%);
17e. ``tools.perf_probe`` ablate and dwlayout.
   Printed, not gated: each tool's rows and times, the phase's wall time.

Needs torch with CUDA and nvcc; no jax, cv2, PIL or yaml. The second line from
the end is a JSON summary of the kernels (the resize kernel's times are
per B=8 CSF forward, ``per_forward`` has each of 10g's forwards); the last
line is the run's JSON result.

    python3 chip_smoke.py --variants

runs phase 1 and then an A/B of the kernel's plan sizes and of diagnostic
builds of its source (arithmetic, staging copies or stores of y taken out),
timed as in phase 5 and printed per shape and per forward; no result line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from sod100k_tpu_torch.arch.csf_res2net import CSFNet
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn, count_params
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.data.csf_dataset import CSFTrainData, padded_batches
from sod100k_tpu_torch.data.image_io import (decode_png, read_image,
                                             resize_f32_linear,
                                             resize_u8_linear, write_png)
from sod100k_tpu_torch.data.pipeline import (SalData, _imread_rgb_u8,
                                             normalize_u8)
from sod100k_tpu_torch.data.resident import (build_resident_dataset,
                                             build_resident_val_dataset,
                                             make_resident_csf_epoch_fn,
                                             make_resident_epoch_fn,
                                             make_resident_salmetric_fn,
                                             make_resident_val_fn)
from sod100k_tpu_torch.data.synth import make_synth_split, synth_pairs
from sod100k_tpu_torch.metrics import salmetric
from sod100k_tpu_torch.metrics.salmetric import (SalMetricAccumulator,
                                                 result_from_sums)
from sod100k_tpu_torch.metrics.smeasure import s_measure_batch
from sod100k_tpu_torch.metrics.wfmeasure import (precompute_wf_tables,
                                                 weighted_f_measure,
                                                 wf_per_image_device)
from sod100k_tpu_torch.ops import cuda_lib, dw_chain, resize_kernel
from sod100k_tpu_torch.prune import build_pruned_csnet, layer_gammas, prune
from sod100k_tpu_torch.serve import export_artifact, load_artifact
from sod100k_tpu_torch.serve_http import make_server
from sod100k_tpu_torch.train.checkpoint import resume, save_checkpoint
from sod100k_tpu_torch.train.csf_step import (csf_loss,
                                              freeze_reference_params,
                                              make_csf_optimizer,
                                              make_csf_train_step)
from sod100k_tpu_torch.train.optim import (cosine_lr, make_adam, make_adam_dwd,
                                           make_sgd)
from sod100k_tpu_torch.train.step import (make_eval_step, make_train_step,
                                          quantized_mae)
from sod100k_tpu_torch.utils import profiler

HW = (224, 224)
CALLS_PER_FORWARD = 33
# (H, W, C) of the 33 fused-tail calls of one CSNet-L forward at 224^2, with
# how many calls use each shape
MAIN_SHAPES = [((224, 224, 20), 4), ((112, 112, 20), 4), ((112, 112, 40), 3),
               ((56, 56, 40), 3), ((112, 112, 80), 1), ((56, 56, 80), 5),
               ((28, 28, 80), 8), ((14, 14, 80), 3), ((56, 56, 160), 1),
               ((28, 28, 160), 1)]
RAGGED_SHAPES = [(2, 40, 36, 13), (1, 17, 23, 5), (2, 64, 64, 24)]  # NHWC
EDGE_SHAPES = [(3, 9, 14, 14),    # odd plane count at 14^2 (NCHW)
               (2, 3, 101, 224),  # H not a multiple of the band rows
               (1, 1, 224, 224),  # the band path with a single plane
               (2, 3, 170, 102)]   # rows not 16-byte aligned
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_S = 67e12    # H100 SXM float32 outside the tensor cores
FLOPS_PER_ELEMENT = 2 * (9 + 9 + 2 + 1)  # two stages: taps, scale+shift, PReLU
L2_BYTES = 50e6
TOL = {torch.float32: dict(rtol=0.0, atol=2e-5),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}
# the reference recipe's dynamic-weight-decay schedule (SURVEY.md)
PENALTY = dict(flops_weight=3.0, flops_expand=2.0)
TRAIN_BATCH = 24  # the reference recipe's batch
TRAIN_STEPS = 30
FINETUNE_STEPS = 5
LR = 1e-3
# phase 6: a gradient tensor's L2-rel distance from the f64 step may exceed
# 3x the CPU f32's by this much (one f32 engine's rounding differs from
# another's by up to ~10x on single tensors: PERF.md)
F64_FLOOR = 1e-2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def chain_inputs(n, c, h, w, dtype, rng):
    """Seeded activation (N, C, H, W) and both stages' taps (C, 3, 3) and
    scale/shift/alpha (C,), the recipe of the JAX package's kernel test."""
    x = torch.from_numpy(rng.standard_normal((n, c, h, w), dtype=np.float32))
    params = []
    for _ in range(2):
        params += [rng.standard_normal((c, 3, 3), dtype=np.float32) * 0.1,
                   rng.random(c).astype(np.float32) + 0.5,
                   rng.standard_normal(c).astype(np.float32),
                   rng.standard_normal(c).astype(np.float32) * 0.25]
    return (x.to("cuda", dtype),
            [torch.from_numpy(np.ascontiguousarray(p)).cuda()
             for p in params])


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(got, x, params, what: str) -> float:
    """Hold the kernel's result against the plain version at TOL: within the
    bar of a value the plain function may give, where a bf16 intermediate
    at a rounding tie may round either way (the kernel and cuDNN sum the
    taps in different orders). Returns the largest distance."""
    check(got.dtype == x.dtype and got.shape == x.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    plain = dw_chain.fused_dw_chain_ref(x, *params)
    e, ties = dw_chain.check_against_plain(got, x, params, **TOL[x.dtype])
    say(f"  kernel vs plain {str(x.dtype)[6:]:8s} NCHW {what}: max |d| "
        f"{(got.float() - plain.float()).abs().max().item():.3e} from the "
        f"plain version, {e:.3e} from its range ({ties} intermediates near a "
        f"rounding tie)")
    return e


def phase_kernel_vs_plain() -> dict:
    cases = [(2, c, h, w) for (h, w, c), _ in MAIN_SHAPES]
    cases += [(n, c, h, w) for n, h, w, c in RAGGED_SHAPES] + EDGE_SHAPES
    rng = np.random.default_rng(0)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cases:
            x, params = chain_inputs(*shape, dtype, rng)
            got = dw_chain.fused_dw_chain(x, *params)
            torch.cuda.synchronize()
            err[dtype] = max(err[dtype], check_kernel(got, x, params,
                                                      str(shape)))
    return err


def phase_model_f32(model_cpu: CSNet, images: np.ndarray) -> None:
    x = normalize_u8(torch.from_numpy(images))
    with torch.no_grad():
        want = model_cpu(x).numpy()
    model = CSNet(model_cpu.lc, device="cuda")
    model.load_state_dict(model_cpu.state_dict(), strict=True)
    model.eval()
    dw_chain.launches = 0
    with torch.no_grad():
        got = model(x.cuda())
    torch.cuda.synchronize()
    launches = dw_chain.launches
    got = got.cpu().numpy()
    check(launches == CALLS_PER_FORWARD,
          f"{launches} kernel launches in one forward, want {CALLS_PER_FORWARD}")
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    d_logit = float(np.abs(got - want).max())
    d_sig = float(np.abs(sig(got) - sig(want)).mean())
    say(f"  f32 card (kernel) vs CPU (plain), 2x224^2: max |dlogit| "
        f"{d_logit:.3e} (< 1e-3), sigmoid mean |d| {d_sig:.3e} (< 1e-5), "
        f"sigmoid std {sig(got).std():.4f}, launches {launches}")
    check(got.shape == (2, *HW, 1) and np.isfinite(got).all(), "f32 output")
    check(d_logit < 1e-3 and d_sig < 1e-5, "f32 card vs CPU parity")
    check(sig(got).std() > 0.01, "sigmoid is not constant")


def post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npy"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"/predict status {r.status}")
        return np.load(io.BytesIO(r.read()))


def phase_serving(model_cpu, artifact: str, dtype: torch.dtype, *,
                  hw=HW, buckets=(1, 8, 32), requests=None, clients: int = 4,
                  calls: int = CALLS_PER_FORWARD):
    """Export, load on the card, serve the requests (by default 16 of 1-4
    noise images at ``hw``) from ``clients`` client threads, check /stats,
    the launch count (``calls`` kernel launches per forward) and every
    response against a direct ServingModel call on the same images."""
    export_artifact(artifact, model_cpu, batch=buckets, hw=hw,
                    dtype=dtype, wire="u8")
    sm = load_artifact(artifact, device="cuda")
    if requests is None:
        rng = np.random.default_rng(2)
        requests = [rng.integers(0, 256, (int(rng.integers(1, 5)), *hw, 3),
                                 np.uint8) for _ in range(16)]
    responses: list = [None] * len(requests)
    errors: list = []

    dw_chain.launches = 0
    srv = make_server(sm, host="127.0.0.1", port=0, warmup=True)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def client(k: int) -> None:
        try:
            for i in range(k, len(requests), clients):
                responses[i] = post_npy(url, requests[i])
        except Exception as e:  # reported below, after every thread joined
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "clients finished")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        torch.cuda.synchronize()
        served_launches = dw_chain.launches
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()
        server.join(timeout=60)
    check(not server.is_alive(), "server thread stopped")
    if errors:
        raise errors[0]

    n_images = sum(len(r) for r in requests)
    hist = {int(k): v for k, v in stats["batch_hist"].items()}
    say(f"  served {stats['requests']} requests, {stats['images']} images in "
        f"{stats['dispatches']} dispatches, batch histogram {hist}")
    check(stats["requests"] == len(requests) and stats["images"] == n_images,
          "/stats request and image counts")
    check(sum(hist.values()) == stats["dispatches"]
          and sum(k * v for k, v in hist.items()) == n_images,
          "/stats batch histogram adds up")
    forwards = len(sm.batches) + stats["dispatches"]  # warm-up + one each
    say(f"  launches over the served phase: {served_launches} "
        f"(want {calls} x {forwards})")
    check(served_launches == calls * forwards,
          "launches over the served phase")

    directs = [sm(req) for req in requests]
    worst_share, worst_max = 0.0, 0
    for i, (resp, direct) in enumerate(zip(responses, directs)):
        check(resp.shape == direct.shape == (len(requests[i]), *hw, 1)
              and resp.dtype == np.uint8, "response shape and dtype")
        diff = np.abs(resp.astype(np.int32) - direct.astype(np.int32))
        worst_share = max(worst_share, float((diff > 0).mean()))
        worst_max = max(worst_max, int(diff.max()))
        if dtype == torch.float32:
            check(diff.max() <= 1 and (diff > 0).mean() <= 1e-3,
                  f"served vs direct: max |d| {diff.max()}, "
                  f"share {(diff > 0).mean():.2e}")
        else:
            # bf16 on fresh weights is chaotic across buckets (PERF.md): the
            # check is that each client got its own images' maps back
            own = np.abs(resp[0].astype(np.int32) - direct[0]).mean()
            others = min(np.abs(resp[0].astype(np.int32) - d[0]).mean()
                         for j, d in enumerate(directs) if j != i)
            check(own < others, f"response {i} is nearer another request's "
                  f"map ({others:.2f}) than its own ({own:.2f})")
    say(f"  {str(dtype)[6:]} served vs direct: worst max |d| {worst_max} "
        f"levels, worst share of pixels that differ {worst_share:.2e}")
    return sm, served_launches


def profile_kernels(fn, reps: int, match: str | None = None
                    ) -> tuple[list, float]:
    """torch.profiler's kernels over ``reps`` calls of ``fn`` (those whose
    name holds ``match``, every kernel if None), largest self device time
    first, and their device ms per call. The profiler has been seen to drop
    a whole window: one with no kernel, or with fewer than ``reps`` of the
    ``match`` kernel, is taken again, three times in all; then ([], 0.0)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.self_device_time_total > 0
                          and (match is None or match in e.key)),
                         key=lambda e: -e.self_device_time_total)
        if kernels and (match is None
                        or sum(e.count for e in kernels) == reps):
            return kernels, sum(e.self_device_time_total
                                for e in kernels) / reps / 1e3
    say(f"  the profiler missed {match or 'every'} kernel in {reps} calls, "
        f"three windows in a row")
    return [], 0.0


def device_ms(fn, match: str | None = None, iters: int = 20
              ) -> tuple[float, str]:
    """Device time per call of ``fn`` after a warm-up, and what measured
    it: "profiler" (``profile_kernels``), or "events" (CUDA events around
    the same loop, host gaps included) when the profiler missed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = profile_kernels(fn, iters, match)[1]
    if ms > 0:
        return ms, "profiler"
    say("  CUDA events instead")
    return cuda_ms(fn, iters), "events"


def host_us(fn, iters: int = 20) -> float:
    """Host time per call of ``fn`` (the enqueue, not the device work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def phase_times(sm, gpu: str) -> dict:
    rng = np.random.default_rng(3)
    tot = dict.fromkeys(("device", "events", "host", "bound", "plain",
                         "library", "bytes_bound", "ops_bound"), 0.0)
    by = {"device": set(), "library": set()}  # what measured each sum
    for (h, w, c), calls in MAIN_SHAPES:
        x, params = chain_inputs(32, c, h, w, torch.bfloat16, rng)
        packed = dw_chain.pack_params(*params)
        plan = dw_chain.device_plan(32, c, h, w, torch.bfloat16, 0)
        fused = lambda: dw_chain.fused_dw_chain_packed(x, packed)  # noqa: E731
        # the plans the forward runs, walks of several items a block
        # included, against the plain version
        check_kernel(fused(), x, params, f"(32, {c}, {h}, {w})")
        x32 = x.float()
        check_kernel(dw_chain.fused_dw_chain_packed(x32, packed), x32,
                     params, f"(32, {c}, {h}, {w})")
        del x32
        plain = lambda: dw_chain.fused_dw_chain_ref(x, *params)  # noqa: E731
        wdw = params[0].reshape(c, 1, 3, 3).to(torch.bfloat16)
        lib = lambda: torch.nn.functional.conv2d(  # noqa: E731
            x, wdw, padding=1, groups=c)
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(fused), cuda_ms(fused), \
            cuda_ms(plain)
        dev, dev_by = device_ms(fused, match="dw_chain_kernel")
        lib_ms, lib_by = device_ms(lib)
        by["device"].add(dev_by)
        by["library"].add(lib_by)
        host = host_us(fused)
        nbytes = 2 * x.numel() * x.element_size()  # read x, write y
        bytes_bound = nbytes / HBM_BYTES_S * 1e3
        ops_bound = x.numel() * FLOPS_PER_ELEMENT / F32_FLOPS_S * 1e3
        bound = max(bytes_bound, ops_bound)
        row = dict(device=dev, events=(k1 + k2) / 2, host=host, bound=bound,
                   plain=(p1 + p2) / 2, library=lib_ms,
                   bytes_bound=bytes_bound, ops_bound=ops_bound)
        for k in tot:
            tot[k] += calls * row[k]
        l2 = "fits in" if nbytes <= L2_BYTES else "exceeds"
        say(f"  N=32 bf16 ({h},{w},{c}) x{calls} [{plan.variant}, "
            f"{plan.copy}, planes {plan.planes}, rows {plan.rows}, vec "
            f"{plan.vec}, block {plan.block}, grid {plan.grid}, smem "
            f"{plan.smem}]: device {dev * 1e3:.2f} us (events "
            f"{row['events'] * 1e3:.2f} us; device by {dev_by}), host "
            f"{host:.1f} us, bound {bound * 1e3:.2f} us ({bound / dev:.1%} "
            f"of it), plain {row['plain']:.4f} ms, library_ms (one-stage "
            f"bf16 depthwise conv2d, not the same function) {lib_ms:.4f} ms "
            f"by {lib_by}; x + y "
            f"{nbytes / 1e6:.1f} MB {l2} the 50 MB L2 between calls  [{gpu}]")
    say(f"  per B=32 forward (33 calls): kernel device {tot['device']:.4f} ms "
        f"(events {tot['events']:.4f} ms), bound {tot['bound']:.4f} ms "
        f"({tot['bound'] / tot['device']:.1%} of it), host "
        f"{tot['host']:.0f} us, plain {tot['plain']:.4f} ms, one-stage "
        f"conv2d yardstick {tot['library']:.4f} ms  [{gpu}]")

    images = rng.integers(0, 256, (32, *HW, 3), np.uint8)
    step = make_eval_step(sm.model, from_u8=True,
                          compute_dtype=torch.bfloat16)
    xu8 = torch.from_numpy(images).cuda()
    for _ in range(3):
        step(xu8)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        step(xu8)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    kernels, dev_fwd = profile_kernels(lambda: step(xu8), 5)
    say(f"  eval forward B=32 bf16 224^2, u8 on the card: {fwd_ms:.3f} ms per "
        f"forward (host clock, 20 forwards, synchronized), device "
        f"{dev_fwd:.3f} ms ({1 - dev_fwd / fwd_ms:.1%} idle)  [{gpu}]")
    for e in kernels[:14]:
        t = e.self_device_time_total / 5 / 1e3
        say(f"    {t:8.4f} ms {t / dev_fwd:6.1%} {e.count / 5:6.1f}/fwd  "
            f"{e.key[:110]}")

    for _ in range(3):
        sm(images)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        sm(images)
    dt = time.perf_counter() - t0
    say(f"  direct ServingModel B=32 bf16 u8 wire: {reps * 32 / dt:.1f} img/s "
        f"({dt / reps * 1e3:.2f} ms per call)  [{gpu}]")
    return tot, {k: "+".join(sorted(v)) for k, v in by.items()}


# ---------------------------------------------------------------------------
# Training, pruning and finetuning (phases 6-8)


def blob_batches(k: int, n: int, seed: int) -> list:
    """``k`` batches of ``n`` uint8 224^2 images, each a disc of one colour
    on noise, with the disc as the uint8 target (0/255): the recipe of
    ``sod100k_tpu/data/synth.py:40-46``, made in memory."""
    rng = np.random.default_rng(seed)
    h, w = HW
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(k):
        img = rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8)
        gt = np.zeros((n, h, w, 1), np.uint8)
        for i in range(n):
            cy = int(rng.integers(h // 4, 3 * h // 4))
            cx = int(rng.integers(w // 4, 3 * w // 4))
            r = int(rng.integers(max(min(h, w) // 8, 4),
                                 max(min(h, w) // 3, 5)))
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[i][blob] = (190, 70, 60)
            gt[i, blob, 0] = 255
        out.append({"image": torch.from_numpy(img),
                    "target": torch.from_numpy(gt)})
    return out


def on_card(batch: dict) -> dict:
    return {k: v.cuda() for k, v in batch.items()}


def copy_of(model: CSNet, device: str) -> CSNet:
    out = CSNet(model.lc, device=device)
    out.load_state_dict({k: v.to(device) for k, v in
                         model.state_dict().items()}, strict=True)
    return out


def eval_logits(model: CSNet, x: torch.Tensor) -> torch.Tensor:
    """The eval forward's f32 logits (the kernel on the card)."""
    model.eval()
    with torch.no_grad():
        return model(x).float()


def l2(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double().cpu()))


def tensors_close(want: dict, got: dict) -> tuple[list, float]:
    """Per-tensor L2-relative errors, with a floor of 1e-6 of the global
    norm, and the global one (``tests/test_trajectory.py:78-99``)."""
    gnorm = sum(l2(v) ** 2 for v in want.values()) ** 0.5
    errs, total = [], 0.0
    for k, v in want.items():
        err = l2(got[k].cpu() - v.cpu())
        total += err ** 2
        errs.append(err / max(l2(v), 1e-6 * gnorm))
    return errs, total ** 0.5 / gnorm


def phase_train_f32(model_cpu: CSNet) -> None:
    """One step with the penalty at B=2 on the card (f32), on the CPU (f32)
    and on the CPU in f64 as the reference: the card's loss and penalty
    within rel 1e-4 of the CPU's, its gradients within L2-rel 2e-3 of the
    CPU's globally, and each gradient tensor no further from the f64
    reference (L2-rel) than 3x what the CPU's own f32 gets on that tensor
    plus ``F64_FLOOR``; BN running statistics within L2-rel 1e-4 per tensor. At this
    size f32 itself is ~2e-2 from f64 on tensors whose gradient is ~1e-4 of
    the global norm (the x100 net amplifies rounding), so the 2e-3
    per-tensor bar of the small-model tests cannot hold here for any f32
    engine against another."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 8, 24, 24), dtype=np.float32)).cuda()
    bn = torch.nn.BatchNorm2d(8, device="cuda")
    y = bn(x.bfloat16())
    y.float().sum().backward()
    d = (y.float() - torch.nn.functional.batch_norm(
        x, None, None, bn.weight, bn.bias, training=True)).abs().max().item()
    say(f"  train BN on the card, bf16 input, f32 parameters: out {y.dtype}, "
        f"weight grad {bn.weight.grad.dtype}, max |d| {d:.2e} from f32")
    check(y.dtype == torch.bfloat16 and bn.weight.grad.dtype == torch.float32
          and d < 2e-2, "train BN takes bf16 with f32 parameters")

    batch = blob_batches(1, 2, seed=6)[0]
    out, models = {}, {}
    for run, dev, dtype in (("cpu", "cpu", None), ("card", "cuda", None),
                            ("card again", "cuda", None),
                            ("f64", "cpu", torch.float64)):
        model = copy_of(model_cpu, dev).to(dtype or torch.float32)
        # lr 0 and no momentum: the step leaves the weights, keeps the grads
        step = make_train_step(model, make_sgd(model, momentum=0.0),
                               **PENALTY, batch_size=2, from_u8=True,
                               compute_dtype=dtype)
        t0 = time.perf_counter()
        out[run] = {k: v.item() for k, v in step(batch, 0.0, 1.0).items()}
        say(f"  {run}: loss {out[run]['loss']:.7f}, penalty "
            f"{out[run]['penalty']:.4f}, step {time.perf_counter() - t0:.1f} s")
        models[run] = model
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in out["cpu"]}
    grads = {run: {n: p.grad.double() for n, p in m.named_parameters()}
             for run, m in models.items()}
    errs, g_all = tensors_close(grads["cpu"], grads["card"])
    card, g_card = tensors_close(grads["f64"], grads["card"])
    cpu, g_cpu = tensors_close(grads["f64"], grads["cpu"])
    again = max(tensors_close(grads["card"], grads["card again"])[0])
    stats = [{n: b for n, b in models[run].named_buffers() if "running" in n}
             for run in ("cpu", "card")]
    s_worst = max(tensors_close(*stats)[0])
    say(f"  f32 card vs CPU: loss rel {rel['loss']:.2e}, penalty rel "
        f"{rel['penalty']:.2e} (< 1e-4); gradients L2-rel global "
        f"{g_all:.2e} (< 2e-3), worst tensor {max(errs):.2e} "
        f"({sum(e >= 2e-3 for e in errs)} of {len(errs)} tensors at 2e-3 or "
        f"more); BN running statistics L2-rel worst {s_worst:.2e} (< 1e-4); "
        f"the card's step again: worst tensor {again:.2e} from the first")
    names = list(grads["f64"])
    bar = [3 * e + F64_FLOOR for e in cpu]
    near = sorted(range(len(names)), key=lambda i: bar[i] - card[i])
    say(f"  gradients against the CPU's f64: card worst tensor "
        f"{max(card):.2e}, global {g_card:.2e}; CPU f32 worst tensor "
        f"{max(cpu):.2e}, global {g_cpu:.2e}; largest card/CPU ratio "
        f"{max(c / max(e, 1e-12) for c, e in zip(card, cpu)):.2f}; "
        f"nearest the bar (3x CPU + {F64_FLOOR:g}): "
        + ", ".join(f"{names[i]} card {card[i]:.2e} CPU {cpu[i]:.2e}"
                    for i in near[:3]))
    check(max(rel.values()) < 1e-4, "loss and penalty, card vs CPU")
    check(g_all < 2e-3, "gradients, card vs CPU")
    over = [n for n, c, b in zip(names, card, bar) if c > b]
    check(not over and g_card <= 3 * g_cpu,
          f"gradients against f64, each within 3x the CPU's f32 distance + "
          f"{F64_FLOOR:g} (over: {over}) and globally within 3x")
    check(s_worst < 1e-4, "BN running statistics, card vs CPU")


def phase_train(model_cpu: CSNet, batches: list) -> tuple:
    """The main training path: CSNet-L, B=24 bf16 on the u8 wire, Adam with
    dynamic weight decay, the penalty on; then the trained model's eval
    (the kernel) against fresh loads, and a checkpoint round trip."""
    model = copy_of(model_cpu, "cuda")
    opt = make_adam_dwd(model)
    step = make_train_step(model, opt, **PENALTY, batch_size=TRAIN_BATCH,
                           compute_dtype=torch.bfloat16, from_u8=True)
    x = normalize_u8(batches[0]["image"][:4])

    def mae(m: CSNet, dtype=None) -> float:
        """Quantized MAE of the eval step on the 4 batches."""
        evaluate = make_eval_step(m, from_u8=True, compute_dtype=dtype)
        return float(np.mean([quantized_mae(
            evaluate(b["image"]), b["target"].float() / 255.0).item()
            for b in batches]))

    mae0 = mae(model)  # the packs are built here, before the weights move
    t0 = time.perf_counter()
    metrics = [step(batches[i % len(batches)], LR, 1.0)
               for i in range(TRAIN_STEPS)]
    loss = torch.stack([m["loss"] for m in metrics]).cpu().numpy()
    pen = torch.stack([m["penalty"] for m in metrics]).cpu().numpy()
    say(f"  {TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s; loss "
        f"{' '.join(f'{v:.4f}' for v in loss)}")
    say(f"  penalty {pen[0]:.2f} -> {pen[-1]:.2f}; mean loss of the first 4 "
        f"steps {loss[:4].mean():.4f}, of the last 4 {loss[-4:].mean():.4f}")
    check(np.isfinite(loss).all() and np.isfinite(pen).all(),
          "finite losses and penalties")
    check((pen > 0).all(), "the penalty is positive")
    check(loss[-4:].mean() < loss[:4].mean(), "the loss falls")

    dw_chain.launches = 0
    got = eval_logits(model, x)
    torch.cuda.synchronize()
    launches = dw_chain.launches
    fresh = eval_logits(copy_of(model, "cuda"), x)
    plain = eval_logits(copy_of(model, "cpu"), x.cpu())
    d_fresh = (got - fresh).abs().max().item()
    d_cpu = (got.cpu() - plain).abs().max().item()
    recalibrated = copy_of(model, "cuda")
    calibrate_bn(recalibrated, normalize_u8(batches[1]["image"][:12]))
    say(f"  trained eval (f32, kernel) vs a fresh load: max |dlogit| "
        f"{d_fresh:.2e} on the card (<= 1e-5), {d_cpu:.2e} against the CPU "
        f"(< 1e-3); {launches} launches")
    say(f"  quantized MAE on the 4 batches (not gated): {mae0:.4f} before, "
        f"{mae(model):.4f} after training (f32 eval), "
        f"{mae(model, torch.bfloat16):.4f} (bf16 eval), "
        f"{mae(recalibrated):.4f} (f32, BN statistics recalibrated on 12 "
        f"training images)")
    check(bool(torch.isfinite(got).all()), "finite trained logits")
    check(d_fresh <= 1e-5, "eval after training equals a fresh load")
    check(d_cpu < 1e-3, "trained eval, card vs CPU")
    check(launches == CALLS_PER_FORWARD, f"{launches} launches in the "
          f"trained eval forward, want {CALLS_PER_FORWARD}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.pth.tar")
        save_checkpoint(path, model, opt, epoch=1)
        other = CSNet(model.lc, seed=1, device="cuda")
        other_opt = make_adam_dwd(other)
        check(resume(path, other, other_opt, map_location="cuda") == 1,
              "resumed epoch")
    same = all(torch.equal(v, other.state_dict()[k])
               for k, v in model.state_dict().items())
    saved, loaded = opt.state_dict(), other_opt.state_dict()
    same_opt = saved["param_groups"] == loaded["param_groups"] and all(
        torch.equal(v.cpu(), loaded["state"][i][k].cpu())
        for i, st in saved["state"].items() for k, v in st.items())
    other_step = make_train_step(other, other_opt, **PENALTY,
                                 batch_size=TRAIN_BATCH,
                                 compute_dtype=torch.bfloat16, from_u8=True)
    a = step(batches[0], LR, 1.0)["loss"].item()
    b = other_step(batches[0], LR, 1.0)["loss"].item()
    say(f"  checkpoint: model state equal {same}, optimizer state equal "
        f"{same_opt}; the next step's loss {a:.7f} and resumed {b:.7f}")
    check(same and same_opt, "the resumed state equals the saved one")
    check(abs(a - b) <= 1e-6 * abs(a), "the resumed step's loss")
    return model, launches


def tail_shapes(model: CSNet, x: torch.Tensor) -> tuple:
    """The eval forward's f32 logits, its kernel launches and the (N, C, H,
    W) of every tail branch it ran."""
    shapes = []
    hooks = [block.conv1x1.register_forward_hook(
        lambda m, i, out: shapes.extend(
            tuple(y.shape) for y in out if y is not None))
        for name in ("stage0", "stage1", "stage2", "stage3", "stage4")
        for block in getattr(model, name)]
    try:
        dw_chain.launches = 0
        got = eval_logits(model, x)
        torch.cuda.synchronize()
        launches = dw_chain.launches
    finally:
        for h in hooks:
            h.remove()
    return got, launches, shapes


def phase_prune(model: CSNet, batches: list) -> tuple:
    """Prune the trained weights at the smallest layer median of |gamma|,
    take finetune steps, calibrate, and hold the slim model's eval (the
    kernel at ragged widths) against the CPU and the kernel against its
    plain version at every slim tail shape of a B=2 and a B=32 forward.
    Returns the slim model and its tail calls per forward."""
    sd, lc = model.state_dict(), model.lc
    gammas = layer_gammas(sd, lc)
    thres = min(float(np.median(np.abs(g))) for g in gammas)
    slim_sd, slim_lc, masks = prune(sd, lc, thres)
    kept = [int(np.concatenate(m).sum()) / len(g)
            for m, g in zip(masks, gammas)]
    slim = build_pruned_csnet(slim_lc, slim_sd, device="cuda")
    say(f"  thres {thres:.6f}: kept share per prunable layer "
        f"{min(kept):.3f}..{max(kept):.3f}; parameters {count_params(model)} "
        f"-> {count_params(slim)}")
    check(len(kept) == 21 and min(kept) >= 0.5,
          "every layer keeps at least half of its channels")
    check(min(kept) <= 0.55, "a layer loses about half")

    step = make_train_step(slim, make_adam(slim), batch_size=TRAIN_BATCH,
                           compute_dtype=torch.bfloat16, from_u8=True)
    loss = [step(batches[i % len(batches)],
                 cosine_lr(LR, i, FINETUNE_STEPS), 0.0)["loss"].item()
            for i in range(FINETUNE_STEPS)]
    say(f"  {FINETUNE_STEPS} finetune steps: loss "
        f"{' '.join(f'{v:.4f}' for v in loss)}")
    check(np.isfinite(loss).all(), "finite finetune losses")
    calibrate_bn(slim, normalize_u8(batches[1]["image"][:8]))

    x = normalize_u8(batches[2]["image"][:2])
    got, launches, shapes = tail_shapes(slim, x)
    want = eval_logits(copy_of(slim, "cpu"), x.cpu())
    got = got.cpu()
    d_logit = (got - want).abs().max().item()
    d_sig = (torch.sigmoid(got) - torch.sigmoid(want)).abs().mean().item()
    std = torch.sigmoid(got).std().item()
    say(f"  slim f32 card (kernel) vs CPU (plain): max |dlogit| {d_logit:.3e}"
        f" (< 1e-3), sigmoid mean |d| {d_sig:.3e} (< 1e-5), sigmoid std "
        f"{std:.4f}, launches {launches}, channels per tail "
        f"{sorted({s[1] for s in shapes})}")
    check(d_logit < 1e-3 and d_sig < 1e-5, "slim card vs CPU parity")
    check(std > 0.01, "the slim sigmoid is not constant")
    check(launches == len(shapes), "one launch per live tail branch")

    # the tail shapes of the B=32 bf16 forward that phase 8b times: at N=32
    # the ragged widths give groups of several planes with a short last one
    x32 = normalize_u8(torch.cat([b["image"] for b in batches])[:32])
    _, launches32, shapes32 = tail_shapes(slim, x32.bfloat16())
    check(launches32 == len(shapes32) == len(shapes)
          and {s[0] for s in shapes32} == {32}, "the B=32 slim tail shapes")
    cases = sorted(set(shapes) | set(shapes32))
    rng = np.random.default_rng(8)
    for dtype in (torch.float32, torch.bfloat16):
        worst, grouped, short = 0.0, 0, 0
        for n, c, h, w in cases:
            plan = dw_chain.device_plan(n, c, h, w, dtype,
                                        torch.cuda.current_device())
            grouped += plan.planes > 1
            short += plan.planes > 1 and n * c % plan.planes != 0
            xk, params = chain_inputs(n, c, h, w, dtype, rng)
            got = dw_chain.fused_dw_chain(xk, *params)
            check(got.dtype == dtype and got.shape == xk.shape,
                  f"kernel output at slim ({n}, {c}, {h}, {w})")
            e, _ = dw_chain.check_against_plain(got, xk, params, **TOL[dtype])
            worst = max(worst, e)
        say(f"  kernel vs plain {str(dtype)[6:]} at the {len(cases)} slim "
            f"tail shapes of the B=2 and B=32 forwards ({grouped} plans of "
            f"several planes an item, {short} of them with a short last "
            f"group): worst {worst:.3e} from the plain range")
    return slim, len(shapes)


def step_ms(step, batch, reps: int) -> list:
    """Host ms of ``reps`` steps, each ending in a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(batch, LR, 1.0)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_train_times(model: CSNet, slim: CSNet, slim_calls: int,
                      batches: list, gpu: str) -> tuple[int, dict]:
    """The B=24 train step (bf16 and f32) and the slim B=32 bf16 eval
    forward, on copies of the trained models. Returns the slim forward's
    kernel launches per forward, counted over its timed run (checked
    against its ``slim_calls`` tail calls), and the bf16 step's host and
    device ms."""
    timed = copy_of(model, "cuda")
    step = make_train_step(timed, make_adam_dwd(timed), **PENALTY,
                           batch_size=TRAIN_BATCH,
                           compute_dtype=torch.bfloat16, from_u8=True)
    step_ms(step, batches[0], 3)
    torch.cuda.reset_peak_memory_stats()
    ms = float(np.median(step_ms(step, batches[1], 20)))
    peak = torch.cuda.max_memory_allocated()
    kernels, dev = profile_kernels(lambda: step(batches[2], LR, 1.0), 5)
    say(f"  train step B={TRAIN_BATCH} bf16, u8 wire, penalty on: {ms:.3f} "
        f"ms (median of 20, host clock, synchronized), "
        f"{TRAIN_BATCH / ms * 1e3:.1f} img/s; device {dev:.3f} ms per step "
        f"({1 - dev / ms:.1%} idle); peak memory {peak / 2 ** 30:.3f} GiB  "
        f"[{gpu}]")
    for e in kernels[:15]:
        t = e.self_device_time_total / 5 / 1e3
        say(f"    {t:8.4f} ms {t / dev:6.1%} {e.count / 5:7.1f}/step  "
            f"{e.key[:110]}")
    step_times = {"ms": ms, "device_ms": dev}
    del timed, step

    timed = copy_of(model, "cuda")
    step = make_train_step(timed, make_adam_dwd(timed), **PENALTY,
                           batch_size=TRAIN_BATCH, from_u8=True)
    step_ms(step, batches[0], 2)
    torch.cuda.reset_peak_memory_stats()
    ms32 = float(np.median(step_ms(step, batches[1], 10)))
    peak32 = torch.cuda.max_memory_allocated()
    kernels, dev = profile_kernels(lambda: step(batches[2], LR, 1.0), 5)
    step_times["ms_f32"] = ms32
    say(f"  train step B={TRAIN_BATCH} f32: {ms32:.3f} ms (median of 10), "
        f"{TRAIN_BATCH / ms32 * 1e3:.1f} img/s; device {dev:.3f} ms per "
        f"step ({1 - dev / ms32:.1%} idle); peak memory "
        f"{peak32 / 2 ** 30:.3f} GiB  [{gpu}]")
    for e in kernels[:6]:
        t = e.self_device_time_total / 5 / 1e3
        say(f"    {t:8.4f} ms {t / dev:6.1%} {e.count / 5:7.1f}/step  "
            f"{e.key[:110]}")
    del timed, step

    images = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (32, *HW, 3), np.uint8)).cuda()
    evaluate = make_eval_step(slim, from_u8=True,
                              compute_dtype=torch.bfloat16)
    for _ in range(3):
        evaluate(images)
    torch.cuda.synchronize()
    dw_chain.launches = 0
    t0 = time.perf_counter()
    for _ in range(20):
        evaluate(images)
    torch.cuda.synchronize()
    fwd = (time.perf_counter() - t0) / 20 * 1e3
    launches = dw_chain.launches
    dev, dev_by = device_ms(lambda: evaluate(images))
    say(f"  slim eval forward B=32 bf16 224^2, u8 on the card: {fwd:.3f} ms "
        f"per forward (host clock, 20 forwards, synchronized), device "
        f"{dev:.3f} ms by {dev_by} ({1 - dev / fwd:.1%} idle), {launches} "
        f"kernel launches in the 20 forwards  [{gpu}]")
    check(launches == 20 * slim_calls,
          f"{launches} launches in 20 slim forwards, want 20 x {slim_calls}")
    return launches // 20, step_times


# ---------------------------------------------------------------------------
# The dataset on the card (phase 9)

SPLIT_N = 1000          # ECSSD, the reference's own test set, has 1,000
SPLIT_HW = (300, 400)   # about ECSSD's image size; orientation alternates
SWEEP_BATCH = 32
PARITY_IMAGES = 64
PNG_RATE_PAIRS = 100    # read on one thread for the host's PNG rate
STORE_HW = (256, 256)   # the resident training store (the JAX default)
# the epoch's store: the split's first 480 pairs (20 steps at B=24), cut
# from 1,000 to keep phase 9 near a minute on a slow host
EPOCH_PAIRS = 480
MAX_CROP = 17           # 15 px at 224 expressed at the 256 store scale
DUTS_TR_N = 10553       # DUTS-TR, the reference's training set
# the JAX package's bars for the sweep against the host protocol
# (tests/test_device_pipeline.py:347-355)
SWEEP_BARS = dict(scalar=1e-4, curve=2e-4, wf=5e-4)


class FirstItems:
    """The first ``n`` items of a dataset with the ``_decode_u8`` interface."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self) -> int:
        return self.n

    def _decode_u8(self, i: int):
        return self.ds._decode_u8(i)


class InMemoryPairs:
    """``n`` items with the ``_decode_u8`` interface, cycling a small pool
    of seeded store-size pairs (a DUTS-TR-sized dataset without its files
    or its host memory)."""

    def __init__(self, n: int, hw, pool: int = 16, seed: int = 11):
        rng = np.random.default_rng(seed)
        self.n = n
        self.pairs = [(rng.integers(0, 256, (*hw, 3), np.uint8),
                       (rng.random(hw) > 0.5).astype(np.uint8) * 255)
                      for _ in range(pool)]

    def __len__(self) -> int:
        return self.n

    def _decode_u8(self, i: int):
        return self.pairs[i % len(self.pairs)]


def nbytes(data: dict) -> int:
    return sum(v.numel() * v.element_size() for v in data.values()
               if isinstance(v, torch.Tensor))


def check_metric_ranges(res: dict, what: str) -> None:
    """Every metric finite and in its range; E-measure may pass 1 by
    n/(n-1) on degenerate GTs (PySODMetrics' normalization)."""
    for k in ("mae", "max_f", "mean_f", "adaptive_f", "s_measure",
              "weighted_f", "precision", "recall"):
        v = np.asarray(res[k])
        check(np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all(),
              f"{what}: {k} finite and in [0, 1]")
    for k in ("emeasure", "adaptive_e"):
        v = np.asarray(res[k])
        check(np.isfinite(v).all() and (v >= 0).all() and (v <= 1.001).all(),
              f"{what}: {k} finite and in [0, 1.001]")


def result_distance(got: dict, want: dict) -> dict:
    """Largest |difference| per metric group."""
    return {
        "scalar": max(abs(got[k] - want[k]) for k in (
            "mae", "max_f", "adaptive_f", "adaptive_e", "s_measure")),
        "curve": max(float(np.abs(got[k] - want[k]).max())
                     for k in ("precision", "recall", "emeasure")),
        "wf": abs(got["weighted_f"] - want["weighted_f"])}


def check_results_close(got: dict, want: dict, what: str) -> None:
    d = result_distance(got, want)
    say(f"  {what}: MAE/maxF/adpF/adpE/S max |d| {d['scalar']:.3e} "
        f"(<= {SWEEP_BARS['scalar']:g}), P/R/E curves {d['curve']:.3e} "
        f"(<= {SWEEP_BARS['curve']:g}), wF {d['wf']:.3e} "
        f"(<= {SWEEP_BARS['wf']:g})")
    check(all(d[k] <= SWEEP_BARS[k] for k in d), what)


def phase_split(split_dir: str) -> tuple:
    """9a: write the synthetic split, read it back through SalData, check
    the first pair bit-equal to the arrays written; the host PNG read rate
    (one thread, every pair, filling SalData's cache)."""
    t0 = time.perf_counter()
    make_synth_split(split_dir, SPLIT_N, hw=SPLIT_HW)
    t_write = time.perf_counter() - t0
    ds = SalData(split_dir, HW, mode="val", cache=True)
    check(len(ds) == SPLIT_N, f"{len(ds)} pairs in the split")

    def read(i):
        return sum(a.nbytes for a in ds._decode_u8(i))

    t0 = time.perf_counter()
    raw1 = sum(read(i) for i in range(PNG_RATE_PAIRS))
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        raw = sum(pool.map(read, range(PNG_RATE_PAIRS, SPLIT_N)))
    t_read = time.perf_counter() - t0
    n_rest = SPLIT_N - PNG_RATE_PAIRS
    img, gt = next(synth_pairs(1, hw=SPLIT_HW))
    item = ds.raw_item(0)
    same = (np.array_equal(item["image_u8"], img)
            and np.array_equal(item["gt_u8"], gt))
    files = sum(os.path.getsize(os.path.join(split_dir, d, f))
                for d in ("images", "GT")
                for f in os.listdir(os.path.join(split_dir, d)))
    say(f"  wrote {SPLIT_N} PNG pairs at {SPLIT_HW} (alternating "
        f"orientation), {files / 1e6:.1f} MB, in {t_write:.2f} s; read back: "
        f"{PNG_RATE_PAIRS} pairs on one host thread at "
        f"{PNG_RATE_PAIRS / t_one:.1f} pairs/s ({raw1 / t_one / 1e6:.1f} MB/s "
        f"decoded), the other {n_rest} on 8 threads at "
        f"{n_rest / t_read:.1f} pairs/s ({raw / t_read / 1e6:.1f} MB/s); "
        f"pair 0 bit-equal to the arrays written: {same}")
    check(same, "pair 0 reads back bit-equal")
    check(ds._decode_u8(1)[1].shape == SPLIT_HW[::-1],
          "orientation alternates")
    return ds, {"png_pairs_s": PNG_RATE_PAIRS / t_one,
                "png_mb_s": raw1 / t_one / 1e6,
                "png_pairs_s_8": n_rest / t_read,
                "png_mb_s_8": raw / t_read / 1e6}


def host_protocol(model: CSNet, ds, n: int, batch: int) -> dict:
    """The host protocol on the card for the first ``n`` pairs: the u8
    resize to the test size, an f32 forward on the card at ``batch`` images
    a call (cli/common.py val_mae batches its forward too); per image, the
    f32 resize back to native size on the host and trunc(x * 255); then
    SalMetricAccumulator and s_measure_batch on the card and the host
    weighted_f_measure."""
    acc = SalMetricAccumulator()
    evaluate = make_eval_step(model, from_u8=True)
    pairs = [ds._decode_u8(i) for i in range(n)]
    x = torch.from_numpy(np.stack([resize_u8_linear(img, HW)
                                   for img, _ in pairs])).cuda()
    preds = torch.cat([evaluate(x[b:b + batch])[..., 0]
                       for b in range(0, n, batch)]).cpu().numpy()
    single = torch.cat([evaluate(x[i:i + 1])[..., 0]
                        for i in range(n)]).cpu().numpy()
    s_sum = wf_sum = 0.0
    for pred, (_, gt) in zip(preds, pairs):
        sal255 = np.trunc(resize_f32_linear(pred, gt.shape) * 255.0)
        acc.update_batch(sal255[None], gt[None])
        s_sum += s_measure_batch(
            torch.from_numpy(sal255[None] / 255.0).cuda(),
            torch.from_numpy((gt[None] > 128).astype(np.float32)).cuda()
        ).item()
        wf_sum += weighted_f_measure(sal255 / 255.0, gt > 128)
    res = acc.result()
    res["s_measure"] = s_sum / n
    res["weighted_f"] = wf_sum / n
    return res, preds, single


def phase_sweep(model: CSNet, ds, gpu: str) -> dict:
    """9b: the TESTALL sweep over the whole split, resident on the card,
    in f32 and bf16 at B=32; launches; ranges; the f32 sweep's first 64
    images against the port on the CPU and against the host protocol."""
    t0 = time.perf_counter()
    data = build_resident_val_dataset(ds, HW, SWEEP_BATCH,
                                      with_wf_tables=True)
    t_build = time.perf_counter() - t0
    canvas = data.pop("_canvas_hw")
    nb = data["image_u8"].shape[0] // SWEEP_BATCH
    wf = data["wf_idx"].nbytes + data["wf_weight"].nbytes
    say(f"  store on the card: {nbytes(data) / 1e9:.3f} GB ({wf / 1e9:.3f} "
        f"GB of wF tables), canvas {canvas}, {nb} batches of "
        f"{SWEEP_BATCH}; built in {t_build:.2f} s (decodes cached)")
    out = {"data": data, "canvas": canvas, "nb": nb}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        fn = make_resident_salmetric_fn(
            make_eval_step(model, from_u8=True, compute_dtype=dtype),
            batch_size=SWEEP_BATCH, canvas_hw=canvas)
        dw_chain.launches = 0
        t0 = time.perf_counter()
        sums = fn(data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dw_chain.launches
        res = result_from_sums(sums)
        say(f"  {name} sweep of {SPLIT_N} images (first run, warm-up "
            f"included): {dt:.2f} s; MAE {res['mae']:.5f}, maxF "
            f"{res['max_f']:.5f}, meanF {res['mean_f']:.5f}, adpF "
            f"{res['adaptive_f']:.5f}, maxE {res['max_e']:.5f}, adpE "
            f"{res['adaptive_e']:.5f}, S {res['s_measure']:.5f}, wF "
            f"{res['weighted_f']:.5f}; {launches} kernel launches")
        check(launches == CALLS_PER_FORWARD * nb,
              f"{launches} launches in the {name} sweep, want "
              f"{CALLS_PER_FORWARD} x {nb}")
        check_metric_ranges(res, f"{name} sweep")
        out[name] = (sums, res)
    d = result_distance(out["bf16"][1], out["f32"][1])
    say(f"  bf16 sweep against f32 (not gated): scalars {d['scalar']:.3e}, "
        f"curves {d['curve']:.3e}, wF {d['wf']:.3e}")

    first = PARITY_IMAGES // SWEEP_BATCH
    card = result_from_sums({k: v[:first] for k, v in out["f32"][0].items()})
    sub = FirstItems(ds, PARITY_IMAGES)
    cpu_data = build_resident_val_dataset(sub, HW, SWEEP_BATCH, device="cpu",
                                          with_wf_tables=True)
    cpu_canvas = cpu_data.pop("_canvas_hw")
    t0 = time.perf_counter()
    cpu = result_from_sums(make_resident_salmetric_fn(
        make_eval_step(copy_of(model, "cpu"), from_u8=True),
        batch_size=SWEEP_BATCH, canvas_hw=cpu_canvas)(cpu_data))
    say(f"  the port on the CPU, first {PARITY_IMAGES} images, in "
        f"{time.perf_counter() - t0:.1f} s")
    check_results_close(card, cpu, f"f32 sweep on the card vs the CPU, first "
                        f"{PARITY_IMAGES} images")
    host, preds, single = host_protocol(model, ds, PARITY_IMAGES,
                                        SWEEP_BATCH)
    check_results_close(card, host, f"f32 sweep vs the host protocol on the "
                        f"card, first {PARITY_IMAGES} images")
    flips = int((np.trunc(preds * 255) != np.trunc(single * 255)).sum())
    say(f"  f32 maps of a B=1 forward per image against the B={SWEEP_BATCH} "
        f"forward (not gated): max |d| {np.abs(preds - single).max():.3e}, "
        f"{flips} of {preds.size} quantized levels differ")
    out["launches_per_forward"] = CALLS_PER_FORWARD
    return out


def metric_batch(ds, canvas) -> tuple:
    """One padded batch of 32 on the canvas: the split's first 29 GTs with
    a seeded noisy map around each, an all-background GT, an
    all-foreground GT and an all-masked row."""
    rng = np.random.default_rng(12)
    n = SWEEP_BATCH
    sal = np.zeros((n, *canvas), np.float32)
    gt = np.zeros((n, *canvas), np.uint8)
    mask = np.zeros((n, *canvas), np.float32)
    hw = np.zeros((n, 2), np.int32)
    for i in range(n - 1):
        g = ds._decode_u8(i)[1].copy()
        if i == n - 3:
            g[:] = 0
        elif i == n - 2:
            g[:] = 255
        h, w = g.shape
        gt[i, :h, :w] = g
        sal[i, :h, :w] = np.trunc(np.clip(
            g * 0.7 + rng.normal(40, 50, g.shape), 0, 255))
        mask[i, :h, :w] = 1.0
        hw[i] = (h, w)
    return sal, gt, mask, hw


def metric_outputs(sal, gt, mask, tables, device) -> dict:
    t = {k: torch.from_numpy(v).to(device) for k, v in
         dict(sal=sal, gt=gt, mask=mask, **tables).items()}
    gtf = t["gt"].float()
    out = dict(zip(("a", "tp", "b", "n"), salmetric.threshold_counts(
        t["sal"], gtf, t["mask"])))
    out.update(zip(("mae", "p", "r", "e"), salmetric.per_image_stats(
        t["sal"], gtf, t["mask"])))
    out["af"] = salmetric.adaptive_f_per_image(t["sal"], gtf, t["mask"])
    out["ae"] = salmetric.adaptive_e_per_image(t["sal"], gtf, t["mask"])
    out["s"] = s_measure_batch(t["sal"] / 255.0, (gtf > 128).float(),
                               t["mask"])
    out["wf"] = wf_per_image_device(t["sal"] / 255.0, t["gt"], t["mask"],
                                    t["wf_idx"], t["wf_weight"])
    return {k: v.cpu() for k, v in out.items()}


def phase_metrics(ds, canvas) -> None:
    """9c: the metric functions alone, card against CPU, on one padded
    batch of 32 with degenerate GTs and an all-masked row."""
    sal, gt, mask, hw = metric_batch(ds, canvas)
    tables = precompute_wf_tables(gt, hw)
    cpu = metric_outputs(sal, gt, mask, tables, "cpu")
    card = metric_outputs(sal, gt, mask, tables, "cuda")
    counts = all(torch.equal(card[k], cpu[k]) for k in ("a", "tp", "b", "n"))
    bars = {"mae": 1e-6, "p": 1e-6, "r": 1e-6, "e": 1e-6, "af": 1e-6,
            "ae": 1e-6, "s": 1e-5, "wf": 1e-5}
    d = {k: float(torch.nan_to_num(card[k] - cpu[k]).abs().max())
         for k in bars}
    same_nan = all(torch.equal(card[k].isnan(), cpu[k].isnan()) for k in bars)
    say(f"  batch of {SWEEP_BATCH} on {canvas}: counts bit-equal {counts}; "
        + ", ".join(f"{k} {v:.2e} (<= {bars[k]:g})" for k, v in d.items())
        + f"; adaptive F/E of the all-masked row {card['af'][-1]:.1f}/"
        f"{card['ae'][-1]:.1f}")
    check(counts, "threshold counts bit-equal, card vs CPU")
    check(same_nan and all(d[k] <= bars[k] for k in bars),
          "metrics card vs CPU")
    check(card["af"][-1] == 0 and card["ae"][-1] == 0,
          "the all-masked row scores 0")


def phase_epoch(model: CSNet, ds, sweep: dict, gpu: str) -> dict:
    """9d: a resident training epoch (a 256^2 store of the split's first
    EPOCH_PAIRS pairs, B=24 bf16 Adam-dwd, penalty on, max_crop 17, an
    explicit generator), then the
    resident validation against the host protocol; the same seed twice in
    f32 on one batch; a DUTS-TR-sized store."""
    t0 = time.perf_counter()
    store = build_resident_dataset(FirstItems(ds, EPOCH_PAIRS), STORE_HW)
    say(f"  training store {tuple(store['image_u8'].shape)}: "
        f"{nbytes(store) / 1e6:.1f} MB on the card, built in "
        f"{time.perf_counter() - t0:.2f} s")
    trained = copy_of(model, "cuda")
    step = make_train_step(trained, make_adam_dwd(trained), **PENALTY,
                           batch_size=TRAIN_BATCH,
                           compute_dtype=torch.bfloat16)
    epoch = make_resident_epoch_fn(step, batch_size=TRAIN_BATCH, out_hw=HW,
                                   max_crop=MAX_CROP)
    gen = torch.Generator(device="cuda").manual_seed(9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, pens = epoch(store, gen, LR, 1.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nb = len(losses)
    losses, pens = losses.cpu().numpy(), pens.cpu().numpy()
    say(f"  epoch of {nb} steps ({nb * TRAIN_BATCH} images) in {dt:.2f} s: "
        f"{nb * TRAIN_BATCH / dt:.1f} img/s, {dt / nb * 1e3:.1f} ms per step "
        f"(first epoch, warm-up included); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, penalty {pens[0]:.1f} -> {pens[-1]:.1f}")
    check(np.isfinite(losses).all() and np.isfinite(pens).all(),
          "finite epoch losses")

    data, canvas = sweep["data"], sweep["canvas"]
    evaluate = make_eval_step(trained, from_u8=True)
    mae = make_resident_val_fn(evaluate, batch_size=SWEEP_BATCH,
                               canvas_hw=canvas)(data).item()
    hws, gts = data["hw"].cpu().numpy(), data["gt_u8"].cpu().numpy()
    preds = torch.cat([
        evaluate(data["image_u8"][b:b + SWEEP_BATCH])[..., 0]
        for b in range(0, SPLIT_N, SWEEP_BATCH)]).cpu().numpy()

    def image_mae(j: int) -> float:
        h, w = hws[j]
        q = np.trunc(resize_f32_linear(preds[j], (h, w)) * 255.0) / 255.0
        return float(np.abs(q - gts[j, :h, :w] / 255.0).mean())

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        host = sum(pool.map(image_mae, range(SPLIT_N))) / SPLIT_N
    say(f"  resident val MAE {mae:.6f}, host protocol on the card "
        f"{host:.6f}: |d| {abs(mae - host):.2e} (<= 1e-4)")
    check(abs(mae - host) <= 1e-4, "resident val MAE vs the host protocol")

    one = {k: v[:TRAIN_BATCH] for k, v in store.items()}
    again = []
    for _ in range(2):
        m = copy_of(model, "cuda")
        f32_step = make_train_step(m, make_adam_dwd(m), **PENALTY,
                                   batch_size=TRAIN_BATCH)
        g = torch.Generator(device="cuda").manual_seed(5)
        again.append(make_resident_epoch_fn(
            f32_step, batch_size=TRAIN_BATCH, out_hw=HW,
            max_crop=MAX_CROP)(one, g, LR, 1.0)[0].item())
    say(f"  one f32 batch, the same generator seed twice: losses "
        f"{again[0]:.8f} and {again[1]:.8f}")
    check(abs(again[0] - again[1]) <= 1e-6 * abs(again[0]),
          "the same seed gives the same loss")

    # the idle share: the profiler's device time over a 4-step epoch
    four = {k: v[:4 * TRAIN_BATCH] for k, v in store.items()}
    kernels, dev = profile_kernels(lambda: epoch(four, gen, LR, 1.0), 1)
    dev_step = dev / 4
    say(f"  epoch step: device {dev_step:.3f} ms by the profiler (4 steps), "
        f"host {dt / nb * 1e3:.3f} ms: {1 - dev_step / (dt / nb * 1e3):.1%} "
        f"idle  [{gpu}]")
    del store, trained, step, epoch

    t0 = time.perf_counter()
    big = build_resident_dataset(InMemoryPairs(DUTS_TR_N, STORE_HW), STORE_HW)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    say(f"  a DUTS-TR-sized store ({DUTS_TR_N} pairs at {STORE_HW}, in "
        f"memory): {nbytes(big) / 1e9:.3f} GB on the card, built in "
        f"{t_big:.2f} s")
    del big
    return {"img_s": nb * TRAIN_BATCH / dt, "step_ms": dt / nb * 1e3,
            "device_step_ms": dev_step}


def phase_dataset_times(model: CSNet, sweep: dict, epoch: dict,
                        train_step: dict, split: dict, gpu: str) -> None:
    """9e: sweep img/s at B=32 bf16 with and without wF; the profiler's
    device time per batch, forward against metrics; the epoch beside phase
    8b's step; the PNG read rate; whether OpenCV's C++ library is there."""
    data, canvas = sweep["data"], sweep["canvas"]
    evaluate = make_eval_step(model, from_u8=True,
                              compute_dtype=torch.bfloat16)
    no_wf = {k: v for k, v in data.items() if not k.startswith("wf_")}
    fn = make_resident_salmetric_fn(evaluate, batch_size=SWEEP_BATCH,
                                    canvas_hw=canvas)
    times = {"with wF": [], "without wF": []}
    for what in ("with wF", "without wF", "without wF", "with wF"):
        d = data if what == "with wF" else no_wf
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(d)
        torch.cuda.synchronize()
        times[what].append(time.perf_counter() - t0)
    for what, ts in times.items():
        say(f"  sweep B={SWEEP_BATCH} bf16 {what}: "
            + ", ".join(f"{SPLIT_N / t:.1f}" for t in ts)
            + f" img/s in two runs ({', '.join(f'{t / sweep['nb'] * 1e3:.2f}'
                                            for t in ts)} ms per batch)  "
            f"[{gpu}]")
    wall_batch = min(times["with wF"]) / sweep["nb"] * 1e3

    one = {k: v[:SWEEP_BATCH] for k, v in data.items()}
    fn = make_resident_salmetric_fn(evaluate, batch_size=SWEEP_BATCH,
                                    canvas_hw=canvas)
    pred = evaluate(one["image_u8"])
    # the stage after the forward alone: the same sweep fed this forward
    rest_fn = make_resident_salmetric_fn(lambda img: pred,
                                         batch_size=SWEEP_BATCH,
                                         canvas_hw=canvas)
    _, total = profile_kernels(lambda: fn(one), 3)
    _, fwd = profile_kernels(lambda: evaluate(one["image_u8"]), 3)
    rest_kernels, rest = profile_kernels(lambda: rest_fn(one), 3)
    say(f"  per batch (bf16, with wF), profiler: device {total:.3f} ms; the "
        f"forward alone {fwd:.3f} ms, the rest alone (resize back, "
        f"quantization, metrics) {rest:.3f} ms; wall {wall_batch:.3f} ms per "
        f"batch in the sweep: {1 - total / wall_batch:.1%} idle  [{gpu}]")
    for e in rest_kernels[:8]:
        t = e.self_device_time_total / 3 / 1e3
        say(f"    {t:8.4f} ms {t / rest:6.1%} {e.count / 3:6.1f}/batch  "
            f"{e.key[:100]}")
    say(f"  epoch {epoch['img_s']:.1f} img/s, {epoch['step_ms']:.3f} ms per "
        f"step, device {epoch['device_step_ms']:.3f} ms "
        f"({1 - epoch['device_step_ms'] / epoch['step_ms']:.1%} idle); phase "
        f"8b's step on blob batches: {train_step['ms']:.3f} ms, device "
        f"{train_step['device_ms']:.3f} ms "
        f"({1 - train_step['device_ms'] / train_step['ms']:.1%} idle)  "
        f"[{gpu}]")
    say(f"  PNG read on the host: {split['png_pairs_s']:.1f} pairs/s, "
        f"{split['png_mb_s']:.1f} MB/s decoded on one thread; "
        f"{split['png_pairs_s_8']:.1f} pairs/s, {split['png_mb_s_8']:.1f} "
        f"MB/s on 8")
    try:
        rc = subprocess.run(["pkg-config", "--exists", "opencv4"]).returncode
        found = "found" if rc == 0 else "not found"
    except FileNotFoundError:
        found = "no pkg-config"
    say(f"  OpenCV 4 C++ library (pkg-config --exists opencv4, for the "
        f"native SalMetric later): {found}")


# ---------------------------------------------------------------------------
# CSF+Res2Net on the card (phase 10)

CSF_HW = (336, 336)       # the README's CSF configurations
CSF_ODD_HW = (301, 401)   # non-integer octave resizes, ceil-mode pools
CSF_TRAIN_HW = (224, 224)
CSF_STORE_PAIRS = 160     # 20 micro-steps at B=8
CSF_BATCH = 8
CSF_ITER = 2
CSF_LR, CSF_WD = 5e-5, 5e-4   # the reference Solver's recipe
CSF_LST_SIZES = [(300, 400), (295, 390), (290, 385), (310, 410)]


def disc_images(rng, n: int, hw) -> np.ndarray:
    """``n`` uint8 images at ``hw``: a disc of one colour at a random place
    on noise, so that saliency maps differ from image to image."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    for i in range(n):
        cy, cx = int(rng.integers(h // 4, 3 * h // 4)), \
            int(rng.integers(w // 4, 3 * w // 4))
        r = int(rng.integers(min(h, w) // 8, min(h, w) // 3))
        img[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(
            0, 256, 3)
    return img


def csf_logits(model: CSFNet, x: torch.Tensor) -> torch.Tensor:
    model.eval()
    with torch.no_grad():
        return model(x).float()


def csf_on(model: CSFNet, device: str) -> CSFNet:
    return copy.deepcopy(model).to(device)


def phase_csf_forward() -> CSFNet:
    """10a: Res2Net-50 at B=2, 336^2 and 301x401, and Res2Net-101 at B=1,
    336^2, f32, the seeded reference init: card against the CPU. Returns
    the Res2Net-50 model (CPU)."""
    rng = np.random.default_rng(20)
    r50 = None
    for backbone, n, shapes in (("res2net50", 2, (CSF_HW, CSF_ODD_HW)),
                                ("res2net101", 1, (CSF_HW,))):
        cpu = CSFNet(backbone, seed=0, device="cpu")
        card = csf_on(cpu, "cuda")
        for hw in shapes:
            x = normalize_u8(torch.from_numpy(disc_images(rng, n, hw)))
            t0 = time.perf_counter()
            want = csf_logits(cpu, x)
            t_cpu = time.perf_counter() - t0
            got = csf_logits(card, x.cuda()).cpu()
            d_logit = (got - want).abs().max().item()
            d_sig = (torch.sigmoid(got) - torch.sigmoid(want)).abs().mean()
            std = torch.sigmoid(got).std().item()
            say(f"  {backbone} f32 card vs CPU, {n}x{hw[0]}x{hw[1]}: max "
                f"|dlogit| {d_logit:.3e} (< 1e-3), sigmoid mean |d| "
                f"{d_sig.item():.3e} (< 1e-5), sigmoid std {std:.4f}, logit "
                f"range [{want.min().item():.3f}, {want.max().item():.3f}]; "
                f"the CPU forward {t_cpu:.1f} s")
            check(got.shape == (n, *hw, 1) and bool(torch.isfinite(got).all()),
                  f"{backbone} output at {hw}")
            check(d_logit < 1e-3 and d_sig.item() < 1e-5,
                  f"{backbone} card vs CPU at {hw}")
            check(std > 1e-3, f"{backbone} map at {hw} is not constant")
        if backbone == "res2net50":
            r50 = cpu
        del card
    return r50


def phase_csf_serving(model_cpu: CSFNet) -> None:
    """10b: a Res2Net-50 artifact at 336^2, bf16 then f32 compute, u8 wire,
    buckets (1, 8), served over HTTP: 8 requests from 2 client threads."""
    rng = np.random.default_rng(21)
    requests = [disc_images(rng, int(rng.integers(1, 5)), CSF_HW)
                for _ in range(8)]
    for dtype in (torch.bfloat16, torch.float32):
        say(f"  {str(dtype)[6:]} compute")
        with tempfile.TemporaryDirectory() as artifact:
            sm, _ = phase_serving(model_cpu, artifact, dtype, hw=CSF_HW,
                                  buckets=(1, 8), requests=requests,
                                  clients=2, calls=0)
            check(sm.meta["family"] == "csf"
                  and sm.model.backbone == "res2net50", "a CSF artifact")
        del sm


def trainable_state(model: CSFNet) -> tuple[dict, dict]:
    """Copies of the trainable parameters and of everything else in the
    state_dict (frozen parameters, BN statistics)."""
    train = {n for n, p in model.named_parameters() if p.requires_grad}
    sd = model.state_dict()
    return ({k: v.clone() for k, v in sd.items() if k in train},
            {k: v.clone() for k, v in sd.items() if k not in train})


def phase_csf_train_f32(model_cpu: CSFNet) -> None:
    """10c: one masked f32 micro-step at B=1, 224^2, card against CPU; then
    iter_size 2 on the card: nothing moves on micro-step 1, the trainable
    tensors move on 2, the frozen ones and the BN statistics do not."""
    rng = np.random.default_rng(22)
    img = disc_images(rng, 1, CSF_TRAIN_HW)
    mask = np.zeros((1, *CSF_TRAIN_HW, 1), np.float32)
    mask[:, :180, :200] = 1.0  # a padded sample's real pixels
    batch = {"image": torch.from_numpy(img),
             "target": torch.from_numpy(((img[..., :1] > 127) * 255)
                                        .astype(np.uint8)),
             "mask": torch.from_numpy(mask)}
    out, models, steps = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = csf_on(model_cpu, dev)
        freeze_reference_params(model)
        step = make_csf_train_step(model, make_csf_optimizer(model, CSF_WD),
                                   iter_size=2, batch_size=1, from_u8=True)
        t0 = time.perf_counter()
        out[dev] = step(batch, CSF_LR)["loss"].item()
        say(f"  {dev}: loss {out[dev]:.7f}, micro-step "
            f"{time.perf_counter() - t0:.1f} s")
        models[dev], steps[dev] = model, step
    rel = abs(out["cuda"] - out["cpu"]) / abs(out["cpu"])
    grads = {dev: {n: p.grad.double() for n, p in m.named_parameters()
                   if p.requires_grad} for dev, m in models.items()}
    errs, g_all = tensors_close(grads["cpu"], grads["cuda"])
    say(f"  f32 card vs CPU: loss rel {rel:.2e} (< 1e-4), gradients L2-rel "
        f"global {g_all:.2e} (< 2e-3), worst tensor {max(errs):.2e} over "
        f"{len(errs)} trainable tensors")
    check(rel < 1e-4, "CSF loss, card vs CPU")
    check(g_all < 2e-3, "CSF gradients, card vs CPU")

    model, step = models["cuda"], steps["cuda"]
    train0, frozen0 = trainable_state(model)
    sd = model.state_dict()
    still = all(torch.equal(sd[k], v) for k, v in {**train0, **frozen0}.items())
    step(batch, CSF_LR)
    train1, frozen1 = trainable_state(model)
    moved = sum(not torch.equal(v, train0[k]) for k, v in train1.items())
    kept = all(torch.equal(v, frozen0[k]) for k, v in frozen1.items())
    say(f"  iter_size 2: micro-step 1 left every tensor as it was: {still}; "
        f"micro-step 2 moved {moved} of {len(train1)} trainable tensors; the "
        f"{len(frozen1)} frozen tensors and BN statistics bit-unchanged: "
        f"{kept}")
    check(still and moved == len(train1) and kept,
          "accumulation: apply on micro-step 2 only, frozen tensors kept")


def csf_store(split_dir: str) -> dict:
    """The resident 336^2 store of the split's first CSF_STORE_PAIRS pairs,
    read through a .lst file and ``CSFTrainData``."""
    names = sorted(os.listdir(os.path.join(split_dir, "images")))
    lst = os.path.join(split_dir, "csf_train.lst")
    with open(lst, "w") as f:
        f.writelines(f"images/{n} GT/{n}\n" for n in names[:CSF_STORE_PAIRS])
    t0 = time.perf_counter()
    store = build_resident_dataset(CSFTrainData(split_dir, lst), CSF_HW)
    torch.cuda.synchronize()
    say(f"  CSF store {tuple(store['image_u8'].shape)}: "
        f"{nbytes(store) / 1e6:.1f} MB on the card, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return store


def phase_csf_epoch(model_cpu: CSFNet, store: dict, gpu: str) -> dict:
    """10d: the resident CSF epoch (B=8 bf16, the recipe's Adam, iter_size
    2, 20 micro-steps) over the 336^2 store; then the trained model's f32
    eval against a fresh load, and remat against the plain f32 step."""
    model = csf_on(model_cpu, "cuda")
    freeze_reference_params(model)
    train0, frozen0 = trainable_state(model)
    step = make_csf_train_step(model, make_csf_optimizer(model, CSF_WD),
                               iter_size=CSF_ITER, batch_size=CSF_BATCH,
                               compute_dtype=torch.bfloat16)
    epoch = make_resident_csf_epoch_fn(step, batch_size=CSF_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(10)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = epoch(store, gen, CSF_LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            checked = losses.cpu().numpy()
            train1, frozen1 = trainable_state(model)
    nb = len(checked)
    say(f"  epoch 1: {nb} micro-steps ({nb * CSF_BATCH} images) in "
        f"{times[0]:.2f} s (warm-up included); loss "
        f"{' '.join(f'{v:.4f}' for v in checked)}")
    moved = sum(not torch.equal(v, train0[k]) for k, v in train1.items())
    kept = all(torch.equal(v, frozen0[k]) for k, v in frozen1.items())
    say(f"  {moved} of {len(train1)} trainable tensors moved; frozen "
        f"tensors and BN statistics bit-unchanged: {kept}")
    check(nb == CSF_STORE_PAIRS // CSF_BATCH and np.isfinite(checked).all(),
          "finite CSF epoch losses")
    check(moved == len(train1) and kept, "the epoch trains what it should")
    img_s = nb * CSF_BATCH / times[1]
    say(f"  epoch 2: {img_s:.1f} img/s, {times[1] / nb * 1e3:.2f} ms per "
        f"micro-step  [{gpu}]")

    x = normalize_u8(store["image_u8"][:2])
    fresh = CSFNet(model.backbone, device="cuda")
    fresh.load_state_dict(model.state_dict(), strict=True)
    d_fresh = (csf_logits(model, x) - csf_logits(fresh, x)).abs().max().item()
    say(f"  trained f32 eval vs a fresh load: max |dlogit| {d_fresh:.2e} "
        f"(<= 1e-5)")
    check(d_fresh <= 1e-5, "trained eval equals a fresh load")
    del fresh

    batch = {"image": x, "target": store["gt_u8"][:2, ..., None].float()
             / 255.0}
    grads = []
    for remat in (False, True):
        m = csf_on(model, "cuda")
        freeze_reference_params(m)
        make_csf_train_step(m, make_csf_optimizer(m, CSF_WD), iter_size=2,
                            batch_size=2, remat=remat)(batch, CSF_LR)
        grads.append({n: p.grad.double() for n, p in m.named_parameters()
                      if p.requires_grad})
        del m
    _, g_remat = tensors_close(*grads)
    say(f"  remat vs plain f32 step (B=2, 336^2): gradients L2-rel "
        f"{g_remat:.2e} (< 1e-5)")
    check(g_remat < 1e-5, "remat gives the plain step's gradients")
    return {"img_s": img_s, "ms": times[1] / nb * 1e3}


def phase_csf_lst(model_cpu: CSFNet) -> None:
    """10e: a 4-pair .lst split (PNG) through CSFTrainData and
    padded_batches (bucket 32) into one masked f32 step on the card,
    against the native-size loss of the same samples (rel 2e-2: the loss
    pixels are the same, convolutions near the padding see zeros)."""
    rng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory() as root:
        for d in ("img", "gt"):
            os.makedirs(os.path.join(root, d))
        lines = []
        for i, hw in enumerate(CSF_LST_SIZES):
            img = disc_images(rng, 1, hw)[0]
            write_png(os.path.join(root, "img", f"{i}.png"), img)
            write_png(os.path.join(root, "gt", f"{i}.png"),
                      ((img[..., 0] > 127) * 255).astype(np.uint8))
            lines.append(f"img/{i}.png gt/{i}.png\n")
        with open(os.path.join(root, "train.lst"), "w") as f:
            f.writelines(lines)
        ds = CSFTrainData(root, os.path.join(root, "train.lst"), seed=0)
        batches = list(padded_batches(ds, len(CSF_LST_SIZES), bucket=32,
                                      shuffle=False))
    check(len(batches) == 1, "one bucket")
    b = batches[0]
    model = csf_on(model_cpu, "cuda")
    freeze_reference_params(model)
    n = len(CSF_LST_SIZES)
    padded = make_csf_train_step(model, make_csf_optimizer(model, CSF_WD),
                                 iter_size=1, batch_size=n)(b, 0.0)
    padded = padded["loss"].item()
    native = 0.0
    for i in range(n):
        rows = b["mask"][i, :, 0, 0] > 0
        cols = b["mask"][i, 0, :, 0] > 0
        h, w = int(rows.sum()), int(cols.sum())
        x = torch.from_numpy(b["image"][i:i + 1, :h, :w].copy()).cuda()
        t = torch.from_numpy(b["target"][i:i + 1, :h, :w].copy()).cuda()
        native += csf_loss(csf_logits(model, x), t, None, 1, n).item()
    rel = abs(padded - native) / abs(native)
    say(f"  {n} pairs {CSF_LST_SIZES} in one {tuple(b['image'].shape[1:3])} "
        f"bucket: masked loss {padded:.6f}, native-size loss {native:.6f}, "
        f"rel {rel:.2e} (<= 2e-2)")
    check(np.isfinite(padded) and rel <= 2e-2, "masked loss vs native")


def time_forward(model: CSFNet, n: int, reps: int) -> tuple:
    """The bf16 eval forward at 336^2 on u8 input: host ms per forward over
    ``reps`` synchronized calls, the profiler's kernels and device ms."""
    images = torch.from_numpy(disc_images(np.random.default_rng(24), n,
                                          CSF_HW)).cuda()
    evaluate = make_eval_step(model, from_u8=True,
                              compute_dtype=torch.bfloat16)
    for _ in range(3):
        evaluate(images)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        evaluate(images)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    kernels, dev = profile_kernels(lambda: evaluate(images), 5)
    return float(np.median(ms)), float(np.mean(ms)), kernels, dev


def say_kernels(kernels, dev: float, reps: int, top: int, unit: str) -> None:
    for e in kernels[:top]:
        t = e.self_device_time_total / reps / 1e3
        say(f"    {t:8.4f} ms {t / dev:6.1%} {e.count / reps:6.1f}/{unit}  "
            f"{e.key[:110]}")


def phase_csf_times(model_cpu: CSFNet, epoch: dict, gpu: str) -> float:
    """10f (not gated): the B=32 bf16 eval forward at 336^2 of both
    backbones, the B=1 latency, the B=8 bf16 micro-step, the epoch.
    Returns the micro-step's median ms."""
    for backbone in ("res2net50", "res2net101"):
        model = (csf_on(model_cpu, "cuda") if backbone == "res2net50"
                 else CSFNet(backbone, seed=0, device="cuda"))
        med, mean, kernels, dev = time_forward(model, 32, 20)
        say(f"  {backbone} eval forward B=32 bf16 336^2, u8 on the card: "
            f"{med:.3f} ms median, {mean:.3f} ms mean of 20 (host clock, "
            f"synchronized), {32 / mean * 1e3:.1f} img/s; device "
            f"{dev:.3f} ms ({1 - dev / mean:.1%} idle)  [{gpu}]")
        say_kernels(kernels, dev, 5, 12, "fwd")
        if backbone == "res2net50":
            med1, mean1, _, dev1 = time_forward(model, 1, 50)
            say(f"  res2net50 B=1 bf16 336^2 latency: {med1:.3f} ms median, "
                f"{mean1:.3f} ms mean of 50 (host clock, synchronized); "
                f"device {dev1:.3f} ms ({1 - dev1 / mean1:.1%} idle)  [{gpu}]")
        del model

    model = csf_on(model_cpu, "cuda")
    freeze_reference_params(model)
    step = make_csf_train_step(model, make_csf_optimizer(model, CSF_WD),
                               iter_size=CSF_ITER, batch_size=CSF_BATCH,
                               compute_dtype=torch.bfloat16, from_u8=True)
    rng = np.random.default_rng(25)
    img = disc_images(rng, CSF_BATCH, CSF_HW)
    batch = {"image": torch.from_numpy(img).cuda(),
             "target": torch.from_numpy(((img[..., :1] > 127) * 255)
                                        .astype(np.uint8)).cuda()}
    for _ in range(4):
        step(batch, CSF_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        step(batch, CSF_LR)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    kernels, dev = profile_kernels(lambda: step(batch, CSF_LR), 4)
    med = float(np.median(ms))
    say(f"  res2net50 micro-step B={CSF_BATCH} bf16 336^2, u8 wire, "
        f"iter_size {CSF_ITER} (every other one applies Adam): {med:.3f} ms "
        f"median of 20 (host clock, synchronized), "
        f"{CSF_BATCH / med * 1e3:.1f} img/s; device {dev:.3f} ms per "
        f"micro-step ({1 - dev / med:.1%} idle); peak memory "
        f"{peak / 2 ** 30:.3f} GiB  [{gpu}]")
    say_kernels(kernels, dev, 4, 12, "step")
    say(f"  resident CSF epoch: {epoch['img_s']:.1f} img/s, "
        f"{epoch['ms']:.2f} ms per micro-step  [{gpu}]")
    del model, step

    return med


RESIZE_CSF_BATCHES = (1, 8, 32)  # the served buckets and the B=32 forward
RESIZE_TRAIN_BATCH = 24          # the CSNet-L-x2 recipe's batch


def resize_shapes(run) -> list:
    """The (input shape, output size) of every ``ops.resize`` span of
    ``run()``, in order."""
    profiler.enable()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        profiler.disable()
    spans, _ = profiler.drain()
    return [(tuple(s.attrs["shape"]), tuple(s.attrs["out_shape"][2:]))
            for s in spans if s.name == "ops.resize"]


def source_taps(n_in: int, n_out: int) -> int:
    """How many of an axis's ``n_in`` source indices a resize to ``n_out``
    reads (a downsample skips some)."""
    scale = np.float32(n_in) / np.float32(n_out)
    src = np.maximum(scale * (np.arange(n_out, dtype=np.float32) + 0.5)
                     - 0.5, 0)
    i0 = src.astype(np.int64)
    return len(np.union1d(i0, np.minimum(i0 + 1, n_in - 1)))


def time_resizes(shapes: list, what: str, gpu: str) -> dict:
    """10g for one forward's resizes (f32): at each shape the kernel is
    ``F.interpolate`` bit for bit and within the plain version's bar; then
    times (not gated): the kernel's device time per call (profiler, 10
    calls), the wrapper's host time, the bound (the source rows and
    columns the outputs read, and the output, at 3.35 TB/s; the contract
    bound that ``resize_roofline`` reads counts the whole input), the
    plain version (CUDA events) and ``F.interpolate`` (library_ms,
    profiler). Returns the sums over the forward."""
    tot = dict.fromkeys(("device", "host", "bound", "contract", "plain",
                         "library", "bytes"), 0.0)
    by = {"device": set(), "library": set()}
    gen = torch.Generator(device="cuda").manual_seed(31)
    for (shape, out_hw) in sorted(set(shapes)):
        calls = shapes.count((shape, out_hw))
        x = torch.randn(shape, device="cuda", generator=gen)
        kern = lambda: resize_kernel.interpolate(x, size=out_hw)  # noqa: E731
        lib = lambda: torch.nn.functional.interpolate(  # noqa: E731
            x, size=out_hw, mode="bilinear", align_corners=False)
        plain = lambda: resize_kernel.bilinear_ref(x, out_hw)  # noqa: E731
        got = kern()
        check(torch.equal(got, lib()), f"10g {what} {shape} -> {out_hw}: "
              f"the kernel is F.interpolate bit for bit")
        err = resize_kernel.check_against_plain(got, x, out_hw)
        del got
        dev, dev_by = device_ms(kern, match="resize_bilinear_nchw", iters=10)
        lib_ms, lib_by = device_ms(lib, match="upsample_bilinear2d",
                                   iters=10)
        by["device"].add(dev_by)
        by["library"].add(lib_by)
        n, c, h, w = shape
        out = n * c * out_hw[0] * out_hw[1]
        read = n * c * source_taps(h, out_hw[0]) * source_taps(w, out_hw[1])
        row = dict(device=dev, host=host_us(kern), plain=cuda_ms(plain, 5),
                   library=lib_ms, bytes=(read + out) * x.element_size())
        row["bound"] = row["bytes"] / HBM_BYTES_S * 1e3
        row["contract"] = ((x.numel() + out) * x.element_size()
                           / HBM_BYTES_S * 1e3)
        for k in tot:
            tot[k] += calls * row[k]
        say(f"  {what} f32 {shape} -> {out_hw} x{calls}: device "
            f"{dev * 1e3:.2f} us by {dev_by}, bound {row['bound'] * 1e3:.2f}"
            f" us ({row['bound'] / dev:.1%} of it; contract "
            f"{row['contract'] / dev:.1%}), host {row['host']:.1f} "
            f"us, plain {row['plain']:.4f} ms, library_ms (F.interpolate) "
            f"{lib_ms:.4f} ms by {lib_by}; {err:.2e} from the plain version "
            f" [{gpu}]")
        del x
    say(f"  per {what} forward ({len(shapes)} resizes): kernel device "
        f"{tot['device']:.4f} ms, bound {tot['bound']:.4f} ms "
        f"({tot['bound'] / tot['device']:.1%} of it; contract "
        f"{tot['contract'] / tot['device']:.1%}), host "
        f"{tot['host']:.0f} us, plain {tot['plain']:.4f} ms, F.interpolate "
        f"{tot['library']:.4f} ms  [{gpu}]")
    tot["calls"] = len(shapes)
    tot.update({f"{k}_by": "+".join(sorted(v)) for k, v in by.items()})
    return tot


def phase_resize(model_cpu: CSFNet, gpu: str) -> dict:
    """10g: the resize kernel at every resize of a Res2Net-50 served f32
    forward at 336^2 (B = 1, 8, 32; 16 resizes, all through the kernel)
    and of a CSNet-L-x2 train-mode forward at 224^2 (B = 24), shapes read
    off the ``ops.resize`` spans (``time_resizes``). Returns each
    forward's sums, keyed csf_b1, csf_b8, csf_b32, csnet_train_b24."""
    out = {}
    model = csf_on(model_cpu, "cuda")
    evaluate = make_eval_step(model, from_u8=True)
    for b in RESIZE_CSF_BATCHES:
        images = torch.from_numpy(disc_images(np.random.default_rng(26), b,
                                              CSF_HW)).cuda()
        before = resize_kernel.launches
        shapes = resize_shapes(lambda: evaluate(images))
        check(len(shapes) == 16 and resize_kernel.launches - before == 16,
              f"10g: the B={b} CSF forward resizes 16 times, each through "
              f"the kernel ({len(shapes)} spans, "
              f"{resize_kernel.launches - before} launches)")
        out[f"csf_b{b}"] = time_resizes(shapes, f"CSF B={b}", gpu)
    del model, evaluate
    csnet = CSNet(init_layers(40, (0.5, 0.5)), seed=0, device="cuda").train()
    x = torch.randn(RESIZE_TRAIN_BATCH, *HW, 3, device="cuda")
    before = resize_kernel.launches
    shapes = resize_shapes(lambda: csnet(x))
    check(len(shapes) > 0 and resize_kernel.launches - before == len(shapes),
          "10g: every resize of the CSNet-L-x2 train forward goes through "
          "the kernel")
    out[f"csnet_train_b{RESIZE_TRAIN_BATCH}"] = time_resizes(
        shapes, f"CSNet-L-x2 train B={RESIZE_TRAIN_BATCH}", gpu)
    del csnet, x
    torch.cuda.empty_cache()
    return out


# --variants: A/B of the kernel's plan sizes (module constants of
# ops/dw_chain.py, for every shape or by H) and diagnostic builds of the
# source that compute the wrong thing on purpose, to show which part bounds
# the kernel
VARIANTS = {
    "default": {},
    "diag: no arithmetic": {"patch": [(
        "    float v = acc * s + sh;", "    float v = b[i + 1]; (void)acc;")]},
    "diag: no staging copies": {"patch": [
        ("  it.bulk = s.bulk && ", "  it.bulk = false && "),
        ("      for (int i = tid; i < it.count; i += nthreads) in[i] = src[i];",
         "      (void)src;")]},
    "diag: no stores of y": {"patch": [(
        "  *reinterpret_cast<Vec<T, V>*>(out) = o;",
        "  if (__isShared(out) || to_f32(o.v[0]) == 12345.f)\n"
        "    *reinterpret_cast<Vec<T, V>*>(out) = o;")]},
    "128 threads": {"all": {"BAND_THREADS": 128, "PLANE_THREADS": 128}},
    "224 threads": {"all": {"BAND_THREADS": 224, "PLANE_THREADS": 224}},
    "two slots everywhere": {"all": {"PLANE_SLOTS": 2}},
    "one slot everywhere": {"all": {"BAND_SLOTS": 1}},
    "224^2 bands of 48 rows": {224: {"BAND_BYTES": 52 * 224 * 2}},
    "112^2 as bands of 56 rows": {112: {"PLANE_BYTES": 0,
                                        "BAND_BYTES": 60 * 112 * 2}},
    "56^2 one plane per item": {56: {"ITEM_BYTES": 56 * 56 * 2}},
    "56^2 two planes per item": {56: {"ITEM_BYTES": 2 * 56 * 56 * 2}},
    "28^2 two, 14^2 eighteen planes per item": {
        28: {"ITEM_BYTES": 2 * 28 * 28 * 2},
        14: {"ITEM_BYTES": 20 * 14 * 14 * 2, "ITEMS_PER_SM": 1}},
}


def build_patched(name: str, patch) -> ctypes.CDLL:
    """``csrc/dw_chain.cu`` with ``patch`` (a list of (old, new)) applied,
    built into ``_build/variants/``."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "dw_chain.cu")) as f:
        src = f.read()
    for old, new in patch:
        check(old in src, f"variant {name!r}: patch target in the source")
        src = src.replace(old, new)
    stem = os.path.join(cuda_lib.BUILD_DIR, "variants",
                        "".join(ch if ch.isalnum() else "_" for ch in name))
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    with open(stem + ".cu", "w") as f:
        f.write(src)
    subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                    stem + ".so", stem + ".cu"], capture_output=True,
                   check=True)
    return dw_chain.bind(ctypes.CDLL(stem + ".so"))


def phase_variants(gpu: str) -> None:
    """Device ms per call of each variant at each main-path shape (N=32,
    bf16), best of two runs taken in the order A..Z, Z..A, and the sum
    over the 33 calls of a forward."""
    names = list(VARIANTS)
    patched = [n for n in names if "patch" in VARIANTS[n]]
    with concurrent.futures.ThreadPoolExecutor(len(patched)) as ex:
        libs = dict(zip(patched, ex.map(
            lambda n: build_patched(n, VARIANTS[n]["patch"]), patched)))
    default_lib = dw_chain._lib
    sizes0 = {k: getattr(dw_chain, k) for k in dir(dw_chain) if k.isupper()}
    rng = np.random.default_rng(4)
    totals = dict.fromkeys(names, 0.0)
    for (h, w, c), calls in MAIN_SHAPES:
        x, params = chain_inputs(32, c, h, w, torch.bfloat16, rng)
        packed = dw_chain.pack_params(*params)
        best = {}
        for name in names + names[::-1]:
            v = VARIANTS[name]
            sizes = {**v.get("all", {}), **v.get(h, {})}
            lib = libs.get(name)
            try:
                for k, val in sizes.items():
                    setattr(dw_chain, k, val)
                if lib is not None:
                    dw_chain._lib = lambda lib=lib: lib
                dw_chain.device_plan.cache_clear()
                t = device_ms(lambda: dw_chain.fused_dw_chain_packed(
                    x, packed), match="dw_chain_kernel")[0]
            finally:
                for k, val in sizes0.items():
                    setattr(dw_chain, k, val)
                dw_chain._lib = default_lib
                dw_chain.device_plan.cache_clear()
            best[name] = min(best.get(name, t), t)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e6
        say(f"  ({h},{w},{c}) x{calls}, bound {bound:.2f} us, device us: "
            + "; ".join(f"{n} {t * 1e3:.2f}" for n, t in best.items()))
        for n, t in best.items():
            totals[n] += calls * t
    say(f"  per forward (33 calls), device ms  [{gpu}]:")
    for n, t in totals.items():
        say(f"    {t:.4f}  {n}")



# ---------------------------------------------------------------------------
# The drivers on the card (phase 11)

DRIVER_TRAIN_PAIRS = 96   # four B=24 steps a driver epoch
DRIVER_TEST_PAIRS = 48
DRIVER_PARITY_PAIRS = 4
DRIVER_REQUESTS = 8
# shaped like the reference's csnet-L-x2_train.yml (CSNet_training/configs):
# CSNet-L at basewidth 40, the dynamic-weight-decay recipe; 1e-4 and 1e-20
# are strings in YAML 1.1 that the schema's float defaults coerce
TRAIN_YAML = """\
TASK: csnet-L-x2
GPU: 0
PRINT_FREQ: 2
MODEL:
  ARCH: csnet
  BASIC_SPLIT: [0.5, 0.5]
LOSS:
  MLOSS: 4
DATA:
  DIR: {root}/DUTS-TR
  BATCH_SIZE: 24
  WORKERS: 4
  SAVEDIR: {root}/results
  IMAGE_H: 224
  IMAGE_W: 224
VAL:
  DIR: {root}/ECSSD
TEST:
  DATASET_PATH: {root}
  DATASETS: ["ECSSD"]
  IMAGE_H: 224
  IMAGE_W: 224
  ENABLE: False   # no finetune dumps
SOLVER:
  METHOD: Adam_dynamic_weight_decay
  LR: 1e-4
  ADJUST_STEP: True
  STEPS: [200, 250]
  MAX_EPOCHS: 300
PRUNE:
  BNS: True
  SHOW: False
AUTO:
  ENABLE: True
  EXPAND: 2.0
  FINETUNE: 300
  FLOPS:
    ENABLE: True
    WEIGHT: 3.0
FINETUNE:
  THRES: 1e-20
"""


def quiet(msg, display: bool = True) -> None:
    """A driver log that drops its lines (the phase prints its own)."""


def phase_driver_config(root: str):
    """11a: the train YAML read back through the port's reader and the
    config node."""
    from sod100k_tpu_torch.config import get_cfg, miniyaml

    yml = os.path.join(root, "csnet-L-x2_train.yml")
    with open(yml, "w") as f:
        f.write(TRAIN_YAML.format(root=root))
    raw = miniyaml.load_file(yml)
    check(raw["FINETUNE"]["THRES"] == "1e-20" and raw["SOLVER"]["LR"] == "1e-4"
          and raw["GPU"] == 0, "YAML 1.1 scalars as PyYAML reads them")
    cfg = get_cfg()
    cfg.merge_from_file(yml)
    check(cfg.FINETUNE.THRES == 1e-20 and isinstance(cfg.FINETUNE.THRES, float)
          and cfg.SOLVER.LR == 1e-4 and cfg.AUTO.EXPAND == 2.0
          and cfg.MODEL.BASIC_SPLIT == [0.5, 0.5]
          and cfg.SOLVER.METHOD == "Adam_dynamic_weight_decay"
          and cfg.AUTO.FLOPS.WEIGHT == 3.0 and cfg.DATA.BATCH_SIZE == 24
          and cfg.DATA.IMAGE_H == cfg.DATA.IMAGE_W == 224 and cfg.GPU == 0,
          "the train YAML's values in the config")
    say(f"  {yml}: THRES {cfg.FINETUNE.THRES!r}, LR {cfg.SOLVER.LR!r}, "
        f"basewidth {round(20 * cfg.AUTO.EXPAND)}, B={cfg.DATA.BATCH_SIZE} at "
        f"{cfg.DATA.IMAGE_H}^2")
    return yml, cfg


def phase_driver_train(yml: str, cfg) -> dict:
    """11b: ``python -m sod100k_tpu_torch.cli.train --config <yml> --epochs
    1`` as a user runs it."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "sod100k_tpu_torch.cli.train", "--config",
         yml, "--epochs", "1"], cwd=repo, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": repo})
    wall = time.perf_counter() - t0
    if out.returncode:
        say(out.stdout[-3000:] + out.stderr[-3000:])
    check(out.returncode == 0, f"cli.train exit code {out.returncode}")
    for line in out.stdout.splitlines():
        if line.startswith(("  + Number", "epoch time", "max memory",
                            " epoch:")):
            say(f"  | {line.strip()}")
    ck = os.path.join(cfg.DATA.SAVEDIR, cfg.TASK, "checkpoint",
                      "checkpoint_epoch1.pth.tar")
    check(os.path.isfile(ck), "cli.train wrote checkpoint_epoch1.pth.tar")
    m = re.search(r" epoch: 1 mae: (\S+)", out.stdout)
    mae = float(m.group(1)) if m else float("nan")
    check(np.isfinite(mae) and 0.0 <= mae <= 1.0, f"val MAE {mae} finite")
    rate = re.search(r"epoch time: (\S+)s \((\S+) img/s\)", out.stdout)
    return {"ckpt": ck, "wall_s": wall, "mae": mae,
            "epoch_s": float(rate.group(1)), "img_s": float(rate.group(2))}


def calibrated_checkpoint(cfg, ck: str, root: str, task: str) -> str:
    """The trained weights with BN statistics recalibrated on 12 of the
    test split's images (a few steps leave the running statistics at
    their init, where the x100 net explodes or dies in eval mode), saved
    as epoch 1 of ``task``."""
    from sod100k_tpu_torch.arch.layer_config import LayerConfig
    from sod100k_tpu_torch.cli.common import load_any_checkpoint

    lc = LayerConfig.load(os.path.join(cfg.DATA.SAVEDIR, cfg.TASK,
                                       "layer_configs", "layer_config_0.bin"))
    model = CSNet(lc, device="cuda")
    load_any_checkpoint(ck, model)
    img_dir = os.path.join(root, "ECSSD", "images")
    names = sorted(os.listdir(img_dir))[-12:]
    calibrate_bn(model, normalize_u8(torch.from_numpy(np.stack([
        resize_u8_linear(_imread_rgb_u8(os.path.join(img_dir, n)), HW)
        for n in names])).cuda()))
    out = os.path.join(cfg.DATA.SAVEDIR, task, "checkpoint",
                       "checkpoint_epoch1.pth.tar")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_checkpoint(out, model, None, epoch=1)
    return out


def _driver_maps(sal_dir: str) -> dict:
    return {n: read_image(os.path.join(sal_dir, n))
            for n in sorted(os.listdir(sal_dir))}


def phase_driver_stages(cfg, root: str, gpu: str) -> dict:
    """11c: finetune, test (fixed 224^2 and ceil-to-16), eval, the resident
    sweep in-process on the card, the f32 maps of 4 images against the
    same driver on the CPU."""
    from sod100k_tpu_torch.cli.eval import run_eval
    from sod100k_tpu_torch.cli.finetune import run_finetune
    from sod100k_tpu_torch.cli.test import run_test, run_testall_resident

    t = {}
    t0 = time.perf_counter()
    ft = run_finetune(cfg, from_epoch=1, max_epochs=1, log=quiet,
                      device="cuda")
    t["finetune_s"] = time.perf_counter() - t0
    check(np.isfinite(ft["best_mae"]) and os.path.isfile(os.path.join(
        ft["ft_dir"], "checkpoint_epoch1.pth.tar")), "finetune epoch")
    say(f"  finetune: pruned at {cfg.FINETUNE.THRES:g}, one epoch, val MAE "
        f"{ft['best_mae']:.6f}, {t['finetune_s']:.1f} s")

    c = cfg.clone()
    c.TASK = "L2test"
    trained = os.path.join(cfg.DATA.SAVEDIR, cfg.TASK, "checkpoint",
                           "checkpoint_epoch1.pth.tar")
    c.TEST.CHECKPOINT = calibrated_checkpoint(cfg, trained, root, c.TASK)
    c.TEST.MODEL_CONFIG = os.path.join(cfg.DATA.SAVEDIR, cfg.TASK,
                                       "layer_configs", "layer_config_0.bin")
    res = run_test(c, log=quiet, device="cuda")["datasets"]["ECSSD"]
    t["test_img_s"] = res["img_per_sec"]
    check(len(os.listdir(res["sal_dir"])) == DRIVER_TEST_PAIRS,
          "fixed-size test dumped every map")
    cc = c.clone()
    cc.TASK = "L2ceil16"
    cc.TEST.IMAGE_H = cc.TEST.IMAGE_W = 0
    ceil = run_test(cc, log=quiet, device="cuda")["datasets"]["ECSSD"]
    t["ceil_img_s"] = ceil["img_per_sec"]
    maps = _driver_maps(ceil["sal_dir"])
    check(len(maps) == DRIVER_TEST_PAIRS and all(
        m.dtype == np.uint8 for m in maps.values()), "ceil-to-16 maps")
    say(f"  test: {DRIVER_TEST_PAIRS} images at 224^2 with PNG dumps "
        f"{t['test_img_s']:.1f} img/s; ceil-to-16 per image "
        f"{t['ceil_img_s']:.1f} img/s (host clock, first call included)  "
        f"[{gpu}]")

    # the same driver on the card and on the CPU, f32, 4 images, in the
    # fixed-size mode and the ceil-to-16 mode (ECSSD4 alternates
    # orientation: 304x400 and 400x304 forwards, their own tail shapes)
    for mode, base in (("224^2", c), ("ceil-to-16", cc)):
        par = {}
        for dev in ("cuda", "cpu"):
            cp = base.clone()
            cp.DATA.SAVEDIR = os.path.join(root, f"parity_{dev}")
            cp.TASK = f"{base.TASK}_{dev}"
            cp.TEST.DATASETS = ["ECSSD4"]
            cp.DATA.BATCH_SIZE = DRIVER_PARITY_PAIRS
            par[dev] = _driver_maps(run_test(cp, log=quiet, device=dev)[
                "datasets"]["ECSSD4"]["sal_dir"])
        check(par["cuda"].keys() == par["cpu"].keys()
              and len(par["cuda"]) == DRIVER_PARITY_PAIRS,
              f"parity map names ({mode})")
        shapes = sorted({m.shape for m in par["cuda"].values()})
        check(all(par["cuda"][n].shape == par["cpu"][n].shape
                  for n in par["cpu"]), f"parity map shapes ({mode})")
        worst = max(int(np.abs(par["cuda"][n].astype(int)
                               - par["cpu"][n].astype(int)).max())
                    for n in par["cpu"])
        check(worst <= 1,
              f"card maps {worst} levels from the CPU's (bar 1, {mode})")
        check(all(m.std() > 0 for m in par["cuda"].values()),
              f"the card's maps are not constant ({mode})")
        say(f"  test maps ({mode}), f32 card vs CPU on "
            f"{DRIVER_PARITY_PAIRS} images of shapes {shapes}: at most "
            f"{worst} level(s) apart")

    t0 = time.perf_counter()
    best = run_eval(c, epoch_range=(1, 2), suite="full", log=quiet,
                    device="cuda")
    t["eval_img_s"] = DRIVER_TEST_PAIRS / (time.perf_counter() - t0)
    with open(os.path.join(c.DATA.SAVEDIR, c.TASK,
                           "FmeasureResults_ECSSD.txt")) as f:
        vals = {k: float(v) for k, v in re.findall(r"(\w+) (\d+\.\d+)",
                                                   f.read())}
    check(best["ECSSD"]["epoch"] == 1 and vals and all(
        0.0 <= v <= 1.0 for v in vals.values()), f"eval metrics {vals}")
    say(f"  eval (full suite, device backend): {vals}; "
        f"{t['eval_img_s']:.1f} img/s  [{gpu}]")

    cs = c.clone()
    cs.CUDA.TEST_RESIDENT = True
    cs.TEST.BEGIN = cs.TEST.INTERVAL = 1
    t0 = time.perf_counter()
    sweep = run_testall_resident(cs, log=quiet, device="cuda")
    t["sweep_img_s"] = DRIVER_TEST_PAIRS / (time.perf_counter() - t0)
    check(sweep["ECSSD"]["epoch"] == 1
          and 0.0 < sweep["ECSSD"]["max_f"] <= 1.0, f"resident sweep {sweep}")
    say(f"  resident sweep: MaxF {sweep['ECSSD']['max_f']:.6f}; "
        f"{t['sweep_img_s']:.1f} img/s, the store's build included  [{gpu}]")
    return {"times": t, "test_cfg": c}


def phase_driver_serving(c, root: str, gpu: str) -> None:
    """11d: ``cli.export`` to buckets 1 and 32 at bf16 on the u8 wire, then
    ``python -m sod100k_tpu_torch.cli.serve`` answering 8 requests over
    HTTP from 2 client threads."""
    import socket

    from sod100k_tpu_torch.cli import export as cexport

    yml = os.path.join(root, "serve.yml")
    with open(yml, "w") as f:
        f.write(f"TEST:\n  MODEL_CONFIG: {c.TEST.MODEL_CONFIG}\n"
                f"  CHECKPOINT: {c.TEST.CHECKPOINT}\n  IMAGE_H: 224\n"
                f"  IMAGE_W: 224\n")
    art = os.path.join(root, "artifact")
    cexport.main(["--config", yml, "--out", art, "--batch", "1,32",
                  "--dtype", "bf16", "--wire", "u8"])
    with socket.socket() as sk:  # a free port on this host
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sod100k_tpu_torch.cli.serve", "--artifact",
         art, "--port", str(port)], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": repo})
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                check(proc.poll() is None, "cli.serve exited early")
                check(time.perf_counter() - t0 < 120, "cli.serve started")
                time.sleep(0.5)
        rng = np.random.default_rng(11)
        reqs = [rng.integers(0, 256, (224, 224, 3), np.uint8)
                for _ in range(DRIVER_REQUESTS)]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(lambda x: post_npy(url, x), reqs))
        check(all(o.shape == (224, 224, 1) and o.dtype == np.uint8
                  for o in outs), "served maps' shape and dtype")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        check(stats["requests"] == DRIVER_REQUESTS, "/stats request count")
        # an encoded image: PNG in, resized on the server, PNG out
        src = os.path.join(root, "ECSSD", "images",
                           sorted(os.listdir(os.path.join(
                               root, "ECSSD", "images")))[0])
        with open(src, "rb") as f:
            body = f.read()
        req = urllib.request.Request(url + "/predict", data=body,
                                     headers={"Content-Type": "image/png"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            check(r.status == 200 and r.headers["Content-Type"] == "image/png",
                  f"/predict of a PNG: status {r.status}")
            png = decode_png(r.read(), "the served PNG")
        rgb = _imread_rgb_u8(src)
        want = post_npy(url, resize_u8_linear(rgb, (224, 224)))[..., 0]
        diff = int(np.abs(png.astype(int) - want.astype(int)).max()) \
            if png.shape == want.shape else -1
        check(png.dtype == np.uint8 and 0 <= diff <= 1,
              f"served PNG {png.shape} {diff} level(s) from the .npy answer")
        say(f"  /predict of a {rgb.shape[1]}x{rgb.shape[0]} PNG: a "
            f"{png.shape[1]}x{png.shape[0]} PNG map, {diff} level(s) from "
            f"the .npy answer for the same resized image")
        say(f"  cli.export -> cli.serve: {stats['requests']} requests in "
            f"{stats['dispatches']} dispatches, up after "
            f"{time.perf_counter() - t0:.1f} s of the run  [{gpu}]")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def jpeg_readers() -> str:
    """Whether PIL (the port's JPEG path) and torchvision's decode_jpeg
    import here."""
    import importlib

    found = []
    for mod, attr in (("PIL.Image", "open"), ("torchvision.io",
                                              "decode_jpeg")):
        try:
            ok = hasattr(importlib.import_module(mod), attr)
        except ImportError:
            ok = False
        found.append(f"{mod}.{attr} {'yes' if ok else 'no'}")
    return ", ".join(found)


def phase_drivers(gpu: str, step_times: dict) -> int:
    """Phase 11: the drivers, as a user runs them, at CSNet-L's full width
    on a synthetic DUTS-TR/ECSSD tree. Returns the fused_dw_chain launches
    of the in-process stages."""
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        make_synth_split(os.path.join(root, "DUTS-TR"), DRIVER_TRAIN_PAIRS,
                         hw=SPLIT_HW, seed=3)
        make_synth_split(os.path.join(root, "ECSSD"), DRIVER_TEST_PAIRS,
                         hw=SPLIT_HW, seed=4)
        for sub in ("images", "GT"):
            src = os.path.join(root, "ECSSD", sub)
            dst = os.path.join(root, "ECSSD4", sub)
            os.makedirs(dst)
            for n in sorted(os.listdir(src))[:DRIVER_PARITY_PAIRS]:
                shutil.copy(os.path.join(src, n), dst)
        say("11a: the train YAML through the port's reader")
        yml, cfg = phase_driver_config(root)
        say("11b: python -m sod100k_tpu_torch.cli.train --config <yml> "
            "--epochs 1")
        train = phase_driver_train(yml, cfg)
        say(f"  cli.train: {train['wall_s']:.1f} s of wall time (process "
            f"start included); epoch {train['epoch_s']:.1f} s, "
            f"{train['img_s']:.1f} img/s (f32, hybrid front-end, the first "
            f"steps included) against phase 8b's f32 step alone "
            f"{TRAIN_BATCH / step_times['ms_f32'] * 1e3:.1f} img/s; val MAE "
            f"{train['mae']:.6f}  [{gpu}]")
        say("11c: finetune, test, eval and the resident sweep in-process")
        torch.cuda.synchronize()
        dw_chain.launches = 0
        stages = phase_driver_stages(cfg, root, gpu)
        torch.cuda.synchronize()
        launches = dw_chain.launches
        say("11d: cli.export and cli.serve")
        phase_driver_serving(stages["test_cfg"], root, gpu)
    say(f"  JPEG readers on this machine (real splits are JPEG): "
        f"{jpeg_readers()}")
    check(launches > 0, "phase 11 launched fused_dw_chain")
    say(f"  phase 11 took {time.perf_counter() - t11:.1f} s; {launches} "
        f"fused_dw_chain launches in its in-process stages  [{gpu}]")
    return launches


# ---------------------------------------------------------------------------
# The CSF driver and the native SalMetric (phase 12)

CSF_CLI_PAIRS = 32        # the resident run's split; the native run's first 20
CSF_CLI_NATIVE_PAIRS = 20  # B=1, iter_size 10: two optimizer steps
# the test split's shapes in list order: same-shape runs of 10, 4 and 2,
# so --test_batch 4 meets full batches, shape breaks and padded partials
CSF_CLI_TEST_HW = [(300, 400)] * 10 + [(400, 300)] * 4 + [(300, 400)] * 2
CSF_CLI_PARITY = 4
CSF_CLI_TB = 4
NATIVE_THREADS = 4


def he_scale(model: CSFNet, seed: int) -> CSFNet:
    """``model`` with He-scale backbone convs (N(0, 2/fan_in)) and BN
    statistics and affines that keep the activations' scale, the draws of
    ``tests/test_torch_csf.py::he_scale_state``: at the reference init the
    backbone's signal vanishes and the map is nearly constant."""
    rng = np.random.default_rng(seed)
    state = model.state_dict()
    with torch.no_grad():
        for k, v in state.items():
            shape = tuple(v.shape)
            if not k.startswith("base.") or k.endswith("num_batches_tracked"):
                continue
            if v.dim() == 4:
                a = rng.standard_normal(shape) * np.sqrt(
                    2.0 / np.prod(shape[1:]))
            elif k.endswith("running_var"):
                a = rng.uniform(0.5, 1.5, shape)
            elif k.endswith("running_mean"):
                a = rng.standard_normal(shape) * 0.1
            elif k.endswith(".weight"):
                lo, hi = ((0.1, 0.3) if ".bn3." in k or ".downsample." in k
                          else (0.5, 1.0))
                a = rng.uniform(lo, hi, shape)
            else:
                a = rng.standard_normal(shape) * 0.1
            v.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def csf_cli_tree(root: str) -> dict:
    """The driver's files: a training split of PNG pairs at 300x400
    (alternating orientation) with .lst files of its first 20 and all 32
    pairs, a 16-image test split with its GTs and .lst files, and seeded
    He-scale checkpoints of both backbones."""
    make_synth_split(os.path.join(root, "train"), CSF_CLI_PAIRS,
                     hw=SPLIT_HW, seed=12)
    names = sorted(os.listdir(os.path.join(root, "train", "images")))
    lists = {}
    for n in (CSF_CLI_NATIVE_PAIRS, CSF_CLI_PAIRS):
        lists[n] = os.path.join(root, f"train{n}.lst")
        with open(lists[n], "w") as f:
            f.writelines(f"images/{m} GT/{m}\n" for m in names[:n])
    test = os.path.join(root, "test")
    for sub in ("images", "GT"):
        os.makedirs(os.path.join(test, sub))
    pairs = synth_pairs(len(CSF_CLI_TEST_HW), hw=SPLIT_HW,
                        alternate_orientation=False, seed=13)
    for i, ((img, gt), hw) in enumerate(zip(pairs, CSF_CLI_TEST_HW)):
        if hw != SPLIT_HW:
            img, gt = img.transpose(1, 0, 2).copy(), gt.T.copy()
        write_png(os.path.join(test, "images", f"t{i:02d}.png"), img)
        write_png(os.path.join(test, "GT", f"t{i:02d}.png"), gt)
    test_names = [f"images/t{i:02d}.png" for i in range(len(CSF_CLI_TEST_HW))]
    for name, sel in (("test.lst", test_names),
                      ("parity.lst", test_names[:CSF_CLI_PARITY])):
        with open(os.path.join(test, name), "w") as f:
            f.writelines(f"{n}\n" for n in sel)
    ckpts = {}
    for backbone in ("res2net50", "res2net101"):
        ckpts[backbone] = os.path.join(root, f"{backbone}_he.pth")
        save_checkpoint(ckpts[backbone], he_scale(
            CSFNet(backbone, seed=0, device="cpu"), 24), None, epoch=0,
            arch=f"csf_{backbone}")
    return {"lists": lists, "test": test, "ckpts": ckpts}


def phase_csf_cli_train(root: str, tree: dict) -> dict:
    """12a: ``python -m sod100k_tpu_torch.cli.csf --mode train`` twice, from
    --load of the seeded checkpoint (no download is tried): the recipe's
    native-size protocol (B=1, iter_size 10, 20 pairs: two optimizer
    steps), then B=8 at 336^2 in bf16 from the resident store (iter_size 2,
    32 pairs: four micro-steps)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    runs = {
        "native": ["--image_size", "0", "--batch_size", "1", "--iter_size",
                   "10", "--train_list", tree["lists"][CSF_CLI_NATIVE_PAIRS],
                   "--show_every", "5"],
        "resident": ["--image_size", "336", "--batch_size", "8",
                     "--iter_size", "2", "--dtype", "bfloat16",
                     "--preprocess", "resident", "--train_list",
                     tree["lists"][CSF_CLI_PAIRS], "--show_every", "8"],
    }
    out = {}
    for name, args in runs.items():
        folder = os.path.join(root, f"results_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sod100k_tpu_torch.cli.csf", "--mode",
             "train", "--train_root", os.path.join(root, "train"), "--load",
             tree["ckpts"]["res2net50"], "--epoch", "1", "--epoch_save", "1",
             "--save_folder", folder, *args], cwd=repo, capture_output=True,
            text=True, timeout=600, env={**os.environ, "PYTHONPATH": repo})
        wall = time.perf_counter() - t0
        if proc.returncode:
            say(proc.stdout[-3000:] + proc.stderr[-3000:])
        check(proc.returncode == 0, f"cli.csf train ({name}) exit code "
              f"{proc.returncode}")
        losses = [float(v) for v in re.findall(r"\|\| Sal : (\S+)",
                                               proc.stdout)]
        final = os.path.join(folder, "run-0", "models", "final.pth")
        check(losses and np.isfinite(losses).all(),
              f"cli.csf train ({name}): finite losses {losses}")
        check(os.path.isfile(final), f"cli.csf train ({name}) final.pth")
        m = re.search(r"epoch 0 time: (\S+)s \((\d+) micro-steps, (\S+) "
                      r"img/s\)", proc.stdout)
        check(m is not None, f"cli.csf train ({name}) epoch time line")
        out[name] = {"wall_s": wall, "final": final, "losses": losses,
                     "epoch_s": float(m.group(1)), "micro": int(m.group(2)),
                     "img_s": float(m.group(3))}
        for line in proc.stdout.splitlines():
            if line.startswith(("The number", "resident", "mixed")):
                say(f"  | {line}")
        say(f"  {name}: {len(losses)} loss lines "
            f"{' '.join(f'{v:.4f}' for v in losses)}; final.pth written")
    return out


def _csf_test(tree: dict, fold: str, device: str, lst: str, *args) -> tuple:
    """``run_csf_test`` on the card or the CPU over the test split's list
    ``lst``, as the parser reads ``args``; returns (its result, the maps
    written, the FPS line)."""
    from sod100k_tpu_torch.cli import csf as ccsf

    cfg = ccsf.build_parser().parse_args(["--mode", "test", "--test_fold",
                                          fold, *args])
    cfg.test_root = tree["test"]
    cfg.test_list = os.path.join(tree["test"], lst)
    lines = []
    res = ccsf.run_csf_test(cfg, log=lines.append, device=device)
    check(lines[-1] == "Test Done!" and lines[0].startswith("Speed: "),
          f"the test driver's last lines {lines}")
    return res, _driver_maps(fold), lines[0]


def _levels(got: dict, want: dict, what: str) -> int:
    check(got.keys() == want.keys(), f"{what}: the same map names")
    check(all(got[n].shape == want[n].shape for n in got),
          f"{what}: the same map shapes")
    return max(int(np.abs(got[n].astype(int) - want[n].astype(int)).max())
               for n in got)


def phase_csf_cli_test(root: str, tree: dict, final: str, gpu: str) -> dict:
    """12b: ``run_csf_test`` on the card from 12a's f32 final.pth: 16
    images at B=1 and at --test_batch 4 (within one level), 4 of them
    against the CPU (f32, within one level), and a Res2Net-101 run."""
    res, b1, fps_line = _csf_test(tree, os.path.join(root, "b1"), "cuda",
                                  "test.lst", "--model", final)
    n = len(CSF_CLI_TEST_HW)
    check(res["n"] == n and sorted(b1) == [f"t{i:02d}_sal_fuse.png"
                                           for i in range(n)],
          "a map per test image")
    check(all(b1[f"t{i:02d}_sal_fuse.png"].shape == hw
              for i, hw in enumerate(CSF_CLI_TEST_HW)), "maps at native size")
    check(all(m.std() > 0 for m in b1.values()), "maps are not constant")
    res4, b4, _ = _csf_test(tree, os.path.join(root, "b4"), "cuda",
                            "test.lst", "--model", final, "--test_batch",
                            str(CSF_CLI_TB))
    d_tb = _levels(b4, b1, "--test_batch 4")
    check(d_tb <= 1, f"--test_batch 4 maps {d_tb} levels from B=1 (bar 1)")
    say(f"  {n} images at B=1: {fps_line}; --test_batch {CSF_CLI_TB}: "
        f"{res4['fps']:.2f} FPS, {d_tb} level(s) from B=1  [{gpu}]")
    par = {}
    for dev in ("cuda", "cpu"):
        par[dev] = _csf_test(tree, os.path.join(root, f"parity_{dev}"), dev,
                             "parity.lst", "--model", final)[1]
    d_cpu = _levels(par["cuda"], par["cpu"], "card vs CPU")
    check(d_cpu <= 1, f"card maps {d_cpu} levels from the CPU's (bar 1)")
    say(f"  f32 maps, card vs CPU, {CSF_CLI_PARITY} images: {d_cpu} "
        f"level(s) apart")
    r101, maps101, fps101 = _csf_test(
        tree, os.path.join(root, "r101"), "cuda", "parity.lst", "--arch",
        "res2net101", "--model", tree["ckpts"]["res2net101"])
    check(len(maps101) == CSF_CLI_PARITY and all(
        m.dtype == np.uint8 and m.std() > 0 for m in maps101.values()),
        "Res2Net-101 maps")
    say(f"  res2net101, {CSF_CLI_PARITY} images: {fps101}  [{gpu}]")
    return {"fps": res["fps"], "fps_tb": res4["fps"],
            "sal_dir": os.path.join(root, "b1")}


def _best_rate(fn, n: int, reps: int = 3) -> float:
    """Images per second of the fastest of ``reps`` calls (host clock; a
    device call ends in a synchronize)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return n / best


def phase_native_metric(root: str, tree: dict, sal_dir: str,
                        gpu: str) -> dict:
    """12c: the native SalMetric, built with the host compiler here, on
    12b's dumps: against the device backend on the card (abs 1e-5), its
    CLI against do_evaluation's dict, and ``cli.eval --dirs --backend
    native --suite full``."""
    import contextlib

    from sod100k_tpu_torch.cli import eval as ceval
    from sod100k_tpu_torch.metrics import native

    t0 = time.perf_counter()
    lib = cuda_lib.build_host("salmetric")
    build_s = time.perf_counter() - t0
    cxx = subprocess.run([cuda_lib.HOST_CXX, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    say(f"  built {lib} with {cuda_lib.HOST_CXX} ({cxx}) in {build_s:.1f} s")
    gt_dir = os.path.join(tree["test"], "GT")
    pairs = ceval._pairs(sal_dir, gt_dir, sal_suffix="_sal_fuse", log=quiet)
    n = len(CSF_CLI_TEST_HW)
    check(len(pairs) == n, f"{len(pairs)} sal/GT pairs")
    nat = ceval.evaluate_pairs_native(pairs, NATIVE_THREADS)
    dev = ceval.evaluate_pairs_device(pairs, log=quiet, device="cuda")
    check(nat["images"] == n, "native: every pair scored")
    worst = max(float(np.abs(np.asarray(nat[k]) - np.asarray(dev[k])).max())
                for k in ("mae", "max_f", "mean_f", "mean_precision",
                          "mean_recall", "precision", "recall", "fmeasure"))
    check(worst <= 1e-5, f"native vs device {worst:.2e} (bar 1e-5)")
    say(f"  native vs device backend on the card: MAE {nat['mae']:.6f}, "
        f"MaxF {nat['max_f']:.6f}; at most {worst:.2e} apart (bar 1e-5)")

    lst = os.path.join(root, "pairs.txt")
    with open(lst, "w") as f:
        f.writelines(f"{s} {g}\n" for s, g in pairs)
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "sod100k_tpu_torch.metrics.native", lst,
         str(NATIVE_THREADS)], capture_output=True, text=True, timeout=300,
        cwd=repo, env={**os.environ, "PYTHONPATH": repo})
    if proc.returncode:
        say(proc.stdout[-3000:] + proc.stderr[-3000:])
    check(proc.returncode == 0, f"metrics.native CLI exit {proc.returncode}")
    lines = proc.stdout.splitlines()
    want = [f"{NATIVE_THREADS} threads are being used for accelerating.",
            *salmetric.format_report(nat).splitlines()]
    num = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
    same = len(lines) == len(want) == 1 + 256 + 7 and all(
        re.sub(num, "#", a) == re.sub(num, "#", b) and np.allclose(
            [float(v) for v in re.findall(num, a)],
            [float(v) for v in re.findall(num, b)], rtol=1e-5, atol=0)
        for a, b in zip(lines, want))
    check(same, "the CLI's stdout is do_evaluation's report")
    say(f"  python -m sod100k_tpu_torch.metrics.native: {len(lines)} lines, "
        f"the dict's report (6 significant digits)")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ceval.main(["--dirs", sal_dir, gt_dir, "--sal-suffix", "_sal_fuse",
                    "--backend", "native", "--suite", "full"])
    report = buf.getvalue().strip().splitlines()[-1]
    check(" wF " in report and " S " in report and f"({n} pairs)" in report,
          f"cli.eval --backend native --suite full: {report}")
    say(f"  cli.eval --dirs --backend native --suite full: {report}")

    rates = {
        "native": _best_rate(lambda: ceval.evaluate_pairs_native(
            pairs, NATIVE_THREADS), n),
        "device": _best_rate(lambda: ceval.evaluate_pairs_device(
            pairs, log=quiet, device="cuda"), n),
        "device_reference": _best_rate(lambda: ceval.evaluate_pairs_device(
            pairs, with_smeasure=False, log=quiet, device="cuda"), n),
    }
    say(f"  scoring {n} pairs at 300x400 (decode included, best of 3): "
        f"native ({NATIVE_THREADS} threads) {rates['native']:.1f} img/s, "
        f"device {rates['device']:.1f} img/s (with S), "
        f"{rates['device_reference']:.1f} img/s (reference block)  [{gpu}]")
    return rates


def phase_csf_cli(gpu: str, step_ms: float) -> int:
    """Phase 12: the CSF driver as a user runs it, at Res2Net-50's full
    width (one Res2Net-101 test run), then the native SalMetric on its
    dumps. Returns the fused_dw_chain launches of the in-process stages
    (the CSF path has no depthwise tail: 0)."""
    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        tree = csf_cli_tree(root)
        say("12a: python -m sod100k_tpu_torch.cli.csf --mode train")
        train = phase_csf_cli_train(root, tree)
        torch.cuda.synchronize()
        dw_chain.launches = 0
        say("12b: run_csf_test on the card")
        test = phase_csf_cli_test(root, tree, train["native"]["final"], gpu)
        say("12c: the native SalMetric on the dumps")
        rates = phase_native_metric(root, tree, test["sal_dir"], gpu)
        torch.cuda.synchronize()
        launches = dw_chain.launches
    say("12d: times (not gated)")
    for name, r in train.items():
        say(f"  cli.csf train ({name}): {r['wall_s']:.1f} s of wall time "
            f"(process start, model build, checkpoint load and save "
            f"included); its epoch {r['epoch_s']:.2f} s for {r['micro']} "
            f"micro-steps, {r['epoch_s'] / r['micro'] * 1e3:.1f} ms a "
            f"micro-step, {r['img_s']:.1f} img/s (first calls included)  "
            f"[{gpu}]")
    say(f"  phase 10f's bare B={CSF_BATCH} bf16 micro-step at 336^2: "
        f"{step_ms:.3f} ms, {CSF_BATCH / step_ms * 1e3:.1f} img/s  [{gpu}]")
    say(f"  test driver: {test['fps']:.2f} FPS at B=1, {test['fps_tb']:.2f} "
        f"FPS at --test_batch {CSF_CLI_TB} (PNG writes and first calls "
        f"included); scoring: native {rates['native']:.1f} img/s, device "
        f"{rates['device']:.1f} img/s  [{gpu}]")
    check(launches == 0, "the CSF driver stages launch no fused_dw_chain")
    say(f"  phase 12 took {time.perf_counter() - t12:.1f} s; {launches} "
        f"fused_dw_chain launches in its in-process stages  [{gpu}]")
    return launches


# ---------------------------------------------------------------------------
# The recipe tools on the card (phase 13)

# the JAX package's slow test of the trajectory (tests/test_prune.py:138-140)
TRAJECTORY = dict(train_epochs=600, ft_epochs=30, basewidth=8, images=32,
                  size=48, batch=8, lr=2e-3, flops_weight=30.0)
PRINTED_INVARIANT = "finetuned <= 1.6x pre-prune"
AB = dict(steps=60, batch=24, hw=224, basewidth=40, log_every=10)


def trajectory_worker(out_path: str) -> None:
    """13a in a process of its own (``start_trajectory``): the trajectory
    at TRAJECTORY on the card, its result, time and fused_dw_chain
    launches written to ``out_path``."""
    from sod100k_tpu_torch.tools import prune_trajectory

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dw_chain.launches = 0
    t0 = time.perf_counter()
    res = prune_trajectory.run_trajectory(**TRAJECTORY, device="cuda",
                                          log=say)
    torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump({"result": res, "launches": dw_chain.launches,
                   "secs": time.perf_counter() - t0}, f)


def start_trajectory(tmp: str):
    """Start 13a: the trajectory is ~2,500 host-bound steps (~126 ms each,
    a few % of the card), so it runs beside 13b and phase 14 instead of
    before them. Returns (process, its log, its result path)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "trajectory.json")
    log = open(os.path.join(tmp, "trajectory.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.trajectory_worker({out!r})"],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, stdout=log,
        stderr=subprocess.STDOUT, text=True)
    return proc, log, out


def finish_trajectory(started, gpu: str) -> int:
    """13a's result: the JAX slow test's invariants (tests/test_prune.py:
    141-146, ``prune_trajectory.INVARIANTS``), PRINTED_INVARIANT printed
    and not gated. Returns its fused_dw_chain launches (the
    validations)."""
    from sod100k_tpu_torch.tools import prune_trajectory

    proc, log, out = started
    try:
        rc = proc.wait(timeout=1200)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
    say(f"13a: prune_trajectory {TRAJECTORY} (in its own process)")
    for line in text.splitlines():
        say(f"  | {line}")
    check(rc == 0, f"the trajectory's process exit {rc}")
    with open(out) as f:
        got = json.load(f)
    res, launches = got["result"], got["launches"]
    steps = (TRAJECTORY["train_epochs"] + TRAJECTORY["ft_epochs"] + 1) * (
        TRAJECTORY["images"] // TRAJECTORY["batch"])
    say(f"  {steps} train steps and the validations in {got['secs']:.1f} s "
        f"(beside 13b and phase 14); {launches} fused_dw_chain launches  "
        f"[{gpu}]")
    for name, ok in prune_trajectory.INVARIANTS.items():
        if name != PRINTED_INVARIANT:
            check(ok(res), name)
    # not gated: the JAX package's runs of this configuration fail it as
    # often (tests/test_torch_trajectory.py holds the recovery instead)
    met = prune_trajectory.INVARIANTS[PRINTED_INVARIANT](res)
    ratio = res["mae_post_finetune"] / res["mae_pre_prune"]
    say(f"  finetuned / pre-prune MAE {ratio:.3f} (the JAX slow test's "
        f"'{PRINTED_INVARIANT}', {'met' if met else 'not met'}; printed, "
        f"not gated)  [{gpu}]")
    check(launches > 0, "the trajectory's validations ran the kernel")
    return launches


def phase_ab(gpu: str) -> None:
    """13b: the bf16 A/B at B=24, 224^2, basewidth 40: finite
    trajectories and gammas, its markdown printed."""
    from sod100k_tpu_torch.tools import bf16_ab

    say(f"13b: bf16_ab {AB}")
    t0 = time.perf_counter()
    ab = bf16_ab.run_ab(**AB, device="cuda", log=lambda m: None)
    for line in ab["lines"]:
        say(f"  | {line.strip()}")
    curves = np.asarray([c[1:] for arm in ab["curves"].values()
                         for c in arm])
    check(np.isfinite(curves).all() and len(curves) == 2 * (
        AB["steps"] // AB["log_every"]), "finite A/B trajectories")
    check(all(np.isfinite(g).all() for g in ab["gammas"].values()),
          "finite gammas in both arms")
    say(f"  the A/B took {time.perf_counter() - t0:.1f} s (beside 13a)  "
        f"[{gpu}]")


# ---------------------------------------------------------------------------
# Data parallelism on the card (phase 14)

DP_BATCH = 24          # the recipe's batch, global: 12 per rank
DP_TIMED_STEPS = 10
DP_TRAIN_PAIRS = 48    # two B=24 steps of a driver epoch
DP_SWEEP_PAIRS = 64    # four B=16 batches: two per rank
DP_SWEEP_BATCH = 16


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_worker(role: str, args_path: str) -> None:
    """One rank of a phase-14 world, started by ``run_dp_ranks`` with the
    SOD100K_* variables: joins over gloo (two ranks on the one card, which
    NCCL refuses), runs ``role`` and writes its JSON result next to
    ``args_path``."""
    from sod100k_tpu_torch.parallel import mesh, multihost

    with open(args_path) as f:
        args = json.load(f)
    check(multihost.init_from_env(log=say, backend="gloo"),
          "the worker joined a world of several processes")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dw_chain.launches = 0
    out = {"rank": mesh.rank(), "device": str(mesh.local_device())}
    if role == "step":
        out.update(dp_steps(args, mesh.data_mesh()))
    elif role == "spatial":
        out.update(spatial_worker(args))
    elif role == "resident":
        out.update(resident_worker(args))
    else:
        out["reports"] = dp_sweep(args)
    torch.cuda.synchronize()
    out["launches"] = dw_chain.launches
    multihost.barrier("done")
    with open(f"{args_path}.rank{mesh.rank()}.json", "w") as f:
        json.dump(out, f)


def run_dp_ranks(role: str, args: dict, tmp: str, n: int = 2) -> list:
    """Run ``dp_worker(role)`` as ``n`` processes of one world on the card;
    returns their JSON results. Every process is waited for or killed."""
    repo = os.path.dirname(os.path.abspath(__file__))
    args_path = os.path.join(tmp, f"{role}-{len(os.listdir(tmp))}.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    port = free_port()
    procs = []
    try:
        for pid in range(n):
            env = {**os.environ, "PYTHONPATH": repo,
                   "SOD100K_COORDINATOR": f"127.0.0.1:{port}",
                   "SOD100K_NUM_PROCESSES": str(n),
                   "SOD100K_PROCESS_ID": str(pid)}
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.dp_worker({role!r}, "
                 f"{args_path!r})"], cwd=repo, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            say(text[-4000:])
        check(p.returncode == 0, f"{role} rank {pid} exit {p.returncode}")
    res = []
    for pid in range(n):
        with open(f"{args_path}.rank{pid}.json") as f:
            res.append(json.load(f))
    return res


def dp_steps(args: dict, m=None) -> dict:
    """``args["steps"]`` checked train steps of CSNet-L (u8 wire, the
    penalty on) at the global batch, then DP_TIMED_STEPS timed ones; on a
    data mesh ``m`` of several processes, this rank's rows. Returns the
    losses, the parameter checksum, the step time and, on a mesh, the
    gradient all-reduce's time."""
    from sod100k_tpu_torch.parallel import mesh, multihost

    torch.backends.cudnn.enabled = args.get("cudnn", True)
    model = CSNet(init_layers(40, (0.5, 0.5)), device="cuda")
    model.load_state_dict(torch.load(args["state"], map_location="cuda"))
    group = m.world if m is not None else None
    mesh.replicate(model, group)
    opt = (make_adam_dwd(model) if args["opt"] == "adam_dwd"
           else make_sgd(model, momentum=0.9))
    step = make_train_step(model, opt, **PENALTY, batch_size=DP_BATCH,
                           compute_dtype=getattr(torch, args["dtype"]),
                           from_u8=True, mesh=m)
    batches = [on_card(multihost.local_slice_feed(b) if group else b)
               for b in blob_batches(args["steps"], DP_BATCH, seed=14)]
    losses = []
    for b in batches:
        losses.append(step(b, LR, 1.0)["loss"].item())
    checksum = float(sum(p.detach().double().abs().sum()
                         for p in model.parameters()))
    times = step_ms(step, batches[0], DP_TIMED_STEPS if args.get(
        "cudnn", True) else 1)
    torch.backends.cudnn.enabled = True
    out = {"losses": losses, "checksum": checksum,
           "step_ms": float(np.median(times))}
    if group is not None:
        ar = step_ms(lambda *_: mesh.all_reduce_grads(model.parameters(),
                                                      group), None,
                     DP_TIMED_STEPS)
        out["allreduce_ms"] = float(np.median(ar))
        out["grad_mib"] = sum(p.grad.numel() * p.grad.element_size()
                              for p in model.parameters()) / 2**20
    return out


def phase_dp_train_driver(root: str, gpu: str) -> None:
    """14a: ``python -m sod100k_tpu_torch.cli.train`` under
    SOD100K_COORDINATOR with SOD100K_NUM_PROCESSES=1 (NCCL, a world of one
    process) against the same run without the variables: a world of one
    runs the single-process code, so the runs differ only by the card's
    run-to-run noise."""
    repo = os.path.dirname(os.path.abspath(__file__))
    make_synth_split(os.path.join(root, "DUTS-TR"), DP_TRAIN_PAIRS,
                     hw=(150, 200), jitter=10, seed=3)
    make_synth_split(os.path.join(root, "ECSSD"), 12, hw=(150, 200),
                     jitter=10, seed=4)
    runs = {}
    for tag in ("one process", "NCCL world of 1"):
        yml = os.path.join(root, f"train-{len(runs)}.yml")
        save = os.path.join(root, f"results-{len(runs)}")
        with open(yml, "w") as f:
            f.write(TRAIN_YAML.format(root=root).replace(
                f"{root}/results", save))
        env = {**os.environ, "PYTHONPATH": repo}
        if runs:
            env.update(SOD100K_COORDINATOR=f"127.0.0.1:{free_port()}",
                       SOD100K_NUM_PROCESSES="1", SOD100K_PROCESS_ID="0")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "sod100k_tpu_torch.cli.train", "--config",
             yml, "--epochs", "1"], cwd=repo, capture_output=True, text=True,
            timeout=600, env=env)
        if out.returncode:
            say(out.stdout[-3000:] + out.stderr[-3000:])
        check(out.returncode == 0, f"cli.train ({tag}) exit "
              f"{out.returncode}")
        lines = [l.strip() for l in out.stdout.splitlines()
                 if l.startswith(("Epoch:", " epoch:", "data parallel"))]
        ck = torch.load(os.path.join(save, "csnet-L-x2", "checkpoint",
                                     "checkpoint_epoch1.pth.tar"),
                        map_location="cpu", weights_only=False)["state_dict"]
        runs[tag] = {"lines": lines, "state": ck,
                     "wall_s": time.perf_counter() - t0}
        say(f"  {tag}: {' | '.join(lines)} ({runs[tag]['wall_s']:.1f} s)")
    a, b = runs.values()
    check(any("(nccl)" in l for l in b["lines"]),
          "the run under the variables joined over NCCL")

    def numbers(r) -> tuple:
        """The last printed loss and penalty, the val MAE, the checksum."""
        text = "\n".join(r["lines"])
        loss, pen = re.findall(r"Loss (\S+)\s+FakeFLOPs (\S+)", text)[-1]
        mae = re.search(r" mae: (\S+) best", text).group(1)
        return (float(loss), float(pen), float(mae),
                sum(float(v.double().abs().sum())
                    for v in r["state"].values()))

    (la, pa, ma, ca), (lb, pb, mb, cb) = numbers(a), numbers(b)
    diff = max(float((a["state"][k].double() - b["state"][k].double())
                     .abs().max()) for k in a["state"])
    say(f"  loss {la} / {lb}, penalty rel {abs(pa - pb) / pa:.2e}, val MAE "
        f"{ma} / {mb}, checkpoint checksum rel {abs(ca - cb) / ca:.2e}, "
        f"max |d| {diff:.3e} over {len(a['state'])} tensors")
    # CUDA training is not bit-reproducible between two processes (the
    # bilinear upsample's backward adds with atomics; max |d| 0.82 on a
    # BN running variance): the bars are the printed loss, the penalty and
    # the checksum within rel 1e-5, and the val MAE, read from maps
    # quantized to 1/255, within 5e-3 (pairs of runs of this code on the
    # card read 1.6e-4, 6.0e-4 and 1.5e-3 apart)
    check(la == lb, "the same printed loss")
    check(abs(pa - pb) <= 1e-5 * pa, "the penalty within rel 1e-5")
    check(abs(ma - mb) <= 5e-3, "the val MAE within 5e-3")
    check(abs(ca - cb) <= 1e-5 * ca, "the checkpoint's checksum within "
          "rel 1e-5")


def phase_dp_step(tmp: str, gpu: str) -> dict:
    """14b: two processes on the one card over gloo (CUDA tensors) run the
    CSNet-L train step at B=24 global (12 + 12) with the penalty on against
    the single-process B=24 step on the card, beside the single process's
    own distance between cuDNN on and off (the engine's noise):

    - f32 (TF32 off), SGD with momentum 0.9, 2 steps: the JAX multi-host
      oracle's bars and configuration (tests/test_multihost.py:102-104,
      tests/mh_worker.py): first loss within rel 1e-5, second within rel
      1e-4, parameter checksum within rel 1e-4;
    - bf16, Adam with dynamic weight decay (the recipe), 3 steps: the
      checksum within rel 1e-4. Its losses are printed, not gated: in
      bf16 one process's cuDNN on and off already differ by ~5e-4 on the
      first loss and by more later (the x100 net amplifies single bf16
      roundings), so no bar of 1e-5 holds between any two engines.
    """
    model = CSNet(init_layers(40, (0.5, 0.5)), seed=0, device="cuda")
    calib = np.random.default_rng(1).integers(0, 256, (4, *HW, 3), np.uint8)
    calibrate_bn(model, normalize_u8(torch.from_numpy(calib).cuda()))
    state = os.path.join(tmp, "dp_state.pt")
    torch.save(model.state_dict(), state)
    del model
    out = {}
    for dtype, opt, steps in (("float32", "sgd", 2),
                              ("bfloat16", "adam_dwd", 3)):
        tag = f"{dtype} {opt}, {steps} steps"
        args = {"state": state, "opt": opt, "dtype": dtype, "steps": steps}
        ref = dp_steps(args, None)
        alt = dp_steps({**args, "cudnn": False}, None)
        ranks = run_dp_ranks("step", args, tmp)
        got = ranks[0]
        for k in ("losses", "checksum"):
            check(ranks[1][k] == got[k], f"{tag}: {k} equal on both ranks")
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"])]
        eng = [abs(a - b) / abs(b) for a, b in zip(alt["losses"],
                                                   ref["losses"])]
        rel_c = abs(got["checksum"] - ref["checksum"]) / ref["checksum"]
        eng_c = abs(alt["checksum"] - ref["checksum"]) / ref["checksum"]
        say(f"  {tag}: two processes {got['losses']} vs one "
            f"{ref['losses']}: rel {', '.join(f'{r:.2e}' for r in rel)}, "
            f"checksum rel {rel_c:.2e} (devices "
            f"{[r['device'] for r in ranks]})")
        say(f"  {tag}: one process, cuDNN off vs on: rel "
            f"{', '.join(f'{r:.2e}' for r in eng)}, checksum rel "
            f"{eng_c:.2e} (the engine's own noise)")
        check(rel_c < 1e-4, f"{tag}: checksum within rel 1e-4")
        if dtype == "float32":
            check(rel[0] < 1e-5, f"{tag}: first loss within rel 1e-5")
            check(max(rel[1:]) < 1e-4, f"{tag}: later losses within 1e-4")
        say(f"  {tag}: step {got['step_ms']:.2f} / {ranks[1]['step_ms']:.2f}"
            f" ms per rank at 12 rows (two ranks on one card, gloo through "
            f"the host) vs {ref['step_ms']:.2f} ms at 24 rows in one "
            f"process; the gradient all-reduce alone "
            f"{got['allreduce_ms']:.2f} ms for {got['grad_mib']:.2f} MiB  "
            f"[{gpu}]")
        out[dtype] = {"rel": rel, "rel_checksum": rel_c, "engine": eng,
                      "step_ms": got["step_ms"], "ref_ms": ref["step_ms"],
                      "allreduce_ms": got["allreduce_ms"]}
    return out


def sweep_cfg(root: str):
    """The resident TESTALL configuration of 14c (CSNet-L at 224^2)."""
    from sod100k_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.TASK = "dp_sweep"
    cfg.DATA.SAVEDIR = root
    cfg.DATA.BATCH_SIZE = DP_SWEEP_BATCH
    cfg.TEST.DATASET_PATH = root
    cfg.TEST.DATASETS = ["ECSSD-DP"]
    cfg.TEST.IMAGE_H, cfg.TEST.IMAGE_W = HW
    cfg.TEST.MODEL_CONFIG = os.path.join(root, "dp_sweep", "lc.bin")
    cfg.TEST.BEGIN = cfg.TEST.INTERVAL = 1
    cfg.CUDA.TEST_RESIDENT = True
    return cfg


def dp_sweep(args: dict) -> list:
    """The resident TESTALL sweep through the driver, on the mesh of
    ``args["mesh_shape"]`` if given; its report lines."""
    from sod100k_tpu_torch.cli.test import run_testall_resident

    cfg = sweep_cfg(args["root"])
    cfg.CUDA.MESH_SHAPE = args.get("mesh_shape", "")
    reports = []
    run_testall_resident(cfg, log=reports.append)
    return [r for r in reports if "[resident]" in r]


def write_sweep_tree(root: str) -> None:
    """The split (DP_SWEEP_PAIRS synthetic pairs) and the checkpoint of a
    CSNet-L calibrated on 12 of its images that ``sweep_cfg(root)`` reads."""
    make_synth_split(os.path.join(root, "ECSSD-DP"), DP_SWEEP_PAIRS, seed=8)
    lc = init_layers(40, (0.5, 0.5))
    model = CSNet(lc, seed=5, device="cuda")
    ds = SalData(os.path.join(root, "ECSSD-DP"), HW, mode="val")
    calibrate_bn(model, normalize_u8(torch.from_numpy(np.stack([
        resize_u8_linear(ds._decode_u8(i)[0], HW)
        for i in range(12)])).cuda()))
    os.makedirs(os.path.join(root, "dp_sweep", "checkpoint"))
    lc.save(os.path.join(root, "dp_sweep", "lc.bin"))
    save_checkpoint(os.path.join(root, "dp_sweep", "checkpoint",
                                 "checkpoint_epoch1.pth.tar"), model, None,
                    epoch=1)


def phase_dp_sweep(root: str, tmp: str, gpu: str) -> int:
    """14c: two processes run the resident TESTALL sweep of a calibrated
    CSNet-L over DP_SWEEP_PAIRS images (the batches split over the ranks,
    the metric sums all-reduced): every rank's table equals the single
    process's to the report's six decimals. Returns the fused_dw_chain
    launches of both runs."""
    write_sweep_tree(root)
    dw_chain.launches = 0
    t0 = time.perf_counter()
    want = dp_sweep({"root": root})
    one_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dw_chain.launches
    t0 = time.perf_counter()
    ranks = run_dp_ranks("sweep", {"root": root}, tmp)
    two_s = time.perf_counter() - t0
    for r in ranks:
        say(f"  rank {r['rank']} ({r['device']}): {r['reports'][0]}; "
            f"{r['launches']} launches")
        check(r["reports"] == want, "the two-process table equals the "
              "single process's")
    say(f"  one process: {want[0]}; {launches} launches; {one_s:.1f} s, "
        f"two processes {two_s:.1f} s (process start and store build "
        f"included)  [{gpu}]")
    total = launches + sum(r["launches"] for r in ranks)
    check(all(r["launches"] > 0 for r in ranks),
          "every rank's sweep ran the kernel")
    return total


def phase_dp(gpu: str) -> int:
    """Phase 14: data parallelism on the card. Returns the fused_dw_chain
    launches over the phase (``dp_launches``)."""
    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as tmp:
        say("14a: cli.train in a world of one process over NCCL vs none")
        phase_dp_train_driver(root, gpu)
        say("14b: two processes on the card, the CSNet-L step at B=24 "
            "(12 + 12) vs one process")
        steps = phase_dp_step(tmp, gpu)
        say("14c: two processes, the resident TESTALL sweep vs one "
            "process")
        launches = phase_dp_sweep(root, tmp, gpu)
    say(f"  phase 14 took {time.perf_counter() - t14:.1f} s; {launches} "
        f"fused_dw_chain launches  [{gpu}]")
    return launches



# ---------------------------------------------------------------------------
# The 2-D data x spatial mesh on the card (phase 15)

SP_BATCH = 2            # (a) and (b): both images on both ranks (1 x 2)
SP_STEPS = 2            # (b): f32 SGD steps
SP_TIMED = 3            # timed forwards and steps per rank
SP_CSF_HW = 336         # (c): the recipe this mesh exists for
SP_CSF_ITER = 2
SP_TEST_HW = [(300, 400)] * 4  # (d): the test split, --test_batch 2
SP_TB = 2


def _spatial_images(seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (SP_BATCH, *HW, 3), np.uint8))


def _record_grads(optimizer, names: dict) -> dict:
    """The gradients each ``optimizer.step()`` sees, by parameter name."""
    seen: dict = {}

    def hook(opt, args, kwargs):
        for g in opt.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    seen[names[p]] = p.grad.detach().float().cpu().numpy()
    optimizer.register_step_pre_hook(hook)
    return seen


def _csf_micro_steps(model: CSFNet, mesh2d=None) -> dict:
    """(c): SP_CSF_ITER micro-steps of the f32 CSF step at B=1, 336^2 (u8
    wire); the summed gradients the apply sees, the micro-steps' losses
    (this rank's shares) and the step time."""
    from sod100k_tpu_torch.parallel import multihost

    freeze_reference_params(model)
    opt = make_csf_optimizer(model, CSF_WD)
    grads = _record_grads(opt, {p: n for n, p in model.named_parameters()})
    kw = {} if mesh2d is None else {"mesh": mesh2d, "image_h": SP_CSF_HW}
    step = make_csf_train_step(model, opt, iter_size=SP_CSF_ITER,
                               batch_size=1, from_u8=True, **kw)
    rng = np.random.default_rng(15)
    batches = [{"image": rng.integers(0, 256, (1, SP_CSF_HW, SP_CSF_HW, 3),
                                      np.uint8),
                "target": (rng.random((1, SP_CSF_HW, SP_CSF_HW, 1)) > 0.5
                           ).astype(np.uint8) * 255}
               for _ in range(SP_CSF_ITER)]
    if mesh2d is not None:
        batches = [multihost.local_slice_feed(b, mesh=mesh2d)
                   for b in batches]
    losses = [step(b, CSF_LR)["loss"].item() for b in batches]
    grads = dict(grads)  # the timed micro-steps below apply again
    times = []
    for _ in range(SP_TIMED):
        t0 = time.perf_counter()
        step(batches[0], CSF_LR)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "grads": grads,
            "micro_ms": float(np.median(times))}


def spatial_worker(args: dict) -> dict:
    """One rank of phase 15's 1 x 2 world (two ranks on the one card over
    gloo): (a) CSNet-L eval forwards on its band in f32 and bf16, each
    fused-tail window held against the plain version; (b) the f32 SGD
    train step on its bands; (c) the CSF micro-step at 336^2; (d)
    ``cli.csf --mode test --mesh_shape 1x2``. Rank 0 saves the gathered
    maps, the step's state and the gradients next to the args file."""
    from sod100k_tpu_torch.cli import csf as ccsf
    from sod100k_tpu_torch.parallel import mesh, multihost, spatial

    m = mesh.make_mesh_2d(1, 2)
    lc = init_layers(40, (0.5, 0.5))
    out: dict = {}
    arrays: dict = {}

    # (a) eval forwards on the bands
    model = CSNet(lc, device="cuda")
    model.load_state_dict(torch.load(args["csnet"], map_location="cuda"))
    model.eval()
    x = normalize_u8(_spatial_images(args["seed"]).cuda())
    orig = dw_chain.fused_dw_chain_packed
    out["spatial_launches"] = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        sp = spatial.SpatialCtx(m, HW[0])
        band = sp.shard(x.to(dtype), dim=1)
        calls = []

        def record(win, packed):
            y = orig(win, packed)
            calls.append((win, packed, y))
            return y
        dw_chain.fused_dw_chain_packed = record
        dw_chain.spatial_launches = 0
        try:
            with torch.no_grad():
                logits = model(band, spatial=sp)
            torch.cuda.synchronize()
        finally:
            dw_chain.fused_dw_chain_packed = orig
        out["spatial_launches"] += dw_chain.spatial_launches
        arrays[f"a_{name}"] = spatial.gather_bands(
            logits, sp, dim=1, h=HW[0]).float().cpu().numpy()
        errs = [dw_chain.check_against_plain(
            y, win, dw_chain.unpack_params(packed), **TOL[dtype])[0]
            for win, packed, y in calls]
        times = []
        for _ in range(SP_TIMED):
            t0 = time.perf_counter()
            with torch.no_grad():
                model(band, spatial=spatial.SpatialCtx(m, HW[0]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"a_{name}"] = {
            "tail_calls": len(calls), "tail_err": max(errs),
            "exchanges": sp.exchanges, "halo_bytes": sp.halo_bytes,
            "windows": sorted({tuple(w.shape) for w, _, _ in calls}),
            "ms": float(np.median(times))}
    del model

    # (b) the f32 train step on the bands
    model = CSNet(lc, device="cuda")
    model.load_state_dict(torch.load(args["csnet"], map_location="cuda"))
    step = make_train_step(model, make_sgd(model, momentum=0.9), **PENALTY,
                           batch_size=SP_BATCH, from_u8=True, mesh=m,
                           image_h=HW[0])
    batches = [on_card(multihost.local_slice_feed(b, mesh=m))
               for b in blob_batches(SP_STEPS, SP_BATCH, seed=15)]
    res = []
    for i, b in enumerate(batches):
        res.append(step(b, LR, 1.0))
        if i == 0 and multihost.is_primary():  # the one-step oracle's state
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       args["b_state"])
    out["b"] = {"losses": [r["loss"].item() for r in res],
                "penalties": [r["penalty"].item() for r in res],
                "checksum": float(sum(p.detach().double().abs().sum()
                                      for p in model.parameters())),
                "exchanges": res[0]["exchanges"],
                "halo_bytes": res[0]["halo_bytes"]}
    out["b"]["ms"] = float(np.median(step_ms(step, batches[0], SP_TIMED)))
    del model, step

    # (c) the CSF micro-step at 336^2
    model = CSFNet("res2net50", device="cuda")
    model.load_state_dict(torch.load(args["csf"], map_location="cuda"))
    c = _csf_micro_steps(model, m)
    out["c"] = {"losses": c["losses"], "micro_ms": c["micro_ms"]}
    arrays.update({f"c/{k}": v for k, v in c["grads"].items()})
    del model

    # (d) the CSF test driver on the mesh
    cfg = ccsf.build_parser().parse_args([
        "--mode", "test", "--model", args["csf_ckpt"], "--test_fold",
        args["d_fold"], "--mesh_shape", "1x2", "--test_batch", str(SP_TB)])
    cfg.test_root, cfg.test_list = args["d_root"], args["d_list"]
    out["d"] = ccsf.run_csf_test(cfg, log=lambda *a: None, device="cuda")
    if multihost.is_primary():
        np.savez(args["arrays"], **arrays)
    return out


def phase_spatial(gpu: str) -> int:
    """Phase 15: the 2-D data x spatial mesh (``parallel.spatial``) on the
    card. Two ranks share it over gloo (NCCL refuses two ranks on one
    card), as a 1 x 2 mesh: each image's rows split in two bands.

    (a) CSNet-L at 224^2, B=2, calibrated: f32 and bf16 eval forwards on
        the bands against one process's in the same dtype (f32: phase 3's
        bars, max |dlogit| < 1e-3 and sigmoid mean |d| < 1e-5; bf16,
        chaotic across cuDNN algorithms: the sigmoid mean |d| within a
        hundredth of one process's own bf16 distance between cuDNN on and
        off; H100 runs read 8.5e-09 against a spread of 8.5e-03, so the
        bar keeps four orders of margin and still catches a fault of the
        rows at a band seam), every fused-tail window (band + 2-row halo)
        held against the plain version;
    (b) the CSNet-L train step, f32 SGD (momentum 0.9), B=2, 2 steps,
        against one process at the JAX 2-D oracle's one-step bars
        (tests/test_parallel.py:287-300): the first loss within 1e-5, the
        penalties within rel 1e-5, every parameter and BN statistic after
        the first step within 1e-3 * max(1, max|leaf|), the parameter
        checksum after the second within rel 1e-4 (the multi-host oracle's
        bar). The second loss is printed beside one process's own cuDNN
        on-vs-off distance, not gated: after an lr-1e-3 step of the x100
        net one f32 rounding moves it by ~3e-4 (CPU runs of this step: the
        bands in f64 equal one process to 1e-7, in f32 3.3e-4 apart, and
        an f64 batch norm alone moves the bands' value by 5e-4);
    (c) the Res2Net-50 CSF micro-step at 336^2, B=1, iter_size 2, f32,
        against one process at tests/test_parallel.py:214-228's bars: the
        losses within rel 1e-5, the summed gradients within rtol 1e-3,
        atol 1e-4 * max(|g|, 1);
    (d) ``cli.csf --mode test --mesh_shape 1x2 --test_batch 2`` over 4
        images: the PNGs within one level of one process's.

    Prints the halo bytes and exchanges per forward and per step, the ms
    per forward and step on each rank against one process, and the
    phase's wall time. Returns the band kernel launches of (a)'s checked
    forwards on both ranks (``spatial_launches``)."""
    t15 = time.perf_counter()
    lc = init_layers(40, (0.5, 0.5))
    with tempfile.TemporaryDirectory() as tmp:
        model = CSNet(lc, seed=0, device="cuda")
        calib = np.random.default_rng(1).integers(0, 256, (4, *HW, 3),
                                                  np.uint8)
        calibrate_bn(model, normalize_u8(torch.from_numpy(calib).cuda()))
        csf_model = he_scale(CSFNet("res2net50", seed=0, device="cpu"), 24)
        args = {"seed": 150, "csnet": os.path.join(tmp, "csnet.pt"),
                "csf": os.path.join(tmp, "csf.pt"),
                "csf_ckpt": os.path.join(tmp, "csf.pth"),
                "b_state": os.path.join(tmp, "b_state.pt"),
                "arrays": os.path.join(tmp, "arrays.npz"),
                "d_root": os.path.join(tmp, "d"),
                "d_list": os.path.join(tmp, "d", "test.lst"),
                "d_fold": os.path.join(tmp, "d_maps")}
        torch.save(model.state_dict(), args["csnet"])
        torch.save(csf_model.state_dict(), args["csf"])
        save_checkpoint(args["csf_ckpt"], csf_model, None, epoch=0,
                        arch="csf_res2net50")
        os.makedirs(os.path.join(args["d_root"], "images"))
        pairs = synth_pairs(len(SP_TEST_HW), hw=SP_TEST_HW[0],
                            alternate_orientation=False, seed=16)
        for i, (img, _) in enumerate(pairs):
            write_png(os.path.join(args["d_root"], "images",
                                   f"s{i}.png"), img)
        with open(args["d_list"], "w") as f:
            f.writelines(f"images/s{i}.png\n"
                         for i in range(len(SP_TEST_HW)))

        t0 = time.perf_counter()
        ranks = run_dp_ranks("spatial", args, tmp)
        two_s = time.perf_counter() - t0
        got = ranks[0]
        arrays = dict(np.load(args["arrays"]))
        check(ranks[1]["b"]["losses"] == got["b"]["losses"],
              "15b: the same (all-reduced) losses on both ranks")

        # (a) one process
        model.eval()
        x = normalize_u8(_spatial_images(args["seed"]).cuda())
        sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
        one = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            with torch.no_grad():
                one[name] = model(x.to(dtype)).float().cpu().numpy()
            times = []
            for _ in range(SP_TIMED):
                t0 = time.perf_counter()
                with torch.no_grad():
                    model(x.to(dtype))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            a = got[f"a_{name}"]
            check(a["tail_calls"] == CALLS_PER_FORWARD,
                  f"15a {name}: {a['tail_calls']} tail calls on a band")
            say(f"  15a {name}: {a['tail_calls']} tail windows per rank "
                f"against the plain version, max |d| {a['tail_err']:.3e} "
                f"from its range; {a['exchanges']} exchanges, "
                f"{a['halo_bytes'] / 2**20:.3f} MiB of halo buffers per "
                f"forward per rank; {a['ms']:.2f} / "
                f"{ranks[1][f'a_{name}']['ms']:.2f} ms per forward on the "
                f"ranks vs {float(np.median(times)):.2f} ms in one process "
                f"(B={SP_BATCH})  [{gpu}]")
        # one process's bf16 spread: the same forward without cuDNN
        torch.backends.cudnn.enabled = False
        with torch.no_grad():
            bf_alt = model(x.to(torch.bfloat16)).float().cpu().numpy()
        torch.backends.cudnn.enabled = True
        banded = arrays["a_float32"]
        check(banded.shape == (SP_BATCH, *HW, 1)
              and np.isfinite(banded).all(), "15a: f32 maps' shape")
        d_logit = float(np.abs(banded - one["float32"]).max())
        d_sig = float(np.abs(sig(banded) - sig(one["float32"])).mean())
        bf = arrays["a_bfloat16"]
        bf_logit = float(np.abs(bf - one["bfloat16"]).max())
        bf_sig = float(np.abs(sig(bf) - sig(one["bfloat16"])).mean())
        alt_logit = float(np.abs(bf_alt - one["bfloat16"]).max())
        alt_sig = float(np.abs(sig(bf_alt) - sig(one["bfloat16"])).mean())
        say(f"  15a f32 bands vs one process: max |dlogit| {d_logit:.3e} "
            f"(< 1e-3), sigmoid mean |d| {d_sig:.3e} (< 1e-5); bf16 bands "
            f"vs one process's bf16: max |dlogit| {bf_logit:.3e}, sigmoid "
            f"mean |d| {bf_sig:.3e} (<= {alt_sig / 100:.3e}, a hundredth of "
            f"one process's cuDNN on vs off, {alt_sig:.3e}; its max |dlogit| "
            f"{alt_logit:.3e})")
        check(d_logit < 1e-3 and d_sig < 1e-5, "15a: f32 parity")
        check(bf.shape == banded.shape and np.isfinite(bf).all()
              and bf_sig <= alt_sig / 100, "15a: bf16 bands within a "
              "hundredth of one process's cuDNN on-vs-off spread")
        launches = got["spatial_launches"] + ranks[1]["spatial_launches"]
        check(got["spatial_launches"] == 2 * CALLS_PER_FORWARD
              and ranks[1]["spatial_launches"] == 2 * CALLS_PER_FORWARD,
              "15a: every band tail call launched the kernel")
        del model

        # (b) one process
        b = got["b"]
        runs = {}
        for cudnn in (True, False):
            torch.backends.cudnn.enabled = cudnn
            model = CSNet(lc, device="cuda")
            model.load_state_dict(torch.load(args["csnet"],
                                             map_location="cuda"))
            step = make_train_step(model, make_sgd(model, momentum=0.9),
                                   **PENALTY, batch_size=SP_BATCH,
                                   from_u8=True)
            batches = [on_card(bb) for bb in blob_batches(
                SP_STEPS, SP_BATCH, seed=15)]
            res, first = [], None
            for bb in batches:
                res.append(step(bb, LR, 1.0))
                if first is None:
                    first = {k: v.detach().float().cpu().clone()
                             for k, v in model.state_dict().items()}
            runs[cudnn] = {"losses": [r["loss"].item() for r in res],
                           "penalties": [r["penalty"].item() for r in res],
                           "first": first, "checksum": float(sum(
                               p.detach().double().abs().sum()
                               for p in model.parameters()))}
            if cudnn:
                one_ms = float(np.median(step_ms(step, batches[0],
                                                 SP_TIMED)))
            del model, step
        torch.backends.cudnn.enabled = True
        losses, pens = runs[True]["losses"], runs[True]["penalties"]
        got_sd = torch.load(args["b_state"])
        worst = max(float((got_sd[k].float() - v).abs().max())
                    / max(1.0, float(v.abs().max()))
                    for k, v in runs[True]["first"].items()
                    if v.is_floating_point())
        rel = [abs(g - w) / abs(w) for g, w in zip(b["losses"], losses)]
        rel_c = abs(b["checksum"] - runs[True]["checksum"]) \
            / runs[True]["checksum"]
        eng = [abs(g - w) / abs(w) for g, w in zip(runs[False]["losses"],
                                                   losses)]
        say(f"  15b f32 SGD, {SP_STEPS} steps: losses {b['losses']} vs "
            f"{losses} (rel {', '.join(f'{r:.2e}' for r in rel)}; one "
            f"process's cuDNN off vs on: {', '.join(f'{r:.2e}' for r in eng)}"
            f"), penalties {b['penalties']} vs {pens}, the state after "
            f"step 1 within {worst:.2e} of max(1, max|leaf|), the "
            f"parameter checksum after step {SP_STEPS} within rel "
            f"{rel_c:.2e}; "
            f"{b['exchanges']} exchanges, {b['halo_bytes'] / 2**20:.3f} "
            f"MiB of halo buffers per step per rank; {b['ms']:.1f} / "
            f"{ranks[1]['b']['ms']:.1f} ms per step on the ranks vs "
            f"{one_ms:.1f} ms in one process  [{gpu}]")
        check(abs(b["losses"][0] - losses[0]) < 1e-5,
              "15b: first loss within 1e-5")
        check(all(abs(g - w) <= 1e-5 * w for g, w in zip(b["penalties"],
                                                          pens)),
              "15b: penalties within rel 1e-5")
        check(worst <= 1e-3, "15b: the state after step 1 within 1e-3 * "
              "max(1, max|leaf|)")
        check(rel_c < 1e-4, "15b: the checksum within rel 1e-4")

        # (c) one process
        c = got["c"]
        csf_one = _csf_micro_steps(copy.deepcopy(csf_model).cuda())
        torch.backends.cudnn.enabled = False
        csf_alt = _csf_micro_steps(csf_model.cuda())
        torch.backends.cudnn.enabled = True
        want_loss = sum(csf_one["losses"])
        got_loss = sum(c["losses"]) + sum(ranks[1]["c"]["losses"])

        def bar_share(grads) -> tuple:
            """The largest share of the JAX oracle's bar, and its tensor."""
            worst = (0.0, "")
            for k, g in csf_one["grads"].items():
                bar = 1e-3 * np.abs(g) + 1e-4 * max(float(np.abs(g).max()),
                                                    1.0)
                worst = max(worst, (float((np.abs(grads[k] - g) / bar).max()),
                                    k))
            return worst

        worst_g, worst_k = bar_share({k[2:]: v for k, v in arrays.items()
                                      if k.startswith("c/")})
        eng_g, eng_k = bar_share(csf_alt["grads"])
        say(f"  15c CSF micro-steps at {SP_CSF_HW}^2: loss {got_loss:.6f} vs "
            f"{want_loss:.6f}, gradients at {worst_g:.3f} of the bar over "
            f"{len(csf_one['grads'])} tensors (worst {worst_k}; one "
            f"process's cuDNN off vs on: {eng_g:.3f}, {eng_k}); "
            f"{c['micro_ms']:.1f} / {ranks[1]['c']['micro_ms']:.1f} ms per "
            f"micro-step on the ranks vs {csf_one['micro_ms']:.1f} ms in one "
            f"process  [{gpu}]")
        check(abs(got_loss - want_loss) <= 1e-5 * abs(want_loss),
              "15c: loss within rel 1e-5")
        check(worst_g <= 1.0, "15c: gradients within rtol 1e-3, atol "
              "1e-4 * max(|g|, 1)")
        del csf_model

        # (d) one process
        tree = {"test": args["d_root"]}
        res_one, maps_one, _ = _csf_test(
            tree, os.path.join(tmp, "d_one"), "cuda", "test.lst",
            "--model", args["csf_ckpt"], "--test_batch", str(SP_TB))
        maps = _driver_maps(args["d_fold"])
        d_lv = _levels(maps, maps_one, "15d")
        check(len(maps) == len(SP_TEST_HW) and d_lv <= 1,
              f"15d: mesh maps {d_lv} levels from one process's (bar 1)")
        say(f"  15d cli.csf test, 1 x 2 mesh: {got['d']['fps']:.2f} FPS vs "
            f"{res_one['fps']:.2f} in one process, {d_lv} level(s) apart  "
            f"[{gpu}]")
    say(f"  phase 15 took {time.perf_counter() - t15:.1f} s (the two-rank "
        f"run {two_s:.1f} s, process start included); {launches} band "
        f"kernel launches  [{gpu}]")
    return launches


# ---------------------------------------------------------------------------
# The resident programs on the 2-D mesh (phase 16)

RM_BATCH = 4            # (a): one batch of the store: nb = 1
RM_STORE = 256          # (a): the resident store's size (the JAX default)
RM_LR = 1e-4            # (a): the JAX oracle's (tests/test_parallel.py:371)
RM_CSF_BATCH = 2        # (c)
RM_SMOKE_HW = 64        # (d): the smoke chain's image size


def _resident_store(n: int, hw: int, seed: int) -> dict:
    """``n`` synthetic pairs at ``hw``^2 as a resident store on the card."""
    pairs = list(synth_pairs(n, hw=(hw, hw), alternate_orientation=False,
                             seed=seed))
    return {"image_u8": torch.from_numpy(np.stack([p[0] for p in pairs]))
            .cuda(),
            "gt_u8": torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()}


def resident_epoch(state: str, m=None) -> tuple[dict, dict]:
    """(a): one resident CSNet-L epoch, f32, one batch of RM_BATCH from a
    RM_STORE^2 store, Adam with dynamic weight decay, the penalty on, the
    permutation and crops from one seeded generator; (its loss and
    penalty, the state after it)."""
    model = CSNet(init_layers(40, (0.5, 0.5)), device="cuda")
    model.load_state_dict(torch.load(state, map_location="cuda"))
    kw = {} if m is None else {"mesh": m, "image_h": HW[0]}
    step = make_train_step(model, make_adam_dwd(model), **PENALTY,
                           batch_size=RM_BATCH, **kw)
    epoch = make_resident_epoch_fn(step, batch_size=RM_BATCH, out_hw=HW,
                                   max_crop=MAX_CROP, mesh=m)
    gen = torch.Generator("cuda").manual_seed(16)
    losses, pens = epoch(_resident_store(RM_BATCH, RM_STORE, 16), gen, RM_LR,
                         1.0)
    return ({"losses": losses.tolist(), "penalties": pens.tolist()},
            {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()})


def resident_eval(root: str, m=None) -> dict:
    """(b): the resident validation and the sweep's image count over the
    sweep tree's split, on the checkpoint ``sweep_cfg`` reads."""
    model = CSNet(init_layers(40, (0.5, 0.5)), device="cuda")
    model.load_state_dict(torch.load(os.path.join(
        root, "dp_sweep", "checkpoint", "checkpoint_epoch1.pth.tar"),
        map_location="cuda", weights_only=False)["state_dict"])
    data = build_resident_val_dataset(
        SalData(os.path.join(root, "ECSSD-DP"), HW, mode="val"), HW,
        DP_SWEEP_BATCH, device="cuda")
    canvas = data.pop("_canvas_hw")
    es = make_eval_step(model, from_u8=True, mesh=m)
    sums = make_resident_salmetric_fn(es, batch_size=DP_SWEEP_BATCH,
                                      canvas_hw=canvas, mesh=m)(data)
    val = make_resident_val_fn(es, batch_size=DP_SWEEP_BATCH,
                               canvas_hw=canvas, mesh=m)(data)
    return {"n": float(sums["n"].sum()), "mae_sum": sums["mae_sum"].tolist(),
            "val": float(val)}


def resident_csf_epoch(state: str, m=None) -> dict:
    """(c): one resident CSF epoch of one micro-step, Res2Net-50 at
    SP_CSF_HW^2, f32, B=RM_CSF_BATCH, the draws given: the global loss and
    the checksum of the trainable parameters' update."""
    from sod100k_tpu_torch.parallel import mesh

    model = CSFNet("res2net50", device="cuda")
    model.load_state_dict(torch.load(state, map_location="cuda"))
    freeze_reference_params(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    kw = {} if m is None else {"mesh": m, "image_h": SP_CSF_HW}
    step = make_csf_train_step(model, make_csf_optimizer(model, CSF_WD),
                               iter_size=1, batch_size=RM_CSF_BATCH, **kw)
    draws = (np.array([[1, 0]]), np.array([[True, False]]))
    losses = make_resident_csf_epoch_fn(
        step, batch_size=RM_CSF_BATCH, mesh=m)(
        _resident_store(RM_CSF_BATCH, SP_CSF_HW, 17), None, CSF_LR,
        draws=draws)
    # each rank returns its band's share: the driver sums over the world
    loss = mesh.all_reduce_sum({"loss": losses},
                               None if m is None else m.world)["loss"]
    after = dict(model.named_parameters())
    return {"loss": float(loss.sum()),
            "update": sum(float((after[n].detach() - p).double().abs().sum())
                          for n, p in before.items())}


def resident_worker(args: dict) -> dict:
    """One rank of phase 16's 1 x 2 world (two ranks on the one card over
    gloo): (a) the resident CSNet-L epoch, (b) the resident TESTALL sweep
    through the driver and the resident validation, (c) the resident CSF
    epoch. Rank 0 saves (a)'s state next to the args file."""
    from sod100k_tpu_torch.parallel import mesh, multihost

    m = mesh.make_mesh_2d(1, 2)
    out, state = {}, {}
    out["a"], state = resident_epoch(args["csnet"], m)
    if multihost.is_primary():
        torch.save(state, args["a_state"])
    dw_chain.launches = dw_chain.spatial_launches = 0
    out["b"] = {"reports": dp_sweep({"root": args["root"],
                                     "mesh_shape": "1x2"}),
                **resident_eval(args["root"], m)}
    torch.cuda.synchronize()
    out["b"]["launches"] = dw_chain.launches
    out["b"]["spatial_launches"] = dw_chain.spatial_launches
    out["c"] = resident_csf_epoch(args["csf"], m)
    return out


SMOKE_SHIM = """\
import atexit, json, runpy, sys
from sod100k_tpu_torch.ops import dw_chain
from sod100k_tpu_torch.parallel import multihost
multihost.init_from_env(backend="gloo")  # two ranks on one card
atexit.register(lambda: print("LAUNCHES " + json.dumps(
    [dw_chain.launches, dw_chain.spatial_launches]), flush=True))
sys.argv = ["sod100k_tpu_torch.cli.smoke", *sys.argv[1:]]
runpy.run_module("sod100k_tpu_torch.cli.smoke", run_name="__main__",
                 alter_sys=True)
"""


def phase_smoke_mesh(tmp: str, gpu: str) -> tuple[int, float]:
    """(d): ``python -m sod100k_tpu_torch.cli.smoke --dry-data --mesh_shape
    1x2 --train-epochs 1`` as two ranks on the card (run through a shim
    that joins over gloo, which the card's two ranks need, and prints the
    kernel's launch counts at exit). Returns the launches and the wall
    time."""
    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    argv = ["--dry-data", "--mesh_shape", "1x2", "--train-epochs", "1",
            "--image-hw", str(RM_SMOKE_HW), "--save-dir",
            os.path.join(tmp, "smoke")]
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(2):
            env = {**os.environ, "PYTHONPATH": repo,
                   "SOD100K_COORDINATOR": f"127.0.0.1:{port}",
                   "SOD100K_NUM_PROCESSES": "2",
                   "SOD100K_PROCESS_ID": str(pid)}
            procs.append(subprocess.Popen(
                [sys.executable, "-c", SMOKE_SHIM, *argv], cwd=repo, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    launches = 0
    for pid, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            say(text[-4000:])
        check(p.returncode == 0, f"16d: cli.smoke rank {pid} exit "
              f"{p.returncode}")
        ok = [l for l in text.splitlines() if l.startswith("[smoke] OK")]
        check(len(ok) == 1, f"16d: rank {pid} reports [smoke] OK")
        epoch = re.search(r"resident_eval=.*'epoch': (-?\d+)", ok[0])
        check(epoch is not None and int(epoch.group(1)) >= 1,
              f"16d: rank {pid}'s resident sweep scored an epoch >= 1")
        total, band = json.loads([l for l in text.splitlines()
                                  if l.startswith("LAUNCHES ")][-1][9:])
        check(band > 0, f"16d: rank {pid}'s chain ran the band kernel")
        launches += total
        say(f"  16d rank {pid}: {ok[0][:160]}; {total} tail launches, "
            f"{band} on bands")
    say(f"  16d cli.smoke --mesh_shape 1x2: {wall:.1f} s for the two-rank "
        f"chain (process start included)  [{gpu}]")
    return launches, wall


def phase_resident_mesh(gpu: str) -> int:
    """Phase 16: the resident programs on the 2-D mesh. Two ranks share
    the card over gloo as a 1 x 2 mesh, as in phase 15.

    (a) the resident CSNet-L epoch, f32, full width, a 256^2 store, out
        224^2, B=4, one batch (nb = 1: tests/test_parallel.py:336-342),
        Adam with dynamic weight decay at lr 1e-4, the penalty on, against
        one process on the same draws: loss and penalty within rel 1e-5,
        every parameter and BN statistic after the step within 1e-3 *
        max(1, max|leaf|);
    (b) the resident TESTALL sweep through the driver (``cli.test``'s
        ``run_testall_resident`` with CUDA.MESH_SHAPE "1x2") and the
        resident validation, f32, on 14c's calibrated CSNet-L and split:
        each rank's report table equal to one process's at the report's
        six decimals, the val MAE within 1e-6, the sweep's image count
        equal to the split's; every rank's sweep launched the tail kernel
        on its bands (``dw_chain.spatial_launches``, counted at the launch
        site);
    (c) the resident CSF epoch, Res2Net-50 at 336^2, B=2, one micro-step,
        the draws given, against one process: the loss within rel 1e-5,
        the checksum of the trainable parameters' update within rel 1e-4;
    (d) ``cli.smoke --dry-data --mesh_shape 1x2`` at 64 px, one train and
        one finetune epoch, as two ranks: each reports ``[smoke] OK`` and
        a resident sweep epoch >= 1.

    Returns the tail kernel's launches over (b) and (d) on every rank
    (``resident_mesh_launches``)."""
    t16 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        model = CSNet(init_layers(40, (0.5, 0.5)), seed=0, device="cuda")
        calib = np.random.default_rng(1).integers(0, 256, (4, *HW, 3),
                                                  np.uint8)
        calibrate_bn(model, normalize_u8(torch.from_numpy(calib).cuda()))
        root = os.path.join(tmp, "root")
        write_sweep_tree(root)
        args = {"root": root, "csnet": os.path.join(tmp, "csnet.pt"),
                "csf": os.path.join(tmp, "csf.pt"),
                "a_state": os.path.join(tmp, "a_state.pt")}
        torch.save(model.state_dict(), args["csnet"])
        del model
        torch.save(he_scale(CSFNet("res2net50", seed=0, device="cpu"), 24)
                   .state_dict(), args["csf"])
        t0 = time.perf_counter()
        ranks = run_dp_ranks("resident", args, tmp)
        two_s = time.perf_counter() - t0

        # (a)
        want, want_state = resident_epoch(args["csnet"])
        got_state = torch.load(args["a_state"])
        for r in ranks:
            check(r["a"] == ranks[0]["a"], "16a: the same (all-reduced) "
                  "loss and penalty on both ranks")
        a = ranks[0]["a"]
        rel_l = abs(a["losses"][0] - want["losses"][0]) / want["losses"][0]
        rel_p = abs(a["penalties"][0] - want["penalties"][0]) \
            / want["penalties"][0]
        worst = max(float((got_state[k].float() - v.float()).abs().max())
                    / max(1.0, float(v.float().abs().max()))
                    for k, v in want_state.items() if v.is_floating_point())
        say(f"  16a resident CSNet-L epoch, f32, B={RM_BATCH}: loss "
            f"{a['losses'][0]:.8f} vs {want['losses'][0]:.8f} (rel "
            f"{rel_l:.2e}), penalty rel {rel_p:.2e}, the state after the "
            f"step within {worst:.2e} of max(1, max|leaf|)  [{gpu}]")
        check(rel_l <= 1e-5 and rel_p <= 1e-5, "16a: loss and penalty "
              "within rel 1e-5")
        check(worst <= 1e-3, "16a: the state within 1e-3 * max(1, "
              "max|leaf|)")

        # (b)
        dw_chain.launches = 0
        reports = dp_sweep({"root": root})
        one = resident_eval(root)
        n_split = len(os.listdir(os.path.join(root, "ECSSD-DP", "images")))
        launches = 0
        for r in ranks:
            b = r["b"]
            say(f"  16b rank {r['rank']}: {b['reports'][0]}; val MAE "
                f"{b['val']:.9f}, n {b['n']:.0f}; {b['launches']} tail "
                f"launches, {b['spatial_launches']} on bands")
            check(b["reports"] == reports, "16b: the rank's table equals "
                  "one process's to six decimals")
            check(abs(b["val"] - one["val"]) <= 1e-6, "16b: val MAE within "
                  "1e-6")
            check(b["n"] == one["n"] == n_split, "16b: n is the split's "
                  "image count")
            check(b["spatial_launches"] > 0, "16b: the rank's sweep ran the "
                  "tail kernel on its bands")
            launches += b["launches"]
        say(f"  16b one process: {reports[0]}; val MAE {one['val']:.9f}; "
            f"{dw_chain.launches} launches")

        # (c)
        c = ranks[0]["c"]
        want_c = resident_csf_epoch(args["csf"])
        rel_c = abs(c["loss"] - want_c["loss"]) / abs(want_c["loss"])
        rel_u = abs(c["update"] - want_c["update"]) / want_c["update"]
        say(f"  16c resident CSF epoch at {SP_CSF_HW}^2, B={RM_CSF_BATCH}: "
            f"loss {c['loss']:.6f} vs {want_c['loss']:.6f} (rel "
            f"{rel_c:.2e}), update checksum rel {rel_u:.2e}  [{gpu}]")
        check(ranks[1]["c"] == c, "16c: the same loss and update on both "
              "ranks")
        check(rel_c <= 1e-5, "16c: loss within rel 1e-5")
        check(rel_u <= 1e-4, "16c: update checksum within rel 1e-4")

        # (d)
        smoke_launches, _ = phase_smoke_mesh(tmp, gpu)
        launches += smoke_launches
    say(f"  phase 16 took {time.perf_counter() - t16:.1f} s (the two-rank "
        f"run of (a)-(c) {two_s:.1f} s, process start included); "
        f"{launches} tail launches over 16b and 16d  [{gpu}]")
    return launches


TOOLS_EXTRAS = [  # tools.bench_extras --skip-e2e, in its order
    "csnet_l_x2_224_serving_artifact_img_per_sec[bf16,B=128]",
    "csnet_l_x2_224_infer_latency_ms[bf16,B=1]",
    "csf_res2net50_336_infer_latency_ms[bf16,B=1]",
    "csf_res2net50_336_infer_img_per_sec[bf16,B=32]",
    "csf_res2net101_336_infer_img_per_sec[bf16,B=32]",
    "csnet_l_x2_224_train_step_img_per_sec[f32,B=128]",
    "csnet_l_x2_224_train_step_img_per_sec[f32,B=24]",
    "csnet_l_x2_224_train_step_img_per_sec[bf16,B=128]",
    "csf_res2net50_336_train_microstep_ms[B=1]",
    "csf_res2net50_336_train_microstep_ms[B=8]",
    "csf_res2net50_336_train_microstep_ms[bf16,B=8]",
    "csf_res2net50_336_train_microstep_ms[bf16,B=32]",
    "csf_res2net101_336_train_microstep_ms[bf16,B=8]",
    "csf_res2net50_336_resident_train_img_per_sec[bf16,B=8]",
    "csnet_l_x2_resident_val_img_per_sec[bf16,B=128,n=512]",
    "csnet_l_x2_resident_testall_img_per_sec[bf16,B=128,n=512]",
]
SERVE_KEYS = ["direct_img_per_sec", "served_img_per_sec",
              "served_over_direct", "clients", "req_batch", "dispatches",
              "mean_dispatch_batch", "client_encode_ms", "hw", "buckets",
              "wire", "dtype", "device", "power_limit"]


def phase_tools_bench(gpu: str) -> int:
    """Phase 17: the measurement tools on the card (the module docstring
    lists what each step checks). Returns the tail kernel's launches over
    the phase."""
    from sod100k_tpu_torch.tools import (bench, bench_check, bench_extras,
                                         bench_serve, perf_probe, timing)

    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    start = dw_chain.launches
    info = timing.card("cuda")
    check(f"{info['device']}, {info['power_limit']}" == gpu,
          "the tools read the card's name and power limit as nvidia-smi "
          "prints them")
    times = {}

    say("17a: tools.bench at its defaults")
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main([])
    lines = buf.getvalue().splitlines()
    check(len(lines) == 1, f"tools.bench printed {len(lines)} stdout lines")
    row = json.loads(lines[0])
    say(f"  {lines[0]}")
    check(list(row)[:4] == ["metric", "value", "unit", "vs_baseline"] and
          row["metric"] in (
              "csnet_l_x2_224_inference_images_per_sec_per_chip[bf16]",
              "csnet_l_x2_224_inference_images_per_sec_per_chip[f32]") and
          row["device"] == info["device"] and row["value"] > 0,
          "tools.bench's row: the JAX keys and metric name, the card")
    launches = dw_chain.launches - start
    want = CALLS_PER_FORWARD * (2 + 1 + timing.REPEATS * bench.SCAN_LEN)
    say(f"  {launches} tail kernel launches (33 x (2 gates + 1 warm-up + "
        f"{timing.REPEATS} x {bench.SCAN_LEN} timed forwards) = {want})")
    check(launches == want, "tools.bench ran every CSNet forward through "
          "the kernel")
    times["17a"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        say("17b: tools.bench_serve --secs 5")
        t = time.perf_counter()
        before = dw_chain.launches
        srow = bench_serve.main(["--secs", "5"])
        check(list(srow) == SERVE_KEYS and srow["served_img_per_sec"] > 0
              and srow["direct_img_per_sec"] > 0,
              "tools.bench_serve's row: the JAX row's keys, img/s > 0")
        check(dw_chain.launches > before, "bench_serve ran the kernel")
        say(f"  {dw_chain.launches - before} tail kernel launches")
        times["17b"] = time.perf_counter() - t

        say("17c: tools.bench_extras --skip-e2e, best of 1 (the full "
            "run's best of 3 is the headline's)")
        t = time.perf_counter()
        extras = os.path.join(tmp, "extras.json")
        before = dw_chain.launches
        repeats, timing.REPEATS = timing.REPEATS, 1
        try:
            entries = bench_extras.main(["--skip-e2e", "--out", extras])
        finally:
            timing.REPEATS = repeats
        names = [e["metric"] for e in entries]
        check(names == TOOLS_EXTRAS, f"bench_extras' rows: {names}")
        check(all(math.isfinite(e["value"]) and e["value"] > 0
                  for e in entries), "bench_extras' values finite and > 0")
        say(f"  {dw_chain.launches - before} tail kernel launches")
        times["17c"] = time.perf_counter() - t

        say("17d: tools.bench_check --record, then against the record")
        t = time.perf_counter()
        ref = os.path.join(tmp, "reference.json")
        bench_check.main(["--record", "--reference", ref,
                          "--extras-json", extras])
        bench_check.main(["--reference", ref, "--extras-json", extras])
        times["17d"] = time.perf_counter() - t

    say("17e: tools.perf_probe ablate and dwlayout")
    t = time.perf_counter()
    ablate = perf_probe.ablate("cuda")
    dw = perf_probe.dwlayout("cuda")
    check(all(math.isfinite(v) and v > 0 for v in list(ablate.values()) +
              [v for k, v in dw.items() if k != "bound_by"]),
          "perf_probe's times finite and > 0")
    times["17e"] = time.perf_counter() - t
    launches = dw_chain.launches - start
    say(f"  phase 17 took {time.perf_counter() - t17:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
        + f"); {launches} tail launches  [{gpu}]")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    check(sys.argv[1:] in ([], ["--variants"]), "arguments: none or --variants")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("TF32 off for convolutions and matmuls: f32 phases run in full f32")

    say("phase 1: build")
    for name in ("dw_chain", "resize_bilinear"):
        t0 = time.perf_counter()
        lib = cuda_lib.build(name)
        say(f"  built {lib} in {time.perf_counter() - t0:.1f} s")
        with open(f"{lib}.log") as f:
            say("  " + f.read().strip().replace("\n", "\n  "))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(smi)
    gpu = smi.splitlines()[0]

    if sys.argv[1:] == ["--variants"]:
        say("variants of the kernel's plans and diagnostic builds")
        phase_variants(gpu)
        return

    say("phase 2: kernel vs plain on the card")
    err = phase_kernel_vs_plain()

    say("phase 3: CSNet-L f32, card vs CPU")
    model_cpu = CSNet(init_layers(40, (0.5, 0.5)), seed=0, device="cpu")
    rng = np.random.default_rng(1)
    calib = rng.integers(0, 256, (4, *HW, 3), np.uint8)
    calibrate_bn(model_cpu, normalize_u8(torch.from_numpy(calib)))
    phase_model_f32(model_cpu, calib[:2])

    say("phase 4: serving, bf16 compute (the main path)")
    with tempfile.TemporaryDirectory() as artifact:
        sm, served_launches = phase_serving(model_cpu, artifact,
                                            torch.bfloat16)
    say("phase 4b: serving, f32 compute")
    with tempfile.TemporaryDirectory() as artifact:
        sm_f32, _ = phase_serving(model_cpu, artifact, torch.float32)
    x = torch.from_numpy(calib[:2])
    mae = (make_eval_step(sm.model, from_u8=True, compute_dtype=torch.bfloat16)(x)
           - make_eval_step(sm_f32.model, from_u8=True)(x)).abs().mean().item()
    say(f"  bf16 vs f32 sigmoid MAE on fresh calibrated weights: {mae:.4e} "
        f"(not gated)")

    say("phase 5: times (not gated)")
    tot, by = phase_times(sm, gpu)
    del sm, sm_f32

    say("phase 6: train, f32, card vs CPU")
    phase_train_f32(model_cpu)

    say(f"phase 7: train on the main path (B={TRAIN_BATCH} bf16, u8 wire, "
        f"Adam with dynamic weight decay, penalty on)")
    batches = [on_card(b) for b in blob_batches(4, TRAIN_BATCH, seed=7)]
    trained, train_launches = phase_train(model_cpu, batches)

    say("phase 8: prune and finetune")
    slim, slim_calls = phase_prune(trained, batches)

    say("phase 8b: training times (not gated)")
    slim_launches, train_step = phase_train_times(trained, slim, slim_calls,
                                                  batches, gpu)

    say("phase 9: the dataset on the card")
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as split_dir:
        say(f"9a: a synthetic split of {SPLIT_N} PNG pairs")
        ds, split = phase_split(split_dir)
        # phase 7's weights with BN statistics recalibrated on 12 of the
        # split's images: the running statistics lag the weights, and the
        # split's discs have another colour than phase 7's
        sweep_model = copy_of(trained, "cuda")
        calibrate_bn(sweep_model, normalize_u8(torch.from_numpy(np.stack([
            resize_u8_linear(ds._decode_u8(i)[0], HW)
            for i in range(SPLIT_N - 12, SPLIT_N)])).cuda()))
        say(f"9b: the TESTALL sweep, B={SWEEP_BATCH}, f32 and bf16")
        sweep = phase_sweep(sweep_model, ds, gpu)
        say("9c: the metrics alone, card vs CPU")
        phase_metrics(ds, sweep["canvas"])
        say(f"9d: a resident training epoch (B={TRAIN_BATCH} bf16, "
            f"Adam-dwd, penalty on) and validation")
        epoch = phase_epoch(trained, ds, sweep, gpu)
        say("9e: times (not gated)")
        phase_dataset_times(sweep_model, sweep, epoch, train_step, split,
                            gpu)
        say(f"  phase 9 took {time.perf_counter() - t9:.1f} s")
        say(f"phase 10: CSF+Res2Net (the store of 10d: the split's first "
            f"{CSF_STORE_PAIRS} pairs through a .lst file)")
        store = csf_store(split_dir)
    sweep_launches = sweep["launches_per_forward"]
    del sweep, sweep_model, trained, slim, epoch

    t10 = time.perf_counter()
    dw_chain.launches = 0
    resize_before = resize_kernel.launches
    say("10a: Res2Net-50 and -101, f32, card vs CPU")
    r50 = phase_csf_forward()
    say("10b: serving a Res2Net-50 artifact at 336^2")
    phase_csf_serving(r50)
    say("10c: the train step, f32, card vs CPU")
    phase_csf_train_f32(r50)
    say(f"10d: the resident CSF epoch (B={CSF_BATCH} bf16, Adam lr "
        f"{CSF_LR:g} wd {CSF_WD:g}, iter_size {CSF_ITER})")
    csf_epoch = phase_csf_epoch(r50, store, gpu)
    del store
    say("10e: a .lst split through padded_batches into a masked step")
    phase_csf_lst(r50)
    say("10f: times (not gated)")
    csf_step_ms = phase_csf_times(r50, csf_epoch, gpu)
    torch.cuda.synchronize()
    csf_resize_launches = resize_kernel.launches - resize_before
    say("10g: the resize kernel at every resize of the CSF served forward "
        "and the CSNet-L-x2 train forward")
    resize = phase_resize(r50, gpu)
    csf_launches = dw_chain.launches
    say(f"  phase 10 took {time.perf_counter() - t10:.1f} s; "
        f"{csf_launches} fused_dw_chain launches (CSF runs no TPU kernel's "
        f"port); {csf_resize_launches} resize kernel launches over 10a-10f")
    check(csf_launches == 0, "the CSF path launches no depthwise-tail kernel")
    check(csf_resize_launches > 0, "the CSF path resizes through the kernel")

    say("phase 11: the drivers (python -m sod100k_tpu_torch.cli.*) on "
        "CSNet-L, B=24 at 224^2")
    cli_launches = phase_drivers(gpu, train_step)

    say("phase 12: the CSF driver (python -m sod100k_tpu_torch.cli.csf) "
        "and the native SalMetric")
    csf_cli_launches = phase_csf_cli(gpu, csf_step_ms)

    say("phase 13: the recipe tools (python -m sod100k_tpu_torch.tools.*); "
        "13a runs in its own process beside 13b and phase 14")
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trajectory = start_trajectory(tmp)
        try:
            phase_ab(gpu)
            say("phase 14: data parallelism (sod100k_tpu_torch.parallel)")
            dp_launches = phase_dp(gpu)
            say("phase 15: the 2-D data x spatial mesh "
                "(sod100k_tpu_torch.parallel.spatial), two ranks on the "
                "card as 1 x 2")
            spatial_launches = phase_spatial(gpu)
            say("phase 16: the resident programs on the 2-D mesh, two "
                "ranks on the card as 1 x 2")
            resident_mesh_launches = phase_resident_mesh(gpu)
        except BaseException:
            proc, log, _ = trajectory
            proc.kill()
            proc.wait()
            log.close()
            raise
        tools_launches = finish_trajectory(trajectory, gpu)
    say(f"  phases 13 to 16 took {time.perf_counter() - t13:.1f} s  "
        f"[{gpu}]")

    say("phase 17: the measurement tools (python -m "
        "sod100k_tpu_torch.tools.{bench,bench_serve,bench_extras,"
        "bench_check,perf_probe})")
    tools_bench_launches = phase_tools_bench(gpu)

    print(json.dumps({"kernels": [{
        "name": "fused_dw_chain", "route": "cuda",
        "source": "sod100k_tpu_torch/csrc/dw_chain.cu",
        "replaces": "sod100k_tpu/ops/pallas/dw_chain.py:125",
        "launches": served_launches,
        "max_abs_err": err[torch.float32],
        "ms": tot["device"], "plain_ms": tot["plain"],
        "bound_ms": tot["bound"],
        "bound_by": ("bytes" if tot["bytes_bound"] >= tot["ops_bound"]
                     else "operations"),
        "library_ms": tot["library"], "device_ms": tot["device"],
        "ms_by": by["device"], "library_ms_by": by["library"],
        "host_us": tot["host"], "train_eval_launches": train_launches,
        "sweep_launches": sweep_launches,
        "slim_launches": slim_launches, "csf_launches": csf_launches,
        "cli_launches": cli_launches,
        "csf_cli_launches": csf_cli_launches,
        "tools_launches": tools_launches, "dp_launches": dp_launches,
        "spatial_launches": spatial_launches,
        "resident_mesh_launches": resident_mesh_launches,
        "tools_bench_launches": tools_bench_launches}, {
        "name": "resize_bilinear", "route": "cuda",
        "source": "sod100k_tpu_torch/csrc/resize_bilinear.cu",
        "replaces": None, "launches": resize["csf_b8"]["calls"],
        "ms": resize["csf_b8"]["device"],
        "plain_ms": resize["csf_b8"]["plain"],
        "bound_ms": resize["csf_b8"]["bound"], "bound_by": "bytes",
        "library_ms": resize["csf_b8"]["library"],
        "host_us": resize["csf_b8"]["host"],
        "csf_launches": csf_resize_launches,
        "per_forward": resize}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
