"""The headline number: CSNet-L-x2 224x224 inference img/s on one card,
gated on parity (the port of ``bench.py``).

    python -m sod100k_tpu_torch.tools.bench [--stem STEM] [--device cpu]

Benchmarks the sigmoid saliency maps of CSNet-L-x2 at 224^2, B=128: K=20
chained forwards (``timing.chain_ms``), best of 3. The weights are the
shipped csnet-L-x2 checkpoint when ``--stem`` names it (``STEM.bin``, the
layer config, and ``STEM.pth.tar``), else ``init_layers(40, [0.5, 0.5])``
from a seed with BN statistics calibrated on one seeded batch
(``arch.csnet.calibrate_bn``: fresh x100 weights explode or die in eval
mode with the init statistics). The row says which (``"weights"``).

The gate. It benchmarks bf16 when the bf16 map's sigmoid MAE is within
1e-3 of the reference, else f32 when the f32 map's is within 1e-5
(``tests/test_model_parity.py:52-54``), else it exits non-zero. The
reference is the golden (``tests/goldens/csnet_l_x2_224.npz``, the
reference model's logits of the shipped weights) for the shipped weights;
for seeded weights it is the f32 map of the same model with the tail's
plain version (``ops.dw_chain.fused_dw_chain_ref``) on the golden's input.
The JAX tool reads a missing golden as MAE 0 and holds seeded weights to
the shipped weights' golden; this gate compares like with like. TF32 is
off while the tool runs, so f32 is f32.

Stdout carries exactly one JSON line: ``metric``, ``value``, ``unit`` and
``vs_baseline`` as the JAX tool prints them (the baseline is the reference
pipeline's 2.9 img/s on a CPU, ``BASELINE.md``), plus the card's
``device`` and ``power_limit`` and ``weights``. Everything else goes to
stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import os
import sys

import numpy as np
import torch

from ..arch.csnet import STAGES, CSNet, calibrate_bn
from ..arch.layer_config import LayerConfig, init_layers
from ..data.pipeline import require_device
from ..ops.dw_chain import fused_dw_chain_ref, unpack_params
from ..train.step import make_eval_step
from . import timing

BASELINE_IMG_PER_SEC = 2.9
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens", "csnet_l_x2_224.npz")
WIDTH = 40
HW = 224
BATCH = 128
SCAN_LEN = 20
BARS = {"bf16": 1e-3, "f32": 1e-5}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def full_f32():
    """TF32 off for convolutions and matmuls inside the block."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def random_images(seed: int, n: int, hw: int, device) -> torch.Tensor:
    """n standard-normal NHWC images (the normalized input space)."""
    x = np.random.default_rng(seed).standard_normal((n, hw, hw, 3),
                                                    dtype=np.float32)
    return torch.from_numpy(x).to(device)


def seeded_csnet(device, *, width: int = 40, hw: int = 224,
                 seed: int = 0) -> CSNet:
    """CSNet at ``init_layers(width, [0.5, 0.5])`` from ``seed``, BN
    statistics calibrated on 4 seeded standard-normal images, in eval
    mode."""
    model = CSNet(init_layers(width, [0.5, 0.5]), seed=seed, device=device)
    calibrate_bn(model, random_images(3, 4, hw, device))
    return model


def load_model(stem: str, device) -> tuple[CSNet, str]:
    """(the eval model, "shipped" or "seeded")."""
    if stem:
        from ..cli.common import load_any_checkpoint

        model = CSNet(LayerConfig.load(stem + ".bin"), device=device)
        load_any_checkpoint(stem + ".pth.tar", model)
        return model.eval(), "shipped"
    return seeded_csnet(device, width=WIDTH, hw=HW), "seeded"


def golden_input() -> np.ndarray:
    """The golden's input (``bench.py:75-76``): 2 standard-normal images,
    NHWC, at ``HW``."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 3, HW, HW),
                               dtype=np.float32).transpose(0, 2, 3, 1)


def _tail_forward(block, tail, xset, gap=None, spatial=None):
    return tail(block, block.conv1x1(xset, gap, spatial))


def with_tail(model: CSNet, tail) -> CSNet:
    """A copy of ``model`` (in eval mode) whose ILBlocks end in
    ``tail(block, yset)`` in place of their depthwise tail; ``model`` is
    untouched."""
    twin = copy.deepcopy(model).eval()
    for name in STAGES:
        for block in getattr(twin, name):
            block.forward = functools.partial(_tail_forward, block, tail)
    return twin


def plain_tail(block, yset: list) -> list:
    """The ILBlock's fused tail through its plain version."""
    packs = block.tail_packs.get(block.conv3x3_1, block.conv3x3_2)
    return [None if p is None or y is None
            else fused_dw_chain_ref(y.contiguous(), *unpack_params(p))
            for y, p in zip(yset, packs)]


def reference_maps(model: CSNet, x: torch.Tensor, shipped: bool
                   ) -> torch.Tensor:
    """The maps the gate holds ``model`` to, (2, H, W) f32 on x's
    device: the golden's sigmoid for the shipped weights, else the f32
    map of ``model`` with the plain tail."""
    if shipped:
        logits = np.load(GOLDEN)["logits"][:, 0]
        return torch.from_numpy(1.0 / (1.0 + np.exp(-logits))).to(x.device)
    return make_eval_step(with_tail(model, plain_tail))(x)[..., 0]


def parity_mae(model: CSNet, x: torch.Tensor, want: torch.Tensor,
               dtype: torch.dtype) -> float:
    """Sigmoid-map MAE of ``model`` computing in ``dtype`` against
    ``want``."""
    got = make_eval_step(model, compute_dtype=dtype)(x)[..., 0]
    return float((got - want).abs().mean())


def run(stem: str = "", device: str | torch.device = "cuda") -> dict:
    """Gate, then time; returns the row that ``main`` prints. Raises
    ``SystemExit`` (non-zero) when neither dtype passes its bar."""
    device = require_device(device)
    with full_f32():
        model, weights = load_model(stem, device)
        x = torch.from_numpy(golden_input()).to(device)
        want = reference_maps(model, x, weights == "shipped")
        mae = {name: parity_mae(model, x, want, dt)
               for name, dt in DTYPES.items()}
        passed = [n for n in ("bf16", "f32") if mae[n] <= BARS[n]]
        if not passed:
            raise SystemExit(
                f"parity gate failed ({weights} weights): sigmoid MAE bf16 "
                f"{mae['bf16']:.3e} (bar {BARS['bf16']:g}), f32 "
                f"{mae['f32']:.3e} (bar {BARS['f32']:g})")
        name = passed[0]
        step = make_eval_step(model, compute_dtype=DTYPES[name])
        ms = timing.chain_ms(step, random_images(1, BATCH, HW, device),
                             SCAN_LEN)
    ips = BATCH / (ms * 1e-3)
    info = timing.card(device)
    _log(f"# parity MAE ({weights} weights): f32 {mae['f32']:.2e}, bf16 "
         f"{mae['bf16']:.2e}; benchmarking {name} batch {BATCH}: "
         f"{ms:.2f} ms/batch  [{info['device']}, {info['power_limit']}]")
    return {
        "metric": f"csnet_l_x2_224_inference_images_per_sec_per_chip[{name}]",
        "value": round(ips, 1),
        "unit": "images/sec",
        "vs_baseline": round(ips / BASELINE_IMG_PER_SEC, 1),
        **info, "weights": weights,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stem", default="",
                    help="the shipped checkpoint's stem (STEM.bin and "
                         "STEM.pth.tar); seeded weights without it")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.stem, args.device)), flush=True)


if __name__ == "__main__":
    main()
