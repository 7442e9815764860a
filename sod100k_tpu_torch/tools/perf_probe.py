"""Perf probes: model-component ablations, the depthwise tail against the
library, histograms, batch sweeps (the port of ``tools/perf_probe.py``).

    python -m sod100k_tpu_torch.tools.perf_probe ablate    [--device cpu]
        # CSNet-L-x2 forward: full, every depthwise tail made the identity,
        # nearest upsampling in place of bilinear
    python -m sod100k_tpu_torch.tools.perf_probe dwlayout
        # the fused tail kernel against cuDNN depthwise (NCHW and
        # channels-last) and the plain version, at one shape
    python -m sod100k_tpu_torch.tools.perf_probe scatter
        # the 256-bin histogram: scatter-add (the port's metrics) against
        # the compare-scan (the JAX package's)
    python -m sod100k_tpu_torch.tools.perf_probe trainb
        # the bf16 CSNet-L train step at B = 64, 128, 192, 256
    python -m sod100k_tpu_torch.tools.perf_probe csf [res2net101]
        # CSF+Res2Net at 336^2: batched inference, the backbone stage by
        # stage, the micro-step

Forwards are K=20 chained calls (``timing.chain_ms``), steps K=4 calls
(``timing.calls_ms``), best of 3, bf16 compute, on seeded weights (CSNet's
BN statistics calibrated on one seeded batch). The ablation variants are
copies of the model: the JAX probe patches the package's functions; here
the no-tail copy's ILBlocks end after their leading CBR, and the nearest
copy runs under a ``TorchFunctionMode`` that turns its integer-factor
bilinear resizes (the octave upsamples and the final resize, where the
factor is 2, 4 or 8: ``sod100k_tpu/ops/resample.py:189-190``) into
nearest ones.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
convolutions and matrix products only (not the fused tail, elementwise
ops, norms or resizes); bytes from shapes, each input read once and each
output written once. The shares are against the H100 SXM peaks
(``timing``), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ..arch.csf_res2net import CSFNet
from ..arch.csnet import CSNet
from ..arch.layer_config import init_layers
from ..data.pipeline import require_device
from ..ops import dw_chain, resize_kernel
from ..train.step import make_eval_step
from . import timing
from .bench import random_images, seeded_csnet, with_tail
from .bench_extras import csf_train_step, free_card, peak_gib, random_batch

B, K, R = 128, 20, 224


def _say(msg: str) -> None:
    print(msg, flush=True)


def count_flops(run) -> float:
    """FLOPs of the convolutions and matrix products that ``run()``
    dispatches (``FlopCounterMode``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return float(counter.get_total_flops())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _integer_factor(x: torch.Tensor, size, scale_factor):
    """The upsampling factor of a bilinear resize call when it is one
    integer for both axes, else None."""
    h, w = x.shape[2:]
    if scale_factor is not None:
        f = scale_factor if isinstance(scale_factor, (int, float)) \
            else scale_factor[0]
        if isinstance(scale_factor, (tuple, list)) and \
                scale_factor[0] != scale_factor[1]:
            return None
        return int(f) if float(f).is_integer() else None
    oh, ow = size
    if oh % h or ow % w or oh // h != ow // w or oh // h not in (2, 4, 8):
        return None
    return oh // h


class NearestUpsample(TorchFunctionMode):
    """Inside the mode, a bilinear resize by one integer factor (the
    port's ``resize_kernel.interpolate``, on the card and the CPU) repeats
    pixels instead (the JAX probe's ``nearest``,
    ``tools/perf_probe.py:76-79``); other calls run as they are."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is resize_kernel.interpolate:
            x = args[0]
            f = _integer_factor(x, kwargs.get("size"),
                                kwargs.get("scale_factor"))
            if f is not None:
                return x.repeat_interleave(f, dim=2).repeat_interleave(
                    f, dim=3)
        return func(*args, **kwargs)


class NearestVariant(torch.nn.Module):
    """A model whose forward runs under ``NearestUpsample``."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.inner = model

    def forward(self, *args, **kwargs):
        with NearestUpsample():
            return self.inner(*args, **kwargs)


def identity_tail(block, yset: list) -> list:
    return yset


def ablation_variants(model) -> dict:
    """{"full", "no-dw-chains", "nearest-upsample"}: the model and two
    ablated copies of it (``model`` is untouched)."""
    return {"full": model,
            "no-dw-chains": with_tail(model, identity_tail),
            "nearest-upsample": NearestVariant(copy.deepcopy(model)).eval()}


def ablate(device, *, batch: int = B, hw: int = R, width: int = 40,
           k: int = K) -> dict:
    """ms per bf16 forward of each ablation variant (the sigmoid map);
    the tail kernel's launches over the full variant's chain."""
    model = seeded_csnet(device, width=width, hw=hw)
    x0 = random_images(0, batch, hw, device)
    out = {}
    for tag, m in ablation_variants(model).items():
        before = dw_chain.launches
        out[tag] = timing.chain_ms(
            make_eval_step(m, compute_dtype=torch.bfloat16), x0, k)
        _say(f"{tag}: {out[tag]:.2f} ms/batch (B={batch}, {hw}^2, bf16; "
             f"{dw_chain.launches - before} tail kernel launches)")
    return out


def _tail_params(c: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def f(*shape, lo=0.0, scale=1.0):
        return torch.from_numpy(lo + scale * rng.standard_normal(
            shape).astype(np.float32))

    return (f(c, 3, 3, scale=0.3), f(c, lo=1.0, scale=0.1),
            f(c, scale=0.1), f(c, lo=0.25, scale=0.05),
            f(c, 3, 3, scale=0.3), f(c, lo=1.0, scale=0.1),
            f(c, scale=0.1), f(c, lo=0.25, scale=0.05))


def _library_tail(x, params):
    """The two stages in the input's dtype through cuDNN's depthwise
    convolution (f32 accumulation), ATen's elementwise ops and PReLU."""
    c = x.shape[1]
    y = x
    for o in (0, 4):
        w, s, b, a = (p.to(x.dtype) for p in params[o:o + 4])
        y = F.conv2d(y, w[:, None], padding=1, groups=c)
        y = F.prelu(y * s[:, None, None] + b[:, None, None], a)
    return y


def dwlayout(device, *, batch: int = B, c: int = 24, hw: int = R,
             dtype=torch.bfloat16, k: int = K) -> dict:
    """ms per call of the two-stage depthwise tail at (batch, c, hw, hw):
    the fused kernel B1 (NCHW), cuDNN on NCHW, cuDNN on a channels-last
    input, the plain version; and the chain's own update alone. B1's
    bound and share of it."""
    plan = dw_chain.plan_launch(batch, c, hw, hw, dtype)
    _say(f"# B1 plan at {(batch, c, hw, hw)} {dtype}: {plan}")
    params = tuple(p.to(device) for p in _tail_params(c))
    packed = dw_chain.pack_params(*params)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, c, hw, hw), dtype=np.float32)).to(device, dtype)
    xcl = x.contiguous(memory_format=torch.channels_last)
    cases = {
        "B1 fused_dw_chain NCHW": (
            lambda v: dw_chain.fused_dw_chain_packed(v, packed), x),
        "cuDNN depthwise NCHW": (lambda v: _library_tail(v, params), x),
        "cuDNN depthwise channels-last": (
            lambda v: _library_tail(v, params), xcl),
        "plain fused_dw_chain_ref": (
            lambda v: dw_chain.fused_dw_chain_ref(v, *params), x),
        "chain update alone": (lambda v: v, x),
    }
    out = {}
    for tag, (fn, v) in cases.items():
        out[tag] = timing.chain_ms(fn, v, k)
        _say(f"{tag}: {out[tag]:.4f} ms/call")
    elements = x.numel()
    bound, by = timing.bound_ms(dw_chain_flops(elements), 2 * nbytes(x),
                                timing.H100_F32_FLOPS)
    b1 = out["B1 fused_dw_chain NCHW"]
    alone = b1 - out["chain update alone"]
    _say(f"B1 bound {bound:.4f} ms ({by}): the chained call at "
         f"{bound / b1:.1%} of it, less the chain's own update "
         f"({out['chain update alone']:.4f} ms, in every row) "
         f"{alone:.4f} ms at {bound / alone:.1%}")
    out.update(bound_ms=bound, bound_by=by)
    return out


def dw_chain_flops(elements: int) -> float:
    """Two stages a element: 9 taps (multiply-add), scale and shift,
    PReLU."""
    return 2.0 * (9 + 9 + 2 + 1) * elements


def hist_scatter(sal: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """256 bins of u8-valued maps as a scatter-add (``index_add_``), the
    port's ``metrics/salmetric.py``: (B, 256)."""
    bsz = sal.shape[0]
    bins = sal.reshape(bsz, -1).long() + 256 * torch.arange(
        bsz, device=sal.device)[:, None]
    h = torch.zeros(bsz * 256, device=sal.device)
    h.index_add_(0, bins.reshape(-1), mask.reshape(-1))
    return h.reshape(bsz, 256)


def counts_scan(sal: torch.Tensor, mask: torch.Tensor,
                chunk: int = 16) -> torch.Tensor:
    """Per-threshold counts of pixels above each of 256 thresholds by
    comparison, 16 thresholds at a time (the JAX package's compare-scan):
    (B, 256)."""
    bsz = sal.shape[0]
    fs, fm = sal.reshape(bsz, -1), mask.reshape(bsz, -1)
    out = []
    for t0 in range(0, 256, chunk):
        th = torch.arange(t0, t0 + chunk, device=sal.device,
                          dtype=sal.dtype)
        gt = fs[:, :, None] > th[None, None, :]
        out.append(torch.where(gt, fm[:, :, None], 0.0).sum(dim=1))
    return torch.cat(out, dim=1)


def scatter(device, *, batch: int = 128, hw=(400, 400)) -> dict:
    """ms of each histogram on (batch, H, W) u8-valued maps."""
    rng = np.random.default_rng(0)
    sal = torch.from_numpy(rng.integers(0, 256, (batch, *hw)).astype(
        np.float32)).to(device)
    mask = torch.ones_like(sal)
    out = {}
    for tag, fn in (("scatter hist (index_add_)", hist_scatter),
                    ("compare-scan counts", counts_scan)):
        run = lambda: float(fn(sal, mask).sum())  # noqa: E731
        run()
        out[tag] = timing.best_ms(run, device)
        _say(f"{tag}: {out[tag]:.2f} ms/batch{batch}")
    return out


def trainb(device, *, batches=(64, 128, 192, 256), hw: int = R,
           width: int = 40, k: int = 4) -> dict:
    """The bf16 CSNet-L train step (Adam-dwd, penalty on) per batch
    size: ms, img/s, peak card memory."""
    from ..train.optim import make_adam_dwd
    from ..train.step import make_train_step

    out = {}
    for bb in batches:
        free_card(device)
        model = CSNet(init_layers(width, [0.5, 0.5]), seed=0, device=device)
        step = make_train_step(model, make_adam_dwd(model, weight_decay=5e-3),
                               flops_weight=3.0, flops_expand=2.0,
                               batch_size=bb, compute_dtype=torch.bfloat16)
        batch = random_batch(bb, hw, device)
        ms = timing.calls_ms(lambda: step(batch, 1e-4, 1.0), device, k)
        out[bb] = ms
        _say(f"train step bf16 B={bb}: {ms:.1f} ms = {bb / (ms * 1e-3):.0f} "
             f"img/s, peak {peak_gib(device)} GiB")
        del model, step, batch
    return out


def _report(tag: str, ms: float, n_img: int, fl: float, by: float) -> None:
    mfu = fl / (ms * 1e-3) / timing.H100_BF16_FLOPS * 100
    bwu = by / (ms * 1e-3) / timing.H100_HBM_BYTES_S * 100
    _say(f"{tag}: {ms:.2f} ms = {n_img / (ms * 1e-3):.0f} img/s | "
         f"{fl / 1e9:.0f} GF (convolutions and products) -> {mfu:.1f}% of "
         f"bf16 peak | {by / 1e9:.3f} GB in+out -> {bwu:.1f}% of HBM rate")


def csf(device, arch: str = "res2net50", *, hw: int = 336,
        batches=(1, 8, 32, 64), stage_batch: int = 32,
        step_plans=((8, False), (32, False), (8, True), (32, True)),
        k: int = K, k_step: int = 4) -> None:
    """CSF+Res2Net at ``hw``^2: the batched bf16 inference sweep, the
    backbone timed through stage k (the head alone is the full forward
    less the backbone), the bf16 micro-step with and without remat."""
    model = CSFNet(arch, seed=3, device=device)
    params = nbytes(*model.parameters())
    step = make_eval_step(model, compute_dtype=torch.bfloat16)
    for bb in batches:
        x = random_images(3, bb, hw, device)
        ms = timing.chain_ms(step, x, k)
        with torch.inference_mode():
            fl = count_flops(lambda: step(x))
        _report(f"infer bf16 B={bb}", ms, bb, fl,
                nbytes(x) + params + bb * hw * hw * 4)

    x = random_images(3, stage_batch, hw, device)

    def through(depth):
        def fn(v):
            img = v.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
            return model.base(img, depth=depth)[-1]
        return fn

    prev_ms = prev_fl = 0.0
    model.eval()
    for depth in range(1, 5):
        ms = timing.chain_ms(through(depth), x, k)
        with torch.inference_mode():
            fl = count_flops(lambda: through(depth)(x))
        share = (fl - prev_fl) / (max(ms - prev_ms, 1e-9) * 1e-3) \
            / timing.H100_BF16_FLOPS
        _say(f"backbone through stage{depth} B={stage_batch}: {ms:.2f} ms "
             f"(stage{depth} alone {ms - prev_ms:.2f} ms, "
             f"{(fl - prev_fl) / 1e9:.0f} GF, {share:.1%} of bf16 peak)")
        prev_ms, prev_fl = ms, fl
    ms_full = timing.chain_ms(step, x, k)
    _say(f"full B={stage_batch}: {ms_full:.2f} ms (CSF head and resize "
         f"alone ~{ms_full - prev_ms:.2f} ms)")
    del model, step

    for bb, remat in step_plans:
        free_card(device)
        cstep = csf_train_step(arch, bb, device, torch.bfloat16, seed=3,
                               remat=remat)
        batch = random_batch(bb, hw, device)
        ms = timing.calls_ms(lambda: cstep(batch, 5e-5), device, k_step)
        fl = count_flops(lambda: cstep(batch, 5e-5))
        trainable = [p for p in cstep.model.parameters() if p.requires_grad]
        by = (nbytes(batch["image"], batch["target"],
                     *cstep.model.parameters()) + nbytes(*trainable))
        _report(f"train micro-step bf16 B={bb} "
                f"[{'remat' if remat else 'plain'}]", ms, bb, fl, by)
        _say(f"  peak {peak_gib(device)} GiB")
        del cstep, batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=["ablate", "dwlayout", "scatter",
                                      "trainb", "csf"])
    ap.add_argument("arch", nargs="?", default="res2net50",
                    choices=["res2net50", "res2net101"],
                    help="the csf probe's backbone")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    info = timing.card(device)
    _say(f"# {args.probe} on {info['device']} ({info['power_limit']})")
    if args.probe == "csf":
        csf(device, args.arch)
    else:
        {"ablate": ablate, "dwlayout": dwlayout, "scatter": scatter,
         "trainb": trainb}[args.probe](device)


if __name__ == "__main__":
    main()
