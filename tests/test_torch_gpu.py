"""The CUDA kernel on the card: fused_dw_chain against its plain version;
the CSNet and CSF+Res2Net train steps and forwards on the card against the
CPU.

Needs an NVIDIA GPU with nvcc; skips elsewhere. Imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

f32: atol 2e-5, the JAX package's bar for the Pallas kernel. bf16: within
one bf16 ulp (rtol 2^-7, atol 1e-3) of a value the plain function may give:
the kernel and cuDNN sum the taps in different orders, so a bf16
intermediate at a rounding tie may round either way
(``dw_chain.fused_dw_chain_ref_range``).
"""

import numpy as np
import pytest
import torch

from sod100k_tpu_torch.arch.csf_res2net import CSFNet
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.ops import dw_chain
from sod100k_tpu_torch.prune import build_pruned_csnet, prune
from sod100k_tpu_torch.train.csf_step import (freeze_reference_params,
                                              make_csf_optimizer,
                                              make_csf_train_step)
from sod100k_tpu_torch.train.optim import make_sgd
from sod100k_tpu_torch.train.step import make_eval_step, make_train_step

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=0, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    n, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    def stage():
        return (torch.from_numpy(rng.standard_normal((c, 3, 3), dtype=np.float32) * 0.1),
                torch.from_numpy(rng.random(c).astype(np.float32) + 0.5),
                torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
                torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.25))

    params = [p.to(device) for p in (*stage(), *stage())]
    return x.to(device=device, dtype=dtype), params


# (H, W, C) of the 33 calls of a CSNet-L forward at 224^2, taken at N=32
MAIN = [(224, 224, 20), (112, 112, 20), (112, 112, 40), (56, 56, 40),
        (112, 112, 80), (56, 56, 80), (28, 28, 80), (14, 14, 80),
        (56, 56, 160), (28, 28, 160)]


def _check(got, x, params, dtype):
    """Within the bar of a value the plain function may give (a bf16
    intermediate at a rounding tie may round either way)."""
    assert got.dtype == dtype and got.shape == x.shape
    dw_chain.check_against_plain(got, x, params, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 13, 40, 36), (1, 5, 17, 23), (2, 24, 64, 64), (2, 20, 224, 224),
    (2, 160, 28, 28),
    (3, 9, 14, 14),     # odd plane count at 14^2: bulk group + short tail
    (2, 3, 101, 224),   # H not a multiple of the band rows
    (1, 1, 224, 224),   # the band path with a single plane
    (2, 3, 170, 102),    # rows not 16-byte aligned: element-wise staging
    *[(32, c, h, w) for h, w, c in MAIN],  # the main path's plans
    (256, 80, 28, 28),  # a one-slot plan with more items than blocks
])
def test_kernel_matches_plain(cuda, shape, dtype):
    x, params = _inputs(shape, dtype, cuda)
    before = dw_chain.launches
    got = dw_chain.fused_dw_chain(x, *params)
    torch.cuda.synchronize()
    assert dw_chain.launches == before + 1
    _check(got, x, params, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sizes,sms", [
    ((2, 3, 224, 224), {}, 4),                    # two-slot bands
    ((2, 3, 224, 224), {"BAND_SLOTS": 1}, 4),     # one-slot bands
    ((2, 3, 224, 224), {"rows": 1}, 8),
    ((2, 3, 224, 224), {"rows": 100}, 2),         # a short last band
    ((2, 3, 224, 224), {"BAND_THREADS": 32}, 4),
    ((8, 20, 28, 28), {}, 4),                     # one-slot planes
    ((8, 20, 28, 28), {"PLANE_SLOTS": 2}, 4),     # two-slot planes
    ((3, 9, 14, 14), {"PLANE_SLOTS": 2}, 1),      # ... and a short group
])
def test_kernel_plan_sizes_match_plain(cuda, shape, sizes, sms, dtype,
                                       monkeypatch):
    """Plans other than the device's, on a grid of ``sms`` one-block SMs:
    each block walks several items, reusing its ring slots."""
    n, c, h, w = shape
    sizes = dict(sizes)
    if "rows" in sizes:
        elt = torch.finfo(dtype).bits // 8
        sizes.update(PLANE_BYTES=0,
                     BAND_BYTES=(sizes.pop("rows") + 4) * w * elt)
    for k, v in sizes.items():
        monkeypatch.setattr(dw_chain, k, v)
    plan = dw_chain.plan_launch(*shape, dtype, sm_count=sms, blocks_per_sm=1)
    assert plan.grid == sms and plan.items >= 2 * plan.grid
    x, params = _inputs(shape, dtype, cuda)
    got = dw_chain.launch(x, dw_chain.pack_params(*params), plan)
    torch.cuda.synchronize()
    _check(got, x, params, dtype)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, params = _inputs((1, 4, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dw_chain.fused_dw_chain(x.transpose(2, 3), *params)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dw_chain.fused_dw_chain(x.half(), *params)
    with pytest.raises(ValueError, match="parameter 1"):
        dw_chain.fused_dw_chain(x, params[0], params[1].cpu(), *params[2:])


def test_packed_path_and_refusals(cuda):
    x, params = _inputs((2, 6, 56, 56), torch.float32, cuda)
    packed = dw_chain.pack_params(*params)
    got = dw_chain.fused_dw_chain_packed(x, packed)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, dw_chain.fused_dw_chain_ref(x, *params),
                               **TOL[torch.float32])
    with pytest.raises(ValueError, match="pack"):
        dw_chain.fused_dw_chain_packed(x, packed.cpu())
    with pytest.raises(ValueError, match="pack"):
        dw_chain.fused_dw_chain_packed(x, packed[:, :12].contiguous())


# ---------------------------------------------------------------------------
# Training on the card

LC = init_layers(8, (0.5, 0.5))


def _train_batch(n=4, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, hw, hw, 3), np.uint8),
            "target": (rng.random((n, hw, hw, 1)) > 0.5).astype(np.uint8)
            * 255}


def _l2(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def test_train_step_matches_cpu(cuda):
    """One f32 step with the penalty, card against CPU: loss and penalty
    within rel 1e-4, every gradient within L2-rel 2e-3 (a floor of 1e-6 of
    the global norm, as tests/test_trajectory.py's ``_tensors_close``, and
    the same bar globally), BN running statistics within L2-rel 1e-4."""
    models, out = {}, {}
    for dev in ("cpu", "cuda"):
        model = CSNet(LC, seed=3, device=dev)
        # lr 0, no momentum: the step leaves the weights and keeps the grads
        step = make_train_step(model, make_sgd(model, momentum=0.0),
                               flops_weight=3.0, batch_size=4, from_u8=True)
        out[dev] = {k: float(v) for k, v in
                    step(_train_batch(), 0.0, 1.0).items()}
        models[dev] = model
    for k in ("loss", "penalty"):
        assert out["cuda"][k] == pytest.approx(out["cpu"][k], rel=1e-4), k
    want = dict(models["cpu"].named_parameters())
    got = dict(models["cuda"].named_parameters())
    gnorm = sum(_l2(p.grad) ** 2 for p in want.values()) ** 0.5
    total = 0.0
    for name, p in want.items():
        err = _l2(got[name].grad.cpu() - p.grad)
        total += err ** 2
        assert err / max(_l2(p.grad), 1e-6 * gnorm) < 2e-3, name
    assert total ** 0.5 / gnorm < 2e-3
    cuda_buffers = dict(models["cuda"].named_buffers())
    for name, b in models["cpu"].named_buffers():
        if "running" in name:
            err = _l2(cuda_buffers[name].cpu() - b) / _l2(b)
            assert err < 1e-4, name


@pytest.mark.parametrize("foreach", [True, False])
def test_eval_after_adam_steps_equals_a_fresh_load(cuda, foreach):
    """Eval (packs built), Adam steps on the card (the multi-tensor
    ``foreach`` path that torch takes on CUDA by default, and the
    single-tensor one), eval again: equal to a fresh model loaded with the
    same state_dict (max |d| <= 1e-5), not to stale packs."""
    model = CSNet(LC, seed=4, device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3), dtype=np.float32)).cuda()
    calibrate_bn(model, x)
    evaluate = make_eval_step(model)
    before = evaluate(x).clone()
    opt = torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.99),
                           foreach=foreach)
    step = make_train_step(model, opt, flops_weight=3.0, batch_size=4,
                           from_u8=True)
    for seed in range(3):
        step(_train_batch(seed=10 + seed), 1e-3, 1.0)
    got = evaluate(x)
    fresh = CSNet(LC, device=cuda)
    fresh.load_state_dict(model.state_dict(), strict=True)
    want = make_eval_step(fresh)(x)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5
    assert (got - before).abs().max().item() > 1e-4  # the steps moved it


@pytest.mark.parametrize("hw", [(64, 64), (37, 45)])
def test_csf_forward_matches_cpu(cuda, hw):
    """CSF+Res2Net-50 in f32 (TF32 off), the seeded reference init, card
    against CPU: max |dlogit| < 1e-4 * max(1, max|logit|), sigmoid mean
    |d| < 1e-5; 37x45 resizes between branch shapes at non-integer ratios
    and pools in ceil mode."""
    model = CSFNet("res2net50", seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, *hw, 3), dtype=np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert torch.isfinite(got).all() and got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() < 1e-4 * scale
    assert (torch.sigmoid(got) - torch.sigmoid(want)).abs().mean() < 1e-5


def test_csf_micro_step_matches_cpu(cuda):
    """One masked f32 micro-step of 2 (the gradients wait), card against
    CPU: loss within rel 1e-4, gradients within L2-rel 2e-3 globally and
    per tensor (floor 1e-6 of the global norm); nothing moved."""
    rng = np.random.default_rng(3)
    batch = _train_batch(n=2, hw=64, seed=3)
    batch["mask"] = (rng.random((2, 64, 64, 1)) > 0.2).astype(np.float32)
    models, loss = {}, {}
    for dev in ("cpu", "cuda"):
        model = CSFNet("res2net50", seed=1, device=dev)
        freeze_reference_params(model)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_csf_train_step(model, make_csf_optimizer(model),
                                   iter_size=2, batch_size=2, from_u8=True)
        loss[dev] = step(batch, 5e-5)["loss"].item()
        assert all(torch.equal(v, before[k])
                   for k, v in model.state_dict().items())
        models[dev] = model
    assert loss["cuda"] == pytest.approx(loss["cpu"], rel=1e-4)
    want = {n: p.grad for n, p in models["cpu"].named_parameters()
            if p.requires_grad}
    got = dict(models["cuda"].named_parameters())
    gnorm = sum(_l2(g) ** 2 for g in want.values()) ** 0.5
    total = 0.0
    for name, g in want.items():
        err = _l2(got[name].grad.cpu() - g)
        total += err ** 2
        assert err / max(_l2(g), 1e-6 * gnorm) < 2e-3, name
    assert total ** 0.5 / gnorm < 2e-3


def _pruned_tail_shapes(n=2, hw=32):
    """(N, C, H, W) of every live tail branch of a slim model: the JAX
    package's prune-test recipe (gammas uniform in [0, 1], one channel per
    branch kept) at threshold 0.3, with stage2.1's branch 1 emptied."""
    model = CSNet(LC, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                g = torch.from_numpy(rng.uniform(0, 1, m.num_features)
                                     .astype(np.float32))
                g[int(rng.integers(m.num_features))] = 0.9
                if name == "stage2.1.conv1x1.bns.1":
                    g[:] = 0.0
                m.weight.copy_(g)
    sd, lc, _ = prune(model.state_dict(), LC, 0.3)
    slim = build_pruned_csnet(lc, sd, device="cpu")
    shapes = []
    for block in (b for s in ("stage0", "stage1", "stage2", "stage3",
                              "stage4") for b in getattr(slim, s)):
        block.conv1x1.register_forward_hook(
            lambda m, i, out: shapes.extend(
                tuple(y.shape) for y in out if y is not None))
    slim.eval()
    with torch.no_grad():
        slim(torch.zeros(n, hw, hw, 3))
    return shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 32, 256])
def test_kernel_matches_plain_at_pruned_tail_shapes(cuda, dtype, n):
    """The plan picks planes per item from N*C: at N=256 the ragged widths
    give items of several planes with a short last group."""
    shapes = _pruned_tail_shapes(n=n)
    assert len(shapes) == 32  # 33 live branches, one emptied by pruning
    assert len({s[1] for s in shapes}) > 4  # ragged channel counts
    short = 0
    for seed, shape in enumerate(shapes):
        plan = dw_chain.device_plan(*shape, dtype, cuda.index or 0)
        short += plan.planes > 1 and shape[0] * shape[1] % plan.planes != 0
        x, params = _inputs(shape, dtype, cuda, seed=seed)
        got = dw_chain.fused_dw_chain(x, *params)
        torch.cuda.synchronize()
        _check(got, x, params, dtype)
    assert n < 256 or short > 0


# ---------------------------------------------------------------------------
# The dataset path on the card: metrics, front-end, resident sweep, prefetch


def _metric_batch(seed=0, canvas=(96, 112)):
    """A padded batch: blob GTs at ragged sizes, an all-background and an
    all-foreground GT, an all-masked row; sal in [0, 255] integral."""
    rng = np.random.default_rng(seed)
    hw = np.asarray([(48, 96), (80, 80), (96, 112), (55, 48), (50, 60),
                     (40, 70), (0, 0)], np.int32)
    n = len(hw)
    sal = np.zeros((n, *canvas), np.float32)
    gt = np.zeros((n, *canvas), np.uint8)
    mask = np.zeros((n, *canvas), np.float32)
    yy, xx = np.mgrid[0:canvas[0], 0:canvas[1]]
    for i, (h, w) in enumerate(hw):
        blob = (yy - 30) ** 2 + (xx - 35) ** 2 < int(rng.integers(8, 25)) ** 2
        g = blob * 255
        if i == 4:
            g[:] = 0
        elif i == 5:
            g[:] = 255
        gt[i, :h, :w] = g[:h, :w]
        sal[i, :h, :w] = np.trunc(np.clip(
            g[:h, :w] * 0.7 + rng.normal(40, 50, (h, w)), 0, 255))
        mask[i, :h, :w] = 1.0
    return sal, gt, mask, hw


def _metric_outputs(sal, gt, mask, tables, device):
    from sod100k_tpu_torch.metrics import salmetric, smeasure, wfmeasure

    t = {k: torch.from_numpy(v).to(device) for k, v in
         dict(sal=sal, gt=gt, mask=mask, **tables).items()}
    gtf = t["gt"].float()
    out = dict(zip(("a", "tp", "b", "n"), salmetric.threshold_counts(
        t["sal"], gtf, t["mask"])))
    out.update(zip(("mae", "p", "r", "e"), salmetric.per_image_stats(
        t["sal"], gtf, t["mask"])))
    out["af"] = salmetric.adaptive_f_per_image(t["sal"], gtf, t["mask"])
    out["ae"] = salmetric.adaptive_e_per_image(t["sal"], gtf, t["mask"])
    out["s"] = smeasure.s_measure_batch(t["sal"] / 255.0,
                                        (gtf > 128).float(), t["mask"])
    out["wf"] = wfmeasure.wf_per_image_device(
        t["sal"] / 255.0, t["gt"], t["mask"], t["wf_idx"], t["wf_weight"])
    return {k: v.cpu() for k, v in out.items()}


def test_metrics_on_the_card_match_the_cpu(cuda):
    """Counts bit-equal (exact f32 integers, atomics in any order); the rest
    within 1e-6 (MAE/P/R/E, adaptive F/E) or 1e-5 (S, weighted F)."""
    from sod100k_tpu_torch.metrics.wfmeasure import precompute_wf_tables

    sal, gt, mask, hw = _metric_batch()
    tables = precompute_wf_tables(gt, hw)
    cpu = _metric_outputs(sal, gt, mask, tables, "cpu")
    card = _metric_outputs(sal, gt, mask, tables, cuda)
    for k in ("a", "tp", "b", "n"):
        assert torch.equal(card[k], cpu[k]), k
    for k, v in cpu.items():
        atol = 1e-5 if k in ("s", "wf") else 1e-6
        torch.testing.assert_close(card[k], v, rtol=0, atol=atol,
                                   equal_nan=True, msg=k)


def test_front_end_on_the_card_matches_the_cpu(cuda):
    from sod100k_tpu_torch.data import device_pipeline as dp
    from sod100k_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD

    rng = np.random.default_rng(1)
    hw = torch.tensor([(50, 61), (64, 64), (40, 45)])
    img = torch.from_numpy(rng.integers(0, 256, (3, 64, 64, 3), np.uint8))
    gt = torch.from_numpy(rng.integers(0, 256, (3, 64, 64), np.uint8))
    draws = dp.draw_augment_params(torch.Generator().manual_seed(2), 3, 15)
    draws["do_flip"][:] = torch.tensor([True, True, False])
    draws["flip_lr"][:] = torch.tensor([True, False, True])
    for dev in ("cpu", cuda):
        out = dp.preprocess_train_batch(img.to(dev), gt.to(dev), hw.to(dev),
                                        draws=draws, out_hw=(32, 40))
        inf = dp.preprocess_infer_batch(img.to(dev), hw.to(dev),
                                        out_hw=(48, 48))
        up = dp.resize_to_native_canvas(img[..., 0].float().to(dev) / 255,
                                        hw.to(dev), (96, 128))
        if dev == "cpu":
            want = (out, inf, up)
    # images on the [0, 1] scale: the card contracts the coordinate and
    # lerp arithmetic into FMAs, and the ImageNet std (x1/0.225) would
    # amplify those roundings
    mean, std = (torch.from_numpy(v) for v in (IMAGENET_MEAN, IMAGENET_STD))
    pairs = [(out["image"] * std.to(cuda) + mean.to(cuda),
              want[0]["image"] * std + mean),
             (out["target"], want[0]["target"]),
             (inf * std.to(cuda) + mean.to(cuda), want[1] * std + mean),
             (up, want[2])]
    for g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    d = dp.draw_augment_params(gen, 64, 15)
    assert all(v.device.type == "cuda" for v in d.values())
    assert d["r2"].min() >= 1 and d["r1"].max() <= 14


def test_resident_sweep_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One TESTALL sweep and one val MAE, small model in f32, the card (the
    kernel) against the CPU (plain path). The forwards agree within 1e-4;
    the stages after them (resize back, quantization, every metric) are
    held at the sweep's bars on the same maps: on a fresh small model a
    quantization level that flips between the two forwards moves a curve
    point of a 10-image split by up to ~4e-4."""
    from sod100k_tpu_torch.data import resident
    from sod100k_tpu_torch.data.pipeline import SalData
    from sod100k_tpu_torch.data.synth import make_synth_split
    from sod100k_tpu_torch.metrics.salmetric import result_from_sums

    split = make_synth_split(str(tmp_path / "split"), 10, hw=(60, 80))
    ds = SalData(split, (64, 64), mode="val")
    model = CSNet(LC, seed=6, device="cpu")
    calibrate_bn(model, torch.from_numpy(np.random.default_rng(3)
                                         .standard_normal((4, 64, 64, 3),
                                                          dtype=np.float32)))
    card_model = CSNet(LC, device=cuda)
    card_model.load_state_dict(model.state_dict())
    data = {dev: resident.build_resident_val_dataset(
        ds, (64, 64), 4, device=dev, with_wf_tables=True)
        for dev in ("cpu", cuda)}
    canvas = data["cpu"].pop("_canvas_hw")
    data[cuda].pop("_canvas_hw")
    es = {"cpu": make_eval_step(model, from_u8=True),
          cuda: make_eval_step(card_model, from_u8=True)}
    maps = {dev: torch.cat([es[dev](data[dev]["image_u8"][b:b + 4])
                            for b in range(0, 12, 4)]) for dev in es}
    assert (maps[cuda].cpu() - maps["cpu"]).abs().max().item() < 1e-4

    before = dw_chain.launches
    es[cuda](data[cuda]["image_u8"][:4])
    per = dw_chain.launches - before
    card_sums = resident.make_resident_salmetric_fn(
        es[cuda], batch_size=4, canvas_hw=canvas)(data[cuda])
    assert per > 0 and dw_chain.launches - before == 4 * per  # 3 batches
    card = result_from_sums(card_sums)
    card_maps = iter(maps[cuda].cpu().split(4))
    cpu = result_from_sums(resident.make_resident_salmetric_fn(
        lambda img: next(card_maps), batch_size=4,
        canvas_hw=canvas)(data["cpu"]))
    cpu_own = result_from_sums(resident.make_resident_salmetric_fn(
        es["cpu"], batch_size=4, canvas_hw=canvas)(data["cpu"]))
    for want, curve in ((cpu, 2e-4), (cpu_own, None)):
        for k in ("mae", "max_f", "adaptive_f", "adaptive_e", "s_measure"):
            assert card[k] == pytest.approx(want[k], abs=1e-4), k
        assert card["weighted_f"] == pytest.approx(want["weighted_f"],
                                                   abs=5e-4)
        if curve:
            for k in ("precision", "recall", "emeasure"):
                np.testing.assert_allclose(card[k], want[k], rtol=0,
                                           atol=curve)
    mae = {dev: resident.make_resident_val_fn(
        es[dev], batch_size=4, canvas_hw=canvas)(data[dev]).item()
        for dev in es}
    assert mae[cuda] == pytest.approx(mae["cpu"], abs=1e-4)


def test_device_prefetch_on_a_side_stream(cuda):
    from sod100k_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(4)
    want = [{"image_u8": rng.integers(0, 256, (8, 64, 64, 3), np.uint8),
             "hw": rng.integers(1, 64, (8, 2)).astype(np.int32),
             "name": f"b{i}"} for i in range(5)]
    got = list(device_prefetch(iter(want), device=cuda))
    assert [g["name"] for g in got] == [w["name"] for w in want]
    for g, w in zip(got, want):
        assert g["image_u8"].device.type == "cuda"
        np.testing.assert_array_equal(g["image_u8"].cpu().numpy(),
                                      w["image_u8"])
        np.testing.assert_array_equal(g["hw"].cpu().numpy(), w["hw"])


def test_smoke_driver_on_the_card(cuda, tmp_path):
    """``python -m sod100k_tpu_torch.cli.smoke --dry-data``: train ->
    prune+finetune -> test -> eval -> resident sweep on a synthetic tree,
    on the card, as a user runs it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "sod100k_tpu_torch.cli.smoke", "--dry-data",
         "--save-dir", str(tmp_path / "save"), "--train-epochs", "1"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": repo,
             "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "[smoke] OK" in out.stdout


def band_worker() -> None:
    """One rank of ``test_band_tail_on_two_ranks``: its band of every main
    tail shape at N=2 through ``fused_dw_chain_band`` (the kernel on band +
    halo), the bands gathered and held against the plain version of the
    whole map; exits non-zero on a miss."""
    from sod100k_tpu_torch.parallel import mesh, multihost, spatial

    assert multihost.init_from_env(lambda *_: None, backend="gloo")
    torch.backends.cudnn.allow_tf32 = False
    sp = spatial.SpatialCtx(mesh.make_mesh_2d(1, 2), 0)
    dw_chain.spatial_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        for h, w, c in MAIN:
            x, params = _inputs((2, c, h, w), dtype, "cuda", seed=h + c)
            band = sp.shard(x).contiguous()
            spatial.tag(band, h)
            y = dw_chain.fused_dw_chain_band(
                band, dw_chain.pack_params(*params), sp)
            a, b = sp.band(h)
            assert y.shape == (2, c, b - a, w)
            _check(spatial.gather_bands(y, sp), x, params, dtype)
    torch.cuda.synchronize()
    assert dw_chain.spatial_launches == 2 * len(MAIN), \
        dw_chain.spatial_launches


def test_band_tail_on_two_ranks(cuda, tmp_path):
    """Two ranks share the card over gloo (CUDA tensors), a 1 x 2 mesh:
    each runs the kernel on its band plus a 2-row halo of every main tail
    shape at N=2; the gathered bands equal the plain version of the whole
    map at the kernel's bars, and every band call launched the kernel."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "band"], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": repo, "TMPDIR": str(tmp_path),
             "SOD100K_COORDINATOR": f"127.0.0.1:{port}",
             "SOD100K_NUM_PROCESSES": "2", "SOD100K_PROCESS_ID": str(r)})
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["band"]:
        band_worker()
