"""``tools.perf_probe`` on the CPU: the ablation variants against the JAX
probe's patched forwards on the same weights, the FLOP count against a
hand count, and each probe run small.

The JAX probe ablates by patching the package's functions
(``tools/perf_probe.py:66-70`` makes ``simplified_goct_cbr`` the identity,
``:72-86`` puts nearest in place of ``upsample_bilinear``); the port's
variants are copies of the model. Both run CSNet at width 8, 32^2, f32,
with the port's calibrated state handed to JAX through
``state_dict_to_pytree``; the bar is max |dlogit| < 1e-3
(``tests/test_model_parity.py:52``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sod100k_tpu.arch.csnet as jcsnet
import sod100k_tpu.ops.goct as jgoct
import sod100k_tpu.ops.resample as jresample
from sod100k_tpu.arch.csnet import csnet_apply
from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
from sod100k_tpu.ops.goct import ApplyCtx
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.ops import resize_kernel
from sod100k_tpu_torch.tools import perf_probe

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def calibrated():
    model = CSNet(init_layers(8, (0.5, 0.5)), seed=1, device="cpu")
    rng = np.random.default_rng(0)
    batch = rng.standard_normal((4, 32, 32, 3), dtype=np.float32)
    calibrate_bn(model, torch.from_numpy(batch))
    return model, batch[:2]


def _jax_nearest(x, f):
    """tools/perf_probe.py:76-79."""
    if f == 1:
        return x
    return jnp.repeat(jnp.repeat(x, f, axis=1), f, axis=2)


def _jax_no_dw(ctx, path, prm, xset, *, split, padding=1):
    """tools/perf_probe.py:67."""
    return xset


PATCHES = {
    "full": [],
    "no-dw-chains": [(jgoct, "simplified_goct_cbr", _jax_no_dw),
                     (jcsnet, "simplified_goct_cbr", _jax_no_dw)],
    "nearest-upsample": [(jresample, "upsample_bilinear", _jax_nearest),
                         (jgoct, "upsample_bilinear", _jax_nearest)],
}


@pytest.mark.parametrize("variant", list(PATCHES))
def test_ablation_variant_is_the_jax_probes(variant, calibrated,
                                            monkeypatch):
    model, x = calibrated
    variants = perf_probe.ablation_variants(model)
    with torch.no_grad():
        got = variants[variant](torch.from_numpy(x)).numpy()
        full = model(torch.from_numpy(x)).numpy()
    params = state_dict_to_pytree(model.state_dict())
    for mod, name, fn in PATCHES[variant]:
        monkeypatch.setattr(mod, name, fn)
    want = np.asarray(jax.jit(lambda p, v: csnet_apply(
        p, v, model.lc, ApplyCtx()))(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-3
    if variant != "full":  # the variant is another function of the input
        assert np.abs(got - full).max() > 1e-2
    # the model itself is untouched by building its variants
    with torch.no_grad():
        np.testing.assert_array_equal(model(torch.from_numpy(x)).numpy(),
                                      full)


def test_nearest_mode_leaves_other_resizes_alone():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    F = torch.nn.functional
    resize = resize_kernel.interpolate
    with perf_probe.NearestUpsample():
        up2 = resize(x, scale_factor=2)
        to8 = resize(x, size=(16, 20))
        odd = resize(x, size=(7, 9))
        three = resize(x, size=(12, 15))
    rep = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
    assert torch.equal(up2, rep)
    assert torch.equal(to8, x.repeat_interleave(4, 2).repeat_interleave(4, 3))
    assert torch.equal(odd, F.interpolate(x, size=(7, 9), mode="bilinear",
                                          align_corners=False))
    # x3 is not one of the JAX resize's integer paths (2, 4, 8)
    assert torch.equal(three, F.interpolate(
        x, size=(12, 15), mode="bilinear", align_corners=False))


def test_flop_count_is_the_hand_count_of_two_convs():
    n, cin, c1, c2, h, w = 2, 3, 8, 4, 16, 12
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, cin, h, w, generator=gen)
    w1 = torch.randn(c1, cin, 3, 3, generator=gen)
    w2 = torch.randn(c2, c1, 1, 1, generator=gen)
    F = torch.nn.functional

    def stack():
        y = F.conv2d(x, w1, padding=1, stride=2)
        return F.conv2d(y, w2)

    ho, wo = h // 2, w // 2
    # a multiply-add is two operations
    want = 2 * n * ho * wo * (c1 * cin * 9 + c2 * c1 * 1)
    assert perf_probe.count_flops(stack) == want


def test_the_probes_run_small():
    out = perf_probe.ablate(CPU, batch=2, hw=32, width=8, k=1)
    assert list(out) == ["full", "no-dw-chains", "nearest-upsample"]
    dw = perf_probe.dwlayout(CPU, batch=2, c=4, hw=16, k=1)
    assert dw["bound_by"] == "bytes"
    assert dw["bound_ms"] == pytest.approx(
        2 * 2 * 4 * 16 * 16 * 2 / 3.35e12 * 1e3)
    sc = perf_probe.scatter(CPU, batch=2, hw=(8, 8))
    assert len(sc) == 2
    assert list(perf_probe.trainb(CPU, batches=(2,), hw=32, width=8,
                                  k=1)) == [2]
    perf_probe.csf(CPU, "res2net50", hw=32, batches=(1,), stage_batch=1,
                   step_plans=((1, True),), k=1, k_step=1)


def test_histograms_agree():
    """The scatter-add histogram and the compare-scan count the same
    pixels: the count above threshold t is the histogram's tail sum."""
    rng = np.random.default_rng(0)
    sal = torch.from_numpy(rng.integers(0, 256, (2, 6, 7)).astype(
        np.float32))
    mask = torch.from_numpy(rng.random((2, 6, 7)).astype(np.float32))
    hist = perf_probe.hist_scatter(sal, mask)
    counts = perf_probe.counts_scan(sal, mask)
    tail = hist.flip(1).cumsum(1).flip(1)  # sum over bins >= t
    # pixels strictly above t: bins t+1 .. 255
    above = torch.cat([tail[:, 1:], torch.zeros(2, 1)], dim=1)
    torch.testing.assert_close(counts, above, rtol=1e-6, atol=1e-5)
