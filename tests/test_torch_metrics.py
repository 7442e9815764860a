"""Port parity, the metric suite: sod100k_tpu_torch.metrics against the JAX
package's metrics, on the CPU.

Inputs come from seeded numpy: padded batches (masks with ragged valid
extents), integral and non-integral saliency (the floor binning), and
degenerate GTs (all background, all foreground) plus an all-masked row.
Bars: threshold counts exact (equal to an integer numpy count, as the JAX
package's are by construction); MAE/P/R/E within 1e-6; S-measure within
1e-5; weighted F within 1e-5 of the JAX device function and 5e-4 of the
host one; tables and report text equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.metrics import salmetric as jsal
from sod100k_tpu.metrics import smeasure as jsm
from sod100k_tpu.metrics import wfmeasure as jwf
from sod100k_tpu_torch.metrics import salmetric, smeasure, wfmeasure


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZES = [(48, 96), (80, 80), (55, 48), (64, 72), (80, 60), (70, 90)]
CANVAS = (80, 96)


def _batch(seed: int = 0, integral: bool = True):
    """A padded batch of 8 on one canvas: blobby GTs at SIZES, then an
    all-background GT, an all-foreground GT and an all-masked row; sal
    correlated with the GT. Returns numpy sal, gt (both [0, 255] f32),
    mask, hw."""
    rng = np.random.default_rng(seed)
    n = len(SIZES) + 3
    hw = np.asarray(SIZES + [(50, 60), (40, 70), (0, 0)], np.int32)
    sal = np.zeros((n, *CANVAS), np.float32)
    gt = np.zeros((n, *CANVAS), np.float32)
    mask = np.zeros((n, *CANVAS), np.float32)
    yy, xx = np.mgrid[0:CANVAS[0], 0:CANVAS[1]]
    for i, (h, w) in enumerate(hw):
        cy, cx = rng.integers(10, 40, 2)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < int(rng.integers(8, 20)) ** 2
        g = blob * 255.0
        if i == len(SIZES):
            g[:] = 0.0
        elif i == len(SIZES) + 1:
            g[:] = 255.0
        s = np.clip(g * 0.7 + rng.normal(40, 50, CANVAS), 0, 255)
        s = np.trunc(s) if integral else s
        gt[i, :h, :w] = g[:h, :w]
        sal[i, :h, :w] = s[:h, :w]
        mask[i, :h, :w] = 1.0
    return sal, gt, mask, hw


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("integral", [True, False])
def test_per_image_stats_matches_jax(integral):
    sal, gt, mask, _ = _batch(1, integral)
    sal, gt, mask = sal[:-1], gt[:-1], mask[:-1]  # MAE divides by npix
    a, tp, b, n = salmetric.threshold_counts(_t(sal), _t(gt), _t(mask))
    fl = np.floor(np.clip(sal, 0, 255))
    pos = (gt > 128) & (mask > 0)
    for i in range(sal.shape[0]):
        v = mask[i] > 0
        want_a = [(fl[i][v] > th).sum() for th in range(256)]
        want_tp = [(fl[i][pos[i]] > th).sum() for th in range(256)]
        np.testing.assert_array_equal(a[i].numpy(), want_a)
        np.testing.assert_array_equal(tp[i].numpy(), want_tp)
        assert b[i].item() == pos[i].sum() and n[i].item() == v.sum()
    got = salmetric.per_image_stats(_t(sal), _t(gt), _t(mask))
    want = jsal._per_image_stats(jnp.asarray(sal), jnp.asarray(gt),
                                 jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_adaptive_f_and_e_match_jax():
    sal, gt, mask, _ = _batch(2)
    args = [jnp.asarray(v) for v in (sal, gt, mask)]
    targs = [_t(v) for v in (sal, gt, mask)]
    for port, ref in ((salmetric.adaptive_f_per_image,
                       jsal.adaptive_f_per_image),
                      (salmetric.adaptive_e_per_image,
                       jsal.adaptive_e_per_image)):
        got, want = port(*targs).numpy(), np.asarray(ref(*args))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert got[-1] == 0.0  # the all-masked row
    assert np.isfinite(salmetric.adaptive_e_per_image(*targs).numpy()).all()


def test_s_measure_batch_matches_jax():
    sal, gt, mask, _ = _batch(3)
    s01, g01 = sal / 255.0, (gt > 128).astype(np.float32)
    got = smeasure.s_measure_batch(_t(s01), _t(g01), _t(mask)).numpy()
    want = np.asarray(jsm.s_measure_batch(jnp.asarray(s01), jnp.asarray(g01),
                                          jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # unmasked single maps, through both entry points
    one = smeasure.s_measure(_t(s01[0]), _t(g01[0])).item()
    assert one == pytest.approx(float(jsm.s_measure(
        jnp.asarray(s01[0]), jnp.asarray(g01[0]))), abs=1e-5)


def test_wf_tables_equal_jax():
    sal, gt, mask, hw = _batch(4)
    gt_u8 = gt.astype(np.uint8)
    got = wfmeasure.precompute_wf_tables(gt_u8, hw)
    want = jwf.precompute_wf_tables(gt_u8, hw)
    for k in ("wf_idx", "wf_weight"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_wf_per_image_device_matches_jax_and_host():
    sal, gt, mask, hw = _batch(5)
    gt_u8 = gt.astype(np.uint8)
    tables = wfmeasure.precompute_wf_tables(gt_u8, hw)
    s01 = sal / 255.0
    got = wfmeasure.wf_per_image_device(
        _t(s01), _t(gt_u8), _t(mask), _t(tables["wf_idx"]),
        _t(tables["wf_weight"])).numpy()
    want = np.asarray(jax.jit(jwf.wf_per_image_device)(
        jnp.asarray(s01), jnp.asarray(gt_u8), jnp.asarray(mask),
        jnp.asarray(tables["wf_idx"]), jnp.asarray(tables["wf_weight"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    host = wfmeasure.weighted_f_measure_batch(s01, gt_u8 > 128, hw)
    np.testing.assert_allclose(got, host, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(
        host, jwf.weighted_f_measure_batch(s01, gt_u8 > 128, hw))
    assert got[len(SIZES)] == 0.0 and got[-1] == 0.0  # no foreground


def test_gaussian_is_the_7x7_kernel():
    """The two 1-D passes equal the JAX package's 7x7 convolution."""
    x = np.random.default_rng(6).random((2, 30, 41)).astype(np.float32)
    got = wfmeasure.gaussian_smooth(_t(x)).numpy()
    k = jnp.asarray(jwf._gauss_kernel(), jnp.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x)[:, None], k[None, None], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_accumulator_result_and_report_match_jax():
    sal, gt, mask, _ = _batch(7)
    acc = salmetric.SalMetricAccumulator(device="cpu")
    jacc = jsal.SalMetricAccumulator()
    for lo, hi in ((0, 4), (4, 9)):
        count = hi - lo - (1 if hi == 9 else 0)  # drop the all-masked row
        acc.update_batch(sal[lo:hi], gt[lo:hi], mask[lo:hi], count=count)
        jacc.update_batch(sal[lo:hi], gt[lo:hi], mask[lo:hi], count=count)
    got, want = acc.result(), jacc.result()
    assert got.keys() == want.keys() and got["argmax"] == want["argmax"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    # the report of one result dict is the JAX package's text
    assert salmetric.format_report(want) == jsal.format_report(want)
    lines = salmetric.format_report(got).splitlines()
    assert len(lines) == 256 + 7 and lines[-1].startswith("MAE:")


def test_result_from_sums_matches_jax():
    rng = np.random.default_rng(8)
    sums = {"n": np.asarray([4.0, 3.0], np.float32),
            "mae_sum": rng.random(2).astype(np.float32),
            "p_sum": rng.random((2, 256)).astype(np.float32) * 3,
            "r_sum": rng.random((2, 256)).astype(np.float32) * 3,
            "e_sum": rng.random((2, 256)).astype(np.float32) * 3,
            "a_sum": rng.random(2).astype(np.float32),
            "ae_sum": rng.random(2).astype(np.float32),
            "s_sum": rng.random(2).astype(np.float32),
            "w_sum": rng.random(2).astype(np.float32)}
    got = salmetric.result_from_sums({k: _t(v) for k, v in sums.items()})
    want = jsal.result_from_sums(sums)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert salmetric.format_report(got) == jsal.format_report(want)


def test_accumulator_defaults_to_the_card():
    """No silent CPU fallback: the default device is the card."""
    if torch.cuda.is_available():
        assert salmetric.SalMetricAccumulator().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            salmetric.SalMetricAccumulator()
