"""Port parity, ops: sod100k_tpu_torch.ops against their sod100k_tpu twins.

Same numpy-seeded inputs through both packages, f32 on the CPU. The port is
NCHW/OIHW inside, the JAX package NHWC/HWIO; inputs are transposed on the way
in and outputs on the way out. Module parameters go from the port's modules
to JAX through the JAX package's own ``state_dict_to_pytree``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
from sod100k_tpu.ops import conv as jconv
from sod100k_tpu.ops import goct as jgoct
from sod100k_tpu.ops import norm as jnorm
from sod100k_tpu.ops import resample as jresample
from sod100k_tpu_torch.ops import conv, goct, norm, resample


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 on both sides; sums of at most a few hundred products of O(1) terms
ATOL = 1e-5


def _nhwc(rng, shape):
    """Seeded (N, H, W, C) f32 array and its NCHW torch twin."""
    a = rng.standard_normal(shape, dtype=np.float32)
    return a, torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _randomize(module, seed):
    """Seeded conv weights (O(1/fan_in) so x100 outputs stay O(1)), BN
    statistics and affines, and PReLU slopes."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if t.dim() == 4:
                fan_in = max(t.shape[1] * t.shape[2] * t.shape[3], 1)
                v = rng.standard_normal(t.shape) / (100.0 * fan_in ** 0.5)
            elif name.endswith("running_var"):
                v = rng.uniform(0.5, 2.0, t.shape)
            else:
                v = rng.standard_normal(t.shape) * 0.5
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil,groups,scale,bias,mode", [
    (4, 6, 3, 1, 1, 1, 2, 1.0, True, "zeros"),     # grouped, with bias
    (5, 5, 3, 1, 1, 1, 5, 100.0, False, "zeros"),  # depthwise x100
    (4, 3, 3, 1, 16, 16, 1, 100.0, False, "zeros"),  # dilation 16
    (3, 4, 3, 2, 1, 1, 1, 100.0, False, "zeros"),  # stride 2, odd size
    (4, 4, 3, 1, 2, 1, 1, 1.0, False, "circular"),
])
def test_conv2d_matches_jax(cin, cout, k, stride, pad, dil, groups, scale,
                            bias, mode):
    rng = np.random.default_rng(1)
    x, xt = _nhwc(rng, (2, 37, 35, cin))
    w = (rng.standard_normal((cout, cin // groups, k, k), dtype=np.float32)
         / (scale * (cin * k * k) ** 0.5))
    b = rng.standard_normal(cout, dtype=np.float32) if bias else None
    got = conv.conv2d(xt, torch.from_numpy(w),
                      None if b is None else torch.from_numpy(b),
                      stride=stride, padding=pad, dilation=dil, groups=groups,
                      weight_scale=scale, padding_mode=mode)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                        None if b is None else jnp.asarray(b),
                        stride=stride, padding=pad, dilation=dil,
                        groups=groups, weight_scale=scale, padding_mode=mode)
    _close(_to_nhwc(got), want)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_bilinear_matches_jax(factor):
    x, xt = _nhwc(np.random.default_rng(factor), (2, 7, 5, 3))
    _close(_to_nhwc(resample.upsample_bilinear(xt, factor)),
           jresample.upsample_bilinear(jnp.asarray(x), factor))


@pytest.mark.parametrize("src,dst", [((7, 5), (16, 11)), ((20, 18), (9, 7)),
                                     ((6, 6), (24, 24))])
def test_resize_bilinear_matches_jax(src, dst):
    x, xt = _nhwc(np.random.default_rng(3), (2, *src, 4))
    _close(_to_nhwc(resample.resize_bilinear(xt, dst)),
           jresample.resize_bilinear(jnp.asarray(x), dst))


@pytest.mark.parametrize("factor", [2, 4])
def test_pools_floor_mode_match_jax(factor):
    x, xt = _nhwc(np.random.default_rng(4), (2, 13, 11, 3))  # ragged edges
    _close(_to_nhwc(resample.max_pool(xt, factor)),
           jresample.max_pool(jnp.asarray(x), factor))
    _close(_to_nhwc(resample.avg_pool(xt, factor)),
           jresample.avg_pool(jnp.asarray(x), factor))


def test_batchnorm_infer_and_prelu_match_jax():
    bn = _randomize(torch.nn.BatchNorm2d(6), 5)
    alpha = torch.from_numpy(np.linspace(-0.5, 0.5, 6, dtype=np.float32))
    x, xt = _nhwc(np.random.default_rng(5), (2, 9, 8, 6))
    p = state_dict_to_pytree(bn.state_dict())
    got = norm.prelu(norm.batchnorm_infer(xt, bn), alpha)
    want = jnorm.prelu(jnorm.batchnorm_infer(jnp.asarray(x), p),
                       jnp.asarray(alpha.numpy()))
    _close(_to_nhwc(got), want)


def _octset(rng, n, hw, split):
    """Branch i at hw / 2^i; None for empty branches."""
    jx, tx = [], []
    for i, c in enumerate(split):
        if c == 0:
            jx.append(None)
            tx.append(None)
            continue
        a, t = _nhwc(rng, (n, hw[0] >> i, hw[1] >> i, c))
        jx.append(jnp.asarray(a))
        tx.append(t)
    return jx, tx


def _close_set(got, want):
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if g is not None:
            _close(_to_nhwc(g), w)


@pytest.mark.parametrize("in_split,out_split,stride,k", [
    ((4, 4), (3, 5), 1, 1),
    ((4, 4), (6, 2), 2, 3),
    ((2, 3, 4), (3, 2, 4), 1, 3),
    ((2, 3, 4), (4, 0, 3), 2, 3),   # an empty output branch
])
def test_goct_conv_matches_jax(in_split, out_split, stride, k):
    rng = np.random.default_rng(6)
    jx, tx = _octset(rng, 2, (32, 24), in_split)
    w = rng.standard_normal((sum(out_split), sum(in_split), k, k),
                            dtype=np.float32) / (sum(in_split) * k * k) ** 0.5
    got = goct.goct_conv(tx, torch.from_numpy(w), None, in_split=in_split,
                         out_split=out_split, stride=stride, padding=k // 2)
    want = jgoct.goct_conv(jx, jnp.asarray(w.transpose(2, 3, 1, 0)), None,
                           in_split=in_split, out_split=out_split,
                           stride=stride, padding=k // 2)
    _close_set(got, want)


@pytest.mark.parametrize("in_split,out_split,stride,k", [
    ((3,), (6,), 2, 3),          # single branch: the x100 conv
    ((4, 4), (5, 3), 1, 1),
    ((2, 3, 4), (3, 0, 4), 1, 1),
])
def test_goct_cbr_matches_jax(in_split, out_split, stride, k):
    m = _randomize(goct.GOctCBR(in_split, out_split, k, stride=stride,
                                padding=k // 2), 7)
    rng = np.random.default_rng(7)
    jx, tx = _octset(rng, 2, (32, 24), in_split)
    with torch.no_grad():
        got = m(tx)
    want = jgoct.goct_cbr(jgoct.ApplyCtx(), "m", state_dict_to_pytree(
        m.state_dict()), jx, in_split=in_split, out_split=out_split,
        stride=stride, padding=k // 2)
    _close_set(got, want)


def test_simplified_goct_cbr_matches_jax():
    split = (4, 0, 3)
    m = _randomize(goct.SimplifiedGOctCBR(split), 8)
    jx, tx = _octset(np.random.default_rng(8), 2, (20, 16), split)
    with torch.no_grad():
        got = m(tx)
    want = jgoct.simplified_goct_cbr(jgoct.ApplyCtx(), "m", state_dict_to_pytree(
        m.state_dict()), jx, split=split)
    _close_set(got, want)


@pytest.mark.parametrize("dil_split", [(2, 2, 2, 2, 3), (0, 3, 0, 0, 2)])
def test_ms_block_matches_jax(dil_split):
    m = _randomize(goct.MSBlock(5, dil_split), 9)
    x, xt = _nhwc(np.random.default_rng(9), (2, 36, 34, 5))
    with torch.no_grad():
        got = m(xt)
    want = jgoct.ms_block(jgoct.ApplyCtx(), "m", state_dict_to_pytree(
        m.state_dict()), jnp.asarray(x), dil_split=dil_split)
    _close(_to_nhwc(got), want)


def test_pall_ms_block_matches_jax():
    in_split, dil_splits = (3, 4, 5), ((1, 1, 0, 1, 0), (0, 0, 0, 0, 0),
                                       (1, 1, 1, 1, 1))
    m = _randomize(goct.PallMSBlock(in_split, dil_splits), 10)
    jx, tx = _octset(np.random.default_rng(10), 1, (40, 36), in_split)
    with torch.no_grad():
        got = m(tx)
    want = jgoct.pall_ms_block(jgoct.ApplyCtx(), "m", state_dict_to_pytree(
        m.state_dict()), jx, dil_splits=dil_splits)
    _close_set(got, want)
