"""Port parity, CSF+Res2Net: the ops of the CSF dialect, the model, weights
interop and serving against the JAX package, f32 on the CPU.

Inputs come from numpy seeds; the JAX side is jitted (one XLA compile is
quicker than eager dispatch's one per primitive and shape). The model's
weights go from the port to JAX
through the JAX package's ``state_dict_to_pytree``; a JAX pytree comes to
the port through ``state_dict_from_pytree`` (its shapes from
``jax.eval_shape(csf_init)``, filled from numpy: ``csf_init`` itself takes
half a minute on the CPU). Each JAX forward is jitted once per backbone
and shape and shared through module fixtures.

Weights: the reference's init (the port's seeded ``CSFNet``), where the
backbone's signal nearly vanishes and the GroupNorm head rescales it, and
one case with He-scale backbone convs and BN statistics and affines drawn
so that activations keep their scale, which exercises the backbone.

Bars: forward max |dlogit| < 1e-4 * max(1, max|logit|) and sigmoid mean
|d| < 1e-5; ops at odd shapes within 1e-5 (f32), GroupNorm within 1e-6.
"""

import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import _close, _nhwc, _to_nhwc
from test_torch_serve import _post_npy, _serve, _stop

from sod100k_tpu.arch import csf_res2net as jcsf
from sod100k_tpu.arch.csnet import count_params as jcount_params
from sod100k_tpu.data.pipeline import normalize_u8_device
from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                            state_dict_to_pytree)
from sod100k_tpu.ops import goct as jgoct
from sod100k_tpu.ops import norm as jnorm
from sod100k_tpu.ops import resample as jresample
from sod100k_tpu_torch.arch.csf_res2net import (FUSE_IN, FUSE_OUT, LAYERS,
                                                MS_DIL_SPLITS, CSFNet,
                                                count_params,
                                                load_res2net_backbone)
from sod100k_tpu_torch.arch.csnet import CSNet
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.interop.torch_ckpt import state_dict_from_pytree
from sod100k_tpu_torch.ops import goct, norm, resample
from sod100k_tpu_torch.serve import ServingModel, export_artifact
from sod100k_tpu_torch.serve_http import make_server
from sod100k_tpu_torch.train.step import make_eval_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _randomize(module, seed):
    """Seeded conv weights at 1/sqrt(fan_in) (plain convs: GroupNorm sees
    O(1) activations, not ones that eps would swamp), norm affines and
    PReLU slopes."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.dim() == 4:
                v = rng.standard_normal(t.shape) / np.prod(t.shape[1:]) ** 0.5
            else:
                v = rng.standard_normal(t.shape) * 0.5
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return module


# ---------------------------------------------------------------------------
# ops (CSF dialect)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(2, 19, 25, 64), (1, 7, 9, 1408)])
def test_groupnorm_matches_jax(shape, dtype):
    """Statistics and affine in f32, one rounding to the activation dtype:
    f32 within 1e-6 (relative where |y| > 1: ATen folds the affine into one
    scale and shift); bf16 within one bf16 ulp of the JAX package."""
    gn = _randomize(torch.nn.GroupNorm(32, shape[-1]), 1)
    x, _ = _nhwc(np.random.default_rng(2), shape)
    x = x * 3.0 + 0.5
    jx = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).permute(
        0, 3, 1, 2)
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = norm.groupnorm(xt.to(tdtype), gn)
    assert got.dtype == tdtype
    want = jnorm.groupnorm(jx, state_dict_to_pytree(gn.state_dict()))
    got = _to_nhwc(got.float())
    want = np.asarray(want.astype(jnp.float32))
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("hw", [(37, 45), (19, 25)])
@pytest.mark.parametrize("kernel,stride,pad,ceil,count_pad", [
    (3, 2, 1, False, True),    # the Bottle2neck stage pool at stride 2
    (3, 1, 1, False, True),    # ... at stride 1
    (2, 2, 0, True, False),    # the downsample shortcut's pool
    (2, 2, 0, True, True),
    (3, 2, 1, True, True),     # ceil extension beyond the padding
    (2, 3, 0, True, False),    # stride > kernel: torch drops a last window
    (1, 3, 0, True, True),     # that would start outside the input
])
def test_avg_pool_torch_matches_jax(hw, kernel, stride, pad, ceil, count_pad):
    x, xt = _nhwc(np.random.default_rng(3), (2, *hw, 3))
    got = resample.avg_pool_torch(xt, kernel, stride, pad, ceil_mode=ceil,
                                  count_include_pad=count_pad)
    want = jresample.avg_pool_torch(jnp.asarray(x), kernel, stride, pad,
                                    ceil_mode=ceil,
                                    count_include_pad=count_pad)
    assert got.shape[2:] == want.shape[1:3]
    _close(_to_nhwc(got), want, atol=1e-6)


@pytest.mark.parametrize("hw", [(37, 45), (19, 25), (8, 8)])
def test_max_pool_torch_matches_jax(hw):
    x, xt = _nhwc(np.random.default_rng(4), (2, *hw, 3))
    got = resample.max_pool_torch(xt, 3, 2, 1)
    want = jresample.max_pool_torch(jnp.asarray(x), 3, 2, 1)
    assert got.shape[2:] == want.shape[1:3]
    _close(_to_nhwc(got), want, atol=0.0)


@pytest.mark.parametrize("src,dst", [
    ((10, 13), (75, 100)),    # up, non-integer ratios
    ((75, 100), (38, 50)),    # down, non-integer ratios
    ((38, 51), (19, 26)),     # the CSF branch shapes of a 301x401 input
    ((10, 13), (38, 51)),
    ((11, 13), (43, 51)),
])
def test_resize_bilinear_non_integer_ratios_match_jax(src, dst):
    x, xt = _nhwc(np.random.default_rng(5), (2, *src, 4))
    _close(_to_nhwc(resample.resize_bilinear(xt, dst)),
           jresample.resize_bilinear(jnp.asarray(x), dst))


# branch shapes of the backbone at 301x401 (layer1..layer4) and at 64^2
ODD_BRANCHES = [(76, 101), (38, 51), (19, 26), (10, 13)]
POW2_BRANCHES = [(16, 16), (8, 8), (4, 4), (2, 2)]


def _branch_set(rng, n, shapes, split):
    jx, tx = [], []
    for (h, w), c in zip(shapes, split):
        a, t = _nhwc(rng, (n, h, w, c))
        jx.append(jnp.asarray(a))
        tx.append(t)
    return jx, tx


def _close_set(got, want, atol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[2:] == w.shape[1:3]
        _close(_to_nhwc(g), w, atol=atol)


@pytest.mark.parametrize("shapes", [ODD_BRANCHES, POW2_BRANCHES])
@pytest.mark.parametrize("in_split,out_split,k", [
    ((8, 12, 16, 20), (4, 8, 12, 12), 1),
    ((8, 12, 16, 20), (24,), 1),      # 4 in, 1 out: fuse1x1's shape
    ((6, 6, 6, 6), (5, 7, 3, 4), 3),
])
def test_goct_conv_csf_flavor_matches_jax(shapes, in_split, out_split, k):
    rng = np.random.default_rng(6)
    jx, tx = _branch_set(rng, 2, shapes, in_split)
    w = rng.standard_normal((sum(out_split), sum(in_split), k, k),
                            dtype=np.float32) / (sum(in_split) * k * k) ** 0.5
    got = goct.goct_conv(tx, torch.from_numpy(w), None, in_split=in_split,
                         out_split=out_split, padding=k // 2, flavor="csf")
    want = jax.jit(lambda xs, w: jgoct.goct_conv(
        xs, w, None, in_split=in_split, out_split=out_split, padding=k // 2,
        flavor="csf"))(jx, jnp.asarray(w.transpose(2, 3, 1, 0)))
    _close_set(got, want)


@pytest.mark.parametrize("in_split,out_split", [
    ((32, 64, 32, 64), (64, 32, 64, 32)),
    ((32, 64, 32, 64), (96,)),       # 4 in, 1 out: no x100, GN per branch
])
def test_goct_cbr_gn_matches_jax(in_split, out_split):
    m = _randomize(goct.GOctCBR(in_split, out_split, 1, flavor="csf",
                                norm="gn"), 7)
    assert "conv.weights" in m.state_dict()
    assert not any("running" in k or "num_batches" in k
                   for k in m.state_dict())
    jx, tx = _branch_set(np.random.default_rng(7), 2, ODD_BRANCHES, in_split)
    with torch.no_grad():
        got = m(tx)
    want = jax.jit(lambda p, xs: jgoct.goct_cbr(
        jgoct.ApplyCtx(), "m", p, xs, in_split=in_split, out_split=out_split,
        flavor="csf", norm="gn"))(state_dict_to_pytree(m.state_dict()), jx)
    _close_set(got, want)


def test_pall_ms_block_gn_plain_matches_jax():
    """PallMSBlock with GroupNorm and plain (not x100) convs, dilations up
    to 16 on odd branch shapes smaller than the dilation."""
    in_split = (32, 64, 64, 32)
    dil_splits = tuple((c // 5,) * 4 + (c - 4 * (c // 5),) for c in in_split)
    m = _randomize(goct.PallMSBlock(in_split, dil_splits, norm="gn",
                                    x100=False), 8)
    jx, tx = _branch_set(np.random.default_rng(8), 1, ODD_BRANCHES, in_split)
    with torch.no_grad():
        got = m(tx)
    want = jax.jit(lambda p, xs: jgoct.pall_ms_block(
        jgoct.ApplyCtx(), "m", p, xs, dil_splits=dil_splits, norm="gn",
        x100=False))(state_dict_to_pytree(m.state_dict()), jx)
    _close_set(got, want)


def test_gap_collector_skips_group_norms():
    m = goct.GOctCBR((32, 32), (32, 32), 1, flavor="csf", norm="gn").train()
    gap = goct.GapCollector(goct.bn_paths(m))
    _, tx = _branch_set(np.random.default_rng(9), 1, POW2_BRANCHES[:2],
                        (32, 32))
    with torch.no_grad():
        m(tx, gap)
    assert gap.gap == {} and gap.paths == {}


# ---------------------------------------------------------------------------
# the model


@pytest.fixture(scope="module")
def jax_forward():
    """One jitted csf_apply per backbone (jax.jit caches per shape)."""
    return {b: jax.jit(lambda p, x, b=b: jcsf.csf_apply(p, x, b))
            for b in LAYERS}


@pytest.fixture(scope="module")
def r50():
    return CSFNet("res2net50", seed=0, device="cpu")


def he_scale_state(model: CSFNet, seed: int) -> dict:
    """``model``'s state with He-scale backbone convs (N(0, 2/fan_in)) and
    BN statistics and affines drawn so that activations keep their scale
    (running var U(0.5, 1.5), mean N(0, 0.1); gamma U(0.5, 1), the
    residual branch's last BN and the shortcut's U(0.1, 0.3); beta
    N(0, 0.1)): the backbone's layer features keep a std of ~0.15-0.25
    where the reference init leaves ~1e-7 at layer4."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if not k.startswith("base.") or k.endswith("num_batches_tracked"):
            out[k] = v.clone()
            continue
        if v.dim() == 4:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
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
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def _check_forward(model, x, jfwd):
    """The port's forward (NHWC in and out) against the JAX package's on
    the same weights; returns the port's logits."""
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jfwd(state_dict_to_pytree(model.state_dict()),
                           jnp.asarray(x)))
    assert got.shape == want.shape == (*x.shape[:3], 1)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() < 1e-4 * scale
    assert np.abs(_sig(got) - _sig(want)).mean() < 1e-5
    assert _sig(got).std() > 1e-3  # not a constant map
    return got


@pytest.mark.parametrize("hw", [(64, 64), (37, 45)])
def test_res2net50_matches_jax(r50, jax_forward, hw):
    """The reference init, at 64^2 and at an odd size (non-integer octave
    resizes, ceil-mode shortcut pools)."""
    x = np.random.default_rng(10).standard_normal((2, *hw, 3),
                                                  dtype=np.float32)
    _check_forward(r50, x, jax_forward["res2net50"])


def test_res2net50_he_scale_matches_jax(jax_forward):
    model = CSFNet("res2net50", seed=0, device="cpu")
    model.load_state_dict(he_scale_state(model, 11), strict=True)
    x = np.random.default_rng(12).standard_normal((2, 64, 64, 3),
                                                  dtype=np.float32)
    with torch.no_grad():
        feats = model.base(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert min(f.std().item() for f in feats) > 0.05  # the signal survives
    _check_forward(model, x, jax_forward["res2net50"])


def test_res2net101_matches_jax(jax_forward):
    model = CSFNet("res2net101", seed=3, device="cpu")
    assert len(model.base.layer3) == 23
    x = np.random.default_rng(13).standard_normal((1, 32, 32, 3),
                                                  dtype=np.float32)
    _check_forward(model, x, jax_forward["res2net101"])


def test_train_mode_keeps_running_statistics(r50):
    """``CSFNet.train()`` changes nothing: the backbone's BNs normalize with
    their running statistics and none of them moves."""
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1, 32, 32, 3), dtype=np.float32))
    before = {k: v.clone() for k, v in r50.state_dict().items()}
    with torch.no_grad():
        want = r50.eval()(x)
        got = r50.train()(x)
    r50.eval()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(torch.equal(v, before[k]) for k, v in r50.state_dict().items())


def test_init_follows_the_reference_distributions():
    model = CSFNet("res2net50", seed=5, device="cpu")
    sd = model.state_dict()
    for name, v in sd.items():
        if name in ("fuse.conv.weights", "fuse1x1.conv.weights"):
            bound = (1.0 / v.shape[1]) ** 0.5
            assert v.abs().max() <= bound and v.abs().max() > 0.99 * bound
            assert abs(v.std().item() - bound / 3 ** 0.5) < 0.01 * bound
        elif v.dim() == 4:  # every plain conv ~ N(0, 0.01)
            if v.numel() >= 4096:
                assert abs(v.std().item() - 0.01) < 5e-4, name
                assert abs(v.mean().item()) < 1e-3, name
        elif "prelu" in name:
            assert torch.all(v == 0.25), name
        elif name.endswith(("running_var", ".weight")):  # BN and GN
            assert torch.all(v == 1), name
        elif name.endswith("num_batches_tracked"):
            assert v.item() == 0
        else:  # BN/GN biases, running means, the classifier's bias
            assert torch.all(v == 0), name
    other = CSFNet("res2net50", seed=5, device="cpu").state_dict()
    assert all(torch.equal(v, other[k]) for k, v in sd.items())


# ---------------------------------------------------------------------------
# weights carried across


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX CSF pytree (res2net50): csf_init's shapes, numpy values."""
    shapes = jax.eval_shape(lambda: jcsf.csf_init(jax.random.key(0)))
    rng = np.random.default_rng(15)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_state_dict_from_pytree_round_trip(jax_tree):
    """The port's state_dict of a JAX CSF pytree is the JAX package's
    ``pytree_to_state_dict`` plus ``num_batches_tracked`` on each BN (none
    on a GroupNorm), with the plural ``weights`` at fuse.conv and
    fuse1x1.conv, and loads strictly."""
    ref = pytree_to_state_dict(jax_tree)
    got = state_dict_from_pytree(jax_tree)
    extra = {k for k in got if k.endswith("num_batches_tracked")}
    assert set(got) - extra == set(ref)
    assert {k.rsplit(".", 1)[0] for k in extra} == \
        {k.rsplit(".", 1)[0] for k in ref if k.endswith("running_mean")}
    assert "fuse.conv.weights" in got and "fuse1x1.conv.weights" in got
    assert not any(k.startswith(("fuse.bns", "fuse1x1.bns", "ms."))
                   for k in extra)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    model = CSFNet("res2net50", device="cpu")
    model.load_state_dict(got, strict=True)
    assert set(model.state_dict()) == set(got)
    assert count_params(model) == jcount_params(jax_tree) == 36528489
    back = state_dict_to_pytree(model.state_dict())
    assert jax.tree.all(jax.tree.map(np.array_equal, back, jax_tree))


def test_load_res2net_backbone(tmp_path, jax_tree):
    """An ImageNet-style checkpoint (top-level backbone keys and an fc
    head), written with torch.save: the backbone takes its tensors, fc is
    dropped and the head keeps its own; the JAX package's loader gives the
    same parameters."""
    donor = CSFNet("res2net50", seed=1, device="cpu")
    ckpt = {k: v for k, v in donor.base.state_dict().items()}
    ckpt["fc.weight"] = torch.zeros(1000, 2048)
    ckpt["fc.bias"] = torch.zeros(1000)
    path = str(tmp_path / "res2net50_v1b_26w_4s.pth")
    torch.save(ckpt, path)
    model = CSFNet("res2net50", device="cpu")
    model.load_state_dict(state_dict_from_pytree(jax_tree), strict=True)
    head = {k: v.clone() for k, v in model.state_dict().items()
            if not k.startswith("base.")}
    missing, unexpected = load_res2net_backbone(model, path)
    assert missing == [] and unexpected == []
    sd = model.state_dict()
    for k, v in donor.base.state_dict().items():
        assert torch.equal(sd[f"base.{k}"], v)
    for k, v in head.items():
        assert torch.equal(sd[k], v)
    want = pytree_to_state_dict(jcsf.load_res2net_backbone(jax_tree, path))
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


# ---------------------------------------------------------------------------
# serving

SERVE_HW = (64, 64)


@pytest.fixture(scope="module")
def served(r50, jax_forward):
    """u8 images and the JAX package's sigmoid on them (r50's weights)."""
    u8 = np.random.default_rng(16).integers(0, 256, (3, *SERVE_HW, 3),
                                            np.uint8)
    x = normalize_u8_device(jnp.asarray(u8))
    logits = jax_forward["res2net50"](state_dict_to_pytree(r50.state_dict()),
                                      x)
    return u8, np.array(x), _sig(np.asarray(logits))


def test_csf_artifact_serves_like_jax(r50, served, tmp_path):
    """f32 wire: the ServingModel (buckets 1 and 2: a padded tail and a
    chunk) within 1e-6 of the JAX sigmoid; u8 wire: trunc(sigmoid * 255)
    of the port's own eval step, and within one level of the JAX one."""
    u8, x, want = served
    f32_dir, u8_dir = str(tmp_path / "f32"), str(tmp_path / "u8")
    export_artifact(f32_dir, r50, batch=(1, 2), hw=SERVE_HW,
                    dtype=torch.float32, wire="f32")
    export_artifact(u8_dir, r50, batch=(1, 2), hw=SERVE_HW,
                    dtype=torch.float32, wire="u8")
    with open(os.path.join(f32_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["family"] == "csf" and meta["backbone"] == "res2net50"
    assert not os.path.exists(os.path.join(f32_dir, "layer_config.bin"))
    sm = ServingModel(f32_dir, device="cpu")
    assert isinstance(sm.model, CSFNet)
    got = sm(x)
    assert got.shape == (3, *SERVE_HW, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sm8 = ServingModel(u8_dir, device="cpu")
    got8 = sm8(u8)
    direct = make_eval_step(r50, from_u8=True, quantize_u8=True)(
        torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got8, direct)
    assert np.abs(got8.astype(np.int32)
                  - np.trunc(want * 255.0).astype(np.int32)).max() <= 1


def test_csf_artifact_over_http(r50, served, tmp_path):
    u8, _, _ = served
    export_artifact(str(tmp_path), r50, batch=(1, 2), hw=SERVE_HW,
                    dtype=torch.float32, wire="u8")
    sm = ServingModel(str(tmp_path), device="cpu")
    srv = make_server(sm, max_wait_ms=1.0)
    url, t = _serve(srv)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["family"] == "csf"
        code, body = _post_npy(url, u8)
        assert code == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(body)), sm(u8))
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 1 and stats["images"] == 3
    finally:
        _stop(srv, t)


def test_csnet_artifacts_keep_their_format(tmp_path):
    """A CSNet artifact is written as before this family existed
    (layer_config.bin, no backbone) and loads; other models and families
    are refused."""
    model = CSNet(init_layers(8, (0.5, 0.5)), device="cpu")
    export_artifact(str(tmp_path), model, hw=(32, 32), dtype=torch.float32)
    with open(tmp_path / "meta.json") as f:
        meta = json.load(f)
    assert meta["family"] == "csnet" and "backbone" not in meta
    assert (tmp_path / "layer_config.bin").exists()
    assert isinstance(ServingModel(str(tmp_path), device="cpu").model, CSNet)
    with pytest.raises(TypeError):
        export_artifact(str(tmp_path / "x"), torch.nn.Linear(2, 2))
    meta["family"] = "unet"
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="unet"):
        ServingModel(str(tmp_path), device="cpu")


def test_entry_points_default_to_the_card():
    """CSFNet builds on the card unless the caller names the CPU, and
    raises without one; ServingModel takes no default device."""
    import inspect

    assert inspect.signature(CSFNet).parameters["device"].default == "cuda"
    assert inspect.signature(ServingModel).parameters["device"].default \
        is inspect.Parameter.empty
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            CSFNet("res2net50")


def test_constants_match_jax():
    assert (FUSE_IN, FUSE_OUT, MS_DIL_SPLITS) == (
        jcsf.FUSE_IN, jcsf.FUSE_OUT, jcsf.MS_DIL_SPLITS)
    assert LAYERS == jcsf.LAYERS
