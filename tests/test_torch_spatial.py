"""Port parity, row bands: every spatial op of the port under a 1 x 2 and a
1 x 3 spatial group against the same op in one process, f32 on the CPU.

Real gloo worlds (the SOD100K_* variables, as ``test_torch_parallel.py``
starts them) run this file as a script. Each rank takes its band of each
case's input rows (``parallel.spatial``), runs the op on the band, and
backpropagates its band of a seeded output gradient; the bands of the
output and of the input gradient are gathered into whole maps and the
weight gradients summed over the group. Rank 0 saves them; the test holds
them against the op on the whole maps in this process.

Bars: the forward and the input gradient within 1e-6 absolute (inputs of
unit scale). Two are restated, with their reasons:
- the weight and bias gradients are sums over every pixel, which the bands
  add in another order: within 1e-6 * max(1, max|reference|);
- the input gradient of a bilinear upsample sums up to 2 * 16 output rows'
  gradients per source row, which the bands (and the halo's adjoint) add in
  another order: within 2e-6 absolute.

Cases: uneven bands (13 rows over 2 and 3), 1-row bands (3 rows over 3),
empty bands (1 and 2 rows over 3, the deepest octave branches), dilation
16 reaching past the neighbour's band, stride 2 from an odd band start,
resizes 42 -> 84, 21 -> 336, 11 -> 21 and 21 -> 11, the ceil-mode average
pool, the stem's max pool, GroupNorm and the GAP over the spatial group,
the global batch norm on uneven bands, the class-balanced BCE's counts,
both gOctConv flavours, the MSBlock octset, and the fused depthwise
tail's band path against the whole-image ``fused_dw_chain_ref``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import run_ranks  # noqa: E402

from sod100k_tpu_torch.ops import conv, dw_chain, goct, norm, resample  # noqa: E402
from sod100k_tpu_torch.parallel import mesh, multihost, spatial  # noqa: E402

HERE = os.path.abspath(__file__)
ATOL = 1e-6


def _u(rng, *shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


# ---- the cases: inputs from a seed, and one function for both sides -----
# fn(xs, ps, sp) -> output; xs are the banded inputs (whole without sp),
# ps the parameters (leaf tensors whose gradients are compared)

def _conv(stride, pad, dil, groups=1):
    def make(rng, h):
        cin, cout = 4, 4 if groups > 1 else 6
        return ([_u(rng, 2, cin, h, 9)],
                [_u(rng, cout, cin // groups, 3, 3, scale=0.3),
                 _u(rng, cout, scale=0.1)])

    def fn(xs, ps, sp):
        return conv.conv2d(xs[0], ps[0], ps[1], stride=stride, padding=pad,
                           dilation=dil, groups=groups, weight_scale=1.0,
                           spatial=sp)
    return make, fn


def _pool(op):
    def make(rng, h):
        return [_u(rng, 2, 3, h, 9)], []

    def fn(xs, ps, sp):
        return op(xs[0], sp)
    return make, fn


def _resize(h_out, w_out, dtype=np.float32):
    def make(rng, h):
        return [_u(rng, 1, 3, h, 7).astype(dtype)], []

    def fn(xs, ps, sp):
        return resample.resize_bilinear(xs[0], (h_out, w_out), sp)
    return make, fn


class _GNAct(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gn = torch.nn.GroupNorm(4, 8, eps=norm.BN_EPS)
        self.act = torch.nn.PReLU(8)

    def forward(self, x, sp):
        return norm.norm_act(self.gn, self.act, x, sp)


def _module_case(build, shapes, hs):
    """A module whose parameters are the case's (``functional_call``)."""
    names = [n for n, _ in build().named_parameters()]

    def make(rng, h):
        xs = [_u(rng, *s[:2], hh, s[2]) + 0.3 for s, hh in zip(shapes, hs)]
        ps = [_u(rng, *p.shape, scale=0.3) + (1.0 if "gn.weight" in n
                                              else 0.0)
              for n, p in build().named_parameters()]
        return xs, ps

    def fn(xs, ps, sp):
        m = build().eval()
        arg = xs if len(xs) > 1 else xs[0]
        return torch.func.functional_call(m, dict(zip(names, ps)),
                                          (arg, sp) if isinstance(m, _GNAct)
                                          else (arg, None, sp))
    return make, fn


def _goct(flavor, hs, stride=1, pad=1, kernel=3):
    in_split, out_split = (4, 3, 2), (3, 2, 2)

    def make(rng, h):
        xs = [_u(rng, 2, c, hh, ww) for c, (hh, ww) in zip(in_split, hs)]
        return xs, [_u(rng, sum(out_split), sum(in_split), kernel, kernel,
                       scale=0.3)]

    def fn(xs, ps, sp):
        return goct.goct_conv(xs, ps[0], None, in_split=in_split,
                              out_split=out_split, stride=stride,
                              padding=pad, flavor=flavor, spatial=sp)
    return make, fn


def _msblock():
    # eval-mode batch norms (local); GroupNorm is its own case
    return lambda: goct.PallMSBlock((4, 3), ((1, 1, 1, 1, 2),
                                             (2, 0, 1, 0, 1)), x100=False)


# name -> (global height of the first input, (make, fn)); the multi-input
# cases carry their own heights
CASES = {
    "conv_uneven": (13, _conv(1, 1, 1)),
    "conv_stride2_odd_start": (13, _conv(2, 1, 1)),
    "conv_stride2_dil2": (14, _conv(2, 2, 2)),
    "conv_dil16_past_neighbour": (40, _conv(1, 16, 16)),
    "conv_depthwise_1row": (3, _conv(1, 1, 1, groups=4)),
    "conv_empty_bands": (2, _conv(1, 1, 1)),
    "conv_one_row": (1, _conv(1, 1, 1)),
    "maxpool2": (13, _pool(lambda x, sp: resample.max_pool(x, 2, sp))),
    "maxpool4": (13, _pool(lambda x, sp: resample.max_pool(x, 4, sp))),
    "avgpool2": (13, _pool(lambda x, sp: resample.avg_pool(x, 2, sp))),
    "upsample2": (7, _pool(
        lambda x, sp: resample.upsample_bilinear(x, 2, sp))),
    "upsample4_from_1row": (1, _pool(
        lambda x, sp: resample.upsample_bilinear(x, 4, sp))),
    "maxpool_stem": (13, _pool(
        lambda x, sp: resample.max_pool_torch(x, 3, 2, 1, sp))),
    "avgpool_stage": (13, _pool(
        lambda x, sp: resample.avg_pool_torch(x, 3, 2, 1, spatial=sp))),
    "avgpool_stage_s1": (7, _pool(
        lambda x, sp: resample.avg_pool_torch(x, 3, 1, 1, spatial=sp))),
    "avgpool_ceil_nopad": (13, _pool(
        lambda x, sp: resample.avg_pool_torch(
            x, 2, 2, 0, ceil_mode=True, count_include_pad=False,
            spatial=sp))),
    "resize_42_84": (42, _resize(84, 14)),
    "resize_21_336": (21, _resize(336, 7)),
    "resize_11_21": (11, _resize(21, 9)),
    "resize_21_11": (21, _resize(11, 5)),
    # f64 maps resize in f64, as ATen does (bar F64_ATOL)
    "resize_11_21_f64": (11, _resize(21, 9, np.float64)),
    "groupnorm_prelu": (13, _module_case(_GNAct, [(2, 8, 5)], [13])),
    "goct_csnet": (12, _goct("csnet", ((12, 12), (6, 6), (3, 3)))),
    "goct_csnet_stride2": (16, _goct("csnet", ((16, 8), (8, 4), (4, 2)),
                                     stride=2)),
    "goct_csf": (21, _goct("csf", ((21, 9), (11, 5), (6, 3)), pad=0,
                           kernel=1)),
    "msblock_dil16": (40, _module_case(_msblock(), [(2, 4, 6), (2, 3, 6)],
                                       [40, 20])),
}
# the input gradients of the upsamples (see above)
DX_ATOL = {name: 2e-6 for name in CASES
           if name.startswith(("resize", "upsample", "goct"))}
F64_ATOL = 1e-12
Y_ATOL = {name: F64_ATOL for name in CASES if name.endswith("_f64")}
DX_ATOL.update(Y_ATOL)


def run_case(name, sp=None):
    """The case on whole maps (sp None) or on this rank's bands: returns
    {"y": [...], "dx": [...], "dp": [...]} as numpy, whole maps and summed
    parameter gradients."""
    h, (make, fn) = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    xs_np, ps_np = make(rng, h)
    ps = [torch.from_numpy(p).requires_grad_(True) for p in ps_np]
    xs = []
    for x in xs_np:
        t = torch.from_numpy(x)
        if sp is not None:
            a, b = sp.band(x.shape[2])
            t = spatial.tag(t[:, :, a:b].clone().requires_grad_(True),
                            x.shape[2])
        else:
            t = t.clone().requires_grad_(True)
        xs.append(t)
    out = fn(xs, ps, sp)
    outs = out if isinstance(out, list) else [out]
    grng = np.random.default_rng(7)
    res = {"y": [], "dx": [], "dp": []}
    if sp is None:
        gs = [torch.from_numpy(_u(grng, *o.shape)).to(o.dtype) for o in outs]
        torch.autograd.backward(outs, gs)
        res["y"] = [o.detach().numpy() for o in outs]
        res["dx"] = [x.grad.numpy() for x in xs]
        res["dp"] = [p.grad.numpy() for p in ps]
        return res
    whole = [spatial.gather_bands(o, sp) for o in outs]
    gs = []
    for o, wo in zip(outs, whole):
        g = torch.from_numpy(_u(grng, *wo.shape)).to(wo.dtype)
        a, b = sp.band(wo.shape[2])
        gs.append(g[:, :, a:b])
    torch.autograd.backward(outs, gs)
    res["y"] = [w.numpy() for w in whole]
    res["dx"] = [spatial.gather_bands(
        spatial.tag(x.grad, spatial.height(x)), sp).numpy() for x in xs]
    res["dp"] = [spatial.spatial_sum(p.grad, sp).numpy() for p in ps]
    return res


def run_gap(sp=None):
    """GapCollector's means of one BN's output, whole or from bands."""
    rng = np.random.default_rng(11)
    y = torch.from_numpy(_u(rng, 3, 5, 13, 6) + 0.2)
    bn = torch.nn.BatchNorm2d(5)
    col = goct.GapCollector({bn: "bn"}, sp)
    if sp is not None:
        a, b = sp.band(13)
        y = spatial.tag(y[:, :, a:b].clone(), 13)
    col.record(bn, y)
    col.finish()
    return col.gap["bn"].numpy()


def run_bn(sp=None):
    """Train-mode global batch norm on uneven bands (the world is the
    spatial group here): output, input and affine gradients, statistics."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_u(rng, 2, 4, 13, 5, scale=2.0) + 0.7)
    g = torch.from_numpy(_u(rng, 2, 4, 13, 5))
    bn = torch.nn.BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(_u(rng, 4) + 1.0))
        bn.bias.copy_(torch.from_numpy(_u(rng, 4)))
    if sp is not None:
        norm.convert_global_bn(bn, sp.group)
        a, b = sp.band(13)
        x, g = x[:, :, a:b], g[:, :, a:b]
    x = x.clone().requires_grad_(True)
    y = bn(x)
    y.backward(g)
    if sp is None:
        return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                "mean": bn.running_mean.numpy(),
                "var": bn.running_var.numpy()}
    return {"y": spatial.gather_bands(spatial.tag(y.detach(), 13),
                                      sp).numpy(),
            "dx": spatial.gather_bands(spatial.tag(x.grad, 13), sp).numpy(),
            "dw": spatial.spatial_sum(bn.weight.grad, sp).numpy(),
            "db": spatial.spatial_sum(bn.bias.grad, sp).numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def run_bce2d(sp=None):
    """The class-balanced BCE's "sum" and "mean", and its per-pixel map,
    whole or from bands (the class counts of the whole images)."""
    from sod100k_tpu_torch.train.csf_step import bce2d

    rng = np.random.default_rng(13)
    logits = torch.from_numpy(_u(rng, 2, 13, 6, 1, scale=3.0))
    target = torch.from_numpy((rng.random((2, 13, 6, 1)) > 0.7)
                              .astype(np.float32))
    if sp is not None:
        a, b = sp.band(13)
        logits, target = logits[:, a:b], target[:, a:b]
    out = {k: bce2d(logits, target, k, spatial=sp)
           for k in ("none", "sum", "mean")}
    if sp is None:
        return {k: v.numpy() for k, v in out.items()}
    return {"none": spatial.gather_bands(out["none"], sp, dim=1,
                                         h=13).numpy(),
            "sum": spatial.spatial_sum(out["sum"], sp).numpy(),
            "mean": spatial.spatial_sum(out["mean"], sp).numpy()}


TAIL_SHAPES = ((2, 6, 13, 10), (1, 4, 3, 7), (1, 3, 2, 5))


def tail_inputs(shape):
    rng = np.random.default_rng(shape[2])
    c = shape[1]
    x = torch.from_numpy(_u(rng, *shape))
    params = [torch.from_numpy(v) for v in (
        _u(rng, c, 3, 3, scale=0.5), _u(rng, c) + 1.0, _u(rng, c, scale=.1),
        _u(rng, c) * 0.3, _u(rng, c, 3, 3, scale=0.5), _u(rng, c) + 1.0,
        _u(rng, c, scale=.1), _u(rng, c) * 0.3)]
    return x, params


def run_tail(shape, sp):
    """The fused tail's band path, gathered (plain version on the CPU)."""
    x, params = tail_inputs(shape)
    a, b = sp.band(shape[2])
    band = spatial.tag(x[:, :, a:b].contiguous(), shape[2])
    y = dw_chain.fused_dw_chain_band(band, dw_chain.pack_params(*params), sp)
    return spatial.gather_bands(y, sp).numpy()


def worker(out_dir: str) -> None:
    multihost.init_from_env(lambda *_: None)
    m = mesh.make_mesh_2d(1, mesh.world_size())
    sp = spatial.SpatialCtx(m, 0)
    res = {}
    for name in CASES:
        r = run_case(name, sp)
        for k, v in r.items():
            for i, a in enumerate(v):
                res[f"{name}/{k}{i}"] = a
    res["gap"] = run_gap(sp)
    for k, v in run_bce2d(sp).items():
        res[f"bce2d/{k}"] = v
    for k, v in run_bn(sp).items():
        res[f"bn/{k}"] = v
    for shape in TAIL_SHAPES:
        res[f"tail{shape}"] = run_tail(shape, sp)
    res["exchanges"] = np.array([sp.exchanges, sp.halo_bytes])
    res["tail_launches"] = np.array(dw_chain.spatial_launches)
    if multihost.is_primary():
        np.savez(os.path.join(out_dir, "bands.npz"), **res)
    print("{}")


@pytest.fixture(scope="module", params=[2, 3], ids=["1x2", "1x3"])
def banded(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"spatial{request.param}")
    results = run_ranks([HERE, str(tmp)], tmp, n=request.param, timeout=180)
    for pid, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {pid} failed:\n{text}"
    return dict(np.load(tmp / "bands.npz"))


def _close(got, want, atol, what):
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert got.shape == want.shape and err <= atol, \
        f"{what}: shape {got.shape} vs {want.shape}, max err {err} > {atol}"


@pytest.mark.parametrize("name", list(CASES))
def test_op_on_bands(banded, name):
    want = run_case(name)
    for k, atol in (("y", Y_ATOL.get(name, ATOL)),
                    ("dx", DX_ATOL.get(name, ATOL))):
        for i, w in enumerate(want[k]):
            _close(banded[f"{name}/{k}{i}"], w, atol, f"{name} {k}{i}")
    for i, w in enumerate(want["dp"]):
        _close(banded[f"{name}/dp{i}"], w,
               atol * max(1.0, float(np.abs(w).max())), f"{name} dp{i}")


def test_gap_and_batchnorm_on_bands(banded):
    _close(banded["gap"], run_gap(), ATOL, "gap")
    want = run_bn()
    for k, w in want.items():
        bar = ATOL * max(1.0, float(np.abs(w).max())) if k in ("dw", "db") \
            else ATOL
        _close(banded[f"bn/{k}"], w, bar, f"bn {k}")


def test_class_balanced_bce_counts_the_whole_images(banded):
    for k, w in run_bce2d().items():
        _close(banded[f"bce2d/{k}"], w, ATOL * max(1.0, float(
            np.abs(w).max())), f"bce2d {k}")


@pytest.mark.parametrize("shape", TAIL_SHAPES, ids=str)
def test_tail_band_equals_whole_image(banded, shape):
    x, params = tail_inputs(shape)
    want = dw_chain.fused_dw_chain_ref(x, *params).numpy()
    _close(banded[f"tail{shape}"], want, ATOL, f"tail {shape}")
    # the plain version on the CPU launches no kernel, so counts none
    assert int(banded["tail_launches"]) == 0


@pytest.mark.parametrize("launched", [1, 0], ids=["launch", "no_launch"])
def test_band_tail_counts_the_kernels_own_launches(monkeypatch, launched):
    """``spatial_launches`` follows ``launches``, which only the kernel's
    launch site raises: a wrapper call that launched nothing adds 0."""
    def packed(win, pack):
        dw_chain.launches += launched
        return dw_chain.fused_dw_chain_ref(win, *dw_chain.unpack_params(pack))

    monkeypatch.setattr(dw_chain, "fused_dw_chain_packed", packed)
    monkeypatch.setattr(dw_chain, "launches", 5)
    monkeypatch.setattr(dw_chain, "spatial_launches", 0)
    sp = spatial.SpatialCtx(mesh.make_mesh_2d(1, 1), 0)
    x, params = tail_inputs(TAIL_SHAPES[0])
    y = dw_chain.fused_dw_chain_band(spatial.tag(x, x.shape[2]),
                                     dw_chain.pack_params(*params), sp)
    _close(y.numpy(), dw_chain.fused_dw_chain_ref(x, *params).numpy(), ATOL,
           "tail on one band")
    assert dw_chain.spatial_launches == launched


def test_exchanges_are_counted(banded):
    n, nbytes = banded["exchanges"]
    assert n > 0 and nbytes > 0


def test_untagged_band_is_refused():
    m = mesh.Mesh2D(1, 2, 0, 0, None, None, None)
    sp = spatial.SpatialCtx(m, 8)
    with pytest.raises(ValueError, match="global height"):
        conv.conv2d(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3),
                    padding=1, spatial=sp)
    with pytest.raises(ValueError, match="not supported on row bands"):
        conv.conv2d(spatial.tag(torch.zeros(1, 1, 4, 4), 8),
                    torch.zeros(1, 1, 3, 3), padding=1,
                    padding_mode="circular", spatial=sp)


def test_band_layout_is_tensor_split():
    for h in range(0, 12):
        for parts in (1, 2, 3, 4):
            want = [len(t) for t in torch.arange(h).tensor_split(parts)]
            got = [mesh.band_rows(h, i, parts) for i in range(parts)]
            assert [b - a for a, b in got] == want
            assert got[0][0] == 0 and got[-1][1] == h


if __name__ == "__main__":
    worker(sys.argv[1])
