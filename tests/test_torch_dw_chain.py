"""Port parity, the fused depthwise tail on the CPU.

``fused_dw_chain_ref`` (the plain version of the CUDA kernel) against the
Pallas kernel ``sod100k_tpu.ops.pallas.dw_chain.fused_dw_chain`` run in
interpret mode, as the JAX package's own tests run it; the fold and the
parameter pack against the JAX package's; the fused tail against the
unfused modules; and the kernel's launch plans: the variant each shape
takes, their shared memory, the 16-byte preconditions of the bulk copies,
and a walk of each plan (the kernel's item and row arithmetic, in Python)
that covers every output row once and computes what the plain version
computes; and the plain version's range over the roundings of a bf16
intermediate at a tie, which the checks on the card hold the kernel to.
The CUDA kernel itself is checked against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.ops.pallas import dw_chain as jdw
from sod100k_tpu_torch.ops import dw_chain
from sod100k_tpu_torch.ops.goct import SimplifiedGOctCBR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_params(rng, c):
    """Taps (3, 3, C) and scale/shift/alpha (C,), the JAX test's recipe."""
    return (rng.standard_normal((3, 3, c), dtype=np.float32) * 0.1,
            rng.random(c).astype(np.float32) + 0.5,
            rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32) * 0.25)


def _torch_params(p):
    """JAX layout -> the port's: taps (3, 3, C) -> (C, 3, 3)."""
    w, s, b, a = (torch.from_numpy(v) for v in p)
    return w.permute(2, 0, 1).contiguous(), s, b, a


@pytest.mark.parametrize("shape", [(2, 40, 36, 13), (1, 17, 23, 5)])
def test_fused_dw_chain_ref_matches_pallas_interpret(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape, dtype=np.float32)
    p1, p2 = _chain_params(rng, shape[3]), _chain_params(rng, shape[3])
    want = jdw.fused_dw_chain(jnp.asarray(x), *map(jnp.asarray, p1),
                              *map(jnp.asarray, p2), interpret=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = dw_chain.fused_dw_chain_ref(xt, *_torch_params(p1),
                                      *_torch_params(p2))
    # the JAX package's bar for this kernel (test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=2e-5)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 7), dtype=np.float32))
    params = (*_torch_params(_chain_params(rng, 6)),
              *_torch_params(_chain_params(rng, 6)))
    before = dw_chain.launches
    got = dw_chain.fused_dw_chain(x, *params)
    assert dw_chain.launches == before
    torch.testing.assert_close(got, dw_chain.fused_dw_chain_ref(x, *params),
                               rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 2, 4, 4), device="meta")
    p = (torch.empty((2, 3, 3), device="meta"),
         *(torch.empty(2, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        dw_chain.fused_dw_chain(x, *p, *p)


def test_fold_bn_eval_matches_jax():
    rng = np.random.default_rng(11)
    c = 9
    bn = torch.nn.BatchNorm2d(c)
    vals = {"weight": rng.standard_normal(c), "bias": rng.standard_normal(c),
            "running_mean": rng.standard_normal(c),
            "running_var": rng.random(c) + 0.2}
    with torch.no_grad():
        for k, v in vals.items():
            getattr(bn, k).copy_(torch.from_numpy(v.astype(np.float32)))
    s, b = dw_chain.fold_bn_eval(bn)
    js, jb = jdw.fold_bn_eval({
        "scale": jnp.asarray(bn.weight.detach().numpy()),
        "offset": jnp.asarray(bn.bias.detach().numpy()),
        "mean": jnp.asarray(bn.running_mean.numpy()),
        "var": jnp.asarray(bn.running_var.numpy())})
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_dw_tail_fused_matches_unfused_modules():
    """The eval-mode fused tail computes what the two unfused stages compute
    (the port's version of test_csnet_pallas_path_matches_default)."""
    split = (5, 0, 3)
    rng = np.random.default_rng(12)
    stages = [SimplifiedGOctCBR(split), SimplifiedGOctCBR(split)]
    with torch.no_grad():
        for m in stages:
            for name, t in m.state_dict().items():
                if name.endswith("num_batches_tracked"):
                    continue
                v = rng.standard_normal(t.shape) * (0.01 if t.dim() == 4
                                                    else 0.5)
                if name.endswith("running_var"):
                    v = np.abs(v) + 0.5
                t.copy_(torch.from_numpy(v.astype(np.float32)))
            m.eval()
    xset = [torch.from_numpy(rng.standard_normal((2, 5, 16, 12),
                                                 dtype=np.float32)),
            None,
            torch.from_numpy(rng.standard_normal((2, 3, 4, 3),
                                                 dtype=np.float32))]
    with torch.no_grad():
        got = dw_chain.dw_tail_fused(
            xset, dw_chain.pack_tail(stages[0], stages[1]))
        want = stages[1](stages[0](xset))
    assert got[1] is None and want[1] is None
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)


def test_pack_matches_jax_prep():
    """The (C, 24) pack against the JAX package's own ``prep`` in
    ``dw_tail_fused``: taps x100 and ``fold_bn_eval``, on the same weights."""
    rng = np.random.default_rng(13)
    split = (6, 0, 4)
    stages = [SimplifiedGOctCBR(split), SimplifiedGOctCBR(split)]
    jparams = []
    with torch.no_grad():
        for m in stages:
            jp = {"convs": {}, "bns": {}, "prelus": {}}
            for key, conv in m.convs.items():
                c = conv.weight.shape[0]
                k = rng.standard_normal((3, 3, 1, c)).astype(np.float32) * 0.01
                conv.weight.copy_(torch.from_numpy(
                    k[:, :, 0, :].transpose(2, 0, 1)[:, None].copy()))
                bn = {"scale": rng.standard_normal(c), "offset":
                      rng.standard_normal(c), "mean": rng.standard_normal(c),
                      "var": rng.random(c) + 0.2}
                bn = {k2: v.astype(np.float32) for k2, v in bn.items()}
                for name, k2 in (("weight", "scale"), ("bias", "offset"),
                                 ("running_mean", "mean"),
                                 ("running_var", "var")):
                    getattr(m.bns[key], name).copy_(torch.from_numpy(bn[k2]))
                alpha = rng.standard_normal(c).astype(np.float32) * 0.25
                m.prelus[key].weight.copy_(torch.from_numpy(alpha))
                jp["convs"][key] = {"kernel": jnp.asarray(k)}
                jp["bns"][key] = {k2: jnp.asarray(v) for k2, v in bn.items()}
                jp["prelus"][key] = {"alpha": jnp.asarray(alpha)}
            jparams.append(jp)
    packs = dw_chain.pack_tail(*stages)
    assert packs[1] is None
    for key in ("0", "2"):
        want = []
        for jp in jparams:  # sod100k_tpu/ops/pallas/dw_chain.py prep()
            k = jp["convs"][key]["kernel"]
            w = k[:, :, 0, :].astype(jnp.float32) * 100.0
            s, b = jdw.fold_bn_eval(jp["bns"][key])
            want += [np.asarray(w).transpose(2, 0, 1).reshape(-1, 9),
                     np.asarray(s)[:, None], np.asarray(b)[:, None],
                     np.asarray(jp["prelus"][key]["alpha"])[:, None]]
        got = packs[int(key)].detach()
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.concatenate(want, axis=1),
                                   rtol=1e-6, atol=1e-6)
        views = dw_chain.unpack_params(got)
        assert [tuple(v.shape) for v in views] == \
            [(got.shape[0], 3, 3)] + [(got.shape[0],)] * 3 + \
            [(got.shape[0], 3, 3)] + [(got.shape[0],)] * 3


# (H, W, C) of the main path at N=32, and shapes at each variant's edge
MAIN = [(224, 224, 20), (112, 112, 20), (112, 112, 40), (56, 56, 40),
        (112, 112, 80), (56, 56, 80), (28, 28, 80), (14, 14, 80),
        (56, 56, 160), (28, 28, 160)]
EDGES = {  # NCHW: what it exercises
    (3, 9, 14, 14): "odd plane count at 14^2: a bulk group and a short tail",
    (2, 3, 101, 224): "H not a multiple of the band rows",
    (1, 1, 224, 224): "the band path with a single plane",
    (2, 3, 170, 102): "a width whose rows are not 16-byte aligned",
    (2, 13, 40, 36): "ragged (the JAX test's shape)",
    (1, 5, 17, 23): "ragged, odd width",
    (2, 24, 64, 64): "ragged channel count",
}
PLAN_CASES = [((32, c, h, w), dt) for h, w, c in MAIN
              for dt in (torch.float32, torch.bfloat16)]
PLAN_CASES += [(shape, dt) for shape in EDGES
               for dt in (torch.float32, torch.bfloat16)]


def _walk(plan, n, c, h, w):
    """Every (plane, output row) the plan's stage 2 writes, with the checks
    the kernel's buffers need, by the kernel's arithmetic."""
    seen = np.zeros((n * c, h), np.int32)
    slot, mid = dw_chain.buffer_bytes(plan.planes, plan.rows, h, w, 1)  # elements
    for _, p0, np_, y0, rows in dw_chain.plan_items(plan, n, c, h):
        in_lo, in_hi = max(y0 - 2, 0), min(y0 + rows + 2, h)
        m_lo, m_hi = max(y0 - 1, 0), min(y0 + rows + 1, h)
        assert np_ == 1 or (in_lo, in_hi) == (0, h)
        assert ((np_ - 1) * h + in_hi - in_lo) * w <= slot
        assert np_ * (m_hi - m_lo) * w <= mid
        for p, ra, rb in dw_chain.plan_runs(plan, np_, y0, y0 + rows):
            seen[p0 + p, ra:rb] += 1
    return seen


@pytest.mark.parametrize("shape,dtype", PLAN_CASES)
def test_plan_launch(shape, dtype):
    n, c, h, w = shape
    plan = dw_chain.plan_launch(n, c, h, w, dtype)
    elt = torch.finfo(dtype).bits // 8
    plane_bytes = h * w * elt
    # the variant: whole planes up to 32 KB, full-width bands above
    want = "planes" if plane_bytes <= dw_chain.PLANE_BYTES else "band"
    assert plan.variant == want
    if n == 32 and dtype == torch.bfloat16:  # the main path
        if h == 224:
            assert (plan.variant, plan.copy, plan.slots) == ("band", "bulk", 2)
        else:
            assert (plan.variant, plan.slots) == ("planes", 1)
            assert plan.planes == {(112, 20): 1, (112, 40): 1, (112, 80): 1,
                                   (56, 40): 2, (56, 80): 3, (56, 160): 3,
                                   (28, 80): 4, (14, 80): 4,
                                   (28, 160): 9}[h, c]
    assert 0 < plan.smem <= 232448
    assert w % plan.vec == 0 and plan.vec * elt <= 16
    threads = (dw_chain.PLANE_THREADS if plan.variant == "planes"
               else dw_chain.BAND_THREADS)
    assert plan.block[0] == min(w // plan.vec, threads)
    assert plan.block[0] * plan.block[1] <= threads
    assert 1 <= plan.grid <= plan.items
    # the bulk copies' preconditions: every full item is one 16-byte
    # aligned and sized range (a short last group of planes may copy
    # element by element, as the kernel checks per item)
    if plan.copy == "bulk":
        if plan.variant == "band":
            assert (w * elt) % 16 == 0
        else:
            assert (plan.planes * plane_bytes) % 16 == 0
    else:
        assert plan.variant == "band" and (w * elt) % 16 != 0
    seen = _walk(plan, n, c, h, w)
    assert (seen == 1).all()


def _emulate(plan, x, packed):
    """The kernel's algorithm in PyTorch on the CPU: items staged from the
    flat tensor, stage 1 into the intermediate buffer (rounded to x.dtype),
    stage 2 into y, each by the threads' runs of rows."""
    n, c, h, w = x.shape
    flat = x.float().reshape(-1)
    y = torch.full((n * c * h * w,), float("nan"))
    params = packed.numpy()

    def stage(src, slo, shi, src_plane, dst, dst_base, dst_plane, olo, ohi,
              np_, c0, off, dtype):
        for p, ra, rb in dw_chain.plan_runs(plan, np_, olo, ohi):
            q = params[(c0 + p) % c, off:off + 12]
            for gy in range(ra, rb):
                acc = torch.zeros(w)
                for dy in range(3):
                    r = gy - 1 + dy
                    row = torch.zeros(w + 2)
                    if slo <= r < shi:
                        a = p * src_plane + (r - slo) * w
                        row[1:-1] = src[a:a + w]
                    for dx in range(3):
                        acc = acc + row[dx:dx + w] * float(q[dy * 3 + dx])
                v = acc * float(q[9]) + float(q[10])
                v = torch.where(v >= 0, v, v * float(q[11]))
                a = dst_base + p * dst_plane + (gy - olo) * w
                dst[a:a + w] = v.to(dtype).float()

    for _, p0, np_, y0, rows in dw_chain.plan_items(plan, n, c, h):
        in_lo, in_hi = max(y0 - 2, 0), min(y0 + rows + 2, h)
        m_lo, m_hi = max(y0 - 1, 0), min(y0 + rows + 1, h)
        start = (p0 * h + in_lo) * w
        staged = flat[start:start + ((np_ - 1) * h + in_hi - in_lo) * w]
        mid = torch.full((np_ * (m_hi - m_lo) * w,), float("nan"))
        stage(staged, in_lo, in_hi, (in_hi - in_lo) * w, mid, 0,
              (m_hi - m_lo) * w, m_lo, m_hi, np_, p0 % c, 0, x.dtype)
        stage(mid, m_lo, m_hi, (m_hi - m_lo) * w, y, p0 * h * w + y0 * w,
              h * w, y0, y0 + rows, np_, p0 % c, 12, x.dtype)
    return y.reshape(n, c, h, w).to(x.dtype)


def _set_sizes(monkeypatch, sizes, shape, dtype):
    """Set the plan's module sizes so that ``shape`` takes ``sizes`` (rows
    of a band, planes per item, ring slots), with 64 threads a block."""
    n, c, h, w = shape
    elt = torch.finfo(dtype).bits // 8
    consts = {"BAND_THREADS": 64, "PLANE_THREADS": 64}
    if "rows" in sizes:
        consts.update(PLANE_BYTES=0, BAND_BYTES=(sizes["rows"] + 4) * w * elt)
    if "planes" in sizes:
        consts.update(ITEM_BYTES=sizes["planes"] * h * w * elt,
                      ITEMS_PER_SM=1)
    if "slots" in sizes:
        consts.update(BAND_SLOTS=sizes["slots"], PLANE_SLOTS=sizes["slots"])
    for k, v in consts.items():
        monkeypatch.setattr(dw_chain, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sizes", [
    ((3, 9, 14, 14), {}), ((2, 3, 101, 224), {}), ((1, 2, 40, 36), {}),
    ((1, 5, 17, 23), {}), ((2, 3, 21, 16), {"rows": 4}),
    ((1, 3, 9, 8), {"rows": 1}), ((4, 3, 6, 10), {"planes": 4}),
    ((2, 3, 21, 16), {"rows": 5, "slots": 1}), ((1, 2, 170, 102), {}),
])
def test_plan_walk_computes_the_plain_function(shape, sizes, dtype,
                                               monkeypatch):
    """One block walks every item (a grid of 1): the walk replays the
    kernel's arithmetic and computes the plain function."""
    rng = np.random.default_rng(21)
    n, c, h, w = shape
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    x = x.to(dtype)
    params = (*_torch_params(_chain_params(rng, c)),
              *_torch_params(_chain_params(rng, c)))
    _set_sizes(monkeypatch, sizes, shape, dtype)
    plan = dw_chain.plan_launch(n, c, h, w, dtype, blocks_per_sm=1,
                                sm_count=1)
    assert {k: getattr(plan, k) for k in sizes} == sizes
    assert plan.grid == 1
    got = _emulate(plan, x, dw_chain.pack_params(*params))
    want = dw_chain.fused_dw_chain_ref(x, *params)
    tol = (dict(rtol=0, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_plan_launch_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dw_chain.plan_launch(1, 1, 8, 8, torch.float16)
    with pytest.raises(ValueError, match="shared memory"):
        dw_chain.plan_launch(1, 1, 64, 20000, torch.float32)
    with pytest.raises(ValueError, match="cannot launch"):
        dw_chain.plan_launch(1, 0, 8, 8, torch.float32)
    with pytest.raises(ValueError, match="cannot launch"):
        dw_chain.plan_launch(2 ** 16, 2 ** 15, 8, 8, torch.float32)


def _range_inputs(dtype, seed=22, shape=(2, 6, 96, 96)):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    params = (*_torch_params(_chain_params(rng, shape[1])),
              *_torch_params(_chain_params(rng, shape[1])))
    return x.to(dtype), params


def test_ref_range_is_the_plain_version_away_from_ties():
    x, params = _range_inputs(torch.float32)
    lo, hi, ties = dw_chain.fused_dw_chain_ref_range(x, *params)
    want = dw_chain.fused_dw_chain_ref(x, *params)
    assert ties == 0
    torch.testing.assert_close(lo, want, rtol=0, atol=0)
    torch.testing.assert_close(hi, want, rtol=0, atol=0)
    xb, params = _range_inputs(torch.bfloat16)
    lo, hi, ties = dw_chain.fused_dw_chain_ref_range(xb, *params)
    want = dw_chain.fused_dw_chain_ref(xb, *params)
    assert lo.dtype == hi.dtype == torch.bfloat16
    assert 0 < ties < xb.numel() // 100
    assert (lo <= want).all() and (want <= hi).all()
    # lo == hi except within a 3x3 reach of a tie
    assert 0 < int((lo != hi).sum()) <= 9 * ties


def test_ref_range_holds_another_summation_order():
    """Stage 1 summed in float64, as a kernel with another order may round
    its intermediate: the check passes, at the unchanged bars; a result
    from other taps fails it."""
    x, (w1, s1, b1, a1, w2, s2, b2, a2) = _range_inputs(torch.bfloat16)
    c = x.shape[1]
    t = x.double()
    t = torch.nn.functional.conv2d(t, w1.double().reshape(c, 1, 3, 3),
                                   padding=1, groups=c)
    t = t * s1.double().view(1, c, 1, 1) + b1.double().view(1, c, 1, 1)
    t = torch.where(t >= 0, t, t * a1.double().view(1, c, 1, 1))
    t = t.to(torch.bfloat16)
    ident = torch.zeros(c, 3, 3)
    ident[:, 1, 1] = 1.0
    one, zero = torch.ones(c), torch.zeros(c)
    params = (w1, s1, b1, a1, w2, s2, b2, a2)
    # the second stage alone, on the float64-order intermediate
    got = dw_chain.fused_dw_chain_ref(t, ident, one, zero, one,
                                      w2, s2, b2, a2)
    flips = int((t != dw_chain.fused_dw_chain_ref(
        x, w1, s1, b1, a1, ident, one, zero, one)).sum())
    assert flips > 0  # the float64 order rounds some ties the other way
    err, ties = dw_chain.check_against_plain(got, x, params,
                                             rtol=2 ** -7, atol=1e-3)
    assert ties >= flips
    bad = dw_chain.fused_dw_chain_ref(x, w1, s1, b1, a1, w2 * 1.05, s2, b2,
                                      a2)
    with pytest.raises(AssertionError, match="over the bar"):
        dw_chain.check_against_plain(bad, x, params, rtol=2 ** -7, atol=1e-3)
