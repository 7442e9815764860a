"""The bilinear resize kernel (``ops/resize_kernel.py``,
``csrc/resize_bilinear.cu``).

On the CPU: the wrapper is ``F.interpolate`` bit for bit (its CPU path),
sizes its output as ``F.interpolate`` does, refuses what the kernel does
not take, returns the input where the shape does not change; the plain
version lies within its bar of ``F.interpolate``; the autograd
``Function`` hands ATen's backward ``F.interpolate``'s arguments; the
launch plan covers every output; importing builds nothing.

On the card (``gpu`` marker; skips without one): the kernel is bit-equal
to ``F.interpolate`` at every resize of a CSF+Res2Net-50 served forward
at 336^2 (B = 1 and 8) and of a CSNet-L-x2 train forward at 224^2
(B = 24), shapes read off the ``ops.resize`` spans, in f32, bf16, f16 and
f64, on a sliced row band and on channels-last maps; the ``Function``'s
input gradient is ATen's; ``launches`` grows by 16 over one CSF forward;
a whole CSF served forward gives the same bits with ``F.interpolate`` put
back. Imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_resize_kernel.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sod100k_tpu_torch.ops import resize_kernel as rk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]

# (input shape, size, scale_factor): up and down, by factor and by size
CASES = [
    ((2, 3, 11, 11), None, 2),
    ((2, 3, 21, 21), None, 4),
    ((1, 2, 7, 9), None, (1.5, 0.7)),
    ((2, 3, 84, 84), (42, 42), None),
    ((2, 3, 84, 84), (11, 11), None),
    ((2, 4, 11, 11), (21, 21), None),
    ((1, 1, 84, 84), (336, 336), None),
    ((2, 3, 37, 45), (16, 91), None),
]


def _ref(x, size=None, scale_factor=None):
    return F.interpolate(x, size=size, scale_factor=scale_factor,
                         mode="bilinear", align_corners=False)


def _randn(shape, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# On the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,size,factor", CASES)
def test_cpu_path_is_f_interpolate(shape, size, factor, dtype):
    x = _randn(shape, dtype)
    got = rk.interpolate(x, size=size, scale_factor=factor)
    want = _ref(x, size, factor)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,size,factor", CASES + [
    ((1, 1, 7, 7), None, 1.7), ((1, 1, 10, 3), None, (0.35, 3.34)),
    ((1, 1, 5, 6), 9, None)])
def test_output_geometry_is_f_interpolates(shape, size, factor):
    (h, w), scales = rk.output_geometry(shape, size, factor)
    assert (h, w) == tuple(_ref(torch.zeros(shape), size, factor).shape[2:])
    assert scales == ((None, None) if factor is None else tuple(
        float(f) for f in (factor if isinstance(factor, tuple)
                           else (factor, factor))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape,size,factor", CASES)
def test_plain_version_within_its_bar_of_f_interpolate(shape, size, factor,
                                                       dtype):
    """The plain version's source tables and scales are ATen's: the CPU's
    own bilinear kernel lies within the plain version's bar."""
    x = _randn(shape, dtype, seed=1)
    out_hw, scales = rk.output_geometry(shape, size, factor)
    rk.check_against_plain(_ref(x, size, factor), x, out_hw, scales)


def test_the_bar_sees_a_wrong_scale():
    x = _randn((1, 2, 11, 11), torch.float32)
    wrong = _ref(x, (21, 21))
    with pytest.raises(AssertionError):
        rk.check_against_plain(wrong, x, (21, 21), (2.0, 2.0))


def test_refusals_and_the_unchanged_shape():
    x = torch.zeros(2, 3, 8, 8)
    for bad in (torch.zeros(3, 8, 8), torch.zeros(1, 2, 3, 8, 8)):
        with pytest.raises(ValueError, match="expects"):
            rk.interpolate(bad, size=(4, 4))
    with pytest.raises(ValueError, match="exactly one"):
        rk.interpolate(x, size=(4, 4), scale_factor=2)
    with pytest.raises(ValueError, match="exactly one"):
        rk.interpolate(x)
    assert rk.interpolate(x, size=(8, 8)) is x
    assert rk.interpolate(x, scale_factor=1) is x
    with pytest.raises(ValueError, match="resize cannot launch"):
        rk.plan_launch(2, 3, 8, 10, 4)


def test_import_builds_nothing():
    """Importing the wrapper and the ops that call it, and a CPU resize
    through them, call no compiler and load no library; a card call's
    arguments import nothing heavy (torch's Python memory-format test
    imports sympy: seconds of a serving set-up on the card)."""
    code = (
        "import subprocess, sys, torch\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "from sod100k_tpu_torch.ops import resize_kernel, resample\n"
        "import sod100k_tpu_torch.arch.csf_res2net\n"
        "resample.resize_bilinear(torch.zeros(1, 2, 8, 8), (5, 5))\n"
        "assert not calls, calls\n"
        "assert resize_kernel._lib.cache_info().currsize == 0\n"
        "assert resize_kernel.launches == 0\n"
        "resize_kernel._sm_count = lambda index: 132\n"
        "x = torch.zeros(2, 3, 8, 8).contiguous(\n"
        "    memory_format=torch.channels_last)\n"
        "resize_kernel._call(tuple(x.shape), x.stride(), x.dtype, (5, 5),\n"
        "                    (None, None), 0)\n"
        "assert 'sympy' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("shape,size,factor", CASES)
def test_backward_gets_f_interpolates_arguments(shape, size, factor,
                                                monkeypatch):
    """``Bilinear`` with ATen's CPU forward in the kernel's place: its
    input gradient is ``F.interpolate``'s bit for bit (the CPU's backward
    is deterministic), so it hands ATen's backward the same output size,
    input size and scales."""
    monkeypatch.setattr(rk, "launch", lambda x, hw, s: torch.ops.aten
                        .upsample_bilinear2d(x, hw, False, *s))
    x = _randn(shape, torch.float64, seed=2)
    out_hw, scales = rk.output_geometry(shape, size, factor)
    g = _randn((shape[0], shape[1], *out_hw), torch.float64, seed=3)
    a = x.clone().requires_grad_()
    rk.Bilinear.apply(a, out_hw, scales).backward(g)
    b = x.clone().requires_grad_()
    _ref(b, size, factor).backward(g)
    assert torch.equal(a.grad, b.grad)


def test_channels_last_is_atens_test():
    from torch._prims_common import suggest_memory_format

    full = torch.zeros(2, 3, 4, 5)
    cl = full.contiguous(memory_format=torch.channels_last)
    maps = [full, cl, cl[:, :, 1:3], full[:, :, 1:3], cl[:, :, :, 1:4],
            full.transpose(2, 3), cl.transpose(2, 3), full[:, :1],
            full[:, :1].contiguous(memory_format=torch.channels_last),
            full[:, :, :1, :1], cl[:, :, :1, :1], full[:1], cl[:1],
            torch.zeros(2, 1, 4, 5).expand(2, 3, 4, 5),
            torch.zeros(2, 4, 5, 1).permute(0, 3, 1, 2).expand(2, 3, 4, 5),
            torch.zeros(1, 1, 1, 1), torch.zeros(3, 1, 1, 1),
            torch.zeros(4, 5, 2, 3).permute(2, 3, 0, 1)]
    for x in maps:
        want = suggest_memory_format(x) == torch.channels_last
        assert rk.channels_last(x.shape, x.stride()) == want, (x.shape,
                                                               x.stride())


def test_launch_arguments_follow_f_interpolates_layout(monkeypatch):
    """The C call's shape and strides: the input's as they are (no copy),
    the output's those ``F.interpolate`` gives (contiguous, or channels-last
    for a channels-last map); ATen's channels-last roundings where ATen
    runs its channels-last kernel (16 or more channels); bad inputs are
    refused before a launch."""
    monkeypatch.setattr(rk, "_sm_count", lambda index: 132)
    full = torch.zeros(2, 24, 84, 84)
    cl = full.contiguous(memory_format=torch.channels_last)
    for x, out_hw, nhwc in [
            (full, (42, 42), 0), (full[:, :, 10:50], (20, 42), 0),
            (cl, (11, 11), 1), (cl[:, :, 5:40], (84, 84), 1),
            (full[:, :3].contiguous(memory_format=torch.channels_last),
             (21, 21), 0)]:
        fmt, args, sh, sw = rk._call(tuple(x.shape), x.stride(), x.dtype,
                                     out_hw, (None, None), 0)
        want = _ref(x, out_hw)
        assert tuple(args[:6]) == (*x.shape, *out_hw)
        assert tuple(args[6:10]) == x.stride()
        assert tuple(args[10:14]) == want.stride()
        assert (sh, sw) == (np.float32(x.shape[2]) / np.float32(out_hw[0]),
                            np.float32(x.shape[3]) / np.float32(out_hw[1]))
        assert args[19] == nhwc
        vec = args[15]
        assert vec == (4 if want.stride()[3] == 1 and out_hw[1] % 4 == 0
                       else 2 if want.stride()[3] == 1 and out_hw[1] % 2 == 0
                       else 1)
    assert rk._call((1, 2, 5, 5), (50, 25, 5, 1), torch.float64, (10, 10),
                    (2.0, 2.0), 0)[2:] == (0.5, 0.5)
    # ATen's half-precision channels-last builds round as its NCHW kernel
    assert rk._call(tuple(cl.shape), cl.stride(), torch.bfloat16, (11, 11),
                    (None, None), 0)[1][19] == 0
    for bad, err in [(((2, 8, 8), (64, 8, 1), torch.float32), ValueError),
                     (((1, 1, 8, 8), (64, 64, 8, 1), torch.int32), TypeError),
                     (((1, 1, 0, 8), (8, 8, 8, 1), torch.float32),
                      ValueError)]:
        with pytest.raises(err):
            rk._call(*bad, (4, 4), (None, None), 0)


@pytest.mark.parametrize("out", [(1, 1, 336, 336), (8, 1408, 84, 84),
                                 (8, 256, 11, 11), (1, 1024, 11, 11),
                                 (24, 20, 224, 224), (3, 5, 7, 1000),
                                 (40000, 2, 3, 4)])
@pytest.mark.parametrize("elt", [2, 4, 8])
def test_launch_plan_covers_every_output(out, elt):
    n, c, h, w = out
    strides = (c * h * w, h * w, w, 1)
    vec = rk.vector_width(w, strides, elt)
    assert 16 % (vec * elt) == 0 and w % vec == 0
    assert vec == max(v for v in (1, 2, 4, 8) if v * elt <= 16 and w % v == 0)
    plan = rk.plan_launch(n, c, h, w, vec)
    (bx, by), (gx, gy, gz) = plan.block, plan.grid
    assert bx * by <= rk.THREADS and gy <= 65535
    assert gx * bx * vec >= w > (gx - 1) * bx * vec
    assert gy * by >= h > (gy - 1) * by
    assert 1 <= gz <= min(n * c, rk.MAX_GRID_Z)
    per_thread = -(-n * c // gz)
    assert per_thread <= rk.PLANES_PER_THREAD or gz == rk.MAX_GRID_Z
    # no vector stores along a non-unit W stride or from rows that do not
    # start aligned
    assert rk.vector_width(w, (h * w, h * w, w, 2), elt) == 1
    assert rk.vector_width(w, (h * w + 1, h * w, w, 1), elt) == 1


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _resize_shapes(run) -> tuple[list, int]:
    """The (input shape, output size) of every ``ops.resize`` span of
    ``run()``, in order, and the kernel's launches over it."""
    from sod100k_tpu_torch.utils import profiler

    before = rk.launches
    profiler.enable()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        profiler.disable()
    spans, _ = profiler.drain()
    return ([(tuple(s.attrs["shape"]), tuple(s.attrs["out_shape"][2:]))
             for s in spans if s.name == "ops.resize"], rk.launches - before)


@pytest.fixture(scope="module")
def forwards(card):
    """Resize shapes and launches of a CSF+Res2Net-50 served forward at
    336^2 (B = 1, 8) and a CSNet-L-x2 train forward at 224^2 (B = 24)."""
    from sod100k_tpu_torch.arch.csf_res2net import CSFNet
    from sod100k_tpu_torch.arch.csnet import CSNet
    from sod100k_tpu_torch.arch.layer_config import init_layers
    from sod100k_tpu_torch.train.step import make_eval_step

    out = {}
    csf = CSFNet("res2net50", seed=0, device=card)
    step = make_eval_step(csf, from_u8=True)
    for b in (1, 8):
        img = torch.randint(0, 256, (b, 336, 336, 3), dtype=torch.uint8)
        out[f"csf-b{b}"] = _resize_shapes(lambda: step(img))
    del csf, step
    csnet = CSNet(init_layers(40, (0.5, 0.5)), seed=0, device=card).train()
    x = torch.randn(24, 224, 224, 3, device=card)
    out["csnet-train-b24"] = _resize_shapes(lambda: csnet(x))
    del csnet
    torch.cuda.empty_cache()
    return out


@pytest.mark.gpu
def test_every_csf_resize_goes_through_the_kernel(forwards):
    for key in ("csf-b1", "csf-b8"):
        shapes, launched = forwards[key]
        assert len(shapes) == 16 and launched == 16, (key, shapes)
        assert shapes[-1][1] == (336, 336)
    shapes, launched = forwards["csnet-train-b24"]
    assert shapes and launched == len(shapes)


def _calls(shape, out_hw):
    """The ways the program sizes a resize of ``shape`` to ``out_hw``: by
    size, and by one integer factor where there is one."""
    calls = [dict(size=out_hw)]
    h, w = shape[2:]
    if out_hw[0] % h == 0 and out_hw[0] // h == out_hw[1] // w \
            and out_hw[1] % w == 0:
        calls.append(dict(scale_factor=out_hw[0] // h))
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("key", ["csf-b1", "csf-b8", "csnet-train-b24"])
def test_kernel_is_f_interpolate_at_the_main_paths_shapes(forwards, card,
                                                          key, dtype):
    shapes = sorted(set(forwards[key][0]))
    bad = []
    for i, (shape, out_hw) in enumerate(shapes):
        x = _randn(shape, torch.float32, card, seed=i).to(dtype)
        for kw in _calls(shape, out_hw):
            got, want = rk.interpolate(x, **kw), _ref(x, **kw)
            if got.stride() != want.stride() or not torch.equal(got, want):
                bad.append((shape, kw, float((got.double() - want.double())
                                             .abs().max())))
            rk.check_against_plain(got, x, *rk.output_geometry(shape, **kw))
        del x
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_a_band_and_on_channels_last(card, dtype):
    """Strided inputs, read without a copy: a row band sliced out of an
    NCHW map, channels-last maps and a band of one (C >= 16 and C < 16:
    ATen's NHWC and NCHW kernels, which round differently); the output has
    ``F.interpolate``'s memory format."""
    full = _randn((2, 64, 84, 84), torch.float32, card).to(dtype)
    cl = full[:, :, :42, :42].contiguous(memory_format=torch.channels_last)
    cl3 = full[:, :3].contiguous(memory_format=torch.channels_last)
    cl15, cl16 = (full[:, :c, :37, :45].contiguous(
        memory_format=torch.channels_last) for c in (15, 16))
    cases = [(full[:, :, 10:50], dict(size=(20, 42))),
             (full[:, :, 10:50], dict(scale_factor=2)),
             (full[:, :, :, 5:66], dict(size=(11, 30))),
             (cl, dict(size=(84, 84))), (cl, dict(size=(11, 11))),
             (cl[:, :, 3:30], dict(size=(21, 21))),
             (cl3, dict(scale_factor=4)), (cl3, dict(size=(21, 50))),
             (cl15, dict(size=(16, 91))), (cl16, dict(size=(16, 91)))]
    for x, kw in cases:
        before = rk.launches
        got, want = rk.interpolate(x, **kw), _ref(x, **kw)
        assert rk.launches == before + 1
        assert got.stride() == want.stride(), (x.stride(), kw)
        assert torch.equal(got, want), (x.shape, x.stride(), kw)


def _exact(shape, out_hw) -> bool:
    """Whether each axis resizes by a power of two, up or down: every
    weight is then a short dyadic fraction, and sums of small-integer
    gradients are exact in any order."""
    def pow2(a, b):
        hi, lo = max(a, b), min(a, b)
        return hi % lo == 0 and (hi // lo) & (hi // lo - 1) == 0
    return all(pow2(i, o) for i, o in zip(shape[2:], out_hw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradient_is_atens(forwards, card, dtype):
    """The ``Function``'s input gradient against ``F.interpolate``'s on
    the same output gradient. ATen's backward adds with atomics in no set
    order: where every weight is a short dyadic fraction and the output
    gradient small integers, every sum is exact and the gradients are
    bit-equal; elsewhere they agree to the reordering of the sums
    (64 roundings of the sum of the terms' magnitudes)."""
    shapes = sorted(set(forwards["csf-b1"][0]
                        + forwards["csnet-train-b24"][0]))
    eps = torch.finfo(dtype).eps
    for i, (shape, out_hw) in enumerate(shapes):
        x = _randn(shape, dtype, card, seed=i)
        rng = np.random.default_rng(100 + i)
        g = torch.from_numpy(rng.integers(-8, 9, (shape[0], shape[1],
                                                  *out_hw))).to(card, dtype)
        for kw in _calls(shape, out_hw):
            a = x.clone().requires_grad_()
            rk.interpolate(a, **kw).backward(g)
            b = x.clone().requires_grad_()
            _ref(b, **kw).backward(g)
            if _exact(shape, out_hw):
                assert torch.equal(a.grad, b.grad), (shape, kw)
            else:
                c = x.clone().requires_grad_()
                _ref(c, **kw).backward(g.abs())
                bar = 64 * eps * c.grad
                assert ((a.grad - b.grad).abs() <= bar).all(), (shape, kw)


@pytest.mark.gpu
def test_served_csf_forward_is_f_interpolates(card, monkeypatch):
    """A whole CSF+Res2Net-50 served forward (B = 2, 336^2, f32, TF32
    off) gives the same bits with the kernel as with ``F.interpolate`` put
    back in the wrapper's place."""
    from sod100k_tpu_torch.arch.csf_res2net import CSFNet
    from sod100k_tpu_torch.train.step import make_eval_step

    model = CSFNet("res2net50", seed=1, device=card)
    step = make_eval_step(model, from_u8=True)
    img = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 336, 336, 3), dtype=np.uint8))
    before = rk.launches
    got = step(img).cpu()
    assert rk.launches == before + 16
    monkeypatch.setattr(rk, "interpolate",
                        lambda x, size=None, scale_factor=None:
                        _ref(x, size, scale_factor))
    want = step(img).cpu()
    assert rk.launches == before + 16
    assert torch.equal(got, want)
