"""Bilinear resize (align_corners=False, no antialias): CUDA kernel, its
plain version, the caller.

Replaces no TPU kernel: the JAX package resizes with ``jax.image.resize``,
which XLA fuses. On the card the port resized through ``F.interpolate``,
whose NCHW forward gives one thread to each output pixel and walks every
(n, c) plane inside it; CSF+Res2Net's head ran it at 2% of its bytes
roofline. The kernel (``csrc/resize_bilinear.cu``, ``resize_bilinear_nchw``)
gives every output element a thread (a run of up to 16 bytes along W) and
splits the planes over the grid; its design is in the source.

``interpolate(x, size=..., scale_factor=...)`` takes ``F.interpolate``'s
sizing and returns its numbers bit for bit: the scale in the accumulate
type (f32; f64 for f64 maps), ATen's source indices and weights, its blend
with the roundings of ATen's build. The output has the memory format
``F.interpolate`` gives it; where its shape is the input's, ``x`` itself
is returned. A CPU tensor goes to ``F.interpolate``; a CUDA tensor
launches the kernel or raises. With a gradient to take, the kernel runs
inside ``Bilinear``, whose backward is ATen's
``upsample_bilinear2d_backward`` with the arguments ``F.interpolate``'s
autograd gives it; without one (serving under ``no_grad`` or
``inference_mode``) the kernel is called directly. ``interpolate`` takes
part in ``__torch_function__`` modes as ``F.interpolate`` does.

``bilinear_ref`` is the plain version: the same tables and blend in torch
ops, products unfused, so within a few roundings of the kernel;
``check_against_plain`` holds the kernel to it. ``launches`` counts kernel
launches, so a run can show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function_unary

from . import cuda_lib

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}
# The launch's sizes (chip_smoke.py times them at the main path's shapes)
THREADS = 256            # threads per block (at most)
PLANES_PER_THREAD = 8    # planes a thread takes once the card is full
MIN_BLOCKS_PER_SM = 4    # the grid fills this many blocks an SM first
MAX_GRID_Z = 65535
INT32_MAX = 2 ** 31 - 1


def output_geometry(shape, size=None, scale_factor=None):
    """((h_out, w_out), (scale_h, scale_w)) as ``F.interpolate`` sizes a
    4-D ``shape``: ``size`` an int or a pair; ``scale_factor`` a number or
    a pair, kept as the op's scales (None for a size)."""
    if (size is None) == (scale_factor is None):
        raise ValueError("give exactly one of size or scale_factor")
    if size is not None:
        hw = (size, size) if isinstance(size, int) else tuple(size)
        if len(hw) != 2:
            raise ValueError(f"size must be an int or a pair, got {size}")
        return (int(hw[0]), int(hw[1])), (None, None)
    sf = (scale_factor if isinstance(scale_factor, (tuple, list))
          else (scale_factor, scale_factor))
    if len(sf) != 2:
        raise ValueError(f"scale_factor must be a number or a pair, got "
                         f"{scale_factor}")
    sf = (float(sf[0]), float(sf[1]))
    # ATen's compute_output_size: int64(in * scale), in double
    return (int(shape[2] * sf[0]), int(shape[3] * sf[1])), sf


def source_scale(n_in: int, n_out: int, factor, dtype: torch.dtype) -> float:
    """ATen's ``compute_scales_value`` in the accumulate type of ``dtype``
    (f64 for f64, else f32): (A)(1 / factor) for a scale factor, (A)in /
    out for a size."""
    if dtype == torch.float64:
        return 1.0 / factor if factor is not None and factor > 0 \
            else n_in / n_out
    if factor is not None and factor > 0:
        return float(np.float32(1.0 / factor))
    return float(np.float32(n_in) / np.float32(n_out))


def channels_last(shape, strides) -> bool:
    """Whether ``F.interpolate`` gives a map of these shape and strides a
    channels-last output: ATen's ``is_channels_last_strides_2d``, the test
    behind ``suggest_memory_format`` (torch's Python copy of it imports
    sympy, seconds at a process's first resize)."""
    if strides[1] == 0:
        return False
    low = 0
    for d in (1, 3, 2, 0):
        if shape[d] == 0 or strides[d] < low or (d == 0
                                                 and low == strides[1]):
            return False
        low = strides[d] * shape[d]
    return True


def _layout(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if channels_last(x.shape, x.stride())
            else torch.contiguous_format)


# ---------------------------------------------------------------------------
# The plain version


def _axis(n_in: int, n_out: int, scale: float, acc: torch.dtype, device):
    """(i0, i1, l0, l1) of every output index along one axis."""
    o = torch.arange(n_out, dtype=acc, device=device)
    src = (scale * (o + 0.5) - 0.5).clamp_min(0)
    i0 = src.to(torch.int64)
    i1 = i0 + (i0 < n_in - 1).to(torch.int64)
    l1 = src - i0.to(acc)
    return i0, i1, 1 - l1, l1


def bilinear_ref(x: torch.Tensor, out_hw, scales=(None, None)) -> torch.Tensor:
    """The kernel's function in plain torch ops: gathers of the source
    rows and columns and the blend in the accumulate type, then one
    rounding to x.dtype. Products are not fused, so a value may sit a few
    roundings from the kernel's (``check_against_plain``)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    h_out, w_out = out_hw
    r0, r1, h0, h1 = _axis(x.shape[2], h_out,
                           source_scale(x.shape[2], h_out, scales[0], x.dtype),
                           acc, x.device)
    c0, c1, w0, w1 = _axis(x.shape[3], w_out,
                           source_scale(x.shape[3], w_out, scales[1], x.dtype),
                           acc, x.device)
    t = x.to(acc)

    def row(r):
        v = t.index_select(2, r)
        return w0 * v.index_select(3, c0) + w1 * v.index_select(3, c1)

    y = h0.view(-1, 1) * row(r0) + h1.view(-1, 1) * row(r1)
    return y.to(x.dtype).contiguous(memory_format=_layout(x))


def check_against_plain(got: torch.Tensor, x: torch.Tensor, out_hw,
                        scales=(None, None)) -> float:
    """Raise AssertionError unless ``got`` lies within the plain version's
    roundings: 8 + 2 max(H, W) roundings of the accumulate type at the
    input's largest magnitude (the products; a source index's rounding at
    its own magnitude), plus one of x.dtype at the value (two f32 sums
    rounded to bf16 or f16 may land on either side of a tie). Returns the
    largest distance."""
    want = bilinear_ref(x, out_hw, scales)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    d = (got.to(acc) - want.to(acc)).abs()
    # a source index rounds at its own magnitude (up to the input's size),
    # so a weight may move by that many roundings
    span = 8 + 2 * max(x.shape[2], x.shape[3])
    bar = (span * torch.finfo(acc).eps * float(x.abs().max())
           + torch.finfo(x.dtype).eps * want.to(acc).abs())
    bad = d > bar
    if bad.any():
        i = int(torch.argmax(d - bar))
        raise AssertionError(
            f"{int(bad.sum())} of {d.numel()} outputs off the plain version; "
            f"worst {got.flatten()[i].item()} against "
            f"{want.flatten()[i].item()}")
    return float(d.max())


# ---------------------------------------------------------------------------
# The launch plan


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """``vec`` outputs a thread along W; ``block`` (x, y) threads over
    runs and rows; ``grid`` (x, y, z) blocks over runs, rows and planes."""
    vec: int
    block: tuple[int, int]
    grid: tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_launch(n: int, c: int, h_out: int, w_out: int, vec: int, *,
                sm_count: int = 132) -> LaunchPlan:
    """The kernel's launch for an (n, c, h_out, w_out) output at ``vec``
    outputs a thread, from the sizes above: the grid's z axis splits the
    planes until every thread takes at most ``PLANES_PER_THREAD`` of them,
    or until there are ``MIN_BLOCKS_PER_SM`` blocks an SM."""
    if min(n, c, h_out, w_out) < 1 or w_out % vec:
        raise ValueError(f"resize cannot launch on output {(n, c, h_out, w_out)}"
                         f" at {vec} a thread")
    runs = w_out // vec
    bx = min(runs, THREADS)
    by = max(1, min(h_out, THREADS // bx))
    gx, gy = _cdiv(runs, bx), _cdiv(h_out, by)
    planes = n * c
    gz = max(_cdiv(planes, PLANES_PER_THREAD),
             _cdiv(MIN_BLOCKS_PER_SM * sm_count, gx * gy))
    return LaunchPlan(vec, (bx, by), (gx, gy, max(1, min(gz, planes,
                                                          MAX_GRID_Z))))


def vector_width(w_out: int, out_strides, elt: int) -> int:
    """The widest run of outputs a thread stores at once: 16 bytes where
    the output's W is contiguous and every run starts 16-byte aligned (the
    output is fresh from the caching allocator, whose blocks are 512-byte
    aligned; the kernel checks), else less."""
    for v in (8, 4, 2):
        if v * elt <= 16 and out_strides[3] == 1 and w_out % v == 0 \
                and all(s % v == 0 for s in out_strides[:3]):
            return v
    return 1


# ---------------------------------------------------------------------------
# The kernel's callers


@functools.cache
def _lib():
    """The built kernel's C entry point, with its argument types."""
    lib = cuda_lib.load("resize_bilinear")
    lib.sod_resize_bilinear.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_double,
                                        ctypes.c_double, ctypes.c_void_p]
    lib.sod_resize_bilinear.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=512)
def _call(shape, x_strides, dtype, out_hw, scales, index):
    """(memory format of the output, the C entry point's 20 int64
    arguments, scale_h, scale_w) for one kind of call, checked once. A float32 or
    float64 channels-last map of 16 or more channels takes the roundings
    of ATen's channels-last kernel, which ATen runs there (its bf16 and
    f16 builds round as its NCHW kernel); any other map those of its NCHW
    kernel."""
    if len(shape) != 4:
        raise ValueError(f"resize expects (N, C, H, W), got shape {shape}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"resize takes float32, bfloat16, float16 or float64,"
                        f" got {dtype}")
    n, c, h, w = shape
    if min(h, w, *out_hw) < 1:
        raise ValueError(f"resize of {shape} to {out_hw}: sizes must be "
                         f"positive")
    if (h - 1) * x_strides[2] + (w - 1) * x_strides[3] > INT32_MAX:
        raise ValueError("resize: a plane spans more than 2^31 elements")
    ho, wo = out_hw
    if channels_last(shape, x_strides):
        fmt, y_strides = torch.channels_last, (ho * wo * c, 1, wo * c, c)
    else:
        fmt, y_strides = torch.contiguous_format, (c * ho * wo, ho * wo, wo, 1)
    vec = vector_width(out_hw[1], y_strides, dtype.itemsize)
    plan = plan_launch(max(n, 1), max(c, 1), *out_hw, vec,
                       sm_count=_sm_count(index))
    nhwc = (fmt == torch.channels_last and c >= 16
            and dtype in (torch.float32, torch.float64))
    args = (ctypes.c_longlong * 20)(
        n, c, h, w, *out_hw, *x_strides, *y_strides, _DTYPE_CODE[dtype],
        plan.vec, *plan.block, plan.grid[2], int(nhwc))
    return (fmt, args, source_scale(h, out_hw[0], scales[0], dtype),
            source_scale(w, out_hw[1], scales[1], dtype))


def launch(x: torch.Tensor, out_hw, scales=(None, None)) -> torch.Tensor:
    """One kernel launch on the current stream (no gradient); counted in
    ``launches``. ``scales`` are the op's scale factors (None for a
    size)."""
    global launches
    index = x.get_device()
    fmt, args, sh, sw = _call(tuple(x.shape), x.stride(), x.dtype,
                              tuple(out_hw), tuple(scales), index)
    n, c = x.shape[:2]
    y = torch.empty((n, c, *out_hw), dtype=x.dtype, device=x.device,
                    memory_format=fmt)
    if n * c == 0:
        return y
    # the current stream's raw handle (torch.cuda.current_stream() builds a
    # Python object: several microseconds of host time per call)
    err = _lib().sod_resize_bilinear(
        x.data_ptr(), y.data_ptr(), args, sh, sw,
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"resize kernel launch failed: CUDA error {err}")
    launches += 1
    return y


class Bilinear(torch.autograd.Function):
    """The kernel forward; ATen's own backward with ``F.interpolate``'s
    arguments (output size, input size, align_corners=False, its scales)."""

    @staticmethod
    def forward(ctx, x, out_hw, scales):
        ctx.shape, ctx.out_hw, ctx.scales = tuple(x.shape), out_hw, scales
        return launch(x, out_hw, scales)

    @staticmethod
    def backward(ctx, g):
        return torch.ops.aten.upsample_bilinear2d_backward(
            g, ctx.out_hw, ctx.shape, False, *ctx.scales), None, None


def interpolate(x: torch.Tensor, size=None, scale_factor=None) -> torch.Tensor:
    """``F.interpolate(x, size=size, scale_factor=scale_factor,
    mode="bilinear", align_corners=False)``: on the CPU that call, on the
    card the kernel (see the module's docstring)."""
    if has_torch_function_unary(x):
        return handle_torch_function(interpolate, (x,), x, size=size,
                                     scale_factor=scale_factor)
    if x.dim() != 4:
        raise ValueError(f"resize expects (N, C, H, W), got shape "
                         f"{tuple(x.shape)}")
    out_hw, scales = output_geometry(x.shape, size, scale_factor)
    if out_hw == tuple(x.shape[2:]):
        return x
    if x.device.type == "cpu":
        return F.interpolate(x, size=size, scale_factor=scale_factor,
                             mode="bilinear", align_corners=False)
    if not x.is_cuda:
        raise ValueError(f"resize runs on cpu or cuda, not {x.device}")
    run = (Bilinear.apply if torch.is_grad_enabled() and x.requires_grad
           else launch)
    index = x.get_device()
    if index == torch._C._cuda_getDevice():
        return run(x, out_hw, scales)
    with torch.cuda.device(index):
        return run(x, out_hw, scales)
