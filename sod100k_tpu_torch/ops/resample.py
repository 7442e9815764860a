"""Spatial resampling for octave feature sets (NCHW).

Port of ``sod100k_tpu/ops/resample.py:79-191``:

- coarse->fine paths upsample bilinearly with half-pixel centers and edge
  clamping (``F.interpolate(mode='bilinear', align_corners=False)``),
- fine->coarse paths max-pool without overlap,
- stride-2 gOctConvs average-pool their input first,
- the CSF dialect resizes between branch shapes of any ratio
  (``resize_bilinear``), and its Res2Net backbone pools with torch's own
  ``nn.MaxPool2d``/``nn.AvgPool2d`` semantics (``max_pool_torch``,
  ``avg_pool_torch``: padding, ceil mode, count_include_pad).

The octave pools are floor mode: trailing rows/columns that do not fill a
window are dropped, as in the JAX package.

Under a ``parallel.spatial.SpatialCtx`` (``spatial=``) each function takes
and returns this rank's band of the rows. The pools fetch the rows of
their windows; padding (-inf for max, zeros for average) and the average's
divisor (``ceil_mode``, ``count_include_pad``) follow the true image edges.
A power-of-two bilinear upsample runs torch's own kernel on a window with
one spare source row on each side (its coordinates are the global ones
shifted by whole rows, exactly in f32); any other ratio computes each
output row's source rows and weights from global coordinates (torch's
half-pixel rule in ATen's arithmetic type, clamped only at the image
edge), fetches them, resamples the columns with ``F.interpolate`` and
blends the rows in that type (f32; f64 for f64 maps).

The general path also computes the power-of-two ratios, a few ulps from
torch's kernel: on the CPU, in unit-scale f32 maps, 2.4e-7 to 3.6e-7 in
the forward at 2x and 4x and up to 5.1e-5 in the input gradient at 16x
(CSF's 21 -> 336). The CPU tests pass with it. On an H100 (NVIDIA H100
80GB HBM3, 700 W; ``chip_smoke.py`` phase 15) it moves the f32 CSNet-L
bands from bit-equal to one process to 3.8e-5 in the logits, and the CSF
micro-step's gradients from 0.816 to 0.906 of the JAX bar (worst: the
stem conv's weight). So the power-of-two case keeps torch's kernel, and
the bands keep one process's numbers.

A bilinear upsample or resize that changes the shape is a span
``ops.resize`` (``utils.profiler``) with its input and output shapes and
itemsize: the bytes of the op's contract, whatever computes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spatial import SpatialCtx, banded, height
from ..utils.profiler import span


def _source_rows(h_in: int, h_out: int, factor: Optional[float], opmath):
    """torch's bilinear source rows and weights for each output row
    (align_corners=False, in ATen's arithmetic type ``opmath``: float64
    for f64 maps, float32 otherwise): i0, i1, l1. ``factor`` is the
    upsample's scale factor, None for a resize to a size."""
    scale = (opmath(1.0 / factor) if factor is not None
             else opmath(h_in) / opmath(h_out))
    o = np.arange(h_out, dtype=opmath)
    src = scale * (o + opmath(0.5)) - opmath(0.5)
    src = np.maximum(src, opmath(0.0))
    i0 = src.astype(np.int64)
    i1 = i0 + (i0 < h_in - 1)
    return i0, i1, (src - i0.astype(opmath)).astype(opmath)


def _bilinear_banded(x: torch.Tensor, h_out: int, w_out: int,
                     factor: Optional[float], sp: SpatialCtx) -> torch.Tensor:
    h_in = height(x)
    # ATen's arithmetic type: f64 maps in f64, the others in f32
    dtype = torch.promote_types(x.dtype, torch.float32)

    def interpolate(t, rows):
        if factor is not None:
            return F.interpolate(t, scale_factor=(rows / t.shape[2],
                                                  factor),
                                 mode="bilinear", align_corners=False)
        return F.interpolate(t, size=(rows, w_out), mode="bilinear",
                             align_corners=False)

    f = h_out // h_in
    if h_out == h_in * f and f & (f - 1) == 0:
        # a power-of-two upsample: a window's source coordinates are the
        # global ones shifted by a whole row, exactly in f32, so torch's
        # own kernel on the window (one spare source row on each side,
        # clamped at the image edge only) gives the global rows bit for bit
        def need(a, b):
            return max(a // f - 1, 0), min(-(-b // f) + 1, h_in)

        def fn(win, a, b):
            lo = need(a, b)[0]
            y = interpolate(win, win.shape[2] * f)
            return y[:, :, a - lo * f:b - lo * f]

        return banded(x, sp, h_out, need, fn)
    i0, i1, l1 = _source_rows(h_in, h_out, factor,
                              np.float64 if dtype == torch.float64
                              else np.float32)

    def fn(win, a, b):
        t = win.to(dtype)
        if w_out != win.shape[3]:
            t = interpolate(t, t.shape[2])
        lo = int(i0[a])
        r0 = torch.as_tensor(i0[a:b] - lo, device=t.device)
        r1 = torch.as_tensor(i1[a:b] - lo, device=t.device)
        w1 = torch.as_tensor(l1[a:b], device=t.device).view(1, 1, -1, 1)
        y = t.index_select(2, r0) * (1 - w1) + t.index_select(2, r1) * w1
        return y.to(x.dtype)

    return banded(x, sp, h_out,
                  lambda a_, b_: (int(i0[a_]), int(i1[b_ - 1]) + 1), fn)


def _tag_resize(s, x: torch.Tensor, y: torch.Tensor) -> None:
    """The ``ops.resize`` span's attributes (a no-op while off)."""
    if s is not None:
        s.set(shape=tuple(x.shape), out_shape=tuple(y.shape),
              itemsize=x.element_size())


def _pooled(h: int, k: int, s: int, p: int, ceil_mode: bool) -> int:
    """torch's pooled size of one axis."""
    span = h + 2 * p - k
    out = (-(-span // s) if ceil_mode else span // s) + 1
    if ceil_mode and (out - 1) * s >= h + p:
        out -= 1
    return out


def _pool_banded(x, sp, k, s, p, ceil_mode, fn, pad_value=0.0):
    h_out = _pooled(height(x), k, s, p, ceil_mode)
    return banded(x, sp, h_out,
                  lambda a, b: (a * s - p, (b - 1) * s - p + k), fn,
                  pad_value=pad_value)


def upsample_bilinear(x: torch.Tensor, factor: int,
                      spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """Bilinear x`factor` upsample, align_corners=False."""
    if factor == 1:
        return x
    with span("ops.resize") as s:
        if spatial is not None:
            y = _bilinear_banded(x, height(x) * factor, x.shape[3] * factor,
                                 float(factor), spatial)
        else:
            y = F.interpolate(x, scale_factor=factor, mode="bilinear",
                              align_corners=False)
        _tag_resize(s, x, y)
    return y


def max_pool(x: torch.Tensor, factor: int,
             spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """Non-overlapping max pool (kernel = stride = factor), floor mode."""
    if factor == 1:
        return x
    if spatial is not None:
        return _pool_banded(x, spatial, factor, factor, 0, False,
                            lambda w, a, b: F.max_pool2d(w, factor, factor))
    return F.max_pool2d(x, factor, factor)


def avg_pool(x: torch.Tensor, factor: int = 2,
             spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """Non-overlapping average pool (kernel = stride = factor), floor mode."""
    if factor == 1:
        return x
    if spatial is not None:
        # floor mode, no padding: every window is whole, in every band
        return _pool_banded(x, spatial, factor, factor, 0, False,
                            lambda w, a, b: F.avg_pool2d(w, factor, factor))
    return F.avg_pool2d(x, factor, factor)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """Bilinear resize to an arbitrary (H, W), half-pixel centers, no
    antialiasing (``jax.image.resize(method="linear", antialias=False)``).
    Under ``spatial``, ``out_hw`` is the global size."""
    if spatial is not None:
        h_in, (h_out, w_out) = height(x), out_hw
        if (h_out, w_out) == (h_in, x.shape[3]):
            return x
    elif tuple(out_hw) == tuple(x.shape[2:]):
        return x
    with span("ops.resize") as s:
        if spatial is not None:
            y = _bilinear_banded(x, h_out, w_out, None, spatial)
        else:
            y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                              align_corners=False, antialias=False)
        _tag_resize(s, x, y)
    return y


def max_pool_torch(x: torch.Tensor, kernel: int, stride: int,
                   padding: int, spatial: Optional[SpatialCtx] = None
                   ) -> torch.Tensor:
    """``nn.MaxPool2d(kernel, stride, padding)``, floor output shape (the
    Res2Net stem pool)."""
    if spatial is not None:
        return _pool_banded(
            x, spatial, kernel, stride, padding, False,
            lambda w, a, b: F.max_pool2d(w, kernel, stride, (0, padding)),
            pad_value=float("-inf"))
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool_torch(x: torch.Tensor, kernel: int, stride: int,
                   padding: int = 0, ceil_mode: bool = False,
                   count_include_pad: bool = True,
                   spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """``nn.AvgPool2d`` with ceil mode and count_include_pad (the
    Bottle2neck stage pool and the downsample shortcut's pool).

    Under ``spatial`` the window sums (f32, zeros outside the image) are
    divided by torch's divisor of each window, computed from the global
    geometry: the rows' part depends on the true image edges, which a
    band's window does not see."""
    if spatial is not None:
        h, w = height(x), x.shape[3]
        k, s, p = kernel, stride, padding
        dh = _divisors(h, _pooled(h, k, s, p, ceil_mode), k, s, p,
                       count_include_pad)
        dw = _divisors(w, _pooled(w, k, s, p, ceil_mode), k, s, p,
                       count_include_pad)

        def fn(win, a, b):
            t = F.avg_pool2d(win.float(), k, s, (0, p), ceil_mode=ceil_mode,
                             count_include_pad=True, divisor_override=1)
            d = torch.as_tensor(np.outer(dh[a:b], dw), dtype=torch.float32,
                                device=t.device)
            return (t / d).to(x.dtype)

        return _pool_banded(x, spatial, k, s, p, ceil_mode, fn)
    return F.avg_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


def _divisors(h: int, h_out: int, k: int, s: int, p: int,
              count_include_pad: bool) -> np.ndarray:
    """torch's average-pool divisor factor of each output row along one
    axis: the window clipped to [-p, h + p), or to the image itself
    without ``count_include_pad``."""
    start = np.arange(h_out) * s - p
    end = np.minimum(start + k, h + p)
    if count_include_pad:
        return (end - start).astype(np.float32)
    return (np.minimum(end, h) - np.maximum(start, 0)).astype(np.float32)
