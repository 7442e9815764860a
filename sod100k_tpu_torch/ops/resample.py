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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear x`factor` upsample, align_corners=False."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False)


def max_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping max pool (kernel = stride = factor), floor mode."""
    if factor == 1:
        return x
    return F.max_pool2d(x, factor, factor)


def avg_pool(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Non-overlapping average pool (kernel = stride = factor), floor mode."""
    if factor == 1:
        return x
    return F.avg_pool2d(x, factor, factor)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to an arbitrary (H, W), half-pixel centers, no
    antialiasing (``jax.image.resize(method="linear", antialias=False)``)."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)


def max_pool_torch(x: torch.Tensor, kernel: int, stride: int,
                   padding: int) -> torch.Tensor:
    """``nn.MaxPool2d(kernel, stride, padding)``, floor output shape (the
    Res2Net stem pool)."""
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool_torch(x: torch.Tensor, kernel: int, stride: int,
                   padding: int = 0, ceil_mode: bool = False,
                   count_include_pad: bool = True) -> torch.Tensor:
    """``nn.AvgPool2d`` with ceil mode and count_include_pad (the
    Bottle2neck stage pool and the downsample shortcut's pool)."""
    return F.avg_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)
