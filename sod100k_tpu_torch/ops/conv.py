"""2-D convolution (NCHW activations, OIHW weights).

Port of ``sod100k_tpu/ops/conv.py``. ``weight_scale`` reproduces the
reference's Conv2dX100 trick: the stored weight is 1/100 of the effective
weight and the forward multiplies by 100. The scale stays in the graph (it is
not folded into the stored weight) so gradients and optimizer state see the
same parameterization as the reference.

Under a ``parallel.spatial.SpatialCtx`` the input is this rank's band of
the map's rows: the convolution fetches the rows its output band reads
(any stride, dilation and padding), zero-pads only at the image edges and
returns its band of the output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import SpatialCtx, banded, height


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int | tuple[int, int] = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int | tuple[int, int] = 1,
    groups: int = 1,
    weight_scale: float = 1.0,
    padding_mode: str = "zeros",
    spatial: Optional[SpatialCtx] = None,
) -> torch.Tensor:
    """``F.conv2d`` with the JAX package's conventions.

    The (scaled) weight and the bias are cast to the activation dtype, so
    bf16 activations run a bf16 convolution (cuDNN accumulates in f32).
    ``padding_mode="circular"`` wrap-pads by the torch expansion (top/left
    get (pad+1)//2, bottom/right pad//2) and then convolves unpadded; no
    model uses it, and it is refused under ``spatial``.
    """
    padding = _pair(padding)
    if spatial is not None:
        if padding_mode != "zeros":
            raise ValueError(f"padding_mode {padding_mode!r} is not "
                             f"supported on row bands")
        return _conv2d_banded(x, weight, bias, _pair(stride), padding,
                              _pair(dilation), groups, weight_scale, spatial)
    if padding_mode == "circular":
        ph, pw = padding
        x = F.pad(x, ((pw + 1) // 2, pw // 2, (ph + 1) // 2, ph // 2),
                  mode="circular")
        padding = (0, 0)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    w = weight if weight_scale == 1.0 else weight * weight_scale
    y = F.conv2d(x, w.to(x.dtype), None, _pair(stride), padding,
                 _pair(dilation), groups)
    if bias is not None:
        y = y + bias.to(x.dtype).view(1, -1, 1, 1)
    return y


def _conv2d_banded(x, weight, bias, stride, padding, dilation, groups,
                   weight_scale, sp: SpatialCtx) -> torch.Tensor:
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    k = weight.shape[2]
    h_out = (height(x) + 2 * ph - dh * (k - 1) - 1) // sh + 1
    w = weight if weight_scale == 1.0 else weight * weight_scale
    w = w.to(x.dtype)

    def fn(win, a, b):
        y = F.conv2d(win, w, None, (sh, sw), (0, pw), (dh, dw), groups)
        if bias is not None:
            y = y + bias.to(x.dtype).view(1, -1, 1, 1)
        return y

    return banded(x, sp, h_out,
                  lambda a, b: (a * sh - ph, (b - 1) * sh - ph
                                + dh * (k - 1) + 1), fn)


class ConvWeight(nn.Module):
    """One OIHW convolution weight (and optional bias) under the reference's
    parameter names. The forward lives in the modules that own it, which
    slice the weight per octave branch; initialization is done by the model
    from a seeded generator (``init_conv_``)."""

    def __init__(self, cout: int, cin_per_group: int, kernel: int, *,
                 bias: bool = False, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin_per_group, kernel, kernel, device=device))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout, device=device))
        else:
            self.register_parameter("bias", None)


def init_conv_(m: ConvWeight, gen: torch.Generator) -> None:
    """torch's default conv init, ``kaiming_uniform_(a=sqrt(5))``: uniform
    within +-1/sqrt(fan_in), fan_in = cin/groups * kh * kw; the bias uses
    the same bound. Zero-sized weights (pruned branches) draw nothing."""
    w = m.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    bound = fan_in ** -0.5 if fan_in else 0.0
    with torch.no_grad():
        for p in (w, m.bias):
            if p is not None and p.numel():
                r = torch.rand(p.shape, generator=gen, dtype=torch.float32)
                p.copy_((r * 2.0 - 1.0) * bound)
