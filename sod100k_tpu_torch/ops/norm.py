"""Eval-mode batch norm, group norm and PReLU (NCHW).

Port of ``sod100k_tpu/ops/norm.py:27-32,61-76``. The modules are torch's
own ``nn.BatchNorm2d``, ``nn.GroupNorm`` and ``nn.PReLU``; train mode runs
``nn.BatchNorm2d`` as it is (batch statistics, unbiased running variance,
momentum 0.1). Group norm (the CSF head's) has no running statistics and
no mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
GN_GROUPS = 32


def batchnorm_infer(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval batch norm from running statistics, folded to one FMA; the
    folded scale and shift are computed in the parameters' dtype and cast
    to the activation dtype."""
    inv = torch.rsqrt(bn.running_var + bn.eps)
    scale = (bn.weight * inv).to(x.dtype).view(1, -1, 1, 1)
    shift = (bn.bias - bn.running_mean * bn.weight * inv).to(x.dtype).view(1, -1, 1, 1)
    return x * scale + shift


def groupnorm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """Group norm with the statistics and the affine in f32, then cast to
    the activation dtype (biased variance, as ``nn.GroupNorm``). A bf16
    input goes up to f32 first rather than into ATen's mixed-dtype path,
    so both dtypes round once, at the end."""
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                     gn.bias.float(), gn.eps)
    return y.to(x.dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with per-channel (or scalar) negative slope, ``x >= 0`` kept."""
    a = alpha.to(x.dtype).view(1, -1, 1, 1)
    return torch.where(x >= 0, x, a * x)


def norm_act(norm: nn.Module, act: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """A norm followed by PReLU. Group norm: ``groupnorm``; batch norm in
    train mode: ``nn.BatchNorm2d``; in eval mode: ``batchnorm_infer``."""
    if isinstance(norm, nn.GroupNorm):
        y = groupnorm(x, norm)
    else:
        y = norm(x) if norm.training else batchnorm_infer(x, norm)
    return prelu(y, act.weight)
