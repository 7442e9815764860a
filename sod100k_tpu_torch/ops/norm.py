"""Eval-mode batch norm and PReLU (NCHW).

Port of ``sod100k_tpu/ops/norm.py:27-32,73-76``. The modules are torch's
own ``nn.BatchNorm2d`` and ``nn.PReLU``; train mode runs ``nn.BatchNorm2d``
as it is (batch statistics, unbiased running variance, momentum 0.1).
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


def batchnorm_infer(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval batch norm from running statistics, folded to one FMA; the
    folded scale and shift are computed in the parameters' dtype and cast
    to the activation dtype."""
    inv = torch.rsqrt(bn.running_var + bn.eps)
    scale = (bn.weight * inv).to(x.dtype).view(1, -1, 1, 1)
    shift = (bn.bias - bn.running_mean * bn.weight * inv).to(x.dtype).view(1, -1, 1, 1)
    return x * scale + shift


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with per-channel (or scalar) negative slope, ``x >= 0`` kept."""
    a = alpha.to(x.dtype).view(1, -1, 1, 1)
    return torch.where(x >= 0, x, a * x)


def norm_act(bn: nn.BatchNorm2d, act: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """Batch norm (train: ``nn.BatchNorm2d``; eval: ``batchnorm_infer``)
    followed by PReLU."""
    y = bn(x) if bn.training else batchnorm_infer(x, bn)
    return prelu(y, act.weight)
