"""Eval-mode batch norm, group norm and PReLU (NCHW).

Port of ``sod100k_tpu/ops/norm.py:27-76``. The modules are torch's
own ``nn.BatchNorm2d``, ``nn.GroupNorm`` and ``nn.PReLU``; train mode runs
``nn.BatchNorm2d`` as it is (batch statistics, unbiased running variance,
momentum 0.1). Group norm (the CSF head's) has no running statistics and
no mode.

Under data parallelism (one process per card) the batch statistics are
those of the global batch, as the JAX package's ``batchnorm_train`` gets
them from GSPMD over a sharded batch: ``convert_global_bn`` turns a
model's batch norms into ``GlobalBatchNorm2d``, which all-reduces the
per-channel sums in its forward and backward. Under a 2-D mesh its group
is the world (every rank's rows and bands); its element count is
all-reduced, so uneven bands weigh right.

Under a ``parallel.spatial.SpatialCtx`` (row bands of each image) group
norm is ``_SpatialGroupNorm``: per-sample statistics summed over the
spatial group only, never the world.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import SpatialCtx, like

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


def groupnorm(x: torch.Tensor, gn: nn.GroupNorm,
              spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """Group norm with the statistics and the affine in f32, then cast to
    the activation dtype (biased variance, as ``nn.GroupNorm``). A bf16
    input goes up to f32 first rather than into ATen's mixed-dtype path,
    so both dtypes round once, at the end. Under ``spatial`` the
    statistics are those of the whole image (``_SpatialGroupNorm``)."""
    if spatial is not None:
        y = _SpatialGroupNorm.apply(x, gn.weight, gn.bias, gn.num_groups,
                                    gn.eps, spatial)
        return like(y, x, spatial)
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                     gn.bias.float(), gn.eps)
    return y.to(x.dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with per-channel (or scalar) negative slope, ``x >= 0`` kept."""
    a = alpha.to(x.dtype).view(1, -1, 1, 1)
    return torch.where(x >= 0, x, a * x)


def norm_act(norm: nn.Module, act: nn.PReLU, x: torch.Tensor,
             spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """A norm followed by PReLU. Group norm: ``groupnorm``; batch norm in
    train mode: ``nn.BatchNorm2d``; in eval mode: ``batchnorm_infer``."""
    if isinstance(norm, nn.GroupNorm):
        y = groupnorm(x, norm, spatial)
    else:
        y = norm(x) if norm.training else batchnorm_infer(x, norm)
    return like(prelu(y, act.weight), x, spatial)


class _SpatialGroupNorm(torch.autograd.Function):
    """Group norm of row bands: each sample's per-group sums (f64) and
    element count are all-reduced over the spatial group; the variance is
    one-pass, clamped at 0; y = (x - mean) * rstd * weight + bias in f32
    (f64 for f64 input), cast to the input's dtype. The backward all-reduces each sample's
    per-group sums of g = dy * weight and g * xhat for the input gradient
    and returns this rank's share of the weight and bias gradients (the
    step sums those over the world with the other gradients)."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, sp):
        n, c = x.shape[:2]
        acc = torch.promote_types(x.dtype, torch.float32)
        xg = x.to(acc).reshape(n, groups, -1)
        count = torch.full((n, groups, 1), xg.shape[2], dtype=torch.float64,
                           device=x.device)
        stats = torch.cat([xg.sum(2, keepdim=True).double(),
                           xg.square().sum(2, keepdim=True).double(), count],
                          dim=2)
        sp.all_reduce(stats)
        cnt = stats[..., 2:3]
        mean64 = stats[..., 0:1] / cnt
        var = torch.clamp(stats[..., 1:2] / cnt - mean64.square(), min=0.0)
        mean, rstd = mean64.to(acc), torch.rsqrt(var.to(acc) + eps)
        xhat = ((xg - mean) * rstd).reshape(x.shape)
        view = (1, c, 1, 1)
        y = xhat * weight.to(acc).view(view) + bias.to(acc).view(view)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.groups, ctx.sp = groups, sp
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        groups, sp = ctx.groups, ctx.sp
        n, c = x.shape[:2]
        view = (1, c, 1, 1)
        acc = mean.dtype
        xhat = ((x.to(acc).reshape(n, groups, -1) - mean) * rstd
                ).reshape(x.shape)
        dyf = dy.to(acc)
        g = (dyf * weight.to(acc).view(view)).reshape(n, groups, -1)
        xg = xhat.reshape(n, groups, -1)
        sums = torch.cat([g.sum(2, keepdim=True), (g * xg).sum(2, keepdim=True),
                          torch.full((n, groups, 1), xg.shape[2],
                                     dtype=acc, device=x.device)],
                         dim=2)
        sp.all_reduce(sums)
        cnt = sums[..., 2:3]
        dx = rstd * (g - sums[..., 0:1] / cnt - xg * (sums[..., 1:2] / cnt))
        d_weight = (dyf * xhat).sum((0, 2, 3))
        d_bias = dyf.sum((0, 2, 3))
        return (dx.reshape(x.shape).to(x.dtype), d_weight.to(weight.dtype),
                d_bias.to(weight.dtype), None, None, None)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the batch of every rank of ``group``
    (``sod100k_tpu/ops/norm.py:35-60`` semantics): per-channel sums in f32
    (f64 for f64 input), all-reduced with the element count; the one-pass
    variance E[x^2] - E[x]^2 clamped at 0; y = (x - mean) * (rsqrt(var +
    eps) * weight) + bias in f32 (f64), cast to the input's dtype; running statistics updated in place
    with the unbiased variance of the global count. The backward
    all-reduces (sum dy, sum dy * xhat) for the input gradient and returns
    this rank's share of the weight and bias gradients (the step sums
    those over ranks with the other gradients)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        dims = (0, 2, 3)
        c = x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        count = torch.full((1,), xf.numel() // c, dtype=torch.float64,
                           device=x.device)
        stats = torch.cat([xf.sum(dims).double(),
                           xf.square().sum(dims).double(), count])
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean64 = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean64.square(), min=0.0)
        mean, inv = mean64.to(acc), torch.rsqrt(var.to(acc) + eps)
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(
            momentum * (var * (n / torch.clamp(n - 1, min=1))).to(
                running_var.dtype))
        view = (1, c, 1, 1)
        y = (xf - mean.view(view)) * (inv * weight).view(view) \
            + bias.view(view)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.n, ctx.group = float(n), group
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, inv = ctx.saved_tensors
        dims, view = (0, 2, 3), (1, x.shape[1], 1, 1)
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(view)) * inv.view(view)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        glob = local.clone()
        dist.all_reduce(glob, group=ctx.group)
        g_dy, g_dyx = glob.view(2, -1).div(ctx.n)
        dx = (weight * inv).view(view) * (
            dyf - g_dy.view(view) - xhat * g_dyx.view(view))
        d_bias, d_weight = local.view(2, -1)
        return (dx.to(x.dtype), d_weight, d_bias, None, None, None, None,
                None)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are those of the
    global batch over ``group`` (``_GlobalBatchNorm``). With no group, a
    group of one process, or in eval mode it is ``nn.BatchNorm2d``
    unchanged. Made by ``convert_global_bn``, which keeps the module
    objects, their parameters and their state_dict keys."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not self.training or self.group is None
                or dist.get_world_size(self.group) == 1):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return _GlobalBatchNorm.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, self.momentum, self.group)


def convert_global_bn(model: nn.Module, group) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``model`` a ``GlobalBatchNorm2d``
    over ``group``, in place: the same objects (so maps keyed on them, as
    ``goct.bn_paths``, still hold), parameters, buffers and state_dict
    keys. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = GlobalBatchNorm2d
            m.group = group
    return model
