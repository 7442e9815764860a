"""Generalized Octave Convolution family (csnet and csf flavors), NCHW.

Port of ``sod100k_tpu/ops/goct.py:95-296``. An octave set (octset) is a list
of NCHW tensors, one per resolution branch (branch i nominally at 1/2^i
scale), with ``None`` for empty or pruned branches.

Cross-scale resampling follows one of the reference's two dialects:

- "csnet" (CSNet's gOctConv): coarse->fine = conv then bilinear upsample by
  2^(i-j); fine->coarse = max-pool by 2^(j-i) then conv; stride 2 =
  avg-pool(2) on the input first;
- "csf" (CSF+Res2Net's gOctConv): coarse->fine = conv then bilinear resize
  to the *input set's* branch-j shape; fine->coarse = bilinear resize of
  the input to that shape, then conv. The shapes need not be powers of two
  apart (an input that is not a multiple of 32 gives odd branch sizes).

The modules own their parameters under the reference's names
(``conv.weight``, ``bns.<j>``, ``prelus.<j>``, ``convs.<j>``, ``msconv.<d>``,
``bn``, ``prelu``; the CSF gOctConv's dense weight is ``conv.weights``), so
a reference state_dict loads strictly. Branch keys exist only for branches
with channels. Convolutions marked x100 carry the reference's Conv2dX100
weight scaling. The norm is batch norm (CSNet) or GroupNorm(32) (the CSF
head, ``norm="gn"``).

A train-mode forward can hand every module a ``GapCollector``: it records,
per BN, the detached |spatial mean| of the post-PReLU activation, the
signal of the dynamic-weight-decay penalty (``train/dynamic_wd.py``). Group
norms are never recorded.

Every forward takes ``spatial`` (a ``parallel.spatial.SpatialCtx``): the
octset then holds this rank's row band of each branch, each branch with
its own global height, and the convolutions, pools and resamples fetch
the rows they read from the other ranks of the spatial group. The CSF
dialect's resize targets are the input branches' global shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel.spatial import SpatialCtx, height, like, spatial_sum
from .conv import ConvWeight, conv2d
from .norm import BN_EPS, GN_GROUPS, norm_act
from .resample import avg_pool, max_pool, resize_bilinear, upsample_bilinear

Split = Sequence[int]
OctSet = list  # list of Optional[torch.Tensor]

DILATIONS = (1, 2, 4, 8, 16)


def bn_paths(model: nn.Module) -> dict[nn.Module, str]:
    """Every BN of ``model`` -> its module name (``stage1.2.conv1x1.bns.0``),
    which is also its JAX path."""
    return {m: name for name, m in model.named_modules()
            if isinstance(m, nn.BatchNorm2d)}


class GapCollector:
    """The penalty's signal of one forward: ``gap[path]`` is the (N, C) f32
    |spatial mean| of the post-PReLU activation after the BN at ``path``,
    detached (the JAX package's ``ApplyCtx.gap``, reference
    ``Oct_bn_hook``). ``paths`` is the model's ``bn_paths``, built once per
    model; the train step makes a collector per forward and passes it
    down.

    Under ``spatial`` (row bands) a record keeps the band's sums; ``finish``
    sums them over the spatial group in one all-reduce and divides by each
    map's whole size. ``gap`` is read after ``finish``."""

    def __init__(self, paths: dict[nn.Module, str],
                 spatial: Optional[SpatialCtx] = None):
        self.paths, self.spatial = paths, spatial
        self.gap: dict[str, torch.Tensor] = {}
        self._sums: dict[str, tuple[torch.Tensor, int]] = {}

    def record(self, bn: nn.BatchNorm2d, y: torch.Tensor) -> None:
        if self.spatial is None:
            self.gap[self.paths[bn]] = \
                y.float().mean(dim=(2, 3)).abs().detach()
            return
        self._sums[self.paths[bn]] = (y.detach().float().sum(dim=(2, 3)),
                                      height(y) * y.shape[3])

    def finish(self) -> None:
        """The means of the whole maps from the bands' sums (no-op without
        ``spatial``)."""
        if not self._sums:
            return
        keys = list(self._sums)
        flat = spatial_sum(torch.cat([self._sums[k][0].reshape(-1)
                                      for k in keys]), self.spatial)
        off = 0
        for k in keys:
            t, size = self._sums[k]
            self.gap[k] = (flat[off:off + t.numel()].view_as(t)
                           / size).abs()
            off += t.numel()
        self._sums = {}


def _norm_act(norm: nn.Module, act: nn.PReLU, x: torch.Tensor,
              gap: Optional[GapCollector],
              spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
    """``norm_act``, recorded in ``gap`` when one is given and the norm is
    a batch norm."""
    y = norm_act(norm, act, x, spatial)
    if gap is not None and isinstance(norm, nn.BatchNorm2d):
        gap.record(norm, y)
    return y


def _offsets(split: Split) -> list[int]:
    offs = [0]
    for s in split:
        offs.append(offs[-1] + int(s))
    return offs


def _bn(c: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, device=device)


def _norm(kind: str, c: int, device) -> nn.Module:
    if kind == "gn":
        return nn.GroupNorm(GN_GROUPS, c, eps=BN_EPS, device=device)
    if kind != "bn":
        raise ValueError(f"unknown norm {kind!r}")
    return _bn(c, device)


def _prelu(c: int, device) -> nn.PReLU:
    return nn.PReLU(c, init=0.25, device=device)


def goct_conv(
    xset: OctSet,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    in_split: Split,
    out_split: Split,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    flavor: str = "csnet",
    spatial: Optional[SpatialCtx] = None,
) -> OctSet:
    """Generalized octave convolution over an octset.

    ``weight`` is the dense OIHW tensor (sum(out_split), sum(in_split), kh,
    kw); each (in-branch, out-branch) pair convolves with its slice, and the
    contributions to an output branch are summed in input-branch order.
    ``flavor`` picks the cross-scale resampling dialect.
    """
    if flavor not in ("csnet", "csf"):
        raise ValueError(f"unknown gOctConv flavor {flavor!r}")
    in_off = _offsets(in_split)
    out_off = _offsets(out_split)
    sp = spatial
    ysets: list[list[torch.Tensor]] = [[] for _ in out_split]
    for i, ci in enumerate(in_split):
        if ci == 0 or i >= len(xset) or xset[i] is None:
            continue
        x = avg_pool(xset[i], 2, sp) if stride == 2 else xset[i]
        for j, cj in enumerate(out_split):
            if cj == 0:
                continue
            w = weight[out_off[j]:out_off[j + 1], in_off[i]:in_off[i + 1]]
            b = None if bias is None else bias[out_off[j]:out_off[j + 1]]
            conv = dict(padding=padding, dilation=dilation, spatial=sp)
            if i == j:
                y = conv2d(x, w, b, **conv)
            elif flavor == "csf":
                tgt = ((height(xset[j]), xset[j].shape[3]) if sp is not None
                       else xset[j].shape[2:])
                if i > j:
                    y = resize_bilinear(conv2d(x, w, b, **conv), tgt, sp)
                else:
                    y = conv2d(resize_bilinear(x, tgt, sp), w, b, **conv)
            elif i > j:
                y = upsample_bilinear(conv2d(x, w, b, **conv), 2 ** (i - j),
                                      sp)
            else:
                y = conv2d(max_pool(x, 2 ** (j - i), sp), w, b, **conv)
            ysets[j].append(y)
    out: OctSet = []
    for ys in ysets:
        if not ys:
            out.append(None)
            continue
        acc = ys[0]
        for y in ys[1:]:
            acc = acc + y
        out.append(like(acc, ys[0], sp))
    return out


class PluralConvWeight(ConvWeight):
    """The CSF gOctConv's dense weight, which the reference names
    ``weights`` (CSF+Res2Net gOctConv.py:21); ``.weight`` reads it."""

    def __init__(self, cout: int, cin: int, kernel: int, *, device=None):
        nn.Module.__init__(self)
        self.weights = nn.Parameter(
            torch.empty(cout, cin, kernel, kernel, device=device))
        self.register_parameter("bias", None)

    @property
    def weight(self) -> nn.Parameter:
        return self.weights


class GOctCBR(nn.Module):
    """gOctConv (or a plain x100 conv when 1-in/1-out) + per-branch norm +
    PReLU: ``goct_cbr``. The x100 weight scale applies only on the
    single-branch path (reference gOctaveCBR). ``flavor="csf"`` resamples
    in the CSF dialect and names the weight ``weights``; ``norm="gn"``
    takes GroupNorm(32) for batch norm."""

    def __init__(self, in_split: Split, out_split: Split, kernel: int, *,
                 stride: int = 1, padding: int = 0, flavor: str = "csnet",
                 norm: str = "bn", device=None):
        super().__init__()
        self.in_split = tuple(int(c) for c in in_split)
        self.out_split = tuple(int(c) for c in out_split)
        self.stride, self.padding, self.flavor = stride, padding, flavor
        weight = PluralConvWeight if flavor == "csf" else ConvWeight
        self.conv = weight(sum(self.out_split), sum(self.in_split), kernel,
                           device=device)
        live = [(str(j), c) for j, c in enumerate(self.out_split) if c]
        self.bns = nn.ModuleDict({k: _norm(norm, c, device) for k, c in live})
        self.prelus = nn.ModuleDict({k: _prelu(c, device) for k, c in live})

    def forward(self, xset: OctSet, gap: Optional[GapCollector] = None,
                spatial: Optional[SpatialCtx] = None) -> OctSet:
        if len(self.in_split) == 1 and len(self.out_split) == 1:
            yset = [conv2d(xset[0], self.conv.weight, stride=self.stride,
                           padding=self.padding, weight_scale=100.0,
                           spatial=spatial)]
        else:
            yset = goct_conv(xset, self.conv.weight, None,
                             in_split=self.in_split, out_split=self.out_split,
                             stride=self.stride, padding=self.padding,
                             flavor=self.flavor, spatial=spatial)
        out: OctSet = []
        for j, y in enumerate(yset):
            if y is None or self.out_split[j] == 0:
                out.append(None)
                continue
            k = str(j)
            out.append(_norm_act(self.bns[k], self.prelus[k], y, gap,
                                 spatial))
        return out


class SimplifiedGOctCBR(nn.Module):
    """Per-branch depthwise 3x3 Conv2dX100 + BN + PReLU, no cross-branch
    mixing: ``simplified_goct_cbr`` (reference SimplifiedGOctConvBR)."""

    def __init__(self, split: Split, *, device=None):
        super().__init__()
        self.split = tuple(int(c) for c in split)
        live = [(str(j), c) for j, c in enumerate(self.split) if c]
        self.convs = nn.ModuleDict(
            {k: ConvWeight(c, 1, 3, device=device) for k, c in live})
        self.bns = nn.ModuleDict({k: _bn(c, device) for k, c in live})
        self.prelus = nn.ModuleDict({k: _prelu(c, device) for k, c in live})

    def forward(self, xset: OctSet, gap: Optional[GapCollector] = None,
                spatial: Optional[SpatialCtx] = None) -> OctSet:
        out: OctSet = []
        for j, c in enumerate(self.split):
            if c == 0 or xset[j] is None:
                out.append(None)
                continue
            k = str(j)
            y = conv2d(xset[j], self.convs[k].weight, padding=1, groups=c,
                       weight_scale=100.0, spatial=spatial)
            out.append(_norm_act(self.bns[k], self.prelus[k], y, gap,
                                 spatial))
        return out


class MSBlock(nn.Module):
    """Parallel dilated 3x3 convs (dilations 1/2/4/8/16), concatenated,
    then norm + PReLU: ``ms_block``. Zero-width dilations are skipped. The
    convs are x100 unless ``x100=False`` (the CSF head's plain convs);
    ``norm="gn"`` takes GroupNorm(32) for batch norm."""

    def __init__(self, cin: int, dil_split: Split, *, norm: str = "bn",
                 x100: bool = True, device=None):
        super().__init__()
        self.dil_split = tuple(int(c) for c in dil_split)
        self.weight_scale = 100.0 if x100 else 1.0
        self.msconv = nn.ModuleDict({
            str(i): ConvWeight(c, cin, 3, device=device)
            for i, c in enumerate(self.dil_split) if c})
        self.bn = _norm(norm, sum(self.dil_split), device)
        self.prelu = _prelu(sum(self.dil_split), device)

    def forward(self, x: torch.Tensor, gap: Optional[GapCollector] = None,
                spatial: Optional[SpatialCtx] = None) -> torch.Tensor:
        outs = [conv2d(x, self.msconv[str(i)].weight, padding=d, dilation=d,
                       weight_scale=self.weight_scale, spatial=spatial)
                for i, d in enumerate(DILATIONS) if self.dil_split[i]]
        y = outs[0] if len(outs) == 1 else like(torch.cat(outs, dim=1), x,
                                                  spatial)
        return _norm_act(self.bn, self.prelu, y, gap, spatial)


class PallMSBlock(nn.Module):
    """One MSBlock per octave branch: ``pall_ms_block``; ``norm`` and
    ``x100`` pass through to each."""

    def __init__(self, in_split: Split, dil_splits: Sequence[Split], *,
                 norm: str = "bn", x100: bool = True, device=None):
        super().__init__()
        self.live = tuple(max(int(v) for v in ds) != 0 for ds in dil_splits)
        self.convs = nn.ModuleDict({
            str(i): MSBlock(int(in_split[i]), ds, norm=norm, x100=x100,
                            device=device)
            for i, ds in enumerate(dil_splits) if self.live[i]})

    def forward(self, xset: OctSet, gap: Optional[GapCollector] = None,
                spatial: Optional[SpatialCtx] = None) -> OctSet:
        return [self.convs[str(i)](xset[i], gap, spatial)
                if live and xset[i] is not None else None
                for i, live in enumerate(self.live)]
