"""CSNet (SOD100K ``CSNet_training/model/csnet.py``), plain PyTorch.

The architecture is data: ``init_layers(basewidth, split)`` gives every
prunable layer's channels per octave branch (``csnet.py:414-518``) and the
stage depths [3, 4, 6, 4]. A stem ILBlock and four stages of ILBlocks
(stride 2 opening stages 2-4), each a generalized-octave CBR and two
depthwise 3x3 Conv2dX100 + BN + PReLU stages per branch; the CSF head over
the branch-0 ends of stages 2-4 (gOctConv fuse, dilated multi-scale block,
1x1 fuse), a 1x1 classifier and a bilinear resize to the input.

Cross-scale paths in CSNet's gOctConv: coarse -> fine is the convolution
then a bilinear upsample by 2^(i-j); fine -> coarse a max pool by 2^(j-i)
then the convolution; a stride-2 gOctConv average-pools its input first.
A single-branch CBR is a plain strided Conv2dX100.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import Norms, conv, resize

DILATIONS = (1, 2, 4, 8, 16)
STAGE_DEPTHS = (3, 4, 6, 4)


@dataclasses.dataclass(frozen=True)
class Layer:
    cin: tuple
    cout: tuple
    dil: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Block:
    name: str      # "stage2.0"
    layer: Layer
    kernel: int
    stride: int


@dataclasses.dataclass(frozen=True)
class Plan:
    blocks: tuple
    fuse: Layer
    ms: Layer
    fuse1x1: Layer


def _split(width: float, fracs) -> tuple:
    return tuple(int(round(width * f)) for f in fracs)


def _dil_split(width: int) -> tuple:
    each = width // len(DILATIONS)
    return (each,) * (len(DILATIONS) - 1) + (width - each * 4,)


def init_layers(basewidth: int, split=(1.0,)) -> Plan:
    """The seed CSNet at ``basewidth``, each layer's channels split over
    the octave branches by ``split`` (``[0.5, 0.5]`` for the -x2 models);
    the last layer of stages 2-4 collapses to one branch."""
    w, one = basewidth, (1.0,)
    layers = [Layer((3,), _split(w, split))]
    layers += [Layer(_split(w, split), _split(w, split))] * STAGE_DEPTHS[0]
    layers.append(Layer(_split(w, split), _split(2 * w, split)))
    layers += [Layer(_split(2 * w, split), _split(2 * w, split))] \
        * (STAGE_DEPTHS[1] - 2)
    layers.append(Layer(_split(2 * w, split), _split(2 * w, one)))
    for depth in STAGE_DEPTHS[2:]:
        first_in = layers[-1].cout
        layers.append(Layer(first_in, _split(4 * w, split)))
        layers += [Layer(_split(4 * w, split), _split(4 * w, split))] \
            * (depth - 2)
        layers.append(Layer(_split(4 * w, split), _split(4 * w, one)))
    blocks = [Block("stage0.0", layers[0], 3, 1)]
    k = 1
    for s, depth in enumerate(STAGE_DEPTHS):
        for i in range(depth):
            stride = 2 if s > 0 and i == 0 else 1
            blocks.append(Block(f"stage{s + 1}.{i}", layers[k],
                                3 if stride == 2 else 1, stride))
            k += 1
    side = (2 * w, 4 * w, 4 * w)
    thirds = tuple(v // 3 for v in side)
    return Plan(tuple(blocks), Layer(side, thirds),
                Layer(thirds, thirds, tuple(_dil_split(t) for t in thirds)),
                Layer(thirds, (sum(thirds),)))


def _live(split) -> list:
    return [j for j, c in enumerate(split) if c]


def _cbr_spec(prefix: str, cin: tuple, cout: tuple, kernel: int) -> list:
    out = [(f"{prefix}.conv.weight", (sum(cout), sum(cin), kernel, kernel),
            "conv")]
    for j in _live(cout):
        out += _bn_spec(f"{prefix}.bns.{j}", cout[j])
        out.append((f"{prefix}.prelus.{j}.weight", (cout[j],), "prelu"))
    return out


def _bn_spec(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "norm_weight"),
            (f"{name}.bias", (c,), "norm_bias"),
            (f"{name}.running_mean", (c,), "mean"),
            (f"{name}.running_var", (c,), "var"),
            (f"{name}.num_batches_tracked", (), "count")]


def spec(plan: Plan) -> list:
    """(name, shape, kind) of every tensor of the state dict."""
    out = []
    for b in plan.blocks:
        L = b.layer
        out += _cbr_spec(f"{b.name}.conv1x1", L.cin, L.cout, b.kernel)
        for stage in ("conv3x3_1", "conv3x3_2"):
            for j in _live(L.cout):
                out.append((f"{b.name}.{stage}.convs.{j}.weight",
                            (L.cout[j], 1, 3, 3), "conv"))
            for j in _live(L.cout):
                out += _bn_spec(f"{b.name}.{stage}.bns.{j}", L.cout[j])
            for j in _live(L.cout):
                out.append((f"{b.name}.{stage}.prelus.{j}.weight",
                            (L.cout[j],), "prelu"))
    out += _cbr_spec("oct_fuse.fuse", plan.fuse.cin, plan.fuse.cout, 1)
    for i, ds in enumerate(plan.ms.dil):
        if not max(ds):
            continue
        pre = f"oct_fuse.ms.convs.{i}"
        for k, c in enumerate(ds):
            if c:
                out.append((f"{pre}.msconv.{k}.weight",
                            (c, plan.ms.cin[i], 3, 3), "conv"))
        out += _bn_spec(f"{pre}.bn", sum(ds))
        out.append((f"{pre}.prelu.weight", (sum(ds),), "prelu"))
    out += _cbr_spec("oct_fuse.fuse1x1", plan.fuse1x1.cin,
                     plan.fuse1x1.cout, 1)
    out += [("cls_layer.weight", (1, sum(plan.fuse1x1.cout), 1, 1), "conv"),
            ("cls_layer.bias", (1,), "conv_bias")]
    return out


def _offsets(split) -> list:
    offs = [0]
    for c in split:
        offs.append(offs[-1] + c)
    return offs


def goct(xs: list, w: torch.Tensor, cin: tuple, cout: tuple, *,
         stride: int = 1, padding: int = 0) -> list:
    """CSNet's generalized octave convolution over branches ``xs``."""
    if len(cin) == 1 and len(cout) == 1:
        return [conv(xs[0], w, stride=stride, padding=padding, x100=True)]
    io, oo = _offsets(cin), _offsets(cout)
    out = [None] * len(cout)
    for i in _live(cin):
        if i >= len(xs) or xs[i] is None:
            continue
        x = F.avg_pool2d(xs[i], 2, 2) if stride == 2 else xs[i]
        for j in _live(cout):
            wij = w[oo[j]:oo[j + 1], io[i]:io[i + 1]]
            if i == j:
                y = conv(x, wij, padding=padding)
            elif i > j:
                y = conv(x, wij, padding=padding)
                y = resize(y, (y.shape[2] * 2 ** (i - j),
                               y.shape[3] * 2 ** (i - j)))
            else:
                y = conv(F.max_pool2d(x, 2 ** (j - i), 2 ** (j - i)), wij,
                         padding=padding)
            out[j] = y if out[j] is None else out[j] + y
    return out


def cbr(xs: list, p: dict, prefix: str, cin, cout, norms: Norms, *,
        kernel: int = 1, stride: int = 1) -> list:
    ys = goct(xs, p[prefix + ".conv.weight"], cin, cout, stride=stride,
              padding=kernel // 2)
    return [None if y is None else
            norms.bn_prelu(y, p, f"{prefix}.bns.{j}", f"{prefix}.prelus.{j}")
            for j, y in enumerate(ys)]


def dw_cbr(xs: list, p: dict, prefix: str, split, norms: Norms,
           tails: list | None = None) -> list:
    out = []
    for j, x in enumerate(xs):
        if x is None or not split[j]:
            out.append(None)
            continue
        if tails is not None:
            tails.append(tuple(x.shape))
        y = conv(x, p[f"{prefix}.convs.{j}.weight"], padding=1,
                 groups=split[j], x100=True)
        out.append(norms.bn_prelu(y, p, f"{prefix}.bns.{j}",
                                  f"{prefix}.prelus.{j}"))
    return out


def forward(p: dict, x: torch.Tensor, plan: Plan, norms: Norms | None = None,
            tails: list | None = None) -> torch.Tensor:
    """Normalized images, NCHW -> logits (N, 1, H, W). ``tails`` collects
    the input shape of every depthwise tail (both stages of one branch of
    one ILBlock), in order."""
    norms = norms or Norms("eval")
    hw = x.shape[2:]
    xs = [x]
    ends = {}
    for b in plan.blocks:
        L = b.layer
        xs = cbr(xs, p, f"{b.name}.conv1x1", L.cin, L.cout, norms,
                 kernel=b.kernel, stride=b.stride)
        xs = dw_cbr(xs, p, f"{b.name}.conv3x3_1", L.cout, norms, tails)
        xs = dw_cbr(xs, p, f"{b.name}.conv3x3_2", L.cout, norms)
        ends[b.name.split(".")[0]] = xs
    xs = cbr([ends["stage2"][0], ends["stage3"][0], ends["stage4"][0]], p,
             "oct_fuse.fuse", plan.fuse.cin, plan.fuse.cout, norms)
    ms = []
    for i, x in enumerate(xs):
        ds = plan.ms.dil[i]
        if x is None or not max(ds):
            ms.append(None)
            continue
        pre = f"oct_fuse.ms.convs.{i}"
        y = torch.cat([conv(x, p[f"{pre}.msconv.{k}.weight"], padding=d,
                            dilation=d, x100=True)
                       for k, d in enumerate(DILATIONS) if ds[k]], dim=1)
        ms.append(norms.bn_prelu(y, p, f"{pre}.bn", f"{pre}.prelu"))
    y = cbr(ms, p, "oct_fuse.fuse1x1", plan.fuse1x1.cin, plan.fuse1x1.cout,
            norms)[0]
    logits = conv(y, p["cls_layer.weight"], p["cls_layer.bias"])
    return resize(logits, hw)


# --- the dynamic-weight-decay penalty's weights (csnet.py:332-355) ---------

def flop_weights(plan: Plan, expand: float) -> dict:
    """BN name -> its flop weight: the g-th group of blocks (group sizes
    [stage1 + 1, stage2, stage3, stage4], the stem in the first) weighs
    expand^(3 - g), and branch k of B an extra expand^(B - 1 - k), for
    each of a block's three CBRs."""
    sizes = [STAGE_DEPTHS[0] + 1, *STAGE_DEPTHS[1:]]
    out = {}
    k = 0
    for g, size in enumerate(sizes):
        base = expand ** (len(sizes) - 1 - g)
        for b in plan.blocks[k:k + size]:
            n = len(b.layer.cout)
            for cbr_name in ("conv1x1", "conv3x3_1", "conv3x3_2"):
                for j, c in enumerate(b.layer.cout):
                    if c:
                        out[f"{b.name}.{cbr_name}.bns.{j}"] = \
                            base * expand ** (n - 1 - j)
        k += size
    return out


def wd_exempt(name: str) -> bool:
    """The recipe's Adam leaves the BN weights of every ILBlock's conv1x1
    and conv3x3_1 undecayed (train.py:101-107; conv3x3_2 keeps its decay,
    as the reference lists conv3x3_1 twice)."""
    parts = name.split(".")
    return (parts[0].startswith("stage") and len(parts) == 6
            and parts[2] in ("conv1x1", "conv3x3_1") and parts[3] == "bns"
            and parts[5] == "weight")
