"""CSF+Res2Net (SOD100K ``CSF+Res2Net/networks/csf_res2net.py:233-259``),
plain PyTorch.

The backbone is Res2Net v1b, 26w4s (``res2net.py``): a three-conv stem
(stride 2) with BN + ReLU and a 3x3/2 max pool, then four layers of
Bottle2neck blocks. A block splits its 1x1 conv's output into four
chunks, runs 3x3 convs in cascade over the first three (each adding the
previous one's output, except in a layer's first block) and passes the
fourth through (average-pooled in a layer's first block); the first block
of a layer carries an average-pool + 1x1 conv + BN shortcut. Every backbone
BN normalizes with its running statistics, in training too (the reference
Solver trains under ``net.eval()``).

The head: a gOctConv over the four layer outputs ([256, 512, 1024, 2048]
-> [128, 256, 512, 512]) with GroupNorm(32) + PReLU, a multi-scale block of
plain dilated 3x3 convs (dilations 1-16, widths c // 5) per branch, a
gOctConv 1x1 onto one 1408-channel branch, the classifier and a bilinear
resize to the input. CSF's gOctConv resizes between branches bilinearly to
the input set's shape of the target branch: coarse -> fine after the
convolution, fine -> coarse before it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Norms, conv, resize

DEPTHS = {"res2net50": (3, 4, 6, 3), "res2net101": (3, 4, 23, 3)}
PLANES = (64, 128, 256, 512)
BASE_WIDTH, SCALE, EXPANSION = 26, 4, 4
FUSE_IN = (256, 512, 1024, 2048)
FUSE_OUT = (128, 256, 512, 512)
DILATIONS = (1, 2, 4, 8, 16)


def _dil_split(width: int) -> tuple:
    each = width // 5
    return (each,) * 4 + (width - 4 * each,)


def _width(planes: int) -> int:
    return int(math.floor(planes * BASE_WIDTH / 64.0))


def _bn(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "norm_weight"),
            (f"{name}.bias", (c,), "norm_bias"),
            (f"{name}.running_mean", (c,), "mean"),
            (f"{name}.running_var", (c,), "var"),
            (f"{name}.num_batches_tracked", (), "count")]


def _gn(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "norm_weight"),
            (f"{name}.bias", (c,), "norm_bias")]


def blocks(backbone: str):
    """(name, inplanes, planes, stride, first) of every Bottle2neck."""
    inplanes = 64
    for li, (planes, depth) in enumerate(zip(PLANES, DEPTHS[backbone])):
        for b in range(depth):
            yield (f"base.layer{li + 1}.{b}", inplanes, planes,
                   1 if li == 0 or b else 2, b == 0)
            inplanes = planes * EXPANSION


def spec(backbone: str) -> list:
    """(name, shape, kind) of every tensor of the state dict; the
    gOctConvs' dense weights are kind ``"goct"``."""
    out = [("base.conv1.0.weight", (32, 3, 3, 3), "conv"),
           *_bn("base.conv1.1", 32),
           ("base.conv1.3.weight", (32, 32, 3, 3), "conv"),
           *_bn("base.conv1.4", 32),
           ("base.conv1.6.weight", (64, 32, 3, 3), "conv"),
           *_bn("base.bn1", 64)]
    for name, inplanes, planes, _, first in blocks(backbone):
        w = _width(planes)
        out += [(f"{name}.conv1.weight", (w * SCALE, inplanes, 1, 1), "conv"),
                *_bn(f"{name}.bn1", w * SCALE)]
        for i in range(SCALE - 1):
            out.append((f"{name}.convs.{i}.weight", (w, w, 3, 3), "conv"))
        for i in range(SCALE - 1):
            out += _bn(f"{name}.bns.{i}", w)
        out += [(f"{name}.conv3.weight", (planes * EXPANSION, w * SCALE, 1, 1),
                 "conv"), *_bn(f"{name}.bn3", planes * EXPANSION)]
        if first:
            out += [(f"{name}.downsample.1.weight",
                     (planes * EXPANSION, inplanes, 1, 1), "conv"),
                    *_bn(f"{name}.downsample.2", planes * EXPANSION)]
    for prefix, cin, cout in (("fuse", FUSE_IN, FUSE_OUT),
                              ("fuse1x1", FUSE_OUT, (sum(FUSE_OUT),))):
        out.append((f"{prefix}.conv.weights", (sum(cout), sum(cin), 1, 1),
                    "goct"))
        for j, c in enumerate(cout):
            out += _gn(f"{prefix}.bns.{j}", c)
            out.append((f"{prefix}.prelus.{j}.weight", (c,), "prelu"))
        if prefix == "fuse":
            for i, c in enumerate(FUSE_OUT):
                ds = _dil_split(c)
                for k, ck in enumerate(ds):
                    out.append((f"ms.convs.{i}.msconv.{k}.weight",
                                (ck, c, 3, 3), "conv"))
                out += _gn(f"ms.convs.{i}.bn", sum(ds))
                out.append((f"ms.convs.{i}.prelu.weight", (sum(ds),),
                            "prelu"))
    out += [("cls_layer.weight", (1, sum(FUSE_OUT), 1, 1), "conv"),
            ("cls_layer.bias", (1,), "conv_bias")]
    return out


def _bn_relu(x, p, name, norms: Norms) -> torch.Tensor:
    return F.relu(norms.bn(x, p, name, frozen=True))


def bottle2neck(x, p, name, stride, first, norms: Norms) -> torch.Tensor:
    out = _bn_relu(conv(x, p[f"{name}.conv1.weight"]), p, f"{name}.bn1",
                   norms)
    chunks = torch.split(out, out.shape[1] // SCALE, dim=1)
    cat, sp = [], None
    for i in range(SCALE - 1):
        sp = chunks[i] if i == 0 or first else sp + chunks[i]
        sp = conv(sp, p[f"{name}.convs.{i}.weight"], stride=stride,
                  padding=1)
        sp = _bn_relu(sp, p, f"{name}.bns.{i}", norms)
        cat.append(sp)
    cat.append(F.avg_pool2d(chunks[-1], 3, stride, 1) if first
               else chunks[-1])
    y = norms.bn(conv(torch.cat(cat, dim=1), p[f"{name}.conv3.weight"]), p,
                 f"{name}.bn3", frozen=True)
    r = x
    if first:
        if stride > 1:
            r = F.avg_pool2d(x, stride, stride, 0, ceil_mode=True,
                             count_include_pad=False)
        r = norms.bn(conv(r, p[f"{name}.downsample.1.weight"]), p,
                     f"{name}.downsample.2", frozen=True)
    return F.relu(y + r)


def backbone_forward(p, x, backbone: str, norms: Norms) -> list:
    x = _bn_relu(conv(x, p["base.conv1.0.weight"], stride=2, padding=1), p,
                 "base.conv1.1", norms)
    x = _bn_relu(conv(x, p["base.conv1.3.weight"], padding=1), p,
                 "base.conv1.4", norms)
    x = _bn_relu(conv(x, p["base.conv1.6.weight"], padding=1), p,
                 "base.bn1", norms)
    x = F.max_pool2d(x, 3, 2, 1)
    feats, layer = [], "layer1"
    for name, _, _, stride, first in blocks(backbone):
        if name.split(".")[1] != layer:
            feats.append(x)
            layer = name.split(".")[1]
        x = bottle2neck(x, p, name, stride, first, norms)
    feats.append(x)
    return feats


def goct_csf(xs: list, w: torch.Tensor, cin, cout) -> list:
    io = [0]
    for c in cin:
        io.append(io[-1] + c)
    oo = [0]
    for c in cout:
        oo.append(oo[-1] + c)
    out = [None] * len(cout)
    for i, x in enumerate(xs):
        for j in range(len(cout)):
            wij = w[oo[j]:oo[j + 1], io[i]:io[i + 1]]
            target = xs[j].shape[2:]
            if i == j:
                y = conv(x, wij)
            elif i > j:
                y = resize(conv(x, wij), target)
            else:
                y = conv(resize(x, target), wij)
            out[j] = y if out[j] is None else out[j] + y
    return out


def forward(p: dict, x: torch.Tensor, backbone: str,
            norms: Norms | None = None) -> torch.Tensor:
    """Normalized images, NCHW -> logits (N, 1, H, W)."""
    norms = norms or Norms("eval")
    hw = x.shape[2:]
    feats = backbone_forward(p, x, backbone, norms)
    ys = goct_csf(feats, p["fuse.conv.weights"], FUSE_IN, FUSE_OUT)
    ys = [norms.gn_prelu(y, p, f"fuse.bns.{j}", f"fuse.prelus.{j}")
          for j, y in enumerate(ys)]
    ms = []
    for i, y in enumerate(ys):
        ds = _dil_split(FUSE_OUT[i])
        z = torch.cat([conv(y, p[f"ms.convs.{i}.msconv.{k}.weight"],
                            padding=d, dilation=d)
                       for k, d in enumerate(DILATIONS) if ds[k]], dim=1)
        ms.append(norms.gn_prelu(z, p, f"ms.convs.{i}.bn",
                                 f"ms.convs.{i}.prelu"))
    y = goct_csf(ms, p["fuse1x1.conv.weights"], FUSE_OUT, (sum(FUSE_OUT),))[0]
    y = norms.gn_prelu(y, p, "fuse1x1.bns.0", "fuse1x1.prelus.0")
    logits = conv(y, p["cls_layer.weight"], p["cls_layer.bias"])
    return resize(logits, hw)


def is_frozen(name: str) -> bool:
    """The reference Solver freezes the backbone's top ``bn1``, every
    block's ``bn1`` / ``bns`` / ``bn3`` affine and the shortcut's conv; the
    stem's BNs and the shortcut's BN train."""
    parts = name.split(".")
    if parts[0] != "base":
        return False
    if parts[1] == "bn1":
        return True
    if not parts[1].startswith("layer"):
        return False
    if parts[3] == "downsample":
        return parts[4] == "1"
    return parts[3] in ("bn1", "bns", "bn3")
