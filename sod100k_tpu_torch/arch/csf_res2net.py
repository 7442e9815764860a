"""CSF+Res2Net as an ``nn.Module`` (NCHW inside, NHWC at the edges).

Port of ``sod100k_tpu/arch/csf_res2net.py:35-241,296-310``:

- Res2Net v1b: a 3-conv stem (stride 2) + BN/ReLU + 3x3/2 max pool, four
  stages of Bottle2neck blocks (base width 26, scale 4): a 4-way channel
  split with cascaded 3x3 convs and a running sum, avg-pool downsample
  shortcuts. The backbone's batch norms always normalize with their
  running statistics, in training too (the reference trains under
  ``net.eval()``): ``CSFNet.train()`` changes nothing in the forward, and
  gradients still reach the BN affines that the reference trains.
- The CSF head: a 4-octave gOctConv fuse ([256, 512, 1024, 2048] ->
  [128, 256, 512, 512]) in the CSF resampling dialect with GroupNorm(32),
  a PallMSBlock of plain convs with width//5 dilation splits, a gOctConv
  1x1 fuse to one 1408-channel branch, the classifier and a bilinear
  resize to the input size.

Module names reproduce the reference's state_dict keys
(``base.conv1.0.weight``, ``base.layer3.5.convs.2.weight``,
``base.layer2.0.downsample.1.weight``, ``fuse.conv.weights``,
``ms.convs.0.msconv.3.weight``, ``cls_layer.bias``), so the JAX package's
parameters (through ``interop.torch_ckpt``) and reference checkpoints load
with ``strict=True``. res2net50 and res2net101 differ only in the stage
depths. The model builds on the card unless the caller names another
device. ``fetch_res2net_weights`` downloads the published ImageNet
backbones (``sod100k_tpu/arch/csf_res2net.py:246-293``).

``forward(x, spatial=ctx)`` runs on row bands under a 2-D mesh
(``parallel.spatial``): the convolutions, the stem's max pool, the
Bottle2neck pools and the head's resizes fetch the rows they read from the
other ranks of the spatial group, the head's group norms take each image's
statistics over the group, and the frozen backbone BNs stay local.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..interop.torch_ckpt import load_checkpoint
from ..ops.conv import ConvWeight, conv2d
from ..ops.goct import GOctCBR, PallMSBlock, _bn
from ..ops.norm import batchnorm_infer
from ..ops.resample import avg_pool_torch, max_pool_torch, resize_bilinear
from ..parallel.spatial import SpatialCtx, like, tag
from .csnet import count_params  # noqa: F401  (one count for both families)

LAYERS = {"res2net50": (3, 4, 6, 3), "res2net101": (3, 4, 23, 3)}
BASE_WIDTH = 26
SCALE = 4
EXPANSION = 4
PLANES = (64, 128, 256, 512)

FUSE_IN = (256, 512, 1024, 2048)
FUSE_OUT = (128, 256, 512, 512)
CONV_STD = 0.01  # the reference Solver's init of every nn.Conv2d
# the downsampling at the input of the deepest true strided conv: layer4's
# stride-2 conv sees H/16 (``sod100k_tpu/arch/csf_res2net.py:46``); the 2-D
# mesh's extent check keys off it (``parallel.mesh.check_spatial_extent``)
DEEPEST_STRIDE2_FACTOR = 16


def _dil_split(width: int) -> tuple[int, ...]:
    each = width // 5
    return (each,) * 4 + (width - 4 * each,)


MS_DIL_SPLITS = tuple(_dil_split(w) for w in FUSE_OUT)


def _width(planes: int) -> int:
    return int(math.floor(planes * (BASE_WIDTH / 64.0)))


def _bn_relu(x: torch.Tensor, bn: nn.BatchNorm2d,
             sp: SpatialCtx | None = None) -> torch.Tensor:
    return like(F.relu(batchnorm_infer(x, bn)), x, sp)


class Bottle2neck(nn.Module):
    """Res2Net v1b bottleneck. ``stage`` blocks (the first of each layer)
    convolve every split chunk from its own input, pool the passthrough
    chunk and carry the avg-pool + 1x1 conv + BN shortcut (``downsample``,
    indices 1 and 2 as in the reference's Sequential)."""

    def __init__(self, inplanes: int, planes: int, stride: int, stage: bool,
                 *, device=None):
        super().__init__()
        w = _width(planes)
        self.width, self.stride, self.stage = w, stride, stage
        self.conv1 = ConvWeight(w * SCALE, inplanes, 1, device=device)
        self.bn1 = _bn(w * SCALE, device)
        self.convs = nn.ModuleList(ConvWeight(w, w, 3, device=device)
                                   for _ in range(SCALE - 1))
        self.bns = nn.ModuleList(_bn(w, device) for _ in range(SCALE - 1))
        self.conv3 = ConvWeight(planes * EXPANSION, w * SCALE, 1,
                                device=device)
        self.bn3 = _bn(planes * EXPANSION, device)
        if stage:
            self.downsample = nn.ModuleDict({
                "1": ConvWeight(planes * EXPANSION, inplanes, 1,
                                device=device),
                "2": _bn(planes * EXPANSION, device)})

    def forward(self, x: torch.Tensor,
                spatial: SpatialCtx | None = None) -> torch.Tensor:
        ctx = spatial
        out = _bn_relu(conv2d(x, self.conv1.weight, spatial=ctx), self.bn1,
                       ctx)
        spx = [like(t, out, ctx) for t in torch.split(out, self.width, dim=1)]
        cat = []
        sp = None
        for i in range(SCALE - 1):
            sp = spx[i] if i == 0 or self.stage else like(sp + spx[i], sp,
                                                          ctx)
            sp = conv2d(sp, self.convs[i].weight, stride=self.stride,
                        padding=1, spatial=ctx)
            sp = _bn_relu(sp, self.bns[i], ctx)
            cat.append(sp)
        cat.append(avg_pool_torch(spx[-1], 3, self.stride, 1, spatial=ctx)
                   if self.stage else spx[-1])
        y = like(torch.cat(cat, dim=1), cat[0], ctx)
        out = batchnorm_infer(conv2d(y, self.conv3.weight, spatial=ctx),
                              self.bn3)
        if self.stage:
            r = x
            if self.stride > 1:
                r = avg_pool_torch(x, self.stride, self.stride, 0,
                                   ceil_mode=True, count_include_pad=False,
                                   spatial=ctx)
            r = batchnorm_infer(conv2d(r, self.downsample["1"].weight,
                                       spatial=ctx), self.downsample["2"])
        else:
            r = x
        return like(F.relu(out + r), cat[0], ctx)


class Res2Net(nn.Module):
    """The Res2Net v1b backbone: the stem and ``layer1``..``layer4``."""

    def __init__(self, backbone: str, *, device=None):
        super().__init__()
        self.conv1 = nn.ModuleDict({
            "0": ConvWeight(32, 3, 3, device=device),
            "1": _bn(32, device),
            "3": ConvWeight(32, 32, 3, device=device),
            "4": _bn(32, device),
            "6": ConvWeight(64, 32, 3, device=device)})
        self.bn1 = _bn(64, device)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip(PLANES,
                                                  LAYERS[backbone])):
            layer = nn.ModuleList()
            for b in range(blocks):
                layer.append(Bottle2neck(inplanes, planes,
                                         1 if li == 0 or b else 2, b == 0,
                                         device=device))
                inplanes = planes * EXPANSION
            self.add_module(f"layer{li + 1}", layer)

    def forward(self, x: torch.Tensor, spatial: SpatialCtx | None = None,
                depth: int = len(PLANES)) -> list[torch.Tensor]:
        """NCHW image batch (row bands under ``spatial``) -> the features
        of the first ``depth`` layers (all four by default)."""
        s, ctx = self.conv1, spatial
        x = _bn_relu(conv2d(x, s["0"].weight, stride=2, padding=1,
                            spatial=ctx), s["1"], ctx)
        x = _bn_relu(conv2d(x, s["3"].weight, padding=1, spatial=ctx),
                     s["4"], ctx)
        x = _bn_relu(conv2d(x, s["6"].weight, padding=1, spatial=ctx),
                     self.bn1, ctx)
        x = max_pool_torch(x, 3, 2, 1, spatial=ctx)
        feats = []
        for li in range(depth):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x, ctx)
            feats.append(x)
        return feats


class CSFNet(nn.Module):
    """CSF head on a Res2Net backbone (``"res2net50"`` or ``"res2net101"``),
    initialized from a ``torch.Generator`` seeded with ``seed`` with the
    JAX package's distributions: every plain conv N(0, 0.01), the gOctConv
    dense weights U(+-sqrt(1/cin)), BN weight 1, bias 0, running mean 0,
    var 1; GN 1/0; PReLU 0.25; classifier bias 0."""

    def __init__(self, backbone: str = "res2net50", *, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if backbone not in LAYERS:
            raise ValueError(f"unknown backbone {backbone!r}; one of "
                             f"{sorted(LAYERS)}")
        self.backbone = backbone
        self.base = Res2Net(backbone, device=device)
        self.fuse = GOctCBR(FUSE_IN, FUSE_OUT, 1, flavor="csf", norm="gn",
                            device=device)
        self.ms = PallMSBlock(FUSE_OUT, MS_DIL_SPLITS, norm="gn", x100=False,
                              device=device)
        self.fuse1x1 = GOctCBR(FUSE_OUT, (sum(FUSE_OUT),), 1, flavor="csf",
                               norm="gn", device=device)
        self.cls_layer = ConvWeight(1, sum(FUSE_OUT), 1, bias=True,
                                    device=device)
        gen = torch.Generator().manual_seed(seed)
        goct = {self.fuse.conv, self.fuse1x1.conv}
        with torch.no_grad():
            for m in self.modules():
                if not isinstance(m, ConvWeight):
                    continue
                w = m.weight
                if m in goct:
                    bound = math.sqrt(1.0 / w.shape[1])
                    r = torch.rand(w.shape, generator=gen)
                    w.copy_((r * 2.0 - 1.0) * bound)
                else:
                    w.copy_(torch.randn(w.shape, generator=gen) * CONV_STD)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x: torch.Tensor,
                spatial: SpatialCtx | None = None) -> torch.Tensor:
        """NHWC image batch -> NHWC saliency logits at the input size.
        Under ``spatial``, ``x`` and the result are this rank's row bands
        of images of height ``spatial.image_h``."""
        sp = spatial
        img = x.permute(0, 3, 1, 2).contiguous()
        hw = x.shape[1:3]
        if sp is not None:
            hw = (sp.image_h, x.shape[2])
            tag(img, sp.image_h)
        feats = self.base(img, sp)
        y = self.fuse1x1(self.ms(self.fuse(feats, None, sp), None, sp),
                         None, sp)
        logits = conv2d(y[0], self.cls_layer.weight, self.cls_layer.bias,
                        spatial=sp)
        return resize_bilinear(logits, hw, sp).permute(0, 2, 3, 1)


# Published ImageNet weights (reference csf_res2net.py:15-18). The filename
# suffix is the torch-hub convention: first 8 hex chars of the file's sha256.
RES2NET_URLS = {
    "res2net50": "https://shanghuagao.oss-cn-beijing.aliyuncs.com/res2net/"
                 "res2net50_v1b_26w_4s-3cf99910.pth",
    "res2net101": "https://shanghuagao.oss-cn-beijing.aliyuncs.com/res2net/"
                  "res2net101_v1b_26w_4s-0812c246.pth",
}


def fetch_res2net_weights(backbone: str = "res2net50",
                          cache_dir: str | None = None,
                          timeout: float = 60.0) -> str | None:
    """Download (once) the published ImageNet checkpoint for ``backbone``
    into ``cache_dir`` (``~/.cache/sod100k_tpu_torch``) and return its
    path. The torch-hub sha256 prefix in the filename is checked: a
    mismatch raises ``ValueError``. The download goes to a ``.part`` file
    renamed only when whole and verified. Returns None when the network is
    unreachable (the reference's download is optional,
    csf_res2net.py:143-144; the caller trains from the seeded init)."""
    import hashlib
    import urllib.error
    import urllib.request

    url = RES2NET_URLS[backbone]
    fname = url.rsplit("/", 1)[1]
    want_prefix = fname.rsplit("-", 1)[1].split(".")[0]
    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "sod100k_tpu_torch")
    path = os.path.join(cache_dir, fname)
    if os.path.isfile(path):
        return path
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            h = hashlib.sha256()
            while chunk := r.read(1 << 20):
                h.update(chunk)
                f.write(chunk)
        if not h.hexdigest().startswith(want_prefix):
            os.remove(tmp)
            raise ValueError(
                f"checksum mismatch for {fname}: got {h.hexdigest()[:8]}, "
                f"want {want_prefix}")
        os.replace(tmp, path)
        return path
    except (urllib.error.URLError, OSError, TimeoutError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def load_res2net_backbone(model: CSFNet, torch_path: str):
    """Overlay an ImageNet res2net50/101_v1b checkpoint (top-level
    ``conv1.*``, ``bn1.*``, ``layer*`` keys) onto ``model.base``: ``fc.*``
    is dropped and anything the file lacks keeps its value (the reference's
    ``strict=False`` load). Returns ``load_state_dict``'s missing and
    unexpected keys. The file is unpickled fully: load only files you
    trust."""
    device = next(model.parameters()).device
    state, _ = load_checkpoint(torch_path, map_location=device)
    base = {k: v for k, v in state.items() if not k.startswith("fc.")}
    return model.base.load_state_dict(base, strict=False)
