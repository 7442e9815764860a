"""Plain operations shared by the reference models (NCHW activations).

Every norm goes through ``Norms``, which says how a batch norm normalizes:
from the running statistics (``"eval"``), from the batch (``"train"``,
biased variance, as ``nn.BatchNorm2d`` in training), or from the batch while
recording its mean and unbiased variance (``"calibrate"``: one seeded batch
sets the running statistics that both sides then serve with). In
``"train"`` mode it can also record the dynamic-weight-decay signal: the
detached |spatial mean| of every BN + PReLU output, per sample and channel.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-5
GN_GROUPS = 32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's and cuBLAS's float32 products on the tensor cores (TF32) on
    or off inside the block. The reference runs with it off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Norms:
    def __init__(self, mode: str = "eval", gap: bool = False):
        if mode not in ("eval", "train", "calibrate"):
            raise ValueError(f"unknown norm mode {mode!r}")
        self.mode = mode
        self.stats: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self.gap: dict[str, torch.Tensor] | None = {} if gap else None

    def bn(self, x: torch.Tensor, p: dict, name: str,
           frozen: bool = False) -> torch.Tensor:
        """Batch norm ``name`` (its ``.weight``, ``.bias``, running
        statistics in ``p``). ``frozen`` norms always use the running
        statistics, outside calibration."""
        w, b = p[name + ".weight"], p[name + ".bias"]
        if self.mode == "eval" or (frozen and self.mode == "train"):
            mean, var = p[name + ".running_mean"], p[name + ".running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.mode == "calibrate":
                self.stats[name] = (mean.detach(), x.detach().var(
                    dim=(0, 2, 3), unbiased=True))
        view = (1, -1, 1, 1)
        return ((x - mean.view(view)) * torch.rsqrt(var.view(view) + EPS)
                * w.view(view) + b.view(view))

    def bn_prelu(self, x: torch.Tensor, p: dict, bn: str, prelu: str,
                 frozen: bool = False) -> torch.Tensor:
        y = F.prelu(self.bn(x, p, bn, frozen), p[prelu + ".weight"])
        if self.gap is not None:
            self.gap[bn] = y.detach().mean(dim=(2, 3)).abs()
        return y

    def gn_prelu(self, x: torch.Tensor, p: dict, gn: str,
                 prelu: str) -> torch.Tensor:
        y = F.group_norm(x, GN_GROUPS, p[gn + ".weight"], p[gn + ".bias"],
                         EPS)
        return F.prelu(y, p[prelu + ".weight"])


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
         stride: int = 1, padding: int = 0, dilation: int = 1,
         groups: int = 1, x100: bool = False) -> torch.Tensor:
    """A convolution; ``x100`` is the reference's Conv2dX100 (the stored
    weight is a hundredth of the one applied)."""
    return F.conv2d(x, w * 100.0 if x100 else w, b, stride, padding,
                    dilation, groups)


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize, half-pixel centres, no antialiasing."""
    hw = tuple(int(v) for v in hw)
    if tuple(x.shape[2:]) == hw:
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> ImageNet-normalized f32 NCHW."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def fill_spec(spec, values: dict) -> dict:
    """A state dict of zeros with the spec's names and shapes, then the
    given values (used by shape-only passes)."""
    out = {}
    for name, shape, kind in spec:
        dtype = torch.int64 if kind == "count" else torch.float32
        out[name] = values.get(name, torch.zeros(shape, dtype=dtype))
    return out
