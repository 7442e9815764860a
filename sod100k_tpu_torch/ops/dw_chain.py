"""Fused ILBlock depthwise tail: CUDA kernel, its plain version, the caller.

Replaces the Pallas TPU kernel
``sod100k_tpu/ops/pallas/dw_chain.py::fused_dw_chain``. An ILBlock ends with
two depthwise 3x3 Conv2dX100 + BN + PReLU stages per octave branch; in eval
mode they run here as

    x -> dw3x3 -> *scale + shift (BN folded) -> PReLU -> round to x.dtype
      -> dw3x3 -> *scale + shift -> PReLU -> y (x.dtype)

with sums in f32 and f32 taps (x100 applied), scales, shifts and alphas.

On the card the bound is device-memory bytes: about 5 flops per byte in
bf16. Unfused, the two stages move the activation 4 times; the kernel
(``csrc/dw_chain.cu``) keeps the intermediate in shared memory and moves it
twice: read x, write y. For CSNet-L at 224^2 that is 2 x 2 B x 10.3 M
elements per image in bf16, out of 4 x 2 B x 10.3 M unfused. Its design
(one block per spatial tile, channel and image, the tile plus a 2-pixel
halo staged in shared memory) is in the source.

``fused_dw_chain`` takes the plain version (``fused_dw_chain_ref``) only for
a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches, so a run can show that the main path
went through the kernel. Inference only: the kernel has no backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_lib

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def _stage(x32: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
           b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    c = x32.shape[1]
    y = F.conv2d(x32, w.reshape(c, 1, 3, 3), padding=1, groups=c)
    y = y * s.view(1, c, 1, 1) + b.view(1, c, 1, 1)
    return torch.where(y >= 0, y, y * a.view(1, c, 1, 1))


def fused_dw_chain_ref(x, w1, s1, b1, a1, w2, s2, b2, a2) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (N, C, H, W) f32 or bf16;
    w (C, 3, 3) and s, b, a (C,) in f32."""
    t = _stage(x.float(), w1, s1, b1, a1).to(x.dtype)
    return _stage(t.float(), w2, s2, b2, a2).to(x.dtype)


def _check(x: torch.Tensor, params) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected (N, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dw_chain takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dw_chain needs a contiguous NCHW tensor")
    n, c, h, w = x.shape
    if min(n, c, h, w) == 0 or n > _MAX_GRID_YZ or c > _MAX_GRID_YZ:
        raise ValueError(f"dw_chain cannot launch on shape {tuple(x.shape)}")
    for i, p in enumerate(params):
        want = (c, 3, 3) if i % 4 == 0 else (c,)
        if p.device != x.device or p.dtype != torch.float32 or \
                tuple(p.shape) != want:
            raise ValueError(
                f"dw_chain parameter {i}: want float32 {want} on {x.device}, "
                f"got {p.dtype} {tuple(p.shape)} on {p.device}")


@functools.cache
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = cuda_lib.load("dw_chain").sod_dw_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_dw_chain(x, w1, s1, b1, a1, w2, s2, b2, a2) -> torch.Tensor:
    """Both depthwise stages of one octave branch in one kernel launch.

    x: (N, C, H, W) contiguous, float32 or bfloat16; w1, w2: (C, 3, 3)
    effective taps; s, b: folded BN scale and shift; a: PReLU alpha, all
    float32 on x's device. CPU tensors take ``fused_dw_chain_ref``.
    """
    global launches
    params = (w1, s1, b1, a1, w2, s2, b2, a2)
    if x.device.type == "cpu":
        return fused_dw_chain_ref(x, *params)
    if x.device.type != "cuda":
        raise ValueError(f"dw_chain runs on cpu or cuda, not {x.device}")
    _check(x, params)
    n, c, h, w = x.shape
    packed = torch.cat([w1.reshape(c, 9), s1[:, None], b1[:, None],
                        a1[:, None], w2.reshape(c, 9), s2[:, None],
                        b2[:, None], a2[:, None]], dim=1).contiguous()
    y = torch.empty_like(x)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), packed.data_ptr(), n, c, h, w,
                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dw_chain kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def fold_bn_eval(bn: torch.nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode batch norm as f32 (scale, shift)."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    scale = bn.weight.float() * inv
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return scale, shift


def dw_tail_fused(conv3x3_1, conv3x3_2, xset: list, split) -> list:
    """conv3x3_1 then conv3x3_2 (the two ``SimplifiedGOctCBR`` stages of an
    ILBlock) fused, per octave branch, from running statistics."""
    out = []
    for j, cj in enumerate(split):
        key = str(j)
        if cj == 0 or xset[j] is None or key not in conv3x3_1.convs:
            out.append(None)
            continue

        def prep(m):
            w = m.convs[key].weight[:, 0].float() * 100.0  # Conv2dX100
            s, b = fold_bn_eval(m.bns[key])
            return w, s, b, m.prelus[key].weight.float()

        out.append(fused_dw_chain(xset[j].contiguous(), *prep(conv3x3_1),
                                  *prep(conv3x3_2)))
    return out
