"""Weighted F-measure (Margolin et al., CVPR 2014).

Port of ``sod100k_tpu/metrics/wfmeasure.py``. Each pixel's error is
weighed by its dependency on nearby foreground errors and by its distance
from the foreground:

  E   = |sal - gt|                       (gt binary {0,1}, sal in [0,1])
  Et  = E with every background pixel replaced by the error at its nearest
        foreground pixel (Euclidean distance transform with indices)
  EA  = Et convolved with a 7x7 sigma-5 Gaussian (zero-padded borders)
  Emin= min(E, EA) on foreground pixels where smoothing reduced the error;
        E elsewhere
  B   = 1 on foreground; 2 - exp(ln(0.5)/5 * dist_to_fg) on background
  Ew  = Emin * B
  TPw = |FG| - sum(Ew over FG),  FPw = sum(Ew over BG)
  Rw  = 1 - mean(Ew over FG),    Pw  = TPw / (TPw + FPw + eps)
  Fbw = (1 + beta2) Pw Rw / (beta2 Pw + Rw + eps),  beta2 = 1

``weighted_f_measure``, ``weighted_f_measure_batch`` and
``precompute_wf_tables`` are carried over unchanged (numpy + scipy, on the
host). ``wf_per_image_device`` is torch: the distance transform depends
only on the GT, so its tables are precomputed once per split and the
device does one gather, the Gaussian and masked sums. The Gaussian runs as
two 1-D passes of 7 shifted multiply-adds in f32 (the 7x7 kernel is the
outer product of its normalized 1-D factor), not ``F.conv2d``, so the
result does not depend on whether cuDNN may use TF32.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12
BETA2 = 1.0  # the paper uses beta^2 = 1 (harmonic mean), unlike F-beta's 0.3


def _gauss_kernel(size: int = 7, sigma: float = 5.0) -> np.ndarray:
    half = (size - 1) / 2.0
    g = np.arange(size) - half
    k = np.exp(-(g[:, None] ** 2 + g[None, :] ** 2) / (2.0 * sigma**2))
    return k / k.sum()


def _gauss_1d(size: int = 7, sigma: float = 5.0) -> np.ndarray:
    """The 1-D factor g / sum(g) of ``_gauss_kernel``:
    outer(g, g) / sum(outer(g, g)) = outer(g / sum(g), g / sum(g))."""
    g = np.exp(-(np.arange(size) - (size - 1) / 2.0) ** 2 / (2.0 * sigma**2))
    return g / g.sum()


def weighted_f_measure(sal: np.ndarray, gt: np.ndarray) -> float:
    """Fbw for one image. sal: float map scaled to [0,1]; gt: binary
    foreground mask (any dtype; nonzero = foreground). Shapes must match."""
    from scipy.ndimage import convolve, distance_transform_edt

    sal = np.asarray(sal, np.float64)
    fg = np.asarray(gt).astype(bool)
    assert sal.shape == fg.shape, (sal.shape, fg.shape)
    if not fg.any():
        return 0.0

    err = np.abs(sal - fg.astype(np.float64))
    dist, idx = distance_transform_edt(~fg, return_indices=True)
    dep = err.copy()
    bg = ~fg
    dep[bg] = err[idx[0][bg], idx[1][bg]]
    smoothed = convolve(dep, _gauss_kernel(), mode="constant", cval=0.0)
    emin = np.where(fg & (smoothed < err), smoothed, err)
    weight = np.where(bg, 2.0 - np.exp(np.log(0.5) / 5.0 * dist), 1.0)
    ew = emin * weight

    n_fg = float(fg.sum())
    tpw = n_fg - float(ew[fg].sum())
    fpw = float(ew[bg].sum())
    recall = 1.0 - float(ew[fg].mean())
    precision = tpw / (tpw + fpw + EPS)
    return float((1.0 + BETA2) * recall * precision
                 / (recall + BETA2 * precision + EPS))


def precompute_wf_tables(gts_u8: np.ndarray, hws: np.ndarray) -> dict:
    """GT-static tables for ``wf_per_image_device``.

    gts_u8: (N, ch, cw) uint8 native-GT canvas; hws: (N, 2) valid extents.
    Foreground is gt > 128. Returns numpy {"wf_idx": (N, ch*cw) int32, the
    flat canvas index of the nearest foreground pixel (self on foreground,
    0 outside the crop or when the crop has no foreground), "wf_weight":
    (N, ch, cw) float32, the Margolin B weight (0 outside the crop)}."""
    from scipy.ndimage import distance_transform_edt

    n, ch, cw = gts_u8.shape
    idx_flat = np.zeros((n, ch * cw), np.int32)
    weight = np.zeros((n, ch, cw), np.float32)
    for i in range(n):
        h, w = int(hws[i, 0]), int(hws[i, 1])
        fg = gts_u8[i, :h, :w] > 128
        if not fg.any():
            continue  # the device scores 0 by its n_fg == 0 guard
        # within the crop: padding must not move the nearest foreground
        dist, idx = distance_transform_edt(~fg, return_indices=True)
        w_crop = np.where(fg, 1.0, 2.0 - np.exp(np.log(0.5) / 5.0 * dist))
        weight[i, :h, :w] = w_crop
        flat = np.zeros((ch, cw), np.int64)
        flat[:h, :w] = idx[0].astype(np.int64) * cw + idx[1]
        idx_flat[i] = flat.reshape(-1).astype(np.int32)
    return {"wf_idx": idx_flat, "wf_weight": weight}


def gaussian_smooth(x: torch.Tensor) -> torch.Tensor:
    """The 7x7 sigma-5 Gaussian of (B, H, W) ``x`` with zero borders, as two
    1-D passes of 7 shifted multiply-adds in f32."""
    g = [float(v) for v in np.float32(_gauss_1d())]
    h, w = x.shape[-2:]
    p = torch.nn.functional.pad(x.float(), (3, 3, 3, 3))
    rows = g[0] * p[:, :, 0:w]
    for k in range(1, 7):
        rows = rows + g[k] * p[:, :, k:k + w]
    out = g[0] * rows[:, 0:h]
    for k in range(1, 7):
        out = out + g[k] * rows[:, k:k + h]
    return out


def wf_per_image_device(sal01, gt_u8, mask, wf_idx, wf_weight):
    """Per-image weighted F-measure (B,) on the tensors' device, given the
    tables of ``precompute_wf_tables``. Matches ``weighted_f_measure`` to
    f32 accumulation error.

    sal01: (B, ch, cw) map in [0, 1]; gt_u8: (B, ch, cw) canvas GTs; mask:
    (B, ch, cw) validity; wf_idx: (B, ch*cw) int; wf_weight: (B, ch, cw)."""
    b, ch, cw = sal01.shape
    maskf = mask.float()
    fg = (gt_u8.float() > 128.0) & (maskf > 0)
    fgf = fg.float()
    err = torch.abs(sal01.float() - fgf) * maskf
    # background error replaced by the error at the nearest foreground pixel
    err_near = torch.gather(err.reshape(b, -1), 1,
                            wf_idx.long()).reshape(b, ch, cw)
    dep = torch.where(fg, err, err_near) * maskf
    # dep is zero outside the crop, so zero padding over the canvas equals
    # scipy's constant-0 convolution over the crop
    smoothed = gaussian_smooth(dep)
    emin = torch.where(fg & (smoothed < err), smoothed, err)
    ew = emin * wf_weight.float()
    n_fg = fgf.sum(dim=(1, 2))
    ew_fg = torch.sum(ew * fgf, dim=(1, 2))
    ew_bg = torch.sum(ew * maskf * (1.0 - fgf), dim=(1, 2))
    safe_n = torch.clamp(n_fg, min=1.0)
    tpw = n_fg - ew_fg
    recall = 1.0 - ew_fg / safe_n
    precision = tpw / (tpw + ew_bg + EPS)
    fbw = ((1.0 + BETA2) * recall * precision
           / (recall + BETA2 * precision + EPS))
    return torch.where(n_fg > 0, fbw, torch.zeros_like(fbw))


def weighted_f_measure_batch(sal: np.ndarray, gt: np.ndarray,
                             hw: np.ndarray | None = None) -> np.ndarray:
    """Fbw per image over a (possibly padded) batch. sal/gt: (N, H, W);
    hw: optional (N, 2) valid extents: the metric runs on the unpadded crop
    (padding must not count as background)."""
    out = np.empty(sal.shape[0], np.float64)
    for i in range(sal.shape[0]):
        if hw is not None:
            h, w = int(hw[i, 0]), int(hw[i, 1])
            out[i] = weighted_f_measure(sal[i, :h, :w], gt[i, :h, :w])
        else:
            out[i] = weighted_f_measure(sal[i], gt[i])
    return out
