"""SalMetric (MAE, 256-threshold P/R/F, E-measure, adaptive F/E) as batched
tensor reductions.

Port of ``sod100k_tpu/metrics/salmetric.py``, which reproduces the
reference C++ tool (``CSNet_training/SalMetric/src/sal_metric.cpp``):

- MAE per image: mean(|sal - gt|) / 255 over raw grayscale values,
- precision/recall at 256 thresholds, strict comparisons (sal > th,
  gt > 128), EPSILON = 1e-4 added to numerator and denominator,
- per-threshold P/R macro-averaged over images, F with beta^2 = 0.3 from
  the averaged P/R, max-F over thresholds (strict >, argmax from 0).

Threshold counts: the JAX package compares every pixel with 16 thresholds
at a time (TPU scatters serialize). Here one histogram per image does it:
``index_add_`` of the mask and foreground weights into bin
``b * 256 + floor(clip(sal, 0, 255))``, then #(sal > th) = total -
cumsum[th]. The weights are 0/1 and a bin holds < 2^24, so the f32 sums
are exact in any order: the counts equal the JAX package's bit for bit,
on the card (atomics) as on the CPU. floor() keeps the 8-bit-PNG binning
for values that are not whole (100.7 bins as 100).
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLDS = 256
EPSILON = 1e-4
BETA2 = 0.3


def threshold_counts(sal: torch.Tensor, gt: torch.Tensor,
                     mask: torch.Tensor):
    """Per image: a[th] = #(sal > th) and tp[th] = #(sal > th, gt > 128)
    over the valid pixels, (B, 256) each; b = #(gt > 128) and n = #valid,
    (B,) each. Exact integers in f32. sal/gt: (B, H, W) in [0, 255]; mask:
    (B, H, W) validity (padding 0)."""
    sal = sal.float()
    mask = mask.float()
    pos = (gt.float() > THRESHOLDS / 2).float() * mask
    bsz = sal.shape[0]
    bins = torch.floor(sal.clamp(0, 255)).long().reshape(bsz, -1)
    bins = (bins + THRESHOLDS * torch.arange(bsz, device=sal.device)[:, None]
            ).reshape(-1)
    hist = torch.zeros(2, bsz * THRESHOLDS, dtype=torch.float32,
                       device=sal.device)
    hist[0].index_add_(0, bins, mask.reshape(-1))
    hist[1].index_add_(0, bins, pos.reshape(-1))
    cum = torch.cumsum(hist.reshape(2, bsz, THRESHOLDS), dim=-1)
    above = cum[..., -1:] - cum  # #(bin > th): exact, integers < 2^24
    return (above[0], above[1], pos.sum(dim=(1, 2)), mask.sum(dim=(1, 2)))


def per_image_stats(sal: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """Per-image (mae (B,), precision (B, 256), recall (B, 256), E-measure
    (B, 256)). sal/gt: (B, H, W) in [0, 255] (integral, as read from 8-bit
    PNGs); mask: (B, H, W) validity."""
    sal, gt, mask = sal.float(), gt.float(), mask.float()
    a_sum, ab, b_sum, npix = threshold_counts(sal, gt, mask)
    mae = torch.sum(torch.abs(sal - gt) / 255.0 * mask, dim=(1, 2)) / npix
    precision = (ab + EPSILON) / (a_sum + EPSILON)
    recall = (ab + EPSILON) / (b_sum[:, None] + EPSILON)
    emeasure = _e_measure_from_counts(ab, a_sum, b_sum[:, None],
                                      npix[:, None])
    return mae, precision, recall, emeasure


def _e_measure_from_counts(tp, a, b, n):
    """Enhanced-alignment measure (Fan et al. IJCAI'18) in closed form over
    the confusion counts; degenerate GTs take the official special cases
    (all-background scores the prediction's background count,
    all-foreground its foreground count); normalization n - 1
    (PySODMetrics)."""
    eps = 1e-12
    mu_f = a / n
    mu_g = b / n
    fp = a - tp
    fn = b - tp
    tn = n - a - b + tp

    def enhanced(df, dg):
        align = 2.0 * df * dg / (df * df + dg * dg + eps)
        return torch.square(align + 1.0) / 4.0

    e_sum = (tp * enhanced(1 - mu_f, 1 - mu_g)
             + fp * enhanced(1 - mu_f, -mu_g)
             + fn * enhanced(-mu_f, 1 - mu_g)
             + tn * enhanced(-mu_f, -mu_g))
    norm = n - 1.0 + eps
    e_general = e_sum / norm
    e_empty_gt = (n - a) / norm
    e_full_gt = a / norm
    return torch.where(b == 0, e_empty_gt,
                       torch.where(b == n, e_full_gt, e_general))


def _adaptive_binarize(sal, gt, mask):
    """Binarize each prediction at min(2 * its masked mean, 255) (>=), the
    GT at > 128; on the raw [0, 255] map, the dialect of the whole suite.
    Returns (binary, pos, npix) with npix clamped to >= 1."""
    sal = sal.float()
    mask = mask.float()
    npix = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
    mean = torch.sum(sal * mask, dim=(1, 2)) / npix
    th = torch.clamp(2.0 * mean, max=255.0)
    binary = (sal >= th[:, None, None]).float() * mask
    pos = (gt.float() > THRESHOLDS / 2).float() * mask
    return binary, pos, npix


def adaptive_f_per_image(sal, gt, mask):
    """Per-image adaptive F-measure (beta^2 = 0.3) from one binarization at
    min(2 * mean, 255); zero intersection (empty GT included) scores 0."""
    binary, pos, _ = _adaptive_binarize(sal, gt, mask)
    inter = torch.sum(binary * pos, dim=(1, 2))
    eps = 1e-12
    pre = inter / torch.clamp(binary.sum(dim=(1, 2)), min=eps)
    rec = inter / torch.clamp(pos.sum(dim=(1, 2)), min=eps)
    f = (1 + BETA2) * pre * rec / (BETA2 * pre + rec + eps)
    return torch.where(inter > 0, f, torch.zeros_like(f))


def adaptive_e_per_image(sal, gt, mask):
    """Per-image adaptive E-measure: the adaptive-F binarization scored by
    the E-measure closed form; an all-masked row scores 0."""
    binary, pos, npix = _adaptive_binarize(sal, gt, mask)
    tp = torch.sum(binary * pos, dim=(1, 2))
    a = binary.sum(dim=(1, 2))
    b = pos.sum(dim=(1, 2))
    e = _e_measure_from_counts(tp, a, b, npix)
    valid = mask.float().sum(dim=(1, 2)) > 0
    return torch.where(valid, e, torch.zeros_like(e))


def as_device_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return torch.as_tensor(v).to(device)


class SalMetricAccumulator:
    """Streaming macro-average accumulator over an image set. Each batch is
    uploaded once to ``device`` (the card unless named), where the three
    reductions share it; the sums are kept on the host in f64."""

    def __init__(self, device="cuda") -> None:
        from ..data.pipeline import require_device
        self.device = require_device(device)
        self.n = 0
        self.mae = 0.0
        self.precision = np.zeros(THRESHOLDS, np.float64)
        self.recall = np.zeros(THRESHOLDS, np.float64)
        self.emeasure = np.zeros(THRESHOLDS, np.float64)
        self.adaptive_f = 0.0
        self.adaptive_e = 0.0

    def update_batch(self, sal, gt, mask=None, count: int | None = None):
        """sal/gt: (B, H, W) in [0, 255]; mask marks valid pixels; count
        marks valid images (trailing padded images ignored)."""
        sal_d = as_device_tensor(sal, self.device).float()
        gt_d = as_device_tensor(gt, self.device).float()
        mask_d = (torch.ones_like(sal_d) if mask is None
                  else as_device_tensor(mask, self.device).float())
        mae, pre, rec, em = per_image_stats(sal_d, gt_d, mask_d)
        af = adaptive_f_per_image(sal_d, gt_d, mask_d)
        ae = adaptive_e_per_image(sal_d, gt_d, mask_d)
        k = sal_d.shape[0] if count is None else count
        self.n += k

        def total(v):
            return v[:k].sum(dim=0).double().cpu().numpy()

        self.mae += float(total(mae))
        self.precision += total(pre)
        self.recall += total(rec)
        self.emeasure += total(em)
        self.adaptive_f += float(total(af))
        self.adaptive_e += float(total(ae))

    def result(self) -> dict:
        assert self.n > 0, "no images accumulated"
        p = self.precision / self.n
        r = self.recall / self.n
        f = ((1 + BETA2) * p * r) / (BETA2 * p + r)
        # strict > with fmax initialized to 0 (sal_metric.cpp:151-172)
        argmax = 0
        fmax = 0.0
        for th in range(THRESHOLDS):
            if f[th] > fmax:
                fmax = float(f[th])
                argmax = th
        e = self.emeasure / self.n
        return {
            "mae": self.mae / self.n,
            "precision": p,
            "recall": r,
            "fmeasure": f,
            "max_f": fmax,
            "mean_f": float(f.mean()),
            "argmax": argmax,
            "precision_at_max": float(p[argmax]),
            "recall_at_max": float(r[argmax]),
            "mean_precision": float(p.mean()),
            "mean_recall": float(r.mean()),
            "emeasure": e,
            "max_e": float(e.max()),
            "mean_e": float(e.mean()),
            "adaptive_f": self.adaptive_f / self.n,
            "adaptive_e": self.adaptive_e / self.n,
        }


def result_from_sums(sums) -> dict:
    """The result dict from per-batch metric sums (each with a leading (nb,)
    batch axis; tensors on any device, or arrays), reduced across batches on
    the host in f64, plus "s_measure" (and "weighted_f" when present)."""

    def total(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().double().cpu().numpy()
        return np.asarray(v, np.float64).sum(axis=0)

    acc = SalMetricAccumulator(device="cpu")
    acc.n = int(round(float(total(sums["n"]))))
    acc.mae = float(total(sums["mae_sum"]))
    acc.precision = total(sums["p_sum"])
    acc.recall = total(sums["r_sum"])
    acc.emeasure = total(sums["e_sum"])
    if "a_sum" in sums:
        acc.adaptive_f = float(total(sums["a_sum"]))
    if "ae_sum" in sums:
        acc.adaptive_e = float(total(sums["ae_sum"]))
    res = acc.result()
    res["s_measure"] = float(total(sums["s_sum"])) / acc.n
    if "w_sum" in sums:
        res["weighted_f"] = float(total(sums["w_sum"])) / acc.n
    return res


def _g(v: float) -> str:
    """C++ `cout << float` default formatting: 6 significant digits."""
    return f"{v:g}"


def format_report(res: dict) -> str:
    """The reference CLI's stdout contract (sal_metric.cpp:164-185): 256
    threshold lines then exactly seven summary lines."""
    lines = []
    for th in range(THRESHOLDS):
        lines.append(
            f"Threshold {th}:\tMAE: {_g(res['mae'])}\tPrecision: "
            f"{_g(res['precision'][th])}\tRecall: {_g(res['recall'][th])}"
            f"\tFmeasure: {_g(res['fmeasure'][th])}"
        )
    lines.append(f"Max_F-measre:   {_g(res['max_f'])}")
    lines.append(f"Mean_F-measre:  {_g(res['mean_f'])}")
    lines.append(f"Precision:      {_g(res['precision_at_max'])}")
    lines.append(f"Recall:         {_g(res['recall_at_max'])}")
    lines.append(f"Mean_Precision: {_g(res['mean_precision'])}")
    lines.append(f"Mean_Recall:    {_g(res['mean_recall'])}")
    lines.append(f"MAE:            {_g(res['mae'])}")
    return "\n".join(lines) + "\n"
