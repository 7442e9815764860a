"""Structure-measure (S-measure, Fan et al. ICCV 2017) as batched masked
reductions over (B, H, W).

Port of ``sod100k_tpu/metrics/smeasure.py``:

    S = alpha * S_object + (1 - alpha) * S_region,  alpha = 0.5
    gt all-background -> S = 1 - mean(sal); all-foreground -> S = mean(sal)

S_object weighs the fg/bg object scores 2*mean / (mean^2 + 1 + std + eps)
by mean(gt); S_region splits the image into 4 quadrants at the rounded GT
centroid and area-weights the paper's SSIM variant. Every statistic is a
masked sum over the whole batch at once; a validity mask makes padding
count for nothing, quadrant areas included. ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the centroid split is the JAX package's.
"""

from __future__ import annotations

import torch

EPS = 1e-8
ALPHA = 0.5


def _sum(x):
    return x.sum(dim=(-2, -1))


def _masked_mean(x, m):
    return _sum(x * m) / torch.clamp(_sum(m), min=1.0)


def _bcast(v):
    return v[..., None, None]


def _masked_var(x, m, mean):
    n = torch.clamp(_sum(m), min=1.0)
    # unbiased (N - 1), like the reference MATLAB cov/std
    return _sum(torch.square(x - _bcast(mean)) * m) / torch.clamp(n - 1.0,
                                                                  min=1.0)


def _object_score(x, region):
    mean = _masked_mean(x, region)
    std = torch.sqrt(_masked_var(x, region, mean))
    return 2.0 * mean / (torch.square(mean) + 1.0 + std + EPS)


def _s_object(sal, gt, valid):
    mu = _masked_mean(gt, valid)
    o_fg = _object_score(sal, gt * valid)
    o_bg = _object_score(1.0 - sal, (1.0 - gt) * valid)
    return mu * o_fg + (1.0 - mu) * o_bg


def _ssim_paper(sal, gt, m):
    n = torch.clamp(_sum(m), min=1.0)
    mx = _masked_mean(sal, m)
    my = _masked_mean(gt, m)
    vx = _masked_var(sal, m, mx)
    vy = _masked_var(gt, m, my)
    sxy = _sum((sal - _bcast(mx)) * (gt - _bcast(my)) * m) / torch.clamp(
        n - 1.0, min=1.0)
    alpha = 4.0 * mx * my * sxy
    beta = (torch.square(mx) + torch.square(my)) * (vx + vy)
    return torch.where(alpha != 0.0, alpha / (beta + EPS),
                       (beta == 0.0).float())


def _s_region(sal, gt, valid):
    h, w = gt.shape[-2:]
    rows = torch.arange(h, dtype=torch.float32,
                        device=gt.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32,
                        device=gt.device)[None, :].expand(h, w)
    gtv = gt * valid
    fg = _sum(gtv)
    total = torch.clamp(fg, min=EPS)
    # valid-image extent (padding sits at high indices)
    vh = torch.clamp((rows * valid).amax(dim=(-2, -1)), min=1.0) + 1.0
    vw = torch.clamp((cols * valid).amax(dim=(-2, -1)), min=1.0) + 1.0
    # centroid, rounded like the reference implementation
    cy = torch.round(_sum(rows * gtv) / total) + 1.0
    cx = torch.round(_sum(cols * gtv) / total) + 1.0
    cy = torch.where(fg == 0, torch.round(vh / 2.0), cy)
    cx = torch.where(fg == 0, torch.round(vw / 2.0), cx)

    top = rows < _bcast(cy)
    left = cols < _bcast(cx)
    area = torch.clamp(_sum(valid), min=1.0)
    score = torch.zeros_like(area)
    for q in (top & left, top & ~left, ~top & left, ~top & ~left):
        m = q.float() * valid
        score = score + _sum(m) / area * _ssim_paper(sal, gtv, m)
    return score


def s_measure_batch(sal: torch.Tensor, gt: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """S-measure per image (B,): sal in [0, 1], gt binary {0, 1} (> 0.5),
    both (B, H, W); optional validity mask for padded batches."""
    sal = sal.float()
    gt = (gt > 0.5).float()
    v = torch.ones_like(gt) if valid is None else valid.float()
    mu = _masked_mean(gt, v)
    s = ALPHA * _s_object(sal, gt, v) + (1 - ALPHA) * _s_region(sal, gt, v)
    mean_sal = _masked_mean(sal, v)
    s = torch.where(mu == 0.0, 1.0 - mean_sal,
                    torch.where(mu == 1.0, mean_sal, s))
    return torch.clamp(s, min=0.0)


def s_measure(sal: torch.Tensor, gt: torch.Tensor,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """S-measure of one (H, W) map."""
    return s_measure_batch(sal[None], gt[None],
                           None if valid is None else valid[None])[0]
