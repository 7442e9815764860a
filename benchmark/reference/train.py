"""The recipes' training steps, plain PyTorch on a flat parameter dict.

CSNet (``CSNet_training/train.py``): BCE-with-logits, the mean over every
pixel (train.py:205-209), plus ``weight * penalty`` with the penalty
0.5 / batch * sum over the ILBlock CBRs' BNs of flop_weight * sum over the
batch and channels of |GAP(BN + PReLU output)| * gamma^2, the GAP detached
(csnet.py:324-330, 391-410; train.py:212-213). Adam (0.9, 0.99, eps 1e-8)
with L2 decay added to the gradient before the moments, none on the BN
weights that ``csnet.wd_exempt`` names.

CSF+Res2Net (``CSF+Res2Net/solver.py``): BCE-with-logits summed and
divided by iter_size * batch, gradients summed over ``iter_size``
micro-steps, Adam (0.9, 0.999, eps 1e-8) with L2 decay over the parameters
the Solver trains (``csf.is_frozen`` names the others).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import csf, csnet
from .common import Norms, normalize_u8


class Adam:
    """torch.optim.Adam's arithmetic with coupled L2 decay, per tensor:
    g += wd * p; m, v moments; p -= lr / (1 - b1^t) * m / (sqrt(v) /
    sqrt(1 - b2^t) + eps)."""

    def __init__(self, params: dict, decay: dict, b1: float, b2: float,
                 eps: float = 1e-8):
        self.params, self.decay = params, decay
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> dict:
        """Apply one update; returns the gradients as the moments got them
        (decay included)."""
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        seen = {}
        for k, p in self.params.items():
            g = grads[k] + self.decay[k] * p
            seen[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
        return seen


class CSNetRecipe:
    """The CSNet train step at ``batch``, from the state dict ``state``
    (copied: its floating tensors become the trained leaves)."""

    def __init__(self, state: dict, plan: csnet.Plan, *, batch: int,
                 penalty_weight: float, expand: float, weight_decay: float,
                 betas=(0.9, 0.99), eps: float = 1e-8):
        self.plan, self.batch, self.weight = plan, batch, penalty_weight
        self.state = {k: v.clone() for k, v in state.items()}
        names = {n for n, _, kind in csnet.spec(plan)
                 if kind not in ("mean", "var", "count")}
        self.params = {k: self.state[k] for k in sorted(names)}
        self.fw = csnet.flop_weights(plan, expand)
        self.opt = Adam(self.params, {k: 0.0 if csnet.wd_exempt(k)
                                      else weight_decay for k in self.params},
                        *betas, eps)

    def loss(self, image_u8: torch.Tensor, target_u8: torch.Tensor,
             penalty_on: float = 1.0):
        norms = Norms("train", gap=True)
        logits = csnet.forward(self.state, normalize_u8(image_u8), self.plan,
                               norms)
        target = target_u8.permute(0, 3, 1, 2).float() / 255.0
        bce = F.binary_cross_entropy_with_logits(logits, target)
        pen = 0.5 * sum(w * torch.sum(norms.gap[k]
                                      * self.state[k + ".weight"].square())
                        for k, w in self.fw.items()) / self.batch
        return bce + penalty_on * self.weight * pen, bce, pen

    def step(self, image_u8, target_u8, lr: float) -> dict:
        for p in self.params.values():
            p.requires_grad_(True)
        total, bce, pen = self.loss(image_u8, target_u8)
        grads = torch.autograd.grad(total, list(self.params.values()))
        for p in self.params.values():
            p.requires_grad_(False)
        seen = self.opt.step(dict(zip(self.params, grads)), lr)
        return {"loss": float(bce.detach()), "penalty": float(pen.detach()),
                "grads": seen}


class CSFRecipe:
    """The CSF Solver's step: ``iter_size`` micro-batches, one update."""

    def __init__(self, state: dict, backbone: str, *, batch: int,
                 iter_size: int, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.backbone, self.batch, self.iter_size = backbone, batch, iter_size
        self.state = {k: v.clone() for k, v in state.items()}
        self.params = {n: self.state[n] for n, _, kind in csf.spec(backbone)
                       if kind not in ("mean", "var", "count")
                       and not csf.is_frozen(n)}
        self.opt = Adam(self.params, {k: weight_decay for k in self.params},
                        *betas, eps)

    def micro_loss(self, image_u8, target_u8) -> torch.Tensor:
        logits = csf.forward(self.state, normalize_u8(image_u8),
                             self.backbone, Norms("train"))
        target = target_u8.permute(0, 3, 1, 2).float() / 255.0
        return F.binary_cross_entropy_with_logits(
            logits, target, reduction="sum") / (self.iter_size * self.batch)

    def step(self, micro_batches, lr: float) -> dict:
        """``micro_batches``: ``iter_size`` (image, target) u8 pairs."""
        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        losses = []
        for image, target in micro_batches:
            for p in self.params.values():
                p.requires_grad_(True)
            loss = self.micro_loss(image, target)
            g = torch.autograd.grad(loss, list(self.params.values()))
            for p in self.params.values():
                p.requires_grad_(False)
            for k, gk in zip(self.params, g):
                grads[k] += gk
            losses.append(float(loss.detach()))
        seen = self.opt.step(grads, lr)
        return {"loss": sum(losses), "grads": seen}
