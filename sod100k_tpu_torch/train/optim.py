"""Optimizers and LR schedules of the reference training recipes.

Port of ``sod100k_tpu/train/optim.py``. Adam_dynamic_weight_decay
(train.py:97-123): torch Adam, betas (0.9, 0.99), eps 1e-8, L2 weight decay
added to the gradient *before* the moment updates (torch Adam's
``weight_decay``; the JAX package's ``optax.add_decayed_weights`` before
``scale_by_adam``), with wd = 0 on the BN weights of ILBlock conv1x1 /
conv3x3_1. The reference lists 'conv3x3_1.bns' twice and never
'conv3x3_2.bns' (train.py:102-104), so conv3x3_2 gammas keep normal decay;
``decay_conv3x3_2=False`` exempts them too, deliberately.

Learning rate: the JAX package multiplies the transform's update by ``lr``
after it; here the train step writes ``lr`` into every param group
(``set_lr``) before ``optimizer.step()``, which is the same update for Adam
and for SGD. The optimizers are built with lr 0, so a step taken without
``set_lr`` moves nothing.

LR schedules: MultiStepLR with gamma 0.1 stepped at the *start* of every
epoch (train.py:152-157), so a milestone m takes effect when epoch+1 >= m;
cosine annealing for finetuning (finetune.py).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def wd_exempt(model: nn.Module, decay_conv3x3_2: bool = True) -> list[str]:
    """Names of the parameters without weight decay: the BN weights of the
    ILBlock CBRs named by the reference's group split (train.py:101-107)."""
    cbrs = ["conv1x1", "conv3x3_1"] + ([] if decay_conv3x3_2 else ["conv3x3_2"])
    bns = {name for name, m in model.named_modules()
           if isinstance(m, nn.BatchNorm2d) and name.startswith("stage")
           and name.split(".")[2] in cbrs}
    return [name for name, _ in model.named_parameters()
            if name.endswith(".weight") and name.rsplit(".", 1)[0] in bns]


def make_adam_dwd(model: nn.Module, weight_decay: float = 5e-3,
                  b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                  decay_conv3x3_2: bool = True) -> torch.optim.Adam:
    """Adam with L2 decay on every parameter but ``wd_exempt``'s: two param
    groups, decayed first."""
    exempt = set(wd_exempt(model, decay_conv3x3_2))
    params = list(model.named_parameters())
    return torch.optim.Adam(
        [{"params": [p for n, p in params if n not in exempt],
          "weight_decay": weight_decay},
         {"params": [p for n, p in params if n in exempt],
          "weight_decay": 0.0}],
        lr=0.0, betas=(b1, b2), eps=eps)


def make_adam(model: nn.Module, weight_decay: float = 0.0, b1: float = 0.9,
              b2: float = 0.99, eps: float = 1e-8) -> torch.optim.Adam:
    """Plain Adam (+uniform L2) for finetuning."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


def make_sgd(model: nn.Module, momentum: float = 0.95,
             weight_decay: float = 0.0) -> torch.optim.SGD:
    """SGD with heavy-ball momentum: ``optax.trace(decay=momentum)`` is
    torch SGD with ``dampening=0`` and no Nesterov."""
    return torch.optim.SGD(model.parameters(), lr=0.0, momentum=momentum,
                           dampening=0.0, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next ``optimizer.step()``, in every group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def multistep_lr(base_lr: float, steps: Sequence[int], epoch: int,
                 gamma: float = 0.1) -> float:
    """torch MultiStepLR with the reference's step-at-epoch-start quirk."""
    drops = sum(1 for m in steps if epoch + 1 >= m)
    return base_lr * gamma**drops


def cosine_lr(base_lr: float, epoch: int, max_epochs: int,
              min_lr: float = 0.0) -> float:
    """torch CosineAnnealingLR(T_max=max_epochs) sampled per epoch."""
    t = min(epoch, max_epochs)
    return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t / max_epochs))
