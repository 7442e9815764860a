"""Dynamic weight decay: the FLOPs-aware BN-gamma penalty.

Port of ``sod100k_tpu/train/dynamic_wd.py``. The reference accumulates, per
ILBlock CBR batch-norm branch (forward hooks, csnet.py:391-410),

    0.5 * flop_weight(stage, branch) * sum_{n,c} |GAP(activation)|_{n,c} * gamma_c^2

with the GAP term detached, and adds ``AUTO.FLOPS.WEIGHT * total /
batch_size`` to the loss while epoch < AUTO.FINETUNE (train.py:212-213).
Here the train-mode forward records the GAP terms in an
``ops.goct.GapCollector`` and ``penalty`` turns them into a differentiable
penalty on the BN weights, so gradients flow only to gamma.

``flop_weight_map`` is a carried-over copy (pure Python); the port's tests
hold it against the JAX package's, key by key.
"""

from __future__ import annotations

import torch
from torch import nn

from ..arch.layer_config import LayerConfig

_CBRS = ("conv1x1", "conv3x3_1", "conv3x3_2")


def flop_weight_map(lc: LayerConfig, expandflop: float = 2.0) -> dict[str, float]:
    """Map of BN path ('stage1.2.conv1x1.bns.0') -> flop weight.

    Blocks are walked in module order; group sizes are [stages[0]+1,
    stages[1], stages[2], stages[3]] (stage0 is folded into the first group)
    and the g-th group's CBRs get expand^(len(stages)-1-g); within a CBR,
    branch k of B gets an extra expand^(B-1-k) (flops_hook, csnet.py:332-355).
    """
    weights: dict[str, float] = {}
    baseflop = expandflop ** (len(lc.stages) - 1)
    group_sizes = [lc.stages[0] + 1, lc.stages[1], lc.stages[2], lc.stages[3]]
    group, in_group = 0, 0
    for plan in lc.block_plans():
        entry = lc.entries[plan.entry]
        branches = len(entry.out_split)
        for cbr in _CBRS:
            init = baseflop * expandflop ** (branches - 1)
            for k in range(branches):
                if entry.out_split[k] != 0:
                    weights[f"{plan.stage}.{plan.index}.{cbr}.bns.{k}"] = init
                init /= expandflop
        in_group += 1
        if in_group == group_sizes[group]:
            baseflop /= expandflop
            group += 1
            in_group = 0
    return weights


def penalty_terms(model: nn.Module, fw: dict[str, float]
                  ) -> list[tuple[str, nn.BatchNorm2d, float]]:
    """(path, BN module, flop weight) of every BN in ``fw``: looked up once
    per model, read at every step."""
    return [(path, model.get_submodule(path), w) for path, w in fw.items()]


def penalty(terms: list[tuple[str, nn.BatchNorm2d, float]],
            gap: dict[str, torch.Tensor], batch_size: int) -> torch.Tensor:
    """0.5/batch * sum over ``terms`` of flop_w * sum(gap * gamma^2).

    ``terms`` is ``penalty_terms(model, flop_weight_map(...))``; ``gap``
    entries are the (N, C) detached per-sample spatial means of one forward
    (``GapCollector.gap``); gamma is the BN's ``weight`` in f32. The sum
    over the batch axis then /batch_size, the configured batch, matches the
    reference's get_flops()/batchsize (csnet.py:324-330, train.py:213).
    """
    sums = [w * torch.sum(gap[path] * bn.weight.float().square())
            for path, bn, w in terms if path in gap]
    return 0.5 * torch.stack(sums).sum() / batch_size
