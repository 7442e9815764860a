"""The CSNet train and eval steps.

Port of ``sod100k_tpu/train/step.py``. Loss = BCE-with-logits (mean over
all pixels, train.py:205-209) + penalty_on * flops_weight * the
dynamic-weight-decay penalty (train.py:212-213). The JAX step is a pure
function of the parameter pytrees; here the step owns the model and its
optimizer and updates both in place: parameters by ``optimizer.step()``, BN
running statistics in the train-mode forward (momentum 0.1, unbiased
variance).

Under data parallelism (``group``, one process per card) the step is the
single-process step at the global batch: the batch norms take global
statistics (``ops.norm.convert_global_bn``); each rank backpropagates
``bce_local / W + penalty_local`` and the gradients are SUM-all-reduced,
which averages the BCE mean over ranks and sums the penalty, a sum over
the batch divided by the configured (global) batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.pipeline import normalize_u8, quantize_sigmoid_u8
from ..ops.goct import GapCollector, bn_paths
from ..ops.norm import convert_global_bn
from ..parallel.mesh import all_reduce_grads, all_reduce_sum, world_size
from . import dynamic_wd
from .optim import set_lr


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in f32."""
    return F.binary_cross_entropy_with_logits(logits.float(), target.float())


def quantized_mae(pred01: torch.Tensor, target01: torch.Tensor) -> torch.Tensor:
    """Reference val MAE: sigmoid output scaled to 255, truncated to int,
    /255, then L1 against the GT (train.py:268-278)."""
    q = torch.trunc(pred01 * 255.0) / 255.0
    return torch.mean(torch.abs(q - target01))


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(device: torch.device, v) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    flops_weight: float = 0.0, flops_expand: float = 2.0,
                    batch_size: int, compute_dtype: torch.dtype | None = None,
                    from_u8: bool = False, group=None):
    """One training step: ``step(batch, lr, penalty_on) -> {"loss",
    "penalty"}``.

    ``batch`` is ``{"image": (N,H,W,3), "target": (N,H,W,1)}`` (tensors or
    numpy), moved to the model's device. ``from_u8`` takes uint8 image and
    target (the hybrid front-end's raw bytes): target / 255 and the
    ImageNet normalization run on the device. ``compute_dtype`` casts the
    normalized image; each op casts its parameters to it, BN statistics,
    parameters, loss and optimizer state stay f32. The penalty needs
    ``flops_weight``; ``batch_size`` is the configured batch it divides by,
    and ``penalty_on`` (0 or 1) gates it per step. ``lr`` goes into every
    param group (``optim.set_lr``). Puts ``model`` in train mode, at each
    call if an eval step has switched it since. The returned tensors stay
    on the device: the step never waits for it.

    ``group`` (``parallel.mesh.data_group()``) makes it a data-parallel
    step: ``batch`` holds this rank's rows, ``batch_size`` is the global
    batch, the model's batch norms become global ones, and the returned
    loss and penalty are the global values on every rank. With None, or a
    group of one process, the step is the single-process one.
    """
    world = world_size(group) if group is not None else 1
    if world > 1:
        convert_global_bn(model, group)
    fw = dynamic_wd.flop_weight_map(model.lc, flops_expand) \
        if flops_weight else {}
    terms = dynamic_wd.penalty_terms(model, fw)
    paths = bn_paths(model)
    device = _device(model)

    def step(batch: dict, lr: float, penalty_on: float) -> dict:
        image = _on(device, batch["image"])
        target = _on(device, batch["target"])
        if from_u8:
            image = normalize_u8(image)
            target = target.float() / 255.0
        if compute_dtype is not None:
            image = image.to(compute_dtype)
        if not model.training:
            model.train()
        gap = GapCollector(paths) if fw else None
        bce = bce_with_logits(model(image, gap), target)
        # this rank's share of the global mean: the gradient SUM over ranks
        # then averages it (world 1: the loss itself)
        loss = bce / world if world > 1 else bce
        if fw:
            pen = dynamic_wd.penalty(terms, gap.gap, batch_size)
            loss = loss + penalty_on * flops_weight * pen
        else:
            pen = torch.zeros((), device=device)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if world > 1:
            all_reduce_grads(model.parameters(), group)
            m = all_reduce_sum({"loss": bce.detach() / world,
                                "penalty": pen.detach()}, group)
            bce, pen = m["loss"], m["penalty"]
        set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": bce.detach(), "penalty": pen.detach()}

    return step


def make_eval_step(model: nn.Module, *, from_u8: bool = False,
                   compute_dtype: torch.dtype | None = None,
                   quantize_u8: bool = False):
    """Inference step: NHWC image batch -> sigmoid saliency maps (N,H,W,1).

    Puts ``model`` in eval mode, again at each call if a train step has
    switched it since. Images move to the model's device.
    ``from_u8`` takes raw uint8 RGB and normalizes on device;
    ``compute_dtype`` casts the normalized image (activations run in that
    dtype, parameters stay f32 and are cast per op); ``quantize_u8`` returns
    trunc(sigmoid*255) as uint8, otherwise the f32 sigmoid.
    """
    model.eval()
    device = _device(model)

    @torch.inference_mode()
    def step(image: torch.Tensor) -> torch.Tensor:
        if model.training:
            model.eval()
        image = image.to(device)
        if from_u8:
            image = normalize_u8(image)
        if compute_dtype is not None:
            image = image.to(compute_dtype)
        sig = torch.sigmoid(model(image).float())
        return quantize_sigmoid_u8(sig) if quantize_u8 else sig

    return step
