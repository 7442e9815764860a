"""The CSNet train and eval steps.

Port of ``sod100k_tpu/train/step.py``. Loss = BCE-with-logits (mean over
all pixels, train.py:205-209) + penalty_on * flops_weight * the
dynamic-weight-decay penalty (train.py:212-213). The JAX step is a pure
function of the parameter pytrees; here the step owns the model and its
optimizer and updates both in place: parameters by ``optimizer.step()``, BN
running statistics in the train-mode forward (momentum 0.1, unbiased
variance).

On a mesh of several processes (``mesh``, a ``parallel.mesh.Mesh2D``; one
process per card) the step is the single-process step at the global batch.
Each rank holds its data rows of the batch and, under a spatial axis, its
band of each image's rows (``parallel.spatial``); plain data parallelism is
the W x 1 mesh. The batch norms take the statistics of the world
(``ops.norm.convert_global_bn``); each rank backpropagates its share of the
global BCE mean (its sum over the global pixel count) plus its penalty (a
sum over its rows divided by the configured, global batch), which every
rank of a spatial group holds whole (the GAP means are all-reduced over
the group) and so counts once, on spatial index 0; and the gradients are
SUM-all-reduced over the world.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.pipeline import normalize_u8, quantize_sigmoid_u8
from ..ops.goct import GapCollector, bn_paths
from ..ops.norm import convert_global_bn
from ..parallel.mesh import Mesh2D, all_reduce_grads, all_reduce_sum
from ..parallel.spatial import SpatialCtx, gather_bands
from ..utils.profiler import span
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
                    from_u8: bool = False, mesh: Mesh2D | None = None,
                    image_h: int | None = None):
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

    ``mesh`` (``parallel.mesh.Mesh2D``) of more than one process makes it
    a parallel step: ``batch`` holds this rank's data rows and, under a
    spatial axis, of each image its band of the rows of images of height
    ``image_h``; ``batch_size`` is the global batch, the model's batch
    norms become global ones, and the returned loss and penalty are the
    global values on every rank, with the step's halo ``exchanges`` and
    ``halo_bytes`` under a spatial axis. With None, or the 1 x 1 mesh, the
    step is the single-process one.

    Spans (``utils.profiler``): ``train.step``, with children
    ``train.forward`` (copy, normalize, model, loss, penalty),
    ``train.backward`` (``zero_grad``, backward, the gradients'
    all-reduce) and ``train.optimizer`` (``set_lr``, ``optimizer.step``).
    """
    world = mesh.world if mesh is not None else None
    if world is not None:
        convert_global_bn(model, world)
    banded = mesh is not None and mesh.spatial > 1
    if banded and not image_h:
        raise ValueError("a spatial mesh needs the images' height")
    # every rank of a spatial group holds the same GAP means: its penalty
    # counts once in the world's sum
    counts_penalty = mesh is None or mesh.spatial_index == 0
    fw = dynamic_wd.flop_weight_map(model.lc, flops_expand) \
        if flops_weight else {}
    terms = dynamic_wd.penalty_terms(model, fw)
    paths = bn_paths(model)
    device = _device(model)

    def step(batch: dict, lr: float, penalty_on: float) -> dict:
        with span("train.step"):
            return _step(batch, lr, penalty_on)

    def _step(batch: dict, lr: float, penalty_on: float) -> dict:
        with span("train.forward"):
            image = _on(device, batch["image"])
            target = _on(device, batch["target"])
            if from_u8:
                image = normalize_u8(image)
                target = target.float() / 255.0
            if compute_dtype is not None:
                image = image.to(compute_dtype)
            if not model.training:
                model.train()
            sp = SpatialCtx(mesh, image_h) if banded else None
            gap = GapCollector(paths, sp) if fw else None
            logits = model(image, gap, spatial=sp)
            if world is None:
                bce = bce_with_logits(logits, target)
            else:  # this rank's share of the global mean over every pixel
                h = image_h if banded else image.shape[1]
                bce = F.binary_cross_entropy_with_logits(
                    logits.float(), target.float(), reduction="sum") \
                    / (batch_size * h * image.shape[2])
            loss = bce
            pen = torch.zeros((), device=device)
            if fw:
                gap.finish()
                if counts_penalty:
                    pen = dynamic_wd.penalty(terms, gap.gap, batch_size)
                    loss = loss + penalty_on * flops_weight * pen
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if world is not None:
                all_reduce_grads(model.parameters(), world)
                m = all_reduce_sum({"loss": bce.detach(),
                                    "penalty": pen.detach()}, world)
                bce, pen = m["loss"], m["penalty"]
        with span("train.optimizer"):
            set_lr(optimizer, lr)
            optimizer.step()
        out = {"loss": bce.detach(), "penalty": pen.detach()}
        if sp is not None:
            out.update(exchanges=sp.exchanges, halo_bytes=sp.halo_bytes)
        return out

    return step


def make_eval_step(model: nn.Module, *, from_u8: bool = False,
                   compute_dtype: torch.dtype | None = None,
                   quantize_u8: bool = False, mesh: Mesh2D | None = None):
    """Inference step: NHWC image batch -> sigmoid saliency maps (N,H,W,1).

    Puts ``model`` in eval mode, again at each call if a train step has
    switched it since. Images move to the model's device.
    ``from_u8`` takes raw uint8 RGB and normalizes on device;
    ``compute_dtype`` casts the normalized image (activations run in that
    dtype, parameters stay f32 and are cast per op); ``quantize_u8`` returns
    trunc(sigmoid*255) as uint8, otherwise the f32 sigmoid.

    Under a 2-D ``mesh`` with a spatial axis every rank of the spatial group
    passes the same whole images; each runs the model on its band of their
    rows (``parallel.spatial``), and the bands of the maps are gathered, so
    every rank returns the whole maps.

    Spans (``utils.profiler``): ``model.h2d`` (the image to the device)
    and ``model.forward`` (normalize, model, sigmoid, quantize; enqueued).
    """
    model.eval()
    device = _device(model)
    banded = mesh is not None and mesh.spatial > 1

    @torch.inference_mode()
    def step(image: torch.Tensor) -> torch.Tensor:
        if model.training:
            model.eval()
        with span("model.h2d"):
            image = image.to(device)
        with span("model.forward"):
            sp = None
            if banded:
                sp = SpatialCtx(mesh, image.shape[1])
                image = sp.shard(image, dim=1)
            if from_u8:
                image = normalize_u8(image)
            if compute_dtype is not None:
                image = image.to(compute_dtype)
            if sp is None:
                sig = torch.sigmoid(model(image).float())
            else:
                sig = gather_bands(
                    torch.sigmoid(model(image, spatial=sp).float()),
                    sp, dim=1, h=sp.image_h)
            return quantize_sigmoid_u8(sig) if quantize_u8 else sig

    return step
