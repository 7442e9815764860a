"""The CSF+Res2Net train step: the reference Solver's semantics.

Port of ``sod100k_tpu/train/csf_step.py:30-198``. Recipe (CSF+Res2Net
solver.py): Adam (0.9, 0.999, eps 1e-8) at lr 5e-5 with coupled L2 decay
5e-4 over the *trainable* parameters only; BCE-with-logits summed and
divided by iter_size * batch; gradients summed over ``iter_size``
micro-steps and applied on every ``iter_size``-th (``optax.MultiSteps(
use_grad_mean=False)`` in the JAX package); lr / 10 after epoch 15 with a
new optimizer, so fresh moments (``CSFTrainStep.restart_optimizer``).

Frozen as in the reference (``requires_grad=False`` there,
``csf_partition`` in the JAX package): the backbone's top ``bn1``, every
block's ``bn1``/``bns.*``/``bn3`` affine and the downsample shortcut's
*conv* (``downsample.1``). The downsample BN affines and the stem BNs
(``conv1.1``, ``conv1.4``) train. Every backbone BN normalizes with its
running statistics (the model never switches them), so no running
statistic moves during training.

The eval step is ``train.step.make_eval_step`` on the CSFNet as it is: NHWC
in, sigmoid (or its u8 quantization) out.

Under data parallelism (``group``) each rank runs its rows of the global
batch and the loss keeps dividing by the global batch, so the gradients
are SUM-all-reduced, once per optimizer apply. The frozen BN statistics
need no global batch norm.

Under a 2-D mesh (``mesh``) each rank also holds only its band of each
image's rows (``parallel.spatial``): the loss, a sum divided by iter_size *
batch, is then this rank's band's share as it stands, and the gradients
are summed over the world.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.pipeline import normalize_u8
from ..parallel.mesh import Mesh2D, all_reduce_grads
from ..parallel.spatial import SpatialCtx, spatial_sum
from .optim import set_lr
from ..utils.profiler import span
from .step import _device, _on

_FROZEN_BN = ("bn1", "bn3", "bns")


def is_frozen(name: str) -> bool:
    """Whether the reference freezes parameter ``name`` of a CSFNet."""
    parts = name.split(".")
    if parts[0] != "base":
        return False
    if parts[1] == "bn1":
        return True
    if not parts[1].startswith("layer"):
        return False  # the stem's conv1.1 / conv1.4 BNs train
    if "downsample" in parts:
        return parts[parts.index("downsample") + 1] == "1"
    return any(p in _FROZEN_BN for p in parts[3:])


def freeze_reference_params(model: nn.Module) -> list[str]:
    """``requires_grad=False`` on the parameters the reference freezes
    (``csf_partition``'s frozen leaves); returns their names."""
    frozen = []
    for name, p in model.named_parameters():
        if is_frozen(name):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def make_csf_optimizer(model: nn.Module, weight_decay: float = 5e-4
                       ) -> torch.optim.Adam:
    """Adam (0.9, 0.999, eps 1e-8) with coupled L2 decay (added to the
    gradient before the moments: ``add_decayed_weights`` before
    ``scale_by_adam``) over the parameters that require gradients. Built at
    lr 0: the step sets the learning rate of each apply (``optim.set_lr``),
    as the JAX step scales the update by ``lr``."""
    return torch.optim.Adam([p for p in model.parameters()
                             if p.requires_grad],
                            lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def bce2d(logits: torch.Tensor, target: torch.Tensor,
          reduction: str = "none",
          spatial: SpatialCtx | None = None) -> torch.Tensor:
    """Class-balanced BCE-with-logits (reference solver.py:129-144): weight
    #neg/#total on positives and 1.1 * #pos/#total on negatives, in f32.
    The reference defines it but its Solver never calls it. On row bands
    (``spatial``) the counts are those of the whole images: the bands'
    counts summed over the spatial group; a "sum" or "mean" reduction is
    then this band's part."""
    target = target.float()
    pos = (target == 1).float()
    neg = (target == 0).float()
    counts = spatial_sum(torch.stack([
        pos.sum(), neg.sum(), torch.tensor(float(target.numel()),
                                           device=target.device)]), spatial)
    n_pos, n_neg, numel = counts[0], counts[1], counts[2]
    total = n_pos + n_neg
    weights = n_neg / total * pos + 1.1 * n_pos / total * neg
    bce = weights * F.binary_cross_entropy_with_logits(
        logits.float(), target, reduction="none")
    if reduction == "none":
        return bce
    if reduction == "mean":
        return bce.mean() if spatial is None else bce.sum() / numel
    if reduction == "sum":
        return bce.sum()
    raise ValueError(f"invalid reduction {reduction!r}")


def csf_loss(logits: torch.Tensor, target: torch.Tensor,
             mask: torch.Tensor | None, iter_size: int,
             batch_size: int) -> torch.Tensor:
    """sum(BCE-with-logits * mask) / (iter_size * batch_size), in f32."""
    bce = F.binary_cross_entropy_with_logits(
        logits.float(), target.float(), reduction="none")
    if mask is not None:
        bce = bce * mask.float()
    return bce.sum() / (iter_size * batch_size)


class CSFTrainStep:
    """One micro-step: ``step(batch, lr) -> {"loss"}``.

    ``batch`` is ``{"image": (N,H,W,3), "target": (N,H,W,1)}`` with an
    optional pixel ``"mask"`` (N,H,W,1) for padded batches; tensors or
    numpy, moved to the model's device. ``from_u8`` takes uint8 image and
    target: the ImageNet normalization and target / 255 run on the device.
    ``compute_dtype`` casts the normalized image; parameters, loss and
    the optimizer's moments stay f32. ``remat=True`` recomputes the
    forward's activations in the backward (``torch.utils.checkpoint``,
    non-reentrant): less memory, identical gradients.

    Gradients accumulate over ``iter_size`` calls; the call that completes
    them writes ``lr`` into the optimizer, steps it and zeroes them. The
    loss stays on the device: the step never waits for it.

    ``mesh`` (``parallel.mesh.Mesh2D``): ``batch`` holds this rank's data
    rows and, under a spatial axis, its band of each image's rows (mask
    included) of images of height ``image_h``; ``batch_size`` is the
    global batch, and the accumulated gradients are summed over the world
    before each apply. The returned loss is this rank's share of the
    micro-step's loss.

    Spans (``utils.profiler``): each call is ``train.step``, with children
    ``train.forward`` (copy, normalize, model, loss), ``train.backward``
    (backward; on an apply, the gradients' all-reduce) and, on an apply,
    ``train.optimizer`` (``set_lr``, ``optimizer.step``, ``zero_grad``).
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 *, iter_size: int = 10, batch_size: int = 1,
                 compute_dtype: torch.dtype | None = None,
                 from_u8: bool = False, remat: bool = False,
                 mesh: Mesh2D | None = None, image_h: int | None = None):
        if mesh is not None and mesh.spatial > 1 and not image_h:
            raise ValueError("a spatial mesh needs the images' height")
        self.group = mesh.world if mesh is not None else None
        self.mesh, self.image_h = mesh, image_h
        self.model, self.optimizer = model, optimizer
        self.iter_size, self.batch_size = iter_size, batch_size
        self.compute_dtype, self.from_u8, self.remat = (compute_dtype,
                                                        from_u8, remat)
        self.device = _device(model)
        self.micro = 0  # micro-steps since the last apply

    def __call__(self, batch: dict, lr: float) -> dict:
        with span("train.step"):
            return self._step(batch, lr)

    def _step(self, batch: dict, lr: float) -> dict:
        with span("train.forward"):
            image = _on(self.device, batch["image"])
            target = _on(self.device, batch["target"])
            mask = batch.get("mask")
            if mask is not None:
                mask = _on(self.device, mask)
            if self.from_u8:
                image = normalize_u8(image)
                target = target.float() / 255.0
            if self.compute_dtype is not None:
                image = image.to(self.compute_dtype)
            if not self.model.training:
                self.model.train()
            args = (image,)
            if self.mesh is not None and self.mesh.spatial > 1:
                args = (image, SpatialCtx(self.mesh, self.image_h))
            if self.remat:
                logits = checkpoint(self.model, *args, use_reentrant=False)
            else:
                logits = self.model(*args)
            loss = csf_loss(logits, target, mask, self.iter_size,
                            self.batch_size)
        apply = self.micro + 1 == self.iter_size
        with span("train.backward"):
            loss.backward()
            self.micro += 1
            if apply:
                all_reduce_grads(self.model.parameters(), self.group)
        if apply:
            with span("train.optimizer"):
                set_lr(self.optimizer, lr)
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
            self.micro = 0
        return {"loss": loss.detach()}

    def restart_optimizer(self) -> None:
        """The reference's lr decay (solver.py:123-125) re-creates Adam: a
        new optimizer over the same parameters with the same weight decay,
        fresh moments, and no pending micro-step gradients (``tx.init`` in
        the JAX package's ``cli/csf.py``). The caller passes the decayed lr
        to the following calls."""
        wd = self.optimizer.param_groups[0]["weight_decay"]
        self.optimizer = make_csf_optimizer(self.model, wd)
        self.model.zero_grad(set_to_none=True)
        self.micro = 0


def make_csf_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        **kwargs) -> CSFTrainStep:
    """``CSFTrainStep(model, optimizer, **kwargs)``: the JAX package's
    ``make_csf_train_step`` counterpart."""
    return CSFTrainStep(model, optimizer, **kwargs)
