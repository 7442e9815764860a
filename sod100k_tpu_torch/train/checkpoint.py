"""Training checkpoints in the reference's .pth.tar format.

A checkpoint is ``{"epoch", "arch", "state_dict", "optimizer"}``, as the
JAX package's drivers write it (``cli/common.py:189-205``): the state_dict
(CPU tensors, the reference's names) is shared by both packages and by the
reference. The ``optimizer`` entry is not: here it is
``optimizer.state_dict()`` of a torch optimizer, in the JAX package an
optax state tree. Neither package reads the other's optimizer state;
``resume`` refuses one it cannot load. The JAX package's Orbax checkpoints
are not ported.

Under data parallelism only the primary process writes: the ranks hold
the same weights.
"""

from __future__ import annotations

import torch
from torch import nn

from ..interop.torch_ckpt import load_checkpoint
from ..parallel.multihost import is_primary


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer | None, epoch: int,
                    arch: str = "csnet") -> None:
    """Write the model's state_dict, the optimizer's state and the epoch
    (on the primary process only)."""
    if not is_primary():
        return
    payload = {"epoch": epoch, "arch": arch,
               "state_dict": {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(payload, path)


def resume(path: str, model: nn.Module,
           optimizer: torch.optim.Optimizer | None = None,
           map_location: str | torch.device = "cuda") -> int:
    """Load a checkpoint into ``model`` (strictly) and ``optimizer`` (its
    state, when the checkpoint holds a torch optimizer's); returns the
    epoch. Tensors load onto ``map_location``, the card by default."""
    state_dict, meta = load_checkpoint(path, map_location=map_location)
    model.load_state_dict(state_dict, strict=True)
    if optimizer is not None:
        opt = meta.get("optimizer")
        if not (isinstance(opt, dict) and "param_groups" in opt):
            raise ValueError(
                f"{path} holds no torch optimizer state (a checkpoint of "
                f"the JAX package keeps an optax tree there); resume the "
                f"model alone and start a fresh optimizer")
        optimizer.load_state_dict(opt)
    return int(meta.get("epoch", 0))
