"""Weights carried across: JAX parameter pytrees and reference checkpoints.

The JAX package keeps parameters as a nested dict mirroring the reference's
module names, with HWIO conv kernels and renamed leaves
(``sod100k_tpu/interop/torch_ckpt.py``). ``state_dict_from_pytree`` turns
such a pytree (numpy leaves) into this port's state_dict:

    kernel (HWIO)               -> weight (OIHW); ``weights`` at the CSF
                                   gOctConvs ``fuse.conv``/``fuse1x1.conv``
    scale/offset/mean/var (BN)  -> weight/bias/running_mean/running_var
                                   (+ num_batches_tracked = 0)
    scale/offset (GroupNorm)    -> weight/bias
    alpha (PReLU)               -> weight
    anything else (conv bias)   -> kept

It is the JAX package's ``pytree_to_state_dict`` plus the
``num_batches_tracked`` buffers that ``nn.BatchNorm2d`` carries, so that
``load_state_dict(strict=True)`` holds, for CSNet and CSF+Res2Net alike.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "offset": "bias", "mean": "running_mean",
              "var": "running_var"}
# The CSF gOctConv names its dense weight `weights` (gOctConv.py:21); these
# module paths exist only at the top of the CSF model (CSNet's head lives
# under `oct_fuse.`)
_CSF_PLURAL_WEIGHT_MODULES = ("fuse.conv.", "fuse1x1.conv.")


def state_dict_from_pytree(params: dict) -> dict[str, torch.Tensor]:
    """JAX CSNet or CSF parameter pytree -> this port's state_dict (CPU
    tensors)."""
    flat: dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            arr = np.asarray(v)
            if k == "kernel":
                name = ("weights" if prefix in _CSF_PLURAL_WEIGHT_MODULES
                        else "weight")
                flat[f"{prefix}{name}"] = torch.from_numpy(
                    arr.transpose(3, 2, 0, 1).copy())
            elif k == "alpha":
                flat[f"{prefix}weight"] = torch.from_numpy(arr.copy())
            elif k in _BN_LEAVES:
                flat[f"{prefix}{_BN_LEAVES[k]}"] = torch.from_numpy(arr.copy())
                if k == "mean":
                    flat[f"{prefix}num_batches_tracked"] = torch.tensor(0)
            else:
                flat[f"{prefix}{k}"] = torch.from_numpy(arr.copy())

    walk(params, "")
    return flat


def load_checkpoint(path: str, map_location: str | torch.device = "cuda"
                    ) -> tuple[dict[str, torch.Tensor], dict]:
    """Load a reference .pth.tar onto ``map_location`` (the card unless the
    caller names another device); returns (state_dict, metadata dict).

    Accepts the training-driver format ``{'epoch','arch','state_dict',...}``
    and bare state_dicts. Reference checkpoints hold more than tensors, so
    this unpickles fully: load only checkpoints you trust."""
    ck = torch.load(path, map_location=map_location, weights_only=False)
    if isinstance(ck, dict) and "state_dict" in ck:
        return ck["state_dict"], {k: v for k, v in ck.items()
                                  if k != "state_dict"}
    return ck, {}


def load_pretrained(model: torch.nn.Module, path: str) -> list[str]:
    """Key-intersection partial load (reference utils/utils.py:6-25), the
    JAX package's ``load_pretrained`` on a module: tensors present in both
    the checkpoint and the model with the same shape are taken from the
    file, every other tensor keeps the model's value. Returns the names
    taken."""
    loaded, _ = load_checkpoint(path, map_location="cpu")
    current = model.state_dict()
    take = {k: v for k, v in loaded.items()
            if k in current and tuple(v.shape) == tuple(current[k].shape)}
    model.load_state_dict(take, strict=False)
    return sorted(take)
