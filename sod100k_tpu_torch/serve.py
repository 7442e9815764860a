"""Serving artifacts and the bucketed ServingModel.

Port of ``sod100k_tpu/serve.py:28-221``. The JAX package exports StableHLO;
here an artifact is a directory holding

    meta.json         family, input/output contract, buckets, compute dtype,
                      torch version (CSF: the backbone's name)
    layer_config.bin  CSNet only: the architecture, in the reference's
                      pickle format
    model.pt          the f32 state_dict (``torch.save``)

and loading rebuilds the model (CSNet or CSF+Res2Net) on an explicit
device. The wire
contracts are the JAX package's: ``wire="f32"`` takes ImageNet-normalized
float32 NHWC and returns the float32 (N,H,W,1) sigmoid; ``wire="u8"`` takes
raw uint8 RGB (normalized on device) and returns trunc(sigmoid*255) as
uint8. Parameters stay f32; activations run in the compute dtype.

``mesh_devices`` serves data-parallel in one process: one replica per
card, and a bucket that divides evenly is split over the replicas (the
JAX package's batch-sharded serving, ``sod100k_tpu/serve.py:125-180``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from torch import nn

from .arch.csf_res2net import CSFNet
from .arch.csnet import CSNet
from .arch.layer_config import LayerConfig
from .train.step import make_eval_step

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def export_artifact(out_dir: str, model: nn.Module, *, batch=1,
                    hw: tuple[int, int] = (224, 224),
                    dtype: torch.dtype = torch.bfloat16,
                    wire: str = "f32") -> str:
    """Write a serving artifact for ``model`` (a CSNet or a CSFNet).
    ``batch`` is an int or a sequence of ints: the shape buckets the
    ServingModel routes request batches onto (pad to the smallest covering
    bucket; chunk over the largest)."""
    if isinstance(model, CSNet):
        family = {"family": "csnet"}
    elif isinstance(model, CSFNet):
        family = {"family": "csf", "backbone": model.backbone}
    else:
        raise TypeError(f"cannot export a {type(model).__name__}; a CSNet "
                        f"or a CSFNet")
    if wire not in ("f32", "u8"):
        raise ValueError(f"unknown wire {wire!r}")
    dtype_name = str(dtype).removeprefix("torch.")
    if dtype_name not in _DTYPES:
        raise ValueError(f"compute dtype must be one of {sorted(_DTYPES)}")
    batches = sorted({int(b) for b in
                      (batch if isinstance(batch, (list, tuple)) else [batch])})
    os.makedirs(out_dir, exist_ok=True)
    if family["family"] == "csnet":
        model.lc.save(os.path.join(out_dir, "layer_config.bin"))
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, "model.pt"))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({**family, "batch": batches[-1],
                   "batches": batches, "h": hw[0], "w": hw[1],
                   "compute_dtype": dtype_name, "wire": wire,
                   "torch_version": torch.__version__,
                   "input": ("uint8 NHWC RGB (normalize fused)"
                             if wire == "u8" else
                             "float32 NHWC, ImageNet-normalized"),
                   "output": ("uint8 (N,H,W,1) trunc(sigmoid*255)"
                              if wire == "u8" else
                              "float32 (N,H,W,1) sigmoid saliency")}, f,
                  indent=1)
    return out_dir


def _major_minor(version: str) -> tuple[int, int]:
    major, minor = version.split("+")[0].split(".")[:2]
    return int(major), int(minor)


class ServingModel:
    """Loaded artifact: ``model(images) -> saliency`` (numpy in, numpy out).

    Any request batch N is served over the artifact's buckets: the smallest
    covering bucket handles the tail (padded by repeating the last image,
    padding discarded), the largest handles overflow in chunks. Spatial dims
    must match the artifact exactly.

    ``mesh_devices``: None or 1 serves on ``device``; N > 1 puts a replica
    on each of the first N cards (0: every visible card) and splits each
    bucket that N divides over them, the others run on the first. On the
    CPU the N replicas all live on the CPU (the same arithmetic, for
    tests)."""

    def __init__(self, path: str, device: str | torch.device,
                 mesh_devices: int | None = None):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        family = self.meta.get("family")
        if family not in ("csnet", "csf"):
            raise ValueError(f"unsupported artifact family {family!r}")
        # version guard: torch.save files load on the same or a newer torch;
        # refuse an artifact written by a newer one with a clear message
        # instead of a deserializer traceback
        exporter = self.meta.get("torch_version", "unknown")
        if exporter == "unknown" or \
                _major_minor(exporter) > _major_minor(torch.__version__):
            raise RuntimeError(
                f"serving artifact at {path} was written by torch {exporter}; "
                f"this runtime is torch {torch.__version__}; re-export the "
                f"artifact with this runtime's torch")
        self.batches = sorted(self.meta["batches"])
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        n = 1 if mesh_devices is None else (
            mesh_devices or (torch.cuda.device_count() if cuda else 1))
        if cuda and n > torch.cuda.device_count():
            raise ValueError(f"mesh_devices={n}: only "
                             f"{torch.cuda.device_count()} card(s) visible")
        devices = ([torch.device("cuda", i) for i in range(n)]
                   if cuda and n > 1 else [self.device] * n)
        state = torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                           weights_only=True)
        u8 = self.meta["wire"] == "u8"
        self.models, self._steps = [], []
        for dev in devices:
            if family == "csnet":
                lc = LayerConfig.load(os.path.join(path, "layer_config.bin"))
                model = CSNet(lc, device=dev)
            else:
                model = CSFNet(self.meta["backbone"], device=dev)
            model.load_state_dict(state, strict=True)
            self.models.append(model)
            self._steps.append(make_eval_step(
                model, from_u8=u8, quantize_u8=u8,
                compute_dtype=_DTYPES[self.meta["compute_dtype"]]))
        self.model = self.models[0]

    @property
    def input_shape(self) -> tuple[int, int, int, int]:
        m = self.meta
        return (m["batch"], m["h"], m["w"], 3)

    def __call__(self, images) -> np.ndarray:
        if self.meta["wire"] == "u8":
            # refuse silent float->uint8 coercion: normalized floats from a
            # client on the f32 contract would wrap into garbage pixels
            arr = np.asarray(images)
            if not np.issubdtype(arr.dtype, np.integer):
                raise TypeError(
                    f"wire='u8' artifact expects raw uint8 RGB images, got "
                    f"dtype {arr.dtype}; pass undecoded pixel values (the "
                    f"normalize runs on device)")
            x = arr.astype(np.uint8)
        else:
            x = np.asarray(images, np.float32)
        if x.ndim != 4 or x.shape[1:] != self.input_shape[1:]:
            raise ValueError(f"expected (N, {self.meta['h']}, "
                             f"{self.meta['w']}, 3) images, got {x.shape}")
        outs, i, n = [], 0, x.shape[0]
        while i < n:
            rem = n - i
            b = next((b for b in self.batches if b >= rem), self.batches[-1])
            take = min(rem, b)
            chunk = x[i:i + take]
            if take < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - take, axis=0)])
            outs.append(self._forward(np.ascontiguousarray(chunk))[:take])
            i += take
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        """One bucket's forward: split over the replicas when their count
        divides it (every replica's work is queued before any result is
        read back, so the cards run together), else on the first."""
        k = len(self._steps)
        if k == 1 or len(chunk) % k:
            return self._steps[0](torch.from_numpy(chunk)).cpu().numpy()
        parts = [step(torch.from_numpy(part)) for step, part in
                 zip(self._steps, np.split(chunk, k))]
        return np.concatenate([p.cpu().numpy() for p in parts])


def load_artifact(path: str, device: str | torch.device,
                  mesh_devices: int | None = None) -> ServingModel:
    return ServingModel(path, device=device, mesh_devices=mesh_devices)
