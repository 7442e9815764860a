"""Multi-process data parallelism: one process per card.

Port of ``sod100k_tpu/parallel/multihost.py``. The JAX package scales out in
two tiers, several devices in one process (a mesh over ``jax.devices()``)
and one process per host coordinated by ``jax.distributed``. PyTorch's idiom
is one process per card, so here the two tiers are one: a world of
processes joined by ``torch.distributed``, each holding one card, every
one running the same program on its rows of each global batch.

Initialization reads the JAX package's environment variables, so every
driver runs data-parallel without new flags:

- ``SOD100K_COORDINATOR=host:port`` + ``SOD100K_NUM_PROCESSES`` +
  ``SOD100K_PROCESS_ID``: a TCP rendezvous at the coordinator (the primary
  listens there); or
- ``SOD100K_MULTIHOST=auto``: torchrun's ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``.

A rank takes the card ``cuda:LOCAL_RANK`` (torchrun sets it; otherwise the
rank modulo the visible cards). The backend is ``nccl`` with cards and
``gloo`` without. The rest is the JAX module's contract: the host data
pipelines are index-deterministic (draws keyed on seed, epoch and index),
so every process derives the same global batch and ``process_slice`` picks
its rows without coordination; scalars the drivers print are all-reduced,
so every rank reads the global value; the primary alone writes files.

Under a 2-D data x spatial mesh (``mesh.Mesh2D``) a rank's feed is its data
index's rows and, of every image-like array, its spatial index's band of
the rows (``local_slice_feed``); per-sample side arrays stay data-only.
A spatial group exchanges halos at every layer, so it must sit on one host
(``check_mesh_process_layout``).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (Mesh2D, _local_rank, band_rows, data_mesh, local_device,
                   rank, world_size)

INIT_TIMEOUT = datetime.timedelta(minutes=10)


def init_from_env(log=print, backend: str | None = None) -> bool:
    """Join the process group that the SOD100K_* variables describe
    (idempotent). Returns True when the world has more than one process.

    Without the variables it does nothing and returns False. With them, a
    failed rendezvous exits non-zero: a run never carries on as a single
    process when it was launched as several. ``backend`` overrides the
    default (``nccl`` with cards, ``gloo`` without), for two ranks on one
    card, which NCCL refuses."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("SOD100K_COORDINATOR", "")
    auto = os.environ.get("SOD100K_MULTIHOST", "").lower() == "auto"
    if not (coord or auto):
        return False
    if coord:
        try:
            world = int(os.environ["SOD100K_NUM_PROCESSES"])
            pid = int(os.environ["SOD100K_PROCESS_ID"])
        except KeyError as e:
            raise SystemExit(
                f"SOD100K_COORDINATOR={coord} also needs "
                f"SOD100K_NUM_PROCESSES and SOD100K_PROCESS_ID (missing {e})")
        kwargs = dict(init_method=f"tcp://{coord}", world_size=world,
                      rank=pid)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise SystemExit(f"SOD100K_MULTIHOST=auto needs torchrun's "
                             f"variables (missing {', '.join(missing)})")
        kwargs = dict(init_method="env://")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_rank(
            kwargs.get("rank", int(os.environ.get("RANK", 0)))))
    try:
        dist.init_process_group(backend, timeout=INIT_TIMEOUT, **kwargs)
    except (RuntimeError, ValueError, OSError) as e:
        raise SystemExit(f"data-parallel init failed ({backend}, "
                         f"{kwargs['init_method']}): {e}")
    log(f"data parallel: process {dist.get_rank()}/{dist.get_world_size()} "
        f"({backend}) on {local_device()}")
    return dist.get_world_size() > 1


def is_multihost() -> bool:
    return world_size() > 1


def is_primary() -> bool:
    """The one process that writes checkpoints, logs and reports."""
    return rank() == 0


def barrier(name: str, timeout_s: float = 600.0) -> None:
    """Block until every process reaches this barrier. No-op for a single
    process. On gloo a rank that does not arrive within ``timeout_s`` is
    named in the error; NCCL waits for the process group's timeout."""
    if not is_multihost():
        return
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def process_slice(n: int, mesh: Mesh2D | None = None) -> slice:
    """This process's contiguous rows of a length-``n`` global batch: its
    data index's under ``mesh`` (by default the world's data mesh)."""
    return (mesh or data_mesh()).rows(n)


def check_mesh_process_layout(mesh: Mesh2D) -> None:
    """Refuse a mesh whose spatial groups would cross hosts: ranks are
    placed host by host, so the ranks of one host (torchrun's
    ``LOCAL_WORLD_SIZE``, where it is set) must be a whole number of
    spatial groups. The data axis alone may cross hosts."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if mesh.spatial > 1 and local and int(local) % mesh.spatial:
        raise ValueError(
            f"mesh {mesh.shape} spreads a spatial group across hosts: "
            f"{local} processes per host is not a multiple of the spatial "
            f"axis {mesh.spatial}; keep spatial <= the processes per host "
            f"and dividing them (data is the only axis that may cross "
            f"hosts)")


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def local_slice_feed(batch: dict, n_global: int | None = None,
                     mesh: Mesh2D | None = None, bands: bool = True) -> dict:
    """This process's rows of a deterministic global batch dict. Every feed
    array is batch-leading (images, targets, per-sample sizes), so one
    slice applies to all; other values pass through. No-op for a single
    process.

    Under a 2-D ``mesh`` the rows are the data index's and, with ``bands``,
    every image-like array (3 or more dimensions: NHWC images, targets,
    masks) is cut to the spatial index's band of its rows (axis 1), as the
    JAX package's ``feed_sharding`` shards H; arrays of 1 or 2 dimensions
    (sizes, ``hw`` pairs) stay data-only. ``bands=False`` keeps whole
    images, for feeds that are resized on the card before the cut."""
    if not is_multihost():
        return batch
    if n_global is None:
        n_global = next(len(v) for v in batch.values() if _is_array(v))
    for k, v in batch.items():
        if _is_array(v) and len(v) != n_global:
            raise ValueError(
                f"local_slice_feed: feed array {k!r} has leading dim "
                f"{len(v)} != global batch {n_global}; every feed array "
                "must be batch-leading (replicate non-batch arrays "
                "explicitly outside the feed)")
    sl = process_slice(n_global, mesh)
    out = {k: (v[sl] if _is_array(v) else v) for k, v in batch.items()}
    if mesh is None or mesh.spatial == 1 or not bands:
        return out
    for k, v in out.items():
        if _is_array(v) and v.ndim >= 3:
            lo, hi = band_rows(v.shape[1], mesh.spatial_index, mesh.spatial)
            out[k] = v[:, lo:hi]
    return out


def global_feed(batch: dict, device) -> dict:
    """This rank's part of the global batch on its card: the arrays of a
    ``local_slice_feed`` result as tensors on ``device``. (The JAX package
    stitches the local rows into one global array here; with one process
    per card the global batch is the union of the ranks' local tensors.)"""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out
