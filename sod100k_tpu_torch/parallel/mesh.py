"""The 1-D data group: world size, rank, the rank's card, and the
collectives of data parallelism.

Port of the 1-D half of ``sod100k_tpu/parallel/mesh.py``. There, XLA
inserts the collectives of a jitted step over a device mesh; here each
process owns one card and the step calls them itself: the model is
replicated from rank 0 once (``replicate``), gradients are all-reduced once
per optimizer step in one flat buffer per dtype (``all_reduce_grads``),
and sums that every rank must read (losses, metric sums) go through
``all_reduce_sum``. Batch-norm statistics over the global batch are
``ops.norm.GlobalBatchNorm2d``'s.

Not ported, because they exist for GSPMD: the 2-D data x spatial mesh
(``make_mesh_2d``, ``parse_mesh_shape``), its validity check
(``check_spatial_extent``) and the spatial half of ``feed_sharding``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def world_size(group=None) -> int:
    """Processes in ``group`` (the world by default); 1 without a process
    group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _local_rank(global_rank: int) -> int:
    n = torch.cuda.device_count()
    return int(os.environ.get("LOCAL_RANK", global_rank)) % max(n, 1)


def local_device() -> torch.device:
    """This rank's card (``cuda:LOCAL_RANK``), or the CPU without cards."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", _local_rank(rank()))


def data_group():
    """The process group the data axis spans: the world when it holds more
    than one process, else None (no collectives at all)."""
    return dist.group.WORLD if world_size() > 1 else None


def row_slice(n: int, group=None) -> slice:
    """This rank's contiguous rows of a length-``n`` global batch axis over
    ``group``; all of them without a group."""
    if group is None:
        return slice(None)
    w = world_size(group)
    if n % w:
        raise ValueError(
            f"global batch {n} must divide evenly over {w} processes")
    per, r = n // w, rank(group)
    return slice(r * per, (r + 1) * per)


def _flat_per_dtype(tensors: list, fn) -> None:
    """Apply the in-place collective ``fn`` to one flat buffer per dtype and
    copy the results back into ``tensors``."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 of
    ``group`` into every rank's copy (in place). No-op without a group."""
    if group is None or world_size(group) == 1:
        return module
    src = dist.get_global_rank(group, 0)
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    _flat_per_dtype(tensors, lambda f: dist.broadcast(f, src, group=group))
    return module


@torch.no_grad()
def all_reduce_grads(params, group=None, op=dist.ReduceOp.SUM) -> None:
    """All-reduce the ``.grad`` of every parameter that has one, one flat
    buffer per dtype. No-op without a group."""
    if group is None or world_size(group) == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_per_dtype(grads, lambda f: dist.all_reduce(f, op=op, group=group))


def all_reduce_sum(tensors: dict, group=None) -> dict:
    """The SUM over ranks of each tensor of ``tensors`` (new tensors, one
    flat all-reduce per dtype). Without a group, the tensors as given."""
    if group is None or world_size(group) == 1:
        return tensors
    out = {k: v.detach().clone() for k, v in tensors.items()}
    _flat_per_dtype(list(out.values()),
                    lambda f: dist.all_reduce(f, group=group))
    return out


def gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of a batch-leading tensor, concatenated in rank
    order, on every rank. An all-gather written as a SUM all-reduce of a
    zero-filled buffer (exact: each element has one non-zero term), which
    gloo also runs on card tensors. Without a group, ``local``."""
    if group is None or world_size(group) == 1:
        return local
    n, r = local.shape[0], rank(group)
    out = local.new_zeros((n * world_size(group), *local.shape[1:]))
    out[r * n:(r + 1) * n] = local
    dist.all_reduce(out, group=group)
    return out
