"""The data x spatial mesh: world size, rank, the rank's card, and the
collectives of data parallelism.

Port of ``sod100k_tpu/parallel/mesh.py``. There, XLA
inserts the collectives of a jitted step over a device mesh; here each
process owns one card and the step calls them itself: the model is
replicated from rank 0 once (``replicate``), gradients are all-reduced once
per optimizer step in one flat buffer per dtype (``all_reduce_grads``),
and sums that every rank must read (losses, metric sums) go through
``all_reduce_sum``. Batch-norm statistics over the global batch are
``ops.norm.GlobalBatchNorm2d``'s.

The 2-D data x spatial mesh (``make_mesh_2d``, ``Mesh2D``): a world of
D*S processes where rank r sits at data index r // S and spatial index
r % S (``devs.reshape(data, spatial)`` in the JAX package), so spatial
neighbours are adjacent ranks on one host. The batch splits over the D
data indices and each image's rows (H) over the S spatial indices, in
balanced bands (``band_rows``: ``torch.tensor_split`` semantics). XLA writes
the halo exchanges of that layout in the JAX package; here
``parallel.spatial`` writes them over ``torch.distributed``. Plain data
parallelism is the W x 1 mesh (``data_mesh``), one process the 1 x 1 one:
the steps, feeds and drivers take a ``Mesh2D`` whatever its shape.
"""

from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# The 2-D data x spatial mesh

# Kept for parity with the JAX package, which refuses spatial sharding
# where the deepest stride-2 conv input is shorter than this: XLA's GSPMD
# computes sharded strided convs wrongly there (a bug of that compiler,
# sod100k_tpu/parallel/mesh.py). The halo exchanges here have no such
# limit; the check stays so that both packages accept the same commands.
MIN_STRIDE2_INPUT = 6


def check_spatial_extent(image_h: int, stride2_factor: int, spatial: int,
                         what: str = "model") -> None:
    """Refuse a spatial split the JAX package refuses (ValueError), with
    its two conditions.

    ``stride2_factor`` is the model's downsampling at the input of its
    deepest true strided conv (``arch.csnet.DEEPEST_STRIDE2_FACTOR``: 4;
    ``arch.csf_res2net.DEEPEST_STRIDE2_FACTOR``: 16). The extent-6 bound
    (``MIN_STRIDE2_INPUT``) guards the JAX package against a GSPMD bug and
    is kept only so that both packages accept the same commands. The rows
    check is a real limit of any row split: the deepest feature (one more
    /2) must give every spatial shard at least one row."""
    if spatial <= 1:
        return
    deepest_in = image_h // stride2_factor
    if deepest_in < MIN_STRIDE2_INPUT:
        raise ValueError(
            f"spatial sharding of {what} at image height {image_h}: the "
            f"deepest stride-2 conv input would be {deepest_in} rows "
            f"(< {MIN_STRIDE2_INPUT}), which the JAX package refuses (its "
            f"compiler computes sharded strided convs wrongly there). Use "
            f"image height >= {stride2_factor * MIN_STRIDE2_INPUT}, or a "
            f"1-D data mesh.")
    deepest = image_h // (2 * stride2_factor)
    if deepest < spatial:
        raise ValueError(
            f"spatial sharding of {what} at image height {image_h} over "
            f"{spatial} shards leaves the deepest feature ({deepest} rows) "
            f"with fewer rows than shards; use at most {deepest} spatial "
            f"shards or a larger image.")


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """'4x2' -> (4, 2) (data x spatial). Raises ValueError on malformed
    specs."""
    try:
        d, s = (int(v) for v in spec.lower().split("x"))
        if d < 1 or s < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"mesh shape must look like '4x2' (data x spatial, both >= 1), "
            f"got {spec!r}") from None
    return d, s


def band_rows(h: int, index: int, parts: int) -> tuple[int, int]:
    """Global rows [lo, hi) of band ``index`` of ``parts`` over a height
    ``h``: balanced blocks, the first ``h % parts`` one row longer
    (``torch.tensor_split``). A band is empty only where h < parts."""
    q, r = divmod(h, parts)
    lo = index * q + min(index, r)
    return lo, lo + q + (1 if index < r else 0)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in a D x S mesh and its three process groups:
    ``spatial_group`` (the S ranks of its data index, which split the same
    images by rows), ``data_group`` (the D ranks of its spatial index) and
    ``world``. A group of one process is None (no collectives)."""

    data: int
    spatial: int
    data_index: int
    spatial_index: int
    spatial_group: object
    data_group: object
    world: object

    @property
    def shape(self) -> str:
        return f"{self.data}x{self.spatial}"

    def rows(self, n: int) -> slice:
        """This rank's rows of a length-``n`` global batch (by data
        index)."""
        if n % self.data:
            raise ValueError(
                f"global batch {n} must divide evenly over the data axis "
                f"({self.data})")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def band(self, h: int) -> tuple[int, int]:
        """This rank's global rows [lo, hi) of a height-``h`` map."""
        return band_rows(h, self.spatial_index, self.spatial)

    def cut_bands(self, feed: dict) -> dict:
        """This rank's band of the rows (axis 1) of every tensor of a feed
        of whole NHWC images and targets, for a front-end that augments
        and resizes whole images before the cut; the feed itself without a
        spatial axis."""
        if self.spatial == 1:
            return feed
        return {k: v[:, slice(*self.band(v.shape[1]))]
                for k, v in feed.items()}


def make_mesh_2d(data: int, spatial: int) -> Mesh2D:
    """The D x S mesh over the world (which must hold exactly D*S
    processes; one process makes the 1 x 1 mesh). Every rank builds every
    group, in one order, as ``torch.distributed.new_group`` requires."""
    need, have = data * spatial, world_size()
    if have != need:
        raise ValueError(f"mesh shape {data}x{spatial} needs {need} "
                         f"processes, the world has {have}")
    di, si = divmod(rank(), spatial)
    world = dist.group.WORLD if need > 1 else None
    # an axis of the whole world is the world; groups are made only for
    # two axes of more than one process
    sgroup = world if data == 1 else None
    dgroup = world if spatial == 1 else None
    if data > 1 and spatial > 1:
        for d in range(data):
            g = dist.new_group([d * spatial + s for s in range(spatial)])
            if d == di:
                sgroup = g
        for s in range(spatial):
            g = dist.new_group([d * spatial + s for d in range(data)])
            if s == si:
                dgroup = g
    return Mesh2D(data, spatial, di, si, sgroup, dgroup, world)


def data_mesh() -> Mesh2D:
    """The 1-D data mesh of the world: W x 1, where every rank holds its
    rows of each batch and whole images (1 x 1, without collectives, for
    one process). Makes no process group."""
    return make_mesh_2d(world_size(), 1)
