"""Row bands of one image over the spatial group: the halo exchange.

Under a 2-D mesh (``parallel.mesh.Mesh2D``) each rank of a spatial group
holds a band of every map's rows (NCHW, rows = dim 2): balanced blocks of
that map's global height (``mesh.band_rows``). Every level of the network,
and each octave branch at each level, has its own height and so its own
bands. In the JAX package GSPMD writes the halo exchanges of this layout;
here ``fetch_rows`` does, over ``torch.distributed``:

- ``fetch_rows`` returns global rows [lo, hi) of a banded map on each rank
  (each rank its own window), taken from whichever ranks own them. Its
  backward is the adjoint: each window row's gradient is added back on the
  rank that owns the row.
- ``banded`` runs a spatially local op on a band: it finds the input rows
  the local output rows need, fetches them, pads only where the window
  meets the true image edge, and runs the unsharded op on the window.
- ``gather_bands`` makes whole maps from bands (outputs and metrics);
  ``spatial_sum`` sums over the group (global statistics).

A band does not know its map's global height, so the ops record it on the
tensors they return (``tag``) and read it from their inputs (``height``);
the ops that keep rows (norms, activations, sums, channel concatenation)
carry it over with ``like``. An op handed an untagged tensor under a
``SpatialCtx`` raises.

Every exchange is a SUM all-reduce of a zero-filled buffer in which each
element has one non-zero term (exact), so it runs on gloo with CPU or card
tensors and on NCCL alike. The exchanges are the same on every rank of the
group (every rank computes every rank's window), which collectives need.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh2D, band_rows

_ROWS = "_sod_global_rows"


def tag(t: torch.Tensor, h: int) -> torch.Tensor:
    """Record ``h``, the global height of the map ``t`` is a band of, on
    ``t``; returns ``t``."""
    setattr(t, _ROWS, int(h))
    return t


def height(t: torch.Tensor) -> int:
    """The global height recorded on band ``t`` by ``tag``."""
    h = getattr(t, _ROWS, None)
    if h is None:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} reached a "
                         f"spatial op without its global height (tag it)")
    return h


def like(t: torch.Tensor, src: torch.Tensor,
         spatial: Optional["SpatialCtx"]) -> torch.Tensor:
    """``t`` with ``src``'s global height under a ctx (``t`` keeps
    ``src``'s rows); ``t`` unchanged without one."""
    return t if spatial is None else tag(t, height(src))


class SpatialCtx:
    """The spatial half of a ``Mesh2D`` for one forward: the group, this
    rank's index, and the input image's height ``image_h`` (the heights of
    the deeper levels ride on their tensors, ``tag``). ``exchanges`` and
    ``halo_bytes`` count the halo all-reduces and the bytes of their
    buffers, forward and backward (not the whole-map gathers)."""

    def __init__(self, mesh: Mesh2D, image_h: int):
        self.mesh, self.image_h = mesh, int(image_h)
        self.group, self.size = mesh.spatial_group, mesh.spatial
        self.index = mesh.spatial_index
        self.exchanges = 0
        self.halo_bytes = 0

    def bands(self, h: int) -> list[tuple[int, int]]:
        """Every rank's global rows [lo, hi) of a height-``h`` map."""
        return [band_rows(h, r, self.size) for r in range(self.size)]

    def band(self, h: int) -> tuple[int, int]:
        return band_rows(h, self.index, self.size)

    def shard(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This rank's band of the whole map ``x`` (rows along ``dim``),
        tagged with the whole height."""
        h = x.shape[dim]
        lo, hi = self.band(h)
        return tag(x.narrow(dim, lo, hi - lo), h)

    def all_reduce(self, buf: torch.Tensor, halo: bool = False
                   ) -> torch.Tensor:
        """SUM-all-reduce ``buf`` over the group in place (bfloat16 goes
        through float32 on gloo, exactly); a ``halo`` exchange is
        counted."""
        if halo:
            self.exchanges += 1
            self.halo_bytes += buf.numel() * buf.element_size()
        if self.group is None:
            return buf
        if buf.dtype == torch.bfloat16 and \
                dist.get_backend(self.group) == "gloo":
            f = buf.float()
            dist.all_reduce(f, group=self.group)
            buf.copy_(f)
        else:
            dist.all_reduce(buf, group=self.group)
        return buf


def _halo_plan(owners, los, his, h):
    """The exchange of one ``fetch_rows``: for each rank r, the global row
    segments of its (clipped) window that it does not own, each with its
    offset in the flat buffer. Returns (segments per rank, total rows)."""
    segs, off = [], 0
    for (a, b), lo, hi in zip(owners, los, his):
        lo, hi = max(lo, 0), min(hi, h)
        mine = []
        for s0, s1 in ((lo, min(hi, a)), (max(lo, b), hi)):
            if s1 > s0:
                mine.append((s0, s1, off))
                off += s1 - s0
        segs.append(mine)
    return segs, off


class _FetchRows(torch.autograd.Function):

    @staticmethod
    def forward(fctx, band, h, los, his, sp):
        owners = sp.bands(h)
        me = sp.index
        a, b = owners[me]
        lo, hi = max(los[me], 0), min(his[me], h)
        segs, total = _halo_plan(owners, los, his, h)
        fctx.plan = (owners, segs, total, lo, hi)
        fctx.sp = sp
        n, c, _, w = band.shape
        buf = None
        if total:
            buf = band.new_zeros((n, c, total, w))
            for r, rsegs in enumerate(segs):
                if r == me:
                    continue
                for s0, s1, off in rsegs:
                    i0, i1 = max(s0, a), min(s1, b)
                    if i1 > i0:
                        buf[:, :, off + i0 - s0:off + i1 - s0] = \
                            band[:, :, i0 - a:i1 - a]
            sp.all_reduce(buf, halo=True)
        parts = []
        for s0, s1, off in segs[me]:
            if s0 < a:
                parts.append(buf[:, :, off:off + s1 - s0])
        m0, m1 = max(lo, a), min(hi, b)
        if m1 > m0:
            parts.append(band[:, :, m0 - a:m1 - a])
        for s0, s1, off in segs[me]:
            if s0 >= b:
                parts.append(buf[:, :, off:off + s1 - s0])
        if not parts:
            return band.new_zeros((n, c, 0, w))
        return torch.cat(parts, dim=2) if len(parts) > 1 \
            else parts[0].clone()

    @staticmethod
    def backward(fctx, grad):
        owners, segs, total, lo, hi = fctx.plan
        sp = fctx.sp
        me = sp.index
        a, b = owners[me]
        n, c, _, w = grad.shape
        gband = grad.new_zeros((n, c, b - a, w))
        m0, m1 = max(lo, a), min(hi, b)
        if m1 > m0:
            gband[:, :, m0 - a:m1 - a] += grad[:, :, m0 - lo:m1 - lo]
        if total:
            buf = grad.new_zeros((n, c, total, w))
            for s0, s1, off in segs[me]:
                buf[:, :, off:off + s1 - s0] = grad[:, :, s0 - lo:s1 - lo]
            sp.all_reduce(buf, halo=True)
            for r, rsegs in enumerate(segs):
                if r == me:
                    continue
                for s0, s1, off in rsegs:
                    i0, i1 = max(s0, a), min(s1, b)
                    if i1 > i0:
                        gband[:, :, i0 - a:i1 - a] += \
                            buf[:, :, off + i0 - s0:off + i1 - s0]
        return gband, None, None, None, None


def fetch_rows(band: torch.Tensor, los: Sequence[int], his: Sequence[int],
               sp: SpatialCtx, h: Optional[int] = None) -> torch.Tensor:
    """Global rows [los[r], his[r]) of the banded map on each rank r of the
    group (every rank passes every rank's window, so all of them know the
    exchange), clipped to the image [0, h): rows outside it are the
    caller's to pad as its op pads the image edge. ``h`` defaults to the
    band's tag. Rows come from any rank of the group, not only the
    neighbours. Differentiable: the backward adds each window row's
    gradient to the band of the rank that owns the row."""
    if h is None:
        h = height(band)
    return _FetchRows.apply(band, int(h), tuple(los), tuple(his), sp)


def banded(x: torch.Tensor, sp: SpatialCtx, h_out: int,
           need: Callable[[int, int], tuple[int, int]],
           fn: Callable[[torch.Tensor, int, int], torch.Tensor],
           pad_value: float = 0.0) -> torch.Tensor:
    """A spatially local op on band ``x``: ``need(a, b)`` gives the global
    input rows [lo, hi) that output rows [a, b) read; ``fn(window, a, b)``
    is the unsharded op on such a window, padded with ``pad_value`` where
    it crosses the image edge, and returns exactly b - a rows. The result is
    this rank's band of the height-``h_out`` output, tagged.

    A rank whose output band is empty (h_out < group size) still takes
    part in the exchange, and its (empty) result depends on its window, so
    that the backward's exchange runs on every rank."""
    h_in = height(x)
    outs = sp.bands(h_out)
    wins = [need(a, b) if b > a else (0, 0) for a, b in outs]
    win = fetch_rows(x, [w[0] for w in wins], [w[1] for w in wins], sp,
                     h_in)
    a, b = outs[sp.index]
    if b > a:
        lo, hi = wins[sp.index]
        top, bottom = max(0, -lo), max(0, hi - h_in)
        if top or bottom:
            win = F.pad(win, (0, 0, top, bottom), value=pad_value)
        y = fn(win, a, b)
    else:  # the shape of one output row, cut to none
        lo, hi = need(0, 1)
        n, c, _, w = x.shape
        y = fn(x.new_zeros((n, c, hi - lo, w)), 0, 1)[:, :, :0] \
            + win.sum() * 0
    if y.shape[2] != b - a:
        raise RuntimeError(f"banded op gave {y.shape[2]} rows for output "
                           f"rows [{a}, {b})")
    return tag(y, h_out)


def gather_bands(band: torch.Tensor, sp: SpatialCtx, dim: int = 2,
                 h: Optional[int] = None) -> torch.Tensor:
    """The whole map on every rank of the group, from each rank's band
    (rows along ``dim``; ``h`` defaults to the band's tag). Not
    differentiable: for outputs and metrics."""
    if h is None:
        h = height(band)
    a, b = sp.band(h)
    shape = list(band.shape)
    shape[dim] = h
    out = band.new_zeros(shape)
    out.narrow(dim, a, b - a).copy_(band.detach())
    return sp.all_reduce(out)


@torch.no_grad()
def spatial_sum(t: torch.Tensor, sp: Optional[SpatialCtx]) -> torch.Tensor:
    """The SUM of ``t`` over the ranks of the spatial group (a new tensor;
    ``t`` itself without a ctx). Not differentiable: for statistics that
    carry no gradient (the GAP signal, class counts)."""
    if sp is None:
        return t
    return sp.all_reduce(t.detach().clone())
