"""Fused ILBlock depthwise tail: CUDA kernel, its plain version, the caller.

Replaces the Pallas TPU kernel
``sod100k_tpu/ops/pallas/dw_chain.py::fused_dw_chain``. An ILBlock ends with
two depthwise 3x3 Conv2dX100 + BN + PReLU stages per octave branch; in eval
mode they run here as

    x -> dw3x3 -> *scale + shift (BN folded) -> PReLU -> round to x.dtype
      -> dw3x3 -> *scale + shift -> PReLU -> y (x.dtype)

with sums in f32 and f32 taps (x100 applied), scales, shifts and alphas.

On the card the bound is device-memory bytes (about 5 flops per byte in
bf16, no matrix product for the tensor cores): the kernel
(``csrc/dw_chain.cu``) reads x once and writes y once, and keeps the
intermediate in shared memory. Its design (full-width row bands or groups
of whole planes, staged by bulk async copies into a one- or two-slot ring,
persistent blocks) is in the source; ``plan_launch`` chooses its sizes
here, in Python, so the CPU tests reach every plan.

The parameters reach the kernel as one (C, 24) f32 pack per branch:
w1[9] s1 b1 a1 w2[9] s2 b2 a2. The model builds the pack once per weight
set (``TailPacks``), not per call.

``fused_dw_chain_packed`` takes the plain version (``fused_dw_chain_ref``)
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches, so a run can show that the main
path went through the kernel; ``packs_built`` counts packs built by
``TailPacks``. Inference only: the kernel has no backward.

On row bands (``parallel.spatial``, the 2-D mesh) ``fused_dw_chain_band``
fetches a 2-row halo (two 3x3 stages) from the neighbouring bands, runs the
same kernel on band + halo, whose own zero padding then falls only on the
true image edges, and crops the halo; ``spatial_launches`` counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..parallel.spatial import SpatialCtx, fetch_rows, height, tag
from . import cuda_lib

launches = 0
spatial_launches = 0
packs_built = 0
HALO = 2  # rows a band reads from each neighbour: two 3x3 stages

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NPARAM = 24
MAX_SMEM = 232448      # a block's dynamic shared memory on sm_90
SMEM_PER_SM = 233472   # an SM's shared memory for blocks (228 KB)
THREADS = 256          # the kernel's launch bound
# The plans' sizes, chosen by A/B runs on an H100 (chip_smoke.py --variants)
BAND_THREADS = 96      # threads per block of a band plan (at most)
PLANE_THREADS = 128    # threads per block of a plane plan (at most)
BAND_SLOTS = 2         # staging slots in the ring of a band plan
PLANE_SLOTS = 1        # ... and of a plane plan
PLANE_BYTES = 32768    # planes up to this size go whole, one or more per item
ITEM_BYTES = 20480     # most staged bytes of a group of whole planes
ITEMS_PER_SM = 4       # fewer planes per item until there are this many
BAND_BYTES = 16384     # target staged bytes of a band


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _dw(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    c = x32.shape[1]
    return F.conv2d(x32, w.reshape(c, 1, 3, 3), padding=1, groups=c)


def _prelu(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, z * _per_channel(a))


def _stage(x32: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
           b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return _prelu(_dw(x32, w) * _per_channel(s) + _per_channel(b), a)


def fused_dw_chain_ref(x, w1, s1, b1, a1, w2, s2, b2, a2) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (N, C, H, W) f32 or bf16;
    w (C, 3, 3) and s, b, a (C,) in f32."""
    t = _stage(x.float(), w1, s1, b1, a1).to(x.dtype)
    return _stage(t.float(), w2, s2, b2, a2).to(x.dtype)


TIE_ULPS = 16  # f32 roundoffs (2^-24) of the terms' magnitude a sum order moves


def fused_dw_chain_ref_range(x, w1, s1, b1, a1, w2, s2, b2, a2):
    """(lo, hi, ties): bounds, in x.dtype, of every result the plain
    function may give when stage 1 sums its taps in another order.

    A bf16 intermediate whose f32 value lies within ``TIE_ULPS`` * 2^-24
    times its terms' magnitude of the midpoint between two bf16 values may
    round either way; ``ties`` counts them. The bounds take stage 2 over
    both roundings of each (stage 2 is linear up to its PReLU). Away from
    ties, and always in float32, lo == hi == ``fused_dw_chain_ref``.
    """
    t32 = _stage(x.float(), w1, s1, b1, a1)
    t = t32.to(x.dtype).float()
    z = _dw(t, w2) * _per_channel(s2) + _per_channel(b2)
    if x.dtype == torch.float32:
        y = _prelu(z, a2).to(x.dtype)
        return y, y, 0
    other = (2 * t32 - t).to(x.dtype).float()  # t32's other neighbour
    mag = _dw(x.float().abs(), w1.abs()) * _per_channel(s1.abs()) \
        + _per_channel(b1.abs())
    mag = mag * _per_channel(a1.abs().clamp(min=1.0))
    tie = (other != t) & ((2 * t32 - t - other).abs()
                          <= 2 * TIE_ULPS * 2.0 ** -24 * mag)
    d = torch.where(tie, other - t, 0.0)
    ws = w2 * s2.view(-1, 1, 1)
    dp, dn, wp, wn = d.clamp(min=0), d.clamp(max=0), ws.clamp(min=0), \
        ws.clamp(max=0)
    z_hi = z + _dw(dp, wp) + _dw(dn, wn)
    z_lo = z + _dw(dp, wn) + _dw(dn, wp)
    f_lo, f_hi = _prelu(z_lo, a2), _prelu(z_hi, a2)
    lo, hi = torch.minimum(f_lo, f_hi), torch.maximum(f_lo, f_hi)
    across = (z_lo < 0) & (z_hi > 0)  # PReLU's kink at 0 lies inside
    lo = torch.where(across, lo.clamp(max=0), lo)
    hi = torch.where(across, hi.clamp(min=0), hi)
    return lo.to(x.dtype), hi.to(x.dtype), int(tie.sum())


def check_against_plain(got: torch.Tensor, x: torch.Tensor, params, *,
                        atol: float, rtol: float) -> tuple[float, int]:
    """Raise AssertionError unless each element of ``got`` lies within
    atol + rtol * |v| of a value v in the plain function's range
    (``fused_dw_chain_ref_range``); the bar of ``torch.testing.assert_close``
    where lo == hi. Returns the largest distance and the count of ties."""
    lo, hi, ties = fused_dw_chain_ref_range(x, *params)
    g = got.float()
    near = torch.clamp(g, lo.float(), hi.float())
    dist = (g - near).abs()
    bad = ~(dist <= atol + rtol * near.abs())
    if bad.any():
        i = int(torch.argmax(dist - rtol * near.abs()))
        raise AssertionError(
            f"{int(bad.sum())} of {g.numel()} elements over the bar (atol "
            f"{atol}, rtol {rtol}); worst: {g.flatten()[i].item()} against "
            f"[{lo.flatten()[i].item()}, {hi.flatten()[i].item()}]; "
            f"{ties} intermediates at a rounding tie")
    return float(dist.max()), ties


# ---------------------------------------------------------------------------
# The launch plan


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut into work items and blocks (see the kernel).

    ``variant`` is "band" (items of ``rows`` full-width output rows of one
    plane) or "planes" (items of ``planes`` whole planes, rows = H);
    ``copy`` is "bulk" (one bulk async copy per item where the item's range
    is 16-byte aligned and sized) or "elementwise"; ``vec`` columns per
    thread; ``slots`` staging buffers in the ring (1 or 2); ``block`` (x, y)
    threads; ``smem`` dynamic shared-memory bytes.
    """
    variant: str
    copy: str
    planes: int
    rows: int
    vec: int
    slots: int
    block: tuple[int, int]
    items: int
    smem: int
    blocks_per_sm: int
    grid: int


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def buffer_bytes(planes: int, rows: int, h: int, w: int,
                 elt: int) -> tuple[int, int]:
    """Bytes of one ring slot (staged input) and of the intermediate."""
    return (planes * min(rows + 4, h) * w * elt,
            planes * min(rows + 2, h) * w * elt)


def plan_launch(n: int, c: int, h: int, w: int, dtype: torch.dtype, *,
                sm_count: int = 132,
                blocks_per_sm: int | None = None) -> LaunchPlan:
    """The kernel's launch plan for x of shape (n, c, h, w) and ``dtype``,
    from the sizes above.

    ``blocks_per_sm`` is the kernel's occupancy at this plan (the wrapper
    asks the CUDA runtime; without it a bound from threads and shared
    memory is used). Raises ValueError for a shape the kernel cannot take.
    """
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dw_chain takes float32 or bfloat16, got {dtype}")
    if min(n, c, h, w) < 1:
        raise ValueError(f"dw_chain cannot launch on shape {(n, c, h, w)}")
    elt = 4 if dtype == torch.float32 else 2
    plane_bytes = h * w * elt
    use_planes = plane_bytes <= PLANE_BYTES
    threads = PLANE_THREADS if use_planes else BAND_THREADS
    slots = PLANE_SLOTS if use_planes else BAND_SLOTS
    vec = next(v for v in (8, 4, 2, 1) if v * elt <= 16 and w % v == 0)
    groups = w // vec
    bx = min(groups, threads)
    by = max(1, threads // bx)
    if use_planes:
        variant, copy, rows = "planes", "bulk", h
        step = 16 // math.gcd(plane_bytes, 16)  # groups of whole 16-B units
        planes = min(ITEM_BYTES // plane_bytes,
                     n * c // (ITEMS_PER_SM * sm_count))
        planes = max(step, planes // step * step)
    else:
        variant = "band"
        copy = "bulk" if (w * elt) % 16 == 0 else "elementwise"
        planes = 1
        rows = max(1, min(h, BAND_BYTES // (w * elt) - 4))
        rows = -(-h // -(-h // rows))  # even bands
    # no idle thread rows in stage 2: as many as its runs of rows need
    rpp = max(1, by // planes)
    by = min(by, planes * -(-rows // -(-rows // rpp)))
    slot, mid = buffer_bytes(planes, rows, h, w, elt)
    # + a row of zeros and the mbarriers
    smem = _round_up(slots * _round_up(slot, 128) + mid, 16) \
        + _round_up(w * elt, 16) + 8 * slots
    if smem > MAX_SMEM:
        raise ValueError(f"dw_chain cannot launch on shape {(n, c, h, w)}: "
                         f"{smem} B of shared memory > {MAX_SMEM}")
    items = -(-n * c // planes) * -(-h // rows)
    if n * c >= 2 ** 31 or items >= 2 ** 31 or h * w >= 2 ** 31 // 8:
        raise ValueError(f"dw_chain cannot launch on shape {(n, c, h, w)}")
    if blocks_per_sm is None:
        blocks_per_sm = min(2048 // (bx * by), SMEM_PER_SM // (smem + 1024),
                            32)
    grid = min(items, sm_count * max(1, blocks_per_sm))
    return LaunchPlan(variant, copy, planes, rows, vec, slots, (bx, by), items,
                      smem, blocks_per_sm, grid)


def plan_items(plan: LaunchPlan, n: int, c: int, h: int):
    """The kernel's items as (block, first plane, planes, y0, rows), in the
    order each block walks them."""
    total = n * c
    nbands = -(-h // plan.rows)
    for b in range(plan.grid):
        for k in range(b, plan.items, plan.grid):
            g, band = divmod(k, nbands)
            p0 = g * plan.planes
            y0 = band * plan.rows
            yield (b, p0, min(plan.planes, total - p0), y0,
                   min(plan.rows, h - y0))


def plan_runs(plan: LaunchPlan, np_: int, olo: int, ohi: int):
    """A stage's runs over an item, as the kernel's threads split it:
    (plane in the item, first row, end row) for each thread row."""
    rpp = max(1, plan.block[1] // np_)
    k = -(-(ohi - olo) // rpp)
    for j in range(np_ * rpp):
        p = j // rpp
        ra = olo + (j - p * rpp) * k
        rb = min(ra + k, ohi)
        if ra < rb:
            yield p, ra, rb


# ---------------------------------------------------------------------------
# Parameter packs


def fold_bn_eval(bn: torch.nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode batch norm as f32 (scale, shift)."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    scale = bn.weight.float() * inv
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return scale, shift


def pack_params(w1, s1, b1, a1, w2, s2, b2, a2) -> torch.Tensor:
    """(C, 24) f32 pack of both stages: w1[9] s1 b1 a1 w2[9] s2 b2 a2."""
    c = s1.shape[0]
    cols = []
    for w, s, b, a in ((w1, s1, b1, a1), (w2, s2, b2, a2)):
        cols += [w.reshape(c, 9), s[:, None], b[:, None], a[:, None]]
    return torch.cat([t.float() for t in cols], dim=1).contiguous()


def unpack_params(packed: torch.Tensor) -> tuple:
    """The pack as views: w1 (C, 3, 3), s1, b1, a1, w2, s2, b2, a2."""
    c = packed.shape[0]
    out = []
    for o in (0, 12):
        out += [packed[:, o:o + 9].view(c, 3, 3), packed[:, o + 9],
                packed[:, o + 10], packed[:, o + 11]]
    return tuple(out)


def _stage_params(m, key: str) -> tuple:
    """Taps x100 (Conv2dX100), folded BN and PReLU alpha of one
    ``SimplifiedGOctCBR`` branch."""
    w = m.convs[key].weight[:, 0].float() * 100.0
    s, b = fold_bn_eval(m.bns[key])
    return w, s, b, m.prelus[key].weight.float()


def pack_tail(conv3x3_1, conv3x3_2) -> list:
    """One (C, 24) pack per octave branch of an ILBlock tail (None for a
    branch without channels), from running statistics."""
    out = []
    for j, cj in enumerate(conv3x3_1.split):
        key = str(j)
        if cj == 0 or key not in conv3x3_1.convs:
            out.append(None)
            continue
        out.append(pack_params(*_stage_params(conv3x3_1, key),
                               *_stage_params(conv3x3_2, key)))
    return out


def _sources(m) -> list:
    """The tensors a pack is built from, for one ``SimplifiedGOctCBR``."""
    out = []
    for key in m.convs:
        bn = m.bns[key]
        out += [m.convs[key].weight, bn.weight, bn.bias, bn.running_mean,
                bn.running_var, bn.num_batches_tracked, m.prelus[key].weight]
    return out


class TailPacks:
    """The packs of one ILBlock tail, built once per weight set.

    The cache key is each source tensor's device, ``data_ptr()`` and
    ``_version`` (conv weights; BN weight, bias, running statistics and
    batch count; PReLU weights; both stages), so any in-place update
    rebuilds the packs. A move, a conversion or ``load_state_dict`` can
    give fresh tensors at freed addresses with restarted version counters,
    so the ILBlock drops its packs on those. Packs are built outside inference mode and without grad, so
    a pack made under ``torch.inference_mode()`` serves a later
    ``torch.no_grad()`` forward as well.
    """

    def __init__(self):
        self._key = None
        self._packs = None

    def get(self, conv3x3_1, conv3x3_2) -> list:
        global packs_built
        key = tuple((t.device, t.data_ptr(), t._version)
                    for t in _sources(conv3x3_1) + _sources(conv3x3_2))
        if key != self._key:
            with torch.inference_mode(False), torch.no_grad():
                self._packs = pack_tail(conv3x3_1, conv3x3_2)
            self._key = key
            packs_built += 1
        return self._packs


# ---------------------------------------------------------------------------
# The kernel's callers


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected (N, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dw_chain takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dw_chain needs a contiguous NCHW tensor")


def _check_pack(x: torch.Tensor, packed: torch.Tensor) -> None:
    want = (x.shape[1], NPARAM)
    if packed.get_device() != x.get_device() or \
            packed.dtype != torch.float32 or \
            tuple(packed.shape) != want or not packed.is_contiguous():
        raise ValueError(
            f"dw_chain pack: want contiguous float32 {want} on {x.device}, "
            f"got {packed.dtype} {tuple(packed.shape)} on {packed.device}")


@functools.cache
def _lib():
    """The built kernel's C entry points, with their argument types."""
    return bind(cuda_lib.load("dw_chain"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a build of ``csrc/dw_chain.cu``."""
    lib.sod_dw_chain.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.sod_dw_chain.restype = ctypes.c_int
    lib.sod_dw_chain_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.sod_dw_chain_occupancy.restype = ctypes.c_int
    return lib


def occupancy(plan: LaunchPlan, dtype: torch.dtype) -> int:
    """Blocks of the kernel at ``plan`` that fit on one SM of the current
    device, from the CUDA runtime."""
    blocks = ctypes.c_int(0)
    err = _lib().sod_dw_chain_occupancy(
        _DTYPE_CODE[dtype], plan.vec, plan.block[0] * plan.block[1],
        plan.smem, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"dw_chain occupancy query failed: CUDA error "
                           f"{err}, {blocks.value} blocks per SM")
    return blocks.value


@functools.lru_cache(maxsize=256)
def device_plan(n: int, c: int, h: int, w: int, dtype: torch.dtype,
                index: int) -> LaunchPlan:
    """``plan_launch`` with the device's SM count and the kernel's measured
    occupancy; cached per shape, dtype and device."""
    sm_count = torch.cuda.get_device_properties(index).multi_processor_count
    plan = plan_launch(n, c, h, w, dtype, sm_count=sm_count)
    with torch.cuda.device(index):
        blocks = occupancy(plan, dtype)
    return plan_launch(n, c, h, w, dtype, sm_count=sm_count,
                       blocks_per_sm=blocks)


@functools.lru_cache(maxsize=256)
def _plan_args(plan: LaunchPlan, n: int, c: int, h: int, w: int,
               dtype: torch.dtype):
    """The C entry point's plan array for ``plan`` and this shape."""
    return (ctypes.c_int * 14)(
        n, c, h, w, _DTYPE_CODE[dtype], plan.planes, plan.rows, plan.vec,
        int(plan.copy == "bulk"), plan.slots, plan.block[0], plan.block[1],
        plan.grid, plan.smem)


def launch(x: torch.Tensor, packed: torch.Tensor,
           plan: LaunchPlan) -> torch.Tensor:
    """One kernel launch at ``plan`` on the current stream (checked
    inputs); counted in ``launches``."""
    global launches
    y = torch.empty_like(x)
    # the current stream's raw handle (torch.cuda.current_stream() builds a
    # Python object: several microseconds of host time per call)
    err = _lib().sod_dw_chain(
        x.data_ptr(), y.data_ptr(), packed.data_ptr(),
        _plan_args(plan, *x.shape, x.dtype),
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"dw_chain kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def fused_dw_chain_packed(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Both depthwise stages of one octave branch in one kernel launch.

    x: (N, C, H, W) contiguous, float32 or bfloat16; packed: (C, 24)
    float32 on x's device (``pack_params``). CPU tensors take
    ``fused_dw_chain_ref`` on views of the pack.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fused_dw_chain_ref(x, *unpack_params(packed))
        raise ValueError(f"dw_chain runs on cpu or cuda, not {x.device}")
    _check(x)
    _check_pack(x, packed)
    index = x.get_device()
    plan = device_plan(*x.shape, x.dtype, index)
    if index == torch.cuda.current_device():
        return launch(x, packed, plan)
    with torch.cuda.device(index):
        return launch(x, packed, plan)


def fused_dw_chain(x, w1, s1, b1, a1, w2, s2, b2, a2) -> torch.Tensor:
    """``fused_dw_chain_packed`` from separate parameters: w1, w2 (C, 3, 3)
    effective taps; s, b folded BN scale and shift; a PReLU alpha, all
    float32 on x's device."""
    params = (w1, s1, b1, a1, w2, s2, b2, a2)
    if x.device.type == "cuda":
        _check(x)
        c = x.shape[1]
        for i, p in enumerate(params):
            want = (c, 3, 3) if i % 4 == 0 else (c,)
            if p.device != x.device or p.dtype != torch.float32 or \
                    tuple(p.shape) != want:
                raise ValueError(
                    f"dw_chain parameter {i}: want float32 {want} on "
                    f"{x.device}, got {p.dtype} {tuple(p.shape)} on "
                    f"{p.device}")
    return fused_dw_chain_packed(x, pack_params(*params))


def _halo_window(x: torch.Tensor, sp: SpatialCtx
                ) -> tuple[torch.Tensor, int, int]:
    """Band ``x`` with ``HALO`` rows of each neighbouring band (fewer at
    the image edges): (window, first row of the band in it, band rows).
    Every rank of the group takes part in the exchange."""
    h = height(x)
    owners = sp.bands(h)
    wins = [(max(a - HALO, 0), min(b + HALO, h)) if b > a else (0, 0)
            for a, b in owners]
    win = fetch_rows(x, [w[0] for w in wins], [w[1] for w in wins], sp, h)
    a, b = owners[sp.index]
    return win.contiguous(), a - wins[sp.index][0], b - a


def fused_dw_chain_band(x: torch.Tensor, packed: torch.Tensor,
                        sp: SpatialCtx) -> torch.Tensor:
    """``fused_dw_chain_packed`` on this rank's band of a map: the kernel
    (or, on the CPU, its plain version) on band + halo, cropped to the
    band; tagged with the map's height."""
    global spatial_launches
    win, off, rows = _halo_window(x, sp)
    if rows == 0:
        return tag(x.new_zeros(x.shape), height(x))
    # counted from ``launch``'s own count: a call that launched no kernel
    # (the CPU's plain version) adds nothing
    before = launches
    y = fused_dw_chain_packed(win, packed)
    spatial_launches += launches - before
    return tag(y[:, :, off:off + rows].contiguous(), height(x))


def dw_tail_fused(xset: list, packs: list,
                  spatial: SpatialCtx | None = None) -> list:
    """conv3x3_1 then conv3x3_2 (the two ``SimplifiedGOctCBR`` stages of an
    ILBlock) fused, per octave branch, from one pack per branch
    (``pack_tail`` / ``TailPacks``); on row bands under ``spatial``."""
    if spatial is not None:
        return [None if p is None or x is None
                else fused_dw_chain_band(x, p, spatial)
                for x, p in zip(xset, packs)]
    return [None if p is None or x is None
            else fused_dw_chain_packed(x.contiguous(), p)
            for x, p in zip(xset, packs)]
