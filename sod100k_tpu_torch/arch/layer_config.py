"""layer_config: the architecture-as-data system driving CSNet.

A carried-over copy of ``sod100k_tpu/arch/layer_config.py`` (pure numpy): the
JAX package's module cannot be imported without jax, because
``sod100k_tpu/arch/__init__.py`` imports the JAX models. The port's tests
check that both copies produce the same configs and pickles.

The reference describes every (prunable) layer's per-branch channel splits as a
pickled list of numpy arrays plus a trailing stage list (reference
``CSNet_training/model/csnet.py:414-518`` for the generator, :521-523/:541-568
for the pickle IO). A model is reconstructible only from a
(layer_config, checkpoint) pair.

This module gives that format a typed, hashable representation:

- ``Entry``: (in_split, out_split, dil_split?) as tuples of ints,
- ``LayerConfig``: entries + stages, with the block plan (stage id, stride,
  kernel size per ILBlock) derived once and cached,
- readers/writers binary-compatible with the reference pickles, and
- ``init_layers`` re-deriving the seed architecture exactly as the reference
  (stages [3,4,6,4], basewidth scaling, CSF-head thirds and dilation splits).

Everything is static data: the model modules are built from a LayerConfig.
"""

from __future__ import annotations

import dataclasses
import functools
import pickle
from typing import Optional, Sequence

import numpy as np

DILATIONS = (1, 2, 4, 8, 16)


def _as_int_tuple(x) -> tuple[int, ...]:
    arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
    return tuple(int(round(v)) for v in arr.tolist())


@dataclasses.dataclass(frozen=True)
class Entry:
    """One prunable layer's channel allocation.

    in_split/out_split: channels per octave branch.
    dil_split: per-branch per-dilation widths (PallMSBlock entries only).
    """

    in_split: tuple[int, ...]
    out_split: tuple[int, ...]
    dil_split: Optional[tuple[tuple[int, ...], ...]] = None

    @property
    def in_channels(self) -> int:
        return sum(self.in_split)

    @property
    def out_channels(self) -> int:
        return sum(self.out_split)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static description of one ILBlock (derived from entry order).

    kernel/stride/padding of the leading CBR follow ILBlock.__init__
    (csnet.py:33-48): 3x3 pad 1 if first block or stride 2, else 1x1 pad 0.
    """

    entry: int          # index into LayerConfig.entries
    stage: str          # "stage0".."stage4"
    index: int          # position within the stage ModuleList
    stride: int
    first: bool

    @property
    def kernel(self) -> int:
        return 3 if (self.first or self.stride == 2) else 1

    @property
    def padding(self) -> int:
        return 1 if self.kernel == 3 else 0


@functools.lru_cache(maxsize=64)
def _block_plans_cached(stages: tuple) -> tuple:
    """ILBlock layout for a stage tuple: stage0 stem, then stages of
    [s0,s1,s2,s3] blocks with stride 2 opening stages 2-4
    (CSNet.__init__, csnet.py:218-302)."""
    plans = []
    e = 0
    plans.append(BlockPlan(e, "stage0", 0, stride=1, first=True))
    e += 1
    for i in range(stages[0]):
        plans.append(BlockPlan(e, "stage1", i, stride=1, first=False))
        e += 1
    for s, name in ((1, "stage2"), (2, "stage3"), (3, "stage4")):
        for i in range(stages[s]):
            plans.append(
                BlockPlan(e, name, i, stride=2 if i == 0 else 1, first=False)
            )
            e += 1
    return tuple(plans)


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    entries: tuple[Entry, ...]
    stages: tuple[int, ...]

    # ---- structure -------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return 1 + sum(self.stages)

    def block_plans(self) -> tuple[BlockPlan, ...]:
        """ILBlock layout: stage0 stem, then stages of [s0,s1,s2,s3] blocks
        with stride 2 opening stages 2-4 (CSNet.__init__, csnet.py:218-302).
        Cached per stage tuple — trace-time callers rebuild this freely."""
        return _block_plans_cached(tuple(self.stages))

    @property
    def fuse_entry(self) -> int:
        """Entry index of the CSF head's fuse CBR (followed by ms, fuse1x1)."""
        return self.num_blocks

    @property
    def fuse(self) -> Entry:
        return self.entries[self.fuse_entry]

    @property
    def ms(self) -> Entry:
        return self.entries[self.fuse_entry + 1]

    @property
    def fuse1x1(self) -> Entry:
        return self.entries[self.fuse_entry + 2]

    def stage_blocks(self, name: str) -> list[BlockPlan]:
        return [p for p in self.block_plans() if p.stage == name]

    # ---- reference pickle compatibility -----------------------------------
    def to_reference(self) -> list:
        """Reference pickle layout: [[in, out(, dil)], ..., stages]."""
        out = []
        for e in self.entries:
            item = [np.array(e.in_split, dtype=np.int32),
                    np.array(e.out_split, dtype=np.int32)]
            if e.dil_split is not None:
                item.append(np.array([list(d) for d in e.dil_split]))
            out.append(item)
        out.append(list(self.stages))
        return out

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_reference(), f)

    @staticmethod
    def from_reference(raw: list) -> "LayerConfig":
        stages = tuple(int(s) for s in raw[-1])
        entries = []
        for item in raw[:-1]:
            dil = None
            if len(item) > 2:
                dil = tuple(_as_int_tuple(row) for row in np.asarray(item[2]))
            entries.append(
                Entry(_as_int_tuple(item[0]), _as_int_tuple(item[1]), dil)
            )
        return LayerConfig(tuple(entries), stages)

    @staticmethod
    def load(path: str) -> "LayerConfig":
        with open(path, "rb") as f:
            return LayerConfig.from_reference(pickle.load(f))


def _ms_dil_split(width: int) -> tuple[int, ...]:
    """Default per-dilation widths: floor(width/5) each, remainder to the last
    (csnet.py:489-500)."""
    each = width // len(DILATIONS)
    return tuple([each] * (len(DILATIONS) - 1) + [width - each * (len(DILATIONS) - 1)])


def init_layers(basewidth: int, basic_split: Sequence[float] = (1.0,)) -> LayerConfig:
    """Seed architecture generator, exactly mirroring csnet.py:414-518.

    Stage widths: w, w, 2w (collapsing to one branch at stage ends), 4w, 4w;
    CSF head takes [2w, 4w, 4w] stage-end features to thirds, with the
    dilation pyramid split across [1,2,4,8,16].
    """
    stages = (3, 4, 6, 4)
    bs = np.asarray([float(x) for x in basic_split])

    def split(width: float, frac=bs) -> tuple[int, ...]:
        return _as_int_tuple(width * frac)

    one = np.asarray([1.0])
    entries: list[Entry] = []
    entries.append(Entry((3,), split(basewidth)))
    entries.append(Entry(split(basewidth), split(basewidth)))
    for _ in range(1, stages[0]):
        entries.append(Entry(split(basewidth), split(basewidth)))
    # stage 2
    entries.append(Entry(split(basewidth), split(basewidth * 2)))
    for _ in range(1, stages[1] - 1):
        entries.append(Entry(split(basewidth * 2), split(basewidth * 2)))
    entries.append(Entry(split(basewidth * 2), split(basewidth * 2, one)))
    # stage 3
    entries.append(Entry(split(basewidth * 2, one), split(basewidth * 4)))
    for _ in range(1, stages[2] - 1):
        entries.append(Entry(split(basewidth * 4), split(basewidth * 4)))
    entries.append(Entry(split(basewidth * 4), split(basewidth * 4, one)))
    # stage 4
    entries.append(Entry(split(basewidth * 4, one), split(basewidth * 4)))
    for _ in range(1, stages[3] - 1):
        entries.append(Entry(split(basewidth * 4), split(basewidth * 4)))
    entries.append(Entry(split(basewidth * 4), split(basewidth * 4, one)))
    # CSF head
    side = (basewidth * 2, basewidth * 4, basewidth * 4)
    thirds = tuple(s // 3 for s in side)
    entries.append(Entry(side, thirds))
    entries.append(Entry(thirds, thirds, tuple(_ms_dil_split(t) for t in thirds)))
    entries.append(Entry(thirds, (sum(thirds),)))
    return LayerConfig(tuple(entries), stages)
