""".lst-file datasets of the CSF+Res2Net recipe.

Port of ``sod100k_tpu/data/csf_dataset.py:26-202``, reading through
``image_io`` instead of cv2. A train list holds "img gt" path pairs
relative to a root; images decode to RGB, /255, ImageNet-normalized;
labels /255, single-channel; a random horizontal flip at p=0.5 draws from
``np.random.default_rng(seed).integers(2)``, as in the JAX package, so
both give the same samples for the same seed. No resize (the reference
trains at native size, batch 1).

Labels follow cv2's ``IMREAD_UNCHANGED`` + channel 0 of the JAX package: a
colour GT gives its *blue* channel (cv2 decodes BGR; channel 2 of the RGB
decode here), and a 16-bit GT keeps its 16 bits and is still divided by
255. Every published SOD GT set is 8-bit gray, where none of that matters.

``padded_batches`` groups samples into shape buckets (ceil to ``bucket``
multiples) and pads with a pixel mask, so the masked-sum loss equals the
native-size one on the loss pixels (convolutions near the padding see
zeros); ``fixed_size_batches`` resizes everything to one shape (the 336^2
Res2Net-101 recipe).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from .image_io import read_image
from .pipeline import (IMAGENET_MEAN, IMAGENET_STD, _imread_rgb_u8,
                       resize_bilinear_np)


def _load_image(path: str) -> np.ndarray:
    im = _imread_rgb_u8(path).astype(np.float32) / 255.0
    return (im - IMAGENET_MEAN) / IMAGENET_STD


def _read_label(path: str) -> np.ndarray:
    """cv2.imread(IMREAD_UNCHANGED)[..., 0]: gray as it is, the blue
    channel of a colour image, the gray of gray+alpha; 16 bits kept."""
    im = read_image(path)
    if im.ndim == 3:
        im = im[:, :, 2] if im.shape[2] >= 3 else im[:, :, 0]
    return np.ascontiguousarray(im)


def _load_label(path: str) -> np.ndarray:
    return _read_label(path).astype(np.float32)[..., None] / 255.0


def _read_list(data_list: str) -> list[str]:
    with open(data_list) as f:
        return [line for line in f.read().splitlines() if line]


class CSFTrainData:
    def __init__(self, data_root: str, data_list: str, seed: int = 0):
        self.root = data_root
        self.pairs = [line.split() for line in _read_list(data_list)]
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.pairs)

    def _path(self, idx: int, k: int) -> str:
        return os.path.join(self.root, self.pairs[idx][k])

    def __getitem__(self, idx: int) -> dict:
        img = _load_image(self._path(idx, 0))
        gt = _load_label(self._path(idx, 1))
        if self.rng.integers(2) == 1:  # cv_random_flip
            img, gt = img[:, ::-1], gt[:, ::-1]
        return {"image": img, "target": gt}

    def _decode_u8(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Raw (image HWC RGB uint8, gt HW) at native resolution, no flip
        and no normalization: the resident front-end does both on the
        device. The GT keeps its file's bit depth."""
        return _imread_rgb_u8(self._path(idx, 0)), _read_label(
            self._path(idx, 1))


class CSFTestData:
    def __init__(self, data_root: str, data_list: str):
        self.root = data_root
        self.names = _read_list(data_list)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> dict:
        img = _load_image(os.path.join(self.root, self.names[idx]))
        return {"image": img, "name": self.names[idx],
                "size": img.shape[:2]}

    def get_u8(self, idx: int) -> dict:
        """Raw uint8 RGB at native size, for the u8 wire (the /255 and the
        ImageNet normalization run on the device)."""
        im = _imread_rgb_u8(os.path.join(self.root, self.names[idx]))
        return {"image": im, "name": self.names[idx], "size": im.shape[:2]}


class CSFJointTrainData(CSFTrainData):
    """Saliency + edge labels (reference dataset/joint_dataset.py): .lst
    lines are "img gt edge"; samples carry an extra "edge"."""

    def __getitem__(self, idx: int) -> dict:
        img = _load_image(self._path(idx, 0))
        gt = _load_label(self._path(idx, 1))
        edge = _load_label(self._path(idx, 2))
        if self.rng.integers(2) == 1:
            img, gt, edge = img[:, ::-1], gt[:, ::-1], edge[:, ::-1]
        return {"image": img, "target": gt, "edge": edge}


CAFFE_BGR_MEAN = np.asarray([104.00699, 116.66877, 122.67892], np.float32)


def load_image_caffe(path: str) -> np.ndarray:
    """Legacy Caffe preprocessing (reference dataset/dataset_old.py): BGR
    order, raw 0-255 range, mean subtracted, no std scaling."""
    return _imread_rgb_u8(path)[:, :, ::-1].astype(np.float32) \
        - CAFFE_BGR_MEAN


def bucket_hw(h: int, w: int, step: int) -> tuple[int, int]:
    """Ceil (h, w) to ``step`` multiples: the shape bucket of a sample."""
    return (-(-h // step) * step, -(-w // step) * step)


def _order(n: int, shuffle: bool, seed: int) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order


def padded_batches(dataset: CSFTrainData, batch_size: int = 1, *,
                   bucket: int = 32, shuffle: bool = True,
                   seed: int = 0) -> Iterator[dict]:
    """Shape-bucketed padded batches {"image", "target", "mask"}: a batch
    is emitted when its bucket holds ``batch_size`` samples, the partial
    buckets at the end. The masked-sum loss equals the native-size one on
    the real pixels; activations near the padding differ (the JAX
    package bounds the loss difference at rel 2e-2)."""
    pending: dict[tuple[int, int], list] = {}
    for idx in _order(len(dataset), shuffle, seed):
        s = dataset[int(idx)]
        key = bucket_hw(*s["image"].shape[:2], bucket)
        pending.setdefault(key, []).append(s)
        if len(pending[key]) == batch_size:
            yield _pad_stack(pending.pop(key), key)
    for key, rest in pending.items():
        yield _pad_stack(rest, key)


def _pad_stack(samples: list, hw: tuple[int, int]) -> dict:
    n = len(samples)
    bh, bw = hw
    img = np.zeros((n, bh, bw, 3), np.float32)
    tgt = np.zeros((n, bh, bw, 1), np.float32)
    msk = np.zeros((n, bh, bw, 1), np.float32)
    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        img[i, :h, :w] = s["image"]
        tgt[i, :h, :w] = s["target"]
        msk[i, :h, :w] = 1.0
    return {"image": img, "target": tgt, "mask": msk}


def fixed_size_batches(dataset: CSFTrainData, batch_size: int,
                       hw: tuple[int, int] = (336, 336), *,
                       shuffle: bool = True, seed: int = 0) -> Iterator[dict]:
    """Fixed-resolution batches (the 336x336 Res2Net-101 recipe): float
    bilinear resizes of the normalized image and the target; the last
    partial batch is dropped."""
    order = _order(len(dataset), shuffle, seed)
    for b in range(len(order) // batch_size):
        samples = [dataset[int(i)]
                   for i in order[b * batch_size:(b + 1) * batch_size]]
        img = np.stack([resize_bilinear_np(s["image"], hw) for s in samples])
        tgt = np.stack([resize_bilinear_np(s["target"][..., 0], hw)[..., None]
                        for s in samples])
        yield {"image": img, "target": tgt}
