"""Synthetic SOD dataset trees (images/ + GT/*.png with blobby saliency).

Port of ``sod100k_tpu/data/synth.py``: the same RNG draws in the same
order, so the GTs are bit-equal to the JAX package's. The images are
written as PNG, not JPEG: without cv2 or PIL there is no JPEG encoder. Each
image file holds what ``cv2.imwrite`` would write for the JAX package's
array (cv2 takes arrays as BGR), so reading either split back gives the
same RGB pixels up to the JAX package's JPEG loss.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .image_io import write_png


def synth_pairs(n: int, *, hw=(300, 400), jitter: int = 0,
                alternate_orientation: bool = True,
                seed: int = 7) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """The (RGB image, GT) pairs ``make_synth_split`` writes, in order: a
    disc of one colour on uniform noise, the disc as the 0/255 GT."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = hw
        if alternate_orientation and i % 2:
            h, w = w, h
        if jitter:
            h += int(rng.integers(-jitter, jitter + 1))
            w += int(rng.integers(-jitter, jitter + 1))
        cy = int(rng.integers(h // 4, 3 * h // 4))
        cx = int(rng.integers(w // 4, 3 * w // 4))
        yy, xx = np.ogrid[0:h, 0:w]
        r = int(rng.integers(max(min(h, w) // 8, 4), max(min(h, w) // 3, 5)))
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        img[blob] = [190, 70, 60]
        yield np.ascontiguousarray(img[:, :, ::-1]), \
            (blob * 255).astype(np.uint8)


def make_synth_split(split_dir: str, n: int, *, hw=(300, 400),
                     jitter: int = 0, alternate_orientation: bool = True,
                     seed: int = 7) -> str:
    """Write n blobby image/GT pairs under split_dir/{images,GT} as PNG.

    hw is the base (H, W); jitter adds +-jitter px per axis;
    alternate_orientation flips H/W for every other image. Idempotent:
    skips generation when the directory already holds >= n images. The
    draws stay in order; the encodes run on 8 threads."""
    img_dir = os.path.join(split_dir, "images")
    gt_dir = os.path.join(split_dir, "GT")
    if os.path.isdir(img_dir) and len(os.listdir(img_dir)) >= n:
        return split_dir
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        jobs = []
        for i, (img, gt) in enumerate(synth_pairs(
                n, hw=hw, jitter=jitter,
                alternate_orientation=alternate_orientation, seed=seed)):
            # noise does not compress: stored (level 0), no row filter;
            # the GT's rows repeat, so Up
            jobs.append(pool.submit(write_png, os.path.join(
                img_dir, f"s{i:04d}.png"), img, filter_type=0, level=0))
            jobs.append(pool.submit(write_png, os.path.join(
                gt_dir, f"s{i:04d}.png"), gt, filter_type=2))
        for j in jobs:
            j.result()
    return split_dir
