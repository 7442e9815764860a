"""Host-side data pipeline: decode, augment, resize, normalize, prefetch.

Port of ``sod100k_tpu/data/pipeline.py``. The readers and resizes go
through ``image_io`` instead of cv2 and PIL: PNG decodes without either,
uint8 resizes equal cv2's ``INTER_LINEAR`` bit for bit, float resizes
within 2 f32 ulp; JPEG needs PIL. Augmentation draws are the JAX package's
(``np.random.default_rng((seed, epoch, idx))``, the same calls in the same
order), so host and hybrid batches equal the JAX package's where the
decode does.

The u8 wire math (``normalize_u8``, ``quantize_sigmoid_u8``) keeps the JAX
package's op order, so the same inputs give the same f32 values.
``device_prefetch`` stages batches on the card from a producer thread.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..parallel.multihost import local_slice_feed
from .image_io import (image_size, read_image, resize_f32_linear,
                       resize_u8_linear)

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize01(image: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] (..., 3) -> (x - mean)/std."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (image - mean) / std


def normalize_u8(image: torch.Tensor) -> torch.Tensor:
    """Raw uint8 RGB (..., 3) -> (x/255 - mean)/std in f32."""
    return normalize01(image.float() / 255.0)


def quantize_sigmoid_u8(sig: torch.Tensor) -> torch.Tensor:
    """trunc(sig * 255) as uint8: the PNG quantization applied on device."""
    return torch.trunc(sig * 255.0).to(torch.uint8)


def _rgb(img: np.ndarray) -> np.ndarray:
    """Gray -> 3 channels, alpha dropped (gray+alpha keeps its gray)."""
    if img.ndim == 2:
        return img[:, :, None].repeat(3, axis=2)
    if img.shape[2] == 2:
        return img[:, :, :1].repeat(3, axis=2)
    return img[:, :, :3]


def _imread_rgb(path: str) -> np.ndarray:
    """float32 RGB in [0, 1] (skimage img_as_float semantics: 16-bit files
    divide by 65535)."""
    img = _rgb(read_image(path))
    scale = np.float32(65535.0 if img.dtype == np.uint16 else 255.0)
    return img.astype(np.float32) / scale


def _imread_rgb_u8(path: str) -> np.ndarray:
    """uint8 RGB HWC; 16-bit sources keep their high byte."""
    return rgb_u8(read_image(path), path)


def rgb_u8(img: np.ndarray, path: str = "<bytes>") -> np.ndarray:
    """A decoded image as uint8 RGB HWC (cv2's IMREAD_COLOR): 16-bit
    samples keep their high byte, gray is repeated, alpha dropped."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    elif img.dtype != np.uint8:
        raise ValueError(f"unsupported image dtype {img.dtype}: {path}")
    return np.ascontiguousarray(_rgb(img))


def _imread_gray_u8(path: str) -> np.ndarray:
    """GT reader. Supported envelope: 8-bit single-channel PNGs (every
    published SOD GT set). Outside it: 16-bit keeps the high byte, colour
    goes through Rec.601 luma in libpng's 15-bit weights (cv2's
    IMREAD_GRAYSCALE asks libpng for it; within one level of cv2), alpha is
    dropped."""
    img = read_image(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3:
        if img.shape[2] <= 2:
            img = img[:, :, 0]
        else:
            rgb = img[:, :, :3].astype(np.int32)
            img = ((rgb[..., 0] * 9798 + rgb[..., 1] * 19235
                    + rgb[..., 2] * 3735) >> 15).astype(np.uint8)
    return np.ascontiguousarray(img)


# what reading an image file can raise: a missing or unreadable file, a
# malformed PNG, a corrupt zlib stream, a non-PNG without PIL (or one PIL
# cannot identify, an OSError)
_DECODE_ERRORS = (OSError, ValueError, RuntimeError, zlib.error)


def imread_gray_u8_or_none(path: str) -> np.ndarray | None:
    """``_imread_gray_u8``, or None when the file cannot be read or
    decoded (cv2.imread's empty result, which the metric tools skip)."""
    try:
        return _imread_gray_u8(path)
    except _DECODE_ERRORS:
        return None


def resize_bilinear_np(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Half-pixel bilinear resize without antialiasing, in float32."""
    return resize_f32_linear(np.asarray(img, np.float32), hw)


def fold_files(folder: str) -> tuple[str, list[str]]:
    """All stems in a folder sharing one extension (prepare_data.py:13-23)."""
    names = sorted(os.listdir(folder))
    if not names:
        raise ValueError(f"empty data folder {folder}")
    ext = names[0].rsplit(".", 1)[-1]
    return ext, [n[: -(len(ext) + 1)] for n in names]


class Augment:
    """Joint crop+flip augmentation (prepare_data.py:26-88): a random crop of
    up to size_h/size_w pixels per edge (at least 1 from bottom/right), then
    an lr or ud flip with probability p_flip (lr/ud 50/50). Draws come from
    ``np.random.default_rng((seed, epoch, idx))``, so an epoch is the same
    at any number of threads."""

    def __init__(self, size_h: int = 15, size_w: int = 15,
                 p_flip: float = 0.5, seed: int = 0):
        self.size_h, self.size_w, self.p_flip = size_h, size_w, p_flip
        self.seed = seed

    def __call__(self, img: np.ndarray, target: np.ndarray,
                 key: tuple[int, int] = (0, 0)):
        h, w = img.shape[:2]
        if h <= self.size_h * 2 or w <= self.size_w * 2:
            raise ValueError(
                f"Image size too small for augmentation: {h}x{w} vs "
                f"crop margins {self.size_h}/{self.size_w}")
        rng = np.random.default_rng((self.seed, *key))
        r1 = int(rng.integers(self.size_h))
        r2 = -int(rng.integers(self.size_h)) - 1
        c1 = int(rng.integers(self.size_w))
        c2 = -int(rng.integers(self.size_w)) - 1
        flip = None
        if rng.random() < self.p_flip:
            flip = "lr" if rng.random() < 0.5 else "ud"

        def tf(a):
            a = a[r1:r2, c1:c2]
            if flip == "lr":
                a = a[:, ::-1]
            elif flip == "ud":
                a = a[::-1]
            return a

        return tf(img), tf(target)


class SalData:
    """images/* + GT/*.png dataset (prepare_data.py:91-139).

    ``cache=True`` keeps the decoded uint8 image/GT pairs in RAM after first
    touch; the augmentation stays per-epoch random."""

    def __init__(self, data_dir: str, size: tuple[int, int],
                 augmentation: bool = True, mode: str = "train", seed: int = 0,
                 cache: bool = False):
        img_dir = os.path.join(data_dir, "images")
        if not os.path.isdir(img_dir):
            raise ValueError(
                "Please put your images in folder 'images' and GT in 'GT'")
        self.data_dir = data_dir
        self.img_ext, self.stems = fold_files(img_dir)
        self.size = size
        self.mode = mode
        self.aug = Augment(seed=seed) if (augmentation and mode == "train") \
            else None
        self._epoch_seed = 0
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] | None = (
            {} if cache else None)

    def set_epoch_seed(self, epoch_seed: int) -> None:
        """Key this epoch's per-sample augmentation draws."""
        self._epoch_seed = int(epoch_seed)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.data_dir, "images",
                            f"{self.stems[idx]}.{self.img_ext}")

    def _decode_u8(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """uint8 (image HWC, gt HW) at native resolution, RAM-cached."""
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        img = _imread_rgb_u8(self.image_path(idx))
        gt = _imread_gray_u8(os.path.join(self.data_dir, "GT",
                                          f"{self.stems[idx]}.png"))
        if self._cache is not None:
            self._cache[idx] = (img, gt)
        return img, gt

    def __len__(self) -> int:
        return len(self.stems)

    def raw_item(self, idx: int) -> dict:
        """uint8 image/GT at native resolution (the device front-end)."""
        img, gt = self._decode_u8(idx)
        return {"image_u8": img, "gt_u8": gt,
                "hw": np.asarray(gt.shape[:2], np.int32)}

    def hybrid_item(self, idx: int) -> dict:
        """Crop/flip and resize on the host in uint8; the normalization runs
        in the train step (``from_u8``)."""
        img, gt = self._decode_u8(idx)
        if self.aug is not None:
            img, gt = self.aug(img, gt, key=(self._epoch_seed, idx))
        img = resize_u8_linear(np.ascontiguousarray(img), self.size)
        gt = resize_u8_linear(np.ascontiguousarray(gt), self.size)
        return {"image_u8": img, "target_u8": gt[..., None]}

    def __getitem__(self, idx: int) -> dict:
        img_u8, gt_u8 = self._decode_u8(idx)
        img = img_u8.astype(np.float32) / np.float32(255.0)
        gt = gt_u8.astype(np.float32) / np.float32(255.0)
        h, w = gt.shape
        if self.aug is not None:
            img, gt = self.aug(img, gt, key=(self._epoch_seed, idx))
        img = resize_bilinear_np(img, self.size)
        if self.mode == "train":
            gt = resize_bilinear_np(gt, self.size)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        sample = {"image": img.astype(np.float32),
                  "target": gt.astype(np.float32)[..., None]}
        if self.mode != "train":
            sample["h"], sample["w"] = h, w
        return sample


def preprocess_test_image(path: str, hw: tuple[int, int] = (0, 0)):
    """test.py:71-86 protocol: fixed HxW resize, or ceil-to-16-multiple.
    Returns (image NHWC float32 with batch dim, (orig_h, orig_w))."""
    img = _imread_rgb(path)
    h, w = img.shape[:2]
    if hw[0] != 0 and hw[1] != 0:
        img = resize_bilinear_np(img, hw)
    elif h % 16 != 0 or w % 16 != 0:
        img = resize_bilinear_np(
            img, (math.ceil(h / 16) * 16, math.ceil(w / 16) * 16))
    img = (img - IMAGENET_MEAN) / IMAGENET_STD
    return img.astype(np.float32)[None], (h, w)


def _epoch_order(dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 seed: int) -> tuple[np.ndarray, int]:
    order = np.arange(len(dataset))
    if hasattr(dataset, "set_epoch_seed"):
        dataset.set_epoch_seed(seed)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order) // batch_size
    if not drop_last and n * batch_size < len(order):
        n += 1
    return order, n


def batches(dataset: SalData, batch_size: int, *, shuffle: bool = True,
            drop_last: bool = True, seed: int = 0,
            num_threads: int = 4) -> Iterator[dict]:
    """Epoch iterator of stacked float batches, decoded on threads. Val GTs
    at native size stay a ragged list with "h"/"w" beside them."""
    order, n = _epoch_order(dataset, batch_size, shuffle, drop_last, seed)
    with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as pool:
        for b in range(n):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            samples = list(pool.map(dataset.__getitem__, idxs))
            targets = [s["target"] for s in samples]
            batch = {"image": np.stack([s["image"] for s in samples])}
            if len({t.shape for t in targets}) == 1:
                batch["target"] = np.stack(targets)
            else:
                batch["target"] = targets
            if "h" in samples[0]:
                batch["h"] = [s["h"] for s in samples]
                batch["w"] = [s["w"] for s in samples]
            yield batch


def hybrid_batches(dataset: SalData, batch_size: int, *, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 0,
                   num_threads: int = 4) -> Iterator[dict]:
    """Epoch iterator of uint8 train-size batches:
    {"image_u8": (N,H,W,3), "target_u8": (N,H,W,1)}."""
    order, n = _epoch_order(dataset, batch_size, shuffle, drop_last, seed)
    with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as pool:
        for b in range(n):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            samples = list(pool.map(dataset.hybrid_item, idxs))
            yield {"image_u8": np.stack([s["image_u8"] for s in samples]),
                   "target_u8": np.stack([s["target_u8"] for s in samples])}


def raw_batches(dataset: SalData, batch_size: int, *, shuffle: bool = True,
                drop_last: bool = True, seed: int = 0, num_threads: int = 4,
                pad_multiple: int = 64, group_by_aspect: bool = True,
                crop_margin: int = 15) -> Iterator[dict]:
    """Decode-only epoch iterator for the device front-end: each batch
    zero-padded (bottom/right) to its max H/W rounded up to pad_multiple,
    {"image_u8": (N,Hp,Wp,3), "gt_u8": (N,Hp,Wp), "valid_hw": (N,2) int32}.
    Under shuffle, group_by_aspect keeps each batch one orientation
    (landscape first), from header-only size reads, cached."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if group_by_aspect and shuffle and len(order):
        sizes = getattr(dataset, "_header_sizes", None)
        if sizes is None:
            sizes = np.asarray([image_size(dataset.image_path(i))
                                for i in range(len(dataset))], np.int64)
            dataset._header_sizes = sizes
        landscape = sizes[order, 1] >= sizes[order, 0]
        order = np.concatenate([order[landscape], order[~landscape]])
    n = len(order) // batch_size
    if not drop_last and n * batch_size < len(order):
        n += 1

    def up(v: int) -> int:
        return max(int(math.ceil(v / pad_multiple) * pad_multiple),
                   pad_multiple)

    with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as pool:
        for b in range(n):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            samples = list(pool.map(dataset.raw_item, idxs))
            hp = up(max(int(s["hw"][0]) for s in samples))
            wp = up(max(int(s["hw"][1]) for s in samples))
            imgs = np.zeros((len(samples), hp, wp, 3), np.uint8)
            gts = np.zeros((len(samples), hp, wp), np.uint8)
            hws = np.zeros((len(samples), 2), np.int32)
            for i, s in enumerate(samples):
                h, w = int(s["hw"][0]), int(s["hw"][1])
                if h <= crop_margin * 2 or w <= crop_margin * 2:
                    # the host Augment's guard: the device crop cannot
                    # raise and would sample a degenerate box
                    raise ValueError(
                        f"Image size too small for augmentation: {h}x{w} vs "
                        f"crop margins {crop_margin}/{crop_margin}")
                imgs[i, :h, :w] = s["image_u8"]
                gts[i, :h, :w] = s["gt_u8"]
                hws[i] = (h, w)
            yield {"image_u8": imgs, "gt_u8": gts, "valid_hw": hws}


def require_device(device) -> torch.device:
    """The device a data path runs on; the card must exist when named."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run this path on the CPU")
    return device


def device_prefetch(it: Iterator[dict], *, device="cuda",
                    depth: int = 2, mesh=None,
                    bands: bool = True) -> Iterator[dict]:
    """Overlap host batch production with device compute: a producer thread
    moves each batch's numpy arrays to ``device`` into a queue of ``depth``.
    On the card the arrays go through pinned host memory and a non-blocking
    copy on a side stream; each batch carries an event that the consumer's
    stream waits on before the batch is yielded. Other values pass through.
    Abandoning the generator releases the producer.

    Under data parallelism (several processes) the iterator yields the
    same index-deterministic global batch on every rank and only this
    rank's rows move (``parallel.multihost.local_slice_feed``; under a 2-D
    ``mesh`` the data index's rows, and with ``bands`` only the spatial
    index's band of each image)."""
    device = require_device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def place(batch: dict):
        batch = local_slice_feed(batch, mesh=mesh, bands=bands)
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    with torch.cuda.stream(stream):
                        t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            else:
                out[k] = v
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    abandoned = threading.Event()

    def _put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                if not _put(place(batch)):
                    return
            _put(stop)
        except BaseException as e:  # surfaced to the consumer
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if cuda:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            yield batch
    finally:
        abandoned.set()
        t.join(timeout=5)
