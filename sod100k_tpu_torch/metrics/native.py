"""The native SalMetric: the reference's C++ metric tool without OpenCV.

Port of ``sod100k_tpu/metrics/native.py`` (the reference's Cython
``do_evaluation(num_thread, sal_lst, gt_lst)``, SalMetric/python). The
metric core is host C++ (``csrc/salmetric.cc``), built with the host
compiler at first use and bound with ``ctypes``; the PNGs decode here in
Python (``data/pipeline._imread_gray_u8``, no cv2), ``CHUNK`` pairs at a
time on ``num_thread`` threads, and go to the library as u8 buffers. A
pair that does not decode, or whose two images differ in size, is
skipped with a message on stderr and still counts in the divisor, as in
the reference. A failed build raises; nothing falls back.

    python -m sod100k_tpu_torch.metrics.native list_file [num_threads]

is the reference's ``salmetric`` CLI: ``list_file`` holds "sal gt" path
pairs; it prints the thread line, 256 threshold lines and 7 summary lines.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..data.pipeline import imread_gray_u8_or_none
from ..ops.cuda_lib import load_host
from .salmetric import BETA2, THRESHOLDS

CHUNK = 256  # pairs decoded and held at once

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_host("salmetric")
    lib.salmetric_new.restype = _P
    lib.salmetric_new.argtypes = [ctypes.c_int]
    lib.salmetric_free.restype = None
    lib.salmetric_free.argtypes = [_P]
    lib.salmetric_feed.restype = None
    lib.salmetric_feed.argtypes = [
        _P, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), _PP, _PP, _INTS, _INTS]
    lib.salmetric_finish.restype = ctypes.c_int
    lib.salmetric_finish.argtypes = [_P, ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_double)]
    return lib


def _feed(lib, handle, sal_paths, gt_paths, pool) -> None:
    """Decode one chunk of pairs and hand it to the library."""
    n = len(sal_paths)
    imgs = list(pool.map(imread_gray_u8_or_none, [*sal_paths, *gt_paths]))
    sal, gt = imgs[:n], imgs[n:]
    ptrs = [(ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()]
    hws = [(ctypes.c_int * (2 * n))(), (ctypes.c_int * (2 * n))()]
    for side, arrs in enumerate((sal, gt)):
        for i, a in enumerate(arrs):
            if a is None:
                continue
            if a.dtype != np.uint8 or not a.flags.c_contiguous:
                raise ValueError(f"expected a contiguous uint8 plane, got "
                                 f"{a.dtype}: {(sal_paths, gt_paths)[side][i]}")
            ptrs[side][i] = a.ctypes.data  # `imgs` keeps each array alive
            hws[side][2 * i:2 * i + 2] = a.shape
    lib.salmetric_feed(
        handle, n, (ctypes.c_char_p * n)(*[s.encode() for s in sal_paths]),
        (ctypes.c_char_p * n)(*[s.encode() for s in gt_paths]),
        ptrs[0], ptrs[1], hws[0], hws[1])


def do_evaluation(num_thread: int, sal_lst: Sequence[str],
                  gt_lst: Sequence[str], print_stdout: bool = True) -> dict:
    """Evaluate sal/gt path lists; returns the metric dict (the JAX
    package's keys). ``print_stdout`` prints the reference report (256
    threshold lines, 7 summary lines)."""
    if len(sal_lst) != len(gt_lst) or not sal_lst:
        raise ValueError(f"empty or mismatched lists: {len(sal_lst)} "
                         f"saliency maps, {len(gt_lst)} GTs")
    lib = _lib()
    out = (ctypes.c_double * (7 + 2 * THRESHOLDS))()
    handle = lib.salmetric_new(int(num_thread))
    try:
        with ThreadPoolExecutor(max(int(num_thread), 1)) as pool:
            for i in range(0, len(sal_lst), CHUNK):
                _feed(lib, handle, sal_lst[i:i + CHUNK], gt_lst[i:i + CHUNK],
                      pool)
        sys.stdout.flush()  # the library writes to the same stdout
        sys.stderr.flush()
        images = lib.salmetric_finish(handle, len(sal_lst), int(print_stdout),
                                      out)
    finally:
        lib.salmetric_free(handle)
    return {
        "images": images,
        "mae": out[0],
        "max_f": out[1],
        "mean_f": out[2],
        "precision_at_max": out[3],
        "recall_at_max": out[4],
        "mean_precision": out[5],
        "mean_recall": out[6],
        "precision": list(out[7:7 + THRESHOLDS]),
        "recall": list(out[7 + THRESHOLDS:7 + 2 * THRESHOLDS]),
    }


def fmeasure_curve(res: dict) -> np.ndarray:
    """The 256-threshold F curve of a ``do_evaluation`` dict, from its P/R
    (the library's formula)."""
    p = np.asarray(res["precision"])
    r = np.asarray(res["recall"])
    return ((1 + BETA2) * p * r) / (BETA2 * p + r)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2:
        print("Usage: python -m sod100k_tpu_torch.metrics.native list_file "
              "[num_threads]\nList file lines: `<sal.png> <gt.png>`",
              file=sys.stderr)
        return 1
    num_threads = int(argv[1]) if len(argv) == 2 else 4
    print(f"{num_threads} threads are being used for accelerating.",
          flush=True)
    try:
        with open(argv[0]) as f:
            tokens = f.read().split()
    except OSError:
        print(f"cannot open list file {argv[0]}", file=sys.stderr)
        return 1
    if len(tokens) < 2:
        print("empty list file", file=sys.stderr)
        return 1
    n = len(tokens) // 2  # `in >> sal >> gt`: a trailing odd token is dropped
    do_evaluation(num_threads, tokens[0:2 * n:2], tokens[1:2 * n:2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
