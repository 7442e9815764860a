"""Saliency evaluation driver (the port of ``cli/eval.py``).

Usage: python -m sod100k_tpu_torch.cli.eval --config <yml> [--method task]
           [--range b,e] [--suite reference|full] [--wfmeasure]
       python -m sod100k_tpu_torch.cli.eval --dirs SAL_DIR GT_DIR
           [--sal-suffix _sal_fuse]

For each dataset and epoch: pair saliency PNGs (DATA.SAVEDIR/task/{ds}_{e})
with GTs (TEST.DATASET_PATH/{ds}/GT), evaluate MAE / 256-threshold P/R /
F-beta, log per-epoch reports, and track the best epoch by Max-F
(reference eval.py:34-76). The files written (FmeasureResults_{ds}.txt,
FmeasureResult_{ds}_{e}.txt, val_{ds}_{e}.txt) have the JAX driver's names
and formats.

Backends:
- "device" (default): batched reductions on the card
  (``metrics/salmetric.py``, ``metrics/smeasure.py``; weighted F on the
  host), with adaptive F, E-measure and S-measure;
- "native": the reference SalMetric's C++ core on the host
  (``metrics/native.py``), the reference block only (MAE, P/R/F); with
  ``--suite full`` the device backend fills in the rest.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from ..config import get_cfg
from ..data.csf_dataset import bucket_hw
from ..data.image_io import image_size
from ..data.pipeline import imread_gray_u8_or_none, require_device
from ..metrics.native import do_evaluation, fmeasure_curve
from ..metrics.salmetric import (SalMetricAccumulator, as_device_tensor,
                                 format_report)

BACKENDS = ("device", "native")


def _pairs(sal_dir: str, gt_dir: str, sal_suffix: str = "",
           log=print) -> list[tuple[str, str]]:
    """Pair sal PNGs with same-named GTs; ``sal_suffix`` is stripped from
    the sal stem before matching (e.g. "_sal_fuse" pairs cli.csf test-mode
    dumps `name_sal_fuse.png` with `name.png`/`name.jpg` GTs). A file
    without the suffix still pairs by its full stem; the count of such
    files is logged, since a folder holding both `name.png` and
    `name_sal_fuse.png` scores that image twice."""
    out, unsuffixed = [], 0
    for name in sorted(os.listdir(sal_dir)):
        if not name.endswith(".png"):
            continue
        stem = name[:-4]
        if sal_suffix and stem.endswith(sal_suffix):
            stem = stem[:-len(sal_suffix)]
        elif sal_suffix:
            unsuffixed += 1
        for ext in (".png", ".jpg", ".bmp"):
            gt = os.path.join(gt_dir, stem + ext)
            if os.path.exists(gt):
                out.append((os.path.join(sal_dir, name), gt))
                break
    if unsuffixed:
        log(f"eval: {unsuffixed} PNG(s) in {sal_dir} lack the suffix "
            f"{sal_suffix!r}; each is paired by its full stem")
    return out


def _size(path: str):
    """Header-only (h, w) read, no pixel decode; None when unreadable."""
    try:
        return image_size(path)
    except (OSError, ValueError, RuntimeError):
        return None


def evaluate_pairs_device(pairs, batch: int = 32, with_smeasure: bool = True,
                          with_wfmeasure: bool = False, log=print, *,
                          device: str | torch.device = "cuda") -> dict:
    """Shape-bucketed padded batches through the accumulator on ``device``.

    Bucketing uses header-only size reads (pixels decode per chunk, so
    memory stays bounded at one chunk); every chunk pads to `batch` images.
    Unreadable or size-mismatched pairs are skipped with a warning, as the
    reference's native tool skips them (sal_metric.cpp:67-71)."""
    from ..metrics.smeasure import s_measure_batch
    from ..metrics.wfmeasure import weighted_f_measure

    device = require_device(device)
    acc = SalMetricAccumulator(device=device)
    s_sum, s_n = 0.0, 0
    wf_sum = 0.0
    buckets: dict[tuple[int, int], list] = defaultdict(list)
    for sp, gp in pairs:
        hw = _size(sp)
        if hw is None or _size(gp) != hw:
            log(f"eval: skipping unreadable/mismatched pair {sp}")
            continue
        buckets[bucket_hw(*hw, 64)].append((sp, gp))

    for (bh, bw), items in buckets.items():
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            k = len(chunk)
            # trailing rows are all-zero-mask and excluded via count=k
            sal_p = np.zeros((batch, bh, bw), np.float32)
            gt_p = np.zeros((batch, bh, bw), np.float32)
            m = np.zeros((batch, bh, bw), np.float32)
            skipped = 0
            for j, (sp, gp) in enumerate(chunk):
                sal = imread_gray_u8_or_none(sp)
                gt = imread_gray_u8_or_none(gp)
                if sal is None or gt is None or sal.shape != gt.shape:
                    log(f"eval: skipping undecodable pair {sp}")
                    skipped += 1
                    continue
                h, w = sal.shape
                jj = j - skipped
                sal_p[jj, :h, :w] = sal
                gt_p[jj, :h, :w] = gt
                m[jj, :h, :w] = 1
                if with_wfmeasure:
                    # on the host per image (the distance transform is
                    # sequential work); unpadded crop on purpose
                    wf_sum += weighted_f_measure(sal / 255.0, gt > 128)
            k -= skipped
            if not k:
                continue
            acc.update_batch(sal_p, gt_p, mask=m, count=k)
            if with_smeasure:
                sal_d = as_device_tensor(sal_p, device)
                gt_d = as_device_tensor(gt_p, device)
                sm = s_measure_batch(sal_d / 255.0, (gt_d > 128).float(),
                                     as_device_tensor(m, device))
                s_sum += float(sm[:k].double().sum())
                s_n += k
    # reference divisor semantics (sal_metric.cpp:158-162): macro averages
    # divide by the LISTED pair count, skipped pairs included
    if acc.n:
        acc.n = len(pairs)
        s_n = len(pairs)
    res = acc.result()
    if with_smeasure and s_n:
        res["s_measure"] = s_sum / s_n
    if with_wfmeasure and acc.n:
        res["weighted_f"] = wf_sum / acc.n
    return res


def evaluate_pairs_native(pairs, num_threads: int = 8) -> dict:
    """The reference block on the host library, with the 256-threshold F
    curve derived from its P/R so that the FmeasureResult file carries the
    full reference report on this backend too."""
    res = do_evaluation(num_threads, [p[0] for p in pairs],
                        [p[1] for p in pairs], print_stdout=False)
    res["fmeasure"] = fmeasure_curve(res)
    return res


def _fill_full_native(res: dict, pairs, log, device) -> None:
    """--suite full on the native backend: the C++ core computes the
    reference block only; the device backend (on ``device``) adds the
    modern metrics and the host weighted F. Where no pair decodes, the
    native result (its divisor semantics) stands alone."""
    if not res["images"]:
        log("eval: full-suite fill skipped: no decodable pairs for the "
            "modern metrics")
        return
    extra = evaluate_pairs_device(pairs, with_wfmeasure=True, log=log,
                                  device=device)
    for key in ("adaptive_f", "adaptive_e", "emeasure", "max_e", "mean_e",
                "s_measure", "weighted_f"):
        res[key] = extra[key]


def _evaluate(pairs, backend: str, full: bool, wfmeasure: bool, log,
              device) -> dict:
    """Score ``pairs`` on ``backend``; refuses an explicitly requested
    weighted F that the native backend would not compute."""
    if backend not in BACKENDS:
        raise SystemExit(f"--backend must be device|native, got {backend!r}")
    if backend == "device":
        return evaluate_pairs_device(pairs, with_wfmeasure=wfmeasure or full,
                                     log=log, device=device)
    if wfmeasure and not full:
        raise SystemExit("--wfmeasure is not computed by the native "
                         "backend; use --backend device or --suite full")
    res = evaluate_pairs_native(pairs)
    if full:
        _fill_full_native(res, pairs, log, device)
    return res


def _report_line(prefix: str, res: dict, full: bool) -> str:
    report = (f"{prefix}: MaxF {res['max_f']:.6f} "
              f"MAE {res['mae']:.6f} MeanF {res['mean_f']:.6f}")
    if "adaptive_f" in res:
        report += f" AdpF {res['adaptive_f']:.6f}"
    if "max_e" in res:
        report += f" MaxE {res['max_e']:.6f}"
    if full and "mean_e" in res:
        report += (f" MeanE {res['mean_e']:.6f}"
                   f" AdpE {res['adaptive_e']:.6f}")
    if "s_measure" in res:
        report += f" S {res['s_measure']:.6f}"
    if "weighted_f" in res:
        report += f" wF {res['weighted_f']:.6f}"
    return report


def run_eval_dirs(sal_dir: str, gt_dir: str, *, backend: str = "device",
                  suite: str = "reference", wfmeasure: bool = False,
                  sal_suffix: str = "", log=print,
                  device: str | torch.device = "cuda") -> dict:
    """Layout-free evaluation: score any saliency-dump directory against
    any GT directory (--dirs); --sal-suffix pairs suffixed names (cli.csf
    test-mode `*_sal_fuse.png` dumps)."""
    full = suite == "full"
    pairs = _pairs(sal_dir, gt_dir, sal_suffix=sal_suffix, log=log)
    if not pairs:
        raise SystemExit(f"no sal/GT pairs between {sal_dir} and {gt_dir} "
                         f"(sal_suffix={sal_suffix!r})")
    res = _evaluate(pairs, backend, full, wfmeasure, log, device)
    log(_report_line(f"{os.path.basename(os.path.normpath(sal_dir))} "
                     f"({len(pairs)} pairs)", res, full))
    return res


def run_eval(cfg, epoch_range=(0, 1), method: str | None = None,
             backend: str | None = None, datasets=None,
             wfmeasure: bool = False, suite: str = "reference",
             log=print, *, device: str | torch.device = "cuda") -> dict:
    """suite="reference" (default): MaxF/MAE/MeanF plus the device
    backend's extras (adaptive F, E, S), wF only behind ``wfmeasure``.
    suite="full": the whole modern suite from one invocation (MAE,
    max/mean/adaptive F, max/mean/adaptive E, S, wF) on either backend.
    The per-epoch FmeasureResult file keeps the 7-line reference contract
    (``format_report``)."""
    if suite not in ("reference", "full"):
        raise SystemExit(f"--suite must be reference|full, got {suite}")
    full = suite == "full"
    method = method or cfg.TASK or cfg.MODEL.ARCH
    backend = backend or cfg.CUDA.EVAL_BACKEND
    datasets = datasets or cfg.TEST.DATASETS
    out_dir = os.path.join(cfg.DATA.SAVEDIR, method)
    os.makedirs(out_dir, exist_ok=True)
    best = {}
    for ds in datasets:
        best_f, best_epoch = 0.0, -1
        flog_path = os.path.join(out_dir, f"FmeasureResults_{ds}.txt")
        with open(flog_path, "a") as flog:
            for epoch in range(*epoch_range):
                sal_dir = os.path.join(out_dir, f"{ds}_{epoch}")
                gt_dir = os.path.join(cfg.TEST.DATASET_PATH, ds, "GT")
                if not os.path.isdir(sal_dir):
                    continue
                pairs = _pairs(sal_dir, gt_dir, log=log)
                if not pairs:
                    continue
                # inspectable "salpath gtpath" pair list (eval.py:52-59),
                # also what the reference's SalMetric CLI reads
                with open(os.path.join(out_dir, f"val_{ds}_{epoch}.txt"),
                          "w") as plist:
                    plist.writelines(f"{sp} {gp}\n" for sp, gp in pairs)
                res = _evaluate(pairs, backend, full, wfmeasure, log,
                                device)
                report = _report_line(f"epoch {epoch} {ds}", res, full)
                log(report)
                flog.write(report + "\n")
                with open(os.path.join(out_dir,
                                       f"FmeasureResult_{ds}_{epoch}.txt"),
                          "w") as f:
                    f.write(format_report(res))
                if res["max_f"] > best_f:
                    best_f, best_epoch = res["max_f"], epoch
        best[ds] = {"max_f": best_f, "epoch": best_epoch}
        log(f"best for {ds}: MaxF {best_f:.6f} @ epoch {best_epoch}")
    return best


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="SOD evaluation on the card")
    parser.add_argument("--config", default=None, metavar="FILE")
    parser.add_argument("--dirs", nargs=2, default=None,
                        metavar=("SAL_DIR", "GT_DIR"),
                        help="layout-free mode: score SAL_DIR's PNGs "
                        "against GT_DIR directly (no config needed)")
    parser.add_argument("--sal-suffix", default="",
                        help="suffix stripped from sal names before GT "
                        "matching (cli.csf dumps use _sal_fuse)")
    parser.add_argument("--method", default=None)
    parser.add_argument("--range", default="0,1",
                        help="epoch range begin,end (python range semantics)")
    parser.add_argument("--backend", default=None, choices=list(BACKENDS),
                        help="device (default) or native (the C++ "
                        "SalMetric core on the host)")
    parser.add_argument("--wfmeasure", action="store_true",
                        help="also report the weighted F-measure (Margolin "
                        "CVPR'14, on the host; device backend or --suite "
                        "full)")
    parser.add_argument("--suite", default="reference",
                        choices=["reference", "full"],
                        help="'full' reports the whole modern suite from "
                        "one invocation (MAE, max/mean/adaptive F and E, "
                        "S-measure, weighted F) on either backend")
    args = parser.parse_args(argv)
    if args.dirs:
        run_eval_dirs(args.dirs[0], args.dirs[1],
                      backend=args.backend or "device", suite=args.suite,
                      wfmeasure=args.wfmeasure, sal_suffix=args.sal_suffix)
        return
    if not args.config:
        parser.error("--config is required (or use --dirs SAL GT)")
    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    if not cfg.TASK:
        cfg.TASK = cfg.MODEL.ARCH
    b, e = (int(v) for v in args.range.split(","))
    run_eval(cfg, epoch_range=(b, e), method=args.method,
             backend=args.backend, wfmeasure=args.wfmeasure,
             suite=args.suite)


if __name__ == "__main__":
    main()
