"""The port's native SalMetric (``sod100k_tpu_torch.metrics.native``, host
C++ without OpenCV) against the JAX package's native library (OpenCV
reads the PNGs there), on the same files.

The pairs: 12 8-bit gray PNGs of several sizes in one 64-px bucket, with
one saliency file that is not a PNG, one whose zlib stream is corrupt, one
GT at the wrong size, an all-black and an all-white GT. Bars:
- the metric dict within abs 1e-12 of the JAX library's, ``images``
  exactly: the same double arithmetic on the same integer counts, summed
  in another order across threads;
- the CLI's stdout line for line against the JAX ``salmetric`` binary,
  every number within 1e-6 (both print ``%g`` of a float);
- the native backend within abs 1e-5 of the device backend on the CPU,
  the JAX package's own bar between its backends
  (``tests/test_metrics.py::test_eval_backends_agree_on_dirty_pairs``);
- ``run_eval_dirs(backend="native")`` against the JAX driver's: the
  reference block within 1e-12, the device backend's fill under --suite
  full at ``tests/test_torch_cli_eval.py``'s bars (1e-6; S and weighted F
  1e-5).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
from test_torch_cli_eval import METRIC_BARS

from sod100k_tpu_torch.cli import eval as ceval
from sod100k_tpu_torch.data.image_io import write_png
from sod100k_tpu_torch.metrics import native
from sod100k_tpu_torch.metrics.salmetric import format_report
from sod100k_tpu_torch.ops import cuda_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(40, 50), (47, 31), (64, 64), (33, 58), (60, 41), (52, 52),
         (36, 63), (58, 44), (45, 45), (62, 37), (41, 60), (50, 39)]
UNREADABLE, CORRUPT, MISMATCHED, BLACK, WHITE = 3, 11, 7, 5, 9
SCORED = len(SIZES) - 3
FLOAT_KEYS = ("mae", "max_f", "mean_f", "precision_at_max", "recall_at_max",
              "mean_precision", "mean_recall", "precision", "recall")


@pytest.fixture(scope="module")
def jnative():
    from sod100k_tpu.metrics import native as jn

    try:
        jn.build()
    except RuntimeError as e:  # OpenCV 4 and make are the JAX tool's needs
        pytest.skip(f"the JAX package's native build is unavailable: {e}")
    return jn


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("salmetric")
    sal_dir, gt_dir = root / "sal", root / "gt"
    sal_dir.mkdir()
    gt_dir.mkdir()
    rng = np.random.default_rng(80)
    out = []
    for i, (h, w) in enumerate(SIZES):
        sal = rng.integers(0, 256, (h, w), np.uint8)
        gt = ((rng.random((h, w)) > 0.6) * 255).astype(np.uint8)
        gt[:, : w // 3] = rng.integers(0, 256, (h, w // 3), np.uint8)
        if i == BLACK:
            gt[:] = 0
        elif i == WHITE:
            gt[:] = 255
        elif i == MISMATCHED:
            gt = gt[:h - 5]
        sp, gp = str(sal_dir / f"{i}.png"), str(gt_dir / f"{i}.png")
        write_png(sp, sal)
        write_png(gp, gt)
        out.append((sp, gp))
    with open(out[UNREADABLE][0], "wb") as f:
        f.write(b"not a png")
    with open(out[CORRUPT][0], "r+b") as f:  # the zlib header of IDAT
        data = f.read()
        f.seek(data.index(b"IDAT") + 4)
        f.write(b"\xff\xff")
    lst = root / "list.txt"
    lst.write_text("".join(f"{s} {g}\n" for s, g in out))
    return {"pairs": out, "list": str(lst), "sal_dir": str(sal_dir),
            "gt_dir": str(gt_dir)}


def _skips(stderr: str) -> list:
    """The skipped pairs' messages (libpng adds its own lines on the JAX
    side)."""
    return sorted(ln for ln in stderr.splitlines()
                  if ln.startswith(("unreadable pair: ", "size mismatch: ")))


def _close(got: dict, want: dict, keys, atol: float) -> None:
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("threads,chunk", [(1, 256), (4, 5)])
def test_do_evaluation_matches_the_jax_library(pairs, jnative, monkeypatch,
                                               capfd, threads, chunk):
    """One chunk on one thread, and chunks of 5 on 4 threads; the skipped
    pairs' messages on stderr are the JAX library's."""
    monkeypatch.setattr(native, "CHUNK", chunk)
    sal, gt = zip(*pairs["pairs"])
    want = jnative.do_evaluation(threads, list(sal), list(gt),
                                 print_stdout=False)
    want_err = capfd.readouterr().err
    got = native.do_evaluation(threads, list(sal), list(gt),
                               print_stdout=False)
    got_err = capfd.readouterr().err
    assert got.keys() == want.keys()
    assert got["images"] == want["images"] == SCORED
    _close(got, want, FLOAT_KEYS, 1e-12)
    assert _skips(got_err) == _skips(want_err)
    assert len(_skips(got_err)) == len(got_err.splitlines()) == 3


def test_mismatched_lists_are_refused():
    with pytest.raises(ValueError, match="empty or mismatched"):
        native.do_evaluation(1, ["a.png"], [])


def _numbers(line: str):
    return [float(v) for v in re.findall(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?",
                                         line)]


def _same_lines(got: list, want: list, rtol: float = 0.0,
                atol: float = 1e-6) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert re.sub(r"[-\d.e+]+", "#", a) == re.sub(r"[-\d.e+]+", "#", b)
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=rtol,
                                   atol=atol, err_msg=a)


def test_cli_matches_the_jax_binary(pairs, jnative):
    """``python -m sod100k_tpu_torch.metrics.native list 2`` prints the
    JAX ``salmetric`` binary's lines (the thread line, 256 threshold
    lines, 7 summary lines), and the report is ``do_evaluation``'s dict
    through ``format_report`` (6 significant digits of the float, or of
    the double there: rel 1e-5)."""
    want = subprocess.run([jnative.cli_path(), pairs["list"], "2"],
                          capture_output=True, text=True, check=True)
    got = subprocess.run(
        [sys.executable, "-m", "sod100k_tpu_torch.metrics.native",
         pairs["list"], "2"], capture_output=True, text=True, check=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    lines = got.stdout.splitlines()
    assert len(lines) == 1 + 256 + 7
    assert lines[0] == "2 threads are being used for accelerating."
    _same_lines(lines, want.stdout.splitlines())
    assert _skips(got.stderr) == _skips(want.stderr)
    sal, gt = zip(*pairs["pairs"])
    res = native.do_evaluation(2, list(sal), list(gt), print_stdout=False)
    res["fmeasure"] = native.fmeasure_curve(res)
    _same_lines(lines[1:], format_report(res).splitlines(), 1e-5, 0.0)
    usage = subprocess.run(
        [sys.executable, "-m", "sod100k_tpu_torch.metrics.native"],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert usage.returncode == 1 and usage.stderr.startswith("Usage:")


def test_native_backend_matches_the_device_backend(pairs):
    got = ceval.evaluate_pairs_native(pairs["pairs"])
    want = ceval.evaluate_pairs_device(pairs["pairs"], batch=4,
                                       log=lambda *a: None, device="cpu")
    assert got["images"] == SCORED
    _close(got, want, ("max_f", "mae", "mean_f", "mean_precision",
                       "mean_recall", "precision", "recall", "fmeasure"),
           1e-5)


@pytest.mark.parametrize("suite", ["reference", "full"])
def test_eval_dirs_native_matches_the_jax_driver(pairs, jnative, suite):
    from cli.eval import run_eval_dirs as jrun

    quiet = lambda *a, **k: None  # noqa: E731
    want = jrun(pairs["sal_dir"], pairs["gt_dir"], backend="native",
                suite=suite, log=quiet)
    got = ceval.run_eval_dirs(pairs["sal_dir"], pairs["gt_dir"],
                              backend="native", suite=suite, log=quiet,
                              device="cpu")
    assert got.keys() == want.keys()
    assert got["images"] == want["images"] == SCORED
    _close(got, want, (*FLOAT_KEYS, "fmeasure"), 1e-12)
    extra = sorted(set(got) - set(FLOAT_KEYS) - {"images", "fmeasure"})
    assert extra == ([] if suite == "reference" else
                     ["adaptive_e", "adaptive_f", "emeasure", "max_e",
                      "mean_e", "s_measure", "weighted_f"])
    for k in extra:
        _close(got, want, (k,), METRIC_BARS.get(k, 1e-6))


@pytest.mark.parametrize("patch", ["compiler", "flags"])
def test_a_failed_build_raises(monkeypatch, tmp_path, patch, pairs):
    """A missing compiler, or one that fails, raises RuntimeError with
    its message; nothing falls back to the device backend."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path))
    if patch == "compiler":
        monkeypatch.setattr(cuda_lib, "HOST_CXX", "no-such-c++-compiler")
        match = r"no-such-c\+\+-compiler not found"
    else:
        monkeypatch.setattr(cuda_lib, "HOST_FLAGS",
                            (*cuda_lib.HOST_FLAGS, "-no-such-flag"))
        match = "(?s)failed for salmetric.cc:\n.*no-such-flag"
    native._lib.cache_clear()
    cuda_lib.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=match):
            ceval.run_eval_dirs(pairs["sal_dir"], pairs["gt_dir"],
                                backend="native", device="cpu")
    finally:
        native._lib.cache_clear()
        cuda_lib.load_host.cache_clear()
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".so")]


def test_native_full_suite_when_nothing_decodes(tmp_path, jnative):
    """No pair decodes: both drivers return the native block alone (zeros
    over the listed count), with no fill from the device backend."""
    from cli.eval import run_eval_dirs as jrun

    for d in ("sal", "gt"):
        (tmp_path / d).mkdir()
    for i in range(2):
        (tmp_path / "sal" / f"{i}.png").write_bytes(b"not a png")
        write_png(str(tmp_path / "gt" / f"{i}.png"),
                  np.zeros((8, 8), np.uint8))
    quiet = lambda *a, **k: None  # noqa: E731
    args = (str(tmp_path / "sal"), str(tmp_path / "gt"))
    want = jrun(*args, backend="native", suite="full", log=quiet)
    log = []
    got = ceval.run_eval_dirs(*args, backend="native", suite="full",
                              log=log.append, device="cpu")
    assert got.keys() == want.keys() and got["images"] == 0
    _close(got, want, (*FLOAT_KEYS, "fmeasure"), 1e-12)
    assert any("full-suite fill skipped" in m for m in log)
