"""The port's eval driver, its resident TESTALL sweep, the dataset fetcher
and the smoke chain, against the JAX package's on the same files.

- eval: both packages score the same sal/GT directories (the port's test
  dumps of calibrated weights): MAE, max/mean/adaptive F and E within 1e-6,
  S and weighted F within 1e-5 (``tests/test_torch_metrics.py``'s bars);
  the FmeasureResults and pair-list files have the same names and line
  formats;
- the resident sweep over two checkpoints: the same best epoch, each
  reported number within the JAX test's sweep bars (scalar 1e-4, weighted
  F 5e-4; ``tests/test_torch_data.py``);
- fetch, offline, with file:// zips written here (PNG data: the image
  archives carry PNG bytes under .jpg names, which the readers sniff), and
  the smoke chain on the fetched tree.
"""

import json
import os
import re
import shutil
import zipfile
from argparse import Namespace

import numpy as np
import pytest
import torch

from sod100k_tpu.config import get_cfg as jget_cfg
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.cli import eval as ceval
from sod100k_tpu_torch.cli import smoke as csmoke
from sod100k_tpu_torch.cli.test import run_test, run_testall_resident
from sod100k_tpu_torch.config import get_cfg
from sod100k_tpu_torch.data import fetch as F
from sod100k_tpu_torch.data.image_io import resize_u8_linear, write_png
from sod100k_tpu_torch.data.pipeline import _imread_rgb_u8, normalize_u8
from sod100k_tpu_torch.data.synth import make_synth_split
from sod100k_tpu_torch.train.checkpoint import save_checkpoint

pytest.importorskip("cv2")

HW = 64
METRIC_BARS = {"mae": 1e-6, "max_f": 1e-6, "mean_f": 1e-6,
               "adaptive_f": 1e-6, "max_e": 1e-6, "mean_e": 1e-6,
               "adaptive_e": 1e-6, "s_measure": 1e-5, "weighted_f": 1e-5}


class _Log(list):
    def __call__(self, msg, display=True):
        self.append(str(msg))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A test split, two calibrated checkpoints under one task, and the
    port's fixed-size test dump of the first."""
    root = tmp_path_factory.mktemp("evaltree")
    make_synth_split(str(root / "ECSSD"), 6, hw=(78, 90), seed=4)
    lc = init_layers(8, [0.5, 0.5])
    lc.save(str(root / "lc.bin"))
    img_dir = root / "ECSSD" / "images"
    imgs = np.stack([resize_u8_linear(_imread_rgb_u8(str(img_dir / n)),
                                      (HW, HW))
                     for n in sorted(os.listdir(img_dir))])
    ck_dir = root / "save" / "t" / "checkpoint"
    ck_dir.mkdir(parents=True)
    for epoch in (1, 2):
        model = CSNet(lc, seed=epoch, device="cpu")
        calibrate_bn(model, normalize_u8(torch.from_numpy(imgs)))
        save_checkpoint(str(ck_dir / f"checkpoint_epoch{epoch}.pth.tar"),
                        model, None, epoch=epoch)
    values = {"TASK": "t", "DATA.SAVEDIR": str(root / "save"),
              "DATA.BATCH_SIZE": 4, "TEST.DATASET_PATH": str(root),
              "TEST.DATASETS": ["ECSSD"], "TEST.IMAGE_H": HW,
              "TEST.IMAGE_W": HW, "TEST.MODEL_CONFIG": str(root / "lc.bin"),
              "TEST.CHECKPOINT": str(ck_dir / "checkpoint_epoch1.pth.tar"),
              "TEST.BEGIN": 1, "TEST.INTERVAL": 1}
    cfg, jcfg = get_cfg(), jget_cfg()
    for c in (cfg, jcfg):
        for key, v in values.items():
            node = c
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = v
    jcfg.TPU.MESH_DEVICES = 1
    tested = run_test(cfg, log=_Log(), device="cpu")
    return {"root": root, "cfg": cfg, "jcfg": jcfg,
            "sal_dir": tested["datasets"]["ECSSD"]["sal_dir"]}


def _as_method(run, method: str) -> str:
    """A copy of the test dump under another method name (run_eval reads
    DATA.SAVEDIR/<method>/<ds>_<epoch> and writes its files beside it)."""
    dst = os.path.join(run["cfg"].DATA.SAVEDIR, method, "ECSSD_1")
    if not os.path.isdir(dst):
        shutil.copytree(run["sal_dir"], dst)
    return os.path.dirname(dst)


def _shape(line: str) -> str:
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def test_eval_matches_the_jax_driver_on_the_same_maps(run):
    from cli.eval import evaluate_pairs_device as jevaluate
    from cli.eval import run_eval as jrun_eval

    jdir, pdir = _as_method(run, "jax"), _as_method(run, "port")
    jrun_eval(run["jcfg"], epoch_range=(1, 2), method="jax", suite="full",
              log=_Log())
    best = ceval.run_eval(run["cfg"], epoch_range=(1, 2), method="port",
                          suite="full", log=_Log(), device="cpu")
    assert best["ECSSD"]["epoch"] == 1 and 0.0 < best["ECSSD"]["max_f"] < 1
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for name in ("FmeasureResults_ECSSD.txt", "FmeasureResult_ECSSD_1.txt",
                 "val_ECSSD_1.txt"):
        jl = open(os.path.join(jdir, name)).read().splitlines()
        pl = open(os.path.join(pdir, name)).read().splitlines()
        assert len(jl) == len(pl) > 0, name
        if name.startswith("val_"):  # the same pairs, under either method
            assert [[os.path.basename(p) for p in ln.split()] for ln in jl] \
                == [[os.path.basename(p) for p in ln.split()] for ln in pl]
        else:
            assert [_shape(ln) for ln in jl] == [_shape(ln) for ln in pl]

    pairs = ceval._pairs(os.path.join(pdir, "ECSSD_1"),
                         os.path.join(run["root"], "ECSSD", "GT"))
    want = jevaluate(pairs, with_wfmeasure=True, log=_Log())
    got = ceval.evaluate_pairs_device(pairs, with_wfmeasure=True, log=_Log(),
                                      device="cpu")
    assert set(got) == set(want)
    for k, bar in METRIC_BARS.items():
        assert got[k] == pytest.approx(want[k], abs=bar), k
    for k in ("precision", "recall", "fmeasure", "emeasure"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_eval_dirs_and_the_native_backend(run, tmp_path):
    """--dirs scores a folder, --sal-suffix pairs suffixed dumps and counts
    the files without the suffix in one log line; the native backend
    scores the same maps as the device one (the JAX package's 1e-5 bar
    between backends), in --dirs, per epoch and from main(), and refuses
    --wfmeasure outside --suite full."""
    gt_dir = os.path.join(run["root"], "ECSSD", "GT")
    sal = tmp_path / "sal"
    sal.mkdir()
    names = sorted(os.listdir(run["sal_dir"]))
    for n in names:
        shutil.copy(os.path.join(run["sal_dir"], n),
                    sal / n.replace(".png", "_sal_fuse.png"))
    shutil.copy(os.path.join(run["sal_dir"], names[0]), sal / names[0])
    log = _Log()
    pairs = ceval._pairs(str(sal), gt_dir, sal_suffix="_sal_fuse", log=log)
    assert len(pairs) == len(names) + 1
    assert sum("1 PNG(s)" in m and "_sal_fuse" in m for m in log) == 1
    log = _Log()
    assert ceval._pairs(run["sal_dir"], gt_dir, log=log) and not log

    res = ceval.run_eval_dirs(run["sal_dir"], gt_dir, log=log, device="cpu")
    _as_method(run, "port")
    cfg = run["cfg"].clone()
    cfg.DATA.SAVEDIR = str(tmp_path / "r")
    want = ceval.run_eval(run["cfg"], epoch_range=(1, 2), log=_Log(),
                          device="cpu", method="port")
    assert res["max_f"] == pytest.approx(want["ECSSD"]["max_f"], abs=1e-12)
    nat = ceval.run_eval_dirs(run["sal_dir"], gt_dir, backend="native",
                              log=_Log(), device="cpu")
    assert nat["images"] == len(names)
    for k in ("max_f", "mae", "mean_f"):
        assert nat[k] == pytest.approx(res[k], abs=1e-5), k
    best = ceval.run_eval(run["cfg"], epoch_range=(1, 2), log=_Log(),
                          device="cpu", method="port", backend="native")
    assert best["ECSSD"]["max_f"] == pytest.approx(nat["max_f"], abs=1e-12)
    with open(os.path.join(run["cfg"].DATA.SAVEDIR, "port",
                           "FmeasureResult_ECSSD_1.txt")) as f:
        assert len(f.read().splitlines()) == 256 + 7
    assert ceval.run_eval(cfg, backend="native", device="cpu",
                          log=_Log())["ECSSD"]["epoch"] == -1  # no dumps
    ceval.main(["--dirs", run["sal_dir"], gt_dir, "--backend", "native"])
    with pytest.raises(SystemExit, match="--wfmeasure is not computed"):
        ceval.main(["--dirs", run["sal_dir"], gt_dir, "--backend", "native",
                    "--wfmeasure"])


_REPORT = re.compile(r"(MaxF|MAE|MeanF|AdpF|MaxE|MeanE|AdpE|S|wF) "
                     r"(-?\d+\.\d+)")


def _resident_reports(out_dir) -> dict:
    lines = open(os.path.join(out_dir, "FmeasureResults_ECSSD_resident.txt")
                 ).read().splitlines()
    return {int(ln.split()[1]): dict((k, float(v)) for k, v in
                                     _REPORT.findall(ln)) for ln in lines}


def test_testall_resident_matches_the_jax_driver(run, tmp_path):
    """The resident sweep over checkpoint epochs 1 and 2 of both drivers
    (the port's files): the same best epoch, each number of the report
    lines within the sweep bars."""
    from cli.test import run_testall_resident as jrun

    outs = {}
    for name, cfg, fn, kw in (("jax", run["jcfg"], jrun, {}),
                              ("port", run["cfg"], run_testall_resident,
                               {"device": "cpu"})):
        c = cfg.clone()
        c.DATA.SAVEDIR = str(tmp_path / name)
        shutil.copytree(os.path.join(run["cfg"].DATA.SAVEDIR, "t",
                                     "checkpoint"),
                        tmp_path / name / "t" / "checkpoint")
        outs[name] = (fn(c, log=_Log(), **kw), tmp_path / name / "t")
    assert outs["port"][0]["ECSSD"]["epoch"] == \
        outs["jax"][0]["ECSSD"]["epoch"] >= 1
    want, got = (_resident_reports(outs[n][1]) for n in ("jax", "port"))
    assert sorted(got) == sorted(want) == [1, 2]
    for epoch in (1, 2):
        assert got[epoch].keys() == want[epoch].keys()
        for k, v in want[epoch].items():
            assert got[epoch][k] == pytest.approx(
                v, abs=5e-4 if k == "wF" else 1e-4), (epoch, k)
    assert sorted(os.listdir(outs["port"][1])) == sorted(
        os.listdir(outs["jax"][1]))


# --- fetch (offline, file:// archives) -------------------------------------


def _zip_split(tmp_path, name, split_dir):
    """file:// archives shaped like the real distributions: one nested
    folder each, images under .jpg names (PNG bytes)."""
    iz, gz = tmp_path / f"{name}_images.zip", tmp_path / f"{name}_gt.zip"
    with zipfile.ZipFile(iz, "w") as z:
        for e in sorted(os.listdir(split_dir / "images")):
            z.write(split_dir / "images" / e,
                    f"{name}_images/{e[:-4]}.jpg")
    with zipfile.ZipFile(gz, "w") as z:
        for e in sorted(os.listdir(split_dir / "GT")):
            z.write(split_dir / "GT" / e, f"ground_truth_mask/{e}")
    return {"archives": {"images": {"url": f"file://{iz}"},
                         "GT": {"url": f"file://{gz}"}}}


@pytest.fixture()
def tiny_spec(tmp_path, monkeypatch):
    src = tmp_path / "src"
    make_synth_split(str(src), 5, hw=(40, 48), seed=1)
    monkeypatch.setitem(F.DATASETS, "TINY",
                        {**_zip_split(tmp_path, "TINY", src), "count": 5})
    return tmp_path


def test_fetch_extract_validate_and_tofu(tiny_spec, tmp_path):
    root = str(tmp_path / "data")
    logs = []
    got = F.fetch_dataset("TINY", root, log=logs.append)
    assert got == os.path.join(root, "TINY")
    assert len(os.listdir(os.path.join(got, "images"))) == 5
    assert len(os.listdir(os.path.join(got, "GT"))) == 5
    sums = json.load(open(os.path.join(root, "CHECKSUMS.json")))
    assert set(sums) == {"TINY/images", "TINY/GT"}
    # second call: tree complete -> no download, same dir
    assert F.fetch_dataset("TINY", root, log=logs.append) == got


def test_fetch_rejects_checksum_mismatch_and_bad_zips(tiny_spec, tmp_path):
    root = str(tmp_path / "data2")
    assert F.fetch_dataset("TINY", root, expected={"images": "0" * 64},
                           log=lambda *_: None) is None
    assert not os.path.isdir(os.path.join(root, "TINY", "images"))
    arc = tmp_path / "data3" / "TINY" / "TINY_images.zip"  # the URL's name
    arc.parent.mkdir(parents=True)
    arc.write_bytes(b"<html>404</html>")
    logs = []
    assert F.fetch_dataset("TINY", str(tmp_path / "data3"),
                           log=logs.append) is None
    assert not arc.exists() and any("not a zip" in m for m in logs)
    assert F.fetch_dataset("TINY", str(tmp_path / "data3"),
                           log=logs.append) is not None


def test_fetch_offline_unknown_and_unpinned_on_failure(tiny_spec, tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(F.DATASETS, "GONE", {
        "archives": {"images": {"url": f"file://{tmp_path}/absent.zip"},
                     "GT": {"url": f"file://{tmp_path}/absent2.zip"}},
        "count": 1})
    assert F.fetch_dataset("GONE", str(tmp_path / "d"),
                           log=lambda *_: None) is None
    with pytest.raises(ValueError, match="ECSSD"):
        F.fetch_dataset("ecssd", str(tmp_path / "nowhere"))
    monkeypatch.setitem(F.DATASETS["TINY"], "count", 99)
    root = str(tmp_path / "data4")
    assert F.fetch_dataset("TINY", root, log=lambda *_: None) is None
    assert not os.path.isfile(os.path.join(root, "CHECKSUMS.json"))
    assert not os.path.isdir(os.path.join(root, "TINY"))
    monkeypatch.setitem(F.DATASETS["TINY"], "count", 5)
    assert F.fetch_dataset("TINY", root, log=lambda *_: None) is not None
    assert os.path.isfile(os.path.join(root, "CHECKSUMS.json"))


def test_fetch_shared_archive_with_prefixes(tmp_path, monkeypatch):
    """The DUTS-TR layout: one zip carrying both subtrees, selected by
    member prefix."""
    rng = np.random.default_rng(1)
    arc = tmp_path / "DUTS-TINY.zip"
    with zipfile.ZipFile(arc, "w") as z:
        for i in range(3):
            img, msk = tmp_path / f"i{i}.png", tmp_path / f"m{i}.png"
            write_png(str(img), rng.integers(0, 255, (8, 8, 3), np.uint8))
            write_png(str(msk), ((rng.random((8, 8)) > 0.5) * 255
                                 ).astype(np.uint8))
            z.write(img, f"DUTS-TINY/DUTS-TINY-Image/s{i}.jpg")
            z.write(msk, f"DUTS-TINY/DUTS-TINY-Mask/s{i}.png")
    monkeypatch.setitem(F.DATASETS, "DTINY", {
        "archives": {
            "images": {"url": f"file://{arc}", "prefix": "DUTS-TINY-Image"},
            "GT": {"url": f"file://{arc}", "prefix": "DUTS-TINY-Mask"}},
        "count": 3})
    got = F.fetch_dataset("DTINY", str(tmp_path / "root"),
                          log=lambda *_: None)
    assert sorted(os.listdir(os.path.join(got, "images"))) == [
        "s0.jpg", "s1.jpg", "s2.jpg"]
    assert sorted(os.listdir(os.path.join(got, "GT"))) == [
        "s0.png", "s1.png", "s2.png"]


def test_fetch_then_the_smoke_chain(tmp_path, monkeypatch):
    """The real-data day as one chain: --fetch all from a cold root
    (file:// stand-ins), then train -> prune+finetune -> test -> eval ->
    resident sweep on the fetched tree, on the CPU."""
    for name, n, seed in (("DUTS-TR", 8, 3), ("ECSSD", 4, 4)):
        src = tmp_path / f"src_{name}"
        make_synth_split(str(src), n, hw=(96, 128), jitter=10, seed=seed)
        monkeypatch.setitem(F.DATASETS, name,
                            {**_zip_split(tmp_path, name, src), "count": n})
    root = str(tmp_path / "cold")
    got = csmoke._fetch_root(Namespace(fetch="all", data_root=root,
                                       dry_data=False))
    assert got == root
    assert len(os.listdir(os.path.join(root, "DUTS-TR", "images"))) == 8
    save = str(tmp_path / "save")
    out = csmoke.run_smoke(root, save, train_epochs=1, log=_Log(),
                           device="cpu")
    assert out["ok"]
    table = os.path.join(save, "smoke", "FmeasureResults_ECSSD.txt")
    lines = open(table).read().strip().splitlines()
    assert lines and all("MaxF" in ln and "MAE" in ln for ln in lines)
    assert os.path.isfile(os.path.join(
        save, "smoke", "FmeasureResults_ECSSD_resident.txt"))
    with pytest.raises(SystemExit, match="pass --data-root"):
        csmoke.main([])
