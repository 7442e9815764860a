"""The port's CSF+Res2Net driver (``sod100k_tpu_torch.cli.csf``) against the
JAX package's ``cli.csf`` on the same files, on the CPU.

A tree of 6 PNG pairs in two shapes (40x56 and 56x48, three each, so a
``--test_batch 2`` run ends each shape with a padded partial batch) and a
shared checkpoint: the port's seeded Res2Net-50 ``CSFNet`` with the
He-scale backbone of ``test_torch_csf.he_scale_state`` (at the reference
init the map is constant), saved as a .pth that both packages load.

Bars:
- test-mode maps within one level of the JAX driver's (two f32 engines;
  the map is trunc(sigmoid * 255), so an f32 difference at a level's edge
  moves it by one), and ``--test_batch 2`` within one level of B=1 (torch's
  CPU convolutions change their arithmetic with the batch);
- the training feed equals the JAX package's batches: padded batches bit
  for bit, fixed-size ones within 2e-6 (the port's float resize is within
  2 f32 ulp of cv2's, ``tests/test_torch_csf_train.py``);
- ``final.pth`` within 1e-6 of a direct ``CSFTrainStep`` replay over the
  same batches (the same ops in the same order; the step itself is held
  against ``jax.grad`` in ``tests/test_torch_csf_train.py``).

The JAX driver's ``csf_init`` takes ~30 s on the CPU: the test-mode run
patches ``cli.csf.csf_init`` to return zeros of ``jax.eval_shape``'s tree,
after checking that the checkpoint holds every leaf of that tree, so the
merge replaces all of them.
"""

import argparse
import hashlib
import io
import os
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_torch_csf import he_scale_state

from sod100k_tpu.arch.csf_res2net import csf_init
from sod100k_tpu.data import csf_dataset as jds
from sod100k_tpu.interop.torch_ckpt import load_checkpoint as jload_checkpoint
from sod100k_tpu.train.csf_step import csf_partition
from sod100k_tpu_torch.arch import csf_res2net as arch
from sod100k_tpu_torch.arch.csf_res2net import CSFNet
from sod100k_tpu_torch.cli import csf
from sod100k_tpu_torch.data.image_io import read_image, write_png
from sod100k_tpu_torch.interop.torch_ckpt import load_checkpoint
from sod100k_tpu_torch.train.checkpoint import save_checkpoint
from sod100k_tpu_torch.train.csf_step import (CSFTrainStep,
                                              freeze_reference_params,
                                              make_csf_optimizer)

SHAPES = [(40, 56)] * 3 + [(56, 48)] * 3
N = len(SHAPES)


class _Log(list):
    def __call__(self, msg, display=True):
        self.append(str(msg))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tree():
    """``csf_init``'s Res2Net-50 tree as shapes (``jax.eval_shape``)."""
    return jax.eval_shape(lambda: csf_init(jax.random.key(0),
                                           backbone="res2net50"))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """images/*.png + gt/*.png, train.lst ("img gt"), test.lst, and the
    shared He-scale checkpoint."""
    root = tmp_path_factory.mktemp("csfcli")
    (root / "images").mkdir()
    (root / "gt").mkdir()
    rng = np.random.default_rng(70)
    for i, (h, w) in enumerate(SHAPES):
        write_png(str(root / "images" / f"{i}.png"),
                  rng.integers(0, 256, (h, w, 3), np.uint8))
        write_png(str(root / "gt" / f"{i}.png"),
                  ((rng.random((h, w)) > 0.5) * 255).astype(np.uint8))
    (root / "train.lst").write_text("".join(
        f"images/{i}.png gt/{i}.png\n" for i in range(N)))
    (root / "test.lst").write_text("".join(
        f"images/{i}.png\n" for i in range(N)))
    model = CSFNet("res2net50", seed=0, device="cpu")
    model.load_state_dict(he_scale_state(model, 24), strict=True)
    save_checkpoint(str(root / "shared.pth"), model, None, epoch=0,
                    arch="csf_res2net50")
    return root


def _config(tree, tmp_path, *args) -> argparse.Namespace:
    """The port's parser on ``args``, the tree's lists and a save folder
    under ``tmp_path``."""
    cfg = csf.build_parser().parse_args([
        "--train_root", str(tree), "--train_list", str(tree / "train.lst"),
        "--save_folder", str(tmp_path / "results"), *args])
    cfg.test_root, cfg.test_list = str(tree), str(tree / "test.lst")
    return cfg


def _maps(folder) -> dict:
    return {n: read_image(os.path.join(folder, n))
            for n in sorted(os.listdir(folder))}


# ---------------------------------------------------------------------------
# test mode


@pytest.fixture(scope="module")
def test_maps(tree, jax_tree, tmp_path_factory):
    """The JAX driver's and the port's test-mode dumps of the shared
    checkpoint, B=1, and the port's at --test_batch 2."""
    import cli.csf as jcsf

    out = tmp_path_factory.mktemp("csfmaps")
    loaded, _ = jload_checkpoint(str(tree / "shared.pth"))
    assert _leaves(loaded) == _leaves(jax_tree)  # the merge replaces all
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax_tree)
    jcfg = argparse.Namespace(
        arch="res2net50", model=str(tree / "shared.pth"),
        test_root=str(tree), test_list=str(tree / "test.lst"),
        test_fold=str(out / "jax"), dtype="float32", test_batch=1,
        mesh_shape="", mesh_devices=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcsf, "csf_init", lambda key, backbone: zeros)
        jcsf.run_csf_test(jcfg, log=_Log())
    maps = {"jax": _maps(out / "jax")}
    for tb in (1, 2):
        cfg = _config(tree, out, "--mode", "test", "--model",
                      str(tree / "shared.pth"), "--test_fold",
                      str(out / f"port{tb}"), "--test_batch", str(tb))
        log = _Log()
        res = csf.run_csf_test(cfg, log=log, device="cpu")
        assert res["n"] == N and log[-1] == "Test Done!"
        assert log[0].startswith("Speed: ") and log[0].endswith(" FPS")
        maps[f"port{tb}"] = _maps(out / f"port{tb}")
    return maps


def _levels(a: dict, b: dict) -> int:
    assert a.keys() == b.keys()
    assert all(a[n].shape == b[n].shape for n in a)
    return max(int(np.abs(a[n].astype(int) - b[n].astype(int)).max())
               for n in a)


def test_test_mode_matches_the_jax_driver(test_maps):
    got, want = test_maps["port1"], test_maps["jax"]
    assert sorted(got) == [f"{i}_sal_fuse.png" for i in range(N)]
    for i, (h, w) in enumerate(SHAPES):
        m = got[f"{i}_sal_fuse.png"]
        assert m.dtype == np.uint8 and m.shape == (h, w)  # native size
        assert m.std() > 0  # the He-scale backbone gives a real map
    assert _levels(got, want) <= 1


def test_test_batch_matches_batch_one(test_maps):
    """Runs of three same-shape images at --test_batch 2: a full batch and
    a padded partial per shape; the padding writes nothing."""
    assert _levels(test_maps["port2"], test_maps["port1"]) <= 1


def test_test_mode_needs_model_and_fold(tree, tmp_path):
    with pytest.raises(SystemExit, match="--model and --test_fold"):
        csf.run_csf_test(_config(tree, tmp_path, "--mode", "test"),
                         device="cpu")


# ---------------------------------------------------------------------------
# training


class _Recorder(CSFTrainStep):
    """A CSFTrainStep that records what the driver feeds it; ``skip``
    returns a zero loss without running the model."""

    made: list = []
    skip = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batches, self.restarts = [], 0
        _Recorder.made.append(self)

    def __call__(self, batch, lr):
        self.batches.append({k: np.array(v) for k, v in batch.items()})
        if _Recorder.skip:
            return {"loss": torch.zeros(())}
        return super().__call__(batch, lr)

    def restart_optimizer(self):
        super().restart_optimizer()
        self.restarts += 1
        assert not self.optimizer.state and self.micro == 0  # fresh moments


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setattr(csf, "CSFTrainStep", _Recorder)
    monkeypatch.setattr(_Recorder, "made", [])
    monkeypatch.setattr(_Recorder, "skip", False)
    return _Recorder


@pytest.mark.parametrize("image_size", [48, 0])
def test_training_feed_equals_the_jax_batches(tree, tmp_path, recorder,
                                              image_size):
    """Two epochs of the driver's host feed (the step skipped) against
    ``sod100k_tpu.data.csf_dataset`` with ``seed=epoch``; the dataset's
    flip draws run on across the epochs in both."""
    recorder.skip = True
    cfg = _config(tree, tmp_path, "--batch_size", "2", "--epoch", "2",
                  "--epoch_save", "9", "--image_size", str(image_size),
                  "--load", str(tree / "shared.pth"))
    csf.run_csf_train(cfg, log=_Log(), device="cpu")
    got = recorder.made[0].batches
    jdata = jds.CSFTrainData(str(tree), str(tree / "train.lst"))
    want = []
    for epoch in range(2):
        want += list(
            jds.fixed_size_batches(jdata, 2, (image_size, image_size),
                                   seed=epoch) if image_size
            else jds.padded_batches(jdata, 2, seed=epoch))
    assert len(got) == len(want) == 2 * (N // 2)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert ("mask" in a) == (image_size == 0)
        for k in a:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=2e-6 if image_size else 0.0,
                                       err_msg=k)


def test_driver_equals_a_direct_replay(tree, tmp_path, jax_tree):
    """B=2, --iter_size 2, one epoch from --load: epoch_1.pth and final.pth
    in the reference's format, final.pth equal to a hand loop of
    CSFTrainStep over the JAX package's batches, the logged losses equal
    to the loop's, and the file loads in the JAX package with the keys and
    shapes of ``csf_init``'s tree."""
    cfg = _config(tree, tmp_path, "--batch_size", "2", "--iter_size", "2",
                  "--epoch", "1", "--epoch_save", "1", "--show_every", "2",
                  "--load", str(tree / "shared.pth"))
    log = _Log()
    res = csf.run_csf_train(cfg, log=log, device="cpu")
    models = os.path.join(res["save_folder"], "models")
    assert res["save_folder"] == str(tmp_path / "results" / "run-0")
    assert sorted(os.listdir(models)) == ["epoch_1.pth", "final.pth"]
    trainable, _ = csf_partition(jax_tree)
    n_params = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(trainable))
    assert f"The number of trainable parameters: {n_params}" in log
    assert not any("WARNING" in m for m in log)

    model = CSFNet("res2net50", device="cpu")
    model.load_state_dict(load_checkpoint(str(tree / "shared.pth"),
                                          map_location="cpu")[0])
    freeze_reference_params(model)
    step = CSFTrainStep(model, make_csf_optimizer(model, 5e-4), iter_size=2,
                        batch_size=2)
    losses = [float(step(b, 5e-5)["loss"]) for b in jds.padded_batches(
        jds.CSFTrainData(str(tree), str(tree / "train.lst")), 2, seed=0)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
    assert [m.split("||")[1] for m in log if "|| Sal" in m] == [
        f" Sal : {v:.4f}  lr 5e-05" for v in losses]

    ck = torch.load(os.path.join(models, "final.pth"), weights_only=False)
    assert set(ck) == {"epoch", "arch", "state_dict"}
    assert ck["epoch"] == 1 and ck["arch"] == "csf_res2net50"
    want = model.state_dict()
    assert ck["state_dict"].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(ck["state_dict"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    moved = ck["state_dict"]["fuse1x1.conv.weights"]
    shared = load_checkpoint(str(tree / "shared.pth"), map_location="cpu")[0]
    assert not torch.equal(moved, shared["fuse1x1.conv.weights"])
    loaded, meta = jload_checkpoint(os.path.join(models, "final.pth"))
    assert _leaves(loaded) == _leaves(jax_tree) and meta["epoch"] == 1


def test_lr_decay_restarts_the_optimizer(tree, tmp_path, recorder,
                                         monkeypatch):
    """LR_DECAY_EPOCH at (0,), two epochs, no --load and no network: the
    WARNING of an unreachable download, then epoch 1 at lr / 10 on an
    optimizer re-created once (fresh moments: its steps are epoch 1's)."""
    monkeypatch.setattr(csf, "LR_DECAY_EPOCH", (0,))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))

    def offline(*args, **kwargs):
        raise urllib.error.URLError("offline")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    cfg = _config(tree, tmp_path, "--batch_size", "2", "--iter_size", "1",
                  "--epoch", "2", "--epoch_save", "9", "--show_every", "2",
                  "--image_size", "32", "--lr", "1e-4")
    log = _Log()
    csf.run_csf_train(cfg, log=log, device="cpu")
    assert sum(m.startswith("WARNING: no --pretrained_model and the "
                            "published res2net50 weights are unreachable")
               for m in log) == 1
    lrs = {m.split("]")[0]: m.rsplit("lr ", 1)[1] for m in log
           if "|| Sal" in m}
    assert lrs == {"epoch: [0/2": "0.0001", "epoch: [1/2": str(1e-4 * 0.1)}
    (step,) = recorder.made
    assert step.restarts == 1
    states = step.optimizer.state.values()
    assert states and all(int(s["step"]) == N // 2 for s in states)
    assert not os.path.exists(tmp_path / "home" / ".cache" /
                              "sod100k_tpu_torch" /
                              "res2net50_v1b_26w_4s-3cf99910.pth.part")


def test_resident_mode(tree, tmp_path):
    """The JAX driver's two refusals, in its words, then one epoch."""
    load = ("--load", str(tree / "shared.pth"))
    with pytest.raises(SystemExit, match=r"^--preprocess resident needs a "
                       r"fixed --image_size \(e\.g\. 336\)$"):
        csf.run_csf_train(_config(tree, tmp_path, "--preprocess", "resident",
                                  *load), device="cpu")
    with pytest.raises(SystemExit, match=(
            r"^--preprocess resident needs at least one full batch: dataset "
            rf"has {N} images < --batch_size 8$")):
        csf.run_csf_train(_config(tree, tmp_path, "--preprocess", "resident",
                                  "--image_size", "32", "--batch_size", "8",
                                  *load), device="cpu")
    cfg = _config(tree, tmp_path, "--preprocess", "resident", "--image_size",
                  "32", "--batch_size", "2", "--iter_size", "2", "--epoch",
                  "1", "--show_every", "2", *load)
    log = _Log()
    res = csf.run_csf_train(cfg, log=log, device="cpu")
    assert len(res["losses"]) == N // 2 and np.isfinite(res["losses"]).all()
    assert any(m.startswith(f"resident CSF dataset: {N} images at 32^2")
               for m in log)
    assert os.path.isfile(os.path.join(res["save_folder"], "models",
                                       "final.pth"))


def test_missing_pretrained_model_is_refused(tree, tmp_path):
    cfg = _config(tree, tmp_path, "--pretrained_model",
                  str(tmp_path / "nope.pth"))
    with pytest.raises(SystemExit, match="--pretrained_model not found"):
        csf.run_csf_train(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the Res2Net fetcher, offline


class _Served(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def test_fetcher_checks_the_sha256_prefix(tmp_path, monkeypatch):
    """A local file served through a patched urlopen: the right prefix
    caches it (a second call needs no network), a wrong one raises
    ValueError and leaves no .part file, an unreachable host gives None."""
    body = b"res2net weights" * 1000
    prefix = hashlib.sha256(body).hexdigest()[:8]
    calls = []

    def serve(url, timeout):
        calls.append(url)
        return _Served(body)

    monkeypatch.setattr(urllib.request, "urlopen", serve)
    monkeypatch.setitem(arch.RES2NET_URLS, "res2net50",
                        f"https://example.invalid/r50_v1b-{prefix}.pth")
    cache = tmp_path / "cache"
    path = arch.fetch_res2net_weights("res2net50", cache_dir=str(cache))
    assert path == str(cache / f"r50_v1b-{prefix}.pth")
    assert open(path, "rb").read() == body and len(calls) == 1
    assert arch.fetch_res2net_weights("res2net50", cache_dir=str(cache)) \
        == path and len(calls) == 1
    monkeypatch.setitem(arch.RES2NET_URLS, "res2net101",
                        "https://example.invalid/r101_v1b-deadbeef.pth")
    with pytest.raises(ValueError, match="checksum mismatch"):
        arch.fetch_res2net_weights("res2net101", cache_dir=str(cache))
    assert sorted(os.listdir(cache)) == [f"r50_v1b-{prefix}.pth"]

    def offline(url, timeout):
        raise urllib.error.URLError("offline")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    assert arch.fetch_res2net_weights("res2net101",
                                      cache_dir=str(cache)) is None
    assert sorted(os.listdir(cache)) == [f"r50_v1b-{prefix}.pth"]


# ---------------------------------------------------------------------------
# the command line


def test_test_info_and_argparse_defaults_match_the_jax_driver(tmp_path,
                                                              monkeypatch):
    """``main()`` of both drivers with no arguments and with --mode test:
    the same config, --mesh_shape included (a malformed shape is refused
    when the run starts, as the JAX driver's)."""
    import cli.csf as jcsf

    for mode in "e", "p", "d", "h", "s", "t", "m_r":
        assert csf.get_test_info(mode) == jcsf.get_test_info(mode)
    monkeypatch.chdir(tmp_path)
    seen = {}
    for name, mod in (("jax", jcsf), ("port", csf)):
        for fn in ("run_csf_train", "run_csf_test"):
            monkeypatch.setattr(mod, fn, lambda c, n=name, f=fn:
                                seen.setdefault((n, f), vars(c)))
    for argv in ([], ["--mode", "test", "--sal_mode", "t"]):
        monkeypatch.setattr(sys, "argv", ["csf", *argv])
        jcsf.main()
        csf.main(argv)
    for fn in ("run_csf_train", "run_csf_test"):
        want = dict(seen[("jax", fn)])
        assert want["mesh_shape"] == "" and want["mesh_devices"] == 0
        assert seen[("port", fn)] == want
    monkeypatch.undo()
    cfg = csf.build_parser().parse_args(["--mesh_shape", "2"])
    with pytest.raises(SystemExit, match="mesh shape must look like"):
        csf.run_csf_train(cfg, log=lambda *a: None, device="cpu")
