"""The port's drivers on the 2-D data x spatial mesh (gloo over 127.0.0.1,
on the CPU), against the same driver in one process, and the mesh's
refusals against the JAX package's conditions.

Two real processes run this file as a script with the SOD100K_* variables
(``test_torch_parallel.py``'s ``run_ranks``); the drivers join the world
and build the mesh themselves (``cli.common.init_parallel``,
``cli.csf``'s --mesh_shape):

1. ``cli.train`` with CUDA.MESH_SHAPE "1x2" (64 px, B=4, one epoch of 6
   pairs, the penalty on), hybrid and device front-ends: every rank prints
   the same loss and val MAE; against one process the first loss within
   rel 1e-5 (the JAX 2-D oracle's bar), the val MAE within 1e-3 (a quarter
   level), the checkpoint by its parameter checksum within rel 1e-4 (f32
   CSNet is chaotic at this size, ``test_torch_spatial_train.py``); then
   ``cli.test`` on the mesh from the one-process checkpoint: the PNG maps
   within one level of one process's, which the primary alone writes; then
   ``cli.finetune`` (one SGD epoch with its periodic test) from a copy of
   the one-process run: the val MAE within 1e-3 and the checkpoint's
   checksum within rel 1e-4 of one process's, the periodic test's maps
   within one level of the same weights' maps in one process.
2. ``cli.csf --mode test`` over ``--mesh_devices 2`` (batch rows split)
   and ``--mesh_shape 1x2`` (image rows split; one image height that the
   extent check refuses runs whole on each rank), ``--test_batch 2``: the
   maps within one level of one process's. ``cli.csf --mode train
   --mesh_shape 1x2`` (96^2, one Adam apply): the losses within rel 1e-5
   and the final checkpoint's parameter checksum within rel 1e-4 (the JAX
   oracle's bar). Not per tensor: Adam's first update, lr * g / (|g| +
   eps), takes the sign of gradients whose BCE part nearly cancels the L2
   term from f32 noise (measured up to 1.1e-3 L2-rel on one tensor); the
   micro-step's gradients themselves are held at 1e-5 in
   ``test_torch_spatial_train.py``.
3. The refusals, in one process: a malformed shape, a data axis that does
   not divide the batch, a world that is not D*S, the extent check (the
   same conditions as the JAX package's ``check_spatial_extent``, held on a
   grid). The resident programs and ``cli.smoke`` run on the mesh
   (``test_torch_resident_mesh.py``, ``test_torch_smoke_mesh.py``): in one
   process they reach the mesh's build and its world refusal.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_csf import he_scale_state  # noqa: E402
from test_torch_parallel import json_lines, run_ranks  # noqa: E402

from sod100k_tpu_torch.arch.csf_res2net import CSFNet  # noqa: E402
from sod100k_tpu_torch.arch.layer_config import init_layers  # noqa: E402
from sod100k_tpu_torch.cli import csf  # noqa: E402
from sod100k_tpu_torch.config import get_cfg  # noqa: E402
from sod100k_tpu_torch.data.image_io import read_image, write_png  # noqa: E402
from sod100k_tpu_torch.data.synth import make_synth_split  # noqa: E402
from sod100k_tpu_torch.parallel import mesh  # noqa: E402
from sod100k_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

HERE = os.path.abspath(__file__)
TASK = "mesh_e2e"
# CSF test images: three heights the 1 x 2 mesh splits and one (80: its
# deepest stride-2 input has 5 rows) that runs whole on each rank
CSF_SHAPES = ((100, 72), (100, 72), (96, 64), (80, 64))


def make_cfg(root: str, save: str, preprocess: str = "hybrid",
             mesh_shape: str = ""):
    cfg = get_cfg()
    cfg.TASK = TASK
    cfg.PRINT_FREQ = 1
    cfg.MODEL.BASIC_SPLIT = [0.5, 0.5]
    cfg.DATA.DIR = os.path.join(root, "DUTS-TR")
    cfg.DATA.BATCH_SIZE = 4
    cfg.DATA.WORKERS = 2
    cfg.DATA.SAVEDIR = save
    cfg.DATA.IMAGE_H = cfg.DATA.IMAGE_W = 64
    cfg.VAL.DIR = os.path.join(root, "ECSSD")
    cfg.TEST.DATASET_PATH = root
    cfg.TEST.DATASETS = ["ECSSD"]
    cfg.TEST.IMAGE_H = cfg.TEST.IMAGE_W = 64
    cfg.TEST.MODEL_CONFIG = os.path.join(root, "predefine.bin")
    cfg.TEST.CHECKPOINT = os.path.join(save, TASK, "checkpoint",
                                       "checkpoint_epoch1.pth.tar")
    cfg.AUTO.ENABLE = True
    cfg.AUTO.PREDEFINE = os.path.join(root, "predefine.bin")
    cfg.AUTO.FLOPS.ENABLE = True
    cfg.AUTO.FLOPS.WEIGHT = 3.0
    cfg.SOLVER.METHOD = "Adam_dynamic_weight_decay"
    cfg.SOLVER.LR = 1e-4
    cfg.CUDA.PREPROCESS = preprocess
    cfg.CUDA.MESH_SHAPE = mesh_shape
    return cfg


def train(root, save, preprocess, mesh_shape="") -> dict:
    from sod100k_tpu_torch.cli.train import run_training

    losses = []

    def log(msg, display=True):
        if "Loss" in str(msg):
            losses.append(float(str(msg).split("Loss ")[1].split()[0]))

    cfg = make_cfg(root, save, preprocess, mesh_shape)
    res = run_training(cfg, max_epochs=1, log=log, device="cpu")
    return {"first_loss": losses[0], "mae": res["history"][0]["mae"]}


def csf_config(tree, fold, *args) -> argparse.Namespace:
    cfg = csf.build_parser().parse_args([
        "--model", str(tree / "shared.pth"), "--test_fold", str(fold),
        "--train_root", str(tree), "--train_list", str(tree / "train.lst"),
        "--save_folder", str(fold), *args])
    cfg.test_root, cfg.test_list = str(tree), str(tree / "test.lst")
    return cfg


def csf_train_args(tree):
    return ["--mode", "train", "--image_size", "96", "--batch_size", "1",
            "--iter_size", "2", "--epoch", "1", "--epoch_save", "1",
            "--show_every", "1", "--load", str(tree / "shared.pth")]


def finetune(root, save, mesh_shape="") -> dict:
    """cli.finetune for one SGD epoch from the epoch-1 checkpoint under
    ``save``, with its periodic test (the maps under finetune_ECSSD_1)."""
    from sod100k_tpu_torch.cli.finetune import run_finetune

    cfg = make_cfg(root, save, mesh_shape=mesh_shape)
    cfg.FINETUNE.SOLVER.METHOD = "SGD"
    cfg.FINETUNE.SOLVER.LR = 1e-3
    cfg.TEST.ENABLE = True
    cfg.TEST.BEGIN = cfg.TEST.INTERVAL = 1
    res = run_finetune(cfg, from_epoch=1, max_epochs=1,
                       log=lambda *a, **k: None, device="cpu")
    return {"best_mae": res["best_mae"],
            "ckpt": os.path.join(res["ft_dir"], "checkpoint_epoch1.pth.tar")}


def worker(role: str, args: list) -> None:
    torch.set_num_threads(1)
    out = {}
    if role == "csnet":
        root, save = args
        for pre in ("hybrid", "device"):
            out[pre] = train(root, os.path.join(save, pre), pre, "1x2")
        from sod100k_tpu_torch.cli.test import run_test

        cfg = make_cfg(root, os.path.join(save, "test"), mesh_shape="1x2")
        cfg.TEST.CHECKPOINT = args[1] + ".ckpt"
        run_test(cfg, log=lambda *a: None, device="cpu")
        out["ft"] = finetune(root, os.path.join(save, "ft"), "1x2")
    elif role == "csftest":
        tree, fold, *flags = args
        lines = []
        csf.run_csf_test(csf_config(
            _path(tree), fold, "--mode", "test", *flags),
            log=lambda *a: lines.append(" ".join(map(str, a))),
            device="cpu")
        out["whole"] = [line for line in lines if "run whole" in line]
    elif role == "csftrain":
        tree, fold = args
        res = csf.run_csf_train(csf_config(
            _path(tree), fold, *csf_train_args(_path(tree)),
            "--mesh_shape", "1x2"), log=lambda *a: None, device="cpu")
        out["losses"] = res["losses"]
        out["final"] = os.path.join(res["save_folder"], "models",
                                    "final.pth")
    print(json.dumps(out), flush=True)


def _path(p):
    import pathlib
    return pathlib.Path(p)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_tree")
    make_synth_split(str(root / "DUTS-TR"), 6, hw=(60, 80), jitter=6,
                     seed=3)
    make_synth_split(str(root / "ECSSD"), 4, hw=(60, 80), jitter=6, seed=4)
    init_layers(8, [0.5, 0.5]).save(str(root / "predefine.bin"))
    return root


def _maps(folder) -> dict:
    return {n: read_image(os.path.join(folder, n))
            for n in sorted(os.listdir(folder))}


def _levels(a: dict, b: dict) -> int:
    assert list(a) == list(b) and a
    return max(int(np.abs(a[n].astype(np.int16) - b[n].astype(np.int16)
                          ).max()) for n in a)


def _checksum(path) -> float:
    sd = torch.load(path, weights_only=False)["state_dict"]
    return float(sum(v.double().abs().sum() for k, v in sd.items()
                     if v.is_floating_point() and "running" not in k))


def test_cli_train_test_and_finetune_on_a_1x2_mesh(tree, tmp_path):
    one = tmp_path / "one"
    want = {pre: train(str(tree), str(one / pre), pre)
            for pre in ("hybrid", "device")}
    ckpt = os.path.join(one, "hybrid", TASK, "checkpoint",
                        "checkpoint_epoch1.pth.tar")
    save = tmp_path / "mesh"
    os.makedirs(save)
    # the test run reads the one-process checkpoint, copied beside it, and
    # both finetunes start from a copy of the one-process training run
    import shutil
    shutil.copy(ckpt, str(save) + ".ckpt")
    for d in (save / "ft", tmp_path / "one_ft"):
        shutil.copytree(one / "hybrid", d)
    res = json_lines(run_ranks([HERE, "csnet", str(tree), str(save)],
                               tmp_path, timeout=240))
    assert res[0] == res[1]  # all-reduced: every rank prints the same
    for pre, w in want.items():
        got = res[0][pre]
        assert got["first_loss"] == pytest.approx(w["first_loss"], rel=1e-5)
        assert got["mae"] == pytest.approx(w["mae"], abs=1e-3)
        mine = os.path.join(save, pre, TASK, "checkpoint",
                            "checkpoint_epoch1.pth.tar")
        ref = os.path.join(one, pre, TASK, "checkpoint",
                           "checkpoint_epoch1.pth.tar")
        assert _checksum(mine) == pytest.approx(_checksum(ref), rel=1e-4)

    from sod100k_tpu_torch.cli.test import run_test

    cfg = make_cfg(str(tree), str(tmp_path / "one_test"))
    cfg.TEST.CHECKPOINT = ckpt
    run_test(cfg, log=lambda *a: None, device="cpu")
    got = _maps(os.path.join(save, "test", TASK, "ECSSD_1"))
    assert len(got) == 4
    assert _levels(got, _maps(os.path.join(tmp_path / "one_test", TASK,
                                           "ECSSD_1"))) <= 1

    ft = finetune(str(tree), str(tmp_path / "one_ft"))
    got = res[0]["ft"]
    assert got["best_mae"] == pytest.approx(ft["best_mae"], abs=1e-3)
    assert _checksum(got["ckpt"]) == pytest.approx(_checksum(ft["ckpt"]),
                                                   rel=1e-4)
    # the periodic test's maps against the same weights' maps in one
    # process: the two finetunes' weights differ by f32 noise that one
    # SGD epoch of the x100 net amplifies (BN biases up to 1.7% apart,
    # maps up to 138 levels, where one process at 1 and 4 threads agrees)
    cfg = make_cfg(str(tree), str(tmp_path / "ft_test"))
    cfg.TEST.MODEL_CONFIG = os.path.join(save, "ft", TASK, "layer_configs",
                                         "layer_config_finetune_1.bin")
    cfg.TEST.CHECKPOINT = got["ckpt"]
    run_test(cfg, log=lambda *a: None, device="cpu")
    maps = _maps(os.path.join(save, "ft", TASK, "finetune_ECSSD_1"))
    assert len(maps) == 4
    assert _levels(maps, _maps(os.path.join(tmp_path / "ft_test", TASK,
                                            "ECSSD_1"))) <= 1


@pytest.fixture(scope="module")
def csf_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_csf")
    (root / "images").mkdir()
    (root / "gt").mkdir()
    rng = np.random.default_rng(71)
    for i, (h, w) in enumerate(CSF_SHAPES):
        write_png(str(root / "images" / f"{i}.png"),
                  rng.integers(0, 256, (h, w, 3), np.uint8))
        write_png(str(root / "gt" / f"{i}.png"),
                  ((rng.random((h, w)) > 0.5) * 255).astype(np.uint8))
    (root / "train.lst").write_text("".join(
        f"images/{i}.png gt/{i}.png\n" for i in range(2)))
    (root / "test.lst").write_text("".join(
        f"images/{i}.png\n" for i in range(len(CSF_SHAPES))))
    model = CSFNet("res2net50", seed=0, device="cpu")
    model.load_state_dict(he_scale_state(model, 24), strict=True)
    save_checkpoint(str(root / "shared.pth"), model, None, epoch=0,
                    arch="csf_res2net50")
    return root


@pytest.mark.parametrize("flags", [["--mesh_devices", "2"],
                                   ["--mesh_shape", "1x2"]],
                         ids=["mesh_devices_2", "mesh_shape_1x2"])
def test_csf_test_mode_across_processes(csf_tree, tmp_path, flags):
    fold = tmp_path / "maps"
    res = json_lines(run_ranks([HERE, "csftest", str(csf_tree), str(fold),
                                "--test_batch", "2", *flags], tmp_path,
                               timeout=240))
    # the height the extent check keeps whole is said once, on a mesh
    # with a spatial axis only
    for r in res:
        if "--mesh_shape" in flags:
            assert len(r["whole"]) == 1 and "height 80 " in r["whole"][0]
        else:
            assert r["whole"] == []
    one = tmp_path / "one"
    csf.run_csf_test(csf_config(csf_tree, one, "--mode", "test",
                                "--test_batch", "2"),
                     log=lambda *a: None, device="cpu")
    got = _maps(fold)
    assert len(got) == len(CSF_SHAPES)
    assert all(n.endswith("_sal_fuse.png") for n in got)
    assert _levels(got, _maps(one)) <= 1


def test_csf_train_on_a_1x2_mesh(csf_tree, tmp_path):
    res = json_lines(run_ranks([HERE, "csftrain", str(csf_tree),
                                str(tmp_path / "mesh")], tmp_path,
                               timeout=240))
    assert res[0]["losses"] == res[1]["losses"]
    one = csf.run_csf_train(csf_config(csf_tree, tmp_path / "one",
                                       *csf_train_args(csf_tree)),
                            log=lambda *a: None, device="cpu")
    assert res[0]["losses"] == pytest.approx(one["losses"], rel=1e-5)
    init = torch.load(csf_tree / "shared.pth", weights_only=False)
    final = os.path.join(one["save_folder"], "models", "final.pth")
    assert _checksum(final) != _checksum(csf_tree / "shared.pth")
    assert _checksum(res[0]["final"]) == pytest.approx(_checksum(final),
                                                       rel=1e-4)
    assert init["state_dict"].keys() == torch.load(
        res[0]["final"], weights_only=False)["state_dict"].keys()


# ---- the refusals (one process) -------------------------------------------

def _exit(fn, *args, **kwargs) -> str:
    with pytest.raises(SystemExit) as e:
        fn(*args, **kwargs)
    return str(e.value)


@pytest.mark.parametrize("shape,preprocess,image,match", [
    ("2y2", "hybrid", 64, "mesh shape must look like '4x2'"),
    ("0x2", "hybrid", 64, "mesh shape must look like '4x2'"),
    ("3x1", "hybrid", 64, "data axis 3 must divide DATA.BATCH_SIZE=4"),
    ("1x2", "hybrid", 16, "deepest stride-2 conv input would be 4 rows"),
    ("1x8", "hybrid", 48, "fewer rows than shards"),
    ("1x2", "hybrid", 64, "needs 2 processes, the world has 1"),
    ("1x2", "resident", 64, "needs 2 processes, the world has 1"),
], ids=["malformed", "zero_axis", "data_axis", "extent", "deepest_rows",
        "world", "resident"])
def test_cli_train_refusals(tree, tmp_path, shape, preprocess, image, match):
    from sod100k_tpu_torch.cli.train import run_training

    cfg = make_cfg(str(tree), str(tmp_path), preprocess, shape)
    cfg.DATA.IMAGE_H = cfg.DATA.IMAGE_W = image
    assert match in _exit(run_training, cfg, max_epochs=1,
                          log=lambda *a, **k: None, device="cpu")


def test_resident_sweep_and_csf_refusals(tree, csf_tree, tmp_path):
    from sod100k_tpu_torch.cli.test import run_testall_resident

    world = "needs 2 processes, the world has 1"
    cfg = make_cfg(str(tree), str(tmp_path), mesh_shape="1x2")
    cfg.CUDA.TEST_RESIDENT = True
    msg = _exit(run_testall_resident, cfg, log=lambda *a: None,
                device="cpu")
    assert "CUDA.MESH_SHAPE=1x2" in msg and world in msg
    args = csf_train_args(csf_tree)
    msg = _exit(csf.run_csf_train, csf_config(
        csf_tree, tmp_path, *args, "--mesh_shape", "1x2", "--preprocess",
        "resident"), log=lambda *a: None, device="cpu")
    assert "--mesh_shape 1x2" in msg and world in msg
    args[args.index("--image_size") + 1] = "0"
    assert "needs a fixed --image_size" in _exit(
        csf.run_csf_train, csf_config(csf_tree, tmp_path, *args,
                                      "--mesh_shape", "1x1"),
        log=lambda *a: None, device="cpu")
    from sod100k_tpu_torch.cli import smoke

    msg = _exit(smoke.main, ["--mesh_shape", "1x2", "--dry-data"])
    assert "--mesh_shape 1x2" in msg and world in msg
    assert "data axis 2 must divide --test_batch=3" in _exit(
        csf.run_csf_test, csf_config(csf_tree, tmp_path, "--mode", "test",
                                     "--mesh_shape", "2x1",
                                     "--test_batch", "3"),
        log=lambda *a: None, device="cpu")


def test_mesh_checks_match_the_jax_package():
    """``parse_mesh_shape`` and ``check_spatial_extent`` accept and refuse
    what the JAX package's do."""
    from sod100k_tpu.parallel import mesh as jmesh

    for spec in ("4x2", "1x1", "2X3", "x2", "2x", "0x1", "2x2x2", "a", ""):
        try:
            want = jmesh.parse_mesh_shape(spec)
        except ValueError:
            with pytest.raises(ValueError):
                mesh.parse_mesh_shape(spec)
        else:
            assert mesh.parse_mesh_shape(spec) == want
    for h in range(0, 400, 7):
        for factor in (4, 16):
            for s in (1, 2, 3, 4, 8):
                try:
                    jmesh.check_spatial_extent(h, factor, s)
                    refused = False
                except ValueError:
                    refused = True
                if refused:
                    with pytest.raises(ValueError):
                        mesh.check_spatial_extent(h, factor, s)
                else:
                    mesh.check_spatial_extent(h, factor, s)
    assert mesh.MIN_STRIDE2_INPUT == jmesh.MIN_STRIDE2_INPUT
    from sod100k_tpu.arch import csf_res2net as jcsf
    from sod100k_tpu.arch import csnet as jcsnet
    from sod100k_tpu_torch.arch import csf_res2net, csnet

    assert csnet.DEEPEST_STRIDE2_FACTOR == jcsnet.DEEPEST_STRIDE2_FACTOR
    assert csf_res2net.DEEPEST_STRIDE2_FACTOR == \
        jcsf.DEEPEST_STRIDE2_FACTOR


def test_feeds_cut_rows_then_bands(monkeypatch):
    """``local_slice_feed`` under a mesh: the data index's rows, then the
    spatial index's band of every image-like array; side arrays keep
    their rows whole; ``bands=False`` keeps whole images."""
    from sod100k_tpu_torch.parallel import multihost

    batch = {"image": np.arange(4 * 7 * 2 * 3).reshape(4, 7, 2, 3),
             "hw": np.arange(8).reshape(4, 2), "name": "x"}
    m = mesh.Mesh2D(2, 2, 1, 1, None, None, None)
    monkeypatch.setattr(multihost, "is_multihost", lambda: True)
    got = multihost.local_slice_feed(batch, mesh=m)
    whole = multihost.local_slice_feed(batch, mesh=m, bands=False)
    np.testing.assert_array_equal(got["image"], batch["image"][2:, 4:])
    np.testing.assert_array_equal(got["hw"], batch["hw"][2:])
    np.testing.assert_array_equal(whole["image"], batch["image"][2:])
    assert got["name"] == "x"
    assert multihost.process_slice(4, m) == slice(2, 4)



def test_spatial_groups_stay_on_one_host(monkeypatch):
    """The JAX package's ``check_mesh_process_layout``: a spatial group
    may not cross hosts, so the processes per host (torchrun's
    LOCAL_WORLD_SIZE) must be a whole number of spatial groups."""
    from sod100k_tpu_torch.parallel import multihost

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="across hosts"):
        multihost.check_mesh_process_layout(
            mesh.Mesh2D(3, 2, 0, 0, None, None, None))
    multihost.check_mesh_process_layout(
        mesh.Mesh2D(2, 3, 0, 0, None, None, None))
    multihost.check_mesh_process_layout(
        mesh.Mesh2D(6, 1, 0, 0, None, None, None))


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2:])
