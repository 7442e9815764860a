"""The port's drivers under two processes (gloo over 127.0.0.1, on the
CPU), against the same driver in one process.

As ``tests/test_multihost.py:108-178`` does for the JAX package, two real
processes run this file as a script with the SOD100K_* variables, and the
driver itself joins the world (``cli.common.init_data_parallel``):

1. ``cli.train`` (hybrid and resident front-ends, Adam with dynamic weight
   decay, the penalty on, global B=8 as 4 + 4, two steps): exit 0, the same
   losses and val MAE on both ranks (all-reduced: exactly), one log file
   (the primary's), and the epoch's checkpoint within rel 1e-4 of the
   single-process run's by its parameter checksum (the JAX oracle's bar,
   ``tests/test_multihost.py:104``). Not per tensor: the f32 gradients of
   this x100 net differ by ~1e-2 (L2, per tensor) between any two engines
   at 32^2, and two Adam steps turn that into lr-sized moves of BN biases
   that sit near 0 (measured at lr 1e-3: up to 1.7e-3 on the resident run, 2%
   (hybrid) and 10% (resident) of the two steps' L2 update, where the
   checksums agree within 1.1e-6 and 9.1e-6). The second step's loss is
   held at the oracle's later-loss bar, rel 1e-4, at the recipe's lr 1e-4
   (at lr 1e-3 Adam's flips of lr-sized updates moved it by 2.8e-4 on the
   resident run). The exact row and
   augmentation split of both front-ends is held in
   ``test_torch_parallel.py``;
2. ``cli.test`` from that checkpoint: fixed-size batches split over the
   ranks and the primary writes every map (within one level of one
   process's maps: B=4 against B=8 on the CPU), the ceil-to-16 mode on the
   primary alone (the same maps); the resident TESTALL sweep's table
   equal on both ranks and to the single process's (to the report's six
   decimals);
3. ``cli.csf --mode test`` refuses two processes at --test_batch 1 (one
   image cannot split its batch rows over two data ranks), exit non-zero.
   Test mode across processes is ``test_torch_spatial_cli.py``'s.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_parallel import json_lines, run_ranks

from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.config import get_cfg
from sod100k_tpu_torch.data.image_io import read_image
from sod100k_tpu_torch.data.synth import make_synth_split

HERE = os.path.abspath(__file__)
TASK = "mh_e2e"


def make_cfg(root: str, save: str, preprocess: str):
    cfg = get_cfg()
    cfg.TASK = TASK
    cfg.PRINT_FREQ = 1
    cfg.MODEL.BASIC_SPLIT = [0.5, 0.5]
    cfg.DATA.DIR = os.path.join(root, "DUTS-TR")
    cfg.DATA.BATCH_SIZE = 8
    cfg.DATA.WORKERS = 2
    cfg.DATA.SAVEDIR = save
    cfg.DATA.IMAGE_H = cfg.DATA.IMAGE_W = 32
    cfg.VAL.DIR = os.path.join(root, "ECSSD")
    cfg.TEST.DATASET_PATH = root
    cfg.TEST.DATASETS = ["ECSSD"]
    cfg.TEST.IMAGE_H = cfg.TEST.IMAGE_W = 32
    cfg.TEST.MODEL_CONFIG = os.path.join(root, "predefine.bin")
    cfg.TEST.CHECKPOINT = os.path.join(save, TASK, "checkpoint",
                                       "checkpoint_epoch1.pth.tar")
    cfg.TEST.BEGIN = cfg.TEST.INTERVAL = 1
    cfg.AUTO.ENABLE = True
    cfg.AUTO.PREDEFINE = os.path.join(root, "predefine.bin")
    cfg.AUTO.FLOPS.ENABLE = True
    cfg.AUTO.FLOPS.WEIGHT = 3.0
    cfg.AUTO.FLOPS.EXPAND = 1.0
    cfg.SOLVER.METHOD = "Adam_dynamic_weight_decay"
    cfg.SOLVER.LR = 1e-4  # the reference recipe's (csnet-L-x2_train.yml)
    cfg.CUDA.PREPROCESS = preprocess
    cfg.CUDA.RESIDENT_STORE_HW = 40
    return cfg


def native_cfg(cfg):
    """``cfg`` for the ceil-to-16 native-size test mode, its maps under
    the task ``native``."""
    c = cfg.clone()
    c.TASK = "native"
    c.TEST.IMAGE_H = c.TEST.IMAGE_W = 0
    return c


def train_and_test(root: str, save: str, preprocess: str) -> dict:
    """cli.train for one epoch, then cli.test and the resident sweep from
    its checkpoint; the numbers every rank prints."""
    from sod100k_tpu_torch.cli.test import run_test, run_testall_resident
    from sod100k_tpu_torch.cli.train import run_training

    cfg = make_cfg(root, save, preprocess)
    res = run_training(cfg, max_epochs=1, device="cpu")
    run_test(cfg, log=lambda *a: None, device="cpu")
    run_test(native_cfg(cfg), log=lambda *a: None, device="cpu")
    reports = []
    cfg.CUDA.TEST_RESIDENT = True
    run_testall_resident(cfg, log=reports.append, device="cpu")
    return {"loss": res["history"][0]["loss"],
            "mae": res["history"][0]["mae"], "best_mae": res["best_mae"],
            "sweep": [r for r in reports if "[resident]" in r]}


def worker(role: str, args: list) -> None:
    torch.set_num_threads(1)
    if role == "train":
        out = train_and_test(*args)
    else:
        raise SystemExit(f"unknown role {role}")
    from sod100k_tpu_torch.parallel import multihost

    out["primary"] = multihost.is_primary()
    out["world"] = multihost.world_size()
    print(json.dumps(out), flush=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh_tree")
    make_synth_split(str(root / "DUTS-TR"), 16, hw=(60, 80), jitter=6,
                     seed=3)
    make_synth_split(str(root / "ECSSD"), 12, hw=(60, 80), jitter=6,
                     seed=4)
    init_layers(8, [0.5, 0.5]).save(str(root / "predefine.bin"))
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(save) -> dict:
    ck = torch.load(os.path.join(save, TASK, "checkpoint",
                                 "checkpoint_epoch1.pth.tar"),
                    weights_only=False)
    return ck["state_dict"]


def _maps(save, task=TASK) -> dict:
    d = os.path.join(save, task, "ECSSD_1")
    return {n: read_image(os.path.join(d, n)) for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("preprocess", ["hybrid", "resident"])
def test_two_process_cli_train_and_test(tree, tmp_path, preprocess):
    save = tmp_path / "dp"
    save.mkdir()
    res = json_lines(run_ranks(
        [HERE, "train", str(tree), str(save), preprocess], tmp_path))
    assert [r["primary"] for r in res] == [True, False]
    assert [r["world"] for r in res] == [2, 2]
    for k in ("loss", "mae", "best_mae", "sweep"):
        assert res[0][k] == res[1][k], k
    assert np.isfinite(res[0]["best_mae"]) and len(res[0]["sweep"]) == 1
    base = save / TASK
    assert len([f for f in os.listdir(base)
                if f.startswith("logtrain_")]) == 1

    from sod100k_tpu_torch.cli.test import run_test, run_testall_resident
    from sod100k_tpu_torch.cli.train import run_training

    one = tmp_path / "one"
    one.mkdir()
    cfg = make_cfg(str(tree), str(one), preprocess)
    want = run_training(cfg, max_epochs=1, device="cpu")["history"][0]
    # the second step's loss: the JAX oracle's bar for later losses
    assert res[0]["loss"] == pytest.approx(want["loss"], rel=1e-4)
    # val MAE reads maps quantized to 1/255: weights that differ at f32
    # noise flip single levels; 1e-3 is a quarter level on average
    assert res[0]["mae"] == pytest.approx(want["mae"], abs=1e-3)
    got_sd, want_sd = _state(save), _state(one)
    assert set(got_sd) == set(want_sd)
    names = [k for k, v in want_sd.items()
             if v.is_floating_point() and "running" not in k]
    got = torch.cat([got_sd[k].double().ravel() for k in names])
    ref = torch.cat([want_sd[k].double().ravel() for k in names])
    assert float(got.abs().sum()) == pytest.approx(float(ref.abs().sum()),
                                                   rel=1e-4)
    for k, w in want_sd.items():
        if not w.is_floating_point():  # the BN step counters
            assert torch.equal(got_sd[k], w), k

    # the test driver on the two-process run's checkpoint, in one process
    cfg.TEST.CHECKPOINT = os.path.join(save, TASK, "checkpoint",
                                       "checkpoint_epoch1.pth.tar")
    run_test(cfg, log=lambda *a: None, device="cpu")
    got_maps, want_maps = _maps(save), _maps(one)
    assert list(got_maps) == list(want_maps) and len(got_maps) == 12
    worst = max(int(np.abs(got_maps[n].astype(np.int16)
                           - want_maps[n].astype(np.int16)).max())
                for n in got_maps)
    # B=4 per rank against B=8: torch's CPU convolutions change their
    # arithmetic with the batch size (one level at most)
    assert worst <= 1, worst
    # the ceil-to-16 mode runs whole on the primary: the same maps
    run_test(native_cfg(cfg), log=lambda *a: None, device="cpu")
    got_maps, want_maps = _maps(save, "native"), _maps(one, "native")
    assert list(got_maps) == list(want_maps) and len(got_maps) == 12
    for n in got_maps:
        np.testing.assert_array_equal(got_maps[n], want_maps[n], err_msg=n)
    reports = []
    cfg.DATA.SAVEDIR = str(save)  # the sweep reads that run's checkpoints
    cfg.CUDA.TEST_RESIDENT = True
    run_testall_resident(cfg, log=reports.append, device="cpu")
    assert [r for r in reports if "[resident]" in r] == res[0]["sweep"]


def test_csf_test_mode_refuses_two_processes(tmp_path):
    res = run_ranks(["-m", "sod100k_tpu_torch.cli.csf", "--mode", "test",
                     "--model", str(tmp_path / "none.pth"), "--test_fold",
                     str(tmp_path / "maps")], tmp_path)
    for rc, text in res:
        assert rc != 0
        assert "data axis 2 must divide --test_batch=1" in text, text


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2:])
