"""The resident programs on the 2-D data x spatial mesh (gloo over
127.0.0.1, on the CPU), against the same programs in one process and the
JAX package's.

Worlds of 1 x 2 and 2 x 2 processes run this file as a script
(``test_torch_parallel.py``'s ``run_ranks``), one world per module fixture
and both worlds at once; every rank prints one JSON line and rank 0 saves
its tensors:

1. The resident CSNet epoch (``init_layers(8, [0.5, 0.5])``, a 40x40
   store, ``out_hw`` 32x32, B=4, one batch, Adam with dynamic weight decay,
   the penalty on) against the same epoch in one process on the same
   generator: losses and penalties rtol 1e-4, every parameter and BN
   statistic within 1e-3 * max(1, max|leaf|), the bars of
   ``tests/test_parallel.py:383-395``. One batch, as there: after one
   Adam step f32 runs that differ by one rounding part chaotically.
2. The resident validation and TESTALL sweep (a calibrated CSNet, 10
   ragged pairs at 48^2, B=4: three batches, which the 2 x 2 mesh's data
   indices share unevenly) against one process and against the JAX
   package's programs run unsharded: ``n`` exact, the val MAE within 1e-3,
   the table's MAE within 1e-3 and max-F within 2e-3, and every rank's
   sums bit-equal to every other rank's.
3. The resident CSF epoch on 1 x 2 (Res2Net-50 at 96^2, the smallest height
   CSF's extent check admits, B=2, one micro-step, the draws given, SGD
   with momentum so that the update is linear in the gradients): the loss
   within rel 1e-5 of one process's, the trainable parameters' checksum
   and the checksum of their update within rel 1e-4.
4. The drivers on 1 x 2: ``cli.train`` with CUDA.PREPROCESS "resident" (6
   pairs at B=4: one step) against one process, the epoch's loss within
   rel 1e-5 and the resident val MAE within 1e-3; ``run_testall_resident``
   over two checkpoints: the same best epoch and each epoch's table within
   the sweep's bars; ``cli.csf --mode test --mesh_shape 1x2`` with and
   without ``--preprocess resident`` (a training flag that test mode
   ignores, as the JAX driver does): the same maps.
"""

import concurrent.futures
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import json_lines, run_ranks  # noqa: E402

from sod100k_tpu_torch.arch.csf_res2net import CSFNet  # noqa: E402
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn  # noqa: E402
from sod100k_tpu_torch.arch.layer_config import init_layers  # noqa: E402
from sod100k_tpu_torch.cli import csf  # noqa: E402
from sod100k_tpu_torch.config import get_cfg  # noqa: E402
from sod100k_tpu_torch.data.image_io import read_image, write_png  # noqa: E402
from sod100k_tpu_torch.data.pipeline import SalData  # noqa: E402
from sod100k_tpu_torch.data.resident import (  # noqa: E402
    build_resident_val_dataset, make_resident_csf_epoch_fn,
    make_resident_epoch_fn, make_resident_salmetric_fn, make_resident_val_fn)
from sod100k_tpu_torch.data.synth import make_synth_split  # noqa: E402
from sod100k_tpu_torch.metrics.salmetric import result_from_sums  # noqa: E402
from sod100k_tpu_torch.parallel import mesh, multihost  # noqa: E402
from sod100k_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from sod100k_tpu_torch.train.csf_step import (  # noqa: E402
    CSFTrainStep, freeze_reference_params)
from sod100k_tpu_torch.train.optim import make_adam_dwd, make_sgd  # noqa: E402
from sod100k_tpu_torch.train.step import (make_eval_step,  # noqa: E402
                                          make_train_step)

HERE = os.path.abspath(__file__)
LC = init_layers(8, (0.5, 0.5))
B = 4
STORE_HW, OUT_HW = 40, (32, 32)
VAL_N, VAL_HW = 10, (48, 48)
CSF_HW, CSF_B = 96, 2
TASK = "resident_mesh"


# ---- the computations, shared by the ranks and the references -----------

def csnet_epoch(m=None) -> tuple[dict, dict]:
    """One resident CSNet epoch of one batch; (losses and penalties, the
    model's state after it)."""
    model = CSNet(LC, seed=6, device="cpu")
    step = make_train_step(model, make_adam_dwd(model), flops_weight=3.0,
                           batch_size=B, mesh=m, image_h=OUT_HW[0])
    rng = np.random.default_rng(9)
    store = {"image_u8": torch.from_numpy(rng.integers(
                 0, 255, (B, STORE_HW, STORE_HW, 3), dtype=np.uint8)),
             "gt_u8": torch.from_numpy(rng.integers(
                 0, 255, (B, STORE_HW, STORE_HW), dtype=np.uint8))}
    epoch = make_resident_epoch_fn(step, batch_size=B, out_hw=OUT_HW, mesh=m)
    losses, pens = epoch(store, torch.Generator().manual_seed(3), 1e-4, 1.0)
    return ({"losses": losses.tolist(), "penalties": pens.tolist()},
            {k: v.clone() for k, v in model.state_dict().items()})


def evaluate(tree: str, state: str, m=None) -> dict:
    """The resident TESTALL sweep's per-batch sums and the val MAE of the
    weights in ``state`` over the split ``tree``."""
    model = CSNet(LC, device="cpu")
    model.load_state_dict(torch.load(state))
    data = build_resident_val_dataset(SalData(tree, VAL_HW, mode="val"),
                                      VAL_HW, B, device="cpu",
                                      with_wf_tables=True)
    canvas = data.pop("_canvas_hw")
    es = make_eval_step(model, from_u8=True, mesh=m)
    sums = make_resident_salmetric_fn(es, batch_size=B, canvas_hw=canvas,
                                      mesh=m)(data)
    val = make_resident_val_fn(es, batch_size=B, canvas_hw=canvas,
                               mesh=m)(data)
    return {"sums": {k: v.tolist() for k, v in sums.items()},
            "val": float(val)}


def csf_epoch(state: str, m=None) -> dict:
    """One resident CSF epoch of one micro-step on given draws: the global
    loss, the trainable parameters' checksum and that of their update."""
    model = CSFNet("res2net50", device="cpu")
    model.load_state_dict(torch.load(state))
    freeze_reference_params(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    step = CSFTrainStep(model, make_sgd(model, momentum=0.9), iter_size=1,
                        batch_size=CSF_B, mesh=m, image_h=CSF_HW)
    rng = np.random.default_rng(17)
    store = {"image_u8": torch.from_numpy(rng.integers(
                 0, 256, (CSF_B, CSF_HW, CSF_HW, 3), dtype=np.uint8)),
             "gt_u8": torch.from_numpy(((rng.random(
                 (CSF_B, CSF_HW, CSF_HW)) > 0.5) * 255).astype(np.uint8))}
    draws = (np.array([[1, 0]]), np.array([[True, False]]))
    losses = make_resident_csf_epoch_fn(step, batch_size=CSF_B, mesh=m)(
        store, torch.Generator(), 1e-6, draws=draws)
    # each rank returns its share: the driver sums them over the world
    loss = mesh.all_reduce_sum({"loss": losses},
                               m.world if m is not None else None)["loss"]
    after = dict(model.named_parameters())
    return {"loss": loss.tolist(),
            "checksum": sum(float(after[n].detach().double().abs().sum())
                            for n in before),
            "update": sum(float((after[n].detach() - p).double().abs().sum())
                          for n, p in before.items())}


def driver_cfg(root: str, save: str, mesh_shape: str = ""):
    cfg = get_cfg()
    cfg.TASK = TASK
    cfg.PRINT_FREQ = 1
    cfg.MODEL.BASIC_SPLIT = [0.5, 0.5]
    cfg.DATA.DIR = os.path.join(root, "DUTS-TR")
    cfg.DATA.BATCH_SIZE = B
    cfg.DATA.SAVEDIR = save
    cfg.DATA.IMAGE_H = cfg.DATA.IMAGE_W = VAL_HW[0]
    cfg.VAL.DIR = os.path.join(root, "ECSSD")
    cfg.TEST.DATASET_PATH = root
    cfg.TEST.DATASETS = ["ECSSD"]
    cfg.TEST.IMAGE_H, cfg.TEST.IMAGE_W = VAL_HW
    cfg.TEST.MODEL_CONFIG = os.path.join(root, "lc.bin")
    cfg.TEST.BEGIN = cfg.TEST.INTERVAL = 1
    cfg.AUTO.ENABLE = True
    cfg.AUTO.PREDEFINE = os.path.join(root, "lc.bin")
    cfg.AUTO.FLOPS.ENABLE = True
    cfg.AUTO.FLOPS.WEIGHT = 3.0
    cfg.SOLVER.METHOD = "Adam_dynamic_weight_decay"
    cfg.SOLVER.LR = 1e-4
    cfg.CUDA.PREPROCESS = "resident"
    cfg.CUDA.RESIDENT_STORE_HW = 64
    cfg.CUDA.TEST_RESIDENT = True
    cfg.CUDA.MESH_SHAPE = mesh_shape
    return cfg


def quiet(*args, **kwargs) -> None:
    pass


def drive(root: str, save: str, mesh_shape: str = "") -> dict:
    """``cli.train`` on the resident front-end for one epoch, then the
    resident TESTALL sweep over the checkpoints under ``save``/sweep."""
    from sod100k_tpu_torch.cli.test import run_testall_resident
    from sod100k_tpu_torch.cli.train import run_training

    res = run_training(driver_cfg(root, os.path.join(save, "train"),
                                  mesh_shape),
                       max_epochs=1, log=quiet, device="cpu")
    reports = []
    best = run_testall_resident(
        driver_cfg(root, os.path.join(save, "sweep"), mesh_shape),
        log=lambda msg: reports.append(str(msg)), device="cpu")
    return {"loss": res["history"][0]["loss"],
            "mae": res["history"][0]["mae"], "best": best,
            "reports": [r for r in reports if "[resident]" in r]}


def csf_test(root: str, fold: str, *flags) -> None:
    cfg = csf.build_parser().parse_args([
        "--mode", "test", "--model", os.path.join(root, "csf.pth"),
        "--test_fold", fold, *flags])
    cfg.test_root = root
    cfg.test_list = os.path.join(root, "test.lst")
    csf.run_csf_test(cfg, log=quiet, device="cpu")


def worker(shape: str, root: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    multihost.init_from_env(log=quiet)
    m = mesh.make_mesh_2d(*mesh.parse_mesh_shape(shape))
    out, state = {}, {}
    out["epoch"], state["epoch"] = csnet_epoch(m)
    out["eval"] = evaluate(os.path.join(root, "ECSSD"),
                           os.path.join(root, "eval_state.pt"), m)
    if shape == "1x2":
        out["csf"] = csf_epoch(os.path.join(root, "csf_state.pt"), m)
        out["drivers"] = drive(root, out_dir, shape)
        for tag, flags in (("plain", []),
                           ("resident", ["--preprocess", "resident"])):
            csf_test(root, os.path.join(out_dir, f"csf_{tag}"),
                     "--mesh_shape", shape, *flags)
    if multihost.is_primary():
        torch.save(state, os.path.join(out_dir, "rank0.pt"))
    print(json.dumps(out), flush=True)


# ---- fixtures ------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calibrated(seed: int) -> CSNet:
    model = CSNet(LC, seed=seed, device="cpu")
    rng = np.random.default_rng(12 + seed)
    calibrate_bn(model, torch.from_numpy(
        rng.standard_normal((4, *VAL_HW, 3), dtype=np.float32)))
    return model


def _sweep_tree(save: str, models) -> None:
    ck = os.path.join(save, "sweep", TASK, "checkpoint")
    os.makedirs(ck)
    for epoch, model in enumerate(models, start=1):
        save_checkpoint(os.path.join(ck, f"checkpoint_epoch{epoch}.pth.tar"),
                        model, None, epoch=epoch)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The splits, the weights every rank loads, and both worlds' results
    (the worlds run at once)."""
    from test_torch_csf import he_scale_state

    root = tmp_path_factory.mktemp("resident_mesh")
    make_synth_split(str(root / "DUTS-TR"), 6, hw=(60, 80), jitter=6, seed=3)
    make_synth_split(str(root / "ECSSD"), VAL_N, hw=(60, 80), jitter=8,
                     seed=4)
    LC.save(str(root / "lc.bin"))
    models = [_calibrated(1), _calibrated(2)]
    torch.save(models[0].state_dict(), root / "eval_state.pt")
    csf_model = CSFNet("res2net50", seed=0, device="cpu")
    csf_model.load_state_dict(he_scale_state(csf_model, 24))
    torch.save(csf_model.state_dict(), root / "csf_state.pt")
    torch.save({"epoch": 0, "state_dict": csf_model.state_dict()},
               root / "csf.pth")
    rng = np.random.default_rng(71)
    (root / "images").mkdir()
    for i in range(2):
        write_png(str(root / "images" / f"{i}.png"),
                  rng.integers(0, 256, (CSF_HW, 72, 3), np.uint8))
    (root / "test.lst").write_text("images/0.png\nimages/1.png\n")
    dirs = {}
    for shape in ("1x2", "2x2", "one"):
        dirs[shape] = tmp_path_factory.mktemp(f"out_{shape}")
        _sweep_tree(str(dirs[shape]), models)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {shape: pool.submit(
            run_ranks, [HERE, shape, str(root), str(dirs[shape])],
            tmp_path_factory.mktemp(f"logs_{shape}"), n=n, timeout=300)
            for shape, n in (("1x2", 2), ("2x2", 4))}
        ranks = {shape: json_lines(f.result()) for shape, f in futs.items()}
    return {"root": root, "dirs": dirs, "ranks": ranks, "models": models}


@pytest.fixture(scope="module")
def one_eval(tree):
    return evaluate(str(tree["root"] / "ECSSD"),
                    str(tree["root"] / "eval_state.pt"))


@pytest.fixture(scope="module")
def jax_eval(tree):
    """The JAX package's resident sweep and val MAE, unsharded, on the same
    weights and split."""
    from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
    from sod100k_tpu.data import pipeline as jpl
    from sod100k_tpu.data import resident as jres
    from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
    from sod100k_tpu.metrics import salmetric as jsal
    from sod100k_tpu.train import step as jstep

    ref = jres.build_resident_val_dataset(
        jpl.SalData(str(tree["root"] / "ECSSD"), VAL_HW, mode="val"),
        VAL_HW, B, with_wf_tables=True)
    canvas = ref.pop("_canvas_hw")
    jes = jstep.make_eval_step(jinit_layers(8, [0.5, 0.5]), from_u8=True)
    params = state_dict_to_pytree(tree["models"][0].state_dict())
    sums = jres.make_resident_salmetric_fn(jes, batch_size=B,
                                           canvas_hw=canvas)(params, ref)
    val = float(jres.make_resident_val_fn(jes, batch_size=B,
                                          canvas_hw=canvas)(params, ref))
    return {"result": jsal.result_from_sums(sums), "val": val,
            "n": float(np.sum(sums["n"]))}


# ---- the checks ----------------------------------------------------------

SHAPES = ["1x2", "2x2"]


@pytest.mark.parametrize("shape", SHAPES)
def test_resident_csnet_epoch(tree, shape):
    want, want_state = csnet_epoch()
    ranks = tree["ranks"][shape]
    for r in ranks:  # the losses are all-reduced: the same on every rank
        assert r["epoch"] == ranks[0]["epoch"]
    got = ranks[0]["epoch"]
    assert len(got["losses"]) == 1 and np.isfinite(got["losses"]).all()
    assert got["penalties"][0] > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["penalties"], want["penalties"],
                               rtol=1e-4)
    state = torch.load(tree["dirs"][shape] / "rank0.pt")["epoch"]
    assert state.keys() == want_state.keys()
    moved = 0
    for k, b in want_state.items():
        if not b.is_floating_point():
            assert torch.equal(state[k], b), k
            continue
        a, b = state[k].numpy(), b.numpy()
        np.testing.assert_allclose(
            a, b, rtol=0, atol=1e-3 * max(1.0, float(np.abs(b).max())),
            err_msg=k)
        moved += k.endswith("weight")
    assert moved


def _result(sums: dict) -> dict:
    return result_from_sums({k: np.asarray(v) for k, v in sums.items()})


@pytest.mark.parametrize("shape", SHAPES)
def test_resident_val_and_sweep(tree, one_eval, jax_eval, shape):
    ranks = tree["ranks"][shape]
    for r in ranks:  # bit-equal on every rank
        assert r["eval"] == ranks[0]["eval"]
    got = ranks[0]["eval"]
    # n counts every image once: a sum over the world instead of the data
    # group would count each data index S times (n = 20 on 1 x 2)
    assert sum(got["sums"]["n"]) == VAL_N
    assert len(got["sums"]["n"]) == 3  # ceil(10 / 4) batches
    assert sum(one_eval["sums"]["n"]) == jax_eval["n"] == VAL_N
    res, one = _result(got["sums"]), _result(one_eval["sums"])
    assert res["mae"] > 0.01 and 0.0 < res["max_f"] < 1.0  # not degenerate
    for want, val in ((one, one_eval["val"]),
                      (jax_eval["result"], jax_eval["val"])):
        assert got["val"] == pytest.approx(val, abs=1e-3)
        assert res["mae"] == pytest.approx(want["mae"], abs=1e-3)
        assert res["max_f"] == pytest.approx(want["max_f"], abs=2e-3)
    assert got["val"] == pytest.approx(res["mae"], abs=1e-6)


def test_resident_csf_epoch(tree):
    ranks = tree["ranks"]["1x2"]
    assert ranks[0]["csf"] == ranks[1]["csf"]
    got = ranks[0]["csf"]
    want = csf_epoch(str(tree["root"] / "csf_state.pt"))
    assert len(got["loss"]) == 1 and got["update"] > 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["checksum"] == pytest.approx(want["checksum"], rel=1e-4)
    assert got["update"] == pytest.approx(want["update"], rel=1e-4)


_REPORT = re.compile(r"epoch (\d+) ECSSD \[resident\]: MaxF (\S+) MAE (\S+)")


def _table(path) -> dict:
    """{epoch: (MaxF, MAE)} from a ``_resident`` results file."""
    out = {}
    for line in open(path):
        e, f, mae = _REPORT.search(line).groups()
        out[int(e)] = (float(f), float(mae))
    return out


def test_resident_drivers_on_a_1x2_mesh(tree):
    ranks = tree["ranks"]["1x2"]
    got = ranks[0]["drivers"]
    assert ranks[1]["drivers"] == got
    want = drive(str(tree["root"]), str(tree["dirs"]["one"]))
    assert np.isfinite(got["loss"])
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["mae"] == pytest.approx(want["mae"], abs=1e-3)
    assert got["best"]["ECSSD"]["epoch"] == want["best"]["ECSSD"]["epoch"]
    assert len(got["reports"]) == 2  # one line per checkpoint
    name = os.path.join("sweep", TASK, "FmeasureResults_ECSSD_resident.txt")
    mine = _table(tree["dirs"]["1x2"] / name)
    ref = _table(tree["dirs"]["one"] / name)
    assert sorted(mine) == sorted(ref) == [1, 2]
    for e, (f, mae) in ref.items():
        assert mine[e][0] == pytest.approx(f, abs=2e-3)
        assert mine[e][1] == pytest.approx(mae, abs=1e-3)


def test_csf_test_mode_ignores_preprocess_resident(tree):
    """``cli.csf --mode test --mesh_shape 1x2 --preprocess resident`` runs
    (the JAX driver's test mode never reads the flag) and writes the maps
    that the same command without the flag writes."""
    plain = tree["dirs"]["1x2"] / "csf_plain"
    names = sorted(os.listdir(plain))
    assert names == ["0_sal_fuse.png", "1_sal_fuse.png"]
    assert sorted(os.listdir(tree["dirs"]["1x2"] / "csf_resident")) == names
    for n in names:
        a = read_image(str(plain / n))
        assert a.std() > 0  # not a constant map
        np.testing.assert_array_equal(
            a, read_image(str(tree["dirs"]["1x2"] / "csf_resident" / n)))


if __name__ == "__main__":
    worker(*sys.argv[1:])
