"""``cli.smoke --mesh_shape 1x2``: the composed recipe (train -> prune +
finetune -> test -> eval -> resident TESTALL sweep) on the 2-D data x
spatial mesh, two processes over gloo on the CPU, against the port's chain
in one process, at the bars of the JAX package's mesh test
(``tests/test_smoke.py:47-110``) on its tree (8 + 4 pairs at 80x96, 64 px,
B=4, one train and one finetune epoch):

- the chain reports ``ok`` on both ranks and its resident sweep scored an
  epoch >= 1;
- the train stage's best val MAE within rel 5e-2 / abs 1e-2 of one
  process's chain (two Adam steps part f32 runs that differ by one
  rounding, so the chains are compared loosely);
- the composition pin: one process's prune + finetune from the mesh run's
  own trained checkpoint gives the mesh run's finetuned MAE within abs
  1e-4, with the same parameter count (the same channels survived the
  gammas the mesh trained).
"""

import json
import os
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import json_lines, run_ranks  # noqa: E402

from sod100k_tpu_torch.arch.csnet import CSNet  # noqa: E402
from sod100k_tpu_torch.arch.layer_config import LayerConfig  # noqa: E402
from sod100k_tpu_torch.cli.smoke import make_dry_data, run_smoke  # noqa: E402
from sod100k_tpu_torch.utils.profiler import count_params  # noqa: E402

HERE = os.path.abspath(__file__)


def quiet(*args, **kwargs) -> None:
    pass


def chain(root: str, save: str, mesh_shape: str = "") -> dict:
    return run_smoke(root, save, train_epochs=1, finetune_epochs=1,
                     image_hw=64, batch_size=4, mesh_shape=mesh_shape,
                     log=quiet, device="cpu")


def worker(root: str, save: str) -> None:
    torch.set_num_threads(1)
    out = chain(root, save, "1x2")
    print(json.dumps({
        "ok": out["ok"], "best_mae": out["trained"]["best_mae"],
        "ft_mae": out["finetuned"]["best_mae"],
        "resident_eval": out["resident_eval"]}), flush=True)


def _params(lc: LayerConfig) -> int:
    return count_params(CSNet(lc, device="cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dry_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smoke_mesh") / "data")
    make_dry_data(root, n_train=8, n_test=4, hw=(80, 96))
    return root


@pytest.fixture(scope="module")
def runs(dry_tree, tmp_path_factory):
    """The chain on the 1 x 2 mesh (two processes) and in one process."""
    save = tmp_path_factory.mktemp("mesh")
    ranks = json_lines(run_ranks([HERE, dry_tree, str(save)],
                                 tmp_path_factory.mktemp("logs"),
                                 timeout=300))
    single = chain(dry_tree, str(tmp_path_factory.mktemp("single")))
    return {"save": save, "ranks": ranks, "single": single}


def test_smoke_chain_on_a_1x2_mesh_is_ok(runs):
    assert runs["single"]["ok"]
    for r in runs["ranks"]:
        assert r["ok"], r
        assert r["resident_eval"]["ECSSD"]["epoch"] >= 1
        assert r["resident_eval"] == runs["ranks"][0]["resident_eval"]


def test_smoke_mesh_train_stage_tracks_one_process(runs):
    assert runs["ranks"][0]["best_mae"] == pytest.approx(
        runs["single"]["trained"]["best_mae"], rel=5e-2, abs=1e-2)


def test_smoke_mesh_composition_pin(runs):
    """One process's prune + finetune from the mesh run's own trained
    checkpoint equals the mesh run's prune + finetune."""
    from sod100k_tpu_torch.cli.finetune import run_finetune

    save = runs["save"]
    c = runs["single"]["cfg"].clone()
    c.TASK = "smoke_ft_single_check"
    c.DATA.SAVEDIR = str(save)
    c.CUDA.MESH_SHAPE = ""
    shutil.copytree(save / "smoke", save / c.TASK,
                    ignore=shutil.ignore_patterns("finetune_*", "ECSSD_*"))
    ft1 = run_finetune(c, from_epoch=1, max_epochs=1, log=quiet,
                       device="cpu")
    assert ft1["best_mae"] == pytest.approx(runs["ranks"][0]["ft_mae"],
                                            abs=1e-4)
    mesh_lc = LayerConfig.load(str(save / "smoke" / "layer_configs" /
                                   "layer_config_finetune_1.bin"))
    assert _params(ft1["lc"]) == _params(mesh_lc)


if __name__ == "__main__":
    worker(*sys.argv[1:])
