"""The recipe tools (sod100k_tpu_torch.tools) against the JAX package's
``tools/``, on the CPU at a tiny scale.

- ``make_synth`` equals the JAX tool's bit for bit (that module imports
  only numpy at the top);
- ``prune_trajectory`` runs the whole recipe (penalty training, prune,
  BN re-estimation, finetune) and writes a JSON with exactly the keys of
  ``tools/prune_trajectory_headline.json``; a layer whose gammas all fall
  under the threshold keeps one channel, so the rebuild succeeds;
- ``bf16_ab``'s rank correlation equals the JAX tool's (its nested
  ``rank_corr``, read from the source: importing that module configures
  JAX's compile cache) and scipy's Spearman on tie-free arrays; the tool
  writes its markdown to --out and leaves ``docs/BF16_AB.md`` alone.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

from sod100k_tpu_torch.arch.csnet import CSNet
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.prune import prune
from sod100k_tpu_torch.tools import bf16_ab, prune_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,size,seed", [(5, 48, 0), (3, 64, 1), (4, 33, 7)])
def test_make_synth_is_the_jax_tools(n, size, seed):
    sys.path.insert(0, REPO)
    from tools.prune_trajectory import make_synth as jmake_synth

    for got, want in zip(prune_trajectory.make_synth(n, size, seed),
                         jmake_synth(n, size, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_prune_trajectory_json_has_the_headline_keys(tmp_path, capsys):
    out = tmp_path / "traj.json"
    prune_trajectory.main([
        "--train-epochs", "2", "--ft-epochs", "1", "--basewidth", "8",
        "--images", "8", "--size", "32", "--batch", "4",
        "--flops-weight", "30", "--json", str(out), "--device", "cpu"])
    with open(os.path.join(REPO, "tools", "prune_trajectory_headline.json")
              ) as f:
        headline = json.load(f)
    res = json.loads(out.read_text())
    assert list(res) == list(headline)
    assert res["params_after"] <= res["params_before"]
    for k in ("mae_trivial_all_zero", "mae_pre_prune", "mae_post_prune",
              "mae_post_finetune"):
        assert 0.0 <= res[k] <= 1.0, k
    text = capsys.readouterr().out
    assert "| trained (dynamic wd) |" in text and "| finetuned |" in text


def test_keep_one_alive_makes_a_dead_layer_rebuildable():
    lc = init_layers(8, (0.5, 0.5))
    sd = {k: v.clone() for k, v in CSNet(lc, device="cpu").state_dict()
          .items()}
    for j in range(2):  # every gamma of the first block's leading CBR
        key = f"stage0.0.conv1x1.bns.{j}.weight"
        if key in sd:
            sd[key] = torch.full_like(sd[key], 1e-4)
    sd["stage0.0.conv1x1.bns.0.weight"][3] = -2e-4
    with pytest.raises(Exception):
        prune(sd, lc, 1e-2)
    assert prune_trajectory.keep_one_alive(sd, lc, 1e-2) == 1
    assert float(sd["stage0.0.conv1x1.bns.0.weight"][3]) == \
        pytest.approx(-1e-2 * 1.01)
    slim_sd, slim_lc, _ = prune(sd, lc, 1e-2)
    assert slim_lc.entries[0].out_split[0] + \
        slim_lc.entries[0].out_split[1] == 1


def _jax_rank_corr():
    """``rank_corr`` as the JAX tool defines it inside its main()."""
    with open(os.path.join(REPO, "tools", "bf16_ab.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "rank_corr")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bf16_ab", "exec"),
         ns)
    return ns["rank_corr"]


def test_rank_corr_is_the_jax_tools():
    from scipy.stats import spearmanr

    jrank_corr = _jax_rank_corr()
    rng = np.random.default_rng(3)
    for n in (5, 50, 491):
        a = rng.standard_normal(n)
        b = a + 0.3 * rng.standard_normal(n)
        assert bf16_ab.rank_corr(a, b) == jrank_corr(a, b)
        assert bf16_ab.rank_corr(a, b) == pytest.approx(
            spearmanr(a, b).statistic, abs=1e-12)
    ties = np.round(rng.random(40), 1)
    assert bf16_ab.rank_corr(ties, ties[::-1]) == jrank_corr(ties, ties[::-1])


def test_bf16_ab_writes_its_table_to_out(tmp_path):
    doc = os.path.join(REPO, "docs", "BF16_AB.md")
    before = open(doc).read() if os.path.exists(doc) else None
    out = tmp_path / "ab.md"
    bf16_ab.main(["--steps", "2", "--batch", "2", "--hw", "32",
                  "--basewidth", "8", "--log-every", "1", "--out", str(out),
                  "--device", "cpu"])
    text = out.read_text()
    for head in ("## Loss / penalty trajectories",
                 "## BN-gamma (pruning signal) agreement",
                 "## Pruning-decision agreement (quantile thresholds)"):
        assert head in text
    rows = [l for l in text.splitlines() if l.startswith("| q")]
    assert [r.split()[1] for r in rows] == ["q20", "q30", "q50"]
    losses = [float(l.split("|")[2]) for l in text.splitlines()
              if l.startswith("| 1 ") or l.startswith("| 2 ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (open(doc).read() if os.path.exists(doc) else None) == before
