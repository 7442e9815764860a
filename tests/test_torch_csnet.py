"""Port parity, the model: sod100k_tpu_torch CSNet against csnet_apply.

Fresh ×100 nets explode or die in eval mode with init BN statistics, so every
model is calibrated first (``calibrate_bn``: one train-mode forward on a
seeded batch sets the running statistics to that batch's). The calibrated
state goes to JAX through the JAX package's ``state_dict_to_pytree``; both
packages then run the same eval forward, f32 on the CPU. Bars: the repo's
golden-parity bars (tests/test_model_parity.py), max |Δlogit| < 1e-3 and
sigmoid mean |Δ| < 1e-5.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.arch.csnet import count_params as jcount_params
from sod100k_tpu.arch.csnet import csnet_apply, csnet_init
from sod100k_tpu.arch.layer_config import LayerConfig as JLayerConfig
from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                            state_dict_to_pytree)
from sod100k_tpu.prune.finetune import prune
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn, count_params
from sod100k_tpu_torch.arch.layer_config import LayerConfig, init_layers
from sod100k_tpu_torch.interop.torch_ckpt import state_dict_from_pytree
from sod100k_tpu_torch.ops import dw_chain


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SPLITS = [(8, (0.5, 0.5)), (40, (0.5, 0.5)), (9, (1 / 3, 1 / 3, 1 / 3)),
          (16, (1.0,))]


@pytest.mark.parametrize("basewidth,split", SPLITS)
def test_layer_config_matches_jax(basewidth, split, tmp_path):
    lc = init_layers(basewidth, split)
    jlc = jinit_layers(basewidth, split)
    assert lc.to_reference().__repr__() == jlc.to_reference().__repr__()
    assert [(p.stage, p.index, p.stride, p.kernel) for p in lc.block_plans()] \
        == [(p.stage, p.index, p.stride, p.kernel) for p in jlc.block_plans()]
    lc.save(str(tmp_path / "port.bin"))
    jlc.save(str(tmp_path / "jax.bin"))
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    assert JLayerConfig.load(str(tmp_path / "port.bin")) == jlc
    assert LayerConfig.load(str(tmp_path / "jax.bin")) == lc


def test_state_dict_from_pytree_matches_pytree_to_state_dict():
    lc = init_layers(8, (0.5, 0.5))
    params = jax.tree.map(np.asarray, csnet_init(jax.random.key(0), lc))
    ref = pytree_to_state_dict(params)
    got = state_dict_from_pytree(params)
    extra = {k for k in got if k.endswith("num_batches_tracked")}
    assert set(got) - extra == set(ref)
    assert {k.rsplit(".", 1)[0] for k in extra} == \
        {k.rsplit(".", 1)[0] for k in ref if k.endswith("running_mean")}
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    model = CSNet(lc)
    model.load_state_dict(got, strict=True)
    assert count_params(model) == jcount_params(params)
    assert set(model.state_dict()) == set(got)


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _check_against_jax(model: CSNet, hw, seed=0):
    """Calibrate, run both packages' eval forward, hold to the bars."""
    rng = np.random.default_rng(seed)
    batch = rng.standard_normal((4, *hw, 3), dtype=np.float32)
    calibrate_bn(model, torch.from_numpy(batch))
    x = batch[:2]
    before = dw_chain.launches
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert dw_chain.launches == before  # the CPU takes the plain version
    params = state_dict_to_pytree(model.state_dict())
    want = np.asarray(jax.jit(lambda p, v: csnet_apply(p, v, model.lc))(
        params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, *hw, 1)
    assert np.isfinite(got).all()
    assert _sig(got).std() > 0.01  # calibrated: not a constant map
    assert np.abs(got - want).max() < 1e-3
    assert np.abs(_sig(got) - _sig(want)).mean() < 1e-5
    assert count_params(model) == jcount_params(params)


@pytest.mark.parametrize("basewidth,split,hw", [
    (8, (0.5, 0.5), (32, 32)),
    (8, (0.5, 0.5), (48, 80)),        # not divisible by 32
    (9, (1 / 3, 1 / 3, 1 / 3), (64, 64)),   # 3 octave branches
    (40, (0.5, 0.5), (64, 64)),       # CSNet-L, full width
])
def test_csnet_matches_jax(basewidth, split, hw):
    _check_against_jax(CSNet(init_layers(basewidth, split), seed=1), hw)


def test_pruned_csnet_matches_jax():
    """A config from the JAX package's prune (randomized-gamma recipe of
    tests/test_prune.py), with one branch pruned away entirely so the model
    carries a None branch."""
    lc = jinit_layers(8, [0.5, 0.5])
    params = csnet_init(jax.random.key(0), lc)
    rng = np.random.default_rng(5)

    def walk(node, path):
        for k, v in node.items():
            if not isinstance(v, dict):
                continue
            if "scale" in v and "mean" in v:
                c = v["scale"].shape[0]
                g = rng.uniform(0.0, 1.0, size=c).astype(np.float32)
                g[rng.integers(c)] = 0.9  # keep the branch alive
                if path == "stage2.1.conv1x1.bns" and k == "1":
                    g[:] = 0.0  # ... except this one
                v["scale"] = g
            else:
                walk(v, f"{path}.{k}" if path else k)

    walk(params, "")
    new_params, new_lc, _ = prune(params, lc, 0.3)
    assert 0 in new_lc.entries[5].out_split  # stage2.1
    model = CSNet(LayerConfig.from_reference(new_lc.to_reference()))
    model.load_state_dict(state_dict_from_pytree(new_params), strict=True)
    _check_against_jax(model, (32, 32))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every sod100k_tpu_torch module imports with jax and sod100k_tpu
    made unimportable."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sod100k_tpu'] = None\n"
        "import sod100k_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'sod100k_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'sod100k_tpu.'))"
        " for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": repo})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 13


def test_reference_pickle_round_trip_through_port(tmp_path):
    """A pickle written the reference way loads into the port's config."""
    raw = jinit_layers(8, [0.5, 0.5]).to_reference()
    path = tmp_path / "lc.bin"
    path.write_bytes(pickle.dumps(raw))
    assert LayerConfig.load(str(path)) == init_layers(8, (0.5, 0.5))


def _calibrated(seed: int, hw=(32, 32)) -> tuple[CSNet, torch.Tensor]:
    model = CSNet(init_layers(8, (0.5, 0.5)), seed=seed)
    rng = np.random.default_rng(seed)
    batch = torch.from_numpy(rng.standard_normal((4, *hw, 3),
                                                 dtype=np.float32))
    calibrate_bn(model, batch)
    return model, batch[:2]


def _tails(model: CSNet) -> int:
    """Live octave branches over the ILBlock tails: packs per weight set."""
    return sum(1 for m in model.modules() if hasattr(m, "tail_packs"))


def test_eval_forwards_pack_once():
    """The eval path builds each block's parameter pack once per weight set,
    not per forward."""
    model, x = _calibrated(3)
    before = dw_chain.packs_built
    with torch.no_grad():
        first = model(x)
        built = dw_chain.packs_built - before
        second = model(x)
    assert built == _tails(model) == 18
    assert dw_chain.packs_built - before == built  # none for the second
    torch.testing.assert_close(first, second, rtol=0, atol=0)


@pytest.mark.parametrize("change", ["load_state_dict", "to", "in_place"])
def test_new_weights_repack(change):
    """load_state_dict with other weights, .to() and an in-place update each
    rebuild the packs; the output equals a freshly built model's."""
    model, x = _calibrated(3)
    other, _ = _calibrated(4)
    with torch.no_grad():
        model(x)
        before = dw_chain.packs_built
        if change == "load_state_dict":
            model.load_state_dict(other.state_dict())
            fresh = other
        elif change == "to":
            model.to(torch.float64).to(torch.float32)
            fresh = model
        else:
            bn = model.stage1[0].conv3x3_2.bns["0"]
            bn.running_var.mul_(2.0)
            fresh = CSNet(model.lc)
            fresh.load_state_dict(model.state_dict())
            fresh.eval()
        got = model(x)
        rebuilt = dw_chain.packs_built - before
        want = fresh(x) if fresh is not model else None
    # every block's sources moved or changed, or just the updated block's
    assert rebuilt == (1 if change == "in_place" else 18)
    if want is not None:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        assert np.isfinite(got.numpy()).all()


def test_pack_from_inference_mode_serves_no_grad_forward():
    """A pack first built under torch.inference_mode() serves a later
    torch.no_grad() forward, and a grad-mode one, unchanged."""
    model, x = _calibrated(5)
    with torch.inference_mode():
        want = model(x).clone()
    before = dw_chain.packs_built
    with torch.no_grad():
        got = model(x)
    assert dw_chain.packs_built == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got_grad = model(x.clone().requires_grad_(True))
    assert dw_chain.packs_built == before
    torch.testing.assert_close(got_grad.detach(), want, rtol=0, atol=0)


def test_moved_model_rebuilds_its_packs():
    """A move or conversion (Module._apply) and load_state_dict drop the
    packs, even where nothing changed: fresh buffers restart their version
    counters and may take freed addresses, so the key alone could repeat.
    Statistics edited while the model was away are served, not a stale
    pack."""
    model, x = _calibrated(3)
    with torch.no_grad():
        want = model(x)
        before = dw_chain.packs_built
        model.cpu()
        assert torch.equal(model(x), want)
        assert dw_chain.packs_built - before == 18
        model.load_state_dict(model.state_dict())
        model(x)
        assert dw_chain.packs_built - before == 36
        model.double()
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.add_(0.25)
        model.float()
        got = model(x)
        fresh = CSNet(model.lc)
        fresh.load_state_dict(model.state_dict())
        fresh.eval()
        torch.testing.assert_close(got, fresh(x), rtol=0, atol=0)
    assert not torch.equal(got, want)
