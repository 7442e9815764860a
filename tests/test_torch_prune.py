"""Port parity, pruning: sod100k_tpu_torch.prune on the port's state_dict
against sod100k_tpu.prune on the JAX pytree, at the same weights.

Weights follow tests/test_prune.py: BN gammas uniform in [0, 1] (one
channel per branch at 0.9, so each branch survives a 0.3 threshold) and
perturbed running statistics, which pruning must reset. Both packages must
give the same LayerConfig, the same masks and exactly the same slim tensors;
the slim port model's eval forward then holds the repo's golden bars
against the JAX slim model (max |dlogit| < 1e-3, sigmoid mean |d| < 1e-5,
tests/test_model_parity.py:52-54).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.arch.csnet import csnet_apply, csnet_init
from sod100k_tpu.arch.layer_config import LayerConfig as JLayerConfig
from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
from sod100k_tpu.prune.finetune import prune as jprune
from sod100k_tpu_torch.arch.csnet import calibrate_bn, count_params
from sod100k_tpu_torch.arch.layer_config import LayerConfig, init_layers
from sod100k_tpu_torch.interop.torch_ckpt import state_dict_from_pytree
from sod100k_tpu_torch.prune import build_pruned_csnet, prune


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JLC = jinit_layers(8, [0.5, 0.5])
LC = init_layers(8, (0.5, 0.5))


def _randomized_params(seed=5, zero=()):
    """The JAX package's prune-test weights; every BN under a path in
    ``zero`` gets all-zero gammas."""
    params = jax.tree.map(np.asarray, csnet_init(jax.random.key(0), JLC))
    rng = np.random.default_rng(seed)

    def walk(node, path):
        for k, v in node.items():
            if not isinstance(v, dict):
                continue
            here = f"{path}.{k}" if path else k
            if "scale" in v and "mean" in v:
                c = v["scale"].shape[0]
                g = rng.uniform(0.0, 1.0, size=c).astype(np.float32)
                g[rng.integers(c)] = 0.9  # keep the branch alive
                if any(here.startswith(z) for z in zero):
                    g[:] = 0.0
                v["scale"] = g
                v["mean"] = rng.normal(0, 0.5, size=c).astype(np.float32)
                v["var"] = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
            else:
                walk(v, here)

    walk(params, "")
    return params


CASES = {
    # prunes channels in every stage and in the head
    "every_stage": ((), 0.3),
    # empties stage2.1's branch 1: the slim model carries a None branch
    "whole_branch": (("stage2.1.conv1x1.bns.1",), 0.3),
    # a higher threshold, with ragged dilation widths in the MSBlocks
    "deep": ((), 0.6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prune_matches_jax(case):
    zero, thres = CASES[case]
    params = _randomized_params(zero=zero)
    jparams, jlc, jmasks = jprune(params, JLC, thres)
    sd, lc, masks = prune(state_dict_from_pytree(params), LC, thres)

    assert lc == LayerConfig.from_reference(jlc.to_reference())
    assert len(masks) == len(jmasks) == 21
    for m, jm in zip(masks, jmasks):
        assert len(m) == len(jm)
        for a, b in zip(m, jm):
            np.testing.assert_array_equal(a, b)
    if case == "every_stage":  # channels go in every stage and the head
        for name in ("stage0", "stage1", "stage2", "stage3", "stage4"):
            def width(c):
                return sum(c.entries[p.entry].out_channels
                           for p in c.stage_blocks(name))
            assert width(lc) < width(LC), name
        assert lc.fuse1x1.out_channels < LC.fuse1x1.out_channels
    if case == "whole_branch":
        assert lc.entries[5].out_split[1] == 0  # stage2.1
        assert not any(k.startswith("stage2.1.conv3x3_1.convs.1") for k in sd)

    want = state_dict_from_pytree(jparams)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    for k, v in sd.items():  # pruning resets the running statistics
        if k.endswith("running_mean"):
            assert not v.any()
        elif k.endswith("running_var"):
            assert (v == 1).all()
        elif k.endswith("num_batches_tracked"):
            assert int(v) == 0

    model = build_pruned_csnet(lc, sd, device="cpu")
    assert count_params(model) < count_params(
        build_pruned_csnet(LC, state_dict_from_pytree(params), device="cpu"))
    _check_slim_forward(model)


def _check_slim_forward(model):
    """Calibrate the slim model, then hold its eval forward (plain path on
    the CPU) against the JAX slim model on the same state."""
    rng = np.random.default_rng(0)
    batch = rng.standard_normal((4, 32, 32, 3), dtype=np.float32)
    calibrate_bn(model, torch.from_numpy(batch))
    with torch.no_grad():
        got = model(torch.from_numpy(batch[:2])).numpy()
    jlc = JLayerConfig.from_reference(model.lc.to_reference())
    want = np.asarray(jax.jit(lambda p, v: csnet_apply(p, v, jlc))(
        state_dict_to_pytree(model.state_dict()), jnp.asarray(batch[:2])))

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    assert got.shape == want.shape == (2, 32, 32, 1)
    assert np.isfinite(got).all() and sig(got).std() > 0.01
    assert np.abs(got - want).max() < 1e-3
    assert np.abs(sig(got) - sig(want)).mean() < 1e-5


def test_prune_refuses_an_empty_block():
    """A block whose every gamma is below the threshold cannot be built:
    both packages raise."""
    params = _randomized_params(zero=("stage3.2.conv1x1",))
    with pytest.raises(ValueError, match="ZERO surviving channels"):
        jprune(params, JLC, 0.3)
    with pytest.raises(ValueError, match=r"layer 10 \(stage3.2.conv1x1\)"):
        prune(state_dict_from_pytree(params), LC, 0.3)
