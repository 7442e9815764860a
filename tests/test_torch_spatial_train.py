"""Port parity, the 2-D data x spatial mesh in training: the CSNet train
step on a 2 x 2 gloo world and the CSF micro-step on a 1 x 2 world, f32 on
the CPU, against the JAX package's single device (its own oracles in
``tests/test_parallel.py``, at their bars) and against the port's single
process.

Real gloo worlds run this file as a script (``test_torch_parallel.py``'s
``run_ranks``), each rank feeding its data rows and its band of each
image's rows (``parallel.multihost.local_slice_feed`` with the mesh).

1. CSNet, ``init_layers(8, [0.5, 0.5])`` at 64^2, B=4 on 2 x 2: the
   train-mode forward (global-batch BN over the world) against the JAX
   package's ``csnet_apply`` on the same weights at atol 5e-4
   (``tests/test_parallel.py:33``); one Adam step with the penalty
   (flops weight 5) at ``:287-300``'s bars: loss within 1e-5, penalty rel
   1e-5, parameters and BN statistics within 1e-3 * max(1, max|leaf|).
   Against the port's single process, in f64: the logits within 1e-5 of
   their largest, the loss and the penalty at 1e-5 relative, and each
   gradient tensor within 1e-5 of its largest element. (In f32 CSNet at
   this size is chaotic: the global batch norm's statistics, summed in
   another order, move one step's gradients ~1e-2 per tensor between any
   two f32 runs, as between the port and the JAX package; f64 holds the
   sharded math itself to the bar.)
2. CSF, Res2Net-50 at 96 x 32, B=2, iter_size 2 on 1 x 2: the micro-step's
   loss and gradients against the JAX package's ``value_and_grad`` of the
   step's loss (``:214-228``: loss rel 1e-5, gradients rtol 1e-3 with atol
   1e-4 * max(|g|, 1)), and against the port's single process at 1e-5
   relative (loss; gradients within 1e-5 of each tensor's largest element).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import run_ranks  # noqa: E402

from sod100k_tpu_torch.arch.csf_res2net import CSFNet  # noqa: E402
from sod100k_tpu_torch.arch.csnet import CSNet  # noqa: E402
from sod100k_tpu_torch.arch.layer_config import init_layers  # noqa: E402
from sod100k_tpu_torch.ops.norm import convert_global_bn  # noqa: E402
from sod100k_tpu_torch.parallel import mesh, multihost, spatial  # noqa: E402
from sod100k_tpu_torch.train.csf_step import (  # noqa: E402
    CSFTrainStep, freeze_reference_params, make_csf_optimizer)
from sod100k_tpu_torch.train.optim import make_adam_dwd  # noqa: E402
from sod100k_tpu_torch.train.step import make_train_step  # noqa: E402

HERE = os.path.abspath(__file__)
LC = init_layers(8, [0.5, 0.5])
HW, B, FW, LR, SEED = 64, 4, 5.0, 1e-4, 5
CSF_H, CSF_W, CSF_B, CSF_ITER = 96, 32, 2, 2


def csnet_batch() -> dict:
    rng = np.random.default_rng(3)
    return {"image": rng.standard_normal((B, HW, HW, 3), dtype=np.float32),
            "target": (rng.random((B, HW, HW, 1)) > 0.5).astype(np.float32)}


def csf_batch() -> dict:
    rng = np.random.default_rng(7)
    return {"image": rng.standard_normal((CSF_B, CSF_H, CSF_W, 3),
                                         dtype=np.float32),
            "target": (rng.random((CSF_B, CSF_H, CSF_W, 1)) > 0.5
                       ).astype(np.float32)}


def _record_grads(optimizer, names: dict) -> dict:
    """The gradients each ``optimizer.step()`` sees (after the step's
    all-reduce), by parameter name."""
    seen = {}

    def hook(opt, args, kwargs):
        for g in opt.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    seen[names[p]] = p.grad.detach().clone()
    optimizer.register_step_pre_hook(hook)
    return seen


def csnet_run(m=None, dtype=torch.float32) -> dict:
    """The train-mode forward's logits and one Adam step (penalty on) at
    B=4, 64^2 in ``dtype``: on one process, or on this rank's rows and band
    of mesh ``m``. Whole logits and the step's loss, penalty, gradients and
    state dict, as numpy."""
    batch = {k: v.astype(torch.empty((), dtype=dtype).numpy().dtype)
             for k, v in csnet_batch().items()}
    fwd = CSNet(LC, seed=SEED, device="cpu").to(dtype).train()
    sp = None
    x = torch.from_numpy(batch["image"])
    if m is not None:
        if m.world is not None:
            convert_global_bn(fwd, m.world)
        sp = spatial.SpatialCtx(m, HW)
        x = multihost.local_slice_feed({"image": batch["image"]}, mesh=m
                                       )["image"]
        x = torch.from_numpy(np.ascontiguousarray(x))
    with torch.no_grad():
        logits = fwd(x, spatial=sp)
    if m is not None:
        logits = mesh.gather_rows(
            spatial.gather_bands(logits, sp, dim=1, h=HW), m.data_group)
    model = CSNet(LC, seed=SEED, device="cpu").to(dtype)
    opt = make_adam_dwd(model)
    grads = _record_grads(opt, {p: n for n, p in model.named_parameters()})
    if m is None:
        step = make_train_step(model, opt, flops_weight=FW, batch_size=B)
        feed = batch
    else:
        step = make_train_step(model, opt, flops_weight=FW, batch_size=B,
                               mesh=m, image_h=HW)
        feed = multihost.local_slice_feed(batch, mesh=m)
    res = step(feed, LR, 1.0)
    out = {"logits": logits.numpy(), "loss": float(res["loss"]),
           "penalty": float(res["penalty"]),
           "exchanges": int(res.get("exchanges", 0))}
    out.update({f"grad/{k}": v.numpy() for k, v in grads.items()})
    out.update({f"state/{k}": v.numpy() for k, v in
                model.state_dict().items()
                if not k.endswith("num_batches_tracked")})
    return out


def csf_run(m=None) -> dict:
    """One CSF micro-step (of iter_size 2) at B=2: loss and the gradients
    summed over the world (whole-image gradients)."""
    model = CSFNet("res2net50", seed=2, device="cpu")
    freeze_reference_params(model)
    batch = csf_batch()
    kw = {} if m is None else {"mesh": m, "image_h": CSF_H}
    step = CSFTrainStep(model, make_csf_optimizer(model), iter_size=CSF_ITER,
                        batch_size=CSF_B, **kw)
    feed = batch if m is None else multihost.local_slice_feed(batch, mesh=m)
    loss = step(feed, 5e-5)["loss"]
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.requires_grad}
    if m is not None:
        loss = mesh.all_reduce_sum({"l": loss}, m.world)["l"]
        mesh.all_reduce_grads(model.parameters(), m.world)
    out = {"loss": float(loss)}
    out.update({f"grad/{k}": v.numpy() for k, v in grads.items()})
    return out


def worker(role: str, out: str) -> None:
    torch.set_num_threads(1)
    assert multihost.init_from_env(lambda *_: None)
    m = mesh.make_mesh_2d(*((2, 2) if role == "csnet" else (1, 2)))
    if role == "csnet":
        res = csnet_run(m)
        res.update({f"f64/{k}": v for k, v in
                    csnet_run(m, torch.float64).items()})
    else:
        res = csf_run(m)
    if multihost.is_primary():
        np.savez(out, **res)
    multihost.barrier("done")


def _ranks(role, n, tmp_path) -> dict:
    out = tmp_path / f"{role}.npz"
    results = run_ranks([HERE, role, str(out)], tmp_path, n=n, timeout=240)
    for pid, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {pid} failed:\n{text}"
    return dict(np.load(out))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def csnet_2x2(tmp_path_factory):
    return _ranks("csnet", 4, tmp_path_factory.mktemp("csnet2d"))


@pytest.fixture(scope="module")
def csnet_one():
    return csnet_run(dtype=torch.float64)


@pytest.fixture(scope="module")
def csnet_jax():
    """The JAX package's single-device forward and Adam step from the
    port's initial weights (``tests/test_parallel.py``'s oracles)."""
    import jax
    import jax.numpy as jnp

    from sod100k_tpu.arch.csnet import csnet_apply
    from sod100k_tpu.arch.layer_config import init_layers as jinit
    from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                                state_dict_to_pytree)
    from sod100k_tpu.ops.goct import ApplyCtx
    from sod100k_tpu.train import optim as joptim
    from sod100k_tpu.train.params import merge, partition
    from sod100k_tpu.train.step import make_train_step as jmake

    jlc = jinit(8, [0.5, 0.5])
    sd = {k: v.numpy() for k, v in CSNet(LC, seed=SEED, device="cpu")
          .state_dict().items() if not k.endswith("num_batches_tracked")}
    params = jax.tree.map(jnp.asarray, state_dict_to_pytree(sd))
    batch = {k: jnp.asarray(v) for k, v in csnet_batch().items()}
    logits = np.asarray(jax.jit(lambda p, v: csnet_apply(
        p, v, jlc, ApplyCtx(train=True)))(params, batch["image"]))
    trainable, state = partition(params)
    tx = joptim.make_adam_dwd(trainable)
    step = jmake(jlc, tx, flops_weight=FW, batch_size=B, donate=False)
    t, s, _, m = step(trainable, state, tx.init(trainable), batch,
                      jnp.float32(LR), jnp.float32(1.0))
    after = pytree_to_state_dict(jax.tree.map(np.asarray, merge(t, s)))
    return {"logits": logits, "loss": float(m["loss"]),
            "penalty": float(m["penalty"]),
            **{f"state/{k}": np.asarray(v) for k, v in after.items()}}


def test_csnet_2x2_forward_matches_jax_and_one_process(csnet_2x2, csnet_one,
                                                       csnet_jax):
    got = csnet_2x2["logits"]
    assert got.shape == (B, HW, HW, 1)
    np.testing.assert_allclose(got, csnet_jax["logits"], atol=5e-4)
    want = csnet_one["logits"]
    np.testing.assert_allclose(csnet_2x2["f64/logits"], want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_csnet_2x2_adam_step_matches_jax(csnet_2x2, csnet_jax):
    assert abs(csnet_2x2["loss"] - csnet_jax["loss"]) < 1e-5
    assert abs(csnet_2x2["penalty"] - csnet_jax["penalty"]) \
        / max(csnet_jax["penalty"], 1e-9) < 1e-5
    keys = [k for k in csnet_jax if k.startswith("state/")]
    assert keys and set(keys) <= set(csnet_2x2)
    for k in keys:
        want = csnet_jax[k]
        np.testing.assert_allclose(
            csnet_2x2[k], want, rtol=0,
            atol=1e-3 * max(1.0, float(np.abs(want).max())), err_msg=k)


def test_csnet_2x2_step_matches_one_process(csnet_2x2, csnet_one):
    got = {k[4:]: v for k, v in csnet_2x2.items() if k.startswith("f64/")}
    assert got["exchanges"] > 0
    assert float(got["loss"]) == pytest.approx(csnet_one["loss"], rel=1e-5)
    assert float(got["penalty"]) == pytest.approx(csnet_one["penalty"],
                                                  rel=1e-5)
    grads = [k for k in csnet_one if k.startswith("grad/")]
    assert len(grads) == len(list(CSNet(LC, device="cpu").parameters()))
    for k in grads:
        want = csnet_one[k]
        np.testing.assert_allclose(
            got[k], want, rtol=0,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-12), err_msg=k)


@pytest.fixture(scope="module")
def csf_1x2(tmp_path_factory):
    return _ranks("csf", 2, tmp_path_factory.mktemp("csf2d"))


def test_csf_1x2_micro_step_matches_jax_and_one_process(csf_1x2):
    import jax
    import jax.numpy as jnp
    import optax

    from sod100k_tpu.arch.csf_res2net import csf_apply
    from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                                state_dict_to_pytree)
    from sod100k_tpu.train.csf_step import csf_partition
    from sod100k_tpu.train.params import merge

    model = CSFNet("res2net50", seed=2, device="cpu")
    trainable, state = csf_partition(jax.tree.map(
        jnp.asarray, state_dict_to_pytree(model.state_dict())))
    batch = {k: jnp.asarray(v) for k, v in csf_batch().items()}

    def loss_fn(t):
        logits = csf_apply(merge(t, state), batch["image"], "res2net50")
        bce = optax.sigmoid_binary_cross_entropy(
            logits.astype(jnp.float32), batch["target"])
        return jnp.sum(bce) / (CSF_ITER * CSF_B)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    want = pytree_to_state_dict(jax.tree.map(np.asarray, jgrads))
    np.testing.assert_allclose(csf_1x2["loss"], float(jloss), rtol=1e-5)
    assert {f"grad/{k}" for k in want} == {k for k in csf_1x2
                                          if k.startswith("grad/")}
    for k, g in want.items():
        np.testing.assert_allclose(
            csf_1x2[f"grad/{k}"], g, rtol=1e-3,
            atol=1e-4 * max(float(np.abs(g).max()), 1.0), err_msg=k)

    one = csf_run()
    assert csf_1x2["loss"] == pytest.approx(one["loss"], rel=1e-5)
    for k, g in one.items():
        if k.startswith("grad/"):
            np.testing.assert_allclose(
                csf_1x2[k], g, rtol=0,
                atol=1e-5 * max(float(np.abs(g).max()), 1e-12), err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
