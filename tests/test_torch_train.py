"""Port parity, training: sod100k_tpu_torch's train step, penalty, optimizers
and checkpoints against the JAX package, f32 on the CPU.

The three oracles mirror tests/test_trajectory.py (which holds the JAX
package against the reference and skips without it), with the JAX package
as the oracle here, at its sizes (``init_layers(8, [0.5, 0.5])``, 16 px,
B=4) and with its comparison helpers:

1. gradients of the full training loss at identical weights: the port's
   ``loss.backward()`` inside ``make_train_step`` against ``jax.grad``,
   per-tensor L2-rel 2e-3 with the global check (``_tensors_close``);
2. optimizers fed identical gradient streams for 3 steps: parameter deltas
   within rel 1e-4 (``_delta_close``);
3. two real coupled steps of both ``make_train_step``s: losses within rel
   1e-4, deltas (BN running statistics included) within rel 3e-2. Two steps
   only: the recipe is chaotic beyond that.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_trajectory import (FW, HW, LC, LR, WD, B, _batches, _delta_close,
                             _export, _our_loss_fn, _tensors_close)

from sod100k_tpu.arch.csnet import csnet_apply, csnet_init
from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
from sod100k_tpu.interop.torch_ckpt import state_dict_to_pytree
from sod100k_tpu.ops.goct import ApplyCtx
from sod100k_tpu.ops.norm import batchnorm_train
from sod100k_tpu.train import dynamic_wd as jdwd
from sod100k_tpu.train import optim as joptim
from sod100k_tpu.train import step as jstep
from sod100k_tpu.train.params import merge, partition
from sod100k_tpu_torch.arch.csnet import CSNet, calibrate_bn
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.interop.torch_ckpt import (load_checkpoint,
                                                  state_dict_from_pytree)
from sod100k_tpu_torch.ops import dw_chain
from sod100k_tpu_torch.ops.goct import GapCollector, bn_paths
from sod100k_tpu_torch.prune import build_pruned_csnet
from sod100k_tpu_torch.train import checkpoint, dynamic_wd, optim
from sod100k_tpu_torch.train.step import (make_eval_step, make_train_step,
                                          quantized_mae)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT_LC = init_layers(8, (0.5, 0.5))


@pytest.fixture(scope="module")
def params0():
    return jax.tree.map(np.asarray, csnet_init(jax.random.key(11), LC))


def _port(params) -> CSNet:
    model = CSNet(PORT_LC, device="cpu")
    model.load_state_dict(state_dict_from_pytree(params), strict=True)
    return model


def _port_sd(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _batch(img, gt) -> dict:
    return {"image": img, "target": gt}


def test_train_batchnorm_matches_batchnorm_train():
    """``nn.BatchNorm2d`` in train mode is the JAX package's
    ``batchnorm_train``: batch statistics over (N, H, W) in f32, unbiased
    running variance, momentum 0.1. f32 within 1e-5; a bf16 input with f32
    parameters gives bf16 out (within one bf16 ulp) and f32 gradients."""
    rng = np.random.default_rng(0)
    c = 6
    x = rng.standard_normal((3, c, 5, 7)).astype(np.float32) * 2 + 0.5
    p = {"scale": rng.random(c).astype(np.float32) + 0.5,
         "offset": rng.standard_normal(c).astype(np.float32),
         "mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.random(c).astype(np.float32) + 0.5}
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        bn = torch.nn.BatchNorm2d(c, eps=1e-5)
        with torch.no_grad():
            for name, k in (("weight", "scale"), ("bias", "offset"),
                            ("running_mean", "mean"), ("running_var", "var")):
                getattr(bn, name).copy_(torch.from_numpy(p[k]))
        xt = torch.from_numpy(x).to(dtype)
        y = bn(xt)
        y.float().sum().backward()
        want, stats = batchnorm_train(
            jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdtype), p)
        assert y.dtype == dtype and bn.weight.grad.dtype == torch.float32
        np.testing.assert_allclose(
            y.detach().float().numpy().transpose(0, 2, 3, 1),
            np.asarray(want, np.float32), rtol=tol, atol=tol)
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("basewidth,split", [
    (8, (0.5, 0.5)), (40, (0.5, 0.5)), (9, (1 / 3, 1 / 3, 1 / 3)),
    (16, (1.0,))])
@pytest.mark.parametrize("expand", [2.0, 1.5])
def test_flop_weight_map_matches_jax(basewidth, split, expand):
    got = dynamic_wd.flop_weight_map(init_layers(basewidth, split), expand)
    want = jdwd.flop_weight_map(jinit_layers(basewidth, list(split)), expand)
    assert list(got.items()) == list(want.items())


def test_gap_and_penalty_match_jax(params0):
    """The collector's signal equals ``ApplyCtx.gap`` path by path: max |d|
    below 1e-3 of the path's largest value (f32 noise grows with depth in
    the x100 net: measured 8e-7 at stage0, 7e-5 at stage4). ``penalty`` on
    the JAX gap equals ``dynamic_wd.penalty`` (rel 1e-5)."""
    (img, _), = _batches(B, HW, 1)
    trainable, state = partition(jax.tree.map(jnp.asarray, params0))
    jgap = jax.jit(_gap_of)(merge(trainable, state), jnp.asarray(img))

    model = _port(params0)
    model.train()
    gap = GapCollector(bn_paths(model))
    with torch.no_grad():
        model(torch.from_numpy(img), gap)
    assert set(gap.gap) == set(jgap)
    for path, want in jgap.items():
        got = gap.gap[path]
        assert got.dtype == torch.float32 and not got.requires_grad
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() < 1e-3 * np.abs(want).max(), \
            path

    fw = dynamic_wd.flop_weight_map(PORT_LC, 2.0)
    want = float(jdwd.penalty(trainable, jgap, jdwd.flop_weight_map(LC, 2.0),
                              B))
    got = dynamic_wd.penalty(
        dynamic_wd.penalty_terms(model, fw),
        {k: torch.from_numpy(np.array(v)) for k, v in jgap.items()}, B).item()
    assert want > 0 and got == pytest.approx(want, rel=1e-5)


def _gap_of(params, x):
    ctx = ApplyCtx(train=True, collect_gap=True)
    csnet_apply(params, x, LC, ctx)
    return ctx.gap


def test_eval_forward_refuses_a_collector(params0):
    model = _port(params0)
    model.eval()
    with pytest.raises(ValueError, match="train-mode"):
        model(torch.zeros(1, HW, HW, 3), GapCollector(bn_paths(model)))


def test_gradients_match_jax_grad(params0):
    """The port's backward of the full training loss (BCE + FW * penalty)
    against ``jax.grad`` of the JAX step's loss, per tensor."""
    (img, gt), = _batches(B, HW, 1)
    model = _port(params0)
    # lr 0 and no momentum: the step leaves the weights and keeps the grads
    step = make_train_step(model, optim.make_sgd(model, momentum=0.0),
                           flops_weight=FW, batch_size=B)
    m = step(_batch(img, gt), 0.0, 1.0)
    tgrads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}

    trainable, state = partition(jax.tree.map(jnp.asarray, params0))
    batch = {"image": jnp.asarray(img), "target": jnp.asarray(gt)}
    jloss, jgrads = jax.jit(jax.value_and_grad(_our_loss_fn))(
        trainable, state, batch)
    jgrads = _export(jgrads)

    got_loss = float(m["loss"]) + FW * float(m["penalty"])
    assert got_loss == pytest.approx(float(jloss), rel=1e-5)
    assert set(jgrads) == set(tgrads)
    _tensors_close(jgrads, tgrads, rtol=2e-3, what="grad")


OPTIMIZERS = {
    "adam_dwd": (lambda m: optim.make_adam_dwd(m, weight_decay=WD),
                 lambda t: joptim.make_adam_dwd(t, weight_decay=WD)),
    "adam_dwd_fixed": (
        lambda m: optim.make_adam_dwd(m, weight_decay=WD,
                                      decay_conv3x3_2=False),
        lambda t: joptim.make_adam_dwd(t, weight_decay=WD,
                                       decay_conv3x3_2=False)),
    "adam": (lambda m: optim.make_adam(m, weight_decay=WD),
             lambda t: joptim.make_adam(weight_decay=WD)),
    "sgd": (lambda m: optim.make_sgd(m, momentum=0.9, weight_decay=WD),
            lambda t: joptim.make_sgd(momentum=0.9, weight_decay=WD)),
}


@pytest.mark.parametrize("method", list(OPTIMIZERS))
def test_optimizer_matches_jax_on_identical_grads(params0, method):
    """The same synthetic gradient stream into the port's optimizer and the
    JAX package's transform: parameters track within rel 1e-4."""
    make_port, make_jax = OPTIMIZERS[method]
    model = _port(params0)
    opt = make_port(model)
    trainable, state = partition(jax.tree.map(jnp.asarray, params0))
    tx = make_jax(trainable)
    opt_state = tx.init(trainable)

    # eager: compiling the transform over ~300 leaves costs more than
    # three steps of it
    def apply(trainable, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, trainable)
        updates = jax.tree.map(lambda u: u * LR, updates)
        return optax.apply_updates(trainable, updates), opt_state

    names = [n for n, _ in model.named_parameters()]
    for step_i in range(3):
        rng = np.random.default_rng(1000 + step_i)
        gsd = {n: rng.standard_normal(p.shape).astype(np.float32) * 1e-2
               for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(gsd[n].copy())
        optim.set_lr(opt, LR)
        opt.step()
        trainable, opt_state = apply(
            trainable, opt_state,
            jax.tree.map(jnp.asarray, state_dict_to_pytree(gsd)))

    init_sd = _export(params0)
    got = _port_sd(model)
    want = _export(merge(trainable, state))
    _delta_close({k: init_sd[k] for k in names}, {k: want[k] for k in names},
                 {k: got[k] for k in names}, rtol=1e-4)


@pytest.mark.parametrize("decay_conv3x3_2", [True, False])
def test_wd_exempt_set_matches_jax_mask(params0, decay_conv3x3_2):
    trainable, _ = partition(params0)
    mask = joptim._wd_mask(trainable, decay_conv3x3_2)
    exempt = []

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            elif not v:
                exempt.append(path.removesuffix(".scale") + ".weight")

    walk(mask, "")
    model = _port(params0)
    got = optim.wd_exempt(model, decay_conv3x3_2)
    assert sorted(got) == sorted(exempt)
    groups = optim.make_adam_dwd(model, decay_conv3x3_2=decay_conv3x3_2) \
        .param_groups
    params = dict(model.named_parameters())
    assert [id(p) for p in groups[1]["params"]] == \
        [id(params[n]) for n in got]
    assert groups[0]["weight_decay"] == 5e-3 and groups[1]["weight_decay"] == 0


def test_lr_schedules_match_jax():
    for epoch in range(0, 31):
        for steps in ([10, 20], [1], [5, 5, 25]):
            assert optim.multistep_lr(1e-3, steps, epoch) == \
                joptim.multistep_lr(1e-3, steps, epoch)
        assert optim.cosine_lr(1e-3, epoch, 25, 1e-6) == \
            joptim.cosine_lr(1e-3, epoch, 25, 1e-6)
    # the step-at-epoch-start quirk: milestone 10 already holds at epoch 9
    assert optim.multistep_lr(1.0, [10, 20], 8) == 1.0
    assert optim.multistep_lr(1.0, [10, 20], 9) == pytest.approx(0.1)
    assert optim.multistep_lr(1.0, [10, 20], 19) == pytest.approx(0.01)
    assert optim.cosine_lr(1.0, 40, 25) == 0.0  # clamped past the end


def test_quantized_mae_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.random((3, 20, 20, 1)).astype(np.float32)
    gt = (rng.random((3, 20, 20, 1)) > 0.5).astype(np.float32)
    got = float(quantized_mae(torch.from_numpy(pred), torch.from_numpy(gt)))
    want = float(jstep.quantized_mae(jnp.asarray(pred), jnp.asarray(gt)))
    assert got == pytest.approx(want, rel=1e-6)


def test_two_coupled_steps_match_jax(params0):
    """Two real SGD steps of both packages' ``make_train_step`` from the
    same weights: per-step losses within rel 1e-4, deltas of every
    parameter and BN running statistic within rel 3e-2. (Adam is held on
    identical gradients above: on coupled steps it turns engine noise in
    near-zero gradients into sign flips of whole lr-sized updates.)"""
    batches = _batches(B, HW, 2)
    model = _port(params0)
    step = make_train_step(model, optim.make_sgd(model, momentum=0.9),
                           flops_weight=FW, flops_expand=2.0, batch_size=B)
    port_losses = [float(step(_batch(img, gt), LR, 1.0)["loss"])
                   for img, gt in batches]

    trainable, state = partition(jax.tree.map(jnp.asarray, params0))
    tx = joptim.make_sgd(momentum=0.9)
    opt_state = tx.init(trainable)
    jax_step = jstep.make_train_step(LC, tx, flops_weight=FW,
                                     flops_expand=2.0, batch_size=B,
                                     donate=False)
    jax_losses = []
    for img, gt in batches:
        batch = {"image": jnp.asarray(img), "target": jnp.asarray(gt)}
        trainable, state, opt_state, m = jax_step(
            trainable, state, opt_state, batch, jnp.float32(LR),
            jnp.float32(1.0))
        jax_losses.append(float(m["loss"]))

    for k in range(2):
        assert port_losses[k] == pytest.approx(jax_losses[k], rel=1e-4), k
    _delta_close(_export(params0), _export(merge(trainable, state)),
                 _port_sd(model), rtol=3e-2)


def _u8_batches(k, n=B, hw=HW, seed0=200):
    out = []
    for i in range(k):
        rng = np.random.default_rng(seed0 + i)
        img = rng.integers(0, 256, (n, hw, hw, 3), np.uint8)
        gt = (rng.random((n, hw, hw, 1)) > 0.5).astype(np.uint8) * 255
        out.append((img, gt))
    return out


def test_bf16_u8_step_runs_near_f32(params0):
    """The hybrid mode: u8 image and target, bf16 compute. Its first loss
    is within 5% of the f32 step's on the same weights and batch; the
    parameters and their gradients stay f32."""
    (img, gt), = _u8_batches(1)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _port(params0)
        step = make_train_step(model, optim.make_adam_dwd(model),
                               flops_weight=FW, batch_size=B,
                               compute_dtype=dtype, from_u8=True)
        m = step(_batch(img, gt), LR, 1.0)
        assert np.isfinite(float(m["loss"])) and float(m["penalty"]) > 0
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        losses[dtype] = float(m["loss"])
    assert losses[torch.bfloat16] == pytest.approx(losses[torch.float32],
                                                   rel=0.05)


def test_resume_equals_an_uninterrupted_run(params0, tmp_path):
    """Save after one step, resume into a new model and optimizer: the
    state loads bit for bit and the next step equals the uninterrupted
    run's, bit for bit."""
    b1, b2 = _u8_batches(2)
    model = _port(params0)
    opt = optim.make_adam_dwd(model)
    step = make_train_step(model, opt, flops_weight=FW, batch_size=B,
                           from_u8=True)
    step(_batch(*b1), LR, 1.0)
    path = str(tmp_path / "ck.pth.tar")
    checkpoint.save_checkpoint(path, model, opt, epoch=1)
    saved_model = copy.deepcopy(model.state_dict())
    saved_opt = copy.deepcopy(opt.state_dict())
    want = float(step(_batch(*b2), LR, 1.0)["loss"])

    other = CSNet(PORT_LC, seed=7, device="cpu")
    other_opt = optim.make_adam_dwd(other)
    assert checkpoint.resume(path, other, other_opt, map_location="cpu") == 1
    for k, v in saved_model.items():
        assert torch.equal(other.state_dict()[k], v), k
    got_opt = other_opt.state_dict()
    assert got_opt["param_groups"] == saved_opt["param_groups"]
    for i, st in saved_opt["state"].items():
        for k, v in st.items():
            assert torch.equal(got_opt["state"][i][k], v), (i, k)
    other_step = make_train_step(other, other_opt, flops_weight=FW,
                                 batch_size=B, from_u8=True)
    got = float(other_step(_batch(*b2), LR, 1.0)["loss"])
    assert got == want
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k

    _, meta = load_checkpoint(path, map_location="cpu")
    assert meta["arch"] == "csnet" and set(meta) == {"epoch", "arch",
                                                     "optimizer"}
    # a checkpoint without a torch optimizer's state: the model alone
    torch.save({"epoch": 3, "arch": "csnet",
                "state_dict": saved_model, "optimizer": {"mu": [1.0]}}, path)
    with pytest.raises(ValueError, match="no torch optimizer state"):
        checkpoint.resume(path, other, other_opt, map_location="cpu")
    assert checkpoint.resume(path, other, map_location="cpu") == 3


@pytest.mark.parametrize("foreach", [False, True])
def test_eval_after_train_steps_equals_a_fresh_load(params0, foreach):
    """Eval (packs built), train steps that update the weights in place
    (Adam, single-tensor or foreach) and the BN statistics, then eval again
    through an eval step made before the training: the tail packs are
    rebuilt, and the result equals a fresh model loaded with the same
    state_dict, bit for bit."""
    model = _port(params0)
    (img, _), = _batches(B, HW, 1, seed0=300)
    calibrate_bn(model, torch.from_numpy(img))
    x = torch.from_numpy(img[:2])
    evaluate = make_eval_step(model)
    evaluate(x)
    opt = torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.99),
                           foreach=foreach)
    step = make_train_step(model, opt, flops_weight=FW, batch_size=B)
    for img, gt in _batches(B, HW, 3, seed0=310):
        step(_batch(img, gt), LR, 1.0)
    before = dw_chain.packs_built
    got = evaluate(x)
    assert not model.training
    assert dw_chain.packs_built - before == 18  # every tail repacked
    fresh = CSNet(PORT_LC, device="cpu")
    fresh.load_state_dict(model.state_dict(), strict=True)
    want = make_eval_step(fresh)(x)
    assert np.isfinite(got.numpy()).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_entry_points_default_to_the_card():
    """The model, the slim-model builder and the checkpoint loaders build
    on the card unless the caller names the CPU."""
    for fn in (CSNet, build_pruned_csnet):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (load_checkpoint, checkpoint.resume):
        assert inspect.signature(fn).parameters["map_location"].default \
            == "cuda"
