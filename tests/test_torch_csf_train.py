"""Port parity, CSF+Res2Net training: the train step, the optimizer with
gradient accumulation, the freeze set, the .lst datasets and the resident
CSF epoch against the JAX package, f32 on the CPU.

1. Gradients: one jitted ``jax.value_and_grad`` of the JAX step's loss
   (``sum(BCE * mask) / (iter_size * batch)`` over ``csf_apply``, w.r.t.
   ``csf_partition``'s trainable leaves) against the port's micro-step, on
   the reference init and on He-scale backbone weights, at an odd size with
   a mask over part of the image: loss rel 1e-5, gradients within L2-rel
   2e-3 globally and per tensor (floor 1e-6 of the global norm).
2. Adam with coupled L2 and summed micro-gradients applied every
   ``iter_size``-th step, fed the port's own per-micro-step gradients,
   against optax's ``MultiSteps(use_grad_mean=False)`` of the JAX
   package's ``make_csf_optimizer``: parameters within 1e-6 after every
   micro-step; frozen tensors and BN statistics bit-unchanged.
3. The datasets read files that cv2 wrote, against the JAX package's
   readers (cv2 serves only them), and the resident epoch fed the JAX
   package's draws against the JAX epoch and the port's own step loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_csf import he_scale_state

from sod100k_tpu.arch.csf_res2net import csf_apply, csf_init
from sod100k_tpu.data import csf_dataset as jds
from sod100k_tpu.data import resident as jresident
from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                            state_dict_to_pytree)
from sod100k_tpu.train import csf_step as jstep
from sod100k_tpu.train.params import merge
from sod100k_tpu_torch.arch.csf_res2net import CSFNet
from sod100k_tpu_torch.data import csf_dataset as ds
from sod100k_tpu_torch.data.resident import (build_resident_dataset,
                                             make_resident_csf_epoch_fn)
from sod100k_tpu_torch.train.csf_step import (bce2d, freeze_reference_params,
                                              is_frozen, make_csf_optimizer,
                                              make_csf_train_step)

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _l2(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def _model(state=None) -> CSFNet:
    model = CSFNet("res2net50", seed=0, device="cpu")
    if state is not None:
        model.load_state_dict(state, strict=True)
    freeze_reference_params(model)
    return model


def _trainable(model) -> dict:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _batch(n, hw, seed, masked=True):
    rng = np.random.default_rng(seed)
    b = {"image": rng.standard_normal((n, *hw, 3), dtype=np.float32),
         "target": (rng.random((n, *hw, 1)) > 0.5).astype(np.float32)}
    if masked:  # the padded bottom-right of a bucket
        mask = np.zeros((n, *hw, 1), np.float32)
        mask[:, :hw[0] - 7, :hw[1] - 9] = 1.0
        b["mask"] = mask
    return b


def test_trainable_names_match_csf_partition():
    """The port freezes what ``csf_partition`` moves to the state: the
    top bn1, every block's bn1/bns/bn3 affine and the downsample conv; the
    downsample BN and the stem BNs train."""
    shapes = jax.eval_shape(lambda: csf_init(jax.random.key(0)))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    trainable, _ = jstep.csf_partition(tree)
    want = set(pytree_to_state_dict(trainable))
    model = CSFNet("res2net50", device="cpu")
    frozen = freeze_reference_params(model)
    got = set(_trainable(model))
    assert got == want
    assert len(got) == len(jax.tree.leaves(trainable))
    assert set(frozen) == {n for n, _ in model.named_parameters()} - want
    assert is_frozen("base.layer2.0.downsample.1.weight")
    assert not is_frozen("base.layer2.0.downsample.2.weight")
    assert not is_frozen("base.conv1.1.weight")
    assert is_frozen("base.layer3.4.bns.2.bias")
    assert not is_frozen("fuse.bns.0.weight")


# ---------------------------------------------------------------------------
# gradients

GRAD_HW = (37, 45)
GRAD_B = 2
ITER = 2


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """One jit of the JAX step's loss and its gradient w.r.t. the
    trainable leaves (``make_csf_train_step``'s ``loss_fn``)."""

    def loss_fn(trainable, state, image, target, mask):
        logits = csf_apply(merge(trainable, state), image).astype(jnp.float32)
        bce = optax.sigmoid_binary_cross_entropy(logits, target) * mask
        return jnp.sum(bce) / (ITER * GRAD_B)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("weights", ["reference", "he_scale"])
def test_micro_step_gradients_match_jax(jax_value_and_grad, weights):
    """The He-scale weights' seed leaves no pre-ReLU value within f32
    rounding of zero: with seed 21 one value of 1.1e-7 takes the other
    side of its ReLU in one f32 engine than in the other (and than in
    f64), which moves layer3's gradients by up to 4e-3 L2-rel."""
    model = _model()
    if weights == "he_scale":
        model.load_state_dict(he_scale_state(model, 24), strict=True)
    trainable, state = jstep.csf_partition(
        state_dict_to_pytree(model.state_dict()))
    b = _batch(GRAD_B, GRAD_HW, seed=22)
    want_loss, grads = jax_value_and_grad(
        trainable, state, *(jnp.asarray(b[k])
                            for k in ("image", "target", "mask")))
    want = pytree_to_state_dict(jax.tree.map(np.asarray, grads))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_csf_train_step(model, make_csf_optimizer(model),
                               iter_size=ITER, batch_size=GRAD_B)
    loss = step(b, 5e-5)["loss"].item()
    # micro-step 1 of 2: the gradients wait, nothing moved
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    got = {n: p.grad.numpy() for n, p in _trainable(model).items()}
    assert set(got) == set(want)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    gnorm = np.sqrt(sum(_l2(v) ** 2 for v in want.values()))
    total = 0.0
    for k, v in want.items():
        err = _l2(got[k] - v)
        total += err ** 2
        assert err / max(_l2(v), 1e-6 * gnorm) < 2e-3, k
    assert np.sqrt(total) / gnorm < 2e-3
    if weights == "he_scale":  # the backbone's gradients are not vanishing
        assert _l2(want["base.layer1.0.conv1.weight"]) > 1e-4 * gnorm


def test_remat_gives_the_plain_gradients():
    model = _model()
    b = _batch(1, (32, 32), seed=23)
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        step = make_csf_train_step(model, make_csf_optimizer(model),
                                   iter_size=2, remat=remat)
        step(b, 5e-5)
        grads.append({n: p.grad.clone()
                      for n, p in _trainable(model).items()})
    for k, v in grads[0].items():
        torch.testing.assert_close(grads[1][k], v, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# the optimizer with accumulation


def test_adam_with_accumulation_matches_optax():
    """Four micro-steps at iter_size 2, lr 1e-3: the port's parameters
    after each against optax fed the gradients the port's own backward
    produced (tensor hooks record each micro-step's contribution)."""
    lr = 1e-3
    model = _model()
    opt = make_csf_optimizer(model)
    step = make_csf_train_step(model, opt, iter_size=2, batch_size=1)
    frozen_before = {k: v.clone() for k, v in model.state_dict().items()
                     if not (k in _trainable(model))}
    streams: dict = {}
    for n, p in _trainable(model).items():
        p.register_hook(lambda g, n=n: streams.__setitem__(n, g.numpy().copy()))
    params0 = {n: p.detach().numpy().copy()
               for n, p in _trainable(model).items()}

    tx = jstep.make_csf_optimizer(weight_decay=5e-4, iter_size=2)
    want = jax.tree.map(jnp.asarray, params0)
    opt_state = tx.init(want)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(
            params, jax.tree.map(lambda u: u * lr, updates)), opt_state

    prev = params0
    for k in range(4):
        step(_batch(1, (32, 32), seed=30 + k), lr)
        want, opt_state = update(jax.tree.map(jnp.asarray, streams),
                                 opt_state, want)
        got = {n: p.detach().numpy().copy()
               for n, p in _trainable(model).items()}
        moved = max(float(np.abs(got[n] - prev[n]).max()) for n in got)
        assert (moved > 1e-4) == (k % 2 == 1), (k, moved)
        prev = got
        err = max(float(np.abs(got[n] - np.asarray(want[n])).max())
                  for n in got)
        assert err <= 1e-6, (k, err)
    # frozen parameters and every BN statistic are bit-unchanged
    for k, v in model.state_dict().items():
        if k in frozen_before:
            assert torch.equal(v, frozen_before[k]), k


def test_restart_optimizer_gives_fresh_moments():
    model = _model()
    step = make_csf_train_step(model, make_csf_optimizer(model, 1e-3),
                               iter_size=2)
    b = _batch(1, (32, 32), seed=40)
    for _ in range(3):  # one apply, then a pending micro-step
        step(b, 1e-3)
    assert step.micro == 1 and step.optimizer.state
    old = step.optimizer
    step.restart_optimizer()
    assert step.optimizer is not old and not step.optimizer.state
    assert step.micro == 0
    assert all(p.grad is None for p in model.parameters())
    assert [g["weight_decay"] for g in step.optimizer.param_groups] == [1e-3]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(b, 1e-4)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    step(b, 1e-4)
    assert not all(torch.equal(p, before[n])
                   for n, p in model.named_parameters())


def test_bf16_u8_step_keeps_f32_state():
    model = _model()
    opt = make_csf_optimizer(model)
    step = make_csf_train_step(model, opt, iter_size=1, batch_size=2,
                               compute_dtype=torch.bfloat16, from_u8=True)
    rng = np.random.default_rng(41)
    b = {"image": rng.integers(0, 256, (2, 32, 32, 3), np.uint8),
         "target": ((rng.random((2, 32, 32, 1)) > 0.5) * 255).astype(np.uint8)}
    loss = step(b, 1e-4)["loss"]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for s in opt.state.values()
               for k, v in s.items() if k != "step")


def test_bce2d_matches_jax():
    rng = np.random.default_rng(42)
    logits = rng.standard_normal((2, 9, 11, 1), dtype=np.float32) * 3
    target = (rng.random((2, 9, 11, 1)) > 0.7).astype(np.float32)
    for red in ("none", "mean", "sum"):
        got = bce2d(torch.from_numpy(logits), torch.from_numpy(target),
                    reduction=red).numpy()
        want = np.asarray(jstep.bce2d(jnp.asarray(logits),
                                      jnp.asarray(target), reduction=red))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        bce2d(torch.from_numpy(logits), torch.from_numpy(target), "max")


# ---------------------------------------------------------------------------
# the .lst datasets

SIZES = [(37, 45), (40, 31), (33, 47), (64, 20), (29, 30)]


@pytest.fixture(scope="module")
def csf_root(tmp_path_factory):
    """images/*.png, gt/*.png and edge/*.png written by cv2 at SIZES, with
    train.lst ("img gt"), joint.lst ("img gt edge") and test.lst. Pair 1's
    GT is colour (BGR) and pair 3's 16-bit: the edges of the envelope."""
    root = tmp_path_factory.mktemp("csf")
    for d in ("images", "gt", "edge"):
        (root / d).mkdir()
    rng = np.random.default_rng(50)
    lines, joint = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        gt = ((rng.random((h, w)) > 0.5) * 255).astype(np.uint8)
        if i == 1:
            gt = rng.integers(0, 256, (h, w, 3), np.uint8)
        elif i == 3:
            gt = rng.integers(0, 65536, (h, w), np.uint16)
        edge = ((rng.random((h, w)) > 0.8) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "images" / f"{i}.png"), img)
        cv2.imwrite(str(root / "gt" / f"{i}.png"), gt)
        cv2.imwrite(str(root / "edge" / f"{i}.png"), edge)
        lines.append(f"images/{i}.png gt/{i}.png")
        joint.append(f"images/{i}.png gt/{i}.png edge/{i}.png")
    (root / "train.lst").write_text("\n".join(lines) + "\n")
    (root / "eight_bit.lst").write_text(
        "\n".join(lines[i] for i in (0, 2, 4)) + "\n")
    (root / "joint.lst").write_text("\n".join(joint) + "\n")
    (root / "test.lst").write_text(
        "\n".join(f"images/{i}.png" for i in range(len(SIZES))) + "\n")
    return root


def _same(got: dict, want: dict, keys, atol=0.0):
    for k in keys:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)


def test_train_and_joint_data_match_jax(csf_root):
    """Same samples, flip draws included, bit for bit."""
    r, lst = str(csf_root), str(csf_root / "train.lst")
    got, want = ds.CSFTrainData(r, lst, seed=3), jds.CSFTrainData(r, lst,
                                                                   seed=3)
    assert len(got) == len(want) == len(SIZES)
    for _ in range(2):
        for i in range(len(got)):
            _same(got[i], want[i], ("image", "target"))
    for i in range(len(got)):
        for a, b in zip(got._decode_u8(i), want._decode_u8(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[3]["target"].max() > 1.0  # 16 bits kept, still / 255
    jl = str(csf_root / "joint.lst")
    got, want = ds.CSFJointTrainData(r, jl, seed=4), jds.CSFJointTrainData(
        r, jl, seed=4)
    for i in range(len(got)):
        _same(got[i], want[i], ("image", "target", "edge"))


def test_test_data_and_caffe_loader_match_jax(csf_root):
    r, lst = str(csf_root), str(csf_root / "test.lst")
    got, want = ds.CSFTestData(r, lst), jds.CSFTestData(r, lst)
    for i in range(len(got)):
        a, b = got[i], want[i]
        _same(a, b, ("image",))
        assert a["name"] == b["name"] and tuple(a["size"]) == tuple(b["size"])
        a, b = got.get_u8(i), want.get_u8(i)
        _same(a, b, ("image",))
        assert tuple(a["size"]) == tuple(b["size"])
        path = str(csf_root / "images" / f"{i}.png")
        np.testing.assert_array_equal(ds.load_image_caffe(path),
                                      jds.load_image_caffe(path))


@pytest.mark.parametrize("batch_size,bucket,shuffle", [(2, 32, True),
                                                       (1, 16, False),
                                                       (3, 64, True)])
def test_padded_batches_match_jax(csf_root, batch_size, bucket, shuffle):
    r, lst = str(csf_root), str(csf_root / "train.lst")
    got = list(ds.padded_batches(ds.CSFTrainData(r, lst, seed=5),
                                 batch_size, bucket=bucket, shuffle=shuffle,
                                 seed=6))
    want = list(jds.padded_batches(jds.CSFTrainData(r, lst, seed=5),
                                   batch_size, bucket=bucket,
                                   shuffle=shuffle, seed=6))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b, ("image", "target", "mask"))
    assert ds.bucket_hw(37, 45, 32) == jds.bucket_hw(37, 45, 32) == (64, 64)


def test_fixed_size_batches_match_jax(csf_root):
    """cv2's float INTER_LINEAR on the JAX side, the port's within 2 f32
    ulp of it."""
    r, lst = str(csf_root), str(csf_root / "eight_bit.lst")
    got = list(ds.fixed_size_batches(ds.CSFTrainData(r, lst, seed=7), 2,
                                     (24, 28), seed=8))
    want = list(jds.fixed_size_batches(jds.CSFTrainData(r, lst, seed=7), 2,
                                       (24, 28), seed=8))
    assert len(got) == len(want) == 1
    _same(got[0], want[0], ("image", "target"), atol=2e-6)


# ---------------------------------------------------------------------------
# the resident CSF epoch

STORE_HW = (32, 40)


def test_resident_store_matches_jax(csf_root):
    d = ds.CSFTrainData(str(csf_root), str(csf_root / "eight_bit.lst"))
    got = build_resident_dataset(d, STORE_HW, device="cpu")
    want = jresident.build_resident_dataset(jds.CSFTrainData(
        str(csf_root), str(csf_root / "eight_bit.lst")), STORE_HW)
    for k in ("image_u8", "gt_u8"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _jax_draws(key, n, bs):
    """The JAX epoch's permutation and flips for ``key``."""
    kperm, kflip = jax.random.split(key)
    nb = n // bs
    perm = np.array(jax.random.permutation(kperm, n)[:nb * bs])
    return (perm.reshape(nb, bs),
            np.array(jax.random.bernoulli(kflip, 0.5, (nb, bs))))


def test_resident_epoch_fed_jax_draws_matches_jax_epoch(csf_root):
    """Both epochs with a checksum step that sees pixel positions (a wrong
    flip axis, normalization or gather changes it)."""
    lst = str(csf_root / "eight_bit.lst")
    store = build_resident_dataset(ds.CSFTrainData(str(csf_root), lst),
                                   STORE_HW, device="cpu")
    jstore = {k: jnp.asarray(v.numpy()) for k, v in store.items()}
    bs, key = 1, jax.random.key(7)
    col = np.arange(STORE_HW[1], dtype=np.float32)

    def jstep_fn(t, s, o, batch, lr):
        c = jnp.asarray(col)
        loss = (jnp.sum(batch["image"] * c[None, None, :, None])
                + jnp.sum(batch["target"][..., 0] * c[None, None, :]))
        return t, o, {"loss": loss}

    _, _, want = jresident.make_resident_csf_epoch_fn(
        jstep_fn, batch_size=bs)({"w": jnp.zeros(())}, {},
                                 {"m": jnp.zeros(())}, jstore, key,
                                 jnp.float32(0.0))
    tcol = torch.from_numpy(col)

    def step_fn(batch, lr):
        return {"loss": (batch["image"] * tcol[None, None, :, None]).sum()
                + (batch["target"][..., 0] * tcol[None, None, :]).sum()}

    perm, flips = _jax_draws(key, 3, bs)
    assert flips.any() and not flips.all()
    got = make_resident_csf_epoch_fn(step_fn, batch_size=bs)(
        store, None, 0.0, draws=(perm, flips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


class _Tiny(torch.nn.Module):
    """A 1x1 conv with bias, NHWC in and out: a stand-in CSF model."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(3, 1, generator=g))
        self.b = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x @ self.w + self.b


def test_resident_epoch_equals_the_step_loop(csf_root):
    """The epoch fed the JAX draws equals a host loop (numpy gather, flip,
    normalization) into the same step, losses and parameters bit for bit;
    the port's own draws repeat for one generator seed."""
    from sod100k_tpu_torch.data.pipeline import normalize_u8

    d = ds.CSFTrainData(str(csf_root), str(csf_root / "eight_bit.lst"))
    store = build_resident_dataset(d, STORE_HW, device="cpu")
    perm, flips = _jax_draws(jax.random.key(9), 3, 1)

    def run(epoch: bool):
        m = _Tiny()
        step = make_csf_train_step(m, make_csf_optimizer(m), iter_size=2)
        if epoch:
            losses = make_resident_csf_epoch_fn(step, batch_size=1)(
                store, None, 1e-2, draws=(perm, flips))
            return losses, m
        imgs, gts = store["image_u8"].numpy(), store["gt_u8"].numpy()
        losses = []
        for idxs, fl in zip(perm, flips):
            img, gt = imgs[idxs], gts[idxs]
            img = np.where(fl[:, None, None, None], img[:, :, ::-1], img)
            gt = np.where(fl[:, None, None], gt[:, :, ::-1], gt)
            batch = {"image": normalize_u8(torch.from_numpy(img)),
                     "target": torch.from_numpy(gt).float()[..., None] / 255}
            losses.append(step(batch, 1e-2)["loss"])
        return torch.stack(losses), m

    (a, ma), (b, mb) = run(True), run(False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for p, q in zip(ma.parameters(), mb.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)

    def own(seed):
        m = _Tiny()
        step = make_csf_train_step(m, make_csf_optimizer(m), iter_size=1)
        g = torch.Generator().manual_seed(seed)
        return make_resident_csf_epoch_fn(step, batch_size=1)(store, g, 1e-2)

    first = own(3)
    assert first.shape == (3,) and torch.isfinite(first).all()
    torch.testing.assert_close(own(3), first, rtol=0, atol=0)
