"""Port parity, data parallelism: sod100k_tpu_torch.parallel against one
process at the global batch, and against the JAX package, f32 on the CPU.

Two real processes (gloo over 127.0.0.1) run this file as a script,
joined through the SOD100K_* variables exactly as the drivers are
(``parallel.multihost.init_from_env``), each feeding its rows of a
deterministic global batch, and print a JSON line that the test holds
against this process's single-process result:

1. ``GlobalBatchNorm2d``: at world size 1 it is ``nn.BatchNorm2d`` bit for
   bit (forward, gradients, running statistics); at world size 2 it equals
   ``nn.BatchNorm2d`` over the global batch within atol 1e-6 (f32 sums in
   another order; the one-pass variance).
2. The CSNet train step (``init_layers(8, [0.5, 0.5])``, 32^2, global B=8 as
   4 + 4, penalty on, SGD with momentum 0.9, 2 steps): the JAX multi-host
   oracle's bars (``tests/test_multihost.py:102-104``) against the port's
   single process: first loss rel 1e-5, second rel 1e-4, parameter
   checksum rel 1e-4; and against the JAX package's single-process
   ``make_train_step`` from the same weights at ``test_torch_train.py``'s
   coupled-step bars (losses rel 1e-4, every delta within L2-rel 3e-2).
   SGD, as the JAX oracle: linear in the gradients, so reduction-order
   noise stays at f32 level, where Adam turns it into sign flips of
   lr-sized updates.
3. The CSF step (Res2Net-50 at 64^2, B=1 per rank, iter_size 2, plain SGD
   with coupled L2 for the same reason): parameter deltas within L2-rel
   1e-5 of the single process at B=2, per tensor with the global floor.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sod100k_tpu_torch.arch.csf_res2net import CSFNet
from sod100k_tpu_torch.arch.csnet import CSNet
from sod100k_tpu_torch.arch.layer_config import init_layers
from sod100k_tpu_torch.ops.norm import GlobalBatchNorm2d, convert_global_bn
from sod100k_tpu_torch.parallel import mesh, multihost
from sod100k_tpu_torch.train.csf_step import (CSFTrainStep,
                                              freeze_reference_params)
from sod100k_tpu_torch.train.optim import make_sgd
from sod100k_tpu_torch.train.step import make_train_step

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))

LC = init_layers(8, (0.5, 0.5))
HW, B, STEPS, LR, FW = 32, 8, 2, 1e-3, 3.0
# test_torch_train.py's size, where its one-step bars hold for f32 engines
JAX_HW, JAX_B = 16, 4
CSF_HW, CSF_ITER, CSF_LR, CSF_WD = 64, 2, 1e-2, 5e-4
BN_SHAPE = (6, 5, 7, 9)  # global N, C, H, W


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_env(port: int, pid: int, n: int = 2) -> dict:
    """The SOD100K_* variables of process ``pid`` of ``n`` (CPU only)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["SOD100K_COORDINATOR"] = f"127.0.0.1:{port}"
    env["SOD100K_NUM_PROCESSES"] = str(n)
    env["SOD100K_PROCESS_ID"] = str(pid)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(argv: list, tmp_path, n: int = 2, env_extra=None,
              timeout: int = 120) -> list:
    """Run ``argv`` as ``n`` processes of one world; returns each one's
    (exit code, output)."""
    port = free_port()
    procs, logs = [], []
    try:
        for pid in range(n):
            env = dp_env(port, pid, n)
            env.update(env_extra or {})
            log = open(tmp_path / f"rank{pid}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=REPO))
        out = []
        for p, log in zip(procs, logs):
            rc = p.wait(timeout=timeout)
            log.seek(0)
            out.append((rc, log.read()))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()


def json_lines(results: list) -> list:
    """The last JSON line of each rank, asserting every rank exited 0."""
    out = []
    for pid, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {pid} failed:\n{text}"
        out.append(json.loads([l for l in text.splitlines()
                               if l.startswith("{")][-1]))
    return out


# ---- the computations, shared by the workers and the references --------

def bn_inputs():
    rng = np.random.default_rng(5)
    n, c, h, w = BN_SHAPE
    x = rng.standard_normal((n, c, h, w)).astype(np.float32) * 3 + 1.5
    dy = rng.standard_normal((n, c, h, w)).astype(np.float32)
    p = [rng.random(c).astype(np.float32) + 0.5 for _ in range(4)]
    return x, dy, p


def bn_run(bn, x, dy) -> dict:
    """Forward and backward of one train-mode batch norm; numpy results."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(dy))
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy(),
            "count": int(bn.num_batches_tracked)}


def make_bn(p, cls=torch.nn.BatchNorm2d):
    bn = cls(BN_SHAPE[1], eps=1e-5)
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                         bn.running_var), p):
            t.copy_(torch.from_numpy(v))
    return bn


def csnet_batches(b=B, hw=HW, steps=STEPS):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(300 + i)
        out.append({
            "image": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            "target": (rng.random((b, hw, hw, 1)) > 0.5).astype(np.float32)})
    return out


def csnet_run(m=None, b=B, hw=HW, steps=STEPS) -> tuple:
    """``steps`` SGD steps of the CSNet train step with the penalty on, at
    a global batch ``b`` (on the data mesh ``m``); the losses, penalties,
    the parameter checksum and the state dict after each step."""
    model = mesh.replicate(CSNet(LC, seed=3, device="cpu"),
                           m.world if m is not None else None)
    step = make_train_step(model, make_sgd(model, momentum=0.9),
                           flops_weight=FW, flops_expand=2.0, batch_size=b,
                           mesh=m)
    losses, pens, states = [], [], []
    for batch in csnet_batches(b, hw, steps):
        m = step(multihost.local_slice_feed(batch), LR, 1.0)
        losses.append(float(m["loss"]))
        pens.append(float(m["penalty"]))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    checksum = float(sum(p.detach().double().abs().sum()
                         for p in model.parameters()))
    return losses, pens, checksum, states


def csf_batches():
    rng = np.random.default_rng(41)
    return [{"image": rng.standard_normal(
                 (2, CSF_HW, CSF_HW, 3)).astype(np.float32),
             "target": (rng.random((2, CSF_HW, CSF_HW, 1)) > 0.6
                        ).astype(np.float32)} for _ in range(CSF_ITER)]


def csf_run(m=None) -> tuple:
    """One optimizer apply (iter_size micro-steps) of the CSF step at a
    global batch of 2; the initial and final state dicts."""
    model = CSFNet("res2net50", seed=2, device="cpu")
    freeze_reference_params(model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=0.0, weight_decay=CSF_WD)
    step = CSFTrainStep(model, opt, iter_size=CSF_ITER, batch_size=2,
                        mesh=m)
    for batch in csf_batches():
        step(multihost.local_slice_feed(batch), CSF_LR)
    return init, model.state_dict()


def resident_rows(m=None) -> dict:
    """The batches the step receives in one resident CSNet epoch and one
    resident CSF epoch of a 16-image store at a global batch of 8
    (recorded; the step trains nothing)."""
    from sod100k_tpu_torch.data.resident import (make_resident_csf_epoch_fn,
                                                 make_resident_epoch_fn)

    rng = np.random.default_rng(9)
    data = {"image_u8": torch.from_numpy(
                rng.integers(0, 256, (16, 40, 40, 3), dtype=np.uint8)),
            "gt_u8": torch.from_numpy(
                rng.integers(0, 256, (16, 40, 40), dtype=np.uint8))}
    seen: dict = {}

    def recorder(kind):
        def record(batch, *_):
            for k in ("image", "target"):
                seen.setdefault(f"{kind}_{k}", []).append(batch[k])
            return {"loss": torch.zeros(()), "penalty": torch.zeros(())}
        return record

    make_resident_epoch_fn(recorder("csnet"), batch_size=8, out_hw=(32, 32),
                           max_crop=3, mesh=m)(
        data, torch.Generator().manual_seed(4), 0.0, 1.0)
    make_resident_csf_epoch_fn(recorder("csf"), batch_size=8, mesh=m)(
        data, torch.Generator().manual_seed(5), 0.0)
    return {k: torch.stack(v) for k, v in seen.items()}


def worker(role: str) -> None:
    torch.set_num_threads(1)
    assert multihost.init_from_env(), "the worker needs SOD100K_* variables"
    dm = mesh.data_mesh()
    group = dm.world
    out = {"rank": mesh.rank(), "primary": multihost.is_primary()}
    if role == "bn":
        x, dy, p = bn_inputs()
        bn = convert_global_bn(make_bn(p), group)
        bn.train()
        sl = multihost.process_slice(BN_SHAPE[0])
        r = bn_run(bn, x[sl], dy[sl])
        mesh.all_reduce_grads(bn.parameters(), group)
        r["dw"], r["db"] = bn.weight.grad.numpy(), bn.bias.grad.numpy()
        out.update({k: np.asarray(v).tolist() for k, v in r.items()})
    elif role == "csnet":
        losses, pens, checksum, _ = csnet_run(dm)
        out.update(losses=losses, pens=pens, checksum=checksum)
        small = csnet_run(dm, JAX_B, JAX_HW, 1)
        out.update(small_loss=small[0][0], small_pen=small[1][0])
        if multihost.is_primary():
            torch.save(small[3][0], os.environ["DP_STATE_OUT"])
    elif role == "rows":
        torch.save(resident_rows(dm), os.environ["DP_STATE_OUT"]
                   + f".{mesh.rank()}")
    elif role == "csf":
        init, final = csf_run(dm)
        if multihost.is_primary():
            torch.save(final, os.environ["DP_STATE_OUT"])
        out["checksum"] = float(sum(v.double().abs().sum()
                                    for v in final.values()
                                    if v.is_floating_point()))
    multihost.barrier("done")
    print(json.dumps(out), flush=True)


# ---- tests ----------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_global_bn_at_world_size_one_is_batchnorm_bit_for_bit():
    """With no group, or out of train mode, ``GlobalBatchNorm2d`` runs
    ``nn.BatchNorm2d``'s own code: equal to the last bit; the conversion
    keeps the module, its parameters and its state_dict keys."""
    x, dy, p = bn_inputs()
    ref = make_bn(p)
    want = bn_run(ref, x, dy)
    bn = make_bn(p)
    weight, keys = bn.weight, list(bn.state_dict())
    holder = torch.nn.Sequential(bn)
    assert convert_global_bn(holder, None) is holder
    assert type(holder[0]) is GlobalBatchNorm2d and holder[0] is bn
    assert isinstance(bn, torch.nn.BatchNorm2d) and bn.weight is weight
    assert list(bn.state_dict()) == keys
    got = bn_run(bn, x, dy)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bn.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(
            bn(torch.from_numpy(x)).numpy(),
            ref.eval()(torch.from_numpy(x)).numpy())


def test_helpers_single_process_fallbacks(monkeypatch):
    """Without the variables the data-parallel API is the single process:
    no group, no collectives, every row, primary."""
    for k in ("SOD100K_COORDINATOR", "SOD100K_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert not multihost.init_from_env()
    assert not multihost.is_multihost() and multihost.is_primary()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    dm = mesh.data_mesh()
    assert dm.shape == "1x1" and (dm.data_index, dm.spatial_index) == (0, 0)
    assert dm.world is None and dm.data_group is None \
        and dm.spatial_group is None
    assert mesh.local_device() == torch.device("cpu")
    assert multihost.process_slice(8) == slice(0, 8)
    assert dm.rows(8) == slice(0, 8)
    batch = {"image": np.zeros((8, 4, 4, 3), np.float32), "meta": "x"}
    assert multihost.local_slice_feed(batch) is batch
    multihost.barrier("noop")
    fed = multihost.global_feed(batch, "cpu")
    assert fed["image"].shape == (8, 4, 4, 3) and fed["meta"] == "x"
    t = torch.ones(3)
    assert mesh.gather_rows(t) is t
    assert mesh.all_reduce_sum({"a": t})["a"] is t
    m = torch.nn.Linear(2, 2)
    assert mesh.replicate(m) is m
    mesh.all_reduce_grads(m.parameters())


def test_init_from_env_refuses_incomplete_variables(monkeypatch):
    monkeypatch.setenv("SOD100K_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("SOD100K_NUM_PROCESSES", raising=False)
    with pytest.raises(SystemExit, match="SOD100K_NUM_PROCESSES"):
        multihost.init_from_env(log=lambda *a: None)
    monkeypatch.delenv("SOD100K_COORDINATOR")
    monkeypatch.setenv("SOD100K_MULTIHOST", "auto")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        multihost.init_from_env(log=lambda *a: None)


def test_a_failed_rendezvous_exits_non_zero(tmp_path):
    """Launched as one of two processes whose peer never comes, a worker
    exits non-zero instead of carrying on alone."""
    code = ("import datetime\n"
            "from sod100k_tpu_torch.parallel import multihost\n"
            "multihost.INIT_TIMEOUT = datetime.timedelta(seconds=3)\n"
            "multihost.init_from_env()\n"
            "print('carried on')\n")
    env = dp_env(free_port(), 1, 2)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "carried on" not in r.stdout, r.stdout
    assert "data-parallel init failed" in r.stderr + r.stdout


def test_global_bn_two_processes_equal_the_global_batch(tmp_path):
    res = json_lines(run_ranks([HERE, "bn"], tmp_path))
    x, dy, p = bn_inputs()
    want = bn_run(make_bn(p), x, dy)
    for k in ("y", "dx"):
        got = np.concatenate([np.asarray(r[k], np.float32) for r in res])
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for r in res:
        for k in ("dw", "db", "mean", "var"):
            # dw and db are sums over N*H*W = 378 terms: their f32 rounding
            # scales with their size, so the bar is 1e-6 of their largest
            scale = max(1.0, float(np.abs(want[k]).max()))
            np.testing.assert_allclose(np.asarray(r[k], np.float32), want[k],
                                       rtol=0, atol=1e-6 * scale, err_msg=k)
        assert r["count"] == want["count"] == 1


def test_two_process_csnet_step_equals_one_process(tmp_path):
    out = tmp_path / "state.pt"
    res = json_lines(run_ranks([HERE, "csnet"], tmp_path,
                               env_extra={"DP_STATE_OUT": str(out)}))
    assert res[0]["primary"] and not res[1]["primary"]
    for k in ("losses", "pens", "checksum"):
        assert res[0][k] == res[1][k], k  # all-reduced: the same on ranks
    losses, pens, checksum, _ = csnet_run()
    got = res[0]
    assert got["losses"][0] == pytest.approx(losses[0], rel=1e-5)
    assert got["losses"][1] == pytest.approx(losses[1], rel=1e-4)
    assert got["pens"] == pytest.approx(pens, rel=1e-4)
    assert got["checksum"] == pytest.approx(checksum, rel=1e-4)

    # and against the JAX package's single-process step, same weights
    import jax
    import jax.numpy as jnp
    from test_trajectory import _delta_close

    from sod100k_tpu.arch.layer_config import init_layers as jinit_layers
    from sod100k_tpu.interop.torch_ckpt import (pytree_to_state_dict,
                                                state_dict_to_pytree)
    from sod100k_tpu.train import optim as joptim
    from sod100k_tpu.train import step as jstep
    from sod100k_tpu.train.params import merge, partition

    sd0 = {k: v.numpy() for k, v in CSNet(LC, seed=3, device="cpu")
           .state_dict().items() if not k.endswith("num_batches_tracked")}
    trainable, state = partition(jax.tree.map(
        jnp.asarray, state_dict_to_pytree(sd0)))
    tx = joptim.make_sgd(momentum=0.9)
    opt_state = tx.init(trainable)
    jax_step = jstep.make_train_step(
        jinit_layers(8, [0.5, 0.5]), tx, flops_weight=FW, flops_expand=2.0,
        batch_size=JAX_B, donate=False)
    batch = {k: jnp.asarray(v)
             for k, v in csnet_batches(JAX_B, JAX_HW, 1)[0].items()}
    trainable, state, opt_state, m = jax_step(
        trainable, state, opt_state, batch, jnp.float32(LR),
        jnp.float32(1.0))
    # one step at 16^2, B=4 (2 + 2): the loss at test_torch_train.py's
    # gradient bar (rel 1e-5), the step's deltas (-lr * gradient, BN
    # statistics) at its L2-rel 2e-3. At 32^2, B=8 both packages' f32
    # gradients of stage0.0.conv1x1 are 1-4% (L2) from an f64 one, so no
    # f32-against-f32 bar below that holds there
    assert got["small_loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert got["small_pen"] == pytest.approx(float(m["penalty"]), rel=1e-5)
    want_sd = {k: np.array(v, np.float32) for k, v in pytree_to_state_dict(
        jax.tree.map(np.asarray, merge(trainable, state))).items()}
    got_sd = {k: v.numpy() for k, v in torch.load(out).items()
              if not k.endswith("num_batches_tracked")}
    _delta_close(sd0, want_sd, got_sd, rtol=2e-3)


def test_resident_epochs_split_the_global_batch_exactly(tmp_path):
    """Both resident epochs draw the permutation and the augmentations of
    the global batch and hand each rank its rows: the two ranks' batches,
    side by side, are the single process's, bit for bit."""
    out = tmp_path / "rows.pt"
    json_lines(run_ranks([HERE, "rows"], tmp_path,
                         env_extra={"DP_STATE_OUT": str(out)}))
    got = [torch.load(f"{out}.{r}") for r in range(2)]
    want = resident_rows()
    for k, w in want.items():
        assert w.shape[:2] == (2, 8), k  # two steps of B=8
        torch.testing.assert_close(torch.cat([g[k] for g in got], dim=1), w,
                                   rtol=0, atol=0)


def test_two_process_csf_step_equals_one_process(tmp_path):
    out = tmp_path / "state.pt"
    res = json_lines(run_ranks([HERE, "csf"], tmp_path,
                               env_extra={"DP_STATE_OUT": str(out)}))
    assert res[0]["checksum"] == res[1]["checksum"]
    from test_trajectory import _tensors_close

    init, want = csf_run()
    got = torch.load(out)
    names = [n for n, p in CSFNet("res2net50", seed=2, device="cpu")
             .named_parameters()]
    moved = {n: (want[n] - init[n]).numpy() for n in names}
    assert sum(float(np.abs(v).sum()) for v in moved.values()) > 0
    _tensors_close(moved, {n: (got[n] - init[n]).numpy() for n in names},
                   rtol=1e-5, what="CSF delta")
    for k, v in want.items():  # frozen statistics: untouched on both
        if "running" in k:
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


if __name__ == "__main__":
    worker(sys.argv[1])
