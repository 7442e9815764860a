"""Port parity, the fused depthwise tail on the CPU.

``fused_dw_chain_ref`` (the plain version of the CUDA kernel) against the
Pallas kernel ``sod100k_tpu.ops.pallas.dw_chain.fused_dw_chain`` run in
interpret mode, as the JAX package's own tests run it; the fold; and the
fused tail against the unfused modules. The CUDA kernel itself is checked
against the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod100k_tpu.ops.pallas import dw_chain as jdw
from sod100k_tpu_torch.ops import dw_chain
from sod100k_tpu_torch.ops.goct import SimplifiedGOctCBR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_params(rng, c):
    """Taps (3, 3, C) and scale/shift/alpha (C,), the JAX test's recipe."""
    return (rng.standard_normal((3, 3, c), dtype=np.float32) * 0.1,
            rng.random(c).astype(np.float32) + 0.5,
            rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32) * 0.25)


def _torch_params(p):
    """JAX layout -> the port's: taps (3, 3, C) -> (C, 3, 3)."""
    w, s, b, a = (torch.from_numpy(v) for v in p)
    return w.permute(2, 0, 1).contiguous(), s, b, a


@pytest.mark.parametrize("shape", [(2, 40, 36, 13), (1, 17, 23, 5)])
def test_fused_dw_chain_ref_matches_pallas_interpret(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape, dtype=np.float32)
    p1, p2 = _chain_params(rng, shape[3]), _chain_params(rng, shape[3])
    want = jdw.fused_dw_chain(jnp.asarray(x), *map(jnp.asarray, p1),
                              *map(jnp.asarray, p2), interpret=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = dw_chain.fused_dw_chain_ref(xt, *_torch_params(p1),
                                      *_torch_params(p2))
    # the JAX package's bar for this kernel (test_pallas_kernels.py)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=2e-5)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 7), dtype=np.float32))
    params = (*_torch_params(_chain_params(rng, 6)),
              *_torch_params(_chain_params(rng, 6)))
    before = dw_chain.launches
    got = dw_chain.fused_dw_chain(x, *params)
    assert dw_chain.launches == before
    torch.testing.assert_close(got, dw_chain.fused_dw_chain_ref(x, *params),
                               rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 2, 4, 4), device="meta")
    p = (torch.empty((2, 3, 3), device="meta"),
         *(torch.empty(2, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        dw_chain.fused_dw_chain(x, *p, *p)


def test_fold_bn_eval_matches_jax():
    rng = np.random.default_rng(11)
    c = 9
    bn = torch.nn.BatchNorm2d(c)
    vals = {"weight": rng.standard_normal(c), "bias": rng.standard_normal(c),
            "running_mean": rng.standard_normal(c),
            "running_var": rng.random(c) + 0.2}
    with torch.no_grad():
        for k, v in vals.items():
            getattr(bn, k).copy_(torch.from_numpy(v.astype(np.float32)))
    s, b = dw_chain.fold_bn_eval(bn)
    js, jb = jdw.fold_bn_eval({
        "scale": jnp.asarray(bn.weight.detach().numpy()),
        "offset": jnp.asarray(bn.bias.detach().numpy()),
        "mean": jnp.asarray(bn.running_mean.numpy()),
        "var": jnp.asarray(bn.running_var.numpy())})
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_dw_tail_fused_matches_unfused_modules():
    """The eval-mode fused tail computes what the two unfused stages compute
    (the port's version of test_csnet_pallas_path_matches_default)."""
    split = (5, 0, 3)
    rng = np.random.default_rng(12)
    stages = [SimplifiedGOctCBR(split), SimplifiedGOctCBR(split)]
    with torch.no_grad():
        for m in stages:
            for name, t in m.state_dict().items():
                if name.endswith("num_batches_tracked"):
                    continue
                v = rng.standard_normal(t.shape) * (0.01 if t.dim() == 4
                                                    else 0.5)
                if name.endswith("running_var"):
                    v = np.abs(v) + 0.5
                t.copy_(torch.from_numpy(v.astype(np.float32)))
            m.eval()
    xset = [torch.from_numpy(rng.standard_normal((2, 5, 16, 12),
                                                 dtype=np.float32)),
            None,
            torch.from_numpy(rng.standard_normal((2, 3, 4, 3),
                                                 dtype=np.float32))]
    with torch.no_grad():
        got = dw_chain.dw_tail_fused(stages[0], stages[1], xset, split)
        want = stages[1](stages[0](xset))
    assert got[1] is None and want[1] is None
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)
