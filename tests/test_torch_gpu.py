"""The CUDA kernel on the card: fused_dw_chain against its plain version.

Needs an NVIDIA GPU with nvcc; skips elsewhere. Imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

f32: atol 2e-5, the JAX package's bar for the Pallas kernel. bf16: within
one bf16 ulp (rtol 2^-7, atol 1e-3) of a value the plain function may give:
the kernel and cuDNN sum the taps in different orders, so a bf16
intermediate at a rounding tie may round either way
(``dw_chain.fused_dw_chain_ref_range``).
"""

import numpy as np
import pytest
import torch

from sod100k_tpu_torch.ops import dw_chain

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=0, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    n, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    def stage():
        return (torch.from_numpy(rng.standard_normal((c, 3, 3), dtype=np.float32) * 0.1),
                torch.from_numpy(rng.random(c).astype(np.float32) + 0.5),
                torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
                torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.25))

    params = [p.to(device) for p in (*stage(), *stage())]
    return x.to(device=device, dtype=dtype), params


# (H, W, C) of the 33 calls of a CSNet-L forward at 224^2, taken at N=32
MAIN = [(224, 224, 20), (112, 112, 20), (112, 112, 40), (56, 56, 40),
        (112, 112, 80), (56, 56, 80), (28, 28, 80), (14, 14, 80),
        (56, 56, 160), (28, 28, 160)]


def _check(got, x, params, dtype):
    """Within the bar of a value the plain function may give (a bf16
    intermediate at a rounding tie may round either way)."""
    assert got.dtype == dtype and got.shape == x.shape
    dw_chain.check_against_plain(got, x, params, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 13, 40, 36), (1, 5, 17, 23), (2, 24, 64, 64), (2, 20, 224, 224),
    (2, 160, 28, 28),
    (3, 9, 14, 14),     # odd plane count at 14^2: bulk group + short tail
    (2, 3, 101, 224),   # H not a multiple of the band rows
    (1, 1, 224, 224),   # the band path with a single plane
    (2, 3, 170, 102),    # rows not 16-byte aligned: element-wise staging
    *[(32, c, h, w) for h, w, c in MAIN],  # the main path's plans
    (256, 80, 28, 28),  # a one-slot plan with more items than blocks
])
def test_kernel_matches_plain(cuda, shape, dtype):
    x, params = _inputs(shape, dtype, cuda)
    before = dw_chain.launches
    got = dw_chain.fused_dw_chain(x, *params)
    torch.cuda.synchronize()
    assert dw_chain.launches == before + 1
    _check(got, x, params, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sizes,sms", [
    ((2, 3, 224, 224), {}, 4),                    # two-slot bands
    ((2, 3, 224, 224), {"BAND_SLOTS": 1}, 4),     # one-slot bands
    ((2, 3, 224, 224), {"rows": 1}, 8),
    ((2, 3, 224, 224), {"rows": 100}, 2),         # a short last band
    ((2, 3, 224, 224), {"BAND_THREADS": 32}, 4),
    ((8, 20, 28, 28), {}, 4),                     # one-slot planes
    ((8, 20, 28, 28), {"PLANE_SLOTS": 2}, 4),     # two-slot planes
    ((3, 9, 14, 14), {"PLANE_SLOTS": 2}, 1),      # ... and a short group
])
def test_kernel_plan_sizes_match_plain(cuda, shape, sizes, sms, dtype,
                                       monkeypatch):
    """Plans other than the device's, on a grid of ``sms`` one-block SMs:
    each block walks several items, reusing its ring slots."""
    n, c, h, w = shape
    sizes = dict(sizes)
    if "rows" in sizes:
        elt = torch.finfo(dtype).bits // 8
        sizes.update(PLANE_BYTES=0,
                     BAND_BYTES=(sizes.pop("rows") + 4) * w * elt)
    for k, v in sizes.items():
        monkeypatch.setattr(dw_chain, k, v)
    plan = dw_chain.plan_launch(*shape, dtype, sm_count=sms, blocks_per_sm=1)
    assert plan.grid == sms and plan.items >= 2 * plan.grid
    x, params = _inputs(shape, dtype, cuda)
    got = dw_chain.launch(x, dw_chain.pack_params(*params), plan)
    torch.cuda.synchronize()
    _check(got, x, params, dtype)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, params = _inputs((1, 4, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dw_chain.fused_dw_chain(x.transpose(2, 3), *params)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dw_chain.fused_dw_chain(x.half(), *params)
    with pytest.raises(ValueError, match="parameter 1"):
        dw_chain.fused_dw_chain(x, params[0], params[1].cpu(), *params[2:])


def test_packed_path_and_refusals(cuda):
    x, params = _inputs((2, 6, 56, 56), torch.float32, cuda)
    packed = dw_chain.pack_params(*params)
    got = dw_chain.fused_dw_chain_packed(x, packed)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, dw_chain.fused_dw_chain_ref(x, *params),
                               **TOL[torch.float32])
    with pytest.raises(ValueError, match="pack"):
        dw_chain.fused_dw_chain_packed(x, packed.cpu())
    with pytest.raises(ValueError, match="pack"):
        dw_chain.fused_dw_chain_packed(x, packed[:, :12].contiguous())
