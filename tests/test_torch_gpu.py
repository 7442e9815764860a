"""The CUDA kernel on the card: fused_dw_chain against its plain version.

Needs an NVIDIA GPU with nvcc; skips elsewhere. Imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

f32: atol 2e-5, the JAX package's bar for the Pallas kernel. bf16: within
one bf16 ulp (rtol 2^-7, atol 1e-3), since the kernel and cuDNN sum the taps
in different orders and a rounding of the bf16 intermediate can flip.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 40, 36), (1, 5, 17, 23),
                                   (2, 24, 64, 64), (2, 20, 224, 224),
                                   (2, 160, 28, 28)])
def test_kernel_matches_plain(cuda, shape, dtype):
    x, params = _inputs(shape, dtype, cuda)
    before = dw_chain.launches
    got = dw_chain.fused_dw_chain(x, *params)
    torch.cuda.synchronize()
    assert dw_chain.launches == before + 1
    want = dw_chain.fused_dw_chain_ref(x, *params)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, params = _inputs((1, 4, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dw_chain.fused_dw_chain(x.transpose(2, 3), *params)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dw_chain.fused_dw_chain(x.half(), *params)
    with pytest.raises(ValueError, match="parameter 1"):
        dw_chain.fused_dw_chain(x, params[0], params[1].cpu(), *params[2:])
