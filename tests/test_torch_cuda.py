"""K1 (`mmpl_tpu_torch/csrc/flash_fwd.cu`) on the card: agreement with its
plain version, the dispatch's launch count, and what the wrapper refuses.

Needs an NVIDIA GPU and nvcc, not JAX; on the card run

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from mmpl_tpu_torch.ops import attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(lq, lk, d, dtype, device, seed=0, B=2, N=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, L, N, d)).astype(
        np.float32)).to(device, dtype) for L in (lq, lk, lk)]


def _errors(q, k, v):
    o, lse = ta.flash_fwd_cuda(q, k, v)
    po, plse = ta.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    return ((o.float() - po.float()).abs().max().item(),
            (lse - plse).abs().max().item())


# bf16/fp16: P is rounded to the input type before PV (as the TPU kernel
# does) while the plain version keeps it fp32; fp32 differs only in the
# order of the sums.
@pytest.mark.parametrize("dtype,d,o_tol,lse_tol", [
    (torch.bfloat16, 128, 2e-2, 1e-3),
    (torch.bfloat16, 64, 2e-2, 1e-3),
    (torch.float16, 96, 5e-3, 1e-3),
    (torch.float32, 24, 1e-4, 1e-4),
    (torch.float32, 128, 1e-4, 1e-4),
])
def test_kernel_matches_plain_at_a_ragged_shape(cuda, dtype, d, o_tol,
                                                lse_tol):
    o_err, lse_err = _errors(*_qkv(1000, 1300, d, dtype, cuda))
    assert o_err <= o_tol and lse_err <= lse_tol, (o_err, lse_err)


def test_kernel_reads_strided_operands(cuda):
    """q/k/v as views of one fused [B, L, 3, N, D] projection."""
    qkv = torch.randn((2, 777, 3, 4, 128), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = ta.flash_fwd_cuda(q, k, v)
    oc, lsec = ta.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    torch.testing.assert_close(o, oc, atol=0, rtol=0)
    torch.testing.assert_close(lse, lsec, atol=0, rtol=0)


def test_dispatch_counts_one_launch_per_unmasked_call(cuda):
    q, k, v = _qkv(64, 200, 128, torch.bfloat16, cuda)
    ta.reset_launch_counts()
    ta.attention(q, k, v)
    mask = torch.ones((1, 1, 64, 200), dtype=torch.bool, device=cuda)
    ta.attention(q, k, v, mask=mask)      # masked attention runs dense
    assert ta.launch_counts == {"flash_fwd": 1}


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 72),
                                     (torch.bfloat16, 144),
                                     (torch.float32, 20),
                                     (torch.float64, 64)])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, dtype, d):
    q, k, v = _qkv(16, 16, d, dtype, cuda)
    ta.reset_launch_counts()
    with pytest.raises(ValueError):
        ta.flash_fwd_cuda(q, k, v)
    assert ta.launch_counts["flash_fwd"] == 0
