"""K1-K6 (`mmpl_tpu_torch/csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`) on the
card: agreement with their plain versions, the dispatch's launch counts,
and what the wrappers refuse.

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
    (torch.bfloat16, 24, 2e-2, 1e-3),
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
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 0),
                                "flash_fwd": 1}


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 20),
                                     (torch.bfloat16, 144),
                                     (torch.float32, 20),
                                     (torch.float64, 64)])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, dtype, d):
    q, k, v = _qkv(16, 16, d, dtype, cuda)
    ta.reset_launch_counts()
    with pytest.raises(ValueError):
        ta.flash_fwd_cuda(q, k, v)
    assert ta.launch_counts["flash_fwd"] == 0


# ---------------------------------------------------------------------------
# K4-K6 and K2/K3
# ---------------------------------------------------------------------------

def _mask(L, S, cuda, blind=True):
    """Frame ids of L tokens in frames of S, a block-causal mask over them
    and, with `blind`, one frame that sees nothing."""
    from mmpl_tpu_torch.training import masks
    F = -(-L // S)
    fm = masks.blockwise_causal_frame_mask(F, 3)
    if blind:
        fm[1] = False
    ids = np.repeat(np.arange(F), S)[:L]
    return (torch.as_tensor(ids, dtype=torch.int32, device=cuda),
            torch.as_tensor(ids, dtype=torch.int32, device=cuda),
            torch.as_tensor(fm, device=cuda))


def _rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 24),
                                     (torch.float32, 24)])
def test_masked_forward_matches_plain_with_a_blind_frame(cuda, dtype, d):
    q, k, v = _qkv(1000, 1000, d, dtype, cuda)
    mask = _mask(1000, 130, cuda)
    tiles = ta.tile_table(*mask)
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    blind = mask[0] == 1
    assert torch.all(o[:, blind] == 0)
    assert torch.all(lse[:, :, blind] == -float("inf"))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (o.float() - po.float()).abs().max().item() <= tol
    live = torch.isfinite(plse)
    assert (lse[live] - plse[live]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,d,tol", [(torch.bfloat16, 128, 1e-2),
                                         (torch.bfloat16, 24, 1e-2),
                                         (torch.float32, 24, 1e-5),
                                         (torch.float32, 128, 1e-5)])
def test_backward_matches_plain_at_a_ragged_shape(cuda, masked, dtype, d,
                                                  tol):
    lq, lk = (1000, 1000) if masked else (1000, 1300)
    q, k, v = _qkv(lq, lk, d, dtype, cuda)
    do = _qkv(lq, lq, d, dtype, cuda, seed=1)[0]
    mask = _mask(lq, 130, cuda) if masked else None
    tiles = ta.tile_table(*mask) if masked else None
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_bwd_cuda(q, k, v, do, lse, delta, None, mask, tiles)
    if masked:
        want = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                   *mask)
    else:
        want = ta.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    if masked:
        assert torch.all(got[0][:, mask[0] == 1] == 0)


def test_backward_reads_strided_do(cuda):
    q, k, v = _qkv(300, 500, 64, torch.bfloat16, cuda)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    wide = torch.randn((2, 300, 3, 2, 64), device=cuda).to(torch.bfloat16)
    do = wide[:, :, :, 0]
    assert not do.is_contiguous()
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    a = ta.flash_bwd_cuda(q, k, v, do, lse, delta)
    b = ta.flash_bwd_cuda(q, k, v, do.contiguous(), lse, delta)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_autograd_launches_each_kernel_once(cuda):
    q, k, v = (x.requires_grad_(True)
               for x in _qkv(500, 500, 64, torch.bfloat16, cuda))
    ids = torch.as_tensor(np.repeat(np.arange(5), 100), dtype=torch.int32,
                          device=cuda)
    fm = torch.tril(torch.ones((5, 5), dtype=torch.bool, device=cuda))
    ta.reset_launch_counts()
    out = ta.frame_masked_attention(q, k, v, ids, ids, fm)
    out = out + ta.flash_attention(q, k, v)
    out.float().sum().backward()
    assert ta.launch_counts == dict.fromkeys(ta.launch_counts, 1)
    for x in (q, k, v):
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()
