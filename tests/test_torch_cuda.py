"""K1-K6 (`mmpl_tpu_torch/csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`, their
Hopper bodies `csrc/flash_fwd_sm90.cuh` and `csrc/flash_bwd_sm90.cuh`, which
also run the bf16 / fp16 K4, K5 and K6) and
the int8 kernels P2 and Q (`csrc/int8_gemm.cu`, P2's Hopper body
`csrc/int8_gemm_sm90.cuh`) on the card: agreement with their plain
versions, the body each type runs, the dispatch's launch counts, and what
the wrappers refuse.

Needs an NVIDIA GPU and nvcc, not JAX; on the card run

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips where there is no CUDA device.
"""

import os

# Keep CUPTI resident between the short torch.profiler sessions of the body
# checks (`_launched`): with the default teardown and lazy re-init the
# card's torch / CUPTI recorded the device kernels of only the first of
# many.  Set before torch loads; it changes nothing on the CPU.
os.environ.setdefault("TEARDOWN_CUPTI", "0")
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mmpl_tpu_torch.ops import attention as ta  # noqa: E402

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
# The Hopper body of K1 and P1 (csrc/flash_fwd_sm90.cuh): 128-key tiles,
# so every residue of Lk mod 128, ragged Lq, D padded to 64 or 128
# ---------------------------------------------------------------------------

def _launched(fn):
    """The names of the device kernels that `BODY_CALLS` calls of `fn`
    launch in one profiler session (one-call sessions lose records)."""
    from mmpl_tpu_torch.utils.profiling import BODY_CALLS, device_kernels
    return set(device_kernels(fn, BODY_CALLS))


@pytest.mark.parametrize("lq", [1, 127, 1000])
@pytest.mark.parametrize("lk", [1, 64, 100, 128, 192, 1300])
def test_hopper_k1_matches_plain_at_every_key_residue(cuda, lq, lk):
    """O and the natural-log lse against the plain version: Lk from a
    single key to several tiles with every kind of last tile (1, 64, 100,
    128 keys), Lq below, at and past one 128-row block."""
    o_err, lse_err = _errors(*_qkv(lq, lk, 128, torch.bfloat16, cuda,
                                   seed=lq + lk))
    assert o_err <= 2e-2 and lse_err <= 1e-3, (o_err, lse_err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [24, 64, 96, 128])
def test_hopper_k1_matches_plain_at_each_head_dim(cuda, dtype, d):
    o_err, lse_err = _errors(*_qkv(1000, 1300, d, dtype, cuda, seed=d))
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-3
    assert o_err <= tol and lse_err <= 1e-3, (o_err, lse_err)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float16, 96),
                                     (torch.bfloat16, 24)])
def test_hopper_k1_reads_the_fused_qkv_in_place(cuda, dtype, d):
    """q, k, v as views of one fused [B, L, 3 * N * D] projection (the
    DiT's `.chunk(3, -1)`: a row stride of 3 * N * D), against the plain
    version, lse included."""
    qkv = torch.randn((2, 777, 3 * 4 * d), generator=torch.Generator(
        device=cuda).manual_seed(d), device=cuda).to(dtype)
    q, k, v = (x.unflatten(-1, (4, d)) for x in qkv.chunk(3, -1))
    assert q.stride(1) == 3 * 4 * d
    o_err, lse_err = _errors(q, k, v)
    assert o_err <= 2e-2 and lse_err <= 1e-3, (o_err, lse_err)


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "flash_fwd_sm90"),
                                        (torch.float16, "flash_fwd_sm90"),
                                        (torch.float32, "flash_fwd_kernel")])
def test_k1_runs_the_body_of_its_type(cuda, dtype, body):
    """bf16 / fp16 K1 runs the Hopper kernel, fp32 the template body; the
    profiler attribution books each to K1."""
    from mmpl_tpu_torch.utils.profiling import port_kernel_of
    q, k, v = _qkv(200, 300, 64, dtype, cuda)
    names = _launched(lambda: ta.flash_fwd_cuda(q, k, v))
    mine = [n for n in names if port_kernel_of(n) == "flash_fwd"]
    assert len(mine) == 1 and body in mine[0], names


@pytest.mark.parametrize("use_exp2", [False, True])
def test_hopper_p1_without_the_pad_test_at_half_a_tile(cuda, use_exp2):
    """Lk = 192 = 128 + 64: the last 128-key tile holds 64 keys, which
    P1 without the pad test drops as a whole half."""
    q, k, v = _qkv(300, 192, 128, torch.bfloat16, cuda, seed=5)
    got = ta.flash_attention_exp2(q, k, v, use_exp2, mask_pad=False)
    want = ta.flash_attention_exp2_plain(q, k, v, use_exp2, mask_pad=False)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("lk", [100, 1300])
def test_backward_through_autograd_reads_the_hopper_lse(cuda, lk):
    """K2 / K3 through `flash_attention`'s autograd, fed the lse the Hopper
    K1 saved, against the plain backward fed the plain lse."""
    q, k, v = _qkv(1000, lk, 128, torch.bfloat16, cuda, seed=6)
    do = _qkv(1000, 1000, 128, torch.bfloat16, cuda, seed=7)[0]
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    ta.flash_attention(qg, kg, vg).backward(do)
    po, plse = ta.flash_attention_plain(q, k, v)
    delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1).contiguous()
    want = ta.flash_attention_bwd_plain(q, k, v, do, plse, delta)
    for g, w, name in zip((qg.grad, kg.grad, vg.grad), want,
                          ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= 1e-2, (name, _rel(g, w))


# ---------------------------------------------------------------------------
# K4-K6 and K2/K3
# ---------------------------------------------------------------------------

def _mask(L, S, cuda, blind=True, unseen=False):
    """Frame ids of L tokens in frames of S, a block-causal mask over them
    and, with `blind`, one frame that sees nothing; with `unseen` frame 2
    is seen by nothing (at S >= 256 both span whole 128-token blocks)."""
    from mmpl_tpu_torch.training import masks
    F = -(-L // S)
    fm = masks.blockwise_causal_frame_mask(F, 3)
    if blind:
        fm[1] = False
    if unseen:
        fm[:, 2] = False
    ids = np.repeat(np.arange(F), S)[:L]
    return (torch.as_tensor(ids, dtype=torch.int32, device=cuda),
            torch.as_tensor(ids, dtype=torch.int32, device=cuda),
            torch.as_tensor(fm, device=cuda))


def _rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 24),
                                     (torch.float16, 128),
                                     (torch.float16, 24),
                                     (torch.float32, 24)])
def test_masked_forward_matches_plain_with_a_blind_frame(cuda, dtype, d):
    q, k, v = _qkv(1000, 1000, d, dtype, cuda)
    mask = _mask(1000, 130, cuda)
    tiles = ta.mask_tiles(*mask)
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
                                         (torch.float16, 128, 1e-2),
                                         (torch.float16, 24, 1e-2),
                                         (torch.float32, 24, 1e-5),
                                         (torch.float32, 128, 1e-5)])
def test_backward_matches_plain_at_a_ragged_shape(cuda, masked, dtype, d,
                                                  tol):
    lq, lk = (1000, 1000) if masked else (1000, 1300)
    q, k, v = _qkv(lq, lk, d, dtype, cuda)
    do = _qkv(lq, lq, d, dtype, cuda, seed=1)[0]
    mask = _mask(lq, 130, cuda) if masked else None
    tiles = ta.mask_tiles(*mask) if masked else None
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [24, 128])
def test_masked_blocks_with_no_admitted_tile(cuda, dtype, d):
    """Frames of 300 tokens: frame 1 sees nothing (query block 384..511
    has no admitted tile, so K4 and K6 run only their epilogues) and frame
    2 is seen by nothing (key blocks 640..895 have no admitted query tile,
    so K5 writes zeros).  O = 0, lse = -inf and dQ = 0 on frame 1's rows,
    dK = dV = 0 on frame 2's keys, the rest against the plain versions."""
    q, k, v = _qkv(1000, 1000, d, dtype, cuda, seed=d)
    do = _qkv(1000, 1000, d, dtype, cuda, seed=d + 1)[0]
    mask = _mask(1000, 300, cuda, unseen=True)
    tiles = ta.mask_tiles(*mask)
    assert (tiles.fwd[3] == 0).all() and (tiles.dkv[5:7] == 0).all()
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    blind, unseen = mask[0] == 1, mask[1] == 2
    assert torch.all(o[:, blind] == 0)
    assert torch.all(lse[:, :, blind] == -float("inf"))
    assert torch.equal(torch.isfinite(lse), torch.isfinite(plse))
    live = torch.isfinite(plse)
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse[live] - plse[live]).abs().max().item() <= 1e-3
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = ta.flash_bwd_cuda(q, k, v, do, lse, delta, None, mask,
                                   tiles)
    wq, wk, wv = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                     *mask)
    assert torch.all(dk[:, unseen] == 0) and torch.all(dv[:, unseen] == 0)
    assert torch.all(dq[:, 384:512] == 0) and torch.all(dq[:, blind] == 0)
    for g, w, name in ((dq, wq, "dq"), (dk, wk, "dk"), (dv, wv, "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= 1e-2, (name, _rel(g, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_masked_dkv_rows_without_lse_on_tiles_that_allow_every_pair(cuda,
                                                                     dtype):
    """Rows whose lse is -inf give p = 0 on every tile, also where the
    frame table allows every pair (class 2, which tests no pair): an
    all-ones mask with some rows' lse set to -inf, against the plain
    version."""
    q, k, v, do = _bwd_inputs(1000, 1000, 128, dtype, cuda, seed=11)
    ids = torch.zeros(1000, dtype=torch.int32, device=cuda)
    mask = (ids, ids, torch.ones((1, 1), dtype=torch.bool, device=cuda))
    tiles = ta.mask_tiles(*mask)
    assert (tiles.dkv == 2).all()
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    lse[:, :, 100:150] = -float("inf")
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, mask,
                                   tiles)
    _, wk, wv = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                    *mask)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for g, w, name in ((dk, wk, "dk"), (dv, wv, "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_masked_dq_rows_without_lse_on_tiles_that_allow_every_pair(cuda,
                                                                    dtype):
    """K6's twin of the dKV test above: rows whose lse is -inf get dQ = 0,
    also on tiles of class 2, and the other rows match the plain version."""
    q, k, v, do = _bwd_inputs(1000, 1000, 128, dtype, cuda, seed=12)
    ids = torch.zeros(1000, dtype=torch.int32, device=cuda)
    mask = (ids, ids, torch.ones((1, 1), dtype=torch.bool, device=cuda))
    tiles = ta.mask_tiles(*mask)
    assert (tiles.fwd == 2).all()
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    lse[:, :, 100:150] = -float("inf")
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = ta.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, mask, tiles)
    wq = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                             *mask)[0]
    assert torch.all(dq[:, 100:150] == 0)
    assert torch.isfinite(dq.float()).all()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel(dq, wq) <= tol, _rel(dq, wq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_masked_kernels_at_the_most_frames_the_hopper_bodies_hold(cuda,
                                                                   dtype):
    """K4, K5 and K6 at F = SM90_MAX_FRAMES with D = 128, the most shared
    memory their frame tables take (K6 holds the table as bits: a byte a
    pair on top of K3's layout would pass the card's opt-in limit): 192
    frames of 8 tokens under a random mask with its diagonal, so every
    frame id appears and most 128 x 128 tiles test each pair, against the
    plain versions."""
    F = ta.SM90_MAX_FRAMES
    rng = np.random.default_rng(14)
    fm = rng.random((F, F)) < 0.3
    np.fill_diagonal(fm, True)
    ids = torch.as_tensor(np.repeat(np.arange(F), 8), dtype=torch.int32,
                          device=cuda)
    mask = (ids, ids, torch.as_tensor(fm, device=cuda))
    tiles = ta.mask_tiles(*mask)
    assert (tiles.fwd == 1).float().mean().item() > 0.5
    q, k, v, do = _bwd_inputs(8 * F, 8 * F, 128, dtype, cuda, seed=15, B=1)
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-3
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_bwd_cuda(q, k, v, do, lse, delta, None, mask, tiles)
    want = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                               *mask)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= 1e-2, (name, _rel(g, w))


@pytest.mark.parametrize("dtype,body", [
    (torch.bfloat16, "flash_masked_fwd_sm90_kernel"),
    (torch.float16, "flash_masked_fwd_sm90_kernel"),
    (torch.float32, "flash_masked_fwd_kernel"),
])
def test_masked_forward_runs_the_body_of_its_type(cuda, dtype, body):
    """bf16 / fp16 K4 runs the Hopper kernel (the masked instantiation of
    K1's body), fp32 the template; the profiler books each to K4."""
    from mmpl_tpu_torch.utils.profiling import port_kernel_of
    q, k, v = _qkv(500, 500, 64, dtype, cuda)
    mask = _mask(500, 100, cuda)
    tiles = ta.mask_tiles(*mask)
    names = _launched(lambda: ta.flash_fwd_cuda(q, k, v, None, mask, tiles))
    mine = [n for n in names if port_kernel_of(n) == "flash_masked_fwd"]
    assert len(mine) == 1 and body in mine[0], names


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
    # the six kernels of the two autograd functions once each; P1 is no
    # kernel of theirs
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 1),
                                "flash_exp2": 0}
    for x in (q, k, v):
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()


# ---------------------------------------------------------------------------
# The Hopper body of K2 and K3 (csrc/flash_bwd_sm90.cuh): 128-key dKV
# blocks over 64-query tiles, 128-query dQ blocks over 128-key tiles, the
# dKV query split where the key blocks do not fill the card
# ---------------------------------------------------------------------------

def _bwd_inputs(lq, lk, d, dtype, cuda, seed=0, B=2, N=3):
    q, k, v = _qkv(lq, lk, d, dtype, cuda, seed=seed, B=B, N=N)
    do = _qkv(lq, lq, d, dtype, cuda, seed=seed + 1000, B=B, N=N)[0]
    return q, k, v, do


def _bwd_errors(q, k, v, do):
    """(dq, dk, dv) of K2 / K3 and their relative errors against the plain
    backward, both fed the lse of K1."""
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_bwd_cuda(q, k, v, do, lse, delta)
    want = ta.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for g, name in zip(got, ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all(), name
    return got, [_rel(g, w) for g, w in zip(got, want)]


@pytest.mark.parametrize("lk", [64, 100, 127, 128, 129, 192, 255, 1300])
def test_hopper_bwd_matches_plain_at_every_key_residue(cuda, lk):
    """Lk at every kind of last 128-key tile (residues 0, 1, 64, 100, 127
    of Lk mod 128; 64 is half a tile) against Lq = 1000, ragged for the
    64-query and 128-query tiles."""
    _, errs = _bwd_errors(*_bwd_inputs(1000, lk, 128, torch.bfloat16, cuda,
                                       seed=lk))
    assert max(errs) <= 1e-2, errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [24, 64, 128])
def test_hopper_bwd_matches_plain_at_each_head_dim(cuda, dtype, d):
    _, errs = _bwd_errors(*_bwd_inputs(1000, 1300, d, dtype, cuda, seed=d))
    assert max(errs) <= 1e-2, errs


def test_hopper_bwd_reads_views_in_place(cuda):
    """q / k / v as views of one fused [B, L, 3 * N * D] projection and dO
    as a strided view: against the plain version, and bit for bit against
    the same call on contiguous copies."""
    B, L, N, D = 2, 777, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((B, L, 3 * N * D), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (x.unflatten(-1, (N, D)) for x in qkv.chunk(3, -1))
    do = torch.randn((B, L, N, 2, D), generator=gen,
                     device=cuda).to(torch.bfloat16)[:, :, :, 1]
    assert not (q.is_contiguous() or do.is_contiguous())
    got, errs = _bwd_errors(q, k, v, do)
    assert max(errs) <= 1e-2, errs
    dense, _ = _bwd_errors(*(x.contiguous() for x in (q, k, v, do)))
    for x, y in zip(got, dense):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


@pytest.mark.parametrize("lq,lk,split", [(4096, 128, True),
                                         (1000, 8192, False)])
def test_hopper_dkv_with_the_query_split_on_and_off(cuda, lq, lk, split):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (ta.bwd_query_splits(2, 2, lq, lk, sms) > 1) is split
    _, errs = _bwd_errors(*_bwd_inputs(lq, lk, 128, torch.bfloat16, cuda,
                                       N=2))
    assert max(errs) <= 1e-2, errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_dkv_gives_the_same_bits_on_every_call(cuda, dtype):
    """The partials are summed in a fixed order, not with atomics."""
    q, k, v, do = _bwd_inputs(3000, 200, 128, dtype, cuda, N=2)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ta.bwd_query_splits(2, 2, 3000, 200, sms) > 1
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    first = ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    for _ in range(3):
        for x, y in zip(ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
                        first):
            assert torch.equal(x, y)


def test_hopper_bwd_padding_keys_stay_finite_under_a_very_negative_lse(cuda):
    """Every score near -100 (q's first coordinate -1128, k's 1), so each
    lse is near -93 and exp(-lse) overflows fp32: the keys past Lk, which
    score 0, must be masked to p = 0 and not multiplied by 0."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.bfloat16, cuda, seed=9)
    q[..., 0] = -1128.0
    k[..., 0] = 1.0
    _, lse = ta.flash_fwd_cuda(q, k, v)
    assert lse.max().item() < -80, lse.max().item()
    _, errs = _bwd_errors(q, k, v, do)
    assert max(errs) <= 1e-2, errs


@pytest.mark.parametrize("dtype,masked,bodies", [
    (torch.bfloat16, False, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float16, False, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float32, False, ("flash_bwd_d", "flash_bwd_d")),
    (torch.bfloat16, True, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float16, True, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float32, True, ("flash_bwd_d", "flash_bwd_d")),
])
def test_backward_runs_the_body_of_its_type(cuda, dtype, masked, bodies):
    """bf16 / fp16 K2 / K3 and K5 / K6 run the Hopper kernels (K2 with its
    reduce where it splits, K5 never split), fp32 the template; the
    profiler attribution books each to its own counter."""
    from mmpl_tpu_torch.utils.profiling import port_kernel_of
    q, k, v, do = _bwd_inputs(500, 300, 64, dtype, cuda)
    mask = _mask(500, 100, cuda, blind=False) if masked else None
    mask = (mask[0], mask[1][:300], mask[2]) if masked else None
    tiles = ta.mask_tiles(*mask) if masked else None
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    prefix = "flash_masked_bwd" if masked else "flash_bwd"
    names = _launched(lambda: ta.flash_bwd_cuda(q, k, v, do, lse, delta, None,
                                                mask, tiles))
    for part, body in zip(("dkv", "dq"), bodies):
        mine = [n for n in names if port_kernel_of(n) == f"{prefix}_{part}"]
        main = [n for n in mine if "_reduce_kernel" not in n]
        assert len(main) == 1 and body in main[0], names
        assert ("_sm90_kernel" in main[0]) is (body == "_sm90_kernel")
        assert len(mine) - len(main) == (
            part == "dkv" and body == "_sm90_kernel" and not masked
            and ta.bwd_query_splits(2, 3, 500, 300, torch.cuda
                                    .get_device_properties(cuda)
                                    .multi_processor_count) > 1), names


def test_autograd_launches_unmasked_k2_and_k3_once(cuda):
    """At a shape where K2 splits the queries, one backward through
    `flash_attention` counts one K2 launch (its reduce included) and one
    K3 launch."""
    q, k, v = (x.requires_grad_(True)
               for x in _qkv(4096, 128, 128, torch.bfloat16, cuda, N=2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ta.bwd_query_splits(2, 2, 4096, 128, sms) > 1
    ta.reset_launch_counts()
    ta.flash_attention(q, k, v).float().sum().backward()
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 0),
                                "flash_fwd": 1, "flash_bwd_dkv": 1,
                                "flash_bwd_dq": 1}
    for x in (q, k, v):
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()


# ---------------------------------------------------------------------------
# P2 and Q (csrc/int8_gemm.cu)
# ---------------------------------------------------------------------------

def _int8(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(
        np.int8)).to(device)


def _ulps(got, want):
    """Largest distance in units in the last place (same-sign values)."""
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.view(view).long() - want.view(view).long()).abs().max().item()


@pytest.mark.parametrize("m,k,n", [(1000, 96, 200), (129, 16, 3),
                                   (300, 1552, 130), (64, 8960, 72)])
def test_int8_gemm_accumulator_is_exact(cuda, m, k, n):
    from mmpl_tpu_torch.ops import quant
    a, b = _int8((m, k), 0, cuda), _int8((n, k), 1, cuda)
    got = quant.int8_gemm_cuda(a, b, None, None, torch.int32)
    want = quant.int8_gemm_plain(a, b, None, None, torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1000, 96, 200), (77, 48, 31)])
def test_w8a8_kernels_match_plain(cuda, act, out, m, k, n):
    """Q's codes and scales exactly, P2's output within 1 ulp."""
    from mmpl_tpu_torch.ops import quant
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         * 3).to(cuda, act)
    x[5] = 0                                  # an all-zero row: s = 1e-12
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                         ).to(cuda)
    wq, sw = quant.quantize_weight(w)
    xq, sx = quant.quantize_rows_cuda(x)
    pq, psx = quant.quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, psx)
    assert not xq[5].any() and sx[5].item() == np.float32(1e-12)
    got = quant.int8_gemm_cuda(xq, wq, sx, sw, out)
    want = quant.int8_gemm_plain(xq, wq, sx, sw, out)
    assert got.dtype == out and _ulps(got, want) <= 1


@pytest.mark.parametrize("case", ["k_not_16", "a_float", "b_int16",
                                  "a_strided", "b_transposed", "sx_f64",
                                  "out_f16", "x_int8", "x_strided"])
def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda, case):
    from mmpl_tpu_torch.ops import quant
    a, b = _int8((64, 96), 0, cuda), _int8((32, 96), 1, cuda)
    sx = torch.ones(64, device=cuda)
    sw = torch.ones(32, device=cuda)
    x = torch.randn((64, 96), device=cuda)
    calls = {
        "k_not_16": lambda: quant.int8_gemm_cuda(a[:, :40].contiguous(),
                                                 b[:, :40].contiguous(),
                                                 sx, sw),
        "a_float": lambda: quant.int8_gemm_cuda(a.float(), b, sx, sw),
        "b_int16": lambda: quant.int8_gemm_cuda(a, b.to(torch.int16), sx, sw),
        "a_strided": lambda: quant.int8_gemm_cuda(
            _int8((64, 192), 3, cuda)[:, ::2], b, sx, sw),
        "b_transposed": lambda: quant.int8_gemm_cuda(
            a, _int8((96, 32), 4, cuda).t(), sx, sw),
        "sx_f64": lambda: quant.int8_gemm_cuda(a, b, sx.double(), sw),
        "out_f16": lambda: quant.int8_gemm_cuda(a, b, sx, sw, torch.float16),
        "x_int8": lambda: quant.quantize_rows_cuda(a),
        "x_strided": lambda: quant.quantize_rows_cuda(
            torch.randn((64, 192), device=cuda)[:, :96]),
    }
    quant.reset_launch_counts()
    with pytest.raises(ValueError):
        calls[case]()
    assert quant.launch_counts == {"int8_gemm": 0, "quantize_rows": 0}


# The Hopper P2 at every tile width (N = 3 .. 8960 take tiles of 16, 128,
# 256 and 128), the ragged and the 16-byte K, the staged (TMA-store) and
# the register epilogue (N = 3 and odd or narrow rows take the latter).
P2_M = (1, 1000, 6240)
P2_K = (16, 96, 432, 1536, 8960)
P2_N = (3, 96, 200, 384, 1536, 8960)


def _codes(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, device=device,
                         dtype=torch.int8)


@pytest.mark.parametrize("n", P2_N)
@pytest.mark.parametrize("k", P2_K)
@pytest.mark.parametrize("m", P2_M)
def test_hopper_p2_accumulator_is_exact(cuda, m, k, n):
    from mmpl_tpu_torch.ops import quant
    a, b = _codes((m, k), m + k, cuda), _codes((n, k), n + 1, cuda)
    got = quant.int8_gemm_cuda(a, b, None, None, torch.int32)
    want = quant.int8_gemm_plain(a, b, None, None, torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_sx", [True, False])
@pytest.mark.parametrize("n", P2_N + (130,))
@pytest.mark.parametrize("k", P2_K)
def test_hopper_p2_scaled_output_within_one_ulp(cuda, k, n, with_sx, out):
    from mmpl_tpu_torch.ops import quant
    m = 1000
    a, b = _codes((m, k), k, cuda), _codes((n, k), n, cuda)
    g = torch.Generator(device=cuda).manual_seed(k + n)
    sx = torch.rand(m, generator=g, device=cuda) if with_sx else None
    sw = torch.rand(n, generator=g, device=cuda) * 1e-3
    got = quant.int8_gemm_cuda(a, b, sx, sw, out)
    want = quant.int8_gemm_plain(a, b, sx, sw, out)
    assert got.dtype == out and _ulps(got, want) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [16, 1536, 8960, 16400])
def test_q_codes_and_scales_are_exact(cuda, k, dtype):
    """Bit for bit at rows a warp holds (16, 1536), a block holds (8960)
    and the two-read loop takes (16400), with an all-zero row and a row
    that one huge value dominates; the body that ran."""
    from mmpl_tpu_torch.ops import quant
    g = torch.Generator(device=cuda).manual_seed(k)
    x = (3 * torch.randn((300, k), generator=g, device=cuda)).to(dtype)
    x[3] = 0
    x[4, k // 2] = 1e30
    out = []
    names = _launched(lambda: out.append(quant.quantize_rows_cuda(x)))
    q, s = out[-1]
    pq, ps = quant.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert not q[3].any() and s[3].item() == np.float32(1e-12)
    assert q[4, k // 2].item() == 127 and q[4].abs().sum().item() == 127
    body = ("quantize_rows_sm90_kernel" if quant.q_row_warps(k)
            else "quantize_rows_kernel<")
    assert len(names) == 1 and body in next(iter(names)), names


@pytest.mark.parametrize("n", [3, 32, 64, 96, 384, 8960])
def test_p2_runs_the_hopper_body_at_its_tile_width(cuda, n):
    from mmpl_tpu_torch.ops import quant
    a, b = _codes((500, 96), 0, cuda), _codes((n, 96), 1, cuda)
    sw = torch.ones(n, device=cuda)
    names = _launched(lambda: quant.int8_gemm_cuda(a, b, None, sw))
    want = f"int8_gemm_sm90_kernel<{quant.p2_tile_n(n)}, __nv_bfloat16>"
    assert len(names) == 1 and want in next(iter(names)), names


@pytest.mark.parametrize("k", [1536, 8960])
def test_p2_and_q_repeat_bit_for_bit(cuda, k):
    from mmpl_tpu_torch.ops import quant
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((4000, k), generator=g, device=cuda).to(torch.bfloat16)
    wq, sw = quant.quantize_weight(torch.randn((1536, k), generator=g,
                                               device=cuda))
    first = quant.quantize_rows_cuda(x)
    again = quant.quantize_rows_cuda(x)
    assert all(torch.equal(u, v) for u, v in zip(first, again))
    ys = [quant.int8_gemm_cuda(first[0], wq, first[1], sw) for _ in range(2)]
    assert torch.equal(ys[0], ys[1])


def test_linear_launches_q_and_p2_once_per_w8a8_call(cuda):
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.ops import quant
    lin = torch.nn.Linear(96, 200, device=cuda, dtype=torch.bfloat16)
    x = torch.randn((2, 50, 96), device=cuda, dtype=torch.bfloat16)
    q8 = quant.QuantLinear.from_linear(lin)
    wo = quant.QuantLinear.from_linear(lin, weight_only=True)
    quant.reset_launch_counts()
    y = dit.linear(q8, x)
    dit.linear(wo, x)
    dit.linear(lin, x)
    assert quant.launch_counts == {"int8_gemm": 1, "quantize_rows": 1}
    assert y.shape == (2, 50, 200) and y.dtype == torch.bfloat16
    ref = dit.linear(lin, x).float()
    assert ((y.float() - ref).norm() / ref.norm()).item() < 0.02


def test_int8_conv_launches_p2_once_per_chunk(cuda, monkeypatch):
    """An int8 VAE conv on the card: one P2 launch per im2col chunk, and
    the same fp32 output as the CPU's plain path (both exact)."""
    from mmpl_tpu_torch.models import vae
    from mmpl_tpu_torch.ops import quant
    conv = vae.Conv(48, 32, (3, 3, 3))
    torch.nn.init.uniform_(conv.weight, -0.1, 0.1)
    torch.nn.init.uniform_(conv.bias, -0.1, 0.1)
    q = vae.QuantConv.from_conv(conv)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 48, 3, 5, 6)).astype(np.float32))
    want = vae._conv3d(q, x)
    monkeypatch.setattr(vae, "IM2COL_BYTES", 2 * 6 * 48 * 27)
    quant.reset_launch_counts()
    vae.int8_conv_counts.update(convs=0, chunks=0)
    got = vae._conv3d(q.to(cuda), x.to(cuda))
    assert vae.int8_conv_counts == {"convs": 1, "chunks": 9}
    assert quant.launch_counts == {"int8_gemm": 9, "quantize_rows": 0}
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_int8_cache_commit_launches_q_for_k_and_v_per_layer(cuda):
    """The commit forward codes each layer's k and v with Q (two launches
    per layer) and writes the same codes as the CPU's plain path, up to a
    flip by one where the fp32 attention's order of sums differs."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.models.fps_dit import init_kv_cache
    from mmpl_tpu_torch.ops import quant
    from mmpl_tpu_torch.pipelines.fps_inference import (
        CausalFPSInferencePipeline)
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(6)
    cond, uncond = (torch.from_numpy(rng.standard_normal(
        (1, cfg.text_len, cfg.text_dim)).astype(np.float32))
        for _ in range(2))
    schedule = CausalFPSInferencePipeline(cfg, copy.deepcopy(model)
                                          ).plan.groups[0]
    lat = torch.from_numpy(rng.standard_normal(
        (1, schedule.num_frames, 16, 4, 4)).astype(np.float32))
    caches, counts = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = CausalFPSInferencePipeline(cfg, copy.deepcopy(model).to(dev),
                                          quantize_cache=True,
                                          dtype=torch.float32)
        cache = init_kv_cache(cfg, 2, 4, KV_CACHE_SLOTS, torch.float32, dev,
                              quantize=True)
        quant.reset_launch_counts()
        with torch.inference_mode():
            pipe._forward(schedule, pipe.prepare_context(
                cond.to(dev), uncond.to(dev)), cache, lat.to(dev), 0.0, True)
        caches[dev] = {k: v.cpu() for k, v in cache.items()}
        counts[dev] = dict(quant.launch_counts)
    assert counts["cpu"] == {"int8_gemm": 0, "quantize_rows": 0}
    assert counts["cuda"] == {"int8_gemm": 0,
                              "quantize_rows": 2 * cfg.num_layers}
    got, want = caches["cuda"], caches["cpu"]
    for name in ("k", "v"):
        assert want[f"{name}_scale"].any()
        assert (got[name].int() - want[name].int()).abs().max().item() <= 1
        torch.testing.assert_close(got[f"{name}_scale"],
                                   want[f"{name}_scale"], rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# P1 (the exp2 probe's forward) and the few-step window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("mask_pad", [True, False])
@pytest.mark.parametrize("dtype,d,tol", [(torch.bfloat16, 128, 2e-2),
                                         (torch.float32, 24, 1e-5)])
def test_exp2_variants_match_plain_at_a_ragged_lq(cuda, use_exp2, mask_pad,
                                                  dtype, d, tol):
    """P1's four variants against their plain version (both round P to
    the input type) at Lq = 1000 (ragged) and Lk = 1280 (a multiple of
    64, so the variants without the pad test are defined)."""
    q, k, v = _qkv(1000, 1280, d, dtype, cuda, seed=3)
    ta.reset_launch_counts()
    got = ta.flash_attention_exp2(q, k, v, use_exp2, mask_pad)
    want = ta.flash_attention_exp2_plain(q, k, v, use_exp2, mask_pad)
    torch.cuda.synchronize()
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 0),
                                "flash_exp2": 1}
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_exp2_with_the_pad_test_matches_k1_at_a_ragged_lk(cuda):
    q, k, v = _qkv(300, 1300, 128, torch.bfloat16, cuda, seed=4)
    got = ta.flash_attention_exp2(q, k, v, use_exp2=True, mask_pad=True)
    want = ta.flash_fwd_cuda(q, k, v)[0]
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_exp2_refuses_mask_pad_false_on_a_ragged_lk(cuda):
    q, k, v = _qkv(64, 1300, 128, torch.bfloat16, cuda)
    ta.reset_launch_counts()
    with pytest.raises(ValueError, match="mask_pad=False"):
        ta.flash_attention_exp2(q, k, v, mask_pad=False)
    assert ta.launch_counts["flash_exp2"] == 0


def test_few_step_window_on_the_card(cuda):
    """A tiny fp32 few-step window (2 blocks, 2 steps) on the card against
    the CPU's plain path from the same weights and draws, with its K1
    launches: blocks x (steps + commit) x layers x (self + cross)."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.pipelines.causal_inference import (
        CausalInferencePipeline)
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(rng.standard_normal((1, 6, 16, 4, 4)).astype(
        np.float32))
    cond = torch.from_numpy(rng.standard_normal(
        (1, cfg.text_len, cfg.text_dim)).astype(np.float32))
    sn = [torch.from_numpy(rng.standard_normal((1, 1, 3, 16, 4, 4)).astype(
        np.float32)) for _ in range(2)]
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = CausalInferencePipeline(cfg, copy.deepcopy(model).to(dev),
                                       denoising_step_list=(1000, 500),
                                       dtype=torch.float32)
        ta.reset_launch_counts()
        out[dev] = pipe.inference(noise.to(dev), cond.to(dev),
                                  step_noise=sn).cpu()
    assert ta.launch_counts["flash_fwd"] == 2 * 3 * cfg.num_layers * 2
    rel = ((out["cuda"] - out["cpu"]).norm() / out["cpu"].norm()).item()
    assert rel <= 1e-4, rel


# ---------------------------------------------------------------------------
# The whole-clip i2v path: K1 at the CLIP tower's and the image
# cross-attention's shapes, the i2v DiT on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,o_tol", [(torch.bfloat16, 2e-2),
                                         (torch.float16, 5e-3),
                                         (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,N,d,lq,lk", [
    (1, 16, 80, 257, 257),       # ViT-H/14: 257 tokens, head dim 80
    (2, 4, 128, 1000, 257),      # image keys: the last tile holds 1 key
    (2, 4, 80, 300, 257)])
def test_k1_matches_plain_at_the_clip_and_image_shapes(cuda, dtype, o_tol,
                                                       B, N, d, lq, lk):
    o_err, lse_err = _errors(*_qkv(lq, lk, d, dtype, cuda, seed=d + lk,
                                   B=B, N=N))
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert o_err <= o_tol and lse_err <= lse_tol, (o_err, lse_err)


def test_k1_reads_the_clip_fused_qkv_at_head_dim_80(cuda):
    """CLIP's q, k and v are views of one [B, 257, 3, 16, 80] projection."""
    qkv = torch.randn((1, 257, 3, 16, 80), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    oc, lsec = ta.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    torch.testing.assert_close(o, oc, atol=0, rtol=0)
    torch.testing.assert_close(lse, lsec, atol=0, rtol=0)


def test_i2v_dit_forward_on_the_card(cuda):
    """The tiny fp32 i2v DiT's bidirectional forward with CLIP tokens and
    `y` on the card against the CPU, and its K1 launches: self, text and
    image attention in each layer."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    cfg = tiny_test_config("i2v")
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(8)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    args = (t(2, 3, 16, 4, 4), torch.tensor([937.0, 250.0]),
            t(2, cfg.text_len, cfg.text_dim))
    kw = {"clip_fea": t(2, 257, dit.CLIP_DIM), "y": t(2, 3, 20, 4, 4)}
    want = dit.dit_forward(model, cfg, *args, **kw)
    card = copy.deepcopy(model).to(cuda)
    ta.reset_launch_counts()
    got = dit.dit_forward(card, cfg, *(a.to(cuda) for a in args),
                          **{k: v.to(cuda) for k, v in kw.items()}).cpu()
    assert ta.launch_counts["flash_fwd"] == 3 * cfg.num_layers
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel
