"""K1-K6 and P1 (`mmpl_tpu_torch/csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`,
their Hopper bodies `csrc/flash_fwd_sm90.cuh` and `csrc/flash_bwd_sm90.cuh`,
which also run the bf16 / fp16 K4, K5, K6 and P1, under their schedules
`csrc/flash_fwd_sched_sm90.cuh` and `csrc/flash_bwd_sched_sm90.cuh`, and the
split-TF32 bodies
of fp32 K1 / P1, K2 / K5 and K3 / K6, `csrc/flash_fwd_f32_sm90.cuh`,
`csrc/flash_bwd_f32_sm90.cuh` and `csrc/flash_bwd_dq_f32_sm90.cuh`)
and
the int8 kernels P2 and Q (`csrc/int8_gemm.cu`, P2's Hopper body
`csrc/int8_gemm_sm90.cuh`) on the card: agreement with their plain
versions, the body each type runs, the dispatch's launch counts, and what
the wrappers refuse.

Needs an NVIDIA GPU and nvcc, not JAX; on the card run

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips where there is no CUDA device.
"""

import os
import time

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


@pytest.mark.parametrize("dtype,body", [
    (torch.bfloat16, "flash_fwd_persistent_sm90"),
    (torch.float16, "flash_fwd_persistent_sm90"),
    (torch.float32, "flash_fwd_f32_sm90")])
def test_k1_runs_the_body_of_its_type(cuda, dtype, body):
    """bf16 / fp16 K1 runs the Hopper kernel (at 300 keys its persistent
    walk), fp32 the split-TF32 Hopper kernel; the profiler attribution
    books each to K1."""
    from mmpl_tpu_torch.utils.profiling import port_kernel_of
    q, k, v = _qkv(200, 300, 64, dtype, cuda)
    names = _launched(lambda: ta.flash_fwd_cuda(q, k, v))
    mine = [n for n in names if port_kernel_of(n) == "flash_fwd"]
    assert len(mine) == 1 and body in mine[0], names


# ---------------------------------------------------------------------------
# bf16 / fp16 K1's schedules (csrc/flash_fwd_sched_sm90.cuh): the persistent
# walk and the key split with its merge, forced through `fwd_schedule`
# ---------------------------------------------------------------------------

#: the kernel each schedule launches (the split also its merge)
SCHEDULE_KERNELS = {"grid": "flash_fwd_sm90_kernel",
                    "persistent": "flash_fwd_persistent_sm90_kernel",
                    "split": "flash_fwd_split_sm90_kernel"}


def _force(monkeypatch, mode, lk):
    """Make K1 run `mode`: the split over min(3, key tiles) ranges."""
    splits = min(3, -(-lk // ta.FWD_BLOCK)) if mode == "split" else 1
    monkeypatch.setattr(ta, "fwd_schedule", lambda *a: (mode, splits))
    return splits


def _schedule_of(names):
    mine = [n for n in names if "flash_fwd" in n and "merge" not in n]
    assert len(mine) == 1, names
    merged = any("flash_fwd_merge_kernel" in n for n in names)
    mode = next(m for m, k in SCHEDULE_KERNELS.items() if k in mine[0])
    assert merged is (mode == "split"), names
    return mode


SCHEDULE_CASES = [(mode, lq, lk, d)
                  for mode in ("persistent", "split")
                  for lq in (1, 7, 128, 129)
                  for lk in (1, 127, 257, 512, 32760)
                  for d in (24, 80, 128)
                  if mode == "persistent" or lk > ta.FWD_BLOCK]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode,lq,lk,d", SCHEDULE_CASES)
def test_k1_schedules_match_plain(cuda, monkeypatch, mode, lq, lk, d, dtype):
    """The persistent walk and the key split against the plain version at
    the chooser's edges: one and a few query rows, a whole and a ragged
    query block, one key, a ragged tile, 257 and 512 keys, 32760 keys,
    head dims below 128 (the schedules pad every head dim to 128); each
    call launches K1 once, booked to its schedule."""
    _force(monkeypatch, mode, lk)
    q, k, v = _qkv(lq, lk, d, dtype, cuda, seed=lq + lk + d)
    ta.reset_launch_counts()
    o_err, lse_err = _errors(q, k, v)
    assert ta.launch_counts["flash_fwd"] == 1
    assert ta.fwd_mode_launches == {**dict.fromkeys(ta.fwd_mode_launches, 0),
                                    mode: 1}
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-3
    assert o_err <= tol and lse_err <= 1e-3, (o_err, lse_err)


@pytest.mark.parametrize("mode", ["persistent", "split"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float16, 80)])
def test_k1_schedules_read_the_fused_qkv_in_place(cuda, monkeypatch, mode,
                                                  dtype, d):
    """q, k, v as views of one fused [B, L, 3 * N * D] projection."""
    _force(monkeypatch, mode, 700)
    qkv = torch.randn((2, 700, 3 * 4 * d), generator=torch.Generator(
        device=cuda).manual_seed(d), device=cuda).to(dtype)
    q, k, v = (x.unflatten(-1, (4, d)) for x in qkv.chunk(3, -1))
    assert q.stride(1) == 3 * 4 * d
    o_err, lse_err = _errors(q, k, v)
    assert o_err <= 2e-2 and lse_err <= 1e-3, (o_err, lse_err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_split_gives_the_same_bits_on_every_call(cuda, monkeypatch,
                                                    dtype):
    """The merge folds the splits in a fixed order, not with atomics."""
    _force(monkeypatch, "split", 5000)
    q, k, v = _qkv(3, 5000, 128, dtype, cuda, seed=4)
    first = ta.flash_fwd_cuda(q, k, v)
    for _ in range(3):
        for x, y in zip(ta.flash_fwd_cuda(q, k, v), first):
            assert torch.equal(x, y)


def test_k1_split_matches_its_plain_version(cuda, monkeypatch):
    """The split kernels and the plain split path agree (both round P
    and merge the same ranges in the same order)."""
    splits = _force(monkeypatch, "split", 1000)
    q, k, v = _qkv(130, 1000, 128, torch.bfloat16, cuda, seed=6)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    po, plse = ta.flash_attention_split_plain(q, k, v, splits)
    torch.cuda.synchronize()
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,N,lq,lk", [(2, 12, 1024, 8192),
                                       (2, 12, 1000, 512),
                                       (2, 12, 1, 32760)])
def test_k1_runs_the_schedule_the_chooser_names(cuda, B, N, lq, lk):
    """The kernel the profiler sees is the one of `fwd_schedule`'s mode
    (on an H100: a long shape on the grid, 512 keys on the persistent
    walk, one query row over 32760 keys split), one K1 launch a call."""
    q, k, v = _qkv(lq, lk, 128, torch.bfloat16, cuda, B=B, N=N)
    want, _ = ta.fwd_schedule(B, N, lq, lk, 128, ta._sm_count(cuda.index or 0))
    ta.reset_launch_counts()
    names = _launched(lambda: ta.flash_fwd_cuda(q, k, v))
    assert _schedule_of(names) == want
    calls = ta.launch_counts["flash_fwd"]
    assert calls >= 1 and ta.fwd_mode_launches[want] == calls


@pytest.mark.parametrize("dtype,body", [
    (torch.bfloat16, "flash_exp2_sm90_kernel"),
    (torch.float16, "flash_exp2_sm90_kernel"),
    (torch.float32, "flash_exp2_f32_sm90_kernel")])
def test_p1_runs_the_body_of_its_type(cuda, dtype, body):
    """bf16 / fp16 P1 runs the Hopper kernel, fp32 the P1 kernel of K1's
    split-TF32 body; the profiler books both to P1."""
    from mmpl_tpu_torch.utils.profiling import port_kernel_of
    q, k, v = _qkv(200, 320, 64, dtype, cuda)
    for use_exp2 in (False, True):
        for mask_pad in (False, True):
            names = _launched(lambda: ta.flash_exp2_cuda(q, k, v, use_exp2,
                                                         mask_pad))
            mine = [n for n in names if port_kernel_of(n) == "flash_exp2"]
            assert len(mine) == 1 and body in mine[0], names
            assert ("_f32_" in mine[0]) is (dtype == torch.float32), names


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
    (torch.float32, "flash_masked_fwd_f32_sm90_kernel"),
])
def test_masked_forward_runs_the_body_of_its_type(cuda, dtype, body):
    """bf16 / fp16 K4 runs the Hopper kernel (the masked instantiation of
    K1's body), fp32 the masked kernel of fp32 K1's split-TF32 body; the
    profiler books each to K4."""
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


# ---------------------------------------------------------------------------
# K2 and K3 under their schedules (csrc/flash_bwd_sched_sm90.cuh): the fused
# walk and its dQ reduce where the queries fit one 64-row tile, K3's
# persistent walk at short keys, the ordered walk and its dQ out kernel at
# long keys
# ---------------------------------------------------------------------------

#: the kernel that computes dQ under each schedule
BWD_SCHEDULE_KERNELS = {"grid": "flash_bwd_dq_sm90_kernel",
                        "persistent": "flash_bwd_dq_persistent_sm90_kernel",
                        "fused": "flash_bwd_fused_sm90_kernel",
                        "ordered": "flash_bwd_ordered_sm90_kernel"}


def _force_bwd(monkeypatch, mode):
    monkeypatch.setattr(ta, "bwd_schedule", lambda *a: mode)


def _bwd_schedule_of(names):
    """The schedule that ran among the profiler's `names`: the fused walk
    with its reduce, or the ordered walk with its dQ out kernel, and no
    K2 / K3 kernel of the grid, or K3's grid or persistent kernel beside
    K2's."""
    fused = [n for n in names if "flash_bwd_fused_sm90_kernel" in n]
    ordered = [n for n in names if "flash_bwd_ordered_sm90_kernel" in n]
    out = any("flash_bwd_ordered_out_kernel" in n for n in names)
    reduced = any("flash_bwd_dq_reduce_kernel" in n for n in names)
    dq = [n for n in names if "flash_bwd_dq" in n and "reduce" not in n]
    dkv = [n for n in names if "flash_bwd_dkv_sm90_kernel" in n]
    if fused:
        assert reduced and not dq and not dkv and not out, names
        return "fused"
    if ordered:
        assert out and not dq and not dkv and not reduced, names
        return "ordered"
    assert len(dq) == 1 and len(dkv) == 1 and not reduced and not out, \
        names
    return ("persistent" if BWD_SCHEDULE_KERNELS["persistent"] in dq[0]
            else "grid")


BWD_SCHEDULE_CASES = [(mode, lq, lk, d)
                      for mode in ("fused", "persistent")
                      for lq in (1, 7, 64, 65, 129)
                      for lk in (1, 127, 128, 257, 512, 32760)
                      for d in (24, 80, 128)
                      if mode == "persistent" or lq <= ta.BWD_QUERY_TILE]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode,lq,lk,d", BWD_SCHEDULE_CASES)
def test_bwd_schedules_match_plain(cuda, monkeypatch, mode, lq, lk, d,
                                   dtype):
    """The fused walk and K3's persistent walk against the plain backward
    at the chooser's edges: one, a few and a whole tile of query rows, a
    ragged query block and more than one, one key, a ragged and a whole key
    tile, 257, 512 and 32760 keys, head dims below 128 (both walks pad
    every head dim to 128); each call counts one K2 and one K3 launch,
    booked to its schedule.  With one key, dS = p (dP - delta) is 0 but
    for rounding (p = 1, delta = dO . v = dP), so dQ and dK are held to a
    bound on their size instead of a relative error."""
    _force_bwd(monkeypatch, mode)
    ta.reset_launch_counts()
    got, errs = _bwd_errors(*_bwd_inputs(lq, lk, d, dtype, cuda,
                                         seed=lq + lk + d))
    assert ta.launch_counts["flash_bwd_dkv"] == 1
    assert ta.launch_counts["flash_bwd_dq"] == 1
    assert ta.bwd_mode_launches == {
        **dict.fromkeys(ta.bwd_mode_launches, 0), mode: 1}
    if lk == 1:
        assert all(g.float().abs().max().item() <= 1e-3 for g in got[:2])
        errs = errs[2:]
    assert max(errs) <= 1e-2, errs


@pytest.mark.parametrize("mode", ["fused", "persistent", "ordered"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float16, 80)])
def test_bwd_schedules_read_views_in_place(cuda, monkeypatch, mode, dtype,
                                           d):
    """q / k / v as views of one fused [B, L, 3 * N * D] projection and dO
    as a strided view: against the plain version, and bit for bit against
    the same call on contiguous copies."""
    _force_bwd(monkeypatch, mode)
    B, N = 2, 4
    lq, lk = (40, 700) if mode == "fused" else (300, 700)
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((B, lq, 3 * N * d), generator=gen,
                    device=cuda).to(dtype)[..., :N * d].unflatten(-1, (N, d))
    kv = torch.randn((B, lk, 3 * N * d), generator=gen,
                     device=cuda).to(dtype)
    k, v = (x.unflatten(-1, (N, d)) for x in kv.chunk(3, -1)[1:])
    do = torch.randn((B, lq, N, 2, d), generator=gen,
                     device=cuda).to(dtype)[:, :, :, 1]
    assert not (q.is_contiguous() or do.is_contiguous())
    got, errs = _bwd_errors(q, k, v, do)
    assert max(errs) <= 1e-2, errs
    dense, _ = _bwd_errors(*(x.contiguous() for x in (q, k, v, do)))
    for x, y in zip(got, dense):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_bwd_gives_the_same_bits_on_every_call(cuda, monkeypatch,
                                                     dtype):
    """The reduce sums dQ's partials in a fixed order, not with atomics."""
    _force_bwd(monkeypatch, "fused")
    q, k, v, do = _bwd_inputs(5, 5000, 128, dtype, cuda, seed=4)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    first = ta.flash_bwd_cuda(q, k, v, do, lse, delta)
    for _ in range(3):
        for x, y in zip(ta.flash_bwd_cuda(q, k, v, do, lse, delta), first):
            assert torch.equal(x, y)


#: (lq, lk, d) of the ordered walk: one query row and one key, ragged and
#: whole 64-query tiles and 128-key blocks, several blocks, D = 24 / 80 /
#: 128
ORDERED_CASES = [(1, 1, 24), (7, 127, 80), (64, 128, 128), (65, 129, 24),
                 (129, 257, 128), (1000, 1300, 128), (1000, 1300, 24),
                 (300, 4000, 80), (4680, 1025, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lq,lk,d", ORDERED_CASES)
def test_ordered_bwd_matches_plain(cuda, monkeypatch, lq, lk, d, dtype):
    """The ordered walk against the plain backward and its own plain
    version (dQ's shares added in key-block order), one K2 and one K3
    launch booked to it; with one key dS is 0 but for rounding, so dQ and
    dK are held to a bound on their size."""
    _force_bwd(monkeypatch, "ordered")
    ta.reset_launch_counts()
    q, k, v, do = _bwd_inputs(lq, lk, d, dtype, cuda, seed=lq + lk + d)
    got, errs = _bwd_errors(q, k, v, do)
    assert ta.launch_counts["flash_bwd_dkv"] == 1
    assert ta.launch_counts["flash_bwd_dq"] == 1
    assert ta.bwd_mode_launches == {
        **dict.fromkeys(ta.bwd_mode_launches, 0), "ordered": 1}
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    want = ta.flash_attention_bwd_ordered_plain(q, k, v, do, lse, delta)
    if lk == 1:
        assert all(g.float().abs().max().item() <= 1e-3 for g in got[:2])
        got, want, errs = got[2:], want[2:], errs[2:]
    assert max(errs) <= 1e-2, errs
    assert max(_rel(g, w) for g, w in zip(got, want)) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ordered_bwd_gives_the_same_bits_on_every_call(cuda, monkeypatch,
                                                       dtype):
    """dQ's shares are added in key-block order (counters between the
    blocks), not as they arrive: the same bits on every call, at a shape
    whose 1,536 units (64 key blocks x 12 heads x 2) are more than the
    card's SMs, so that the waits cross blocks and rounds of the walk and
    must finish."""
    _force_bwd(monkeypatch, "ordered")
    q, k, v, do = _bwd_inputs(1000, 8192, 128, dtype, cuda, seed=8, N=12)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert -(-8192 // ta.BWD_KEY_BLOCK) * 12 * 2 > sms
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    first = ta.flash_bwd_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for _ in range(3):
        for x, y in zip(ta.flash_bwd_cuda(q, k, v, do, lse, delta), first):
            assert torch.equal(x, y)
    want = ta.flash_attention_bwd_ordered_plain(q, k, v, do, lse, delta)
    assert max(_rel(g, w) for g, w in zip(first, want)) <= 1e-2


def test_ordered_bwd_runs_its_walk_and_the_parts_the_grid(cuda):
    """At a long shape the profiler sees the ordered walk and its dQ out
    kernel for the whole backward (`flash_bwd_cuda`), and K2's and K3's
    grid kernels for the parts asked for alone."""
    q, k, v, do = _bwd_inputs(1000, 2000, 128, torch.bfloat16, cuda, N=12)
    assert ta.bwd_schedule(2, 12, 1000, 2000, 128,
                           ta._sm_count(cuda.index or 0)) == "ordered"
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    whole = _launched(lambda: ta.flash_bwd_cuda(q, k, v, do, lse, delta))
    assert _bwd_schedule_of(whole) == "ordered"
    dkv = _launched(lambda: ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
    dq = _launched(lambda: ta.flash_bwd_dq_cuda(q, k, v, do, lse, delta))
    assert any("flash_bwd_dkv_sm90_kernel" in n for n in dkv), dkv
    assert any("flash_bwd_dq_sm90_kernel" in n for n in dq), dq
    assert not any("ordered" in n for n in dkv | dq), (dkv, dq)


def test_fused_bwd_matches_its_plain_version(cuda, monkeypatch):
    """The fused walk and its plain version agree (both round nothing
    before the partials and sum them in the reduce's order)."""
    _force_bwd(monkeypatch, "fused")
    q, k, v, do = _bwd_inputs(33, 3000, 128, torch.bfloat16, cuda, seed=6)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_bwd_cuda(q, k, v, do, lse, delta)
    want = ta.flash_attention_bwd_fused_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-2


@pytest.mark.parametrize("B,N,lq,lk", [(2, 12, 1000, 8192),
                                       (1, 12, 4096, 512),
                                       (2, 12, 1, 32760)])
def test_bwd_runs_the_schedule_the_chooser_names(cuda, B, N, lq, lk):
    """The kernels the profiler sees are those of `bwd_schedule`'s mode
    (on an H100: a long shape at 12 heads on the ordered walk, 512 keys on
    K3's persistent walk, one query row over 32760 keys fused), one K2 and
    one K3 launch a call."""
    q, k, v, do = _bwd_inputs(lq, lk, 128, torch.bfloat16, cuda, B=B, N=N)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    want = ta.bwd_schedule(B, N, lq, lk, 128, ta._sm_count(cuda.index or 0))
    ta.reset_launch_counts()
    names = _launched(lambda: ta.flash_bwd_cuda(q, k, v, do, lse, delta))
    assert _bwd_schedule_of(names) == want
    calls = ta.launch_counts["flash_bwd_dq"]
    assert calls >= 1 and ta.launch_counts["flash_bwd_dkv"] == calls
    assert ta.bwd_mode_launches[want] == calls


@pytest.mark.parametrize("dtype,masked,bodies", [
    (torch.bfloat16, False, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float16, False, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float32, False, ("_f32_sm90_kernel", "_f32_sm90_kernel")),
    (torch.bfloat16, True, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float16, True, ("_sm90_kernel", "_sm90_kernel")),
    (torch.float32, True, ("_f32_sm90_kernel", "_f32_sm90_kernel")),
])
def test_backward_runs_the_body_of_its_type(cuda, dtype, masked, bodies):
    """bf16 / fp16 K2 / K3 and K5 / K6 run the Hopper kernels (K2 with its
    reduce where it splits, K5 never split), fp32 K2, K3, K5 and K6 the
    split-TF32 Hopper kernels; the profiler attribution books each to its
    own counter."""
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
        assert ("_sm90_kernel" in main[0]) is ("_sm90_kernel" in body)
        assert ("_f32_sm90_kernel" in main[0]) is (body == "_f32_sm90_kernel")
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
# The split-TF32 bodies of fp32 K1 and K2 (csrc/flash_fwd_f32_sm90.cuh,
# csrc/flash_bwd_f32_sm90.cuh): 64-row K1 blocks over 32-key stages, 64-key
# K2 blocks over 32-query tiles, D padded to 64 or 128
# ---------------------------------------------------------------------------

#: fp32 K1 and K2 against their plain versions: O and lse by the largest
#: difference, dK and dV also by the relative norm (chip_smoke.py's
#: GRAD_REL_TOL for fp32)
F32_TOL = 1e-4
F32_REL_TOL = 1e-5


def _f32_views(lq, lk, d, cuda, seed):
    """q, k, v and dO as strided views: q, k, v of one fused [B, L, 3 N D]
    projection when Lq = Lk (the DiT's self-attention), else q of a wider
    row and k, v of one fused [B, Lk, 2 N D]; dO one of two interleaved."""
    B, N = 2, 3
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda)
    if lq == lk:
        q, k, v = (x.unflatten(-1, (N, d))
                   for x in rnd(B, lq, 3 * N * d).chunk(3, -1))
    else:
        q = rnd(B, lq, N, d + 8)[..., 8:]
        k, v = (x.unflatten(-1, (N, d)) for x in rnd(B, lk, 2 * N * d)
                .chunk(2, -1))
    do = rnd(B, lq, N, 2, d)[:, :, :, 1]
    return q, k, v, do


def _f32_errors(q, k, v, do):
    """K1's largest O and lse differences and K2's dK / dV relative and
    largest differences against the plain versions, K2 and the plain
    backward fed the plain lse and delta."""
    o, lse = ta.flash_fwd_cuda(q, k, v)
    po, plse = ta.flash_attention_plain(q, k, v)
    delta = (do * po).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = ta.flash_bwd_dkv_cuda(q, k, v, do, plse, delta)
    _, pdk, pdv = ta.flash_attention_bwd_plain(q, k, v, do, plse, delta)
    torch.cuda.synchronize()
    for x, name in ((o, "o"), (lse, "lse"), (dk, "dk"), (dv, "dv")):
        assert torch.isfinite(x).all(), name
    return {"o": (o - po).abs().max().item(),
            "lse": (lse - plse).abs().max().item(),
            "dk": (dk - pdk).abs().max().item(),
            "dv": (dv - pdv).abs().max().item(),
            "dk_rel": _rel(dk, pdk), "dv_rel": _rel(dv, pdv)}


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("d", [24, 64, 80, 128])
@pytest.mark.parametrize("lq,lk", [(1000, 1300), (777, 777), (1, 500),
                                   (65, 33)])
def test_fp32_k1_and_k2_on_the_tf32_bodies_match_plain(cuda, lq, lk, d,
                                                       strided):
    """Ragged Lq and Lk against the 64-row block, the 32-key stage and the
    32-query tile (one query row; a last stage of one key), every head-dim
    width, contiguous operands and strided views."""
    if strided:
        q, k, v, do = _f32_views(lq, lk, d, cuda, seed=lq + d)
        assert not (q.is_contiguous() or k.is_contiguous()
                    or do.is_contiguous())
    else:
        q, k, v, do = _bwd_inputs(lq, lk, d, torch.float32, cuda, seed=lq + d)
    err = _f32_errors(q, k, v, do)
    assert max(err["o"], err["lse"], err["dk"], err["dv"]) <= F32_TOL, err
    assert max(err["dk_rel"], err["dv_rel"]) <= F32_REL_TOL, err


def test_fp32_k2_padding_keys_stay_finite_under_a_very_negative_lse(cuda):
    """As the bf16 case: every lse near -93, so the keys past Lk (which
    score 0) must get p = 0 in the split-TF32 K2, not exp(93) times 0.
    The bound is looser than F32_REL_TOL: each score is a sum of
    magnitude ~1,128 before the scale, whose last bits (the tensor cores'
    sums, fp32's own ulp) move p by ~1e-4 in either implementation."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.float32, cuda, seed=9)
    q[..., 0] = -1128.0
    k[..., 0] = 1.0
    _, lse = ta.flash_fwd_cuda(q, k, v)
    assert lse.max().item() < -80, lse.max().item()
    err = _f32_errors(q, k, v, do)
    assert max(err["dk_rel"], err["dv_rel"]) <= 1e-3, err


def test_fp32_k1_and_k2_give_the_same_bits_on_every_call(cuda):
    """No atomics and no split: each block owns its outputs."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.float32, cuda, seed=4)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    first = (o, lse, *ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
    for _ in range(2):
        again = (*ta.flash_fwd_cuda(q, k, v),
                 *ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
        for x, y in zip(again, first):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The split-TF32 body of fp32 K3 and K6 (csrc/flash_bwd_dq_f32_sm90.cuh):
# 64-row blocks over 32-key tiles, D padded to 64 or 128; K6 walks the
# 64 x 64 table, an entry two tiles
# ---------------------------------------------------------------------------

def _f32_mask(lq, lk, cuda, unseen=False):
    """Frame ids of lq queries and lk keys in ten frames, a block-causal
    mask over them with frame 1 blind (its rows see no key) and, with
    `unseen`, frame 2 seen by nothing (its keys get dK = dV = 0)."""
    from mmpl_tpu_torch.training import masks
    F = 10
    S = -(-max(lq, lk) // F)
    fm = masks.blockwise_causal_frame_mask(F, 3)
    fm[1] = False
    if unseen:
        fm[:, 2] = False
    ids = lambda L: torch.as_tensor(np.repeat(np.arange(F), S)[:L],
                                    dtype=torch.int32, device=cuda)
    return ids(lq), ids(lk), torch.as_tensor(fm, device=cuda)


def _f32_dq_errors(q, k, v, do, mask=None):
    """K3's (or, with `mask`, K6's) dQ against the plain version, both fed
    the plain lse and delta: its largest and relative differences; K6's
    blind rows must get dQ = 0."""
    tiles = None if mask is None else ta.mask_tiles(*mask)
    if mask is None:
        po, plse = ta.flash_attention_plain(q, k, v)
    else:
        po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    delta = (do * po).sum(-1).permute(0, 2, 1).contiguous()
    dq = ta.flash_bwd_dq_cuda(q, k, v, do, plse, delta, None, mask, tiles)
    if mask is None:
        pdq = ta.flash_attention_bwd_plain(q, k, v, do, plse, delta)[0]
    else:
        pdq = ta.frame_masked_attention_bwd_plain(q, k, v, do, plse, delta,
                                                  *mask)[0]
        assert torch.all(dq[:, mask[0] == 1] == 0)
    torch.cuda.synchronize()
    assert torch.isfinite(dq).all()
    return {"dq": (dq - pdq).abs().max().item(), "dq_rel": _rel(dq, pdq)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("d", [24, 64, 80, 128])
@pytest.mark.parametrize("lq,lk", [(1000, 1300), (777, 777), (1, 500),
                                   (65, 33)])
def test_fp32_k3_and_k6_on_the_tf32_body_match_plain(cuda, lq, lk, d,
                                                     strided, masked):
    """Ragged Lq and Lk against the 64-row block and the 32-key tile (one
    query row; a last tile of one key; an odd count of 32-key tiles, whose
    last 64 x 64 entry covers one), every head-dim width, contiguous
    operands and strided views, unmasked and under a mask with a blind
    frame."""
    if strided:
        q, k, v, do = _f32_views(lq, lk, d, cuda, seed=lq + d + 1)
        assert not (q.is_contiguous() or k.is_contiguous()
                    or do.is_contiguous())
    else:
        q, k, v, do = _bwd_inputs(lq, lk, d, torch.float32, cuda,
                                  seed=lq + d + 1)
    mask = _f32_mask(lq, lk, cuda) if masked else None
    err = _f32_dq_errors(q, k, v, do, mask)
    assert err["dq"] <= F32_TOL and err["dq_rel"] <= F32_REL_TOL, err


def test_fp32_k3_padding_keys_stay_finite_under_a_very_negative_lse(cuda):
    """K2's twin for dQ: every lse near -93, so the keys past Lk (which
    score 0) must get p = 0 in the split-TF32 K3, not exp(93) times 0 (the
    looser bound as K2's, for the same reason)."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.float32, cuda, seed=9)
    q[..., 0] = -1128.0
    k[..., 0] = 1.0
    _, lse = ta.flash_fwd_cuda(q, k, v)
    assert lse.max().item() < -80, lse.max().item()
    err = _f32_dq_errors(q, k, v, do)
    assert err["dq_rel"] <= 1e-3, err


def test_fp32_k3_and_k6_give_the_same_bits_on_every_call(cuda):
    """No atomics and no split of the key loop: each block owns its rows."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.float32, cuda, seed=5)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    mask = _f32_mask(1000, 1300, cuda)
    tiles = ta.mask_tiles(*mask)
    mo, mlse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    mdelta = (do * mo).sum(-1).permute(0, 2, 1).contiguous()
    calls = (lambda: ta.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
             lambda: ta.flash_bwd_dq_cuda(q, k, v, do, mlse, mdelta, None,
                                          mask, tiles))
    for call in calls:
        first = call()
        for _ in range(2):
            assert torch.equal(call(), first)


# ---------------------------------------------------------------------------
# fp32 K4, the masked kernel of fp32 K1's split-TF32 body
# (csrc/flash_fwd_f32_sm90.cuh): 64-query blocks walking their row of the
# 64 x 64 table, an entry two 32-key stages
# ---------------------------------------------------------------------------

def _late_frames():
    """(frame mask, token frame ids) in numpy: 1550 tokens in frames of
    100, even frames see the frames up to their own, odd frames only
    frames 11-15, frame 7 nothing.  Query block 15 (frames 9 and 10) walks
    all 49 key tiles, and frame 9's rows see their first key at tile 34,
    after two folds; block 12 holds frame 7's blind rows beside frame 8's,
    which walk 30 tiles (a fold while those rows have seen nothing).  The
    CPU model of fp32 K4 (`test_torch_attention_f32_masked.py`) walks it
    too."""
    f = np.arange(16)
    fm = np.where((f % 2 == 0)[:, None], f[None, :] <= f[:, None],
                  f[None, :] >= 11)
    fm[7] = False
    return fm, np.repeat(f, 100)[:1550]


def _late_mask(cuda):
    """`_late_frames` as the kernels take it, on the card."""
    fm, ids = _late_frames()
    ids = torch.as_tensor(ids, dtype=torch.int32, device=cuda)
    return ids, ids, torch.as_tensor(fm, device=cuda)


def _f32_k4_errors(q, k, v, mask):
    """K4's largest O and lse differences from the masked plain version;
    the rows that see no key must get O = 0 and lse = -inf exactly, and
    nothing may be NaN."""
    tiles = ta.mask_tiles(*mask)
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    torch.cuda.synchronize()
    blind = ~mask[2][mask[0].long()].any(1)
    assert torch.all(o[:, blind] == 0)
    assert torch.all(lse[:, :, blind] == -float("inf"))
    assert torch.equal(torch.isfinite(lse), torch.isfinite(plse))
    assert torch.isfinite(o).all()
    live = torch.isfinite(plse)
    return {"o": (o - po).abs().max().item(),
            "lse": (lse[live] - plse[live]).abs().max().item()
            if live.any() else 0.0}


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("d", [24, 64, 80, 128])
@pytest.mark.parametrize("lq,lk", [(1000, 1300), (777, 777), (1, 500),
                                   (65, 33)])
def test_fp32_k4_on_the_tf32_body_matches_plain(cuda, lq, lk, d, strided):
    """Ragged Lq and Lk against the 64-row block and the 32-key stage (one
    query row; a last stage of one key; an odd count of 32-key stages,
    whose last 64 x 64 entry covers one), every head-dim width, contiguous
    operands and strided views, under a mask with a blind frame and a
    frame that no query sees."""
    if strided:
        q, k, v, _ = _f32_views(lq, lk, d, cuda, seed=lq + d + 3)
        assert not (q.is_contiguous() or k.is_contiguous())
    else:
        q, k, v = _qkv(lq, lk, d, torch.float32, cuda, seed=lq + d + 3)
    err = _f32_k4_errors(q, k, v, _f32_mask(lq, lk, cuda, unseen=True))
    assert max(err.values()) <= F32_TOL, err


@pytest.mark.parametrize("kind", ["dead", "fps", "late"])
def test_fp32_k4_walks_empty_blocks_the_fps_mask_and_late_keys(cuda, kind):
    """"dead": frames of 300 where frame 1 sees nothing, so query blocks
    5-8 admit no tile and run only their epilogue; "fps": the fps-forcing
    mask of the teacher-forcing step over 42 frames of 40 tokens; "late"
    (`_late_mask`): rows whose first allowed key comes after two folds, and
    a fold while some rows have seen no key."""
    from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS
    from mmpl_tpu_torch.training import masks
    if kind == "dead":
        mask = _mask(1000, 300, cuda, unseen=True)
    elif kind == "fps":
        fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS)
        ids = torch.arange(fm.shape[0], dtype=torch.int32,
                           device=cuda).repeat_interleave(40)
        mask = (ids, ids, torch.as_tensor(fm, device=cuda))
    else:
        mask = _late_mask(cuda)
    t64 = ta.mask_tiles(*mask).t64
    if kind == "dead":
        assert (t64[5:9] == 0).all()
    if kind == "late":
        assert (t64[15] != 0).all() and (t64[12] != 0).sum() == 15
    L = mask[0].numel()
    q, k, v = _qkv(L, L, 128, torch.float32, cuda, seed=L)
    err = _f32_k4_errors(q, k, v, mask)
    assert max(err.values()) <= F32_TOL, err


def test_fp32_k4_gives_the_same_bits_on_every_call(cuda):
    """No atomics and no split of the key loop: each block owns its rows."""
    mask = _late_mask(cuda)
    tiles = ta.mask_tiles(*mask)
    q, k, v = _qkv(1550, 1550, 128, torch.float32, cuda, seed=7)
    first = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    for _ in range(2):
        for x, y in zip(ta.flash_fwd_cuda(q, k, v, None, mask, tiles), first):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# fp32 K5, the masked kernel of fp32 K2's split-TF32 body
# (csrc/flash_bwd_f32_sm90.cuh): 64-key blocks walking their column of the
# 64 x 64 table, an entry two 32-query tiles
# ---------------------------------------------------------------------------

def _f32_dkv_errors(q, k, v, do, mask):
    """K5's dK and dV against the masked plain backward, both fed the plain
    lse and delta: the largest and relative differences; the keys that no
    query sees (frame 2 under `_f32_mask(..., unseen=True)`) must get
    dK = dV = 0 exactly."""
    tiles = ta.mask_tiles(*mask)
    po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    delta = (do * po).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = ta.flash_bwd_dkv_cuda(q, k, v, do, plse, delta, None, mask,
                                   tiles)
    _, pdk, pdv = ta.frame_masked_attention_bwd_plain(q, k, v, do, plse,
                                                      delta, *mask)
    torch.cuda.synchronize()
    unseen = mask[1] == 2
    assert torch.all(dk[:, unseen] == 0) and torch.all(dv[:, unseen] == 0)
    for x, name in ((dk, "dk"), (dv, "dv")):
        assert torch.isfinite(x).all(), name
    return {"dk": (dk - pdk).abs().max().item(),
            "dv": (dv - pdv).abs().max().item(),
            "dk_rel": _rel(dk, pdk), "dv_rel": _rel(dv, pdv)}


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("d", [24, 64, 80, 128])
@pytest.mark.parametrize("lq,lk", [(1000, 1300), (777, 777), (1, 500),
                                   (65, 33)])
def test_fp32_k5_on_the_tf32_body_matches_plain(cuda, lq, lk, d, strided):
    """Ragged Lq and Lk against the 64-key block and the 32-query tile (one
    query row; an odd count of 32-query tiles, whose last 64 x 64 entry
    covers one), every head-dim width, contiguous operands and strided
    views, under a mask with a blind frame and a frame that no query
    sees."""
    if strided:
        q, k, v, do = _f32_views(lq, lk, d, cuda, seed=lq + d + 2)
        assert not (q.is_contiguous() or k.is_contiguous()
                    or do.is_contiguous())
    else:
        q, k, v, do = _bwd_inputs(lq, lk, d, torch.float32, cuda,
                                  seed=lq + d + 2)
    err = _f32_dkv_errors(q, k, v, do, _f32_mask(lq, lk, cuda, unseen=True))
    assert max(err["dk"], err["dv"]) <= F32_TOL, err
    assert max(err["dk_rel"], err["dv_rel"]) <= F32_REL_TOL, err


def test_fp32_k5_padding_keys_stay_finite_under_a_very_negative_lse(cuda):
    """K2's twin under the mask: every lse near -93, so the keys past Lk
    (which score 0) and the pairs the mask forbids must get p = 0 by a
    select, not exp(93) times 0 (the looser bound as K2's, for the same
    reason)."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.float32, cuda, seed=9)
    q[..., 0] = -1128.0
    k[..., 0] = 1.0
    mask = _f32_mask(1000, 1300, cuda, unseen=True)
    _, lse = ta.frame_masked_attention_plain(q, k, v, *mask)
    live = torch.isfinite(lse)
    assert lse[live].max().item() < -80, lse[live].max().item()
    err = _f32_dkv_errors(q, k, v, do, mask)
    assert max(err["dk_rel"], err["dv_rel"]) <= 1e-3, err


def test_fp32_k5_gives_the_same_bits_on_every_call(cuda):
    """No atomics and no split of the query loop: each block owns its keys'
    rows."""
    q, k, v, do = _bwd_inputs(1000, 1300, 128, torch.float32, cuda, seed=6)
    mask = _f32_mask(1000, 1300, cuda, unseen=True)
    tiles = ta.mask_tiles(*mask)
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    call = lambda: ta.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, mask,
                                         tiles)
    first = call()
    for _ in range(2):
        for x, y in zip(call(), first):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# fp32 P1, the P1 kernel of fp32 K1's split-TF32 body
# (csrc/flash_fwd_f32_sm90.cuh): exp or exp2, with or without the pad test,
# O only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [24, 64, 128])
@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("mask_pad", [True, False])
def test_fp32_p1_on_the_tf32_body_matches_plain(cuda, mask_pad, use_exp2, d):
    """P1's four variants at a ragged Lq (1000) over Lk = 1280, a multiple
    of 64 (so the variants without the pad test are defined), and the two
    with the pad test at a ragged Lk (1300), against the plain version
    within fp32 K1's bound; one launch a call."""
    for lk in (1280,) if not mask_pad else (1280, 1300):
        q, k, v = _qkv(1000, lk, d, torch.float32, cuda, seed=d + lk)
        ta.reset_launch_counts()
        got = ta.flash_exp2_cuda(q, k, v, use_exp2, mask_pad)
        want = ta.flash_attention_exp2_plain(q, k, v, use_exp2, mask_pad)
        torch.cuda.synchronize()
        assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 0),
                                    "flash_exp2": 1}
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= F32_TOL, (lk, use_exp2)


def test_fp32_p1_refuses_mask_pad_false_on_a_ragged_lk(cuda):
    q, k, v = _qkv(64, 1300, 24, torch.float32, cuda)
    ta.reset_launch_counts()
    with pytest.raises(ValueError, match="mask_pad=False"):
        ta.flash_exp2_cuda(q, k, v, use_exp2=True, mask_pad=False)
    assert ta.launch_counts["flash_exp2"] == 0


def test_fp32_p1_gives_the_same_bits_on_every_call(cuda):
    q, k, v = _qkv(1000, 1280, 128, torch.float32, cuda, seed=7)
    for use_exp2 in (False, True):
        for mask_pad in (False, True):
            first = ta.flash_exp2_cuda(q, k, v, use_exp2, mask_pad)
            for _ in range(2):
                assert torch.equal(
                    ta.flash_exp2_cuda(q, k, v, use_exp2, mask_pad), first)


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


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(77, 48), (1000, 96), (300, 4480),
                                 (129, 768), (64, 17920), (40, 1536)])
def test_q_amax_and_scaled_modes_match_plain(cuda, act, m, k):
    """Q's amax mode and its given-scale mode exactly against their plain
    versions at ragged and tensor-parallel shapes (K = 4480, fc2's input
    at tp 2; 768, o's and a cache token's; 17920 takes the two-read
    loop), bf16 and fp32, with a zero row and ties; the two halves of a
    row split in two, the maximum taken, give the whole row's codes; one
    launch of each mode counted."""
    from mmpl_tpu_torch.ops import quant
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         * 3).to(cuda, act)
    x[5] = 0
    x[6, :4] = torch.tensor([63.5, -127.0, 0.5, 1.5], device=cuda).to(act)
    quant.reset_launch_counts()
    amax = quant.row_amax_cuda(x)
    assert torch.equal(amax, quant.row_amax_plain(x))
    s = quant.amax_scale(amax)
    q = quant.quantize_rows_scaled_cuda(x, s)
    assert torch.equal(q, quant.quantize_rows_scaled_plain(x, s))
    pq, ps = quant.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert quant.q_mode_counts == {"codes": 0, "amax": 1, "scaled": 1}
    assert quant.launch_counts == {"int8_gemm": 0, "quantize_rows": 2}
    if k % 32 == 0:
        halves = [h.contiguous() for h in x.chunk(2, -1)]
        sh = quant.amax_scale(torch.maximum(*(quant.row_amax_cuda(h)
                                              for h in halves)))
        assert torch.equal(sh, ps)
        assert torch.equal(torch.cat([quant.quantize_rows_scaled_cuda(h, sh)
                                      for h in halves], -1), pq)


@pytest.mark.parametrize("case", ["amax_x_int8", "amax_x_strided",
                                  "amax_k_not_16", "scaled_s_short",
                                  "scaled_s_f64", "scaled_s_cpu",
                                  "scaled_x_strided"])
def test_q_modes_refuse_what_the_kernel_does_not_take(cuda, case):
    from mmpl_tpu_torch.ops import quant
    x = torch.randn((64, 96), device=cuda)
    s = torch.ones(64, device=cuda)
    calls = {
        "amax_x_int8": lambda: quant.row_amax_cuda(_int8((64, 96), 0, cuda)),
        "amax_x_strided": lambda: quant.row_amax_cuda(
            torch.randn((64, 192), device=cuda)[:, :96]),
        "amax_k_not_16": lambda: quant.row_amax_cuda(x[:, :40].contiguous()),
        "scaled_s_short": lambda: quant.quantize_rows_scaled_cuda(x, s[:63]),
        "scaled_s_f64": lambda: quant.quantize_rows_scaled_cuda(
            x, s.double()),
        "scaled_s_cpu": lambda: quant.quantize_rows_scaled_cuda(x, s.cpu()),
        "scaled_x_strided": lambda: quant.quantize_rows_scaled_cuda(
            torch.randn((64, 192), device=cuda)[:, :96], s),
    }
    quant.reset_launch_counts()
    with pytest.raises(ValueError):
        calls[case]()
    assert quant.launch_counts == {"int8_gemm": 0, "quantize_rows": 0}
    assert quant.q_mode_counts == dict.fromkeys(quant.Q_MODES, 0)


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


# ---------------------------------------------------------------------------
# Distillation and the flow objective: K1-K3 at the shapes the critic, the
# flow objective, the rollout's graded blocks and the GAN head run, and a
# tiny DMD step on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,lq,lk", [
    (1, 32760, 32760),      # critic / flow / bidirectional self-attention
    (2, 1, 32760),          # the GAN head: one register token a sample
    (1, 4680, 18720),       # a graded rollout block over 3 cached blocks
    (1, 32760, 512)])       # the scores' text cross-attention
def test_k1_k2_k3_match_plain_at_the_distillation_shapes(cuda, B, lq, lk):
    q, k, v, do = _bwd_inputs(lq, lk, 128, torch.bfloat16, cuda, seed=lq,
                              B=B, N=12)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    po, plse = ta.flash_attention_plain(q, k, v)
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-3
    del po, plse
    _, errs = _bwd_errors(q, k, v, do)
    assert max(errs) <= 1e-2, errs


def _tiny_dmd(device):
    """Tiny fp32 generator, fake and real scores, a 2-block batch."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    cfg = tiny_test_config()
    g = lambda s: torch.Generator().manual_seed(s)
    models = {k: dit.randomize_head(dit.init_dit_params(
        cfg, g(s), torch.float32), g(s + 99)).to(device)
        for k, s in (("generator", 0), ("fake_score", 1),
                     ("real_score", 2))}
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g(5))
    return cfg, models, ctx.to(device), torch.randn(
        1, 6, 16, 4, 4, generator=g(6)).to(device)


@pytest.mark.parametrize("loss,trained", [("dmd_generator_loss", "generator"),
                                          ("critic_loss", "fake_score")])
def test_tiny_dmd_step_on_the_card_matches_the_cpu(cuda, loss, trained):
    """One fp32 DMD generator (or critic) loss and its gradients on the
    card against the CPU, the draws handed in."""
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.training.diffusion import make_scheduler
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    from mmpl_tpu_torch.training.self_forcing import SelfForcingRollout
    out = {}
    for dev in ("cpu", cuda):
        cfg, models, ctx, noise = _tiny_dmd(dev)
        sch = make_scheduler(5.0)
        ro = SelfForcingRollout(cfg, sch, (1000, 750, 500, 250),
                                num_max_frames=6, grad_frame_window=6)
        dist = Distiller(cfg, DistillationConfig(timestep_shift=5.0), ro,
                         sch)
        with torch.no_grad():
            kv = dit.precompute_context_kv(
                models["generator"], cfg,
                dit.embed_text(models["generator"], ctx))
        gen = torch.Generator().manual_seed(7)
        draws = {"exit_flags": torch.tensor([2, 2]),
                 "rollout": [{"step": [torch.randn(1, 3, 16, 4, 4,
                                                   generator=gen)
                                       for _ in range(3)],
                              "commit": torch.randn(1, 3, 16, 4, 4,
                                                    generator=gen)}
                             for _ in range(2)],
                 "u": torch.rand(1, 1, generator=gen).to(dev),
                 "noise": torch.randn(1, 6, 16, 4, 4,
                                      generator=gen).to(dev)}
        models[trained].requires_grad_(True)
        ta.reset_launch_counts()
        val, _ = getattr(dist, loss)(
            models, {"noise": noise, "ctx_kv": kv, "context": ctx,
                     "uncond_context": torch.zeros_like(ctx)}, draws)
        val.backward()
        out[str(dev)] = (val.item(), {
            n: p.grad.cpu() for n, p in models[trained].named_parameters()
            if p.grad is not None}, dict(ta.launch_counts))
    (lc, gc, _), (lg, gg, counts) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    scale = max(g.abs().max().item() for g in gc.values())
    for n in gc:
        assert (gg[n] - gc[n]).abs().max().item() <= 1e-4 * scale, n
    assert counts["flash_fwd"] > 0 and counts["flash_bwd_dkv"] > 0 \
        and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"], counts


# ---------------------------------------------------------------------------
# Multi-device on one card: the ring in the in-process group, the chunk
# pipeline's stages as streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,ring", [(torch.bfloat16, 4),
                                        (torch.float32, 2)])
def test_ring_matches_the_whole_sequence_kernels(cuda, dtype, ring):
    """ring_flash_attention over `ring` stacked shards: K1 per ring step
    merged by lse equals one K1 call over every key; K2 / K3 per step
    with the global lse and delta equal K2 / K3 over the whole sequence;
    `ring` launches of each a call."""
    from mmpl_tpu_torch.parallel.collectives import LocalMesh
    mesh = LocalMesh({"ring": ring})
    group = mesh.get_group("ring")
    q, k, v, do = (x.to(dtype) for x in _qkv(1024, 1024, 128, torch.float32,
                                               cuda, seed=3) + _qkv(
        1024, 1024, 128, torch.float32, cuda, seed=4)[:1])
    shard = lambda x: mesh.shard(x, 1, ("ring",)).contiguous()
    leaves = [shard(x).requires_grad_() for x in (q, k, v)]
    ta.reset_launch_counts()
    out = ta.ring_flash_attention(*leaves, group)
    out.backward(shard(do))
    counts = dict(ta.launch_counts)
    o_w, lse_w = ta.flash_fwd_cuda(q, k, v)
    delta = (do.float() * o_w.float()).sum(-1).transpose(1, 2).contiguous()
    grads_w = ta.flash_bwd_cuda(q, k, v, do, lse_w, delta)
    got = mesh.gather(out, 1, ("ring",))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - o_w.float()).abs().max().item() <= tol
    for x, w in zip(leaves, grads_w):
        g = mesh.gather(x.grad, 1, ("ring",)).float()
        rel = ((g - w.float()).norm() / w.float().norm()).item()
        assert rel <= (1e-2 if dtype == torch.bfloat16 else 1e-5), rel
    assert counts["flash_fwd"] == ring
    assert counts["flash_bwd_dkv"] == counts["flash_bwd_dq"] == ring


def _tiny_chunk_pipe(cuda, stages, **kw):
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit, vae
    from mmpl_tpu_torch.parallel.chunk_pipeline import ChunkParallelPipeline
    cfg = tiny_test_config()
    g = lambda s: torch.Generator(device=cuda).manual_seed(s)
    model = dit.randomize_head(dit.init_dit_params(cfg, g(0), torch.bfloat16,
                                                   cuda), g(9))
    vae_m = vae.init_vae_params(g(1), torch.float32, cuda)
    pipe = ChunkParallelPipeline(cfg, model, vae_m, devices=[cuda] * stages,
                                 sampling_steps=2, dtype=torch.bfloat16,
                                 **kw)
    gen = g(5)
    noises = [torch.randn((1, 21, 16, 8, 8), generator=gen, device=cuda)
              for _ in range(3)]
    ctx = [torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                       device=cuda) for _ in range(2)]
    return pipe, noises, ctx


def test_two_streams_give_one_streams_chunks(cuda):
    """Three chunks over two stages of one card (two streams, one model)
    equal the same chunks on one stage, bit for bit; each chunk's CUDA
    events are ordered and chunk 1 starts after chunk 0's anchors."""
    runs = []
    for stages in (2, 1):
        pipe, noises, (cond, uncond) = _tiny_chunk_pipe(cuda, stages)
        runs.append(pipe.generate(noises, cond, uncond, seed=3))
        timeline = pipe.device_timeline()
        assert [t["stage"] for t in timeline] == [i % stages
                                                  for i in range(3)]
        for t in timeline:
            assert t["start_ms"] <= t["groups_start_ms"] <= t["anchor_ms"] \
                <= t["end_ms"]
        for a, b in zip(timeline, timeline[1:]):
            assert b["groups_start_ms"] >= a["anchor_ms"]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_sync_timing_waits_for_its_own_stream_only(cuda):
    """With sync_timing on, a pipeline times its groups on its own stream:
    a long kernel queued on another stream of the card (another stage)
    does not hold it up, so two stages still overlap."""
    pipe, noises, (cond, uncond) = _tiny_chunk_pipe(cuda, 1)
    stage = pipe.stages[0].pipe
    stage.sync_timing = True
    with torch.inference_mode():
        stage.inference(noises[0], cond, uncond)      # warm-up
    torch.cuda.synchronize()
    other = torch.cuda.Stream(device=cuda)
    mine = torch.cuda.Stream(device=cuda)
    with torch.cuda.stream(other):
        torch.cuda._sleep(int(6e9))       # >= 3 s at up to 2 GHz
    t0 = time.perf_counter()
    with torch.cuda.stream(mine), torch.inference_mode():
        stage.inference(noises[0], cond, uncond)
    mine.synchronize()
    seconds = time.perf_counter() - t0
    busy = other.query()
    torch.cuda.synchronize()
    assert not busy, "the other stream finished first: no overlap shown"
    assert seconds < 2.0, seconds
    assert all(v >= 0 for v in stage.phase_times.values())


def test_served_chunk_is_published_before_the_next_chunk_ends(cuda,
                                                              tmp_path):
    """The pipeline backend on two stages of the card decodes chunk 0 on
    its stage and publishes its file (on_chunk) while chunk 1 still runs:
    chunk 1's stage first queues a long kernel, and chunk 1's end event
    has not completed when chunk 0's file is published."""
    from mmpl_tpu_torch.serving import server as srv
    cfg, model, vae_m, text_encoder, lat_hw = srv.smoke_models(cuda)
    config = srv.ParallelServerConfig(output_folder=str(tmp_path),
                                      num_chunks=2)
    backend = srv.make_pipeline_backend(cfg, model, vae_m, text_encoder,
                                        config, devices=[cuda, cuda],
                                        lat_hw=lat_hw, sampling_steps=2)
    stage1 = backend.pipe.stages[1].pipe
    inference = stage1.inference

    def slow_inference(*args, **kwargs):
        torch.cuda._sleep(int(4e9))     # >= 2 s at up to 2 GHz
        return inference(*args, **kwargs)

    stage1.inference = slow_inference
    seen = []

    def on_chunk(path):
        log = backend.pipe.dispatch_log[1]
        seen.append(bool(log) and log["cuda_events"]["end"].query())

    paths = backend("a red fox", 2, 5, on_chunk=on_chunk)
    torch.cuda.synchronize()
    assert len(paths) == 2 and len(seen) == 2
    assert seen[0] is False, seen


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_usp_forward_matches_the_single_device_forward(cuda, dtype, tol):
    """usp_dit_forward over sp 2 x ring 2 in the in-process group on the
    card (K1 on the all-to-all's strided shards, the ring's merge) equals
    dit_forward; relative error of the flow."""
    import copy
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.parallel.collectives import LocalMesh
    from mmpl_tpu_torch.parallel.sequence_parallel import usp_dit_forward
    from mmpl_tpu_torch.utils.device import set_float32_precision
    set_float32_precision()
    cfg = copy.deepcopy(tiny_test_config())
    cfg.num_heads = 2
    g = lambda s: torch.Generator(device=cuda).manual_seed(s)
    model = dit.randomize_head(dit.init_dit_params(cfg, g(0), dtype, cuda),
                               g(1))
    dit.fuse_qkv_params(model, cfg.num_heads)
    lat = torch.randn((1, 4, 16, 8, 8), generator=g(2), device=cuda).to(dtype)
    t = torch.tensor([600.0], device=cuda)
    ctx = torch.randn((1, 16, 64), generator=g(3), device=cuda).to(dtype)
    with torch.no_grad():
        want = dit.dit_forward(model, cfg, lat, t, ctx).float()
        got = usp_dit_forward(model, cfg, lat, t, ctx,
                              LocalMesh({"sp": 2, "ring": 2}),
                              ring_axis="ring").float()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= tol, rel


@pytest.mark.parametrize("th,tw,shape", [(480, 832, (9, 720, 1280, 3)),
                                         (64, 40, (3, 96, 120, 3)),
                                         (192, 240, (2, 96, 120, 3))])
def test_fastproc_on_the_card_matches_the_cpu(cuda, th, tw, shape):
    """The clip resample (`data/fastproc.py`) on the card against the
    same on the CPU: the same taps, TF32 off, the products summed in
    another order; within 1e-5 of [-1, 1]."""
    from mmpl_tpu_torch.data import fastproc
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape, dtype=np.uint8))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fastproc.scale_crop_normalize_clip(frames.to(cuda), th, tw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    want = fastproc.scale_crop_normalize_clip(frames, th, tw)
    assert got.device.type == "cuda" and got.shape == (shape[0], 3, th, tw)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


def test_data_process_on_the_card(cuda, tmp_path):
    """`data_process --synthetic --device cuda --use_native` at a smoke
    size: the resample and the random VAE on the card, a short clip
    skipped, one shard."""
    from mmpl_tpu_torch.data import datasets, video_dataset
    rng = np.random.default_rng(1)
    for name, n in (("a", 9), ("b", 13), ("short", 3)):
        np.save(tmp_path / f"{name}.npy",
                rng.integers(0, 256, (n, 72, 128, 3), dtype=np.uint8))
    (tmp_path / "meta.csv").write_text(
        "file_name,text\na.npy,a cat\nb.npy,a dog\nshort.npy,short\n")
    paths = video_dataset.data_process([
        "--base_path", str(tmp_path), "--metadata_path",
        str(tmp_path / "meta.csv"), "--output_path", str(tmp_path / "out"),
        "--synthetic", "--num_frames", "9", "--height", "64", "--width",
        "96", "--text_len", "16", "--text_dim", "64", "--use_native"])
    items = datasets.TensorDictDataset(str(tmp_path / "out"))
    assert len(paths) == 1 and len(items) == 2
    assert items[0]["latents"].shape == (3, 16, 8, 12)
    assert np.isfinite(items[1]["latents"]).all()


def test_record_trajectories_on_the_card_matches_the_cpu(cuda):
    """`data/ode_gen.record_trajectories` of the tiny model in fp32 (K1
    over the CFG pair) on the card against the CPU's plain path."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.data.ode_gen import record_trajectories
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.utils.device import set_float32_precision
    set_float32_precision()
    cfg = tiny_test_config()
    g = torch.Generator().manual_seed(5)
    model = dit.randomize_head(dit.init_dit_params(cfg, g, torch.float32),
                               g)
    noise = torch.randn((1, 3, 16, 4, 4), generator=g)
    cond, uncond = (torch.randn((1, 16, 64), generator=g) for _ in range(2))
    want = record_trajectories(cfg, model, noise, cond, uncond,
                               sampling_steps=6, dtype=torch.float32)
    ta.reset_launch_counts()
    got = record_trajectories(cfg, model.to(cuda), noise.to(cuda),
                              cond.to(cuda), uncond.to(cuda),
                              sampling_steps=6, dtype=torch.float32)
    assert ta.launch_counts["flash_fwd"] == 6 * 2 * cfg.num_layers
    assert torch.equal(got[:, 0].cpu(), noise)
    rel = ((got.cpu() - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel


# ---------------------------------------------------------------------------
# Host offload: the streamed AdamW and EMA, block inputs on the host
# ---------------------------------------------------------------------------

def _offload_params(device, n=24, shape=(512, 1024), seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(shape, generator=g,
                                           device=device))
            for _ in range(n)]


def _grads(params, seed):
    g = torch.Generator(device=params[0].device).manual_seed(seed)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=p.device)


def test_offloaded_moments_and_shadow_are_pinned_host_tensors(cuda):
    from mmpl_tpu_torch.utils.ema import EmaParams
    from mmpl_tpu_torch.utils.memory import HostAdamW
    params = _offload_params(cuda, n=3)
    opt = HostAdamW(params, lr=1e-3)
    _grads(params, 1)
    opt.step()
    for st in opt.state.values():
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].device.type == "cpu" and st[k].is_pinned(), k
        assert st["step"].device.type == "cpu"
    ema = EmaParams(torch.nn.ParameterList(params), offload=True)
    ema.update(torch.nn.ParameterList(params))
    assert all(s.device.type == "cpu" and s.is_pinned()
               for s in ema.shadow.values())


def test_offloaded_update_equals_the_resident_one_and_holds_less(cuda):
    """Three AdamW steps and EMA updates, resident and offloaded, from the
    same values and gradients: parameters, moments and shadows bit for
    bit; the offloaded step's peak device memory is below the resident
    one's by at least the moments' bytes."""
    from mmpl_tpu_torch.utils.ema import EmaParams
    from mmpl_tpu_torch.utils.memory import HostAdamW
    out = {}
    for kind in (torch.optim.AdamW, HostAdamW):
        params = _offload_params(cuda)
        opt = kind(params, lr=1e-3, weight_decay=1e-4)
        ema = EmaParams(torch.nn.ParameterList(params), decay=0.9,
                        offload=kind is HostAdamW)
        peaks = []
        for step in range(3):
            _grads(params, 10 + step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            opt.step()
            ema.update(torch.nn.ParameterList(params))
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
        state = opt.state_dict()["state"]
        out[kind] = ([p.detach().clone() for p in params],
                     {i: {k: v.cpu() for k, v in st.items()}
                      for i, st in state.items()},
                     {n: s.cpu() for n, s in ema.shadow.items()}, peaks[-1])
        del params, opt, ema, state
        torch.cuda.empty_cache()
    (pr, sr, er, peak_r), (ph, sh, eh, peak_h) = out[torch.optim.AdamW], \
        out[HostAdamW]
    assert all(torch.equal(a, b) for a, b in zip(pr, ph))
    for i in sr:
        for k in sr[i]:
            assert torch.equal(sr[i][k], sh[i][k]), (i, k)
    assert all(torch.equal(er[n], eh[n]) for n in er)
    moments = 2 * sum(p.nbytes for p in pr)
    assert peak_r - peak_h >= moments, (peak_r, peak_h, moments)


def test_remat_offload_on_the_card_equals_the_plain_path(cuda):
    """A tiny fp32 teacher-forcing loss and its gradients with the blocks'
    inputs in pinned host memory: bit for bit the plain path's, the inputs
    really on the host while the backward waits."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.training import diffusion as tdiff
    from mmpl_tpu_torch.training import masks
    from mmpl_tpu_torch.utils import memory
    cfg = tiny_test_config()
    g = lambda s: torch.Generator(device=cuda).manual_seed(s)
    fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:6])
    shape = (1, 6, 16, 4, 4)
    gen = g(1)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device=cuda)
    batch = {"latents": torch.randn(shape, generator=gen, device=cuda),
             "context": ctx, "uncond_context": torch.zeros_like(ctx)}
    draws = tdiff.draw_teacher_forcing(gen, shape, 3, 1000, 100, cuda)
    pinned = []
    real = memory.HostBoundaries._pack

    def pack(self, x):
        b = real(self, x)
        pinned.append(b.host.is_pinned() if x.numel() else True)
        return b

    memory.HostBoundaries._pack = pack
    try:
        out = {}
        for off in (False, True):
            model = dit.randomize_head(dit.init_dit_params(
                cfg, g(0), torch.float32, cuda), g(2)).requires_grad_(True)
            loss = tdiff.make_teacher_forcing_loss_fn(
                cfg, tdiff.make_scheduler(8.0), fm,
                noise_aug_max_timestep=100, compute_dtype=torch.float32,
                remat_offload=off)(model, batch, draws)
            loss.backward()
            out[off] = (loss.detach(), [p.grad for p in model.parameters()])
    finally:
        memory.HostBoundaries._pack = real
    assert len(pinned) >= cfg.num_layers and all(pinned)
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))
