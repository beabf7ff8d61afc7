"""K2's and K3's schedules off the card: `bwd_schedule` at every bf16 / fp16
K2 / K3 shape of `chip_smoke.py` on an H100's 132 SMs, its limits, the
reduce's order of dQ's partials, the fused walk's plain version
(`flash_attention_bwd_fused_plain`: each 128-key block's dK, dV and share
of dQ, the shares summed in the reduce's order) against the Pallas K2 and
K3 in interpret mode, and what each schedule's call is given
(`bwd_workspace`, `_bwd_sched_args`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.ops.attention import _flash_bwd_impl as j_flash_bwd
from mmpl_tpu_torch.ops import attention as ta

#: SMs of an H100 SXM
H100_SMS = 132

#: (label, B, N, D, Lq, Lk, the schedule the card runs): chip_smoke.py's
#: bf16 / fp16 BWD_SHAPES
BWD_SCHEDULES = [
    ("tf_cross", 1, 12, 128, 65520, 512, "persistent"),
    ("tf_cross_f16", 1, 12, 128, 65520, 512, "persistent"),
    ("fewstep_self_hot", 1, 12, 128, 4680, 32760, "ordered"),
    ("ragged", 2, 12, 128, 1000, 1300, "ordered"),
    ("d24_bf16", 2, 4, 24, 1000, 1300, "grid"),
    ("critic_self", 1, 12, 128, 32760, 32760, "ordered"),
    ("score_cross", 1, 12, 128, 32760, 512, "persistent"),
    ("gan_head_q1", 2, 12, 128, 1, 32760, "fused"),
]


@pytest.mark.parametrize("label,B,N,D,lq,lk,mode", BWD_SCHEDULES,
                         ids=[r[0] for r in BWD_SCHEDULES])
def test_each_bwd_shape_gets_its_schedule(label, B, N, D, lq, lk, mode):
    """The long rows at D = 128 on the ordered walk, D = 24 on the grid,
    512 keys on K3's persistent walk, one query row over 32760 keys fused;
    the same answer from a cold cache."""
    got = ta.bwd_schedule(B, N, lq, lk, D, H100_SMS)
    assert got == mode, got
    ta.bwd_schedule.cache_clear()
    assert ta.bwd_schedule(B, N, lq, lk, D, H100_SMS) == got


@pytest.mark.parametrize("B,N,lq,lk,D,want", [
    (2, 12, 64, 8192, 128, "fused"),       # a whole query tile: 48 MiB
    (2, 12, 65, 8192, 128, "ordered"),     # past one query tile
    (1, 66, 1, 32760, 128, "fused"),       # K3's 66 blocks: half the card
    (1, 67, 1, 32760, 128, "ordered"),     # more than half the card
    (2, 12, 64, 16384, 128, "ordered"),    # 96 MiB of partials: past the cap
    (2, 12, 64, 16384, 64, "fused"),       # 48 MiB at D = 64
    (2, 12, 1000, 768, 128, "persistent"),  # 6 key tiles
    (2, 12, 1000, 769, 128, "ordered"),    # 7 key tiles
    (2, 12, 1000, 769, 64, "grid"),        # the grid's 64-wide head dim
    (2, 12, 1000, 769, 72, "ordered"),     # past it
    (1, 8, 4096, 4096, 128, "grid"),       # a wave holds 17 blocks a head
    (1, 9, 4096, 4096, 128, "ordered"),    # 15 blocks a head
    (1, 4, 4096, 1024, 128, "ordered"),    # 8 blocks: the whole head
    (2, 40, 32760, 32760, 128, "ordered"),  # i2v-14B's 40 heads
])
def test_bwd_schedule_limits(B, N, lq, lk, D, want):
    assert ta.bwd_schedule(B, N, lq, lk, D, H100_SMS) == want


@pytest.mark.parametrize("mode,parts,lq,lk,d", [
    ("ordered", "both", 100, 300, 24), ("ordered", "both", 64, 1000, 128),
    ("fused", "both", 3, 1000, 80), ("grid", "dkv", 4096, 200, 128),
    ("grid", "dq", 100, 300, 24), ("persistent", "both", 100, 300, 24)])
def test_bwd_workspace_of_each_schedule(mode, parts, lq, lk, d):
    """The ordered walk gets its fp32 sums (two 64 x 64 halves a 64-query
    tile of each (batch, head), left unset) and zeroed int32 counters (one
    a half); the fused walk its partials; the grid's K2 its split's
    partials where it splits (on a card of 6 SMs here); the others
    nothing."""
    B, N = 2, 3
    q = torch.zeros((B, lq, N, d), dtype=torch.bfloat16)
    k = torch.zeros((B, lk, N, d), dtype=torch.bfloat16)
    splits, ws, cnt = ta.bwd_workspace(mode, parts, q, k, sms=6)
    tiles = B * N * -(-lq // 64)
    if mode == "ordered":
        assert splits == 1 and ws.dtype == torch.float32
        assert ws.numel() == tiles * 2 * 64 * 64
        assert cnt.dtype == torch.int32 and cnt.numel() == tiles * 2
        assert not cnt.any()
    elif mode == "fused":
        assert cnt is None and ws.numel() == -(-lk // 128) * B * N * lq * d
    else:
        assert cnt is None
        want = ta.bwd_query_splits(B, N, lq, lk, 6) if parts != "dq" else 1
        assert splits == want and (ws is None) == (splits == 1)


def test_sched_args_pack_the_counters_last():
    """42 int64s: the ordered walk's counters after the 21 strides (0 for
    the other modes), the mode's code among them."""
    import struct
    q = torch.zeros((1, 70, 2, 24), dtype=torch.bfloat16)
    k = torch.zeros((1, 300, 2, 24), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 70))
    _, ws, cnt = ta.bwd_workspace("ordered", "both", q, k, sms=132)
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(k))
    packed = ta._bwd_sched_args(q, k, k, q, lse, lse, *outs, ws, "ordered",
                                "both", 1, 132, cnt)
    vals = struct.unpack("42q", packed)
    assert vals[11] == ta.BWD_MODES["ordered"] == 3
    assert vals[10] == ws.data_ptr() and vals[-1] == cnt.data_ptr()
    assert struct.unpack("42q", ta._bwd_sched_args(
        q, k, k, q, lse, lse, *outs, None, "grid", "both", 1, 132))[-1] == 0


@pytest.mark.parametrize("n", [1, 5, 8, 9, 256])
def test_partials_summed_in_the_reduce_order(n):
    """Each key block's partial counted once, in ranges of the reduce's
    bounds, the same bits as the sum written out in that order."""
    rng = np.random.default_rng(n)
    parts = [torch.from_numpy(rng.standard_normal((2, 3, 5, 8)).astype(
        np.float32)) for _ in range(n)]
    R = ta.BWD_REDUCE_RANGES
    edges = [w * n // R for w in range(R + 1)]
    assert edges[0] == 0 and edges[-1] == n
    want = torch.zeros_like(parts[0])
    for w in range(R):
        acc = torch.zeros_like(parts[0])
        for z in range(edges[w], edges[w + 1]):
            acc = acc + parts[z]
        want = want + acc
    assert torch.equal(ta._dq_partials_summed(parts), want)
    torch.testing.assert_close(ta._dq_partials_summed(parts),
                               torch.stack(parts).sum(0), atol=1e-5,
                               rtol=1e-5)


def _inputs(lq, lk, d, seed, B=1, N=2):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, lq, N, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, lk, N, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _pallas_bwd(q, k, v, do, lse, delta, d):
    """The JAX package's K2 and K3 in interpret mode, fed the same lse and
    delta ([B, N, Lqp, 1], padded with zero rows to the 128-query block)."""
    lq = q.shape[1]
    pad = -(-lq // 128) * 128 - lq
    rows = lambda x: np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
    return [np.asarray(x) for x in j_flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rows(np.swapaxes(do, 1, 2))),
        jnp.asarray(rows(lse.numpy()[..., None])),
        jnp.asarray(rows(delta.numpy()[..., None])), d ** -0.5, 128, 128,
        True)]


@pytest.mark.parametrize("d", [24, 80, 128])
@pytest.mark.parametrize("lk", [1, 127, 300, 1000])
@pytest.mark.parametrize("lq", [1, 3, 64])
def test_fused_plain_matches_pallas_bwd(lq, lk, d):
    """The fused walk's arithmetic on the CPU in fp32: dK and dV of each
    128-key block, dQ as its blocks' partials summed in the reduce's order,
    against the Pallas K2 and K3 on the same lse and delta."""
    q, k, v, do = _inputs(lq, lk, d, seed=lq + lk + d)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = ta.flash_attention_plain(qt, kt, vt)
    delta = (dot * o).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_attention_bwd_fused_plain(qt, kt, vt, dot, lse, delta)
    want = _pallas_bwd(q, k, v, do, lse, delta, d)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4, rtol=5e-4,
                                   err_msg=name)


def test_a_key_block_of_one_key_gives_no_nan():
    """Lk = 1: the one block holds one valid key beside 127 past Lk; every
    gradient is finite, and the one key's dQ share is the plain one's."""
    q, k, v, do = _inputs(3, 1, 24, seed=5)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = ta.flash_attention_plain(qt, kt, vt)
    delta = (dot * o).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_attention_bwd_fused_plain(qt, kt, vt, dot, lse, delta)
    want = ta.flash_attention_bwd_plain(qt, kt, vt, dot, lse, delta)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_the_cpu_backward_still_runs_the_plain_backward(monkeypatch):
    """On CPU tensors the autograd backward takes `_plain_bwd`, as before
    the schedules: the chooser is never asked."""
    monkeypatch.setattr(ta, "bwd_schedule", None)
    q, k, v, _ = _inputs(3, 200, 24, seed=7)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    ta.flash_attention(qt, kt, vt).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (qt, kt, vt))
