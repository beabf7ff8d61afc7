"""Port parity: the differentiable flash attention (K1-K3) and the
frame-masked attention (K4-K6) on the CPU, where the port runs their plain
versions through the same `autograd.Function`s, against the Pallas kernels
in interpret mode and against torch autograd through a dense forward."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.ops.attention import (_flash_bwd_impl as j_flash_bwd,
                                    flash_attention_vjp as j_flash_vjp,
                                    frame_masked_attention as j_masked)
from mmpl_tpu.training import masks as jmasks
from mmpl_tpu_torch.ops import attention as ta
from mmpl_tpu_torch.training import masks as tmasks


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, w):
    loss = lambda *a: jnp.sum(fn(*a) * w)
    args = tuple(map(jnp.asarray, (q, k, v)))
    return (np.asarray(fn(*args)),
            [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)])


def _close(got, want, atol, rtol=0.0):
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("lq,lk", [(64, 64), (100, 200)])
def test_flash_attention_and_grads_match_pallas_vjp(lq, lk):
    B, N, D = 1, 2, 64
    q, w = _arrays([(B, lq, N, D)] * 2, seed=lq)
    k, v = _arrays([(B, lk, N, D)] * 2, seed=lk + 1)
    o_w, g_w = _jax_grads(
        lambda a, b, c: j_flash_vjp(a, b, c, None, 128, 128, True), q, k, v, w)
    o_g, g_g = _torch_grads(ta.flash_attention, q, k, v, w)
    np.testing.assert_allclose(o_g, o_w, atol=2e-5)
    _close(g_g, g_w, atol=5e-4, rtol=5e-4)


def _masked_case(name):
    """(frame mask, q ids, kv ids, B, N, D) as in tests/test_models.py."""
    if name == "teacher_forcing":        # 10 frames of 4 tokens
        fm = jmasks.teacher_forcing_frame_mask(5, num_frame_per_block=1)
        ids = np.repeat(np.arange(10), 4)
        return fm, ids, ids, 1, 2, 64
    if name == "ragged":                 # L = 15, not a block multiple
        fm = np.tril(np.ones((3, 3), bool))
        ids = np.repeat(np.arange(3), 5)
        return fm, ids, ids, 1, 1, 64
    fm = jmasks.teacher_forcing_frame_mask(3, 1)     # grads case, 6 x 8
    ids = np.repeat(np.arange(6), 8)
    return fm, ids, ids, 1, 2, 64


@pytest.mark.parametrize("case", ["teacher_forcing", "ragged", "grads"])
def test_frame_masked_attention_and_grads_match_pallas(case):
    fm, qi, ki, B, N, D = _masked_case(case)
    q, w = _arrays([(B, len(qi), N, D)] * 2, seed=3)
    k, v = _arrays([(B, len(ki), N, D)] * 2, seed=4)
    o_w, g_w = _jax_grads(
        lambda a, b, c: j_masked(a, b, c, qi, ki, fm, block_q=128,
                                 block_k=128, interpret=True), q, k, v, w)
    o_g, g_g = _torch_grads(
        lambda a, b, c: ta.frame_masked_attention(a, b, c, qi, ki, fm),
        q, k, v, w)
    np.testing.assert_allclose(o_g, o_w, atol=2e-5)
    _close(g_g, g_w, atol=5e-4, rtol=5e-4)


def test_fully_masked_frame_gives_zero_output_and_grads():
    fm = np.tril(np.ones((4, 4), bool))
    fm[2, :] = False                     # frame 2 sees nothing
    ids = np.repeat(np.arange(4), 6)
    q, k, v, w = _arrays([(2, 24, 3, 16)] * 4, seed=5)
    o, lse = ta.frame_masked_attention_plain(
        *map(torch.from_numpy, (q, k, v)), ids, ids, fm)
    rows = ids == 2
    assert torch.all(o[:, rows] == 0)
    assert torch.all(lse[:, :, rows] == -math.inf)
    assert torch.isfinite(lse[:, :, ~rows]).all()
    _, (dq, dk, dv) = _torch_grads(
        lambda a, b, c: ta.frame_masked_attention(a, b, c, ids, ids, fm),
        q, k, v, w)
    assert np.all(dq[:, rows] == 0) and np.isfinite(dq).all()
    # keys of frame 3 are seen by no query (the mask is lower-triangular
    # and row 3 is frame 3's own), so only the diagonal reaches them
    assert np.isfinite(dk).all() and np.isfinite(dv).all()


@pytest.mark.parametrize("masked", [False, True])
def test_custom_backward_matches_autograd_of_the_dense_forward(masked):
    fm = tmasks.fps_forcing_frame_mask([0, 0, 1, 1, 2, 2])
    ids = np.repeat(np.arange(12), 5)
    q, k, v, w = _arrays([(2, 60, 2, 24)] * 4, seed=6)
    tok = torch.from_numpy(tmasks.expand_frame_mask(fm, 5))[None, None]
    if masked:
        fn = lambda a, b, c: ta.frame_masked_attention(a, b, c, ids, ids, fm)
        ref = lambda a, b, c: ta.dense_attention(a, b, c, mask=tok)
    else:
        fn, ref = ta.flash_attention, ta.dense_attention
    o_g, g_g = _torch_grads(fn, q, k, v, w)
    o_w, g_w = _torch_grads(ref, q, k, v, w)
    np.testing.assert_allclose(o_g, o_w, atol=1e-5)
    _close(g_g, g_w, atol=2e-5, rtol=1e-5)


def test_plain_backward_chunks_rows_without_changing_the_result(monkeypatch):
    fm = np.tril(np.ones((5, 5), bool))
    ids = np.repeat(np.arange(5), 7)
    q, k, v, do = map(torch.from_numpy, _arrays([(2, 35, 3, 16)] * 4, 7))
    o, lse = ta.frame_masked_attention_plain(q, k, v, ids, ids, fm)
    delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
    whole = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                ids, ids, fm)
    monkeypatch.setattr(ta, "_PLAIN_SCORE_BYTES", 4 * 2 * 3 * 35 * 6)
    chunked = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                  ids, ids, fm)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_tile_table_marks_skipped_partial_and_full_tiles():
    # 3 frames of 100 tokens; frame 1 sees frames 0 and 1, frame 0 only 0,
    # frame 2 sees nothing
    fm = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 0]], bool)
    ids = torch.as_tensor(np.repeat(np.arange(3), 100), dtype=torch.int32)
    got = ta.tile_table(ids, ids, torch.from_numpy(fm)).numpy()
    # tile rows/cols over tokens [0,64) [64,128) [128,192) [192,256) [256,300)
    tok = tmasks.expand_frame_mask(fm, 100)
    want = np.zeros((5, 5), np.uint8)
    for i in range(5):
        for j in range(5):
            blk = tok[64 * i:64 * (i + 1), 64 * j:64 * (j + 1)]
            want[i, j] = 2 if blk.all() else (1 if blk.any() else 0)
    np.testing.assert_array_equal(got, want)
    assert {0, 1, 2} <= set(np.unique(got))


@pytest.mark.parametrize("wrapper", ["masked_fwd", "bwd_dkv", "bwd_dq",
                                     "masked_bwd_dq"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    q, k, v, do = map(torch.from_numpy, _arrays([(1, 16, 2, 8)] * 4, 9))
    ids = torch.zeros(16, dtype=torch.int32)
    mask = (ids, ids, torch.ones((1, 1), dtype=torch.bool))
    tiles = ta.tile_table(*mask)
    lse = torch.zeros((1, 2, 16))
    calls = {
        "masked_fwd": lambda: ta.flash_fwd_cuda(q, k, v, None, mask, tiles),
        "bwd_dkv": lambda: ta.flash_bwd_dkv_cuda(q, k, v, do, lse, lse),
        "bwd_dq": lambda: ta.flash_bwd_dq_cuda(q, k, v, do, lse, lse),
        "masked_bwd_dq": lambda: ta.flash_bwd_dq_cuda(
            q, k, v, do, lse, lse, None, mask, tiles),
    }
    ta.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[wrapper]()
    assert set(ta.launch_counts.values()) == {0}


@pytest.mark.parametrize("bad", [("q", 2), ("kv", 2), ("q", -1)])
@pytest.mark.parametrize("call", ["masked_attention", "tile_table", "plain"])
def test_frame_ids_outside_the_mask_are_refused(bad, call):
    """The kernels index the [F, F] table with the ids unchecked, so the
    table's builder and the plain versions refuse ids outside [0, F)."""
    q, k, v = map(torch.from_numpy, _arrays([(1, 16, 2, 8)] * 3, 10))
    side, value = bad
    q_ids = torch.zeros(16, dtype=torch.int32)
    kv_ids = torch.ones(16, dtype=torch.int32)
    (q_ids if side == "q" else kv_ids)[5] = value
    fm = torch.ones((2, 2), dtype=torch.bool)
    calls = {
        "masked_attention": lambda: ta.frame_masked_attention(
            q, k, v, q_ids, kv_ids, fm),
        "tile_table": lambda: ta.tile_table(q_ids, kv_ids, fm),
        "plain": lambda: ta.frame_masked_attention_plain(
            q, k, v, q_ids, kv_ids, fm),
    }
    with pytest.raises(ValueError, match=r"outside \[0, 2\)"):
        calls[call]()


def test_no_grad_and_inference_calls_bypass_autograd():
    q, k, v = map(torch.from_numpy, _arrays([(1, 16, 2, 8)] * 3, 8))
    with torch.inference_mode():
        out = ta.flash_attention(q, k, v)
    torch.testing.assert_close(out, ta.flash_attention_plain(q, k, v)[0])
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# The dKV query split of the Hopper K2 (its planner and its reduce order)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lq,splits", [(64, 1), (300, 2), (900, 3),
                                       (1000, 7), (4096, 16), (65520, 8),
                                       (129, 5)])
def test_split_rows_cover_every_query_tile_once(lq, splits):
    rows = ta.bwd_split_rows(lq, splits)
    assert len(rows) == splits
    assert rows[0][0] == 0 and rows[-1][1] == lq
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(r0 % ta.BWD_QUERY_TILE == 0 and r0 <= r1 for r0, r1 in rows)
    tile = ta.BWD_QUERY_TILE
    dealt = [t for r0, r1 in rows for t in range(r0 // tile, -(-r1 // tile))]
    assert dealt == list(range(-(-lq // tile)))   # the ragged last included


@pytest.mark.parametrize("B,N,lq,lk,sms,split", [
    (1, 12, 65520, 512, 132, True),       # the training cross-attention
    (2, 12, 9360, 512, 132, True),        # the serving text cross-attention
    (2, 2, 4096, 128, 132, True),
    (1, 12, 4680, 32760, 132, False),     # the few-step steady state
    (2, 12, 9360, 32760, 132, False),
    (1, 12, 65520, 65520, 132, False),    # the training self-attention
    (1, 1, 128, 64, 132, False),          # too few query tiles to split
])
def test_query_splits_fill_the_card_only_where_the_keys_do_not(B, N, lq, lk,
                                                               sms, split):
    s = ta.bwd_query_splits(B, N, lq, lk, sms)
    blocks = B * N * -(-lk // ta.BWD_KEY_BLOCK)
    if not split:
        assert s == 1
        return
    assert 1 < s <= ta.BWD_MAX_SPLITS
    # a full wave, or as near as the most splits allowed come
    assert blocks * s >= min(sms, blocks * ta.BWD_MAX_SPLITS)
    assert 2 * s * B * N * lk * 128 * 4 <= ta.BWD_MAX_WORKSPACE
    assert -(-lq // ta.BWD_QUERY_TILE) // s >= ta.BWD_MIN_SPLIT_TILES


def test_split_partials_summed_in_order_match_the_pallas_dkv():
    """The split's arithmetic on the CPU: the plain backward over each
    split's query rows, dK and dV summed in the reduce kernel's order
    (split 0, 1, ...), against the JAX package's K2 (and K3) in interpret
    mode fed the same lse and delta."""
    B, N, D, lq, lk = 1, 2, 64, 900, 64
    splits = ta.bwd_query_splits(B, N, lq, lk, sms=6)
    assert splits == 3
    q, do = _arrays([(B, lq, N, D)] * 2, seed=11)
    k, v = _arrays([(B, lk, N, D)] * 2, seed=12)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = ta.flash_attention_plain(qt, kt, vt)
    delta = (dot * o).sum(-1).permute(0, 2, 1).contiguous()
    dk = dv = 0
    dqs = []
    for r0, r1 in ta.bwd_split_rows(lq, splits):
        dq_z, dk_z, dv_z = ta.flash_attention_bwd_plain(
            qt[:, r0:r1], kt, vt, dot[:, r0:r1], lse[:, :, r0:r1],
            delta[:, :, r0:r1])
        dk, dv = dk + dk_z, dv + dv_z
        dqs.append(dq_z)
    # the Pallas kernels take [B, N, Lqp, *] padded with zero rows
    pad = -(-lq // 128) * 128 - lq
    rows = lambda x: np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
    dq_w, dk_w, dv_w = j_flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(rows(np.swapaxes(do, 1, 2))),
        jnp.asarray(rows(lse.numpy()[..., None])),
        jnp.asarray(rows(delta.numpy()[..., None])), D ** -0.5, 128, 128,
        True)
    _close([torch.cat(dqs, 1).numpy(), dk.numpy(), dv.numpy()],
           [np.asarray(x) for x in (dq_w, dk_w, dv_w)], atol=5e-4, rtol=5e-4)


# ---------------------------------------------------------------------------
# The walk of the Hopper K6 (the masked dQ over the 128 x 128 table)
# ---------------------------------------------------------------------------

def _k6_walk(q, k, v, do, lse, delta, mask, tiles, scale):
    """dQ as the Hopper K6 computes it, in fp32: each 128-query block walks
    the key tiles its row of `tiles.fwd` admits, in order; on class-1 tiles
    the pairs the frame table forbids score -inf; rows whose lse is -inf
    take +inf in its place; K and V are padded with zeros to whole tiles
    and the keys past Lk masked on the tile whose own index is the last; a
    block with no admitted tile keeps dQ = 0."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    q_ids, kv_ids, fm = mask
    nkt = -(-Lk // 128)
    pad = lambda x: torch.nn.functional.pad(
        x.float().permute(0, 2, 1, 3), (0, 0, 0, nkt * 128 - Lk))
    kp, vp = pad(k), pad(v)                          # [B, N, nkt * 128, D]
    kv_pad = torch.nn.functional.pad(kv_ids.long(), (0, nkt * 128 - Lk))
    qt, dot = (x.float().permute(0, 2, 1, 3) for x in (q, do))
    lse_in = torch.where(lse == -math.inf, math.inf, lse)
    dq = torch.zeros_like(qt)
    for qb in range(tiles.fwd.shape[0]):
        r0, r1 = 128 * qb, min(128 * qb + 128, Lq)
        for kt in torch.nonzero(tiles.fwd[qb]).flatten().tolist():
            c0, c1 = 128 * kt, 128 * kt + 128
            s = qt[:, :, r0:r1] @ kp[:, :, c0:c1].transpose(-1, -2) * scale
            if tiles.fwd[qb, kt] == 1:
                allowed = fm[q_ids[r0:r1].long()][:, kv_pad[c0:c1]]
                s = s.masked_fill(~allowed, -math.inf)
            p = torch.exp(s - lse_in[:, :, r0:r1, None])
            if kt == nkt - 1:
                p[..., Lk - c0:] = 0.0
            dp = dot[:, :, r0:r1] @ vp[:, :, c0:c1].transpose(-1, -2)
            ds = p * (dp - delta[:, :, r0:r1, None])
            dq[:, :, r0:r1] += ds @ kp[:, :, c0:c1]
    return (scale * dq).permute(0, 2, 1, 3)


def test_k6_walk_over_admitted_tiles_matches_the_pallas_dq():
    """The Hopper K6's arithmetic on the CPU: `_k6_walk` against the JAX
    package's K6 (`_masked_bwd_dq_kernel`, through the masked VJP in
    interpret mode) and the port's plain backward, on a mask with a frame
    that sees nothing (its rows' lse is -inf, and query block 3 holds only
    its rows, so no tile of that block is admitted), partial and full
    tiles, and a ragged last key tile."""
    fm = np.tril(np.ones((3, 3), bool))
    fm[1] = False                        # frame 1 (rows 300..599) is blind
    ids = np.repeat(np.arange(3), 300)[:700]
    B, N, D, L = 1, 2, 64, 700
    q, k, v, w = _arrays([(B, L, N, D)] * 4, seed=13)
    _, vjp = jax.vjp(lambda a, b, c: j_masked(
        a, b, c, ids, ids, fm, block_q=128, block_k=128, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    dq_w = np.asarray(vjp(jnp.asarray(w))[0])

    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, w))
    mask = ta._as_mask(ids, ids, fm, torch.device("cpu"))
    tiles = ta.mask_tiles(*mask)
    assert (tiles.fwd[3] == 0).all()
    assert {0, 1, 2} <= set(tiles.fwd.flatten().tolist())
    o, lse = ta.frame_masked_attention_plain(qt, kt, vt, ids, ids, fm)
    delta = (dot * o).sum(-1).permute(0, 2, 1).contiguous()
    blind = torch.from_numpy(ids == 1)
    assert (lse[:, :, blind] == -math.inf).all()
    got = _k6_walk(qt, kt, vt, dot, lse, delta, mask, tiles, D ** -0.5)
    assert (got[:, blind] == 0).all()
    np.testing.assert_allclose(got.numpy(), dq_w, atol=5e-4, rtol=5e-4)
    plain = ta.frame_masked_attention_bwd_plain(qt, kt, vt, dot, lse, delta,
                                                ids, ids, fm)[0]
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
