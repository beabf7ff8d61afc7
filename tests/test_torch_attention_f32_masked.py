"""Port parity for the fp32 K4, the masked kernel of fp32 K1's split-TF32
body (`csrc/flash_fwd_f32_sm90.cuh`), on the CPU: `_k4_f32_walk`, a model
of its arithmetic over the 64 x 64 tile table, against the JAX package's
K4 (`_masked_fwd_kernel`, in interpret mode) and the port's plain
version."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.ops.attention import _MaskedMeta, _masked_vjp_fwd_impl
from mmpl_tpu_torch.ops import attention as ta
from test_torch_attention_bwd import _arrays
from test_torch_cuda import _late_frames

LOG2E = 1.4426950408889634
#: the kernel's query block, key tile and fold period
BLOCK_M, KEY_TILE, FOLD = 64, 32, 16


def _jax_k4(q, k, v, ids, fm, block=128):
    """O and lse of the JAX package's K4 in interpret mode, its operands
    and frame tables built as `frame_masked_attention` builds them."""
    B, L, N, D = q.shape
    F = fm.shape[0]
    Fp = 128
    Lp = -(-L // block) * block
    fm_p = np.zeros((Fp, Fp), np.float32)
    fm_p[:F, :F] = fm
    padded = np.full(Lp, F, np.int32)
    padded[:L] = ids
    onehot = np.zeros((Lp, Fp), np.float32)
    onehot[np.arange(Lp), np.minimum(padded, Fp - 1)] = padded < F
    fmb = np.zeros((F + 1, F + 1), bool)
    fmb[:F, :F] = fm
    nb = Lp // block
    frames = [np.unique(padded[i * block:(i + 1) * block]) for i in range(nb)]
    adm = np.array([[int(fmb[np.ix_(a, b)].any()) for b in frames]
                    for a in frames], np.int32)
    meta = _MaskedMeta(onehot, onehot, fm_p, Fp, D ** -0.5, block, block,
                       True, L, L, adm)
    pad = lambda x: jnp.pad(jnp.swapaxes(jnp.asarray(x), 1, 2),
                            ((0, 0), (0, 0), (0, Lp - L), (0, 0)))
    o, (*_, lse) = _masked_vjp_fwd_impl(pad(q), pad(k), pad(v), meta)
    return (np.swapaxes(np.asarray(o)[:, :, :L], 1, 2),
            np.asarray(lse)[:, :, :L, 0])


def _k4_f32_walk(q, k, v, mask, tiles, scale):
    """O and lse as the fp32 K4 computes them, and what its guards met.

    Each 64-query block walks its row of `tiles.t64`, an entry two 32-key
    tiles (one for the last entry where ceil(Lk / 32) is odd): class 0
    skips both, class 1 tests each pair against the frame table, class 2
    none; the keys past Lk fail K1's pad test on every class.  The softmax
    runs in the exp2 domain (log2(e) in the scale); a row whose running
    max is still -inf shifts by 0, so alpha and p are 0 and not NaN.  The
    output accumulates over 16 walked tiles, then is folded into its fp32
    copy, rescaled to the new row max (scale 0 while the max is -inf), and
    once more at the end; the lse comes back in natural log.  Returns (O,
    lse, what the walk met: "shift", steps where some row had still seen
    no key; "fold", folds inside a walk while some row had seen none;
    "late", rows whose first key came after a fold)."""
    pad = torch.nn.functional.pad
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    q_ids, kv_ids, fm = mask
    nkb, nqb = -(-Lk // KEY_TILE), -(-Lq // BLOCK_M)
    t64 = tiles.t64
    assert t64.shape == (nqb, -(-Lk // 64))
    rows = lambda x, L, n: pad(x.float().permute(0, 2, 1, 3),
                               (0, 0, 0, n - L))
    qp = rows(q, Lq, BLOCK_M * nqb)
    kp, vp = rows(k, Lk, KEY_TILE * nkb), rows(v, Lk, KEY_TILE * nkb)
    kf = pad(kv_ids.long(), (0, KEY_TILE * nkb - Lk))   # 0 past Lk
    sc = scale * LOG2E
    o = torch.zeros(B, N, BLOCK_M * nqb, D)
    lse = torch.zeros(B, N, BLOCK_M * nqb)
    met = {"shift": 0, "fold": 0, "late": 0}
    ninf = -math.inf
    for qb in range(nqb):
        r0, r1 = BLOCK_M * qb, BLOCK_M * qb + BLOCK_M
        row = t64[qb]
        walk = [j for j in range(nkb) if row[j // 2] != 0]
        # the consumer's count of its steps
        assert len(walk) == 2 * int((row != 0).sum()) - int(
            nkb % 2 == 1 and row[-1] != 0)
        live = torch.arange(r0, r1) < Lq
        qf = q_ids.long()[torch.clamp(torch.arange(r0, r1), max=Lq - 1)]
        m = torch.full((B, N, BLOCK_M), ninf)
        mf = torch.full((B, N, BLOCK_M), ninf)
        l = torch.zeros(B, N, BLOCK_M)
        acc = torch.zeros(B, N, BLOCK_M, D)
        om = torch.zeros(B, N, BLOCK_M, D)

        def fold():
            f = torch.where(m == ninf, 0.0, torch.exp2(mf - m))
            return om * f[..., None] + acc

        for i, j in enumerate(walk):
            c0, c1 = KEY_TILE * j, KEY_TILE * j + KEY_TILE
            ok = (torch.arange(c0, c1) < Lk)[None, :].expand(BLOCK_M,
                                                             KEY_TILE)
            if row[j // 2] == 1:
                ok = ok & live[:, None] & fm[qf][:, kf[c0:c1]]
            s = qp[:, :, r0:r1] @ kp[:, :, c0:c1].transpose(-1, -2) * sc
            s = torch.where(ok, s, ninf)
            m_new = torch.maximum(m, s.amax(-1))
            met["shift"] += int((m_new == ninf).any())
            shift = torch.where(m_new == ninf, 0.0, m_new)
            alpha = torch.exp2(m - shift)
            p = torch.exp2(s - shift[..., None])
            l = l * alpha + p.sum(-1)
            if i >= FOLD:
                met["late"] += int(((m == ninf) & (m_new > ninf)).sum())
            m = m_new
            acc = acc * alpha[..., None]
            if i > 0 and i % FOLD == 0:      # steps i - 16 .. i - 1
                met["fold"] += int((m == ninf).any())
                om, mf, acc = fold(), m, torch.zeros_like(acc)
            acc = acc + p @ vp[:, :, c0:c1]
        om = fold()
        lsafe = torch.where(l == 0, 1.0, l)
        o[:, :, r0:r1] = om / lsafe[..., None]
        lse[:, :, r0:r1] = torch.where(
            m == ninf, ninf, (m + torch.log2(lsafe)) / LOG2E)
    return (o[:, :, :Lq].permute(0, 2, 1, 3), lse[:, :, :Lq], met)


def _k4_case(name):
    """(frame mask, token frame ids, B, N, D) of a K4 walk case."""
    if name == "blind_ragged":
        # frames of 200 over 650 tokens: frame 1 sees nothing, frame 2 is
        # seen by nothing; 21 key tiles, the last of 10 keys; query block
        # 4 holds only blind rows, block 3 blind rows beside frame 0's
        fm = np.tril(np.ones((4, 4), bool))
        fm[1] = False
        fm[:, 2] = False
        return fm, np.repeat(np.arange(4), 200)[:650], 1, 2, 64
    return (*_late_frames(), 1, 1, 64)


@pytest.mark.parametrize("case", ["blind_ragged", "late_fold"])
def test_k4_f32_walk_over_admitted_tiles_matches_the_pallas_forward(case):
    """The fp32 K4's arithmetic on the CPU: `_k4_f32_walk` against the JAX
    package's K4 (`_masked_fwd_kernel` in interpret mode) and the port's
    plain version, on a mask with blind rows, a query block with no
    admitted tile, partial and full entries and a ragged last key tile
    (an odd count of 32-key tiles); or on one whose rows see their first
    key only after two folds, with a fold while rows beside them have
    seen nothing (`_late_frames`)."""
    fm, ids, B, N, D = _k4_case(case)
    L = ids.size
    q, k, v = _arrays([(B, L, N, D)] * 3, seed=19)
    o_w, lse_w = _jax_k4(q, k, v, ids, fm)

    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    mask = ta._as_mask(ids, ids, fm, torch.device("cpu"))
    tiles = ta.mask_tiles(*mask)
    assert -(-L // KEY_TILE) % 2 == 1 and L % KEY_TILE
    o, lse, met = _k4_f32_walk(qt, kt, vt, mask, tiles, D ** -0.5)
    blind = torch.from_numpy(~fm[ids].any(1))
    assert met["shift"] > 0
    if case == "blind_ragged":
        assert (tiles.t64[4] == 0).all() and blind.any()
        assert {0, 1, 2} <= set(tiles.t64.flatten().tolist())
    else:
        # frame 9's 40 rows (query block 15) see no key before tile 34,
        # the blind frame 7's rows pass a fold in block 12 (30 tiles)
        assert (tiles.t64[15] != 0).all()
        assert (tiles.t64[12] != 0).sum() == 15
        assert met["late"] >= 40 and met["fold"] >= 3
    assert (o[:, blind] == 0).all()
    assert (lse[:, :, blind] == -math.inf).all()
    assert torch.isfinite(o).all()
    live = ~blind
    np.testing.assert_allclose(o.numpy(), o_w, atol=2e-5)
    np.testing.assert_allclose(lse[:, :, live].numpy(), lse_w[:, :, live],
                               atol=2e-5)
    po, plse = ta.frame_masked_attention_plain(qt, kt, vt, ids, ids, fm)
    assert torch.equal(plse == -math.inf, lse == -math.inf)
    torch.testing.assert_close(o, po, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse[:, :, live], plse[:, :, live], atol=1e-5,
                               rtol=1e-5)
