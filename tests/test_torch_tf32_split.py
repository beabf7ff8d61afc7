"""The numerics of the fp32 K1 / P1, K2 / K5 and K3 / K6 bodies
(csrc/flash_fwd_f32_sm90.cuh, csrc/flash_bwd_f32_sm90.cuh,
csrc/flash_bwd_dq_f32_sm90.cuh): split TF32.  A plain emulation, here and
not in the package: each operand rounded to TF32 as `cvt.rna.tf32.f32`
does (10 mantissa bits, to nearest, ties away from zero) as hi, the
remainder rounded again as lo, and each product taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32.  The attention forward (O and
the lse), dK / dV and dQ (also under a frame mask with a frame that sees
nothing, and for dK / dV one that nothing sees) computed that way are held against the JAX package's Pallas
kernels in interpret mode in fp32 at 1e-5; one TF32 pass, which keeps the
10 bits alone, misses 1e-4, the fp32 paths' tolerance, which is why the
bodies split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmpl_tpu.ops.attention import (_flash_bwd_impl as j_flash_bwd,
                                    _flash_vjp_fwd_impl as j_flash_fwd,
                                    frame_masked_attention as j_masked)

#: (D, Lq, Lk): the smoke configuration's head dim and the width kD = 64,
#: ragged against the Pallas kernels' 128-row blocks
CASES = [(24, 100, 77), (64, 130, 200)]
TOL = 1e-5
FP32_TOL = 1e-4


def tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32, kept in fp32: round to nearest with ties away
    from zero on the magnitude, then the low 13 mantissa bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(x.astype(np.float32) - hi)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as split TF32: three products summed in fp32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as one TF32 pass."""
    return tf32(a) @ tf32(b)


def _inputs(D, lq, lk, seed):
    rng = np.random.default_rng(seed)
    B, N = 1, 2
    q, do = (rng.standard_normal((B, lq, N, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, lk, N, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _heads(x):
    """[B, L, N, D] -> [B, N, L, D]."""
    return np.swapaxes(x, 1, 2)


def emulated_fwd(q, k, v, mm):
    """(O [B, L, N, D], lse [B, N, L]) with every product through `mm`."""
    sc = np.float32(q.shape[-1] ** -0.5)
    qh, kh, vh = map(_heads, (q, k, v))
    s = mm(qh, np.swapaxes(kh, -1, -2)) * sc
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    o = mm(p, vh) / l
    return np.swapaxes(o, 1, 2), (m + np.log(l))[..., 0]


def emulated_dkv(q, k, v, do, lse, delta, mm, allowed=None):
    """(dK, dV) [B, L, N, D] from the saved lse and delta [B, N, Lq]; with
    `allowed` ([Lq, Lk] bool, the frame mask by token), p is 0 on the pairs
    it forbids and on rows whose lse is -inf."""
    sc = np.float32(q.shape[-1] ** -0.5)
    qh, kh, vh, doh = map(_heads, (q, k, v, do))
    s = mm(qh, np.swapaxes(kh, -1, -2)) * sc
    if allowed is None:
        p = np.exp(s - lse[..., None])
    else:
        live = np.isfinite(lse)[..., None]
        p = np.where(live & allowed,
                     np.exp(s - np.where(live, lse[..., None], 0)), 0)
    ds = p * (mm(doh, np.swapaxes(vh, -1, -2)) - delta[..., None])
    dv = mm(np.swapaxes(p, -1, -2), doh)
    dk = sc * mm(np.swapaxes(ds, -1, -2), qh)
    return np.swapaxes(dk, 1, 2), np.swapaxes(dv, 1, 2)


def emulated_dq(q, k, v, do, lse, delta, mm, allowed=None):
    """dQ [B, L, N, D] from the saved lse and delta [B, N, Lq]; p is 0 on
    rows whose lse is -inf and, with `allowed` ([Lq, Lk] bool, the frame
    mask by token), on the pairs it forbids."""
    sc = np.float32(q.shape[-1] ** -0.5)
    qh, kh, vh, doh = map(_heads, (q, k, v, do))
    s = mm(qh, np.swapaxes(kh, -1, -2)) * sc
    live = np.isfinite(lse)[..., None]
    keep = live if allowed is None else live & allowed
    p = np.where(keep, np.exp(s - np.where(live, lse[..., None], 0)), 0)
    ds = p * (mm(doh, np.swapaxes(vh, -1, -2)) - delta[..., None])
    return np.swapaxes(sc * mm(ds, kh), 1, 2)


def masked_lse(q, k, allowed):
    """The natural-log lse [B, N, Lq] under `allowed`, in float64 (-inf on
    rows that see no key)."""
    qh, kh = (_heads(x).astype(np.float64) for x in (q, k))
    s = qh @ np.swapaxes(kh, -1, -2) * q.shape[-1] ** -0.5
    s = np.where(allowed, s, -np.inf)
    m = s.max(-1, keepdims=True)
    shift = np.where(np.isfinite(m), m, 0)
    with np.errstate(divide="ignore"):
        return (np.log(np.exp(s - shift).sum(-1, keepdims=True))
                + shift)[..., 0].astype(np.float32)


def pallas_fwd(q, k, v):
    """The JAX package's K1 in interpret mode: (O, lse [B, N, Lq])."""
    o, (*_, lse) = j_flash_fwd(*map(jnp.asarray, (q, k, v)), None, 128, 128,
                               True)
    return np.asarray(o), np.asarray(lse)[:, :, :q.shape[1], 0]


def pallas_bwd(q, k, v, do, lse, delta):
    """The JAX package's K3 and K2 in interpret mode, fed this lse and
    delta: (dQ, dK, dV)."""
    pad = -(-q.shape[1] // 128) * 128 - q.shape[1]
    rows = lambda x: np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
    return tuple(np.asarray(g) for g in j_flash_bwd(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(rows(_heads(do))),
        jnp.asarray(rows(lse[..., None])), jnp.asarray(rows(delta[..., None])),
        q.shape[-1] ** -0.5, 128, 128, True))


def pallas_dkv(q, k, v, do, lse, delta):
    """The JAX package's K2 in interpret mode, fed this lse and delta."""
    return pallas_bwd(q, k, v, do, lse, delta)[1:]


def _max_err(got, want) -> float:
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                  1 + ulp], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one, 1 + ulp, 1 + ulp, -(1 + ulp), 1 + ulp],
                          np.float32))
    hi, lo = split(np.float32([np.pi]))
    assert hi[0] + lo[0] != hi[0]
    assert abs(float(hi[0]) + float(lo[0]) - np.pi) < 2.0 ** -20


@pytest.mark.parametrize("D,lq,lk", CASES)
def test_split_tf32_forward_matches_pallas(D, lq, lk):
    q, k, v, _ = _inputs(D, lq, lk, seed=D)
    o_w, lse_w = pallas_fwd(q, k, v)
    o, lse = emulated_fwd(q, k, v, mm3)
    assert _max_err((o, lse), (o_w, lse_w)) <= TOL


@pytest.mark.parametrize("D,lq,lk", CASES)
def test_split_tf32_dkv_matches_pallas(D, lq, lk):
    q, k, v, do = _inputs(D, lq, lk, seed=D + 1)
    o, lse = pallas_fwd(q, k, v)
    delta = _heads(do * o).sum(-1)
    want = pallas_dkv(q, k, v, do, lse, delta)
    got = emulated_dkv(q, k, v, do, lse, delta, mm3)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("D,lq,lk", CASES)
def test_split_tf32_dq_matches_pallas(D, lq, lk):
    q, k, v, do = _inputs(D, lq, lk, seed=D + 3)
    o, lse = pallas_fwd(q, k, v)
    delta = _heads(do * o).sum(-1)
    want = pallas_bwd(q, k, v, do, lse, delta)[0]
    got = emulated_dq(q, k, v, do, lse, delta, mm3)
    assert _max_err((got,), (want,)) <= TOL


def test_split_tf32_masked_dq_matches_pallas():
    """K6's arithmetic: the masked dQ against the JAX package's K6
    (`_masked_bwd_dq_kernel`, through the masked VJP in interpret mode) on
    a mask whose frame 1 sees nothing, so its rows get dQ = 0."""
    fm = np.tril(np.ones((3, 3), bool))
    fm[1] = False                        # frame 1 (rows 300..599) is blind
    ids = np.repeat(np.arange(3), 300)[:700]
    q, k, v, do = _inputs(64, 700, 700, seed=13)
    o_w, vjp = jax.vjp(lambda a, b, c: j_masked(
        a, b, c, ids, ids, fm, block_q=128, block_k=128, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = np.asarray(vjp(jnp.asarray(do))[0])
    allowed = fm[ids][:, ids]
    lse = masked_lse(q, k, allowed)
    assert np.isneginf(lse[:, :, ids == 1]).all()
    delta = _heads(do * np.asarray(o_w)).sum(-1)
    got = emulated_dq(q, k, v, do, lse, delta, mm3, allowed)
    assert (got[:, ids == 1] == 0).all()
    assert _max_err((got,), (want,)) <= TOL


def test_split_tf32_masked_dkv_matches_pallas():
    """K5's arithmetic: the masked dK / dV against the JAX package's K5
    (`_masked_bwd_dkv_kernel`, through the masked VJP in interpret mode) on
    a mask whose frame 1 sees nothing and whose frame 2 nothing sees, so
    frame 2's keys get dK = dV = 0."""
    fm = np.tril(np.ones((3, 3), bool))
    fm[1] = False                        # frame 1 (rows 300..599) is blind
    fm[:, 2] = False                     # frame 2 (keys 600..699) is unseen
    ids = np.repeat(np.arange(3), 300)[:700]
    q, k, v, do = _inputs(64, 700, 700, seed=14)
    o_w, vjp = jax.vjp(lambda a, b, c: j_masked(
        a, b, c, ids, ids, fm, block_q=128, block_k=128, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))[1:]]
    allowed = fm[ids][:, ids]
    lse = masked_lse(q, k, allowed)
    assert np.isneginf(lse[:, :, ids == 1]).all()
    delta = _heads(do * np.asarray(o_w)).sum(-1)
    got = emulated_dkv(q, k, v, do, lse, delta, mm3, allowed)
    for g in got:
        assert (g[:, ids == 2] == 0).all()
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("D,lq,lk", CASES)
def test_one_tf32_pass_misses_the_fp32_tolerance(D, lq, lk):
    q, k, v, do = _inputs(D, lq, lk, seed=D + 2)
    o_w, lse_w = pallas_fwd(q, k, v)
    delta = _heads(do * o_w).sum(-1)
    dq_w, *dkv_w = pallas_bwd(q, k, v, do, lse_w, delta)
    assert _max_err(emulated_fwd(q, k, v, mm1), (o_w, lse_w)) > FP32_TOL
    assert _max_err(emulated_dkv(q, k, v, do, lse_w, delta, mm1),
                    dkv_w) > FP32_TOL
    assert _max_err((emulated_dq(q, k, v, do, lse_w, delta, mm1),),
                    (dq_w,)) > FP32_TOL
