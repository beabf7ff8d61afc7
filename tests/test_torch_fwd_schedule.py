"""K1's schedules off the card: `fwd_schedule` at every bf16 K1 shape of
`chip_smoke.py` on an H100's 132 SMs, `fwd_split_keys`, `split_keys`'
limits, and the key split's plain version (`flash_attention_split_plain`,
`merge_splits`) against the Pallas K1 in interpret mode."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.ops.attention import flash_attention_lse as j_flash_lse
from mmpl_tpu_torch.ops import attention as ta

#: SMs of an H100 SXM
H100_SMS = 132

#: (label, B, N, D, Lq, Lk, the schedule the card runs): chip_smoke.py's
#: bf16 K1_SHAPES
K1_SCHEDULES = [
    ("group0_self", 2, 12, 128, 3120, 3120, "persistent"),
    ("group1_self", 2, 12, 128, 10920, 14040, "grid"),
    ("group2_self", 2, 12, 128, 9360, 20280, "grid"),
    ("group3_self", 2, 12, 128, 9360, 32760, "grid"),
    ("i2v_group0_self", 2, 12, 128, 1560, 1560, "persistent"),
    ("i2v_group1_self", 2, 12, 128, 1560, 3120, "persistent"),
    ("i2v_group3_self", 2, 12, 128, 9360, 23400, "grid"),
    ("cross", 2, 12, 128, 9360, 512, "persistent"),
    ("tf_cross", 1, 12, 128, 65520, 512, "persistent"),
    ("fewstep_self_hot", 1, 12, 128, 4680, 32760, "grid"),
    ("fewstep_cross", 1, 12, 128, 4680, 512, "persistent"),
    ("ragged", 2, 12, 128, 1000, 1300, "persistent"),
    ("i2v14b_self", 2, 40, 128, 32760, 32760, "grid"),
    ("i2v14b_cross", 2, 40, 128, 32760, 512, "persistent"),
    ("i2v14b_img", 2, 40, 128, 32760, 257, "persistent"),
    ("clip_self", 1, 16, 80, 257, 257, "persistent"),
    ("bidir_self", 2, 12, 128, 32760, 32760, "grid"),
    ("critic_self", 1, 12, 128, 32760, 32760, "grid"),
    ("cd_block_self", 2, 12, 128, 4680, 32760, "grid"),
    ("gan_head_q1", 2, 12, 128, 1, 32760, "split"),
]


@pytest.mark.parametrize("label,B,N,D,lq,lk,mode", K1_SCHEDULES,
                         ids=[r[0] for r in K1_SCHEDULES])
def test_each_k1_shape_gets_its_schedule(label, B, N, D, lq, lk, mode):
    """The long self-attention on the grid, the short keys on the
    persistent walk, one query row over 32760 keys split; the same answer
    from a cold cache."""
    got = ta.fwd_schedule(B, N, lq, lk, D, H100_SMS)
    assert got[0] == mode, got
    assert (got[1] > 1) is (mode == "split"), got
    ta.fwd_schedule.cache_clear()
    assert ta.fwd_schedule(B, N, lq, lk, D, H100_SMS) == got


def test_the_gan_head_splits_within_the_limits():
    """24 units over 256 key tiles: more than one split, each at least
    FWD_MIN_SPLIT_TILES tiles, at most FWD_MAX_SPLITS, the splits' units
    one wave of the card."""
    mode, splits = ta.fwd_schedule(2, 12, 1, 32760, 128, H100_SMS)
    assert mode == "split" and 1 < splits <= ta.FWD_MAX_SPLITS
    assert 256 // splits >= ta.FWD_MIN_SPLIT_TILES
    assert 24 * splits <= H100_SMS < 24 * (splits + 1)


@pytest.mark.parametrize("B,N,lq,lk,D,sms,want", [
    (2, 12, 1, 32760, 128, 132, 5),   # the GAN head: 24 units x 5, one wave
    (1, 16, 1, 32760, 128, 132, 8),   # 16 units x 8
    (2, 12, 1, 896, 128, 132, 1),     # 7 tiles: fewer than 2 x 4 a split
    (1, 1, 1, 524288, 128, 132, 16),  # FWD_MAX_SPLITS
    (1, 67, 1, 32760, 128, 132, 1),   # more than half the card: one wave
    (1, 66, 128, 524288, 128, 2112, 15),  # 4.36 MB a split, 64 MB in all
])
def test_split_keys_limits(B, N, lq, lk, D, sms, want):
    assert ta.split_keys(B, N, lq, lk, D, sms) == want


def test_many_units_never_split():
    """Units that fill more than half the card take the persistent walk
    or the grid, whatever their keys."""
    assert ta.fwd_schedule(1, 67, 1, 32760, 128, H100_SMS) == ("grid", 1)
    assert ta.fwd_schedule(1, 66, 1, 32760, 128, H100_SMS)[0] == "split"
    assert ta.fwd_schedule(1, 67, 1, 4096, 128, H100_SMS) == ("persistent",
                                                              1)


SPLIT_KEYS = [(lk, s) for lk in (1, 127, 128, 129, 257, 1000, 32760)
              for s in (1, 2, 3, 5, 11, 16) if s <= -(-lk // ta.FWD_BLOCK)]


@pytest.mark.parametrize("lk,splits", SPLIT_KEYS)
def test_split_keys_cover_every_key_once_in_whole_tiles(lk, splits):
    ranges = ta.fwd_split_keys(lk, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == lk
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    for a, b in ranges:
        assert a < b and a % ta.FWD_BLOCK == 0
    for _, b in ranges[:-1]:
        assert b % ta.FWD_BLOCK == 0


def _qkv(lq, lk, d, seed, B=2, N=3):
    rng = np.random.default_rng(seed)
    mk = lambda L: rng.standard_normal((B, L, N, d)).astype(np.float32)
    return mk(lq), mk(lk), mk(lk)


@functools.lru_cache(maxsize=None)
def _pallas(lq, lk, d):
    """The inputs and the Pallas K1's (O, lse) in interpret mode, once a
    shape for every split count."""
    q, k, v = _qkv(lq, lk, d, seed=lq * 7 + lk + d)
    o, lse = j_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         block_q=128, block_k=128, interpret=True)
    return (q, k, v), np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("d", [24, 80, 128])
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("lk", [257, 300, 1000])
@pytest.mark.parametrize("lq", [1, 3, 130])
def test_split_plain_matches_pallas_flash(lq, lk, splits, d):
    """The plain key split (each range through the plain version, merged
    in order) against the Pallas K1: O and lse within the tolerances of
    test_torch_attention.py; at 257 keys the third range is one key."""
    (q, k, v), want_o, want_lse = _pallas(lq, lk, d)
    got_o, got_lse = ta.flash_attention_split_plain(
        *map(torch.from_numpy, (q, k, v)), splits)
    assert got_o.dtype == torch.float32 and got_lse.shape == (2, 3, lq)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5)


def test_a_one_key_range_merges_without_nan():
    """129 keys in two splits: 128 keys, then one."""
    q, k, v = map(torch.from_numpy, _qkv(5, 129, 32, seed=3))
    assert ta.fwd_split_keys(129, 2) == [(0, 128), (128, 129)]
    o, lse = ta.flash_attention_split_plain(q, k, v, 2)
    po, plse = ta.flash_attention_plain(q, k, v)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o, po, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, plse, atol=2e-6, rtol=0)


def test_merge_weighs_a_range_that_sees_nothing_as_zero():
    """A range whose lse is -inf adds nothing and no NaN; a row whose
    every range has lse = -inf gets O = 0 and lse = -inf."""
    g = torch.Generator().manual_seed(0)
    o1, o2 = (torch.randn((1, 4, 2, 8), generator=g) for _ in range(2))
    lse1 = torch.randn((1, 2, 4), generator=g)
    lse2 = torch.full((1, 2, 4), -math.inf)
    o, lse = ta.merge_splits([(o1, lse1), (o2, lse2)])
    torch.testing.assert_close(o, o1, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, lse1, atol=1e-6, rtol=0)
    o, lse = ta.merge_splits([(o1, lse2), (o2, lse2.clone())])
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, lse2)
