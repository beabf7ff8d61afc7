"""The frame mask's tile tables (`ops.attention.mask_tiles`, `pool_tiles`):
the 128 x 128 table of the Hopper K4 and the 64 x 128 table of the Hopper
K5 against the token-level mask of the JAX package
(`training/masks.expand_frame_mask`) and against the tile admissibility
that the JAX package's `frame_masked_attention` builds, at lengths that
are ragged at 64 and at 128; what the wrappers refuse."""

import numpy as np
import pytest
import torch

from mmpl_tpu.core.geometry import T2V_CLEAN_STEPS
from mmpl_tpu.ops import attention as jattn
from mmpl_tpu.training import masks as jm
from mmpl_tpu_torch.ops import attention as ta

CASES = ["fps", "teacher_forcing", "blind", "dead"]


def _case(name):
    """(frame mask, frame ids, tokens a frame)."""
    if name == "fps":                # the 42 frames of the TF step
        fm, S, L = jm.fps_forcing_frame_mask(T2V_CLEAN_STEPS), 130, None
    elif name == "teacher_forcing":  # [clean | noisy] 2 x 7 frames
        fm, S, L = jm.teacher_forcing_frame_mask(7, 3), 130, None
    elif name == "blind":            # frame 1 sees nothing, L = 1000
        fm, S, L = jm.blockwise_causal_frame_mask(8, 3), 130, 1000
        fm[1] = False
    else:    # frame 1 sees nothing, frame 2 is seen by nothing: whole
        fm, S, L = jm.blockwise_causal_frame_mask(4, 3), 300, 1000  # tiles
        fm[1] = False
        fm[:, 2] = False
    ids = np.repeat(np.arange(fm.shape[0]), S)[:L]
    return fm, ids, S


def _token_classes(fm, ids, S, bq, bk):
    """0 / 1 / 2 of each bq x bk tile of the token-level mask: no pair
    allowed, some, all (of the tokens the tile holds)."""
    L = len(ids)
    tok = jm.expand_frame_mask(fm, S)[:L, :L]
    nq, nk = -(-L // bq), -(-L // bk)
    some = np.zeros((nq * bq, nk * bk), bool)
    every = np.ones((nq * bq, nk * bk), bool)
    some[:L, :L] = every[:L, :L] = tok
    some = some.reshape(nq, bq, nk, bk).any(axis=(1, 3))
    every = every.reshape(nq, bq, nk, bk).all(axis=(1, 3))
    return np.where(some, np.where(every, 2, 1), 0).astype(np.uint8)


def _tiles(fm, ids):
    t = torch.as_tensor(ids, dtype=torch.int32)
    return ta.mask_tiles(t, t, torch.as_tensor(fm))


@pytest.mark.parametrize("table,bq,bk", [("t64", 64, 64), ("fwd", 128, 128),
                                         ("dkv", 64, 128)])
@pytest.mark.parametrize("name", CASES)
def test_tables_match_the_token_level_mask(name, table, bq, bk):
    fm, ids, S = _case(name)
    got = getattr(_tiles(fm, ids), table).numpy()
    if table == "dkv":               # stored key-block major
        got = got.T
    want = _token_classes(fm, ids, S, bq, bk)
    np.testing.assert_array_equal(got, want)
    if name in ("fps", "dead"):      # every class occurs
        assert {0, 1, 2} <= set(np.unique(got))


def _jax_adm(fm, ids, block_q, block_k):
    """The JAX package's tile admissibility (ops/attention.py
    `frame_masked_attention`), rebuilt from the same ids: padded tokens
    take the padding frame F, which allows nothing."""
    F = fm.shape[0]
    L = len(ids)
    qf = np.full(-(-L // block_q) * block_q, F, np.int32)
    kf = np.full(-(-L // block_k) * block_k, F, np.int32)
    qf[:L] = kf[:L] = ids
    fmb = np.zeros((F + 1, F + 1), bool)
    fmb[:F, :F] = fm
    adm = np.zeros((len(qf) // block_q, len(kf) // block_k), np.int32)
    for qi in range(adm.shape[0]):
        qs = np.unique(qf[qi * block_q:(qi + 1) * block_q])
        for ki in range(adm.shape[1]):
            ks = np.unique(kf[ki * block_k:(ki + 1) * block_k])
            adm[qi, ki] = int(fmb[np.ix_(qs, ks)].any())
    return adm


def _jax_built_adm(monkeypatch, fm, ids):
    """The admissibility that the JAX package's own `frame_masked_attention`
    hands its kernels at 128 x 128 blocks (its kernels are not run)."""
    seen = {}

    def capture(qt, kt, vt, meta):
        seen["adm"] = np.asarray(meta.adm)
        return qt

    monkeypatch.setattr(jattn, "_masked_flash_vjp", capture)
    x = np.zeros((1, len(ids), 1, 8), np.float32)
    jattn.frame_masked_attention(x, x, x, ids, ids, fm, block_q=128,
                                 block_k=128, interpret=True)
    return seen["adm"]


@pytest.mark.parametrize("name", CASES)
def test_skipped_tiles_are_those_the_jax_package_skips(monkeypatch, name):
    fm, ids, _ = _case(name)
    tiles = _tiles(fm, ids)
    adm128 = _jax_built_adm(monkeypatch, fm, ids)
    np.testing.assert_array_equal(adm128, _jax_adm(fm, ids, 128, 128))
    np.testing.assert_array_equal(tiles.fwd.numpy() != 0, adm128 != 0)
    dkv = tiles.dkv.numpy().T
    np.testing.assert_array_equal(dkv != 0, _jax_adm(fm, ids, 64, 128) != 0)
    # a 128 x 128 tile that the JAX package skips is skipped by both of
    # K5's 64-query tiles within it
    assert not (dkv[adm128.repeat(2, axis=0)[:dkv.shape[0]] == 0]).any()


@pytest.mark.parametrize("shape,rows,cols", [((5, 7), 2, 2), ((4, 9), 1, 2),
                                             ((1, 1), 2, 2), ((6, 6), 3, 1)])
def test_pool_tiles_matches_a_loop(shape, rows, cols):
    rng = np.random.default_rng(sum(shape) + rows)
    t = rng.integers(0, 3, shape).astype(np.uint8)
    t[0, :] = 2                                   # some pooled tiles all 2
    got = ta.pool_tiles(torch.from_numpy(t), rows, cols).numpy()
    want = np.zeros((-(-shape[0] // rows), -(-shape[1] // cols)), np.uint8)
    for i in range(want.shape[0]):
        for j in range(want.shape[1]):
            sub = t[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
            want[i, j] = 2 if (sub == 2).all() else (1 if sub.any() else 0)
    np.testing.assert_array_equal(got, want)


def _mask_args(tiles, F=3, hopper=False):
    ids = torch.zeros(300, dtype=torch.int32)
    fm = torch.ones((F, F), dtype=torch.bool)
    return ta._mask_args("k", (ids, ids, fm), tiles, 300, 300,
                         torch.device("cpu"), "fwd", hopper)


def test_mask_arguments_carry_every_table():
    ids = torch.zeros(300, dtype=torch.int32)
    tiles = ta.mask_tiles(ids, ids, torch.ones((3, 3), dtype=torch.bool))
    assert [tuple(x.shape) for x in tiles] == [(5, 5), (3, 3), (3, 5)]
    args = _mask_args(tiles)
    assert args[3:] == [tiles.t64.data_ptr(), tiles.fwd.data_ptr(), 3]


@pytest.mark.parametrize("bad", ["bare_table", "fwd_shape", "dkv_untransposed",
                                 "dtype", "frames"])
def test_mask_arguments_refuse_what_the_kernels_do_not_take(bad):
    ids = torch.zeros(300, dtype=torch.int32)
    F = ta.SM90_MAX_FRAMES + 1 if bad == "frames" else 3
    tiles = ta.mask_tiles(ids, ids, torch.ones((F, F), dtype=torch.bool))
    tiles = {
        "bare_table": tiles.t64,
        "fwd_shape": tiles._replace(fwd=tiles.t64),
        "dkv_untransposed": tiles._replace(dkv=tiles.dkv.t().contiguous()),
        "dtype": tiles._replace(fwd=tiles.fwd.to(torch.int32)),
        "frames": tiles,
    }[bad]
    with pytest.raises(ValueError):
        _mask_args(tiles, F, hopper=True)


@pytest.mark.parametrize("part,table", [("dkv", "dkv"), ("dq", "fwd")])
def test_masked_backward_arguments_carry_their_coarse_table(part, table):
    """K5's entry takes the key-block-major 64 x 128 table, K6's the
    128 x 128 table of the forward (the Hopper K6 walks K4's rows)."""
    ids = torch.zeros(300, dtype=torch.int32)
    mask = (ids, ids, torch.ones((3, 3), dtype=torch.bool))
    tiles = ta.mask_tiles(*mask)
    args = ta._bwd_mask_args(part, mask, tiles, 300, 300, torch.device("cpu"),
                             torch.bfloat16)
    assert args[3:] == [tiles.t64.data_ptr(),
                        getattr(tiles, table).data_ptr(), 3]


@pytest.mark.parametrize("part", ["dkv", "dq"])
@pytest.mark.parametrize("dtype,refused", [(torch.bfloat16, True),
                                           (torch.float16, True),
                                           (torch.float32, False)])
def test_hopper_masked_backward_refuses_more_frames_than_it_holds(part, dtype,
                                                                 refused):
    """bf16 / fp16 K5 and K6 hold the frame table in shared memory, up to
    SM90_MAX_FRAMES frames; the fp32 template reads it from memory."""
    F = ta.SM90_MAX_FRAMES + 1
    ids = torch.zeros(300, dtype=torch.int32)
    mask = (ids, ids, torch.ones((F, F), dtype=torch.bool))
    tiles = ta.mask_tiles(*mask)
    call = lambda: ta._bwd_mask_args(part, mask, tiles, 300, 300,
                                     torch.device("cpu"), dtype)
    if refused:
        with pytest.raises(ValueError, match=str(ta.SM90_MAX_FRAMES)):
            call()
    else:
        assert call()[-1] == F
