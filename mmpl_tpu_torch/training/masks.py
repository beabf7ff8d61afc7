"""Training attention masks, frame-granular (numpy only).

Port of `mmpl_tpu/training/masks.py` (the JAX package's copy is not
imported).  Re-design of the reference's FlexAttention mask builders
(`MMPL_t2v/wan/modules/causal_model.py:534-709`).  Every rule in those
builders is a function of per-frame (step, region) ids — token granularity
only enters through the self-token diagonal, which the frame rules already
imply for the shipped plans — so we build boolean *frame-level* masks
([F, F] or [2F, 2F]) and expand to tokens only where a dense kernel needs
them.  The frame-level form is also what the frame-masked kernels K4-K6 read
(`ops/attention.py:frame_masked_attention`; 1 frame = 1560 tokens).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def blockwise_causal_frame_mask(num_frames: int, num_frame_per_block: int = 3,
                                local_attn_frames: int = -1,
                                independent_first_frame: bool = False
                                ) -> np.ndarray:
    """[F, F] bool: query frame attends to kv frames in blocks up to its own.

    causal_model.py:534-580 (+ the i2v first-frame split variant :657-706).
    """
    ends = np.zeros(num_frames, dtype=np.int64)
    start = 0
    if independent_first_frame:
        ends[0] = 1
        start = 1
    for s in range(start, num_frames, num_frame_per_block):
        e = min(s + num_frame_per_block, num_frames)
        ends[s:e] = e
    kv = np.arange(num_frames)[None, :]
    mask = kv < ends[:, None]
    if local_attn_frames != -1:
        mask &= kv >= (ends[:, None] - local_attn_frames)
    mask |= np.eye(num_frames, dtype=bool)
    return mask


def teacher_forcing_frame_mask(num_frames: int,
                               num_frame_per_block: int = 3) -> np.ndarray:
    """[2F, 2F] bool over [clean_0..clean_F | noise_0..noise_F]
    (causal_model.py:582-655): clean frames are block-causal over clean;
    noisy frames attend to their own noisy block + all *previous-block*
    clean frames.
    """
    F = num_frames
    blk = np.arange(F) // num_frame_per_block
    mask = np.zeros((2 * F, 2 * F), dtype=bool)
    # clean-clean: block-causal (attend through own block end)
    mask[:F, :F] = blk[None, :] <= blk[:, None]
    # noise-noise: same block only
    mask[F:, F:] = blk[None, :] == blk[:, None]
    # noise-clean: strictly previous blocks
    mask[F:, :F] = blk[None, :] < blk[:, None]
    return mask


def fps_forcing_frame_mask(clean_steps: Sequence[int],
                           noise_steps: Optional[Sequence[int]] = None,
                           blind_frames: Tuple[int, ...] = (19, 20),
                           blind_step: int = 2) -> np.ndarray:
    """[2F, 2F] bool: the macro-from-micro teacher-forcing mask
    (causal_model.py:620-709).

    Layout [clean_0..clean_F | noise_0..noise_F]; rules:
      * clean q -> clean kv with kv_step <= q_step
      * noise q -> noise kv with kv_step == q_step, or clean kv with
        kv_step < q_step
      * diagonal always allowed
      * queries with step == `blind_step` cannot see clean frames
        `blind_frames` (the anchor-blinding of fill group 1,
        causal_model.py:678-695)
    """
    clean_steps = np.asarray(clean_steps)
    noise_steps = np.asarray(noise_steps if noise_steps is not None
                             else clean_steps)
    F = len(clean_steps)
    steps = np.concatenate([clean_steps, noise_steps])
    region = np.concatenate([np.zeros(F, np.int64), np.ones(F, np.int64)])

    qs, ks = steps[:, None], steps[None, :]
    qr, kr = region[:, None], region[None, :]

    clean_rule = (qr == 0) & (kr == 0) & (ks <= qs)
    noise_rule = (qr == 1) & (((kr == 1) & (ks == qs)) |
                              ((kr == 0) & (ks < qs)))
    eye = np.eye(2 * F, dtype=bool)

    kv_frame = np.concatenate([np.arange(F), np.arange(F)])
    is_blind_clean = (kr == 0) & np.isin(kv_frame, blind_frames)[None, :]
    blocking = (qs == blind_step) & is_blind_clean

    return (eye | clean_rule | noise_rule) & ~blocking


def expand_frame_mask(frame_mask: np.ndarray,
                      frame_seqlen: int) -> np.ndarray:
    """[F, F] bool -> token-level [F*S, F*S] bool."""
    return np.kron(frame_mask,
                   np.ones((frame_seqlen, frame_seqlen), dtype=bool))
