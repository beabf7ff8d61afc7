"""The clip resample of the data path: max-scale cover, centre crop,
[-1, 1] normalisation and HWC -> CHW for a whole clip at once.

Computes what the JAX package's C helper does
(`mmpl_tpu/data/_fastproc.c:scale_crop_normalize_clip`): the same cover
scale and crop offsets, and the same tap tables (`build_taps`: box / area
taps when an axis shrinks, 2-tap bilinear when it grows), built here on
the host from the C code's float64 formulas with its float32 weights and
float32 normalising sums.  The taps go to the frames' device as two dense
fp32 matrices, rows `[th, rows]` and columns `[tw, W]`, and the resample is
two products there with TF32 off: no C file and no compiler, and no PIL.
The products sum the taps in another order than the C loops, so the two
agree within float32 rounding (about 1e-7 of the [-1, 1] output).

    frames uint8 [T, H, W, 3] (a tensor, or numpy for the CPU)
      -> float32 [T, 3, th, tw] in [-1, 1], on the frames' device
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch


def available() -> bool:
    """Always: the resample needs nothing beyond torch."""
    return True


def cover(H: int, W: int, th: int, tw: int) -> Tuple[int, int, int, int]:
    """(resized height, resized width, y offset, x offset) of the max-scale
    cover of (H, W) over (th, tw) and its centre crop."""
    scale = max(tw / W, th / H)
    # C's lround rounds halves away from zero (Python's round would not)
    rh = max(int(math.floor(H * scale + 0.5)), th)
    rw = max(int(math.floor(W * scale + 0.5)), tw)
    return rh, rw, (rh - th) // 2, (rw - tw) // 2


def tap_matrix(n_in: int, resized: int, out0: int, n_out: int
               ) -> np.ndarray:
    """[n_out, n_in] float32: row o holds the taps of output o + out0 of an
    axis of n_in samples resized to `resized` (`_fastproc.c:build_taps`)."""
    inv = n_in / resized
    max_taps = max(int(math.ceil(inv)) + 2, 2)
    m = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        oo = out0 + o
        if inv > 1.0:
            s0, s1 = oo * inv, (oo + 1) * inv
            i0, i1 = max(int(math.floor(s0)), 0), min(int(math.ceil(s1)),
                                                      n_in)
            i1 = min(i1, i0 + max_taps)
            w = np.array([max(min(i + 1.0, s1) - max(float(i), s0), 0.0)
                          for i in range(i0, i1)]).astype(np.float32)
            wsum = np.float32(0.0)
            for x in w:
                wsum = np.float32(wsum + x)
            m[o, i0:i1] = w / wsum if wsum > 0 else w
        else:
            s = (oo + 0.5) * inv - 0.5
            i0 = int(math.floor(s))
            f = s - i0
            if i0 < 0:
                i0, f = 0, 0.0
            if i0 + 1 < n_in:
                m[o, i0] = np.float32(1.0 - f)
                m[o, i0 + 1] = np.float32(f)
            else:
                m[o, i0] = 1.0
    return m


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def scale_crop_normalize_clip(frames, height: int, width: int
                              ) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> float32 [T, 3, height, width] in [-1, 1], on
    the device of `frames` (a numpy array is read on the CPU)."""
    x = torch.as_tensor(frames)
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"frames must be uint8 [T, H, W, 3], got "
                         f"{x.dtype} {tuple(x.shape)}")
    T, H, W, _ = x.shape
    rh, rw, y_off, x_off = cover(H, W, height, width)
    ty = tap_matrix(H, rh, y_off, height)
    tx = tap_matrix(W, rw, x_off, width)
    # only the source rows the vertical taps read
    used = np.flatnonzero(ty.any(axis=0))
    row0, row1 = int(used[0]), int(used[-1]) + 1
    dev = x.device
    ty = torch.from_numpy(np.ascontiguousarray(ty[:, row0:row1])).to(dev)
    tx = torch.from_numpy(tx).to(dev)
    with _no_tf32():
        planes = x[:, row0:row1].permute(0, 3, 1, 2).float()  # [T,3,r,W]
        out = torch.matmul(ty, torch.matmul(planes, tx.t()))   # [T,3,th,tw]
    return out.mul_(1.0 / 127.5).sub_(1.0)
