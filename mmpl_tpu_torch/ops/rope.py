"""3D rotary position embeddings for the Wan DiT.

Port of `mmpl_tpu/ops/rope.py`.  The per-head channel dim d splits into a
temporal band of d - 4*(d//6) channels and two spatial bands of 2*(d//6)
channels, rotated by frame / row / column position.  cos/sin tables are
built on the host in fp64 and stored fp32; the rotation runs in fp32.

Interleaved pair convention: channel pair (2i, 2i+1) is (re, im).  The
split-half layout ([re_0..re_{d/2-1} | im_0..im_{d/2-1}]) is what the fused
QKV projection produces after `split_rope_permutation`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def band_dims(head_dim: int) -> Tuple[int, int, int]:
    """(temporal, row, col) channel counts; each even, summing to head_dim."""
    s = 2 * (head_dim // 6)
    t = head_dim - 4 * (head_dim // 6)
    return t, s, s


def _inv_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)


@lru_cache(maxsize=64)
def rope_table(frame_positions: Tuple[int, ...], grid_h: int, grid_w: int,
               head_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables [L, head_dim//2] (fp32) for tokens of the given frames,
    in (frame, row, col) row-major order at absolute frame positions."""
    dt, dh, dw = band_dims(head_dim)
    f = np.asarray(frame_positions, dtype=np.float64)
    h = np.arange(grid_h, dtype=np.float64)
    w = np.arange(grid_w, dtype=np.float64)
    ang_t = np.einsum("f,c->fc", f, _inv_freqs(dt))
    ang_h = np.einsum("h,c->hc", h, _inv_freqs(dh))
    ang_w = np.einsum("w,c->wc", w, _inv_freqs(dw))
    F, H, W = len(f), grid_h, grid_w
    angles = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], (F, H, W, dt // 2)),
        np.broadcast_to(ang_h[None, :, None, :], (F, H, W, dh // 2)),
        np.broadcast_to(ang_w[None, None, :, :], (F, H, W, dw // 2)),
    ], axis=-1).reshape(F * H * W, head_dim // 2)
    return (np.cos(angles).astype(np.float32),
            np.sin(angles).astype(np.float32))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Rotate x [B, L, N, D] (interleaved pairs) by cos/sin [L, D//2]."""
    out_dtype = out_dtype or x.dtype
    B, L, N, D = x.shape
    xf = x.float().reshape(B, L, N, D // 2, 2)
    re, im = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([re * c - im * s, re * s + im * c], dim=-1)
    return out.reshape(B, L, N, D).to(out_dtype)


def apply_rope_split(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """Rotate x [B, L, N, D] whose per-head channels are split-half."""
    out_dtype = out_dtype or x.dtype
    half = x.shape[-1] // 2
    re = x[..., :half].float()
    im = x[..., half:].float()
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([re * c - im * s, re * s + im * c], dim=-1).to(out_dtype)


def window_rope_table(num_frames: int, grid_h: int, grid_w: int,
                      head_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Table of a contiguous [0, num_frames) window (bidirectional DiT)."""
    return rope_table(tuple(range(num_frames)), grid_h, grid_w, head_dim)


def dynamic_rope_table(start_frame, num_frames: int, grid_h: int,
                       grid_w: int, head_dim: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [F*H*W, head_dim//2] fp32 tensors for frames
    [start, start+F), the rolling cache's table: `start_frame` is an int or
    a 0-d tensor (then its device is used).  As in the JAX package the
    temporal band's angles and every cos/sin are computed in fp32 on the
    device; the spatial angles are host constants, stored fp32."""
    dt, dh, dw = band_dims(head_dim)
    start = torch.as_tensor(start_frame, device=device)
    device = start.device
    ft = torch.as_tensor(_inv_freqs(dt).astype(np.float32), device=device)
    f = start.float() + torch.arange(num_frames, dtype=torch.float32,
                                     device=device)
    ang_t = f[:, None] * ft[None, :]                             # [F, dt/2]
    ang_h = np.einsum("h,c->hc", np.arange(grid_h, dtype=np.float64),
                      _inv_freqs(dh))
    ang_w = np.einsum("w,c->wc", np.arange(grid_w, dtype=np.float64),
                      _inv_freqs(dw))
    H, W = grid_h, grid_w
    ang_s = np.concatenate([
        np.broadcast_to(ang_h[:, None, :], (H, W, dh // 2)),
        np.broadcast_to(ang_w[None, :, :], (H, W, dw // 2)),
    ], axis=-1).reshape(H * W, (dh + dw) // 2).astype(np.float32)
    ang_s = torch.as_tensor(ang_s, device=device)                # [S, ds/2]
    F, S = num_frames, H * W
    ang = torch.cat([ang_t[:, None, :].expand(F, S, dt // 2),
                     ang_s[None].expand(F, S, (dh + dw) // 2)],
                    dim=-1).reshape(F * S, head_dim // 2)
    return torch.cos(ang), torch.sin(ang)


def split_rope_permutation(num_heads: int, head_dim: int) -> np.ndarray:
    """Channel permutation from interleaved pairs to split-half layout, per
    head: new[i] = old[2i], new[D/2 + i] = old[2i + 1]."""
    per_head = np.concatenate([np.arange(0, head_dim, 2),
                               np.arange(1, head_dim, 2)])
    return np.concatenate([h * head_dim + per_head
                           for h in range(num_heads)])
