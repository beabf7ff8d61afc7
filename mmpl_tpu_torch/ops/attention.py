"""Attention: the K1 flash-forward kernel, its plain version and the dispatch.

Port of `mmpl_tpu/ops/attention.py` for the serving path.  Layout is
[B, L, N, D] throughout.  MMPL inference attention needs no mask: the
planned visibility is realised by gathering whole frames from the KV cache
before the call (`models/fps_dit.py`).

On a CUDA tensor, unmasked attention launches the hand-written Hopper
kernel `csrc/flash_fwd.cu` (the port of `_flash_fwd_kernel`) or raises; on
a CPU tensor it runs `flash_attention_plain`.  There is no fallback from
one to the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

#: launches of each hand-written kernel, counted where the launch succeeds
launch_counts = {"flash_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: bytes of fp32 scores the plain version holds at once (~1 GiB)
_PLAIN_SCORE_BYTES = 1 << 30


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention; fp32 softmax, probabilities cast to v's dtype.

    `mask` is boolean, broadcastable to [B, N, Lq, Lk]; True = attend.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    scores = torch.einsum("bqnd,bknd->bnqk", qf, k.float())
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype), v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 softmax attention, the plain version of K1.

    Computes in chunks of query rows so that the fp32 scores held at once
    stay near 1 GiB (at B=2, N=12, Lk=32760 that is 341 rows).  Returns
    (O [B, Lq, N, D] in q's dtype, lse [B, N, Lq] fp32).
    """
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf = k.float().permute(0, 2, 3, 1)                 # [B, N, D, Lk]
    vf = v.float().permute(0, 2, 1, 3)                 # [B, N, Lk, D]
    rows = max(1, _PLAIN_SCORE_BYTES // (4 * B * N * Lk))
    outs, lses = [], []
    for s in range(0, Lq, rows):
        qc = q[:, s:s + rows].float().permute(0, 2, 1, 3)   # [B, N, r, D]
        scores = torch.matmul(qc, kf) * scale               # [B, N, r, Lk]
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        del scores
        l = p.sum(dim=-1, keepdim=True)
        lsafe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append((torch.matmul(p, vf) / lsafe).permute(0, 2, 1, 3))
        lses.append((m + torch.log(lsafe))[..., 0])
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out, torch.cat(lses, dim=-1)


def _check_operand(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise ValueError(f"flash_fwd: {name} is {x.dtype}, q is {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash_fwd: {name} needs a contiguous head dim")
    vec = 16 // x.element_size()
    if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
        raise ValueError(f"flash_fwd: {name} must be 16-byte aligned with "
                         f"strides that are multiples of {vec} elements")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 (`csrc/flash_fwd.cu`) on CUDA tensors.

    q [B, Lq, N, D], k/v [B, Lk, N, D]; bf16/fp16 with D a multiple of 16,
    or fp32 with D a multiple of 8, D <= 128.  Returns (O, lse [B, N, Lq]).
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd: q, k and v must be CUDA tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_fwd: unsupported dtype {q.dtype}")
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    step = 8 if q.dtype == torch.float32 else 16
    if D % step or not 0 < D <= 128:
        raise ValueError(f"flash_fwd: head dim {D} unsupported for {q.dtype}")
    if k.shape != (B, Lk, N, D) or v.shape != k.shape or Lk == 0:
        raise ValueError(f"flash_fwd: bad shapes {q.shape} {k.shape} {v.shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, N, Lq), dtype=torch.float32, device=q.device)
    if Lq == 0:
        return o, lse
    from . import _build
    lib = _build.library("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmpl_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, Lq, Lk, N, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    launch_counts["flash_fwd"] += 1
    return o, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors.

    Returns (out [B, Lq, N, D], lse [B, N, Lq] fp32).
    """
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return flash_attention_plain(q, k, v, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    return flash_attention_lse(q, k, v, scale)[0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Main dispatch: masked attention runs dense, unmasked attention runs
    K1 (CUDA) or its plain version (CPU)."""
    if mask is not None:
        return dense_attention(q, k, v, mask=mask, scale=scale)
    return flash_attention(q, k, v, scale=scale)
