"""Causal FPS Wan DiT: the MMPL planned-KV-cache forward (inference).

Port of the inference branch of `mmpl_tpu/models/fps_dit.py`.  The KV
cache is a dict of [num_layers, B, SLOTS, S, N*d] tensors (SLOTS = 15
frame slots, S = tokens per frame, heads merged in the minor dim, as in
the JAX package so both caches compare like with like).  Visibility is a
gather of whole frame slots; attention over the gathered set needs no
mask.  The cached K carries RoPE in the fused projection's split-half
channel layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.geometry import GroupSchedule, KV_CACHE_SLOTS
from ..ops.attention import attention
from ..ops.rope import rope_table
from .dit import (WanDiT, block_forward, head_forward, linear, patchify,
                  qkv_project, time_embed, unpatchify)


def init_kv_cache(cfg, batch_size: int, tokens_per_frame: int,
                  num_slots: int = KV_CACHE_SLOTS, dtype=torch.bfloat16,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed planned KV cache, layout [L, B, SLOTS, S, N*d]."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype} (bf16 or f32 only)")
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    shape = (cfg.num_layers, batch_size, num_slots, tokens_per_frame, n * d)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fps_forward_group(model: WanDiT, cfg, latents: torch.Tensor,
                      t: torch.Tensor, ctx_kv: List[Dict[str, torch.Tensor]],
                      kv_cache: Dict[str, torch.Tensor],
                      schedule: GroupSchedule,
                      write_cache: bool = False) -> torch.Tensor:
    """One forward of the group's frames through the whole trunk.

    latents [B, G, C, H, W] (frames ascending as `schedule.frames`);
    t [B, G]; ctx_kv: per-layer cross-attention K/V.  Returns the flow
    [B, G, C_out, H, W].

    Self-attention runs over the cached frames visible to the group other
    than its own, plus the group's own in-flight K/V.  A group never reads
    its own slots, so the cache is constant through the solver loop; only
    the clean commit pass (`write_cache=True`) writes, and it writes the
    group's `write_slots` of `kv_cache` IN PLACE, once, after the layer
    loop.  Append-mode groups never write.
    """
    B, G, C, H, W = latents.shape
    assert G == schedule.num_frames, (G, schedule)
    grid = (H // cfg.patch_size[1], W // cfg.patch_size[2])
    S = grid[0] * grid[1]
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    device = latents.device

    x = patchify(model.patch_embedding, latents, cfg.patch_size)
    e, e0 = time_embed(model, cfg, t)
    cos_np, sin_np = rope_table(schedule.frames, grid[0], grid[1], d)
    cos = torch.as_tensor(cos_np, device=device)
    sin = torch.as_tensor(sin_np, device=device)

    own = set(schedule.frames) if not schedule.append_mode else set()
    other_slots = [s for f, s in zip(schedule.visible_frames,
                                     schedule.visible_slots) if f not in own]
    vis_other = torch.as_tensor(other_slots, dtype=torch.long, device=device)
    write = write_cache and not schedule.append_mode
    own_kv = []

    for li, blk in enumerate(model.blocks):
        def self_attn_fn(xm, sa=blk.self_attn, li=li):
            L = xm.shape[1]
            q, k, v = qkv_project(sa, xm, n, d, cos, sin)
            if other_slots:
                ck = kv_cache["k"][li].index_select(1, vis_other)
                cv = kv_cache["v"][li].index_select(1, vis_other)
                kv_k = torch.cat([ck.reshape(B, -1, n, d), k], dim=1)
                kv_v = torch.cat([cv.reshape(B, -1, n, d), v], dim=1)
            else:
                kv_k, kv_v = k, v
            out = attention(q, kv_k, kv_v)
            if write:
                own_kv.append((k.reshape(B, G, S, n * d),
                               v.reshape(B, G, S, n * d)))
            return linear(sa.o, out.reshape(B, L, -1))

        x = block_forward(blk, cfg, x, e0, self_attn_fn, ctx_kv[li], G)

    if write:
        slots = torch.as_tensor(schedule.write_slots, dtype=torch.long,
                                device=device)
        for li, (k, v) in enumerate(own_kv):
            kv_cache["k"][li].index_copy_(1, slots, k.to(kv_cache["k"].dtype))
            kv_cache["v"][li].index_copy_(1, slots, v.to(kv_cache["v"].dtype))

    x = head_forward(model.head, cfg, x, e, G)
    return unpatchify(x, G, grid, cfg.patch_size, cfg.out_dim)
