"""Causal FPS Wan DiT: the MMPL planned-KV-cache forward (inference) and the
teacher-forcing training forward.

Port of `mmpl_tpu/models/fps_dit.py` (`fps_forward_group`'s inference
branch and `fps_forward_train`).  The KV
cache is a dict of [num_layers, B, SLOTS, S, N*d] tensors (SLOTS = 15
frame slots, S = tokens per frame, heads merged in the minor dim, as in
the JAX package so both caches compare like with like).  Visibility is a
gather of whole frame slots; attention over the gathered set needs no
mask.  The cached K carries RoPE in the fused projection's split-half
channel layout.  An int8 cache (`init_kv_cache(quantize=True)`) keeps
per-token f32 scales beside the codes: the gathered visible set is
dequantised in the activation dtype, and the commit pass writes codes.
Teacher forcing needs no cache: its self-attention runs the frame-masked
kernels over the whole [clean | noisy] sequence.  The self-forcing rollout
and the ODE loss train through `fps_forward_group` itself, with per-layer
recomputation and, where a later pass must still read the cache an
earlier one read or gradients flow through the cache, functional writes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.geometry import GroupSchedule, KV_CACHE_SLOTS
from ..ops.attention import attention, frame_masked_attention, mask_tiles
from ..ops.quant import quantize_rows
from ..ops.rope import rope_table
from .dit import (WanDiT, block_forward, call_with, embed_text,
                  head_forward, linear, local_heads, patchify,
                  precompute_context_kv, qkv_project, run_block,
                  sharding_of, time_embed, unpatchify)
from .dit import remat as remat_layer


def init_kv_cache(cfg, batch_size: int, tokens_per_frame: int,
                  num_slots: int = KV_CACHE_SLOTS, dtype=torch.bfloat16,
                  device="cpu", quantize: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """Zeroed planned KV cache, layout [L, B, SLOTS, S, N*d].

    quantize=True stores K/V as int8 with per-token f32 scales
    `k_scale` / `v_scale` [L, B, SLOTS, S] (one scale across the merged
    heads; the QK-norm keeps head magnitudes comparable): half the bytes
    of the largest resident of the 50-step CFG window."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype} (bf16 or f32 only)")
    n, d = local_heads(cfg), cfg.dim // cfg.num_heads
    shape = (cfg.num_layers, batch_size, num_slots, tokens_per_frame, n * d)
    if not quantize:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}


def _gather(kv_cache, name: str, li: int, slots: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Layer li's visible slots of cache `name` [B, n_slots, S, N*d]; int8
    codes are dequantised here, in `dtype` (scales cast to it first)."""
    x = kv_cache[name][li].index_select(1, slots)
    scale = kv_cache.get(f"{name}_scale")
    if scale is None:
        return x
    return x.to(dtype) * scale[li].index_select(1, slots)[..., None].to(dtype)


def _write(kv_cache, name: str, slots: torch.Tensor,
           per_layer: List[torch.Tensor], inplace: bool) -> None:
    """Write each layer's [B, G, ...] rows into the slots of cache `name`:
    in place, or as a new tensor that replaces the dict's entry."""
    dtype = kv_cache[name].dtype
    if inplace:
        for li, rows in enumerate(per_layer):
            kv_cache[name][li].index_copy_(1, slots, rows.to(dtype))
    else:
        kv_cache[name] = kv_cache[name].index_copy(
            2, slots, torch.stack([r.to(dtype) for r in per_layer]))


def fps_forward_group(model: WanDiT, cfg, latents: torch.Tensor,
                      t: torch.Tensor, ctx_kv: List[Dict[str, torch.Tensor]],
                      kv_cache: Dict[str, torch.Tensor],
                      schedule: GroupSchedule,
                      write_cache: bool = False,
                      rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None,
                      y: Optional[torch.Tensor] = None,
                      remat: bool = False,
                      inplace: bool = True) -> torch.Tensor:
    """One forward of the group's frames through the whole trunk.

    latents [B, G, C, H, W] (frames ascending as `schedule.frames`);
    t [B, G]; ctx_kv: per-layer cross-attention K/V.  Returns the flow
    [B, G, C_out, H, W].  `rope_cs` (cos, sin) [G*S, d//2] overrides the
    table of `schedule.frames` (the rolling cache's
    `rope.dynamic_rope_table`).  `y` [B, G, C', H, W]: the i2v
    conditioning, concatenated to the latents along channels.

    Self-attention runs over the cached frames visible to the group other
    than its own, plus the group's own in-flight K/V.  A group never reads
    its own slots, so the cache is constant through the solver loop; only
    the clean commit pass (`write_cache=True`) writes, and it writes the
    group's `write_slots` of `kv_cache` IN PLACE, once, after the layer
    loop (codes and scales for an int8 cache).  Append-mode groups never
    write.  With `inplace=False` the write is functional instead: each of
    `kv_cache`'s entries is replaced by a new tensor, differentiable in
    the written K/V, and the tensors it replaces stay as they were.  That
    is what training needs where a later pass must still read the old
    cache (the recomputation of an earlier graded block) or where
    gradients flow through the cache (the ODE loss).

    remat=True recomputes each layer in the backward pass (`dit.remat`);
    the layers read the cache tensors bound at entry, so a later
    functional write does not change what the recomputation reads.
    """
    if y is not None:
        latents = torch.cat([latents, y.to(latents.dtype)], dim=2)
    B, G, C, H, W = latents.shape
    assert G == schedule.num_frames, (G, schedule)
    grid = (H // cfg.patch_size[1], W // cfg.patch_size[2])
    S = grid[0] * grid[1]
    n, d = local_heads(cfg), cfg.dim // cfg.num_heads
    sh = sharding_of(cfg)
    device = latents.device

    x = patchify(model.patch_embedding, latents, cfg.patch_size)
    e, e0 = time_embed(model, cfg, t)
    if rope_cs is not None:
        cos, sin = rope_cs
    else:
        cos_np, sin_np = rope_table(schedule.frames, grid[0], grid[1], d)
        cos = torch.as_tensor(cos_np, device=device)
        sin = torch.as_tensor(sin_np, device=device)

    own = set(schedule.frames) if not schedule.append_mode else set()
    other_slots = [s for f, s in zip(schedule.visible_frames,
                                     schedule.visible_slots) if f not in own]
    vis_other = torch.as_tensor(other_slots, dtype=torch.long, device=device)
    write = write_cache and not schedule.append_mode
    cache = dict(kv_cache)      # the tensors this pass reads

    def layer(x, blk, ckv, li):
        own_kv = []

        def self_attn_fn(xm):
            L = xm.shape[1]
            q, k, v = qkv_project(blk.self_attn, xm, n, d, cos, sin,
                                  sh.tp_group)
            if other_slots:
                ck = _gather(cache, "k", li, vis_other, k.dtype)
                cv = _gather(cache, "v", li, vis_other, v.dtype)
                kv_k = torch.cat([ck.reshape(B, -1, n, d), k], dim=1)
                kv_v = torch.cat([cv.reshape(B, -1, n, d), v], dim=1)
            else:
                kv_k, kv_v = k, v
            out = attention(q, kv_k, kv_v)
            if write:
                own_kv.extend((k.reshape(B, G, S, n * d),
                               v.reshape(B, G, S, n * d)))
            return linear(blk.self_attn.o, out.reshape(B, L, -1),
                          sh.tp_group)

        x = block_forward(blk, cfg, x, e0, self_attn_fn, ckv, G)
        return (x, *own_kv) if write else x

    own_k, own_v = [], []
    for li, blk in enumerate(model.blocks):
        step = lambda x, blk=blk, li=li: run_block(
            blk, lambda b, x: layer(x, b, ctx_kv[li], li), x,
            unshard=sh.unshard)
        out = remat_layer(step, x) if remat else step(x)
        if write:
            x, k, v = out
            own_k.append(k)
            own_v.append(v)
        else:
            x = out

    if write:
        slots = torch.as_tensor(schedule.write_slots, dtype=torch.long,
                                device=device)
        for name, own_l in (("k", own_k), ("v", own_v)):
            if f"{name}_scale" in kv_cache:
                # per-token codes: one launch of Q per layer and name
                coded = [quantize_rows(kv.reshape(-1, n * d).contiguous())
                         for kv in own_l]
                own_l = [c.reshape(kv.shape) for (c, _), kv
                         in zip(coded, own_l)]
                scales = [sc.reshape(kv.shape[:-1]) for (_, sc), kv
                          in zip(coded, own_l)]
                _write(kv_cache, f"{name}_scale", slots, scales, inplace)
            _write(kv_cache, name, slots, own_l, inplace)

    x = head_forward(model.head, cfg, x, e, G)
    return unpatchify(x, G, grid, cfg.patch_size, cfg.out_dim)


def fps_forward_train(model: WanDiT, cfg, noisy: torch.Tensor,
                      t: torch.Tensor, context: torch.Tensor, frame_mask,
                      clean_x: Optional[torch.Tensor] = None,
                      aug_t: Optional[torch.Tensor] = None,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Training forward with teacher forcing (no KV cache).

    noisy [B, F, C, H, W]; t / aug_t [B, F]; context [B, T, text_dim];
    frame_mask [F, F] or, with `clean_x`, [2F, 2F] bool.  With `clean_x`
    the token sequence is [clean | noisy], the clean half with the time
    embedding of `aug_t` (zeros if None), RoPE positions repeated per half,
    and the head sees only the noisy half.  Returns the flow
    [B, F, C_out, H, W].

    Self-attention runs `frame_masked_attention` (K4 forward, K5 / K6
    backward on CUDA; the plain versions on the CPU) with frame ids
    repeat(arange(frames), S); its tile tables (`mask_tiles`) are built
    once here for every layer.  Cross-attention runs `attention` (K1 / K2 /
    K3).  Each block is recomputed in the backward pass (`dit.remat`).
    The forward reads the parameters cast to `compute_dtype` (default: the
    masters' own dtype; the bf16 trunk over fp32 masters, grads flowing
    back through the cast): the embeddings and the head here, each block's
    inside its recomputed step.  The activations follow `noisy`'s dtype.
    """
    dtype = compute_dtype or next(model.parameters()).dtype
    outer = {n: p.to(dtype) for n, p in model.named_parameters()
             if not n.startswith("blocks.")}
    return call_with(model, outer, _forward_train, cfg, noisy, t, context,
                     frame_mask, clean_x, aug_t, dtype)


def _forward_train(model, cfg, noisy, t, context, frame_mask, clean_x,
                   aug_t, dtype):
    B, Fr, C, H, W = noisy.shape
    grid = (H // cfg.patch_size[1], W // cfg.patch_size[2])
    S = grid[0] * grid[1]
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    device = noisy.device

    x = patchify(model.patch_embedding, noisy, cfg.patch_size)
    e_noisy, e0 = time_embed(model, cfg, t)
    num_seq_frames = Fr
    if clean_x is not None:
        xc = patchify(model.patch_embedding, clean_x, cfg.patch_size)
        if aug_t is None:
            aug_t = torch.zeros_like(t)
        _, e0_clean = time_embed(model, cfg, aug_t)
        x = torch.cat([xc, x], dim=1)
        e0 = torch.cat([e0_clean, e0], dim=1)
        num_seq_frames = 2 * Fr
    fm = torch.as_tensor(frame_mask, dtype=torch.bool, device=device)
    if tuple(fm.shape) != (num_seq_frames, num_seq_frames):
        raise ValueError(f"frame mask {tuple(fm.shape)} for "
                         f"{num_seq_frames} sequence frames")

    cos_np, sin_np = rope_table(tuple(range(Fr)), grid[0], grid[1], d)
    reps = num_seq_frames // Fr     # RoPE positions repeat per half
    cos = torch.as_tensor(np.concatenate([cos_np] * reps), device=device)
    sin = torch.as_tensor(np.concatenate([sin_np] * reps), device=device)

    ids = torch.arange(num_seq_frames, dtype=torch.int32,
                       device=device).repeat_interleave(S)
    tiles = mask_tiles(ids, ids, fm)

    ctx = embed_text(model, context.to(x.dtype))
    # reads the blocks' masters; `linear` and `rms_norm` cast each weight to
    # the activations' dtype, the same rounding as `cast_params`
    ctx_kv = precompute_context_kv(model, cfg, ctx)

    def block_fn(blk, x, ckv):
        def self_attn_fn(xm):
            L = xm.shape[1]
            q, k, v = qkv_project(blk.self_attn, xm, n, d, cos, sin)
            out = frame_masked_attention(q, k, v, ids, ids, fm, tiles=tiles)
            return linear(blk.self_attn.o, out.reshape(B, L, -1))
        return block_forward(blk, cfg, x, e0, self_attn_fn, ckv,
                             num_seq_frames)

    for blk, ckv in zip(model.blocks, ctx_kv):
        # the block casts its own parameters, so that the backward's
        # recomputation, which runs after this forward has returned, reads
        # the same cast values
        step = lambda x, blk=blk, ckv=ckv: run_block(
            blk, block_fn, x, ckv, dtype=dtype)
        x = remat_layer(step, x)

    if clean_x is not None:
        x = x[:, x.shape[1] // 2:]
    x = head_forward(model.head, cfg, x, e_noisy, Fr)
    return unpatchify(x, Fr, grid, cfg.patch_size, cfg.out_dim)
