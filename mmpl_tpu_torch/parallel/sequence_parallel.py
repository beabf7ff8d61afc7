"""Sequence parallelism for the bidirectional Wan DiT (USP).

Port of `mmpl_tpu/parallel/sequence_parallel.py`.  The tokens of the
whole clip are split over a mesh's `sp` axis (and, for full USP, its
`ring` axis too):

  * Ulysses: an all-to-all turns tokens [B, L/sp, N, D] into heads
    [B, L, N/sp, D], each rank attends the full sequence on its heads, and
    a second all-to-all turns them back;
  * ring: heads stay whole, the K/V chunks rotate around the ring and each
    chunk's attention merges into the running output by its logsumexp
    (`ops/attention.ring_flash_attention`: K1 per chunk forward, K2 / K3
    per chunk backward with the global lse and delta).  With both, the
    sequence parallelism sp x ring can exceed the head count.

The group moves come from `parallel/collectives.py`: a process group per
axis (NCCL on cards, gloo on the CPU), or the in-process mesh that holds
every rank's shard on one device, stacked along the batch.  The math is
one code path over either.  RoPE is applied rank-locally with the table
sliced at each shard's token offset; the sequence length must divide by
sp x ring (the reference pads to this).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.dit import (WanDiT, block_forward, embed_text, head_forward,
                          linear, patchify, precompute_context_kv,
                          qkv_project, time_embed, unpatchify)
from ..ops.attention import (attention, dense_attention_lse, merge_lse,
                             ring_flash_attention)
from ..ops.rope import window_rope_table
from .collectives import as_mesh


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, impl: str = "flash") -> torch.Tensor:
    """Ring attention over a sequence-sharded K/V: q / k / v [B, L/ring,
    N, D] shards, `group` the ring axis's group.  Unmasked (the
    bidirectional path), so the chunk order does not matter.

    impl: "flash" runs `ring_flash_attention` (the hand-written kernels on
    a card, differentiable through the ring's own backward); "dense" is
    its plain version, torch attention per chunk merged by lse and
    differentiated by autograd (the JAX package's pure-jnp ring)."""
    if impl == "flash":
        return ring_flash_attention(q, k, v, group)
    if impl != "dense":
        raise ValueError(f"ring impl {impl!r} (flash or dense)")
    out, lse = dense_attention_lse(q, k, v)
    kr, vr = k, v
    for _ in range(group.size - 1):
        kr, vr = group.rotate(kr), group.rotate(vr)
        out, lse = merge_lse(out, lse, *dense_attention_lse(q, kr, vr))
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, ring_group=None) -> torch.Tensor:
    """All-to-all head / sequence reshuffle and attention over the full
    sequence on this rank's heads; with `ring_group`, the remaining
    sequence shards rotate over that ring (full USP, the flash ring)."""
    qg, kg, vg = (group.all_to_all(x, split_dim=2, concat_dim=1)
                  for x in (q, k, v))            # [B, L/ring, N/sp, D]
    if ring_group is None:
        out = attention(qg, kg, vg)
    else:
        out = ring_attention(qg, kg, vg, ring_group)
    return group.all_to_all(out, split_dim=1, concat_dim=2)


def usp_dit_forward(model: WanDiT, cfg, latents: torch.Tensor,
                    t: torch.Tensor, context: torch.Tensor, mesh,
                    sp_axis: str = "sp",
                    ring_axis: Optional[str] = None) -> torch.Tensor:
    """Sequence-parallel bidirectional Wan DiT forward (the teacher path).

    latents [B, F, C, H, W]; t [B] (one timestep per clip, so the AdaLN
    modulation broadcasts over tokens and shards need not align with
    frames); context [B, T, text_dim].  `mesh`: a `collectives.LocalMesh`,
    `ProcessMesh` or `DeviceMesh` with `sp_axis` (and `ring_axis`).
    Every rank computes the embeddings, then its token shard runs the
    blocks; returns the full flow [B, F, C_out, H, W] on every rank."""
    mesh = as_mesh(mesh)
    sp = mesh.size(sp_axis)
    ring = mesh.size(ring_axis) if ring_axis else 1
    B, Fr, C, H, W = latents.shape
    grid = (H // cfg.patch_size[1], W // cfg.patch_size[2])
    L = Fr * grid[0] * grid[1]
    if L % (sp * ring):
        raise ValueError(f"sequence length {L} must be a multiple of "
                         f"sp * ring = {sp * ring}")
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    if n % sp:
        raise ValueError(f"{n} heads must be a multiple of the Ulysses "
                         f"sp = {sp}")
    axes = (sp_axis, ring_axis) if ring_axis else (sp_axis,)
    sp_group = mesh.get_group(sp_axis)
    ring_group = mesh.get_group(ring_axis) if ring_axis else None

    x = patchify(model.patch_embedding, latents, cfg.patch_size)
    e, e0 = time_embed(model, cfg, t.reshape(B, 1))   # [B,1,D], [B,1,6,D]
    ctx_kv = precompute_context_kv(model, cfg,
                                   embed_text(model, context.to(x.dtype)))
    cos_np, sin_np = window_rope_table(Fr, grid[0], grid[1], d)
    cos, sin = (mesh.shard(torch.as_tensor(a, device=x.device).expand(
        B, L, d // 2), 1, axes)[:, :, None] for a in (cos_np, sin_np))

    x = mesh.shard(x, 1, axes)                        # [*, L/(sp ring), D]
    e, e0 = mesh.replicate(e), mesh.replicate(e0)
    ctx_kv = [{name: mesh.replicate(a) for name, a in kv.items()}
              for kv in ctx_kv]
    Bl = x.shape[0]

    def self_attn_fn(blk):
        def fn(xm):
            q, k, v = qkv_project(blk.self_attn, xm, n, d, cos, sin)
            out = ulysses_attention(q, k, v, sp_group, ring_group)
            return linear(blk.self_attn.o, out.reshape(Bl, xm.shape[1], -1))
        return fn

    for blk, ckv in zip(model.blocks, ctx_kv):
        x = block_forward(blk, cfg, x, e0, self_attn_fn(blk), ckv, 1)
    x = head_forward(model.head, cfg, x, e, 1)
    return unpatchify(mesh.gather(x, 1, axes), Fr, grid, cfg.patch_size,
                      cfg.out_dim)
