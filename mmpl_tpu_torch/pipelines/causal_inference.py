"""CausalInferencePipeline: few-step block-causal sampling (the distilled
DMD / SiD / CausVid checkpoints).

Port of `mmpl_tpu/pipelines/causal_inference.py`, on one device or, with
`mesh`, sharded as the planned-window pipeline is.  Blocks
of `num_frame_per_block` frames are denoised in generation order through a
short `denoising_step_list` (e.g. [1000, 750, 500, 250]): each step predicts
the flow, converts it to x0 and, before the next step, re-noises x0 to the
next timestep.  No CFG.  Then one commit forward at `context_noise` writes
the block's K/V into the cache, the only pass that writes it.

  * The cache holds one slot per frame, and each block's schedule
    (`block_schedule`) writes its own frames' slots and attends to the
    frames of the last `local_attn_frames` that precede it.
  * With `max_attention_frames` the cache is a fixed ring of that many
    slots (the rolling steady state): once a block would pass the ring's
    end, the oldest block that is not a sink is evicted and the new block
    takes its slots.  The JAX package rotates every cache leaf into recency
    order; here the rotation is a permutation of slot indices kept beside
    the cache (`slot_order`: recency position -> slot), so eviction copies
    nothing.  The block attends to the same keys in the same order, and
    `in_recency_order` gives the JAX package's layout of the cache.  RoPE
    comes from the block's absolute start frame (`rope.dynamic_rope_table`).
  * The re-noising noise [steps - 1, B, G, C, H, W] per block is drawn from
    a `torch.Generator`, or handed in (`step_noise`) so that a test can
    replay the JAX package's key chain.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.geometry import GroupSchedule
from ..models.dit import (WanDiT, apply_quantize, embed_text,
                          fuse_qkv_params, precompute_context_kv)
from ..models.fps_dit import fps_forward_group, init_kv_cache
from ..ops.rope import dynamic_rope_table
from ..parallel.mesh import InferenceSharding
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils.profiling import PhaseTimer, sync


def block_schedule(start_frame: int, num_frames: int,
                   local_attn_frames: int = 21) -> GroupSchedule:
    """Causal-attention schedule of one block: it writes its frames' slots
    and sees the frames [max(0, end - local_attn_frames), end)."""
    end = start_frame + num_frames
    attn_start = max(0, end - local_attn_frames)
    frames = tuple(range(start_frame, end))
    return GroupSchedule(
        index=start_frame, frames=frames, append_mode=False,
        write_slots=frames,
        visible_frames=tuple(range(attn_start, end)),
        visible_slots=tuple(range(attn_start, end)),
        anchor_group=False)


def rolling_schedule(cap: int, G: int,
                     slot_order: Sequence[int]) -> GroupSchedule:
    """The steady-state block's schedule in a ring of `cap` slots: it
    writes the slots of the last G recency positions and attends to every
    other slot, in recency order, then to its own K/V.  The frame ids are
    placeholders (RoPE comes from the start frame)."""
    return GroupSchedule(
        index=-1, frames=tuple(range(10 ** 6, 10 ** 6 + G)),
        append_mode=False,
        write_slots=tuple(slot_order[cap - G:]),
        visible_frames=tuple(range(cap - G)),
        visible_slots=tuple(slot_order[:cap - G]),
        anchor_group=False)


def in_recency_order(cache: Dict[str, torch.Tensor],
                     slot_order: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The ring cache's leaves with their slots in recency order (the JAX
    package's layout of the rolling cache)."""
    idx = torch.as_tensor(list(slot_order), dtype=torch.long)
    return {k: v.index_select(2, idx.to(v.device)) for k, v in cache.items()}


class CausalInferencePipeline:
    """Block-causal few-step sampling with an optional rolling KV cache."""

    def __init__(self, cfg, model: WanDiT,
                 denoising_step_list: Sequence[int] = (1000, 750, 500, 250),
                 num_frame_per_block: int = 3,
                 context_noise: int = 0,
                 timestep_shift: float = 8.0,
                 independent_first_frame: bool = False,
                 local_attn_frames: int = 21,
                 max_attention_frames: Optional[int] = None,
                 sink_frames: int = 0,
                 warp_denoising_step: bool = False,
                 fuse_qkv: bool = True,
                 quantize: Optional[str] = None,
                 quantize_cache: bool = False,
                 mesh=None,
                 dtype=torch.bfloat16):
        """max_attention_frames: the rolling cache, a ring of that many
        slots with the first `sink_frames` frames pinned; memory stays
        constant however long the video.  When None the cache grows with
        the video and attention is truncated to the last
        `local_attn_frames` frames.  mesh: the model sharded over its tp
        and fsdp dims and the batch rows over dp, as the planned-window
        pipeline's (`parallel/mesh.InferenceSharding`)."""
        if fuse_qkv or mesh is not None:
            model = fuse_qkv_params(model, num_heads=cfg.num_heads)
        self._shard = InferenceSharding(cfg, model, mesh, quantize,
                                        quantize_cache)
        self.cfg = cfg = self._shard.cfg
        self.model = apply_quantize(self._shard.model, quantize, cfg)
        self.quantize_cache = bool(quantize_cache)
        self.num_frame_per_block = num_frame_per_block
        self.context_noise = context_noise
        self.independent_first_frame = independent_first_frame
        self.local_attn_frames = (max_attention_frames
                                  if max_attention_frames is not None
                                  else local_attn_frames)
        self.max_attention_frames = max_attention_frames
        self.sink_frames = sink_frames
        if max_attention_frames is not None and \
                not 0 <= sink_frames < max_attention_frames:
            raise ValueError(f"sink_frames={sink_frames} must lie in "
                             f"[0, max_attention_frames="
                             f"{max_attention_frames})")
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=timestep_shift,
                                            sigma_min=0.0,
                                            extra_one_step=True)
        self.scheduler.set_timesteps(1000, training=True)
        steps = [int(t) for t in denoising_step_list]
        if warp_denoising_step:
            # each step through the shifted table: step -> timesteps[1000-step]
            ts = np.concatenate([self.scheduler.timesteps, [0.0]])
            steps = [float(ts[1000 - s]) for s in steps]
        self.denoising_step_list = tuple(steps)
        #: the PhaseTimer of the last `inference(profile=True)`
        self.last_profile: Optional[PhaseTimer] = None
        #: recency position -> slot of the last run's ring cache
        self.slot_order: Optional[List[int]] = None

    # ------------------------------------------------------------------

    def prepare_context(self, cond_context: torch.Tensor):
        """Per-layer cross-attention K/V of the text states."""
        emb = embed_text(self.model,
                         self._shard.rows(cond_context).to(self.dtype))
        return precompute_context_kv(self.model, self.cfg, emb)

    def _forward(self, schedule: GroupSchedule, ctx_kv, cache,
                 x: torch.Tensor, t: float, write_cache: bool,
                 rope_cs=None) -> torch.Tensor:
        x = self._shard.rows(x)
        B, G = x.shape[:2]
        tt = torch.full((B, G), float(t), dtype=torch.float32,
                        device=x.device)
        flow = fps_forward_group(self.model, self.cfg, x.to(self.dtype), tt,
                                 ctx_kv, cache, schedule,
                                 write_cache=write_cache, rope_cs=rope_cs)
        return flow if write_cache else self._shard.gather(flow)

    def _denoise_block(self, schedule: GroupSchedule, ctx_kv, cache,
                       noisy: torch.Tensor, step_noise: torch.Tensor,
                       rope_cs=None) -> torch.Tensor:
        """The few steps of one block, then its commit at context_noise.
        noisy [B, G, C, H, W]; step_noise [steps - 1, B, G, C, H, W]."""
        x = noisy.float()
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        steps = self.denoising_step_list
        n = x.shape[0] * x.shape[1]
        for i, t in enumerate(steps):
            # the steps' cache writes would be dead: a block never reads
            # its own slots, so only the commit below writes
            flow = self._forward(schedule, ctx_kv, cache, x, t, False,
                                 rope_cs)
            tt = torch.full((n,), float(t), dtype=torch.float32,
                            device=x.device)
            x0 = self.scheduler.convert_flow_pred_to_x0(
                flat(flow).float(), flat(x), tt).reshape(x.shape)
            if i < len(steps) - 1:
                nt = torch.full((n,), float(steps[i + 1]),
                                dtype=torch.float32, device=x.device)
                x = self.scheduler.add_noise(
                    flat(x0), flat(step_noise[i].float()), nt
                ).reshape(x.shape)
            else:
                x = x0
        self._forward(schedule, ctx_kv, cache, x, self.context_noise, True,
                      rope_cs)
        return x

    def _rolling_schedule(self, G: int,
                          slot_order: Sequence[int]) -> GroupSchedule:
        return rolling_schedule(self.max_attention_frames, G, slot_order)

    def _denoise_block_rolling(self, ctx_kv, cache, slot_order: List[int],
                               noisy: torch.Tensor, start_frame: int,
                               step_noise: torch.Tensor):
        """A steady-state block: evict the oldest block that is not a sink
        (its slots move to the newest recency positions and take this
        block's commit), then denoise and commit as a static block.
        Returns (x, the new slot order)."""
        B, G, _, H, W = noisy.shape
        s0 = self.sink_frames
        order = (slot_order[:s0] + slot_order[s0 + G:]
                 + slot_order[s0:s0 + G])
        d = self.cfg.dim // self.cfg.num_heads
        rope_cs = dynamic_rope_table(start_frame, G, H // 2, W // 2, d,
                                     device=noisy.device)
        x = self._denoise_block(self._rolling_schedule(G, order), ctx_kv,
                                cache, noisy, step_noise, rope_cs)
        return x, order

    def _commit_block(self, schedule: GroupSchedule, ctx_kv, cache,
                      clean: torch.Tensor) -> None:
        self._forward(schedule, ctx_kv, cache, clean, 0.0, True)

    def _block_sizes(self, frames: int, first_alone: bool) -> List[int]:
        sizes = [1] if first_alone else []
        nb = self.num_frame_per_block
        return sizes + [nb] * ((frames - len(sizes)) // nb)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def inference(self, noise: torch.Tensor, cond_context: torch.Tensor,
                  initial_latent: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  step_noise: Optional[List[torch.Tensor]] = None,
                  profile: bool = False,
                  on_block: Optional[Callable[[int, torch.Tensor], None]]
                  = None) -> torch.Tensor:
        """noise [B, F, C, H, W] -> latents [B, n_init + F, C, H, W] fp32
        (frames past the last whole block are dropped, as in the JAX
        package).

        initial_latent [B, n_init, C, H, W]: clean context frames,
        committed block by block at t = 0 and returned as they are;
        generator: draws each denoised block's re-noising noise unless
        `step_noise` (one [steps - 1, B, G, C, H, W] tensor per denoised
        block, in order) supplies it;
        on_block(start_frame, latents_block): called after each committed
        context block and each denoised block, in generation order (the
        preview hook, `utils.preview`);
        profile: the reference's phase report (init, diffusion with each
        block's time), printed and kept in `last_profile`, to which a
        caller may add its decode phase.  It synchronises the card around
        each block.
        """
        timer = PhaseTimer() if profile else None
        self.last_profile = timer
        B, F, C, H, W = noise.shape
        device = noise.device
        n_init = 0 if initial_latent is None else initial_latent.shape[1]
        cap = self.max_attention_frames

        t0 = time.perf_counter()
        ctx_kv = self.prepare_context(cond_context)
        num_slots = cap if cap is not None else max(n_init + F,
                                                    self.local_attn_frames)
        cache = init_kv_cache(self.cfg, self._shard.num_rows(B), H * W // 4,
                              num_slots, self.dtype, device,
                              quantize=self.quantize_cache)
        order = list(range(num_slots))
        if timer:
            sync(device)
            timer.phases["Initialization/caching"] = time.perf_counter() - t0
        outputs = []
        t_diff0 = time.perf_counter()

        start = 0
        if initial_latent is not None:
            consumed = 0
            for g in self._block_sizes(n_init, self.independent_first_frame):
                clean = initial_latent[:, consumed:consumed + g].float()
                self._commit_block(
                    block_schedule(start, g, self.local_attn_frames),
                    ctx_kv, cache, clean)
                outputs.append(clean)
                if on_block is not None:
                    on_block(start, clean)
                consumed += g
                start += g

        consumed = 0
        sizes = self._block_sizes(
            F, self.independent_first_frame and initial_latent is None)
        steps = len(self.denoising_step_list)
        for bi, g in enumerate(sizes):
            t_blk0 = time.perf_counter()
            noisy = noise[:, consumed:consumed + g]
            if step_noise is not None:
                sn = step_noise[bi].to(device)
            else:
                sn = torch.randn((steps - 1,) + tuple(noisy.shape),
                                 generator=generator, device=device)
            if cap is not None and start + g > cap:
                if start < cap or (start - cap) % g:
                    raise ValueError(
                        f"rolling KV: block [{start},{start + g}) straddles "
                        f"the {cap}-frame cache boundary; pick "
                        f"max_attention_frames with cap % block == "
                        f"n_warmup_frames % block (here block={g})")
                x, order = self._denoise_block_rolling(ctx_kv, cache, order,
                                                       noisy, start, sn)
            else:
                x = self._denoise_block(
                    block_schedule(start, g, self.local_attn_frames),
                    ctx_kv, cache, noisy, sn)
            if timer:
                sync(device)
                timer.record_block(time.perf_counter() - t_blk0)
            outputs.append(x)
            if on_block is not None:
                on_block(start, x)
            consumed += g
            start += g

        self.slot_order = order
        out = torch.cat(outputs, dim=1)
        if timer:
            sync(device)
            timer.phases["Diffusion generation"] = (time.perf_counter()
                                                   - t_diff0)
            timer.report()
        return out
