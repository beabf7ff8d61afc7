"""CausalFPSInferencePipeline: planned chunk-order denoising of one window.

Port of `mmpl_tpu/pipelines/fps_inference.py` (single device).  Behaviour:

  * CFG runs as a batched pair: [cond; uncond] stacked on the batch axis,
    with separate cache halves;
  * each chunk-group runs a fresh UniPC solver loop, then (outside append
    mode) a t = 0 clean-KV commit forward, the only pass that writes the
    cache;
  * fill groups re-seed their boundary frames from denoised anchors with the
    FlowMatch `add_noise` at `ddpm_timestep`, which resolves to sigma = 1.0.
    The reseed noise is a tensor drawn by `inference` from an explicit
    `torch.Generator`, or handed in by the caller;
  * `quantize` ("int8" W8A8, "int8wo" W8A16, "auto" per projection) turns
    the block projections into int8 codes at construction
    (`dit.apply_quantize`), and `quantize_cache` keeps the KV cache in int8
    with per-token scales (`fps_dit.init_kv_cache`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.geometry import ChunkPlan, GroupSchedule, KV_CACHE_SLOTS, t2v_plan
from ..models.dit import (WanDiT, apply_quantize, embed_image_clip,
                          embed_text, fuse_qkv_params, precompute_context_kv)
from ..models.fps_dit import fps_forward_group, init_kv_cache
from ..schedulers.flow_match import FlowMatchScheduler
from ..schedulers.unipc import FlowUniPC


class CausalFPSInferencePipeline:
    """Planned chunk-order denoising of one 21-frame window."""

    def __init__(self, cfg, model: WanDiT, plan: Optional[ChunkPlan] = None,
                 sampling_steps: int = 50, timestep_shift: float = 8.0,
                 guidance_scale: float = 5.0,
                 num_train_timesteps: int = 1000,
                 reseed_seed: int = 0,
                 fuse_qkv: bool = True,
                 quantize: Optional[str] = None,
                 quantize_cache: bool = False,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        if fuse_qkv:
            # one [3D, D] gemm per layer + split-half RoPE layout
            model = fuse_qkv_params(model, num_heads=cfg.num_heads)
        # int8 projections, in place, after the fusion
        self.model = apply_quantize(model, quantize, cfg)
        self.quantize_cache = bool(quantize_cache)
        self.plan = plan or t2v_plan()
        self.guidance_scale = float(guidance_scale)
        self.dtype = dtype
        self.sampler = FlowUniPC(sampling_steps, shift=timestep_shift,
                                 num_train_timesteps=num_train_timesteps)
        # the re-seed scheduler, training-mode tables at the run shift; the
        # random index in [980, 1000) is drawn once, as in the reference
        self.ddpm = FlowMatchScheduler(shift=timestep_shift, sigma_min=0.0,
                                       extra_one_step=True)
        self.ddpm.set_timesteps(num_train_timesteps, training=True)
        idx = int(np.random.default_rng(reseed_seed).integers(980, 1000))
        self.ddpm_timestep = float(self.ddpm.timesteps[idx]) + 1000.0
        #: when True, synchronise around each group and record its solver
        #: and commit seconds in `phase_times`
        self.sync_timing = False
        self.phase_times: Dict[str, float] = {}

    # ------------------------------------------------------------------

    def _forward(self, schedule: GroupSchedule, ctx_kv2, cache,
                 latents: torch.Tensor, t: float, write_cache: bool):
        B2 = 2 * latents.shape[0]
        lat2 = torch.cat([latents, latents], 0).to(self.dtype)
        tt = torch.full((B2, schedule.num_frames), t, dtype=torch.float32,
                        device=latents.device)
        return fps_forward_group(self.model, self.cfg, lat2, tt, ctx_kv2,
                                 cache, schedule, write_cache=write_cache)

    def _apply_reseed(self, schedule: GroupSchedule, latents: torch.Tensor,
                      reseed_src: List[torch.Tensor],
                      noise: torch.Tensor) -> torch.Tensor:
        """Re-noise the group's re-seeded positions: entry i of `reseed_src`
        [B, 1, C, H, W] goes to position `schedule.reseed[i][0]` after
        blending with `noise[:, i:i+1]` at `ddpm_timestep`."""
        R = len(schedule.reseed)
        assert len(reseed_src) == R and noise.shape[1] == R, (
            len(reseed_src), tuple(noise.shape), schedule.reseed)
        B = latents.shape[0]
        ts = torch.full((B,), self.ddpm_timestep, dtype=torch.float32,
                        device=latents.device)
        latents = latents.clone()
        for i, (pos, _src) in enumerate(schedule.reseed):
            latents[:, pos:pos + 1] = self.ddpm.add_noise(
                reseed_src[i].float(), noise[:, i:i + 1].float(), ts)
        return latents

    def _sync(self, device) -> float:
        if self.sync_timing and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def _denoise_group(self, schedule: GroupSchedule, ctx_kv2, cache,
                       noisy: torch.Tensor, reseed_src, reseed_noise
                       ) -> torch.Tensor:
        """Solver loop of one group, then the clean commit (not in append
        mode).  noisy [B, G, C, H, W]; the cache is read, and written only
        by the commit."""
        B = noisy.shape[0]
        latents = noisy.float()
        if schedule.reseed:
            latents = self._apply_reseed(schedule, latents, reseed_src,
                                         reseed_noise)
        state = self.sampler.init_state(latents)
        t0 = self._sync(noisy.device)
        for coef, t in zip(self.sampler.table, self.sampler.timesteps):
            flow2 = self._forward(schedule, ctx_kv2, cache, state["sample"],
                                  float(t), write_cache=False)
            cond, uncond = flow2[:B].float(), flow2[B:].float()
            flow = uncond + self.guidance_scale * (cond - uncond)
            state = self.sampler.step(coef, state, flow)
        final = state["sample"]
        t1 = self._sync(noisy.device)
        if not schedule.append_mode:
            self._forward(schedule, ctx_kv2, cache, final, 0.0,
                          write_cache=True)
        t2 = self._sync(noisy.device)
        gi = schedule.index
        self.phase_times[f"group{gi}_steps_s"] = t1 - t0
        self.phase_times[f"group{gi}_commit_s"] = t2 - t1
        return final

    def _commit_group(self, schedule: GroupSchedule, ctx_kv2, cache,
                      clean: torch.Tensor) -> None:
        """t = 0 context commit only (the initial-latent group-0 path)."""
        t0 = self._sync(clean.device)
        self._forward(schedule, ctx_kv2, cache, clean, 0.0, write_cache=True)
        self.phase_times[f"group{schedule.index}_commit_s"] = (
            self._sync(clean.device) - t0)

    # ------------------------------------------------------------------

    def prepare_context(self, cond_context: torch.Tensor,
                        uncond_context: torch.Tensor,
                        clip_fea: Optional[torch.Tensor] = None):
        """Per-layer cross-attention K/V of the stacked [cond; uncond];
        with `clip_fea` [B, 257, 1280] (an i2v DiT) also the image K/V of
        [clip_fea; clip_fea]."""
        ctx = torch.cat([cond_context, uncond_context], 0)
        emb = embed_text(self.model, ctx.to(self.dtype))
        img = None
        if clip_fea is not None:
            img = embed_image_clip(self.model, torch.cat(
                [clip_fea, clip_fea], 0).to(self.dtype))
        return precompute_context_kv(self.model, self.cfg, emb, img)

    @torch.inference_mode()
    def inference(self, noise: torch.Tensor, cond_context: torch.Tensor,
                  uncond_context: torch.Tensor,
                  initial_latent: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  on_anchor: Optional[Callable[[torch.Tensor], None]] = None,
                  reseed_noise: Optional[Dict[int, torch.Tensor]] = None,
                  clip_fea: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Denoise one window.

        noise [B, 21, C, H, W]; contexts [B, T, text_dim];
        initial_latent [B, n0, C, H, W]: clean context frames, committed
        group by group (video extension / the window bridge);
        generator: draws each fill group's reseed noise [B, R, C, H, W]
        unless `reseed_noise` ({group index: tensor}) supplies it;
        on_anchor: called with the handoff latents after the anchor group;
        clip_fea [B, 257, 1280]: CLIP image tokens for an i2v DiT's image
        cross-attention.
        Returns the denoised window [B, 21, C, H, W] fp32.
        """
        B, Fr, C, H, W = noise.shape
        assert Fr == self.plan.num_frames
        device = noise.device
        ctx_kv2 = self.prepare_context(cond_context, uncond_context,
                                       clip_fea=clip_fea)
        cache = init_kv_cache(self.cfg, 2 * B, H * W // 4, KV_CACHE_SLOTS,
                              self.dtype, device,
                              quantize=self.quantize_cache)
        n_init = 0 if initial_latent is None else initial_latent.shape[1]
        frame_pos = {f: (gi, pi)
                     for gi, g in enumerate(self.plan.groups)
                     for pi, f in enumerate(g.frames)}
        group_out: List[Optional[torch.Tensor]] = [None] * len(
            self.plan.groups)

        def frame_latent(f: int) -> torch.Tensor:
            gi, pi = frame_pos[f]
            return group_out[gi][:, pi:pi + 1]

        consumed = 0
        self.phase_times = {}
        for gi, group in enumerate(self.plan.groups):
            if n_init > 0 and consumed < n_init:
                take = group.num_frames
                clean = initial_latent[:, consumed:consumed + take].float()
                self._commit_group(group, ctx_kv2, cache, clean)
                group_out[gi] = clean
                consumed += take
                continue
            rs, rn = [], None
            if group.reseed:
                rs = [frame_latent(s) for _pos, s in group.reseed]
                if reseed_noise is not None:
                    rn = reseed_noise[gi].to(device)
                else:
                    rn = torch.randn((B, len(group.reseed), C, H, W),
                                     generator=generator, device=device)
            group_out[gi] = self._denoise_group(
                group, ctx_kv2, cache, noise[:, list(group.frames)], rs, rn)
            if group.anchor_group and on_anchor is not None:
                on_anchor(torch.cat([frame_latent(f)
                                     for f in self.plan.handoff_frames], 1))

        return torch.cat([frame_latent(f) for f in range(Fr)], dim=1)
