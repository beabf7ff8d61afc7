"""CausalDiffusionInferencePipeline: block-causal sampling, each block by a
full UniPC loop with classifier-free guidance.

Port of `mmpl_tpu/pipelines/causal_diffusion_inference.py` (single
device), the plain next-block baseline that the planned FPS window
improves on:

  * `num_frame_per_block` frames at a time in generation order, each block
    denoised by the whole UniPC loop over a batched CFG pair ([cond;
    uncond] on the batch axis, with separate cache halves), then committed
    clean at t = 0, the only pass that writes the cache;
  * `initial_latent` frames are committed first, block by block, and
    returned as they are;
  * each block's schedule is `causal_inference.block_schedule`: it writes
    its own frames' slots and sees the last `local_attn_frames` frames;
  * `quantize` ("int8", "int8wo", "auto") turns the block projections into
    int8 codes at construction and `quantize_cache` keeps the KV cache in
    int8 with per-token scales, as in the FPS pipeline.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.geometry import GroupSchedule
from ..models.dit import (WanDiT, apply_quantize, embed_text,
                          fuse_qkv_params, precompute_context_kv)
from ..models.fps_dit import fps_forward_group, init_kv_cache
from ..schedulers.unipc import FlowUniPC
from .causal_inference import block_schedule


class CausalDiffusionInferencePipeline:
    def __init__(self, cfg, model: WanDiT, sampling_steps: int = 50,
                 timestep_shift: float = 8.0, guidance_scale: float = 5.0,
                 num_frame_per_block: int = 3,
                 local_attn_frames: int = 21,
                 quantize: Optional[str] = None,
                 quantize_cache: bool = False,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        model = fuse_qkv_params(model, num_heads=cfg.num_heads)
        self.model = apply_quantize(model, quantize, cfg)
        self.guidance_scale = float(guidance_scale)
        self.num_frame_per_block = num_frame_per_block
        self.local_attn_frames = local_attn_frames
        self.quantize_cache = bool(quantize_cache)
        self.dtype = dtype
        self.sampler = FlowUniPC(sampling_steps, shift=timestep_shift)

    def _forward(self, schedule: GroupSchedule, ctx_kv2, cache,
                 latents: torch.Tensor, t: float, write_cache: bool):
        B2 = 2 * latents.shape[0]
        lat2 = torch.cat([latents, latents], 0).to(self.dtype)
        tt = torch.full((B2, schedule.num_frames), float(t),
                        dtype=torch.float32, device=latents.device)
        return fps_forward_group(self.model, self.cfg, lat2, tt, ctx_kv2,
                                 cache, schedule, write_cache=write_cache)

    def _denoise_block(self, schedule: GroupSchedule, ctx_kv2, cache,
                       noisy: torch.Tensor) -> torch.Tensor:
        """The block's UniPC loop over the CFG pair (the cache is read
        only), then its clean commit."""
        B = noisy.shape[0]
        state = self.sampler.init_state(noisy.float())
        for coef, t in zip(self.sampler.table, self.sampler.timesteps):
            flow2 = self._forward(schedule, ctx_kv2, cache, state["sample"],
                                  float(t), write_cache=False)
            cond, uncond = flow2[:B].float(), flow2[B:].float()
            flow = uncond + self.guidance_scale * (cond - uncond)
            state = self.sampler.step(coef, state, flow)
        final = state["sample"]
        self._forward(schedule, ctx_kv2, cache, final, 0.0, write_cache=True)
        return final

    @torch.inference_mode()
    def inference(self, noise: torch.Tensor, cond_context: torch.Tensor,
                  uncond_context: torch.Tensor,
                  initial_latent: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """noise [B, F, C, H, W], contexts [B, T, text_dim],
        initial_latent [B, n_init, C, H, W] (clean context) ->
        latents [B, n_init + F, C, H, W] fp32."""
        B, F, C, H, W = noise.shape
        nb = self.num_frame_per_block
        n_init = 0 if initial_latent is None else initial_latent.shape[1]
        ctx = torch.cat([cond_context, uncond_context], 0)
        emb = embed_text(self.model, ctx.to(self.dtype))
        ctx_kv2 = precompute_context_kv(self.model, self.cfg, emb)
        cache = init_kv_cache(self.cfg, 2 * B, H * W // 4,
                              max(n_init + F, self.local_attn_frames),
                              self.dtype, noise.device,
                              quantize=self.quantize_cache)
        outputs = []
        start = 0
        for s in range(0, n_init, nb):
            g = min(nb, n_init - s)
            clean = initial_latent[:, s:s + g].float()
            self._forward(block_schedule(start, g, self.local_attn_frames),
                          ctx_kv2, cache, clean, 0.0, write_cache=True)
            outputs.append(clean)
            start += g
        for s in range(0, F, nb):
            g = min(nb, F - s)
            outputs.append(self._denoise_block(
                block_schedule(start, g, self.local_attn_frames), ctx_kv2,
                cache, noise[:, s:s + g]))
            start += g
        return torch.cat(outputs, dim=1)
