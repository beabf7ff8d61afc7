"""Bidirectional (non-causal) whole-clip sampling over the Wan DiT.

Port of `mmpl_tpu/pipelines/bidirectional_inference.py`, the teacher and
evaluation paths:

  * `BidirectionalDiffusionInferencePipeline`: the UniPC loop (50 steps by
    default) with classifier-free guidance over a batched [cond; uncond]
    pair, every token of the clip attending every token (`dit_forward`);
  * `BidirectionalInferencePipeline`: the few-step distilled sampler.
    Each step predicts the flow, converts it to x0 and, before the next
    step, re-noises x0 to the next timestep.  The re-noising draws come
    from an explicit `torch.Generator`, or are handed in (`step_noise`) so
    that a test can replay the JAX package's key chain.

`quantize` turns the block projections into int8 codes at construction
(`dit.apply_quantize`), as in the causal pipelines.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..models.dit import (WanDiT, apply_quantize, dit_forward,
                          fuse_qkv_params)
from ..schedulers.flow_match import FlowMatchScheduler
from ..schedulers.unipc import FlowUniPC


class BidirectionalDiffusionInferencePipeline:
    """UniPC + CFG over the bidirectional WanModel."""

    def __init__(self, cfg, model: WanDiT, sampling_steps: int = 50,
                 timestep_shift: float = 8.0, guidance_scale: float = 5.0,
                 quantize: Optional[str] = None, dtype=torch.bfloat16):
        self.cfg = cfg
        model = fuse_qkv_params(model, num_heads=cfg.num_heads)
        self.model = apply_quantize(model, quantize, cfg)
        self.guidance_scale = float(guidance_scale)
        self.dtype = dtype
        self.sampler = FlowUniPC(sampling_steps, shift=timestep_shift)

    @torch.inference_mode()
    def inference(self, noise: torch.Tensor, cond_context: torch.Tensor,
                  uncond_context: torch.Tensor) -> torch.Tensor:
        """noise [B, F, C, H, W] -> latents [B, F, C, H, W] fp32."""
        B = noise.shape[0]
        ctx2 = torch.cat([cond_context, uncond_context], 0).to(self.dtype)
        state = self.sampler.init_state(noise.float())
        for coef, t in zip(self.sampler.table, self.sampler.timesteps):
            lat2 = torch.cat([state["sample"], state["sample"]], 0)
            tt = torch.full((2 * B,), float(t), dtype=torch.float32,
                            device=noise.device)
            flow2 = dit_forward(self.model, self.cfg, lat2.to(self.dtype),
                                tt, ctx2)
            cond, uncond = flow2[:B], flow2[B:]
            flow = uncond.float() + self.guidance_scale * (
                cond - uncond).float()
            state = self.sampler.step(coef, state, flow)
        return state["sample"]


class BidirectionalInferencePipeline:
    """Few-step distilled whole-clip sampling."""

    def __init__(self, cfg, model: WanDiT,
                 denoising_step_list: Sequence[int] = (1000, 750, 500, 250),
                 timestep_shift: float = 8.0,
                 quantize: Optional[str] = None, dtype=torch.bfloat16):
        self.cfg = cfg
        model = fuse_qkv_params(model, num_heads=cfg.num_heads)
        self.model = apply_quantize(model, quantize, cfg)
        self.steps = tuple(int(t) for t in denoising_step_list)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=timestep_shift,
                                            sigma_min=0.0,
                                            extra_one_step=True)
        self.scheduler.set_timesteps(1000, training=True)

    @torch.inference_mode()
    def inference(self, noise: torch.Tensor, cond_context: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  step_noise: Optional[List[torch.Tensor]] = None
                  ) -> torch.Tensor:
        """noise [B, F, C, H, W] -> x0 [B, F, C, H, W] fp32.  The noise of
        re-noising step i is `step_noise[i]` (like the latents), else a
        draw from `generator`."""
        B, F = noise.shape[:2]
        device = noise.device
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        x = noise.float()
        for i, t_int in enumerate(self.steps):
            tt = torch.full((B,), float(t_int), dtype=torch.float32,
                            device=device)
            flow = dit_forward(self.model, self.cfg, x.to(self.dtype), tt,
                               cond_context)
            x0 = self.scheduler.convert_flow_pred_to_x0(
                flat(flow).float(), flat(x),
                tt.repeat_interleave(F)).reshape(x.shape)
            if i < len(self.steps) - 1:
                nz = (step_noise[i].to(device).float()
                      if step_noise is not None else
                      torch.randn(x.shape, generator=generator,
                                  device=device))
                nt = torch.full((B * F,), float(self.steps[i + 1]),
                                dtype=torch.float32, device=device)
                x = self.scheduler.add_noise(flat(x0), flat(nz),
                                             nt).reshape(x.shape)
            else:
                x = x0
        return x
