"""ODE trajectories from the bidirectional teacher: the producer of the
shards that the trainer's `--objective ode --data-dir` regresses on.

Port of `mmpl_tpu/data/ode_gen.py`: the teacher's UniPC sampling with
classifier-free guidance (the cond / uncond pair batched into one
`models/dit.dit_forward` of batch 2B, cond first; the guidance in fp32),
recording the solver state fed into the steps nearest the distillation
step list, plus the final latent.  Only the picked states are kept on the
device, not one a step.  The shards are `.npz` in the JAX package's
layout (`ode_latent` fp16, `prompts`, optional `prompt_embeds` fp16);
`ODERegressionNpzDataset` reads them with the LMDB dataset's item schema.

    from mmpl_tpu_torch.data.ode_gen import record_trajectories, \\
        write_ode_shard
    traj = record_trajectories(cfg, model, noise, cond, uncond)
    write_ode_shard("shards/ode_00000.npz", traj, prompts, cond)
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from .datasets import _NpzShards


def record_trajectories(cfg, model, noise, cond_ctx, uncond_ctx,
                        denoising_step_list: Sequence[int] = (1000, 750,
                                                              500, 250),
                        sampling_steps: int = 50,
                        guidance_scale: float = 5.0,
                        timestep_shift: float = 8.0,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """Teacher UniPC rollout -> [B, len(step_list)+1, F, C, H, W] fp32, on
    the device of `noise`.

    Entry j is the solver state fed into the step whose timestep is
    nearest `denoising_step_list[j]` (entry 0 is the noise itself); the
    last entry is the fully denoised latent.  `model` is a `WanDiT`; its
    q/k/v are fused in place once, as the pipelines do (outside inference
    mode, so that the model stays usable for training); its weights are
    read cast to `dtype` where they are of another type."""
    from ..models.dit import fuse_qkv_params
    if not model.blocks[0].self_attn.fused:
        fuse_qkv_params(model, num_heads=cfg.num_heads)
    with torch.inference_mode():
        return _rollout(cfg, model, noise, cond_ctx, uncond_ctx,
                        denoising_step_list, sampling_steps, guidance_scale,
                        timestep_shift, dtype)


def _rollout(cfg, model, noise, cond_ctx, uncond_ctx, denoising_step_list,
             sampling_steps, guidance_scale, timestep_shift, dtype):
    from ..models.dit import dit_forward
    from ..schedulers.unipc import FlowUniPC
    compute = None if model.head.head.weight.dtype == dtype else dtype
    sampler = FlowUniPC(sampling_steps, shift=timestep_shift)
    ts = np.asarray(sampler.timesteps)
    picks = [int(np.argmin(np.abs(ts - s))) for s in denoising_step_list]
    g = float(guidance_scale)
    B = noise.shape[0]
    device = noise.device
    ctx2 = torch.cat([torch.as_tensor(cond_ctx), torch.as_tensor(
        uncond_ctx)], 0).to(device=device, dtype=dtype)
    state = sampler.init_state(noise.float())
    kept = {}
    for i, (coef, t) in enumerate(zip(sampler.table, sampler.timesteps)):
        if i in picks:
            kept[i] = state["sample"]
        lat2 = torch.cat([state["sample"], state["sample"]], 0).to(dtype)
        t2 = torch.full((2 * B,), float(t), dtype=torch.float32,
                        device=device)
        flow2 = dit_forward(model, cfg, lat2, t2, ctx2,
                            compute_dtype=compute)
        c, u = flow2[:B], flow2[B:]
        flow = u.float() + g * (c - u).float()
        state = sampler.step(coef, state, flow)
    return torch.stack([kept[i] for i in picks] + [state["sample"]], dim=1)


def write_ode_shard(path: str, trajectories, prompts: Sequence[str],
                    prompt_embeds=None) -> str:
    """One `.npz` shard: `ode_latent` [N, S+1, F, C, H, W] fp16 and
    `prompts` (and `prompt_embeds` [N, L, D] fp16, so that the trainer
    needs no text encoder)."""
    traj = _numpy(trajectories)
    assert traj.shape[0] == len(prompts), (traj.shape, len(prompts))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    extra = {}
    if prompt_embeds is not None:
        emb = _numpy(prompt_embeds)
        assert emb.shape[0] == traj.shape[0]
        extra["prompt_embeds"] = emb.astype(np.float16)
    np.savez(path, ode_latent=traj.astype(np.float16),
             prompts=np.asarray(list(prompts), dtype=object), **extra)
    return path


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class ODERegressionNpzDataset(_NpzShards):
    """Items {"ode_latent" fp32 [S+1, F, C, H, W], "prompts" str, and
    "prompt_embeds" fp32 [L, D] where the shard has them}."""

    count_key = "ode_latent"

    def __getitem__(self, idx: int):
        path, i = self._index[idx]
        z = self._load(path)
        item = {"ode_latent": z["ode_latent"][i].astype(np.float32),
                "prompts": str(z["prompts"][i])}
        if "prompt_embeds" in z:
            item["prompt_embeds"] = z["prompt_embeds"][i].astype(np.float32)
        return item
