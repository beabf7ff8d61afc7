"""Flow-matching teacher-forcing training on one device.

Port of the teacher-forcing part of `mmpl_tpu/training/diffusion.py`
(`make_teacher_forcing_loss_fn`, `DiffusionTrainer`) without the mesh:
  * blockwise random timesteps (equal within each `num_frame_per_block`
    group), flow target v = noise - x0 and the per-timestep loss weight;
  * the [clean | noisy] sequence under the frame mask (typically
    `masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS)`), the clean context
    optionally noise-augmented;
  * one CFG-dropout coin per step;
  * a bf16 trunk over fp32 master weights, AdamW on the masters.

The random draws come in as tensors (`draw_teacher_forcing` makes them
from an explicit `torch.Generator`), so a test can feed the draws of the
JAX key chain instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.fps_dit import fps_forward_train
from ..schedulers.flow_match import FlowMatchScheduler


def draw_teacher_forcing(generator: torch.Generator, latents_shape,
                         num_frame_per_block: int = 3,
                         num_timesteps: int = 1000,
                         noise_aug_max_timestep: int = 0,
                         device=None) -> Dict[str, Optional[torch.Tensor]]:
    """One step's draws: `idx` [B, F/nb] timestep ids, `noise` like the
    latents, `idx_aug` [B, F/nb] clean-context noise ids (None without
    augmentation) and `coin` (a scalar in [0, 1) for CFG dropout)."""
    B, F = latents_shape[:2]
    nb = F // num_frame_per_block
    kw = dict(generator=generator, device=device)
    return {
        "idx": torch.randint(0, num_timesteps, (B, nb), **kw),
        "noise": torch.randn(tuple(latents_shape), **kw),
        "idx_aug": (torch.randint(0, noise_aug_max_timestep, (B, nb), **kw)
                    if noise_aug_max_timestep > 0 else None),
        "coin": torch.rand((), **kw),
    }


def make_teacher_forcing_loss_fn(cfg, scheduler: FlowMatchScheduler,
                                 frame_mask, num_frame_per_block: int = 3,
                                 noise_aug_max_timestep: int = 0,
                                 cfg_dropout: float = 0.1,
                                 compute_dtype=torch.bfloat16) -> Callable:
    """CausalDiffusion generator loss; loss_fn(model, batch, draws).

    batch: {"latents" [B, F, C, H, W], "context", "uncond_context"};
    draws: from `draw_teacher_forcing`.  compute_dtype is the trunk's
    precision (default bf16; the noising and weighting stay fp32)."""
    nfpb = num_frame_per_block

    def loss_fn(model, batch, draws):
        x0 = batch["latents"].float()
        B, F = x0.shape[:2]
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        ts = torch.as_tensor(scheduler.timesteps, device=x0.device)

        t = ts[draws["idx"].repeat_interleave(nfpb, dim=1)]
        noise = draws["noise"].float()
        noisy = scheduler.add_noise(flat(x0), flat(noise),
                                    t.reshape(-1)).reshape(x0.shape)
        target = noise - x0

        if noise_aug_max_timestep > 0:
            aug_t = ts[draws["idx_aug"].repeat_interleave(nfpb, dim=1)]
            clean_aug = scheduler.add_noise(
                flat(x0), flat(noise), aug_t.reshape(-1)).reshape(x0.shape)
        else:
            clean_aug, aug_t = x0, torch.zeros_like(t)

        # single-coin CFG dropout per step, decided on the device
        drop = draws["coin"] <= cfg_dropout
        ctx = torch.where(drop, batch["uncond_context"], batch["context"])

        flow = fps_forward_train(model, cfg, noisy.to(compute_dtype), t, ctx,
                                 frame_mask,
                                 clean_x=clean_aug.to(compute_dtype),
                                 aug_t=aug_t, compute_dtype=compute_dtype)
        err = torch.mean((flow.float() - target) ** 2, dim=(2, 3, 4))
        w = scheduler.training_weight(t).reshape(B, F)
        return torch.mean(err * w)

    return loss_fn


def make_scheduler(timestep_shift: float = 8.0) -> FlowMatchScheduler:
    """The training schedule of `DiffusionTrainer` (1000 steps, weights)."""
    sch = FlowMatchScheduler(shift=timestep_shift, sigma_min=0.0,
                             extra_one_step=True)
    sch.set_timesteps(1000, training=True)
    return sch


class DiffusionTrainer:
    """Single-device trainer: fp32 master weights in `model`, AdamW on
    them (the `optax.adamw` configuration of the JAX trainer)."""

    def __init__(self, model, loss_fn: Callable,
                 learning_rate: float = 1e-5, weight_decay: float = 0.01):
        bad = [n for n, p in model.named_parameters()
               if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"master weights must be fp32: {bad[:3]}")
        self.model = model.requires_grad_(True)
        self.opt = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)
        self._loss_fn = loss_fn
        #: global norm of the last step's gradients (a device scalar)
        self.grad_norm: Optional[torch.Tensor] = None

    def train_step(self, batch, draws) -> torch.Tensor:
        """One AdamW step; returns the loss (a detached device scalar)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self._loss_fn(self.model, batch, draws)
        loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        self.grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        self.opt.step()
        return loss.detach()
