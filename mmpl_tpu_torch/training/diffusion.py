"""Flow-matching training on one device: teacher forcing and the flow
objective.

Port of `mmpl_tpu/training/diffusion.py` (`make_teacher_forcing_loss_fn`,
`make_loss_fn`, `sample_block_timesteps`, `DiffusionTrainer`); the
trainer's `--mesh` shards the model before it reaches `DiffusionTrainer`
(`train._Ranks`).  The flow objective (`make_loss_fn`) is flow-matching MSE on the
bidirectional `dit_forward` with per-block rematerialisation, blockwise
timesteps, the training weight and 10% CFG dropout (one coin per sample).
Teacher forcing:
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

from ..models.dit import dit_forward
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


def sample_block_timesteps(generator: torch.Generator, batch: int,
                           num_frames: int, num_frame_per_block: int,
                           min_t: int = 0, max_t: int = 1000,
                           device=None) -> torch.Tensor:
    """[B, F] integer timesteps as fp32, equal within each block."""
    nb = num_frames // num_frame_per_block
    t = torch.randint(min_t, max_t, (batch, nb), generator=generator,
                      device=device).float()
    return t.repeat_interleave(num_frame_per_block, dim=1)


def draw_flow(generator: torch.Generator, latents_shape,
              num_frame_per_block: int = 3,
              device=None) -> Dict[str, torch.Tensor]:
    """One flow step's draws: `t` [B, F] block timesteps, `noise` like the
    latents, `coin` [B] in [0, 1) (CFG dropout where < the rate)."""
    B, F = latents_shape[:2]
    return {"t": sample_block_timesteps(generator, B, F, num_frame_per_block,
                                        device=device),
            "noise": torch.randn(tuple(latents_shape), generator=generator,
                                 device=device),
            "coin": torch.rand((B,), generator=generator, device=device)}


def make_loss_fn(cfg, scheduler: FlowMatchScheduler,
                 cfg_dropout: float = 0.1,
                 compute_dtype=torch.bfloat16,
                 remat: bool = True) -> Callable:
    """Flow-matching MSE with timestep weighting on the bidirectional Wan
    DiT; loss_fn(model, batch, draws).

    batch: {"latents" [B, F, C, H, W], "context" [B, T, text_dim]};
    draws: from `draw_flow`.  The trunk reads the parameters cast to
    compute_dtype (default bf16 over fp32 masters); the noising and the
    loss stay fp32."""

    def loss_fn(model, batch, draws):
        x0 = batch["latents"].float()
        context = batch["context"]
        B, F = x0.shape[:2]
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        ts = torch.as_tensor(scheduler.timesteps, device=x0.device)
        # the integer train step -> the shifted schedule's timestep
        t = ts[draws["t"].long().clamp(0, ts.shape[0] - 1)]
        noise = draws["noise"].float()
        xt = scheduler.add_noise(flat(x0), flat(noise),
                                 t.reshape(-1)).reshape(x0.shape)
        drop = (draws["coin"] < cfg_dropout).reshape(B, 1, 1)
        context = torch.where(drop, torch.zeros_like(context), context)
        flow = dit_forward(model, cfg, xt.to(compute_dtype), t, context,
                           remat=remat, compute_dtype=compute_dtype)
        err = (flow.float() - (noise - x0)) ** 2
        w = scheduler.training_weight(t).reshape(B, F, 1, 1, 1)
        return torch.mean(err * w)

    return loss_fn


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
        # through the model's call: an FSDP-sharded model
        # (`parallel/mesh.shard_for_training`) gathers its root there
        loss = self.model(self._loss_fn, batch, draws)
        loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        self.grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        self.opt.step()
        return loss.detach()
