"""Distillation objectives: DMD, SiD, CausVid, GAN and ODE regression.

Port of `mmpl_tpu/training/distillation.py` over a bundle of modules:

  models = {"generator": the causal DiT (trained by the generator losses),
            "fake_score": a bidirectional DiT (trained by the critic),
            "real_score": a bidirectional DiT (the frozen teacher),
            "gan_head": `gan.GanHead` (the GAN objective's critic part)}

The generator's sample comes from `SelfForcingRollout`; the scores run
the bidirectional `dit_forward` with per-block rematerialisation.  Each
loss is loss(models, batch, draws) -> (loss, log).  `draws` holds the
random numbers by name (the keys each loss names below); a name that is
missing is drawn from `draws["generator"]`, a `torch.Generator`, at the
point the JAX package draws it, so that a test can hand in the JAX key
chain's draws and a trainer can pass a generator alone.  Which modules a
loss trains is the caller's choice (`requires_grad`): the losses detach
what the JAX package stops gradients at.

`DistillationConfig.dtype` is the activations' type (fp32 by default, as
in the JAX trainer); `linear` casts the fp32 weights to it, so bf16 is a
bf16 trunk over fp32 masters.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dit import dit_forward
from ..models.fps_dit import fps_forward_group, init_kv_cache
from ..pipelines.causal_inference import block_schedule
from ..schedulers.flow_match import FlowMatchScheduler
from .self_forcing import SelfForcingRollout, slice_last_window


def shift_timestep(t: torch.Tensor, shift: float) -> torch.Tensor:
    """The score-timestep warp t' = s t / (1 + (s - 1) t / 1000)."""
    if shift <= 1:
        return t
    tn = t / 1000.0
    return shift * tn / (1 + (shift - 1) * tn) * 1000.0


def _flat(a):
    return a.reshape((-1,) + tuple(a.shape[2:]))


def _draw(draws: dict, name: str, make: Callable[[torch.Generator],
                                                 torch.Tensor]):
    v = draws.get(name)
    return make(draws["generator"]) if v is None else v


def _normal(draws, name, shape, device):
    return _draw(draws, name, lambda g: torch.randn(
        tuple(shape), generator=g, device=device)).to(device).float()


class DistillationConfig:
    def __init__(self, real_guidance_scale: float = 5.0,
                 fake_guidance_scale: float = 0.0,
                 timestep_shift: float = 8.0,
                 min_step: float = 20.0, max_step: float = 980.0,
                 min_score_timestep: int = 0,
                 num_train_timestep: int = 1000,
                 ts_schedule: bool = True, ts_schedule_max: bool = False,
                 sid_alpha: float = 1.0,
                 gan_g_weight: float = 1e-2, gan_d_weight: float = 1e-2,
                 r1_weight: float = 0.0, r2_weight: float = 0.0,
                 r1_sigma: float = 0.01, r2_sigma: float = 0.01,
                 relativistic_discriminator: bool = False,
                 concat_time_embeddings: bool = False,
                 critic_timestep_shift: Optional[float] = None,
                 window_frames: Optional[int] = None,
                 remat: bool = True,
                 dtype=torch.float32):
        self.real_guidance_scale = real_guidance_scale
        self.fake_guidance_scale = fake_guidance_scale
        self.timestep_shift = timestep_shift
        self.min_step = min_step
        self.max_step = max_step
        self.min_score_timestep = min_score_timestep
        self.num_train_timestep = num_train_timestep
        self.ts_schedule = ts_schedule
        self.ts_schedule_max = ts_schedule_max
        self.sid_alpha = sid_alpha
        self.gan_g_weight = gan_g_weight
        self.gan_d_weight = gan_d_weight
        self.r1_weight = r1_weight
        self.r2_weight = r2_weight
        self.r1_sigma = r1_sigma
        self.r2_sigma = r2_sigma
        self.relativistic_discriminator = relativistic_discriminator
        self.concat_time_embeddings = concat_time_embeddings
        self.critic_timestep_shift = (timestep_shift
                                      if critic_timestep_shift is None
                                      else critic_timestep_shift)
        #: rollouts longer than this are cut to their last window
        #: (`slice_last_window`) before the losses
        self.window_frames = window_frames
        #: recompute the score models' blocks in the backward pass
        self.remat = remat
        self.dtype = dtype


class Distiller:
    """The DMD / SiD / CausVid / GAN losses over one rollout each."""

    def __init__(self, model_cfg, dcfg: DistillationConfig,
                 rollout: SelfForcingRollout,
                 scheduler: FlowMatchScheduler, vae=None):
        self.model_cfg = model_cfg
        self.dcfg = dcfg
        self.rollout = rollout
        self.scheduler = scheduler
        #: `models.vae.WanVAE` for the last-window prefix re-encode
        self.vae = vae

    # -- score model helpers ----------------------------------------------

    def score_x0(self, model, xt: torch.Tensor, t: torch.Tensor,
                 ctx: torch.Tensor) -> torch.Tensor:
        """Bidirectional score forward -> x0 ([B, F, ...], t [B, F])."""
        flow = dit_forward(model, self.model_cfg, xt.to(self.dcfg.dtype), t,
                           ctx, remat=self.dcfg.remat)
        return self.scheduler.convert_flow_pred_to_x0(
            _flat(flow).float(), _flat(xt.float()),
            t.reshape(-1)).reshape(xt.shape)

    def _score_timestep(self, u: torch.Tensor, B: int, F: int, t_from,
                        t_to, shift: Optional[float] = None
                        ) -> torch.Tensor:
        """u [B, 1] in [0, 1) -> score timesteps [B, F] (equal across
        frames), warped and clipped."""
        d = self.dcfg
        dev = u.device
        min_t = torch.tensor(float(t_to if (d.ts_schedule and t_to is not None)
                                   else d.min_score_timestep),
                             dtype=torch.float32, device=dev)
        max_t = torch.tensor(float(t_from
                                   if (d.ts_schedule_max and t_from is not None)
                                   else d.num_train_timestep),
                             dtype=torch.float32, device=dev)
        t = min_t + u.float() * torch.clamp(max_t - min_t, min=1.0)
        t = shift_timestep(t.expand(B, F),
                           d.timestep_shift if shift is None else shift)
        return torch.clamp(t, d.min_step, d.max_step)

    def _u(self, draws, B: int, device) -> torch.Tensor:
        return _draw(draws, "u", lambda g: torch.rand(
            (B, 1), generator=g, device=device)).to(device)

    def kl_grad(self, models, noisy, x0_est, t, ctx, uncond_ctx,
                normalization: bool = True):
        """The DMD KL gradient: fake minus guided real x0, normalised by
        the mean |x0 - real|.  Returns (grad, real)."""
        d = self.dcfg
        fake = self.score_x0(models["fake_score"], noisy, t, ctx)
        if d.fake_guidance_scale != 0.0:
            fake_u = self.score_x0(models["fake_score"], noisy, t,
                                   uncond_ctx)
            fake = fake + (fake - fake_u) * d.fake_guidance_scale
        real_c = self.score_x0(models["real_score"], noisy, t, ctx)
        real_u = self.score_x0(models["real_score"], noisy, t, uncond_ctx)
        real = real_c + (real_c - real_u) * d.real_guidance_scale
        grad = fake - real
        if normalization:
            normalizer = torch.mean(torch.abs(x0_est - real), dim=(1, 2, 3, 4),
                                    keepdim=True)
            grad = grad / normalizer
        return torch.nan_to_num(grad), real

    def _rollout(self, models, batch, draws):
        """Rollout, then the last-window slice.  Returns (x0, t_from,
        t_to, gradient mask or None).  Draws: `exit_flags`, `rollout` (one
        dict per block, see `SelfForcingRollout.rollout`)."""
        noise = batch["noise"]
        init = batch.get("initial_latent")
        nblocks = self.rollout.num_blocks(noise.shape[1], init is not None)
        flags = _draw(draws, "exit_flags", lambda g: self.rollout
                      .sample_exit_flags(g, nblocks, device=noise.device))
        x0, t_from, t_to = self.rollout.rollout(
            models["generator"], batch["ctx_kv"], noise, flags,
            generator=draws.get("generator"), draws=draws.get("rollout"),
            initial_latent=init)
        mask = None
        if self.dcfg.window_frames is not None:
            x0, mask = slice_last_window(
                x0, self.dcfg.window_frames,
                self.rollout.num_frame_per_block, self.vae,
                independent_first_frame=self.rollout.independent_first_frame)
        return x0, t_from, t_to, mask

    # -- losses -----------------------------------------------------------

    def dmd_generator_loss(self, models, batch, draws):
        """DMD: 0.5 |x0 - sg(x0 - grad)|^2 (masked mean over the window's
        frames when sliced).  Draws: exit_flags, rollout, u, noise."""
        x0, t_from, t_to, mask = self._rollout(models, batch, draws)
        B, F = x0.shape[:2]
        t = self._score_timestep(self._u(draws, B, x0.device), B, F, t_from,
                                 t_to)
        noise = _normal(draws, "noise", x0.shape, x0.device)
        with torch.no_grad():
            noisy = self.scheduler.add_noise(
                _flat(x0.detach()), _flat(noise),
                t.reshape(-1)).reshape(x0.shape)
            grad, _ = self.kl_grad(models, noisy, x0.detach(), t,
                                   batch["context"], batch["uncond_context"])
            target = x0.detach() - grad
        if mask is None:
            loss = 0.5 * torch.mean((x0 - target) ** 2)
        else:
            m = mask.float()[..., None, None, None]
            loss = 0.5 * torch.sum((x0 - target) ** 2 * m) / (
                torch.clamp(torch.sum(m), min=1.0)
                * float(np.prod(x0.shape[2:])))
        return loss, {"dmd_grad_norm": torch.mean(torch.abs(grad))}

    def sid_generator_loss(self, models, batch, draws):
        """Score identity distillation (the gradient mask is accepted and
        not applied, as in the reference).  Draws: exit_flags, rollout, u,
        noise."""
        d = self.dcfg
        x0, t_from, t_to, _ = self._rollout(models, batch, draws)
        B, F = x0.shape[:2]
        t = self._score_timestep(self._u(draws, B, x0.device), B, F, t_from,
                                 t_to)
        noise = _normal(draws, "noise", x0.shape, x0.device)
        noisy = self.scheduler.add_noise(_flat(x0), _flat(noise),
                                         t.reshape(-1)).reshape(x0.shape)
        fake = self.score_x0(models["fake_score"], noisy, t, batch["context"])
        real_c = self.score_x0(models["real_score"], noisy, t,
                               batch["context"])
        real_u = self.score_x0(models["real_score"], noisy, t,
                               batch["uncond_context"])
        real = real_c + (real_c - real_u) * d.real_guidance_scale
        sid = (real - fake) * ((real - x0) - d.sid_alpha * (real - fake))
        normalizer = torch.mean(torch.abs(x0 - real), dim=(1, 2, 3, 4),
                                keepdim=True).detach()
        loss = torch.mean(torch.nan_to_num(sid / normalizer))
        return loss, {"timestep": torch.mean(t)}

    #: CausVid: the DMD generator loss with the fake score's optional CFG
    causvid_generator_loss = dmd_generator_loss

    def critic_loss(self, models, batch, draws):
        """The fake score's flow-matching loss on the generator's sample
        (the rollout runs without gradients).  Draws: exit_flags, rollout,
        u, noise."""
        with torch.no_grad():
            x0, t_from, t_to, _ = self._rollout(models, batch, draws)
        B, F = x0.shape[:2]
        t = self._score_timestep(self._u(draws, B, x0.device), B, F, t_from,
                                 t_to)
        noise = _normal(draws, "noise", x0.shape, x0.device)
        noisy = self.scheduler.add_noise(_flat(x0), _flat(noise),
                                         t.reshape(-1)).reshape(x0.shape)
        pred_x0 = self.score_x0(models["fake_score"], noisy, t,
                                batch["context"])
        flow_pred = self.scheduler.convert_x0_to_flow_pred(
            _flat(pred_x0), _flat(noisy), t.reshape(-1))
        loss = torch.mean((flow_pred - _flat(noise - x0)) ** 2)
        return loss, {"critic_timestep": torch.mean(t)}

    # -- GAN objective ----------------------------------------------------

    def _gan_logits(self, models, noisy, t, ctx):
        from .gan import dit_forward_classify
        return dit_forward_classify(
            models["fake_score"], models["gan_head"], self.model_cfg,
            noisy.to(self.dcfg.dtype), t, ctx,
            concat_time_embeddings=self.dcfg.concat_time_embeddings,
            remat_blocks=self.dcfg.remat)

    def _gan_noisy_pair(self, models, batch, draws, critic: bool):
        """The rollout and its noising, and the real latents' (the last
        window of them).  The generator loss draws fresh noise for the real
        branch, the critic reuses the fake branch's.  Draws: exit_flags,
        rollout, u, noise_fake, noise_real (generator loss only)."""
        d = self.dcfg
        with torch.set_grad_enabled(torch.is_grad_enabled() and not critic):
            x0, t_from, t_to, _ = self._rollout(models, batch, draws)
        B, F = x0.shape[:2]
        t = self._score_timestep(self._u(draws, B, x0.device), B, F, t_from,
                                 t_to, shift=d.critic_timestep_shift)
        noise_f = _normal(draws, "noise_fake", x0.shape, x0.device)
        noisy_fake = self.scheduler.add_noise(
            _flat(x0), _flat(noise_f), t.reshape(-1)).reshape(x0.shape)
        real = batch["real_latents"].float().detach()
        if real.shape[1] > x0.shape[1]:
            real = real[:, -x0.shape[1]:]
        noise_r = noise_f if critic else _normal(draws, "noise_real",
                                                 real.shape, x0.device)
        noisy_real = self.scheduler.add_noise(
            _flat(real), _flat(noise_r), t.reshape(-1)).reshape(real.shape)
        return noisy_fake, noisy_real, t

    def gan_generator_loss(self, models, batch, draws):
        """R3GAN generator loss on the rolled-out video, one batched critic
        pass over [fake; real].  batch also holds `real_latents`."""
        d = self.dcfg
        noisy_fake, noisy_real, t = self._gan_noisy_pair(models, batch,
                                                         draws, critic=False)
        both = torch.cat([noisy_fake, noisy_real.detach()], 0)
        ctx2 = torch.cat([batch["context"], batch["context"]], 0)
        logits = self._gan_logits(models, both, torch.cat([t, t], 0), ctx2)
        lf, lr = logits.float().chunk(2, 0)
        if d.relativistic_discriminator:
            loss = torch.mean(F.softplus(-(lf - lr)))
        else:
            loss = torch.mean(F.softplus(-lf))
        return loss * d.gan_g_weight, {"gan_fake_logit": torch.mean(lf)}

    def gan_critic_loss(self, models, batch, draws):
        """R3GAN critic loss and the R1 / R2 finite-difference penalties;
        trains `fake_score` and `gan_head`.  Draws: exit_flags, rollout,
        u, noise_fake, eps_r1, eps_r2."""
        d = self.dcfg
        noisy_fake, noisy_real, t = self._gan_noisy_pair(models, batch,
                                                         draws, critic=True)
        both = torch.cat([noisy_fake, noisy_real], 0)
        ctx2 = torch.cat([batch["context"], batch["context"]], 0)
        logits = self._gan_logits(models, both, torch.cat([t, t], 0), ctx2)
        lf, lr = logits.float().chunk(2, 0)
        if d.relativistic_discriminator:
            loss = torch.mean(F.softplus(-(lr - lf)))
        else:
            loss = torch.mean(F.softplus(-lr)) + torch.mean(F.softplus(lf))
        loss = loss * d.gan_d_weight

        def fd_penalty(noisy, base_logit, sigma, name):
            eps = sigma * _normal(draws, name, noisy.shape, noisy.device)
            pert = self._gan_logits(models, noisy + eps, t, batch["context"])
            g = (pert.float() - base_logit) / sigma
            return torch.mean(g ** 2)

        log = {"gan_real_logit": torch.mean(lr),
               "gan_fake_logit": torch.mean(lf)}
        if d.r1_weight > 0.0:
            loss = loss + d.r1_weight * fd_penalty(noisy_real, lr,
                                                   d.r1_sigma, "eps_r1")
        if d.r2_weight > 0.0:
            loss = loss + d.r2_weight * fd_penalty(noisy_fake, lf,
                                                   d.r2_sigma, "eps_r2")
        return loss, log


def prepare_ode_generator_input(ode_latent: torch.Tensor,
                                denoising_step_list, idx: torch.Tensor,
                                num_frame_per_block: int = 3):
    """The solver state at a step index drawn per block: ode_latent
    [B, S+1, F, C, H, W] (entry j the state at step j, entry S the clean
    end), idx [B, F / nb] ints in [0, S).  Returns (noisy_input
    [B, F, C, H, W], timestep [B, F] from the step list)."""
    B, S1, F = ode_latent.shape[:3]
    nb = num_frame_per_block
    assert F % nb == 0, (F, nb)
    idx = idx.long().repeat_interleave(nb, dim=1)             # [B, F]
    gather = idx[:, None, :, None, None, None].expand(
        B, 1, F, *ode_latent.shape[3:])
    noisy = torch.gather(ode_latent, 1, gather)[:, 0]
    steps = torch.as_tensor(list(denoising_step_list), dtype=torch.float32,
                            device=ode_latent.device)
    return noisy, steps[idx]


def ode_regression_loss(generator, cfg, scheduler: FlowMatchScheduler,
                        batch, dtype=torch.float32, remat: bool = True):
    """Regress the causal generator onto precomputed ODE trajectories.

    batch: {"noisy_input" [B, F, C, H, W] (a solver state at `timestep`),
    "clean_latent" [B, F, C, H, W] (the trajectory's end), "timestep"
    [B, F], "ctx_kv"}.  Blocks of 3 frames in order; after each, the
    target's clean frames are committed as context with gradients through
    the cache (functional writes, `fps_forward_group(inplace=False)`),
    each layer recomputed in the backward pass."""
    noisy = batch["noisy_input"].float()
    target = batch["clean_latent"].float()
    t = batch["timestep"].float()
    B, F = noisy.shape[:2]
    nb = 3
    cache = init_kv_cache(cfg, B, noisy.shape[3] * noisy.shape[4] // 4,
                          max(F, 21), dtype, noisy.device)
    preds = []
    for b in range(F // nb):
        sched = block_schedule(b * nb, nb, 21)
        x = noisy[:, b * nb:(b + 1) * nb]
        tt = t[:, b * nb:(b + 1) * nb]
        flow = fps_forward_group(generator, cfg, x.to(dtype), tt,
                                 batch["ctx_kv"], cache, sched, remat=remat)
        preds.append(scheduler.convert_flow_pred_to_x0(
            _flat(flow).float(), _flat(x), tt.reshape(-1)).reshape(x.shape))
        clean = target[:, b * nb:(b + 1) * nb]
        fps_forward_group(generator, cfg, clean.to(dtype),
                          torch.zeros_like(tt), batch["ctx_kv"], cache, sched,
                          write_cache=True, remat=remat, inplace=False)
    pred = torch.cat(preds, dim=1)
    # frames whose timestep is 0 are left out of the mean
    mask = (t != 0.0).float()[..., None, None, None]
    denom = torch.clamp(torch.sum(mask), min=1.0) * float(
        np.prod(pred.shape[2:]))
    loss = torch.sum((pred - target) ** 2 * mask) / denom
    unnorm = torch.mean((pred - target) ** 2, dim=(1, 2, 3, 4))
    return loss, {"pred": pred, "unnormalized_loss": unnorm,
                  "timestep": torch.mean(t, dim=1)}
