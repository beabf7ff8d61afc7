"""Self-forcing generator rollout for distillation training.

Port of `mmpl_tpu/training/self_forcing.py` (single device).  The causal
generator unrolls its own few-step sampling loop block by block; gradients
flow through exactly one denoising step per block, the one its exit flag
selects, and only for blocks inside the last `grad_frame_window` frames.
After each block the KV cache is committed from the prediction re-noised
to `context_noise`.

  * The steps before the flag run under `torch.no_grad()` and the loop
    stops at the flag (the reference's `break`); the flagged step then
    runs once with gradients, each layer recomputed in the backward pass
    (`remat`), and the commit runs under `torch.no_grad()` again.  No pass
    of the generator's own steps writes the cache, which a block never
    reads; only the commit does.
  * Absolute-slot blocks write their own frames' slots in place: a later
    block never rewrites the slots an earlier graded block read, so the
    recomputation reads what the forward read.  Past `num_max_frames`
    with `rolling`, the cache is a ring of that many slots kept as a slot
    permutation (as `pipelines/causal_inference.py` keeps it) with RoPE
    from the block's start frame (`rope.dynamic_rope_table`); there each
    commit replaces the cache's tensors instead of overwriting them
    (`fps_forward_group(inplace=False)`), so an earlier graded block's
    recomputation still reads the K/V its forward read.
  * Every draw comes from an explicit `torch.Generator` or is handed in:
    the exit flags (`sample_exit_flags`), the per-step re-noising and the
    commit noise (`rollout(draws=...)`) and the rollout length
    (`sample_num_frames`, a numpy Generator as in the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.fps_dit import fps_forward_group, init_kv_cache
from ..ops.rope import dynamic_rope_table
from ..pipelines.causal_inference import block_schedule, rolling_schedule
from ..schedulers.flow_match import FlowMatchScheduler


class SelfForcingRollout:
    def __init__(self, cfg, scheduler: FlowMatchScheduler,
                 denoising_step_list: Sequence[int] = (1000, 750, 500, 250),
                 num_frame_per_block: int = 3,
                 context_noise: int = 0,
                 same_step_across_blocks: bool = True,
                 last_step_only: bool = False,
                 num_max_frames: int = 21,
                 grad_frame_window: int = 21,
                 remat: bool = True,
                 quantize_cache: bool = False,
                 rolling: bool = False,
                 warp_denoising_step: bool = False,
                 independent_first_frame: bool = False,
                 dtype=torch.float32):
        steps = [float(t) for t in denoising_step_list]
        if steps[-1] == 0:
            steps = steps[:-1]
        if warp_denoising_step:
            # each step through the shifted table: step -> timesteps[1000-step]
            ts = np.concatenate([np.asarray(scheduler.timesteps), [0.0]])
            steps = [float(ts[1000 - int(s)]) for s in steps]
        #: the step values as fp32 numbers (the JAX package's table)
        self.steps = tuple(float(np.float32(s)) for s in steps)
        self.cfg = cfg
        self.scheduler = scheduler
        self.num_frame_per_block = num_frame_per_block
        self.context_noise = context_noise
        self.same_step_across_blocks = same_step_across_blocks
        self.last_step_only = last_step_only
        self.num_max_frames = num_max_frames
        self.grad_frame_window = grad_frame_window
        self.remat = remat
        #: int8 rollout cache (its gradients are severed anyway)
        self.quantize_cache = bool(quantize_cache)
        self.rolling = bool(rolling)
        #: the i2v [1, nb, nb, ...] plan without an initial latent
        self.independent_first_frame = bool(independent_first_frame)
        self.dtype = dtype

    def num_blocks(self, num_noise_frames: int,
                   has_initial_latent: bool = False) -> int:
        """Number of denoised blocks (= exit flags) for a noise tensor of
        `num_noise_frames` frames."""
        first = 1 if (self.independent_first_frame
                      and not has_initial_latent) else 0
        assert (num_noise_frames - first) % self.num_frame_per_block == 0, \
            (num_noise_frames, first, self.num_frame_per_block)
        return first + (num_noise_frames - first) // self.num_frame_per_block

    def sample_exit_flags(self, generator: Optional[torch.Generator],
                          num_blocks: int, device=None) -> torch.Tensor:
        """[num_blocks] int64 step indices in [0, steps)."""
        if self.last_step_only:
            return torch.full((num_blocks,), len(self.steps) - 1,
                              dtype=torch.long, device=device)
        return torch.randint(0, len(self.steps), (num_blocks,),
                             generator=generator, device=device)

    def block_flags(self, exit_flags, num_blocks: int) -> List[int]:
        """Each block's step index (the first flag for every block under
        `same_step_across_blocks`), clipped to the step list."""
        flags = [int(f) for f in torch.as_tensor(exit_flags).tolist()]
        S = len(self.steps)
        if self.same_step_across_blocks:
            flags = [flags[0]] * num_blocks
        return [min(max(f, 0), S - 1) for f in flags]

    # ------------------------------------------------------------------

    def _one_block(self, model, ctx_kv, cache, x: torch.Tensor, flag: int,
                   sched, rope_cs, graded: bool, draws, generator,
                   inplace: bool) -> torch.Tensor:
        """The no-grad steps up to the flag, the (graded) flagged step and
        the context-noise commit; returns x0 [B, G, C, H, W] fp32."""
        sch = self.scheduler
        B, G = x.shape[:2]
        n = B * G
        dev = x.device
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        full = lambda v, shape: torch.full(shape, float(v),
                                           dtype=torch.float32, device=dev)

        def noise_for(kind, i=None):
            if draws is not None:
                d = draws[kind] if i is None else draws[kind][i]
                return d.to(dev).float()
            return torch.randn(x.shape, generator=generator, device=dev)

        xi = x
        with torch.no_grad():
            for i in range(flag):
                tt = full(self.steps[i], (B, G))
                flow = fps_forward_group(model, self.cfg, xi.to(self.dtype),
                                         tt, ctx_kv, cache, sched,
                                         rope_cs=rope_cs)
                x0 = sch.convert_flow_pred_to_x0(
                    flat(flow).float(), flat(xi), tt.reshape(-1)
                ).reshape(xi.shape)
                xi = sch.add_noise(flat(x0), flat(noise_for("step", i)),
                                   full(self.steps[i + 1], (n,))
                                   ).reshape(xi.shape)

        tt = full(self.steps[flag], (B, G))
        with torch.set_grad_enabled(graded and torch.is_grad_enabled()):
            flow = fps_forward_group(model, self.cfg, xi.to(self.dtype), tt,
                                     ctx_kv, cache, sched, rope_cs=rope_cs,
                                     remat=self.remat and graded)
            x0 = sch.convert_flow_pred_to_x0(
                flat(flow).float(), flat(xi), tt.reshape(-1)
            ).reshape(xi.shape)

        with torch.no_grad():
            committed = sch.add_noise(
                flat(x0.detach()), flat(noise_for("commit")),
                full(self.context_noise, (n,))).reshape(x0.shape)
            fps_forward_group(model, self.cfg, committed.to(self.dtype),
                              full(self.context_noise, (B, G)), ctx_kv,
                              cache, sched, write_cache=True,
                              rope_cs=rope_cs, inplace=inplace)
        return x0

    def rollout(self, model, ctx_kv, noise: torch.Tensor, exit_flags,
                generator: Optional[torch.Generator] = None,
                draws: Optional[List[Dict]] = None,
                initial_latent: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[int], Optional[int]]:
        """Returns (output [B, n_init + F, C, H, W] fp32 with gradients at
        the flagged steps, denoised_timestep_from, denoised_timestep_to);
        the last two are None unless `same_step_across_blocks`.

        exit_flags [num_blocks]; draws: one dict per denoised block, in
        order, {"step": [steps - 1 tensors like the block (entries past
        the flag may be None)], "commit": a tensor like the block}; without
        it each draw comes from `generator` as it is needed."""
        cfg = self.cfg
        B, F, C, H, W = noise.shape
        nb = self.num_frame_per_block
        n_init = 0 if initial_latent is None else initial_latent.shape[1]
        first = 1 if (self.independent_first_frame and n_init == 0) else 0
        assert (F - first) % nb == 0, (F, first, nb)
        sizes = [1] * first + [nb] * ((F - first) // nb)
        total = F + n_init
        grad_start_frame = total - self.grad_frame_window
        cap = self.num_max_frames
        rolling = self.rolling and total > cap
        # the ring must be exactly full when the steady state takes over
        assert not rolling or (
            cap >= n_init + first
            and (cap - n_init - first) % nb == 0), (cap, nb, n_init, first)
        num_slots = cap if rolling else max(total, cap)
        cache = init_kv_cache(cfg, B, H * W // 4, num_slots, self.dtype,
                              noise.device, quantize=self.quantize_cache)
        flags = self.block_flags(exit_flags, len(sizes))
        d_head = cfg.dim // cfg.num_heads
        outputs = []
        start = 0
        if initial_latent is not None:
            with torch.no_grad():
                fps_forward_group(
                    model, cfg, initial_latent.float().to(self.dtype),
                    torch.zeros((B, n_init), device=noise.device), ctx_kv,
                    cache, block_schedule(0, n_init, cap), write_cache=True)
            outputs.append(initial_latent.float())
            start = n_init

        order = list(range(num_slots))
        noff = 0
        for b, g in enumerate(sizes):
            x = noise[:, noff:noff + g].float()
            bd = None if draws is None else draws[b]
            if not rolling or start + g <= cap:
                sched = block_schedule(start, g, cap if rolling
                                       else self.num_max_frames)
                x0 = self._one_block(model, ctx_kv, cache, x, flags[b], sched,
                                     None, start >= grad_start_frame, bd,
                                     generator, inplace=not rolling)
            else:
                # steady state: evict the oldest block; all steady blocks
                # run graded, the window is applied on the output below
                order = order[g:] + order[:g]
                rope_cs = dynamic_rope_table(start, g, H // 2, W // 2,
                                             d_head, device=noise.device)
                x0 = self._one_block(model, ctx_kv, cache, x, flags[b],
                                     rolling_schedule(cap, g, order),
                                     rope_cs, True, bd, generator,
                                     inplace=False)
            outputs.append(x0)
            start += g
            noff += g

        output = torch.cat(outputs, dim=1)
        if rolling and grad_start_frame > 0:
            output = torch.cat([output[:, :grad_start_frame].detach(),
                                output[:, grad_start_frame:]], dim=1)
        if not self.same_step_across_blocks:
            return output, None, None
        return (output,) + self.denoised_range(exit_flags)

    def denoised_range(self, exit_flags) -> Tuple[int, int]:
        """(denoised_timestep_from, denoised_timestep_to): 1000 minus the
        index of the schedule entry nearest the first flag's step (and the
        next step's; 0 after the last step)."""
        ts = np.asarray(self.scheduler.timesteps, np.float32)
        flag0 = int(torch.as_tensor(exit_flags).reshape(-1)[0])
        S = len(self.steps)
        vals = np.asarray(self.steps, np.float32)

        def t_idx(v):
            return 1000 - int(np.argmin(np.abs(ts - v)))

        t_from = t_idx(vals[min(max(flag0, 0), S - 1)])
        t_to = 0 if flag0 == S - 1 else t_idx(vals[min(flag0 + 1, S - 1)])
        return t_from, t_to


def sample_num_frames(rng: np.random.Generator, min_frames: int,
                      max_frames: int, num_frame_per_block: int = 3,
                      independent_first_frame: bool = False) -> int:
    """Uniform random rollout length in whole blocks; under the i2v plan
    the blocks are drawn over [min - 1, max - 1] and the image frame is
    added back."""
    off = 1 if independent_first_frame else 0
    assert (min_frames - off) % num_frame_per_block == 0, (
        min_frames, off, num_frame_per_block)
    assert (max_frames - off) % num_frame_per_block == 0, (
        max_frames, off, num_frame_per_block)
    lo = (min_frames - off) // num_frame_per_block
    hi = (max_frames - off) // num_frame_per_block
    return int(rng.integers(lo, hi + 1)) * num_frame_per_block + off


def slice_last_window(x0: torch.Tensor, window: int,
                      num_frame_per_block: int = 3, vae=None,
                      independent_first_frame: bool = False):
    """The last-window trick for rollouts longer than `window` frames:
    decode the prefix, re-encode its last pixel frame as an image latent
    (no gradient) and return [image latent, the last window - 1 latents],
    with the per-frame gradient mask whose first block (the image frame
    alone under the i2v plan) is False.  Without a VAE the prefix is
    dropped.  Returns (x_win [B, window, C, H, W], mask [B, window] bool or
    None)."""
    B, F = x0.shape[:2]
    if F <= window:
        return x0, None
    if vae is not None:
        from ..models import vae as vae_mod
        prefix = x0[:, :F - (window - 1)].detach().float()
        pixels = vae_mod.decode(vae, prefix)
        img_lat = vae_mod.encode(vae, pixels[:, -1:])
        # out of inference mode: a plain tensor that autograd may save
        x_win = torch.cat([img_lat.clone().to(x0.dtype),
                           x0[:, -(window - 1):]], dim=1)
    else:
        x_win = x0[:, -window:]
    nomask = 1 if independent_first_frame else num_frame_per_block
    mask = torch.ones((B, window), dtype=torch.bool, device=x0.device)
    mask[:, :nomask] = False
    return x_win, mask
