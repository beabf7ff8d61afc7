"""Training entry point: teacher forcing, the flow objective, self-forcing
distillation (DMD, SiD, CausVid, GAN) and ODE regression.

Port of `train.py:main`.  Random weights and synthetic batches drawn
from `torch.Generator`s seeded from `--seed`, or with `--data-dir` the
batches of a shard directory; one JSON line per step in
`<log-dir>/<run-name>/metrics.jsonl`.  Smoke mode is the tiny
config at 4x4 latents; otherwise `t2v-1.3B` at 60x104 (480x832 pixels).
The generator starts, in this order, from an MMPL fine-tune `.pt`
(`--generator-ckpt`), the base Wan weights (`--wan-dir`: a directory of
safetensors shards or one state dict file), or random weights; the fp32
masters take the file's values, widened where the file holds bf16.

  * teacher_forcing: the fps-forcing mask over [clean | noisy], a bf16
    trunk over fp32 masters, AdamW, EMA (`training/diffusion.py`);
  * flow: flow-matching MSE on the bidirectional DiT, a bf16 trunk over
    fp32 masters with per-block rematerialisation, AdamW, EMA;
  * dmd / sid / causvid / gan: the generator's self-forcing rollout
    (`training/self_forcing.py`) scored by a fake score (trained) and a
    frozen real score, or by the fake score's GAN head
    (`training/distillation.py`, `training/gan.py`).  Each step trains the
    critic (AdamW at `--lr-critic`), and every `--dfake-gen-update-ratio`-
    th step the generator (AdamW at `--lr`), whose EMA starts at
    `--ema-start-step`.  With `--num-training-frames` above
    `--num-frames` each step draws the rollout's length and the losses see
    its last window (re-encoded through `--vae-path` when given).  The
    modules run in fp32, as the JAX trainer builds them;
  * ode: regression of the generator onto ODE trajectories, synthetic or
    from `--data-dir`.

`--data-dir` (teacher_forcing, flow, ode): `.npz` shards read through
`data/datasets.batch_iterator` (numpy's `default_rng(--seed)` shuffle,
the JAX trainer's batches).  Teacher forcing and flow train on the
shards' `latents` ([N, F, 16, h, w], `data/video_dataset.py` writes them)
with `prompt_embeds` as the context and a zero uncond context; ode on
`ode_latent` ([N, S+1, F, 16, h, w], `data/ode_gen.py`) with
`prompt_embeds`.  Each step's batch goes to the device as one pinned,
non-blocking copy; its `load_s` is logged beside `step_s`.  The
distillation objectives read no data (their real latents are drawn, in
both packages) and exit naming `--data-dir`.

Checkpoints (`utils/train_state_io.py`): with `--ckpt-dir`, every
`--ckpt-every` steps the fp32 masters of every trained model, the AdamW
state(s), the EMA shadow, the step and the states of the trainer's
generators and the data iterator's position go to `<ckpt-dir>/step<N>`;
`--resume <ckpt-dir>/step<N>` restores them and runs steps
N..`--steps`-1, drawing and reading what an unbroken run would, bit for
bit (the JAX trainer starts its shuffled order again at a resume).  `--export-pt` writes the generator and its EMA as the
upstream `.pt` at the end.  `--config` merges a run config
(`configs/*.yaml`) over the flag defaults as the JAX trainer does; flags
given on the command line win.  `--mesh dp=A,fsdp=B,tp=C` (one process
per card under torchrun, or `--coordinator` / `--num-processes` /
`--process-id`) splits every DiT's heads and ffn over tp (Megatron, the
tp ranks of a dp rank on the same rows and draws), FSDP-shards it over
fsdp, replicated over dp, and splits the batch over dp (`_Ranks`);
`--export-pt` gathers the full tensors to rank 0; `--ckpt-dir` /
`--resume` write and read sharded checkpoints
(`train_state_io.save_sharded`, the tp slices under keys of their own)
on a mesh of the same shape.

Host offload (`utils/memory.py`), where `train.py` uses it:
`--remat-offload` keeps each rematerialised block's input in pinned host
memory until the backward pass (teacher forcing, ODE, the distillation
scores and rollout); `--offload-opt` keeps the distillation objectives'
AdamW moments (`utils/memory.HostAdamW`) and the generator's EMA shadow
there, streamed through the card a parameter at a time.  Both change
where tensors live, not what is computed; checkpoints keep their format
and a run may switch either flag across a resume.  Where `train.py`
parses a flag and ignores it (`--offload-opt` with teacher_forcing, flow
or ode; `--remat-offload` with flow) the port exits naming it.

    python -m mmpl_tpu_torch.train --smoke --steps 3
    python -m mmpl_tpu_torch.train --smoke --objective flow --steps 3
    python -m mmpl_tpu_torch.train --config configs/self_forcing_dmd.yaml \
        --generator-ckpt ode_init.pt --wan-dir Wan2.1-T2V-1.3B \
        --ckpt-dir ckpt --export-pt mmpl_dmd_1.3B.pt
    python -m mmpl_tpu_torch.train --generator-ckpt mmpl_t2v_1.3B.pt
    python -m mmpl_tpu_torch.train --steps 1000 --ckpt-dir ckpt \
        --resume ckpt/step500 --export-pt mmpl_t2v_1.3B.pt
    python -m mmpl_tpu_torch.train --data-dir shards --num-frames 21
    python -m mmpl_tpu_torch.train --objective ode --data-dir ode_shards
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .models.dit import WanDiT

OBJECTIVES = ("teacher_forcing", "flow", "dmd", "sid", "gan", "causvid",
              "ode")
#: the objectives that train on `--data-dir`
DATA_OBJECTIVES = ("teacher_forcing", "flow", "ode")
#: the objectives whose optimizers and EMA `--offload-opt` moves, and
#: those `--remat-offload` offloads (train.py passes each flag there only)
OFFLOAD_OPT_OBJECTIVES = ("dmd", "sid", "gan", "causvid")
REMAT_OFFLOAD_OBJECTIVES = ("teacher_forcing", "ode") + OFFLOAD_OPT_OBJECTIVES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mmpl_tpu_torch training")
    p.add_argument("--objective", default="teacher_forcing",
                   choices=OBJECTIVES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--smoke", action="store_true",
                   help="tiny model + synthetic data")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr-critic", type=float, default=None,
                   help="fake-score / discriminator learning rate "
                        "(defaults to --lr)")
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--ema-start-step", type=int, default=0,
                   help="distillation: start the generator's EMA here")
    p.add_argument("--timestep-shift", type=float, default=8.0)
    p.add_argument("--num-frames", type=int, default=21)
    p.add_argument("--num-frame-per-block", type=int, default=3)
    p.add_argument("--num-training-frames", type=int, default=None,
                   help="distillation: max rollout length; each step "
                        "draws a length in [--num-frames, this] in whole "
                        "blocks and the losses see its last --num-frames")
    p.add_argument("--rolling", action="store_true",
                   help="distillation: rollout blocks past the "
                        "--num-frames window run in a ring cache")
    p.add_argument("--noise-aug-max", type=int, default=100)
    p.add_argument("--dfake-gen-update-ratio", type=int, default=5)
    p.add_argument("--fake-guidance-scale", type=float, default=0.0,
                   help="CFG on the fake score (the CausVid knob)")
    p.add_argument("--denoising-step-list", default="1000,750,500,250",
                   help="few-step list of the rollout and ODE regression")
    p.add_argument("--warp-denoising-step", action="store_true",
                   help="map the step list through the shifted schedule")
    p.add_argument("--independent-first-frame", action="store_true",
                   help="i2v [1, nb, nb, ...] rollout plan")
    p.add_argument("--same-step-across-blocks", type=int, choices=[0, 1],
                   default=1,
                   help="one exit flag for every rollout block")
    p.add_argument("--last-step-only", action="store_true",
                   help="always exit the rollout at the last step")
    p.add_argument("--ts-schedule", type=int, choices=[0, 1], default=1,
                   help="draw score timesteps from [t_to, max]")
    p.add_argument("--real-guidance-scale", type=float, default=5.0,
                   help="CFG on the frozen real score")
    p.add_argument("--context-noise", type=int, default=0,
                   help="timestep at which rollout blocks are committed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", default="runs",
                   help="JSONL metrics directory (utils/metrics.py)")
    p.add_argument("--run-name", default=None)
    p.add_argument("--generator-ckpt", default=None,
                   help="MMPL generator .pt to start from")
    p.add_argument("--wan-dir", default=None,
                   help="base Wan DiT weights: the generator's start "
                        "without --generator-ckpt, and the distillation "
                        "scores' start")
    p.add_argument("--vae-path", default=None,
                   help="Wan2.1_VAE.pth for the long rollout's last-window "
                        "re-encode")
    p.add_argument("--ckpt-dir", default=None,
                   help="write <ckpt-dir>/step<N> every --ckpt-every steps")
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--resume", default=None,
                   help="a <ckpt-dir>/step<N> to resume the models, "
                        "optimizers, EMA, step and generators from")
    p.add_argument("--export-pt", default=None,
                   help="at the end, write the generator and its EMA as "
                        "the upstream .pt ({'generator', 'generator_ema'})")
    p.add_argument("--config", default=None,
                   help="YAML run config (configs/*.yaml) merged over the "
                        "flag defaults; flags given explicitly win")
    p.add_argument("--mesh", default=None,
                   help="multi-process mesh 'dp=A,fsdp=B,tp=C' (sizes "
                        "multiply to the processes): every model's heads "
                        "and ffn split over tp, FSDP-sharded over fsdp "
                        "(HSDP, replicated over dp), the batch over dp; "
                        "one process per card under torchrun, or "
                        "--coordinator / --num-processes / --process-id")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous host:port "
                        "(torch.distributed; parallel/mesh.py)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="a directory of .npz shards to train on "
                        "(teacher_forcing and flow: data/video_dataset.py's "
                        "latents; ode: data/ode_gen.py's trajectories)")
    p.add_argument("--remat-offload", action="store_true",
                   help="keep each rematerialised block's input in pinned "
                        "host memory until the backward pass (teacher "
                        "forcing, ode, the distillation objectives)")
    p.add_argument("--offload-opt", action="store_true",
                   help="distillation: keep the AdamW moments and the "
                        "generator's EMA shadow in pinned host memory, "
                        "streamed through the card a parameter at a time")
    args = apply_run_config(p.parse_args(argv), argv)
    if args.objective not in OBJECTIVES:
        p.error(f"--config selects objective {args.objective!r}, which "
                f"neither package trains")
    for flag, objectives in (("offload_opt", OFFLOAD_OPT_OBJECTIVES),
                             ("remat_offload", REMAT_OFFLOAD_OBJECTIVES)):
        if getattr(args, flag) and args.objective not in objectives:
            p.error(f"--{flag.replace('_', '-')} with --objective "
                    f"{args.objective}: train.py parses the flag and "
                    f"ignores it there; it applies to "
                    f"{', '.join(objectives)}")
    if args.data_dir and args.objective not in DATA_OBJECTIVES:
        p.error(f"--data-dir with --objective {args.objective}: the "
                f"distillation objectives read no data (their real latents "
                f"are drawn at random, as train.py's are); "
                f"{', '.join(DATA_OBJECTIVES)} train on --data-dir")
    if args.mesh:
        shape = mesh_shape(args.mesh)
        if set(shape) - {"dp", "fsdp", "tp"}:
            p.error(f"--mesh {args.mesh}: the trainer's axes are dp, fsdp "
                    f"and tp")
    return args


def mesh_shape(spec: str) -> dict:
    """'dp=A,fsdp=B,tp=C' -> {"dp": A, "fsdp": B, "tp": C}."""
    return {k: int(v) for k, v in (kv.split("=") for kv in spec.split(","))}


#: YAML key -> (CLI flag, args attribute, cast), as the JAX trainer's
#: `_CONFIG_KEYS`; `trainer` / `distribution_loss` -> --objective and
#: `denoising_step_list` are handled separately
_CONFIG_KEYS = {
    "timestep_shift": ("--timestep-shift", "timestep_shift", float),
    "lr": ("--lr", "lr", float),
    "seed": ("--seed", "seed", int),
    "batch_size": ("--batch-size", "batch_size", int),
    "ema_weight": ("--ema-decay", "ema_decay", float),
    "dfake_gen_update_ratio": ("--dfake-gen-update-ratio",
                               "dfake_gen_update_ratio", int),
    "num_training_frames": ("--num-training-frames",
                            "num_training_frames", int),
    "context_noise": ("--context-noise", "context_noise", int),
    "guidance_scale": ("--real-guidance-scale", "real_guidance_scale",
                       float),
    "ts_schedule": ("--ts-schedule", "ts_schedule",
                    lambda v: int(bool(v))),
    "same_step_across_blocks": ("--same-step-across-blocks",
                                "same_step_across_blocks",
                                lambda v: int(bool(v))),
    "last_step_only": ("--last-step-only", "last_step_only", bool),
    "lr_critic": ("--lr-critic", "lr_critic", float),
    "ema_start_step": ("--ema-start-step", "ema_start_step", int),
    "num_frame_per_block": ("--num-frame-per-block",
                            "num_frame_per_block", int),
    "fake_guidance_scale": ("--fake-guidance-scale",
                            "fake_guidance_scale", float),
    "independent_first_frame": ("--independent-first-frame",
                                "independent_first_frame", bool),
    "warp_denoising_step": ("--warp-denoising-step",
                            "warp_denoising_step", bool),
    "generator_ckpt": ("--generator-ckpt", "generator_ckpt", str),
}


def apply_run_config(args, argv=None):
    """Merge the `--config` YAML (with `default_config.yaml` beside it,
    when present, under it) into parsed args: config values replace flag
    DEFAULTS, flags given on the command line win.  Port of the JAX
    trainer's `apply_run_config`."""
    if not args.config:
        return args
    from .core.config import load_config
    default = os.path.join(os.path.dirname(args.config),
                           "default_config.yaml")
    run_cfg = load_config(args.config,
                          default if os.path.exists(default) else None)
    given = list(argv if argv is not None else sys.argv[1:])

    def explicit(flag):
        return any(a == flag or a.startswith(flag + "=") for a in given)

    for key, (flag, attr, cast) in _CONFIG_KEYS.items():
        if key in run_cfg and not explicit(flag):
            setattr(args, attr, cast(run_cfg[key]))
    if "denoising_step_list" in run_cfg \
            and not explicit("--denoising-step-list"):
        args.denoising_step_list = ",".join(
            str(int(t)) for t in run_cfg["denoising_step_list"])
    # image_or_video_shape: [B, F_latent, C, H, W]
    shp = run_cfg.get("image_or_video_shape")
    if shp and len(shp) >= 2:
        if not explicit("--batch-size"):
            args.batch_size = int(shp[0])
        if not explicit("--num-frames"):
            args.num_frames = int(shp[1])
    # `trainer: diffusion` -> teacher_forcing; `score_distillation` ->
    # its distribution_loss; a config may name the objective directly
    tr = run_cfg.get("trainer")
    obj = {"diffusion": "teacher_forcing",
           "score_distillation": run_cfg.get("distribution_loss", "dmd"),
           }.get(tr, tr)
    if obj and not explicit("--objective"):
        args.objective = obj
    return args


def load_generator(args, cfg, generator: torch.Generator,
                   device: torch.device):
    """The fp32 generator: `--generator-ckpt` (the MMPL `.pt`), else
    `--wan-dir` (base Wan weights), else random weights from
    `generator`."""
    from .models import dit
    from .utils import checkpoint as ckpt
    if args.generator_ckpt:
        model = ckpt.load_mmpl_generator(args.generator_ckpt, cfg,
                                         dtype=torch.float32, device=device)
        print(f"generator <- {args.generator_ckpt}", file=sys.stderr)
    elif args.wan_dir:
        model = ckpt.load_wan_dit(args.wan_dir, cfg, torch.float32, device)
        print(f"generator <- {args.wan_dir}", file=sys.stderr)
    else:
        model = dit.init_dit_params(cfg, generator, torch.float32, device)
    return model


def synthetic_batch(generator: torch.Generator, shape, cfg,
                    device: torch.device) -> dict:
    """One synthetic batch: latents [B, F, C, h, w] and text states drawn
    from `generator` (text states first), a zero uncond context."""
    context = torch.randn((shape[0], cfg.text_len, cfg.text_dim),
                          generator=generator, device=device)
    return {"latents": torch.randn(shape, generator=generator,
                                   device=device),
            "context": context,
            "uncond_context": torch.zeros_like(context)}


def distill_batch(generator: torch.Generator, noise_shape, cfg,
                  device: torch.device, real_shape=None) -> dict:
    """One distillation step's synthetic inputs: text states, the rollout
    noise [B, F_roll, C, h, w] and, for the GAN objective, real latents
    [B, F, C, h, w], drawn from `generator` in that order."""
    context = torch.randn((noise_shape[0], cfg.text_len, cfg.text_dim),
                          generator=generator, device=device)
    batch = {"context": context,
             "uncond_context": torch.zeros_like(context),
             "noise": torch.randn(noise_shape, generator=generator,
                                  device=device)}
    if real_shape is not None:
        batch["real_latents"] = torch.randn(real_shape, generator=generator,
                                            device=device)
    return batch


def ode_batch(generator: torch.Generator, shape, cfg,
              device: torch.device):
    """One synthetic ODE trajectory [B, S+1, F, C, h, w] and its text
    states."""
    traj = torch.randn(shape, generator=generator, device=device)
    context = torch.randn((shape[0], cfg.text_len, cfg.text_dim),
                          generator=generator, device=device)
    return traj, context


def loss_draws(generator: torch.Generator, step: int, role: str) -> dict:
    """The draws of one loss (`role`: critic, generator or ode): all from
    `generator`, at the points where the loss needs them."""
    return {"generator": generator}


def adamw(params, lr: float, weight_decay: float,
          offload: bool = False) -> torch.optim.AdamW:
    """AdamW (optax.adamw's betas and eps); with `offload` its moments in
    pinned host memory (`utils/memory.HostAdamW`, `--offload-opt`), the
    same values."""
    from .utils.memory import HostAdamW
    kind = HostAdamW if offload else torch.optim.AdamW
    return kind(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=weight_decay)


#: optax.adamw's default weight decay, which the JAX trainer's
#: distillation and ODE optimisers take
OPTAX_WEIGHT_DECAY = 1e-4


def _generators(device, seed):
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    return gen(seed), gen(seed + 1)


def _log_step(metrics, step, line, scalars):
    metrics.log(step, **scalars)
    load = f", load {scalars['load_s']:.3f}s" if "load_s" in scalars else ""
    print(line + f" ({scalars['step_s']:.2f}s{load})", file=sys.stderr,
          flush=True)


@contextlib.contextmanager
def _trainable(module):
    """Every parameter of `module` requires gradients inside the block:
    `torch.distributed.checkpoint.state_dict` reads and writes the
    optimizer state of those parameters only (and makes a fresh
    optimizer's state by a step at lr 0 over them), while the
    distillation trainer flags its modules only inside their steps."""
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    module.requires_grad_(True)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


class _Checkpoints:
    """`--ckpt-dir` / `--resume` around a state function: one
    `train_state.pt` on one device, a sharded checkpoint under the mesh
    (`utils/train_state_io.py`).  The state function builds its model and
    optimizer entries with `model_state` / `optim_state`, and a restore
    puts them back with `load_model` / `load_optim`: the modules' and
    optimizers' own state dicts on one device, `torch.distributed.
    checkpoint.state_dict`'s under the mesh (whose optimizer state dict
    creates a fresh AdamW's state, so that a load has tensors to fill)."""

    def __init__(self, args, metrics, device, ranks):
        self.args, self.metrics, self.device = args, metrics, device
        self.ranks = ranks

    @property
    def sharded(self) -> bool:
        return self.ranks.mesh is not None

    def model_state(self, model) -> dict:
        if not self.sharded:
            return model.state_dict()
        from torch.distributed.checkpoint.state_dict import \
            get_model_state_dict
        return get_model_state_dict(model)

    def optim_state(self, module, opt) -> dict:
        """`module`: the modules whose parameters `opt` steps."""
        if not self.sharded:
            return opt.state_dict()
        from torch.distributed.checkpoint.state_dict import \
            get_optimizer_state_dict
        with _trainable(module):
            return get_optimizer_state_dict(module, opt)

    def load_model(self, model, state: dict) -> None:
        if not self.sharded:
            model.load_state_dict(state)
            return
        from torch.distributed.checkpoint.state_dict import \
            set_model_state_dict
        set_model_state_dict(model, state)

    def load_optim(self, module, opt, state: dict) -> None:
        if not self.sharded:
            opt.load_state_dict(state)
            return
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_optimizer_state_dict)
        # strict=False: a parameter AdamW never stepped (no gradient in
        # any step, e.g. the text embedding under the distillation
        # losses) has no saved state and keeps none
        with _trainable(module):
            set_optimizer_state_dict(module, opt, state,
                                     options=StateDictOptions(strict=False))

    def restore(self, template: dict):
        from .utils import train_state_io as tsio
        path = self.args.resume
        t0 = time.time()
        if self.sharded:
            st = tsio.restore_sharded(path, template, self.ranks.shape,
                                      self.ranks.tp_rank)
        elif os.path.exists(os.path.join(path, ".metadata")):
            raise SystemExit(f"--resume {path} is a sharded checkpoint: "
                             f"resume it under the --mesh that wrote it")
        else:
            # the host-resident state (--offload-opt) is read into host
            # memory; the models are copied onto the card as they load
            st = tsio.restore_checkpoint(
                path, template, map_location="cpu" if self.args.offload_opt
                else self.device)
        dt = time.time() - t0
        self.metrics.log(int(st["step"]), resumed_from=path, restore_s=dt)
        if self.ranks.rank0:
            print(f"resumed at step {int(st['step'])} <- {path} "
                  f"({dt:.2f}s)", file=sys.stderr)
        return st

    def maybe_save(self, step: int, state_fn) -> None:
        from .utils import train_state_io as tsio
        a = self.args
        if not (a.ckpt_dir and a.ckpt_every and step % a.ckpt_every == 0):
            return
        path = os.path.join(a.ckpt_dir, f"step{step}")
        t0 = time.time()
        if self.sharded:
            nbytes = tsio.save_sharded(path, state_fn(step),
                                       self.ranks.shape, self.ranks.tp_rank)
        else:
            nbytes = tsio.save_checkpoint(path, state_fn(step))
        dt = time.time() - t0
        self.metrics.log(step, ckpt=path, ckpt_bytes=nbytes, save_s=dt)
        if self.ranks.rank0:
            print(f"saved {path} ({nbytes} bytes, {dt:.2f}s)",
                  file=sys.stderr)


class _DataBatches:
    """`--data-dir`: endless batches of `dataset` (`data/datasets.
    batch_iterator`, shuffled from --seed), the arrays `keys` of each
    stacked into one fp32 host buffer (pinned for a card) and moved to
    `device` in one non-blocking copy.  `position` counts the batches
    taken; a fresh iterator starts there (`skip`: the batches before it
    are not loaded), which is how `--resume` continues the unbroken run's
    order.  `load_s`: the host seconds of the last batch (read, pack,
    enqueue the copy)."""

    def __init__(self, dataset, args, device, keys, position: int = 0):
        from .data.datasets import batch_iterator
        self.dir, self.keys, self.device = args.data_dir, keys, device
        self.position = int(position)
        self._it = batch_iterator(dataset, args.batch_size, seed=args.seed,
                                  skip=self.position)
        self.load_s = 0.0

    def next(self) -> dict:
        t0 = time.perf_counter()
        b = next(self._it)
        self.position += 1
        missing = [k for k in self.keys if k not in b]
        if missing:
            raise SystemExit(f"--data-dir {self.dir}: the shards lack "
                             f"{', '.join(missing)} (write them with "
                             f"data/ode_gen.write_ode_shard(..., "
                             f"prompt_embeds=...) or data/video_dataset)")
        arrays = [np.ascontiguousarray(b[k], dtype=np.float32)
                  for k in self.keys]
        host = torch.empty(sum(a.size for a in arrays), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        off = 0
        for a in arrays:
            host[off:off + a.size].copy_(torch.from_numpy(a.reshape(-1)))
            off += a.size
        flat = host.to(self.device, non_blocking=True)
        out, off = {}, 0
        for k, a in zip(self.keys, arrays):
            out[k] = flat[off:off + a.size].view(a.shape)
            off += a.size
        self.load_s = time.perf_counter() - t0
        return out

    def check(self, what: str, got: int, want: int, flag: str) -> None:
        """Exit naming both numbers where the shards' `what` is not the
        `want` that `flag` gives."""
        if got != want:
            raise SystemExit(f"--data-dir {self.dir}: the shards' {what} "
                             f"is {got}; {flag} gives {want}")


class _Ranks:
    """The trainer's `--mesh` (JAX `train.py`'s (dp, fsdp, tp) mesh): every
    model split over tp and FSDP-sharded over (dp, fsdp)
    (`parallel/mesh.shard_for_training`), the layers given the tp group
    through `cfg.sharding` (`layer_cfg`), each process on its dp rows of
    the batch (the tp ranks of a dp rank on the same rows and draws), the
    losses run inside the models' forwards (whose hooks gather the
    parameters), the gradients of unsharded modules (the GAN head)
    averaged over dp.  Without `--mesh` every method leaves its input as
    it is."""

    def __init__(self, args):
        self.mesh, self.dp, self.dp_rank, self.rank0 = None, 1, 0, True
        self.tp, self.tp_rank, self.tp_group = 1, 0, None
        self.num_heads = None
        self.batch = args.batch_size
        if not args.mesh:
            return
        import torch.distributed as dist
        from .parallel.collectives import DistGroup
        from .parallel.mesh import init_distributed, make_mesh
        shape = mesh_shape(args.mesh)
        if not init_distributed(args.coordinator, args.num_processes,
                                args.process_id):
            raise SystemExit("--mesh needs a process group: run under "
                             "torchrun, or give --coordinator, "
                             "--num-processes and --process-id")
        self.dp, self.tp = shape.get("dp", 1), shape.get("tp", 1)
        if self.batch % self.dp:
            raise SystemExit(f"--batch-size {self.batch} does not split "
                             f"over dp = {self.dp}")
        #: the mesh's shape, which a sharded checkpoint records (tp only
        #: where it splits)
        self.shape = {"dp": self.dp, "fsdp": shape.get("fsdp", 1)}
        if self.tp > 1:
            self.shape["tp"] = self.tp
        self.mesh = make_mesh(self.shape)
        self.dp_rank = self.mesh.get_local_rank("dp")
        if self.tp > 1:
            self.tp_rank = self.mesh.get_local_rank("tp")
            self.tp_group = DistGroup(self.mesh.get_group("tp"))
        self.rank0 = dist.get_rank() == 0
        dims = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        print(f"mesh: {dims} (process {dist.get_rank()}/"
              f"{dist.get_world_size()})", file=sys.stderr)

    def layer_cfg(self, cfg):
        """cfg with the layers' `sharding` under tp (`dit.LayerSharding`:
        this rank's heads, the tp group's moves); cfg itself without."""
        self.num_heads = cfg.num_heads
        if self.tp == 1:
            return cfg
        from .core.config import DotDict
        from .models.dit import LayerSharding
        return DotDict(cfg, sharding=LayerSharding(self.tp, self.tp_group))

    def shard(self, model):
        if self.mesh is None:
            return model
        from .parallel.mesh import shard_for_training
        shard_for_training(model, self.mesh, self.num_heads)
        return model

    def rows(self, tree):
        """This process's dp rows of every batch-first tensor of `tree`."""
        if self.dp == 1:
            return tree
        if isinstance(tree, dict):
            return {k: self.rows(v) for k, v in tree.items()}
        if (isinstance(tree, torch.Tensor) and tree.ndim
                and tree.shape[0] == self.batch):
            return tree.chunk(self.dp)[self.dp_rank]
        return tree

    def in_forward(self, modules, fn, *args):
        """fn(*args) inside each module's forward (`WanDiT.forward`): an
        FSDP root gathers its own parameters there."""
        if self.mesh is None or not modules:
            return fn(*args)
        rest = list(modules[1:])
        return modules[0](lambda _m, *a: self.in_forward(rest, fn, *a),
                          *args)

    def full(self, named: dict) -> dict:
        """The whole tensors of a sharded model's {name: tensor}: the FSDP
        shards gathered (`DTensor.full_tensor`), then the tp slices
        (`parallel/mesh.gather_tp`); collectives, on every rank."""
        from .parallel.mesh import gather_tp
        from .utils.memory import stream_to_device
        out = {}
        for n, t in named.items():
            if hasattr(t, "full_tensor"):
                # a host-resident shard (--offload-opt) gathers on the card
                t = stream_to_device([t])[0].full_tensor()
            out[n] = gather_tp(n, t.detach(), self.tp_group)
        return out

    def export(self, path: str, model, ema_shadow, cfg) -> None:
        """`--export-pt`: the generator (and its EMA) as the upstream
        `.pt`; under the mesh every rank gathers the full tensors (`full`)
        and rank 0 writes."""
        from .utils import train_state_io as tsio
        params = dict(model.named_parameters())
        if self.mesh is not None:
            params = self.full(params)
            ema_shadow = None if ema_shadow is None else self.full(
                ema_shadow)
        if self.rank0:
            tsio.export_generator_pt(path, params, ema_shadow, cfg)
            print(f"exported {path}", file=sys.stderr)

    def sync_grads(self, modules) -> None:
        """The dp mean of the gradients of modules FSDP does not hold."""
        if self.dp == 1:
            return
        import torch.distributed as dist
        group = self.mesh.get_group("dp")
        for m in modules:
            for p in m.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
                    p.grad.div_(self.dp)


class _NoMetrics:
    """The metrics of a process other than rank 0 (which writes them)."""

    def log(self, step: int, **scalars) -> None:
        pass


def main(argv=None) -> int:
    args = parse_args(argv)
    from .core.config import WAN_CONFIGS, tiny_test_config
    from .utils.device import resolve_device, set_float32_precision
    from .utils.metrics import MetricsLogger

    device = resolve_device(args.device)
    set_float32_precision()
    ranks = _Ranks(args)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = tiny_test_config() if args.smoke else WAN_CONFIGS["t2v-1.3B"]
    lat_hw = (4, 4) if args.smoke else (60, 104)
    model = load_generator(args, cfg, torch.Generator(device=device)
                           .manual_seed(args.seed), device)
    cfg = ranks.layer_cfg(cfg)
    metrics = MetricsLogger(args.log_dir, args.run_name, config=vars(args)) \
        if ranks.rank0 else _NoMetrics()
    ckpts = _Checkpoints(args, metrics, device, ranks)
    if args.objective in ("teacher_forcing", "flow"):
        _train_diffusion(args, cfg, model, lat_hw, device, metrics, ckpts,
                         ranks)
    elif args.objective == "ode":
        _train_ode(args, cfg, model, lat_hw, device, metrics, ckpts, ranks)
    else:
        _train_distill(args, cfg, model, lat_hw, device, metrics, ckpts,
                       ranks)
    return 0


def _train_diffusion(args, cfg, model, lat_hw, device, metrics, ckpts,
                     ranks):
    """teacher_forcing and flow: one model, AdamW, EMA."""
    from .core.geometry import T2V_CLEAN_STEPS
    from .training import diffusion as tdiff
    from .training import masks
    from .utils.ema import EmaParams

    F = args.num_frames
    sch = tdiff.make_scheduler(args.timestep_shift)
    if args.objective == "teacher_forcing":
        fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:F])
        loss_fn = tdiff.make_teacher_forcing_loss_fn(
            cfg, sch, fm, num_frame_per_block=args.num_frame_per_block,
            noise_aug_max_timestep=args.noise_aug_max,
            remat_offload=args.remat_offload)
    else:
        loss_fn = tdiff.make_loss_fn(cfg, sch)
    trainer = tdiff.DiffusionTrainer(ranks.shard(model), loss_fn,
                                     learning_rate=args.lr,
                                     tp_group=ranks.tp_group)
    ema = EmaParams(model, decay=args.ema_decay)
    data_gen, draw_gen = _generators(device, args.seed)
    batches = None

    def train_state(step: int) -> dict:
        return {"model": ckpts.model_state(model),
                "optimizer": ckpts.optim_state(model, trainer.opt),
                "ema": ema.shadow, "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state()},
                "data": batches.position if batches else 0}

    start_step, position = 0, 0
    if args.resume:
        st = ckpts.restore(train_state(0))
        ckpts.load_model(model, st["model"])
        ckpts.load_optim(model, trainer.opt, st["optimizer"])
        ema.load(st["ema"])
        data_gen.set_state(st["rng"]["data"].cpu())
        draw_gen.set_state(st["rng"]["draw"].cpu())
        start_step, position = int(st["step"]), int(st.get("data", 0))
    if args.data_dir:
        from .data.datasets import TensorDictDataset
        batches = _DataBatches(TensorDictDataset(args.data_dir), args,
                               device, ("latents", "prompt_embeds"),
                               position)

    shape = (args.batch_size, F, cfg.in_dim, *lat_hw)
    for step in range(start_step, args.steps):
        scalars = {}
        if batches is None:
            batch = synthetic_batch(data_gen, shape, cfg, device)
        else:
            b = batches.next()
            batches.check("latent frame count", b["latents"].shape[1], F,
                          "--num-frames")
            batch = {"latents": b["latents"], "context": b["prompt_embeds"],
                     "uncond_context": torch.zeros_like(b["prompt_embeds"])}
            shape = tuple(batch["latents"].shape)
            scalars["load_s"] = batches.load_s
        if args.objective == "teacher_forcing":
            draws = tdiff.draw_teacher_forcing(
                draw_gen, shape, args.num_frame_per_block,
                len(sch.timesteps), args.noise_aug_max, device)
        else:
            draws = tdiff.draw_flow(draw_gen, shape,
                                    args.num_frame_per_block, device)
        t0 = time.time()
        loss = float(trainer.train_step(ranks.rows(batch), ranks.rows(draws)))
        ema.update(model)
        dt = time.time() - t0
        _log_step(metrics, step, f"step {step}: loss={loss:.5f}",
                  {"loss": loss, "step_s": dt, **scalars})
        ckpts.maybe_save(step + 1, train_state)
    if args.export_pt:
        ranks.export(args.export_pt, model, ema.shadow, cfg)


def _step_list(args):
    return tuple(int(s) for s in args.denoising_step_list.split(","))


@torch.no_grad()
def _context_kv(model, cfg, context):
    """The generator's per-layer text K/V, a constant of the step (the JAX
    trainer computes it outside the differentiated function)."""
    from .models import dit
    return dit.precompute_context_kv(model, cfg,
                                     dit.embed_text(model, context))


def _train_ode(args, cfg, model, lat_hw, device, metrics, ckpts, ranks):
    """ODE regression of the generator onto synthetic trajectories."""
    from .training import diffusion as tdiff
    from .training.distillation import (ode_regression_loss,
                                        prepare_ode_generator_input)

    F = args.num_frames
    sch = tdiff.make_scheduler(args.timestep_shift)
    steps = _step_list(args)
    model = ranks.shard(model.requires_grad_(True))
    opt = adamw(model.parameters(), args.lr, OPTAX_WEIGHT_DECAY)
    data_gen, draw_gen = _generators(device, args.seed)
    batches = None

    def train_state(step: int) -> dict:
        return {"models": {"generator": ckpts.model_state(model)},
                "opt_g": ckpts.optim_state(model, opt), "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state()},
                "data": batches.position if batches else 0}

    start_step, position = 0, 0
    if args.resume:
        st = ckpts.restore(train_state(0))
        ckpts.load_model(model, st["models"]["generator"])
        ckpts.load_optim(model, opt, st["opt_g"])
        data_gen.set_state(st["rng"]["data"].cpu())
        draw_gen.set_state(st["rng"]["draw"].cpu())
        start_step, position = int(st["step"]), int(st.get("data", 0))
    if args.data_dir:
        from .data.ode_gen import ODERegressionNpzDataset
        batches = _DataBatches(ODERegressionNpzDataset(args.data_dir), args,
                               device, ("ode_latent", "prompt_embeds"),
                               position)

    shape = (args.batch_size, len(steps) + 1, F, cfg.in_dim, *lat_hw)
    for step in range(start_step, args.steps):
        scalars = {}
        if batches is None:
            traj, ctx = ode_batch(data_gen, shape, cfg, device)
        else:
            b = batches.next()
            traj, ctx = b["ode_latent"], b["prompt_embeds"]
            batches.check("trajectory length", traj.shape[1],
                          len(steps) + 1, "--denoising-step-list (+ 1)")
            batches.check("latent frame count", traj.shape[2], F,
                          "--num-frames")
            scalars["load_s"] = batches.load_s
        draws = loss_draws(draw_gen, step, "ode")
        t0 = time.time()
        idx = draws.get("idx")
        if idx is None:
            idx = torch.randint(0, len(steps), (args.batch_size, F // 3),
                                generator=draws["generator"], device=device)
        traj, ctx, idx = (ranks.rows(x) for x in (traj, ctx,
                                                  idx.to(device)))
        noisy, t = prepare_ode_generator_input(traj, steps, idx)
        batch = {"noisy_input": noisy, "clean_latent": traj[:, -1],
                 "timestep": t, "ctx_kv": ranks.in_forward(
                     [model], _context_kv, model, cfg, ctx)}
        opt.zero_grad(set_to_none=True)
        loss, _ = ranks.in_forward(
            [model], lambda *a: ode_regression_loss(
                *a, remat_offload=args.remat_offload),
            model, cfg, sch, batch)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        dt = time.time() - t0
        _log_step(metrics, step, f"step {step}: loss={loss:.5f}",
                  {"loss": loss, "step_s": dt, **scalars})
        ckpts.maybe_save(step + 1, train_state)
    if args.export_pt:
        ranks.export(args.export_pt, model, dict(model.named_parameters()),
                     cfg)


def build_distillation(args, cfg, generator_model, device, vae=None,
                       dtype=torch.float32):
    """(models, Distiller, generator loss, critic loss, critic keys) of a
    distillation objective: the fake score (and the frozen real score, or
    the GAN head) from `--wan-dir` or seeded random weights."""
    from .models import dit
    from .training import diffusion as tdiff
    from .training.distillation import DistillationConfig, Distiller
    from .training.self_forcing import SelfForcingRollout
    from .utils import checkpoint as ckpt

    F = args.num_frames
    max_F = args.num_training_frames or F
    nb = args.num_frame_per_block
    off = 1 if args.independent_first_frame else 0
    if not (max_F >= F and (max_F - off) % nb == 0
            and (F - off) % nb == 0):
        raise ValueError(f"rollout lengths {F}..{max_F} are not whole "
                         f"blocks of {nb} (+{off})")
    sch = tdiff.make_scheduler(args.timestep_shift)
    ro = SelfForcingRollout(
        cfg, sch, denoising_step_list=_step_list(args),
        context_noise=args.context_noise, num_frame_per_block=nb,
        same_step_across_blocks=bool(args.same_step_across_blocks),
        last_step_only=args.last_step_only, num_max_frames=F,
        grad_frame_window=F, rolling=args.rolling,
        remat_offload=args.remat_offload,
        warp_denoising_step=args.warp_denoising_step,
        independent_first_frame=args.independent_first_frame, dtype=dtype)
    dist = Distiller(cfg, DistillationConfig(
        timestep_shift=args.timestep_shift,
        real_guidance_scale=args.real_guidance_scale,
        fake_guidance_scale=args.fake_guidance_scale,
        ts_schedule=bool(args.ts_schedule),
        window_frames=F if max_F > F else None,
        remat_offload=args.remat_offload, dtype=dtype), ro, sch,
        vae=vae)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    if args.wan_dir:
        score = lambda: ckpt.load_wan_dit(args.wan_dir, cfg, torch.float32,
                                          device)
        print(f"scores <- {args.wan_dir}", file=sys.stderr)
    else:
        score = None
    models = {"generator": generator_model,
              "fake_score": score() if score else dit.init_dit_params(
                  cfg, gen(args.seed + 10), torch.float32, device)}
    if args.objective == "gan":
        from .training.gan import init_gan_head_params
        models["gan_head"] = init_gan_head_params(
            gen(args.seed + 12), atten_dim=cfg.dim, ffn_dim=cfg.ffn_dim,
            device=device).requires_grad_(False)
        return (models, dist, dist.gan_generator_loss, dist.gan_critic_loss,
                ("fake_score", "gan_head"))
    models["real_score"] = score() if score else dit.init_dit_params(
        cfg, gen(args.seed + 11), torch.float32, device)
    return (models, dist, getattr(dist, f"{args.objective}_generator_loss"),
            dist.critic_loss, ("fake_score",))


def train_step(models, keys, loss_fn, opt, batch, draws, ranks=None):
    """One AdamW step of the modules `keys` on loss_fn(models, batch,
    draws); only they require gradients during it.  Returns the loss.
    ranks: the `--mesh` (`_Ranks`), whose sharded models' forwards the
    loss runs in."""
    for name, m in models.items():
        m.requires_grad_(name in keys)
    opt.zero_grad(set_to_none=True)
    try:
        if ranks is None:
            loss, _ = loss_fn(models, batch, draws)
        else:
            roots = [m for m in models.values() if isinstance(m, WanDiT)]
            loss, _ = ranks.in_forward(roots, loss_fn, models, batch, draws)
        loss.backward()
        if ranks is not None:
            ranks.sync_grads([models[k] for k in keys
                              if not isinstance(models[k], WanDiT)])
        opt.step()
    finally:
        for m in models.values():
            m.requires_grad_(False)
    return loss.detach()


def _train_distill(args, cfg, model, lat_hw, device, metrics, ckpts,
                   ranks):
    """dmd / sid / causvid / gan: the critic every step, the generator
    every --dfake-gen-update-ratio-th.  Under a dp mesh each dp rank draws
    the losses' noise from its own stream (seed + 1 + 1000 x dp rank)."""
    from .training.self_forcing import sample_num_frames
    from .utils.ema import EmaParams

    vae = None
    if args.vae_path:
        from .utils import checkpoint as ckpt
        vae = ckpt.load_vae(args.vae_path, device=device)
        print(f"vae <- {args.vae_path}", file=sys.stderr)
    model.requires_grad_(False)
    models, dist, gen_loss, critic_loss, critic_keys = build_distillation(
        args, cfg, model, device, vae)
    models = {k: ranks.shard(m) if isinstance(m, WanDiT) else m
              for k, m in models.items()}
    F = args.num_frames
    max_F = args.num_training_frames or F
    nb = args.num_frame_per_block
    iff = args.independent_first_frame
    lr_c = args.lr_critic if args.lr_critic is not None else args.lr
    opt_g = adamw(models["generator"].parameters(), args.lr,
                  OPTAX_WEIGHT_DECAY, offload=args.offload_opt)
    opt_c = adamw([p for k in critic_keys for p in models[k].parameters()],
                  lr_c, OPTAX_WEIGHT_DECAY, offload=args.offload_opt)
    ema = EmaParams(models["generator"], decay=args.ema_decay,
                    offload=args.offload_opt)
    if args.offload_opt and ranks.rank0:
        print("optimizer moments + EMA shadow: host memory (pinned on a "
              "card; streamed a parameter at a time)", file=sys.stderr)
    data_gen, draw_gen = _generators(device, args.seed)
    if ranks.dp > 1:
        draw_gen.manual_seed(args.seed + 1 + 1000 * ranks.dp_rank)
    len_rng = np.random.default_rng(args.seed + 2)
    trained = ("generator",) + critic_keys

    critics = torch.nn.ModuleDict({k: models[k] for k in critic_keys})

    def train_state(step: int) -> dict:
        return {"models": {k: ckpts.model_state(models[k]) for k in trained},
                "opt_g": ckpts.optim_state(models["generator"], opt_g),
                "opt_c": ckpts.optim_state(critics, opt_c),
                "ema": ema.shadow, "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state(),
                        "length": len_rng.bit_generator.state}}

    start_step = 0
    if args.resume:
        st = ckpts.restore(train_state(0))
        for k in trained:
            ckpts.load_model(models[k], st["models"][k])
        ckpts.load_optim(models["generator"], opt_g, st["opt_g"])
        ckpts.load_optim(critics, opt_c, st["opt_c"])
        ema.load(st["ema"])
        data_gen.set_state(st["rng"]["data"].cpu())
        draw_gen.set_state(st["rng"]["draw"].cpu())
        len_rng.bit_generator.state = st["rng"]["length"]
        start_step = int(st["step"])

    for step in range(start_step, args.steps):
        F_roll = sample_num_frames(len_rng, F, max_F, nb, iff) \
            if max_F > F else F
        batch = distill_batch(
            data_gen, (args.batch_size, F_roll, cfg.in_dim, *lat_hw), cfg,
            device, real_shape=((args.batch_size, F, cfg.in_dim, *lat_hw)
                                if args.objective == "gan" else None))
        batch = ranks.rows(batch)
        batch["ctx_kv"] = ranks.in_forward(
            [models["generator"]], _context_kv, models["generator"], cfg,
            batch["context"])
        t0 = time.time()
        closs = float(train_step(models, critic_keys, critic_loss, opt_c,
                                 batch, loss_draws(draw_gen, step, "critic"),
                                 ranks))
        line = f"step {step}: critic={closs:.5f}"
        scalars = {"critic_loss": closs}
        if (step + 1) % args.dfake_gen_update_ratio == 0:
            gloss = float(train_step(models, ("generator",), gen_loss, opt_g,
                                     batch, loss_draws(draw_gen, step,
                                                       "generator"), ranks))
            if step >= args.ema_start_step:
                ema.update(models["generator"])
            line += f" gen={gloss:.5f}"
            scalars["gen_loss"] = gloss
        scalars["step_s"] = time.time() - t0
        _log_step(metrics, step, line, scalars)
        ckpts.maybe_save(step + 1, train_state)
    if args.export_pt:
        ranks.export(args.export_pt, models["generator"], ema.shadow, cfg)


if __name__ == "__main__":
    sys.exit(main())
