"""Training entry point: teacher forcing, the flow objective, self-forcing
distillation (DMD, SiD, CausVid, GAN) and ODE regression.

Port of `train.py:main` on one device.  Random weights and synthetic
batches drawn from `torch.Generator`s seeded from `--seed`; one JSON line
per step in `<log-dir>/<run-name>/metrics.jsonl`.  Smoke mode is the tiny
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
  * ode: regression of the generator onto synthetic ODE trajectories.

Checkpoints (`utils/train_state_io.py`): with `--ckpt-dir`, every
`--ckpt-every` steps the fp32 masters of every trained model, the AdamW
state(s), the EMA shadow, the step and the states of the trainer's
generators go to `<ckpt-dir>/step<N>`; `--resume <ckpt-dir>/step<N>`
restores them and runs steps N..`--steps`-1, drawing what an unbroken run
would, bit for bit.  `--export-pt` writes the generator and its EMA as the
upstream `.pt` at the end.  `--config` merges a run config
(`configs/*.yaml`) over the flag defaults as the JAX trainer does; flags
given on the command line win.  `--mesh dp=A,fsdp=B` (one process per
card under torchrun, or `--coordinator` / `--num-processes` /
`--process-id`) FSDP-shards every model over fsdp, replicated over dp,
and splits the batch over dp (`_Ranks`); `--export-pt` gathers the full
tensors to rank 0, `--ckpt-dir` / `--resume` are not ported.
Refused by name: `--data-dir` (Slice I) and the two 16 GB TPU workarounds
`--remat-offload` and `--offload-opt`.

    python -m mmpl_tpu_torch.train --smoke --steps 3
    python -m mmpl_tpu_torch.train --smoke --objective flow --steps 3
    python -m mmpl_tpu_torch.train --config configs/self_forcing_dmd.yaml \
        --generator-ckpt ode_init.pt --wan-dir Wan2.1-T2V-1.3B \
        --ckpt-dir ckpt --export-pt mmpl_dmd_1.3B.pt
    python -m mmpl_tpu_torch.train --generator-ckpt mmpl_t2v_1.3B.pt
    python -m mmpl_tpu_torch.train --steps 1000 --ckpt-dir ckpt \
        --resume ckpt/step500 --export-pt mmpl_t2v_1.3B.pt
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .models.dit import WanDiT

#: flags that are not ported (ROADMAP.md)
REFUSED = {
    "data_dir": "Slice I (data)",
    "remat_offload": "a 16 GB TPU workaround the H100 needs not "
                     "(ROADMAP.md North star)",
    "offload_opt": "a 16 GB TPU workaround the H100 needs not "
                   "(ROADMAP.md North star)",
}
OBJECTIVES = ("teacher_forcing", "flow", "dmd", "sid", "gan", "causvid",
              "ode")


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
                   help="multi-process mesh 'dp=A,fsdp=B' (sizes multiply "
                        "to the processes): every model FSDP-sharded over "
                        "fsdp (HSDP, replicated over dp), the batch over "
                        "dp; one process per card under torchrun, or "
                        "--coordinator / --num-processes / --process-id")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous host:port "
                        "(torch.distributed; parallel/mesh.py)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    # flags that are not ported: parsed so that they can be refused by name
    p.add_argument("--data-dir", default=None, help=argparse.SUPPRESS)
    for flag in ("--remat-offload", "--offload-opt"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    args = apply_run_config(p.parse_args(argv), argv)
    if args.objective not in OBJECTIVES:
        p.error(f"--config selects objective {args.objective!r}, which "
                f"neither package trains")
    for dest, why in REFUSED.items():
        if getattr(args, dest):
            p.error(f"--{dest.replace('_', '-')} is not ported: {why}")
    if args.mesh:
        for dest in ("ckpt_dir", "resume"):
            if getattr(args, dest):
                p.error(f"--{dest.replace('_', '-')} with --mesh is not "
                        f"ported: sharded checkpoints (ROADMAP.md Queue 1)")
    return args


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


def adamw(params, lr: float, weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


#: optax.adamw's default weight decay, which the JAX trainer's
#: distillation and ODE optimisers take
OPTAX_WEIGHT_DECAY = 1e-4


def _generators(device, seed):
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    return gen(seed), gen(seed + 1)


def _log_step(metrics, step, line, scalars):
    metrics.log(step, **scalars)
    print(line + f" ({scalars['step_s']:.2f}s)", file=sys.stderr,
          flush=True)


class _Checkpoints:
    """`--ckpt-dir` / `--resume` around a state function."""

    def __init__(self, args, metrics, device):
        self.args, self.metrics, self.device = args, metrics, device

    def restore(self, template: dict):
        from .utils import train_state_io as tsio
        t0 = time.time()
        st = tsio.restore_checkpoint(self.args.resume, template,
                                     map_location=self.device)
        dt = time.time() - t0
        self.metrics.log(int(st["step"]), resumed_from=self.args.resume,
                         restore_s=dt)
        print(f"resumed at step {int(st['step'])} <- {self.args.resume} "
              f"({dt:.2f}s)", file=sys.stderr)
        return st

    def maybe_save(self, step: int, state_fn) -> None:
        from .utils import train_state_io as tsio
        a = self.args
        if not (a.ckpt_dir and a.ckpt_every and step % a.ckpt_every == 0):
            return
        path = os.path.join(a.ckpt_dir, f"step{step}")
        t0 = time.time()
        nbytes = tsio.save_checkpoint(path, state_fn(step))
        dt = time.time() - t0
        self.metrics.log(step, ckpt=path, ckpt_bytes=nbytes, save_s=dt)
        print(f"saved {path} ({nbytes} bytes, {dt:.2f}s)", file=sys.stderr)


class _Ranks:
    """The trainer's `--mesh` (JAX `train.py`'s (dp, fsdp) mesh): every
    model FSDP-sharded (`parallel/mesh.shard_for_training`), each process
    on its dp rows of the batch, the losses run inside the models'
    forwards (whose hooks gather the parameters), the gradients of
    unsharded modules (the GAN head) averaged over dp.  Without `--mesh`
    every method leaves its input as it is."""

    def __init__(self, args):
        self.mesh, self.dp, self.dp_rank, self.rank0 = None, 1, 0, True
        self.batch = args.batch_size
        if not args.mesh:
            return
        import torch.distributed as dist
        from .parallel.mesh import init_distributed, make_mesh
        shape = {k: int(v) for k, v in
                 (kv.split("=") for kv in args.mesh.split(","))}
        if set(shape) - {"dp", "fsdp", "tp"} or shape.get("tp", 1) > 1:
            raise SystemExit(f"--mesh {args.mesh}: the trainer shards over "
                             f"dp and fsdp (tp in training is not ported)")
        if not init_distributed(args.coordinator, args.num_processes,
                                args.process_id):
            raise SystemExit("--mesh needs a process group: run under "
                             "torchrun, or give --coordinator, "
                             "--num-processes and --process-id")
        self.dp = shape.get("dp", 1)
        if self.batch % self.dp:
            raise SystemExit(f"--batch-size {self.batch} does not split "
                             f"over dp = {self.dp}")
        self.mesh = make_mesh({"dp": self.dp, "fsdp": shape.get("fsdp", 1)})
        self.dp_rank = self.mesh.get_local_rank("dp")
        self.rank0 = dist.get_rank() == 0
        dims = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        print(f"mesh: {dims} (process {dist.get_rank()}/"
              f"{dist.get_world_size()})", file=sys.stderr)

    def shard(self, model):
        if self.mesh is None:
            return model
        from .parallel.mesh import shard_for_training
        return shard_for_training(model, self.mesh)

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

    def export(self, path: str, model, ema_shadow, cfg) -> None:
        """`--export-pt`: the generator (and its EMA) as the upstream
        `.pt`; under the mesh every rank gathers the full tensors
        (`DTensor.full_tensor`, a collective) and rank 0 writes."""
        from .utils import train_state_io as tsio
        params = dict(model.named_parameters())
        if self.mesh is not None:
            full = lambda d: {n: t.full_tensor() for n, t in d.items()}
            params = full(params)
            ema_shadow = None if ema_shadow is None else full(ema_shadow)
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


def _restore_ema(ema, saved) -> None:
    with torch.no_grad():
        for name, s in ema.shadow.items():
            s.copy_(saved[name])


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
    metrics = MetricsLogger(args.log_dir, args.run_name, config=vars(args)) \
        if ranks.rank0 else _NoMetrics()
    ckpts = _Checkpoints(args, metrics, device)
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
            noise_aug_max_timestep=args.noise_aug_max)
    else:
        loss_fn = tdiff.make_loss_fn(cfg, sch)
    trainer = tdiff.DiffusionTrainer(ranks.shard(model), loss_fn,
                                     learning_rate=args.lr)
    ema = EmaParams(model, decay=args.ema_decay)
    data_gen, draw_gen = _generators(device, args.seed)

    def train_state(step: int) -> dict:
        return {"model": model.state_dict(),
                "optimizer": trainer.opt.state_dict(),
                "ema": ema.shadow, "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state()}}

    start_step = 0
    if args.resume:
        st = ckpts.restore(train_state(0))
        model.load_state_dict(st["model"])
        trainer.opt.load_state_dict(st["optimizer"])
        _restore_ema(ema, st["ema"])
        data_gen.set_state(st["rng"]["data"].cpu())
        draw_gen.set_state(st["rng"]["draw"].cpu())
        start_step = int(st["step"])

    shape = (args.batch_size, F, cfg.in_dim, *lat_hw)
    for step in range(start_step, args.steps):
        batch = synthetic_batch(data_gen, shape, cfg, device)
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
                  {"loss": loss, "step_s": dt})
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

    def train_state(step: int) -> dict:
        return {"models": {"generator": model.state_dict()},
                "opt_g": opt.state_dict(), "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state()}}

    start_step = 0
    if args.resume:
        st = ckpts.restore(train_state(0))
        model.load_state_dict(st["models"]["generator"])
        opt.load_state_dict(st["opt_g"])
        data_gen.set_state(st["rng"]["data"].cpu())
        draw_gen.set_state(st["rng"]["draw"].cpu())
        start_step = int(st["step"])

    shape = (args.batch_size, len(steps) + 1, F, cfg.in_dim, *lat_hw)
    for step in range(start_step, args.steps):
        traj, ctx = ode_batch(data_gen, shape, cfg, device)
        draws = loss_draws(draw_gen, step, "ode")
        t0 = time.time()
        idx = draws.get("idx")
        if idx is None:
            idx = torch.randint(0, len(steps), (shape[0], F // 3),
                                generator=draws["generator"], device=device)
        traj, ctx, idx = (ranks.rows(x) for x in (traj, ctx,
                                                  idx.to(device)))
        noisy, t = prepare_ode_generator_input(traj, steps, idx)
        batch = {"noisy_input": noisy, "clean_latent": traj[:, -1],
                 "timestep": t, "ctx_kv": ranks.in_forward(
                     [model], _context_kv, model, cfg, ctx)}
        opt.zero_grad(set_to_none=True)
        loss, _ = ranks.in_forward([model], ode_regression_loss, model, cfg,
                                   sch, batch)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        dt = time.time() - t0
        _log_step(metrics, step, f"step {step}: loss={loss:.5f}",
                  {"loss": loss, "step_s": dt})
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
        warp_denoising_step=args.warp_denoising_step,
        independent_first_frame=args.independent_first_frame, dtype=dtype)
    dist = Distiller(cfg, DistillationConfig(
        timestep_shift=args.timestep_shift,
        real_guidance_scale=args.real_guidance_scale,
        fake_guidance_scale=args.fake_guidance_scale,
        ts_schedule=bool(args.ts_schedule),
        window_frames=F if max_F > F else None, dtype=dtype), ro, sch,
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
                  OPTAX_WEIGHT_DECAY)
    opt_c = adamw([p for k in critic_keys for p in models[k].parameters()],
                  lr_c, OPTAX_WEIGHT_DECAY)
    ema = EmaParams(models["generator"], decay=args.ema_decay)
    data_gen, draw_gen = _generators(device, args.seed)
    if ranks.dp > 1:
        draw_gen.manual_seed(args.seed + 1 + 1000 * ranks.dp_rank)
    len_rng = np.random.default_rng(args.seed + 2)
    trained = ("generator",) + critic_keys

    def train_state(step: int) -> dict:
        return {"models": {k: models[k].state_dict() for k in trained},
                "opt_g": opt_g.state_dict(), "opt_c": opt_c.state_dict(),
                "ema": ema.shadow, "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state(),
                        "length": len_rng.bit_generator.state}}

    start_step = 0
    if args.resume:
        st = ckpts.restore(train_state(0))
        for k in trained:
            models[k].load_state_dict(st["models"][k])
        opt_g.load_state_dict(st["opt_g"])
        opt_c.load_state_dict(st["opt_c"])
        _restore_ema(ema, st["ema"])
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
