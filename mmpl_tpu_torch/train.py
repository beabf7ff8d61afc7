"""Training entry point: teacher forcing (CausalDiffusion) with the
fps-forcing mask, the objective that produced the released checkpoints.

Port of the `teacher_forcing` branch of `train.py:main`.  Random weights
and synthetic batches drawn from `torch.Generator`s seeded from `--seed`;
a bf16 trunk over fp32 masters, AdamW, EMA, and one JSON line per step in
`<log-dir>/<run-name>/metrics.jsonl`.  Smoke mode is the tiny config at
4x4 latents; otherwise `t2v-1.3B` at 60x104 (480x832 pixels).  The
generator starts, in this order, from an MMPL fine-tune `.pt`
(`--generator-ckpt`), the base Wan weights (`--wan-dir`: a directory of
safetensors shards or one state dict file), or random weights; the fp32
masters take the file's values, widened where the file holds bf16.

Checkpoints (`utils/train_state_io.py`): with `--ckpt-dir`, every
`--ckpt-every` steps the masters, AdamW state, EMA shadow, step and the
states of the two generators (batches, per-step draws) go to
`<ckpt-dir>/step<N>`; `--resume <ckpt-dir>/step<N>` restores them and runs
steps N..`--steps`-1.  The generators' saved states, not a replay of the
draws, make a resumed run draw what an unbroken run would, bit for bit.
`--export-pt` writes the generator and its EMA as the upstream `.pt` at
the end.  `--config` merges a run config (`configs/*.yaml`) over the flag
defaults as the JAX trainer does (`apply_run_config`); flags given on the
command line win, and a config whose `trainer` selects an objective of a
later slice is refused by name.

    python -m mmpl_tpu_torch.train --smoke --steps 3
    python -m mmpl_tpu_torch.train --generator-ckpt mmpl_t2v_1.3B.pt
    python -m mmpl_tpu_torch.train --steps 1000 --ckpt-dir ckpt
    python -m mmpl_tpu_torch.train --steps 1000 --ckpt-dir ckpt \
        --resume ckpt/step500 --export-pt mmpl_t2v_1.3B.pt
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

#: flags that belong to later slices of the port (ROADMAP.md, Queue 1)
LATER_SLICES = {
    "data_dir": "Slice I (data)",
    "mesh": "Slice F (multi-device)",
    "remat_offload": "Slice H (a 16 GB TPU workaround the H100 needs not)",
    "offload_opt": "Slice H (a 16 GB TPU workaround the H100 needs not)",
}
#: objectives of later slices
LATER_OBJECTIVES = {
    "flow": "Slice E (bidirectional dit_forward)",
    "dmd": "Slice H (self-forcing distillation)",
    "sid": "Slice H (self-forcing distillation)",
    "gan": "Slice H (self-forcing distillation)",
    "causvid": "Slice H (self-forcing distillation)",
    "ode": "Slice H (ODE regression)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mmpl_tpu_torch training")
    p.add_argument("--objective", default="teacher_forcing",
                   choices=["teacher_forcing", *LATER_OBJECTIVES])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--smoke", action="store_true",
                   help="tiny model + synthetic data")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--timestep-shift", type=float, default=8.0)
    p.add_argument("--num-frames", type=int, default=21)
    p.add_argument("--num-frame-per-block", type=int, default=3)
    p.add_argument("--noise-aug-max", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", default="runs",
                   help="JSONL metrics directory (utils/metrics.py)")
    p.add_argument("--run-name", default=None)
    p.add_argument("--generator-ckpt", default=None,
                   help="MMPL generator .pt to start from")
    p.add_argument("--wan-dir", default=None,
                   help="base Wan DiT weights to start from (without "
                        "--generator-ckpt)")
    p.add_argument("--ckpt-dir", default=None,
                   help="write <ckpt-dir>/step<N> every --ckpt-every steps")
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--resume", default=None,
                   help="a <ckpt-dir>/step<N> to resume the models, "
                        "optimizer, EMA, step and generators from")
    p.add_argument("--export-pt", default=None,
                   help="at the end, write the generator and its EMA as "
                        "the upstream .pt ({'generator', 'generator_ema'})")
    p.add_argument("--config", default=None,
                   help="YAML run config (configs/*.yaml) merged over the "
                        "flag defaults; flags given explicitly win")
    # flags of later slices: parsed so that they can be refused by name
    for flag in ("--data-dir", "--mesh"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--remat-offload", "--offload-opt"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    objective = args.objective
    args = apply_run_config(args, argv)
    if args.objective in LATER_OBJECTIVES:
        where = " (from --config)" if args.objective != objective else ""
        p.error(f"--objective {args.objective}{where} is not ported yet: "
                f"ROADMAP.md {LATER_OBJECTIVES[args.objective]}")
    if args.objective != "teacher_forcing":
        p.error(f"--config selects objective {args.objective!r}, which "
                f"neither package trains")
    for dest, where in LATER_SLICES.items():
        if getattr(args, dest):
            p.error(f"--{dest.replace('_', '-')} is not ported: "
                    f"ROADMAP.md {where}")
    return args


#: YAML key -> (CLI flag, args attribute, cast): the keys of the JAX
#: trainer's `_CONFIG_KEYS` (train.py:146-174) whose flags this trainer
#: has.  The others (the distillation knobs) are Slice H's rest and are
#: not read; `trainer` / `distribution_loss` -> --objective is handled
#: separately.
_CONFIG_KEYS = {
    "timestep_shift": ("--timestep-shift", "timestep_shift", float),
    "lr": ("--lr", "lr", float),
    "seed": ("--seed", "seed", int),
    "batch_size": ("--batch-size", "batch_size", int),
    "ema_weight": ("--ema-decay", "ema_decay", float),
    "num_frame_per_block": ("--num-frame-per-block",
                            "num_frame_per_block", int),
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


def main(argv=None) -> int:
    args = parse_args(argv)
    from .core.config import WAN_CONFIGS, tiny_test_config
    from .core.geometry import T2V_CLEAN_STEPS
    from .training import masks
    from .training.diffusion import (DiffusionTrainer, draw_teacher_forcing,
                                     make_scheduler,
                                     make_teacher_forcing_loss_fn)
    from .utils import train_state_io as tsio
    from .utils.device import resolve_device, set_float32_precision
    from .utils.ema import EmaParams
    from .utils.metrics import MetricsLogger

    device = resolve_device(args.device)
    set_float32_precision()
    cfg = tiny_test_config() if args.smoke else WAN_CONFIGS["t2v-1.3B"]
    F = args.num_frames
    lat_hw = (4, 4) if args.smoke else (60, 104)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)

    model = load_generator(args, cfg, gen(args.seed), device)
    metrics = MetricsLogger(args.log_dir, args.run_name, config=vars(args))
    sch = make_scheduler(args.timestep_shift)
    fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:F])
    loss_fn = make_teacher_forcing_loss_fn(
        cfg, sch, fm, num_frame_per_block=args.num_frame_per_block,
        noise_aug_max_timestep=args.noise_aug_max)
    trainer = DiffusionTrainer(model, loss_fn, learning_rate=args.lr)
    ema = EmaParams(model, decay=args.ema_decay)

    data_gen, draw_gen = gen(args.seed), gen(args.seed + 1)

    def train_state(step: int) -> dict:
        return {"model": model.state_dict(),
                "optimizer": trainer.opt.state_dict(),
                "ema": ema.shadow, "step": step,
                "rng": {"data": data_gen.get_state(),
                        "draw": draw_gen.get_state()}}

    start_step = 0
    if args.resume:
        t0 = time.time()
        st = tsio.restore_checkpoint(args.resume, train_state(0),
                                     map_location=device)
        model.load_state_dict(st["model"])
        trainer.opt.load_state_dict(st["optimizer"])
        with torch.no_grad():
            for name, s in ema.shadow.items():
                s.copy_(st["ema"][name])
        data_gen.set_state(st["rng"]["data"].cpu())
        draw_gen.set_state(st["rng"]["draw"].cpu())
        start_step = int(st["step"])
        dt = time.time() - t0
        metrics.log(start_step, resumed_from=args.resume, restore_s=dt)
        print(f"resumed at step {start_step} <- {args.resume} "
              f"({dt:.2f}s)", file=sys.stderr)

    shape = (args.batch_size, F, cfg.in_dim, *lat_hw)
    for step in range(start_step, args.steps):
        batch = synthetic_batch(data_gen, shape, cfg, device)
        draws = draw_teacher_forcing(draw_gen, shape,
                                     args.num_frame_per_block,
                                     len(sch.timesteps), args.noise_aug_max,
                                     device)
        t0 = time.time()
        loss = float(trainer.train_step(batch, draws))
        ema.update(model)
        dt = time.time() - t0
        metrics.log(step, loss=loss, step_s=dt)
        print(f"step {step}: loss={loss:.5f} ({dt:.2f}s)", file=sys.stderr,
              flush=True)
        if args.ckpt_dir and args.ckpt_every \
                and (step + 1) % args.ckpt_every == 0:
            path = os.path.join(args.ckpt_dir, f"step{step + 1}")
            t0 = time.time()
            nbytes = tsio.save_checkpoint(path, train_state(step + 1))
            dt = time.time() - t0
            metrics.log(step + 1, ckpt=path, ckpt_bytes=nbytes, save_s=dt)
            print(f"saved {path} ({nbytes} bytes, {dt:.2f}s)",
                  file=sys.stderr)
    if args.export_pt:
        tsio.export_generator_pt(args.export_pt, model, ema.shadow, cfg)
        print(f"exported {args.export_pt}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
