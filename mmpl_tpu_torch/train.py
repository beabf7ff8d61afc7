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

    python -m mmpl_tpu_torch.train --smoke --steps 3
    python -m mmpl_tpu_torch.train --generator-ckpt mmpl_t2v_1.3B.pt
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

#: flags that belong to later slices of the port (ROADMAP.md, Queue 1)
LATER_SLICES = {
    "data_dir": "Slice I (data)",
    "resume": "Slice H (checkpoints and resume)",
    "export_pt": "Slice H (checkpoints and resume)",
    "ckpt_dir": "Slice H (checkpoints and resume)",
    "config": "Slice H (run configs)",
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
    p.add_argument("--ckpt-every", type=int, default=500,
                   help="checkpoints are not ported yet: a run that would "
                        "write one (ckpt-every <= steps) is refused")
    # flags of later slices: parsed so that they can be refused by name
    for flag in ("--data-dir", "--resume", "--export-pt", "--ckpt-dir",
                 "--config", "--mesh"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--remat-offload", "--offload-opt"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.objective in LATER_OBJECTIVES:
        p.error(f"--objective {args.objective} is not ported yet: "
                f"ROADMAP.md {LATER_OBJECTIVES[args.objective]}")
    for dest, where in LATER_SLICES.items():
        if getattr(args, dest):
            p.error(f"--{dest.replace('_', '-')} is not ported: "
                    f"ROADMAP.md {where}")
    if args.ckpt_every and args.ckpt_every <= args.steps:
        p.error(f"--ckpt-every {args.ckpt_every} <= --steps {args.steps} "
                f"would write a checkpoint, not ported yet: ROADMAP.md "
                f"Slice H (checkpoints and resume)")
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
    shape = (args.batch_size, F, cfg.in_dim, *lat_hw)
    for step in range(args.steps):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
