"""CLI entry point: rolling long-video T2V generation with the planned-window
(FPS) pipeline.

Port of `mmpl_tpu/cli.py` for the 50-step serving path.  `--duration`
windows are generated in turn; each window after the first is seeded by
re-encoding the previous window's last 5 pixel frames into 2 context
latents, and its first 5 pixel frames (the overlap) are trimmed.  Without a
checkpoint it runs random weights and random text embeddings ("smoke" is
the tiny config at 64x64).

    python -m mmpl_tpu_torch.cli --model smoke --duration 2 --sampling-steps 4

`--quantize int8|int8wo|auto`, `--quantize-cache` and `--quantize-vae` run
the int8 projections, the int8 KV cache and the int8 VAE decoder.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

#: flags that belong to later slices of the port (ROADMAP.md, Queue 1)
LATER_SLICES = {
    "checkpoint_path": "Slice A item 10 (checkpoint ingestion)",
    "wan_dir": "Slice A item 10 (checkpoint ingestion)",
    "use_ema": "Slice A item 10 (checkpoint ingestion)",
    "image": "Slice D (i2v)",
    "mesh": "Slice F (multi-device)",
    "preview": "Slice C (few-step production path)",
    "taehv_path": "Slice C (few-step production path)",
    "profile": "Slice C (few-step production path)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mmpl_tpu_torch video generation")
    p.add_argument("--config", default=None, help="run-config yaml")
    p.add_argument("--model", default="t2v-1.3B",
                   choices=["t2v-14B", "t2v-1.3B", "smoke"],
                   help="model config ('smoke' = tiny random-weight)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--prompt", default="a cat surfing a wave at sunset",
                   help="unused until the text encoder is ported: random "
                        "text embeddings stand in")
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--duration", type=int, default=1,
                   help="number of 21-frame windows (~5s each)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--sampling-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--timestep-shift", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--save-latents", default=None)
    p.add_argument("--quantize", default=None,
                   choices=["int8", "int8wo", "auto"],
                   help="int8 block projections (ops/quant.py): int8 = W8A8 "
                        "through the int8 kernel, int8wo = weight-only W8A16, "
                        "auto = W8A8 or W8A16 per projection from a probe of "
                        "the loaded weights")
    p.add_argument("--quantize-cache", action="store_true",
                   help="int8 KV cache with per-token scales (half the "
                        "bytes of the window's largest resident)")
    p.add_argument("--quantize-vae", action="store_true",
                   help="int8 W8A8 VAE decoder convs "
                        "(models/vae.quantize_vae_decoder)")
    # flags of later slices: parsed so that they can be refused by name
    for flag in ("--checkpoint-path", "--wan-dir", "--image", "--mesh",
                 "--preview", "--taehv-path"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--use-ema", "--profile"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for dest, where in LATER_SLICES.items():
        if getattr(args, dest):
            p.error(f"--{dest.replace('_', '-')} is not ported yet: "
                    f"ROADMAP.md {where}")
    return args, p


def random_text_context(cfg, device: torch.device):
    """Random cond/uncond text-encoder states [1, text_len, text_dim]."""
    out = []
    for seed in (2, 3):
        g = torch.Generator(device=device).manual_seed(seed)
        out.append(torch.randn((1, cfg.text_len, cfg.text_dim), generator=g,
                               device=device))
    return out


def run_windows(pipe, vae_model, cond: torch.Tensor, uncond: torch.Tensor,
                duration: int, lat_hw, generator: torch.Generator,
                on_window: Optional[Callable[..., None]] = None
                ) -> np.ndarray:
    """Generate `duration` bridged windows; returns uint8 [B, T, H, W, 3]
    with T = 81 + 76 * (duration - 1).

    on_window(win, latents, frames, seconds) is called after each window
    (frames before the overlap trim; seconds = denoise + decode + bridge,
    synchronised)."""
    from .models import vae
    device = cond.device
    lat_h, lat_w = lat_hw
    initial_latent = None
    videos = []
    for win in range(duration):
        noise = torch.randn((1, 21, 16, lat_h, lat_w), generator=generator,
                            device=device)
        t0 = time.perf_counter()
        latents = pipe.inference(noise, cond, uncond,
                                 initial_latent=initial_latent,
                                 generator=generator)
        frames_u8, tail = vae.decode_to_frames(vae_model, latents)
        if win + 1 < duration:
            # rolling bridge: the last 5 pixel frames -> 2 context latents
            initial_latent = vae.encode(vae_model, tail)[:, :2]
        frames = frames_u8.cpu().numpy()
        seconds = time.perf_counter() - t0
        print(f"window {win}: {seconds:.1f}s", file=sys.stderr)
        if on_window is not None:
            on_window(win, latents, frames, seconds)
        # trim the bridged overlap: (2-1)*4+1 = 5 pixel frames
        videos.append(frames if win == 0 else frames[:, 5:])
    return np.concatenate(videos, axis=1)


def main(argv=None) -> int:
    args, parser = parse_args(argv)
    if args.duration < 1:
        print("error: --duration must be >= 1", file=sys.stderr)
        return 2
    from .core.config import WAN_CONFIGS, load_config, tiny_test_config
    from .models import dit, vae
    from .pipelines.fps_inference import CausalFPSInferencePipeline
    from .utils.device import resolve_device, set_float32_precision

    if args.config:
        default = os.path.join(os.path.dirname(args.config),
                               "default_config.yaml")
        run_cfg = load_config(args.config,
                              default if os.path.exists(default) else None)
        if run_cfg.get("denoising_step_list"):
            parser.error("a config with denoising_step_list selects the "
                         "few-step pipeline, not ported yet: ROADMAP.md "
                         "Slice C (few-step production path)")
        if args.model != "smoke":
            args.model = run_cfg.get("model_name", args.model)
        args.timestep_shift = run_cfg.get("timestep_shift",
                                          args.timestep_shift)
        args.guidance_scale = run_cfg.get("guidance_scale",
                                          args.guidance_scale)

    device = resolve_device(args.device)
    set_float32_precision()
    smoke = args.model == "smoke"
    if smoke:
        cfg = tiny_test_config()
        H = W = 64
    else:
        cfg = WAN_CONFIGS[args.model]
        H, W = args.height, args.width

    t0 = time.time()
    print(f"[random weights] config={cfg.name} device={device}",
          file=sys.stderr)
    model = dit.init_dit_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        torch.bfloat16, device)
    vae_model = vae.init_vae_params(
        torch.Generator(device=device).manual_seed(1), torch.float32, device)
    if args.quantize_vae:
        vae.quantize_vae_decoder(vae_model)
    cond, uncond = random_text_context(cfg, device)
    print(f"model init: {time.time() - t0:.1f}s", file=sys.stderr)

    # smoke runs fp32 activations over bf16 weights; real widths run bf16
    pipe = CausalFPSInferencePipeline(
        cfg, model, sampling_steps=args.sampling_steps,
        timestep_shift=args.timestep_shift,
        guidance_scale=args.guidance_scale, quantize=args.quantize,
        quantize_cache=args.quantize_cache,
        dtype=torch.float32 if smoke else torch.bfloat16)

    all_latents = []
    on_window = None
    if args.save_latents:
        def on_window(win, latents, frames, seconds):
            all_latents.append(latents.float().cpu().numpy())

    gen = torch.Generator(device=device).manual_seed(args.seed + 100)
    full = run_windows(pipe, vae_model, cond, uncond, args.duration,
                       (H // 8, W // 8), gen, on_window)
    if args.save_latents:
        np.save(args.save_latents, np.stack(all_latents, axis=1))
    frames = full[0]
    from .utils.video_io import write_video
    path = write_video(args.output, frames, fps=16)
    print(f"wrote {path}: {frames.shape[0]} frames "
          f"{frames.shape[2]}x{frames.shape[1]} @16fps", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
