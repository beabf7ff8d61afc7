"""CLI entry point: rolling long-video T2V generation.

Port of `mmpl_tpu/cli.py`.  `--duration` windows are generated in turn;
each window after the first is seeded by re-encoding the previous window's
last 5 pixel frames into 2 context latents, and its first 5 pixel frames
(the overlap) are trimmed.  Without a checkpoint it runs random weights and
random text embeddings ("smoke" is the tiny config at 64x64).

The pipeline follows the run config: one with a `denoising_step_list`
(`configs/self_forcing_dmd.yaml`) selects the few-step causal pipeline
(`pipelines/causal_inference.py`, no CFG), any other the 50-step
planned-window pipeline (`pipelines/fps_inference.py`).

    python -m mmpl_tpu_torch.cli --model smoke --duration 2 --sampling-steps 4
    python -m mmpl_tpu_torch.cli --config configs/self_forcing_dmd.yaml \
        --profile --preview preview.mp4

`--quantize int8|int8wo|auto`, `--quantize-cache` and `--quantize-vae` run
the int8 projections, the int8 KV cache and the int8 VAE decoder.
`--profile` prints the few-step pipeline's phase report per window (with
the planned-window pipeline it only times each window's phases);
`--preview` writes a TAEHV preview decoded block by block during the
few-step generation (`--taehv-path`: `taew2_1.pth`, else random weights).
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
    p.add_argument("--profile", action="store_true",
                   help="per-phase timing report (init / per-block "
                        "diffusion / VAE) of the few-step pipeline; with "
                        "the planned-window pipeline, each window's "
                        "denoise and decode seconds")
    p.add_argument("--preview", default=None, metavar="PATH",
                   help="write a fast TAEHV preview video, decoded block "
                        "by block during generation (few-step pipeline)")
    p.add_argument("--taehv-path", default=None,
                   help="taew2_1.pth weights for --preview (random "
                        "weights when absent)")
    # flags of later slices: parsed so that they can be refused by name
    for flag in ("--checkpoint-path", "--wan-dir", "--image", "--mesh"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    p.add_argument("--use-ema", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for dest, where in LATER_SLICES.items():
        if getattr(args, dest):
            p.error(f"--{dest.replace('_', '-')} is not ported yet: "
                    f"ROADMAP.md {where}")
    return args


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
                on_window: Optional[Callable[..., None]] = None,
                profile: bool = False,
                on_block: Optional[Callable[[int, torch.Tensor], None]]
                = None) -> np.ndarray:
    """Generate `duration` bridged windows; returns uint8 [B, T, H, W, 3].

    The planned-window pipeline denoises 21 latent frames per window:
    T = 81 + 76 * (duration - 1).  The few-step pipeline
    (`CausalInferencePipeline`) denoises the whole blocks that fit in 21
    latents after the context: 21 in the first window, 18 in a bridged
    one (3-frame blocks), where its 2 bridge latents make no whole block
    and are not committed, as in the JAX package: 69 frames, 64 after the
    trim, so T = 81 + 64 * (duration - 1).  `uncond` is unused there (no
    CFG).

    on_window(win, latents, frames, seconds) is called after each window
    (frames before the overlap trim; seconds = denoise + decode + bridge,
    synchronised).  profile: synchronise and print each window's denoise
    and decode seconds, and complete the few-step pipeline's phase report
    with "VAE decoding".  on_block: the few-step pipeline's per-block hook
    (the preview)."""
    from .models import vae
    from .pipelines.causal_inference import CausalInferencePipeline
    from .utils.profiling import sync
    few_step = isinstance(pipe, CausalInferencePipeline)
    device = cond.device
    lat_h, lat_w = lat_hw
    initial_latent = None
    videos = []
    for win in range(duration):
        noise = torch.randn((1, 21, 16, lat_h, lat_w), generator=generator,
                            device=device)
        t0 = time.perf_counter()
        if few_step:
            n_init = 0 if initial_latent is None else initial_latent.shape[1]
            nb = pipe.num_frame_per_block
            f_new = ((21 - n_init) // nb) * nb
            latents = pipe.inference(noise[:, :f_new], cond,
                                     initial_latent=initial_latent,
                                     generator=generator, profile=profile,
                                     on_block=on_block)
        else:
            latents = pipe.inference(noise, cond, uncond,
                                     initial_latent=initial_latent,
                                     generator=generator)
        if profile:
            sync(device)
            print(f"window {win}: denoise {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
        t1 = time.perf_counter()
        frames_u8, tail = vae.decode_to_frames(vae_model, latents)
        if profile:
            sync(device)
            decode_s = time.perf_counter() - t1
            print(f"window {win}: vae decode {decode_s:.1f}s",
                  file=sys.stderr)
            if few_step and pipe.last_profile is not None:
                pipe.last_profile.phases["VAE decoding"] = decode_s
                pipe.last_profile.report()
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


def few_step_pipeline(cfg, model, run_cfg, timestep_shift: float, **kw):
    """The few-step pipeline a run config with a `denoising_step_list`
    selects, with its block size, context noise, step warp and first-frame
    setting (the defaults of `configs/default_config.yaml` where it has
    none); `kw` goes to `CausalInferencePipeline`."""
    from .pipelines.causal_inference import CausalInferencePipeline
    return CausalInferencePipeline(
        cfg, model, denoising_step_list=run_cfg["denoising_step_list"],
        num_frame_per_block=int(run_cfg.get("num_frame_per_block", 3)),
        context_noise=int(run_cfg.get("context_noise", 0)),
        timestep_shift=timestep_shift,
        warp_denoising_step=bool(run_cfg.get("warp_denoising_step", False)),
        independent_first_frame=bool(run_cfg.get("independent_first_frame",
                                                 False)),
        **kw)


def make_preview_hook(taehv_path: Optional[str], device: torch.device,
                      frames_out: list) -> Callable[[int, torch.Tensor],
                                                    None]:
    """The few-step pipeline's on_block hook for --preview: each block
    through the TAEHV previewer, its uint8 frames [T, H, W, 3] appended to
    `frames_out`.  taehv_path: an upstream `taew2_1.pth` state dict; None:
    random weights (seed 7)."""
    from .models.taehv import TAEHV, init_taehv_params
    from .utils.preview import TaehvPreviewer
    if taehv_path:
        model = TAEHV()
        model.load_state_dict(torch.load(taehv_path, map_location="cpu",
                                         weights_only=True))
        model = model.to(device)
    else:
        model = init_taehv_params(
            torch.Generator(device=device).manual_seed(7), device=device)
        print("[preview] no --taehv-path: random TAEHV weights",
              file=sys.stderr)
    previewer = TaehvPreviewer(model)

    def on_block(start_frame: int, latents: torch.Tensor) -> None:
        t0 = time.perf_counter()
        frames = previewer(latents)[0]
        frames_out.append(frames)
        print(f"[preview] frames {start_frame}..: {frames.shape[0]} px "
              f"frames in {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    return on_block


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.duration < 1:
        print("error: --duration must be >= 1", file=sys.stderr)
        return 2
    from .core.config import WAN_CONFIGS, load_config, tiny_test_config
    from .models import dit, vae
    from .pipelines.fps_inference import CausalFPSInferencePipeline
    from .utils.device import resolve_device, set_float32_precision

    # run-config merge; a `denoising_step_list` selects the few-step pipeline
    run_cfg = {}
    if args.config:
        default = os.path.join(os.path.dirname(args.config),
                               "default_config.yaml")
        run_cfg = load_config(args.config,
                              default if os.path.exists(default) else None)
        if args.model != "smoke":
            args.model = run_cfg.get("model_name", args.model)
        args.timestep_shift = run_cfg.get("timestep_shift",
                                          args.timestep_shift)
        args.guidance_scale = run_cfg.get("guidance_scale",
                                          args.guidance_scale)
    denoising_step_list = run_cfg.get("denoising_step_list")
    if args.preview and not denoising_step_list:
        print("--preview requires the few-step pipeline "
              "(a config with denoising_step_list)", file=sys.stderr)
        return 2

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
    dtype = torch.float32 if smoke else torch.bfloat16
    if denoising_step_list:
        pipe = few_step_pipeline(cfg, model, run_cfg, args.timestep_shift,
                                 quantize=args.quantize,
                                 quantize_cache=args.quantize_cache,
                                 dtype=dtype)
    else:
        pipe = CausalFPSInferencePipeline(
            cfg, model, sampling_steps=args.sampling_steps,
            timestep_shift=args.timestep_shift,
            guidance_scale=args.guidance_scale, quantize=args.quantize,
            quantize_cache=args.quantize_cache, dtype=dtype)

    on_block, preview_frames = None, []
    if args.preview:
        on_block = make_preview_hook(args.taehv_path, device, preview_frames)

    all_latents = []
    on_window = None
    if args.save_latents:
        def on_window(win, latents, frames, seconds):
            all_latents.append(latents.float().cpu().numpy())

    gen = torch.Generator(device=device).manual_seed(args.seed + 100)
    full = run_windows(pipe, vae_model, cond, uncond, args.duration,
                       (H // 8, W // 8), gen, on_window,
                       profile=args.profile, on_block=on_block)
    from .utils.video_io import write_video
    if preview_frames:
        ppath = write_video(args.preview, np.concatenate(preview_frames),
                            fps=16)
        print(f"wrote preview {ppath}", file=sys.stderr)
    if args.save_latents:
        # [B, windows, F, ...]; the few-step windows differ in length, so
        # theirs are joined along the frames
        same = len({a.shape for a in all_latents}) == 1
        np.save(args.save_latents, np.stack(all_latents, axis=1) if same
                else np.concatenate(all_latents, axis=1))
    frames = full[0]
    path = write_video(args.output, frames, fps=16)
    print(f"wrote {path}: {frames.shape[0]} frames "
          f"{frames.shape[2]}x{frames.shape[1]} @16fps", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
