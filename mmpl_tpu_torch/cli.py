"""CLI entry point: rolling long-video T2V / I2V generation.

Port of `mmpl_tpu/cli.py`.  `--duration` windows are generated in turn;
each window after the first is seeded by re-encoding the previous window's
last 5 pixel frames into 2 context latents, and its first 5 pixel frames
(the overlap) are trimmed.

Without `--checkpoint-path` it runs random weights and random text states
("smoke" is the tiny config at 64x64; fp32 activations over bf16
weights).  With it, the generator comes from an MMPL `.pt` (bf16;
`--use-ema` takes `generator_ema`), and the VAE, the umT5 encoder (f32)
and its tokenizer from `--wan-dir` (a Wan2.1 directory:
`Wan2.1_VAE.pth`, `models_t5_umt5-xxl-enc-bf16.pth`, `google/umt5-xxl/`);
`--prompt` and `--negative-prompt` (else the config's, else Wan's default
negative prompt) become the cond / uncond text states.  `--image` runs the
i2v window plan: the image (a file, an http(s) URL or base64) is resized
and centre-cropped to the output size and VAE-encoded as window 0's one
clean latent frame.

The pipeline follows the run config: one with a `denoising_step_list`
(`configs/self_forcing_dmd.yaml`) selects the few-step causal pipeline
(`pipelines/causal_inference.py`, no CFG), any other the 50-step
planned-window pipeline (`pipelines/fps_inference.py`).

    python -m mmpl_tpu_torch.cli --model smoke --duration 2 --sampling-steps 4
    python -m mmpl_tpu_torch.cli --config configs/self_forcing_dmd.yaml \
        --profile --preview preview.mp4
    python -m mmpl_tpu_torch.cli --checkpoint-path mmpl_t2v_1.3B.pt \
        --wan-dir Wan2.1-T2V-1.3B --use-ema --prompt "..." [--image img.png]

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
    "mesh": "Slice F (multi-device)",
}
#: models the serving CLI refuses, and why
REFUSED_MODELS = {
    "i2v-14B": ("Queue 3, a known difference: the FPS pipeline passes no "
                "i2v conditioning y, so the in_dim-36 DiT fails at the "
                "patch embedding in mmpl_tpu too; the i2v-14B DiT runs "
                "whole clips through pipelines/wan_reference.WanI2V"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mmpl_tpu_torch video generation")
    p.add_argument("--config", default=None, help="run-config yaml")
    p.add_argument("--model", default="t2v-1.3B",
                   choices=["t2v-14B", "t2v-1.3B", "i2v-14B", "smoke"],
                   help="model config ('smoke' = tiny random-weight)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--prompt", default="a cat surfing a wave at sunset",
                   help="the text prompt (random text states stand in "
                        "without --checkpoint-path)")
    p.add_argument("--negative-prompt", default=None,
                   help="the uncond prompt (default: the run config's, "
                        "else the model config's sample_neg_prompt)")
    p.add_argument("--image", default=None,
                   help="conditioning image (file, http(s) URL or base64) "
                        "-> the i2v plan: the image is VAE-encoded as the "
                        "first latent frame")
    p.add_argument("--checkpoint-path", default=None,
                   help="MMPL generator .pt (t2v_14B_8k.pt style)")
    p.add_argument("--wan-dir", default=None,
                   help="Wan2.1 directory (the VAE, T5 and tokenizer)")
    p.add_argument("--use-ema", action="store_true",
                   help="take the checkpoint's generator_ema")
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
    p.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for dest, where in LATER_SLICES.items():
        if getattr(args, dest):
            p.error(f"--{dest.replace('_', '-')} is not ported yet: "
                    f"ROADMAP.md {where}")
    if args.model in REFUSED_MODELS:
        p.error(f"--model {args.model} is refused: ROADMAP.md "
                f"{REFUSED_MODELS[args.model]}")
    if args.checkpoint_path and args.model != "smoke" and not args.wan_dir:
        p.error("--checkpoint-path needs --wan-dir (the VAE, the T5 encoder "
                "and its tokenizer)")
    return args


def random_text_context(cfg, device: torch.device):
    """Random cond/uncond text-encoder states [1, text_len, text_dim]."""
    out = []
    for seed in (2, 3):
        g = torch.Generator(device=device).manual_seed(seed)
        out.append(torch.randn((1, cfg.text_len, cfg.text_dim), generator=g,
                               device=device))
    return out


def load_models(cfg, checkpoint_path: str, wan_dir: str, use_ema: bool,
                device: torch.device):
    """(generator, VAE, text encoder) from real files: the MMPL generator
    `.pt` in bf16 (`generator_ema` with use_ema), the VAE and the umT5
    encoder (f32, `models.t5.UMT5_XXL`) from the Wan2.1 directory, the
    tokenizer from its `google/umt5-xxl`."""
    from .models import t5
    from .utils import checkpoint as ckpt
    from .utils.tokenizer import WanTextEncoder
    model = ckpt.load_mmpl_generator(checkpoint_path, cfg, use_ema=use_ema,
                                     dtype=torch.bfloat16, device=device)
    vae_model = ckpt.load_vae(os.path.join(wan_dir, cfg.vae_checkpoint),
                              torch.float32, device)
    t5_model = ckpt.load_t5(os.path.join(wan_dir, cfg.t5_checkpoint),
                            t5.UMT5_XXL, torch.float32, device)
    text_encoder = WanTextEncoder(
        t5_model, os.path.join(wan_dir, cfg.t5_tokenizer))
    return model, vae_model, text_encoder


def encode_image(vae_model, image: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """[3, H, W] in [-1, 1] (`utils/media.load_image`) -> the i2v window's
    first clean latent frame [1, 1, 16, H/8, W/8]."""
    from .models import vae
    pixels = torch.from_numpy(image).to(device)[None, None]
    return vae.encode(vae_model, pixels)


def run_windows(pipe, vae_model, cond: torch.Tensor, uncond: torch.Tensor,
                duration: int, lat_hw, generator: torch.Generator,
                on_window: Optional[Callable[..., None]] = None,
                profile: bool = False,
                on_block: Optional[Callable[[int, torch.Tensor], None]]
                = None,
                initial_latent: Optional[torch.Tensor] = None) -> np.ndarray:
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
    (the preview).  initial_latent [B, n0, 16, h, w]: window 0's clean
    context latents (the encoded i2v image, n0 = 1); a pipeline with the
    i2v plan commits it as group 0 and denoises from frame 1 on."""
    from .models import vae
    from .pipelines.causal_inference import CausalInferencePipeline
    from .utils.profiling import sync
    few_step = isinstance(pipe, CausalInferencePipeline)
    device = cond.device
    lat_h, lat_w = lat_hw
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
    from .core.geometry import i2v_plan
    from .models import dit, vae
    from .pipelines.fps_inference import CausalFPSInferencePipeline
    from .utils.device import resolve_device, set_float32_precision
    from .utils.media import load_image

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
        if run_cfg.get("negative_prompt") and not args.negative_prompt:
            args.negative_prompt = run_cfg["negative_prompt"]
    denoising_step_list = run_cfg.get("denoising_step_list")
    if args.preview and not denoising_step_list:
        print("--preview requires the few-step pipeline "
              "(a config with denoising_step_list)", file=sys.stderr)
        return 2

    device = resolve_device(args.device)
    set_float32_precision()
    smoke = args.model == "smoke" or args.checkpoint_path is None
    if args.model == "smoke":
        cfg = tiny_test_config()
        H = W = 64
    else:
        cfg = WAN_CONFIGS[args.model]
        H, W = args.height, args.width

    t0 = time.time()
    if smoke:
        print(f"[smoke mode] random weights, config={cfg.name} "
              f"device={device}", file=sys.stderr)
        model = dit.init_dit_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            torch.bfloat16, device)
        vae_model = vae.init_vae_params(
            torch.Generator(device=device).manual_seed(1), torch.float32,
            device)
        cond, uncond = random_text_context(cfg, device)
    else:
        model, vae_model, text_encoder = load_models(
            cfg, args.checkpoint_path, args.wan_dir, args.use_ema, device)
        cond = text_encoder([args.prompt])["prompt_embeds"]
        neg = args.negative_prompt or cfg.sample_neg_prompt
        uncond = text_encoder([neg])["prompt_embeds"]
        del text_encoder           # the encoder runs once, before the windows
    if args.quantize_vae:
        vae.quantize_vae_decoder(vae_model)
    print(f"model init: {time.time() - t0:.1f}s", file=sys.stderr)

    # smoke runs fp32 activations over bf16 weights; checkpoints run bf16
    dtype = torch.float32 if smoke else torch.bfloat16
    plan = i2v_plan() if args.image else None
    if denoising_step_list:
        pipe = few_step_pipeline(cfg, model, run_cfg, args.timestep_shift,
                                 quantize=args.quantize,
                                 quantize_cache=args.quantize_cache,
                                 dtype=dtype)
    else:
        pipe = CausalFPSInferencePipeline(
            cfg, model, plan=plan, sampling_steps=args.sampling_steps,
            timestep_shift=args.timestep_shift,
            guidance_scale=args.guidance_scale, quantize=args.quantize,
            quantize_cache=args.quantize_cache, dtype=dtype)

    initial_latent = None
    if args.image:
        initial_latent = encode_image(vae_model, load_image(args.image, H, W),
                                      device)

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
                       profile=args.profile, on_block=on_block,
                       initial_latent=initial_latent)
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
