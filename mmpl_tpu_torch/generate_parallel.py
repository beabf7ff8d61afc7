"""Chunk-parallel long-video generation over the visible cards.

Port of the root `generate_parallel.py`: N chunks (~5 s each) pipelined
over the stages of `parallel/chunk_pipeline.ChunkParallelPipeline`, one
stage per visible card (round-robin reuse beyond the card count), the
anchors handed from stage to stage on the device.  Without
`--checkpoint-path` it runs the tiny config with random weights and
random text states (smoke mode), as the JAX entry does.

    python -m mmpl_tpu_torch.generate_parallel --num-chunks 4 \
        --output-dir out/

`--coordinator`, `--num-processes` and `--process-id` initialise
`torch.distributed` (`parallel/mesh.init_distributed`); a world of more
than one process is refused, since the stages are this process's (one
stage per process is not ported).  `--device cpu` runs one stage on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="mmpl_tpu_torch chunk-parallel generation")
    p.add_argument("--model", default="smoke",
                   choices=["t2v-14B", "t2v-1.3B", "smoke"])
    p.add_argument("--prompt", default="a red panda climbing a tree")
    p.add_argument("--num-chunks", type=int, default=4,
                   help="number of 5s chunks (4=20s ... 12=60s)")
    p.add_argument("--checkpoint-path", default=None)
    p.add_argument("--wan-dir", default=None)
    p.add_argument("--sampling-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--timestep-shift", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", default=None,
                   choices=["int8", "int8wo", "auto"],
                   help="int8 projections per stage (ops/quant.py)")
    p.add_argument("--quantize-cache", action="store_true",
                   help="int8 KV cache per stage (halves the cache bytes)")
    p.add_argument("--output-dir", default="videos/parallel_fps")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous host:port "
                        "(torch.distributed; see parallel/mesh.py)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--config", default=None,
                   help="YAML run config: merges model_name / "
                        "timestep_shift / guidance_scale over the flag "
                        "defaults")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .core.config import WAN_CONFIGS, load_config, tiny_test_config
    if args.config:
        default = os.path.join(os.path.dirname(args.config),
                               "default_config.yaml")
        run_cfg = load_config(args.config,
                              default if os.path.exists(default) else None)
        if args.model != "smoke":      # an explicit smoke wins
            args.model = run_cfg.get("model_name", args.model)
        args.timestep_shift = run_cfg.get("timestep_shift",
                                          args.timestep_shift)
        args.guidance_scale = run_cfg.get("guidance_scale",
                                          args.guidance_scale)
    if not 1 <= args.num_chunks <= 12:
        print("error: --num-chunks must be in [1, 12] "
              "(Wan_fps_inference_parallel_4gpu_5-60s.py:276-394)",
              file=sys.stderr)
        return 2

    from .cli import load_models, random_text_context
    from .models import dit, vae
    from .parallel.chunk_pipeline import ChunkParallelPipeline, \
        default_devices
    from .parallel.mesh import init_distributed
    from .utils.device import resolve_device, set_float32_precision
    from .utils.video_io import write_video

    device = resolve_device(args.device)
    set_float32_precision()
    if init_distributed(args.coordinator, args.num_processes,
                        args.process_id):
        import torch.distributed as dist
        print(f"distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()} ({dist.get_backend()})",
              file=sys.stderr)
        if dist.get_world_size() > 1:
            # every process would run every chunk on every visible card
            # and write the same files
            print("error: generate_parallel runs its stages in one "
                  "process, over every visible card; one stage per "
                  "process (stage_meshes) is not ported (ROADMAP.md "
                  "Queue 1)", file=sys.stderr)
            return 2
    devices = default_devices() if device.type == "cuda" else [device]
    dev0 = devices[0]

    smoke = args.model == "smoke" or args.checkpoint_path is None
    if smoke:
        cfg = tiny_test_config()
        lat_h = lat_w = 8
        steps = min(args.sampling_steps, 4)
        g = lambda s: torch.Generator(device=dev0).manual_seed(s)
        model = dit.init_dit_params(cfg, g(0), torch.float32, dev0)
        vae_model = vae.init_vae_params(g(1), torch.float32, dev0)
        cond, uncond = random_text_context(cfg, dev0)
        dtype = torch.float32
    else:
        cfg = WAN_CONFIGS[args.model]
        lat_h, lat_w = 60, 104
        steps = args.sampling_steps
        model, vae_model, text_encoder = load_models(
            cfg, args.checkpoint_path, args.wan_dir, False, dev0)
        cond = text_encoder([args.prompt])["prompt_embeds"]
        uncond = text_encoder([cfg.sample_neg_prompt])["prompt_embeds"]
        del text_encoder
        dtype = torch.bfloat16

    print(f"{len(devices)} stage(s) on {[str(d) for d in devices]}; "
          f"{args.num_chunks} chunks (round-robin reuse beyond "
          f"{len(devices)})", file=sys.stderr)
    pipe = ChunkParallelPipeline(
        cfg, model, vae_model, devices=devices, sampling_steps=steps,
        guidance_scale=args.guidance_scale,
        timestep_shift=args.timestep_shift, quantize=args.quantize,
        quantize_cache=args.quantize_cache, dtype=dtype)

    gen = torch.Generator(device=dev0).manual_seed(args.seed)
    noises = [torch.randn((1, 21, 16, lat_h, lat_w), generator=gen,
                          device=dev0) for _ in range(args.num_chunks)]
    t0 = time.time()
    chunks = pipe.generate(noises, cond, uncond, seed=args.seed)
    vids = pipe.decode_chunks(chunks, uint8=True)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, v in enumerate(vids):
        frames = v[0].cpu().numpy()
        out = os.path.join(args.output_dir,
                           f"{args.prompt[:60]}-chunk{i + 1}.mp4")
        path = write_video(out, frames, fps=16)
        print(f"chunk {i + 1}: {path} ({frames.shape[0]} frames)",
              file=sys.stderr)
    print(f"generated ~{args.num_chunks * 5}s of video in "
          f"{time.time() - t0:.1f}s wall-clock", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
