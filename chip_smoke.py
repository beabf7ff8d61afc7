"""Drive the PyTorch/CUDA port (mmpl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines as it goes (any failure exits non-zero):
  1. device and build: the card's name and power limit; nvcc builds every
     kernel from mmpl_tpu_torch/csrc;
  2. kernel: K1 (csrc/flash_fwd.cu) against its plain PyTorch version at the
     1.3B main path's attention shapes, with kernel / plain / SDPA times and
     the card's bound;
  3. cli: the port's CLI in smoke mode (tiny config, fp32, 2 windows);
  4. window: the 1.3B model (30 layers, random weights, non-zero head) at
     480x832 in bf16, two bridged windows at 4 sampling steps, with exact
     K1 launch counts;
  5. profile: one group-3 solver forward under torch.profiler (device time
     by kernel, the device's idle share);
  6. the kernels line, then the final device line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(1)

from mmpl_tpu_torch import cli                                  # noqa: E402
from mmpl_tpu_torch.core.config import WAN_CONFIGS               # noqa: E402
from mmpl_tpu_torch.models import dit, vae                       # noqa: E402
from mmpl_tpu_torch.ops import _build                            # noqa: E402
from mmpl_tpu_torch.ops import attention as attn                 # noqa: E402
from mmpl_tpu_torch.pipelines.fps_inference import \
    CausalFPSInferencePipeline                                    # noqa: E402
from mmpl_tpu_torch.utils.device import set_float32_precision   # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA,
#: HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12

#: (label, B, N, D, Lq, Lk, dtype): the 1.3B main path's K1 calls (the four
#: t2v self-attention groups and text cross-attention), a ragged shape, and
#: the fp32 smoke path's head dim
K1_SHAPES = [
    ("group0_self", 2, 12, 128, 3120, 3120, torch.bfloat16),
    ("group1_self", 2, 12, 128, 10920, 14040, torch.bfloat16),
    ("group2_self", 2, 12, 128, 9360, 20280, torch.bfloat16),
    ("group3_self", 2, 12, 128, 9360, 32760, torch.bfloat16),
    ("cross", 2, 12, 128, 9360, 512, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("smoke_f32", 2, 4, 24, 130, 200, torch.float32),
]
MAIN_SHAPE = "group3_self"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (a plain assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, warmup: int = 1, budget_ms: float = 3000.0,
            max_reps: int = 20) -> float:
    """Median of CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < max_reps:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        if sum(times) > budget_ms and len(times) >= 3:
            break
    return statistics.median(times)


def bound(B, N, D, Lq, Lk, dtype):
    flops = 4.0 * B * N * Lq * Lk * D
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * B * D * N * (2 * Lq + 2 * Lk) + 4 * B * N * Lq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    log = _build.build()
    for name in _build.SIGNATURES:
        info = log.get(name, {})
        ptxas = [ln.strip() for ln in info.get("ptxas", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name,
              "seconds": round(info.get("seconds", 0.0), 3),
              "cached": name not in log, "ptxas": ptxas})
    return smi


def phase_kernel():
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, N, D, Lq, Lk, dtype in K1_SHAPES:
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for L in (Lq, Lk, Lk))
        o, lse = attn.flash_fwd_cuda(q, k, v)
        po, plse = attn.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        lerr = (lse - plse).abs()
        row = {"phase": "kernel", "kernel": "flash_fwd", "shape": label,
               "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "dtype": str(dtype).replace("torch.", ""),
               "o_max_abs_err": err.max().item(),
               "o_mean_abs_err": err.mean().item(),
               "lse_max_abs_err": lerr.max().item(),
               "lse_mean_abs_err": lerr.mean().item()}
        del po, plse, err, lerr, o, lse
        row["ms"] = time_ms(lambda: attn.flash_fwd_cuda(q, k, v))
        row["plain_ms"] = time_ms(lambda: attn.flash_attention_plain(q, k, v),
                                  max_reps=5)
        row["bound_ms"], row["bound_by"] = bound(B, N, D, Lq, Lk, dtype)
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
        row["tflops"] = 4.0 * B * N * Lq * Lk * D / row["ms"] / 1e9
        emit(row)
        rows[label] = row
        if dtype == torch.float32:
            check(row["o_max_abs_err"] <= 1e-4, row)
            check(row["lse_max_abs_err"] <= 1e-4, row)
        else:
            check(row["o_max_abs_err"] <= 2e-2, row)
            check(row["o_mean_abs_err"] <= 2e-3, row)
            check(row["lse_max_abs_err"] <= 1e-3, row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_cli():
    os.makedirs(OUT_DIR, exist_ok=True)
    from mmpl_tpu_torch.utils import video_io
    written = {}
    original = video_io.write_video

    def capture(path, frames, fps=16):
        written["frames"] = frames
        return original(path, frames, fps)

    video_io.write_video = capture
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["--model", "smoke", "--duration", "2",
                       "--sampling-steps", "4", "--device", "cuda",
                       "--output", os.path.join(OUT_DIR, "smoke.mp4")])
    finally:
        video_io.write_video = original
    launches = attn.launch_counts["flash_fwd"]
    frames = written["frames"]
    # tiny config: 2 layers x (self + cross) per forward; 19 + 15 forwards
    expected = 2 * 2 * (19 + 15)
    emit({"phase": "cli", "rc": rc, "seconds": time.perf_counter() - t0,
          "frames_shape": list(frames.shape), "dtype": str(frames.dtype),
          "flash_fwd_launches": launches, "expected_launches": expected})
    check(rc == 0, f"cli exit code {rc}")
    check(frames.shape == (157, 64, 64, 3) and str(frames.dtype) == "uint8",
          (frames.shape, frames.dtype))
    check(launches == expected, (launches, expected))


def phase_window(steps: int = 4):
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    t0 = time.perf_counter()
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(0), torch.bfloat16, dev), g(99))
    vae_model = vae.init_vae_params(g(1), torch.float32, dev)
    cond, uncond = cli.random_text_context(cfg, dev)
    pipe = CausalFPSInferencePipeline(cfg, model, sampling_steps=steps,
                                      dtype=torch.bfloat16)
    pipe.sync_timing = True
    torch.cuda.synchronize()
    emit({"phase": "window_init", "seconds": time.perf_counter() - t0})

    windows = []

    def on_window(win, latents, frames, seconds):
        lat = latents.float()
        finite = bool(torch.isfinite(lat).all().item())
        std = lat.std().item()
        new_frames = 21 if win == 0 else 19
        row = {"phase": "window", "window": win, "seconds": seconds,
               "new_latent_frames": new_frames,
               "latent_frames_per_s": new_frames / seconds,
               "latents_finite": finite, "latents_std": std,
               "frames_shape": list(frames.shape)}
        for key, val in pipe.phase_times.items():
            if key.endswith("_steps_s"):
                row[key.replace("_steps_s", "_ms_per_step")] = \
                    1e3 * val / steps
            else:
                row[key.replace("_s", "_ms")] = 1e3 * val
        emit(row)
        windows.append(row)
        check(finite and std > 1e-3, row)
        check(frames.shape == (1, 81, 480, 832, 3), frames.shape)

    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    full = cli.run_windows(pipe, vae_model, cond, uncond, 2, (60, 104),
                           g(100), on_window)
    launches = attn.launch_counts["flash_fwd"]
    per_forward = 2 * cfg.num_layers
    expected = per_forward * ((4 * steps + 3) + (3 * steps + 3))
    emit({"phase": "window_total", "flash_fwd_launches": launches,
          "expected_launches": expected,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30,
          "frames_shape": list(full[0].shape), "dtype": str(full.dtype)})
    check(launches == expected, (launches, expected))
    check(full[0].shape == (157, 480, 832, 3) and str(full.dtype) == "uint8",
          (full.shape, full.dtype))
    return launches, pipe, cond, uncond


def phase_profile(pipe, cond, uncond, top: int = 12):
    """One group-3 solver forward (the heaviest step) under torch.profiler:
    device time by kernel, K1's share, and the device's idle share of the
    synchronised wall time.  Reports what it sees; the numbers are read by
    PERF.md's time breakdown, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    from mmpl_tpu_torch.models.fps_dit import init_kv_cache

    schedule = pipe.plan.groups[3]
    dev = cond.device
    ctx_kv2 = pipe.prepare_context(cond, uncond)
    cache = init_kv_cache(pipe.cfg, 2, 60 * 104 // 4, KV_CACHE_SLOTS,
                          torch.bfloat16, dev)
    lat = torch.randn((1, schedule.num_frames, 16, 60, 104), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(7))

    def step():
        with torch.inference_mode():
            pipe._forward(schedule, ctx_kv2, cache, lat, 500.0, False)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "flash_fwd_kernel" in e.key) / 1e3
    emit({"phase": "profile", "what": "group3 solver forward, 30 layers",
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
          "flash_fwd_ms": k1_ms,
          "flash_fwd_share_of_busy": k1_ms / busy_ms if busy_ms else None,
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in kernels[:top]]})


def main() -> int:
    set_float32_precision()
    smi = phase_device()
    rows = phase_kernel()
    phase_cli()
    launches, pipe, cond, uncond = phase_window()
    phase_profile(pipe, cond, uncond)
    main_row = rows[MAIN_SHAPE]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mmpl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mmpl_tpu/ops/attention.py:324",
        "launches": launches,
        "max_abs_err": max(r["o_max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": MAIN_SHAPE, "card": smi,
        "shapes": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "library_ms", "o_max_abs_err")}
                   for k, r in rows.items()}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
