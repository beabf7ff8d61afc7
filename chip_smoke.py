"""Drive the PyTorch/CUDA port (mmpl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines as it goes (any failure exits non-zero):
  1. device and build: the card's name and power limit; nvcc builds every
     kernel from mmpl_tpu_torch/csrc;
  2. kernel: K1 (csrc/flash_fwd.cu) against its plain PyTorch version at the
     1.3B main path's attention shapes, with kernel / plain / SDPA times and
     the card's bound;
  3. kernel_bwd: K2 / K3 (csrc/flash_bwd.cu) at the training
     cross-attention shape, a ragged shape and D = 24, against the plain
     backward and SDPA's backward;
  4. kernel_masked: K4 / K5 / K6 under the fps-forcing mask at the 1.3B
     teacher-forcing self-attention shape (42 frames x 1560 tokens), and
     ragged shapes with a frame that sees nothing, against the plain
     versions and SDPA (memory-efficient backend) with the token mask;
  5. cli: the port's serving CLI in smoke mode (tiny config, fp32, 2
     windows);
  6. window: the 1.3B model (30 layers, random weights, non-zero head) at
     480x832 in bf16, two bridged windows at 4 sampling steps, with exact
     K1 launch counts;
  7. profile: one group-3 solver forward under torch.profiler (device time
     by kernel, the device's idle share);
  8. train_cli: `python -m mmpl_tpu_torch.train --smoke --steps 3` in this
     process, with exact launch counts; train_parity: one fp32 loss and
     its gradients of the tiny model on the card against the CPU's plain
     path;
  9. train: teacher forcing of the 1.3B model (30 layers, 21 latent frames
     at 60x104, bf16 trunk over fp32 masters, AdamW, EMA), one warm-up and
     two timed steps with exact launch counts; train_profile: one step
     under torch.profiler;
 10. the kernels line, then the final device line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(1)

from mmpl_tpu_torch import cli                                  # noqa: E402
from mmpl_tpu_torch.core.config import WAN_CONFIGS               # noqa: E402
from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS         # noqa: E402
from mmpl_tpu_torch.models import dit, vae                       # noqa: E402
from mmpl_tpu_torch.ops import _build                            # noqa: E402
from mmpl_tpu_torch.ops import attention as attn                 # noqa: E402
from mmpl_tpu_torch.pipelines.fps_inference import \
    CausalFPSInferencePipeline                                    # noqa: E402
from mmpl_tpu_torch.training import masks                        # noqa: E402
from mmpl_tpu_torch.utils.device import set_float32_precision   # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA,
#: HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12

#: (label, B, N, D, Lq, Lk, dtype): the 1.3B main path's K1 calls (the four
#: t2v self-attention groups and text cross-attention), the training
#: cross-attention, a ragged shape, and the fp32 smoke path's head dim
K1_SHAPES = [
    ("group0_self", 2, 12, 128, 3120, 3120, torch.bfloat16),
    ("group1_self", 2, 12, 128, 10920, 14040, torch.bfloat16),
    ("group2_self", 2, 12, 128, 9360, 20280, torch.bfloat16),
    ("group3_self", 2, 12, 128, 9360, 32760, torch.bfloat16),
    ("cross", 2, 12, 128, 9360, 512, torch.bfloat16),
    ("tf_cross", 1, 12, 128, 65520, 512, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("smoke_f32", 2, 4, 24, 130, 200, torch.float32),
]
MAIN_SHAPE = "group3_self"

#: K2 / K3 shapes, as K1_SHAPES: the 1.3B teacher-forcing step's
#: cross-attention (65520 tokens over 512 text tokens), a ragged shape and
#: the tiny configuration's head dim in bf16 and fp32
BWD_SHAPES = [
    ("tf_cross", 1, 12, 128, 65520, 512, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("d24_bf16", 2, 4, 24, 1000, 1300, torch.bfloat16),
    ("d24_f32", 2, 4, 24, 1000, 1300, torch.float32),
]
BWD_MAIN = "tf_cross"

#: K4-K6 shapes: (label, B, N, D, mask, tokens per frame, dtype).  "fps" is
#: the fps-forcing mask of T2V_CLEAN_STEPS over [clean | noisy] 2 x 21
#: frames of 1560 tokens (L = 65520, the 1.3B teacher-forcing step);
#: "blind" is L = 1000 in frames of 130 under a block-causal mask where
#: frame 1 sees nothing
MASKED_SHAPES = [
    ("tf_self", 1, 12, 128, "fps", 1560, torch.bfloat16),
    ("ragged_blind", 2, 12, 128, "blind", 130, torch.bfloat16),
    ("d24_bf16_blind", 2, 4, 24, "blind", 130, torch.bfloat16),
    ("d24_f32_blind", 2, 4, 24, "blind", 130, torch.float32),
]
MASKED_MAIN = "tf_self"

#: forward tolerances (as K1) and gradient tolerances, ||got - plain|| /
#: ||plain|| per dq / dk / dv
FWD_TOL = {"max": 2e-2, "mean": 2e-3, "lse": 1e-3}
FWD_TOL_F32 = {"max": 1e-4, "mean": 1e-4, "lse": 1e-4}
GRAD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}

#: kernel launches of one teacher-forcing step per layer: with per-block
#: recomputation the forward kernels run twice (forward, then again in the
#: backward pass), each backward kernel once
TRAIN_LAUNCHES_PER_LAYER = {"flash_fwd": 2, "flash_masked_fwd": 2,
                            "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
                            "flash_masked_bwd_dkv": 1,
                            "flash_masked_bwd_dq": 1}


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


def roofline(flops, nbytes, dtype):
    """(least ms on the card, what bounds it) for this work."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_work(kind, B, N, D, Lq, Lk, dtype, share=1.0, mask_bytes=0):
    """(FLOPs, bytes) of one attention kernel: "fwd" (S, PV: 4 flops per
    q-k-d triple), "dkv" (S, dP, dV, dK: 8) or "dq" (S, dP, dQ: 6), times
    the share of (query, key) pairs the mask allows.  Bytes: each input
    read once and each output written once (q/k/v/dO/O/dQ/dK/dV in the
    input type, lse and delta fp32 per query row, the mask's ids and
    tables)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    mult, q_elems, k_elems, row_arrays = {
        "fwd": (4, 2, 2, 1),    # q, o | k, v | lse out
        "dkv": (8, 2, 4, 2),    # q, dO | k, v, dk, dv | lse, delta in
        "dq": (6, 3, 2, 2),     # q, dO, dq | k, v | lse, delta in
    }[kind]
    flops = mult * B * N * Lq * Lk * D * share
    nbytes = (esize * B * N * D * (q_elems * Lq + k_elems * Lk)
              + 4 * B * N * Lq * row_arrays + mask_bytes)
    return flops, nbytes


def bound(B, N, D, Lq, Lk, dtype):
    return roofline(*attention_work("fwd", B, N, D, Lq, Lk, dtype), dtype)


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


def _rand(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _grad_errors(row, got, want, dtype, blind_rows=None):
    """Relative and max-abs errors of (dq, dk, dv) against the plain
    version, checked against GRAD_REL_TOL; with `blind_rows` (queries that
    see no key) their dq must be exactly 0."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), (row["shape"], name, "finite"))
        row[f"{name}_rel_err"] = ((g - w).norm()
                                  / w.norm().clamp_min(1e-30)).item()
        row[f"{name}_max_abs_err"] = (g - w).abs().max().item()
    if blind_rows is not None:
        row["blind_dq_zero"] = bool((got[0][:, blind_rows] == 0).all())
        check(row["blind_dq_zero"], (row["shape"], "dq of blind rows"))
    tol = GRAD_REL_TOL[dtype]
    for name in ("dq", "dk", "dv"):
        check(row[f"{name}_rel_err"] <= tol, (row["shape"], name, row))


def _library_times(row, q, k, v, do, attn_mask=None):
    """SDPA on the same inputs as the yardstick: forward, backward alone
    (torch.autograd.grad over a kept graph: dq, dk and dv in one call) and
    forward + backward.  With `attn_mask` (the token-level bool mask) under
    the memory-efficient backend, the one that takes a mask with a
    backward.  Where SDPA refuses the inputs the row says why."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = (sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])
               if attn_mask is not None else contextlib.nullcontext())
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    try:
        with backend:
            fwd = lambda: sdpa(qt, kt, vt, attn_mask=attn_mask)
            row["library_fwd_ms"] = time_ms(lambda: fwd().detach())
            out = fwd()
            row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
            del out
            row["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                fwd(), (qt, kt, vt), dot))
    except RuntimeError as exc:   # the yardstick only; no kernel of the port
        row["library_error"] = str(exc).splitlines()[0][:200]
    torch.cuda.empty_cache()


def phase_kernel_bwd():
    """K2 (dK, dV) and K3 (dQ) against the plain backward."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, B, N, D, Lq, Lk, dtype in BWD_SHAPES:
        q, do = (_rand(gen, dtype, B, Lq, N, D) for _ in range(2))
        k, v = (_rand(gen, dtype, B, Lk, N, D) for _ in range(2))
        o, lse = attn.flash_fwd_cuda(q, k, v)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        dk, dv = attn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
        dq = attn.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
        want = attn.flash_attention_bwd_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        row = {"phase": "kernel_bwd", "kernel": "flash_bwd_dkv+flash_bwd_dq",
               "shape": label, "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "dtype": str(dtype).replace("torch.", "")}
        _grad_errors(row, (dq, dk, dv), want, dtype)
        del dq, dk, dv, want
        row["dkv_ms"] = time_ms(
            lambda: attn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
        row["dq_ms"] = time_ms(
            lambda: attn.flash_bwd_dq_cuda(q, k, v, do, lse, delta))
        row["plain_ms"] = time_ms(lambda: attn.flash_attention_bwd_plain(
            q, k, v, do, lse, delta), max_reps=5)
        for part in ("dkv", "dq"):
            work = attention_work(part, B, N, D, Lq, Lk, dtype)
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = roofline(
                *work, dtype)
            row[f"{part}_tflops"] = work[0] / row[f"{part}_ms"] / 1e9
        _library_times(row, q, k, v, do)
        emit(row)
        rows[label] = row
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows


def _masked_inputs(kind, S):
    """(q ids, kv ids, frame mask) on the card, the blind query rows (or
    None) and the share of (query, key) pairs the mask allows."""
    if kind == "fps":
        fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS)
        ids = np.repeat(np.arange(fm.shape[0]), S)
    else:
        L = 1000
        fm = masks.blockwise_causal_frame_mask(-(-L // S), 3)
        fm[1] = False
        ids = np.repeat(np.arange(fm.shape[0]), S)[:L]
    counts = np.bincount(ids, minlength=fm.shape[0]).astype(np.float64)
    share = float(counts @ fm @ counts) / float(len(ids)) ** 2
    tids = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
    blind = ~fm.any(axis=1)
    rows = (torch.as_tensor(blind[ids], device="cuda") if blind.any()
            else None)
    return (tids, tids, torch.as_tensor(fm, device="cuda")), rows, share


def phase_kernel_masked():
    """K4 (forward), K5 (dK, dV) and K6 (dQ) under a frame mask against
    their plain versions."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, B, N, D, kind, S, dtype in MASKED_SHAPES:
        mask, blind, share = _masked_inputs(kind, S)
        L = mask[0].numel()
        q, k, v, do = (_rand(gen, dtype, B, L, N, D) for _ in range(4))
        tiles = attn.tile_table(*mask)
        o, lse = attn.flash_fwd_cuda(q, k, v, None, mask, tiles)
        po, plse = attn.frame_masked_attention_plain(q, k, v, *mask)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        live = torch.isfinite(plse)
        row = {"phase": "kernel_masked", "shape": label, "mask": kind,
               "B": B, "N": N, "D": D, "L": L, "frames": mask[2].shape[0],
               "dtype": str(dtype).replace("torch.", ""),
               "pair_share": share,
               "tile_share": (tiles != 0).float().mean().item(),
               "tiles_full_share": (tiles == 2).float().mean().item(),
               "o_max_abs_err": err.max().item(),
               "o_mean_abs_err": err.mean().item(),
               "lse_max_abs_err": (lse[live] - plse[live]).abs().max().item(),
               "lse_inf_rows_agree": bool(torch.equal(
                   torch.isfinite(lse), live))}
        tol = FWD_TOL_F32 if dtype == torch.float32 else FWD_TOL
        check(row["o_max_abs_err"] <= tol["max"], row)
        check(row["o_mean_abs_err"] <= tol["mean"], row)
        check(row["lse_max_abs_err"] <= tol["lse"], row)
        check(row["lse_inf_rows_agree"], row)
        if blind is not None:
            row["blind_o_zero"] = bool((o[:, blind] == 0).all())
            row["blind_lse_neg_inf"] = bool(
                (lse[:, :, blind] == -math.inf).all())
            check(row["blind_o_zero"] and row["blind_lse_neg_inf"], row)
        del po, plse, err
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        dk, dv = attn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, mask,
                                         tiles)
        dq = attn.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, mask,
                                    tiles)
        want = attn.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                     *mask)
        torch.cuda.synchronize()
        _grad_errors(row, (dq, dk, dv), want, dtype, blind)
        del dq, dk, dv, want
        row["fwd_ms"] = time_ms(
            lambda: attn.flash_fwd_cuda(q, k, v, None, mask, tiles))
        row["dkv_ms"] = time_ms(lambda: attn.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, None, mask, tiles))
        row["dq_ms"] = time_ms(lambda: attn.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, None, mask, tiles))
        row["tile_table_ms"] = time_ms(lambda: attn.tile_table(*mask))
        row["plain_fwd_ms"] = time_ms(
            lambda: attn.frame_masked_attention_plain(q, k, v, *mask),
            max_reps=5)
        row["plain_bwd_ms"] = time_ms(
            lambda: attn.frame_masked_attention_bwd_plain(
                q, k, v, do, lse, delta, *mask), max_reps=5)
        mask_bytes = 4 * 2 * L + mask[2].numel() + tiles.numel()
        for part in ("fwd", "dkv", "dq"):
            work = attention_work(part, B, N, D, L, L, dtype, share,
                                  mask_bytes)
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = roofline(
                *work, dtype)
            row[f"{part}_tflops"] = work[0] / row[f"{part}_ms"] / 1e9
            # the same at the admitted tiles' share, what the kernel computes
            row[f"{part}_tile_bound_ms"] = roofline(*attention_work(
                part, B, N, D, L, L, dtype, row["tile_share"], mask_bytes),
                dtype)[0]
        token_mask = mask[2][mask[0].long()][:, mask[1].long()]
        _library_times(row, q, k, v, do, token_mask)
        del token_mask
        emit(row)
        rows[label] = row
        del q, k, v, do, o, lse, delta, tiles
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


def _train_launches(num_layers: int, steps: int) -> dict:
    return {name: n * num_layers * steps
            for name, n in TRAIN_LAUNCHES_PER_LAYER.items()}


def phase_train_cli(steps: int = 3):
    """The training CLI in smoke mode on the card: tiny config (2 layers,
    D = 24), bf16 trunk, 21 latent frames at 4x4."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.config import tiny_test_config
    run = "train_smoke"
    shutil.rmtree(os.path.join(OUT_DIR, run), ignore_errors=True)
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train.main(["--smoke", "--steps", str(steps), "--device", "cuda",
                     "--log-dir", OUT_DIR, "--run-name", run])
    seconds = time.perf_counter() - t0
    counts = dict(attn.launch_counts)
    with open(os.path.join(OUT_DIR, run, "metrics.jsonl"),
              encoding="utf-8") as f:
        losses = [json.loads(line)["loss"] for line in f if line.strip()]
    expected = _train_launches(tiny_test_config().num_layers, steps)
    emit({"phase": "train_cli", "rc": rc, "seconds": seconds,
          "losses": losses, "launches": counts,
          "expected_launches": expected})
    check(rc == 0, f"train exit code {rc}")
    check(len(losses) == steps and all(map(math.isfinite, losses)), losses)
    check(counts == expected, (counts, expected))


def _tf_setup(cfg, device, dtype_model, frames, lat_hw, seed=0):
    """A teacher-forcing set-up: model (fp32 masters, non-zero head), loss
    function, one batch and one draw, all from seeds."""
    from mmpl_tpu_torch.training.diffusion import (
        draw_teacher_forcing, make_scheduler, make_teacher_forcing_loss_fn)
    g = lambda s: torch.Generator(device=device).manual_seed(s)
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(seed), dtype_model, device), g(seed + 99))
    fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:frames])
    shape = (1, frames, cfg.in_dim, *lat_hw)
    gen = g(seed + 1)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device=device)
    batch = {"latents": torch.randn(shape, generator=gen, device=device),
             "context": ctx, "uncond_context": torch.zeros_like(ctx)}
    draws = draw_teacher_forcing(gen, shape, 3, 1000, 100, device)
    return model, make_scheduler(8.0), fm, batch, draws


def phase_train_parity():
    """One fp32 teacher-forcing loss and its gradients of the tiny model on
    the card (K1-K6) against the same on the CPU (the plain versions, which
    tests/test_torch_training.py holds against the JAX package)."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.training.diffusion import make_teacher_forcing_loss_fn
    cfg = tiny_test_config()
    model, sch, fm, batch, draws = _tf_setup(cfg, torch.device("cuda"),
                                             torch.float32, 21, (4, 4))
    loss_fn = make_teacher_forcing_loss_fn(
        cfg, sch, fm, noise_aug_max_timestep=100,
        compute_dtype=torch.float32)
    results = []
    for dev in ("cuda", "cpu"):
        m = model.to(dev).requires_grad_(True)
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, {k: x.to(dev) for k, x in batch.items()},
                       {k: x.to(dev) for k, x in draws.items()})
        loss.backward()
        results.append((loss.item(), {n: p.grad.detach().cpu().clone()
                                      for n, p in m.named_parameters()}))
    (loss_g, grads_g), (loss_c, grads_c) = results
    diff = {n: (grads_g[n] - grads_c[n]).abs().max().item() for n in grads_c}
    worst = max(diff, key=diff.get)
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs.values()])
    gg, gc = flat(grads_g), flat(grads_c)
    row = {"phase": "train_parity", "loss_cuda": loss_g, "loss_cpu": loss_c,
           "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
           "grad_rel_err": ((gg - gc).norm() / gc.norm()).item(),
           "grad_max_abs_err": diff[worst], "grad_max_abs_err_at": worst,
           "grad_max_abs": gc.abs().max().item(), "params": len(diff)}
    emit(row)
    # the CPU tests' tolerances against the JAX package: loss rtol 1e-5,
    # gradients atol 1e-4
    check(row["loss_rel_err"] <= 1e-5, row)
    check(row["grad_max_abs_err"] <= 1e-4, row)
    check(row["grad_rel_err"] <= 1e-4, row)


def phase_train(timed_steps: int = 2):
    """Teacher forcing of the 1.3B model at full width and depth: the
    slice's main path.  Counts are read over the timed steps only."""
    from mmpl_tpu_torch.training.diffusion import (
        DiffusionTrainer, draw_teacher_forcing, make_teacher_forcing_loss_fn)
    from mmpl_tpu_torch.utils.ema import EmaParams
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    frames, lat_hw = 21, (60, 104)
    t0 = time.perf_counter()
    model, sch, fm, batch, _ = _tf_setup(cfg, dev, torch.float32, frames,
                                         lat_hw)
    loss_fn = make_teacher_forcing_loss_fn(cfg, sch, fm,
                                           num_frame_per_block=3,
                                           noise_aug_max_timestep=100)
    trainer = DiffusionTrainer(model, loss_fn, learning_rate=1e-5)
    ema = EmaParams(model, decay=0.999)
    draw_gen = torch.Generator(device=dev).manual_seed(3)
    n_params = sum(p.numel() for p in model.parameters())
    # the loss covers the noisy half; the clean half is conditioning
    trained = frames * 60 * 104 // 4
    torch.cuda.synchronize()
    emit({"phase": "train_init", "seconds": time.perf_counter() - t0,
          "params": n_params, "trained_tokens": trained,
          "sequence_tokens": 2 * trained})

    def step():
        draws = draw_teacher_forcing(draw_gen, batch["latents"].shape, 3,
                                     len(sch.timesteps), 100, dev)
        loss = trainer.train_step(batch, draws)
        ema.update(model)
        return loss

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    emit({"phase": "train_warmup", "seconds": time.perf_counter() - t0,
          "loss": loss.item()})

    attn.reset_launch_counts()
    steps = []
    for i in range(timed_steps):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        row = {"phase": "train_step", "step": i, "seconds": seconds,
               "loss": loss.item(), "grad_norm": trainer.grad_norm.item(),
               "trained_tokens_per_s": trained / seconds}
        emit(row)
        steps.append(row)
        check(math.isfinite(row["loss"]), row)
        check(math.isfinite(row["grad_norm"]) and row["grad_norm"] > 0, row)
    counts = dict(attn.launch_counts)
    expected = _train_launches(cfg.num_layers, timed_steps)
    moved = max((ema.shadow[n] - p.detach()).abs().max().item()
                for n, p in model.named_parameters())
    emit({"phase": "train_total", "launches": counts,
          "expected_launches": expected,
          "seconds_per_step": statistics.mean(r["seconds"] for r in steps),
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30,
          "ema_minus_params_max_abs": moved})
    check(counts == expected, (counts, expected))
    check(math.isfinite(moved) and moved > 0, moved)
    return counts, step


def _kernel_of(key: str):
    """The port kernel a profiler kernel name belongs to, or None."""
    masked = ", true>" in key or "ELb1E" in key
    for base in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if f"{base}_kernel" in key:
            return base.replace("flash_", "flash_masked_" if masked
                                else "flash_")
    return None


def phase_train_profile(step, top: int = 14):
    """One 1.3B teacher-forcing step under torch.profiler: device time by
    kernel, the port kernels' shares and the device's idle share of the
    synchronised wall time.  Read by PERF.md's breakdown, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    by_port = {}
    for e in kernels:
        name = _kernel_of(e.key)
        if name:
            by_port[name] = by_port.get(name, 0.0) + \
                e.self_device_time_total / 1e3
    emit({"phase": "train_profile",
          "what": "one 1.3B teacher-forcing step, 30 layers",
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
          "port_kernels_ms": by_port,
          "port_kernels_share_of_busy":
              sum(by_port.values()) / busy_ms if busy_ms else None,
          "top_kernels": [{"name": e.key[:90], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in kernels[:top]]})


def _entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
           bound_ms, bound_by, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def kernels_line(smi, rows, bwd, masked, window_launches, train_counts):
    """The six kernels at their main-path shapes: K1 at group 3 of the
    serving window, K2 / K3 at the training cross-attention, K4-K6 at the
    training self-attention.  `launches` sums the paths each runs on."""
    fwd_src = "mmpl_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "mmpl_tpu_torch/csrc/flash_bwd.cu"
    k1 = rows[MAIN_SHAPE]
    b, m = bwd[BWD_MAIN], masked[MASKED_MAIN]
    grad_err = lambda rs, parts: max(r[f"{p}_max_abs_err"]
                                     for r in rs.values() for p in parts)
    bwd_note = ("plain_ms and library_ms compute dq, dk and dv in one call "
                "(flash_attention_bwd_plain; SDPA's backward)")
    out = [_entry(
        "flash_fwd", fwd_src, "mmpl_tpu/ops/attention.py:324",
        window_launches + train_counts["flash_fwd"],
        max(r["o_max_abs_err"] for r in rows.values()), k1["ms"],
        k1["plain_ms"], k1["bound_ms"], k1["bound_by"], k1["library_ms"],
        at=MAIN_SHAPE, launches_by_path={
            "window": window_launches, "train": train_counts["flash_fwd"]},
        shapes={k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "o_max_abs_err")}
                for k, r in rows.items()})]
    for name, part, line in (("flash_bwd_dkv", "dkv", 373),
                             ("flash_bwd_dq", "dq", 417)):
        out.append(_entry(
            name, bwd_src, f"mmpl_tpu/ops/attention.py:{line}",
            train_counts[name],
            grad_err(bwd, ("dk", "dv") if part == "dkv" else ("dq",)),
            b[f"{part}_ms"], b["plain_ms"], b[f"{part}_bound_ms"],
            b[f"{part}_bound_by"], b.get("library_bwd_ms"), at=BWD_MAIN,
            note=bwd_note))
    for name, part, line, plain, lib in (
            ("flash_masked_fwd", "fwd", 725, "plain_fwd_ms", "library_fwd_ms"),
            ("flash_masked_bwd_dkv", "dkv", 783, "plain_bwd_ms",
             "library_bwd_ms"),
            ("flash_masked_bwd_dq", "dq", 821, "plain_bwd_ms",
             "library_bwd_ms")):
        err = (max(r["o_max_abs_err"] for r in masked.values())
               if part == "fwd" else
               grad_err(masked, ("dk", "dv") if part == "dkv" else ("dq",)))
        out.append(_entry(
            name, fwd_src if part == "fwd" else bwd_src,
            f"mmpl_tpu/ops/attention.py:{line}", train_counts[name], err,
            m[f"{part}_ms"], m[plain], m[f"{part}_bound_ms"],
            m[f"{part}_bound_by"], m.get(lib), at=MASKED_MAIN,
            pair_share=m["pair_share"], tile_share=m["tile_share"],
            library=("SDPA, memory-efficient backend, token-level bool mask"
                     + ("" if part == "fwd" else "; " + bwd_note))))
    for e in out:
        e["card"] = smi
    return {"kernels": out}


def main() -> int:
    set_float32_precision()
    smi = phase_device()
    rows = phase_kernel()
    bwd = phase_kernel_bwd()
    masked = phase_kernel_masked()
    phase_cli()
    window_launches, pipe, cond, uncond = phase_window()
    phase_profile(pipe, cond, uncond)
    del pipe, cond, uncond
    torch.cuda.empty_cache()
    phase_train_cli()
    phase_train_parity()
    train_counts, step = phase_train()
    phase_train_profile(step)
    emit(kernels_line(smi, rows, bwd, masked, window_launches, train_counts))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
