"""Drive the PyTorch/CUDA port (mmpl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines as it goes (any failure exits non-zero):
  1. device and build: the card's name and power limit; nvcc builds every
     kernel from mmpl_tpu_torch/csrc;
  2. kernel: K1 (csrc/flash_fwd.cu: bf16 / fp16 on the wgmma + TMA body of
     csrc/flash_fwd_sm90.cuh, fp32 on the template body) against its plain
     PyTorch version at the 1.3B main path's attention shapes, with the
     body that ran (read from the profiler's kernel names), kernel / plain
     / SDPA times and the card's bound; kernel_exp2: P1
     (csrc/flash_fwd.cu, the exp2 probe's forward, on the same two
     bodies), its four variants against the plain version at the probe's
     shape, the few-step path's steady-state self-attention (4680 x 32760,
     where only the variants with the pad test are defined), a ragged
     shape and fp32 at D = 24, beside K1 and SDPA;
  3. kernel_bwd: K2 / K3 (csrc/flash_bwd.cu: bf16 / fp16 on the wgmma +
     TMA body of csrc/flash_bwd_sm90.cuh, with K2's query split and reduce
     where it splits, fp32 on the template body) at the training
     cross-attention shape in bf16 and fp16, the few-step steady-state
     self-attention shape, a ragged shape and D = 24, against the plain
     backward and SDPA's backward, with the body that ran and the split;
  4. kernel_masked: K4 / K5 / K6 under the fps-forcing mask at the 1.3B
     teacher-forcing self-attention shape (42 frames x 1560 tokens), and
     ragged shapes with a frame that sees nothing (bf16, fp16, D = 24,
     fp32) and with whole blocks that see or are seen by nothing, against
     the plain versions and SDPA (memory-efficient backend) with the token
     mask; bf16 / fp16 K4, K5 and K6 run the masked instantiations of K1's,
     K2's and K3's Hopper bodies over the coarse tile tables (their
     admitted and partial shares reported), fp32 the template body;
  5. kernel_int8 (run before kernel_masked, whose large SDPA yardstick
     leaves the short profiler sessions that read a body without their
     records): Q (csrc/int8_gemm.cu) and P2 (the wgmma s8 + TMA body
     of csrc/int8_gemm_sm90.cuh) against their plain versions at the 1.3B
     window's projection shapes, the VAE's im2col shapes (96 channels, the
     3-channel head, the 16-channel conv2, the decoder's first conv), a
     ragged shape and fp32 activations: codes, scales and int32
     accumulators exactly, outputs within 1 ulp, the same bits on a second
     call; the body each ran (profiler names); device times of the kernel,
     torch._int_mm + epilogue and the bf16 matmul, the plain version's and
     the card's bound;
  6. cli, cli_int8: the port's serving CLI in smoke mode (tiny config,
     fp32, 2 windows), then again with --quantize auto --quantize-cache
     --quantize-vae;
  7. window: the 1.3B model (30 layers, random weights, non-zero head) at
     480x832 in bf16, two bridged windows at 4 sampling steps, with exact
     K1 launch counts; profile: one group-3 solver forward under
     torch.profiler (device time by kernel, the device's idle share);
  8. window_int8, profile_int8: the same windows from the same seeds with
     int8 projections (W8A8), the int8 KV cache and the int8 VAE decoder,
     with exact K1 / Q / P2 launch counts, the cache's bytes, and the
     latents' and frames' distance from the bf16 windows;
     profile_int8_vae: one int8 decode of a window under torch.profiler
     (P2, im2col copies, activation codes, the rest); quant_parity:
     the tiny model's int8 fp32 window (and a small int8 decode) on the
     card against the CPU's plain path;
  9. train_cli: `python -m mmpl_tpu_torch.train --smoke --steps 3` in this
     process, with exact launch counts; train_parity: one fp32 loss and
     its gradients of the tiny model on the card against the CPU's plain
     path;
  10. train: teacher forcing of the 1.3B model (30 layers, 21 latent frames
     at 60x104, bf16 trunk over fp32 masters, AdamW, EMA), one warm-up and
     two timed steps with exact launch counts; train_profile: one step
     under torch.profiler;
  11. exp2_probe: the port's probe (`python -m
     mmpl_tpu_torch.tools.exp2_probe`), P1's path;
  12. cli_fewstep, cli_fewstep_int8: the serving CLI with the few-step
     config (configs/self_forcing_dmd.yaml) in smoke mode, 2 windows, with
     --profile and --preview, then with --quantize auto --quantize-cache,
     exact K1 launch counts, 81 + 64 frames and the preview's frames;
  13. fewstep: the few-step path of the 1.3B model at 480x832 in bf16, two
     bridged windows through the CLI's run_windows, exact K1 launch counts
     (2,100 and 1,800), the cache's bytes and a TAEHV preview block;
     fewstep_rolling: 27 frames through a 21-frame ring (2 steady-state
     blocks); profile_fewstep: one steady-state block forward under
     torch.profiler; fewstep_parity: the tiny model's fp32 few-step runs
     (static, with committed context, rolling) on the card against the
     CPU's plain path;
  14. the kernels line, then the final device line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

# Keep CUPTI resident between torch.profiler sessions (the setting torch
# itself uses with CUDA graphs).  With the default teardown and lazy
# re-init, on the card's torch 2.11 / CUDA 12.8 only the first of many
# short sessions recorded the device kernels (1 of 60; 59 of 60 with these
# two), and the body checks below read one short session each.
os.environ.setdefault("TEARDOWN_CUPTI", "0")
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(1)

from mmpl_tpu_torch import cli                                  # noqa: E402
from mmpl_tpu_torch.core.config import WAN_CONFIGS               # noqa: E402
from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS         # noqa: E402
from mmpl_tpu_torch.models import dit, vae                       # noqa: E402
from mmpl_tpu_torch.ops import _build                            # noqa: E402
from mmpl_tpu_torch.ops import attention as attn                 # noqa: E402
from mmpl_tpu_torch.ops import quant                             # noqa: E402
from mmpl_tpu_torch.pipelines import causal_inference             # noqa: E402
from mmpl_tpu_torch.pipelines.fps_inference import \
    CausalFPSInferencePipeline                                    # noqa: E402
from mmpl_tpu_torch.training import masks                        # noqa: E402
from mmpl_tpu_torch.utils.device import set_float32_precision   # noqa: E402
from mmpl_tpu_torch.utils.profiling import (BODY_CALLS,          # noqa: E402
                                            device_kernels,
                                            port_kernel_of, queued_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA,
#: HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: H100 SXM dense int8 tensor-core peak (NVIDIA data sheet), ops/s
PEAK_INT8 = 1979e12

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
    ("fewstep_self_hot", 1, 12, 128, 4680, 32760, torch.bfloat16),
    ("fewstep_cross", 1, 12, 128, 4680, 512, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("smoke_f32", 2, 4, 24, 130, 200, torch.float32),
]
MAIN_SHAPE = "group3_self"

#: P1 shapes, as K1_SHAPES: the JAX probe's shape, the few-step path's
#: steady-state self-attention (Lk ragged for the 64-key tile), a ragged
#: Lq with a tile-multiple Lk, a ragged Lk, and fp32 at the tiny head dim
EXP2_SHAPES = [
    ("probe", 2, 12, 128, 11264, 14336, torch.bfloat16),
    ("fewstep_hot", 1, 12, 128, 4680, 32760, torch.bfloat16),
    ("ragged_lq", 2, 12, 128, 1000, 1280, torch.bfloat16),
    ("ragged_lk", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("d24_f32", 2, 4, 24, 130, 192, torch.float32),
]
EXP2_MAIN = ("probe", "exp2")
#: (name, use_exp2, mask_pad) of P1's variants
EXP2_VARIANTS = (("exp+mask", False, True), ("exp", False, False),
                 ("exp2+mask", True, True), ("exp2", True, False))

#: the few-step run config and the 1.3B few-step windows' K1 launches:
#: blocks x (4 steps + 1 commit) x 30 layers x (self + cross)
FEWSTEP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "self_forcing_dmd.yaml")
FEWSTEP_K1 = (7 * 5 * 30 * 2, 6 * 5 * 30 * 2)

#: K2 / K3 shapes, as K1_SHAPES: the 1.3B teacher-forcing step's
#: cross-attention (65520 tokens over 512 text tokens) in bf16 and fp16,
#: the few-step steady-state self-attention (the shape self-forcing
#: training and the ring backward will run), a ragged shape and the tiny
#: configuration's head dim in bf16 and fp32
BWD_SHAPES = [
    ("tf_cross", 1, 12, 128, 65520, 512, torch.bfloat16),
    ("tf_cross_f16", 1, 12, 128, 65520, 512, torch.float16),
    ("fewstep_self_hot", 1, 12, 128, 4680, 32760, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("d24_bf16", 2, 4, 24, 1000, 1300, torch.bfloat16),
    ("d24_f32", 2, 4, 24, 1000, 1300, torch.float32),
]
BWD_MAIN = "tf_cross"

#: K4-K6 shapes: (label, B, N, D, mask, tokens per frame, dtype).  "fps" is
#: the fps-forcing mask of T2V_CLEAN_STEPS over [clean | noisy] 2 x 21
#: frames of 1560 tokens (L = 65520, the 1.3B teacher-forcing step);
#: "blind" is L = 1000 in frames of 130 under a block-causal mask where
#: frame 1 sees nothing; "dead" is L = 1000 in frames of 300 where frame 1
#: sees nothing and frame 2 is seen by nothing (a 128-query block with no
#: admitted key tile, 128-key blocks with no admitted query tile).  tf_self
#: runs last: after its SDPA yardstick (a 4.3 GB token mask) the short
#: profiler sessions that read the body lost every device record
MASKED_SHAPES = [
    ("ragged_blind", 2, 12, 128, "blind", 130, torch.bfloat16),
    ("ragged_blind_f16", 2, 12, 128, "blind", 130, torch.float16),
    ("dead_blocks", 2, 12, 128, "dead", 300, torch.bfloat16),
    ("d24_bf16_blind", 2, 4, 24, "blind", 130, torch.bfloat16),
    ("d24_f32_blind", 2, 4, 24, "blind", 130, torch.float32),
    ("tf_self", 1, 12, 128, "fps", 1560, torch.bfloat16),
]
MASKED_MAIN = "tf_self"

#: P2 / Q shapes: (label, M, K, N, activation dtype or None, output
#: dtype).  M = 6240, 21840, 18720: the tokens of group 0, group 1 and
#: groups 2/3 of the 1.3B window times the CFG pair; (K, N): the fused
#: qkv, o (and cross-attention q / o), ffn.fc1, ffn.fc2.  The VAE's int8
#: im2col products (per-tensor activation codes made outside Q, sx = 1):
#: "vae_96ch" one 480x832 frame through a 96-channel 3x3x3 decoder conv,
#: "vae_head" the same frame through the head conv (N = 3), "vae_conv2"
#: the post-latent 1x1x1 conv of a window's 21 latent frames at 60x104
#: (K = N = 16), "vae_conv1" the decoder's first conv of one latent frame
#: (16 -> 384 channels, K = 432); "smoke_f32" the tiny model's fp32 qkv.
INT8_SHAPES = [
    (f"g{g}_{name}", M, K, N, torch.bfloat16, torch.bfloat16)
    for g, M in (("0", 6240), ("1", 21840), ("23", 18720))
    for name, K, N in (("qkv", 1536, 4608), ("o", 1536, 1536),
                       ("fc1", 1536, 8960), ("fc2", 8960, 1536))
] + [
    ("vae_96ch", 480 * 832, 96 * 27, 96, None, torch.bfloat16),
    ("vae_head", 480 * 832, 96 * 27, 3, None, torch.bfloat16),
    ("vae_conv2", 21 * 60 * 104, 16, 16, None, torch.bfloat16),
    ("vae_conv1", 60 * 104, 16 * 27, 384, None, torch.bfloat16),
    ("ragged", 1000, 96, 200, torch.bfloat16, torch.bfloat16),
    ("smoke_f32", 224, 96, 288, torch.float32, torch.float32),
]
INT8_MAIN = "g23_fc1"      # P2's main shape: group 3's ffn.fc1
Q_MAIN = "g23_fc2"         # Q's: group 3's ffn.fc2 input (18720 x 8960)

#: projections per layer that run W8A8 under quantize="int8"
W8A8_PER_LAYER = 6

#: forward tolerances (as K1) and gradient tolerances, ||got - plain|| /
#: ||plain|| per dq / dk / dv
FWD_TOL = {"max": 2e-2, "mean": 2e-3, "lse": 1e-3}
FWD_TOL_F32 = {"max": 1e-4, "mean": 1e-4, "lse": 1e-4}
GRAD_REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2,
                torch.float32: 1e-5}

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
        "fwd_o": (4, 2, 2, 0),  # P1: no lse
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
        report = info.get("ptxas", "")
        # C7512: ptxas serialised a kernel's wgmma for want of registers
        emit({"phase": "build", "kernel": name,
              "seconds": round(info.get("seconds", 0.0), 3),
              "cached": name not in log, "ptxas": _ptxas_lines(report),
              "wgmma_serialized": report.count("C7512"),
              "sm90_spill_store_bytes": _spill_bytes(report, "_sm90_kernel")})
    return smi


def _spill_bytes(report: str, pattern: str) -> int:
    """Spill-store bytes summed over the kernels of `nvcc -Xptxas -v`'s
    report whose mangled name holds `pattern`."""
    total, mine = 0, False
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mine = pattern in m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and mine:
            total += int(m.group(1))
    return total


def _ptxas_lines(report: str) -> list:
    """One line per compiled kernel of `nvcc -Xptxas -v`'s report: the
    kernel with its template arguments (mangled), its registers and its
    spill stores."""
    out, kernel, spill = [], "?", "?"
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            kernel, spill = _kernel_id(m.group(1)), "?"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{kernel}: {m.group(1)} registers, {spill} bytes "
                       f"spill stores")
    return out


def _kernel_id(mangled: str) -> str:
    """`name<template arguments>` of a mangled `..._kernel` entry: its
    identifier is the one whose length prefix reaches `_kernel` just
    before the template arguments `I...E`."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            end = m.end() + int(m.group()[i:])
            args = re.match(r"I(\w*?)EEv", mangled[end:])
            if mangled[m.end():end].endswith("_kernel") and args:
                return f"{mangled[m.end():end]}<{args.group(1)}>"
    return mangled


def _launched(fn) -> list:
    """The names of the device kernels that BODY_CALLS calls of `fn`
    launch in one profiler session.  `fn` runs again (after a pause) while
    a session records no device kernel at all; a caller keeps the result
    of its last call."""
    return sorted(device_kernels(fn, BODY_CALLS))


def _body(names, counter: str, dtype) -> str:
    """Which body ran `counter`'s launch among `names`: "wgmma" (the
    `*_sm90_kernel` of csrc/flash_fwd_sm90.cuh or csrc/flash_bwd_sm90.cuh,
    with K2's reduce kernel when the call split the queries) or "template"
    (the fp32 FMA body of csrc/flash_fwd.cu or csrc/flash_bwd.cu, one
    kernel).  bf16 / fp16 K1-K6 and P1 must run the first; fp32 the
    second."""
    mine = [n for n in names if port_kernel_of(n) == counter]
    main = [n for n in mine if "_reduce_kernel" not in n]
    check(len(main) == 1 and len(mine) - len(main) <= 1, (counter, names))
    body = "wgmma" if "_sm90_kernel" in main[0] else "template"
    want = ("wgmma" if dtype in (torch.bfloat16, torch.float16)
            else "template")
    check(body == want and (body == "wgmma" or len(mine) == 1),
          (counter, dtype, mine))
    return body


def phase_kernel():
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, N, D, Lq, Lk, dtype in K1_SHAPES:
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for L in (Lq, Lk, Lk))
        out = {}
        names = _launched(lambda: out.update(r=attn.flash_fwd_cuda(q, k, v)))
        o, lse = out["r"]
        po, plse = attn.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        lerr = (lse - plse).abs()
        row = {"phase": "kernel", "kernel": "flash_fwd", "shape": label,
               "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "dtype": str(dtype).replace("torch.", ""),
               "body": _body(names, "flash_fwd", dtype),
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
        row["bound_share"] = row["bound_ms"] / row["ms"]
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
    """K2 (dK, dV) and K3 (dQ) against the plain backward, with the body
    that ran each (from the profiler's kernel names) and K2's query
    split."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, N, D, Lq, Lk, dtype in BWD_SHAPES:
        q, do = (_rand(gen, dtype, B, Lq, N, D) for _ in range(2))
        k, v = (_rand(gen, dtype, B, Lk, N, D) for _ in range(2))
        o, lse = attn.flash_fwd_cuda(q, k, v)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        out = {}
        names = _launched(lambda: out.update(
            dkv=attn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
            dq=attn.flash_bwd_dq_cuda(q, k, v, do, lse, delta)))
        (dk, dv), dq = out["dkv"], out["dq"]
        want = attn.flash_attention_bwd_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        splits = (1 if dtype == torch.float32
                  else attn.bwd_query_splits(B, N, Lq, Lk, sms))
        reduced = any("_reduce_kernel" in n for n in names)
        row = {"phase": "kernel_bwd", "kernel": "flash_bwd_dkv+flash_bwd_dq",
               "shape": label, "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "dtype": str(dtype).replace("torch.", ""),
               "dkv_body": _body(names, "flash_bwd_dkv", dtype),
               "dq_body": _body(names, "flash_bwd_dq", dtype),
               "splits": splits, "reduce_ran": reduced}
        check(reduced == (splits > 1), row)
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
            row[f"{part}_bound_share"] = (row[f"{part}_bound_ms"]
                                          / row[f"{part}_ms"])
        _library_times(row, q, k, v, do)
        emit(row)
        rows[label] = row
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows


def _masked_inputs(kind, S):
    """(q ids, kv ids, frame mask) on the card, the blind query rows and
    the keys that no query sees (each None where there are none), and the
    share of (query, key) pairs the mask allows."""
    if kind == "fps":
        fm = masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS)
        ids = np.repeat(np.arange(fm.shape[0]), S)
    else:
        L = 1000
        fm = masks.blockwise_causal_frame_mask(-(-L // S), 3)
        fm[1] = False
        if kind == "dead":
            fm[:, 2] = False
        ids = np.repeat(np.arange(fm.shape[0]), S)[:L]
    counts = np.bincount(ids, minlength=fm.shape[0]).astype(np.float64)
    share = float(counts @ fm @ counts) / float(len(ids)) ** 2
    tids = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
    tokens = lambda frames: (torch.as_tensor(frames[ids], device="cuda")
                             if frames.any() else None)
    return ((tids, tids, torch.as_tensor(fm, device="cuda")),
            tokens(~fm.any(axis=1)), tokens(~fm.any(axis=0)), share)


def phase_kernel_masked():
    """K4 (forward), K5 (dK, dV) and K6 (dQ) under a frame mask against
    their plain versions."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, B, N, D, kind, S, dtype in MASKED_SHAPES:
        mask, blind, unseen, share = _masked_inputs(kind, S)
        L = mask[0].numel()
        q, k, v, do = (_rand(gen, dtype, B, L, N, D) for _ in range(4))
        tiles = attn.mask_tiles(*mask)
        out = {}
        names = _launched(lambda: out.update(
            r=attn.flash_fwd_cuda(q, k, v, None, mask, tiles)))
        o, lse = out["r"]
        po, plse = attn.frame_masked_attention_plain(q, k, v, *mask)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        live = torch.isfinite(plse)
        admitted = lambda t: (t != 0).float().mean().item()
        partial = lambda t: (t == 1).float().mean().item()
        row = {"phase": "kernel_masked", "shape": label, "mask": kind,
               "B": B, "N": N, "D": D, "L": L, "frames": mask[2].shape[0],
               "dtype": str(dtype).replace("torch.", ""),
               "fwd_body": _body(names, "flash_masked_fwd", dtype),
               "pair_share": share,
               "tile_share": admitted(tiles.t64),
               "tiles_full_share": (tiles.t64 == 2).float().mean().item(),
               # the Hopper K4's and K6's 128 x 128 and K5's 64 x 128
               # tables
               **{f"{part}_{what}": fn(getattr(tiles, table))
                  for part, table in attn.COARSE_TABLE.items()
                  for what, fn in (("tile_share", admitted),
                                   ("partial_share", partial))},
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
        out = {}
        names = _launched(lambda: out.update(
            dkv=attn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, mask,
                                        tiles),
            dq=attn.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, mask,
                                      tiles)))
        (dk, dv), dq = out["dkv"], out["dq"]
        row["dkv_body"] = _body(names, "flash_masked_bwd_dkv", dtype)
        row["dq_body"] = _body(names, "flash_masked_bwd_dq", dtype)
        want = attn.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                     *mask)
        torch.cuda.synchronize()
        _grad_errors(row, (dq, dk, dv), want, dtype, blind)
        if unseen is not None:
            row["unseen_dkv_zero"] = bool((dk[:, unseen] == 0).all()
                                          and (dv[:, unseen] == 0).all())
            check(row["unseen_dkv_zero"], (label, "dk, dv of unseen keys"))
        del dq, dk, dv, want
        row["fwd_ms"] = time_ms(
            lambda: attn.flash_fwd_cuda(q, k, v, None, mask, tiles))
        row["dkv_ms"] = time_ms(lambda: attn.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, None, mask, tiles))
        row["dq_ms"] = time_ms(lambda: attn.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, None, mask, tiles))
        row["mask_tiles_ms"] = time_ms(lambda: attn.mask_tiles(*mask))
        row["plain_fwd_ms"] = time_ms(
            lambda: attn.frame_masked_attention_plain(q, k, v, *mask),
            max_reps=5)
        row["plain_bwd_ms"] = time_ms(
            lambda: attn.frame_masked_attention_bwd_plain(
                q, k, v, do, lse, delta, *mask), max_reps=5)
        hopper = dtype != torch.float32
        for part in ("fwd", "dkv", "dq"):
            # the ids, the frame table and the tile table the kernel reads
            table = (getattr(tiles, attn.COARSE_TABLE[part]) if hopper
                     else tiles.t64)
            mask_bytes = 4 * 2 * L + mask[2].numel() + table.numel()
            work = attention_work(part, B, N, D, L, L, dtype, share,
                                  mask_bytes)
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = roofline(
                *work, dtype)
            row[f"{part}_tflops"] = work[0] / row[f"{part}_ms"] / 1e9
            row[f"{part}_bound_share"] = (row[f"{part}_bound_ms"]
                                          / row[f"{part}_ms"])
            # the same at the admitted share of the tiles the kernel walks
            row[f"{part}_tile_bound_ms"] = roofline(*attention_work(
                part, B, N, D, L, L, dtype, admitted(table), mask_bytes),
                dtype)[0]
        token_mask = mask[2][mask[0].long()][:, mask[1].long()]
        _library_times(row, q, k, v, do, token_mask)
        del token_mask
        emit(row)
        rows[label] = row
        del q, k, v, do, o, lse, delta, tiles
        torch.cuda.empty_cache()
    return rows


def _ulps(got, want) -> int:
    """Largest distance in units in the last place between two bf16 or
    fp32 tensors of the same signs (their bit patterns as integers)."""
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.view(view).long() - want.view(view).long()).abs().max().item()


def _esize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


#: calls of one kernel_int8 timing (profiling.queued_ms)
INT8_TIMED_CALLS = 10


def _device_ms(fn, counter=None, reps: int = INT8_TIMED_CALLS):
    """(device ms of one call, names of the kernels that book to
    `counter`): the time of `reps` calls queued on the card
    (profiling.queued_ms), free of the host's time around each launch; the
    names from a torch.profiler session of `reps` calls (a session may
    lose the records of its first few kernels)."""
    names = [] if counter is None else [
        n for n in device_kernels(fn, reps) if port_kernel_of(n) == counter]
    return queued_ms(fn, reps), names


def _int8_body(names, counter: str, K: int) -> str:
    """The body that ran: P2 "wgmma" (`int8_gemm_sm90_kernel`); Q
    "one_read" (`quantize_rows_sm90_kernel`) or, past the rows its
    registers hold (quant.q_row_warps(K) = 0), "two_read"."""
    check(len(names) == 1, (counter, names))
    if counter == "int8_gemm":
        check("int8_gemm_sm90_kernel" in names[0], names)
        return "wgmma"
    body = ("one_read" if "quantize_rows_sm90_kernel" in names[0]
            else "two_read")
    check(body == ("one_read" if quant.q_row_warps(K) else "two_read"),
          (K, names))
    return body


def phase_kernel_int8():
    """Q (per-token codes) and P2 (int8 product, rescale epilogue) against
    their plain versions, the body each ran, and their device times
    beside the library's."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, M, K, N, act, out in INT8_SHAPES:
        w = torch.randn((N, K), generator=gen, device="cuda")
        wq, sw = quant.quantize_weight(w)
        row = {"phase": "kernel_int8", "shape": label, "M": M, "K": K,
               "N": N, "act": str(act).replace("torch.", ""),
               "out": str(out).replace("torch.", ""),
               "tile_n": quant.p2_tile_n(N)}
        if act is None:
            xq = torch.randint(-127, 128, (M, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            sx, sw = None, sw * 0.01
            x = xq.to(torch.bfloat16)
        else:
            x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(act)
            xq, sx = quant.quantize_rows_cuda(x)
            pq, psx = quant.quantize_rows_plain(x)
            torch.cuda.synchronize()
            row["q_codes_equal"] = bool(torch.equal(xq, pq))
            row["q_scales_equal"] = bool(torch.equal(sx, psx))
            row["q_max_abs_err"] = max(
                (xq.int() - pq.int()).abs().max().item(),
                (sx - psx).abs().max().item())
            check(row["q_codes_equal"] and row["q_scales_equal"], row)
            again, again_s = quant.quantize_rows_cuda(x)
            row["q_repeat_equal"] = bool(torch.equal(again, xq)
                                         and torch.equal(again_s, sx))
            check(row["q_repeat_equal"], row)
            del pq, psx, again, again_s
        acc = quant.int8_gemm_cuda(xq, wq, None, None, torch.int32)
        pacc = quant.int8_gemm_plain(xq, wq, None, None, torch.int32)
        torch.cuda.synchronize()
        row["acc_equal"] = bool(torch.equal(acc, pacc))
        row["acc_max_abs"] = pacc.abs().max().item()
        check(row["acc_equal"], row)
        del acc, pacc
        y = quant.int8_gemm_cuda(xq, wq, sx, sw, out)
        py = quant.int8_gemm_plain(xq, wq, sx, sw, out)
        torch.cuda.synchronize()
        row["out_max_ulps"] = _ulps(y, py)
        row["max_abs_err"] = (y.float() - py.float()).abs().max().item()
        check(row["out_max_ulps"] <= 1, row)
        row["repeat_equal"] = bool(torch.equal(
            quant.int8_gemm_cuda(xq, wq, sx, sw, out), y))
        check(row["repeat_equal"], row)
        del y, py
        row["ms"], names = _device_ms(
            lambda: quant.int8_gemm_cuda(xq, wq, sx, sw, out), "int8_gemm")
        row["body"] = _int8_body(names, "int8_gemm", K)
        row["call_ms"] = time_ms(
            lambda: quant.int8_gemm_cuda(xq, wq, sx, sw, out))
        row["plain_ms"] = time_ms(
            lambda: quant.int8_gemm_plain(xq, wq, sx, sw, out), max_reps=5)
        ops = 2.0 * M * N * K
        nbytes = M * K + N * K + 4 * N + M * N * _esize(out) + (
            4 * M if sx is not None else 0)
        t_ops, t_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES
        row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tops"] = ops / row["ms"] / 1e9

        def library():      # the yardstick only: the port never calls it
            yl = torch._int_mm(xq, wq.t()).float()
            if sx is not None:
                yl = yl * sx[:, None]
            return (yl * sw[None, :]).to(out)
        try:
            row["library_ms"] = _device_ms(library)[0]
        except RuntimeError as exc:
            row["library_ms"] = None
            row["library_error"] = str(exc).splitlines()[0][:200]
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        row["bf16_matmul_ms"] = _device_ms(lambda: torch.matmul(xb, wb.t()))[0]
        del xb, wb
        if act is not None:
            row["q_ms"], names = _device_ms(
                lambda: quant.quantize_rows_cuda(x), "quantize_rows")
            row["q_body"] = _int8_body(names, "quantize_rows", K)
            row["q_row_warps"] = quant.q_row_warps(K)
            row["q_call_ms"] = time_ms(lambda: quant.quantize_rows_cuda(x))
            row["q_plain_ms"] = time_ms(lambda: quant.quantize_rows_plain(x),
                                        max_reps=5)
            row["q_bound_ms"] = 1e3 * (M * K * (_esize(act) + 1) + 4 * M
                                       ) / PEAK_BYTES
            row["q_bound_share"] = row["q_bound_ms"] / row["q_ms"]
        emit(row)
        rows[label] = row
        del x, xq, w, wq
        torch.cuda.empty_cache()
    return rows


def _capture_writes():
    """Record what the CLI hands `write_video` ({path: frames}); returns
    (written, restore)."""
    from mmpl_tpu_torch.utils import video_io
    written = {}
    original = video_io.write_video

    def capture(path, frames, fps=16):
        written[path] = frames
        return original(path, frames, fps)

    video_io.write_video = capture
    return written, lambda: setattr(video_io, "write_video", original)


def phase_cli():
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, "smoke.mp4")
    written, restore = _capture_writes()
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["--model", "smoke", "--duration", "2",
                       "--sampling-steps", "4", "--device", "cuda",
                       "--output", out])
    finally:
        restore()
    launches = attn.launch_counts["flash_fwd"]
    frames = written[out]
    # tiny config: 2 layers x (self + cross) per forward; 19 + 15 forwards
    expected = 2 * 2 * (19 + 15)
    emit({"phase": "cli", "rc": rc, "seconds": time.perf_counter() - t0,
          "frames_shape": list(frames.shape), "dtype": str(frames.dtype),
          "flash_fwd_launches": launches, "expected_launches": expected})
    check(rc == 0, f"cli exit code {rc}")
    check(frames.shape == (157, 64, 64, 3) and str(frames.dtype) == "uint8",
          (frames.shape, frames.dtype))
    check(launches == expected, (launches, expected))


def phase_cli_int8():
    """The serving CLI in smoke mode with every int8 flag: auto policy
    (its probe forwards launch P2 too), int8 cache, int8 VAE decoder.
    Every W8A8 product is one Q and one P2; each commit forward adds a Q
    for k and one for v per layer; the VAE adds one P2 per im2col
    chunk."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, "smoke_int8.mp4")
    written, restore = _capture_writes()
    quant.reset_launch_counts()
    vae.int8_conv_counts.update(convs=0, chunks=0)
    t0 = time.perf_counter()
    try:
        rc = cli.main(["--model", "smoke", "--duration", "2",
                       "--sampling-steps", "4", "--device", "cuda",
                       "--quantize", "auto", "--quantize-cache",
                       "--quantize-vae", "--output", out])
    finally:
        restore()
    counts = dict(quant.launch_counts)
    frames = written[out]
    emit({"phase": "cli_int8", "rc": rc, "seconds": time.perf_counter() - t0,
          "frames_shape": list(frames.shape), "dtype": str(frames.dtype),
          "launches": counts, "vae_int8": dict(vae.int8_conv_counts),
          "auto_policy": dit.last_auto_quantize_report.get("policy"),
          "auto_mixed_rel_err":
              dit.last_auto_quantize_report.get("mixed_rel_err")})
    check(rc == 0, f"cli exit code {rc}")
    check(frames.shape == (157, 64, 64, 3) and str(frames.dtype) == "uint8",
          (frames.shape, frames.dtype))
    check(counts["quantize_rows"] > 0 and vae.int8_conv_counts["convs"] > 0,
          (counts, vae.int8_conv_counts))
    # tiny config: 2 layers; Q also codes k and v in each commit forward
    cache_q = 2 * 2 * sum(WINDOW_COMMITS)
    check(counts["int8_gemm"] == counts["quantize_rows"] - cache_q
          + vae.int8_conv_counts["chunks"], (counts, vae.int8_conv_counts))


def _window_forwards(steps: int) -> int:
    """DiT forwards of the two bridged windows: window 0 runs 4 groups of
    `steps` solver forwards and 3 commits, window 1 commits its 2 bridged
    latent frames (group 0) and runs 3 groups and their commits."""
    return (4 * steps + 3) + (3 * steps + 3)


#: commit forwards (the cache writes) of the two bridged windows: groups
#: 0-2 of window 0, the bridge commit and groups 1-2 of window 1
WINDOW_COMMITS = (3, 3)


def _run_windows(phase, steps, quantize=None, quantize_cache=False,
                 quantize_vae=False):
    """Two bridged 1.3B windows at 480x832 in bf16 from the same seeds
    (model 0, head 99, VAE 1, text 2 / 3, noise 100), with the int8
    options asked for.  Returns (pipe, cond, uncond, rows, latents,
    frames, caches): per-window rows, latents on the host, frames, and
    each KV cache's {name: (dtype, bytes)}."""
    from mmpl_tpu_torch.pipelines import fps_inference
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    t0 = time.perf_counter()
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(0), torch.bfloat16, dev), g(99))
    vae_model = vae.init_vae_params(g(1), torch.float32, dev)
    if quantize_vae:
        vae.quantize_vae_decoder(vae_model)
    cond, uncond = cli.random_text_context(cfg, dev)
    pipe = CausalFPSInferencePipeline(cfg, model, sampling_steps=steps,
                                      quantize=quantize,
                                      quantize_cache=quantize_cache,
                                      dtype=torch.bfloat16)
    pipe.sync_timing = True
    torch.cuda.synchronize()
    emit({"phase": f"{phase}_init", "seconds": time.perf_counter() - t0})

    rows, latents, frames_out, caches = [], [], [], []
    counted = {}        # launches and int8 convs up to the previous window

    def counts_now():
        return {"flash_fwd": attn.launch_counts["flash_fwd"],
                **quant.launch_counts,
                **{f"vae_int8_{k}": v for k, v in vae.int8_conv_counts.items()}}

    def on_window(win, lat, frames, seconds):
        lat = lat.float()
        finite = bool(torch.isfinite(lat).all().item())
        std = lat.std().item()
        new_frames = 21 if win == 0 else 19
        now = counts_now()
        row = {"phase": phase, "window": win, "seconds": seconds,
               "new_latent_frames": new_frames,
               "latent_frames_per_s": new_frames / seconds,
               "latents_finite": finite, "latents_std": std,
               "frames_shape": list(frames.shape),
               "launches": {k: v - counted.get(k, 0) for k, v in now.items()}}
        counted.update(now)
        for key, val in pipe.phase_times.items():
            if key.endswith("_steps_s"):
                row[key.replace("_steps_s", "_ms_per_step")] = \
                    1e3 * val / steps
            else:
                row[key.replace("_s", "_ms")] = 1e3 * val
        rows.append(row)
        latents.append(lat.cpu())
        frames_out.append(frames)
        check(finite and std > 1e-3, row)
        check(frames.shape == (1, 81, 480, 832, 3), frames.shape)

    def capture(*args, **kwargs):
        cache = make_cache(*args, **kwargs)
        caches.append({k: (str(v.dtype).replace("torch.", ""),
                           v.numel() * v.element_size())
                       for k, v in cache.items()})
        return cache

    make_cache = fps_inference.init_kv_cache
    fps_inference.init_kv_cache = capture
    attn.reset_launch_counts()
    quant.reset_launch_counts()
    vae.int8_conv_counts.update(convs=0, chunks=0)
    torch.cuda.reset_peak_memory_stats()
    try:
        full = cli.run_windows(pipe, vae_model, cond, uncond, 2, (60, 104),
                               g(100), on_window)
    finally:
        fps_inference.init_kv_cache = make_cache
    check(full[0].shape == (157, 480, 832, 3) and str(full.dtype) == "uint8",
          (full.shape, full.dtype))
    return pipe, cond, uncond, rows, latents, frames_out, caches


def phase_window(steps: int = 4):
    """The bf16 windows: the serving path's K1 launches, exactly."""
    pipe, cond, uncond, rows, latents, frames, _ = _run_windows(
        "window", steps)
    launches = attn.launch_counts["flash_fwd"]
    expected = 2 * pipe.cfg.num_layers * _window_forwards(steps)
    for row in rows:
        emit(row)
    emit({"phase": "window_total", "flash_fwd_launches": launches,
          "expected_launches": expected,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30})
    check(launches == expected, (launches, expected))
    return launches, pipe, cond, uncond, (rows, latents, frames)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def phase_window_int8(bf16, steps: int = 4):
    """The same two windows with W8A8 projections, the int8 KV cache and
    the int8 VAE decoder.  Launches, exactly: Q and P2 once per W8A8
    projection (6 per layer and forward: 3x the K1 count), Q once more
    for k and once for v per layer in each commit forward, P2 once more
    per im2col chunk of an int8 conv (counted per window); the cache int8
    with its bytes; the latents and frames against the bf16 windows'
    (reported, not gated)."""
    pipe, cond, uncond, rows, latents, frames, caches = _run_windows(
        "window_int8", steps, quantize="int8", quantize_cache=True,
        quantize_vae=True)
    cfg = pipe.cfg
    k1 = attn.launch_counts["flash_fwd"]
    counts = dict(quant.launch_counts)
    chunks = dict(vae.int8_conv_counts)
    per_window = [(4 * steps + 3, WINDOW_COMMITS[0]),
                  (3 * steps + 3, WINDOW_COMMITS[1])]
    for row, (forwards, commits) in zip(rows, per_window):
        got = row["launches"]
        w8a8 = W8A8_PER_LAYER * cfg.num_layers * forwards
        want = {"flash_fwd": 2 * cfg.num_layers * forwards,
                "quantize_rows": w8a8 + 2 * cfg.num_layers * commits,
                "int8_gemm": w8a8 + got["vae_int8_chunks"]}
        check({k: got[k] for k in want} == want, (row["window"], got, want))
    forwards = _window_forwards(steps)
    cache_q = 2 * cfg.num_layers * sum(WINDOW_COMMITS)
    expected = {"flash_fwd": 2 * cfg.num_layers * forwards,
                "quantize_rows": W8A8_PER_LAYER * cfg.num_layers * forwards
                + cache_q}
    expected["int8_gemm"] = (expected["quantize_rows"] - cache_q
                             + chunks["chunks"])
    b_rows, b_lat, b_frames = bf16
    for row, lat, fr, blat, bfr, brow in zip(rows, latents, frames, b_lat,
                                              b_frames, b_rows):
        row["latents_rel_err_vs_bf16"] = (
            (lat - blat).norm() / blat.norm()).item()
        row["latents_cosine_vs_bf16"] = torch.nn.functional.cosine_similarity(
            lat.reshape(1, -1).double(), blat.reshape(1, -1).double()).item()
        row["frames_psnr_db_vs_bf16"] = _psnr(fr, bfr)
        row["bf16_seconds"] = brow["seconds"]
        emit(row)
    L, B2, S, D = cfg.num_layers, 2, 60 * 104 // 4, cfg.dim
    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    tokens = L * B2 * KV_CACHE_SLOTS * S
    want_bytes = {"k": tokens * D, "v": tokens * D, "k_scale": 4 * tokens,
                  "v_scale": 4 * tokens}
    got_bytes = {k: b for k, (_, b) in caches[0].items()}
    got_dtypes = {k: d for k, (d, _) in caches[0].items()}
    emit({"phase": "window_int8_total", "launches": counts,
          "flash_fwd_launches": k1, "expected_launches": expected,
          "vae_int8": chunks, "kv_cache_dtypes": got_dtypes,
          "kv_cache_bytes": got_bytes, "expected_kv_cache_bytes": want_bytes,
          "kv_cache_gb": sum(got_bytes.values()) / 1e9,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30})
    check(k1 == expected["flash_fwd"], (k1, expected))
    check(counts == {"int8_gemm": expected["int8_gemm"],
                     "quantize_rows": expected["quantize_rows"]},
          (counts, expected))
    check(counts["quantize_rows"] == 3 * k1 + cache_q, (counts, k1))
    check(chunks["convs"] > 0, chunks)
    check(len(caches) == 2 and all(c == caches[0] for c in caches), caches)
    check(got_dtypes == {"k": "int8", "v": "int8", "k_scale": "float32",
                         "v_scale": "float32"}, got_dtypes)
    check(got_bytes == want_bytes, (got_bytes, want_bytes))
    return {"flash_fwd": k1, **counts}, pipe, cond, uncond


def phase_quant_parity(steps: int = 4):
    """The tiny model's int8 window (W8A8, int8 cache), fp32, on the card
    against the CPU's plain path from the same weights, noise and reseed
    noise; and a small int8 VAE decode.  The int8 window is chaotic in
    the last bit: a code flips where an fp32 difference (here the order
    of sums) crosses a rounding boundary, and CFG amplifies it; this phase
    measures how far one fp32 ulp of the noise moves the card's own int8
    window.  Gates: the float window within 1e-4; the int8 window within
    1e-2 (about 5x that sensitivity) and nearer the CPU's int8 window than
    the card's float window is; the int8 decode within 0.1 (rel, as
    tests/test_torch_quant_vae.py holds the two packages) and nearer the
    CPU's int8 decode than the card's float decode is, so that a card
    path that skipped int8 fails.  One bidirectional forward, free of the
    window's amplification, separates the two by far more: its int8 output
    within 1e-3 of the CPU's and within a tenth of the float forward's
    distance from it."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((1, 21, 16, 4, 4)).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, cfg.text_len, cfg.text_dim))
                    .astype(np.float32) for _ in range(2))
    from mmpl_tpu_torch.core.geometry import t2v_plan
    reseed = {gi: rng.standard_normal((1, len(g.reseed), 16, 4, 4)).astype(
        np.float32) for gi, g in enumerate(t2v_plan().groups) if g.reseed}

    def window(dev, quantize, noise_np=noise):
        pipe = CausalFPSInferencePipeline(
            cfg, copy.deepcopy(model).to(dev), sampling_steps=steps,
            quantize=quantize, quantize_cache=quantize is not None,
            dtype=torch.float32)
        t = lambda a: torch.from_numpy(a).to(dev)
        return pipe.inference(t(noise_np), t(cond), t(uncond),
                              reseed_noise={k: t(v) for k, v in
                                            reseed.items()}).cpu()

    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    quant.reset_launch_counts()
    float_gpu = window("cuda", None)
    row = {"phase": "quant_parity", "steps": steps,
           "float_rel_err": rel(float_gpu, window("cpu", None))}
    got, want = window("cuda", "int8"), window("cpu", "int8")
    row["int8_launches"] = dict(quant.launch_counts)
    row["int8_rel_err"] = rel(got, want)
    row["card_float_vs_cpu_int8_rel"] = rel(float_gpu, want)
    row["int8_finite"] = bool(torch.isfinite(got).all())
    row["int8_card_ulp_sensitivity"] = rel(
        window("cuda", "int8", np.nextafter(noise, np.float32(np.inf))), got)
    float_vae = vae.init_vae_params(torch.Generator().manual_seed(1))
    vae_model = vae.quantize_vae_decoder(copy.deepcopy(float_vae))
    z = torch.from_numpy(rng.standard_normal((1, 2, 16, 4, 4)).astype(
        np.float32))
    px_cpu = vae.decode_streaming(vae_model, z)
    px_gpu = vae.decode_streaming(vae_model.to("cuda"), z.cuda()).cpu()
    px_float = vae.decode_streaming(float_vae.to("cuda"), z.cuda()).cpu()
    row["int8_decode_rel_err"] = rel(px_gpu, px_cpu)
    row["card_float_decode_vs_cpu_int8_rel"] = rel(px_float, px_cpu)

    fwd_rng = np.random.default_rng(12)
    lat = fwd_rng.standard_normal((1, 3, 16, 8, 8)).astype(np.float32)

    def forward(dev, quantize):
        m = dit.apply_quantize(dit.fuse_qkv_params(
            copy.deepcopy(model).to(dev), num_heads=cfg.num_heads), quantize)
        to = lambda a: torch.from_numpy(a).to(dev)
        with torch.inference_mode():
            return dit.dit_forward(m, cfg, to(lat), torch.full(
                (1,), 500.0, device=dev), to(cond)).cpu()

    fwd_cpu = forward("cpu", "int8")
    row["int8_forward_rel_err"] = rel(forward("cuda", "int8"), fwd_cpu)
    row["card_float_forward_vs_cpu_int8_rel"] = rel(forward("cuda", None),
                                                    fwd_cpu)
    emit(row)
    check(row["float_rel_err"] <= 1e-4, row)
    check(row["int8_finite"] and row["int8_rel_err"] <= 1e-2, row)
    check(row["int8_rel_err"] < row["card_float_vs_cpu_int8_rel"], row)
    check(row["int8_launches"]["quantize_rows"] > 0, row)
    check(row["int8_decode_rel_err"] <= 0.1, row)
    check(row["int8_decode_rel_err"]
          < row["card_float_decode_vs_cpu_int8_rel"], row)
    check(row["int8_forward_rel_err"] <= 1e-3 and row["int8_forward_rel_err"]
          < 0.1 * row["card_float_forward_vs_cpu_int8_rel"], row)


def _profile_step(step, what: str, phase: str, top: int = 12) -> dict:
    """`step` once to warm up, then once under torch.profiler: device time
    by kernel, the port kernels' shares and the device's idle share of the
    synchronised wall time.  Reports what it sees; the numbers are read by
    PERF.md's time breakdown, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    by_port = _by_port(kernels)
    k1_ms = by_port.get("flash_fwd", 0.0)
    p2_ms = by_port.get("int8_gemm", 0.0)
    q_ms = by_port.get("quantize_rows", 0.0)
    row = {"phase": phase, "what": what,
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
           "flash_fwd_ms": k1_ms,
           "flash_fwd_share_of_busy": k1_ms / busy_ms if busy_ms else None,
           "int8_gemm_ms": p2_ms, "quantize_rows_ms": q_ms,
           "int8_share_of_busy": (p2_ms + q_ms) / busy_ms if busy_ms
           else None,
           "port_kernels_ms": by_port,
           "int8_kernels": {e.key[:90]: {"calls": e.count,
                                         "ms": e.self_device_time_total / 1e3}
                            for e in kernels if port_kernel_of(e.key) in
                            ("int8_gemm", "quantize_rows")},
           "top_kernels": [{"name": e.key[:90], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in kernels[:top]]}
    emit(row)
    # the serving forward runs K1 and no masked kernel
    check(k1_ms > 0 and "flash_masked_fwd" not in by_port, row)
    return row


def _by_port(kernels) -> dict:
    """Device ms of each port kernel (by launch counter) among the
    profiler's `kernels`; a Hopper-body kernel (K2's reduce included) must
    book to K1-K6, P1, P2 or Q, never to nothing; and a masked Hopper
    kernel to K4, K5 or K6 alone."""
    by_port = {}
    for e in kernels:
        name = port_kernel_of(e.key)
        if "_sm90_kernel" in e.key or "_reduce_kernel" in e.key:
            check(name in ("flash_fwd", "flash_masked_fwd", "flash_exp2",
                           "flash_bwd_dkv", "flash_masked_bwd_dkv",
                           "flash_bwd_dq", "flash_masked_bwd_dq",
                           "int8_gemm", "quantize_rows"),
                  e.key)
            check(("_masked_" in e.key) == (name in (
                "flash_masked_fwd", "flash_masked_bwd_dkv",
                "flash_masked_bwd_dq")), e.key)
        if name:
            by_port[name] = by_port.get(name, 0.0) + \
                e.self_device_time_total / 1e3
    return by_port


def phase_profile_int8_vae(top: int = 12):
    """One int8 `decode_to_frames` of a window (21 latent frames at 60x104
    to 81 frames at 480x832; window_int8's int8 VAE decoder, from the same
    seed) under torch.profiler: device time by kernel, the idle share, and
    the split between P2, the im2col copies, the activation codes and the
    copies of the products into the output (vae.INT8_CONV_RANGES: each
    range's device time is that of the kernels launched inside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    vae_model = vae.quantize_vae_decoder(vae.init_vae_params(
        torch.Generator(device=dev).manual_seed(1), torch.float32, dev))
    lat = torch.randn((1, 21, 16, 60, 104), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(8))
    vae.decode_to_frames(vae_model, lat)      # the im2col weights, once
    torch.cuda.synchronize()
    quant.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames, _ = vae.decode_to_frames(vae_model, lat)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ranges = vae.INT8_CONV_RANGES
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in ranges
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    in_range = {r.split(".")[-1] + "_ms": sum(
        e.device_time_total for e in events
        if e.device_type == DeviceType.CPU and e.key == r) / 1e3
        for r in ranges}
    p2 = [e for e in kernels if port_kernel_of(e.key) == "int8_gemm"]
    p2_ms = sum(e.self_device_time_total for e in p2) / 1e3
    row = {"phase": "profile_int8_vae",
           "what": "int8 decode_to_frames, 21 latent frames -> 81 at 480x832",
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
           "int8_gemm_ms": p2_ms, "int8_gemm_launches":
               quant.launch_counts["int8_gemm"],
           "int8_gemm_kernels": {e.key[:90]: e.count for e in p2},
           **in_range,
           "other_ms": busy_ms - p2_ms - sum(in_range.values()),
           "top_kernels": [{"name": e.key[:90], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in kernels[:top]]}
    emit(row)
    check(tuple(frames.shape) == (1, 81, 480, 832, 3), frames.shape)
    check(p2_ms > 0 and quant.launch_counts["int8_gemm"] > 0
          and all("_sm90_kernel" in e.key for e in p2), row)
    del vae_model, lat, frames
    torch.cuda.empty_cache()


def phase_profile(pipe, cond, uncond, top: int = 12, phase="profile"):
    """One group-3 solver forward (the heaviest step) under torch.profiler:
    device time by kernel, K1's (and P2's and Q's) share, and the device's
    idle share of the synchronised wall time."""
    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    from mmpl_tpu_torch.models.fps_dit import init_kv_cache

    schedule = pipe.plan.groups[3]
    dev = cond.device
    ctx_kv2 = pipe.prepare_context(cond, uncond)
    cache = init_kv_cache(pipe.cfg, 2, 60 * 104 // 4, KV_CACHE_SLOTS,
                          torch.bfloat16, dev, quantize=pipe.quantize_cache)
    lat = torch.randn((1, schedule.num_frames, 16, 60, 104), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(7))

    def step():
        with torch.inference_mode():
            pipe._forward(schedule, ctx_kv2, cache, lat, 500.0, False)

    row = _profile_step(step, "group3 solver forward, 30 layers", phase, top)
    if phase == "profile_int8":
        # W8A8 runs P2's Hopper body and Q's one-read body (K = 1536, 8960)
        names = list(row["int8_kernels"])
        check(row["int8_gemm_ms"] > 0 and row["quantize_rows_ms"] > 0
              and all("_sm90_kernel" in n for n in names), names)


def _train_launches(num_layers: int, steps: int) -> dict:
    """Every attention kernel's launches in `steps` training steps (0 for
    the kernels training does not run)."""
    return {**dict.fromkeys(attn.launch_counts, 0),
            **{name: n * num_layers * steps
               for name, n in TRAIN_LAUNCHES_PER_LAYER.items()}}


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
    by_port = _by_port(kernels)
    row = {"phase": "train_profile",
           "what": "one 1.3B teacher-forcing step, 30 layers",
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
           "port_kernels_ms": by_port,
           "port_kernels_share_of_busy":
               sum(by_port.values()) / busy_ms if busy_ms else None,
           "top_kernels": [{"name": e.key[:90], "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in kernels[:top]]}
    emit(row)
    # K1 (bf16 cross-attention) books to K1, and K4-K6 to themselves
    check(by_port.get("flash_fwd", 0.0) > 0, row)
    check(all(by_port.get(k, 0.0) > 0 for k in TRAIN_LAUNCHES_PER_LAYER), row)


def phase_kernel_exp2():
    """P1's four variants against their plain version at EXP2_SHAPES,
    beside K1 and SDPA on the same inputs; where Lk is not a multiple of
    the 64-key tile the variants without the pad test must be refused."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, B, N, D, Lq, Lk, dtype in EXP2_SHAPES:
        q, k, v = (_rand(gen, dtype, B, L, N, D) for L in (Lq, Lk, Lk))
        tol = FWD_TOL_F32 if dtype == torch.float32 else FWD_TOL
        shape = {"B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
                 "dtype": str(dtype).replace("torch.", "")}
        bound_ms, bound_by = roofline(*attention_work(
            "fwd_o", B, N, D, Lq, Lk, dtype), dtype)
        k1_ms = time_ms(lambda: attn.flash_fwd_cuda(q, k, v))
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
        for name, use_exp2, mask_pad in EXP2_VARIANTS:
            row = {"phase": "kernel_exp2", "kernel": "flash_exp2",
                   "shape": label, "variant": name, **shape}
            if not mask_pad and Lk % attn.TILE:
                before = attn.launch_counts["flash_exp2"]
                try:
                    attn.flash_exp2_cuda(q, k, v, use_exp2, mask_pad)
                    refused = False
                except ValueError:
                    refused = True
                row["refused"] = refused and (
                    attn.launch_counts["flash_exp2"] == before)
                emit(row)
                check(row["refused"], row)
                continue
            out = {}
            names = _launched(lambda: out.update(
                r=attn.flash_exp2_cuda(q, k, v, use_exp2, mask_pad)))
            o = out["r"]
            po = attn.flash_attention_exp2_plain(q, k, v, use_exp2, mask_pad)
            torch.cuda.synchronize()
            err = (o.float() - po.float()).abs()
            row.update(body=_body(names, "flash_exp2", dtype),
                       o_max_abs_err=err.max().item(),
                       o_mean_abs_err=err.mean().item())
            del o, po, err
            row["ms"] = time_ms(
                lambda: attn.flash_exp2_cuda(q, k, v, use_exp2, mask_pad))
            row["plain_ms"] = time_ms(
                lambda: attn.flash_attention_exp2_plain(q, k, v, use_exp2,
                                                        mask_pad),
                max_reps=5)
            row.update(bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms, k1_ms=k1_ms,
                       tflops=4.0 * B * N * Lq * Lk * D / row["ms"] / 1e9,
                       bound_share=bound_ms / row["ms"])
            emit(row)
            rows[(label, name)] = row
            check(row["o_max_abs_err"] <= tol["max"], row)
            check(row["o_mean_abs_err"] <= tol["mean"], row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_exp2_probe():
    """P1's path: the port's probe, `python -m
    mmpl_tpu_torch.tools.exp2_probe`, in this process; its launches of P1
    are what the kernels line counts."""
    from mmpl_tpu_torch.tools import exp2_probe
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    rows = exp2_probe.run(exp2_probe.parse_args([]))
    launches = attn.launch_counts["flash_exp2"]
    for row in rows:
        emit({"phase": "exp2_probe", **row})
    emit({"phase": "exp2_probe_total", "seconds": time.perf_counter() - t0,
          "flash_exp2_launches": launches})
    check(launches > 0, launches)
    check({(r["shape"], r["variant"]) for r in rows} >= {
        ("probe", n) for n, _, _ in EXP2_VARIANTS}, rows)
    return launches


def phase_cli_fewstep():
    """The serving CLI with the few-step config in smoke mode (tiny model,
    fp32, 64x64): 2 windows of 7 and 6 blocks, 4 steps and a commit each,
    with --profile and --preview; then with --quantize auto
    --quantize-cache.  K1 counts exactly (auto's probe forwards add theirs),
    81 + 64 frames, and the preview's frames: 9 for the first block, 12
    for each later one (its MemBlock state runs on across windows)."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    os.makedirs(OUT_DIR, exist_ok=True)
    layers = tiny_test_config().num_layers
    for phase, extra in (("cli_fewstep", []),
                         ("cli_fewstep_int8", ["--quantize", "auto",
                                               "--quantize-cache"])):
        out = os.path.join(OUT_DIR, f"{phase}.mp4")
        prev = os.path.join(OUT_DIR, f"{phase}_preview.mp4")
        written, restore = _capture_writes()
        attn.reset_launch_counts()
        quant.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["--model", "smoke", "--config", FEWSTEP_CONFIG,
                           "--duration", "2", "--profile", "--preview", prev,
                           "--device", "cuda", "--output", out] + extra)
        finally:
            restore()
        k1 = attn.launch_counts["flash_fwd"]
        counts = dict(quant.launch_counts)
        forwards = (7 + 6) * 5
        expected = 2 * layers * forwards
        if extra:
            report = dit.last_auto_quantize_report
            expected += 2 * layers * (2 + len(report["per_target_rel_err"]))
        row = {"phase": phase, "rc": rc, "seconds": time.perf_counter() - t0,
               "frames_shape": list(written[out].shape),
               "preview_shape": list(written[prev].shape),
               "flash_fwd_launches": k1, "expected_flash_fwd": expected,
               "int8_launches": counts}
        emit(row)
        check(rc == 0, row)
        check(written[out].shape == (81 + 64, 64, 64, 3)
              and written[out].dtype == np.uint8, row)
        check(written[prev].shape == (9 + 12 * 12, 64, 64, 3)
              and written[prev].dtype == np.uint8, row)
        check(k1 == expected, row)
        if extra:
            cache_q = 2 * layers * (7 + 6)    # k and v per commit forward
            check(counts["quantize_rows"] > cache_q and counts["int8_gemm"]
                  == counts["quantize_rows"] - cache_q, row)


def _fewstep_pipe(model, **kw):
    """The 1.3B few-step pipeline of the few-step run config, built as the
    CLI builds it, in bf16."""
    from mmpl_tpu_torch.core.config import load_config
    run_cfg = load_config(FEWSTEP_CONFIG, os.path.join(
        os.path.dirname(FEWSTEP_CONFIG), "default_config.yaml"))
    return cli.few_step_pipeline(WAN_CONFIGS["t2v-1.3B"], model, run_cfg,
                                 run_cfg["timestep_shift"],
                                 dtype=torch.bfloat16, **kw)


def _cache_bytes(cache) -> dict:
    return {k: v.numel() * v.element_size() for k, v in cache.items()}


def phase_fewstep():
    """Two bridged few-step windows of the 1.3B model at 480x832 in bf16
    (random weights from seeds: model 0, head 99, VAE 1, text 2, noise 100)
    through the CLI's run_windows with --profile's synchronised block
    times: K1 launches per window exactly, the cache's bytes, window
    seconds, latent-frames/s and peak memory; then the TAEHV preview of
    one block at this geometry."""
    from mmpl_tpu_torch.models.taehv import init_taehv_params
    from mmpl_tpu_torch.utils.preview import TaehvPreviewer
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    t0 = time.perf_counter()
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(0), torch.bfloat16, dev), g(99))
    vae_model = vae.init_vae_params(g(1), torch.float32, dev)
    cond, uncond = cli.random_text_context(cfg, dev)
    pipe = _fewstep_pipe(model)
    torch.cuda.synchronize()
    emit({"phase": "fewstep_init", "seconds": time.perf_counter() - t0,
          "denoising_step_list": list(pipe.denoising_step_list)})

    rows, caches, first_block = [], [], []
    counted = {"k1": 0}
    make_cache = causal_inference.init_kv_cache

    def capture(*args, **kwargs):
        cache = make_cache(*args, **kwargs)
        caches.append(_cache_bytes(cache))
        return cache

    def on_window(win, lat, frames, seconds):
        lat = lat.float()
        k1 = attn.launch_counts["flash_fwd"]
        blocks = pipe.last_profile.blocks
        row = {"phase": "fewstep", "window": win, "seconds": seconds,
               "new_latent_frames": lat.shape[1],
               "latent_frames_per_s": lat.shape[1] / seconds,
               "block_ms": [1e3 * b for b in blocks],
               "diffusion_s": pipe.last_profile.phases[
                   "Diffusion generation"],
               "vae_decode_s": pipe.last_profile.phases.get("VAE decoding"),
               "latents_finite": bool(torch.isfinite(lat).all().item()),
               "latents_std": lat.std().item(),
               "frames_shape": list(frames.shape),
               "flash_fwd_launches": k1 - counted["k1"],
               "expected_flash_fwd": FEWSTEP_K1[win]}
        counted["k1"] = k1
        rows.append(row)
        emit(row)
        if win == 0:
            first_block.append(lat[:, :6].clone())
        check(row["latents_finite"] and row["latents_std"] > 1e-3, row)
        check(row["flash_fwd_launches"] == FEWSTEP_K1[win], row)
        check(frames.shape == (1, 81 if win == 0 else 69, 480, 832, 3), row)

    causal_inference.init_kv_cache = capture
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        full = cli.run_windows(pipe, vae_model, cond, uncond, 2, (60, 104),
                               g(100), on_window, profile=True)
    finally:
        causal_inference.init_kv_cache = make_cache
    peak = torch.cuda.max_memory_allocated() / 2**30
    del vae_model
    torch.cuda.empty_cache()
    want_bytes = 30 * 21 * 1560 * 1536 * 2
    total = {"phase": "fewstep_total", "frames_shape": list(full.shape),
             "flash_fwd_launches": attn.launch_counts["flash_fwd"],
             "kv_cache_bytes": caches[0], "kv_cache_gb":
             sum(caches[0].values()) / 1e9,
             "max_memory_allocated_gib": peak}
    emit(total)
    check(full.shape == (1, 81 + 64, 480, 832, 3), total)
    check(len(caches) == 2 and all(
        c == {"k": want_bytes, "v": want_bytes} for c in caches), caches)

    # the CLI's previewer (fp32) and, beside it, the same weights in bf16
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        previewer = TaehvPreviewer(init_taehv_params(g(7), device=dev),
                                   dtype=dtype)
        for lo in (0, 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = previewer(first_block[0][:, lo:lo + 3])
            times[f"{str(dtype)[6:]}_{'first' if lo == 0 else 'next'}"
                  "_block_s"] = time.perf_counter() - t0
            check(frames.shape == (1, 9 if lo == 0 else 12, 480, 832, 3)
                  and frames.dtype == np.uint8, frames.shape)
    emit({"phase": "fewstep_preview", **times, "frames_per_block": [9, 12]})
    return pipe.model, cond, rows, total


def phase_fewstep_rolling(model, cond):
    """27 frames through a 21-slot ring: 7 static blocks, then 2
    steady-state blocks at 4680 x 32760, each of which evicts one block by
    a slot permutation (the JAX package rotates every cache leaf).  K1
    launches exactly; the steady-state blocks' ms beside the last static
    block's, which attends to as many keys; peak memory."""
    dev = cond.device
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    pipe = _fewstep_pipe(model, max_attention_frames=21)
    noise = torch.randn((1, 27, 16, 60, 104), generator=g(101), device=dev)
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.inference(noise, cond, generator=g(102), profile=True)
    seconds = time.perf_counter() - t0
    blocks = [1e3 * b for b in pipe.last_profile.blocks]
    cache_bytes = 30 * 21 * 1560 * 1536 * 2 * 2
    row = {"phase": "fewstep_rolling", "seconds": seconds,
           "block_ms": blocks, "static_block6_ms": blocks[6],
           "steady_state_block_ms": blocks[7:],
           "flash_fwd_launches": attn.launch_counts["flash_fwd"],
           "expected_flash_fwd": 9 * 5 * 30 * 2,
           "slot_order": pipe.slot_order,
           "kv_cache_bytes": cache_bytes,
           "jax_eviction_copy_ms_at_peak_bytes":
               1e3 * 2 * cache_bytes / PEAK_BYTES,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "latents_finite": bool(torch.isfinite(out).all().item())}
    emit(row)
    check(row["flash_fwd_launches"] == row["expected_flash_fwd"], row)
    check(tuple(out.shape) == (1, 27, 16, 60, 104) and row["latents_finite"],
          row)
    check(pipe.slot_order == list(range(6, 21)) + list(range(6)), row)
    return pipe


def phase_profile_fewstep(pipe, cond):
    """One steady-state block forward (4680 queries over 32760 keys, 30
    layers) under torch.profiler."""
    from mmpl_tpu_torch.models.fps_dit import init_kv_cache
    from mmpl_tpu_torch.ops.rope import dynamic_rope_table
    dev = cond.device
    ctx = pipe.prepare_context(cond)
    cache = init_kv_cache(pipe.cfg, 1, 1560, 21, torch.bfloat16, dev)
    sched = pipe._rolling_schedule(3, list(range(21)))
    rope = dynamic_rope_table(21, 3, 30, 52, 128, device=dev)
    lat = torch.randn((1, 3, 16, 60, 104), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(8))

    def step():
        with torch.inference_mode():
            pipe._forward(sched, ctx, cache, lat, 500.0, False, rope)

    _profile_step(step, "few-step steady-state block forward, 4680 x 32760, "
                  "30 layers", "profile_fewstep", top=14)


def phase_fewstep_parity():
    """The tiny model's fp32 few-step runs on the card against the CPU's
    plain path, from the same weights, noise and re-noising draws: a
    static window (2 blocks), a run after one committed context block, and
    a rolling run (12 frames through a 6-slot ring).  Each is gated by a
    sensitivity measured here: how far one fp32 ulp of the noise moves the
    card's own run (at most 100 times that, and 1e-4)."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(13)
    cond = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    row = {"phase": "fewstep_parity"}
    for case, F, n_init, kw in (("static", 6, 0, {}),
                                ("context", 3, 3, {}),
                                ("rolling", 12, 0,
                                 {"max_attention_frames": 6})):
        noise = rng.standard_normal((1, F, 16, 4, 4)).astype(np.float32)
        init = rng.standard_normal((1, n_init, 16, 4, 4)).astype(np.float32)
        sn = [rng.standard_normal((1, 1, 3, 16, 4, 4)).astype(np.float32)
              for _ in range(F // 3)]

        def run(dev, noise_np=noise):
            pipe = causal_inference.CausalInferencePipeline(
                cfg, copy.deepcopy(model).to(dev),
                denoising_step_list=(1000, 500), dtype=torch.float32, **kw)
            t = lambda a: torch.from_numpy(a).to(dev)
            return pipe.inference(
                t(noise_np), t(cond),
                initial_latent=t(init) if n_init else None,
                step_noise=[t(a) for a in sn]).cpu()

        card = run("cuda")
        row[f"{case}_rel_err"] = rel(card, run("cpu"))
        row[f"{case}_ulp_sensitivity"] = rel(
            run("cuda", np.nextafter(noise, np.float32(np.inf))), card)
        row[f"{case}_gate"] = min(1e-4, 100 * row[f"{case}_ulp_sensitivity"])
    emit(row)
    for case in ("static", "context", "rolling"):
        check(row[f"{case}_rel_err"] <= row[f"{case}_gate"], row)


def _entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
           bound_ms, bound_by, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def kernels_line(smi, rows, bwd, masked, int8, window_launches,
                 int8_launches, train_counts, exp2, exp2_launches,
                 fewstep_launches):
    """The nine kernels at their main-path shapes: K1 at group 3 of the
    serving window, K2 / K3 at the training cross-attention (and their
    other shapes under `shapes`), K4-K6 at the
    training self-attention, P2 at group 3's ffn.fc1, Q at group 3's
    ffn.fc2 input and P1 (its exp2 variant without the pad test) at the
    probe's shape.  `launches` sums the paths each runs on."""
    fwd_src = "mmpl_tpu_torch/csrc/flash_fwd.cu"
    sm90_src = "mmpl_tpu_torch/csrc/flash_fwd_sm90.cuh"
    bwd_src = "mmpl_tpu_torch/csrc/flash_bwd.cu"
    bodies = ("wgmma + TMA body (flash_fwd_sm90.cuh) for bf16 / fp16, "
              "the template body of flash_fwd.cu for fp32; entry in "
              "flash_fwd.cu")
    k1 = rows[MAIN_SHAPE]
    b, m = bwd[BWD_MAIN], masked[MASKED_MAIN]
    grad_err = lambda rs, parts: max(r[f"{p}_max_abs_err"]
                                     for r in rs.values() for p in parts)
    bwd_note = ("plain_ms and library_ms compute dq, dk and dv in one call "
                "(flash_attention_bwd_plain; SDPA's backward)")
    out = [_entry(
        "flash_fwd", sm90_src, "mmpl_tpu/ops/attention.py:324",
        window_launches + int8_launches["flash_fwd"]
        + train_counts["flash_fwd"] + sum(fewstep_launches.values()),
        max(r["o_max_abs_err"] for r in rows.values()), k1["ms"],
        k1["plain_ms"], k1["bound_ms"], k1["bound_by"], k1["library_ms"],
        at=MAIN_SHAPE, bodies=bodies, bound_share=k1["bound_share"],
        launches_by_path={
            "window": window_launches,
            "window_int8": int8_launches["flash_fwd"],
            "train": train_counts["flash_fwd"], **fewstep_launches},
        shapes={k: {f: r[f] for f in ("body", "ms", "plain_ms", "bound_ms",
                                      "library_ms", "o_max_abs_err")}
                for k, r in rows.items()})]
    bwd_sm90_src = "mmpl_tpu_torch/csrc/flash_bwd_sm90.cuh"
    bwd_bodies = ("wgmma + TMA body (flash_bwd_sm90.cuh; K2 with its query "
                  "split and reduce) for bf16 / fp16, the template body of "
                  "flash_bwd.cu for fp32; entries in flash_bwd.cu")
    for name, part, line in (("flash_bwd_dkv", "dkv", 373),
                             ("flash_bwd_dq", "dq", 417)):
        out.append(_entry(
            name, bwd_sm90_src, f"mmpl_tpu/ops/attention.py:{line}",
            train_counts[name],
            grad_err(bwd, ("dk", "dv") if part == "dkv" else ("dq",)),
            b[f"{part}_ms"], b["plain_ms"], b[f"{part}_bound_ms"],
            b[f"{part}_bound_by"], b.get("library_bwd_ms"), at=BWD_MAIN,
            sources=[bwd_sm90_src, bwd_src], bodies=bwd_bodies,
            bound_share=b[f"{part}_bound_share"], note=bwd_note,
            shapes={k: {"body": r[f"{part}_body"], "splits": r["splits"],
                        "ms": r[f"{part}_ms"],
                        "bound_ms": r[f"{part}_bound_ms"],
                        "bound_share": r[f"{part}_bound_share"],
                        "plain_ms": r["plain_ms"],
                        "library_ms": r.get("library_bwd_ms")}
                    for k, r in bwd.items()}))
    masked_bodies = {
        "fwd": ("K1's wgmma + TMA body, masked (flash_fwd_sm90.cuh) for "
                "bf16 / fp16 over the 128 x 128 table, the template body "
                "of flash_fwd.cu for fp32; entry in flash_fwd.cu",
                sm90_src, [sm90_src, fwd_src]),
        "dkv": ("K2's wgmma + TMA dKV body, masked, never split "
                "(flash_bwd_sm90.cuh) for bf16 / fp16 over the 64 x 128 "
                "table, the template body of flash_bwd.cu for fp32; entry "
                "in flash_bwd.cu", bwd_sm90_src, [bwd_sm90_src, bwd_src]),
        "dq": ("K3's wgmma + TMA dQ body, masked (flash_bwd_sm90.cuh) for "
               "bf16 / fp16 over the 128 x 128 table, the template body of "
               "flash_bwd.cu for fp32; entry in flash_bwd.cu", bwd_sm90_src,
               [bwd_sm90_src, bwd_src]),
    }
    for name, part, line, plain, lib in (
            ("flash_masked_fwd", "fwd", 725, "plain_fwd_ms", "library_fwd_ms"),
            ("flash_masked_bwd_dkv", "dkv", 783, "plain_bwd_ms",
             "library_bwd_ms"),
            ("flash_masked_bwd_dq", "dq", 821, "plain_bwd_ms",
             "library_bwd_ms")):
        err = (max(r["o_max_abs_err"] for r in masked.values())
               if part == "fwd" else
               grad_err(masked, ("dk", "dv") if part == "dkv" else ("dq",)))
        body, src, srcs = masked_bodies[part]
        coarse = {f"{part}_tile_share": m[f"{part}_tile_share"],
                  f"{part}_partial_share": m[f"{part}_partial_share"]}
        out.append(_entry(
            name, src, f"mmpl_tpu/ops/attention.py:{line}",
            train_counts[name], err,
            m[f"{part}_ms"], m[plain], m[f"{part}_bound_ms"],
            m[f"{part}_bound_by"], m.get(lib), at=MASKED_MAIN,
            sources=srcs, bodies=body,
            bound_share=m[f"{part}_bound_share"],
            pair_share=m["pair_share"], tile_share=m["tile_share"], **coarse,
            shapes={k: {"body": r["fwd_body" if part == "fwd"
                                  else f"{part}_body"],
                        "ms": r[f"{part}_ms"],
                        "bound_ms": r[f"{part}_bound_ms"],
                        "bound_share": r[f"{part}_bound_share"]}
                    for k, r in masked.items()},
            library=("SDPA, memory-efficient backend, token-level bool mask"
                     + ("" if part == "fwd" else "; " + bwd_note))))
    int8_src = "mmpl_tpu_torch/csrc/int8_gemm.cu"
    p2_src = "mmpl_tpu_torch/csrc/int8_gemm_sm90.cuh"
    p2, q = int8[INT8_MAIN], int8[Q_MAIN]
    timing = (f"ms: device time of one call, {INT8_TIMED_CALLS} calls "
              "queued on the card behind a spinning kernel between CUDA "
              "events (library_ms and bf16_matmul_ms too); call_ms: CUDA "
              "events around one call after a synchronise, the wrapper's "
              "host time included")
    out.append(_entry(
        "int8_gemm", p2_src,
        "tools/pallas_int8_mm_probe.py:38 (_mm_s8_kernel, pallas_call :49) "
        "and :61 (_mm_s8_kloop_kernel, pallas_call :82)",
        int8_launches["int8_gemm"],
        max(r["max_abs_err"] for r in int8.values()), p2["ms"],
        p2["plain_ms"], p2["bound_ms"], p2["bound_by"], p2["library_ms"],
        at=INT8_MAIN, sources=[p2_src, int8_src],
        bodies="wgmma s8 + TMA, persistent, warp-specialised "
               "(int8_gemm_sm90.cuh); entry in int8_gemm.cu",
        bf16_matmul_ms=p2["bf16_matmul_ms"], tops=p2["tops"],
        bound_share=p2["bound_share"], timing=timing,
        max_ulps=max(r["out_max_ulps"] for r in int8.values()),
        accumulators_exact=all(r["acc_equal"] for r in int8.values()),
        library="torch._int_mm + the same epilogue (device time)",
        shapes={k: {f: r.get(f) for f in (
            "body", "tile_n", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_share", "library_ms", "bf16_matmul_ms", "tops",
            "out_max_ulps")} for k, r in int8.items()}))
    out.append(_entry(
        "quantize_rows", int8_src,
        "mmpl_tpu/ops/quant.py:49-52 (per-token codes, fused by XLA)",
        int8_launches["quantize_rows"],
        max(r["q_max_abs_err"] for r in int8.values() if "q_ms" in r),
        q["q_ms"], q["q_plain_ms"],
        q["q_bound_ms"], "bytes", None, at=Q_MAIN,
        bound_share=q["q_bound_share"], timing=timing,
        bodies="one read: the row in registers, a warp or a block a row "
               "(quantize_rows_sm90_kernel); two reads past 16,384 "
               "elements (quantize_rows_kernel)",
        codes_and_scales_exact=all(
            r["q_codes_equal"] and r["q_scales_equal"]
            for r in int8.values() if "q_codes_equal" in r),
        shapes={k: {f: r[f] for f in ("q_body", "q_row_warps", "q_ms",
                                      "q_call_ms", "q_plain_ms",
                                      "q_bound_ms", "q_bound_share")}
                for k, r in int8.items() if "q_ms" in r}))
    p1 = exp2[EXP2_MAIN]
    out.append(_entry(
        "flash_exp2", sm90_src,
        "tools/exp2_probe.py:42 (_fwd_kernel, pallas_call :95)",
        exp2_launches, max(r["o_max_abs_err"] for r in exp2.values()),
        p1["ms"], p1["plain_ms"], p1["bound_ms"], p1["bound_by"],
        p1["library_ms"], at=f"{EXP2_MAIN[0]} ({EXP2_MAIN[1]} variant)",
        k1_ms=p1["k1_ms"], library="SDPA (default backend)",
        bodies=bodies, bound_share=p1["bound_share"],
        variants={f"{lbl}/{name}": {f: r[f] for f in (
            "body", "ms", "plain_ms", "bound_ms", "library_ms", "k1_ms",
            "o_max_abs_err")} for (lbl, name), r in exp2.items()}))
    for e in out:
        e["card"] = smi
    return {"kernels": out}


def main() -> int:
    set_float32_precision()
    smi = phase_device()
    rows = phase_kernel()
    # before any long profiler session: after one (train_profile), the
    # short sessions that read which body ran saw no device kernel
    exp2 = phase_kernel_exp2()
    bwd = phase_kernel_bwd()
    # before kernel_masked: after its 65520^2 SDPA yardstick the short
    # sessions that read which body ran lost their device records
    int8 = phase_kernel_int8()
    masked = phase_kernel_masked()
    phase_cli()
    phase_cli_int8()
    window_launches, pipe, cond, uncond, bf16 = phase_window()
    phase_profile(pipe, cond, uncond)
    del pipe, cond, uncond
    torch.cuda.empty_cache()
    int8_launches, pipe, cond, uncond = phase_window_int8(bf16)
    phase_profile(pipe, cond, uncond, phase="profile_int8")
    del pipe, cond, uncond, bf16
    torch.cuda.empty_cache()
    phase_profile_int8_vae()
    phase_quant_parity()
    phase_train_cli()
    phase_train_parity()
    train_counts, step = phase_train()
    phase_train_profile(step)
    del step
    torch.cuda.empty_cache()
    exp2_launches = phase_exp2_probe()
    phase_cli_fewstep()
    model, cond, fewstep_rows, _ = phase_fewstep()
    pipe = phase_fewstep_rolling(model, cond)
    rolling_k1 = attn.launch_counts["flash_fwd"]
    phase_profile_fewstep(pipe, cond)
    del model, pipe, cond
    torch.cuda.empty_cache()
    phase_fewstep_parity()
    fewstep_launches = {"fewstep": sum(r["flash_fwd_launches"]
                                       for r in fewstep_rows),
                        "fewstep_rolling": rolling_k1}
    emit(kernels_line(smi, rows, bwd, masked, int8, window_launches,
                      int8_launches, train_counts, exp2, exp2_launches,
                      fewstep_launches))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
