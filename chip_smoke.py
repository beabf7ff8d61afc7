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
  14. real inputs: t5, umT5-XXL at full width and depth (seeded f32
     weights on the card) encoding two 512-token rows, one padded, and a
     2-layer full-width copy against the CPU; ckpt, synthetic files in the
     upstream layouts (a 1.3B MMPL generator .pt with its EMA, in bf16;
     Wan2.1_VAE.pth; the 2-layer umT5 .pth in bf16; a word-level
     tokenizer) loaded to the card through the port's loaders, bit for
     bit; cli_real, the CLI's non-smoke path on those files
     (--checkpoint-path, --wan-dir, --use-ema, a prompt) at 480x832, 4
     steps, two bridged windows, exact K1 launches; window_i2v, two
     bridged 1.3B windows on the i2v plan from a synthetic 480x832 image,
     exact K1 launches; window_i2v_parity, the tiny model's fp32 i2v
     window and image encode on the card against the CPU.  The K1 rows
     of the kernel phase include the i2v plan's own shapes;
  15. checkpoints and the whole-clip pipelines: train_resume, the trainer
     at the 1.3B width cut to 2 layers, two steps unbroken and twice, then
     one step resumed from the step-1 checkpoint and the `.pt` export,
     held bit for bit against the unbroken run (loss, masters, AdamW
     state, EMA, generators) and loaded back, with the checkpoint's bytes
     and save / restore seconds; wan_t2v, `WanT2V` on the 1.3B model at
     full width and depth, 480x832, 2 UniPC steps and the decode to 81
     frames, exact K1 launches; wan_i2v, `WanI2V.generate_from_image` on
     i2v-14B at full width and depth (weights made on the card) with
     ViT-H/14, the chunked conditioning encode and the decode, exact K1
     launches, the peak memory; clip_text, the two-tower XLM-RoBERTa CLIP
     at full width and depth, and a 2-layer copy against the CPU;
     wan_parity, the tiny fp32 WanT2V and WanI2V on the card against the
     CPU.  The K1 rows of the kernel phase include WanI2V's shapes
     (32760^2 over 40 heads, 32760 x 512, 32760 x 257, and the CLIP's
     257^2 at head dim 80);
  16. distillation, the flow objective and the baseline pipelines (1.3B
     width, 480x832, bf16 activations, seeded random weights with non-zero
     heads, exact K1 / K2 / K3 launches checked against each path's
     formula): causal_diffusion, `CausalDiffusionInferencePipeline` (7
     blocks of 3 frames, 2 UniPC steps over the CFG pair, ms per block),
     and again with --quantize auto and the int8 cache (exact P2 / Q
     launches from the auto policy); bidirectional, the 2-step UniPC CFG
     and 4-step few-step bidirectional pipelines; window_dpm, one planned
     window with DPM-Solver++; train_flow, the flow objective at full
     depth (32760 tokens, per-block recomputation, AdamW, EMA); distill_dmd,
     one DMD critic and one generator step at DISTILL_LAYERS depth
     (configs/self_forcing_dmd.yaml's steps; the drawn exit flag printed
     and the launches checked against it; peak memory; distill_profile, a
     generator step under torch.profiler); distill_other,
     SiD, GAN (critic with R1 / R2, generator; K1-K3 at one query row over
     32760 keys), CausVid and ODE at 2 layers; distill_rolling, 27 frames
     through the 21-slot ring at 2 layers; train_distill_cli, the trainer
     CLI in smoke mode for flow, dmd, sid, causvid, gan and ode;
     distill_parity, tiny fp32 DMD losses and gradients and a tiny
     causal-diffusion run, card against CPU.  The K1 / K2 / K3 rows of the
     kernel phases include the critic's and flow's 32760^2, the scores'
     32760 x 512 and the GAN head's 1 x 32760;
  17. multi-device and serving on this one card: chunk_pipeline,
     `ChunkParallelPipeline` at 1.3B (480x832, bf16, 4 steps): 3 chunks
     over 2 stages (two streams, one model), then on 1 stage, with wall
     seconds, peak memory, each chunk's CUDA events, the overlap and exact
     K1 launches, the two runs' chunks compared bit for bit;
     generate_parallel, `python -m mmpl_tpu_torch.generate_parallel` in
     smoke mode writing its chunk files; serving, the HTTP server in this
     process on 127.0.0.1 backed by the 1.3B chunk pipeline on 2 stages, a
     2-chunk request polled to success, chunk 0's file out while chunk 1
     still runs; ring, `ring_flash_attention` with ring = 4
     in the in-process group at 32760 tokens (B=2, 12 x 128) against one
     K1 call and K2 / K3 over the whole sequence; usp, `WanT2V` with sp 2 x
     ring 2 in the in-process group against one device, at 1.3B and full
     depth; mesh, `init_distributed` and `make_mesh` on NCCL at world size
     1, USP attention over the process groups, one group-3 forward of the
     pipeline built over the mesh, one 1.3B teacher-forcing step at full
     width and depth FSDP-sharded over the mesh against the same step
     unsharded, and one `train --mesh` CLI step in smoke mode;
  18. the kernels line, then the final device line.
"""

from __future__ import annotations

import contextlib
import copy
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
#: t2v self-attention groups and text cross-attention), the shapes only
#: the i2v plan gives (group 0: the image frame alone, its commit; group 1:
#: frame 1 over frames {0, 1}, denoised in window 0; group 3: 6 frames
#: over the 15 cached ones, not in append mode; its group 2 and append-mode
#: group 4 run group1_self and group3_self), the training cross-attention,
#: a ragged shape, the fp32 smoke path's head dim, and the whole-clip
#: WanI2V's: the i2v-14B DiT's self-attention over all 21 latent frames
#: (CFG pair, 40 heads), its text and image cross-attention (512 and 257
#: keys; the last 128-key tile of the image keys holds one key) and the
#: CLIP tower's 257 tokens at head dim 80; the distillation slice's: the
#: bidirectional pipeline's CFG pair over all 32760 tokens, the critic's
#: and the flow objective's batch of one, the causal-diffusion pipeline's
#: last block (CFG pair, 4680 queries over 32760 keys) and the GAN head's
#: register token (one query row over 32760 keys)
K1_SHAPES = [
    ("group0_self", 2, 12, 128, 3120, 3120, torch.bfloat16),
    ("group1_self", 2, 12, 128, 10920, 14040, torch.bfloat16),
    ("group2_self", 2, 12, 128, 9360, 20280, torch.bfloat16),
    ("group3_self", 2, 12, 128, 9360, 32760, torch.bfloat16),
    ("i2v_group0_self", 2, 12, 128, 1560, 1560, torch.bfloat16),
    ("i2v_group1_self", 2, 12, 128, 1560, 3120, torch.bfloat16),
    ("i2v_group3_self", 2, 12, 128, 9360, 23400, torch.bfloat16),
    ("cross", 2, 12, 128, 9360, 512, torch.bfloat16),
    ("tf_cross", 1, 12, 128, 65520, 512, torch.bfloat16),
    ("fewstep_self_hot", 1, 12, 128, 4680, 32760, torch.bfloat16),
    ("fewstep_cross", 1, 12, 128, 4680, 512, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("smoke_f32", 2, 4, 24, 130, 200, torch.float32),
    ("i2v14b_self", 2, 40, 128, 32760, 32760, torch.bfloat16),
    ("i2v14b_cross", 2, 40, 128, 32760, 512, torch.bfloat16),
    ("i2v14b_img", 2, 40, 128, 32760, 257, torch.bfloat16),
    ("clip_self", 1, 16, 80, 257, 257, torch.bfloat16),
    ("bidir_self", 2, 12, 128, 32760, 32760, torch.bfloat16),
    ("critic_self", 1, 12, 128, 32760, 32760, torch.bfloat16),
    ("cd_block_self", 2, 12, 128, 4680, 32760, torch.bfloat16),
    ("gan_head_q1", 2, 12, 128, 1, 32760, torch.bfloat16),
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
#: the few-step steady-state self-attention (the graded rollout block's
#: backward over 7 blocks), a ragged shape and the tiny configuration's
#: head dim in bf16 and fp32; the distillation slice's: the critic's and
#: the flow objective's self-attention (32760^2) and text cross-attention
#: (32760 x 512), and the GAN head's register token (Lq = 1 over 32760)
BWD_SHAPES = [
    ("tf_cross", 1, 12, 128, 65520, 512, torch.bfloat16),
    ("tf_cross_f16", 1, 12, 128, 65520, 512, torch.float16),
    ("fewstep_self_hot", 1, 12, 128, 4680, 32760, torch.bfloat16),
    ("ragged", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("d24_bf16", 2, 4, 24, 1000, 1300, torch.bfloat16),
    ("d24_f32", 2, 4, 24, 1000, 1300, torch.float32),
    ("critic_self", 1, 12, 128, 32760, 32760, torch.bfloat16),
    ("score_cross", 1, 12, 128, 32760, 512, torch.bfloat16),
    ("gan_head_q1", 2, 12, 128, 1, 32760, torch.bfloat16),
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


#: perf_counter at import: every phase row carries its seconds since then
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 3)}
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


def _i2v_window_forwards(steps: int) -> int:
    """DiT forwards of two bridged windows on the i2v plan: window 0
    commits the image frame (group 0) and runs groups 1-4 (group 4 in
    append mode, no commit); window 1 commits its 2 bridge latents as
    groups 0 and 1 and runs groups 2-4."""
    return (1 + 4 * steps + 3) + (2 + 3 * steps + 2)


#: commit forwards (the cache writes) of the two bridged windows: groups
#: 0-2 of window 0, the bridge commit and groups 1-2 of window 1
WINDOW_COMMITS = (3, 3)


def _run_windows(phase, steps, quantize=None, quantize_cache=False,
                 quantize_vae=False, plan=None, image=None):
    """Two bridged 1.3B windows at 480x832 in bf16 from the same seeds
    (model 0, head 99, VAE 1, text 2 / 3, noise 100), with the int8
    options asked for; with `plan` and `image` ([3, 480, 832] in [-1, 1])
    the i2v windows, the image VAE-encoded as window 0's first latent
    frame.  Returns (pipe, cond, uncond, rows, latents, frames, caches):
    per-window rows, latents on the host, frames, and each KV cache's
    {name: (dtype, bytes)}."""
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
    pipe = CausalFPSInferencePipeline(cfg, model, plan=plan,
                                      sampling_steps=steps,
                                      quantize=quantize,
                                      quantize_cache=quantize_cache,
                                      dtype=torch.bfloat16)
    pipe.sync_timing = True
    initial = None if image is None else cli.encode_image(vae_model, image,
                                                          dev)
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
        new_frames = (21 - (0 if initial is None else initial.shape[1])
                      if win == 0 else 19)
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
                               g(100), on_window, initial_latent=initial)
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


def phase_train_profile(step, top: int = 14, phase: str = "train_profile",
                        what: str = "one 1.3B teacher-forcing step, 30 layers",
                        checked=tuple(TRAIN_LAUNCHES_PER_LAYER)):
    """One training step under torch.profiler (by default the 1.3B
    teacher-forcing step): device time by kernel, the port kernels' shares
    and the device's idle share of the synchronised wall time.  Read by
    PERF.md's breakdown; checked only for the port's kernels `checked`."""
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
    row = {"phase": phase, "what": what,
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
    check(all(by_port.get(k, 0.0) > 0 for k in checked), row)


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


#: the T5 depth of the checkpoint phases: a 2-layer umT5 at full width
#: (vocabulary 256384, dim 4096, 64 heads, ffn 10240); the t5 phase runs
#: all 24 layers
T5_SHALLOW_LAYERS = 2
#: the words of the tokenizer the checkpoint phases write (the umT5
#: tokenizer files are not in the repository): <pad> 0, </s> 1, <unk> 2
TOKENIZER_WORDS = ("a cat dog surfing wave at sunset on the beach red blue "
                   "green quickly slowly runs jumps over fox lazy").split()
CLI_PROMPT = "a cat surfing a wave at sunset on the beach"


def _t5_ids(vocab: int, L: int = 512, seed: int = 5):
    """Two 512-token id rows: one full, one of 77 tokens then padding
    (mask 0, id 0); </s> (id 1) ends each."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    ids[0, -1] = ids[1, 76] = 1
    ids[1, 77:] = 0
    mask[1, 77:] = 0
    return ids, mask


def phase_t5():
    """umT5-XXL at full width and depth (24 layers, 5.68 B parameters,
    seeded weights made on the card in f32): two 512-token rows, one
    padded, through `WanTextEncoder.encode_ids`, with the encode's ms and
    the peak memory; then a 2-layer full-width copy on the card against
    the same module on the CPU (f32, TF32 off: within 1e-4 relative).
    Returns the 2-layer CPU module (the checkpoint phases write it)."""
    from mmpl_tpu_torch.models import t5
    from mmpl_tpu_torch.utils.tokenizer import WanTextEncoder
    cfg = t5.UMT5_XXL
    ids, mask = _t5_ids(cfg["vocab_size"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = t5.init_t5_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                              torch.float32, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc = WanTextEncoder(model)
    out = {}
    ms = time_ms(lambda: out.update(s=enc.encode_ids(ids, mask)),
                 max_reps=5)
    states = out["s"]
    row = {"phase": "t5", "layers": cfg["num_layers"], "dim": cfg["dim"],
           "heads": cfg["num_heads"], "ffn": cfg["dim_ffn"],
           "vocab": cfg["vocab_size"],
           "params": sum(p.numel() for p in model.parameters()),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9,
           "init_s": init_s, "tokens": list(ids.shape),
           "valid_tokens": mask.sum(1).tolist(), "encode_ms": ms,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "states_shape": list(states.shape),
           "finite": bool(torch.isfinite(states).all()),
           "padded_zero": bool((states[1, 77:] == 0).all()),
           "states_std": states[0].std().item()}
    del model, enc, states, out
    torch.cuda.empty_cache()

    shallow = t5.init_t5_params(dict(cfg, num_layers=T5_SHALLOW_LAYERS),
                                torch.Generator().manual_seed(1))
    want = shallow(torch.from_numpy(ids), torch.from_numpy(mask))
    card = t5.empty_t5(shallow.cfg, device="cuda")
    card.load_state_dict(shallow.state_dict())
    got = card(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
    got = got.cpu()
    del card
    torch.cuda.empty_cache()
    row.update(shallow_layers=T5_SHALLOW_LAYERS,
               shallow_rel_err=((got - want).norm() / want.norm()).item(),
               shallow_max_abs_err=(got - want).abs().max().item())
    emit(row)
    check(row["finite"] and row["padded_zero"] and row["states_std"] > 0.1,
          row)
    check(row["states_shape"] == [2, 512, 4096], row)
    check(row["params"] == 5_680_910_336, row)
    check(row["shallow_rel_err"] <= 1e-4, row)
    return shallow


def _save_word_tokenizer(path: str) -> str:
    """A umT5-like word-level tokenizer in `path` (tokenizer.json and
    tokenizer_config.json, as `AutoTokenizer.from_pretrained` reads
    them): <pad> 0, </s> 1 appended to each sequence, <unk> 2."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    vocab = {w: i for i, w in enumerate(["<pad>", "</s>", "<unk>",
                                         *TOKENIZER_WORDS])}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "<pad>", "eos_token": "</s>",
                   "unk_token": "<unk>", "model_max_length": 512}, f)
    return path


def _mismatched(module, source: dict, source_key, widen=False) -> list:
    """Names of the module's tensors that differ from their upstream
    tensors in `source` (reshaped to the module's layout; widened to f32
    where the module is f32 and the file bf16)."""
    bad = []
    for k, v in module.state_dict().items():
        want = source[source_key(k)].reshape(v.shape)
        if widen:
            want = want.float()
        if not torch.equal(v.cpu(), want):
            bad.append(k)
    return bad


def phase_ckpt(t5_shallow):
    """Synthetic files in the upstream layouts under build/chip_smoke/ckpt:
    a 1.3B MMPL generator `.pt` (`generator` and `generator_ema` under
    `model.`, bf16; the EMA differs in the head and shares the rest), a
    Wan2.1 directory with `Wan2.1_VAE.pth` (f32), the 2-layer full-width
    umT5 in bf16 (`models_t5_umt5-xxl-enc-bf16.pth`) and a word-level
    tokenizer under `google/umt5-xxl`.  Each file loads to the card
    through the port's loaders; the module tensors equal the written
    ones bit for bit (T5's widened to f32).  Returns (pt, wan dir)."""
    from mmpl_tpu_torch.utils import checkpoint as ckpt
    cfg = WAN_CONFIGS["t2v-1.3B"]
    root = os.path.join(OUT_DIR, "ckpt")
    shutil.rmtree(root, ignore_errors=True)
    wan = os.path.join(root, "Wan2.1-T2V-1.3B")
    os.makedirs(wan)
    pt = os.path.join(root, "mmpl_t2v_1.3B.pt")
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(0), torch.bfloat16, "cuda"), g(99))
    up = {k: v.cpu() for k, v in
          ckpt.to_upstream(model.state_dict(), "dit").items()}
    del model
    ema = dict(up)
    for k in ("head.head.weight", "head.modulation"):
        ema[k] = (up[k].float() * 0.5).to(torch.bfloat16)
    vae_up = {k: v.cpu() for k, v in ckpt.to_upstream(
        vae.init_vae_params(g(1), torch.float32, "cuda").state_dict(),
        "vae").items()}
    t5_up = {k: v.to(torch.bfloat16) for k, v in
             ckpt.to_upstream(t5_shallow.state_dict(), "t5").items()}
    files = {"generator": pt,
             "vae": os.path.join(wan, cfg.vae_checkpoint),
             "t5": os.path.join(wan, cfg.t5_checkpoint)}
    t0 = time.perf_counter()
    torch.save({"generator": {f"model.{k}": v for k, v in up.items()},
                "generator_ema": {f"model.{k}": v for k, v in ema.items()}},
               pt)
    torch.save(vae_up, files["vae"])
    torch.save(t5_up, files["t5"])
    tok = _save_word_tokenizer(os.path.join(wan, cfg.t5_tokenizer))
    write_s = time.perf_counter() - t0
    row = {"phase": "ckpt", "write_s": write_s,
           "bytes": {k: os.path.getsize(p) for k, p in files.items()},
           "tokenizer": sorted(os.listdir(tok))}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for use_ema, src in ((False, up), (True, ema)):
        m, sec = timed(lambda: ckpt.load_mmpl_generator(
            pt, cfg, use_ema=use_ema, dtype=torch.bfloat16, device="cuda"))
        name = "generator_ema" if use_ema else "generator"
        row[f"{name}_load_s"] = sec
        row[f"{name}_params"] = sum(p.numel() for p in m.parameters())
        row[f"{name}_mismatched"] = _mismatched(m, src, ckpt.dit_source_key)
        del m
    m, row["vae_load_s"] = timed(lambda: ckpt.load_vae(
        files["vae"], torch.float32, "cuda"))
    row["vae_mismatched"] = _mismatched(m, vae_up, ckpt.vae_source_key)
    m, row["t5_load_s"] = timed(lambda: ckpt.load_t5(
        files["t5"], t5_shallow.cfg, torch.float32, "cuda"))
    row["t5_mismatched"] = _mismatched(m, t5_up, ckpt.t5_source_key,
                                      widen=True)
    row["t5_params"] = sum(p.numel() for p in m.parameters())
    del m
    torch.cuda.empty_cache()
    emit(row)
    for part in ("generator", "generator_ema", "vae", "t5"):
        check(row[f"{part}_mismatched"] == [], row)
    check(row["generator_params"] == 1_418_996_800, row)
    return pt, wan


def phase_cli_real(pt: str, wan: str, steps: int = 4):
    """The CLI's non-smoke path on the ckpt phase's files: the 1.3B
    generator's EMA in bf16, the VAE, the 2-layer umT5 (the CLI's umT5
    config cut to the file's depth) and the tokenizer, a prompt and Wan's
    default negative prompt, at 480x832, `steps` sampling steps, two
    bridged windows: exact K1 launches per window, window seconds and
    latent-frames/s, the text states' spread."""
    from mmpl_tpu_torch.models import t5
    cfg = WAN_CONFIGS["t2v-1.3B"]
    rows, counted, states = [], {"k1": 0}, {}
    real_run, real_t5 = cli.run_windows, t5.UMT5_XXL

    def run_windows(pipe, vae_model, cond, uncond, duration, lat_hw, gen,
                    on_window=None, **kw):
        pipe.sync_timing = True
        states.update(cond=cond, uncond=uncond)

        def record(win, lat, frames, seconds):
            lat = lat.float()
            k1 = attn.launch_counts["flash_fwd"]
            new = 21 if win == 0 else 19
            row = {"phase": "cli_real", "window": win, "seconds": seconds,
                   "new_latent_frames": new,
                   "latent_frames_per_s": new / seconds,
                   "latents_finite": bool(torch.isfinite(lat).all()),
                   "latents_std": lat.std().item(),
                   "frames_shape": list(frames.shape),
                   "flash_fwd_launches": k1 - counted["k1"]}
            counted["k1"] = k1
            for key, val in pipe.phase_times.items():
                if key.endswith("_steps_s"):
                    row[key.replace("_steps_s", "_ms_per_step")] = \
                        1e3 * val / steps
            rows.append(row)
            emit(row)
            check(row["latents_finite"] and row["latents_std"] > 1e-3, row)
        return real_run(pipe, vae_model, cond, uncond, duration, lat_hw,
                        gen, record, **kw)

    out = os.path.join(OUT_DIR, "cli_real.mp4")
    written, restore = _capture_writes()
    cli.run_windows = run_windows
    t5.UMT5_XXL = dict(real_t5, num_layers=T5_SHALLOW_LAYERS)
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["--model", "t2v-1.3B", "--checkpoint-path", pt,
                       "--wan-dir", wan, "--use-ema", "--prompt", CLI_PROMPT,
                       "--duration", "2", "--sampling-steps", str(steps),
                       "--device", "cuda", "--output", out])
    finally:
        restore()
        cli.run_windows, t5.UMT5_XXL = real_run, real_t5
    total_s = time.perf_counter() - t0
    frames = written[out]
    expected = 2 * cfg.num_layers * _window_forwards(steps)
    cond, uncond = states["cond"], states["uncond"]
    total = {"phase": "cli_real_total", "rc": rc, "seconds": total_s,
             "load_and_encode_s": total_s - sum(r["seconds"] for r in rows),
             "frames_shape": list(frames.shape),
             "flash_fwd_launches": attn.launch_counts["flash_fwd"],
             "expected_launches": expected,
             "text_states_shape": list(cond.shape),
             "cond_uncond_max_abs_diff":
                 (cond - uncond).abs().max().item(),
             "max_memory_allocated_gib":
                 torch.cuda.max_memory_allocated() / 2**30}
    emit(total)
    check(rc == 0, total)
    check(frames.shape == (157, 480, 832, 3) and str(frames.dtype)
          == "uint8", total)
    check(total["flash_fwd_launches"] == expected, total)
    check(total["text_states_shape"] == [1, 512, 4096]
          and total["cond_uncond_max_abs_diff"] > 1e-2, total)
    return total["flash_fwd_launches"]


def _synthetic_image(h: int, w: int, seed: int = 21) -> np.ndarray:
    """[h, w, 3] uint8: a colour gradient with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([255 * x / w, 255 * y / h, 128 + 64 * np.sin(x / 37.0)],
                   -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _image_input(rgb: np.ndarray, h: int, w: int):
    """(the image as `load_image` gives it from a PNG file, how): through
    PIL where the machine has it, else the array through `image_array`,
    the step that follows the decoding."""
    from mmpl_tpu_torch.utils import media
    try:
        from PIL import Image
    except ImportError:
        return media.image_array(rgb, h, w), "image_array (no PIL)"
    path = os.path.join(OUT_DIR, f"i2v_{rgb.shape[0]}x{rgb.shape[1]}.png")
    Image.fromarray(rgb).save(path)
    return media.load_image(path, h, w), "load_image (PNG via PIL)"


def phase_window_i2v(steps: int = 4):
    """Two bridged 1.3B windows on the i2v plan at 480x832, bf16, `steps`
    sampling steps, from a synthetic image (a 540x960 PNG resized and
    centre-cropped): the image's latent commits group 0 of window 0, the 2
    bridge latents groups 0 and 1 of window 1; exact K1 launches,
    per-group ms per step, window seconds."""
    from mmpl_tpu_torch.core.geometry import i2v_plan
    image, how = _image_input(_synthetic_image(540, 960), 480, 832)
    _, _, _, rows, _, _, _ = _run_windows("window_i2v", steps,
                                          plan=i2v_plan(), image=image)
    launches = attn.launch_counts["flash_fwd"]
    expected = 2 * WAN_CONFIGS["t2v-1.3B"].num_layers * \
        _i2v_window_forwards(steps)
    for row in rows:
        emit(row)
    emit({"phase": "window_i2v_total", "image_input": how,
          "flash_fwd_launches": launches, "expected_launches": expected,
          "per_window": [r["launches"]["flash_fwd"] for r in rows],
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30})
    check(launches == expected, (launches, expected))
    check([r["new_latent_frames"] for r in rows] == [20, 19], rows)
    torch.cuda.empty_cache()
    return launches


def phase_window_i2v_parity(steps: int = 4):
    """The tiny model's fp32 i2v window on the card against the CPU's
    plain path, from the same weights, noise and text states: the image
    (64x64) encoded by the VAE on both (within 1e-4 relative), then the
    window from that one latent frame (within 1e-4 relative, the float
    window gate of quant_parity)."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.core.geometry import i2v_plan
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    vae_cpu = vae.init_vae_params(torch.Generator().manual_seed(1))
    vae_gpu = copy.deepcopy(vae_cpu).to("cuda")
    image, how = _image_input(_synthetic_image(80, 100), 64, 64)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    lat_cpu = cli.encode_image(vae_cpu, image, torch.device("cpu"))
    lat_gpu = cli.encode_image(vae_gpu, image, torch.device("cuda")).cpu()
    rng = np.random.default_rng(17)
    noise = rng.standard_normal((1, 21, 16, 8, 8)).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, cfg.text_len, cfg.text_dim))
                    .astype(np.float32) for _ in range(2))

    def window(dev):
        pipe = CausalFPSInferencePipeline(
            cfg, copy.deepcopy(model).to(dev), plan=i2v_plan(),
            sampling_steps=steps, dtype=torch.float32)
        t = lambda a: torch.from_numpy(a).to(dev)
        return pipe.inference(t(noise), t(cond), t(uncond),
                              initial_latent=lat_cpu.to(dev)).cpu()

    got, want = window("cuda"), window("cpu")
    row = {"phase": "window_i2v_parity", "steps": steps, "image_input": how,
           "latent_shape": list(lat_cpu.shape),
           "encode_rel_err": rel(lat_gpu, lat_cpu),
           "window_rel_err": rel(got, want),
           "first_frame_equal": bool(torch.equal(got[:, :1], lat_cpu))}
    emit(row)
    check(row["latent_shape"] == [1, 1, 16, 8, 8], row)
    check(row["encode_rel_err"] <= 1e-4 and row["window_rel_err"] <= 1e-4,
          row)
    check(row["first_frame_equal"], row)


# ---------------------------------------------------------------------------
# Checkpoints and resume; the whole-clip Wan pipelines; the CLIP towers
# ---------------------------------------------------------------------------

#: depth of the resume cell's 1.3B-wide trainer: a checkpoint holds 16
#: bytes a parameter (fp32 masters, EMA, AdamW's two moments), ~22 GB at
#: full depth and ~1.9 GB at 2 layers
RESUME_LAYERS = 2


def _metrics(root: str, run: str) -> list:
    with open(os.path.join(root, run, "metrics.jsonl"),
              encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _state_diff(a, b) -> float:
    """The largest absolute difference between two checkpoint states
    (nested dicts of tensors and numbers; 0.0 when equal bit for bit,
    inf when their layouts differ)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return math.inf
        return max((_state_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return math.inf
        return max((_state_diff(x, y) for x, y in zip(a, b)), default=0.0)
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return math.inf
        if torch.equal(a, b):
            return 0.0
        if not a.is_floating_point():
            return math.inf
        return (a.double() - b.double()).abs().max().item()
    return 0.0 if a == b else math.inf


def phase_train_resume():
    """`python -m mmpl_tpu_torch.train` in process at the 1.3B width (dim
    1536, 21 latent frames at 60x104), cut to RESUME_LAYERS layers: two
    steps unbroken (checkpoints at steps 1 and 2), the same again (the
    run-to-run spread), then a new trainer resumed from the first run's
    step-1 checkpoint takes step 2 and exports the `.pt`.  The resumed
    run's loss and its step-2 state (masters, AdamW state, EMA,
    generators) against the unbroken run's, bit for bit (or within the
    spread of the two unbroken runs, if they differ); the export loaded
    back through `load_mmpl_generator` against that state, bit for bit;
    the checkpoint's bytes, save and restore seconds; exact launches of
    the resumed step."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.config import DotDict
    from mmpl_tpu_torch.utils import checkpoint as ckpt
    from mmpl_tpu_torch.utils import train_state_io as tsio
    name = "t2v-1.3B"
    full = WAN_CONFIGS[name]
    cfg = DotDict(full, num_layers=RESUME_LAYERS)
    root = os.path.join(OUT_DIR, "resume")
    shutil.rmtree(root, ignore_errors=True)
    base = ["--device", "cuda", "--steps", "2", "--log-dir", root]
    WAN_CONFIGS[name] = cfg
    try:
        for run, extra in (("unbroken", ["--ckpt-every", "1"]),
                           ("unbroken2", ["--ckpt-every", "2"])):
            check(train.main(base + extra + [
                "--run-name", run, "--ckpt-dir",
                os.path.join(root, run)]) == 0, run)
        pt = os.path.join(root, "resumed.pt")
        step1 = os.path.join(root, "unbroken", "step1")
        attn.reset_launch_counts()
        rc = train.main(base + [
            "--run-name", "resumed", "--resume", step1, "--ckpt-every", "1",
            "--ckpt-dir", os.path.join(root, "resumed"), "--export-pt", pt])
        counts = dict(attn.launch_counts)
        check(rc == 0, "resumed run")
        logs = {run: _metrics(root, run)
                for run in ("unbroken", "unbroken2", "resumed")}
        loss = {run: {r["step"]: r["loss"] for r in recs if "loss" in r}
                for run, recs in logs.items()}
        saves = [r for r in logs["unbroken"] if "ckpt_bytes" in r]
        restore = [r for r in logs["resumed"] if "restore_s" in r]
        states = {run: tsio.restore_checkpoint(
            os.path.join(root, run, "step2"))
            for run in ("unbroken", "unbroken2", "resumed")}
        spread = _state_diff(states["unbroken2"], states["unbroken"])
        resumed = _state_diff(states["resumed"], states["unbroken"])
        t0 = time.perf_counter()
        export = {use_ema: ckpt.load_mmpl_generator(
            pt, cfg, use_ema=use_ema, dtype=torch.float32, device="cuda")
            for use_ema in (False, True)}
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = states["resumed"]
        export_diff = max(
            _state_diff({k: v.cpu() for k, v in
                         export[False].state_dict().items()}, want["model"]),
            _state_diff({k: v.cpu() for k, v in
                         export[True].state_dict().items()}, want["ema"]))
        del export
    finally:
        WAN_CONFIGS[name] = full
    expected = _train_launches(RESUME_LAYERS, 1)
    row = {"phase": "train_resume", "layers": RESUME_LAYERS,
           "dim": cfg.dim, "latent_frames": 21, "latent_hw": [60, 104],
           "params": sum(t.numel() for t in want["model"].values()),
           "ckpt_bytes": saves[0]["ckpt_bytes"],
           "save_s": [r["save_s"] for r in saves],
           "restore_s": restore[0]["restore_s"],
           "export_bytes": os.path.getsize(pt), "export_load_s": load_s,
           "losses": loss,
           "resumed_loss_equal": loss["resumed"][1] == loss["unbroken"][1],
           "unbroken_spread_max_abs": spread,
           "resumed_max_abs_diff": resumed,
           "bit_for_bit": resumed == 0.0,
           "export_max_abs_diff": export_diff,
           "launches": counts, "expected_launches": expected}
    del states, want
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(row)
    check(list(loss["resumed"]) == [1], loss)
    check(all(map(math.isfinite, loss["unbroken"].values())), loss)
    if spread == 0.0:
        check(row["resumed_loss_equal"] and row["bit_for_bit"], row)
    else:
        check(resumed <= spread, row)
    check(export_diff == 0.0, row)
    check(counts == expected, (counts, expected))
    return counts


def _text_states(cfg, device, seeds=(2, 3)):
    return [torch.randn((1, cfg.text_len, cfg.text_dim), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(s)) for s in seeds]


def _video_row(video) -> dict:
    return {"video_shape": list(video.shape),
            "finite": bool(torch.isfinite(video).all()),
            "video_std": video.float().std().item()}


def phase_wan_t2v(steps: int = 2):
    """`WanT2V.generate` on the 1.3B model at full width and depth (random
    weights, non-zero head), 480x832, 21 latent frames, bf16, the batched
    CFG pair, `steps` UniPC steps, then the fp32 streaming decode to 81
    frames: exact K1 launches (self and text cross-attention, 30 layers,
    each step), seconds per step and of the decode, the peak memory."""
    from mmpl_tpu_torch.pipelines.wan_reference import WanT2V
    cfg = WAN_CONFIGS["t2v-1.3B"]
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(0), torch.bfloat16, "cuda"), g(99))
    vae_m = vae.init_vae_params(g(1), torch.float32, "cuda")
    pipe = WanT2V(cfg, model, vae_m, sampling_steps=steps,
                  dtype=torch.bfloat16)
    pipe.sync_timing = True
    noise = torch.randn((1, 21, 16, 60, 104), generator=g(4), device="cuda")
    cond, uncond = _text_states(cfg, "cuda")
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    video = pipe.generate(noise, cond, uncond)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(attn.launch_counts)
    expected = {**dict.fromkeys(counts, 0),
                "flash_fwd": 2 * cfg.num_layers * steps}
    row = {"phase": "wan_t2v", "model": cfg.name, "steps": steps,
           "latents": [21, 60, 104], "seconds": seconds,
           "seconds_per_step": pipe.phase_times["steps_s"] / steps,
           "decode_s": pipe.phase_times["decode_s"],
           "launches": counts, "expected_launches": expected,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           **_video_row(video)}
    del pipe, model, vae_m, video
    torch.cuda.empty_cache()
    emit(row)
    check(counts == expected, (counts, expected))
    check(row["finite"] and row["video_shape"] == [1, 81, 3, 480, 832]
          and row["video_std"] > 0, row)
    return counts["flash_fwd"]


def phase_wan_i2v(steps: int = 2):
    """`WanI2V.generate_from_image` on i2v-14B at full width and depth
    (dim 5120, 40 layers, ~16.4 B parameters in bf16, random weights made
    on the card), ViT-H/14 at full width (bf16), a synthetic 480x832
    image, 21 latent frames, the batched CFG pair, `steps` UniPC steps,
    the conditioning encode in causal chunks and the fp32 decode to 81
    frames: exact K1 launches (31 CLIP blocks, then self, text and image
    cross-attention of 40 layers each step), the CLIP ms, the encode,
    per-step and decode seconds, the peak memory."""
    from mmpl_tpu_torch.models import clip
    from mmpl_tpu_torch.pipelines.wan_reference import WanI2V
    cfg = WAN_CONFIGS["i2v-14B"]
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dit.randomize_head(
        dit.init_dit_params(cfg, g(0), torch.bfloat16, "cuda"), g(99))
    clip_m = clip.init_clip_visual_params(clip.VIT_H_14, g(3),
                                          torch.bfloat16, "cuda")
    vae_m = vae.init_vae_params(g(1), torch.float32, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    pipe = WanI2V(cfg, model, vae_m, clip_model=clip_m,
                  sampling_steps=steps, dtype=torch.bfloat16)
    pipe.sync_timing = True
    image, how = _image_input(_synthetic_image(540, 960), 480, 832)
    image = torch.from_numpy(image)[None].cuda()
    noise = torch.randn((1, 21, 16, 60, 104), generator=g(4), device="cuda")
    cond, uncond = _text_states(cfg, "cuda")
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    video = pipe.generate_from_image(noise, image, cond, uncond)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(attn.launch_counts)
    clip_blocks = clip.VIT_H_14["num_layers"] - 1
    expected = {**dict.fromkeys(counts, 0),
                "flash_fwd": clip_blocks + 3 * cfg.num_layers * steps}
    pt = pipe.phase_times
    row = {"phase": "wan_i2v", "model": cfg.name, "steps": steps,
           "params": params, "weights_gib": weights_gib, "init_s": init_s,
           "image_input": how, "latents": [21, 60, 104],
           "seconds": seconds, "clip_ms": 1e3 * pt["clip_s"],
           "encode_s": pt["encode_s"],
           "seconds_per_step": pt["steps_s"] / steps,
           "decode_s": pt["decode_s"], "launches": counts,
           "expected_launches": expected,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           **_video_row(video)}
    del pipe, model, clip_m, vae_m, video
    torch.cuda.empty_cache()
    emit(row)
    check(counts == expected, (counts, expected))
    check(row["finite"] and row["video_shape"] == [1, 81, 3, 480, 832]
          and row["video_std"] > 0, row)
    check(row["max_memory_allocated_gib"] < 79.0, row)
    return counts["flash_fwd"]


def _clip_ids(vocab: int, L: int = 77, seed: int = 9):
    """Two XLM-R id rows of L: <s> (0), words, </s> (2); the second one
    ends at 20 and is padded (pad id 1)."""
    ids = np.random.default_rng(seed).integers(5, vocab, (2, L))
    ids[:, 0] = 0
    ids[0, -1] = ids[1, 19] = 2
    ids[1, 20:] = 1
    return torch.from_numpy(ids)


def phase_clip_text():
    """`xlm_roberta_clip_forward` at full width and depth (ViT-H/14, 32
    blocks; XLM-R large, 24 layers, vocab 250002; seeded f32 weights made
    on the card): two 224x224 images from the synthetic one and two
    77-token rows, one padded: exact K1 launches (32 visual blocks; the
    text tower's key-padding attention is plain torch), the forward's ms,
    the peak memory; then a 2-layer full-width copy of both towers on the
    card against the CPU (f32, TF32 off: within 1e-4 relative)."""
    from mmpl_tpu_torch.models import clip, xlm_roberta as xr
    vis, text = clip.VIT_H_14, xr.XLM_ROBERTA_LARGE
    img, _ = _image_input(_synthetic_image(540, 960), 480, 832)
    imgs = clip.preprocess_image(torch.from_numpy(np.stack(
        [img, img[:, :, ::-1].copy()])))
    ids = _clip_ids(text["vocab_size"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = clip.init_xlm_roberta_clip_params(
        vis, text, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    attn.reset_launch_counts()
    xi, xt = clip.xlm_roberta_clip_forward(model, imgs.cuda(), ids.cuda())
    torch.cuda.synchronize()
    counts = dict(attn.launch_counts)
    ms = time_ms(lambda: clip.xlm_roberta_clip_forward(
        model, imgs.cuda(), ids.cuda()), max_reps=5)
    expected = {**dict.fromkeys(counts, 0), "flash_fwd": vis["num_layers"]}
    row = {"phase": "clip_text", "visual_layers": vis["num_layers"],
           "text_layers": text["num_layers"],
           "params": sum(p.numel() for p in model.parameters()),
           "images": list(imgs.shape), "ids": list(ids.shape),
           "forward_ms": ms, "launches": counts,
           "expected_launches": expected,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "visual_shape": list(xi.shape), "text_shape": list(xt.shape),
           "finite": bool(torch.isfinite(xi).all()
                          and torch.isfinite(xt).all())}
    del model, xi, xt
    torch.cuda.empty_cache()

    cut_v, cut_t = dict(vis, num_layers=2), dict(text, num_layers=2)
    shallow = clip.init_xlm_roberta_clip_params(
        cut_v, cut_t, generator=torch.Generator().manual_seed(1))
    want = clip.xlm_roberta_clip_forward(shallow, imgs, ids)
    card = copy.deepcopy(shallow).to("cuda")
    got = [t.cpu() for t in clip.xlm_roberta_clip_forward(
        card, imgs.cuda(), ids.cuda())]
    del card
    torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    row.update(shallow_layers=2,
               shallow_visual_rel_err=rel(got[0], want[0]),
               shallow_text_rel_err=rel(got[1], want[1]))
    emit(row)
    check(counts == expected, (counts, expected))
    check(row["finite"] and row["visual_shape"] == [2, 257, 1280]
          and row["text_shape"] == [2, 1024], row)
    check(row["shallow_visual_rel_err"] <= 1e-4
          and row["shallow_text_rel_err"] <= 1e-4, row)
    return counts["flash_fwd"]


def phase_wan_parity(steps: int = 2):
    """The tiny fp32 `WanT2V.generate` and `WanI2V.generate_from_image`
    (4x4 latents, 3 latent frames, a CLIP tower of ViT-H/14's width cut
    to 2 blocks, the VAE with random weights), `steps` UniPC steps, on the
    card against the CPU from the same weights and inputs (within 1e-4
    relative; the CPU path is held to the JAX package by
    tests/test_torch_wan_reference.py)."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import clip
    from mmpl_tpu_torch.pipelines.wan_reference import WanI2V, WanT2V
    vis = dict(clip.VIT_H_14, mlp_ratio=1, num_layers=2)
    vae_cpu = vae.init_vae_params(torch.Generator().manual_seed(1))
    clip_cpu = clip.init_clip_visual_params(vis,
                                            torch.Generator().manual_seed(3))
    rng = np.random.default_rng(23)
    noise = rng.standard_normal((1, 3, 16, 4, 4)).astype(np.float32)
    image = rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    row = {"phase": "wan_parity", "steps": steps}
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    for kind in ("t2v", "i2v"):
        cfg = tiny_test_config(kind)
        model = dit.randomize_head(dit.init_dit_params(
            cfg, torch.Generator().manual_seed(0), torch.float32),
            torch.Generator().manual_seed(99))
        ctx = rng.standard_normal((2, 1, cfg.text_len, cfg.text_dim)).astype(
            np.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            t = lambda a: torch.from_numpy(a).to(dev)
            args = (copy.deepcopy(model).to(dev), copy.deepcopy(vae_cpu)
                    .to(dev))
            attn.reset_launch_counts()
            if kind == "t2v":
                pipe = WanT2V(cfg, *args, sampling_steps=steps,
                              dtype=torch.float32)
                video = pipe.generate(t(noise), t(ctx[0]), t(ctx[1]))
            else:
                pipe = WanI2V(cfg, *args, clip_model=copy.deepcopy(
                    clip_cpu).to(dev), sampling_steps=steps,
                    dtype=torch.float32)
                video = pipe.generate_from_image(t(noise), t(image),
                                                 t(ctx[0]), t(ctx[1]))
            out[dev] = (video.cpu(), attn.launch_counts["flash_fwd"])
        per_step = 2 if kind == "t2v" else 3
        expected = per_step * cfg.num_layers * steps + (
            vis["num_layers"] - 1 if kind == "i2v" else 0)
        row.update({f"{kind}_rel_err": rel(out["cuda"][0], out["cpu"][0]),
                    f"{kind}_flash_fwd_launches": out["cuda"][1],
                    f"{kind}_expected_launches": expected,
                    f"{kind}_shape": list(out["cuda"][0].shape)})
    emit(row)
    for kind in ("t2v", "i2v"):
        check(row[f"{kind}_rel_err"] <= 1e-4, row)
        check(row[f"{kind}_flash_fwd_launches"]
              == row[f"{kind}_expected_launches"], row)
        check(row[f"{kind}_shape"] == [1, 9, 3, 32, 32], row)


# ---------------------------------------------------------------------------
# Distillation, the flow objective and the baseline pipelines
# ---------------------------------------------------------------------------

#: the depth of the full-depth distillation and flow phases (the memory
#: reckoning of three 1.3B models, two AdamW states and the EMA fits the
#: 80 GB card at 30 layers) and of the phases cut to 2 layers
DISTILL_LAYERS = 30
SHALLOW_LAYERS = 2
#: the 21 latent frames of a 480x832 window, in blocks of 3
DISTILL_FRAMES, DISTILL_BLOCKS = 21, 7
FEW_STEPS = (1000, 750, 500, 250)


def _cfg13(layers: int = 30):
    from mmpl_tpu_torch.core.config import DotDict
    return DotDict(WAN_CONFIGS["t2v-1.3B"], num_layers=layers)


def _model13(cfg, seed: int, dtype):
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    return dit.randomize_head(dit.init_dit_params(cfg, g(seed), dtype,
                                                  "cuda"), g(seed + 99))


def _attn_counts(**kw) -> dict:
    """Every attention counter, 0 where not given."""
    return {**dict.fromkeys(attn.launch_counts, 0), **kw}


def _k123(fwd: int, bwd: int = 0) -> dict:
    return _attn_counts(flash_fwd=fwd, flash_bwd_dkv=bwd, flash_bwd_dq=bwd)


def _run_counted(fn):
    """(result, seconds, attention launches, peak GiB) of fn() on the card."""
    attn.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, dict(attn.launch_counts),
            torch.cuda.max_memory_allocated() / 2**30)


def phase_causal_diffusion(model, cond, uncond, quantize=None):
    """`CausalDiffusionInferencePipeline` on the 1.3B model at 480x832:
    7 blocks of 3 frames, each by a 2-step UniPC loop over the CFG pair
    and a clean commit (K1 4680 x 4680k, CFG batch 2); with `quantize`,
    int8 projections (P2, Q) and the int8 cache (Q codes k and v in each
    commit).  Exact launches, ms per block."""
    from mmpl_tpu_torch.pipelines.causal_diffusion_inference import \
        CausalDiffusionInferencePipeline
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    pipe = CausalDiffusionInferencePipeline(
        cfg, model, sampling_steps=2, timestep_shift=8.0,
        guidance_scale=5.0, quantize=quantize,
        quantize_cache=quantize is not None, dtype=torch.bfloat16)
    noise = torch.randn((1, 21, 16, 60, 104), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(110))
    block_s = []
    run_block = pipe._denoise_block

    def timed_block(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_block(*a)
        torch.cuda.synchronize()
        block_s.append(time.perf_counter() - t0)
        return out

    pipe._denoise_block = timed_block
    for k in quant.launch_counts:
        quant.launch_counts[k] = 0
    out, seconds, counts, peak = _run_counted(
        lambda: pipe.inference(noise, cond, uncond))
    forwards = DISTILL_BLOCKS * 3                 # 2 steps + the commit
    expected = _k123(forwards * 30 * 2)
    n8 = 0
    if quantize is not None:
        policy = (dit.last_auto_quantize_report["policy"]
                  if quantize == "auto" else
                  dict.fromkeys(dit.AUTO_QUANT_TARGETS, quantize))
        n8 = sum(mode == "int8" for mode in policy.values())
    q_expected = {"int8_gemm": n8 * 30 * forwards,
                  "quantize_rows": n8 * 30 * forwards
                  + (2 * 30 * DISTILL_BLOCKS if quantize else 0)}
    row = {"phase": "causal_diffusion" + ("_int8" if quantize else ""),
           "quantize": quantize, "seconds": seconds,
           "block_ms": [1e3 * s for s in block_s],
           "ms_per_block": 1e3 * statistics.mean(block_s),
           "launches": counts, "expected_launches": expected,
           "int8_launches": dict(quant.launch_counts),
           "expected_int8_launches": q_expected, "w8a8_targets": n8,
           "max_memory_allocated_gib": peak,
           "latents_finite": bool(torch.isfinite(out).all().item()),
           "latents_std": out.float().std().item()}
    emit(row)
    check(counts == expected, row)
    check(dict(quant.launch_counts) == q_expected, row)
    check(tuple(out.shape) == (1, 21, 16, 60, 104) and row["latents_finite"],
          row)
    return counts, dict(quant.launch_counts)


def phase_bidirectional(model, cond, uncond):
    """`BidirectionalDiffusionInferencePipeline` (2 UniPC steps, CFG pair:
    K1 at 32760^2, batch 2) and `BidirectionalInferencePipeline` (4 steps,
    batch 1) on the 1.3B model at 480x832."""
    from mmpl_tpu_torch.pipelines.bidirectional_inference import (
        BidirectionalDiffusionInferencePipeline,
        BidirectionalInferencePipeline)
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    noise = torch.randn((1, 21, 16, 60, 104), device=dev, generator=g(111))
    total = {}
    for name, pipe, run, fwd in (
            ("diffusion", BidirectionalDiffusionInferencePipeline(
                cfg, model, sampling_steps=2, dtype=torch.bfloat16),
             lambda p: p.inference(noise, cond, uncond), 2),
            ("fewstep", BidirectionalInferencePipeline(
                cfg, model, FEW_STEPS, dtype=torch.bfloat16),
             lambda p: p.inference(noise, cond, generator=g(112)), 4)):
        out, seconds, counts, peak = _run_counted(lambda: run(pipe))
        expected = _k123(fwd * 30 * 2)
        row = {"phase": f"bidirectional_{name}", "seconds": seconds,
               "ms_per_forward": 1e3 * seconds / fwd, "launches": counts,
               "expected_launches": expected,
               "max_memory_allocated_gib": peak,
               "latents_finite": bool(torch.isfinite(out).all().item()),
               "latents_std": out.float().std().item()}
        emit(row)
        check(counts == expected, row)
        check(tuple(out.shape) == tuple(noise.shape)
              and row["latents_finite"], row)
        total = {k: total.get(k, 0) + counts[k] for k in counts}
    return total


def phase_window_dpm(model, cond, uncond, steps: int = 4):
    """One planned t2v window of the 1.3B model with
    `sample_solver="dpm++"`, 4 steps: K1 exactly, finite latents."""
    dev = torch.device("cuda")
    pipe = CausalFPSInferencePipeline(WAN_CONFIGS["t2v-1.3B"], model,
                                      sampling_steps=steps,
                                      sample_solver="dpm++",
                                      dtype=torch.bfloat16)
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    noise = torch.randn((1, 21, 16, 60, 104), device=dev, generator=g(113))
    out, seconds, counts, peak = _run_counted(
        lambda: pipe.inference(noise, cond, uncond, generator=g(114)))
    expected = _k123((4 * steps + 3) * 30 * 2)
    row = {"phase": "window_dpm", "solver": type(pipe.sampler).__name__,
           "steps": steps, "seconds": seconds, "launches": counts,
           "expected_launches": expected, "max_memory_allocated_gib": peak,
           "latents_finite": bool(torch.isfinite(out).all().item()),
           "latents_std": out.float().std().item()}
    emit(row)
    check(counts == expected, row)
    check(row["solver"] == "FlowDPMSolver" and row["latents_finite"], row)
    return counts


def phase_train_flow(timed_steps: int = 2):
    """The flow objective on the 1.3B model at full depth: 21 latent frames
    at 60x104 (32760 tokens, bidirectional), a bf16 trunk over fp32
    masters with per-block recomputation, AdamW, EMA, batch 1.  Per step
    each layer launches K1 four times (self and text cross-attention,
    forward and recomputation) and K2 and K3 twice."""
    from mmpl_tpu_torch.training.diffusion import (DiffusionTrainer,
                                                   draw_flow, make_loss_fn,
                                                   make_scheduler)
    from mmpl_tpu_torch.utils.ema import EmaParams
    cfg = _cfg13(DISTILL_LAYERS)
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    model = _model13(cfg, 20, torch.float32)
    trainer = DiffusionTrainer(model, make_loss_fn(cfg, make_scheduler(8.0)),
                               learning_rate=1e-5)
    ema = EmaParams(model, decay=0.999)
    shape = (1, DISTILL_FRAMES, 16, 60, 104)
    gen = g(21)
    batch = {"latents": torch.randn(shape, device=dev, generator=gen),
             "context": torch.randn((1, 512, 4096), device=dev,
                                    generator=gen)}

    def step():
        loss = trainer.train_step(batch, draw_flow(gen, shape, 3, dev))
        ema.update(model)
        return loss.item()

    rows = []
    for i in range(timed_steps + 1):
        loss, seconds, counts, peak = _run_counted(step)
        row = {"phase": "train_flow", "step": i, "warmup": i == 0,
               "layers": cfg.num_layers, "seconds": seconds, "loss": loss,
               "grad_norm": trainer.grad_norm.item(), "launches": counts,
               "expected_launches": _k123(4 * cfg.num_layers,
                                          2 * cfg.num_layers),
               "max_memory_allocated_gib": peak}
        emit(row)
        check(counts == row["expected_launches"], row)
        check(math.isfinite(loss) and math.isfinite(row["grad_norm"])
              and row["grad_norm"] > 0, row)
        rows.append(row)
    timed = rows[1:]
    return ({k: sum(r["launches"][k] for r in timed) for k in counts},
            statistics.mean(r["seconds"] for r in timed))


def _distill_setup(layers: int, dtype=torch.bfloat16, gan: bool = False,
                   frames: int = DISTILL_FRAMES, **rollout_kw):
    """The 1.3B distillation bundle at `layers`: generator, fake score and
    real score (or GAN head) as fp32 masters with non-zero heads from
    seeds, the rollout and Distiller of configs/self_forcing_dmd.yaml
    (warped steps, shift 5.0, guidance 3.0) in `dtype`, and one batch."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.training.diffusion import make_scheduler
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    from mmpl_tpu_torch.training.gan import init_gan_head_params
    from mmpl_tpu_torch.training.self_forcing import SelfForcingRollout
    cfg = _cfg13(layers)
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    models = {"generator": _model13(cfg, 30, torch.float32),
              "fake_score": _model13(cfg, 31, torch.float32)}
    if gan:
        models["gan_head"] = init_gan_head_params(
            g(33), atten_dim=cfg.dim, ffn_dim=cfg.ffn_dim,
            device=dev).requires_grad_(False)
    else:
        models["real_score"] = _model13(cfg, 32, torch.float32)
    sch = make_scheduler(5.0)
    kw = dict(warp_denoising_step=True, num_max_frames=DISTILL_FRAMES,
              grad_frame_window=DISTILL_FRAMES, dtype=dtype)
    kw.update(rollout_kw)
    ro = SelfForcingRollout(cfg, sch, FEW_STEPS, **kw)
    dcfg = dict(timestep_shift=5.0, real_guidance_scale=3.0, dtype=dtype)
    gen = g(34)
    ctx = torch.randn((1, 512, 4096), device=dev, generator=gen)
    batch = {"context": ctx, "uncond_context": torch.zeros_like(ctx),
             "noise": torch.randn((1, frames, 16, 60, 104), device=dev,
                                  generator=gen),
             "ctx_kv": train._context_kv(models["generator"], cfg,
                                         ctx.to(dtype))}
    if gan:
        batch["real_latents"] = torch.randn(
            (1, DISTILL_FRAMES, 16, 60, 104), device=dev, generator=gen)
    return cfg, models, ro, sch, dcfg, batch, gen


def _distill_step(models, keys, loss_fn, batch, ro, gen, nblocks, lr=1e-5):
    """One AdamW step of `keys` on the loss with the exit flags drawn
    here (so the run's launches can be checked against them)."""
    from mmpl_tpu_torch import train
    flags = ro.sample_exit_flags(gen, nblocks, device=gen.device)
    opt = train.adamw([p for k in keys for p in models[k].parameters()], lr,
                      train.OPTAX_WEIGHT_DECAY)
    draws = {"generator": gen, "exit_flags": flags}
    loss = train.train_step(models, keys, loss_fn, opt, batch, draws)
    return loss.item(), ro.block_flags(flags, nblocks)


def _rollout_k123(flags, L, graded):
    """K1 and K2 / K3 of a rollout: every block's no-grad steps before its
    flag, the flagged step and the commit (2L K1 each); the graded blocks'
    flagged step again in the backward pass, and its backward."""
    fwd = sum(f + 2 for f in flags) * 2 * L
    return fwd + graded * 2 * L, graded * 2 * L


def phase_distill_dmd():
    """One DMD critic step and one generator step at 1.3B width and
    DISTILL_LAYERS depth, 21 frames at 60x104, the rollout and the
    Distiller in bf16 over fp32 masters (configs/self_forcing_dmd.yaml's
    warped steps, shift 5.0, guidance 3.0), AdamW.  The exit flag is
    drawn once for all blocks (same_step_across_blocks), so the launches
    are checked against the flag's formula."""
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    cfg, models, ro, sch, dcfg, batch, gen = _distill_setup(DISTILL_LAYERS)
    dist = Distiller(cfg, DistillationConfig(**dcfg), ro, sch)
    L, nb = cfg.num_layers, DISTILL_BLOCKS
    n_params = sum(p.numel() for m in models.values()
                   for p in m.parameters())
    out, total = [], {}
    for role, keys, fn in (("critic", ("fake_score",), dist.critic_loss),
                           ("generator", ("generator",),
                            dist.dmd_generator_loss)):
        (loss, flags), seconds, counts, peak = _run_counted(
            lambda: _distill_step(models, keys, fn, batch, ro, gen, nb))
        if role == "critic":
            # the rollout without gradients; the fake score's forward,
            # its recomputation and its backward
            fwd, bwd = _rollout_k123(flags, L, 0)
            expected = _k123(fwd + 2 * 2 * L, 2 * L)
        else:
            # the rollout with every block graded; three score forwards
            # (fake, real cond, real uncond) without gradients
            fwd, bwd = _rollout_k123(flags, L, nb)
            expected = _k123(fwd + 3 * 2 * L, bwd)
        row = {"phase": "distill_dmd", "step": role, "layers": L,
               "params": n_params, "flag": flags[0], "seconds": seconds,
               "loss": loss, "launches": counts,
               "expected_launches": expected,
               "max_memory_allocated_gib": peak}
        emit(row)
        check(counts == expected, row)
        check(math.isfinite(loss), row)
        out.append(row)
        total = {k: total.get(k, 0) + counts[k] for k in counts}
    grads_finite = all(torch.isfinite(p).all().item()
                       for m in models.values() for p in m.parameters())
    phase_train_profile(
        lambda: _distill_step(models, ("generator",),
                              dist.dmd_generator_loss, batch, ro, gen, nb),
        phase="distill_profile",
        what=f"one DMD generator step, 1.3B width, {L} layers, bf16 over "
             f"fp32 masters", checked=("flash_bwd_dkv", "flash_bwd_dq"))
    emit({"phase": "distill_dmd_total", "layers": L,
          "seconds_per_step": {r["step"]: r["seconds"] for r in out},
          "max_memory_allocated_gib": max(r["max_memory_allocated_gib"]
                                          for r in out),
          "params_finite_after": grads_finite, "launches": total})
    check(grads_finite, "non-finite parameters after the DMD steps")
    return total


def phase_distill_other():
    """One step each of SiD (generator), GAN (critic with R1 / R2, then
    generator), CausVid (generator, fake-score CFG 2.0) and ODE regression
    at 1.3B width cut to SHALLOW_LAYERS, bf16 over fp32 masters."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.training.distillation import (
        DistillationConfig, Distiller, ode_regression_loss,
        prepare_ode_generator_input)
    from mmpl_tpu_torch.training.gan import gan_tap_layers
    L, nb = SHALLOW_LAYERS, DISTILL_BLOCKS
    total = {}

    def record(name, fn, expected_of):
        nonlocal total
        (loss, flags), seconds, counts, peak = _run_counted(fn)
        expected = expected_of(flags)
        row = {"phase": "distill_other", "objective": name, "layers": L,
               "flag": flags[0] if flags else None, "seconds": seconds,
               "loss": loss, "launches": counts,
               "expected_launches": expected,
               "max_memory_allocated_gib": peak}
        emit(row)
        check(counts == expected, row)
        check(math.isfinite(loss), row)
        total = {k: total.get(k, 0) + counts[k] for k in counts}

    cfg, models, ro, sch, dcfg, batch, gen = _distill_setup(L)
    sid = Distiller(cfg, DistillationConfig(**dcfg), ro, sch)
    cv = Distiller(cfg, DistillationConfig(fake_guidance_scale=2.0, **dcfg),
                   ro, sch)

    def graded_gen(extra_fwd, extra_bwd):
        def of(flags):
            fwd, bwd = _rollout_k123(flags, L, nb)
            return _k123(fwd + extra_fwd, bwd + extra_bwd)
        return of

    # SiD: three score forwards with gradients into the sample
    record("sid", lambda: _distill_step(
        models, ("generator",), sid.sid_generator_loss, batch, ro, gen, nb),
        graded_gen(3 * 2 * 2 * L, 3 * 2 * L))
    # CausVid: four score forwards without gradients
    record("causvid", lambda: _distill_step(
        models, ("generator",), cv.causvid_generator_loss, batch, ro, gen,
        nb), graded_gen(4 * 2 * L, 0))
    del models["real_score"]
    torch.cuda.empty_cache()

    cfg, models, ro, sch, dcfg, batch, gen = _distill_setup(L, gan=True)
    gan = Distiller(cfg, DistillationConfig(r1_weight=0.1, r2_weight=0.1,
                                            **dcfg), ro, sch)
    # one classify pass: the trunk up to the last tap (2 per layer), one
    # register-token attention per tap (Lq = 1 over 32760 keys)
    trunk = 2 * (max(gan_tap_layers(L, 3)) + 1)
    classify = trunk + 3

    def gan_critic(flags):
        fwd, _ = _rollout_k123(flags, L, 0)
        # [fake; real], R1 and R2: three passes, the trunk recomputed
        return _k123(fwd + 3 * (classify + trunk), 3 * classify)

    record("gan_critic", lambda: _distill_step(
        models, ("fake_score", "gan_head"), gan.gan_critic_loss, batch, ro,
        gen, nb), gan_critic)
    record("gan_generator", lambda: _distill_step(
        models, ("generator",), gan.gan_generator_loss, batch, ro, gen, nb),
        graded_gen(classify + trunk, classify))
    del models
    torch.cuda.empty_cache()

    cfg, models, ro, sch, dcfg, batch, gen = _distill_setup(L)
    gmodel = models["generator"]
    steps = (1000, 750, 500)
    traj = torch.randn((1, len(steps) + 1, DISTILL_FRAMES, 16, 60, 104),
                       device="cuda", generator=gen)
    idx = torch.randint(0, len(steps), (1, nb), device="cuda",
                        generator=gen)
    noisy, tt = prepare_ode_generator_input(traj, steps, idx)
    ode_batch = {"noisy_input": noisy, "clean_latent": traj[:, -1],
                 "timestep": tt, "ctx_kv": batch["ctx_kv"]}

    def ode_step():
        opt = train.adamw(gmodel.parameters(), 1e-5,
                          train.OPTAX_WEIGHT_DECAY)
        loss = train.train_step(
            {"generator": gmodel}, ("generator",),
            lambda m, b, d: ode_regression_loss(m["generator"], cfg, sch, b,
                                                dtype=torch.bfloat16),
            opt, ode_batch, {})
        return loss.item(), []

    # each block: a noisy forward and a commit forward with gradients
    # through the cache, each recomputed; no gradient reaches the last
    # block's commit, nor the last layer's attention of the others
    record("ode", ode_step, lambda _: _k123(
        2 * nb * 2 * L + (2 * nb - 1) * 2 * L,
        nb * 2 * L + (nb - 1) * 2 * (L - 1)))
    return total


def phase_distill_rolling():
    """The DMD generator's rollout with `rolling` past the 21-slot ring
    (27 frames: 7 absolute-slot blocks, then 2 steady-state blocks that
    evict through the slot permutation, their commits functional) at
    SHALLOW_LAYERS: seconds, launches, finite gradients.  The last 21
    frames are graded: 7 of the 9 blocks."""
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    L = SHALLOW_LAYERS
    cfg, models, ro, sch, dcfg, batch, gen = _distill_setup(
        L, frames=27, rolling=True)
    dist = Distiller(cfg, DistillationConfig(**dcfg), ro, sch)
    (loss, flags), seconds, counts, peak = _run_counted(
        lambda: _distill_step(models, ("generator",),
                              dist.dmd_generator_loss, batch, ro, gen, 9))
    fwd, bwd = _rollout_k123(flags, L, 7)
    expected = _k123(fwd + 3 * 2 * L, bwd)
    finite = all(torch.isfinite(p).all().item()
                 for p in models["generator"].parameters())
    row = {"phase": "distill_rolling", "layers": L, "frames": 27,
           "ring_slots": 21, "flag": flags[0], "seconds": seconds,
           "loss": loss, "launches": counts, "expected_launches": expected,
           "params_finite_after": finite, "max_memory_allocated_gib": peak}
    emit(row)
    check(counts == expected and math.isfinite(loss) and finite, row)
    return counts


def phase_train_distill_cli():
    """`python -m mmpl_tpu_torch.train --smoke` for flow, dmd, sid,
    causvid, gan and ode on the card (tiny config, fp32, 21 frames at
    4x4, 2 steps, the generator every step), in this process: exact K1 /
    K2 / K3 launches (each distillation step's exit flags are drawn where
    the loss would draw them and recorded), finite losses."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.training.gan import gan_tap_layers
    L = tiny_test_config().num_layers
    nb = DISTILL_BLOCKS
    taps = 2 * (max(gan_tap_layers(L, 3)) + 1)
    classify = taps + 3
    real_draws = train.loss_draws
    total = {}
    for objective in ("flow", "dmd", "sid", "causvid", "gan", "ode"):
        flags = []

        def draws(generator, step, role):
            d = real_draws(generator, step, role)
            if objective in ("flow", "ode"):
                return d
            f = torch.randint(0, 4, (nb,), generator=generator,
                              device=generator.device)
            flags.append((role, int(f[0])))
            return {**d, "exit_flags": f}

        train.loss_draws = draws
        run = f"distill_cli_{objective}"
        shutil.rmtree(os.path.join(OUT_DIR, run), ignore_errors=True)
        try:
            rc, seconds, counts, peak = _run_counted(lambda: train.main([
                "--smoke", "--objective", objective, "--steps", "2",
                "--device", "cuda", "--dfake-gen-update-ratio", "1",
                "--log-dir", OUT_DIR, "--run-name", run]))
        finally:
            train.loss_draws = real_draws
        with open(os.path.join(OUT_DIR, run, "metrics.jsonl"),
                  encoding="utf-8") as f:
            recs = [json.loads(line) for line in f if line.strip()]
        losses = [r[k] for r in recs for k in ("loss", "critic_loss",
                                               "gen_loss") if k in r]
        if objective == "flow":
            expected = _k123(2 * 4 * L, 2 * 2 * L)
        elif objective == "ode":
            expected = _k123(2 * (2 * nb * 2 * L + (2 * nb - 1) * 2 * L),
                             2 * (nb * 2 * L + (nb - 1) * 2 * (L - 1)))
        else:
            fwd = bwd = 0
            for role, f in flags:
                rf, rb = _rollout_k123([f] * nb, L,
                                       nb if role == "generator" else 0)
                if objective == "gan":
                    # one classify pass each (the trainer sets no R1 / R2)
                    extra = (classify + taps, classify)
                elif role == "critic":
                    extra = (2 * 2 * L, 2 * L)
                else:
                    extra = {"dmd": (3 * 2 * L, 0), "causvid": (3 * 2 * L, 0),
                             "sid": (3 * 2 * 2 * L, 3 * 2 * L)}[objective]
                fwd += rf + extra[0]
                bwd += rb + extra[1]
            expected = _k123(fwd, bwd)
        row = {"phase": "train_distill_cli", "objective": objective,
               "rc": rc, "seconds": seconds, "losses": losses,
               "flags": flags, "launches": counts,
               "expected_launches": expected,
               "max_memory_allocated_gib": peak}
        emit(row)
        check(rc == 0 and losses and all(map(math.isfinite, losses)), row)
        check(counts == expected, row)
        total = {k: total.get(k, 0) + counts[k] for k in counts}
    return total


def phase_distill_parity():
    """Tiny fp32 DMD generator and critic losses and gradients (12 frames,
    two blocks' draws handed in) and a tiny `CausalDiffusionInference
    Pipeline` run, each on the card against the CPU's plain path.  Gate:
    1e-4 relative (gradients: of the largest entry)."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.pipelines.causal_diffusion_inference import \
        CausalDiffusionInferencePipeline
    from mmpl_tpu_torch.training.diffusion import make_scheduler
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    from mmpl_tpu_torch.training.self_forcing import SelfForcingRollout
    cfg = tiny_test_config()
    g = lambda s: torch.Generator().manual_seed(s)
    base = {k: dit.randomize_head(dit.init_dit_params(
        cfg, g(s), torch.float32), g(s + 99))
        for k, s in (("generator", 0), ("fake_score", 1),
                     ("real_score", 2))}
    gen = g(7)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen)
    noise = torch.randn(1, 6, 16, 4, 4, generator=gen)
    draws = {"exit_flags": torch.tensor([2, 1]),
             "rollout": [{"step": [torch.randn(1, 3, 16, 4, 4,
                                               generator=gen)
                                   for _ in range(3)],
                          "commit": torch.randn(1, 3, 16, 4, 4,
                                                generator=gen)}
                         for _ in range(2)],
             "u": torch.rand(1, 1, generator=gen),
             "noise": torch.randn(1, 6, 16, 4, 4, generator=gen)}
    row = {"phase": "distill_parity"}
    for loss_name, trained in (("dmd_generator_loss", "generator"),
                               ("critic_loss", "fake_score")):
        res = {}
        for dev in ("cpu", "cuda"):
            models = {k: copy.deepcopy(m).to(dev) for k, m in base.items()}
            sch = make_scheduler(5.0)
            ro = SelfForcingRollout(cfg, sch, FEW_STEPS, num_max_frames=6,
                                    grad_frame_window=6,
                                    same_step_across_blocks=False)
            dist = Distiller(cfg, DistillationConfig(timestep_shift=5.0),
                             ro, sch)
            with torch.no_grad():
                kv = dit.precompute_context_kv(
                    models["generator"], cfg,
                    dit.embed_text(models["generator"], ctx.to(dev)))
            d = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                 for k, v in draws.items()}
            models[trained].requires_grad_(True)
            attn.reset_launch_counts()
            val, _ = getattr(dist, loss_name)(
                models, {"noise": noise.to(dev), "ctx_kv": kv,
                         "context": ctx.to(dev),
                         "uncond_context": torch.zeros_like(ctx).to(dev)}, d)
            val.backward()
            res[dev] = (val.item(), {n: p.grad.cpu() for n, p in
                                     models[trained].named_parameters()
                                     if p.grad is not None},
                        dict(attn.launch_counts))
        (lc, gc, _), (lg, gg, counts) = res["cpu"], res["cuda"]
        scale = max(x.abs().max().item() for x in gc.values())
        row[loss_name] = {
            "loss_rel_err": abs(lg - lc) / abs(lc),
            "grad_max_abs_err_over_largest": max(
                (gg[n] - gc[n]).abs().max().item() for n in gc) / scale,
            "launches": counts}
    pipe_out = {}
    rng = np.random.default_rng(14)
    cnoise = torch.from_numpy(rng.standard_normal((1, 6, 16, 4, 4)).astype(
        np.float32))
    uncond = torch.zeros_like(ctx)
    for dev in ("cpu", "cuda"):
        pipe = CausalDiffusionInferencePipeline(
            cfg, copy.deepcopy(base["generator"]).to(dev), sampling_steps=2,
            local_attn_frames=6, dtype=torch.float32)
        attn.reset_launch_counts()
        pipe_out[dev] = pipe.inference(cnoise.to(dev), ctx.to(dev),
                                       uncond.to(dev)).cpu()
    row["causal_diffusion_rel_err"] = (
        (pipe_out["cuda"] - pipe_out["cpu"]).norm()
        / pipe_out["cpu"].norm()).item()
    row["causal_diffusion_flash_fwd"] = attn.launch_counts["flash_fwd"]
    emit(row)
    for loss_name in ("dmd_generator_loss", "critic_loss"):
        r = row[loss_name]
        check(r["loss_rel_err"] <= 1e-4, row)
        check(r["grad_max_abs_err_over_largest"] <= 1e-4, row)
        check(r["launches"]["flash_bwd_dkv"] > 0, row)
    check(row["causal_diffusion_rel_err"] <= 1e-4, row)
    check(row["causal_diffusion_flash_fwd"] == 2 * 3 * 2 * cfg.num_layers,
          row)


# ---------------------------------------------------------------------------
# Multi-device and serving: the chunk pipeline, its entry, the server, the
# ring, sequence parallelism and the process groups
# ---------------------------------------------------------------------------

CHUNKS = 3


def _chunk_forwards(steps: int, chunks: int) -> int:
    """DiT forwards of `chunks` chained t2v chunks: chunk 0 as a window
    from noise, each later one as a bridged window (`_window_forwards`)."""
    return (4 * steps + 3) + (chunks - 1) * (3 * steps + 3)


def phase_chunk_pipeline(steps: int = 4):
    """`ChunkParallelPipeline` at 1.3B (480x832, bf16, the CFG pair, 30
    layers, `steps` UniPC steps): 3 chunks over 2 stages on one card (two
    streams, chunk 2 back on stage 0), then the same chunks on 1 stage.
    Wall seconds and peak memory each way, each chunk's CUDA events, the
    overlap (chunk k+1's first group start against chunk k's end), exact
    K1 launches, and the 2-stage chunks against the 1-stage ones."""
    from mmpl_tpu_torch.parallel.chunk_pipeline import ChunkParallelPipeline
    cfg = WAN_CONFIGS["t2v-1.3B"]
    model = _model13(cfg, 0, torch.bfloat16)
    dev = torch.device("cuda", torch.cuda.current_device())
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    vae_m = vae.init_vae_params(g(1), torch.float32, dev)
    cond, uncond = cli.random_text_context(cfg, dev)
    gen = g(200)
    noises = [torch.randn((1, 21, 16, 60, 104), generator=gen, device=dev)
              for _ in range(CHUNKS)]
    expected = _attn_counts(flash_fwd=2 * cfg.num_layers
                            * _chunk_forwards(steps, CHUNKS))
    runs, total = {}, 0
    for stages in (2, 1):
        pipe = ChunkParallelPipeline(cfg, model, vae_m, devices=[dev] * stages,
                                     sampling_steps=steps,
                                     dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        chunks, seconds, counts, peak = _run_counted(
            lambda: pipe.generate(noises, cond, uncond, seed=5))
        timeline = pipe.device_timeline()
        overlap = [{"chunks": [k, k + 1],
                    "first_group_start_ms": timeline[k + 1]["groups_start_ms"],
                    "previous_end_ms": timeline[k]["end_ms"],
                    "overlap_ms": timeline[k]["end_ms"]
                    - timeline[k + 1]["groups_start_ms"]}
                   for k in range(CHUNKS - 1)]
        row = {"phase": "chunk_pipeline", "stages": stages,
               "chunks": CHUNKS, "steps": steps, "wall_s": seconds,
               "device_span_ms": max(t["end_ms"] for t in timeline),
               "timeline": timeline, "overlap": overlap,
               "stage_of_chunk": [e["stage"] for e in pipe.dispatch_log],
               "dispatch_s": [e["dispatch_end"] - e["dispatch_start"]
                              for e in pipe.dispatch_log],
               "launches": counts, "expected_launches": expected,
               "max_memory_allocated_gib": peak,
               "finite": all(bool(torch.isfinite(c).all()) for c in chunks)}
        emit(row)
        check(counts == expected, (counts, expected))
        check(row["finite"] and all(c.shape == (1, 21, 16, 60, 104)
                                    for c in chunks), row)
        check(row["stage_of_chunk"] == [i % stages for i in range(CHUNKS)],
              row)
        runs[stages] = [c.cpu() for c in chunks]
        total += counts["flash_fwd"]
        del pipe, chunks
    diffs = [(a - b).abs().max().item() for a, b in zip(runs[2], runs[1])]
    rels = [((a - b).norm() / b.norm()).item()
            for a, b in zip(runs[2], runs[1])]
    row = {"phase": "chunk_pipeline_equal", "bit_equal": all(
        torch.equal(a, b) for a, b in zip(runs[2], runs[1])),
        "max_abs_diff": diffs, "rel_diff": rels}
    if not row["bit_equal"]:
        row["why"] = ("the stages launch on two streams of one card, so "
                      "a kernel whose result depends on what runs beside "
                      "it (a library call picking another algorithm or "
                      "split) differs in its last bits; the diff grows "
                      "through the solver steps and the bridge")
    emit(row)
    check(max(rels) < 1e-2, row)
    del model, vae_m
    torch.cuda.empty_cache()
    return total


def phase_generate_parallel():
    """`python -m mmpl_tpu_torch.generate_parallel` in smoke mode on the
    card, in this process: 2 chunks of the tiny model over every visible
    card, one video file a chunk; exact K1 launches."""
    from mmpl_tpu_torch import generate_parallel
    from mmpl_tpu_torch.core.config import tiny_test_config
    out_dir = os.path.join(OUT_DIR, "generate_parallel")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--num-chunks", "2", "--sampling-steps", "4", "--output-dir",
            out_dir]
    try:
        rc, seconds, counts, peak = _run_counted(
            lambda: generate_parallel.main(argv))
        files = sorted(os.listdir(out_dir))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    stages = torch.cuda.device_count()
    expected = _attn_counts(flash_fwd=2 * tiny_test_config().num_layers
                            * _chunk_forwards(4, 2))
    row = {"phase": "generate_parallel", "argv": argv, "rc": rc,
           "seconds": seconds, "stages": stages, "files": files,
           "launches": counts, "expected_launches": expected}
    emit(row)
    check(rc == 0 and len(files) == 2, row)
    check(counts == expected, (counts, expected))
    return counts["flash_fwd"]


def _http(port, path, body=None, timeout=30):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serving(steps: int = 4):
    """The HTTP server in this process on 127.0.0.1 (an ephemeral port),
    backed by `make_pipeline_backend` over the 1.3B chunk pipeline (480x832,
    bf16, `steps` steps, random text states) on 2 stages of this card:
    /health, then a 2-chunk /parallel_text_2_video request polled through
    /status to success, its files written; the request's seconds, exact K1
    launches, and when chunk 1's file was published: while chunk 1 still
    ran (its end event not yet complete)."""
    import threading
    from mmpl_tpu_torch.serving import server as srv_mod
    cfg = WAN_CONFIGS["t2v-1.3B"]
    model = _model13(cfg, 0, torch.bfloat16)
    dev = torch.device("cuda", torch.cuda.current_device())
    vae_m = vae.init_vae_params(torch.Generator(device=dev).manual_seed(1),
                                torch.float32, dev)
    out_dir = os.path.join(OUT_DIR, "serving")
    shutil.rmtree(out_dir, ignore_errors=True)
    config = srv_mod.ParallelServerConfig(host="127.0.0.1", port=0,
                                          output_folder=out_dir,
                                          num_chunks=2)
    backend = srv_mod.make_pipeline_backend(
        cfg, model, vae_m, srv_mod.smoke_text_encoder(cfg, dev), config,
        devices=[dev, dev], lat_hw=(60, 104), sampling_steps=steps,
        dtype=torch.bfloat16)

    def chunk1_done() -> bool:
        """Whether chunk 1's last group has run on the card (its log entry
        is written once the chunk is enqueued)."""
        log = backend.pipe.dispatch_log
        return len(log) == 2 and bool(log[1]) \
            and log[1]["cuda_events"]["end"].query()

    server = srv_mod.create_server(config, backend=backend)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        health = _http(port, "/health")
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        body = _http(port, "/parallel_text_2_video",
                     {"prompt": "a red panda climbing a tree", "seed": 3,
                      "num_chunks": 2, "seqid": "chip-smoke"})
        rec, first = None, None
        while time.perf_counter() - t0 < 600:
            rec = _http(port, f"/status/{body['task_id']}")
            if first is None and rec.get("data") and rec["data"]["video"]:
                first = {"s": time.perf_counter() - t0,
                         "status": rec["status"],
                         "videos": len(rec["data"]["video"]),
                         "chunk1_done": chunk1_done()}
            if rec["status"] in (srv_mod.TaskStatus.SUCCESS.value,
                                 srv_mod.TaskStatus.FAILED.value):
                break
            time.sleep(0.2)
        seconds = time.perf_counter() - t0
        search = _http(port, "/openapi/task_search", {"seqid": "chip-smoke"})
        files = sorted(os.listdir(out_dir))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        shutil.rmtree(out_dir, ignore_errors=True)
    counts = dict(attn.launch_counts)
    expected = _attn_counts(flash_fwd=2 * cfg.num_layers
                            * _chunk_forwards(steps, 2))
    row = {"phase": "serving", "health": health, "request_s": seconds,
           "status": rec["status"], "message": rec["message"],
           "videos": rec["data"]["video"], "covers": rec["data"]["cover_image"],
           "search_status": search["status"], "files": files,
           "first_published": first, "stages": len(backend.pipe.stages),
           "launches": counts, "expected_launches": expected}
    emit(row)
    check(health["status"] == "healthy" and health["model_loaded"], row)
    check(rec["status"] == srv_mod.TaskStatus.SUCCESS.value
          and len(rec["data"]["video"]) == 2
          and len(rec["data"]["cover_image"]) == 2
          and search["status"] == rec["status"], row)
    check(counts == expected, (counts, expected))
    # chunk 0's file is published while chunk 1 still runs
    check(first is not None and first["videos"] == 1
          and first["status"] == srv_mod.TaskStatus.PROCESSING.value
          and not first["chunk1_done"], row)
    del model, vae_m, backend
    torch.cuda.empty_cache()
    return counts["flash_fwd"]


RING = 4
RING_SHAPE = (2, 32760, 12, 128)


def phase_ring():
    """`ring_flash_attention` with ring = 4 in the in-process group at
    32760 tokens, B=2, 12 x 128, bf16: one K1 call per ring step over the
    four ranks' stacked shards, then K2 / K3 per step with the global lse
    and delta.  Held against one K1 call over all 32760 keys and K2 / K3
    over the whole sequence; exact launches (4 K1, 4 K2, 4 K3 a call); the
    ring's ms, the whole-sequence kernels' ms, the merge's and the
    rotations' own ms."""
    from mmpl_tpu_torch.parallel.collectives import LocalMesh
    mesh = LocalMesh({"ring": RING})
    group = mesh.get_group("ring")
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, k, v, do = (_rand(gen, torch.bfloat16, *RING_SHAPE) for _ in range(4))
    shard = lambda x: mesh.shard(x, 1, ("ring",)).contiguous()
    unshard = lambda x: mesh.gather(x, 1, ("ring",))
    ql, kl, vl, dol = (shard(x) for x in (q, k, v, do))
    # forward: the ring against K1 whole
    attn.reset_launch_counts()
    with torch.no_grad():
        out_l, lse_l = attn._ring_fwd(ql, kl, vl, group, None)
    fwd_counts = dict(attn.launch_counts)
    o_w, lse_w = attn.flash_fwd_cuda(q, k, v)
    out = unshard(out_l)
    lse = lse_l.reshape(RING, 2, 12, -1).permute(1, 2, 0, 3).reshape(
        2, 12, -1)
    err = (out.float() - o_w.float()).abs()
    # backward: autograd through the ring against K2 / K3 whole
    leaves = [x.clone().requires_grad_() for x in (ql, kl, vl)]
    attn.reset_launch_counts()
    attn.ring_flash_attention(*leaves, group).backward(dol)
    bwd_counts = dict(attn.launch_counts)
    delta_w = (do.float() * o_w.float()).sum(-1).transpose(1, 2).contiguous()
    dq_w, dk_w, dv_w = attn.flash_bwd_cuda(q, k, v, do, lse_w, delta_w)
    rel = {f"{n}_rel_err": ((unshard(x.grad).float() - w.float()).norm()
                            / w.float().norm()).item()
           for n, x, w in zip(("dq", "dk", "dv"), leaves, (dq_w, dk_w, dv_w))}
    torch.cuda.synchronize()
    B, L, N, D = RING_SHAPE
    o_c, lse_c = attn.flash_attention_lse(ql, kl, vl)
    of = out_l.float()
    row = {"phase": "ring", "ring": RING, "B": B, "L": L, "N": N, "D": D,
           "group": "in-process (LocalMesh)",
           "o_max_abs_err": err.max().item(),
           "o_mean_abs_err": err.mean().item(),
           "lse_max_abs_err": (lse - lse_w).abs().max().item(), **rel,
           "fwd_launches": fwd_counts, "bwd_launches": bwd_counts,
           "ms": time_ms(lambda: attn._ring_fwd(ql, kl, vl, group, None)),
           "whole_k1_ms": time_ms(lambda: attn.flash_fwd_cuda(q, k, v)),
           "merge_ms": (RING - 1) * time_ms(
               lambda: attn.merge_lse(of, lse_l, o_c, lse_c)),
           "rotate_ms": 2 * (RING - 1) * time_ms(lambda: group.rotate(kl))}

    def fwd_bwd():
        xs = [x.detach().requires_grad_() for x in (ql, kl, vl)]
        attn.ring_flash_attention(*xs, group).backward(dol)

    row["fwd_bwd_ms"] = time_ms(fwd_bwd)
    row["whole_fwd_bwd_ms"] = time_ms(
        lambda: attn.flash_bwd_cuda(q, k, v, do, lse_w, delta_w)) \
        + row["whole_k1_ms"]
    row["bound_ms"], row["bound_by"] = bound(B, N, D, L, L, torch.bfloat16)
    emit(row)
    check(row["o_max_abs_err"] <= FWD_TOL["max"]
          and row["o_mean_abs_err"] <= FWD_TOL["mean"]
          and row["lse_max_abs_err"] <= FWD_TOL["lse"], row)
    check(all(v <= GRAD_REL_TOL[torch.bfloat16] for v in rel.values()), row)
    check(fwd_counts == _k123(RING), fwd_counts)
    check(bwd_counts == _k123(RING, RING), bwd_counts)
    del q, k, v, do, ql, kl, vl, dol, leaves, o_w, dq_w, dk_w, dv_w
    torch.cuda.empty_cache()
    return _k123(2 * RING, RING)


def phase_usp(steps: int = 2):
    """`WanT2V` at 1.3B, full depth, 480x832, bf16, `steps` UniPC steps
    (no decode) with sp = 2 x ring = 2 in the in-process group (Ulysses
    over sp: 6 heads a rank; the ring of 2 over the rest), against the
    single-device run from the same noise: the latents' error, seconds
    per step each way, exact K1 launches (self-attention: 2 ring steps a
    layer over the stacked ranks; cross-attention: 1)."""
    from mmpl_tpu_torch.parallel.collectives import LocalMesh
    from mmpl_tpu_torch.pipelines.wan_reference import WanT2V
    cfg = WAN_CONFIGS["t2v-1.3B"]
    model = _model13(cfg, 0, torch.bfloat16)
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    noise = torch.randn((1, 21, 16, 60, 104), generator=g(4), device="cuda")
    cond, uncond = _text_states(cfg, "cuda")
    rows = {}
    for name, mesh in (("single", None),
                       ("sp2_ring2", LocalMesh({"sp": 2, "ring": 2}))):
        pipe = WanT2V(cfg, model, None, sampling_steps=steps, mesh=mesh,
                      dtype=torch.bfloat16)
        pipe.sync_timing = True
        torch.cuda.empty_cache()
        lat, seconds, counts, peak = _run_counted(
            lambda: pipe.generate(noise, cond, uncond, decode=False))
        rows[name] = {"latents": lat.float(), "seconds": seconds,
                      "seconds_per_step": pipe.phase_times["steps_s"] / steps,
                      "launches": counts, "peak_gib": peak}
    # one forward each way on the same input: the drift a step starts
    from mmpl_tpu_torch.models.dit import dit_forward
    from mmpl_tpu_torch.parallel.sequence_parallel import usp_dit_forward
    lat2 = torch.cat([noise, noise]).to(torch.bfloat16)
    t2 = torch.full((2,), 999.0, device="cuda")
    ctx2 = torch.cat([cond, uncond]).to(torch.bfloat16)
    with torch.no_grad():
        f_single = dit_forward(model, cfg, lat2, t2, ctx2).float()
        f_usp = usp_dit_forward(model, cfg, lat2, t2, ctx2,
                                LocalMesh({"sp": 2, "ring": 2}),
                                ring_axis="ring").float()
    forward_rel = ((f_usp - f_single).norm() / f_single.norm()).item()
    del f_single, f_usp
    a, b = rows["sp2_ring2"]["latents"], rows["single"]["latents"]
    per_fwd = {"single": 2, "sp2_ring2": 3}
    row = {"phase": "usp", "mesh": {"sp": 2, "ring": 2},
           "group": "in-process (LocalMesh)", "steps": steps,
           "forward_rel_err": forward_rel,
           "max_abs_err": (a - b).abs().max().item(),
           "rel_err": ((a - b).norm() / b.norm()).item(),
           "finite": bool(torch.isfinite(a).all()),
           **{f"{k}_{f}": r[f] for k, r in rows.items()
              for f in ("seconds", "seconds_per_step", "launches",
                        "peak_gib")}}
    emit(row)
    for k, r in rows.items():
        check(r["launches"] == _attn_counts(
            flash_fwd=per_fwd[k] * cfg.num_layers * steps), (k, r["launches"]))
    check(row["finite"] and row["forward_rel_err"] < 2e-2
          and row["rel_err"] < 5e-2, row)
    del model, rows, a, b
    torch.cuda.empty_cache()
    return 3 * cfg.num_layers * steps


def _sharded_fps_step(mesh) -> dict:
    """One group-3 solver forward of the 1.3B planned window through the
    pipeline built over `mesh` (`shard_params_for_inference`, the dp rows)
    against the same forward without a mesh."""
    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    from mmpl_tpu_torch.models.fps_dit import init_kv_cache
    cfg = WAN_CONFIGS["t2v-1.3B"]
    model = _model13(cfg, 0, torch.bfloat16)
    dev = torch.device("cuda", torch.cuda.current_device())
    cond, uncond = cli.random_text_context(cfg, dev)
    lat = torch.randn((1, 6, 16, 60, 104), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(7))
    flows, counts = [], []
    for m in (None, mesh):
        pipe = CausalFPSInferencePipeline(cfg, model, sampling_steps=1,
                                          mesh=m, dtype=torch.bfloat16)
        schedule = pipe.plan.groups[3]
        with torch.inference_mode():
            ctx_kv2 = pipe.prepare_context(cond, uncond)
            cache = init_kv_cache(pipe.cfg, 2, 60 * 104 // 4,
                                  KV_CACHE_SLOTS, torch.bfloat16, dev)
            attn.reset_launch_counts()
            flows.append(pipe._forward(schedule, ctx_kv2, cache, lat, 500.0,
                                       False).float())
        counts.append(attn.launch_counts["flash_fwd"])
    out = {"sharded_step_bit_equal": torch.equal(*flows),
           "sharded_step_flash_fwd": counts[1]}
    del model, flows
    torch.cuda.empty_cache()
    check(counts == [2 * cfg.num_layers] * 2, counts)
    return out


def _train_mesh_cli() -> dict:
    """`python -m mmpl_tpu_torch.train --smoke --steps 1 --mesh
    dp=1,fsdp=1` in this process, on the group already initialised: the
    CLI's wiring of the mesh (the tiny model FSDP-sharded, one
    teacher-forcing step); exact launches."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.config import tiny_test_config
    log_dir = os.path.join(OUT_DIR, "train_mesh")
    try:
        rc, seconds, counts, _ = _run_counted(lambda: train.main(
            ["--smoke", "--steps", "1", "--mesh", "dp=1,fsdp=1",
             "--log-dir", log_dir, "--run-name", "mesh"]))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    out = {"train_mesh_cli_rc": rc, "train_mesh_cli_s": seconds,
           "train_mesh_cli_launches": counts}
    check(rc == 0, out)
    check(counts == _train_launches(tiny_test_config().num_layers, 1),
          out)
    return counts


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole tensor; any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _train_mesh_step(mesh) -> dict:
    """One teacher-forcing step of the 1.3B model at full width and depth,
    the train phase's shapes (21 latents at 60x104, B=1, bf16 over fp32
    masters, AdamW), without a mesh and then with the model sharded over
    `mesh` by `shard_for_training` (FSDP2, DTensor parameters, as `train
    --mesh` shards it): the same weights, batch and draws.  The sharded
    step's loss, gradient norm, gradients and updated parameters against
    the unsharded step's (train_parity's tolerances), and each step's
    exact K1-K6 launches; then a second sharded step for its seconds.
    Returns the launches of the three steps."""
    from mmpl_tpu_torch.parallel.mesh import shard_for_training
    from mmpl_tpu_torch.training.diffusion import (
        DiffusionTrainer, draw_teacher_forcing, make_teacher_forcing_loss_fn)
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda", torch.cuda.current_device())
    expected = _train_launches(cfg.num_layers, 1)
    total = dict.fromkeys(expected, 0)
    norm = lambda gs: torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in gs])).item()
    for sharded in (False, True):
        model, sch, fm, batch, _ = _tf_setup(cfg, dev, torch.float32, 21,
                                             (60, 104))
        if sharded:
            shard_for_training(model, mesh)
        loss_fn = make_teacher_forcing_loss_fn(cfg, sch, fm,
                                               num_frame_per_block=3,
                                               noise_aug_max_timestep=100)
        trainer = DiffusionTrainer(model, loss_fn, learning_rate=1e-5)
        draws = draw_teacher_forcing(
            torch.Generator(device=dev).manual_seed(3),
            batch["latents"].shape, 3, len(sch.timesteps), 100, dev)
        loss, seconds, counts, peak = _run_counted(
            lambda: trainer.train_step(batch, draws))
        check(counts == expected, (sharded, counts, expected))
        total = {k: total[k] + counts[k] for k in total}
        named = list(model.named_parameters())
        if not sharded:
            # the unsharded step's gradients and updated parameters, kept
            # (no copy) while the sharded step runs
            one = {"loss": loss.item(), "seconds": seconds, "peak": peak,
                   "grads": {n: p.grad.detach() for n, p in named},
                   "params": {n: p.detach() for n, p in named}}
            del model, named, loss, trainer, loss_fn, batch, draws
            torch.cuda.empty_cache()
            continue
        kind = type(named[0][1]).__name__
        grad_err, param_err, equal, sq = {}, 0.0, True, []
        for n, p in named:
            g = _full(p.grad).detach()
            grad_err[n] = (g - one["grads"][n]).abs().max().item()
            equal = equal and torch.equal(g, one["grads"][n])
            sq.append(torch.linalg.vector_norm(g))
            param_err = max(param_err, (_full(p).detach()
                                        - one["params"][n]).abs().max()
                            .item())
        g_sh = torch.linalg.vector_norm(torch.stack(sq)).item()
        g_one = norm(one["grads"].values())
        worst = max(grad_err, key=grad_err.get)
        out = {"train_mesh_loss": loss.item(),
               "train_mesh_loss_single": one["loss"],
               "train_mesh_loss_rel_err": abs(loss.item() - one["loss"])
               / abs(one["loss"]),
               "train_mesh_grad_norm": g_sh,
               "train_mesh_grad_norm_single": g_one,
               "train_mesh_grad_norm_rel_err": abs(g_sh - g_one) / g_one,
               "train_mesh_grad_max_abs_err": grad_err[worst],
               "train_mesh_grad_max_abs_err_at": worst,
               "train_mesh_params_max_abs_err": param_err,
               "train_mesh_bit_equal": equal,
               "train_mesh_parameters": kind,
               "train_mesh_s": seconds, "train_mesh_single_s":
               one["seconds"], "train_mesh_peak_gib": peak,
               "train_mesh_single_peak_gib": one["peak"],
               "train_mesh_launches": total}
        del named, loss, sq
        # a second sharded step, past FSDP2's lazy set-up: its seconds
        _, out["train_mesh_second_s"], counts, _ = _run_counted(
            lambda: trainer.train_step(batch, draws))
        check(counts == expected, ("second", counts, expected))
        out["train_mesh_launches"] = {k: total[k] + counts[k] for k in total}
        del model, trainer, loss_fn, batch, draws
    del one
    torch.cuda.empty_cache()
    return out


def phase_mesh():
    """`init_distributed` on NCCL at world size 1 (a localhost rendezvous,
    an ephemeral port), `make_mesh`'s default fold and an sp x ring mesh,
    USP attention over the real process groups (of one rank each), and
    one group-3 forward of the 1.3B pipeline built over the default mesh
    (`_sharded_fps_step`), one 1.3B teacher-forcing step at full width and
    depth with the model FSDP-sharded over it against the same step
    without (`_train_mesh_step`), and the `train --mesh` CLI in smoke mode
    (`_train_mesh_cli`); the group is destroyed after."""
    import socket
    import torch.distributed as dist
    from mmpl_tpu_torch.parallel import mesh as mesh_mod
    from mmpl_tpu_torch.parallel import sequence_parallel as tsp
    from mmpl_tpu_torch.parallel.collectives import as_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ok = mesh_mod.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        init_s = time.perf_counter() - t0
        default = mesh_mod.make_mesh()
        m = as_mesh(mesh_mod.make_mesh({"sp": 1, "ring": 1}))
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v = (_rand(gen, torch.bfloat16, 2, 3120, 12, 128)
                   for _ in range(3))
        attn.reset_launch_counts()
        out = tsp.ulysses_attention(q, k, v, m.get_group("sp"),
                                    m.get_group("ring"))
        counts = dict(attn.launch_counts)
        want, _ = attn.flash_fwd_cuda(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        del q, k, v, out, want
        step = _sharded_fps_step(default)
        # the trainer's mesh is (dp, fsdp), as `train --mesh` builds it
        step.update(_train_mesh_step(mesh_mod.make_mesh({"dp": 1,
                                                         "fsdp": 1})))
        cli_counts = _train_mesh_cli()
        row = {"phase": "mesh", "initialised": ok, "init_s": init_s,
               "backend": dist.get_backend(),
               "world_size": dist.get_world_size(),
               "default_mesh": dict(zip(default.mesh_dim_names,
                                        default.mesh.shape)),
               "mesh": dict(zip(m.names, m.sizes)),
               "usp_attention_max_abs_err": err, "launches": counts,
               **step}
    finally:
        dist.destroy_process_group()
    emit(row)
    check(row["sharded_step_bit_equal"], row)
    # train_parity's tolerances: loss rtol 1e-5, gradients atol 1e-4; a
    # first AdamW step moves a parameter by about lr (1e-5) either way, so
    # two such steps end at most 2 lr apart
    check(row["train_mesh_parameters"] == "DTensor", row)
    check(row["train_mesh_loss_rel_err"] <= 1e-5, row)
    check(row["train_mesh_grad_norm_rel_err"] <= 1e-5, row)
    check(row["train_mesh_grad_max_abs_err"] <= 1e-4, row)
    check(row["train_mesh_params_max_abs_err"] <= 2e-5, row)
    check(ok and row["backend"] == "nccl" and row["world_size"] == 1, row)
    check(row["default_mesh"] == {"dp": 1, "fsdp": 1, "tp": 1}, row)
    check(err == 0.0 and counts == _k123(1), row)
    total = {k: v + cli_counts[k]
             for k, v in row["train_mesh_launches"].items()}
    total["flash_fwd"] += counts["flash_fwd"] + row["sharded_step_flash_fwd"]
    return total


def _entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
           bound_ms, bound_by, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def kernels_line(smi, rows, bwd, masked, int8, window_launches,
                 int8_launches, train_counts, exp2, exp2_launches,
                 path_launches, bwd_paths, int8_paths):
    """The nine kernels at their main-path shapes: K1 at group 3 of the
    serving window, K2 / K3 at the training cross-attention (and their
    other shapes under `shapes`), K4-K6 at the
    training self-attention, P2 at group 3's ffn.fc1, Q at group 3's
    ffn.fc2 input and P1 (its exp2 variant without the pad test) at the
    probe's shape.  `launches` sums the paths each runs on (the training
    kernels': the train phase's timed steps and train_resume's resumed
    step); `path_launches` holds K1's on the few-step, real-file CLI, i2v,
    resumed-training, whole-clip and CLIP paths, and on the distillation
    slice's paths (the causal-diffusion and bidirectional pipelines, the
    DPM window, the flow and distillation steps, the trainer's CLI);
    `bwd_paths` K2's and K3's on the flow and distillation paths, and
    `int8_paths` P2's and Q's on the int8 causal-diffusion run."""
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
        + train_counts["flash_fwd"] + sum(
            n for p, n in path_launches.items() if p != "train_resume"),
        max(r["o_max_abs_err"] for r in rows.values()), k1["ms"],
        k1["plain_ms"], k1["bound_ms"], k1["bound_by"], k1["library_ms"],
        at=MAIN_SHAPE, bodies=bodies, bound_share=k1["bound_share"],
        launches_by_path={
            "window": window_launches,
            "window_int8": int8_launches["flash_fwd"],
            "train": (train_counts["flash_fwd"]
                      - path_launches.get("train_resume", 0)),
            **path_launches},
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
            train_counts[name] + sum(c[name] for c in bwd_paths.values()),
            grad_err(bwd, ("dk", "dv") if part == "dkv" else ("dq",)),
            b[f"{part}_ms"], b["plain_ms"], b[f"{part}_bound_ms"],
            b[f"{part}_bound_by"], b.get("library_bwd_ms"), at=BWD_MAIN,
            sources=[bwd_sm90_src, bwd_src], bodies=bwd_bodies,
            bound_share=b[f"{part}_bound_share"], note=bwd_note,
            launches_by_path={"train": train_counts[name],
                              **{p: c[name] for p, c in bwd_paths.items()}},
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
        int8_launches["int8_gemm"]
        + sum(c["int8_gemm"] for c in int8_paths.values()),
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
        int8_launches["quantize_rows"]
        + sum(c["quantize_rows"] for c in int8_paths.values()),
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
    path_launches = {"fewstep": sum(r["flash_fwd_launches"]
                                    for r in fewstep_rows),
                     "fewstep_rolling": rolling_k1}
    # real inputs: umT5 at full width, files in the upstream layouts, the
    # CLI's non-smoke path on them, the i2v windows
    t5_shallow = phase_t5()
    pt, wan = phase_ckpt(t5_shallow)
    del t5_shallow
    try:
        path_launches["cli_real"] = phase_cli_real(pt, wan)
    finally:
        shutil.rmtree(os.path.dirname(pt), ignore_errors=True)
    path_launches["window_i2v"] = phase_window_i2v()
    phase_window_i2v_parity()
    # checkpoints and resume; the whole-clip pipelines; the CLIP towers
    resume_counts = phase_train_resume()
    path_launches["train_resume"] = resume_counts["flash_fwd"]
    train_counts = {k: train_counts[k] + resume_counts[k]
                    for k in train_counts}
    path_launches["wan_t2v"] = phase_wan_t2v()
    path_launches["wan_i2v"] = phase_wan_i2v()
    path_launches["clip_text"] = phase_clip_text()
    phase_wan_parity()
    # distillation, the flow objective and the baseline pipelines: the
    # bf16 pipelines share one 1.3B model (the int8 run quantises it last)
    dev = torch.device("cuda")
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    model = dit.randomize_head(dit.init_dit_params(
        WAN_CONFIGS["t2v-1.3B"], g(40), torch.bfloat16, dev), g(139))
    cond, uncond = cli.random_text_context(WAN_CONFIGS["t2v-1.3B"], dev)
    path_launches["causal_diffusion"] = phase_causal_diffusion(
        model, cond, uncond)[0]["flash_fwd"]
    path_launches["bidirectional"] = phase_bidirectional(
        model, cond, uncond)["flash_fwd"]
    path_launches["window_dpm"] = phase_window_dpm(
        model, cond, uncond)["flash_fwd"]
    counts, int8_cd = phase_causal_diffusion(model, cond, uncond,
                                             quantize="auto")
    path_launches["causal_diffusion_int8"] = counts["flash_fwd"]
    del model, cond, uncond
    torch.cuda.empty_cache()
    bwd_paths = {}
    bwd_paths["train_flow"], _ = phase_train_flow()
    torch.cuda.empty_cache()
    bwd_paths["distill_dmd"] = phase_distill_dmd()
    torch.cuda.empty_cache()
    bwd_paths["distill_other"] = phase_distill_other()
    torch.cuda.empty_cache()
    bwd_paths["distill_rolling"] = phase_distill_rolling()
    torch.cuda.empty_cache()
    bwd_paths["train_distill_cli"] = phase_train_distill_cli()
    phase_distill_parity()
    # multi-device and serving: stages as streams of this card, the
    # in-process group for the ring and USP, NCCL at world size 1
    path_launches["chunk_pipeline"] = phase_chunk_pipeline()
    path_launches["generate_parallel"] = phase_generate_parallel()
    path_launches["serving"] = phase_serving()
    bwd_paths["ring"] = phase_ring()
    path_launches["usp"] = phase_usp()
    bwd_paths["mesh"] = phase_mesh()
    for p, c in bwd_paths.items():
        path_launches[p] = c["flash_fwd"]
    # the masked kernels' rows count training steps: train --mesh's too
    train_counts = {k: v + (bwd_paths["mesh"][k] if "masked" in k else 0)
                    for k, v in train_counts.items()}
    emit(kernels_line(smi, rows, bwd, masked, int8, window_launches,
                      int8_launches, train_counts, exp2, exp2_launches,
                      path_launches, bwd_paths,
                      {"causal_diffusion_int8": int8_cd}))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
