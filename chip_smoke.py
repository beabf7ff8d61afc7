"""Drive the PyTorch/CUDA port (mmpl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines as it goes (any failure exits non-zero):
  1. device and build: the card's name and power limit; nvcc builds every
     kernel from mmpl_tpu_torch/csrc;
  2. kernel: K1 (csrc/flash_fwd.cu: bf16 / fp16 on the wgmma + TMA body of
     csrc/flash_fwd_sm90.cuh under the schedule ops/attention.fwd_schedule
     picks, a block per 128-query block, the persistent walk or the key
     split and its merge of csrc/flash_fwd_sched_sm90.cuh; fp32 on the
     split-TF32 wgmma body of csrc/flash_fwd_f32_sm90.cuh) against its plain
     PyTorch version at the 1.3B main path's attention shapes and the fp32
     trunk's (the trainer's ODE and distillation objectives), with the
     body and the schedule that ran (read from the profiler's kernel names),
     kernel / plain / SDPA times (a call after a synchronise, the
     wrapper's host time included) and device times (queued), and the
     card's bound; kernel_exp2: P1
     (csrc/flash_fwd.cu, the exp2 probe's forward, on K1's two bodies:
     fp32 on the split-TF32 one), its four variants against
     the plain version at the probe's
     shape, the few-step path's steady-state self-attention (4680 x 32760,
     where only the variants with the pad test are defined), a ragged
     shape, fp32 at D = 24 and fp32 at K1's ode_self_1 shape (4680^2),
     beside K1 and SDPA;
  3. kernel_bwd: K2 / K3 (csrc/flash_bwd.cu: bf16 / fp16 on the wgmma +
     TMA body of csrc/flash_bwd_sm90.cuh, with K2's query split and reduce
     where it splits; fp32 K2 on the split-TF32 wgmma body of
     csrc/flash_bwd_f32_sm90.cuh, fp32 K3 on the split-TF32 wgmma body of
     csrc/flash_bwd_dq_f32_sm90.cuh) at the
     training cross-attention shape in bf16 and fp16, the few-step
     steady-state self-attention shape, a ragged shape, D = 24 and the
     fp32 trunk's shapes, against the plain backward and SDPA's backward
     (memory-efficient backend in fp32), with the body that ran and the
     split; then the whole backward in one call under `bwd_schedule`'s
     schedule (the grid, K3's persistent walk, or the fused or ordered
     walk of csrc/flash_bwd_sched_sm90.cuh, each walk also held against
     its plain version), the schedule that ran and a second call bit for
     bit;
  4. kernel_masked: K4 / K5 / K6 under the fps-forcing mask at the 1.3B
     teacher-forcing self-attention shape (42 frames x 1560 tokens; in
     bf16, and in fp32 without SDPA), and ragged shapes with a frame that sees nothing (bf16, fp16, D = 24,
     fp32) and with whole blocks that see or are seen by nothing, against
     the plain versions and SDPA (memory-efficient backend) with the token
     mask; bf16 / fp16 K4, K5 and K6 run the masked instantiations of K1's,
     K2's and K3's Hopper bodies over the coarse tile tables (their
     admitted and partial shares reported); fp32 K5 and K6 run the masked
     kernels of fp32 K2's and K3's split-TF32 bodies over the 64 x 64
     table, fp32 K4 the masked kernel of fp32 K1's;
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
     one DMD critic and one generator step at DMD_LAYERS depth
     (configs/self_forcing_dmd.yaml's steps; the drawn exit flag printed
     and the launches checked against it; peak memory; distill_profile, a
     generator step under torch.profiler); offload, on distill_dmd's
     bundle: a DMD critic and generator step with `--offload-opt
     --remat-offload`'s pieces (HostAdamW, the host EMA, block inputs on
     the host), the same steps resident from the same state, bit for bit
     (losses, parameters, moments, EMA), the two offloaded steps again
     warm, each step's peak and seconds; the pinned copy rates and one
     offloaded 1.3B AdamW update; `offload_params` / `restore_params` of
     the DiT; one 1.3B teacher-forcing step resident and with
     `remat_offload`, bit for bit, K4-K6 exact; both flags through `train
     --smoke`; distill_other,
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
     width and 10 layers (MESH_LAYERS) FSDP-sharded over the mesh against
     the same step unsharded, one `train --mesh` CLI step in smoke mode, and mesh_ckpt:
     2-layer teacher forcing on the data shards under `--mesh
     dp=1,fsdp=1`, saved sharded and resumed, bit for bit;
  18. the training data path (run after cli_real, on the ckpt phase's
     files): data, three .npy clips of 720x1280 (two of 81+ frames, one
     too short) through `python -m mmpl_tpu_torch.data.video_dataset
     --use_native` at 480x832 and 81 frames, the resample and the VAE's
     `encode_streaming` on the card (resample ms and its distance from the
     CPU, encode seconds and peak per clip, the shard); ode_gen,
     `data/ode_gen.record_trajectories` of the 1.3B teacher at full depth
     in bf16 over the CFG pair, 4 steps, exact K1, the shard with
     `prompt_embeds`; train_data, `train --data-dir` on those shards:
     teacher forcing at full width and depth (exact K1-K6, step and load
     seconds), flow and ODE at 2 layers; train_data_resume, 2-layer
     teacher forcing on the shards resumed from step 1 of 3, bit for bit;
  19. what the mesh refused until now, two ranks spawned on this one
     card over gloo (NCCL takes no two ranks on a device; gloo carries
     the anchors' point-to-point move through host memory): kernel_q_modes
     (run beside kernel_int8), Q's amax and given-scale modes at the tp-2
     shapes (18720 x 4480, 18720 x 768), exactly against their plain
     versions, with device times and bounds; mesh_int8, tp 2 at the 1.3B
     width cut to TP_LAYERS layers, a group-2 solver forward and its
     commit in W8A8 with the int8 cache against the same forwards
     unsharded (the fc2 input's summed int32 accumulators, codes and
     scales and the cache's codes and scales bit for bit, the flow within
     quant_parity's int8 window gate and no farther than tp moves the
     bf16 forward, exact Q / P2 / K1 launches); mesh_tp_train, tp-2
     teacher-forcing steps at 65,520 tokens and TP_LAYERS layers against
     the unsharded steps, the trunk in fp32 (train_mesh's tolerances) and
     in bf16 (within bf16's own distance from fp32), K4-K6 at 6 heads,
     exact launches, and `train --smoke --mesh tp=2`;
     stage_meshes, `ChunkParallelPipeline(stage_meshes=...)` over two
     processes of a stage each, the 1.3B window model at full width and
     depth, 4 steps, 3 chunks, bit for bit against chunk_pipeline's
     one-process run, with each chunk's start against the previous one's
     end on the host clock; generate_parallel_ranks, the entry over 2
     processes in smoke mode writing the files one process writes;
  20. the kernels line, then the final device line.
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
                                            FUSED_BWD, device_kernels,
                                            port_kernel_of, queued_ms)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores; fp32 at
#: the TF32 tensor-core rate, the rate the fp32 bodies run their
#: split-TF32 products at (three passes a product: they reach at most a
#: third of it; 67e12, the FMA rate, would put a tensor-core body above
#: 100% of its bound); HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 495e12}
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
#: register token (one query row over 32760 keys); in fp32, the trainer's
#: ODE and distillation trunk (F32_SHAPES) and a ragged shape
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
    ("ragged_f32", 2, 12, 128, 1000, 1300, torch.float32),
]
#: the fp32 trunk of the trainer's ODE regression and distillation
#: objectives (1.3B width, 21 latent frames at 60x104 in blocks of 3): a
#: block's 4680 queries over 1, 4 and 7 blocks of keys, the critic's and
#: real score's 32760^2, the text cross-attention and the GAN head's
#: register token (the trainer builds the GAN objective in fp32); K1-K3
#: run them in fp32 (mmpl_tpu_torch/tools/flash_compare.py F32_SHAPES)
F32_SHAPES = [
    ("ode_self_1", 1, 12, 128, 4680, 4680, torch.float32),
    ("ode_self_4", 1, 12, 128, 4680, 18720, torch.float32),
    ("ode_self_7", 1, 12, 128, 4680, 32760, torch.float32),
    ("critic_self_f32", 1, 12, 128, 32760, 32760, torch.float32),
    ("ode_cross", 1, 12, 128, 4680, 512, torch.float32),
    ("gan_head_q1_f32", 2, 12, 128, 1, 32760, torch.float32),
]
K1_SHAPES += F32_SHAPES
MAIN_SHAPE = "group3_self"

#: P1 shapes, as K1_SHAPES: the JAX probe's shape, the few-step path's
#: steady-state self-attention (Lk ragged for the 64-key tile), a ragged
#: Lq with a tile-multiple Lk, a ragged Lk, fp32 at the tiny head dim and
#: fp32 at K1's ode_self_1 shape (F32_SHAPES)
EXP2_SHAPES = [
    ("probe", 2, 12, 128, 11264, 14336, torch.bfloat16),
    ("fewstep_hot", 1, 12, 128, 4680, 32760, torch.bfloat16),
    ("ragged_lq", 2, 12, 128, 1000, 1280, torch.bfloat16),
    ("ragged_lk", 2, 12, 128, 1000, 1300, torch.bfloat16),
    ("d24_f32", 2, 4, 24, 130, 192, torch.float32),
    ("ode_self_1", 1, 12, 128, 4680, 4680, torch.float32),
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
#: head dim in bf16 and fp32 (and a ragged shape and F32_SHAPES in fp32);
#: the distillation slice's: the critic's and
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
    ("ragged_f32", 2, 12, 128, 1000, 1300, torch.float32),
] + F32_SHAPES
BWD_MAIN = "tf_cross"

#: K4-K6 shapes: (label, B, N, D, mask, tokens per frame, dtype).  "fps" is
#: the fps-forcing mask of T2V_CLEAN_STEPS over [clean | noisy] 2 x 21
#: frames of 1560 tokens (L = 65520, the 1.3B teacher-forcing step);
#: "blind" is L = 1000 in frames of 130 under a block-causal mask where
#: frame 1 sees nothing; "dead" is L = 1000 in frames of 300 where frame 1
#: sees nothing and frame 2 is seen by nothing (a 128-query block with no
#: admitted key tile, 128-key blocks with no admitted query tile); both
#: also in fp32 at D = 128 (the masked kernels of the split-TF32 bodies);
#: "late" (fp32 only) is L = 1550 in frames of 100 where even frames see
#: the frames up to their own, odd frames only frames 11-15 and frame 7
#: nothing, so fp32 K4's rows walk up to 49 key tiles, some see their
#: first key after two folds and blind rows pass a fold.  tf_self_f32 is
#: tf_self in fp32, the shape mesh_tp_train's unsharded fp32 step gives
#: fp32 K4-K6 (rows walking hundreds of tiles and many folds), without
#: the SDPA yardstick (MASKED_NO_LIBRARY).  tf_self runs last: after its
#: SDPA yardstick (a 4.3 GB token mask) the short profiler sessions that
#: read the body lost every device record
MASKED_SHAPES = [
    ("ragged_blind", 2, 12, 128, "blind", 130, torch.bfloat16),
    ("ragged_blind_f16", 2, 12, 128, "blind", 130, torch.float16),
    ("dead_blocks", 2, 12, 128, "dead", 300, torch.bfloat16),
    ("d24_bf16_blind", 2, 4, 24, "blind", 130, torch.bfloat16),
    ("d24_f32_blind", 2, 4, 24, "blind", 130, torch.float32),
    ("ragged_blind_f32", 2, 12, 128, "blind", 130, torch.float32),
    ("dead_blocks_f32", 2, 12, 128, "dead", 300, torch.float32),
    ("late_fold_f32", 2, 12, 128, "late", 100, torch.float32),
    ("tf_self_f32", 1, 12, 128, "fps", 1560, torch.float32),
    ("tf_self", 1, 12, 128, "fps", 1560, torch.bfloat16),
]
MASKED_MAIN = "tf_self"
#: rows whose SDPA yardstick is left out: its token mask would come before
#: tf_self's body read (tools/flash_compare.py --kernel masked --dtype
#: float32 times SDPA at this shape)
MASKED_NO_LIBRARY = ("tf_self_f32",)

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
    # tp 2: fc1's rows of a rank (column-parallel, a scaled output), fc2's
    # and o's input columns of a rank (row-parallel: the int32
    # accumulator, summed over tp outside the kernel)
    ("g23_fc1_tp2", 18720, 1536, 4480, torch.bfloat16, torch.bfloat16),
    ("g23_fc2_tp2", 18720, 4480, 1536, torch.bfloat16, torch.int32),
    ("g23_o_tp2", 18720, 768, 1536, torch.bfloat16, torch.int32),
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

#: K1's launches by schedule (`attn.fwd_mode_launches`) on the paths that
#: record them: the serving window, the GAN steps
FWD_MODES_BY_PATH = {}
#: K3's launches by schedule (`attn.bwd_mode_launches`; a fused or ordered
#: launch is K2's too) on the paths that record them: the teacher-forcing
#: steps (the cross-attention on K3's persistent walk), the GAN steps (the
#: register token's backward fused), the flow and DMD steps and the ring
#: (the self-attention's backward ordered)
BWD_MODES_BY_PATH = {}


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
    """Median of CUDA-event timings after warm-up: at least 3 calls once
    they pass `budget_ms` together, one where a single call does (the
    plain versions at the largest shapes take seconds a call)."""
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
        if sum(times) > budget_ms and (len(times) >= 3 or times[0] > budget_ms):
            break
    return statistics.median(times)


def roofline(flops, nbytes, dtype):
    """(least ms on the card, what bounds it) for this work."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_work(kind, B, N, D, Lq, Lk, dtype, share=1.0, mask_bytes=0):
    """(FLOPs, bytes) of one attention kernel: "fwd" (S, PV: 4 flops per
    q-k-d triple), "dkv" (S, dP, dV, dK: 8), "dq" (S, dP, dQ: 6) or the
    whole backward, "bwd" (S, dP, dV, dK, dQ once each: 10), times
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
        # both: S, dP, dV, dK, dQ once each
        "bwd": (10, 3, 4, 2),   # q, dO, dq | k, v, dk, dv | lse, delta in
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


#: the second kernel of a launch that splits its work: K2's reduce, K1's
#: merge
_FOLDS = ("_reduce_kernel", "_merge_kernel")


def _main_kernels(names, counter: str) -> list:
    return [n for n in names if port_kernel_of(n) == counter
            and not any(f in n for f in _FOLDS)]


def _body(names, counter: str, dtype) -> str:
    """Which body ran `counter`'s launch among `names`: "wgmma" (the
    `*_sm90_kernel` of csrc/flash_fwd_sm90.cuh or csrc/flash_bwd_sm90.cuh,
    K1's also under its schedules of csrc/flash_fwd_sched_sm90.cuh, with
    K2's reduce kernel when the call split the queries and K1's merge when
    it split the keys) or "tf32x3" (the split-TF32 `*_f32_sm90_kernel` of
    csrc/flash_fwd_f32_sm90.cuh, csrc/flash_bwd_f32_sm90.cuh or
    csrc/flash_bwd_dq_f32_sm90.cuh, one kernel).  bf16 / fp16 K1-K6 and P1
    must run the first, fp32 the second."""
    mine = [n for n in names if port_kernel_of(n) == counter]
    main = _main_kernels(names, counter)
    check(len(main) == 1 and len(mine) - len(main) <= 1, (counter, names))
    check("_sm90_kernel" in main[0], (counter, names))
    body = "tf32x3" if "_f32_sm90_kernel" in main[0] else "wgmma"
    want = "wgmma" if dtype in (torch.bfloat16, torch.float16) else "tf32x3"
    check(body == want and (body == "wgmma" or len(mine) == 1),
          (counter, dtype, mine))
    return body


def _bwd_schedule_of(names) -> str:
    """The schedule a whole backward call ran among `names`: "fused" (the
    fused walk and its dQ reduce, booked to both K2 and K3, and no other
    K2 / K3 kernel) or "ordered" (the ordered walk and its dQ out kernel,
    the same way), else K3's kernel: its persistent walk or the grid."""
    fused = [n for n in names if port_kernel_of(n) == FUSED_BWD]
    if fused:
        ordered = [n for n in fused if "flash_bwd_ordered_" in n]
        check(len(fused) == 2 and not _main_kernels(names, "flash_bwd_dq")
              and not _main_kernels(names, "flash_bwd_dkv"), names)
        if ordered:
            check(len(ordered) == 2
                  and any("_out_kernel" in n for n in ordered), names)
            return "ordered"
        check(any("_reduce_kernel" in n for n in fused), names)
        return "fused"
    main = _main_kernels(names, "flash_bwd_dq")
    check(len(main) == 1, names)
    return ("persistent" if "flash_bwd_dq_persistent_sm90_kernel" in main[0]
            else "grid")


def _fwd_schedule_of(names) -> str:
    """The schedule K1's launch ran among `names` (its kernel's name)."""
    main = _main_kernels(names, "flash_fwd")
    check(len(main) == 1, names)
    return next((m for m in ("persistent", "split")
                 if f"flash_fwd_{m}_sm90_kernel" in main[0]), "grid")


def phase_kernel():
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        mode, splits = (("grid", 1) if dtype == torch.float32
                        else attn.fwd_schedule(B, N, Lq, Lk, D, sms))
        row = {"phase": "kernel", "kernel": "flash_fwd", "shape": label,
               "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "dtype": str(dtype).replace("torch.", ""),
               "body": _body(names, "flash_fwd", dtype), "mode": mode,
               "splits": splits, "mode_ran": _fwd_schedule_of(names),
               "o_max_abs_err": err.max().item(),
               "o_mean_abs_err": err.mean().item(),
               "lse_max_abs_err": lerr.max().item(),
               "lse_mean_abs_err": lerr.mean().item()}
        del po, plse, err, lerr, o, lse
        budget = BUDGET_MS[dtype]
        row["ms"] = time_ms(lambda: attn.flash_fwd_cuda(q, k, v),
                            budget_ms=budget)
        row["plain_ms"] = time_ms(lambda: attn.flash_attention_plain(q, k, v),
                                  max_reps=PLAIN_REPS[dtype])
        row["bound_ms"], row["bound_by"] = bound(B, N, D, Lq, Lk, dtype)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        # device times: calls queued behind a spin, no host time between
        reps = QUEUED_REPS if row["ms"] < 5.0 else 3
        with _sdpa_backend(dtype):
            row["library_ms"] = time_ms(sdpa, budget_ms=budget)
            row["library_device_ms"] = queued_ms(sdpa, reps)
        row["device_ms"] = queued_ms(lambda: attn.flash_fwd_cuda(q, k, v),
                                     reps)
        row["tflops"] = 4.0 * B * N * Lq * Lk * D / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(row)
        rows[label] = row
        check(row["mode_ran"] == mode, row)
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


#: calls that a device time (`queued_ms`) of a K1 row queues (3 where a
#: call takes 5 ms or more)
QUEUED_REPS = 10

#: timed calls of the plain versions at most, and the ms that a kernel's
#: or SDPA's timing may take before it stops at 3 calls or more (fp32 at
#: 32760^2 takes 0.15-0.7 s a call: the whole script has a time limit)
PLAIN_REPS = {torch.bfloat16: 5, torch.float16: 5, torch.float32: 1}
BUDGET_MS = {torch.bfloat16: 3000.0, torch.float16: 3000.0, torch.float32: 1000.0}


def _sdpa_backend(dtype, masked: bool = False):
    """SDPA's yardstick backend: memory-efficient for fp32 (the one that
    takes it) and under a token mask, else SDPA's own choice."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return (sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])
            if masked or dtype == torch.float32 else contextlib.nullcontext())


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


def _library_times(row, q, k, v, do, attn_mask=None, device_reps=0):
    """SDPA on the same inputs as the yardstick: forward, backward alone
    (torch.autograd.grad over a kept graph: dq, dk and dv in one call; with
    `device_reps`, also its device time over that many queued calls) and
    forward + backward.  With `attn_mask` (the token-level bool mask) or
    fp32 inputs under the memory-efficient backend, the one that takes a
    mask with a backward, and fp32.  Where SDPA refuses the inputs the row
    says why."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = _sdpa_backend(q.dtype, attn_mask is not None)
    budget = BUDGET_MS[q.dtype]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    try:
        with backend:
            fwd = lambda: sdpa(qt, kt, vt, attn_mask=attn_mask)
            row["library_fwd_ms"] = time_ms(lambda: fwd().detach(),
                                            budget_ms=budget)
            out = fwd()
            grad = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True)
            row["library_bwd_ms"] = time_ms(grad, budget_ms=budget)
            if device_reps:
                row["library_bwd_device_ms"] = queued_ms(grad, device_reps)
            del out
            row["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                fwd(), (qt, kt, vt), dot), budget_ms=budget)
    except RuntimeError as exc:   # the yardstick only; no kernel of the port
        row["library_error"] = str(exc).splitlines()[0][:200]
    torch.cuda.empty_cache()


def phase_kernel_bwd():
    """K2 (dK, dV) and K3 (dQ) against the plain backward, with the body
    that ran each (from the profiler's kernel names) and K2's query
    split; then the whole backward (`flash_bwd_cuda`, one call) under
    `bwd_schedule`'s mode, the mode that ran (from the profiler), its
    gradients against the plain backward (the fused and ordered walks' also
    against their plain versions), whether a second call gives the same
    bits (`repeat_equal`) and its time beside SDPA's backward, by wall and
    device time."""
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
        mode = ("grid" if dtype == torch.float32
                else attn.bwd_schedule(B, N, Lq, Lk, D, sms))
        row = {"phase": "kernel_bwd", "kernel": "flash_bwd_dkv+flash_bwd_dq",
               "shape": label, "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "dtype": str(dtype).replace("torch.", ""),
               "dkv_body": _body(names, "flash_bwd_dkv", dtype),
               "dq_body": _body(names, "flash_bwd_dq", dtype),
               "splits": splits, "reduce_ran": reduced, "mode": mode}
        check(reduced == (splits > 1), row)
        _grad_errors(row, (dq, dk, dv), want, dtype)
        # the whole backward, one call, under its schedule (fp32 has one,
        # the parts' bodies above: no second profiler session)
        if dtype == torch.float32:
            out["bwd"] = attn.flash_bwd_cuda(q, k, v, do, lse, delta)
        else:
            names = _launched(lambda: out.update(
                bwd=attn.flash_bwd_cuda(q, k, v, do, lse, delta)))
            row["mode_ran"] = _bwd_schedule_of(names)
            check(row["mode_ran"] == mode, row)
        whole = {"shape": label}
        _grad_errors(whole, out["bwd"], want, dtype)
        row.update({f"bwd_{k_}": x for k_, x in whole.items()
                    if k_ != "shape"})
        plain_of = {"fused": attn.flash_attention_bwd_fused_plain,
                    "ordered": attn.flash_attention_bwd_ordered_plain}
        if mode in plain_of:
            walk = {"shape": label}
            _grad_errors(walk, out["bwd"],
                         plain_of[mode](q, k, v, do, lse, delta), dtype)
            row.update({f"{mode}_plain_{k_}": x for k_, x in walk.items()
                        if k_ != "shape"})
        # the whole backward gives the same bits on every call (the
        # split's, the fused walk's and the ordered walk's sums run in a
        # fixed order)
        again = attn.flash_bwd_cuda(q, k, v, do, lse, delta)
        row["repeat_equal"] = all(torch.equal(a, b)
                                  for a, b in zip(again, out["bwd"]))
        check(row["repeat_equal"], row)
        del dq, dk, dv, want, out, again
        budget = BUDGET_MS[dtype]
        whole_call = lambda: attn.flash_bwd_cuda(q, k, v, do, lse, delta)
        row["bwd_ms"] = time_ms(whole_call, budget_ms=budget)
        row["dkv_ms"] = time_ms(
            lambda: attn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
            budget_ms=budget)
        row["dq_ms"] = time_ms(
            lambda: attn.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
            budget_ms=budget)
        row["plain_ms"] = time_ms(lambda: attn.flash_attention_bwd_plain(
            q, k, v, do, lse, delta), max_reps=PLAIN_REPS[dtype])
        for part in ("dkv", "dq", "bwd"):
            work = attention_work(part, B, N, D, Lq, Lk, dtype)
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = roofline(
                *work, dtype)
            row[f"{part}_tflops"] = work[0] / row[f"{part}_ms"] / 1e9
            row[f"{part}_bound_share"] = (row[f"{part}_bound_ms"]
                                          / row[f"{part}_ms"])
        # device times: calls queued behind a spin, no host time between
        # (one call where a call takes 50 ms or more: the host's share is
        # nothing there)
        reps = (QUEUED_REPS if row["bwd_ms"] < 5.0
                else 3 if row["bwd_ms"] < 50.0 else 1)
        row["bwd_device_ms"] = queued_ms(whole_call, reps)
        _library_times(row, q, k, v, do, device_reps=reps)
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
    elif kind == "late":
        f = np.arange(16)
        fm = np.where((f % 2 == 0)[:, None], f[None, :] <= f[:, None],
                      f[None, :] >= 11)
        fm[7] = False
        ids = np.repeat(f, S)[:1550]
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
        if label not in MASKED_NO_LIBRARY:
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
            if out == torch.int32:
                return torch._int_mm(xq, wq.t())
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
    modes = dict(attn.fwd_mode_launches)
    expected = 2 * pipe.cfg.num_layers * _window_forwards(steps)
    for row in rows:
        emit(row)
    emit({"phase": "window_total", "flash_fwd_launches": launches,
          "expected_launches": expected, "flash_fwd_modes": modes,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30})
    check(launches == expected, (launches, expected))
    # the text cross-attention (half of the launches) on the persistent
    # walk, the long self-attention on the grid, nothing split
    check(sum(modes.values()) == launches and modes["split"] == 0
          and modes["persistent"] >= launches // 2 and modes["grid"] > 0,
          modes)
    FWD_MODES_BY_PATH["window"] = modes
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
    book to K1-K6 (K2 and K3's fused walk to both), P1, P2 or Q, never to
    nothing; and a masked Hopper
    kernel to K4, K5 or K6 alone."""
    by_port = {}
    for e in kernels:
        name = port_kernel_of(e.key)
        if "_sm90_kernel" in e.key or "_reduce_kernel" in e.key:
            check(name in ("flash_fwd", "flash_masked_fwd", "flash_exp2",
                           "flash_bwd_dkv", "flash_masked_bwd_dkv",
                           "flash_bwd_dq", "flash_masked_bwd_dq", FUSED_BWD,
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
    bwd_modes = dict(attn.bwd_mode_launches)
    expected = _train_launches(cfg.num_layers, timed_steps)
    moved = max((ema.shadow[n] - p.detach()).abs().max().item()
                for n, p in model.named_parameters())
    # the unmasked backward is the cross-attention's (65520 queries over
    # 512 text tokens): K3 on its persistent walk
    want_modes = {**dict.fromkeys(bwd_modes, 0),
                  "persistent": expected["flash_bwd_dq"]}
    BWD_MODES_BY_PATH["train"] = bwd_modes
    emit({"phase": "train_total", "launches": counts,
          "expected_launches": expected, "flash_bwd_modes": bwd_modes,
          "seconds_per_step": statistics.mean(r["seconds"] for r in steps),
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30,
          "ema_minus_params_max_abs": moved})
    check(counts == expected, (counts, expected))
    check(bwd_modes == want_modes, (bwd_modes, want_modes))
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

#: the depth of the full-depth flow phase and the ODE teacher (the memory
#: reckoning of three 1.3B models, two AdamW states and the EMA fits the
#: 80 GB card at 30 layers) and of the phases cut to 2 layers
DISTILL_LAYERS = 30
#: distill_dmd's and the offload phase's depth: the DMD bundle cut to 8 of
#: its 30 layers, for the script's time limit (PERF.md holds both phases'
#: numbers at 30 and 15 layers, distill_dmd's 40.24 GiB among them)
DMD_LAYERS = 8
#: distill_profile's depth (its session's cost grows with the launches)
PROFILE_LAYERS = 3
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

    rows, modes = [], {}
    for i in range(timed_steps + 1):
        loss, seconds, counts, peak = _run_counted(step)
        bwd_modes = dict(attn.bwd_mode_launches)
        row = {"phase": "train_flow", "step": i, "warmup": i == 0,
               "layers": cfg.num_layers, "seconds": seconds, "loss": loss,
               "grad_norm": trainer.grad_norm.item(), "launches": counts,
               "expected_launches": _k123(4 * cfg.num_layers,
                                          2 * cfg.num_layers),
               "flash_bwd_modes": bwd_modes,
               "max_memory_allocated_gib": peak}
        emit(row)
        check(counts == row["expected_launches"], row)
        # the self-attention's backward (32760^2) on the ordered walk, the
        # text cross-attention's (512 keys) on K3's persistent walk
        check(bwd_modes == {**dict.fromkeys(bwd_modes, 0),
                            "ordered": cfg.num_layers,
                            "persistent": cfg.num_layers}, row)
        if i:
            modes = {k: modes.get(k, 0) + n for k, n in bwd_modes.items()}
        check(math.isfinite(loss) and math.isfinite(row["grad_norm"])
              and row["grad_norm"] > 0, row)
        rows.append(row)
    timed = rows[1:]
    BWD_MODES_BY_PATH["train_flow"] = modes
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
    DMD_LAYERS depth, 21 frames at 60x104, the rollout and the
    Distiller in bf16 over fp32 masters (configs/self_forcing_dmd.yaml's
    warped steps, shift 5.0, guidance 3.0), AdamW.  The exit flag is
    drawn once for all blocks (same_step_across_blocks), so the launches
    are checked against the flag's formula.  distill_profile: a generator
    step of the same bundle cut to PROFILE_LAYERS, under the profiler.
    Returns the launches and the bundle, which the offload phase goes on
    with."""
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    bundle = _distill_setup(DMD_LAYERS)
    cfg, models, ro, sch, dcfg, batch, gen = bundle
    dist = Distiller(cfg, DistillationConfig(**dcfg), ro, sch)
    L, nb = cfg.num_layers, DISTILL_BLOCKS
    n_params = sum(p.numel() for m in models.values()
                   for p in m.parameters())
    out, total, modes = [], {}, {}
    for role, keys, fn in (("critic", ("fake_score",), dist.critic_loss),
                           ("generator", ("generator",),
                            dist.dmd_generator_loss)):
        (loss, flags), seconds, counts, peak = _run_counted(
            lambda: _distill_step(models, keys, fn, batch, ro, gen, nb))
        bwd_modes = dict(attn.bwd_mode_launches)
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
               "expected_launches": expected, "flash_bwd_modes": bwd_modes,
               "max_memory_allocated_gib": peak}
        emit(row)
        check(counts == expected, row)
        # each layer's self-attention backward (a block's queries over
        # 4680 k keys, the score's 32760^2) on the ordered walk, its text
        # cross-attention's on K3's persistent walk
        check(bwd_modes == {**dict.fromkeys(bwd_modes, 0),
                            "ordered": counts["flash_bwd_dq"] // 2,
                            "persistent": counts["flash_bwd_dq"] // 2}, row)
        modes = {k: modes.get(k, 0) + n for k, n in bwd_modes.items()}
        check(math.isfinite(loss), row)
        out.append(row)
        total = {k: total.get(k, 0) + counts[k] for k in counts}
    grads_finite = all(torch.isfinite(p).all().item()
                       for m in models.values() for p in m.parameters())
    # the profile at PROFILE_LAYERS: a session over the ~70,000 launches of
    # a 30-layer generator step took 120-141 s of the run on the H100
    del dist
    torch.cuda.empty_cache()
    pcfg, pmodels, pro, psch, pdcfg, pbatch, pgen = _distill_setup(
        PROFILE_LAYERS)
    pdist = Distiller(pcfg, DistillationConfig(**pdcfg), pro, psch)
    phase_train_profile(
        lambda: _distill_step(pmodels, ("generator",),
                              pdist.dmd_generator_loss, pbatch, pro, pgen,
                              nb),
        phase="distill_profile",
        what=f"one DMD generator step, 1.3B width, {PROFILE_LAYERS} "
             f"layers, bf16 over fp32 masters",
        checked=("flash_bwd_dkv", "flash_bwd_dq"))
    emit({"phase": "distill_dmd_total", "layers": L,
          "seconds_per_step": {r["step"]: r["seconds"] for r in out},
          "max_memory_allocated_gib": max(r["max_memory_allocated_gib"]
                                          for r in out),
          "params_finite_after": grads_finite, "launches": total})
    check(grads_finite, "non-finite parameters after the DMD steps")
    BWD_MODES_BY_PATH["distill_dmd"] = modes
    return total, bundle


#: the offload phase's bandwidth probe: bytes copied each way
OFFLOAD_PROBE_BYTES = 1 << 30


def _meminfo() -> dict:
    """The host's MemTotal and MemAvailable in bytes (/proc/meminfo)."""
    out = {}
    with open("/proc/meminfo", encoding="ascii") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def _clones(named: dict) -> dict:
    """Copies of {name: tensor} where they lie, and their GiB: the offload
    phase keeps its comparison copies on the card (host copies of 11 GB
    cost seconds of page faults) and takes their bytes off the peaks."""
    out = {n: t.detach().clone() for n, t in named.items()}
    return out, sum(t.nbytes for t in out.values()) / 2**30


def _put_back(module, saved: dict) -> None:
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(saved[n])


def _bits(got: dict, want: dict) -> dict:
    """How many of `got`'s tensors differ from `want`'s (moved to got's
    device one at a time) in any bit, and the largest difference."""
    differ, worst = 0, 0.0
    for n, a in got.items():
        b = want[n].to(a.device)
        if not torch.equal(a, b):
            differ += 1
            worst = max(worst, (a.double() - b.double()).abs().max().item())
    return {"tensors": len(got), "differ": differ, "max_abs": worst}


def _host_peak() -> int:
    """Peak bytes of torch's pinned host allocator, which holds the
    recomputed blocks' inputs (not the moments or the shadow, which
    `pin_in_place` pins); 0 where torch keeps no such statistics."""
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return int(stats.get("allocated_bytes.all.peak",
                         stats.get("allocated_bytes.peak", 0)))


def _copy_rates(nbytes: int = OFFLOAD_PROBE_BYTES) -> dict:
    """GB/s of pinned copies on this card: to the card, to the host, and
    both at once on two streams (each way's rate), by CUDA events; and of
    making pinned host state (`memory.host_flat_like`: fresh zeroed pages,
    then locked; host clock)."""
    from mmpl_tpu_torch.utils import memory
    like = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    fresh = memory.host_flat_like([like])
    pin_gb_s = nbytes / (time.perf_counter() - t0) / 1e9
    del fresh, like
    host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    dev = [torch.empty(nbytes, dtype=torch.uint8, device="cuda")
           for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]

    def timed(jobs):
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            marks = []
            for stream, job in zip(streams, jobs):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                with torch.cuda.stream(stream):
                    a.record()
                    job()
                    b.record()
                marks.append((a, b))
            torch.cuda.synchronize()
            best = min(best, max(a.elapsed_time(b) for a, b in marks))
        return nbytes / (best / 1e3) / 1e9

    h2d = lambda: dev[0].copy_(host[0], non_blocking=True)
    d2h = lambda: host[1].copy_(dev[1], non_blocking=True)
    out = {"bytes": nbytes, "pin_gb_s": pin_gb_s, "h2d_gb_s": timed([h2d]),
           "d2h_gb_s": timed([d2h]), "duplex_gb_s_each_way": timed([h2d, d2h])}
    del host, dev
    torch.cuda.empty_cache()
    return out


def _offload_dmd(bundle) -> tuple:
    """(b) of `phase_offload`: a critic and a generator step of the DMD
    bundle offloaded (`--offload-opt --remat-offload`: HostAdamW for both
    optimizers, the generator's EMA on the host, every recomputed block's
    input on the host), then the same two steps resident from the same
    state and draws, with both optimizers and the EMA alive across the
    steps as in the trainer, then two more offloaded steps on the same
    draws (warm: the host state made and pinned, the allocators' caches
    filled).  Returns
    (rows, comparison, offloaded optimizers, launches)."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.training.distillation import (DistillationConfig,
                                                      Distiller)
    from mmpl_tpu_torch.utils.ema import EmaParams
    cfg, models, ro, sch, dcfg, batch, gen = bundle
    L, nb = cfg.num_layers, DISTILL_BLOCKS
    trained = {"critic": "fake_score", "generator": "generator"}
    start = {k: _clones(dict(models[k].named_parameters()))[0]
             for k in trained.values()}
    # the GiB of copies a run holds on the card beside its own tensors
    held = sum(t.nbytes for st in start.values() for t in st.values()) / 2**30
    gen_state = gen.get_state()
    rows, total = [], {}

    def two_steps(mode, opts, ema):
        """The critic's and the generator's step; their losses and
        launches by role."""
        nonlocal total
        off = mode != "resident"
        ro.remat_offload = off
        dist = Distiller(cfg, DistillationConfig(**dcfg, remat_offload=off),
                         ro, sch)
        out = {}
        for role, fn in (("critic", dist.critic_loss),
                         ("generator", dist.dmd_generator_loss)):
            def run(role=role, fn=fn):
                flags = ro.sample_exit_flags(gen, nb, device=gen.device)
                loss = train.train_step(
                    models, (trained[role],), fn, opts[role], batch,
                    {"generator": gen, "exit_flags": flags})
                if role == "generator":
                    ema.update(models["generator"])
                return loss.item(), ro.block_flags(flags, nb)

            (loss, flags), seconds, counts, peak = _run_counted(run)
            if role == "critic":
                fwd, bwd = _rollout_k123(flags, L, 0)
                expected = _k123(fwd + 2 * 2 * L, 2 * L)
            else:
                fwd, bwd = _rollout_k123(flags, L, nb)
                expected = _k123(fwd + 3 * 2 * L, bwd)
            row = {"phase": "offload_dmd", "run": mode, "step": role,
                   "layers": L, "flag": flags[0], "seconds": seconds,
                   "loss": loss, "launches": counts,
                   "expected_launches": expected,
                   "max_memory_allocated_gib": peak - held,
                   "held_copies_gib": held,
                   "pinned_state_bytes": (
                       opts[role].host_bytes if off else 0)
                   + (ema.host_bytes if role == "generator" else 0),
                   "pinned_allocator_peak_bytes": _host_peak()}
            emit(row)
            check(counts == expected, row)
            check(math.isfinite(loss), row)
            rows.append(row)
            out[role] = (loss, counts)
            total = {k: total.get(k, 0) + counts[k] for k in counts}
        return out

    def make(off):
        opts = {role: train.adamw(models[k].parameters(), 1e-5,
                                  train.OPTAX_WEIGHT_DECAY, offload=off)
                for role, k in trained.items()}
        return opts, EmaParams(models["generator"], decay=0.999, offload=off)

    off_opts, off_ema = make(True)
    off_loss = two_steps("offload", off_opts, off_ema)
    done = {k: _clones(dict(models[k].named_parameters()))[0]
            for k in trained.values()}
    for k in trained.values():
        _put_back(models[k], start.pop(k))
    gen.set_state(gen_state)
    res_opts, res_ema = make(False)
    res_loss = two_steps("resident", res_opts, res_ema)
    cmp = {"losses_equal": all(off_loss[r][0] == res_loss[r][0]
                               for r in trained),
           "launches_equal": all(off_loss[r][1] == res_loss[r][1]
                                 for r in trained),
           "ema": _bits(res_ema.shadow, off_ema.shadow)}
    for role, k in trained.items():
        cmp[f"{k}_params"] = _bits(dict(models[k].named_parameters()),
                                   done[k])
        stepped = [(n, p) for n, p in models[k].named_parameters()
                   if p in res_opts[role].state]
        for m in ("exp_avg", "exp_avg_sq"):
            cmp[f"{k}_{m}"] = _bits(
                {n: res_opts[role].state[p][m] for n, p in stepped},
                {n: off_opts[role].state[p][m] for n, p in stepped})
    cmp["moments_pinned_on_host"] = all(
        st[m].device.type == "cpu" and st[m].is_pinned()
        for o in off_opts.values() for st in o.state.values()
        for m in ("exp_avg", "exp_avg_sq"))
    cmp["ema_pinned_on_host"] = all(s.device.type == "cpu" and s.is_pinned()
                                    for s in off_ema.shadow.values())
    del res_opts, res_ema, done
    torch.cuda.empty_cache()
    held = 0.0
    # the first steps' draws again: the same exit flags, so the seconds
    # compare with both runs' at the same rollout length
    gen.set_state(gen_state)
    two_steps("offload_warm", off_opts, off_ema)
    ro.remat_offload = False
    return rows, cmp, off_opts, total


def phase_offload(bundle) -> dict:
    """Host offload at the 1.3B width: `--offload-opt` and
    `--remat-offload` (`utils/memory.py`) against the resident paths.

    (b) offload_dmd: on distill_dmd's bundle (DMD_LAYERS; bf16 over fp32
    masters, 21 frames at 60x104), a critic and a generator step with
    both optimizers' moments and the EMA in pinned host memory and every
    recomputed block's input there too, then the same steps resident
    (`_offload_dmd`): losses, updated parameters, moments and EMA bit for
    bit, exact and equal K1-K3 launches, each step's peak, seconds and
    pinned bytes; then the offloaded steps again, warm (the first pinned
    the host state).  The host's MemTotal / MemAvailable are printed; where
    the host cannot hold what this needs, (b) runs on a bundle cut to
    fewer layers and says so.  (c) offload_adamw: one more offloaded
    AdamW update of the generator alone against this card's pinned copy
    rates, measured here.  (d) offload_params: `offload_params` /
    `restore_params` of the generator, bit for bit.  (a) offload_tf:
    one teacher-forcing step of the 1.3B model at full depth resident and
    one with `remat_offload` from the same state and draws: loss,
    gradients and updated parameters bit for bit (or at train_parity's
    tolerances, saying so), K4-K6 exact and equal, each step's peak.
    Then both flags through `train.main --smoke`: the losses of a plain
    and an offloaded 2-step DMD run equal.  Returns the launches of (a)
    and (b)."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.training.diffusion import (
        DiffusionTrainer, draw_teacher_forcing, make_teacher_forcing_loss_fn)
    from mmpl_tpu_torch.utils import memory
    t_start = time.perf_counter()
    mem = _meminfo()
    cfg = bundle[0]
    tree = sum(p.numel() for p in bundle[1]["generator"].parameters()) * 4
    # the host holds the two trained models' start and offloaded results,
    # four moment trees and the shadow, and the recomputed blocks' inputs
    need = 10 * tree
    layers = cfg.num_layers
    if mem["MemAvailable"] < 1.2 * need:
        layers = max(2, int(layers * mem["MemAvailable"] / (1.2 * need)))
        del bundle
        torch.cuda.empty_cache()
        bundle = _distill_setup(layers)
    emit({"phase": "offload_host", "mem_total_bytes": mem["MemTotal"],
          "mem_available_bytes": mem["MemAvailable"],
          "host_bytes_needed": need, "dmd_layers": layers,
          "cut": layers != cfg.num_layers})
    rows, cmp, off_opts, total = _offload_dmd(bundle)
    emit({"phase": "offload_dmd_parity", **cmp})
    check(cmp["losses_equal"] and cmp["launches_equal"], cmp)
    check(all(v["differ"] == 0 for v in cmp.values()
              if isinstance(v, dict)), cmp)
    check(cmp["moments_pinned_on_host"] and cmp["ema_pinned_on_host"], cmp)
    by = {(r["run"], r["step"]): r for r in rows}
    emit({"phase": "offload_dmd_peaks", **{
        f"{run}_{step}_gib": r["max_memory_allocated_gib"]
        for (run, step), r in by.items()},
        "saved_gib": {f"{run}_{step}":
                      by["resident", step]["max_memory_allocated_gib"]
                      - by[run, step]["max_memory_allocated_gib"]
                      for run in ("offload", "offload_warm")
                      for step in ("critic", "generator")},
        "offloaded_trees_gib": 5 * tree / 2**30})

    # (c) one offloaded update of the generator alone, on the gradients of
    # the warm generator step
    models = bundle[1]
    rates = _copy_rates()
    opt = off_opts["generator"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    each_way = opt.host_bytes
    row = {"phase": "offload_adamw", "seconds": seconds,
           "bytes_each_way": each_way, "params": len(opt.state),
           "ring_bytes_on_card": opt.streamer.bytes_on_device, **rates,
           "bound_s": each_way / (rates["duplex_gb_s_each_way"] * 1e9)}
    row["bound_share"] = row["bound_s"] / seconds
    emit(row)
    check(math.isfinite(seconds), row)
    del off_opts, opt

    # (d) the generator's round trip through pinned host memory
    g = models["generator"]
    ref = {n: t.clone() for n, t in g.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memory.offload_params(g)
    off_s = time.perf_counter() - t0
    on_host = all(p.device.type == "cpu" and p.is_pinned()
                  for p in g.parameters())
    hbm_parked = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    memory.restore_params(g)
    torch.cuda.synchronize()
    back_s = time.perf_counter() - t0
    exact = all(torch.equal(ref[n], t) for n, t in g.state_dict().items())
    row = {"phase": "offload_params", "bytes": tree, "offload_s": off_s,
           "restore_s": back_s, "pinned": on_host,
           "allocated_gib_while_parked": hbm_parked,
           "allocated_gib_after": torch.cuda.memory_allocated() / 2**30,
           "bit_for_bit": exact}
    emit(row)
    check(on_host and exact, row)
    # the bundle's models and batch go here, whoever else holds the bundle
    bundle[1].clear()
    bundle[5].clear()
    del ref, g, models, bundle
    torch.cuda.empty_cache()

    # (a) teacher forcing at full depth, resident and with remat_offload
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda")
    model, sch, fm, batch, _ = _tf_setup(cfg, dev, torch.float32, 21,
                                         (60, 104))
    draws = draw_teacher_forcing(torch.Generator(device=dev).manual_seed(3),
                                 batch["latents"].shape, 3,
                                 len(sch.timesteps), 100, dev)
    start, held = _clones(dict(model.named_parameters()))
    out = {}
    for off in (False, True):
        if off:
            _put_back(model, start)
            # the resident run's gradients and parameters stay held
            held = sum(t.nbytes for k in ("grads", "params")
                       for t in out[False][k].values()) / 2**30
            start = None
        loss_fn = make_teacher_forcing_loss_fn(
            cfg, sch, fm, num_frame_per_block=3, noise_aug_max_timestep=100,
            remat_offload=off)
        trainer = DiffusionTrainer(model, loss_fn, learning_rate=1e-5)
        # the peak through the backward pass, read as AdamW starts: its
        # moments are made in this first step, after the boundaries are gone
        adamw_step, before_adamw = trainer.opt.step, []

        def step_after_backward(*a, **kw):
            before_adamw.append(torch.cuda.max_memory_allocated() / 2**30)
            return adamw_step(*a, **kw)

        trainer.opt.step = step_after_backward
        loss, seconds, counts, peak = _run_counted(
            lambda: trainer.train_step(batch, draws).item())
        expected = _train_launches(cfg.num_layers, 1)
        row = {"phase": "offload_tf", "remat_offload": off,
               "layers": cfg.num_layers, "seconds": seconds, "loss": loss,
               "launches": counts, "expected_launches": expected,
               "max_memory_allocated_gib": peak - held,
               "backward_peak_gib": before_adamw[0] - held,
               "held_copies_gib": held}
        emit(row)
        check(counts == expected, row)
        check(math.isfinite(loss), row)
        out[off] = {"loss": loss, "peak": row["backward_peak_gib"],
                    "launches": counts,
                    "grads": {n: p.grad for n, p in model.named_parameters()},
                    "params": dict(model.named_parameters())}
        total = {k: total.get(k, 0) + counts[k] for k in counts}
        if not off:
            out[off]["grads"] = _clones(out[off]["grads"])[0]
            out[off]["params"] = _clones(out[off]["params"])[0]
        del trainer
    grads = _bits(out[True]["grads"], out[False]["grads"])
    params = _bits(out[True]["params"], out[False]["params"])
    loss_rel = abs(out[True]["loss"] - out[False]["loss"]) / abs(
        out[False]["loss"])
    scale = max(t.abs().max().item() for t in out[False]["grads"].values())
    row = {"phase": "offload_tf_parity", "loss_equal":
           out[True]["loss"] == out[False]["loss"], "loss_rel_err": loss_rel,
           "grads": grads, "params": params, "grad_scale": scale,
           "launches_equal": out[True]["launches"] == out[False]["launches"],
           "backward_peak_gib": {"resident": out[False]["peak"],
                                 "remat_offload": out[True]["peak"]},
           "boundaries_gib": cfg.num_layers * 2 * 21 * 60 * 104 // 4
           * cfg.dim * 2 / 2**30}
    row["bit_for_bit"] = (row["loss_equal"] and grads["differ"] == 0
                          and params["differ"] == 0)
    emit(row)
    check(row["launches_equal"], row)
    if not row["bit_for_bit"]:
        # train_parity's tolerances
        check(loss_rel <= 1e-5 and grads["max_abs"] <= 1e-4, row)
    del out, start, model, batch, draws
    torch.cuda.empty_cache()

    # both flags through the entry point, in smoke mode
    smoke = ["--smoke", "--objective", "dmd", "--steps", "2", "--device",
             "cuda", "--dfake-gen-update-ratio", "1"]
    runs = {}
    for run, extra in (("offload_cli_plain", []),
                       ("offload_cli", ["--offload-opt",
                                        "--remat-offload"])):
        shutil.rmtree(os.path.join(OUT_DIR, run), ignore_errors=True)
        rc, secs, _, _, recs = _cli_run(OUT_DIR, run, smoke + extra)
        runs[run] = [(r["critic_loss"], r["gen_loss"]) for r in recs
                     if "critic_loss" in r]
        check(rc == 0, (run, rc))
    row = {"phase": "offload_cli", "losses": runs,
           "equal": runs["offload_cli"] == runs["offload_cli_plain"],
           "seconds": time.perf_counter() - t_start}
    emit(row)
    check(row["equal"] and len(runs["offload_cli"]) == 2, row)
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

    def record(name, fn, expected_of, splits=0, fused=0):
        """`splits`: the K1 launches that split their keys, the register
        token's (one query row over 32760 keys) on the GAN steps; `fused`:
        its backward's launches, fused."""
        nonlocal total
        (loss, flags), seconds, counts, peak = _run_counted(fn)
        modes = dict(attn.fwd_mode_launches)
        bwd_modes = dict(attn.bwd_mode_launches)
        expected = expected_of(flags)
        row = {"phase": "distill_other", "objective": name, "layers": L,
               "flag": flags[0] if flags else None, "seconds": seconds,
               "loss": loss, "launches": counts,
               "expected_launches": expected, "flash_fwd_modes": modes,
               "flash_bwd_modes": bwd_modes,
               "max_memory_allocated_gib": peak}
        emit(row)
        check(counts == expected, row)
        check(modes["split"] == splits, row)
        check(bwd_modes["fused"] == fused, row)
        if splits:
            FWD_MODES_BY_PATH[name] = modes
        if fused:
            BWD_MODES_BY_PATH[name] = bwd_modes
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
        gen, nb), gan_critic, splits=3 * 3, fused=3 * 3)
    record("gan_generator", lambda: _distill_step(
        models, ("generator",), gan.gan_generator_loss, batch, ro, gen, nb),
        graded_gen(classify + trunk, classify), splits=3, fused=3)
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


def phase_ode_profile(timed_steps: int = 2):
    """One ODE-regression step of the trainer's default fp32 trunk
    (`ode_regression_loss(dtype=torch.float32)`, the generator at 1.3B
    width cut to SHALLOW_LAYERS, 21 frames at 60x104) under
    torch.profiler, as phase_train_profile reads a step: device time by
    kernel, K1-K3's shares, the idle share; after one warm-up step and
    `timed_steps` steps timed on the host clock (synchronised), with exact
    K1-K3 launches.  Not a phase of main() (the script's time limit): PERF.md
    §5's fp32 ODE breakdown comes from it run alone on a card, against this
    tree's package or another checkout's (put that checkout's root first on
    sys.path before loading this file), after `set_float32_precision()`."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.training.distillation import (
        ode_regression_loss, prepare_ode_generator_input)
    L, nb = SHALLOW_LAYERS, DISTILL_BLOCKS
    cfg, models, _, sch, _, batch, gen = _distill_setup(
        L, dtype=torch.float32)
    gmodel = models["generator"]
    del models
    steps = (1000, 750, 500)
    traj = torch.randn((1, len(steps) + 1, DISTILL_FRAMES, 16, 60, 104),
                       device="cuda", generator=gen)
    idx = torch.randint(0, len(steps), (1, nb), device="cuda",
                        generator=gen)
    noisy, tt = prepare_ode_generator_input(traj, steps, idx)
    ode_batch = {"noisy_input": noisy, "clean_latent": traj[:, -1],
                 "timestep": tt, "ctx_kv": batch["ctx_kv"]}
    opt = train.adamw(gmodel.parameters(), 1e-5, train.OPTAX_WEIGHT_DECAY)
    losses = []

    def step():
        losses.append(train.train_step(
            {"generator": gmodel}, ("generator",),
            lambda m, b, d: ode_regression_loss(m["generator"], cfg, sch, b,
                                                dtype=torch.float32),
            opt, ode_batch, {}).item())

    step()
    _, seconds, counts, peak = _run_counted(
        lambda: [step() for _ in range(timed_steps)])
    expected = _k123(timed_steps * (2 * nb * 2 * L + (2 * nb - 1) * 2 * L),
                     timed_steps * (nb * 2 * L + (nb - 1) * 2 * (L - 1)))
    row = {"phase": "ode_step", "dtype": "float32", "layers": L,
           "step_s": seconds / timed_steps, "losses": losses,
           "launches": counts, "expected_launches": expected,
           "max_memory_allocated_gib": peak}
    emit(row)
    check(counts == expected, row)
    check(all(map(math.isfinite, losses)), row)
    phase_train_profile(step, phase="ode_profile",
                        what=f"one fp32 ODE-regression step, {L} layers",
                        checked=("flash_fwd", "flash_bwd_dkv",
                                 "flash_bwd_dq"))
    del gmodel, opt, ode_batch, traj, noisy
    torch.cuda.empty_cache()


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
    return total, runs[1]


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
    bwd_modes = dict(attn.bwd_mode_launches)
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
           "bwd_modes": bwd_modes,
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
    # each ring step's chunk ([8, 8190]^2 stacked) on the ordered walk
    check(bwd_modes == {**dict.fromkeys(bwd_modes, 0), "ordered": RING},
          bwd_modes)
    BWD_MODES_BY_PATH["ring"] = bwd_modes
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


#: layers of the 1.3B width in the mesh phase's FSDP2 teacher-forcing step
#: and the unsharded step it is held against (cut from 30 for the script's
#: time limit; the train phase runs the step at full depth)
MESH_LAYERS = 10


def _train_mesh_step(mesh) -> dict:
    """One teacher-forcing step of the 1.3B model at full width and
    MESH_LAYERS layers, the train phase's shapes (21 latents at 60x104, B=1, bf16 over fp32
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
    cfg = _cfg13(MESH_LAYERS)
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


def phase_mesh(shards: str):
    """`init_distributed` on NCCL at world size 1 (a localhost rendezvous,
    an ephemeral port), `make_mesh`'s default fold and an sp x ring mesh,
    USP attention over the real process groups (of one rank each), and
    one group-3 forward of the 1.3B pipeline built over the default mesh
    (`_sharded_fps_step`), one 1.3B teacher-forcing step at full width and
    MESH_LAYERS layers with the model FSDP-sharded over it against the same
    step without (`_train_mesh_step`), the `train --mesh` CLI in smoke mode
    (`_train_mesh_cli`) and its sharded checkpoints on the data phase's
    shards (`_mesh_ckpt`); the group is destroyed after."""
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
        step.update(_mesh_ckpt(shards))
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
    _check_resumed({k[len("mesh_ckpt_"):]: v for k, v in row.items()
                    if k.startswith("mesh_ckpt_")})
    check(row["mesh_ckpt_launches"] == row["mesh_ckpt_expected_launches"],
          row)
    check(".metadata" in row["mesh_ckpt_files"]
          and "rank0.pt" in row["mesh_ckpt_files"], row)
    total = {k: v + cli_counts[k] + row["mesh_ckpt_launches"][k]
             for k, v in row["train_mesh_launches"].items()}
    total["flash_fwd"] += counts["flash_fwd"] + row["sharded_step_flash_fwd"]
    return total


# ---------------------------------------------------------------------------
# The training data path: raw clips -> latent shards, ODE trajectories,
# the trainer's --data-dir, sharded checkpoints
# ---------------------------------------------------------------------------

DATA_DIR = os.path.join(OUT_DIR, "data")
#: (file, pixel frames, prompt): two clips of 81+ frames and one too short
DATA_CLIPS = (("clip_a.npy", 97, "a cat surfing a wave at sunset"),
              ("clip_b.npy", 89, "a red fox runs on the beach"),
              ("short.npy", 40, "a lazy dog"))
DATA_HW = (720, 1280)
DATA_LAYERS = 2


def _write_clips(root: str) -> str:
    """The clips as uint8 [T, 720, 1280, 3] `.npy` (a drifting colour
    gradient with noise, from seeds) and their CSV; returns the CSV."""
    os.makedirs(root, exist_ok=True)
    h, w = DATA_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([x * 255 / w, y * 255 / h,
                     128 + 64 * np.sin(x / 41.0)], -1).astype(np.uint8)
    for i, (name, frames, _) in enumerate(DATA_CLIPS):
        noise = np.random.default_rng(60 + i).integers(
            0, 24, (h, w + frames, 3), dtype=np.uint8)
        clip = np.empty((frames, h, w, 3), np.uint8)
        for t in range(frames):
            # the gradient drifts a pixel a frame, the noise slides
            np.add(np.roll(base, t, axis=1), noise[:, t:t + w], out=clip[t])
        np.save(os.path.join(root, name), clip)
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", encoding="utf-8") as f:
        f.write("file_name,text\n" + "".join(
            f"{name},{text}\n" for name, _, text in DATA_CLIPS))
    return meta


def phase_data(wan: str) -> str:
    """Raw clips to latent shards on the card: the resample
    (`data/fastproc.py`, 81 frames of 720x1280 to 480x832) timed by CUDA
    events and held against the same on the CPU (9 frames), then
    `python -m mmpl_tpu_torch.data.video_dataset --use_native` in process
    on the ckpt phase's VAE file, its 2-layer umT5 (the umT5 config cut to
    the file's depth) and word tokenizer: each clip resampled and encoded
    on the card (`encode_streaming`, seconds and peak per clip), the short
    clip skipped, the shard's bytes and shapes.  Returns the shard
    directory."""
    from mmpl_tpu_torch.data import fastproc, video_dataset
    from mmpl_tpu_torch.models import t5
    from mmpl_tpu_torch.utils import checkpoint as ckpt_mod
    cfg = WAN_CONFIGS["t2v-1.3B"]
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    clips = os.path.join(DATA_DIR, "clips")
    t0 = time.perf_counter()
    meta = _write_clips(clips)
    write_s = time.perf_counter() - t0
    raw = torch.from_numpy(np.load(os.path.join(clips, DATA_CLIPS[0][0]))
                           [:81].copy())
    on_card = raw.cuda()
    resample_ms = time_ms(lambda: fastproc.scale_crop_normalize_clip(
        on_card, 480, 832))
    got = fastproc.scale_crop_normalize_clip(on_card[:9], 480, 832).cpu()
    want = fastproc.scale_crop_normalize_clip(raw[:9], 480, 832)
    resample_err = (got - want).abs().max().item()
    del on_card, got, want, raw
    torch.cuda.empty_cache()

    seen = {"resample": [], "encode": []}
    real_resample, real_encode = (fastproc.scale_crop_normalize_clip,
                                  vae.encode_streaming)

    def resample(frames, h, w):
        out = real_resample(frames, h, w)
        seen["resample"].append((frames.device.type, out.device.type))
        return out

    def encode(model, pixels):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real_encode(model, pixels)
        torch.cuda.synchronize()
        seen["encode"].append({
            "device": pixels.device.type, "pixels": list(pixels.shape),
            "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        return out

    out = os.path.join(DATA_DIR, "shards")
    real_t5 = t5.UMT5_XXL
    fastproc.scale_crop_normalize_clip, vae.encode_streaming = (resample,
                                                                encode)
    t5.UMT5_XXL = dict(real_t5, num_layers=T5_SHALLOW_LAYERS)
    t0 = time.perf_counter()
    try:
        paths = video_dataset.data_process([
            "--base_path", clips, "--metadata_path", meta,
            "--output_path", out, "--vae_path",
            os.path.join(wan, cfg.vae_checkpoint), "--text_encoder_path",
            os.path.join(wan, cfg.t5_checkpoint), "--tokenizer_path",
            os.path.join(wan, cfg.t5_tokenizer), "--num_frames", "81",
            "--height", "480", "--width", "832", "--use_native"])
    finally:
        fastproc.scale_crop_normalize_clip, vae.encode_streaming = (
            real_resample, real_encode)
        t5.UMT5_XXL = real_t5
    total_s = time.perf_counter() - t0
    z = np.load(paths[0], allow_pickle=True)
    row = {"phase": "data", "clips": [[n, f, *DATA_HW] for n, f, _ in
                                      DATA_CLIPS],
           "clip_write_s": write_s, "resample_ms_per_clip": resample_ms,
           "resample_frames": 81, "resample_to": [480, 832],
           "resample_card_vs_cpu_max_abs": resample_err,
           "resample_devices": seen["resample"],
           "read": "numpy .npy; resample data/fastproc.py on the card "
                   "(no PIL)",
           "encode": seen["encode"], "data_process_s": total_s,
           "shards": [os.path.basename(p) for p in paths],
           "shard_bytes": sum(os.path.getsize(p) for p in paths),
           "latents_shape": list(z["latents"].shape),
           "prompt_embeds_shape": list(z["prompt_embeds"].shape),
           "prompts": [str(p) for p in z["prompts"]],
           "short_clip_skipped": DATA_CLIPS[2][2] not in
           [str(p) for p in z["prompts"]],
           "latents_finite": bool(np.isfinite(z["latents"]).all()),
           "latents_std": float(z["latents"].std()),
           "states_differ": float(np.abs(z["prompt_embeds"][0]
                                         - z["prompt_embeds"][1]).max())}
    del z
    emit(row)
    check(len(paths) == 1 and row["latents_shape"] == [2, 21, 16, 60, 104],
          row)
    check(row["prompt_embeds_shape"] == [2, 512, 4096], row)
    check(row["short_clip_skipped"] and row["prompts"]
          == [DATA_CLIPS[0][2], DATA_CLIPS[1][2]], row)
    check(row["latents_finite"] and row["latents_std"] > 1e-3, row)
    check(row["states_differ"] > 1e-3, row)
    check(resample_err <= 1e-5, row)
    check(seen["resample"] == [("cuda", "cuda")] * 2, row)
    check([e["device"] for e in seen["encode"]] == ["cuda"] * 2
          and all(e["pixels"] == [1, 81, 3, 480, 832]
                  for e in seen["encode"]), row)
    return out


def phase_ode_gen(shards: str):
    """`data/ode_gen.record_trajectories` on the 1.3B teacher at full width
    and depth in bf16: the CFG pair (the data phase's first umT5 states,
    a zero uncond) over one 21x60x104 latent, 4 UniPC steps, the step
    list 1000,750,500,250; seconds a step, exact K1 (self-attention at
    32760^2 over B = 2 and text cross-attention, each layer and step);
    the shard written with `prompt_embeds`.  Returns (shard directory, K1
    launches)."""
    from mmpl_tpu_torch.data.datasets import TensorDictDataset
    from mmpl_tpu_torch.data.ode_gen import (ODERegressionNpzDataset,
                                             record_trajectories,
                                             write_ode_shard)
    cfg = _cfg13(DISTILL_LAYERS)
    dev = torch.device("cuda")
    item = TensorDictDataset(shards)[0]
    cond = torch.from_numpy(item["prompt_embeds"][None]).to(dev)
    noise = torch.randn((1, DISTILL_FRAMES, 16, 60, 104), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(51))
    model = _model13(cfg, 50, torch.bfloat16)
    steps = 4
    traj, seconds, counts, peak = _run_counted(lambda: record_trajectories(
        cfg, model, noise, cond, torch.zeros_like(cond),
        denoising_step_list=FEW_STEPS, sampling_steps=steps,
        dtype=torch.bfloat16))
    del model
    torch.cuda.empty_cache()
    root = os.path.join(DATA_DIR, "ode")
    path = write_ode_shard(os.path.join(root, "ode_00000.npz"), traj,
                           [item["prompts"]], cond)
    back = ODERegressionNpzDataset(root)[0]
    expected = _k123(steps * 2 * cfg.num_layers)
    row = {"phase": "ode_gen", "layers": cfg.num_layers, "dim": cfg.dim,
           "dtype": "bf16", "sampling_steps": steps,
           "step_list": list(FEW_STEPS), "seconds": seconds,
           "seconds_per_step": seconds / steps,
           "trajectory_shape": list(traj.shape),
           "entry0_equals_noise": bool(torch.equal(traj[:, 0],
                                                   noise.float())),
           "final_minus_noise_mean_abs": (traj[:, -1] - noise).abs().mean()
           .item(),
           "finite": bool(torch.isfinite(traj).all()),
           "shard_bytes": os.path.getsize(path),
           "shard_keys": sorted(back),
           "launches": counts, "expected_launches": expected,
           "max_memory_allocated_gib": peak}
    del traj, noise
    emit(row)
    check(row["trajectory_shape"] == [1, 5, 21, 16, 60, 104], row)
    check(row["entry0_equals_noise"] and row["finite"], row)
    check(row["final_minus_noise_mean_abs"] > 1e-3, row)
    check(row["shard_keys"] == ["ode_latent", "prompt_embeds", "prompts"],
          row)
    check(counts == expected, row)
    return root, counts["flash_fwd"]


def _ode_k123(layers: int, steps: int) -> dict:
    """K1-K3 launches of `steps` ODE-regression steps over 21 frames (7
    blocks of 3) at `layers` layers, as train_distill_cli counts them."""
    nb, L = DISTILL_BLOCKS, layers
    return _k123(steps * (2 * nb * 2 * L + (2 * nb - 1) * 2 * L),
                 steps * (nb * 2 * L + (nb - 1) * 2 * (L - 1)))


@contextlib.contextmanager
def _layers_13(layers: int):
    """The trainer's `t2v-1.3B` cut to `layers` layers inside the block."""
    from mmpl_tpu_torch.core.config import DotDict
    full = WAN_CONFIGS["t2v-1.3B"]
    WAN_CONFIGS["t2v-1.3B"] = DotDict(full, num_layers=layers)
    try:
        yield
    finally:
        WAN_CONFIGS["t2v-1.3B"] = full


def _cli_run(root: str, run: str, argv: list):
    """`train.main(argv)` in this process: (rc, seconds, launches, peak
    GiB, metric records)."""
    from mmpl_tpu_torch import train
    rc, seconds, counts, peak = _run_counted(lambda: train.main(
        argv + ["--log-dir", root, "--run-name", run]))
    return rc, seconds, counts, peak, _metrics(root, run)


#: the train_data ODE run (2 layers, fp32 trunk) when fp32 K1 and K2 ran
#: the FMA template bodies: a step's seconds on an H100 80GB HBM3 at 700
#: W, and the losses of this script's last run on the templates (the same
#: card type and data); PERF.md, Findings, holds both runs
ODE_ON_TEMPLATES = {"template_step_s": 5.37,
                    "template_losses": [5.780923366546631, 4.507685661315918]}


def phase_train_data(shards: str, ode_dir: str) -> dict:
    """`python -m mmpl_tpu_torch.train --data-dir` in process on the
    shards the data phase wrote: teacher forcing at full width and depth
    (2 steps; K1-K6 exact; each step's seconds and its batch's load
    seconds), flow at DATA_LAYERS layers, and `--objective ode --data-dir`
    on the ode_gen shard at DATA_LAYERS layers.  Returns the launches."""
    root = os.path.join(DATA_DIR, "runs")
    runs = {
        "teacher_forcing": (30, ["--data-dir", shards],
                            _train_launches(30, 2)),
        "flow": (DATA_LAYERS, ["--objective", "flow", "--data-dir", shards],
                 _k123(2 * 4 * DATA_LAYERS, 2 * 2 * DATA_LAYERS)),
        "ode": (DATA_LAYERS, ["--objective", "ode", "--data-dir", ode_dir],
                _ode_k123(DATA_LAYERS, 2)),
    }
    total = dict.fromkeys(attn.launch_counts, 0)
    for objective, (layers, extra, expected) in runs.items():
        with _layers_13(layers):
            rc, seconds, counts, peak, recs = _cli_run(
                root, f"data_{objective}",
                ["--device", "cuda", "--steps", "2"] + extra)
        steps = [r for r in recs if "loss" in r]
        row = {"phase": "train_data", "objective": objective,
               "layers": layers, "rc": rc, "seconds": seconds,
               "losses": [r["loss"] for r in steps],
               "step_s": [r["step_s"] for r in steps],
               "load_s": [r["load_s"] for r in steps],
               "launches": counts, "expected_launches": expected,
               "max_memory_allocated_gib": peak}
        if objective == "ode":
            # the fp32 trunk: beside the run on the template bodies
            row.update(ODE_ON_TEMPLATES, losses_max_rel_to_templates=max(
                abs(a - b) / abs(b) for a, b in zip(
                    row["losses"], ODE_ON_TEMPLATES["template_losses"])))
        emit(row)
        check(rc == 0 and len(steps) == 2, row)
        check(all(map(math.isfinite, row["losses"])), row)
        check(counts == expected, row)
        total = {k: total[k] + counts[k] for k in total}
    torch.cuda.empty_cache()
    return total


def _resume_exact(root: str, argv: list, steps: int, read) -> dict:
    """`steps` steps twice unbroken (the first with checkpoints after each
    step) and once resumed from the first run's step-1 checkpoint; the last step's state
    of each run read by `read`: the resumed one against the unbroken one
    bit for bit (or within the two unbroken runs' spread where those
    differ).  Returns the row's numbers."""
    out = {}
    for run in ("unbroken", "unbroken2", "resumed"):
        # only the unbroken run writes every step (the resumed run starts
        # from its step 1); the others write their last
        every = 1 if run == "unbroken" else steps
        extra = ["--ckpt-dir", os.path.join(root, run)]
        if run == "resumed":
            extra += ["--resume", os.path.join(root, "unbroken", "step1")]
        rc, seconds, counts, _, recs = _cli_run(
            root, run, argv + ["--steps", str(steps), "--ckpt-every",
                               str(every)] + extra)
        check(rc == 0, (run, rc))
        out[run] = {"seconds": seconds, "launches": counts, "recs": recs,
                    "state": read(os.path.join(root, run, f"step{steps}"))}
    spread = _state_diff(out["unbroken2"]["state"], out["unbroken"]["state"])
    diff = _state_diff(out["resumed"]["state"], out["unbroken"]["state"])
    saves = [r for r in out["unbroken"]["recs"] if "ckpt_bytes" in r]
    restore = [r for r in out["resumed"]["recs"] if "restore_s" in r]
    loss = {run: {r["step"]: r["loss"] for r in o["recs"] if "loss" in r}
            for run, o in out.items()}
    return {"steps": steps, "ckpt_bytes": saves[0]["ckpt_bytes"],
            "save_s": [r["save_s"] for r in saves],
            "restore_s": restore[0]["restore_s"], "losses": loss,
            "resumed_losses_equal": all(
                loss["resumed"][k] == loss["unbroken"][k]
                for k in loss["resumed"]),
            "unbroken_spread_max_abs": spread, "resumed_max_abs_diff": diff,
            "bit_for_bit": diff == 0.0,
            "launches": out["resumed"]["launches"]}


def _check_resumed(row) -> None:
    if row["unbroken_spread_max_abs"] == 0.0:
        check(row["resumed_losses_equal"] and row["bit_for_bit"], row)
    else:
        check(row["resumed_max_abs_diff"] <= row["unbroken_spread_max_abs"],
              row)


def phase_train_data_resume(shards: str) -> dict:
    """Teacher forcing on the shards at the 1.3B width cut to DATA_LAYERS
    layers, 3 steps over the 2 clips (step 2 starts the second shuffle):
    resumed from step 1, the step-3 state (masters, AdamW, EMA,
    generators, the data position) against the unbroken run's bit for
    bit; exact launches of the resumed run's 2 steps."""
    from mmpl_tpu_torch.utils import train_state_io as tsio
    root = os.path.join(DATA_DIR, "resume")
    with _layers_13(DATA_LAYERS):
        row = _resume_exact(root, ["--device", "cuda", "--data-dir", shards],
                            3, tsio.restore_checkpoint)
    row = {"phase": "train_data_resume", "layers": DATA_LAYERS, **row,
           "expected_launches": _train_launches(DATA_LAYERS, 2)}
    shutil.rmtree(root, ignore_errors=True)
    emit(row)
    _check_resumed(row)
    check(row["launches"] == row["expected_launches"], row)
    return row["launches"]


def _mesh_ckpt(shards: str) -> dict:
    """On the group already initialised: teacher forcing on the shards at
    DATA_LAYERS layers under `--mesh dp=1,fsdp=1` (FSDP2), saved sharded
    after each step (`train_state_io.save_sharded`), 3 steps unbroken and
    resumed from step 1; the step-3 checkpoints read back without the
    group (`sharded_to_state`) bit for bit; save / restore seconds and
    bytes; exact launches of the resumed run."""
    from mmpl_tpu_torch.utils import train_state_io as tsio
    root = os.path.join(DATA_DIR, "mesh_ckpt")
    with _layers_13(DATA_LAYERS):
        row = _resume_exact(root, ["--device", "cuda", "--data-dir", shards,
                                   "--mesh", "dp=1,fsdp=1"], 3,
                            tsio.sharded_to_state)
    files = sorted(os.listdir(os.path.join(root, "unbroken", "step3")))
    shutil.rmtree(root, ignore_errors=True)
    out = {f"mesh_ckpt_{k}": v for k, v in row.items()}
    out["mesh_ckpt_files"] = files
    out["mesh_ckpt_expected_launches"] = _train_launches(DATA_LAYERS, 2)
    return out


# ---------------------------------------------------------------------------
# What the mesh refused until now: int8 projections and the int8 cache over
# tp, tp in training, chunk-pipeline stages as processes.  Two ranks share
# this one card over gloo (NCCL takes no two ranks on one device); the
# group moves carry CUDA tensors through host memory where gloo takes none
# (point-to-point: `collectives.GLOO_HOST_MOVES`)
# ---------------------------------------------------------------------------

#: layers of the 1.3B width in mesh_int8 and mesh_tp_train (cut from 30:
#: every all-reduce crosses the host under gloo)
TP_LAYERS = 2
#: seconds the two ranks may take for all their cases, start-up included
RANKS_LIMIT = 480
#: Q's tensor-parallel shapes (label, M, K): fc2's input at tp 2 (18720
#: tokens of group 3 x the 4480 ffn units of a rank) and a row of 768
#: (o's input, and a cache token's heads, at tp 2)
Q_MODE_SHAPES = (("g23_fc2_tp2", 18720, 4480), ("g23_o_tp2", 18720, 768))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_kernel_q_modes():
    """Q's amax mode and given-scale mode at the tensor-parallel shapes:
    the amax, the scale and the codes exactly against their plain
    versions, the halves of a row split in two composed to the whole
    row's codes, the body each ran, device times, plain times and bounds
    (bytes: the row read once; the codes written once by the given-scale
    mode), and the amax mode's beside one library call of the same
    function (`torch.linalg.vector_norm` of order inf in fp32)."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, M, K in Q_MODE_SHAPES:
        x = (3 * torch.randn((M, K), generator=gen, device="cuda")).to(
            torch.bfloat16)
        amax = quant.row_amax_cuda(x)
        s = quant.amax_scale(amax)
        q = quant.quantize_rows_scaled_cuda(x, s)
        pq, ps = quant.quantize_rows_plain(x)
        torch.cuda.synchronize()
        row = {"phase": "kernel_q_modes", "shape": label, "M": M, "K": K,
               "q_row_warps": quant.q_row_warps(K),
               "amax_equal": bool(torch.equal(amax,
                                              quant.row_amax_plain(x))),
               "scales_equal": bool(torch.equal(s, ps)),
               "codes_equal": bool(torch.equal(q, pq)),
               "max_abs_err": max((q.int() - pq.int()).abs().max().item(),
                                  (s - ps).abs().max().item())}
        halves = [h.contiguous() for h in x.chunk(2, -1)]
        sh = quant.amax_scale(torch.maximum(*(quant.row_amax_cuda(h)
                                              for h in halves)))
        row["split_equal"] = bool(torch.equal(sh, ps) and torch.equal(
            torch.cat([quant.quantize_rows_scaled_cuda(h, sh)
                       for h in halves], -1), pq))
        for mode, fn, plain, nbytes in (
                ("amax", lambda: quant.row_amax_cuda(x),
                 lambda: quant.row_amax_plain(x), M * K * 2 + 4 * M),
                ("scaled", lambda: quant.quantize_rows_scaled_cuda(x, s),
                 lambda: quant.quantize_rows_scaled_plain(x, s),
                 M * K * 2 + 4 * M + M * K)):
            row[f"{mode}_ms"], names = _device_ms(fn, "quantize_rows")
            row[f"{mode}_body"] = _int8_body(names, "quantize_rows", K)
            row[f"{mode}_plain_ms"] = time_ms(plain, max_reps=5)
            row[f"{mode}_bound_ms"] = 1e3 * nbytes / PEAK_BYTES
            row[f"{mode}_bound_share"] = (row[f"{mode}_bound_ms"]
                                          / row[f"{mode}_ms"])

        def library():      # the yardstick only: the port never calls it
            return torch.linalg.vector_norm(x, float("inf"), dim=-1,
                                            dtype=torch.float32)
        row["amax_library_ms"] = _device_ms(library)[0]
        row["amax_library_equal"] = bool(torch.equal(library(), amax))
        row["scaled_library_ms"] = None     # no one call codes at a scale
        emit(row)
        check(row["amax_equal"] and row["scales_equal"]
              and row["codes_equal"] and row["split_equal"], row)
        rows[label] = row
        del x, amax, s, q, pq, ps, halves
        torch.cuda.empty_cache()
    return rows


def _counts() -> dict:
    """The attention and int8 launch counters, and Q's by mode."""
    return {**attn.launch_counts, **quant.launch_counts,
            **{f"q_{k}": v for k, v in quant.q_mode_counts.items()}}


def _reset_counts() -> None:
    attn.reset_launch_counts()
    quant.reset_launch_counts()


def _rank_mesh_int8(rank: int, world: int) -> dict:
    """One group-2 solver forward and its commit of the 1.3B window model
    (TP_LAYERS layers, bf16, the CFG pair: 18,720 tokens, group 3's
    shapes) in W8A8 with the int8 cache,
    unsharded and then over tp = `world`, with the launches of each
    forward.  Then the unsharded forward's own layer-0 fc2 input and
    commit K tokens split over tp: the row-parallel product's summed
    int32 accumulators, codes, scales and output, and the cache's codes
    and scales, against the unsharded ones."""
    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    from mmpl_tpu_torch.models import fps_dit
    from mmpl_tpu_torch.parallel.collectives import as_mesh
    from mmpl_tpu_torch.parallel.mesh import make_mesh
    cfg = _cfg13(TP_LAYERS)
    dev = torch.device("cuda", torch.cuda.current_device())
    cond, uncond = cli.random_text_context(cfg, dev)
    lat = torch.randn((1, 6, 16, 60, 104), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(7))
    mesh = make_mesh({"tp": world})
    seen = {}
    w8a8, code = quant.w8a8_matmul, fps_dit.quantize_rows

    def spy_w8a8(x, wq, wscale, *a, **kw):
        if wq.shape[1] == cfg.ffn_dim and "fc2_x" not in seen:
            seen["fc2_x"] = x.reshape(-1, wq.shape[1]).clone()
        return w8a8(x, wq, wscale, *a, **kw)

    def spy_code(x):
        if seen.get("commit") and "k" not in seen:
            seen["k"] = x.clone()
        return code(x)

    def run(m, quantize="int8"):
        pipe = CausalFPSInferencePipeline(
            cfg, _model13(cfg, 0, torch.bfloat16), sampling_steps=1,
            quantize=quantize, quantize_cache=quantize is not None, mesh=m,
            dtype=torch.bfloat16)
        group = pipe.plan.groups[2]         # 6 frames, not in append mode
        out = {}
        with torch.inference_mode():
            ctx_kv2 = pipe.prepare_context(cond, uncond)
            cache = fps_dit.init_kv_cache(pipe.cfg, 2, 60 * 104 // 4,
                                          KV_CACHE_SLOTS, torch.bfloat16,
                                          dev, quantize=quantize is not None)
            for phase, t, write in (("solver", 500.0, False),
                                    ("commit", 0.0, True)):
                seen["commit"] = write
                torch.cuda.synchronize()
                _reset_counts()
                t0 = time.perf_counter()
                flow = pipe._forward(group, ctx_kv2, cache, lat, t, write)
                torch.cuda.synchronize()
                out[f"{phase}_s"] = time.perf_counter() - t0
                out[f"{phase}_launches"] = _counts()
                if not write:
                    out["flow"] = flow.float()
        out["cache"] = {k: v[:, :, list(group.write_slots)]
                        for k, v in cache.items()}
        out["fc2"] = pipe.model.blocks[0].ffn.fc2
        return out

    # the bf16 forwards (no int8), unsharded and over tp: how far tp alone
    # moves the flow, and how far int8 moves it
    float_one = run(None, None)["flow"]
    float_tp = run(mesh, None)["flow"]

    quant.w8a8_matmul, fps_dit.quantize_rows = spy_w8a8, spy_code
    try:
        one = run(None)
    finally:
        quant.w8a8_matmul, fps_dit.quantize_rows = w8a8, code
    torch.cuda.reset_peak_memory_stats()
    sharded = run(mesh)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    tp = as_mesh(mesh).get_group("tp")
    r = as_mesh(mesh).coordinate("tp")
    cols = lambda t: t.chunk(world, -1)[r].contiguous()
    x, fc2 = seen["fc2_x"], one["fc2"]
    xq, xs = quant.quantize_rows_split(cols(x), tp)
    acc = tp.all_reduce(quant.int8_gemm(xq, cols(fc2.codes), None, None,
                                        torch.int32))
    wxq, wxs = quant.quantize_rows(x)
    want_acc = quant.int8_gemm(wxq, fc2.codes, None, None, torch.int32)
    y = quant.w8a8_matmul(cols(x), cols(fc2.codes), fc2.scale, group=tp)
    want_y = quant.w8a8_matmul(x, fc2.codes, fc2.scale)
    k = seen["k"]
    kq, ks = quant.quantize_rows_split(cols(k), tp)
    wkq, wks = quant.quantize_rows(k)
    heads = lambda t: t.chunk(world, -1)[r]
    same = lambda a, b: (a == b).float().mean().item()
    return {
        "layers": TP_LAYERS, "tp": world, "rank": r,
        "flow_rel_err": rel(sharded["flow"], one["flow"]),
        "bf16_flow_tp_rel_err": rel(float_tp, float_one),
        "bf16_vs_int8_rel": rel(float_one, one["flow"]),
        "flow_finite": bool(torch.isfinite(sharded["flow"]).all()),
        "fc2_rows": tuple(x.shape),
        "fc2_acc_equal": bool(torch.equal(acc, want_acc)),
        "fc2_codes_equal": bool(torch.equal(xq, cols(wxq))),
        "fc2_scales_equal": bool(torch.equal(xs, wxs)),
        "fc2_out_max_ulps": _ulps(y, want_y),
        "k_rows": tuple(k.shape),
        "cache_codes_equal": bool(torch.equal(kq, cols(wkq))),
        "cache_scales_equal": bool(torch.equal(ks, wks)),
        # the forwards' own caches: the sharded QK-norm sums its squares
        # in another order, so a token may differ in its last bit
        "forward_cache_codes_same_share": same(
            sharded["cache"]["k"], heads(one["cache"]["k"])),
        "forward_cache_scales_same_share": same(
            sharded["cache"]["k_scale"], one["cache"]["k_scale"]),
        "launches": {p: sharded[f"{p}_launches"]
                     for p in ("solver", "commit")},
        "launches_single": {p: one[f"{p}_launches"]
                            for p in ("solver", "commit")},
        "seconds": {p: sharded[f"{p}_s"] for p in ("solver", "commit")},
        "seconds_single": {p: one[f"{p}_s"] for p in ("solver", "commit")},
        "peak_gib": peak}


def _tp_step(cfg, dev, mesh, dtype) -> dict:
    """One teacher-forcing step of `cfg` (21 latent frames at 60x104, all
    65,520 tokens, fp32 masters, the trunk in `dtype`, AdamW), unsharded
    (mesh None) or over the tp mesh (`shard_for_training`): its loss,
    gradient norm, seconds, peak and launches, and its whole gradients and
    updated parameters (the tp slices gathered)."""
    from mmpl_tpu_torch.core.config import DotDict
    from mmpl_tpu_torch.parallel.mesh import gather_tp, shard_for_training
    from mmpl_tpu_torch.training.diffusion import (
        DiffusionTrainer, draw_teacher_forcing, make_teacher_forcing_loss_fn)
    model, sch, fm, batch, _ = _tf_setup(cfg, dev, torch.float32, 21,
                                         (60, 104))
    c, group = cfg, None
    if mesh is not None:
        sh = shard_for_training(model, mesh, cfg.num_heads)
        c, group = DotDict(cfg, sharding=sh), sh.tp_group
    trainer = DiffusionTrainer(model, make_teacher_forcing_loss_fn(
        c, sch, fm, num_frame_per_block=3, noise_aug_max_timestep=100,
        compute_dtype=dtype), learning_rate=1e-5, tp_group=group)
    draws = draw_teacher_forcing(
        torch.Generator(device=dev).manual_seed(3), batch["latents"].shape,
        3, len(sch.timesteps), 100, dev)
    _reset_counts()
    loss, seconds, _, peak = _run_counted(
        lambda: trainer.train_step(batch, draws))
    out = {"loss": loss.item(), "norm": trainer.grad_norm.item(),
           "seconds": seconds, "peak_gib": peak, "launches": _counts()}
    named = dict(model.named_parameters())
    out["grads"] = {n: gather_tp(n, p.grad.detach(), group)
                    for n, p in named.items()}
    out["params"] = {n: gather_tp(n, p.detach(), group)
                     for n, p in named.items()}
    del model, trainer, named, batch, draws
    torch.cuda.empty_cache()
    return out


def _step_distance(a: dict, b: dict) -> dict:
    """How far step a is from step b: the loss's and the gradient norm's
    relative errors, the largest gradient and parameter differences."""
    grad = {n: (g - b["grads"][n]).abs().max().item()
            for n, g in a["grads"].items()}
    worst = max(grad, key=grad.get)
    return {"loss_rel_err": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_norm_rel_err": abs(a["norm"] - b["norm"]) / b["norm"],
            "grad_max_abs_err": grad[worst], "grad_max_abs_err_at": worst,
            "params_max_abs_err": max(
                (p - b["params"][n]).abs().max().item()
                for n, p in a["params"].items())}


def _rank_tp_train(rank: int, world: int) -> dict:
    """Teacher-forcing steps of the 1.3B width (TP_LAYERS layers, 65,520
    tokens): unsharded and over tp = `world`, with the trunk in bf16 (the
    training path) and in fp32.  In fp32 the tp step is held to the
    unsharded one at train_mesh's tolerances; in bf16 tp rounds
    differently (each rank's row-parallel partial product is rounded to
    bf16 before the sum; the QK-norms sum their squares in another
    order), so the bf16 tp step's distance from the unsharded bf16 step
    is set beside the unsharded bf16 step's own distance from the fp32
    one.  Then `train --smoke --steps 1 --mesh tp=<world>` on this
    group."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.parallel.mesh import make_mesh
    cfg = _cfg13(TP_LAYERS)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"tp": world})
    steps = {(dtype, tp): _tp_step(cfg, dev, mesh if tp else None, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for tp in (False, True)}
    keep = ("loss", "norm", "seconds", "peak_gib", "launches")
    name = lambda dtype, tp: (f"{str(dtype).replace('torch.', '')}"
                              f"{'_tp' if tp else ''}")
    res = {"layers": TP_LAYERS, "tp": world,
           "local_heads": cfg.num_heads // world,
           "steps": {name(*k): {f: v[f] for f in keep}
                     for k, v in steps.items()},
           "bf16_tp": _step_distance(steps[(torch.bfloat16, True)],
                                     steps[(torch.bfloat16, False)]),
           "fp32_tp": _step_distance(steps[(torch.float32, True)],
                                     steps[(torch.float32, False)]),
           "bf16_vs_fp32": _step_distance(steps[(torch.bfloat16, False)],
                                          steps[(torch.float32, False)])}
    del steps
    torch.cuda.empty_cache()
    log_dir = os.path.join(OUT_DIR, f"tp_train_rank{rank}")
    try:
        _reset_counts()
        rc = train.main(["--smoke", "--steps", "1", "--mesh", f"tp={world}",
                         "--log-dir", log_dir, "--run-name", "tp"])
        torch.cuda.synchronize()
        res.update(cli_rc=rc, cli_launches=_counts(),
                   cli_expected=_train_launches(
                       tiny_test_config().num_layers, 1))
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return res


def _stage_inputs(cfg, dev):
    """The chunk_pipeline phase's model, VAE, contexts and noises, from the
    same seeds."""
    g = lambda s: torch.Generator(device=dev).manual_seed(s)
    model = _model13(cfg, 0, torch.bfloat16)
    vae_m = vae.init_vae_params(g(1), torch.float32, dev)
    cond, uncond = cli.random_text_context(cfg, dev)
    gen = g(200)
    noises = [torch.randn((1, 21, 16, 60, 104), generator=gen, device=dev)
              for _ in range(CHUNKS)]
    return model, vae_m, cond, uncond, noises


def _rank_stage_meshes(rank: int, world: int, steps: int = 4) -> dict:
    """`ChunkParallelPipeline(stage_meshes=...)`: `world` stages of one
    rank each, the 1.3B window model at full width and depth, `steps`
    UniPC steps, CHUNKS chunks, the anchors handed from process to
    process; this process's chunks (on the host), its log with the host
    clock of each chunk's anchors arriving and its last group done, its
    launches and peak."""
    from mmpl_tpu_torch.parallel.chunk_pipeline import ChunkParallelPipeline
    from mmpl_tpu_torch.parallel.mesh import make_stage_meshes
    cfg = WAN_CONFIGS["t2v-1.3B"]
    dev = torch.device("cuda", torch.cuda.current_device())
    model, vae_m, cond, uncond, noises = _stage_inputs(cfg, dev)
    pipe = ChunkParallelPipeline(cfg, model, vae_m,
                                 stage_meshes=make_stage_meshes(world),
                                 sampling_steps=steps, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    chunks, seconds, counts, peak = _run_counted(
        lambda: pipe.generate(noises, cond, uncond, seed=5))
    return {"stage": pipe.stage_index, "wall_s": seconds,
            "launches": counts, "peak_gib": peak,
            "chunks": {i: c.cpu() for i, c in enumerate(chunks)
                       if c is not None},
            "log": [{k: e[k] for k in ("chunk", "stage", "dispatch_start",
                                       "dispatch_end", "received", "done")
                     if k in e} for e in pipe.dispatch_log],
            "timeline": pipe.device_timeline()}


#: the cases a rank of `_run_ranks` runs, by name
RANK_CASES = {"mesh_int8": _rank_mesh_int8, "mesh_tp_train": _rank_tp_train,
              "stage_meshes": _rank_stage_meshes}


def _rank_entry(rank: int, world: int, port: int, cases, results) -> None:
    """One rank of a gloo group on this card: each case of RANK_CASES in
    turn, its result (or the traceback of its failure) put on
    `results`."""
    import traceback
    import torch.distributed as dist
    from mmpl_tpu_torch.parallel.mesh import init_distributed
    try:
        set_float32_precision()
        os.environ["MMPL_DIST_BACKEND"] = "gloo"
        init_distributed(f"127.0.0.1:{port}", world, rank)
        for case in cases:
            results.put((rank, case, RANK_CASES[case](rank, world), None))
            dist.barrier()
            torch.cuda.empty_cache()
    except Exception:      # reported to the parent, which fails the run
        results.put((rank, None, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(cases, world: int = 2, limit: float = RANKS_LIMIT) -> dict:
    """Spawn `world` processes (torch.multiprocessing), ranks of a gloo
    group on a localhost rendezvous, all on this card, each running
    `cases` in turn; {case: [result of rank 0, ...]}.  Fails if a rank
    fails, exits non-zero or is still running after `limit` seconds;
    every process is stopped before this returns."""
    import queue
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, port, list(cases), results))
             for r in range(world)]
    out = {c: [None] * world for c in cases}
    deadline = time.monotonic() + limit
    for p in procs:
        p.start()
    try:
        pending = world * len(cases)
        while pending:
            left = deadline - time.monotonic()
            check(left > 0, f"ranks still running after {limit} s")
            try:
                rank, case, res, err = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                check(all(p.is_alive() or p.exitcode == 0 for p in procs),
                      [p.exitcode for p in procs])
                continue
            check(err is None, f"rank {rank}: {err}")
            out[case][rank] = res
            pending -= 1
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        check([p.exitcode for p in procs] == [0] * world,
              [p.exitcode for p in procs])
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return out


def _q_launches(L: int, split_cache: bool) -> dict:
    """Q's and P2's launches of one W8A8 forward of L layers: six
    projections a layer, over tp the three row-parallel ones (o, the
    cross-attention o, fc2) taking Q's amax and given-scale modes; with
    the cache written, its K and V each coded a layer (split over tp)."""
    n = {"int8_gemm": 6 * L, "q_codes": 3 * L, "q_amax": 3 * L,
         "q_scaled": 3 * L}
    if not split_cache:
        return n
    return {**n, "q_amax": 5 * L, "q_scaled": 5 * L}


def phase_mesh_ranks(one_process_chunks):
    """The two-rank phases, in one spawn: mesh_int8 (tp 2, W8A8 and the
    int8 cache against the unsharded forward; accumulators, codes and
    scales bit for bit), mesh_tp_train (tp 2 teacher forcing at 65,520
    tokens against the unsharded step: fp32 at train_mesh's tolerances,
    bf16 within bf16's own distance from fp32; K4-K6 at 6 heads; the
    CLI's --mesh tp=2), stage_meshes (two processes a
    stage each, the 1.3B model at full width and depth, 4 steps, 3
    chunks, bit for bit against the chunk_pipeline phase's one-process
    run).  Returns the launches by path."""
    t0 = time.perf_counter()
    res = _run_ranks(list(RANK_CASES))
    spawn_s = time.perf_counter() - t0
    L = TP_LAYERS
    # mesh_int8
    transport = ("gloo on one card: collectives on the device tensors, no "
                 "point-to-point move")
    emit({"phase": "mesh_int8", "transport": transport,
          "ranks": res["mesh_int8"]})
    emit({"phase": "mesh_tp_train", "transport": transport,
          "ranks": res["mesh_tp_train"]})
    # the unsharded steps at full width: fp32 runs K4-K6 on the split-TF32
    # bodies, bf16 on the Hopper bodies; both ranks run theirs at once on
    # the one card
    unsharded = {dt: [r["steps"][dt] for r in res["mesh_tp_train"]]
                 for dt in ("float32", "bfloat16")}
    emit({"phase": "mesh_tp_train_steps", "layers": L, "tokens": 65520,
          "ranks_sharing_the_card": len(res["mesh_tp_train"]),
          "seconds": {dt: [x["seconds"] for x in v]
                      for dt, v in unsharded.items()},
          "flash_masked_bwd_dkv": {
              dt: [x["launches"]["flash_masked_bwd_dkv"] for x in v]
              for dt, v in unsharded.items()}})
    rows = res["stage_meshes"]
    got = {i: c for r in rows for i, c in r["chunks"].items()}
    logs = sorted((e for r in rows for e in r["log"]),
                  key=lambda e: e["chunk"])
    overlap = [{"chunks": [a["chunk"], b["chunk"]],
                "received": b["received"] - logs[0]["dispatch_start"],
                "previous_done": a["done"] - logs[0]["dispatch_start"],
                "overlap_s": a["done"] - b["received"]}
               for a, b in zip(logs, logs[1:])]
    same = sorted(got) == list(range(CHUNKS))
    srow = {"phase": "stage_meshes", "stages": 2, "chunks": CHUNKS,
            "transport": "gloo on one card: the anchors through host "
                         "memory (a thread copies and sends them)",
            "stage_of_chunk": [e["stage"] for e in logs],
            "wall_s": [r["wall_s"] for r in rows],
            "peak_gib": [r["peak_gib"] for r in rows],
            "launches": [r["launches"]["flash_fwd"] for r in rows],
            "overlap": overlap, "timeline": [r["timeline"] for r in rows],
            "bit_equal": same and all(
                torch.equal(got[i], one_process_chunks[i])
                for i in range(CHUNKS)),
            "max_abs_diff": [(got[i] - one_process_chunks[i]).abs().max()
                             .item() for i in range(CHUNKS)] if same
            else None, "spawn_s": spawn_s}
    emit(srow)
    for r in res["mesh_int8"]:
        check(r["fc2_acc_equal"] and r["fc2_codes_equal"]
              and r["fc2_scales_equal"] and r["cache_codes_equal"]
              and r["cache_scales_equal"], r)
        check(r["fc2_out_max_ulps"] <= 1, r)
        # quant_parity's card-against-CPU gate for an int8 window, and tp
        # moving the int8 forward no farther than it moves the bf16 one
        check(r["flow_finite"] and r["flow_rel_err"] <= 1e-2
              and r["flow_rel_err"] <= r["bf16_flow_tp_rel_err"], r)
        for p, split in (("solver", False), ("commit", True)):
            got = r["launches"][p]
            want = {**_q_launches(L, split), "flash_fwd": 2 * L}
            want["quantize_rows"] = (want["q_codes"] + want["q_amax"]
                                     + want["q_scaled"])
            check({k: got[k] for k in want} == want, (p, got, want))
    want = _train_launches(L, 1)
    for r in res["mesh_tp_train"]:
        # fp32: train_mesh's tolerances (loss rtol 1e-5, gradients atol
        # 1e-4, one AdamW step moves a weight by at most lr = 1e-5 either
        # way)
        f, b, noise = r["fp32_tp"], r["bf16_tp"], r["bf16_vs_fp32"]
        check(f["loss_rel_err"] <= 1e-5 and f["grad_norm_rel_err"] <= 1e-5
              and f["grad_max_abs_err"] <= 1e-4
              and f["params_max_abs_err"] <= 2e-5, r)
        # bf16: the loss at train_mesh's tolerance, the gradients no
        # farther from the unsharded bf16 step than bf16 itself is from fp32
        check(b["loss_rel_err"] <= 1e-5 and b["params_max_abs_err"] <= 2e-5
              and b["grad_max_abs_err"] <= noise["grad_max_abs_err"]
              and b["grad_norm_rel_err"] <= noise["grad_norm_rel_err"], r)
        for s in r["steps"].values():
            check({k: s["launches"][k] for k in want} == want, r)
        check(r["cli_rc"] == 0 and {k: r["cli_launches"][k] for k in
                                    r["cli_expected"]} == r["cli_expected"],
              r)
    check(same, srow)
    check(srow["stage_of_chunk"] == [i % 2 for i in range(CHUNKS)], srow)
    check(srow["bit_equal"], srow)
    check(sum(srow["launches"]) == 2 * WAN_CONFIGS["t2v-1.3B"].num_layers
          * _chunk_forwards(4, CHUNKS), srow)
    paths = {
        "mesh_int8": {k: sum(r["launches"][p][k] + r["launches_single"][p][k]
                             for r in res["mesh_int8"]
                             for p in ("solver", "commit"))
                      for k in ("flash_fwd", "int8_gemm", "quantize_rows",
                                "q_codes", "q_amax", "q_scaled")},
        "mesh_tp_train": {k: sum(sum(s["launches"][k]
                                     for s in r["steps"].values())
                                 + r["cli_launches"][k]
                                 for r in res["mesh_tp_train"])
                          for k in attn.launch_counts},
        "stage_meshes": sum(srow["launches"])}
    return paths


def phase_generate_parallel_ranks():
    """`python -m mmpl_tpu_torch.generate_parallel` over 2 processes on a
    gloo group (MMPL_DIST_BACKEND=gloo: the ranks share this card), smoke
    mode, 2 chunks: a stage each, each process writing its own chunk's
    file; the files against the one process's run of the same command,
    byte for byte."""
    out_dir = os.path.join(OUT_DIR, "generate_parallel_ranks")
    one_dir = os.path.join(OUT_DIR, "generate_parallel_one")
    argv = [sys.executable, "-m", "mmpl_tpu_torch.generate_parallel",
            "--num-chunks", "2", "--sampling-steps", "4"]
    env = {**os.environ, "MMPL_DIST_BACKEND": "gloo"}
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        argv + ["--output-dir", out_dir, "--coordinator",
                f"127.0.0.1:{port}", "--num-processes", "2",
                "--process-id", str(r)], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    seconds = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    try:
        one = subprocess.run(argv + ["--output-dir", one_dir], cwd=ROOT,
                             capture_output=True, text=True, timeout=240)
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        want = sorted(os.listdir(one_dir)) if os.path.isdir(one_dir) else []
        same = files == want and all(
            open(os.path.join(out_dir, f), "rb").read()
            == open(os.path.join(one_dir, f), "rb").read() for f in files)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(one_dir, ignore_errors=True)
    row = {"phase": "generate_parallel_ranks", "rcs": rcs,
           "one_process_rc": one.returncode, "seconds": seconds,
           "files": files, "files_equal": same,
           "stderr_tail": [e[-400:] for e in errs]}
    emit(row)
    check(rcs == [0, 0] and one.returncode == 0 and len(files) == 2
          and same, row)


def _entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
           bound_ms, bound_by, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def kernels_line(smi, rows, bwd, masked, int8, window_launches,
                 int8_launches, train_counts, exp2, exp2_launches,
                 path_launches, bwd_paths, int8_paths, q_modes):
    """The nine kernels at their main-path shapes: K1 at group 3 of the
    serving window (and under its persistent walk at the window's text
    cross-attention and its key split at the GAN head's register token,
    `flash_fwd_persistent` and `flash_fwd_split`, their launches those of
    the window and of the GAN steps), K2 / K3 at the training
    cross-attention (and their
    other shapes under `shapes`; K3's persistent walk there and the fused
    walk of K2 and K3 with its dQ reduce at the GAN head's register token,
    `flash_bwd_dq_persistent` and `flash_bwd_fused`, their launches those
    of the teacher-forcing steps and of the GAN steps; the ordered walk of
    K2 and K3 with its dQ out kernel at the critic's self-attention,
    `flash_bwd_ordered`, its launches those of the flow and DMD steps and
    the ring's backward), K4-K6 at the
    training self-attention, P2 at group 3's ffn.fc1, Q at group 3's
    ffn.fc2 input and P1 (its exp2 variant without the pad test) at the
    probe's shape.  `launches` sums the paths each runs on (the training
    kernels': the train phase's timed steps and train_resume's resumed
    step); `path_launches` holds K1's on the few-step, real-file CLI, i2v,
    resumed-training, whole-clip and CLIP paths, and on the distillation
    slice's paths (the causal-diffusion and bidirectional pipelines, the
    DPM window, the flow and distillation steps, the trainer's CLI);
    `bwd_paths` K2's and K3's on the flow and distillation paths (and
    tp training's), `int8_paths` P2's and Q's on the int8
    causal-diffusion run and the tp-2 int8 forwards, and `q_modes` Q's
    amax and given-scale modes at the tp shapes (`modes` of Q's entry:
    the same kernel, its launches counted with Q's)."""
    fwd_src = "mmpl_tpu_torch/csrc/flash_fwd.cu"
    sm90_src = "mmpl_tpu_torch/csrc/flash_fwd_sm90.cuh"
    bwd_src = "mmpl_tpu_torch/csrc/flash_bwd.cu"
    bodies = ("wgmma + TMA body (flash_fwd_sm90.cuh) for bf16 / fp16, "
              "the split-TF32 wgmma body (flash_fwd_f32_sm90.cuh) for fp32; "
              "entry in flash_fwd.cu")
    exp2_bodies = ("wgmma + TMA body (flash_fwd_sm90.cuh) for bf16 / fp16, "
                   "K1's split-TF32 wgmma body (flash_fwd_f32_sm90.cuh) "
                   "for fp32; entry in flash_fwd.cu")
    k1 = rows[MAIN_SHAPE]
    b, m = bwd[BWD_MAIN], masked[MASKED_MAIN]
    grad_err = lambda rs, parts: max(r[f"{p}_max_abs_err"]
                                     for r in rs.values() for p in parts)
    bwd_note = ("plain_ms and library_ms compute dq, dk and dv in one call "
                "(flash_attention_bwd_plain; SDPA's backward)")
    f32_src = "mmpl_tpu_torch/csrc/flash_fwd_f32_sm90.cuh"
    out = [_entry(
        "flash_fwd", sm90_src, "mmpl_tpu/ops/attention.py:324",
        window_launches + int8_launches["flash_fwd"]
        + train_counts["flash_fwd"] + sum(
            n for p, n in path_launches.items() if p != "train_resume"),
        max(r["o_max_abs_err"] for r in rows.values()), k1["ms"],
        k1["plain_ms"], k1["bound_ms"], k1["bound_by"], k1["library_ms"],
        at=MAIN_SHAPE, bodies=bodies, bound_share=k1["bound_share"],
        sources=[sm90_src, f32_src, fwd_src],
        launches_by_path={
            "window": window_launches,
            "window_int8": int8_launches["flash_fwd"],
            "train": (train_counts["flash_fwd"]
                      - path_launches.get("train_resume", 0)),
            **path_launches},
        shapes={k: {f: r[f] for f in (
            "body", "mode", "splits", "ms", "device_ms", "plain_ms",
            "bound_ms", "library_ms", "library_device_ms", "o_max_abs_err")}
                for k, r in rows.items()})]
    # K1's other schedules, each at its main shape: the persistent walk at
    # the serving window's text cross-attention, the key split (with its
    # merge) at the GAN head's register token
    sched_src = "mmpl_tpu_torch/csrc/flash_fwd_sched_sm90.cuh"
    for name, mode, at, paths in (
            ("flash_fwd_persistent", "persistent", "cross", ("window",)),
            ("flash_fwd_split", "split", "gan_head_q1",
             ("gan_critic", "gan_generator"))):
        r = rows[at]
        by_path = {p: FWD_MODES_BY_PATH[p][mode] for p in paths}
        out.append(_entry(
            name, sched_src, "mmpl_tpu/ops/attention.py:324",
            sum(by_path.values()),
            max(x["o_max_abs_err"] for x in rows.values()
                if x["mode"] == mode),
            r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
            r["library_ms"], at=at, sources=[sched_src, fwd_src],
            device_ms=r["device_ms"],
            library_device_ms=r["library_device_ms"],
            launches_by_path=by_path,
            kernels=([f"{name}_sm90_kernel"] + (
                ["flash_fwd_merge_kernel"] if mode == "split" else [])),
            note=("K1 (launch counter flash_fwd) under ops/attention."
                  "fwd_schedule's schedule; ms is a call after a "
                  "synchronise, the wrapper's host time included, "
                  "device_ms the call's device time"),
            shapes={k: {f: x[f] for f in ("splits", "ms", "device_ms",
                                          "bound_ms", "library_ms",
                                          "library_device_ms")}
                    for k, x in rows.items() if x["mode"] == mode}))
    bwd_sm90_src = "mmpl_tpu_torch/csrc/flash_bwd_sm90.cuh"
    bwd_f32_src = "mmpl_tpu_torch/csrc/flash_bwd_f32_sm90.cuh"
    bwd_dq_f32_src = "mmpl_tpu_torch/csrc/flash_bwd_dq_f32_sm90.cuh"
    bwd_bodies = {
        "dkv": ("wgmma + TMA body (flash_bwd_sm90.cuh, with its query "
                "split and reduce) for bf16 / fp16, the split-TF32 wgmma "
                "body (flash_bwd_f32_sm90.cuh) for fp32; entry in "
                "flash_bwd.cu", [bwd_sm90_src, bwd_f32_src, bwd_src]),
        "dq": ("wgmma + TMA body (flash_bwd_sm90.cuh) for bf16 / fp16, the "
               "split-TF32 wgmma body (flash_bwd_dq_f32_sm90.cuh) for fp32; "
               "entry in flash_bwd.cu",
               [bwd_sm90_src, bwd_dq_f32_src, bwd_src]),
    }
    for name, part, line in (("flash_bwd_dkv", "dkv", 373),
                             ("flash_bwd_dq", "dq", 417)):
        out.append(_entry(
            name, bwd_sm90_src, f"mmpl_tpu/ops/attention.py:{line}",
            train_counts[name] + sum(c[name] for c in bwd_paths.values()),
            grad_err(bwd, ("dk", "dv") if part == "dkv" else ("dq",)),
            b[f"{part}_ms"], b["plain_ms"], b[f"{part}_bound_ms"],
            b[f"{part}_bound_by"], b.get("library_bwd_ms"), at=BWD_MAIN,
            sources=bwd_bodies[part][1], bodies=bwd_bodies[part][0],
            bound_share=b[f"{part}_bound_share"], note=bwd_note,
            launches_by_path={"train": train_counts[name],
                              **{p: c[name] for p, c in bwd_paths.items()}},
            shapes={k: {"body": r[f"{part}_body"], "splits": r["splits"],
                        "mode": r["mode"], "ms": r[f"{part}_ms"],
                        "bound_ms": r[f"{part}_bound_ms"],
                        "bound_share": r[f"{part}_bound_share"],
                        "plain_ms": r["plain_ms"],
                        "library_ms": r.get("library_bwd_ms")}
                    for k, r in bwd.items()}))
    # K2 and K3's other schedules, each at its main shape: K3's persistent
    # walk at the teacher-forcing cross-attention (K3 alone), the fused
    # walk with its dQ reduce at the GAN head's register token and the
    # ordered walk with its dQ out kernel at the flow and critic
    # self-attention (the whole backward, one call)
    bwd_sched_src = "mmpl_tpu_torch/csrc/flash_bwd_sched_sm90.cuh"
    for name, mode, at, paths, part, replaces, kernels in (
            ("flash_bwd_dq_persistent", "persistent", BWD_MAIN, ("train",),
             "dq", "mmpl_tpu/ops/attention.py:417",
             ["flash_bwd_dq_persistent_sm90_kernel"]),
            ("flash_bwd_fused", "fused", "gan_head_q1",
             ("gan_critic", "gan_generator"), "bwd",
             "mmpl_tpu/ops/attention.py:373 and :417 (K2 and K3 where the "
             "queries fit one 64-row tile)",
             ["flash_bwd_fused_sm90_kernel", "flash_bwd_dq_reduce_kernel"]),
            ("flash_bwd_ordered", "ordered", "critic_self",
             ("train_flow", "distill_dmd", "ring"), "bwd",
             "mmpl_tpu/ops/attention.py:373 and :417 (K2 and K3 at long "
             "keys)",
             ["flash_bwd_ordered_sm90_kernel",
              "flash_bwd_ordered_out_kernel"])):
        r = bwd[at]
        check(r["mode"] == mode, (name, r["mode"]))
        by_path = {p: BWD_MODES_BY_PATH[p][mode] for p in paths}
        errs = ("dq",) if part == "dq" else ("dq", "dk", "dv")
        out.append(_entry(
            name, bwd_sched_src, replaces, sum(by_path.values()),
            max(x[f"{'bwd_' if part == 'bwd' else ''}{e}_max_abs_err"]
                for x in bwd.values() if x["mode"] == mode for e in errs),
            r[f"{part}_ms"], r["plain_ms"], r[f"{part}_bound_ms"],
            r[f"{part}_bound_by"], r.get("library_bwd_ms"), at=at,
            sources=[bwd_sched_src, bwd_sm90_src, bwd_src],
            bound_share=r[f"{part}_bound_share"],
            bwd_ms=r["bwd_ms"], bwd_device_ms=r["bwd_device_ms"],
            library_device_ms=r.get("library_bwd_device_ms"),
            launches_by_path=by_path, kernels=kernels,
            note=(("K3 alone (launch counter flash_bwd_dq) on its "
                   "persistent walk" if part == "dq" else
                   "K2 and K3 in one call (one launch of each counter): the "
                   + ("fused walk and its dQ reduce" if mode == "fused" else
                      "ordered walk (dQ's shares added in key-block order) "
                      "and its dQ out kernel"))
                  + "; ms is a call after a synchronise, the wrapper's host "
                  "time included; bwd_device_ms the whole backward's device "
                  "time beside SDPA's (library_device_ms); " + bwd_note),
            shapes={k: {f: x.get(f) for f in (
                "mode", "bwd_ms", "bwd_device_ms", "dq_ms", "bwd_bound_ms",
                "library_bwd_ms", "library_bwd_device_ms", "repeat_equal")}
                    for k, x in bwd.items() if x["mode"] == mode}))
    masked_bodies = {
        "fwd": ("K1's wgmma + TMA body, masked (flash_fwd_sm90.cuh) for "
                "bf16 / fp16 over the 128 x 128 table, K1's split-TF32 "
                "wgmma body, masked (flash_fwd_f32_sm90.cuh), for fp32 over "
                "the 64 x 64 table; entry in flash_fwd.cu",
                sm90_src, [sm90_src, f32_src, fwd_src]),
        "dkv": ("K2's wgmma + TMA dKV body, masked, never split "
                "(flash_bwd_sm90.cuh) for bf16 / fp16 over the 64 x 128 "
                "table, K2's split-TF32 wgmma body, masked "
                "(flash_bwd_f32_sm90.cuh), for fp32 over the 64 x 64 "
                "table; entry in flash_bwd.cu", bwd_sm90_src,
                [bwd_sm90_src, bwd_f32_src, bwd_src]),
        "dq": ("K3's wgmma + TMA dQ body, masked (flash_bwd_sm90.cuh) for "
               "bf16 / fp16 over the 128 x 128 table, K3's split-TF32 wgmma "
               "body, masked (flash_bwd_dq_f32_sm90.cuh), for fp32 over the "
               "64 x 64 table; entry in flash_bwd.cu", bwd_sm90_src,
               [bwd_sm90_src, bwd_dq_f32_src, bwd_src]),
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
        modes={f"{mode}/{k}": {
            "ms": r[f"{mode}_ms"], "plain_ms": r[f"{mode}_plain_ms"],
            "bound_ms": r[f"{mode}_bound_ms"], "bound_by": "bytes",
            "bound_share": r[f"{mode}_bound_share"],
            "body": r[f"{mode}_body"],
            "library_ms": r[f"{mode}_library_ms"],
            "exact": r["amax_equal"] and r["codes_equal"]
            and r["scales_equal"] and r["split_equal"]}
            for k, r in q_modes.items() for mode in ("amax", "scaled")},
        mode_launches={m: sum(c.get(f"q_{m}", 0)
                              for c in int8_paths.values())
                       for m in ("amax", "scaled")},
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
        sources=[sm90_src, f32_src, fwd_src],
        bodies=exp2_bodies, bound_share=p1["bound_share"],
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
    q_modes = phase_kernel_q_modes()
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
        # the training data path: raw clips to shards on the card (the
        # ckpt phase's VAE and umT5 files), ODE trajectories from the 1.3B
        # teacher, the trainer on both; the shards stay for the mesh phase
        shards = phase_data(wan)
    finally:
        shutil.rmtree(os.path.dirname(pt), ignore_errors=True)
    ode_dir, path_launches["ode_gen"] = phase_ode_gen(shards)
    bwd_paths = {"train_data": phase_train_data(shards, ode_dir),
                 "train_data_resume": phase_train_data_resume(shards)}
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
    bwd_paths["train_flow"], _ = phase_train_flow()
    torch.cuda.empty_cache()
    bwd_paths["distill_dmd"], bundle = phase_distill_dmd()
    torch.cuda.empty_cache()
    # host offload: DMD on distill_dmd's bundle, then teacher forcing
    bwd_paths["offload"] = phase_offload(bundle)
    del bundle
    torch.cuda.empty_cache()
    bwd_paths["distill_other"] = phase_distill_other()
    torch.cuda.empty_cache()
    bwd_paths["distill_rolling"] = phase_distill_rolling()
    torch.cuda.empty_cache()
    bwd_paths["train_distill_cli"] = phase_train_distill_cli()
    phase_distill_parity()
    # multi-device and serving: stages as streams of this card, the
    # in-process group for the ring and USP, NCCL at world size 1
    path_launches["chunk_pipeline"], one_stage = phase_chunk_pipeline()
    path_launches["generate_parallel"] = phase_generate_parallel()
    path_launches["serving"] = phase_serving()
    bwd_paths["ring"] = phase_ring()
    path_launches["usp"] = phase_usp()
    bwd_paths["mesh"] = phase_mesh(shards)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    # what the mesh refused until now, two ranks on this card over gloo:
    # int8 over tp, tp in training, stages as processes
    torch.cuda.empty_cache()
    ranks = phase_mesh_ranks(one_stage)
    del one_stage
    path_launches["stage_meshes"] = ranks["stage_meshes"]
    bwd_paths["mesh_tp_train"] = ranks["mesh_tp_train"]
    int8_tp = ranks["mesh_int8"]
    path_launches["mesh_int8"] = int8_tp["flash_fwd"]
    phase_generate_parallel_ranks()
    for p, c in bwd_paths.items():
        path_launches[p] = c["flash_fwd"]
    # the masked kernels' rows count training steps: train --mesh's and
    # the data path's too
    train_counts = {k: v + (sum(bwd_paths[p][k] for p in (
        "mesh", "train_data", "train_data_resume", "mesh_tp_train",
        "offload"))
        if "masked" in k else 0) for k, v in train_counts.items()}
    emit(kernels_line(smi, rows, bwd, masked, int8, window_launches,
                      int8_launches, train_counts, exp2, exp2_launches,
                      path_launches, bwd_paths,
                      {"causal_diffusion_int8": int8_cd,
                       "mesh_int8": int8_tp}, q_modes))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
