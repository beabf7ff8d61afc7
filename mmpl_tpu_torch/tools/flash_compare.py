"""K1, K2 and K3, K4-K6, P1, or P2 and Q, of this tree against another
checkout's, on one card, in turns.

    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel bwd
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel masked
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel exp2
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel int8
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --dtype float32
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel bwd \
        --dtype float32
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR \
        --kernel masked --dtype float32
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR \
        --kernel masked --dtype float16
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel bwd \
        --dtype float16
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR \
        --kernel exp2 --dtype float32

DIR holds another checkout of the repository (for example an earlier
commit unpacked with `git archive`).  Its `mmpl_tpu_torch/csrc/flash_fwd.cu`
(`--kernel fwd`, the default) or `flash_bwd.cu` (`--kernel bwd`) is built
with this tree's nvcc flags into
`build/kernels/baseline-<source>-<hash>.so` and bound by the sources it
has: a baseline without `flash_fwd_sm90.cuh` takes
K1's natural scale, a newer one the scale with log2(e) folded in; a
baseline without `flash_bwd_sm90.cuh` has the dKV entry without the
workspace and the query split (`OLD_DKV_SIGNATURE`), a newer one is given
this tree's split.  At each shape both trees' kernels run on the same bf16
inputs in the order baseline, this tree, this tree, baseline, both through
the same ctypes call of their C entries (`call_k1`, `call_bwd`; not the
wrapper, whose checks would add host time inside this tree's turns); each
time is the median of CUDA events over `--reps` calls after one warm-up
call.  Each
shape prints one JSON line: the four times (per kernel for the backward),
both trees' distance from the plain version, SDPA's time on the same inputs
(its backward for `bwd`; a yardstick the port never calls) and the card's
bound.  The card's name and power limit come first; for `fwd` a last line
says whether each Hopper kernel (`*_sm90_kernel`) compiled to the same
SASS in both trees (`cuobjdump -sass`).

For bf16 K1 (`--kernel fwd`) this tree runs its scheduled entry
(`call_sched`, `mmpl_flash_fwd_sched`) under `ops.attention.fwd_schedule`'s
schedule, which each row names (`mode`, `splits`); a baseline with that
entry runs it under the same schedule, an earlier one its
`mmpl_flash_fwd` (one block per 128-query block).  Each row adds the same
turns by device time (`device`: `utils.profiling.queued_ms`, calls queued
behind a spinning kernel, so the host's time around the launches is not
counted), SDPA's device time, and this tree's device time under every
schedule (`modes_ms`: the grid, the persistent walk and, where the chooser
splits the keys, its split, one fewer and twice as many and one), from
which the chooser's thresholds were read.  `SHAPES` holds the rows where
the parent trailed SDPA and the long rows whose time must hold.

For K2 and K3 (`--kernel bwd`) this tree runs its scheduled entry
(`call_bwd_sched`, `mmpl_flash_bwd_sched`) under
`ops.attention.bwd_schedule`'s mode, which each row names (`mode`): K2
alone on the grid against the baseline's K2, K3 alone (the grid or its
persistent walk) against the baseline's K3, and the whole backward in one
call (`bwd`: the fused walk and its reduce, or K2 then K3) against the
baseline's, each by wall and device time (`*_device`), beside
SDPA's backward by both (`sdpa_bwd_ms`, `sdpa_bwd_device_ms`) and this
tree's whole backward under every schedule by device time (`modes_ms`),
from which the chooser's thresholds were read, and the cost of the ordered
walk's ordering: its device time in turns against the same walk with the
counter waits cut out (`unordered_library`, a scratch variant built from
this tree's sources; `ordered_ms`, `unordered_ms`).  A baseline with the
scheduled entry runs it under the same modes (the grid where this tree
runs the ordered walk and the baseline has none); an earlier one runs its
`mmpl_flash_bwd_dkv` and `mmpl_flash_bwd_dq` (`call_bwd`), its whole
backward as the two calls.

`--dtype float32` (fwd and bwd) runs K1, or K2 and K3, on fp32 inputs at
`F32_SHAPES`, the fp32 trunk's attention in the trainer's ODE and
distillation objectives, and adds to each row the plain version's time
(`flash_attention_plain` / `flash_attention_bwd_plain`, few calls) and
SDPA's under the memory-efficient backend (the one that takes fp32); the
bound is then taken at the TF32 tensor-core rate (`PEAK_TF32`), the rate
the fp32 wgmma bodies run their products at.  With `--kernel masked` it
runs K4, K5 and K6 on fp32 inputs at `MASKED_SHAPES` the same way (the
masked plain versions' times, the bound at `PEAK_TF32`): the split-TF32
bodies' masked kernels against whatever bodies the baseline has (before
them, the FMA template).  `--dtype float16` takes `--kernel masked`
(the fp16 instantiations of the Hopper K4-K6) or `--kernel bwd` (fp16 K2
and K3 at `BWD_SHAPES` under their schedules).  `--kernel bwd`
ends, as `fwd` does, with the SASS check of its source, so the two fp32
calls show that the bf16 / fp16 Hopper kernels of K1-K6 and P1 are
unchanged.

`--kernel masked` builds the baseline's `flash_fwd.cu` and `flash_bwd.cu`
and times K4, K5 and K6 (`call_masked`) at `MASKED_SHAPES` (the
teacher-forcing self-attention under the fps-forcing mask) the same way,
with SDPA's forward and backward under the token mask (memory-efficient
backend, the one that takes a mask with a backward);
a baseline entry that takes no coarse tile table (K4 and K5 before their
Hopper bodies, K6 before its own; `OLD_MASKED_SIGNATURES`) gets the
64 x 64 table alone.  Both trees are held against the plain versions; the
last two lines say whether the Hopper kernels of each source compiled to
the same SASS in both trees (K1, P1, K2, K3 and those of K4-K6 that both
trees have; the others exist in one tree only).

`--kernel exp2` builds the baseline's `flash_fwd.cu` and times P1's four
variants (`call_exp2`, both trees bound by this tree's P1 signature, which
the trees since P1 have kept) at `EXP2_SHAPES` in bf16 or, with `--dtype
float32`, at `EXP2_F32_SHAPES` (fp32 at the tiny head dim and at K1's
ode_self_1 shape) the same way; a variant without the pad test runs only
where Lk is a multiple of 64.  Each row adds this tree's K1 and SDPA (its
default backend) on the same inputs, and in fp32 the plain version's time
(`flash_attention_exp2_plain`); the last line is `flash_fwd.cu`'s SASS
check.

`--kernel int8` builds the baseline's `int8_gemm.cu` (bound by the old
signatures, without P2's tile width and Q's layout, when it has no
`int8_gemm_sm90.cuh`) and times P2 (bf16 out) and Q at `INT8_SHAPES` the
same way, but by device time (`utils.profiling.queued_ms`: `--reps`
calls queued on the card behind a spinning kernel): a call of either
lasts little longer than the host's time around its launch.  Both trees'
outputs are held against the plain versions.  Its last lines say, for
`flash_fwd.cu` and `flash_bwd.cu`, whether K1, P1, K2 and K3 compiled to
the same SASS in both trees (the Hopper helpers that P2 shares live in
`sm90_common.cuh`).  It needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as attn
from ..ops import quant
from ..utils.profiling import queued_ms

#: (label, B, N, D, Lq, Lk) of K1 (chip_smoke.py K1_SHAPES): the serving
#: window's self-attention groups and its text cross-attention, the i2v
#: plan's group 0, the few-step steady state and its cross-attention, the
#: teacher-forcing cross-attention, WanI2V's self, text and image
#: attention and its CLIP tower, the bidirectional pipeline's, the
#: critic's and the causal-diffusion block's self-attention, and the GAN
#: head's one query row
SHAPES = {
    "group0_self": (2, 12, 128, 3120, 3120),
    "group1_self": (2, 12, 128, 10920, 14040),
    "group2_self": (2, 12, 128, 9360, 20280),
    "group3_self": (2, 12, 128, 9360, 32760),
    "i2v_group0_self": (2, 12, 128, 1560, 1560),
    "cross": (2, 12, 128, 9360, 512),
    "fewstep_self_hot": (1, 12, 128, 4680, 32760),
    "fewstep_cross": (1, 12, 128, 4680, 512),
    "tf_cross": (1, 12, 128, 65520, 512),
    "i2v14b_self": (2, 40, 128, 32760, 32760),
    "i2v14b_cross": (2, 40, 128, 32760, 512),
    "i2v14b_img": (2, 40, 128, 32760, 257),
    "clip_self": (1, 16, 80, 257, 257),
    "bidir_self": (2, 12, 128, 32760, 32760),
    "critic_self": (1, 12, 128, 32760, 32760),
    "cd_block_self": (2, 12, 128, 4680, 32760),
    "gan_head_q1": (2, 12, 128, 1, 32760),
}
#: K2 / K3: the teacher-forcing cross-attention and the few-step steady
#: state, the self-attention shape of self-forcing training, the critic's
#: and the flow objective's self-attention and text cross-attention, the
#: GAN head's one query row, chip_smoke.py's ragged shape and its tiny
#: head dim, a chunk of the ring backward (ring 4 over 2 x 32760 tokens),
#: and the ordered walk's edges: 7 key blocks (the first past K3's
#: persistent walk), and 8 and 4 heads over 4096 keys (a wave of the walk
#: holds 17 and 32 key blocks of a head)
BWD_SHAPES = {
    "tf_cross": (1, 12, 128, 65520, 512),
    "fewstep_self_hot": (1, 12, 128, 4680, 32760),
    "gan_head_q1": (2, 12, 128, 1, 32760),
    "score_cross": (1, 12, 128, 32760, 512),
    "critic_self": (1, 12, 128, 32760, 32760),
    "ragged": (2, 12, 128, 1000, 1300),
    "d24_bf16": (2, 4, 24, 1000, 1300),
    "ring_chunk": (2, 12, 128, 8190, 8190),
    "keys896": (2, 12, 128, 1000, 896),
    "heads8_4096": (1, 8, 128, 4096, 4096),
    "heads4_4096": (1, 4, 128, 4096, 4096),
}

#: P2 and Q: (M, K, N, activations quantised by Q): the serving window's
#: group-3 ffn.fc1 and ffn.fc2, group 0's o, and the VAE's 96-channel
#: im2col product of one 480x832 frame (codes made outside Q)
INT8_SHAPES = {
    "g23_fc1": (18720, 1536, 8960, True),
    "g23_fc2": (18720, 8960, 1536, True),
    "g0_o": (6240, 1536, 1536, True),
    "vae_96ch": (480 * 832, 96 * 27, 96, False),
}
#: K4-K6: (B, N, D, tokens a frame) under the fps-forcing mask of
#: T2V_CLEAN_STEPS over [clean | noisy] 2 x 21 frames: the 1.3B
#: teacher-forcing step's self-attention, 65520 tokens
MASKED_SHAPES = {
    "tf_self": (1, 12, 128, 1560),
}
#: P1: the JAX probe's shape and the few-step steady state (Lk ragged for
#: the 64-key tile: the variants without the pad test do not run), bf16
EXP2_SHAPES = {
    "probe": (2, 12, 128, 11264, 14336),
    "fewstep_hot": (1, 12, 128, 4680, 32760),
}
#: P1 in fp32: the tiny head dim (chip_smoke's d24_f32) and K1's ode_self_1
EXP2_F32_SHAPES = {
    "d24_f32": (2, 4, 24, 130, 192),
    "ode_self_1": (1, 12, 128, 4680, 4680),
}
#: P1's variants: (name, use_exp2, mask_pad)
EXP2_VARIANTS = (("exp+mask", False, True), ("exp", False, False),
                 ("exp2+mask", True, True), ("exp2", True, False))
#: K1, K2 and K3 in fp32, (B, N, D, Lq, Lk): the trainer's fp32 trunk (ODE
#: regression and the distillation objectives' rollouts and critics at the
#: 1.3B width, 21 latent frames at 60x104 in blocks of 3 frames): a block's
#: 4680 queries over 1, 4 and 7 blocks of keys, the critic's and the real
#: score's 32760^2, the text cross-attention, and the GAN head's register
#: token (the trainer builds the GAN objective in fp32)
F32_SHAPES = {
    "ode_self_1": (1, 12, 128, 4680, 4680),
    "ode_self_4": (1, 12, 128, 4680, 18720),
    "ode_self_7": (1, 12, 128, 4680, 32760),
    "critic_self": (1, 12, 128, 32760, 32760),
    "ode_cross": (1, 12, 128, 4680, 512),
    "gan_head_q1": (2, 12, 128, 1, 32760),
}
TABLES = {"fwd": SHAPES, "bwd": BWD_SHAPES, "masked": MASKED_SHAPES,
          "exp2": EXP2_SHAPES, "int8": INT8_SHAPES}
#: the tables of --dtype float32
F32_TABLES = {"fwd": F32_SHAPES, "bwd": F32_SHAPES, "masked": MASKED_SHAPES,
              "exp2": EXP2_F32_SHAPES}
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

#: H100 SXM dense bf16 and int8 tensor-core peaks and HBM rate (NVIDIA
#: data sheet)
PEAK_FLOPS = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
#: H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet): the rate of
#: the fp32 bodies' products (split TF32 reaches at most a third of it)
PEAK_TF32 = 495e12
#: timed calls of the plain versions in fp32 (a 32760^2 call takes
#: seconds)
PLAIN_REPS = 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the dKV entry of the trees before the Hopper backward body
OLD_DKV_SIGNATURE = [_I] + [_P] * 8 + [_I] * 5 + [_P, _F, _P]
#: the masked entries of the trees before the Hopper K4 and K5, or K6 (no
#: coarse tile table)
OLD_MASKED_SIGNATURES = {
    "mmpl_flash_masked_fwd": [_I] + [_P] * 9 + [_I] * 6
                             + [ctypes.c_longlong] * 12 + [_F, _P],
    "mmpl_flash_masked_bwd_dkv": [_I] + [_P] * 12 + [_I] * 6 + [_P, _F, _P],
    "mmpl_flash_masked_bwd_dq": [_I] + [_P] * 11 + [_I] * 6 + [_P, _F, _P],
}
#: the int8 entries of the trees before the Hopper P2 (no tile width, no
#: Q layout)
OLD_INT8_SIGNATURES = {
    "mmpl_int8_gemm": [_I] + [_P] * 5 + [_I] * 3 + [_P],
    "mmpl_quantize_rows": [_I, _P, _P, _P, _I, _I, _P],
}
#: the Hopper P2's entries before Q took a mode (its layout, not yet its
#: amax and given-scale modes)
HOPPER_INT8_SIGNATURES = {
    "mmpl_int8_gemm": [_I] + [_P] * 5 + [_I] * 4 + [_P],
    "mmpl_quantize_rows": [_I, _P, _P, _P, _I, _I, _I, _P],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="K1, K2 / K3, K4-K6, P1 or P2 / Q against another "
                    "checkout's")
    p.add_argument("--baseline", required=True, type=Path,
                   help="root of the other checkout")
    p.add_argument("--kernel", choices=sorted(TABLES), default="fwd",
                   help="fwd: K1; bwd: K2 and K3; masked: K4, K5 and K6; "
                        "exp2: P1; int8: P2 and Q")
    p.add_argument("--shapes", nargs="+", default=None,
                   choices=sorted({k for t in (*TABLES.values(),
                                               *F32_TABLES.values())
                                   for k in t}),
                   help="default: every shape of the kernel")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="float32: K1 or K2 / K3 at F32_SHAPES (fwd, bwd), "
                        "K4-K6 at MASKED_SHAPES (masked), P1 at "
                        "EXP2_F32_SHAPES (exp2)")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if args.dtype == "float32" and args.kernel not in F32_TABLES:
        p.error(f"--dtype float32 takes --kernel fwd, bwd, masked or exp2, "
                f"not {args.kernel}")
    if args.dtype == "float16" and args.kernel not in ("masked", "bwd"):
        p.error(f"--dtype float16 takes --kernel masked or bwd, not "
                f"{args.kernel}")
    table = (F32_TABLES if args.dtype == "float32" else TABLES)[args.kernel]
    if args.shapes is None:
        args.shapes = list(table)
    bad = [s for s in args.shapes if s not in table]
    if bad:
        p.error(f"--kernel {args.kernel} has no shape {bad}; "
                f"choose from {list(table)}")
    return args


def baseline_csrc(root: Path, source: str = "flash_fwd") -> Path:
    csrc = Path(root) / "mmpl_tpu_torch" / "csrc"
    if not (csrc / f"{source}.cu").exists():
        raise FileNotFoundError(f"no mmpl_tpu_torch/csrc/{source}.cu "
                                f"under {root}")
    return csrc


def baseline_takes_log2e(root: Path) -> bool:
    """Whether the baseline's K1 entry takes the scale with log2(e) folded
    in (the Hopper body's trees) or the natural one (earlier trees)."""
    return (baseline_csrc(root) / "flash_fwd_sm90.cuh").exists()


def baseline_schedules_k1(root: Path) -> bool:
    """Whether the baseline's `flash_fwd.cu` has K1's scheduled entry
    (`mmpl_flash_fwd_sched`: the persistent walk and the key split) or only
    `mmpl_flash_fwd` (earlier trees)."""
    src = (baseline_csrc(root) / "flash_fwd.cu").read_text()
    return re.search(r"mmpl_flash_fwd_sched\(", src) is not None


def baseline_schedules_bwd(root: Path) -> bool:
    """Whether the baseline's `flash_bwd.cu` has K2 and K3's scheduled
    entry (`mmpl_flash_bwd_sched`: the fused walk and K3's persistent
    walk) or only `mmpl_flash_bwd_dkv` and `mmpl_flash_bwd_dq` (earlier
    trees)."""
    src = (baseline_csrc(root, "flash_bwd") / "flash_bwd.cu").read_text()
    return re.search(r"mmpl_flash_bwd_sched\(", src) is not None


def baseline_orders_bwd(root: Path) -> bool:
    """Whether the baseline's scheduled entry has the ordered walk (mode
    3); a baseline without it runs the grid where this tree runs it."""
    src = baseline_csrc(root, "flash_bwd") / "flash_bwd_sched_sm90.cuh"
    return src.exists() and "launch_ordered" in src.read_text()


def unordered_library() -> ctypes.CDLL:
    """This tree's `flash_bwd.cu` with the ordered walk's counter waits
    cut out (`flash_bwd_sched_sm90.cuh`): each key block adds its share of
    dQ as soon as it is staged, in whatever order the blocks reach it.  A
    scratch variant built under `build/kernels/unordered-<hash>/` for the
    cost of the ordering alone (`unordered_ms`); its dQ is not the same on
    every call, and no path of the port runs it."""
    src = _build.CSRC / "flash_bwd_sched_sm90.cuh"
    text, cut = re.subn(
        r"\n *for \(int spins = 0; ld_acquire_gpu\(p\.cnt \+ blk\) != w\.kb; "
        r"\+\+spins\) \{\n.*?\n *\}\n", "\n", src.read_text(), flags=re.S)
    if cut != 1:
        raise RuntimeError("the ordered walk's counter wait was not found")
    digest = hashlib.sha256(text.encode() + " ".join(
        _build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"unordered-{digest}" / "flash_bwd.so"
    if not out.exists():
        csrc = out.parent / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.iterdir():
            if f.suffix in (".cu", ".cuh"):
                (csrc / f.name).write_bytes(f.read_bytes())
        (csrc / src.name).write_text(text)
        run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(out), str(csrc / "flash_bwd.cu")],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed for the unordered variant:\n"
                               f"{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mmpl_flash_bwd_sched.argtypes = \
        _build.SIGNATURES["flash_bwd"]["mmpl_flash_bwd_sched"]
    lib.mmpl_flash_bwd_sched.restype = ctypes.c_int
    return lib


def baseline_splits_queries(root: Path) -> bool:
    """Whether the baseline's dKV entry takes the workspace and the query
    split (the Hopper backward's trees) or not (earlier trees)."""
    return (baseline_csrc(root, "flash_bwd") / "flash_bwd_sm90.cuh").exists()


def baseline_takes_coarse_tables(root: Path, source: str = "flash_fwd",
                                  part: str = "dkv") -> bool:
    """Whether the baseline's masked entry of `source` (flash_fwd: K4;
    flash_bwd: K5, or K6 with `part` = "dq") takes the Hopper body's coarse
    tile table (or only the 64 x 64 one, as earlier trees)."""
    src = (baseline_csrc(root, source) / f"{source}.cu").read_text()
    entry = "fwd" if source == "flash_fwd" else f"bwd_{part}"
    return re.search(rf"mmpl_flash_masked_{entry}\([^)]*coarse",
                     src) is not None


def baseline_has_hopper_int8(root: Path) -> bool:
    """Whether the baseline's P2 is the Hopper body, whose entries take
    P2's tile width and Q's layout (or the earlier `mma.sync` one)."""
    return (baseline_csrc(root, "int8_gemm") / "int8_gemm_sm90.cuh").exists()


def baseline_q_takes_mode(root: Path) -> bool:
    """Whether the baseline's Q entry takes a mode (codes, amax, codes at
    a given scale), as this tree's does."""
    src = (baseline_csrc(root, "int8_gemm") / "int8_gemm.cu").read_text()
    return re.search(r"mmpl_quantize_rows\([^)]*int mode", src) is not None


def baseline_signatures(root: Path, source: str) -> dict:
    """The entries of the baseline's `source` that the comparison calls,
    with the C signatures its sources have."""
    sigs = _build.SIGNATURES[source]
    if source == "int8_gemm":
        if not baseline_has_hopper_int8(root):
            return dict(OLD_INT8_SIGNATURES)
        return dict(sigs) if baseline_q_takes_mode(root) else dict(
            HOPPER_INT8_SIGNATURES)
    masked = {n: (sigs[n] if baseline_takes_coarse_tables(
                      root, source, n.rsplit("_", 1)[-1])
                  else OLD_MASKED_SIGNATURES[n])
              for n in sigs if n.startswith("mmpl_flash_masked")}
    if source == "flash_fwd":
        sched = ({"mmpl_flash_fwd_sched": sigs["mmpl_flash_fwd_sched"]}
                 if baseline_schedules_k1(root) else {})
        return {"mmpl_flash_fwd": sigs["mmpl_flash_fwd"], **sched, **masked}
    sched = ({"mmpl_flash_bwd_sched": sigs["mmpl_flash_bwd_sched"]}
             if baseline_schedules_bwd(root) else {})
    return {"mmpl_flash_bwd_dkv": (sigs["mmpl_flash_bwd_dkv"]
                                   if baseline_splits_queries(root)
                                   else OLD_DKV_SIGNATURE),
            "mmpl_flash_bwd_dq": sigs["mmpl_flash_bwd_dq"], **sched,
            **masked}


def baseline_library(root: Path, source: str = "flash_fwd") -> Path:
    """Where the baseline's `source` is built (keyed by its sources)."""
    csrc = baseline_csrc(root, source)
    src = (csrc / f"{source}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(
        src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    return _build.BUILD_DIR / f"baseline-{source}-{digest}.so"


def build_baseline(root: Path, source: str = "flash_fwd") -> ctypes.CDLL:
    """Build (once per source hash) and bind the baseline's entries of
    `source`."""
    csrc = baseline_csrc(root, source)
    out = baseline_library(root, source)
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(tmp), str(csrc / f"{source}.cu")],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed for the baseline:\n"
                               f"{run.stdout}{run.stderr}")
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in baseline_signatures(root, source).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def call_k1(lib, log2e: bool, q, k, v):
    """K1 of a built `flash_fwd` library on CUDA tensors: (O, lse)."""
    B, Lq, N, D = q.shape
    scale = D ** -0.5 * (attn.LOG2E if log2e else 1.0)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, N, Lq), dtype=torch.float32, device=q.device)
    rc = lib.mmpl_flash_fwd(
        attn._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Lq, k.shape[1], N,
        D, *attn._strides(q, k, v, o), float(scale),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    return o, lse


def call_sched(lib, mode: str, splits: int, q, k, v):
    """K1 of a built `flash_fwd` library with `mmpl_flash_fwd_sched` under
    the schedule `mode` (`attn.FWD_MODES`) on CUDA tensors: (O, lse)."""
    B, Lq, N, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, N, Lq), dtype=torch.float32, device=q.device)
    ws = (torch.empty(splits * B * N * Lq * (D + 1), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    rc = lib.mmpl_flash_fwd_sched(
        attn._sched_args(q, k, v, o, lse, ws, mode, splits,
                         attn._sm_count(q.device.index)),
        float(D ** -0.5 * attn.LOG2E), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 ({mode}) launch failed: CUDA error {rc}")
    return o, lse


def bind_exp2(lib) -> ctypes.CDLL:
    """Bind P1's entry of a built `flash_fwd` library by this tree's
    signature."""
    lib.mmpl_flash_exp2.argtypes = _build.SIGNATURES["flash_fwd"][
        "mmpl_flash_exp2"]
    lib.mmpl_flash_exp2.restype = ctypes.c_int
    return lib


def call_exp2(lib, use_exp2: bool, mask_pad: bool, q, k, v):
    """P1 of a built `flash_fwd` library on CUDA tensors: O."""
    B, Lq, N, D = q.shape
    scale = D ** -0.5 * (attn.LOG2E if use_exp2 else 1.0)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = lib.mmpl_flash_exp2(
        attn._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), int(use_exp2), int(mask_pad), B, Lq,
        k.shape[1], N, D, *attn._strides(q, k, v, o), float(scale),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"P1 launch failed: CUDA error {rc}")
    return o


def call_bwd(lib, splits_queries: bool, part: str, q, k, v, do, lse, delta):
    """K2 ("dkv": (dk, dv)) or K3 ("dq": (dq,)) of a built `flash_bwd`
    library on CUDA tensors; a library that splits the queries gets this
    tree's split."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    like = (k, v) if part == "dkv" else (q,)
    outs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in like)
    split = []
    if part == "dkv" and splits_queries:
        splits = (1 if q.dtype == torch.float32 else attn.bwd_query_splits(
            B, N, Lq, Lk, attn._sm_count(q.device.index)))
        ws = (torch.empty((2, splits, B, N, Lk, D), dtype=torch.float32,
                          device=q.device) if splits > 1 else None)
        split = [None if ws is None else ws.data_ptr(), splits]
    strides = attn._strides(q, k, v, do, *outs) + [0] * 3 * (2 - len(outs))
    rc = getattr(lib, f"mmpl_flash_bwd_{part}")(
        attn._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(x.data_ptr() for x in outs), *split, B, Lq, Lk, N, D,
        (ctypes.c_longlong * 18)(*strides), float(D ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{part} launch failed: CUDA error {rc}")
    return outs


def call_bwd_sched(lib, mode: str, parts: str, q, k, v, do, lse, delta):
    """K2 and / or K3 (`parts`: "dkv", "dq" or "both") of a built
    `flash_bwd` library through its scheduled entry (`mmpl_flash_bwd_sched`)
    under `mode`; returns (dq, dk, dv), None for a part not computed."""
    D = q.shape[-1]
    dq = (torch.empty_like(q, memory_format=torch.contiguous_format)
          if parts != "dkv" else None)
    dk, dv = ((torch.empty_like(x, memory_format=torch.contiguous_format)
               for x in (k, v)) if parts != "dq" else (None, None))
    sms = attn._sm_count(q.device.index)
    splits, ws, cnt = attn.bwd_workspace(mode, parts, q, k, sms)
    rc = lib.mmpl_flash_bwd_sched(
        attn._bwd_sched_args(q, k, v, do, lse, delta, dq, dk, dv, ws, mode,
                             parts, splits, sms, cnt),
        float(D ** -0.5), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{mode} {parts} launch failed: CUDA error {rc}")
    return dq, dk, dv


def call_masked(lib, coarse: bool, part: str, q, k, v, mask, tiles,
                do=None, lse=None, delta=None):
    """K4 ("fwd": (O, lse)), K5 ("dkv": (dk, dv)) or K6 ("dq": (dq,)) of a
    built `flash_fwd` / `flash_bwd` library on CUDA tensors under `mask`
    (ids, ids, frame table) and its `attn.mask_tiles`; with `coarse` (the
    entry takes a coarse table) it gets the one of its kernel."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    ids = [mask[0].data_ptr(), mask[1].data_ptr(), mask[2].data_ptr(),
           tiles.t64.data_ptr()]
    if coarse:
        ids.append(getattr(tiles, attn.COARSE_TABLE[part]).data_ptr())
    ids.append(mask[2].shape[0])
    code = attn._DTYPE_CODES[q.dtype]
    if part == "fwd":
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        out = torch.empty((B, N, Lq), dtype=torch.float32, device=q.device)
        rc = lib.mmpl_flash_masked_fwd(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            out.data_ptr(), *ids, B, Lq, Lk, N, D,
            *attn._strides(q, k, v, o), float(D ** -0.5), stream)
        outs = (o, out)
    else:
        like = (k, v) if part == "dkv" else (q,)
        outs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                     for x in like)
        strides = attn._strides(q, k, v, do, *outs) + [0] * 3 * (2 - len(outs))
        rc = getattr(lib, f"mmpl_flash_masked_bwd_{part}")(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
            *ids, B, Lq, Lk, N, D, (ctypes.c_longlong * 18)(*strides),
            float(D ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"masked {part} launch failed: CUDA error {rc}")
    return outs


def call_p2(lib, hopper: bool, a, b, sx, sw):
    """P2 of a built `int8_gemm` library, bf16 out; a Hopper library gets
    this tree's tile width."""
    M, K = a.shape
    N = b.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    rc = lib.mmpl_int8_gemm(
        1, a.data_ptr(), b.data_ptr(), None if sx is None else sx.data_ptr(),
        sw.data_ptr(), out.data_ptr(), M, N, K,
        *([quant.p2_tile_n(N)] if hopper else []),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"P2 launch failed: CUDA error {rc}")
    return out


def call_q(lib, hopper: bool, x, mode: bool = True):
    """Q of a built `int8_gemm` library: (codes, scales); a Hopper library
    gets this tree's layout, and, with `mode` (an entry that takes one),
    the codes-and-scales mode."""
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    rc = lib.mmpl_quantize_rows(
        quant._DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(), s.data_ptr(),
        M, K, *([quant.q_row_warps(K)] if hopper else []),
        *([quant.Q_MODES["codes"]] if hopper and mode else []),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Q launch failed: CUDA error {rc}")
    return q, s


def sass_by_kernel(path: Path) -> dict:
    """{mangled kernel name: its SASS} of a built library, from the
    cuobjdump beside nvcc, each line's runs of blanks made one (cuobjdump
    pads the instructions to the widest of the whole library, so a kernel
    added beside them shifts every column)."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name is not None:
            kernels[name].append(" ".join(line.split()))
    return {k: "\n".join(v) for k, v in kernels.items()}


def same_sass(base: Path, this: Path, pattern: str = "_sm90_kernel") -> dict:
    """Which kernels matching `pattern` compiled to the same SASS in the
    two libraries."""
    a, b = sass_by_kernel(base), sass_by_kernel(this)
    names = sorted(n for n in {*a, *b} if pattern in n)
    return {"identical": [n for n in names if a.get(n) == b.get(n)],
            "differ": [n for n in names if n in a and n in b
                       and a[n] != b[n]],
            "only_one_tree": [n for n in names if (n in a) != (n in b)]}


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _turns(base, this, reps: int, timer=time_ms) -> dict:
    """Times in the order baseline, this, this, baseline, and the speedup
    of the sums."""
    t = [timer(f, reps) for f in (base, this, this, base)]
    return {"baseline_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
            "speedup": (t[0] + t[3]) / (t[1] + t[2])}


def _card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("flash_compare needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return smi


def _shapes(args) -> dict:
    return (F32_TABLES if args.dtype == "float32" else TABLES)[args.kernel]


def _bound_ms(flops: float, nbytes: float, dtype) -> float:
    peak = PEAK_TF32 if dtype == torch.float32 else PEAK_FLOPS
    return 1e3 * max(flops / peak, nbytes / PEAK_BYTES)


def _efficient_sdpa():
    """SDPA's memory-efficient backend: the one that takes fp32."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])


def run_fwd(args, smi: str) -> list:
    lib = build_baseline(args.baseline)
    log2e = baseline_takes_log2e(args.baseline)
    scheduled = baseline_schedules_k1(args.baseline)
    mine = _build.library("flash_fwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = DTYPES[args.dtype]
    f32 = dtype == torch.float32
    sms = attn._sm_count(torch.cuda.current_device())
    rows = []
    for label in args.shapes:
        B, N, D, Lq, Lk = _shapes(args)[label]
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device="cuda")
                   .to(dtype) for L in (Lq, Lk, Lk))
        po, _ = attn.flash_attention_plain(q, k, v)
        mode, splits = (("grid", 1) if f32
                        else attn.fwd_schedule(B, N, Lq, Lk, D, sms))
        base = ((lambda: call_sched(lib, mode, splits, q, k, v)) if scheduled
                else (lambda: call_k1(lib, log2e, q, k, v)))
        this = lambda: call_sched(mine, mode, splits, q, k, v)
        err = lambda f: (f()[0].float() - po.float()).abs().max().item()
        row = {"kernel": "fwd", "dtype": args.dtype, "shape": label, "B": B,
               "N": N, "D": D, "Lq": Lq, "Lk": Lk, "mode": mode,
               "splits": splits, "baseline_max_abs_err": err(base),
               "this_max_abs_err": err(this)}
        row.update(_turns(base, this, args.reps))
        # the same turns by device time: no host time between the calls
        row["device"] = _turns(base, this, args.reps, queued_ms)
        if not f32:
            # this tree under each schedule by device time, for the
            # chooser's crossovers
            # where the chooser splits: its split, one fewer and twice as
            # many and one (a second wave)
            n = splits if mode == "split" else 1
            forced = [("grid", 1), ("persistent", 1)] + [
                ("split", x) for x in sorted({max(2, n - 1), n, 2 * n + 1})
                if n > 1 and x <= attn.FWD_MAX_SPLITS]
            row["modes_ms"], row["modes_max_abs_err"] = {}, {}
            for m, n in forced:
                run = lambda: call_sched(mine, m, n, q, k, v)
                row["modes_max_abs_err"][f"{m}/{n}"] = err(run)
                row["modes_ms"][f"{m}/{n}"] = queued_ms(run, args.reps)
        del po
        library = lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
        with _efficient_sdpa() if f32 else contextlib.nullcontext():
            row["sdpa_ms"] = time_ms(library, args.reps)
            row["sdpa_device_ms"] = queued_ms(library, args.reps)
        if f32:
            row["plain_ms"] = time_ms(
                lambda: attn.flash_attention_plain(q, k, v), PLAIN_REPS)
        flops = 4.0 * B * N * Lq * Lk * D
        nbytes = (q.element_size() * B * N * D * (2 * Lq + 2 * Lk)
                  + 4 * B * N * Lq)
        row["bound_ms"] = _bound_ms(flops, nbytes, dtype)
        row["this_tflops"] = flops / min(row["this_ms"]) / 1e9
        row["baseline_tflops"] = flops / min(row["baseline_ms"]) / 1e9
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    sass = same_sass(baseline_library(args.baseline),
                     _build._target("flash_fwd"))
    print(json.dumps({"kernel": "fwd", "sass_of": "flash_fwd.cu",
                      "sass_identical": len(sass["identical"]), **sass,
                      "card": smi}), flush=True)
    return rows


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def run_bwd(args, smi: str) -> list:
    lib = build_baseline(args.baseline, "flash_bwd")
    new = baseline_splits_queries(args.baseline)
    scheduled = baseline_schedules_bwd(args.baseline)
    ordered = baseline_orders_bwd(args.baseline)
    mine = _build.library("flash_bwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = DTYPES[args.dtype]
    f32 = dtype == torch.float32
    unordered = None if f32 else unordered_library()
    sms = attn._sm_count(torch.cuda.current_device())
    rows = []
    for label in args.shapes:
        B, N, D, Lq, Lk = _shapes(args)[label]
        q, do = (torch.randn((B, Lq, N, D), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((B, Lk, N, D), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        o, lse = attn.flash_fwd_cuda(q, k, v)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        want = dict(zip(("dq", "dk", "dv"), attn.flash_attention_bwd_plain(
            q, k, v, do, lse, delta)))
        args_ = (q, k, v, do, lse, delta)
        mode = "grid" if f32 else attn.bwd_schedule(B, N, Lq, Lk, D, sms)
        dq_mode = "grid" if mode in ("fused", "ordered") else mode
        # a baseline without the ordered walk runs the grid in its place
        base_mode = "grid" if mode == "ordered" and not ordered else mode
        base_dkv = lambda: call_bwd(lib, new, "dkv", *args_)
        # K2 alone (the grid), K3 alone under its schedule, and the whole
        # backward under its schedule, of each tree: a baseline without
        # the scheduled entry runs K3 on its grid and the whole backward
        # as its two calls, K2 first (as its `flash_bwd_cuda`)
        if scheduled:
            base_dq = lambda: call_bwd_sched(lib, dq_mode, "dq", *args_)[:1]
            base_bwd = lambda: call_bwd_sched(lib, base_mode, "both", *args_)
        else:
            base_dq = lambda: call_bwd(lib, new, "dq", *args_)
            base_bwd = lambda: (lambda dkv: base_dq() + dkv)(base_dkv())
        calls = {
            "dkv": (base_dkv, lambda: call_bwd_sched(mine, "grid", "dkv",
                                                     *args_)[1:]),
            "dq": (base_dq, lambda: call_bwd_sched(mine, dq_mode, "dq",
                                                   *args_)[:1]),
            "bwd": (base_bwd,
                    lambda: call_bwd_sched(mine, mode, "both", *args_)),
        }
        row = {"kernel": "bwd", "dtype": args.dtype, "shape": label, "B": B,
               "N": N, "D": D, "Lq": Lq, "Lk": Lk, "mode": mode,
               "baseline_mode": base_mode,
               "splits": 1 if f32 else attn.bwd_query_splits(
                   B, N, Lq, Lk, sms)}
        for part, (base, this) in calls.items():
            names = {"dkv": ("dk", "dv"), "dq": ("dq",),
                     "bwd": ("dq", "dk", "dv")}[part]
            for who, fn in (("baseline", base), ("this", this)):
                row[f"{part}_{who}_rel_err"] = max(
                    _rel(g, want[n]) for g, n in zip(fn(), names))
            row.update({f"{part}_{k_}": x for k_, x in
                        _turns(base, this, args.reps).items()})
            # the same turns by device time: no host time between the calls
            row[f"{part}_device"] = _turns(base, this, args.reps, queued_ms)
            mult, elems = {"dkv": (8.0, (2, 4)), "dq": (6.0, (3, 2)),
                           "bwd": (10.0, (3, 4))}[part]
            flops = mult * B * N * Lq * Lk * D
            nbytes = (q.element_size() * B * N * D
                      * (elems[0] * Lq + elems[1] * Lk) + 8 * B * N * Lq)
            row[f"{part}_bound_ms"] = _bound_ms(flops, nbytes, dtype)
            row[f"{part}_this_tflops"] = (flops / min(row[f"{part}_this_ms"])
                                          / 1e9)
            row[f"{part}_baseline_tflops"] = (
                flops / min(row[f"{part}_baseline_ms"]) / 1e9)
        if not f32:
            # this tree's whole backward under each schedule by device
            # time, for the chooser's crossovers
            row["modes_ms"], row["modes_rel_err"] = {}, {}
            for m in ("grid", "persistent", "ordered") + (
                    ("fused",) if Lq <= attn.BWD_QUERY_TILE else ()):
                run = lambda: call_bwd_sched(mine, m, "both", *args_)
                row["modes_rel_err"][m] = max(
                    _rel(g, want[n]) for g, n in zip(run(), ("dq", "dk",
                                                             "dv")))
                row["modes_ms"][m] = queued_ms(run, args.reps)
            # the cost of the ordering: the ordered walk against the same
            # walk with its adds unordered (a scratch variant), in turns by
            # device time
            run = lambda lib_: lambda: call_bwd_sched(lib_, "ordered", "both",
                                                      *args_)
            t = [queued_ms(run(x), args.reps)
                 for x in (unordered, mine, mine, unordered)]
            row["ordered_ms"], row["unordered_ms"] = [t[1], t[2]], [t[0], t[3]]
        del want
        if f32:
            row["plain_ms"] = time_ms(lambda: attn.flash_attention_bwd_plain(
                *args_), PLAIN_REPS)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        with _efficient_sdpa() if f32 else contextlib.nullcontext():
            out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
            grad = lambda: torch.autograd.grad(
                out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
            row["sdpa_bwd_ms"] = time_ms(grad, args.reps)
            row["sdpa_bwd_device_ms"] = queued_ms(grad, args.reps)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta, qt, kt, vt, out
        torch.cuda.empty_cache()
    sass = same_sass(baseline_library(args.baseline, "flash_bwd"),
                     _build._target("flash_bwd"))
    print(json.dumps({"kernel": "bwd", "sass_of": "flash_bwd.cu",
                      "sass_identical": len(sass["identical"]), **sass,
                      "card": smi}), flush=True)
    return rows


def run_masked(args, smi: str) -> list:
    from ..core.geometry import T2V_CLEAN_STEPS
    from ..training.masks import fps_forcing_frame_mask
    libs = {src: build_baseline(args.baseline, src)
            for src in ("flash_fwd", "flash_bwd")}
    coarse = {part: baseline_takes_coarse_tables(args.baseline, src, part)
              for part, src in (("fwd", "flash_fwd"), ("dkv", "flash_bwd"),
                                ("dq", "flash_bwd"))}
    mine = {src: _build.library(src) for src in ("flash_fwd", "flash_bwd")}
    gen = torch.Generator(device="cuda").manual_seed(3)
    dtype = DTYPES[args.dtype]
    f32 = dtype == torch.float32
    rows = []
    for label in args.shapes:
        B, N, D, S = MASKED_SHAPES[label]
        fm = fps_forcing_frame_mask(T2V_CLEAN_STEPS)
        ids = torch.arange(fm.shape[0], dtype=torch.int32,
                           device="cuda").repeat_interleave(S)
        mask = (ids, ids, torch.as_tensor(fm, device="cuda"))
        tiles = attn.mask_tiles(*mask)
        L = ids.numel()
        counts = torch.full((fm.shape[0],), float(S), dtype=torch.float64)
        share = float(counts @ torch.as_tensor(fm, dtype=torch.float64)
                      @ counts) / L ** 2
        q, k, v, do = (torch.randn((B, L, N, D), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = attn.flash_fwd_cuda(q, k, v, None, mask, tiles)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        po, _ = attn.frame_masked_attention_plain(q, k, v, *mask)
        want = dict(zip(("dq", "dk", "dv"),
                        attn.frame_masked_attention_bwd_plain(
                            q, k, v, do, lse, delta, *mask)))
        want["o"] = po
        row = {"kernel": "masked", "dtype": args.dtype, "shape": label,
               "B": B, "N": N, "D": D, "L": L, "pair_share": share,
               "fwd_tile_share": (tiles.fwd != 0).float().mean().item(),
               "dkv_tile_share": (tiles.dkv != 0).float().mean().item(),
               "t64_tile_share": (tiles.t64 != 0).float().mean().item()}
        bwd_args = dict(do=do, lse=lse, delta=delta)
        for part, src, names, mult in (("fwd", "flash_fwd", ("o",), 4.0),
                                       ("dkv", "flash_bwd", ("dk", "dv"), 8.0),
                                       ("dq", "flash_bwd", ("dq",), 6.0)):
            extra = {} if part == "fwd" else bwd_args
            base = lambda: call_masked(libs[src], coarse[part], part, q, k,
                                       v, mask, tiles, **extra)
            this = lambda: call_masked(mine[src], True, part, q, k, v, mask,
                                       tiles, **extra)
            for who, fn in (("baseline", base), ("this", this)):
                row[f"{part}_{who}_rel_err"] = max(
                    _rel(g, want[n]) for g, n in zip(fn(), names))
            row.update({f"{part}_{k_}": x for k_, x in
                        _turns(base, this, args.reps).items()})
            flops = mult * B * N * L * L * D * share
            elems = {"fwd": 4 * L, "dkv": 6 * L, "dq": 5 * L}[part]
            nbytes = q.element_size() * B * N * D * elems + 4 * B * N * L * (
                1 if part == "fwd" else 2)
            row[f"{part}_bound_ms"] = _bound_ms(flops, nbytes, dtype)
            row[f"{part}_this_tflops"] = (flops / min(row[f"{part}_this_ms"])
                                          / 1e9)
            row[f"{part}_baseline_tflops"] = (
                flops / min(row[f"{part}_baseline_ms"]) / 1e9)
        del want, po
        if f32:
            row["plain_fwd_ms"] = time_ms(
                lambda: attn.frame_masked_attention_plain(q, k, v, *mask),
                PLAIN_REPS)
            row["plain_bwd_ms"] = time_ms(
                lambda: attn.frame_masked_attention_bwd_plain(
                    q, k, v, do, lse, delta, *mask), PLAIN_REPS)
        # SDPA under the token mask: the yardstick only
        token_mask = mask[2][mask[0].long()][:, mask[1].long()]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with _efficient_sdpa():
            row["sdpa_fwd_ms"] = time_ms(lambda: sdpa(
                qt, kt, vt, attn_mask=token_mask).detach(), args.reps)
            out = sdpa(qt, kt, vt, attn_mask=token_mask)
            row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
                args.reps)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta, token_mask, qt, kt, vt, out
        torch.cuda.empty_cache()
    for source in ("flash_fwd", "flash_bwd"):
        sass = same_sass(baseline_library(args.baseline, source),
                         _build._target(source))
        print(json.dumps({"kernel": "masked", "sass_of": f"{source}.cu",
                          "sass_identical": len(sass["identical"]), **sass,
                          "card": smi}), flush=True)
    return rows


def run_exp2(args, smi: str) -> list:
    lib = bind_exp2(build_baseline(args.baseline))
    mine = bind_exp2(_build.library("flash_fwd"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtype = DTYPES[args.dtype]
    f32 = dtype == torch.float32
    rows = []
    for label in args.shapes:
        B, N, D, Lq, Lk = _shapes(args)[label]
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device="cuda")
                   .to(dtype) for L in (Lq, Lk, Lk))
        k1_ms = time_ms(lambda: call_k1(mine, True, q, k, v), args.reps)
        sdpa_ms = time_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2)), args.reps)
        flops = 4.0 * B * N * Lq * Lk * D
        nbytes = q.element_size() * B * N * D * (2 * Lq + 2 * Lk)
        for name, use_exp2, mask_pad in EXP2_VARIANTS:
            if not mask_pad and Lk % attn.TILE:
                continue
            want = attn.flash_attention_exp2_plain(q, k, v, use_exp2,
                                                   mask_pad)
            base = lambda: call_exp2(lib, use_exp2, mask_pad, q, k, v)
            this = lambda: call_exp2(mine, use_exp2, mask_pad, q, k, v)
            err = lambda f: (f().float() - want.float()).abs().max().item()
            row = {"kernel": "exp2", "dtype": args.dtype, "shape": label,
                   "variant": name, "B": B, "N": N, "D": D, "Lq": Lq,
                   "Lk": Lk, "baseline_max_abs_err": err(base),
                   "this_max_abs_err": err(this)}
            del want
            row.update(_turns(base, this, args.reps))
            row.update(k1_ms=k1_ms, sdpa_ms=sdpa_ms,
                       bound_ms=_bound_ms(flops, nbytes, dtype))
            if f32:
                row["plain_ms"] = time_ms(
                    lambda: attn.flash_attention_exp2_plain(
                        q, k, v, use_exp2, mask_pad), PLAIN_REPS)
            row["this_tflops"] = flops / min(row["this_ms"]) / 1e9
            row["baseline_tflops"] = flops / min(row["baseline_ms"]) / 1e9
            row["card"] = smi
            print(json.dumps(row), flush=True)
            rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    sass = same_sass(baseline_library(args.baseline),
                     _build._target("flash_fwd"))
    print(json.dumps({"kernel": "exp2", "sass_of": "flash_fwd.cu",
                      "sass_identical": len(sass["identical"]), **sass,
                      "card": smi}), flush=True)
    return rows


def _ulps(got, want) -> int:
    return (got.view(torch.int16).long() - want.view(torch.int16).long()
            ).abs().max().item()


def run_int8(args, smi: str) -> list:
    lib = build_baseline(args.baseline, "int8_gemm")
    hopper = baseline_has_hopper_int8(args.baseline)
    mode = hopper and baseline_q_takes_mode(args.baseline)
    mine = _build.library("int8_gemm")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label in args.shapes:
        M, K, N, act = INT8_SHAPES[label]
        wq, sw = quant.quantize_weight(
            torch.randn((N, K), generator=gen, device="cuda"))
        row = {"kernel": "int8", "shape": label, "M": M, "K": K, "N": N,
               "tile_n": quant.p2_tile_n(N)}
        if act:
            x = (3 * torch.randn((M, K), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            want = quant.quantize_rows_plain(x)
            for who, l_, h, m in (("baseline", lib, hopper, mode),
                                  ("this", mine, True, True)):
                got = call_q(l_, h, x, m)
                row[f"q_{who}_equal"] = all(torch.equal(g, w)
                                            for g, w in zip(got, want))
            xq, sx = want
            row.update({f"q_{k}": v for k, v in _turns(
                lambda: call_q(lib, hopper, x, mode),
                lambda: call_q(mine, True, x), args.reps,
                queued_ms).items()})
            row["q_bound_ms"] = 1e3 * (3 * M * K + 4 * M) / PEAK_BYTES
            del x
        else:
            xq = torch.randint(-127, 128, (M, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            sx, sw = None, sw * 0.01
        want = quant.int8_gemm_plain(xq, wq, sx, sw, torch.bfloat16)
        for who, l_, h in (("baseline", lib, hopper), ("this", mine, True)):
            row[f"{who}_max_ulps"] = _ulps(call_p2(l_, h, xq, wq, sx, sw),
                                           want)
        del want
        row.update(_turns(lambda: call_p2(lib, hopper, xq, wq, sx, sw),
                          lambda: call_p2(mine, True, xq, wq, sx, sw),
                          args.reps, queued_ms))
        ops = 2.0 * M * N * K
        nbytes = M * K + N * K + 2 * M * N + 4 * N + (4 * M if act else 0)
        row["bound_ms"] = 1e3 * max(ops / PEAK_INT8, nbytes / PEAK_BYTES)
        row["this_tops"] = ops / min(row["this_ms"]) / 1e9
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del xq, wq
        torch.cuda.empty_cache()
    _build.build(["flash_fwd", "flash_bwd"])
    for source in ("flash_fwd", "flash_bwd"):
        build_baseline(args.baseline, source)
        sass = same_sass(baseline_library(args.baseline, source),
                         _build._target(source))
        print(json.dumps({"kernel": "int8", "sass_of": f"{source}.cu",
                          "sass_identical": len(sass["identical"]), **sass,
                          "card": smi}), flush=True)
    return rows


def run(args) -> list:
    smi = _card()
    return {"fwd": run_fwd, "bwd": run_bwd, "masked": run_masked,
            "exp2": run_exp2, "int8": run_int8}[args.kernel](args, smi)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
