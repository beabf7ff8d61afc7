"""K1 of this tree against K1 of another checkout, on one card, in turns.

    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR

DIR holds another checkout of the repository (for example an earlier
commit unpacked with `git archive`).  Its `mmpl_tpu_torch/csrc/flash_fwd.cu`
is built with this tree's nvcc flags into `build/kernels/baseline-<hash>.so`
and bound like this tree's (`mmpl_flash_fwd` keeps its signature).  A
baseline without `flash_fwd_sm90.cuh` takes K1's natural scale, a newer
one the scale with log2(e) folded in.  At each shape both K1s run on the
same bf16 inputs in the order baseline, this tree, this tree, baseline;
each time is the median of CUDA events over `--reps` calls after one
warm-up call.  Each shape prints one JSON line: the four times, both
kernels' largest difference from the plain version, SDPA's time on the
same inputs (a yardstick the port never calls) and the card's bound.  The
card's name and power limit come first.  It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as attn

#: (label, B, N, D, Lq, Lk): the serving window's group 1 and group 3
#: self-attention, its text cross-attention, the few-step steady state
SHAPES = {
    "group1_self": (2, 12, 128, 10920, 14040),
    "group3_self": (2, 12, 128, 9360, 32760),
    "cross": (2, 12, 128, 9360, 512),
    "fewstep_self_hot": (1, 12, 128, 4680, 32760),
}

#: H100 SXM dense bf16 tensor-core peak and HBM rate (NVIDIA data sheet)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="K1 against another checkout's")
    p.add_argument("--baseline", required=True, type=Path,
                   help="root of the other checkout")
    p.add_argument("--shapes", nargs="+", default=list(SHAPES),
                   choices=list(SHAPES))
    p.add_argument("--reps", type=int, default=10)
    return p.parse_args(argv)


def baseline_csrc(root: Path) -> Path:
    csrc = Path(root) / "mmpl_tpu_torch" / "csrc"
    if not (csrc / "flash_fwd.cu").exists():
        raise FileNotFoundError(f"no mmpl_tpu_torch/csrc/flash_fwd.cu "
                                f"under {root}")
    return csrc


def baseline_takes_log2e(root: Path) -> bool:
    """Whether the baseline's K1 entry takes the scale with log2(e) folded
    in (the Hopper body's trees) or the natural one (earlier trees)."""
    return (baseline_csrc(root) / "flash_fwd_sm90.cuh").exists()


def build_baseline(root: Path) -> ctypes.CDLL:
    """Build (once per source hash) and bind the baseline's K1 entry."""
    csrc = baseline_csrc(root)
    src = (csrc / "flash_fwd.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(
        src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"baseline-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(tmp), str(csrc / "flash_fwd.cu")],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed for the baseline:\n"
                               f"{run.stdout}{run.stderr}")
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    lib.mmpl_flash_fwd.argtypes = \
        _build.SIGNATURES["flash_fwd"]["mmpl_flash_fwd"]
    lib.mmpl_flash_fwd.restype = ctypes.c_int
    return lib


def baseline_k1(lib, log2e: bool, q, k, v):
    """The baseline's K1 on CUDA tensors: (O, lse)."""
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
        raise RuntimeError(f"baseline K1 launch failed: CUDA error {rc}")
    return o, lse


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


def run(args) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("flash_compare needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lib = build_baseline(args.baseline)
    log2e = baseline_takes_log2e(args.baseline)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for label in args.shapes:
        B, N, D, Lq, Lk = SHAPES[label]
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for L in (Lq, Lk, Lk))
        po, _ = attn.flash_attention_plain(q, k, v)
        base = lambda: baseline_k1(lib, log2e, q, k, v)
        this = lambda: attn.flash_fwd_cuda(q, k, v)
        err = lambda f: (f()[0].float() - po.float()).abs().max().item()
        row = {"shape": label, "B": B, "N": N, "D": D, "Lq": Lq, "Lk": Lk,
               "baseline_max_abs_err": err(base),
               "this_max_abs_err": err(this)}
        del po
        turns = [time_ms(f, args.reps) for f in (base, this, this, base)]
        row["baseline_ms"] = [turns[0], turns[3]]
        row["this_ms"] = [turns[1], turns[2]]
        row["speedup"] = sum(row["baseline_ms"]) / sum(row["this_ms"])
        row["sdpa_ms"] = time_ms(lambda: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            args.reps)
        flops = 4.0 * B * N * Lq * Lk * D
        nbytes = 2 * B * N * D * (2 * Lq + 2 * Lk) + 4 * B * N * Lq
        row["bound_ms"] = 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
        row["this_tflops"] = flops / min(row["this_ms"]) / 1e9
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
