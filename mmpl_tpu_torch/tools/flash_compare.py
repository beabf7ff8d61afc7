"""K1, K2 and K3, K4-K6, or P2 and Q, of this tree against another
checkout's, on one card, in turns.

    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel bwd
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel masked
    python -m mmpl_tpu_torch.tools.flash_compare --baseline DIR --kernel int8

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

`--kernel masked` builds the baseline's `flash_fwd.cu` and `flash_bwd.cu`
and times K4, K5 and K6 (`call_masked`) at `MASKED_SHAPES` (the
teacher-forcing self-attention under the fps-forcing mask) the same way;
a baseline entry that takes no coarse tile table (K4 and K5 before their
Hopper bodies, K6 before its own; `OLD_MASKED_SIGNATURES`) gets the
64 x 64 table alone.  Both trees are held against the plain versions; the
last two lines say whether the Hopper kernels of each source compiled to
the same SASS in both trees (K1, P1, K2, K3 and those of K4-K6 that both
trees have; the others exist in one tree only).

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

#: (label, B, N, D, Lq, Lk) of K1: the serving window's group 1 and group 3
#: self-attention, its text cross-attention, the few-step steady state
SHAPES = {
    "group1_self": (2, 12, 128, 10920, 14040),
    "group3_self": (2, 12, 128, 9360, 32760),
    "cross": (2, 12, 128, 9360, 512),
    "fewstep_self_hot": (1, 12, 128, 4680, 32760),
}
#: K2 / K3: the teacher-forcing cross-attention and the few-step steady
#: state, the self-attention shape of self-forcing training and the ring
BWD_SHAPES = {
    "tf_cross": (1, 12, 128, 65520, 512),
    "fewstep_self_hot": (1, 12, 128, 4680, 32760),
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
TABLES = {"fwd": SHAPES, "bwd": BWD_SHAPES, "masked": MASKED_SHAPES,
          "int8": INT8_SHAPES}

#: H100 SXM dense bf16 and int8 tensor-core peaks and HBM rate (NVIDIA
#: data sheet)
PEAK_FLOPS = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

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


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="K1, K2 / K3, K4-K6 or P2 / Q against another "
                    "checkout's")
    p.add_argument("--baseline", required=True, type=Path,
                   help="root of the other checkout")
    p.add_argument("--kernel", choices=sorted(TABLES), default="fwd",
                   help="fwd: K1; bwd: K2 and K3; masked: K4, K5 and K6; "
                        "int8: P2 and Q")
    p.add_argument("--shapes", nargs="+", default=None,
                   choices=sorted({k for t in TABLES.values() for k in t}),
                   help="default: every shape of the kernel")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    table = TABLES[args.kernel]
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


def baseline_signatures(root: Path, source: str) -> dict:
    """The entries of the baseline's `source` that the comparison calls,
    with the C signatures its sources have."""
    sigs = _build.SIGNATURES[source]
    if source == "int8_gemm":
        return (dict(sigs) if baseline_has_hopper_int8(root)
                else dict(OLD_INT8_SIGNATURES))
    masked = {n: (sigs[n] if baseline_takes_coarse_tables(
                      root, source, n.rsplit("_", 1)[-1])
                  else OLD_MASKED_SIGNATURES[n])
              for n in sigs if n.startswith("mmpl_flash_masked")}
    if source == "flash_fwd":
        return {"mmpl_flash_fwd": sigs["mmpl_flash_fwd"], **masked}
    return {"mmpl_flash_bwd_dkv": (sigs["mmpl_flash_bwd_dkv"]
                                   if baseline_splits_queries(root)
                                   else OLD_DKV_SIGNATURE),
            "mmpl_flash_bwd_dq": sigs["mmpl_flash_bwd_dq"], **masked}


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
        splits = attn.bwd_query_splits(B, N, Lq, Lk,
                                       attn._sm_count(q.device.index))
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


def call_q(lib, hopper: bool, x):
    """Q of a built `int8_gemm` library: (codes, scales); a Hopper library
    gets this tree's layout."""
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    rc = lib.mmpl_quantize_rows(
        quant._DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(), s.data_ptr(),
        M, K, *([quant.q_row_warps(K)] if hopper else []),
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


def run_fwd(args, smi: str) -> list:
    lib = build_baseline(args.baseline)
    log2e = baseline_takes_log2e(args.baseline)
    mine = _build.library("flash_fwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for label in args.shapes:
        B, N, D, Lq, Lk = SHAPES[label]
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for L in (Lq, Lk, Lk))
        po, _ = attn.flash_attention_plain(q, k, v)
        base = lambda: call_k1(lib, log2e, q, k, v)
        this = lambda: call_k1(mine, True, q, k, v)
        err = lambda f: (f()[0].float() - po.float()).abs().max().item()
        row = {"kernel": "fwd", "shape": label, "B": B, "N": N, "D": D,
               "Lq": Lq, "Lk": Lk, "baseline_max_abs_err": err(base),
               "this_max_abs_err": err(this)}
        del po
        row.update(_turns(base, this, args.reps))
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
    sass = same_sass(baseline_library(args.baseline),
                     _build._target("flash_fwd"))
    print(json.dumps({"kernel": "fwd",
                      "sass_identical": len(sass["identical"]), **sass,
                      "card": smi}), flush=True)
    return rows


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def run_bwd(args, smi: str) -> list:
    lib = build_baseline(args.baseline, "flash_bwd")
    new = baseline_splits_queries(args.baseline)
    mine = _build.library("flash_bwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label in args.shapes:
        B, N, D, Lq, Lk = BWD_SHAPES[label]
        q, do = (torch.randn((B, Lq, N, D), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Lk, N, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        o, lse = attn.flash_fwd_cuda(q, k, v)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        want = dict(zip(("dq", "dk", "dv"), attn.flash_attention_bwd_plain(
            q, k, v, do, lse, delta)))
        args_ = (q, k, v, do, lse, delta)
        calls = {
            "dkv": (lambda: call_bwd(lib, new, "dkv", *args_),
                    lambda: call_bwd(mine, True, "dkv", *args_)),
            "dq": (lambda: call_bwd(lib, new, "dq", *args_),
                   lambda: call_bwd(mine, True, "dq", *args_)),
        }
        row = {"kernel": "bwd", "shape": label, "B": B, "N": N, "D": D,
               "Lq": Lq, "Lk": Lk,
               "splits": attn.bwd_query_splits(
                   B, N, Lq, Lk, attn._sm_count(q.device.index))}
        for part, (base, this) in calls.items():
            names = ("dk", "dv") if part == "dkv" else ("dq",)
            for who, fn in (("baseline", base), ("this", this)):
                row[f"{part}_{who}_rel_err"] = max(
                    _rel(g, want[n]) for g, n in zip(fn(), names))
            row.update({f"{part}_{k_}": x for k_, x in
                        _turns(base, this, args.reps).items()})
            mult = 8.0 if part == "dkv" else 6.0
            flops = mult * B * N * Lq * Lk * D
            elems = (2 * Lq + 4 * Lk) if part == "dkv" else (3 * Lq + 2 * Lk)
            nbytes = 2 * B * N * D * elems + 8 * B * N * Lq
            row[f"{part}_bound_ms"] = 1e3 * max(flops / PEAK_FLOPS,
                                                nbytes / PEAK_BYTES)
            row[f"{part}_this_tflops"] = (flops / min(row[f"{part}_this_ms"])
                                          / 1e9)
        del want
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            args.reps)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta, qt, kt, vt, out
        torch.cuda.empty_cache()
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
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = attn.flash_fwd_cuda(q, k, v, None, mask, tiles)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        po, _ = attn.frame_masked_attention_plain(q, k, v, *mask)
        want = dict(zip(("dq", "dk", "dv"),
                        attn.frame_masked_attention_bwd_plain(
                            q, k, v, do, lse, delta, *mask)))
        want["o"] = po
        row = {"kernel": "masked", "shape": label, "B": B, "N": N, "D": D,
               "L": L, "pair_share": share,
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
            nbytes = 2 * B * N * D * elems + 4 * B * N * L * (
                1 if part == "fwd" else 2)
            row[f"{part}_bound_ms"] = 1e3 * max(flops / PEAK_FLOPS,
                                                nbytes / PEAK_BYTES)
            row[f"{part}_this_tflops"] = (flops / min(row[f"{part}_this_ms"])
                                          / 1e9)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta, po, want
        torch.cuda.empty_cache()
    for source in ("flash_fwd", "flash_bwd"):
        sass = same_sass(baseline_library(args.baseline, source),
                         _build._target(source))
        print(json.dumps({"kernel": "masked", "sass_of": f"{source}.cu",
                          "sass_identical": len(sass["identical"]), **sass,
                          "card": smi}), flush=True)
    return rows


def _ulps(got, want) -> int:
    return (got.view(torch.int16).long() - want.view(torch.int16).long()
            ).abs().max().item()


def run_int8(args, smi: str) -> list:
    lib = build_baseline(args.baseline, "int8_gemm")
    hopper = baseline_has_hopper_int8(args.baseline)
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
            for who, l_, h in (("baseline", lib, hopper), ("this", mine, True)):
                got = call_q(l_, h, x)
                row[f"q_{who}_equal"] = all(torch.equal(g, w)
                                            for g, w in zip(got, want))
            xq, sx = want
            row.update({f"q_{k}": v for k, v in _turns(
                lambda: call_q(lib, hopper, x), lambda: call_q(mine, True, x),
                args.reps, queued_ms).items()})
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
            "int8": run_int8}[args.kernel](args, smi)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
