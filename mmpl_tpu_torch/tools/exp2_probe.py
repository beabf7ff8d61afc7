"""Does exp2 (log2(e) folded into the scale) beat exp in the flash forward,
and does dropping the pad test help when Lk is a multiple of the key tile?

Port of `tools/exp2_probe.py:main`: P1's four variants (exp / exp2, with /
without the in-kernel pad test, `ops.attention.flash_attention_exp2`) and
K1 (`flash_attention_lse`) at the probe's shape B=2, Lq=11264, Lk=14336,
N=12, D=128, bf16.  Each variant's largest difference from the first
(exp with the pad test) is checked; ms and TFLOP/s are printed.  Added
here: SDPA as a yardstick, and the few-step path's steady-state
self-attention, 4680 queries over 32760 keys at B=1, where Lk is ragged
for the 64-key tile, so only the two variants with the pad test run.

    python -m mmpl_tpu_torch.tools.exp2_probe            # on the card
    python -m mmpl_tpu_torch.tools.exp2_probe --device cpu --tiny

`--tiny` runs the same sweep at small shapes (the plain versions on the
CPU).  The numbers go to stderr, one line per variant as the JAX probe
prints them.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List

import torch

from ..ops import attention as attn
from ..utils.device import resolve_device, set_float32_precision

#: (name, use_exp2, mask_pad), in the JAX probe's order
VARIANTS = (("exp+mask", False, True), ("exp", False, False),
            ("exp2+mask", True, True), ("exp2", True, False))

#: (label, B, Lq, Lk, N, D): the probe's shape and the few-step hot shape
SHAPES = (("probe", 2, 11264, 14336, 12, 128),
          ("hot", 1, 4680, 32760, 12, 128))
TINY_SHAPES = (("probe", 1, 176, 256, 2, 128),
               ("hot", 1, 78, 546, 2, 128))

#: largest difference of a variant from the first, bf16 output
MAX_DIFF = 2e-2
#: timed calls per variant, after one warm-up call
REPEATS = 10


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="P1 exp / exp2 probe")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tiny", action="store_true",
                   help="small shapes (a check of the sweep on the CPU)")
    return p.parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def timeit(fn, device: torch.device, repeats: int = REPEATS) -> float:
    """Median seconds of one call, after a warm-up (CUDA events on the
    card)."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run(args) -> List[Dict]:
    device = resolve_device(args.device)
    set_float32_precision()
    rows = []
    for label, B, Lq, Lk, N, D in (TINY_SHAPES if args.tiny else SHAPES):
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn((B, L, N, D), generator=gen, device=device)
                   .to(torch.bfloat16) for L in (Lq, Lk, Lk))
        flops = 4.0 * B * N * Lq * Lk * D
        log(f"{label}: B={B} Lq={Lq} Lk={Lk} N={N} D={D} bf16")
        ref = None

        def row(name, fn, out=None):
            secs = timeit(fn, device)
            r = {"shape": label, "variant": name, "B": B, "Lq": Lq,
                 "Lk": Lk, "N": N, "D": D, "ms": 1e3 * secs,
                 "tflops": flops / secs / 1e12}
            if out is not None:
                r["max_diff"] = (out.float() - ref).abs().max().item()
            rows.append(r)
            return r

        for name, use_exp2, mask_pad in VARIANTS:
            if not mask_pad and Lk % attn.TILE:
                log(f"exp2={use_exp2} mask={mask_pad}: not run, Lk={Lk} "
                    f"is not a multiple of {attn.TILE}")
                continue
            fn = lambda e=use_exp2, m=mask_pad: attn.flash_attention_exp2(
                q, k, v, e, m)
            out = fn()
            if ref is None:
                ref = out.float()
            r = row(name, fn, out)
            log(f"exp2={use_exp2} mask={mask_pad}: {r['ms']:7.2f}ms "
                f"{r['tflops']:6.1f} TF/s  maxdiff={r['max_diff']:.2e}")
            if not r["max_diff"] <= MAX_DIFF:
                raise RuntimeError(f"exp2 probe: {name} differs by "
                                   f"{r['max_diff']:.3e} at {label}")
        fn = lambda: attn.flash_attention_lse(q, k, v)
        r = row("k1", fn, fn()[0])
        log(f"production (K1) : {r['ms']:7.2f}ms {r['tflops']:6.1f} TF/s"
            f"  maxdiff={r['max_diff']:.2e}")
        # the yardstick only: no path of the port calls it
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        r = row("sdpa", lambda: torch.nn.functional.
                scaled_dot_product_attention(qt, kt, vt))
        log(f"SDPA (yardstick): {r['ms']:7.2f}ms {r['tflops']:6.1f} TF/s")
        del q, k, v, qt, kt, vt, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
