"""Phase timing with the reference's report format, and the port's kernels
by profiler name.

Port of `mmpl_tpu/utils/profiling.py:PhaseTimer`: named phases (init /
diffusion / VAE) and per-block diffusion times, reported as the reference
pipeline's `causal_inference.py:258-271` prints them.  `sync(device)`
waits for the card before a host clock is read.  `port_kernel_of` books a
kernel name from `torch.profiler` to the port kernel (its launch counter's
name in `ops.attention` / `ops.quant`) it belongs to; `device_kernels`
reads which device kernels a call launches and their device time, and
`queued_ms` times a call on the card without the host's time around it.
`trace(log_dir)` records a `torch.profiler` session as a Chrome trace and
`device_memory_stats()` reads the card's memory in GB (the JAX module's
`jax.profiler` trace and `device.memory_stats`).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


#: the `__global__` functions of `csrc/`, by launch counter.  K1, K4, P1,
#: K2, K3, K5 and K6 have a Hopper kernel (bf16 / fp16) and, in fp32, a
#: split-TF32 Hopper kernel; bf16 / fp16 K1 also has its persistent and
#: key-split kernels, the split's launch adding its merge (one K1 launch
#: whatever the schedule);
#: K2's Hopper launch adds its reduce when it splits the queries; bf16 /
#: fp16 K3 also has its persistent walk, and K2 and K3 their fused walk,
#: which with its dQ reduce books to FUSED_BWD (one launch of each), and
#: their ordered walk, which with its dQ out kernel books there too.  The
#: masked kernels (K4-K6) are kernels of their own names.  P2 has one body;
#: Q reads a row once, or twice beyond the rows its registers hold
#: what the fused and ordered walks of K2 and K3 and their second kernels
#: book to: both counters
FUSED_BWD = "flash_bwd_dkv+flash_bwd_dq"
_KERNELS = {
    "flash_fwd_sm90_kernel": "flash_fwd",
    "flash_fwd_f32_sm90_kernel": "flash_fwd",
    "flash_fwd_persistent_sm90_kernel": "flash_fwd",
    "flash_fwd_split_sm90_kernel": "flash_fwd",
    "flash_fwd_merge_kernel": "flash_fwd",
    "flash_masked_fwd_sm90_kernel": "flash_masked_fwd",
    "flash_masked_fwd_f32_sm90_kernel": "flash_masked_fwd",
    "flash_exp2_sm90_kernel": "flash_exp2",
    "flash_exp2_f32_sm90_kernel": "flash_exp2",
    "flash_bwd_dkv_sm90_kernel": "flash_bwd_dkv",
    "flash_bwd_dkv_reduce_kernel": "flash_bwd_dkv",
    "flash_bwd_dkv_f32_sm90_kernel": "flash_bwd_dkv",
    "flash_masked_bwd_dkv_sm90_kernel": "flash_masked_bwd_dkv",
    "flash_masked_bwd_dkv_f32_sm90_kernel": "flash_masked_bwd_dkv",
    "flash_bwd_dq_sm90_kernel": "flash_bwd_dq",
    "flash_bwd_dq_persistent_sm90_kernel": "flash_bwd_dq",
    "flash_bwd_fused_sm90_kernel": FUSED_BWD,
    "flash_bwd_dq_reduce_kernel": FUSED_BWD,
    "flash_bwd_ordered_sm90_kernel": FUSED_BWD,
    "flash_bwd_ordered_out_kernel": FUSED_BWD,
    "flash_masked_bwd_dq_sm90_kernel": "flash_masked_bwd_dq",
    "flash_bwd_dq_f32_sm90_kernel": "flash_bwd_dq",
    "flash_masked_bwd_dq_f32_sm90_kernel": "flash_masked_bwd_dq",
    "int8_gemm_sm90_kernel": "int8_gemm",
    "quantize_rows_sm90_kernel": "quantize_rows",
    "quantize_rows_kernel": "quantize_rows",
}
#: a kernel's identifier, demangled (`name<...>(...)`) or mangled
#: (`<length>name` before its template arguments `I...E`)
_KERNEL_RE = re.compile("|".join(
    rf"(?<![A-Za-z0-9_]){k}(?=[<(])|{len(k)}{k}(?=[IE])" for k in _KERNELS))


def port_kernel_of(name: str) -> Optional[str]:
    """The launch counter of the port kernel that a profiler kernel name
    (mangled or demangled) belongs to, or None for any other kernel:
    "flash_fwd" (K1), "flash_masked_fwd" (K4), "flash_exp2" (P1),
    "flash_bwd_dkv" / "flash_masked_bwd_dkv" (K2 / K5), "flash_bwd_dq" /
    "flash_masked_bwd_dq" (K3 / K6), FUSED_BWD (K2 and K3's fused and ordered walks),
    "int8_gemm" (P2), "quantize_rows" (Q)."""
    m = _KERNEL_RE.search(name)
    if m is None:
        return None
    return _KERNELS[m.group(0).lstrip("0123456789")]


#: calls of each profiler session that reads which body ran a kernel
#: (`chip_smoke.py`, the card tests): one-call sessions kept only some of
#: their kernels' records now and then, a whole session or one of two
#: kernels (H100, torch 2.11; a 10-call session kept about 7 of its 10
#: records), so each body is read from the records of this many calls
BODY_CALLS = 10

#: a profiler session that recorded no device kernel at all is run again
#: after these pauses (s): even with CUPTI kept resident between sessions
#: (TEARDOWN_CUPTI=0, DISABLE_CUPTI_LAZY_REINIT=1, set before torch loads)
#: a short session now and then loses every device record
PROFILE_RETRY_PAUSES = (1.0, 2.0, 4.0)


def device_kernels(fn: Callable[[], object], reps: int = 1
                   ) -> Dict[str, Tuple[int, float]]:
    """{device kernel name: (launches, device ms summed)} of `reps` calls
    of `fn` under torch.profiler, on the card.  A session that records no
    device kernel runs again after each pause of PROFILE_RETRY_PAUSES, so
    `fn` may run more often; the last session's kernels are returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    found: Dict[str, Tuple[int, float]] = {}
    for pause in (0.0, *PROFILE_RETRY_PAUSES):
        time.sleep(pause)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = {e.key: (e.count, e.self_device_time_total / 1e3)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)}
        if found:
            return found
    return found


#: cycles the card spins before a queued timing: some 25 ms at the H100's
#: clocks, doubled while the host took longer to queue the calls
QUEUE_HOLD_CYCLES = 50_000_000


def queued_ms(fn: Callable[[], object], reps: int = 10) -> float:
    """Device time of one call of `fn` on the card (ms): after one warm-up
    call, `reps` calls queued behind a kernel that spins the card until the
    host has queued them all, timed by CUDA events around the calls.  The
    host's time around each launch is not counted, the card's own gaps
    between kernels are.  (A profiler session can drop the first records
    of a session; this count has nothing to lose.)"""
    fn()
    torch.cuda.synchronize()
    cycles = QUEUE_HOLD_CYCLES
    for _ in range(4):
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if 1e3 * queued_s < held.elapsed_time(start):
            break
        cycles *= 2
    return start.elapsed_time(end) / reps


def sync(device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("runs", "trace")):
    """Record the host and (with a card) the device activity of the
    block under `torch.profiler`; on exit write `<log_dir>/trace.json`, a
    Chrome trace (chrome://tracing or Perfetto).  Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in GB (2^30 bytes): in use by tensors, its
    total and the peak in use; {} on the CPU."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    gb = 1024 ** 3
    return {
        "bytes_in_use_gb": torch.cuda.memory_allocated(dev) / gb,
        "bytes_limit_gb": torch.cuda.get_device_properties(dev)
        .total_memory / gb,
        "peak_bytes_in_use_gb": torch.cuda.max_memory_allocated(dev) / gb,
    }


class PhaseTimer:
    """Named phase seconds, in report order, and each block's seconds
    (host clock; the caller syncs before it reads the clock)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self.blocks: List[float] = []

    def record_block(self, seconds: float) -> None:
        self.blocks.append(seconds)

    def report(self, file=None) -> str:
        file = file if file is not None else sys.stderr
        total = sum(self.phases.values())
        lines = ["Profiling results:"]
        for name, t in self.phases.items():
            pct = 100 * t / total if total else 0.0
            lines.append(f"  - {name} time: {t * 1e3:.2f} ms ({pct:.2f}%)")
            if name.lower().startswith("diffusion") and self.blocks:
                for i, bt in enumerate(self.blocks):
                    bpct = 100 * bt / t if t else 0.0
                    lines.append(
                        f"    - Block {i} generation time: "
                        f"{bt * 1e3:.2f} ms ({bpct:.2f}% of diffusion)")
        lines.append(f"  - Total time: {total * 1e3:.2f} ms")
        out = "\n".join(lines)
        print(out, file=file, flush=True)
        return out
