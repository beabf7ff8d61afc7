"""Phase timing with the reference's report format.

Port of `mmpl_tpu/utils/profiling.py:PhaseTimer`: named phases (init /
diffusion / VAE) and per-block diffusion times, reported as the reference
pipeline's `causal_inference.py:258-271` prints them.  `sync(device)`
waits for the card before a host clock is read.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch


def sync(device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
