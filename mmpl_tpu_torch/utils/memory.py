"""Device-memory introspection on `torch.cuda`.

Port of `hbm_bytes_in_use` and `free_hbm_gb` of
`mmpl_tpu/utils/memory.py` (the reference's `get_cuda_free_memory_gb`,
`demo_utils/memory.py:72-83`).  Both return None on the CPU, as the JAX
package returns None where the backend keeps no memory statistics.

Not ported: the host-offload half of the JAX module (`offload_params`,
`restore_params`, the host-resident AdamW), which backs the JAX
trainer's `--remat-offload` and `--offload-opt`.  Those were workarounds
for the 16 GB of a TPU v5e; the 1.3B teacher-forcing step fits the H100
at 37.7 GiB and a DMD step at 40.2 GiB without them, so the port's
trainer refuses both flags by name (ROADMAP.md North star).
"""

from __future__ import annotations

from typing import Optional

import torch


def _cuda(device) -> Optional[torch.device]:
    """`device` as a CUDA device (the current one for None), or None when
    it is not one or there is no card."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def hbm_bytes_in_use(device=None) -> Optional[int]:
    """Bytes of tensors live on the card (`torch.cuda.memory_allocated`);
    None on the CPU."""
    dev = _cuda(device)
    return None if dev is None else torch.cuda.memory_allocated(dev)


def free_hbm_gb(device=None) -> Optional[float]:
    """GiB a new allocation could take on the card: the free memory
    `torch.cuda.mem_get_info` reports plus what torch's caching allocator
    reserves and no tensor uses; None on the CPU."""
    dev = _cuda(device)
    if dev is None:
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    idle = (stats.get("reserved_bytes.all.current", 0)
            - stats.get("active_bytes.all.current", 0))
    return (free + idle) / 2**30
