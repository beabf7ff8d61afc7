"""Device selection and float32 precision settings.

Entry points run on CUDA unless the caller asks for the CPU; asking for
CUDA without a card raises (nothing falls back to the CPU).
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return torch.device(name)


def set_float32_precision() -> None:
    """Full fp32 for matmuls AND cuDNN convolutions: TF32 off in both
    (`torch.backends.cuda.matmul.allow_tf32 = False`,
    `torch.backends.cudnn.allow_tf32 = False`).  cuDNN convolutions default
    to TF32, which keeps ~3 decimal digits and would make the fp32 smoke
    path disagree with the JAX reference.  bf16 work is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
