"""Exponential moving average of a model's parameters.

Port of `mmpl_tpu/utils/ema.py:EmaParams` without `offload`: the fp32
shadow lives beside the model on its device (5.7 GB at 1.3B, which the
H100 holds) and is updated in place.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class EmaParams:
    def __init__(self, model: nn.Module, decay: float = 0.999):
        self.decay = float(decay)
        self.shadow: Dict[str, torch.Tensor] = {
            n: p.detach().to(torch.float32, copy=True)
            for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        """shadow = shadow * decay + param * (1 - decay), in place."""
        d = self.decay
        for n, p in model.named_parameters():
            s = self.shadow[n]
            s.mul_(d).add_(p.detach().float(), alpha=1.0 - d)
