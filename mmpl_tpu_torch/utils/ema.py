"""Exponential moving average of a model's parameters.

Port of `mmpl_tpu/utils/ema.py:EmaParams`.  The fp32 shadow lives beside
the model on its device (5.7 GB at 1.3B) and is updated in place, or with
`offload=True` in pinned host memory, streamed through the card one
parameter at a time on each update (`utils/memory.HostStreamer`); both
compute the same values, bit for bit.  On the CPU the offloaded shadow
is a plain CPU tensor and the streaming loop runs all the same.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .memory import HostStreamer, _local, stream_to_host


class EmaParams:
    def __init__(self, model: nn.Module, decay: float = 0.999,
                 offload: bool = False):
        self.decay = float(decay)
        #: the streaming update of a host shadow (None: on the device)
        self.streamer = HostStreamer() if offload else None
        named = dict(model.named_parameters())
        if offload:
            # made on the host a tensor at a time, never whole on the card
            self._shadow = dict(zip(named, stream_to_host(
                [p.detach() for p in named.values()], torch.float32)))
        else:
            self._shadow = {n: p.detach().to(torch.float32, copy=True)
                            for n, p in named.items()}

    @property
    def shadow(self) -> Dict[str, torch.Tensor]:
        """The shadow by parameter name (host tensors once every pending
        copy back has landed, when offloaded)."""
        if self.streamer is not None:
            self.streamer.synchronize()
        return self._shadow

    @property
    def host_bytes(self) -> int:
        """Bytes of the shadow in host memory (0 when it is on the card)."""
        return 0 if self.streamer is None else sum(
            _local(s).nbytes for s in self._shadow.values())

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        """shadow = shadow * decay + param * (1 - decay), in place."""
        d = self.decay
        if self.streamer is None:
            for n, p in model.named_parameters():
                self._shadow[n].mul_(d).add_(p.detach().float(),
                                             alpha=1.0 - d)
            return
        named = list(model.named_parameters())

        def update(i, s):
            s[0].mul_(d).add_(_local(named[i][1].detach()).float(),
                              alpha=1.0 - d)

        self.streamer.run([[_local(self._shadow[n])] for n, _ in named],
                          update, _local(named[0][1]).device)

    @torch.no_grad()
    def load(self, saved: Dict[str, torch.Tensor]) -> None:
        """Copy a saved shadow (by name) into this one, where it lies; a
        saved tensor that is the shadow's own (a sharded restore loads in
        place) is left as it is."""
        for n, s in self.shadow.items():
            if saved[n] is not s:
                _local(s).copy_(_local(saved[n]))
