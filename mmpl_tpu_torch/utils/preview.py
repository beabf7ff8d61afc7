"""Fast block-by-block preview decode through the TAEHV tiny VAE.

Port of `mmpl_tpu/utils/preview.py`.  The few-step pipeline hands each
denoised block to `TaehvPreviewer` (its `on_block` hook), which decodes it
with the carried MemBlock state and returns uint8 RGB frames while the full
Wan VAE decode runs once per window at the end.  Clip, scale, rounding,
uint8 and the NTHWC layout are done where the latents are (on the card),
so only the uint8 frames cross to the host.

The previewer reads the pipeline's normalised latents as they are (TAEHV
takes "NTCHW latents with ~Gaussian values"); `denormalize=True` undoes the
Wan per-channel normalisation first, for a checkpoint trained on raw VAE
latents.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models import taehv as _taehv


class TaehvPreviewer:
    """Streaming per-block preview decoder.

    Call with each latent block [B, T, 16, h, w] in generation order; it
    returns uint8 frames [B, 4T (- 3 on the first block), 8h, 8w, 3].
    `reset()` between independent videos.
    """

    def __init__(self, model: _taehv.TAEHV, denormalize: bool = False,
                 dtype=torch.float32):
        self.model = model.to(dtype)
        self.dtype = dtype
        self.denormalize = denormalize
        self._state = None

    def reset(self) -> None:
        self._state = None

    @torch.inference_mode()
    def __call__(self, latents: torch.Tensor) -> np.ndarray:
        z = latents.to(self.dtype)
        if self.denormalize:
            from ..models.vae import LATENT_MEAN, LATENT_STD
            stat = lambda a: torch.as_tensor(a, device=z.device).to(
                z.dtype)[:, None, None]
            z = z * stat(LATENT_STD) + stat(LATENT_MEAN)
        video, self._state = _taehv.taehv_decode_streaming(self.model, z,
                                                           self._state)
        u8 = torch.round(torch.clamp(video, 0.0, 1.0) * 255.0).to(torch.uint8)
        return u8.permute(0, 1, 3, 4, 2).contiguous().cpu().numpy()


def make_preview_callback(previewer: TaehvPreviewer,
                          sink: Callable[[int, np.ndarray], None]
                          ) -> Callable:
    """The pipelines' `on_block(start, latents)` hook: decode each block
    and hand (start frame, uint8 frames) to `sink` (a file writer, a push
    to a client)."""
    def on_block(start_frame: int, latents: torch.Tensor) -> None:
        sink(start_frame, previewer(latents))
    return on_block
