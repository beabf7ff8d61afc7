"""Flow-matching scheduler tables, `add_noise` (the anchor reseed, the
training noise and the few-step re-noising), `convert_flow_pred_to_x0` and
the training loss weight.

Port of `mmpl_tpu/schedulers/flow_match.py`: the sigma/timestep tables are
fp64 numpy on the host, stored fp32; lookups pick the nearest timestep
(`argmin |timesteps - t|`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class FlowMatchScheduler:
    """Shifted-sigma linear flow schedule.

      sigmas = linspace(sigma_start, sigma_min, N [+1])[:N]
      sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
      timesteps = sigmas * num_train_timesteps
    """

    def __init__(self, num_inference_steps: int = 100,
                 num_train_timesteps: int = 1000, shift: float = 3.0,
                 sigma_max: float = 1.0, sigma_min: float = 0.003 / 1.002,
                 extra_one_step: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.extra_one_step = extra_one_step
        self.linear_timesteps_weights: Optional[np.ndarray] = None
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps: int = 100,
                      denoising_strength: float = 1.0,
                      training: bool = False) -> None:
        sigma_start = self.sigma_min + \
            (self.sigma_max - self.sigma_min) * denoising_strength
        if self.extra_one_step:
            sigmas = np.linspace(sigma_start, self.sigma_min,
                                 num_inference_steps + 1,
                                 dtype=np.float64)[:-1]
        else:
            sigmas = np.linspace(sigma_start, self.sigma_min,
                                 num_inference_steps, dtype=np.float64)
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.sigmas = sigmas.astype(np.float32)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.float32)
        if training:
            x = self.timesteps.astype(np.float64)
            y = np.exp(-2 * ((x - num_inference_steps / 2)
                             / num_inference_steps) ** 2)
            y_shifted = y - y.min()
            self.linear_timesteps_weights = (
                y_shifted * (num_inference_steps / y_shifted.sum())
            ).astype(np.float32)

    def sigma_of(self, timestep: torch.Tensor) -> torch.Tensor:
        """fp32 sigma of the nearest table timestep, one per entry."""
        ts = torch.as_tensor(self.timesteps, device=timestep.device)
        sig = torch.as_tensor(self.sigmas, device=timestep.device)
        t = timestep.reshape(-1).float()
        return sig[torch.argmin(torch.abs(ts[None, :] - t[:, None]), dim=1)]

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timestep: torch.Tensor) -> torch.Tensor:
        sigma = self.sigma_of(timestep)
        sigma = sigma.reshape(sigma.shape + (1,) * (original_samples.ndim - 1))
        out = (1 - sigma) * original_samples.float() + sigma * noise.float()
        return out.to(noise.dtype)

    def convert_flow_pred_to_x0(self, flow_pred: torch.Tensor,
                                xt: torch.Tensor,
                                timestep: torch.Tensor) -> torch.Tensor:
        """x0 = x_t - sigma_t * v, in fp32, returned in flow_pred's dtype."""
        sigma = self.sigma_of(timestep)
        sigma = sigma.reshape(sigma.shape + (1,) * (xt.ndim - 1))
        out = xt.float() - sigma * flow_pred.float()
        return out.to(flow_pred.dtype)

    def training_weight(self, timestep: torch.Tensor) -> torch.Tensor:
        """Per-timestep loss weight of the nearest table timestep, one per
        entry (`set_timesteps(training=True)` first)."""
        if self.linear_timesteps_weights is None:
            raise ValueError("set_timesteps(training=True) first")
        ts = torch.as_tensor(self.timesteps, device=timestep.device)
        w = torch.as_tensor(self.linear_timesteps_weights,
                            device=timestep.device)
        t = timestep.reshape(-1).float()
        return w[torch.argmin(torch.abs(ts[:, None] - t[None, :]), dim=0)]
