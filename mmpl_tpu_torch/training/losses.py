"""Denoising-loss registry (x0 / v / noise / flow prediction MSE).

Port of `mmpl_tpu/training/losses.py`: each loss takes the clean sample,
the noise, the network's prediction in its own parameterisation and the
timestep, and returns a scalar fp32 MSE; `get_denoising_loss` is keyed by
a run config's `denoising_loss_type`.
"""

from __future__ import annotations

import torch


def x0_pred_loss(x, x_pred, **_):
    return torch.mean((x.float() - x_pred.float()) ** 2)


def v_pred_loss(x, noise, v_pred, alphas_cumprod, timestep, **_):
    """Target v = sqrt(a) n - sqrt(1 - a) x."""
    a = torch.as_tensor(alphas_cumprod, device=x.device)[
        timestep.to(torch.int32).long()].reshape((-1,) + (1,) * (x.ndim - 1))
    target = torch.sqrt(a) * noise - torch.sqrt(1 - a) * x
    return torch.mean((target - v_pred.float()) ** 2)


def noise_pred_loss(noise, noise_pred, **_):
    return torch.mean((noise.float() - noise_pred.float()) ** 2)


def flow_pred_loss(x, noise, flow_pred, **_):
    """Target = noise - x."""
    target = noise.float() - x.float()
    return torch.mean((target - flow_pred.float()) ** 2)


_REGISTRY = {
    "x0": x0_pred_loss,
    "v": v_pred_loss,
    "noise": noise_pred_loss,
    "flow": flow_pred_loss,
}


def get_denoising_loss(loss_type: str):
    return _REGISTRY[loss_type]
