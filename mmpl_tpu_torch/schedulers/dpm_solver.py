"""Flow-matching DPM-Solver++ multistep (order 2, midpoint) with
host-precomputed tables.

Port of `mmpl_tpu/schedulers/dpm_solver.py`.  Every per-step scalar is
computed in fp64 numpy at construction and stored fp32, so a device step is

  x0   = sample - sigma[i] * flow_pred
  next = p_ax[i] * sample + p_m0[i] * x0 + p_m1[i] * m_prev

Update rules (dpmsolver++ / midpoint):
  order 1: x_t = (s_t/s_s0) x - a_t (e^{-h} - 1) m0
  order 2: x_t = (s_t/s_s0) x - a_t (e^{-h} - 1) (m0 + 0.5 D1),
           D1 = (m0 - m1) / r0,  r0 = (lam_s0 - lam_s1) / h
The sigmas are linspace(1, 0, N+1)[:N] through the shift warp, with a
final sigma 0.  The sampler's state holds the sample and the previous x0
(`m0`) only; `step` has `FlowUniPC.step`'s signature, so the pipelines
take either sampler.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

TABLE_KEYS = ("sigma_cur", "p_ax", "p_m0", "p_m1")


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    sigma = np.linspace(1, 0, sampling_steps + 1,
                        dtype=np.float64)[:sampling_steps]
    return shift * sigma / (1 + (shift - 1) * sigma)


def _lambda(sigma: float) -> float:
    """Log-SNR, with the infinite limits at sigma 1 and 0 returned as such
    (the update rules take them: expm1(-inf) = -1, 1 / r0 -> 0)."""
    if sigma >= 1.0:
        return -np.inf
    if sigma <= 0.0:
        return np.inf
    return np.log(1.0 - sigma) - np.log(sigma)


def compute_dpm_coeffs(num_inference_steps: int, shift: float = 8.0,
                       num_train_timesteps: int = 1000,
                       lower_order_final: bool = True):
    """(sigmas [N+1], timesteps [N], sigma_cur [N], p_ax, p_m0, p_m1),
    each fp32, computed in fp64."""
    N = num_inference_steps
    sig = get_sampling_sigmas(N, shift)
    sigmas = np.concatenate([sig, [0.0]])
    timesteps = (sig * num_train_timesteps).astype(np.int64).astype(
        np.float64)

    p_ax = np.zeros(N)
    p_m0 = np.zeros(N)
    p_m1 = np.zeros(N)
    lower = 0
    for i in range(N):
        order = min(2, N - i) if lower_order_final else 2
        order = min(order, lower + 1)
        lower = min(lower + 1, 2)
        s_t, s_s0 = sigmas[i + 1], sigmas[i]
        if s_t == 0.0:
            p_ax[i], p_m0[i], p_m1[i] = 0.0, 1.0, 0.0
            continue
        a_t = 1.0 - s_t
        h = _lambda(s_t) - _lambda(s_s0)
        em = np.expm1(-h)
        p_ax[i] = s_t / s_s0
        p_m0[i] = -a_t * em
        if order >= 2:
            h0 = _lambda(s_s0) - _lambda(sigmas[i - 1])
            r0 = h0 / h
            p_m0[i] += -a_t * em * 0.5 / r0
            p_m1[i] = a_t * em * 0.5 / r0
    f32 = lambda a: a.astype(np.float32)
    return (f32(sigmas), f32(timesteps), f32(sig.copy()),
            f32(p_ax), f32(p_m0), f32(p_m1))


class FlowDPMSolver:
    """DPM-Solver++ sampler: `init_state`, then one `step` per model call."""

    def __init__(self, num_inference_steps: int = 50, shift: float = 8.0,
                 num_train_timesteps: int = 1000):
        self.num_steps = num_inference_steps
        (self.sigmas, self.timesteps, sigma_cur, p_ax, p_m0, p_m1) = \
            compute_dpm_coeffs(num_inference_steps, shift,
                               num_train_timesteps)
        cols = dict(zip(TABLE_KEYS, (sigma_cur, p_ax, p_m0, p_m1)))
        #: per-step coefficients as Python floats (the fp32 table values)
        self.table: List[Dict[str, float]] = [
            {k: float(v[i]) for k, v in cols.items()}
            for i in range(num_inference_steps)]

    @staticmethod
    def init_state(sample: torch.Tensor) -> dict:
        return {"sample": sample.float(),
                "m0": torch.zeros_like(sample, dtype=torch.float32)}

    @staticmethod
    def step(coef: Dict[str, float], state: dict,
             flow_pred: torch.Tensor) -> dict:
        x0 = state["sample"] - coef["sigma_cur"] * flow_pred.float()
        nxt = (coef["p_ax"] * state["sample"] + coef["p_m0"] * x0
               + coef["p_m1"] * state["m0"])
        return {"sample": nxt, "m0": x0}
