"""Flow-matching UniPC multistep sampler with host-precomputed tables.

Port of `mmpl_tpu/schedulers/unipc.py` (solver_order=2, predict_x0, bh2).
Every per-step scalar, including the 2x2 corrector solve, is computed in
fp64 numpy at construction and stored fp32, so a device step is a few
fused multiply-adds:

  x0     = sample - sigma[i] * flow_pred
  sample = c_ax*last_sample + c_m0*m0 + c_m1*m1 + c_mt*x0     (i >= 1)
  next   = p_ax*sample + p_m0*x0 + p_m1*m0
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

TABLE_KEYS = ("sigma_cur", "c_ax", "c_m0", "c_m1", "c_mt", "use_corr",
              "p_ax", "p_m0", "p_m1")


@dataclasses.dataclass(frozen=True)
class UniPCCoeffs:
    """Per-step coefficient tables, each [num_steps] fp32 (computed fp64)."""
    sigmas: np.ndarray          # [N+1] (with the final sigma 0 appended)
    timesteps: np.ndarray       # [N] model-facing timesteps (int-truncated)
    sigma_cur: np.ndarray
    c_ax: np.ndarray
    c_m0: np.ndarray
    c_m1: np.ndarray
    c_mt: np.ndarray
    use_corr: np.ndarray        # {0,1}
    p_ax: np.ndarray
    p_m0: np.ndarray
    p_m1: np.ndarray


def _lambda(sigma: float) -> float:
    return np.log(1.0 - sigma) - np.log(sigma)


def compute_unipc_coeffs(num_inference_steps: int,
                         num_train_timesteps: int = 1000,
                         shift: float = 8.0,
                         solver_order: int = 2,
                         solver_type: str = "bh2",
                         lower_order_final: bool = True,
                         disable_corrector: Tuple[int, ...] = (),
                         ) -> UniPCCoeffs:
    assert solver_order == 2, "reference uses solver_order=2"
    N = num_inference_steps
    alphas = np.linspace(1, 1 / num_train_timesteps,
                         num_train_timesteps)[::-1].copy()
    base = 1.0 - alphas
    sigma_max, sigma_min = float(base[0]), float(base[-1])
    sig = np.linspace(sigma_max, sigma_min, N + 1, dtype=np.float64)[:-1]
    sig = shift * sig / (1 + (shift - 1) * sig)
    timesteps = (sig * num_train_timesteps).astype(np.int64).astype(
        np.float64)
    sigmas = np.concatenate([sig, [0.0]])

    pred_order: List[int] = []
    lower = 0
    for i in range(N):
        this = min(solver_order, N - i) if lower_order_final \
            else solver_order
        pred_order.append(min(this, lower + 1))
        lower = min(lower + 1, solver_order)

    def bh_terms(s_t: float, s_s0: float):
        a_t = 1.0 - s_t
        h = _lambda(s_t) - _lambda(s_s0)
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = np.expm1(hh) if solver_type == "bh2" else hh
        return a_t, h, hh, h_phi_1, B_h

    t = {k: np.zeros(N) for k in TABLE_KEYS if k != "sigma_cur"}
    for i in range(N):
        s_t, s_s0 = sigmas[i + 1], sigmas[i]
        if s_t == 0.0:
            t["p_ax"][i], t["p_m0"][i], t["p_m1"][i] = 0.0, 1.0, 0.0
        else:
            a_t, h, hh, h_phi_1, B_h = bh_terms(s_t, s_s0)
            t["p_ax"][i] = s_t / s_s0
            t["p_m0"][i] = -a_t * h_phi_1
            if pred_order[i] >= 2:
                r0 = (_lambda(sigmas[i - 1]) - _lambda(s_s0)) / h
                P = a_t * B_h * 0.5 / r0
                t["p_m0"][i] += P
                t["p_m1"][i] = -P

        if i >= 1 and (i - 1) not in disable_corrector:
            q = pred_order[i - 1]
            s_t, s_s0 = sigmas[i], sigmas[i - 1]
            a_t, h, hh, h_phi_1, B_h = bh_terms(s_t, s_s0)
            t["use_corr"][i] = 1.0
            t["c_ax"][i] = s_t / s_s0
            t["c_m0"][i] = -a_t * h_phi_1
            if q == 1:
                t["c_mt"][i] = -a_t * B_h * 0.5
                t["c_m0"][i] += a_t * B_h * 0.5
            else:
                r0 = (_lambda(sigmas[i - 2]) - _lambda(s_s0)) / h
                b1 = (h_phi_1 / hh - 1.0) / B_h
                b2 = 2.0 * ((h_phi_1 / hh - 1.0) / hh - 0.5) / B_h
                rho0 = (b1 - b2) / (1.0 - r0)
                rho1 = (b2 - r0 * b1) / (1.0 - r0)
                t["c_m0"][i] += a_t * B_h * (rho0 / r0 + rho1)
                t["c_m1"][i] = -a_t * B_h * rho0 / r0
                t["c_mt"][i] = -a_t * B_h * rho1

    f32 = lambda a: np.asarray(a).astype(np.float32)
    return UniPCCoeffs(sigmas=f32(sigmas), timesteps=f32(timesteps),
                       sigma_cur=f32(sigmas[:N]),
                       **{k: f32(v) for k, v in t.items()})


class FlowUniPC:
    """UniPC sampler: `init_state`, then one `step` per model call."""

    def __init__(self, num_inference_steps: int = 50, shift: float = 8.0,
                 num_train_timesteps: int = 1000,
                 disable_corrector: Tuple[int, ...] = ()):
        self.num_steps = num_inference_steps
        self.coeffs = compute_unipc_coeffs(
            num_inference_steps, num_train_timesteps, shift,
            disable_corrector=disable_corrector)
        self.timesteps = self.coeffs.timesteps
        #: per-step coefficients as Python floats (the fp32 table values)
        self.table: List[Dict[str, float]] = [
            {k: float(getattr(self.coeffs, k)[i]) for k in TABLE_KEYS}
            for i in range(num_inference_steps)]

    @staticmethod
    def init_state(sample: torch.Tensor) -> dict:
        z = torch.zeros_like(sample, dtype=torch.float32)
        return {"sample": sample.float(), "m0": z, "m1": z, "last_sample": z}

    @staticmethod
    def step(coef: Dict[str, float], state: dict,
             flow_pred: torch.Tensor) -> dict:
        """One predictor(+corrector) update; all tensors fp32."""
        flow = flow_pred.float()
        sample = state["sample"]
        x0 = sample - coef["sigma_cur"] * flow
        if coef["use_corr"] > 0:
            sample = (coef["c_ax"] * state["last_sample"]
                      + coef["c_m0"] * state["m0"]
                      + coef["c_m1"] * state["m1"]
                      + coef["c_mt"] * x0)
        nxt = (coef["p_ax"] * sample + coef["p_m0"] * x0
               + coef["p_m1"] * state["m0"])
        return {"sample": nxt, "m0": x0, "m1": state["m0"],
                "last_sample": sample}
