"""Port parity: DPM-Solver++ (`schedulers/dpm_solver.py`) and the FPS
window with `sample_solver="dpm++"`.

The sigma schedule, the log-SNR guard and the coefficient tables equal
`mmpl_tpu.schedulers.dpm_solver`'s; one sampler step matches; a 2-step
planned window with DPM-Solver++ matches the JAX pipeline on the same
weights, noise and replayed re-seed draws (the setup of
`test_fps_pipeline.py::test_fps_pipeline_dpm_solver`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.pipelines.fps_inference import CausalFPSInferencePipeline \
    as JPipe
from mmpl_tpu.schedulers import dpm_solver as jdpm
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.pipelines.fps_inference import CausalFPSInferencePipeline \
    as TPipe
from mmpl_tpu_torch.schedulers import dpm_solver as tdpm
from mmpl_tpu_torch.schedulers.unipc import FlowUniPC
from test_torch_distill_draws import (B, C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, t)


@pytest.mark.parametrize("steps,shift", [(2, 8.0), (4, 5.0), (50, 8.0),
                                         (1, 3.0)])
def test_tables_equal(steps, shift):
    np.testing.assert_array_equal(tdpm.get_sampling_sigmas(steps, shift),
                                  jdpm.get_sampling_sigmas(steps, shift))
    for a, b in zip(tdpm.compute_dpm_coeffs(steps, shift),
                    jdpm.compute_dpm_coeffs(steps, shift)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    s = tdpm.FlowDPMSolver(steps, shift=shift)
    js = jdpm.FlowDPMSolver(steps, shift=shift)
    np.testing.assert_array_equal(s.timesteps, np.asarray(js.timesteps))
    for k in tdpm.TABLE_KEYS:
        assert [c[k] for c in s.table] == np.asarray(js.table[k]).tolist()


def test_lambda_limits():
    for sig in (1.0, 0.0, 0.3):
        assert tdpm._lambda(sig) == jdpm._lambda(sig)


def test_step_matches():
    rng = np.random.default_rng(0)
    x, flow = (rng.standard_normal((2, 16, 4, 4)).astype(np.float32)
               for _ in range(2))
    s, js = tdpm.FlowDPMSolver(4), jdpm.FlowDPMSolver(4)
    st, jst = s.init_state(t(x)), js.init_state(jnp.asarray(x))
    for i in range(4):
        st = s.step(s.table[i], st, t(flow) * (i + 1))
        jst = js.step({k: v[i] for k, v in js.table.items()}, jst,
                      jnp.asarray(flow) * (i + 1))
        assert set(st) == set(jst) == {"sample", "m0"}
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-6, atol=1e-6)


def _reseed_noise(rng, plan):
    out = {}
    for gi, g in enumerate(plan.groups):
        rng, sub = jax.random.split(rng)
        if g.reseed:
            keys = jax.random.split(sub, len(g.reseed))
            out[gi] = torch.cat([t(jax.random.normal(k, (B, 1, C, H, W),
                                                     jnp.float32))
                                 for k in keys], 1)
    return out


def test_window_dpm_matches():
    p, m = dit_pair(0, head_seed=99)
    jpipe = JPipe(j_tiny(), p, sampling_steps=2, sample_solver="dpm++",
                  dtype=jnp.float32)
    tpipe = TPipe(tiny_test_config(), m, sampling_steps=2,
                  sample_solver="dpm++", dtype=torch.float32)
    assert isinstance(tpipe.sampler, tdpm.FlowDPMSolver)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((B, 21, C, H, W)).astype(np.float32)
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    uncond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jpipe.inference(jnp.asarray(noise), jnp.asarray(cond),
                                      jnp.asarray(uncond), rng=key))
    got = tpipe.inference(t(noise), t(cond), t(uncond),
                          reseed_noise=_reseed_noise(key, tpipe.plan)).numpy()
    assert got.shape == want.shape == (B, 21, C, H, W)
    assert np.isfinite(got).all() and np.abs(got - noise).mean() > 1e-3
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def test_unknown_solver_is_refused():
    _, m = dit_pair(0)
    with pytest.raises(NotImplementedError, match="euler"):
        TPipe(tiny_test_config(), m, sampling_steps=2, sample_solver="euler")
    assert isinstance(TPipe(tiny_test_config(), m, sampling_steps=2).sampler,
                      FlowUniPC)
