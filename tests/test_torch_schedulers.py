"""Port parity: UniPC tables and steps, FlowMatch reseed (mmpl_tpu_torch vs
mmpl_tpu)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.schedulers.flow_match import FlowMatchScheduler as JFM
from mmpl_tpu.schedulers.unipc import FlowUniPC as JUniPC
from mmpl_tpu.schedulers.unipc import compute_unipc_coeffs as j_coeffs
from mmpl_tpu_torch.schedulers.flow_match import FlowMatchScheduler as TFM
from mmpl_tpu_torch.schedulers.unipc import FlowUniPC as TUniPC
from mmpl_tpu_torch.schedulers.unipc import compute_unipc_coeffs as t_coeffs


@pytest.mark.parametrize("steps,shift", [(2, 8.0), (4, 8.0), (50, 8.0),
                                         (50, 5.0)])
def test_unipc_tables_match(steps, shift):
    want, got = j_coeffs(steps, 1000, shift), t_coeffs(steps, 1000, shift)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


@pytest.mark.parametrize("steps", [4, 50])
def test_unipc_steps_match(steps):
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((1, 2, 3, 4)).astype(np.float32)
    jsamp, tsamp = JUniPC(steps), TUniPC(steps)
    js = jsamp.init_state(jnp.asarray(x))
    ts = tsamp.init_state(torch.from_numpy(x))
    for i in range(min(steps, 6)):
        flow = rng.standard_normal(x.shape).astype(np.float32)
        coef = {k: v[i] for k, v in jsamp.table.items()}
        js = JUniPC.step(coef, js, jnp.asarray(flow))
        ts = TUniPC.step(tsamp.table[i], ts, torch.from_numpy(flow))
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       atol=1e-6, err_msg=f"step {i} {k}")
    np.testing.assert_array_equal(tsamp.timesteps, np.asarray(jsamp.timesteps))


def test_flow_match_tables_and_add_noise_match():
    jfm = JFM(shift=8.0, sigma_min=0.0, extra_one_step=True)
    tfm = TFM(shift=8.0, sigma_min=0.0, extra_one_step=True)
    jfm.set_timesteps(1000, training=True)
    tfm.set_timesteps(1000, training=True)
    np.testing.assert_array_equal(tfm.sigmas, np.asarray(jfm.sigmas))
    np.testing.assert_array_equal(tfm.timesteps, np.asarray(jfm.timesteps))
    np.testing.assert_allclose(tfm.linear_timesteps_weights,
                               np.asarray(jfm.linear_timesteps_weights),
                               rtol=1e-6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 4, 2, 2)).astype(np.float32)
    n = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([500.0, 871.3], np.float32)
    want = np.asarray(jfm.add_noise(jnp.asarray(x), jnp.asarray(n),
                                    jnp.asarray(t)))
    got = tfm.add_noise(torch.from_numpy(x), torch.from_numpy(n),
                        torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("reseed_seed", [0, 5])
def test_reseed_timestep_is_pure_noise(reseed_seed):
    """The pipeline's reseed timestep (timesteps[idx] + 1000) resolves to
    sigma == 1.0, and matches the JAX pipeline's draw."""
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models.dit import init_dit_params
    from mmpl_tpu_torch.pipelines.fps_inference import \
        CausalFPSInferencePipeline
    cfg = tiny_test_config()
    model = init_dit_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
    pipe = CausalFPSInferencePipeline(cfg, model, sampling_steps=2,
                                      reseed_seed=reseed_seed)
    sigma = pipe.ddpm.sigma_of(torch.tensor([pipe.ddpm_timestep]))
    assert float(sigma[0]) == 1.0
    jfm = JFM(shift=8.0, sigma_min=0.0, extra_one_step=True)
    jfm.set_timesteps(1000, training=True)
    idx = int(np.random.default_rng(reseed_seed).integers(980, 1000))
    assert pipe.ddpm_timestep == float(np.asarray(jfm.timesteps)[idx]) + 1000.0
