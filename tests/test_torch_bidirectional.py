"""Port parity: `pipelines/bidirectional_inference.py`.

`BidirectionalDiffusionInferencePipeline` (2-step UniPC with CFG) and
`BidirectionalInferencePipeline` (few-step, with its re-noising draws
replayed from the JAX key chain) against `mmpl_tpu`'s on the same weights
and noise, within 1e-5 relative; the few-step sampler's draws come from
its generator when none are handed in."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.pipelines import bidirectional_inference as jbi
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.pipelines import bidirectional_inference as tbi
from test_torch_distill_draws import (B, C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, normal, t)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_diffusion_pipeline_matches():
    p, m = dit_pair(0)
    kw = dict(sampling_steps=2, timestep_shift=8.0, guidance_scale=5.0)
    jpipe = jbi.BidirectionalDiffusionInferencePipeline(
        j_tiny(), p, dtype=jnp.float32, **kw)
    tpipe = tbi.BidirectionalDiffusionInferencePipeline(
        tiny_test_config(), m, dtype=torch.float32, **kw)
    rng = np.random.default_rng(0)
    noise = rng.standard_normal((B, 3, C, H, W)).astype(np.float32)
    cond, uncond = (rng.standard_normal((B, 16, 64)).astype(np.float32)
                    for _ in range(2))
    want = np.asarray(jpipe.inference(jnp.asarray(noise), jnp.asarray(cond),
                                      jnp.asarray(uncond)))
    got = tpipe.inference(t(noise), t(cond), t(uncond)).numpy()
    assert got.shape == want.shape == noise.shape
    assert np.abs(got - noise).mean() > 1e-3
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def test_fewstep_pipeline_matches():
    p, m = dit_pair(0)
    steps = (1000, 750, 500, 250)
    jpipe = jbi.BidirectionalInferencePipeline(j_tiny(), p, steps,
                                               dtype=jnp.float32)
    tpipe = tbi.BidirectionalInferencePipeline(tiny_test_config(), m, steps,
                                               dtype=torch.float32)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((B, 3, C, H, W)).astype(np.float32)
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jpipe.inference(jnp.asarray(noise), jnp.asarray(cond),
                                      rng=key))
    draws, k = [], key
    for _ in steps[1:]:
        k, sub = jax.random.split(k)
        draws.append(normal(sub, noise.shape))
    got = tpipe.inference(t(noise), t(cond), step_noise=draws).numpy()
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    a, b = (tpipe.inference(t(noise), t(cond),
                            generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and not np.allclose(a.numpy(), got)
