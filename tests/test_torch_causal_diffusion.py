"""Port parity: `pipelines/causal_diffusion_inference.py`.

`CausalDiffusionInferencePipeline` (3-frame blocks, each by a 2-step
UniPC loop over the batched CFG pair, committed clean) against
`mmpl_tpu.pipelines.causal_diffusion_inference` on the same weights and
noise, with and without an initial latent (fp32 within 1e-5 relative),
and with int8 projections and the int8 cache at the bound of
`test_torch_quant.py`'s int8 window (5e-3 relative: W8A8 codes flip where
an fp32 rounding difference crosses a rounding boundary)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.pipelines.causal_diffusion_inference import \
    CausalDiffusionInferencePipeline as JPipe
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.pipelines.causal_diffusion_inference import \
    CausalDiffusionInferencePipeline as TPipe
from test_torch_distill_draws import (B, C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, t)


@pytest.mark.parametrize("n_init,quantize,bound", [
    (0, None, 1e-5), (2, None, 1e-5), (0, "int8", 5e-3)])
def test_latents_match(n_init, quantize, bound):
    p, m = dit_pair(0)
    kw = dict(sampling_steps=2, timestep_shift=8.0, guidance_scale=5.0,
              local_attn_frames=6, quantize=quantize,
              quantize_cache=quantize is not None)
    jpipe = JPipe(j_tiny(), p, dtype=jnp.float32, **kw)
    tpipe = TPipe(tiny_test_config(), m, dtype=torch.float32, **kw)
    rng = np.random.default_rng(n_init)
    noise = rng.standard_normal((B, 8, C, H, W)).astype(np.float32)
    cond, uncond = (rng.standard_normal((B, 16, 64)).astype(np.float32)
                    for _ in range(2))
    init = (rng.standard_normal((B, n_init, C, H, W)).astype(np.float32)
            if n_init else None)
    want = np.asarray(jpipe.inference(
        jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(uncond),
        initial_latent=None if init is None else jnp.asarray(init)))
    got = tpipe.inference(t(noise), t(cond), t(uncond),
                          initial_latent=None if init is None
                          else t(init)).numpy()
    assert got.shape == want.shape == (B, n_init + 8, C, H, W)
    assert np.isfinite(got).all()
    assert np.abs(got[:, n_init:] - noise).mean() > 1e-3
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= bound, rel
    if init is not None:
        np.testing.assert_array_equal(got[:, :n_init], init)
    if quantize:
        assert tpipe.quantize_cache
