"""Port parity: `mmpl_tpu_torch/data/ode_gen.py` against
`mmpl_tpu/data/ode_gen.py`.

`record_trajectories` at `tiny_test_config` in f32, 6 UniPC steps with
CFG, on the same weights, noise and text states: within 1e-5 relative
(`test_torch_bidirectional.py`'s tolerance), entry 0 the noise itself,
the picks JAX's `argmin` makes (a step list whose entries share a step
too).  The shards round-trip across the two packages, with and without
`prompt_embeds`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.data import ode_gen as jog
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.data import ode_gen as tog
from test_torch_distill_draws import (C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, t)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("steps", [(1000, 750, 500, 250), (1000, 990, 0)])
def test_record_trajectories_matches_jax(steps):
    p, m = dit_pair(2)
    rng = np.random.default_rng(3)
    B, F = 2, 3
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    cond, uncond = (rng.standard_normal((B, 16, 64)).astype(np.float32)
                    for _ in range(2))
    kw = dict(denoising_step_list=steps, sampling_steps=6,
              guidance_scale=5.0, timestep_shift=8.0)
    want = jog.record_trajectories(j_tiny(), p, jnp.asarray(noise),
                                   jnp.asarray(cond), jnp.asarray(uncond),
                                   dtype=jnp.float32, **kw)
    got = tog.record_trajectories(tiny_test_config(), m, t(noise), t(cond),
                                  t(uncond), dtype=torch.float32, **kw)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (B, len(steps) + 1, F, C, H, W)
    assert torch.equal(got[:, 0], t(noise))
    assert np.abs(want[:, -1] - noise).mean() > 1e-2
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)


def test_ode_shards_round_trip_across_the_two_packages(tmp_path):
    rng = np.random.default_rng(4)
    traj = rng.standard_normal((2, 5, 3, C, H, W)).astype(np.float32)
    emb = rng.standard_normal((2, 16, 64)).astype(np.float32)
    prompts = ["a cat", "a dog"]
    jog.write_ode_shard(str(tmp_path / "jax" / "ode_00000.npz"), traj,
                        prompts, emb)
    tog.write_ode_shard(str(tmp_path / "port" / "ode_00000.npz"), t(traj),
                        prompts, t(emb))
    tog.write_ode_shard(str(tmp_path / "bare" / "ode_00000.npz"), traj,
                        prompts)
    for src in ("jax", "port", "bare"):
        readers = [m.ODERegressionNpzDataset(str(tmp_path / src))
                   for m in (jog, tog)]
        assert [len(r) for r in readers] == [2, 2]
        for i in range(2):
            a, b = (r[i] for r in readers)
            assert set(a) == set(b) == ({"ode_latent", "prompts"} | (
                set() if src == "bare" else {"prompt_embeds"}))
            assert a["prompts"] == b["prompts"] == prompts[i]
            for k in set(a) - {"prompts"}:
                assert b[k].dtype == np.float32
                np.testing.assert_array_equal(b[k], a[k])
            np.testing.assert_array_equal(
                b["ode_latent"], traj[i].astype(np.float16).astype(
                    np.float32))
    zj, zt = (np.load(tmp_path / s / "ode_00000.npz", allow_pickle=True)
              for s in ("jax", "port"))
    assert zt["ode_latent"].dtype == zt["prompt_embeds"].dtype == np.float16
    for k in ("ode_latent", "prompt_embeds", "prompts"):
        np.testing.assert_array_equal(zt[k], zj[k])
