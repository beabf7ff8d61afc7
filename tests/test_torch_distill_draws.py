"""Shared set-up of the distillation parity tests: the tiny models carried
from the JAX trees, and the JAX package's key chains replayed as the
draws that the port's rollout and losses take as tensors
(`mmpl_tpu/training/self_forcing.py`, `distillation.py`).  Its own tests
hold the replayed exit flags and score-timestep draws against the JAX
functions that make them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.schedulers.flow_match import FlowMatchScheduler as JFM
from mmpl_tpu.training import self_forcing as jsf
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.schedulers.flow_match import FlowMatchScheduler as TFM
from mmpl_tpu_torch.training import self_forcing as tsf
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax

B, C, H, W = 1, 16, 4, 4


def few_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    return n


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = few_threads()
    yield
    torch.set_num_threads(n)


def schedulers(shift=8.0):
    js, ts = JFM(shift=shift, sigma_min=0.0, extra_one_step=True), \
        TFM(shift=shift, sigma_min=0.0, extra_one_step=True)
    js.set_timesteps(1000, training=True)
    ts.set_timesteps(1000, training=True)
    return js, ts


def dit_pair(seed, head_seed=None):
    """(JAX params, fp32 torch WanDiT) of the tiny config from one seed,
    with a random head (a zero head makes every flow vacuous)."""
    p = jdit.init_dit_params(jax.random.PRNGKey(seed), j_tiny(), jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(head_seed if head_seed is not None else 99 + seed),
        p["head"]["head"]["kernel"].shape)
    tcfg = tiny_test_config()
    m = tdit.empty_dit(tcfg, fused=False, dtype=torch.float32)
    m.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, p), tcfg))
    return p, m


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def normal(key, shape):
    return t(jax.random.normal(key, shape, jnp.float32))


def block_draws(key, S, shape):
    """One block's draws of `one_block`: S - 1 re-noising keys split off the
    carry whatever the flag, then the commit key.  Returns (draws, key)."""
    steps = []
    for _ in range(S - 1):
        key, k = jax.random.split(key)
        steps.append(normal(k, shape))
    key, k = jax.random.split(key)
    return {"step": steps, "commit": normal(k, shape)}, key


def rollout_draws(rng, sizes, S, n_init=0, cap=None, rolling=False):
    """The rollout's draws per denoised block: the absolute-slot blocks
    chain one key; the rolling steady state splits its keys at once."""
    out = []
    start = n_init
    b = 0
    while b < len(sizes) and (not rolling or start + sizes[b] <= cap):
        d, rng = block_draws(rng, S, (B, sizes[b], C, H, W))
        out.append(d)
        start += sizes[b]
        b += 1
    if b < len(sizes):
        keys = jax.random.split(rng, len(sizes) - b + 1)
        for i, g in enumerate(sizes[b:]):
            out.append(block_draws(keys[1 + i], S, (B, g, C, H, W))[0])
    return out


def rollout_keys(rng, ro, nblocks):
    """`Distiller._rollout`'s split: exit flags from the first key, the
    rollout from the second."""
    r1, r2 = jax.random.split(rng)
    flags = ro.sample_exit_flags(r1, nblocks)
    return t(flags).long(), r2


def distill_draws(rng, jro, sizes, S, shape_x0, n_init=0, cap=None,
                  rolling=False, kind="dmd"):
    """The draws of one Distiller loss from its key, by name, for `kind`
    in dmd / sid / critic (r1 rollout, r2 u, r3 noise), gan_gen (four keys:
    rollout, u, fake noise, real noise) and gan_critic (three keys; the
    first split four ways as gan_gen's, then R1's and R2's eps)."""
    if kind in ("dmd", "sid", "critic"):
        r1, r2, r3 = jax.random.split(rng, 3)
        extra = {"noise": normal(r3, shape_x0)}
    elif kind == "gan_gen":
        r1, r2, r3, r4 = jax.random.split(rng, 4)
        extra = {"noise_fake": normal(r3, shape_x0),
                 "noise_real": normal(r4, shape_x0)}
    else:
        r_main, r_r1, r_r2 = jax.random.split(rng, 3)
        r1, r2, r3, _ = jax.random.split(r_main, 4)
        extra = {"noise_fake": normal(r3, shape_x0),
                 "eps_r1": normal(r_r1, shape_x0),
                 "eps_r2": normal(r_r2, shape_x0)}
    flags, rb = rollout_keys(r1, jro, len(sizes))
    return {"exit_flags": flags,
            "rollout": rollout_draws(rb, sizes, S, n_init, cap, rolling),
            "u": t(jax.random.uniform(r2, (shape_x0[0], 1))), **extra}


def test_exit_flags_replay():
    js, ts = schedulers()
    jro = jsf.SelfForcingRollout(j_tiny(), js, (1000, 750, 500, 250))
    flags, _ = rollout_keys(jax.random.PRNGKey(3), jro, 5)
    r1, _ = jax.random.split(jax.random.PRNGKey(3))
    assert flags.tolist() == np.asarray(
        jax.random.randint(r1, (5,), 0, 4)).tolist()
    tro = tsf.SelfForcingRollout(tiny_test_config(), ts,
                                 (1000, 750, 500, 250), last_step_only=True)
    assert tro.sample_exit_flags(None, 3).tolist() == [3, 3, 3]


@pytest.mark.parametrize("flag", [0, 1, 3])
def test_denoised_range_matches(flag):
    """t_from / t_to of the flag against the JAX rollout's formula."""
    js, ts = schedulers(5.0)
    jro = jsf.SelfForcingRollout(j_tiny(), js, (1000, 750, 500, 250),
                                 warp_denoising_step=True)
    tro = tsf.SelfForcingRollout(tiny_test_config(), ts,
                                 (1000, 750, 500, 250),
                                 warp_denoising_step=True)
    assert tro.steps == tuple(float(np.float32(s)) for s in jro.steps)
    tsj = np.asarray(js.timesteps)
    vals = np.asarray(jro.steps, np.float32)
    idx = lambda v: 1000 - int(np.argmin(np.abs(tsj - v)))
    want_to = 0 if flag == 3 else idx(vals[flag + 1])
    assert tro.denoised_range(torch.tensor([flag, 0])) == (idx(vals[flag]),
                                                           want_to)
