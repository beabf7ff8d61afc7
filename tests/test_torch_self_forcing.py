"""Port parity: the self-forcing rollout (`training/self_forcing.py`).

Rollout outputs and the generator's gradients against
`mmpl_tpu.training.self_forcing.SelfForcingRollout` on the same weights,
noise and replayed draws: absolute slots, an initial latent, the i2v
independent first frame, the warped step list, last_step_only, per-block
flags, the rolling ring past its wrap, the gradient window, the int8
cache; the denoised-timestep range; `sample_num_frames`; and
`slice_last_window` with and without the VAE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.models import vae as jvae
from mmpl_tpu.training import self_forcing as jsf
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.training import self_forcing as tsf
from mmpl_tpu_torch.utils.jax_params import (dit_state_from_jax,
                                             vae_state_from_jax)
from test_torch_distill_draws import (B, C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, rollout_draws, schedulers, t)

STEPS = (1000, 750, 500, 250)


@pytest.fixture(scope="module")
def gen():
    return dit_pair(0)


def _ctx(p, m, seed=1):
    ctx = np.random.default_rng(seed).standard_normal(
        (B, 16, 64)).astype(np.float32)
    jkv = jdit.precompute_context_kv(p, j_tiny(), jdit.embed_text(
        p, jnp.asarray(ctx)))
    with torch.no_grad():
        tkv = tdit.precompute_context_kv(m, tiny_test_config(),
                                         tdit.embed_text(m, t(ctx)))
    return jkv, tkv


def grads_close(jg, model, tol=1e-4):
    """Every gradient within `tol` of the largest entry of its JAX
    counterpart (names carried as the weights are)."""
    want = dit_state_from_jax(jax.tree.map(np.asarray, jg),
                              tiny_test_config())
    got = {n: p.grad for n, p in model.named_parameters()}
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    assert scale > 0
    for n, w in want.items():
        g = got[n] if got[n] is not None else torch.zeros_like(w)
        err = float((g - w).abs().max())
        assert err <= tol * scale, (n, err, scale)


CASES = {
    # name: (rollout kwargs, F, n_init, exit flags)
    "absolute": (dict(), 6, 0, [1, 0]),
    "per_block_flags_grad_window": (dict(num_max_frames=9,
                                         grad_frame_window=3,
                                         same_step_across_blocks=False),
                                    9, 0, [3, 0, 2]),
    "last_step_only_int8_cache": (dict(last_step_only=True,
                                       quantize_cache=True), 6, 0, [3, 3]),
    "initial_latent_warped": (dict(warp_denoising_step=True,
                                   context_noise=250), 6, 3, [2, 1]),
    "independent_first_frame": (dict(independent_first_frame=True,
                                     same_step_across_blocks=False), 7, 0,
                                [1, 2, 0]),
    "rolling_wrap": (dict(num_max_frames=6, grad_frame_window=6,
                          rolling=True, same_step_across_blocks=False),
                     12, 0, [1, 2, 0, 3]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_and_grads_match(gen, case):
    kw, F, n_init, flags = CASES[case]
    p, m = gen
    js, ts = schedulers()
    jro = jsf.SelfForcingRollout(j_tiny(), js, STEPS, **kw)
    tro = tsf.SelfForcingRollout(tiny_test_config(), ts, STEPS, **kw)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    init = (rng.standard_normal((B, n_init, C, H, W)).astype(np.float32)
            if n_init else None)
    total = F + n_init
    wgt = rng.standard_normal((B, total, C, H, W)).astype(np.float32)
    jkv, tkv = _ctx(p, m)
    key = jax.random.PRNGKey(11)
    jflags = jnp.asarray(flags, jnp.int32)

    def jloss(params):
        out, tf, tt = jro.rollout(params, jkv, jnp.asarray(noise), jflags,
                                  key, initial_latent=None if init is None
                                  else jnp.asarray(init))
        return jnp.sum(out * wgt), (out, tf, tt)

    (_, (jout, jtf, jtt)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(p)

    first = 1 if kw.get("independent_first_frame") and not n_init else 0
    sizes = [1] * first + [3] * ((F - first) // 3)
    draws = rollout_draws(key, sizes, len(tro.steps), n_init,
                          cap=kw.get("num_max_frames", 21),
                          rolling=kw.get("rolling", False) and total > kw.get(
                              "num_max_frames", 21))
    m.zero_grad(set_to_none=True)
    m.requires_grad_(True)
    try:
        out, tf, tt = tro.rollout(m, tkv, t(noise), torch.tensor(flags),
                                  draws=draws,
                                  initial_latent=None if init is None
                                  else t(init))
        (out * t(wgt)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        if kw.get("same_step_across_blocks", True):
            assert (tf, tt) == (int(jtf), int(jtt))
        else:
            assert tf is None and jtf is None
        grads_close(jg, m)
    finally:
        m.requires_grad_(False)
        m.zero_grad(set_to_none=True)


def test_rolling_commits_do_not_reach_earlier_recomputation(gen):
    """The steady-state ring reuses slots: the graded blocks' gradients
    must not change when the later commits write the slots they read
    (held by the JAX gradients in `rolling_wrap`), and the ring's
    functional commits leave the cache they replace untouched."""
    p, m = gen
    js, ts = schedulers()
    tro = tsf.SelfForcingRollout(tiny_test_config(), ts, STEPS,
                                 num_max_frames=6, grad_frame_window=12,
                                 rolling=True)
    _, tkv = _ctx(p, m)
    noise = torch.randn((B, 12, C, H, W), generator=torch.Generator()
                        .manual_seed(3))
    m.requires_grad_(True)
    try:
        for remat in (True, False):
            tro.remat = remat
            m.zero_grad(set_to_none=True)
            out, _, _ = tro.rollout(m, tkv, noise, torch.tensor([2]),
                                    generator=torch.Generator()
                                    .manual_seed(4))
            out.square().sum().backward()
            g = {n: q.grad.clone() for n, q in m.named_parameters()
                 if q.grad is not None}
            if remat:
                want = g
        for n in want:
            torch.testing.assert_close(g[n], want[n], rtol=1e-5, atol=1e-6)
    finally:
        m.requires_grad_(False)
        m.zero_grad(set_to_none=True)


def test_sample_num_frames_matches():
    for iff, lo, hi in ((False, 21, 33), (True, 21, 37)):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(6):
            assert tsf.sample_num_frames(a, lo, hi, 4 if iff else 3, iff) \
                == jsf.sample_num_frames(b, lo, hi, 4 if iff else 3, iff)


def _numpy_vae(seed):
    """A random VAE tree in `init_vae_params`' layout, filled by numpy
    (the JAX package's own init takes ~20 s on the CPU): kernels
    N(0, 1/fan_in), unit gammas, zero biases."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (np.ones if name == "gamma" else np.zeros)(
            leaf.shape, np.float32)

    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, jnp.float32),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("with_vae,iff", [(False, False), (True, False),
                                          (False, True)])
def test_slice_last_window_matches(with_vae, iff):
    rng = np.random.default_rng(2)
    F, window = 4, 3
    x0 = rng.standard_normal((B, F, 16, 2, 2)).astype(np.float32)
    vae_j = vae_t = None
    if with_vae:
        vae_j = _numpy_vae(4)
        vae_t = tvae.empty_vae(torch.float32)
        vae_t.load_state_dict(vae_state_from_jax(
            jax.tree.map(np.asarray, vae_j)))
    jw, jm = jax.jit(lambda x, v: jsf.slice_last_window(
        x, window, 3, v, independent_first_frame=iff))(jnp.asarray(x0), vae_j)
    xt = t(x0).requires_grad_(True)
    tw, tm = tsf.slice_last_window(xt, window, 3, vae_t,
                                   independent_first_frame=iff)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                               rtol=1e-4, atol=1e-4)
    assert tm.numpy().tolist() == np.asarray(jm).tolist()
    tw.sum().backward()      # gradients reach the kept frames only
    kept = window - 1 if with_vae else window
    assert float(xt.grad[:, F - kept:].abs().min()) == 1.0
    assert float(xt.grad[:, :F - kept].abs().max()) == 0.0
    same, none = tsf.slice_last_window(xt, F)
    assert same is xt and none is None
