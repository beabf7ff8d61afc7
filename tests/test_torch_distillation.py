"""Port parity: the distillation losses (`training/distillation.py`,
`training/gan.py`, `training/losses.py`).

DMD (with and without the last-window slice), SiD, CausVid (fake-score
CFG), the critic, the GAN generator and critic (R1 / R2) and the ODE
regression loss, each with its gradients into the modules it trains,
against `mmpl_tpu.training.distillation.Distiller` on the same weights and
replayed draws; `dit_forward_classify`'s logits; the loss registry;
`shift_timestep` and `prepare_ode_generator_input`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.training import distillation as jd
from mmpl_tpu.training import gan as jgan
from mmpl_tpu.training import losses as jl
from mmpl_tpu.training import self_forcing as jsf
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.training import distillation as td
from mmpl_tpu_torch.training import gan as tgan
from mmpl_tpu_torch.training import losses as tl
from mmpl_tpu_torch.training import self_forcing as tsf
from mmpl_tpu_torch.utils.jax_params import (dit_state_from_jax,
                                             gan_head_state_from_jax)
from test_torch_distill_draws import (B, C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, distill_draws, normal,
                                      schedulers, t)

STEPS = (1000, 750, 500, 250)


@pytest.fixture(scope="module")
def bundle():
    """JAX and torch model bundles: generator, fake and real scores, GAN
    head; the batch's contexts."""
    (pg, mg), (pf, mf), (pr, mr) = dit_pair(0), dit_pair(10), dit_pair(11)
    jh = jgan.init_gan_head_params(jax.random.PRNGKey(12), atten_dim=96,
                                   ffn_dim=256, num_heads=4)
    th = tgan.GanHead(96, ffn_dim=256)
    th.load_state_dict(gan_head_state_from_jax(jax.tree.map(np.asarray, jh)))
    th.requires_grad_(False)
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((B, 16, 64)).astype(np.float32)
    return ({"generator": pg, "fake_score": pf, "real_score": pr,
             "gan_head": jh},
            {"generator": mg, "fake_score": mf, "real_score": mr,
             "gan_head": th}, ctx)


def _batches(jm, tm, ctx, F, real=False):
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    cfg, tcfg = j_tiny(), tiny_test_config()
    jkv = jdit.precompute_context_kv(jm["generator"], cfg, jdit.embed_text(
        jm["generator"], jnp.asarray(ctx)))
    with torch.no_grad():
        tkv = tdit.precompute_context_kv(tm["generator"], tcfg,
                                         tdit.embed_text(tm["generator"],
                                                         t(ctx)))
    jb = {"noise": jnp.asarray(noise), "ctx_kv": jkv,
          "context": jnp.asarray(ctx),
          "uncond_context": jnp.zeros_like(jnp.asarray(ctx))}
    tb = {"noise": t(noise), "ctx_kv": tkv, "context": t(ctx),
          "uncond_context": torch.zeros_like(t(ctx))}
    if real:
        r = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
        jb["real_latents"], tb["real_latents"] = jnp.asarray(r), t(r)
    return jb, tb


def _close_grads(want_tree, module, convert, tol=1e-4):
    want = convert(jax.tree.map(np.asarray, want_tree))
    got = {n: p.grad for n, p in module.named_parameters()}
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    assert scale > 0
    for n, w in want.items():
        g = got[n] if got[n] is not None else torch.zeros_like(w)
        err = float((g - w).abs().max())
        assert err <= tol * scale, (n, err, scale)


_dit = lambda tree: dit_state_from_jax(tree, tiny_test_config())

# name: (loss, trained keys, DistillationConfig kwargs, draw kind, F,
#        rollout kwargs)
CASES = {
    "dmd": ("dmd_generator_loss", ("generator",), {}, "dmd", 3, {}),
    "dmd_window": ("dmd_generator_loss", ("generator",),
                   dict(window_frames=6), "dmd", 9,
                   dict(same_step_across_blocks=False)),
    "sid": ("sid_generator_loss", ("generator",), {}, "sid", 3, {}),
    "causvid": ("causvid_generator_loss", ("generator",),
                dict(fake_guidance_scale=2.0, ts_schedule=False), "dmd", 3,
                {}),
    "critic": ("critic_loss", ("fake_score",), dict(ts_schedule_max=True),
               "critic", 3, {}),
    "gan_generator": ("gan_generator_loss", ("generator",),
                      dict(relativistic_discriminator=True), "gan_gen", 3,
                      {}),
    # the finite-difference penalties divide the difference of two fp32
    # logits by sigma, so the packages' rounding (~1e-7) grows by 1/sigma
    # (the losses part by ~3e-5 relative at the default 0.01 and ~1.4e-5
    # at 0.1); at sigma 1 the comparison holds at the loss tolerance
    "gan_critic": ("gan_critic_loss", ("fake_score", "gan_head"),
                   dict(r1_weight=0.5, r2_weight=0.25, r1_sigma=1.0,
                        r2_sigma=1.0), "gan_critic", 3, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match(bundle, case):
    name, trained, dkw, kind, F, rkw = CASES[case]
    jm, tm, ctx = bundle
    js, ts = schedulers(5.0)
    jro = jsf.SelfForcingRollout(j_tiny(), js, STEPS, **rkw)
    tro = tsf.SelfForcingRollout(tiny_test_config(), ts, STEPS, **rkw)
    jdist = jd.Distiller(j_tiny(), jd.DistillationConfig(
        timestep_shift=5.0, real_guidance_scale=3.0, **dkw), jro, js)
    tdist = td.Distiller(tiny_test_config(), td.DistillationConfig(
        timestep_shift=5.0, real_guidance_scale=3.0, **dkw), tro, ts)
    jb, tb = _batches(jm, tm, ctx, F, real=kind.startswith("gan"))
    key = jax.random.PRNGKey(21)

    def jloss(sub):
        loss, log = getattr(jdist, name)({**jm, **sub}, jb, key)
        return loss, log

    (jval, jlog), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jm[k] for k in trained})

    window = dkw.get("window_frames") or F
    draws = distill_draws(key, jro, [3] * (F // 3), len(tro.steps),
                          (B, window, C, H, W), kind=kind)
    for k in trained:
        tm[k].requires_grad_(True)
    try:
        loss, log = getattr(tdist, name)(tm, tb, draws)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5,
                                   atol=1e-7)
        for k, v in jlog.items():
            np.testing.assert_allclose(log[k].item(), float(v), rtol=1e-5,
                                       atol=1e-6)
        for k in trained:
            _close_grads(jg[k], tm[k], gan_head_state_from_jax
                         if k == "gan_head" else _dit)
    finally:
        for k in trained:
            tm[k].requires_grad_(False)
            tm[k].zero_grad(set_to_none=True)


def test_ode_regression_loss_and_grads_match(bundle):
    """Gradients through the cache's commits (functional writes under
    per-layer recomputation) at 9 frames."""
    jm, tm, ctx = bundle
    js, ts = schedulers()
    steps = (1000, 750, 500)
    F = 9
    rng = np.random.default_rng(4)
    ode = rng.standard_normal((B, len(steps) + 1, F, C, H, W)).astype(
        np.float32)
    idx_key = jax.random.PRNGKey(5)
    jb, tb = _batches(jm, tm, ctx, 3)
    jnoisy, jt = jd.prepare_ode_generator_input(jnp.asarray(ode), steps,
                                                idx_key)
    idx = t(jax.random.randint(idx_key, (B, F // 3), 0, len(steps)))
    tnoisy, tt = td.prepare_ode_generator_input(t(ode), steps, idx)
    np.testing.assert_array_equal(tnoisy.numpy(), np.asarray(jnoisy))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))

    jbatch = {"noisy_input": jnoisy, "clean_latent": jnp.asarray(ode[:, -1]),
              "timestep": jt, "ctx_kv": jb["ctx_kv"]}
    (jval, jlog), jg = jax.jit(jax.value_and_grad(
        lambda p: jd.ode_regression_loss(p, j_tiny(), js, jbatch,
                                         jax.random.PRNGKey(0)),
        has_aux=True))(jm["generator"])
    g = tm["generator"]
    g.requires_grad_(True)
    try:
        loss, log = td.ode_regression_loss(
            g, tiny_test_config(), ts,
            {"noisy_input": tnoisy, "clean_latent": t(ode[:, -1]),
             "timestep": tt, "ctx_kv": tb["ctx_kv"]})
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
        np.testing.assert_allclose(log["pred"].detach().numpy(),
                                   np.asarray(jlog["pred"]), rtol=1e-5,
                                   atol=1e-5)
        _close_grads(jg, g, _dit)
    finally:
        g.requires_grad_(False)
        g.zero_grad(set_to_none=True)


@pytest.mark.parametrize("concat_t", [False, True])
def test_dit_forward_classify_matches(bundle, concat_t):
    jm, tm, ctx = bundle
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, C, H, W)).astype(np.float32)
    tt = np.array([500.0, 120.0], np.float32)
    jh, th = jm["gan_head"], tm["gan_head"]
    if concat_t:
        jh = jgan.init_gan_head_params(jax.random.PRNGKey(13), atten_dim=96,
                                       ffn_dim=256, time_embed_dim=96)
        th = tgan.GanHead(96, time_embed_dim=96, ffn_dim=256)
        th.load_state_dict(gan_head_state_from_jax(
            jax.tree.map(np.asarray, jh)))
    c2 = np.concatenate([ctx, ctx])
    want = jgan.dit_forward_classify(jm["fake_score"], jh, j_tiny(),
                                     jnp.asarray(x), jnp.asarray(tt),
                                     jnp.asarray(c2),
                                     concat_time_embeddings=concat_t)
    with torch.no_grad():
        got = tgan.dit_forward_classify(tm["fake_score"], th,
                                        tiny_test_config(), t(x), t(tt),
                                        t(c2),
                                        concat_time_embeddings=concat_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    lr, lf = t(want)[:1], t(want)[1:]
    np.testing.assert_allclose(
        float(tgan.r3gan_critic_loss(lr, lf)),
        float(jgan.r3gan_critic_loss(jnp.asarray(lr.numpy()),
                                     jnp.asarray(lf.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tgan.r3gan_generator_loss(lf)),
        float(jgan.r3gan_generator_loss(jnp.asarray(lf.numpy()))),
        rtol=1e-6)


def test_gan_taps_match():
    for L in (2, 5, 30):
        cfg = dict(j_tiny(), num_layers=L)
        taps = [i for i in jgan.GAN_TAP_LAYERS if i < L]
        if len(taps) != 3:
            taps = sorted(min(L - 1, max(0, round((j + 1) * L / 3) - 1))
                          for j in range(3))
        assert tgan.gan_tap_layers(cfg["num_layers"], 3) == taps


@pytest.mark.parametrize("kind", ["x0", "v", "noise", "flow"])
def test_denoising_losses_match(kind):
    rng = np.random.default_rng(8)
    x, noise, pred = (rng.standard_normal((2, 3, 4)).astype(np.float32)
                      for _ in range(3))
    acp = np.linspace(0.99, 0.01, 1000).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    kw = {"x": x, "noise": noise, "x_pred": pred, "v_pred": pred,
          "noise_pred": pred, "flow_pred": pred, "alphas_cumprod": acp,
          "timestep": ts}
    want = jl.get_denoising_loss(kind)(**{k: jnp.asarray(v)
                                          for k, v in kw.items()})
    got = tl.get_denoising_loss(kind)(**{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_shift_timestep_matches():
    v = np.array([[0.0, 20.0, 500.0, 999.0]], np.float32)
    for s in (1.0, 5.0, 8.0):
        np.testing.assert_allclose(
            td.shift_timestep(t(v), s).numpy(),
            np.asarray(jd.shift_timestep(jnp.asarray(v), s)), rtol=1e-6)


def test_normal_replay_helper():
    k = jax.random.PRNGKey(0)
    assert torch.equal(normal(k, (2, 3)), t(jax.random.normal(k, (2, 3))))
