"""Port parity: the image-conditioned (i2v) window plan, the one-frame VAE
encode of the image, i2v windows of the planned-window pipeline and the
CLI's `--image` in smoke mode (mmpl_tpu_torch vs mmpl_tpu)."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mmpl_tpu import cli as jcli
from mmpl_tpu.core import geometry as jg
from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.models import vae as jvae
from mmpl_tpu.pipelines import fps_inference as jfps
from mmpl_tpu_torch import cli
from mmpl_tpu_torch.core import geometry as tg
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.pipelines import fps_inference as tfps
from mmpl_tpu_torch.utils.device import set_float32_precision
from mmpl_tpu_torch.utils.jax_params import (dit_state_from_jax,
                                             vae_state_from_jax)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, C, H, W = 1, 16, 4, 4
STEPS = 2


def test_i2v_plan_matches_field_by_field():
    want, got = jg.i2v_plan(), tg.i2v_plan()
    assert tg.I2V_CLEAN_STEPS == jg.I2V_CLEAN_STEPS
    for field in ("name", "clean_steps", "anchor_group_index",
                  "handoff_frames", "num_frames", "group_sizes"):
        assert getattr(got, field) == getattr(want, field), field
    for gw, gg in zip(want.groups, got.groups):
        assert dataclasses.asdict(gg) == dataclasses.asdict(gw)
    assert got.group_sizes == (1, 1, 7, 6, 6)
    assert got.anchor_group_index == 2
    assert got.handoff_frames == (0, 19, 20)
    assert [g.append_mode for g in got.groups] == [False] * 4 + [True]
    assert all(not g.reseed for g in got.groups)


def test_i2v_plan_attention_lengths():
    """The keys each i2v group attends to, in frames: group 0 itself,
    group 1 frames {0, 1}, group 3 the 15 cached frames, group 4 (append)
    the 15 cached and its own 6."""
    plan = tg.i2v_plan()
    keys = [g.num_visible + (g.num_frames if g.append_mode else 0)
            for g in plan.groups]
    assert keys == [1, 2, 9, 15, 21]


@pytest.fixture(scope="module")
def vae_weights():
    set_float32_precision()
    p = jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(1),
                                                      jnp.float32))
    model = tvae.empty_vae(torch.float32)
    model.load_state_dict(vae_state_from_jax(p))
    return jax.tree.map(jnp.asarray, p), model


@pytest.mark.parametrize("frames", [1, 2])
def test_encode_of_one_or_two_frames_matches(vae_weights, frames):
    """A one-frame image (and two frames) through the encoder: the
    downsample3d time conv has no full window below 3 frames, and frame 0
    passes alone (f32, within 1e-4)."""
    jp, model = vae_weights
    px = np.random.default_rng(frames).uniform(
        -1, 1, (1, frames, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jvae.encode(jp, jnp.asarray(px)))
    got = tvae.encode(model, torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (1, 1, 16, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def pipes():
    cfg = j_tiny()
    p = jdit.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(99), p["head"]["head"]["kernel"].shape)
    jpipe = jfps.CausalFPSInferencePipeline(
        cfg, p, plan=jg.i2v_plan(), sampling_steps=STEPS, timestep_shift=8.0,
        guidance_scale=5.0, dtype=jnp.float32)
    tcfg = tiny_test_config()
    model = tdit.empty_dit(tcfg, fused=False, dtype=torch.float32)
    model.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, p),
                                             tcfg))
    tpipe = tfps.CausalFPSInferencePipeline(
        tcfg, model, plan=tg.i2v_plan(), sampling_steps=STEPS,
        timestep_shift=8.0, guidance_scale=5.0, dtype=torch.float32)
    return jpipe, tpipe


@pytest.mark.parametrize("n_init", [1, 2])
def test_i2v_window_latents_match(pipes, n_init):
    """n_init = 1: window 0, the image latent committed as group 0 and
    frame 1 denoised; n_init = 2: a bridged window, groups 0 and 1
    committed from the 2 bridge latents.  f32, within 1e-3 (as the t2v
    window test); the committed frames come back exactly, the anchor
    handoff is frames (0, 19, 20)."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(10 + n_init)
    noise = rng.standard_normal((B, 21, C, H, W)).astype(np.float32)
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    uncond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    init = rng.standard_normal((B, n_init, C, H, W)).astype(np.float32)
    anchors_j, anchors_t = [], []
    want = np.asarray(jpipe.inference(
        jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(uncond),
        initial_latent=jnp.asarray(init), rng=jax.random.PRNGKey(7),
        on_anchor=lambda a: anchors_j.append(np.asarray(a))))
    got = tpipe.inference(
        torch.from_numpy(noise), torch.from_numpy(cond),
        torch.from_numpy(uncond), initial_latent=torch.from_numpy(init),
        on_anchor=lambda a: anchors_t.append(a.numpy())).numpy()
    assert got.shape == want.shape == (B, 21, C, H, W)
    np.testing.assert_array_equal(got[:, :n_init], init)
    assert np.abs(want[:, n_init:] - noise[:, n_init:]).mean() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert len(anchors_t) == len(anchors_j) == 1
    assert anchors_t[0].shape == (B, 3, C, H, W)
    np.testing.assert_allclose(anchors_t[0], anchors_j[0], atol=1e-3)
    # the groups that ran: commits only for the initial frames
    ran = sorted(k for k in tpipe.phase_times if k.endswith("_steps_s"))
    assert ran == [f"group{g}_steps_s" for g in range(n_init, 5)]


def _png(tmp_path, h=80, w=100, seed=0):
    rgb = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    p = tmp_path / "cond.png"
    p.write_bytes(buf.getvalue())
    return str(p)


def _capture_jax_inference(monkeypatch, seen):
    """The JAX pipeline's inference records what it is handed and returns
    zero latents (its windows are not under test here)."""
    def fake(self, noise, cond, uncond, initial_latent=None, rng=None,
             **kw):
        seen.append({"plan": self.plan.name, "cond": np.asarray(cond),
                     "uncond": np.asarray(uncond), "dtype": self.dtype,
                     "initial_latent": None if initial_latent is None
                     else np.asarray(initial_latent)})
        return jnp.zeros(noise.shape, jnp.float32)
    monkeypatch.setattr(jfps.CausalFPSInferencePipeline, "inference", fake)


def _record_port_inference(monkeypatch, seen):
    """The port pipeline's inference runs, and records what it is handed."""
    real = tfps.CausalFPSInferencePipeline.inference

    def spy(self, noise, cond, uncond, initial_latent=None, **kw):
        seen.append({"plan": self.plan.name, "cond": cond.float().numpy(),
                     "uncond": uncond.float().numpy(), "dtype": self.dtype,
                     "initial_latent": None if initial_latent is None
                     else initial_latent.numpy()})
        return real(self, noise, cond, uncond,
                    initial_latent=initial_latent, **kw)
    monkeypatch.setattr(tfps.CausalFPSInferencePipeline, "inference", spy)


def _no_video_writes(monkeypatch, written):
    def fake_write(path, frames, fps=16):
        written[path] = frames
        return path
    monkeypatch.setattr("mmpl_tpu_torch.utils.video_io.write_video",
                        fake_write)
    monkeypatch.setattr("mmpl_tpu.utils.video_io.write_video", fake_write)


def test_cli_image_in_smoke_mode_matches_jax(monkeypatch, tmp_path):
    """`--model smoke --image`: both CLIs take the i2v plan and hand window
    0 the image's latent: resized and centre-cropped to 64x64, encoded by
    the same VAE weights (the port's smoke VAE replaced by the JAX one's
    bridged), f32 within 1e-4.  The port's run then writes 81 + 76 frames
    (its second window is bridged by 2 latents)."""
    jparams = jax.tree.map(np.asarray, jvae.init_vae_params(
        jax.random.PRNGKey(1), jnp.float32))

    def bridged_vae(generator, dtype=torch.float32, device="cpu"):
        model = tvae.empty_vae(dtype, device)
        model.load_state_dict(vae_state_from_jax(jparams))
        return model
    monkeypatch.setattr(tvae, "init_vae_params", bridged_vae)
    seen_j, seen_t, written = [], [], {}
    _capture_jax_inference(monkeypatch, seen_j)
    _record_port_inference(monkeypatch, seen_t)
    _no_video_writes(monkeypatch, written)
    img = _png(tmp_path)
    argv = ["--model", "smoke", "--image", img, "--sampling-steps", "1",
            "--output", str(tmp_path / "out.mp4")]
    assert jcli.main(argv + ["--duration", "1"]) == 0
    assert cli.main(argv + ["--duration", "2", "--device", "cpu"]) == 0
    j0, t0, t1 = seen_j[0], seen_t[0], seen_t[1]
    assert j0["plan"] == t0["plan"] == t1["plan"] == "i2v"
    assert t0["initial_latent"].shape == j0["initial_latent"].shape == (
        1, 1, 16, 8, 8)
    np.testing.assert_allclose(t0["initial_latent"], j0["initial_latent"],
                               atol=1e-4)
    assert t1["initial_latent"].shape == (1, 2, 16, 8, 8)
    assert t0["dtype"] == torch.float32
    frames = written[str(tmp_path / "out.mp4")]
    assert frames.shape == (81 + 76, 64, 64, 3) and frames.dtype == np.uint8
