"""Port parity: the whole-clip Wan pipelines (mmpl_tpu_torch.pipelines.
wan_reference vs mmpl_tpu.pipelines.wan_reference), f32 on the CPU: the
tiny DiT at 4x4 latents, 3 latent frames (9 pixel frames), the real VAE
with random weights, 2 UniPC steps with the batched CFG pair, and for I2V a
CLIP tower of ViT-H/14's width (1280, the width `img_emb` takes) cut to 2
blocks.  Tolerances: 1e-3 abs for the 2-step pipelines (as
test_torch_pipeline.py), 1e-4 for the conditioning encode (as the VAE
encode in test_torch_vae.py), 1e-5 for the chunked encode against the
whole-clip one (the same convolutions, the causal padding taken from the
carried frames)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.models import clip as jclip
from mmpl_tpu.pipelines import wan_reference as jwr
from mmpl_tpu.utils import checkpoint as jck
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import clip as tclip
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.pipelines import wan_reference as twr
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils.device import set_float32_precision
from mmpl_tpu_torch.utils.jax_params import clip_visual_state_from_jax
from test_torch_dit import jax_params_np, port_model

B, F, C, H, W = 1, 3, 16, 4, 4
STEPS = 2
#: ViT-H/14's width and head dim (the DiT's img_emb takes 1280-wide
#: tokens), cut to 2 blocks and a narrow MLP
VIS = dict(image_size=224, patch_size=14, dim=1280, mlp_ratio=1,
           num_heads=16, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Random VAE weights made by the port and carried to the JAX package
    through the upstream layout (its own converter), much quicker than
    JAX's eager init on the CPU."""
    set_float32_precision()
    vae = tvae.init_vae_params(torch.Generator().manual_seed(1))
    vp = jck.convert_vae({k: v.numpy() for k, v in tck.to_upstream(
        vae.state_dict(), "vae").items()})
    rng = np.random.default_rng(0)
    cfg = tiny_test_config()
    ctx = rng.standard_normal((2, 1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    image = rng.uniform(-1, 1, (B, 3, 8 * H, 8 * W)).astype(np.float32)
    return vp, vae, ctx, noise, image


def test_encode_streaming_equals_encode(setup):
    _, vae, _, _, _ = setup
    px = np.random.default_rng(1).uniform(-1, 1, (1, 9, 3, 16, 24)).astype(
        np.float32)
    want = tvae.encode(vae, torch.from_numpy(px))
    got = tvae.encode_streaming(vae, torch.from_numpy(px))
    assert got.shape == (1, 3, 16, 2, 3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        tvae.encode_streaming(vae, torch.from_numpy(px[:, :8]))


def test_i2v_conditioning_matches(setup):
    jvp, vae, _, _, image = setup
    want = jwr.build_i2v_conditioning(jvp, jnp.asarray(image), F)
    got = twr.build_i2v_conditioning(vae, torch.from_numpy(image), F)
    assert got.shape == (B, F, 20, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _run_both(jpipe, tpipe, jcall, tcall):
    want = np.asarray(jcall(jpipe))
    got = tcall(tpipe).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    return got


def test_t2v_generate_matches(setup):
    jvp, vae, ctx, noise, _ = setup
    cfg = tiny_test_config()
    tree = jax_params_np(cfg, seed=5)
    jpipe = jwr.WanT2V(cfg, jax.tree.map(jnp.asarray, tree), jvp,
                       sampling_steps=STEPS, dtype=jnp.float32)
    tpipe = twr.WanT2V(cfg, port_model(tree, cfg), vae,
                       sampling_steps=STEPS, dtype=torch.float32)
    assert tpipe.model.blocks[0].self_attn.fused
    args_j = (jnp.asarray(noise), jnp.asarray(ctx[0]), jnp.asarray(ctx[1]))
    args_t = (torch.from_numpy(noise), torch.from_numpy(ctx[0]),
              torch.from_numpy(ctx[1]))
    video = _run_both(jpipe, tpipe, lambda p: p.generate(*args_j),
                      lambda p: p.generate(*args_t))
    assert video.shape == (B, 9, 3, 8 * H, 8 * W)
    assert set(tpipe.phase_times) == {"steps_s", "decode_s"}


def test_i2v_generate_from_image_matches(setup, monkeypatch):
    jvp, vae, ctx, noise, image = setup
    cfg = tiny_test_config("i2v")
    tree = jax_params_np(cfg, seed=6)
    ctree = jax.tree.map(np.asarray, jclip.init_clip_visual_params(
        jax.random.PRNGKey(3), VIS))
    clip = tclip.empty_clip_visual(VIS)
    clip.load_state_dict(clip_visual_state_from_jax(ctree, VIS))
    monkeypatch.setattr(jwr, "VIT_H_14", VIS)
    jpipe = jwr.WanI2V(cfg, jax.tree.map(jnp.asarray, tree), jvp,
                       clip_params=jax.tree.map(jnp.asarray, ctree),
                       sampling_steps=STEPS, dtype=jnp.float32)
    tpipe = twr.WanI2V(cfg, port_model(tree, cfg), vae, clip_model=clip,
                       sampling_steps=STEPS, dtype=torch.float32)
    video = _run_both(
        jpipe, tpipe,
        lambda p: p.generate_from_image(jnp.asarray(noise),
                                        jnp.asarray(image),
                                        jnp.asarray(ctx[0]),
                                        jnp.asarray(ctx[1])),
        lambda p: p.generate_from_image(torch.from_numpy(noise),
                                        torch.from_numpy(image),
                                        torch.from_numpy(ctx[0]),
                                        torch.from_numpy(ctx[1])))
    assert video.shape == (B, 9, 3, 8 * H, 8 * W)
    assert np.isfinite(video).all()
    assert set(tpipe.phase_times) == {"clip_s", "encode_s", "steps_s",
                                      "decode_s"}


def test_a_mesh_and_a_missing_clip_are_refused(setup):
    _, vae, ctx, noise, image = setup
    cfg = tiny_test_config("i2v")
    model = port_model(jax_params_np(cfg, seed=6), cfg)
    with pytest.raises(NotImplementedError, match="Slice F"):
        twr.WanT2V(cfg, model, vae, mesh=object())
    pipe = twr.WanI2V(cfg, model, vae, sampling_steps=STEPS)
    with pytest.raises(ValueError, match="clip_model"):
        pipe.generate_from_image(torch.from_numpy(noise),
                                 torch.from_numpy(image),
                                 torch.from_numpy(ctx[0]),
                                 torch.from_numpy(ctx[1]))
