"""Port parity: the i2v DiT variant (mmpl_tpu_torch vs mmpl_tpu), f32 on the
CPU at `tiny_test_config("i2v")`: the configs, the CLIP image projection,
the image keys and values of the cross-attention, the bidirectional
forward with `clip_fea` and `y`, the group forward with `y`, the FPS
pipeline's context with `clip_fea`, and `convert_dit` of a synthetic
upstream i2v state dict.  Tolerance 2e-5 abs for the layers (as
test_torch_dit.py), 0 for the conversion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core import config as jcfg
from mmpl_tpu.core.geometry import i2v_plan as j_i2v_plan
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.models import fps_dit as jfps
from mmpl_tpu.utils import checkpoint as jck
from mmpl_tpu_torch.core import config as tcfg
from mmpl_tpu_torch.core.geometry import i2v_plan
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import fps_dit as tfps
from mmpl_tpu_torch.pipelines.fps_inference import CausalFPSInferencePipeline
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax
from test_checkpoint import make_synthetic_dit_sd
from test_torch_dit import close, jax_params_np, port_model, t

ATOL = 2e-5
B, F, C, H, W = 2, 3, 16, 4, 4
#: the CLIP image tokens of ViT-H/14: 257 tokens of width 1280
CLIP_TOKENS = 257


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = tcfg.tiny_test_config("i2v")
    tree = jax_params_np(cfg, seed=3)
    rng = np.random.default_rng(7)
    inputs = {
        "ctx": rng.standard_normal((B, cfg.text_len, cfg.text_dim)).astype(
            np.float32),
        "clip": rng.standard_normal((B, CLIP_TOKENS, tdit.CLIP_DIM)).astype(
            np.float32),
        "lat": rng.standard_normal((B, F, C, H, W)).astype(np.float32),
        "y": rng.standard_normal((B, F, 20, H, W)).astype(np.float32),
    }
    return cfg, tree, port_model(tree, cfg), inputs


@pytest.mark.parametrize("name", ["i2v-14B", "t2i-14B"])
def test_model_configs_match(name):
    assert dict(tcfg.WAN_CONFIGS[name]) == dict(jcfg.WAN_CONFIGS[name])


def test_size_tables_and_tiny_i2v_config_match():
    assert tcfg.SIZE_CONFIGS == jcfg.SIZE_CONFIGS
    assert tcfg.MAX_AREA_CONFIGS == jcfg.MAX_AREA_CONFIGS
    assert tcfg.SUPPORTED_SIZES == jcfg.SUPPORTED_SIZES
    assert set(tcfg.WAN_CONFIGS) == set(jcfg.WAN_CONFIGS)
    assert dict(tcfg.tiny_test_config("i2v")) == dict(
        jcfg.tiny_test_config("i2v"))


def test_init_has_the_jax_leaves(setup):
    """The port's random i2v DiT holds every leaf of the JAX init, with
    its shape (img_emb, k_img / v_img / norm_k_img included)."""
    cfg, tree, _, _ = setup
    model = tdit.init_dit_params(cfg, torch.Generator().manual_seed(0),
                                 torch.float32)
    want = dit_state_from_jax(tree, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert torch.equal(model.blocks[1].cross_attn.norm_k_img.weight,
                       torch.ones(cfg.dim))
    assert not model.img_emb.norm2.bias.any()


def test_embed_image_clip_matches(setup):
    cfg, tree, model, x = setup
    want = jdit.embed_image_clip(tree, jnp.asarray(x["clip"]))
    close(tdit.embed_image_clip(model, t(x["clip"])), want)


def test_context_kv_with_image_matches(setup):
    cfg, tree, model, x = setup
    emb_j = jdit.embed_text(tree, jnp.asarray(x["ctx"]))
    img_j = jdit.embed_image_clip(tree, jnp.asarray(x["clip"]))
    want = jdit.precompute_context_kv(tree, cfg, emb_j, img_j)
    got = tdit.precompute_context_kv(
        model, cfg, tdit.embed_text(model, t(x["ctx"])),
        tdit.embed_image_clip(model, t(x["clip"])))
    for li, kv in enumerate(got):
        assert set(kv) == {"k", "v", "k_img", "v_img"}
        for name, a in kv.items():
            close(a, want[name][li])


def test_cross_attention_adds_the_image_attention(setup):
    cfg, tree, model, x = setup
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((B, F * 4, cfg.dim)).astype(np.float32)
    emb_j = jdit.embed_text(tree, jnp.asarray(x["ctx"]))
    img_j = jdit.embed_image_clip(tree, jnp.asarray(x["clip"]))
    kv = jdit.precompute_context_kv(tree, cfg, emb_j, img_j)
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"])
    want = jdit.cross_attention(lp["cross_attn"], jnp.asarray(xs),
                                kv["k"][0], kv["v"][0], cfg.num_heads,
                                kv["k_img"][0], kv["v_img"][0])
    tt = lambda a: torch.from_numpy(np.array(a))
    got = tdit.cross_attention(model.blocks[0].cross_attn, t(xs),
                               tt(kv["k"][0]), tt(kv["v"][0]),
                               cfg.num_heads, tt(kv["k_img"][0]),
                               tt(kv["v_img"][0]))
    close(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_dit_forward_with_clip_and_y_matches(setup, fused):
    cfg, _, _, x = setup
    tree = jax_params_np(cfg, seed=3, fused=fused)
    model = port_model(tree, cfg)
    tt = np.array([937.0, 250.0], np.float32)
    want = jdit.dit_forward(tree, cfg, jnp.asarray(x["lat"]),
                            jnp.asarray(tt), jnp.asarray(x["ctx"]),
                            clip_fea=jnp.asarray(x["clip"]),
                            y=jnp.asarray(x["y"]))
    got = tdit.dit_forward(model, cfg, t(x["lat"]), t(tt), t(x["ctx"]),
                           clip_fea=t(x["clip"]), y=t(x["y"]))
    assert got.shape == (B, F, C, H, W)
    close(got, want)


def test_group_forward_with_y_matches(setup):
    """Group 1 of the i2v plan (frame 1 over the committed frame 0) with
    a conditioning `y` for its frames, from a random cache."""
    cfg, tree, model, x = setup
    sched_j, sched_t = j_i2v_plan().groups[1], i2v_plan().groups[1]
    G = sched_t.num_frames
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((B, G, C, H, W)).astype(np.float32)
    y = rng.standard_normal((B, G, 20, H, W)).astype(np.float32)
    tt = np.full((B, G), 811.0, np.float32)
    emb_j = jdit.embed_text(tree, jnp.asarray(x["ctx"]))
    img_j = jdit.embed_image_clip(tree, jnp.asarray(x["clip"]))
    ckv_j = jdit.precompute_context_kv(tree, cfg, emb_j, img_j)
    ckv_t = tdit.precompute_context_kv(
        model, cfg, tdit.embed_text(model, t(x["ctx"])),
        tdit.embed_image_clip(model, t(x["clip"])))
    shape = jfps.init_kv_cache(cfg, B, H * W // 4,
                               dtype=jnp.float32)["k"].shape
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    want, _ = jfps.fps_forward_group(
        tree, cfg, jnp.asarray(lat), jnp.asarray(tt), ckv_j,
        {k: jnp.asarray(v) for k, v in cache.items()}, sched_j,
        y=jnp.asarray(y))
    got = tfps.fps_forward_group(
        model, cfg, t(lat), t(tt), ckv_t,
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}, sched_t,
        y=t(y))
    close(got, want)


def test_pipeline_context_with_clip_matches(setup):
    """`prepare_context` with `clip_fea`: the image K/V of [clip; clip]
    beside the text K/V of [cond; uncond]."""
    cfg, tree, _, x = setup
    model = port_model(tree, cfg)
    pipe = CausalFPSInferencePipeline(cfg, model, sampling_steps=2,
                                      dtype=torch.float32)
    cond, uncond = x["ctx"][:1], x["ctx"][1:]
    clip = x["clip"][:1]
    got = pipe.prepare_context(t(cond), t(uncond), clip_fea=t(clip))
    jtree = jax.tree.map(jnp.asarray, jax_params_np(cfg, seed=3,
                                                    fused=True))
    emb = jdit.embed_text(jtree, jnp.asarray(np.concatenate([cond,
                                                             uncond])))
    img = jdit.embed_image_clip(jtree, jnp.asarray(np.concatenate([clip,
                                                                   clip])))
    want = jdit.precompute_context_kv(jtree, cfg, emb, img)
    for li, kv in enumerate(got):
        for name in ("k", "v", "k_img", "v_img"):
            close(kv[name], want[name][li])


def synthetic_i2v_sd(cfg, seed=3):
    """A WanModel-layout i2v state dict: the t2v keys plus `img_emb.proj`
    and each cross-attention's `k_img`, `v_img`, `norm_k_img`."""
    sd = make_synthetic_dit_sd(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    d, c = cfg.dim, tdit.CLIP_DIM
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}.cross_attn"
        for proj in ("k_img", "v_img"):
            sd[f"{pre}.{proj}.weight"] = r(d, d)
            sd[f"{pre}.{proj}.bias"] = r(d)
        sd[f"{pre}.norm_k_img.weight"] = 1.0 + 0.1 * r(d)
    for idx, (o, i) in (("1", (c, c)), ("3", (d, c))):
        sd[f"img_emb.proj.{idx}.weight"] = r(o, i)
        sd[f"img_emb.proj.{idx}.bias"] = r(o)
    for idx, n in (("0", c), ("4", d)):
        sd[f"img_emb.proj.{idx}.weight"] = 1.0 + 0.1 * r(n)
        sd[f"img_emb.proj.{idx}.bias"] = r(n)
    return sd


def test_convert_dit_i2v_equals_the_bridged_jax_conversion():
    cfg = tcfg.tiny_test_config("i2v")
    sd = synthetic_i2v_sd(jcfg.tiny_test_config("i2v"))
    want = dit_state_from_jax(
        jax.tree.map(np.asarray, jck.convert_dit(sd, jcfg.tiny_test_config(
            "i2v"))), cfg)
    got = tck.convert_dit({k: torch.from_numpy(v) for k, v in sd.items()},
                          cfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and back: the upstream names and shapes, bit for bit
    up = tck.to_upstream(got, "dit")
    assert set(up) == set(sd)
    for k, v in sd.items():
        assert torch.equal(up[k], torch.from_numpy(v)), k
