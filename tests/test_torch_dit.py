"""Port parity: DiT layers and blocks (mmpl_tpu_torch vs mmpl_tpu), f32 on
the CPU, weights bridged with `utils.jax_params`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.ops import attention as jattn
from mmpl_tpu.ops.rope import rope_table
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.ops.attention import attention as t_attention
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5


def jax_params_np(cfg, seed=0, fused=False):
    """JAX init with non-trivial biases, norm weights and head, as numpy."""
    p = jdit.init_dit_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)

    def jitter(node):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                jitter(leaf)
            elif key == "bias":
                node[key] = np.asarray(leaf) + 0.05 * rng.standard_normal(
                    leaf.shape).astype(np.float32)
            elif key == "weight":
                node[key] = np.asarray(leaf) * (1 + 0.1 * rng.standard_normal(
                    leaf.shape)).astype(np.float32)
            else:
                node[key] = np.asarray(leaf)

    p = jax.tree.map(np.asarray, p)
    jitter(p)
    p["head"]["head"]["kernel"] = 0.05 * rng.standard_normal(
        p["head"]["head"]["kernel"].shape).astype(np.float32)
    if fused:
        p = jax.tree.map(np.asarray, jdit.fuse_qkv_params(
            jax.tree.map(jnp.asarray, p), num_heads=cfg.num_heads))
    return p


def port_model(tree, cfg):
    fused = "qkv" in tree["blocks"]["self_attn"]
    model = tdit.empty_dit(cfg, fused=fused, dtype=torch.float32)
    model.load_state_dict(dit_state_from_jax(tree, cfg))
    return model


def layer(tree, i=0):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree["blocks"])


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def cfg():
    assert dict(tiny_test_config()) == dict(j_tiny())
    return tiny_test_config()


def test_fuse_qkv_params_matches_jax_fusion(cfg):
    unfused = jax_params_np(cfg)
    fused = jax_params_np(cfg, fused=True)
    model = tdit.fuse_qkv_params(port_model(unfused, cfg), cfg.num_heads)
    want = port_model(fused, cfg).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_qkv_project_matches(cfg, fused):
    tree = jax_params_np(cfg, fused=fused)
    model = port_model(tree, cfg)
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    frames, gh, gw = (3, 4), 2, 3
    x = np.random.default_rng(1).standard_normal(
        (2, len(frames) * gh * gw, cfg.dim)).astype(np.float32)
    cos, sin = rope_table(frames, gh, gw, d)
    want = jdit.qkv_project(layer(tree)["self_attn"], jnp.asarray(x), n, d,
                            jnp.asarray(cos), jnp.asarray(sin))
    got = tdit.qkv_project(model.blocks[0].self_attn, t(x), n, d, t(cos),
                           t(sin))
    for g, w in zip(got, want):
        close(g, w)


def test_context_kv_and_cross_attention_match(cfg):
    tree = jax_params_np(cfg)
    model = port_model(tree, cfg)
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((2, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    x = rng.standard_normal((2, 12, cfg.dim)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    emb_w = jdit.embed_text(jp, jnp.asarray(ctx))
    emb_g = tdit.embed_text(model, t(ctx))
    close(emb_g, emb_w)
    ckv_w = jdit.precompute_context_kv(jp, cfg, emb_w)
    ckv_g = tdit.precompute_context_kv(model, cfg, emb_g)
    for i in range(cfg.num_layers):
        close(ckv_g[i]["k"], ckv_w["k"][i])
        close(ckv_g[i]["v"], ckv_w["v"][i])
    want = jdit.cross_attention(layer(tree)["cross_attn"], jnp.asarray(x),
                                ckv_w["k"][0], ckv_w["v"][0], cfg.num_heads)
    got = tdit.cross_attention(model.blocks[0].cross_attn, t(x),
                               ckv_g[0]["k"], ckv_g[0]["v"], cfg.num_heads)
    close(got, want)


def test_time_embed_matches(cfg):
    tree = jax_params_np(cfg)
    model = port_model(tree, cfg)
    tt = np.array([[999.0, 999.0], [0.0, 512.5]], np.float32)
    ew, e0w = jdit.time_embed(jax.tree.map(jnp.asarray, tree), cfg,
                              jnp.asarray(tt))
    eg, e0g = tdit.time_embed(model, cfg, t(tt))
    close(eg, ew)
    close(e0g, e0w)


def test_patchify_unpatchify_match(cfg):
    tree = jax_params_np(cfg)
    model = port_model(tree, cfg)
    lat = np.random.default_rng(3).standard_normal(
        (2, 3, cfg.in_dim, 4, 6)).astype(np.float32)
    want = jdit.patchify(jax.tree.map(jnp.asarray, tree["patch_embedding"]),
                         jnp.asarray(lat), cfg.patch_size)
    got = tdit.patchify(model.patch_embedding, t(lat), cfg.patch_size)
    close(got, want)
    tok = np.random.default_rng(4).standard_normal(
        (2, 3 * 2 * 3, 4 * cfg.out_dim)).astype(np.float32)
    want = jdit.unpatchify(jnp.asarray(tok), 3, (2, 3), cfg.patch_size,
                           cfg.out_dim)
    got = tdit.unpatchify(t(tok), 3, (2, 3), cfg.patch_size, cfg.out_dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_parity(cfg, fused, atol):
    tree = jax_params_np(cfg, fused=fused)
    model = port_model(tree, cfg)
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    frames, gh, gw = (5, 6), 2, 3
    B, F = 2, len(frames)
    L = F * gh * gw
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, L, cfg.dim)).astype(np.float32)
    e0 = rng.standard_normal((B, F, 6, cfg.dim)).astype(np.float32)
    e = rng.standard_normal((B, F, cfg.dim)).astype(np.float32)
    ctx = rng.standard_normal((B, cfg.text_len, cfg.dim)).astype(np.float32)
    cos, sin = rope_table(frames, gh, gw, d)
    jp = jax.tree.map(jnp.asarray, tree)
    bp = layer(tree)
    ckv_w = jax.tree.map(lambda a: a[0],
                         jdit.precompute_context_kv(jp, cfg, jnp.asarray(ctx)))
    ckv_g = tdit.precompute_context_kv(model, cfg, t(ctx))[0]

    def j_self(xm):
        q, k, v = jdit.qkv_project(bp["self_attn"], xm, n, d,
                                   jnp.asarray(cos), jnp.asarray(sin))
        out = jattn.attention(q, k, v)
        return jdit.linear(bp["self_attn"]["o"], out.reshape(B, L, -1))

    sa = model.blocks[0].self_attn

    def t_self(xm):
        q, k, v = tdit.qkv_project(sa, xm, n, d, t(cos), t(sin))
        return tdit.linear(sa.o, t_attention(q, k, v).reshape(B, L, -1))

    want = jdit.block_forward(bp, cfg, jnp.asarray(x), jnp.asarray(e0),
                              j_self, ckv_w, F)
    got = tdit.block_forward(model.blocks[0], cfg, t(x), t(e0), t_self,
                             ckv_g, F)
    close(got, want, atol)
    want = jdit.head_forward(jp["head"], cfg, want, jnp.asarray(e), F)
    got = tdit.head_forward(model.head, cfg, got, t(e), F)
    close(got, want, atol)


@pytest.mark.parametrize("fused", [False, True])
def test_block_forward_matches(cfg, fused):
    _block_parity(cfg, fused, atol=5e-5)


def test_block_forward_head_dim_128_against_pallas_flash():
    """A head-dim-128 block: the JAX side runs its Pallas flash kernel (in
    interpret mode on the CPU), the port its K1 plain version."""
    cfg = tiny_test_config()
    cfg.dim, cfg.num_heads, cfg.ffn_dim = 256, 2, 384
    jattn.set_attention_backend("flash")
    try:
        _block_parity(cfg, fused=True, atol=1e-4)
    finally:
        jattn.set_attention_backend(None)
