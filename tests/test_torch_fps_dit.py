"""Port parity: the planned-KV-cache group forward (flow and cache contents)
for all four t2v groups, from a pre-filled random cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.geometry import t2v_plan as j_plan
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.models import fps_dit as jfps
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.core.geometry import t2v_plan
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import fps_dit as tfps
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, C, H, W = 2, 16, 4, 4


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    p = jdit.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(99), p["head"]["head"]["kernel"].shape)
    p = jdit.fuse_qkv_params(p, num_heads=cfg.num_heads)
    tree = jax.tree.map(np.asarray, p)
    model = tdit.empty_dit(cfg, fused=True, dtype=torch.float32)
    model.load_state_dict(dit_state_from_jax(tree, cfg))
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((B, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    ckv_j = jdit.precompute_context_kv(p, cfg, jdit.embed_text(
        p, jnp.asarray(ctx)))
    ckv_t = tdit.precompute_context_kv(model, cfg, tdit.embed_text(
        model, torch.from_numpy(ctx)))
    shape = jfps.init_kv_cache(cfg, B, H * W // 4, dtype=jnp.float32)["k"].shape
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    return cfg, p, model, ckv_j, ckv_t, cache


def test_init_kv_cache_layout_matches():
    cfg = tiny_test_config()
    want = jfps.init_kv_cache(cfg, 2, 1560, dtype=jnp.float32)
    got = tfps.init_kv_cache(cfg, 2, 1560, dtype=torch.float32)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
    with pytest.raises(ValueError):
        tfps.init_kv_cache(cfg, 2, 4, dtype=torch.float16)


@pytest.mark.parametrize("gi", [0, 1, 2, 3])
def test_group_forward_flow_and_cache_match(setup, gi):
    cfg, p, model, ckv_j, ckv_t, cache = setup
    sched_j, sched_t = j_plan().groups[gi], t2v_plan().groups[gi]
    G = sched_t.num_frames
    rng = np.random.default_rng(10 + gi)
    lat = rng.standard_normal((B, G, C, H, W)).astype(np.float32)
    tt = np.full((B, G), 0.0 if gi == 1 else 937.0, np.float32)
    flow_j, cache_j = jfps.fps_forward_group(
        p, cfg, jnp.asarray(lat), jnp.asarray(tt), ckv_j,
        {k: jnp.asarray(v) for k, v in cache.items()}, sched_j)
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    flow_t = tfps.fps_forward_group(model, cfg, torch.from_numpy(lat),
                                    torch.from_numpy(tt), ckv_t, cache_t,
                                    sched_t, write_cache=True)
    assert np.abs(np.asarray(flow_j)).max() > 1e-3
    np.testing.assert_allclose(flow_t.numpy(), np.asarray(flow_j),
                               atol=5e-5, rtol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(cache_j[k]),
                                   atol=5e-5, rtol=1e-5)
    if sched_t.append_mode:
        for k in ("k", "v"):
            np.testing.assert_array_equal(cache_t[k].numpy(), cache[k])
    else:
        changed = np.abs(cache_t["k"].numpy() - cache["k"]).max(
            axis=(0, 1, 3, 4)) > 0
        assert tuple(np.flatnonzero(changed)) == tuple(
            sorted(sched_t.write_slots))


def test_solver_pass_writes_nothing(setup):
    cfg, p, model, ckv_j, ckv_t, cache = setup
    sched = t2v_plan().groups[1]
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    lat = torch.randn((B, sched.num_frames, C, H, W),
                      generator=torch.Generator().manual_seed(0))
    tfps.fps_forward_group(model, cfg, lat, torch.full((B, 7), 500.0),
                           ckv_t, cache_t, sched, write_cache=False)
    for k in ("k", "v"):
        np.testing.assert_array_equal(cache_t[k].numpy(), cache[k])
