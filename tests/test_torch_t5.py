"""Port parity: the umT5 text encoder (mmpl_tpu_torch vs mmpl_tpu), weights
bridged with `utils.jax_params.t5_state_from_jax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.models import t5 as jt5
from mmpl_tpu_torch.models import t5 as tt5
from mmpl_tpu_torch.utils.jax_params import t5_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = jt5.TINY_T5
    tree = jax.tree.map(np.asarray,
                        jt5.init_t5_params(jax.random.PRNGKey(0), cfg))
    model = tt5.empty_t5(cfg)
    model.load_state_dict(t5_state_from_jax(tree))
    return tree, model


def test_configs_match():
    assert tt5.UMT5_XXL == jt5.UMT5_XXL
    assert tt5.TINY_T5 == jt5.TINY_T5


@pytest.mark.parametrize("L,nb,max_dist", [(16, 8, 128), (64, 32, 128),
                                           (512, 32, 128), (300, 32, 64)])
def test_relative_position_buckets_exact(L, nb, max_dist):
    np.testing.assert_array_equal(
        tt5.relative_position_buckets(L, nb, max_dist),
        jt5.relative_position_buckets(L, nb, max_dist))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_layer_norm(dtype):
    """f32 within 1e-6; bf16 within one bf16 ulp of the output's scale
    (XLA keeps the fused chain in f32, torch rounds after each op)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jt5.t5_layer_norm(jnp.asarray(x, jd),
                                        jnp.asarray(w, jd)), np.float32)
    got = tt5.t5_layer_norm(torch.from_numpy(x).to(td),
                            torch.from_numpy(w).to(td)).float().numpy()
    atol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_t5_encode_matches_jax_with_ragged_masks(weights):
    """f32, ragged masks (10 and 16 valid of 16 tokens, one row all but
    one padded): within 1e-5; padded positions exactly 0."""
    tree, model = weights
    cfg = jt5.TINY_T5
    rng = np.random.default_rng(2)
    B, L = 3, 16
    ids = rng.integers(0, cfg["vocab_size"], (B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate((10, 16, 1)):
        mask[b, :n] = 1
    want = np.asarray(jt5.t5_encode(jax.tree.map(jnp.asarray, tree), cfg,
                                    jnp.asarray(ids), jnp.asarray(mask)))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (B, L, cfg["dim"])
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[mask == 0], 0.0)


def test_t5_encode_without_mask_matches_jax(weights):
    tree, model = weights
    cfg = jt5.TINY_T5
    ids = np.random.default_rng(3).integers(
        0, cfg["vocab_size"], (2, 24)).astype(np.int32)
    want = np.asarray(jt5.t5_encode(jax.tree.map(jnp.asarray, tree), cfg,
                                    jnp.asarray(ids)))
    got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_padded_tokens_do_not_reach_valid_positions(weights):
    _, model = weights
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    mask = torch.ones((2, 16), dtype=torch.int32)
    mask[:, 10:] = 0
    a = model(ids, mask)
    ids2 = ids.clone()
    ids2[:, 12] = (ids2[:, 12] + 1) % 128
    torch.testing.assert_close(model(ids2, mask)[:, :10], a[:, :10],
                               atol=0, rtol=0)


def test_init_is_seeded_and_scaled():
    cfg = tt5.TINY_T5
    a = tt5.init_t5_params(cfg, torch.Generator().manual_seed(0))
    b = tt5.init_t5_params(cfg, torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, atol=0, rtol=0, msg=name)
    std = a.blocks[0].ffn.fc2.weight.std().item()
    assert abs(std - cfg["dim_ffn"] ** -0.5) < 0.2 * cfg["dim_ffn"] ** -0.5
    assert torch.equal(a.norm.weight, torch.ones(cfg["dim"]))
