"""Port parity: RoPE tables and rotations (mmpl_tpu_torch vs mmpl_tpu)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.ops import rope as jr
from mmpl_tpu_torch.ops import rope as tr


@pytest.mark.parametrize("head_dim", [24, 64, 128])
def test_band_dims_and_permutation_match(head_dim):
    assert tr.band_dims(head_dim) == jr.band_dims(head_dim)
    np.testing.assert_array_equal(tr.split_rope_permutation(3, head_dim),
                                  jr.split_rope_permutation(3, head_dim))


@pytest.mark.parametrize("frames,grid,head_dim", [
    ((0, 1), (2, 3), 24), ((2, 3, 10, 11, 12, 19, 20), (2, 2), 24),
    ((13, 14), (30, 52), 128)])
def test_rope_table_matches(frames, grid, head_dim):
    cw, sw = jr.rope_table(frames, grid[0], grid[1], head_dim)
    cg, sg = tr.rope_table(frames, grid[0], grid[1], head_dim)
    np.testing.assert_array_equal(cg, cw)
    np.testing.assert_array_equal(sg, sw)


@pytest.mark.parametrize("split", [False, True])
def test_apply_rope_matches(split):
    rng = np.random.default_rng(0)
    frames, gh, gw, n, d = (4, 5, 9), 2, 3, 3, 24
    L = len(frames) * gh * gw
    x = rng.standard_normal((2, L, n, d)).astype(np.float32)
    cos, sin = jr.rope_table(frames, gh, gw, d)
    jfn = jr.apply_rope_split if split else jr.apply_rope
    tfn = tr.apply_rope_split if split else tr.apply_rope
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(cos),
              torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_split_layout_is_a_channel_permutation_of_interleaved():
    """apply_rope_split on permuted channels == permuted apply_rope."""
    rng = np.random.default_rng(1)
    frames, gh, gw, n, d = (0, 7), 2, 2, 2, 24
    x = torch.from_numpy(rng.standard_normal(
        (1, len(frames) * gh * gw, n, d)).astype(np.float32))
    cos, sin = (torch.from_numpy(t) for t in tr.rope_table(frames, gh, gw, d))
    perm = torch.from_numpy(tr.split_rope_permutation(1, d))
    a = tr.apply_rope(x, cos, sin)[..., perm]
    b = tr.apply_rope_split(x[..., perm], cos, sin)
    torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
