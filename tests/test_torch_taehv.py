"""Port parity: the TAEHV preview autoencoder (encode, decode, streaming
decode), its upstream-named state dict, and the previewer's uint8 frames,
against `mmpl_tpu.models.taehv` and `mmpl_tpu.utils.preview` on the same
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.models import taehv as jtaehv
from mmpl_tpu.utils.preview import TaehvPreviewer as JPreviewer
from mmpl_tpu_torch.models import taehv as ttaehv
from mmpl_tpu_torch.utils.jax_params import taehv_state_from_jax
from mmpl_tpu_torch.utils.preview import (TaehvPreviewer,
                                          make_preview_callback)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    params = jtaehv.init_taehv_params(jax.random.PRNGKey(0))
    model = ttaehv.TAEHV()
    model.load_state_dict(taehv_state_from_jax(jax.tree.map(np.asarray,
                                                            params)))
    return params, model


def _lat(seed, T, h=4, w=4):
    return np.random.default_rng(seed).standard_normal(
        (1, T, 16, h, w)).astype(np.float32)


# fp32 convs on both sides: only the order of sums differs
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("trim", [True, False])
def test_decode_matches(models, trim):
    params, model = models
    z = _lat(1, 3)
    want = np.asarray(jtaehv.taehv_decode(params, jnp.asarray(z), trim=trim))
    got = ttaehv.taehv_decode(model, torch.from_numpy(z), trim=trim).numpy()
    assert got.shape == want.shape == (1, 12 - 3 * trim, 3, 32, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_streaming_decode_equals_the_whole_decode(models):
    _, model = models
    z = torch.from_numpy(_lat(2, 6))
    full = ttaehv.taehv_decode(model, z)
    state, chunks = None, []
    for lo, hi in ((0, 3), (3, 5), (5, 6)):       # uneven chunks
        out, state = ttaehv.taehv_decode_streaming(model, z[:, lo:hi], state)
        chunks.append(out)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), full.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_encode_matches(models):
    params, model = models
    video = np.random.default_rng(3).uniform(
        0, 1, (1, 8, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jtaehv.taehv_encode(params, jnp.asarray(video)))
    got = ttaehv.taehv_encode(model, torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (1, 2, 16, 4, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_loads_an_upstream_state_dict():
    """A synthetic state dict in `taew2_1.pth` key names: the port takes it
    with `load_state_dict` as it is, the JAX package through
    `convert_taehv`, and the two decode alike."""
    rng = np.random.default_rng(4)
    model = ttaehv.TAEHV()
    fan_in = lambda s: np.prod(s[1:]) if len(s) > 1 else 1
    sd = {k: (rng.standard_normal(tuple(v.shape)) / np.sqrt(
        fan_in(tuple(v.shape)))).astype(np.float32)
          for k, v in model.state_dict().items()}
    assert "decoder.3.conv.4.weight" in sd and "encoder.2.conv.weight" in sd
    params = jtaehv.convert_taehv(sd)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    z = _lat(5, 2)
    np.testing.assert_allclose(
        ttaehv.taehv_decode(model, torch.from_numpy(z)).numpy(),
        np.asarray(jtaehv.taehv_decode(params, jnp.asarray(z))), **TOL)


def test_random_init_is_seeded_and_bounded():
    a = ttaehv.init_taehv_params(torch.Generator().manual_seed(7))
    b = ttaehv.init_taehv_params(torch.Generator().manual_seed(7))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
        else:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            assert p.abs().max() <= 1 / np.sqrt(fan_in)


@pytest.mark.parametrize("denormalize", [False, True])
def test_previewer_frames_match(models, denormalize):
    """uint8 NTHWC frames block by block, the first block 3 frames short;
    the two packages' frames within one code (rounding at .5 after
    different orders of sums)."""
    params, model = models
    jp = JPreviewer(params, denormalize=denormalize)
    tp = TaehvPreviewer(model, denormalize=denormalize)
    seen = []
    on_block = make_preview_callback(tp, lambda s, f: seen.append((s, f)))
    z = _lat(6, 6)
    for start in (0, 3):
        blk = z[:, start:start + 3]
        want = jp(jnp.asarray(blk))
        on_block(start, torch.from_numpy(blk))
        got = seen[-1][1]
        assert seen[-1][0] == start
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.shape == (1, 9 if start == 0 else 12, 32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
