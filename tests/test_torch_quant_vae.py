"""Port parity: the int8 VAE decoder (mmpl_tpu_torch vs mmpl_tpu) on the
CPU, weights bridged from the JAX package's quantised tree; every int8
conv runs as im2col products through the plain int8 product (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.models import vae as jvae
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.utils.device import set_float32_precision
from mmpl_tpu_torch.utils.jax_params import vae_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_vae_tree(seed: int):
    """A JAX VAE tree of `init_vae_params`' structure filled from numpy:
    U(+-1/sqrt(fan_in)) kernels and biases, unit gammas, and a non-zero
    attention projection (cheaper than the JAX init on the CPU)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvae.init_vae_params(
        jax.random.PRNGKey(0), jnp.float32))

    def leaf(path, s):
        if path[-1].key == "gamma":
            return np.ones(s.shape, np.float32)
        fan = int(np.prod(s.shape[:-1])) if path[-1].key == "kernel" else \
            s.shape[0]
        a = 1.0 / np.sqrt(fan)
        return rng.uniform(-a, a, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def vae_setup():
    """A JAX VAE tree and its int8 decoder (`vae.quantize_vae_decoder`),
    and the port's VAE loaded from the float tree and quantised."""
    set_float32_precision()
    p = _random_vae_tree(0)
    jq = jvae.quantize_vae_decoder(jax.tree.map(jnp.asarray, p))
    model = tvae.empty_vae(torch.float32)
    model.load_state_dict(vae_state_from_jax(p))
    tvae.quantize_vae_decoder(model)
    return p, jq, model


def test_quantize_vae_decoder_matches_bridged_jax_tree(vae_setup):
    p, jq, model = vae_setup
    want = vae_state_from_jax(jax.tree.map(np.asarray, jq))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert isinstance(model.conv2, tvae.QuantConv)
    assert isinstance(model.conv1, tvae.Conv)           # the encoder's side
    assert not any(isinstance(m, tvae.QuantConv)
                   for m in model.encoder.modules())
    n_conv = sum(isinstance(m, tvae.QuantConv) for m in model.modules())
    assert n_conv == sum(k.endswith("kernel_q") for k in
                         _flat_keys(jax.tree.map(np.asarray, jq)))


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key, v in tree.items()
                for k in _flat_keys(v, f"{prefix}{key}.")]
    if isinstance(tree, (list, tuple)):
        return [k for i, v in enumerate(tree)
                for k in _flat_keys(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


#: (port module path, JAX tree path, conv kind) of each kind of int8 conv
#: in the decoder
CONV_SITES = [
    ("conv2", ("conv2",), "3d", 16),
    ("decoder.conv1", ("decoder", "conv1"), "3d", 16),
    ("decoder.middle.0.conv1", ("decoder", "middle", 0, "conv1"), "3d", 384),
    ("decoder.middle.1.to_qkv", ("decoder", "middle", 1, "to_qkv"), "2d",
     384),
    ("decoder.up.3.time_conv", ("decoder", "up", 3, "time_conv"), "3d", 384),
    ("decoder.up.11.resample", ("decoder", "up", 11, "resample"), "2d", 192),
    ("decoder.up.4.shortcut", ("decoder", "up", 4, "shortcut"), "3d", 192),
]


@pytest.mark.parametrize("site", CONV_SITES, ids=[c[0] for c in CONV_SITES])
def test_int8_conv_matches_jax_exactly(vae_setup, site):
    """One int8 conv, same input: the integer conv of the codes is exact on
    both sides, and the epilogue acc * (xs * s_w) is the same fp32 product,
    so the outputs are equal."""
    name, path, kind, cin = site
    _, jq, model = vae_setup
    jp, tp = jq, model.get_submodule(name)
    for k in path:
        jp = jp[k]
    x = np.random.default_rng(3).standard_normal((1, 3, 4, 6, cin)).astype(
        np.float32)                                        # NDHWC
    if kind == "3d":
        want = jvae._conv3d(jp, jnp.asarray(x))
        got = tvae._conv3d(tp, torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    else:
        want = jvae._conv2d(jp, jnp.asarray(x))
        got = tvae._conv2d(tp, torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


def test_int8_decode_matches_jax(vae_setup):
    """The streaming int8 decode against the JAX package's.  Each conv is
    exact (test above), but a per-tensor activation scale makes the
    decoder chaotic in the last bit: where a last-bit difference of an
    fp32 norm flips a code, the flip spreads through the later blocks.
    So the two int8 decodes may differ by up to rel 0.1, less than the
    int8 decoder's own distance from the float one (`pytest -s` prints
    both)."""
    p, jq, model = vae_setup
    z = np.random.default_rng(1).standard_normal((1, 2, 16, 2, 2)).astype(
        np.float32)
    want = np.asarray(jvae.decode_streaming(jq, jnp.asarray(z)))
    got = tvae.decode_streaming(model, torch.from_numpy(z)).numpy()
    float_model = tvae.empty_vae(torch.float32)
    float_model.load_state_dict(vae_state_from_jax(p))
    flt = tvae.decode_streaming(float_model, torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 5, 3, 16, 16)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    rel_float = np.linalg.norm(got - flt) / np.linalg.norm(flt)
    print(f"int8 decode: port vs JAX rel {rel:.3g}, port int8 vs float "
          f"{rel_float:.3g}")
    assert rel <= 0.1 and rel < rel_float, (rel, rel_float)
    assert abs(np.abs(got).max() - np.abs(want).max()) <= 0.05


def test_int8_conv_chunks_count_and_agree(vae_setup, monkeypatch):
    """The im2col runs in row blocks of at most IM2COL_BYTES; the result
    does not depend on the blocking, and each block is one P2 call."""
    _, _, model = vae_setup
    p = model.decoder.middle[0].conv1
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 384, 3, 5, 6)).astype(np.float32))
    tvae.int8_conv_counts.update(convs=0, chunks=0)
    whole = tvae._conv3d(p, x)
    assert tvae.int8_conv_counts == {"convs": 1, "chunks": 1}
    K = 384 * 27
    # a frame of 5 rows does not fit: blocks of 2 rows, 3 per frame
    monkeypatch.setattr(tvae, "IM2COL_BYTES", 2 * 6 * K)
    tvae.int8_conv_counts.update(convs=0, chunks=0)
    rows = tvae._conv3d(p, x)
    assert tvae.int8_conv_counts == {"convs": 1, "chunks": 9}
    # two whole frames fit
    monkeypatch.setattr(tvae, "IM2COL_BYTES", 2 * 5 * 6 * K)
    tvae.int8_conv_counts.update(convs=0, chunks=0)
    frames = tvae._conv3d(p, x)
    assert tvae.int8_conv_counts == {"convs": 1, "chunks": 2}
    torch.testing.assert_close(rows, whole, rtol=0, atol=0)
    torch.testing.assert_close(frames, whole, rtol=0, atol=0)


def test_int8_conv_matrix_follows_loaded_codes():
    """The [Cout, K] im2col matrix is built once per conv and again after
    `load_state_dict`, so codes loaded after a first decode are the ones
    the conv uses."""
    gen = torch.Generator().manual_seed(5)

    def quant_conv():
        conv = tvae.Conv(32, 16, (3, 3, 3))
        for t in (conv.weight, conv.bias):
            t.data.uniform_(-0.1, 0.1, generator=gen)
        return tvae.QuantConv.from_conv(conv)

    first, second = quant_conv(), quant_conv()
    x = torch.randn((1, 32, 2, 4, 5), generator=gen)
    before = tvae._conv3d(first, x)
    assert first.weight_im2col is not None
    assert "weight_im2col" not in first.state_dict()
    first.load_state_dict(second.state_dict())
    assert first.weight_im2col is None
    torch.testing.assert_close(tvae._conv3d(first, x),
                               tvae._conv3d(second, x), rtol=0, atol=0)
    assert not torch.equal(before, tvae._conv3d(second, x))
