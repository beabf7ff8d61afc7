"""Port parity: the chunk pipeline (`mmpl_tpu_torch/parallel/chunk_pipeline.py`
against `mmpl_tpu/parallel/chunk_pipeline.py`): the causal-prefix bridge,
two stages on two devices against JAX's two virtual CPU devices, three
chunks round-robin, the i2v initial latent, `decode_chunks` and the
dispatch log.  Stages here are CPU devices (no streams); the card's
streams are held in `tests/test_torch_cuda.py`."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core import geometry as jg
from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import vae as jvae
from mmpl_tpu.parallel import chunk_pipeline as jcp
from mmpl_tpu_torch.core import geometry as tg
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.parallel import chunk_pipeline as tcp
from mmpl_tpu_torch.utils.device import set_float32_precision
from mmpl_tpu_torch.utils.jax_params import vae_state_from_jax

from test_torch_distill_draws import dit_pair, few_threads

B, C, H, W = 1, 16, 4, 4
STEPS = 2
CPU2 = [torch.device("cpu")] * 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = few_threads()
    set_float32_precision()
    yield
    torch.set_num_threads(n)


def _numpy_vae(seed):
    """A random VAE tree in `init_vae_params`' layout, filled by numpy
    (the JAX package's own init takes ~20 s on the CPU)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (np.ones if name == "gamma" else np.zeros)(
            leaf.shape, np.float32)

    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, jnp.float32),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def models():
    params, model = dit_pair(0)
    vae_j = _numpy_vae(1)
    vae_t = tvae.empty_vae(torch.float32)
    vae_t.load_state_dict(vae_state_from_jax(jax.tree.map(np.asarray,
                                                          vae_j)))
    return params, model, vae_j, vae_t


def _jax_chunk_draws(rng, plan, n_inits):
    """Replay JAX's key chain: one split per chunk (`generate`), then per
    denoised group one split and split(sub, R) reseed draws
    (`CausalFPSInferencePipeline.inference`)."""
    out = []
    for n_init in n_inits:
        rng, sub = jax.random.split(rng)
        draws, consumed = {}, 0
        for gi, g in enumerate(plan.groups):
            if n_init > 0 and consumed < n_init:
                consumed += g.num_frames
                continue
            sub, gsub = jax.random.split(sub)
            if g.reseed:
                keys = jax.random.split(gsub, len(g.reseed))
                draws[gi] = torch.from_numpy(np.concatenate(
                    [np.asarray(jax.random.normal(k, (B, 1, C, H, W),
                                                  jnp.float32))
                     for k in keys], axis=1))
        out.append(draws)
    return out


def _inputs(seed, chunks):
    rng = np.random.default_rng(seed)
    noises = [rng.standard_normal((B, 21, C, H, W)).astype(np.float32)
              for _ in range(chunks)]
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    uncond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    return noises, cond, uncond


def test_bridge_matches_jax_and_the_full_window(models):
    _, _, vae_j, vae_t = models
    handoff = np.random.default_rng(2).standard_normal(
        (B, 8, C, H, W)).astype(np.float32)
    jbridge, vp = jcp.make_bridge_fn(vae_j, 8)
    want = np.asarray(jbridge(vp, jnp.asarray(handoff)))
    got = tcp.make_bridge_fn(vae_t, 8)(torch.from_numpy(handoff)).numpy()
    assert got.shape == want.shape == (B, 2, C, H, W)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)

    # the reference's formulation: a 21-frame mask, an 81-frame re-encode
    h = torch.from_numpy(handoff)
    mask = torch.zeros((B, 21, C, H, W))
    mask[:, 0], mask[:, 1], mask[:, 2], mask[:, 3] = h[:, 0], h[:, -2], \
        h[:, -2], h[:, -1]
    vid = tvae.decode(vae_t, mask) * 0.5 + 0.5
    px = torch.zeros_like(vid)
    px[:, :5] = vid[:, 8:13]
    full = tvae.encode(vae_t, px * 2.0 - 1.0)[:, :2].numpy()
    np.testing.assert_allclose(got, full, atol=2e-4, rtol=1e-4)

    with pytest.raises(ValueError, match="8 handoff latents"):
        tcp.make_bridge_fn(vae_t, 8)(h[:, :3])


@pytest.mark.parametrize("kind,chunks", [("t2v", 3), ("i2v", 2)])
def test_two_stages_match_jax(models, kind, chunks):
    """Chunks round-robin over two stages (chunk 2 back on stage 0) equal
    the JAX pipeline's over two virtual CPU devices; with the i2v plan
    chunk 0 starts from the encoded image's latent."""
    params, model, vae_j, vae_t = models
    noises, cond, uncond = _inputs(3, chunks)
    init = None
    jplan, tplan = (jg.i2v_plan(), tg.i2v_plan()) if kind == "i2v" \
        else (None, None)
    if kind == "i2v":
        init = np.random.default_rng(4).standard_normal(
            (B, 1, C, H, W)).astype(np.float32)
    jpipe = jcp.ChunkParallelPipeline(
        j_tiny(), params, vae_j, devices=jax.devices()[:2], plan=jplan,
        sampling_steps=STEPS, dtype=jnp.float32)
    key = jax.random.PRNGKey(6)
    want = [np.asarray(c) for c in jpipe.generate(
        [jnp.asarray(n) for n in noises], jnp.asarray(cond),
        jnp.asarray(uncond), rng=key,
        initial_latent=None if init is None else jnp.asarray(init))]

    tpipe = tcp.ChunkParallelPipeline(
        tiny_test_config(), model, vae_t, devices=CPU2, plan=tplan,
        sampling_steps=STEPS, dtype=torch.float32)
    n_inits = [0 if init is None else 1] + [2] * (chunks - 1)
    draws = _jax_chunk_draws(key, tpipe.plan, n_inits)
    got = tpipe.generate([torch.from_numpy(n) for n in noises],
                         torch.from_numpy(cond), torch.from_numpy(uncond),
                         initial_latent=None if init is None
                         else torch.from_numpy(init), reseed_noise=draws)
    assert len(got) == len(want) == chunks
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 21, C, H, W)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3)
    if init is not None:
        np.testing.assert_array_equal(got[0][:, :1].numpy(), init)
    # chunk 1 starts from the bridge of chunk 0's anchors
    anchors = got[0][:, list(tpipe.plan.handoff_frames)]
    bridged = tcp.make_bridge_fn(vae_t, len(tpipe.plan.handoff_frames))(
        anchors)
    torch.testing.assert_close(got[1][:, :2], bridged, atol=0, rtol=0)

    log = tpipe.dispatch_log
    assert [e["chunk"] for e in log] == list(range(chunks))
    assert [e["stage"] for e in log] == [i % 2 for i in range(chunks)]
    for e in log:
        assert {"chunk", "stage", "dispatch_start", "dispatch_end",
                "phase_times"} <= set(e)
        assert e["dispatch_end"] >= e["dispatch_start"]
        assert e["cuda_events"] is None
        assert e["phase_times"]
    assert tpipe.device_timeline() == []


def test_one_stage_equals_two_and_reuses_the_model(models):
    """One stage runs the chunks in turn; two stages on one device share
    the model and the VAE, and both give the same chunks bit for bit."""
    _, model, _, vae_t = models
    noises, cond, uncond = _inputs(5, 3)
    args = ([torch.from_numpy(n) for n in noises], torch.from_numpy(cond),
            torch.from_numpy(uncond))
    runs = []
    for devices in (CPU2, CPU2[:1]):
        pipe = tcp.ChunkParallelPipeline(tiny_test_config(), model, vae_t,
                                          devices=devices,
                                          sampling_steps=STEPS,
                                          dtype=torch.float32)
        assert all(st.pipe.model is model for st in pipe.stages)
        assert all(st.vae is vae_t for st in pipe.stages)
        runs.append(pipe.generate(*args, seed=11))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # the seed reaches the fill groups' reseed draws
    other = tcp.ChunkParallelPipeline(
        tiny_test_config(), model, vae_t, devices=CPU2[:1],
        sampling_steps=STEPS, dtype=torch.float32).generate(
            args[0][:1], *args[1:], seed=12)
    assert (other[0] - runs[0][0]).abs().max() > 1e-4


def test_decode_chunks(models):
    _, model, _, vae_t = models
    pipe = tcp.ChunkParallelPipeline(tiny_test_config(), model, vae_t,
                                     devices=CPU2, sampling_steps=STEPS,
                                     dtype=torch.float32)
    lat = [torch.from_numpy(np.random.default_rng(s).standard_normal(
        (B, 3, C, H, W)).astype(np.float32)) for s in (7, 8)]
    u8 = pipe.decode_chunks(lat, uint8=True)
    for x, v in zip(lat, u8):
        assert v.dtype == torch.uint8 and v.shape == (B, 9, 32, 32, 3)
        torch.testing.assert_close(v, tvae.decode_to_frames(vae_t, x)[0],
                                   atol=0, rtol=0)
    px = pipe.decode_chunks(lat)
    for x, got in zip(lat, px):
        torch.testing.assert_close(got, tvae.decode_streaming(vae_t, x),
                                   atol=0, rtol=0)
    whole = pipe.decode_chunks(lat, streaming=False)
    for a, b in zip(whole, px):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_a_failing_chunk_raises_and_frees_the_other_stage(models):
    """A chunk that raises ends `generate` with its error; the stage
    waiting for its anchors gives up instead of waiting forever."""
    _, model, _, vae_t = models
    pipe = tcp.ChunkParallelPipeline(tiny_test_config(), model, vae_t,
                                     devices=CPU2, sampling_steps=1,
                                     dtype=torch.float32)

    def boom(*a, **k):
        raise RuntimeError("stage 0 failed")

    pipe.stages[0].pipe.inference = boom
    noises, cond, uncond = _inputs(9, 3)
    done = {}

    def run():
        try:
            pipe.generate([torch.from_numpy(n) for n in noises],
                          torch.from_numpy(cond), torch.from_numpy(uncond))
        except RuntimeError as e:
            done["error"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "generate hung after a failed chunk"
    assert done.get("error") == "stage 0 failed"
