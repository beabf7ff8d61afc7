"""Port parity: the few-step causal path (Slice C).  `block_schedule`,
`dynamic_rope_table`, `convert_flow_pred_to_x0`, and whole few-step runs of
`CausalInferencePipeline` (static, with committed context, with an
independent first frame, with the warped step list, rolling, rolling with
the int8 cache) against `mmpl_tpu` on the same weights, noise and replayed
re-noising draws; the rolling ring against growing truncation; the
few-step CLI's frame count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.ops import rope as jrope
from mmpl_tpu.pipelines import causal_inference as jci
from mmpl_tpu.schedulers.flow_match import FlowMatchScheduler as JFM
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.ops import rope as trope
from mmpl_tpu_torch.pipelines import causal_inference as tci
from mmpl_tpu_torch.schedulers.flow_match import FlowMatchScheduler as TFM
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, C, H, W = 1, 16, 4, 4
STEPS = (1000, 500)


@pytest.mark.parametrize("start,g,local", [(0, 3, 21), (18, 3, 21),
                                           (9, 3, 6), (0, 1, 21),
                                           (1, 3, 4)])
def test_block_schedule_matches(start, g, local):
    assert tci.block_schedule(start, g, local).__dict__ == \
        jci.block_schedule(start, g, local).__dict__


@pytest.mark.parametrize("start", [0, 7, 21])
def test_dynamic_rope_table(start):
    """Against JAX (fp32 device trig on both sides) and against the static
    fp64 table at the same frames (one fp32 rounding of the angle apart)."""
    jc, js = jrope.dynamic_rope_table(jnp.asarray(start, jnp.int32), 3, 3,
                                      4, 24)
    tc, ts = trope.dynamic_rope_table(torch.tensor(start), 3, 3, 4, 24)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (36, 12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    sc, ss = trope.rope_table(tuple(range(start, start + 3)), 3, 4, 24)
    np.testing.assert_allclose(tc.numpy(), sc, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), ss, atol=1e-5)
    ic, _ = trope.dynamic_rope_table(start, 3, 3, 4, 24)
    assert torch.equal(ic, tc)


def test_convert_flow_pred_to_x0_matches():
    rng = np.random.default_rng(0)
    flow, xt = (rng.standard_normal((4, 16, 2, 2)).astype(np.float32)
                for _ in range(2))
    t = np.array([1000.0, 750.0, 437.5, 0.0], np.float32)
    js, ts = JFM(shift=5.0, sigma_min=0.0, extra_one_step=True), \
        TFM(shift=5.0, sigma_min=0.0, extra_one_step=True)
    js.set_timesteps(1000, training=True)
    ts.set_timesteps(1000, training=True)
    want = np.asarray(js.convert_flow_pred_to_x0(
        jnp.asarray(flow), jnp.asarray(xt), jnp.asarray(t)))
    got = ts.convert_flow_pred_to_x0(torch.from_numpy(flow),
                                     torch.from_numpy(xt), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def weights():
    cfg = j_tiny()
    p = jdit.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(99), p["head"]["head"]["kernel"].shape)
    tcfg = tiny_test_config()
    state = dit_state_from_jax(jax.tree.map(np.asarray, p), tcfg)
    return cfg, p, tcfg, state


def _pipes(weights, **kw):
    cfg, p, tcfg, state = weights
    kw.setdefault("denoising_step_list", STEPS)
    jpipe = jci.CausalInferencePipeline(cfg, p, dtype=jnp.float32, **kw)
    model = tdit.empty_dit(tcfg, fused=False, dtype=torch.float32)
    model.load_state_dict(state)
    return jpipe, tci.CausalInferencePipeline(tcfg, model,
                                              dtype=torch.float32, **kw)


def _jax_step_noise(rng, sizes, steps):
    """Replay the JAX pipeline's key chain: one split per denoised block,
    then one per re-noising step inside the block."""
    out = []
    for g in sizes:
        rng, sub = jax.random.split(rng)
        draws = []
        for _ in range(steps - 1):
            sub, k = jax.random.split(sub)
            draws.append(np.asarray(jax.random.normal(k, (B, g, C, H, W),
                                                      jnp.float32)))
        out.append(torch.from_numpy(np.stack(draws)))
    return out


def _run(jpipe, tpipe, F, sizes, seed=0, n_init=0):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    init = (rng.standard_normal((B, n_init, C, H, W)).astype(np.float32)
            if n_init else None)
    key = jax.random.PRNGKey(5)
    blocks_j, blocks_t = [], []
    want = np.asarray(jpipe.inference(
        jnp.asarray(noise), jnp.asarray(cond),
        initial_latent=None if init is None else jnp.asarray(init), rng=key,
        on_block=lambda s, x: blocks_j.append((s, x.shape[1]))))
    got = tpipe.inference(
        torch.from_numpy(noise), torch.from_numpy(cond),
        initial_latent=None if init is None else torch.from_numpy(init),
        step_noise=_jax_step_noise(key, sizes,
                                   len(tpipe.denoising_step_list)),
        on_block=lambda s, x: blocks_t.append((s, x.shape[1]))).numpy()
    assert blocks_t == blocks_j
    assert got.shape == want.shape
    return got, want, noise, init


# fp32 on both sides; the sums run in other orders, and each step feeds the
# next (the FPS window parity holds 1e-3 the same way)
ATOL = 1e-3


@pytest.mark.parametrize("case", ["static", "context", "first_frame",
                                  "warp"])
def test_few_step_window_matches(weights, case):
    kw, F, sizes, n_init = {}, 6, [3, 3], 0
    if case == "context":
        n_init, F = 3, 3          # one committed context block, then one
        sizes = [3]
    elif case == "first_frame":
        kw["independent_first_frame"] = True
        F, sizes = 7, [1, 3, 3]
    elif case == "warp":
        kw.update(warp_denoising_step=True, timestep_shift=5.0,
                  denoising_step_list=(1000, 750, 500, 250))
    jpipe, tpipe = _pipes(weights, **kw)
    assert tpipe.denoising_step_list == pytest.approx(
        jpipe.denoising_step_list, abs=0)
    got, want, noise, init = _run(jpipe, tpipe, F, sizes, n_init=n_init)
    assert np.abs(want[:, n_init:] - noise[:, :sum(sizes)]).mean() > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL)
    if init is not None:
        np.testing.assert_array_equal(got[:, :n_init], init)


def test_step_noise_comes_from_the_generator(weights):
    _, tpipe = _pipes(weights)
    rng = np.random.default_rng(3)
    noise, cond = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, 6, C, H, W), (B, 16, 64)))
    run = lambda s: tpipe.inference(
        noise, cond, generator=torch.Generator().manual_seed(s))
    a, b, c = run(5), run(5), run(6)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a - c).abs().max() > 1e-4


@pytest.mark.parametrize("quantize_cache", [False, True])
def test_rolling_matches_jax(weights, monkeypatch, quantize_cache):
    """12 frames through a 6-frame ring: blocks 2 and 3 evict.  The slot
    permutation attends to the same keys in the same order as the JAX
    package's rotation, and the int8 cache's codes and scales rotate with
    their slots.  Measured (`pytest -s`): rel 1.07e-7 with either cache;
    the int8 codes of the two packages agree here (a code could flip where
    fp32 roundings differ, ROADMAP Queue 3)."""
    made = []
    make = tci.init_kv_cache
    monkeypatch.setattr(tci, "init_kv_cache", lambda *a, **kw: made.append(
        make(*a, **kw)) or made[-1])
    jpipe, tpipe = _pipes(weights, max_attention_frames=6,
                          quantize_cache=quantize_cache)
    got, want, _, _ = _run(jpipe, tpipe, 12, [3] * 4, seed=1)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"rolling, int8 cache {quantize_cache}: rel {rel:.3e}")
    assert rel <= 1e-4, rel
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert made[0]["k"].dtype == (torch.int8 if quantize_cache
                                  else torch.float32)
    assert made[0]["k"].shape[2] == 6
    # two evictions of 3 slots take the ring once round
    assert tpipe.slot_order == [0, 1, 2, 3, 4, 5]


def test_rolling_eviction_gives_the_jax_cache(weights):
    """One steady-state block from the same filled ring: the latents and
    the committed cache (in recency order) equal the JAX package's."""
    jpipe, tpipe = _pipes(weights, max_attention_frames=6, sink_frames=1)
    cfg, tcfg = jpipe.cfg, tpipe.cfg
    rng = np.random.default_rng(2)
    cache = {k: rng.standard_normal((cfg.num_layers, B, 6, 4, cfg.dim))
             .astype(np.float32) for k in ("k", "v")}
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    noisy = rng.standard_normal((B, 3, C, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    x_j, cache_j = jpipe._denoise_block_rolling(
        jpipe.params, jpipe._context_kv(jnp.asarray(cond)),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(noisy),
        jnp.asarray(9, jnp.int32), key)
    sub, k = jax.random.split(key)
    sn = torch.from_numpy(np.array(jax.random.normal(
        k, (B, 3, C, H, W), jnp.float32))[None])
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    x_t, order = tpipe._denoise_block_rolling(
        tpipe.prepare_context(torch.from_numpy(cond)), cache_t,
        list(range(6)), torch.from_numpy(noisy), 9, sn)
    assert order == [0, 4, 5, 1, 2, 3]
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=ATOL)
    for name, leaf in tci.in_recency_order(cache_t, order).items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(cache_j[name]),
                                   atol=ATOL)


def test_rolling_matches_growing_truncation(weights):
    """The ring reproduces the growing cache truncated to the same window
    (`tests/test_rolling_kv.py` for the JAX package)."""
    _, ref = _pipes(weights, local_attn_frames=6)
    _, ring = _pipes(weights, max_attention_frames=6)
    rng = np.random.default_rng(4)
    noise, cond = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, 12, C, H, W), (B, 16, 64)))
    sn = [torch.from_numpy(rng.standard_normal((1, B, 3, C, H, W)).astype(
        np.float32)) for _ in range(4)]
    want = ref.inference(noise, cond, step_noise=sn)
    got = ring.inference(noise, cond, step_noise=sn)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="rolling KV"):
        _pipes(weights, max_attention_frames=7)[1].inference(noise, cond)


def test_profile_reports_each_block(weights, capsys):
    _, tpipe = _pipes(weights)
    rng = np.random.default_rng(6)
    noise, cond = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, 6, C, H, W), (B, 16, 64)))
    tpipe.inference(noise, cond, profile=True)
    err = capsys.readouterr().err
    assert "Profiling results:" in err and "Block 1 generation time" in err
    assert list(tpipe.last_profile.phases) == ["Initialization/caching",
                                               "Diffusion generation"]
    assert len(tpipe.last_profile.blocks) == 2


def test_phase_timer_report_matches():
    from mmpl_tpu.utils.profiling import PhaseTimer as JTimer
    from mmpl_tpu_torch.utils.profiling import PhaseTimer
    reports = []
    for timer in (JTimer(), PhaseTimer()):
        timer.phases.update({"Initialization/caching": 0.0125,
                             "Diffusion generation": 1.5,
                             "VAE decoding": 0.25})
        for b in (0.5, 0.75, 0.25):
            timer.record_block(b)
        reports.append(timer.report())
    assert reports[0] == reports[1]


def test_few_step_cli_without_a_card_raises(monkeypatch):
    import pathlib

    from mmpl_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
        "self_forcing_dmd.yaml"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(config)])


def test_few_step_cli_frame_count(tmp_path, monkeypatch):
    """`--config configs/self_forcing_dmd.yaml` at --device cpu: window 0
    denoises 21 latents (81 frames); window 1 denoises 18 from frame 0,
    its 2 bridge latents dropped as in the JAX package (69 frames, 64
    after the trim)."""
    import pathlib

    from mmpl_tpu_torch import cli
    written = {}
    monkeypatch.setattr("mmpl_tpu_torch.utils.video_io.write_video",
                        lambda path, frames, fps=16: written.setdefault(
                            "frames", frames) is not None and path)
    config = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
        "self_forcing_dmd.yaml"
    rc = cli.main(["--model", "smoke", "--config", str(config),
                   "--duration", "2", "--device", "cpu",
                   "--output", str(tmp_path / "out.mp4")])
    assert rc == 0
    frames = written["frames"]
    assert frames.shape == (81 + 64, 64, 64, 3) and frames.dtype == np.uint8
    assert frames.max() > frames.min()
