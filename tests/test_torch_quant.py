"""Port parity: the int8 serving path (mmpl_tpu_torch vs mmpl_tpu) on the
CPU, where every int8 product runs its plain version (a float64 matmul of
the codes, exact): the weight and activation codes, the W8A8 and W8A16
products, the TPU int8 kernel P2 itself (in interpret mode), the quantised
DiT and its `auto` policy, the int8 KV cache, the quantised window and
the weight bridge on quantised trees.  The int8 VAE decoder and the CLI
flags are in test_torch_quant_vae.py and test_torch_quant_cli.py.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.models import fps_dit as jfps
from mmpl_tpu.ops import quant as jquant
from mmpl_tpu.pipelines.fps_inference import \
    CausalFPSInferencePipeline as JPipe
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import fps_dit as tfps
from mmpl_tpu_torch.ops import quant as tquant
from mmpl_tpu_torch.pipelines.fps_inference import \
    CausalFPSInferencePipeline as TPipe
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
TARGETS = tdit.AUTO_QUANT_TARGETS


def _bits(a) -> np.ndarray:
    """bf16 values (torch or numpy) as their int16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


# ---------------------------------------------------------------------------
# Codes, scales and the two products (ops/quant.py)
# ---------------------------------------------------------------------------

def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 48, 40)).astype(np.float32)     # [L, K, N]
    w[1, :, 3] = 0                                              # amax 0
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w).transpose(1, 2))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(0, 2, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_codes_match_jax(dtype):
    """Per-token codes (`quant.py:49-52`; the JAX package's KV-cache
    quantiser is the same formula, and the port's cache commit uses
    `quantize_rows` over [tokens, K]) bit for bit, ties rounding half
    to even: a row with amax 127 has scale 1, so 2.5 -> 2, -3.5 -> -4."""
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((33, 64))).astype(np.float32)
    x[4] = 0
    x[5, :4] = [127.0, 2.5, -3.5, 0.5]
    x[5, 4:] = 0
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy())
    jq, js = jfps._quantize_cache_tokens(xj)
    for q, s in (tquant.quantize_rows(xt), tquant.quantize_rows_plain(
            xt.reshape(3, 11, 64))):
        np.testing.assert_array_equal(q.reshape(33, 64).numpy(),
                                      np.asarray(jq))
        np.testing.assert_array_equal(s.reshape(33).numpy(), np.asarray(js))
    q, s = tquant.quantize_rows(xt)
    assert s[4].item() == np.float32(1e-12) and not q[4].any()
    assert q[5, :4].tolist() == [127, 2, -4, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_codes_match_jax_at_the_ffn_width(dtype):
    """The per-token codes of rows as long as ffn.fc2's input (K = 8960,
    the rows Q's block-per-row layout takes on the card), with an all-zero
    row and a row that one huge value dominates."""
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((6, 8960))).astype(np.float32)
    x[2] = 0
    x[4, 4321] = 1e30
    xt = torch.from_numpy(x).to(dtype)
    jq, js = jfps._quantize_cache_tokens(jnp.asarray(xt.float().numpy()))
    q, s = tquant.quantize_rows_plain(xt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[2].item() == np.float32(1e-12) and not q[2].any()
    assert q[4, 4321].item() == 127 and q[4].abs().sum().item() == 127


def _w8_inputs(seed, k=96, n=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, n))).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    return x, jq, js, torch.from_numpy(np.asarray(jq).T.copy()), \
        torch.from_numpy(np.array(js))


def test_w8a8_matmul_matches_jax():
    """The int32 accumulator is exact on both sides and the epilogue is the
    same (acc * s_x) * s_w in fp32."""
    x, jq, js, wq, ws = _w8_inputs(2)
    want = np.asarray(jquant.w8a8_matmul(jnp.asarray(x), jq, js))
    got = tquant.w8a8_matmul(torch.from_numpy(x), wq, ws)
    assert got.shape == (2, 5, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_w8a16_matmul_matches_jax_in_fp32():
    x, jq, js, wq, ws = _w8_inputs(3)
    want = np.asarray(jquant.w8a16_matmul(jnp.asarray(x), jq, js))
    got = tquant.w8a16_matmul(torch.from_numpy(x), wq, ws)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1536, 8960])
def test_w8a16_matmul_bf16_rounds_once_more_than_jax(k):
    """bf16: torch's matmul rounds the product to bf16 before the scale,
    XLA keeps it fp32 until after (ROADMAP Queue 3).  The two results
    stay within 3 bf16 ulps of each other (more than 1 only near
    cancellation), and most are equal; `pytest -s` prints the shares."""
    _, jq, js, wq, ws = _w8_inputs(4, k=k, n=256)
    x = np.random.default_rng(5).standard_normal((260, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jquant.w8a16_matmul(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                               jq, js)
    got = tquant.w8a16_matmul(xb, wq, ws)
    assert got.dtype == torch.bfloat16
    ulps = np.abs(_bits(got) - _bits(want))
    wf = np.asarray(want).astype(np.float32)
    rel = np.linalg.norm(got.float().numpy() - wf) / np.linalg.norm(wf)
    print(f"K={k}: equal {np.mean(ulps == 0):.3f}, <= 1 ulp "
          f"{np.mean(ulps <= 1):.5f}, max {ulps.max()} ulps, rel {rel:.3g}")
    assert ulps.max() <= 3, ulps.max()
    assert np.mean(ulps <= 1) >= 0.999 and np.mean(ulps == 0) >= 0.5


def test_scales_divide_by_127_as_eager_jax_does():
    """Q's scale is amax / 127 by a true division, as `quant.py:50` writes
    it and eager JAX computes it; jitted XLA multiplies by f32(1/127)
    instead, which differs in the last bit on some rows (ROADMAP Queue 3;
    `pytest -s` prints the share)."""
    x = np.random.default_rng(12).standard_normal((4096, 64)).astype(
        np.float32)
    _, s = tquant.quantize_rows(torch.from_numpy(x))
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=-1)
    eager = np.asarray(jnp.maximum(amax / 127.0, 1e-12))
    jitted = np.asarray(jax.jit(
        lambda a: jnp.maximum(jnp.max(jnp.abs(a), axis=-1) / 127.0, 1e-12))(
            jnp.asarray(x)))
    np.testing.assert_array_equal(s.numpy(), eager)
    share = np.mean(s.numpy() != jitted)
    print(f"jitted XLA scales differ from the true quotient on {share:.3f}")
    assert 0 < share < 0.2
    np.testing.assert_allclose(jitted, eager, rtol=2e-7, atol=0)


def test_int8_gemm_plain_is_the_exact_product():
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (70, 8960)).astype(np.int8)
    b = rng.integers(-127, 128, (30, 8960)).astype(np.int8)
    got = tquant.int8_gemm(torch.from_numpy(a), torch.from_numpy(b), None,
                           None, torch.int32)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)
    assert tquant.launch_counts == {"int8_gemm": 0, "quantize_rows": 0}


@pytest.fixture(scope="module")
def probe():
    """tools/pallas_int8_mm_probe.py, the TPU kernel P2, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "pallas_int8_mm_probe", ROOT / "tools" / "pallas_int8_mm_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["full_k", "k_loop"])
def test_int8_gemm_matches_the_pallas_kernel(probe, monkeypatch, variant):
    """P2 (`_mm_s8_kernel`, `_mm_s8_kloop_kernel`) in interpret mode
    against the port's plain int8 product with the same rescale: within 1
    bf16 ulp (both round the fp32 epilogue to bf16 once)."""
    monkeypatch.setattr(probe.pl, "pallas_call", functools.partial(
        probe.pl.pallas_call, interpret=True))
    rng = np.random.default_rng(6)
    M, K, N = 64, 96, 48
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    if variant == "full_k":
        want = probe.pallas_s8_matmul(jnp.asarray(xq), jnp.asarray(wq), 32, 16)
    else:
        want = probe.pallas_s8_matmul_kloop(jnp.asarray(xq), jnp.asarray(wq),
                                            32, 16, 32)
    got = tquant.int8_gemm(torch.from_numpy(xq),
                           torch.from_numpy(wq.T.copy()), None,
                           torch.full((N,), 1e-4), torch.bfloat16)
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 16          # the sums do use 32 bits
    ulps = np.abs(_bits(got) - _bits(want))
    assert ulps.max() <= 1, ulps.max()


def test_wrappers_refuse_other_devices():
    x = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tquant.quantize_rows(x)
    with pytest.raises(ValueError, match="unsupported device"):
        tquant.int8_gemm(x.to(torch.int8), x.to(torch.int8), None, None)


# ---------------------------------------------------------------------------
# Quantised DiT (models/dit.py)
# ---------------------------------------------------------------------------

def _jax_params(seed=0, outlier=False):
    """Fused fp32 JAX params with a random head (numpy leaves)."""
    cfg = j_tiny()
    p = jdit.init_dit_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(99), p["head"]["head"]["kernel"].shape)
    p = jax.tree.map(np.asarray, jdit.fuse_qkv_params(
        p, num_heads=cfg.num_heads))
    if outlier:
        # one outlier input channel of fc2 (tests/test_quant.py:320-326)
        p["blocks"]["ffn"]["fc2"]["kernel"] = \
            p["blocks"]["ffn"]["fc2"]["kernel"].copy()
        p["blocks"]["ffn"]["fc2"]["kernel"][:, 7, :] *= 3000.0
    return p


def _port_model(tree, cfg, quantize=None):
    """The port's fused model from a float JAX tree, or from a JAX tree
    quantised with `quantize` ("int8" or "int8wo") into the port's
    quantised modules."""
    model = tdit.empty_dit(cfg, fused=True, dtype=torch.float32)
    if quantize:
        tdit.quantize_params(model, weight_only=quantize == "int8wo")
    model.load_state_dict(dit_state_from_jax(tree, cfg))
    return model


@pytest.fixture(scope="module")
def dit_setup():
    cfg = tiny_test_config()
    tree = _jax_params()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 3, 16, 8, 8)).astype(np.float32)
    t = np.full((1, 3), 500.0, np.float32)
    ctx = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    return cfg, tree, (x, t, ctx)


@pytest.mark.parametrize("mode", ["int8", "int8wo"])
def test_quantize_params_codes_match_jax(dit_setup, mode):
    """The port's `quantize_params` of the float weights gives the codes
    and scales of the JAX package's, and the bridged JAX tree has exactly
    the port's quantised state."""
    cfg, tree, _ = dit_setup
    model = _port_model(tree, cfg)
    tdit.quantize_params(model, weight_only=mode == "int8wo")
    jtree = jax.tree.map(np.asarray, jdit.quantize_params(
        jax.tree.map(jnp.asarray, tree), weight_only=mode == "int8wo"))
    want = dit_state_from_jax(jtree, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    code = "weight_w8" if mode == "int8wo" else "weight_q"
    for blk in model.blocks:
        for tgt in TARGETS:
            mod, name = tgt.split(".")
            q = getattr(getattr(blk, mod), name)
            assert isinstance(q, tquant.QuantLinear), tgt
            assert q.codes.dtype == torch.int8 and q.code_name == code
            assert q.scale.shape == (q.codes.shape[0],)
            assert not hasattr(q, "weight")        # the floats are dropped
        assert isinstance(blk.cross_attn.k, nn.Linear)
        assert isinstance(blk.cross_attn.v, nn.Linear)


def test_quantize_params_skips_unfused_qkv():
    cfg = tiny_test_config()
    model = tdit.empty_dit(cfg, fused=False, dtype=torch.float32)
    tdit.quantize_params(model)
    sa = model.blocks[0].self_attn
    assert isinstance(sa.q, nn.Linear) and isinstance(sa.o, tquant.QuantLinear)


@pytest.mark.parametrize("mode", [None, "int8", "int8wo"])
def test_dit_forward_matches_jax(dit_setup, mode):
    """The bidirectional forward, float and quantised.  fp32 on both sides;
    the int8 products are exact, so the quantised forwards differ only
    where a last-bit difference of an fp32 activation moves a code across
    a rounding boundary, which the tolerance leaves room for."""
    cfg, tree, (x, t, ctx) = dit_setup
    jtree = tree
    if mode:
        jtree = jax.tree.map(np.asarray, jdit.quantize_params(
            jax.tree.map(jnp.asarray, tree), weight_only=mode == "int8wo"))
    want = np.asarray(jdit.dit_forward(
        jax.tree.map(jnp.asarray, jtree), j_tiny(), jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx)))
    model = _port_model(jtree, cfg, mode)
    got = tdit.dit_forward(model, cfg, torch.from_numpy(x),
                           torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == (1, 3, 16, 8, 8)
    assert np.abs(want).max() > 1e-3
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= (1e-5 if mode is None else 1e-4), rel
    if mode is None:
        np.testing.assert_allclose(got, want, atol=5e-5)


def test_auto_quantize_policy_and_report(dit_setup):
    """Healthy weights: every projection passes (tests/test_quant.py:297)."""
    cfg, tree, (x, t, ctx) = dit_setup
    model = _port_model(tree, cfg)
    model.head.head.weight.zero_()                  # the reference init
    _, rep = tdit.auto_quantize(model, cfg)
    assert rep is tdit.last_auto_quantize_report
    assert set(rep["policy"]) == set(rep["per_target_rel_err"]) == set(TARGETS)
    assert all(m == "int8" for m in rep["policy"].values()), rep
    assert rep["mixed_rel_err"] < 0.01
    assert rep["probed_with_random_head"] is True
    assert not model.head.head.weight.any()         # put back to zero
    assert isinstance(model.blocks[0].ffn.fc2, tquant.QuantLinear)
    out = tdit.dit_forward(model, cfg, torch.from_numpy(x),
                           torch.from_numpy(t), torch.from_numpy(ctx))
    assert torch.isfinite(out).all()


def test_auto_quantize_demotes_sensitive_projection():
    """An outlier input channel of fc2 demotes it to W8A16
    (tests/test_quant.py:316)."""
    cfg = tiny_test_config()
    model = _port_model(_jax_params(outlier=True), cfg)
    model = tdit.apply_quantize(model, "auto", cfg)
    rep = tdit.last_auto_quantize_report
    assert rep["policy"]["ffn.fc2"] == "int8wo", rep
    assert rep["per_target_rel_err"]["ffn.fc2"] > 0.03
    assert rep["mixed_rel_err"] < rep["per_target_rel_err"]["ffn.fc2"]
    assert rep["probed_with_random_head"] is False
    assert model.blocks[1].ffn.fc2.code_name == "weight_w8"
    assert model.blocks[1].ffn.fc1.code_name == "weight_q"


def test_apply_quantize_refuses_unknown_modes():
    cfg = tiny_test_config()
    model = tdit.empty_dit(cfg, fused=True, dtype=torch.float32)
    assert tdit.apply_quantize(model, None, cfg) is model
    with pytest.raises(ValueError):
        tdit.apply_quantize(model, "int4", cfg)
    with pytest.raises(ValueError):
        tdit.apply_quantize(model, "auto")


# ---------------------------------------------------------------------------
# int8 KV cache (models/fps_dit.py)
# ---------------------------------------------------------------------------

def test_int8_kv_cache_layout_and_round_trip():
    cfg = tiny_test_config()
    want = jfps.init_kv_cache(cfg, 2, 16, quantize=True)
    got = tfps.init_kv_cache(cfg, 2, 16, quantize=True)
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
        assert not got[k].any()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3, 16, cfg.dim)).astype(np.float32))
    q, s = tquant.quantize_rows(x.reshape(-1, cfg.dim))   # the commit's
    q, s = q.reshape(x.shape), s.reshape(x.shape[:-1])
    assert q.dtype == torch.int8 and s.shape == x.shape[:-1]
    err = (q.float() * s[..., None] - x).abs()
    assert (err <= 0.5 * s[..., None] * (1 + 1e-6)).all()


# ---------------------------------------------------------------------------
# The quantised window (pipelines/fps_inference.py)
# ---------------------------------------------------------------------------

B, C, H, W = 1, 16, 4, 4


def _jax_reseed_noise(rng, plan):
    """The JAX pipeline's reseed draws (one key split per group, then
    split(sub, R)), as tests/test_torch_pipeline.py replays them."""
    out = {}
    for gi, g in enumerate(plan.groups):
        rng, sub = jax.random.split(rng)
        if g.reseed:
            keys = jax.random.split(sub, len(g.reseed))
            out[gi] = torch.from_numpy(np.concatenate(
                [np.asarray(jax.random.normal(k, (B, 1, C, H, W),
                                              jnp.float32)) for k in keys],
                axis=1))
    return out


@pytest.mark.parametrize("quantize,quantize_cache", [
    ("int8", True), ("int8wo", False)])
def test_quantised_window_matches_jax(quantize, quantize_cache):
    """Two solver steps of the tiny model in fp32, same weights, noise and
    reseed noise as the JAX pipeline.  Every int8 product is exact, but
    W8A8 makes the window sensitive to the last bit of an activation: a
    code flips where an fp32 rounding difference crosses a rounding
    boundary, and CFG amplifies it.  So the two packages may differ by
    what one fp32 ulp of the noise does to the port's own window (printed
    beside the distance; `pytest -s` shows them): rel <= 5e-3."""
    cfg = j_tiny()
    p = jdit.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(99), p["head"]["head"]["kernel"].shape)
    kw = dict(sampling_steps=2, timestep_shift=8.0, guidance_scale=5.0,
              quantize=quantize, quantize_cache=quantize_cache)
    jpipe = JPipe(cfg, p, dtype=jnp.float32, **kw)
    model = tdit.empty_dit(tiny_test_config(), fused=False,
                           dtype=torch.float32)
    model.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, p),
                                             tiny_test_config()))
    tpipe = TPipe(tiny_test_config(), model, dtype=torch.float32, **kw)
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((B, 21, C, H, W)).astype(np.float32)
    cond, uncond = (rng.standard_normal((B, 16, 64)).astype(np.float32)
                    for _ in range(2))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpipe.inference(jnp.asarray(noise), jnp.asarray(cond),
                                      jnp.asarray(uncond), rng=key))
    reseed = _jax_reseed_noise(key, tpipe.plan)
    got, ulp = (tpipe.inference(torch.from_numpy(n), torch.from_numpy(cond),
                                torch.from_numpy(uncond),
                                reseed_noise=reseed).numpy()
                for n in (noise, np.nextafter(noise, np.float32(np.inf))))
    assert got.shape == want.shape == (B, 21, C, H, W)
    assert np.abs(want - noise).mean() > 1e-3
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    sensitivity = np.linalg.norm(ulp - got) / np.linalg.norm(got)
    print(f"{quantize} cache={quantize_cache}: port vs JAX rel {rel:.3g}, "
          f"one ulp of the noise moves the port by {sensitivity:.3g}")
    assert rel <= 5e-3, (rel, sensitivity)
