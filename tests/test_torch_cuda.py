"""K1-K6 (`mmpl_tpu_torch/csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`) and the
int8 kernels P2 and Q (`csrc/int8_gemm.cu`) on the card: agreement with
their plain versions, the dispatch's launch counts, and what the wrappers
refuse.

Needs an NVIDIA GPU and nvcc, not JAX; on the card run

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from mmpl_tpu_torch.ops import attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(lq, lk, d, dtype, device, seed=0, B=2, N=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, L, N, d)).astype(
        np.float32)).to(device, dtype) for L in (lq, lk, lk)]


def _errors(q, k, v):
    o, lse = ta.flash_fwd_cuda(q, k, v)
    po, plse = ta.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    return ((o.float() - po.float()).abs().max().item(),
            (lse - plse).abs().max().item())


# bf16/fp16: P is rounded to the input type before PV (as the TPU kernel
# does) while the plain version keeps it fp32; fp32 differs only in the
# order of the sums.
@pytest.mark.parametrize("dtype,d,o_tol,lse_tol", [
    (torch.bfloat16, 128, 2e-2, 1e-3),
    (torch.bfloat16, 64, 2e-2, 1e-3),
    (torch.bfloat16, 24, 2e-2, 1e-3),
    (torch.float16, 96, 5e-3, 1e-3),
    (torch.float32, 24, 1e-4, 1e-4),
    (torch.float32, 128, 1e-4, 1e-4),
])
def test_kernel_matches_plain_at_a_ragged_shape(cuda, dtype, d, o_tol,
                                                lse_tol):
    o_err, lse_err = _errors(*_qkv(1000, 1300, d, dtype, cuda))
    assert o_err <= o_tol and lse_err <= lse_tol, (o_err, lse_err)


def test_kernel_reads_strided_operands(cuda):
    """q/k/v as views of one fused [B, L, 3, N, D] projection."""
    qkv = torch.randn((2, 777, 3, 4, 128), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = ta.flash_fwd_cuda(q, k, v)
    oc, lsec = ta.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    torch.testing.assert_close(o, oc, atol=0, rtol=0)
    torch.testing.assert_close(lse, lsec, atol=0, rtol=0)


def test_dispatch_counts_one_launch_per_unmasked_call(cuda):
    q, k, v = _qkv(64, 200, 128, torch.bfloat16, cuda)
    ta.reset_launch_counts()
    ta.attention(q, k, v)
    mask = torch.ones((1, 1, 64, 200), dtype=torch.bool, device=cuda)
    ta.attention(q, k, v, mask=mask)      # masked attention runs dense
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 0),
                                "flash_fwd": 1}


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 20),
                                     (torch.bfloat16, 144),
                                     (torch.float32, 20),
                                     (torch.float64, 64)])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, dtype, d):
    q, k, v = _qkv(16, 16, d, dtype, cuda)
    ta.reset_launch_counts()
    with pytest.raises(ValueError):
        ta.flash_fwd_cuda(q, k, v)
    assert ta.launch_counts["flash_fwd"] == 0


# ---------------------------------------------------------------------------
# K4-K6 and K2/K3
# ---------------------------------------------------------------------------

def _mask(L, S, cuda, blind=True):
    """Frame ids of L tokens in frames of S, a block-causal mask over them
    and, with `blind`, one frame that sees nothing."""
    from mmpl_tpu_torch.training import masks
    F = -(-L // S)
    fm = masks.blockwise_causal_frame_mask(F, 3)
    if blind:
        fm[1] = False
    ids = np.repeat(np.arange(F), S)[:L]
    return (torch.as_tensor(ids, dtype=torch.int32, device=cuda),
            torch.as_tensor(ids, dtype=torch.int32, device=cuda),
            torch.as_tensor(fm, device=cuda))


def _rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 24),
                                     (torch.float32, 24)])
def test_masked_forward_matches_plain_with_a_blind_frame(cuda, dtype, d):
    q, k, v = _qkv(1000, 1000, d, dtype, cuda)
    mask = _mask(1000, 130, cuda)
    tiles = ta.tile_table(*mask)
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    po, plse = ta.frame_masked_attention_plain(q, k, v, *mask)
    blind = mask[0] == 1
    assert torch.all(o[:, blind] == 0)
    assert torch.all(lse[:, :, blind] == -float("inf"))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (o.float() - po.float()).abs().max().item() <= tol
    live = torch.isfinite(plse)
    assert (lse[live] - plse[live]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,d,tol", [(torch.bfloat16, 128, 1e-2),
                                         (torch.bfloat16, 24, 1e-2),
                                         (torch.float32, 24, 1e-5),
                                         (torch.float32, 128, 1e-5)])
def test_backward_matches_plain_at_a_ragged_shape(cuda, masked, dtype, d,
                                                  tol):
    lq, lk = (1000, 1000) if masked else (1000, 1300)
    q, k, v = _qkv(lq, lk, d, dtype, cuda)
    do = _qkv(lq, lq, d, dtype, cuda, seed=1)[0]
    mask = _mask(lq, 130, cuda) if masked else None
    tiles = ta.tile_table(*mask) if masked else None
    o, lse = ta.flash_fwd_cuda(q, k, v, None, mask, tiles)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = ta.flash_bwd_cuda(q, k, v, do, lse, delta, None, mask, tiles)
    if masked:
        want = ta.frame_masked_attention_bwd_plain(q, k, v, do, lse, delta,
                                                   *mask)
    else:
        want = ta.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    if masked:
        assert torch.all(got[0][:, mask[0] == 1] == 0)


def test_backward_reads_strided_do(cuda):
    q, k, v = _qkv(300, 500, 64, torch.bfloat16, cuda)
    o, lse = ta.flash_fwd_cuda(q, k, v)
    wide = torch.randn((2, 300, 3, 2, 64), device=cuda).to(torch.bfloat16)
    do = wide[:, :, :, 0]
    assert not do.is_contiguous()
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    a = ta.flash_bwd_cuda(q, k, v, do, lse, delta)
    b = ta.flash_bwd_cuda(q, k, v, do.contiguous(), lse, delta)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_autograd_launches_each_kernel_once(cuda):
    q, k, v = (x.requires_grad_(True)
               for x in _qkv(500, 500, 64, torch.bfloat16, cuda))
    ids = torch.as_tensor(np.repeat(np.arange(5), 100), dtype=torch.int32,
                          device=cuda)
    fm = torch.tril(torch.ones((5, 5), dtype=torch.bool, device=cuda))
    ta.reset_launch_counts()
    out = ta.frame_masked_attention(q, k, v, ids, ids, fm)
    out = out + ta.flash_attention(q, k, v)
    out.float().sum().backward()
    # the six kernels of the two autograd functions once each; P1 is no
    # kernel of theirs
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 1),
                                "flash_exp2": 0}
    for x in (q, k, v):
        assert x.grad is not None and torch.isfinite(x.grad.float()).all()


# ---------------------------------------------------------------------------
# P2 and Q (csrc/int8_gemm.cu)
# ---------------------------------------------------------------------------

def _int8(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(
        np.int8)).to(device)


def _ulps(got, want):
    """Largest distance in units in the last place (same-sign values)."""
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.view(view).long() - want.view(view).long()).abs().max().item()


@pytest.mark.parametrize("m,k,n", [(1000, 96, 200), (129, 16, 3),
                                   (300, 1552, 130), (64, 8960, 72)])
def test_int8_gemm_accumulator_is_exact(cuda, m, k, n):
    from mmpl_tpu_torch.ops import quant
    a, b = _int8((m, k), 0, cuda), _int8((n, k), 1, cuda)
    got = quant.int8_gemm_cuda(a, b, None, None, torch.int32)
    want = quant.int8_gemm_plain(a, b, None, None, torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1000, 96, 200), (77, 48, 31)])
def test_w8a8_kernels_match_plain(cuda, act, out, m, k, n):
    """Q's codes and scales exactly, P2's output within 1 ulp."""
    from mmpl_tpu_torch.ops import quant
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         * 3).to(cuda, act)
    x[5] = 0                                  # an all-zero row: s = 1e-12
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                         ).to(cuda)
    wq, sw = quant.quantize_weight(w)
    xq, sx = quant.quantize_rows_cuda(x)
    pq, psx = quant.quantize_rows_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, psx)
    assert not xq[5].any() and sx[5].item() == np.float32(1e-12)
    got = quant.int8_gemm_cuda(xq, wq, sx, sw, out)
    want = quant.int8_gemm_plain(xq, wq, sx, sw, out)
    assert got.dtype == out and _ulps(got, want) <= 1


@pytest.mark.parametrize("case", ["k_not_16", "a_float", "b_int16",
                                  "a_strided", "b_transposed", "sx_f64",
                                  "out_f16", "x_int8", "x_strided"])
def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda, case):
    from mmpl_tpu_torch.ops import quant
    a, b = _int8((64, 96), 0, cuda), _int8((32, 96), 1, cuda)
    sx = torch.ones(64, device=cuda)
    sw = torch.ones(32, device=cuda)
    x = torch.randn((64, 96), device=cuda)
    calls = {
        "k_not_16": lambda: quant.int8_gemm_cuda(a[:, :40].contiguous(),
                                                 b[:, :40].contiguous(),
                                                 sx, sw),
        "a_float": lambda: quant.int8_gemm_cuda(a.float(), b, sx, sw),
        "b_int16": lambda: quant.int8_gemm_cuda(a, b.to(torch.int16), sx, sw),
        "a_strided": lambda: quant.int8_gemm_cuda(
            _int8((64, 192), 3, cuda)[:, ::2], b, sx, sw),
        "b_transposed": lambda: quant.int8_gemm_cuda(
            a, _int8((96, 32), 4, cuda).t(), sx, sw),
        "sx_f64": lambda: quant.int8_gemm_cuda(a, b, sx.double(), sw),
        "out_f16": lambda: quant.int8_gemm_cuda(a, b, sx, sw, torch.float16),
        "x_int8": lambda: quant.quantize_rows_cuda(a),
        "x_strided": lambda: quant.quantize_rows_cuda(
            torch.randn((64, 192), device=cuda)[:, :96]),
    }
    quant.reset_launch_counts()
    with pytest.raises(ValueError):
        calls[case]()
    assert quant.launch_counts == {"int8_gemm": 0, "quantize_rows": 0}


def test_linear_launches_q_and_p2_once_per_w8a8_call(cuda):
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.ops import quant
    lin = torch.nn.Linear(96, 200, device=cuda, dtype=torch.bfloat16)
    x = torch.randn((2, 50, 96), device=cuda, dtype=torch.bfloat16)
    q8 = quant.QuantLinear.from_linear(lin)
    wo = quant.QuantLinear.from_linear(lin, weight_only=True)
    quant.reset_launch_counts()
    y = dit.linear(q8, x)
    dit.linear(wo, x)
    dit.linear(lin, x)
    assert quant.launch_counts == {"int8_gemm": 1, "quantize_rows": 1}
    assert y.shape == (2, 50, 200) and y.dtype == torch.bfloat16
    ref = dit.linear(lin, x).float()
    assert ((y.float() - ref).norm() / ref.norm()).item() < 0.02


def test_int8_conv_launches_p2_once_per_chunk(cuda, monkeypatch):
    """An int8 VAE conv on the card: one P2 launch per im2col chunk, and
    the same fp32 output as the CPU's plain path (both exact)."""
    from mmpl_tpu_torch.models import vae
    from mmpl_tpu_torch.ops import quant
    conv = vae.Conv(48, 32, (3, 3, 3))
    torch.nn.init.uniform_(conv.weight, -0.1, 0.1)
    torch.nn.init.uniform_(conv.bias, -0.1, 0.1)
    q = vae.QuantConv.from_conv(conv)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 48, 3, 5, 6)).astype(np.float32))
    want = vae._conv3d(q, x)
    monkeypatch.setattr(vae, "IM2COL_BYTES", 2 * 6 * 48 * 27)
    quant.reset_launch_counts()
    vae.int8_conv_counts.update(convs=0, chunks=0)
    got = vae._conv3d(q.to(cuda), x.to(cuda))
    assert vae.int8_conv_counts == {"convs": 1, "chunks": 9}
    assert quant.launch_counts == {"int8_gemm": 9, "quantize_rows": 0}
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_int8_cache_commit_launches_q_for_k_and_v_per_layer(cuda):
    """The commit forward codes each layer's k and v with Q (two launches
    per layer) and writes the same codes as the CPU's plain path, up to a
    flip by one where the fp32 attention's order of sums differs."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.core.geometry import KV_CACHE_SLOTS
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.models.fps_dit import init_kv_cache
    from mmpl_tpu_torch.ops import quant
    from mmpl_tpu_torch.pipelines.fps_inference import (
        CausalFPSInferencePipeline)
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(6)
    cond, uncond = (torch.from_numpy(rng.standard_normal(
        (1, cfg.text_len, cfg.text_dim)).astype(np.float32))
        for _ in range(2))
    schedule = CausalFPSInferencePipeline(cfg, copy.deepcopy(model)
                                          ).plan.groups[0]
    lat = torch.from_numpy(rng.standard_normal(
        (1, schedule.num_frames, 16, 4, 4)).astype(np.float32))
    caches, counts = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = CausalFPSInferencePipeline(cfg, copy.deepcopy(model).to(dev),
                                          quantize_cache=True,
                                          dtype=torch.float32)
        cache = init_kv_cache(cfg, 2, 4, KV_CACHE_SLOTS, torch.float32, dev,
                              quantize=True)
        quant.reset_launch_counts()
        with torch.inference_mode():
            pipe._forward(schedule, pipe.prepare_context(
                cond.to(dev), uncond.to(dev)), cache, lat.to(dev), 0.0, True)
        caches[dev] = {k: v.cpu() for k, v in cache.items()}
        counts[dev] = dict(quant.launch_counts)
    assert counts["cpu"] == {"int8_gemm": 0, "quantize_rows": 0}
    assert counts["cuda"] == {"int8_gemm": 0,
                              "quantize_rows": 2 * cfg.num_layers}
    got, want = caches["cuda"], caches["cpu"]
    for name in ("k", "v"):
        assert want[f"{name}_scale"].any()
        assert (got[name].int() - want[name].int()).abs().max().item() <= 1
        torch.testing.assert_close(got[f"{name}_scale"],
                                   want[f"{name}_scale"], rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# P1 (the exp2 probe's forward) and the few-step window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_exp2", [False, True])
@pytest.mark.parametrize("mask_pad", [True, False])
@pytest.mark.parametrize("dtype,d,tol", [(torch.bfloat16, 128, 2e-2),
                                         (torch.float32, 24, 1e-5)])
def test_exp2_variants_match_plain_at_a_ragged_lq(cuda, use_exp2, mask_pad,
                                                  dtype, d, tol):
    """P1's four variants against their plain version (both round P to
    the input type) at Lq = 1000 (ragged) and Lk = 1280 (a multiple of
    64, so the variants without the pad test are defined)."""
    q, k, v = _qkv(1000, 1280, d, dtype, cuda, seed=3)
    ta.reset_launch_counts()
    got = ta.flash_attention_exp2(q, k, v, use_exp2, mask_pad)
    want = ta.flash_attention_exp2_plain(q, k, v, use_exp2, mask_pad)
    torch.cuda.synchronize()
    assert ta.launch_counts == {**dict.fromkeys(ta.launch_counts, 0),
                                "flash_exp2": 1}
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_exp2_with_the_pad_test_matches_k1_at_a_ragged_lk(cuda):
    q, k, v = _qkv(300, 1300, 128, torch.bfloat16, cuda, seed=4)
    got = ta.flash_attention_exp2(q, k, v, use_exp2=True, mask_pad=True)
    want = ta.flash_fwd_cuda(q, k, v)[0]
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_exp2_refuses_mask_pad_false_on_a_ragged_lk(cuda):
    q, k, v = _qkv(64, 1300, 128, torch.bfloat16, cuda)
    ta.reset_launch_counts()
    with pytest.raises(ValueError, match="mask_pad=False"):
        ta.flash_attention_exp2(q, k, v, mask_pad=False)
    assert ta.launch_counts["flash_exp2"] == 0


def test_few_step_window_on_the_card(cuda):
    """A tiny fp32 few-step window (2 blocks, 2 steps) on the card against
    the CPU's plain path from the same weights and draws, with its K1
    launches: blocks x (steps + commit) x layers x (self + cross)."""
    import copy

    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    from mmpl_tpu_torch.pipelines.causal_inference import (
        CausalInferencePipeline)
    cfg = tiny_test_config()
    model = dit.randomize_head(dit.init_dit_params(
        cfg, torch.Generator().manual_seed(0), torch.float32),
        torch.Generator().manual_seed(99))
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(rng.standard_normal((1, 6, 16, 4, 4)).astype(
        np.float32))
    cond = torch.from_numpy(rng.standard_normal(
        (1, cfg.text_len, cfg.text_dim)).astype(np.float32))
    sn = [torch.from_numpy(rng.standard_normal((1, 1, 3, 16, 4, 4)).astype(
        np.float32)) for _ in range(2)]
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = CausalInferencePipeline(cfg, copy.deepcopy(model).to(dev),
                                       denoising_step_list=(1000, 500),
                                       dtype=torch.float32)
        ta.reset_launch_counts()
        out[dev] = pipe.inference(noise.to(dev), cond.to(dev),
                                  step_noise=sn).cpu()
    assert ta.launch_counts["flash_fwd"] == 2 * 3 * cfg.num_layers * 2
    rel = ((out["cuda"] - out["cpu"]).norm() / out["cpu"].norm()).item()
    assert rel <= 1e-4, rel
