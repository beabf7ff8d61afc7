"""Port parity: int8 projections and the int8 KV cache over tp
(`parallel/mesh.shard_params_for_inference` of `QuantLinear`s, Q's amax
and given-scale modes with the maximum over tp, P2's int32 accumulators
summed over tp, `fps_dit`'s cache codes over tp), on gloo ranks spawned
as `test_torch_mesh.py` spawns them, and Q's plain modes.

The sharded windows hold the port's unsharded window and JAX's window
under its (dp 2, fsdp 2, tp 2) mesh within the int8 tolerance: the
QK-norms sum their squares over tp in another order than one rank does,
so an activation may differ from the unsharded one in its last bit and,
under W8A8, flip a code.  What tp changes nothing of holds bit for bit:
the row-parallel accumulators, codes, scales and outputs, and the cache's
codes and scales, of the same activations split over the ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.parallel.mesh import make_mesh as j_make_mesh
from mmpl_tpu.pipelines.fps_inference import \
    CausalFPSInferencePipeline as JPipe
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import fps_dit
from mmpl_tpu_torch.ops import quant as tquant
from mmpl_tpu_torch.pipelines.fps_inference import \
    CausalFPSInferencePipeline as TPipe

from test_torch_dit import jax_params_np, port_model
from test_torch_mesh import _free_port, _spawn
from test_torch_pipeline import _jax_reseed_noise


def test_q_plain_modes_compose_to_quantize_rows():
    """Q's amax mode, the scale and Q's given-scale mode give
    `quantize_rows_plain`'s codes and scales, bf16 and fp32, with ties and
    a zero row; split over two column halves with the maximum taken, the
    whole rows' codes."""
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((37, 96)).astype(
            np.float32)).to(dtype)
        x[3] = 0
        x[5, :4] = torch.tensor([63.5, -127.0, 0.5, 1.5]).to(dtype)
        q, s = tquant.quantize_rows_plain(x)
        amax = tquant.row_amax_plain(x)
        assert amax.dtype == torch.float32
        assert torch.equal(amax, x.float().abs().amax(-1))
        assert torch.equal(tquant.amax_scale(amax), s)
        assert torch.equal(tquant.quantize_rows_scaled_plain(x, s), q)
        halves = x.chunk(2, -1)
        whole = torch.maximum(*(tquant.row_amax(h) for h in halves))
        sh = tquant.amax_scale(whole)
        assert torch.equal(sh, s)
        assert torch.equal(torch.cat([tquant.quantize_rows_scaled(h, sh)
                                      for h in halves], -1), q)
    assert tquant.launch_counts == {"int8_gemm": 0, "quantize_rows": 0}


@pytest.fixture(scope="module")
def window_case():
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    tree = jax_params_np(cfg_j, seed=5)
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((1, 21, 16, 4, 4)).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, 16, 64)).astype(np.float32)
                    for _ in range(2))
    key = jax.random.PRNGKey(7)
    draws = _jax_reseed_noise(key, TPipe(cfg_t, port_model(tree, cfg_t),
                                         sampling_steps=2).plan, 0)
    return cfg_j, cfg_t, tree, noise, cond, uncond, key, draws


def _window(cfg, model, mode, noise, cond, uncond, draws):
    return TPipe(cfg, model, sampling_steps=2, quantize=mode,
                 quantize_cache=True, dtype=torch.float32).inference(
        torch.from_numpy(noise), torch.from_numpy(cond),
        torch.from_numpy(uncond), reseed_noise=draws).numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_int8_over_four_gloo_ranks(tmp_path, window_case, monkeypatch):
    """W8A8 with the int8 cache over (fsdp 2, tp 2) and (dp 2, tp 2), W8A16
    and `auto` over (dp 2, tp 2): each window against the port's unsharded
    window of the same mode (W8A16 within the float windows' 5e-4), and
    W8A8's against JAX's under its (dp 2, fsdp 2, tp 2) mesh.  The unsharded window's fc2 input and its first
    commit's K tokens, split over tp 2: the summed int32 accumulators,
    codes, scales and W8A8 output of fc2, and the cache's codes and
    scales, equal the unsharded ones bit for bit."""
    cfg_j, cfg_t, tree, noise, cond, uncond, key, draws = window_case
    seen = {}
    w8a8, code = tquant.w8a8_matmul, fps_dit.quantize_rows

    def spy_w8a8(x, wq, wscale, *a, **kw):
        if wq.shape[1] == cfg_t.ffn_dim and "fc2_x" not in seen:
            seen.update(fc2_x=x.reshape(-1, wq.shape[1]).clone())
        return w8a8(x, wq, wscale, *a, **kw)

    def spy_code(x):
        seen.setdefault("k", x.clone())
        return code(x)

    monkeypatch.setattr(tquant, "w8a8_matmul", spy_w8a8)
    monkeypatch.setattr(fps_dit, "quantize_rows", spy_code)
    single = {mode: _window(cfg_t, port_model(tree, cfg_t), mode, noise,
                            cond, uncond, draws)
              for mode in ("int8", "int8wo", "auto")}
    monkeypatch.undo()
    model = port_model(tree, cfg_t)
    inp = {"noise": noise, "cond": cond, "uncond": uncond,
           "num_heads": np.asarray(cfg_t.num_heads),
           "fc2_x": seen["fc2_x"].numpy(), "k": seen["k"].numpy(),
           "fc2_w": model.blocks[0].ffn.fc2.weight.detach().numpy(),
           **{f"rn_{gi}": v.numpy() for gi, v in draws.items()},
           **{f"dit.{k}": v.numpy() for k, v in model.state_dict().items()}}
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "NUM_PROCESSES": 4, "PROCESS_ID": "{rank}"}
    outs = _spawn(tmp_path, 4, env, ["int8_mesh"], inp)

    jwant = np.asarray(JPipe(
        cfg_j, jax.tree.map(jnp.asarray, tree), sampling_steps=2,
        mesh=j_make_mesh({"dp": 2, "fsdp": 2, "tp": 2}), quantize="int8",
        quantize_cache=True, dtype=jnp.float32).inference(
        jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(uncond),
        rng=key))
    assert np.abs(single["int8"] - noise).mean() > 1e-3
    assert _rel(single["int8"], jwant) <= 5e-3

    x = seen["fc2_x"]
    codes, scale = tquant.quantize_weight(torch.from_numpy(inp["fc2_w"]))
    xq, xs = tquant.quantize_rows_plain(x)
    acc = tquant.int8_gemm(xq, codes, None, None, torch.int32)
    y = tquant.w8a8_matmul(x, codes, scale)
    kq, ks = tquant.quantize_rows_plain(seen["k"])
    for rank, out in enumerate(outs):
        tp = rank % 2
        for name in ("fsdp2_tp2_int8", "dp2_tp2_int8"):
            got = out[f"window_{name}"]
            assert _rel(got, single["int8"]) <= 5e-3, name
            assert _rel(got, jwant) <= 5e-3, name
        np.testing.assert_allclose(out["window_dp2_tp2_int8wo"],
                                   single["int8wo"], atol=5e-4)
        # the tiny model's `auto` policy takes W8A8 for every projection
        assert _rel(out["window_dp2_tp2_auto"], single["auto"]) <= 5e-3
        assert np.array_equal(out["fc2_acc"], acc.numpy())
        assert np.array_equal(out["fc2_xs"], xs.numpy())
        assert np.array_equal(out["fc2_xq"], xq.chunk(2, -1)[tp].numpy())
        assert np.array_equal(out["fc2_y"], y.numpy())
        assert np.array_equal(out["cache_codes"], kq.chunk(2, -1)[tp]
                              .numpy())
        assert np.array_equal(out["cache_scales"], ks.numpy())
