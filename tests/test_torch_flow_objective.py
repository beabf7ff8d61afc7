"""Port parity: the flow objective (`training/diffusion.make_loss_fn`) and
per-block rematerialisation.

The flow loss and its gradients against `mmpl_tpu.training.diffusion.
make_loss_fn` with the draws of its key chain handed in (fp32 trunk:
loss within 1e-5, gradients within 1e-4 of the largest entry), with one
sample's context dropped; `sample_block_timesteps`; `dit_forward(remat=
True)` and `fps_forward_group(remat=True)` gradients equal to those
without; and `--objective flow` through the port's CLI against
`train.py` at `--device cpu` on the JAX trainer's step-0 batch and draws,
both trunks in fp32."""

import functools
import importlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.training import diffusion as jdiff
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.core.geometry import GroupSchedule
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import fps_dit as tfps
from mmpl_tpu_torch.pipelines.causal_inference import block_schedule
from mmpl_tpu_torch.training import diffusion as tdiff
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax
from test_torch_distill_draws import (C, H, W, _few_torch_threads,  # noqa
                                      dit_pair, schedulers, t)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _flow_draws(rng, shape, nfpb=3):
    """The draws of `make_loss_fn`'s key chain."""
    k1, k2, k3 = jax.random.split(rng, 3)
    B, F = shape[:2]
    tt = jnp.repeat(jax.random.randint(k1, (B, F // nfpb), 0, 1000)
                    .astype(jnp.float32), nfpb, axis=1)
    return {"t": t(tt), "noise": t(jax.random.normal(k2, shape,
                                                     jnp.float32)),
            "coin": t(jax.random.uniform(k3, (B, 1, 1))).reshape(B)}


def _dropping_key(B):
    """A key whose CFG coins drop some samples' context and keep others'
    (bernoulli(k, 0.1) is uniform(k) < 0.1)."""
    for i in range(200):
        k = jax.random.PRNGKey(i)
        k3 = jax.random.split(k, 3)[2]
        drop = np.asarray(jax.random.bernoulli(k3, 0.1, (B, 1, 1))).ravel()
        coin = np.asarray(jax.random.uniform(k3, (B, 1, 1))).ravel()
        assert (drop == (coin < 0.1)).all()
        if drop.any() and not drop.all():
            return k
    raise AssertionError("no key drops one sample of two")


def _grads_close(jg, model, tol=1e-4):
    want = dit_state_from_jax(jax.tree.map(np.asarray, jg),
                              tiny_test_config())
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((g - want[n]).abs().max())
        assert err <= tol * scale, (n, err, scale)


def test_flow_loss_and_grads_match():
    p, m = dit_pair(0)
    js, ts = schedulers()
    B, F = 2, 6
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    ctx = rng.standard_normal((B, 16, 64)).astype(np.float32)
    key = _dropping_key(B)
    jloss = jdiff.make_loss_fn(j_tiny(), js, compute_dtype=jnp.float32)
    jval, jg = jax.jit(jax.value_and_grad(jloss))(
        p, {"latents": jnp.asarray(x0), "context": jnp.asarray(ctx)}, key)
    loss_fn = tdiff.make_loss_fn(tiny_test_config(), ts,
                                 compute_dtype=torch.float32)
    m.requires_grad_(True)
    loss = loss_fn(m, {"latents": t(x0), "context": t(ctx)},
                   _flow_draws(key, x0.shape))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    _grads_close(jg, m)


def test_sample_block_timesteps():
    g = torch.Generator().manual_seed(0)
    tt = tdiff.sample_block_timesteps(g, 2, 9, 3)
    assert tt.dtype == torch.float32 and tuple(tt.shape) == (2, 9)
    assert torch.equal(tt, tt[:, ::3].repeat_interleave(3, dim=1))
    assert 0 <= float(tt.min()) and float(tt.max()) < 1000
    d = tdiff.draw_flow(torch.Generator().manual_seed(1), (2, 6, C, H, W))
    assert tuple(d["noise"].shape) == (2, 6, C, H, W)
    assert tuple(d["coin"].shape) == (2,)


def _grads(model, fn):
    model.zero_grad(set_to_none=True)
    model.requires_grad_(True)
    try:
        fn().square().sum().backward()
        return {n: q.grad.clone() for n, q in model.named_parameters()
                if q.grad is not None}
    finally:
        model.requires_grad_(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_forward_remat_changes_no_value(dtype):
    _, m = dit_pair(3)
    cfg = tiny_test_config()
    rng = np.random.default_rng(1)
    x = t(rng.standard_normal((1, 3, C, H, W)).astype(np.float32)).to(dtype)
    ctx = t(rng.standard_normal((1, 16, 64)).astype(np.float32))
    tt = torch.tensor([300.0])
    out = {}
    for remat in (False, True):
        out[remat] = _grads(m, lambda: tdit.dit_forward(
            m, cfg, x, tt, ctx, remat=remat, compute_dtype=dtype).float())
    assert set(out[True]) == set(out[False])
    for n in out[False]:
        assert torch.equal(out[True][n], out[False][n]), n


def test_fps_forward_group_remat_and_functional_write():
    """Per-layer recomputation and a functional commit change no value;
    a later in-place write to the slots an earlier pass read would."""
    _, m = dit_pair(4)
    cfg = tiny_test_config()
    rng = np.random.default_rng(2)
    x = t(rng.standard_normal((1, 3, C, H, W)).astype(np.float32))
    with torch.no_grad():
        kv = tdit.precompute_context_kv(m, cfg, tdit.embed_text(
            m, t(rng.standard_normal((1, 16, 64)).astype(np.float32))))
    cache0 = tfps.init_kv_cache(cfg, 1, 4, 21, torch.float32)
    tfps.fps_forward_group(m, cfg, x, torch.zeros(1, 3), kv, cache0,
                           block_schedule(0, 3), write_cache=True)
    sched = block_schedule(3, 3)
    tt = torch.full((1, 3), 500.0)

    def run(remat):
        cache = dict(cache0)
        out = tfps.fps_forward_group(m, cfg, x, tt, kv, cache, sched,
                                     remat=remat, write_cache=True,
                                     inplace=False)
        assert cache["k"] is not cache0["k"]
        assert torch.equal(cache["k"][:, :, :3], cache0["k"][:, :, :3])
        return out + cache["k"].sum() * 0

    g0, g1 = _grads(m, lambda: run(False)), _grads(m, lambda: run(True))
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert isinstance(sched, GroupSchedule)


def _jax_train_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("train")


def test_flow_cli_first_loss_matches_jax(monkeypatch, tmp_path):
    """`--objective flow --smoke`, one step in both trainers on the JAX
    trainer's step-0 batch and draws, both trunks fp32."""
    jtrain = _jax_train_module()
    monkeypatch.setattr(jdiff, "make_loss_fn", functools.partial(
        jdiff.make_loss_fn, compute_dtype=jnp.float32))
    base = ["--smoke", "--objective", "flow", "--steps", "1", "--num-frames",
            "6", "--log-dir", str(tmp_path)]
    assert jtrain.main(base + ["--run-name", "jax"]) == 0

    cfg = tiny_test_config()
    k = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    k1, k2 = jax.random.split(k)
    batch = {"latents": t(jax.random.normal(k1, (1, 6, 16, 4, 4))),
             "context": t(jax.random.normal(k2, (1, cfg.text_len,
                                                 cfg.text_dim)))}
    batch["uncond_context"] = torch.zeros_like(batch["context"])
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    from mmpl_tpu_torch import train as ttrain
    monkeypatch.setattr(ttrain, "synthetic_batch",
                        lambda *a, **kw: dict(batch))
    monkeypatch.setattr(tdiff, "draw_flow",
                        lambda *a, **kw: _flow_draws(sub, (1, 6, 16, 4, 4)))
    monkeypatch.setattr(tdiff, "make_loss_fn", functools.partial(
        tdiff.make_loss_fn, compute_dtype=torch.float32))
    jp = jax.tree.map(np.asarray, __import__(
        "mmpl_tpu.models.dit", fromlist=["x"]).init_dit_params(
            jax.random.PRNGKey(0), j_tiny(), jnp.float32))
    monkeypatch.setattr(ttrain, "load_generator", lambda *a: _port(jp))
    assert ttrain.main(base + ["--run-name", "port", "--device", "cpu"]) == 0

    def loss(run):
        line = (tmp_path / run / "metrics.jsonl").read_text().splitlines()
        return json.loads(line[0])["loss"]
    assert np.isfinite(loss("port"))
    np.testing.assert_allclose(loss("port"), loss("jax"), rtol=1e-5)


def _port(tree):
    cfg = tiny_test_config()
    m = tdit.empty_dit(cfg, fused=False, dtype=torch.float32)
    m.load_state_dict(dit_state_from_jax(tree, cfg))
    return m
