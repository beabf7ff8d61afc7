"""Port parity: sequence parallelism in the in-process group
(`mmpl_tpu_torch/parallel/{collectives,sequence_parallel}.py`,
`ops/attention.ring_flash_attention`) against the JAX package's functions
under `shard_map` on its virtual CPU mesh: the ring (dense, and the flash
ring with its own backward: the plain kernels here, the Pallas kernels in
interpret mode there), Ulysses, `usp_dit_forward` at sp = 2 and at
sp = 2 x ring = 2, and `WanT2V` over a mesh.  f32; tolerances 1e-5 on
forwards and 1e-4 on gradients.  The same code over gloo process groups
is in `test_torch_mesh.py`."""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.parallel import sequence_parallel as jsp
from mmpl_tpu.parallel.mesh import make_mesh as j_make_mesh
from mmpl_tpu.pipelines import wan_reference as jwr
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.ops import attention as tattn
from mmpl_tpu_torch.parallel import sequence_parallel as tsp
from mmpl_tpu_torch.parallel.collectives import LocalMesh, as_mesh
from mmpl_tpu_torch.pipelines import wan_reference as twr
from mmpl_tpu_torch.utils.device import set_float32_precision

from test_torch_dit import jax_params_np, port_model
from test_torch_distill_draws import few_threads

FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = few_threads()
    set_float32_precision()
    yield
    torch.set_num_threads(n)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_ring(q, k, v, ring, impl):
    """(out, dq, dk, dv) of JAX's ring under shard_map, loss sum(out^2)."""
    mesh = j_make_mesh({"ring": ring})
    fn = shard_map(partial(jsp.ring_attention, axis_name="ring", impl=impl),
                   mesh=mesh, in_specs=(P(None, "ring"),) * 3,
                   out_specs=P(None, "ring"), check_vma=False)
    args = [jnp.asarray(a) for a in (q, k, v)]
    loss = lambda *a: jnp.sum(fn(*a) ** 2)
    out, grads = jax.jit(lambda *a: (fn(*a), jax.grad(
        loss, argnums=(0, 1, 2))(*a)))(*args)
    return [np.asarray(x) for x in (out, *grads)]


def _port_ring(q, k, v, ring, impl):
    mesh = LocalMesh({"ring": ring})
    full = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    loc = [mesh.shard(x, 1, ("ring",)) for x in full]
    out = mesh.gather(tsp.ring_attention(*loc, mesh.get_group("ring"),
                                         impl=impl), 1, ("ring",))
    grads = torch.autograd.grad((out ** 2).sum(), full)
    return [x.detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_ring_matches_jax_dense_ring(impl):
    """More shards than heads (ring 4, 2 heads), the case Ulysses alone
    cannot serve; both port rings against JAX's dense ring."""
    q, k, v = _qkv(0, (2, 32, 2, 16))
    want = _jax_ring(q, k, v, 4, "dense")
    got = _port_ring(q, k, v, 4, impl)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=f"d{name}")


def test_ring_flash_matches_jax_ring_flash():
    """The flash ring (K1 / K2 / K3's plain versions here) against JAX's
    ring-level custom VJP over its Pallas kernels in interpret mode, at a
    lane-aligned head dim."""
    q, k, v = _qkv(3, (1, 256, 2, 128))
    want = _jax_ring(q, k, v, 2, "flash")
    got = _port_ring(q, k, v, 2, "flash")
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=f"d{name}")


def test_ring_flash_counts_one_kernel_call_per_chunk(monkeypatch):
    """One K1 call per ring step over every rank's shard at once, one K2 /
    K3 pair per step backward, each with the global lse and delta."""
    calls = {"fwd": 0, "bwd": []}
    fwd, bwd = tattn.flash_attention_lse, tattn.flash_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(q, k, v, do, lse, delta, scale=None):
        calls["bwd"].append((lse, delta))
        return bwd(q, k, v, do, lse, delta, scale)

    monkeypatch.setattr(tattn, "flash_attention_lse", count_fwd)
    monkeypatch.setattr(tattn, "flash_attention_bwd", count_bwd)
    mesh = LocalMesh({"ring": 4})
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, (8, 8, 2, 16)))
    out = tattn.ring_flash_attention(q, k, v, mesh.get_group("ring"))
    out.sum().backward()
    assert calls["fwd"] == 4 and len(calls["bwd"]) == 4
    assert all(lse is calls["bwd"][0][0] for lse, _ in calls["bwd"])


def test_ulysses_matches_jax():
    q, k, v = _qkv(2, (1, 32, 4, 16))
    mesh = j_make_mesh({"sp": 2})
    fn = shard_map(partial(jsp.ulysses_attention, axis_name="sp"),
                   mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                   out_specs=P(None, "sp"), check_vma=False)
    want = np.asarray(fn(*[jnp.asarray(a) for a in (q, k, v)]))
    tmesh = LocalMesh({"sp": 2})
    loc = [tmesh.shard(torch.from_numpy(a), 1, ("sp",)) for a in (q, k, v)]
    got = tmesh.gather(tsp.ulysses_attention(*loc, tmesh.get_group("sp")),
                       1, ("sp",)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def _usp_case(heads):
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    if heads != cfg_j.num_heads:
        cfg_j = copy.deepcopy(cfg_j)
        cfg_t = copy.deepcopy(cfg_t)
        cfg_j.num_heads = cfg_t.num_heads = heads
    tree = jax_params_np(cfg_j, seed=4)
    return cfg_j, cfg_t, tree, port_model(tree, cfg_t)


@pytest.mark.parametrize("shape,frames,heads", [
    ({"sp": 2}, 3, 4), ({"sp": 2, "ring": 2}, 4, 2)],
    ids=["sp2", "sp2_ring2"])
def test_usp_dit_forward_matches_jax(shape, frames, heads):
    cfg_j, cfg_t, tree, model = _usp_case(heads)
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((1, frames, 16, 8, 8)).astype(np.float32)
    t = np.asarray([500.0], np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    ring = "ring" if "ring" in shape else None
    want = np.asarray(jsp.usp_dit_forward(
        jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(lat),
        jnp.asarray(t), jnp.asarray(ctx), j_make_mesh(shape),
        ring_axis=ring))
    got = tsp.usp_dit_forward(model, cfg_t, torch.from_numpy(lat),
                              torch.from_numpy(t), torch.from_numpy(ctx),
                              LocalMesh(shape), ring_axis=ring).numpy()
    assert got.shape == want.shape == (1, frames, 16, 8, 8)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_usp_refuses_what_does_not_split():
    _, cfg_t, _, model = _usp_case(4)
    lat, t, ctx = torch.zeros(1, 3, 16, 8, 8), torch.zeros(1), \
        torch.zeros(1, 16, 64)
    with pytest.raises(ValueError, match="multiple of sp"):
        tsp.usp_dit_forward(model, cfg_t, lat, t, ctx,
                            LocalMesh({"sp": 2, "ring": 5}),
                            ring_axis="ring")
    with pytest.raises(ValueError, match="heads"):
        tsp.usp_dit_forward(model, cfg_t, lat, t, ctx, LocalMesh({"sp": 8}))
    with pytest.raises(TypeError, match="not a mesh"):
        as_mesh({"sp": 2})
    with pytest.raises(ValueError, match="two distinct"):
        LocalMesh({"sp": 2}).get_group("sp").all_to_all(lat, 0, 1)


def test_wan_t2v_over_a_mesh_matches_jax():
    """WanT2V with an sp x ring mesh runs usp_dit_forward (Ulysses and the
    ring) and equals JAX's WanT2V over its sp mesh, 2 UniPC steps."""
    cfg_j, cfg_t, tree, model = _usp_case(2)
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((1, 4, 16, 8, 8)).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, 16, 64)).astype(np.float32)
                    for _ in range(2))
    jp = jwr.WanT2V(cfg_j, jax.tree.map(jnp.asarray, tree), None,
                    sampling_steps=2, mesh=j_make_mesh({"sp": 2}),
                    dtype=jnp.float32)
    want = np.asarray(jp.generate(jnp.asarray(noise), jnp.asarray(cond),
                                  jnp.asarray(uncond), decode=False))
    calls = []
    real = tsp.ulysses_attention

    def spy(*a, **k):
        calls.append(a[4] if len(a) > 4 else k.get("ring_group"))
        return real(*a, **k)

    tsp.ulysses_attention = spy
    try:
        tp = twr.WanT2V(cfg_t, model, None, sampling_steps=2,
                        mesh=LocalMesh({"sp": 2, "ring": 2}),
                        dtype=torch.float32)
        got = tp.generate(torch.from_numpy(noise), torch.from_numpy(cond),
                          torch.from_numpy(uncond), decode=False).numpy()
    finally:
        tsp.ulysses_attention = real
    assert calls and all(g is not None for g in calls)
    np.testing.assert_allclose(got, want, atol=1e-4)
