"""Port parity: chunk-pipeline stages as process groups
(`ChunkParallelPipeline(stage_meshes=...)`, `generate_parallel` over
processes), on gloo ranks spawned as `test_torch_mesh.py` spawns them.

Two stages of one rank each (2 processes) and two stages of tp 2 each (4
processes), 3 chunks round-robin with JAX's key chain replayed: each
process holds its own stage's chunks; one rank a stage gives the chunks
of the one-process pipeline bit for bit, and both give those of JAX's
`ChunkParallelPipeline(stage_meshes=...)` over 4 virtual devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.parallel import chunk_pipeline as jcp
from mmpl_tpu.parallel.mesh import make_stage_meshes as j_stage_meshes
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.parallel import chunk_pipeline as tcp
from mmpl_tpu_torch.utils.jax_params import vae_state_from_jax

from test_torch_chunk_pipeline import _inputs, _jax_chunk_draws, _numpy_vae
from test_torch_distill_draws import dit_pair
from test_torch_mesh import _free_port, _spawn

CHUNKS, STEPS = 3, 2


@pytest.fixture(scope="module")
def case():
    """The inputs, the draws of JAX's key chain, JAX's chunks over two
    stages of tp 2, and the one-process port pipeline's over two stages
    (one torch thread, as each rank runs)."""
    params, model = dit_pair(0)
    vae_j = _numpy_vae(1)
    vae_t = tvae.empty_vae(torch.float32)
    vae_t.load_state_dict(vae_state_from_jax(jax.tree.map(np.asarray,
                                                          vae_j)))
    noises, cond, uncond = _inputs(3, CHUNKS)
    key = jax.random.PRNGKey(6)
    jpipe = jcp.ChunkParallelPipeline(
        j_tiny(), params, vae_j, sampling_steps=STEPS, dtype=jnp.float32,
        stage_meshes=j_stage_meshes(2, {"dp": 1, "fsdp": 1, "tp": 2},
                                    devices=jax.devices()[:4]))
    want = [np.asarray(c) for c in jpipe.generate(
        [jnp.asarray(n) for n in noises], jnp.asarray(cond),
        jnp.asarray(uncond), rng=key)]
    tpipe = tcp.ChunkParallelPipeline(
        tiny_test_config(), model, vae_t, devices=[torch.device("cpu")] * 2,
        sampling_steps=STEPS, dtype=torch.float32)
    draws = _jax_chunk_draws(key, tpipe.plan, [0] + [2] * (CHUNKS - 1))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = [c.numpy() for c in tpipe.generate(
            [torch.from_numpy(x) for x in noises], torch.from_numpy(cond),
            torch.from_numpy(uncond), reseed_noise=draws)]
    finally:
        torch.set_num_threads(n)
    _, model = dit_pair(0)
    inp = {"cond": cond, "uncond": uncond, "num_heads": np.asarray(4),
           **{f"noise{i}": x for i, x in enumerate(noises)},
           **{f"dit.{k}": v.numpy() for k, v in model.state_dict().items()},
           **{f"vae.{k}": v.numpy() for k, v in vae_t.state_dict().items()}}
    return inp, draws, want, one


@pytest.mark.parametrize("tp", [1, 2])
def test_stage_meshes_over_gloo_ranks(tmp_path, case, tp):
    """2 stages of `tp` ranks: the processes of stage 0 hold chunks 0 and
    2, those of stage 1 chunk 1, each logged; the chunks equal JAX's and,
    at tp 1, the one-process pipeline's bit for bit."""
    inp, draws, want, one = case
    torch.save(draws, tmp_path / "draws.pt")
    world = 2 * tp
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "NUM_PROCESSES": world, "PROCESS_ID": "{rank}"}
    outs = _spawn(tmp_path, world, env, [f"stages_tp{tp}"], inp)
    tag = f"stages_tp{tp}"
    for out in outs:
        stage = int(out[f"{tag}_rank"]) // tp
        own = [c for c in range(CHUNKS) if c % 2 == stage]
        assert list(out[f"{tag}_own"]) == own
        assert [tuple(e) for e in out[f"{tag}_log"]] == [(c, stage)
                                                         for c in own]
        for c in own:
            got = out[f"{tag}_chunk{c}"]
            np.testing.assert_allclose(got, want[c], atol=1e-3)
            if tp == 1:
                assert np.array_equal(got, one[c]), c
