"""Port parity: tensor parallelism in training (`parallel/mesh.
shard_for_training` over a mesh with tp, `train._Ranks`, the layers'
column- and row-parallel moves, `train_state_io.save_sharded` under tp)
on gloo ranks spawned as `test_torch_mesh.py` spawns them.

The teacher-forcing loss and gradients over tp 2 (2 ranks), dp 2 x tp 2
and fsdp 2 x tp 2 (4 ranks) against JAX's single-device
`value_and_grad`; a DMD generator loss and gradients over tp 2 with
JAX's draws replayed; the trainer's CLI at tp 2 resumed from a sharded
checkpoint bit for bit, and its `--export-pt` equal to one process's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.core.geometry import T2V_CLEAN_STEPS
from mmpl_tpu.training import diffusion as jdiff
from mmpl_tpu.training import distillation as jd
from mmpl_tpu.training import masks as jmasks
from mmpl_tpu.training import self_forcing as jsf
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax

from test_torch_distill_draws import dit_pair, distill_draws, schedulers
from test_torch_mesh import _assert_resume_exact, _free_port, _spawn
from test_torch_training import jax_draws, scheduler

B, F = 2, 6
FM = jmasks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:F])
STEPS = (1000, 750, 500, 250)


def _env(world):
    return {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
            "NUM_PROCESSES": world, "PROCESS_ID": "{rank}"}


@pytest.fixture(scope="module")
def tf_case():
    """The tiny model, a 2-row batch, JAX's draws, and JAX's single-device
    teacher-forcing loss and gradients."""
    params, model = dit_pair(0)
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((B, 16, 64)).astype(np.float32)
    batch = {"latents": rng.standard_normal((B, F, 16, 4, 4)).astype(
                 np.float32), "context": ctx, "uncond_context": 0 * ctx}
    key = jax.random.PRNGKey(5)
    jloss = jdiff.make_teacher_forcing_loss_fn(
        j_tiny(), scheduler(), FM, num_frame_per_block=3,
        noise_aug_max_timestep=100, compute_dtype=jnp.float32)
    loss, grads = jax.value_and_grad(jloss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want = {k: v.numpy() for k, v in dit_state_from_jax(
        jax.tree.map(np.asarray, grads), tiny_test_config()).items()}
    draws = jax_draws(key, shape=(B, F, 16, 4, 4))
    inp = {**batch, **{k: v.numpy() for k, v in draws.items()},
           "num_heads": np.asarray(4),
           **{f"dit.{k}": v.numpy() for k, v in model.state_dict().items()}}
    return inp, float(loss), want


def _check_grads(out, tag, want_loss, want, atol=1e-4):
    np.testing.assert_allclose(float(out[f"{tag}_loss"]), want_loss,
                               rtol=1e-5)
    got = {k[len(tag) + 6:]: v for k, v in out.items()
           if k.startswith(f"{tag}_grad.")}
    assert set(got) == set(want), tag
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=atol, rtol=1e-4,
                                   err_msg=f"{tag} {n}")
    norm = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                       for w in want.values()))
    np.testing.assert_allclose(float(out[f"{tag}_grad_norm"]), norm,
                               rtol=1e-4)


def test_tp_training_over_two_gloo_ranks(tmp_path, tf_case):
    """tp 2: the teacher-forcing loss and gradients (whole, gathered) and
    the gradient norm against JAX's; the DMD generator loss and gradients
    against JAX's with its draws replayed; the CLI's sharded checkpoints
    (teacher forcing and DMD) resumed bit for bit; the export of the
    tp-split model equal to one process's bit for bit."""
    inp, tf_loss, tf_want = tf_case
    # DMD, as tests/test_torch_distillation.py's "dmd" case
    (pg, mg), (pf, mf), (pr, mr) = dit_pair(0), dit_pair(10), dit_pair(11)
    js, _ = schedulers(5.0)
    jro = jsf.SelfForcingRollout(j_tiny(), js, STEPS)
    jdist = jd.Distiller(j_tiny(), jd.DistillationConfig(
        timestep_shift=5.0, real_guidance_scale=3.0), jro, js)
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((1, 3, 16, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    from mmpl_tpu.models import dit as jdit
    jb = {"noise": jnp.asarray(noise), "context": jnp.asarray(ctx),
          "uncond_context": jnp.zeros((1, 16, 64)),
          "ctx_kv": jdit.precompute_context_kv(pg, j_tiny(), jdit.embed_text(
              pg, jnp.asarray(ctx)))}
    key = jax.random.PRNGKey(21)
    jm = {"generator": pg, "fake_score": pf, "real_score": pr}
    (dloss, _), dgrads = jax.value_and_grad(
        lambda g: jdist.dmd_generator_loss({**jm, "generator": g}, jb, key),
        has_aux=True)(pg)
    dwant = {k: v.numpy() for k, v in dit_state_from_jax(
        jax.tree.map(np.asarray, dgrads), tiny_test_config()).items()}
    draws = distill_draws(key, jro, [3], len(STEPS), (1, 3, 16, 4, 4))
    torch.save(draws, tmp_path / "draws.pt")
    inp = {**inp, "dmd_noise": noise, "dmd_context": ctx,
           "dmd_uncond_context": 0 * ctx,
           **{f"{k}.{n}": v.numpy() for k, m in (
               ("generator", mg), ("fake_score", mf), ("real_score", mr))
              for n, v in m.state_dict().items()}}
    outs = _spawn(tmp_path, 2, _env(2), ["tp_train"], inp)
    for out in outs:
        _check_grads(out, "tf", tf_loss, tf_want)
        np.testing.assert_allclose(float(out["dmd_loss"]), float(dloss),
                                   rtol=1e-5, atol=1e-7)
        got = {k[len("dmd_grad."):]: v for k, v in out.items()
               if k.startswith("dmd_grad.")}
        scale = max(np.abs(w).max() for w in dwant.values())
        for n, w in dwant.items():
            g = got.get(n, np.zeros_like(w))
            assert np.abs(g - w).max() <= 1e-4 * scale, n
    _assert_resume_exact(tmp_path, {"tp": 2, "dp": 1, "fsdp": 1}, 2)
    # the export of the tp-split (untrained) model against one process's
    from mmpl_tpu_torch import train
    assert train.main(["--smoke", "--device", "cpu", "--steps", "0",
                       "--num-frames", "6", "--log-dir",
                       str(tmp_path / "runs1"), "--export-pt",
                       str(tmp_path / "single.pt")]) == 0
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    got, want = load(tmp_path / "tp2.pt"), load(tmp_path / "single.pt")
    assert set(got) == set(want) == {"generator", "generator_ema"}
    for part in want:
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_tp_mix_training_over_four_gloo_ranks(tmp_path, tf_case):
    """dp 2 x tp 2 (each dp rank on its row) and fsdp 2 x tp 2: the
    teacher-forcing loss, gradients and gradient norm against JAX's."""
    inp, tf_loss, tf_want = tf_case
    outs = _spawn(tmp_path, 4, _env(4), ["tp_mix_train"], inp)
    for out in outs:
        for tag in ("dp2_tp2", "fsdp2_tp2"):
            _check_grads(out, tag, tf_loss, tf_want)
