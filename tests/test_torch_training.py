"""Port parity: the teacher-forcing training slice (`fps_forward_train`, the
loss and its gradients, two AdamW steps, the EMA, the CLI) against the JAX
package, at `tiny_test_config` in f32 on the CPU."""

import copy
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.core.geometry import T2V_CLEAN_STEPS
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.models.fps_dit import fps_forward_train as j_forward_train
from mmpl_tpu.parallel.mesh import make_mesh
from mmpl_tpu.schedulers.flow_match import FlowMatchScheduler
from mmpl_tpu.training import diffusion as jdiff
from mmpl_tpu.training import masks as jmasks
from mmpl_tpu.utils.ema import EmaParams as JEma
from mmpl_tpu_torch import train as ttrain
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models.fps_dit import fps_forward_train
from mmpl_tpu_torch.training import diffusion as tdiff
from mmpl_tpu_torch.utils.ema import EmaParams
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax
from helpers import randomize_head


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, F, C, H, W = 1, 21, 16, 4, 4
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
FM = jmasks.fps_forcing_frame_mask(T2V_CLEAN_STEPS)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    assert dict(cfg) == dict(j_tiny())
    params = randomize_head(jdit.init_dit_params(jax.random.PRNGKey(0), cfg,
                                                 jnp.float32))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((B, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    batch = {"latents": rng.standard_normal((B, F, C, H, W)).astype(
                 np.float32),
             "context": ctx, "uncond_context": np.zeros_like(ctx)}
    return cfg, tree, batch


def port_model(tree, cfg):
    model = tdit.empty_dit(cfg, fused=False, dtype=torch.float32)
    model.load_state_dict(dit_state_from_jax(tree, cfg))
    return model


def tt(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_draws(rng, nfpb=3, aug_max=100):
    """The draws of `make_teacher_forcing_loss_fn`'s key chain."""
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    nb = F // nfpb
    return {"idx": torch.from_numpy(np.array(jax.random.randint(
                k1, (B, nb), 0, 1000))).long(),
            "noise": tt(jax.random.normal(k2, (B, F, C, H, W), jnp.float32)),
            "idx_aug": torch.from_numpy(np.array(jax.random.randint(
                k3, (B, nb), 0, aug_max))).long(),
            "coin": tt(jax.random.uniform(k4, ()))}


def scheduler():
    sch = FlowMatchScheduler(shift=8.0, sigma_min=0.0, extra_one_step=True)
    sch.set_timesteps(1000, training=True)
    return sch


def test_fps_forward_train_matches_jax(setup):
    cfg, tree, _ = setup
    rng = np.random.default_rng(1)
    noisy, clean = (rng.standard_normal((B, F, C, H, W)).astype(np.float32)
                    for _ in range(2))
    t = np.repeat(rng.uniform(0, 1000, (B, 7)), 3, axis=1).astype(np.float32)
    aug = np.repeat(rng.uniform(0, 60, (B, 7)), 3, axis=1).astype(np.float32)
    ctx = rng.standard_normal((B, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    want = np.asarray(j_forward_train(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(noisy),
        jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(FM),
        clean_x=jnp.asarray(clean), aug_t=jnp.asarray(aug)))
    got = fps_forward_train(port_model(tree, cfg), cfg, tt(noisy), tt(t),
                            tt(ctx), FM, clean_x=tt(clean), aug_t=tt(aug))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_fps_forward_train_anchor_blinding(setup):
    """One layer: perturbing clean frame 19 leaves the step-2 noisy outputs
    (frames 4..9) alone and moves the step-3 outputs (13..18); perturbing
    clean frame 0 moves step 2 (tests/test_training.py:99-134)."""
    cfg, tree, _ = setup
    cfg1 = copy.deepcopy(cfg)
    cfg1.num_layers = 1
    tree1 = dict(tree, blocks=jax.tree.map(lambda a: a[:1], tree["blocks"]))
    model = port_model(tree1, cfg1)
    g = torch.Generator().manual_seed(2)
    noisy, clean = (torch.randn((1, F, C, H, W), generator=g)
                    for _ in range(2))
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g)
    t = torch.full((1, F), 400.0)
    run = lambda c: fps_forward_train(model, cfg1, noisy, t, ctx, FM,
                                      clean_x=c, aug_t=torch.zeros(1, F))
    with torch.no_grad():
        out_a = run(clean)
        out_b = run(clean.index_add(1, torch.tensor([19]),
                                    torch.full((1, 1, C, H, W), 3.0)))
        out_c = run(clean.index_add(1, torch.tensor([0]),
                                    torch.full((1, 1, C, H, W), 3.0)))
    step2, step3 = list(range(4, 10)), list(range(13, 19))
    torch.testing.assert_close(out_a[:, step2], out_b[:, step2], atol=2e-5,
                               rtol=0)
    assert (out_a[:, step3] - out_b[:, step3]).abs().max() > 1e-4
    assert (out_a[:, step2] - out_c[:, step2]).abs().max() > 1e-4


def _grads_close(model, jgrads, cfg, atol):
    want = dit_state_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    nonzero = 0
    for name, w in want.items():
        gr = got[name].grad
        assert gr is not None, name
        np.testing.assert_allclose(gr.numpy(), w.numpy(), atol=atol,
                                   rtol=1e-4, err_msg=name)
        nonzero += bool(np.abs(w.numpy()).max() > 0)
    assert nonzero > len(want) // 2


def test_teacher_forcing_loss_and_grads_match_jax(setup):
    cfg, tree, batch = setup
    sch = scheduler()
    jloss = jdiff.make_teacher_forcing_loss_fn(
        cfg, sch, FM, num_frame_per_block=3, noise_aug_max_timestep=100,
        compute_dtype=jnp.float32)
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_w, grads_w = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, tree), jb, rng)

    tloss = tdiff.make_teacher_forcing_loss_fn(
        cfg, tdiff.make_scheduler(8.0), FM, num_frame_per_block=3,
        noise_aug_max_timestep=100, compute_dtype=torch.float32)
    model = port_model(tree, cfg).requires_grad_(True)
    loss_g = tloss(model, {k: tt(v) for k, v in batch.items()},
                   jax_draws(rng))
    loss_g.backward()
    np.testing.assert_allclose(loss_g.item(), float(loss_w), rtol=1e-5)
    _grads_close(model, grads_w, cfg, atol=1e-4)


def test_two_trainer_steps_match_jax(setup):
    cfg, tree, batch = setup
    jloss = jdiff.make_teacher_forcing_loss_fn(
        cfg, scheduler(), FM, noise_aug_max_timestep=100,
        compute_dtype=jnp.float32)
    mesh = make_mesh({"dp": 1, "fsdp": 1, "tp": 1})
    jtr = jdiff.DiffusionTrainer(cfg, jax.tree.map(jnp.asarray, tree),
                                 mesh=mesh, learning_rate=1e-3,
                                 loss_fn=jloss)
    tloss = tdiff.make_teacher_forcing_loss_fn(
        cfg, tdiff.make_scheduler(8.0), FM, noise_aug_max_timestep=100,
        compute_dtype=torch.float32)
    model = port_model(tree, cfg)
    ttr = tdiff.DiffusionTrainer(model, tloss, learning_rate=1e-3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: tt(v) for k, v in batch.items()}
    for seed in (11, 12):
        rng = jax.random.PRNGKey(seed)
        lw = float(jtr.train_step(jb, rng))
        lg = ttr.train_step(tb, jax_draws(rng)).item()
        np.testing.assert_allclose(lg, lw, rtol=1e-5)
    want = dit_state_from_jax(jax.tree.map(np.asarray, jtr.params), cfg)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
        start = dit_state_from_jax(tree, cfg)[name].numpy()
        moved += bool(np.abs(p.detach().numpy() - start).max() > 1e-4)
    assert moved > len(want) // 2
    assert torch.isfinite(ttr.grad_norm) and ttr.grad_norm > 0


def test_ema_matches_jax(setup):
    cfg, tree, _ = setup
    model = port_model(tree, cfg)
    jema = JEma(jax.tree.map(jnp.asarray, tree), decay=0.9)
    ema = EmaParams(model, decay=0.9)
    rng = np.random.default_rng(3)
    for _ in range(2):
        tree = jax.tree.map(
            lambda a: a + rng.standard_normal(a.shape).astype(np.float32),
            tree)
        jema.update(jax.tree.map(jnp.asarray, tree))
        model.load_state_dict(dit_state_from_jax(tree, cfg))
        ema.update(model)
    want = dit_state_from_jax(jax.tree.map(np.asarray, jema.shadow), cfg)
    assert set(ema.shadow) == set(want)
    for name, s in ema.shadow.items():
        np.testing.assert_allclose(s.numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_train_cli_smoke_run_logs_finite_losses(tmp_path):
    rc = ttrain.main(["--smoke", "--steps", "2", "--device", "cpu",
                      "--log-dir", str(tmp_path), "--run-name", "tf"])
    assert rc == 0
    lines = (tmp_path / "tf" / "metrics.jsonl").read_text().splitlines()
    losses = [json.loads(ln)["loss"] for ln in lines]
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg = json.loads((tmp_path / "tf" / "config.json").read_text())
    assert cfg["steps"] == 2 and cfg["device"] == "cpu"


@pytest.mark.parametrize("argv,slice_name", [
    (["--objective", "dmd"], None),
    (["--objective", "ode"], None),
    (["--objective", "flow"], None),
    (["--data-dir", "x"], "Slice I"),
    (["--resume", "x"], None),
    (["--export-pt", "x"], None),
    (["--ckpt-dir", "x"], None),
    (["--generator-ckpt", "x"], None),
    (["--wan-dir", "x"], None),
    (["--config", str(CONFIGS / "self_forcing_df.yaml")], None),
    # --mesh is ported (this case's id kept): it parses; with it the
    # checkpoint flags are refused (the next case)
    pytest.param(["--mesh", "dp=2"], None, id="argv10-Slice F"),
    (["--remat-offload"], "TPU workaround"),
    (["--offload-opt"], "TPU workaround"),
    (["--config", str(CONFIGS / "self_forcing_dmd.yaml")], None),
    (["--mesh", "dp=2", "--ckpt-dir", "x"], "sharded checkpoints"),
])
def test_refused_flags_name_their_slice(argv, slice_name, capsys):
    """Flags that are not ported exit naming their ROADMAP slice (or that
    they are a TPU workaround); the flags and objectives that the port
    trains (slice_name None) parse, the distillation run configs
    included."""
    if slice_name is None:
        args = ttrain.parse_args(argv)
        assert getattr(args, argv[0][2:].replace("-", "_")) == argv[1]
        return
    with pytest.raises(SystemExit):
        ttrain.parse_args(argv)
    assert slice_name in capsys.readouterr().err


def test_cuda_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1", "--log-dir", str(tmp_path)])
