"""Port parity: the teacher-forcing training slice (`fps_forward_train`, the
loss and its gradients, two AdamW steps, the EMA, the CLI) against the JAX
package, at `tiny_test_config` in f32 on the CPU."""

import copy
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
from test_torch_flow_objective import _flow_draws


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


def jax_draws(rng, nfpb=3, aug_max=100, shape=(B, F, C, H, W)):
    """The draws of `make_teacher_forcing_loss_fn`'s key chain."""
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    nb = shape[1] // nfpb
    return {"idx": torch.from_numpy(np.array(jax.random.randint(
                k1, (shape[0], nb), 0, 1000))).long(),
            "noise": tt(jax.random.normal(k2, shape, jnp.float32)),
            "idx_aug": torch.from_numpy(np.array(jax.random.randint(
                k3, (shape[0], nb), 0, aug_max))).long(),
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


def _grads_close(model, jgrads, cfg, atol, untouched=()):
    """`untouched`: name prefixes of parameters outside the gradient (no
    grad in the port, zeros in JAX)."""
    want = dit_state_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    nonzero = 0
    for name, w in want.items():
        gr = got[name].grad
        if gr is None and name.startswith(untouched):
            assert not np.any(w.numpy()), name
            continue
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
    # --data-dir is ported (this case's id kept): it parses
    pytest.param(["--data-dir", "x"], None, id="argv3-Slice I"),
    (["--resume", "x"], None),
    (["--export-pt", "x"], None),
    (["--ckpt-dir", "x"], None),
    (["--generator-ckpt", "x"], None),
    (["--wan-dir", "x"], None),
    (["--config", str(CONFIGS / "self_forcing_df.yaml")], None),
    # --mesh is ported (this case's id kept): it parses
    pytest.param(["--mesh", "dp=2"], None, id="argv10-Slice F"),
    # host offload is ported (these cases' ids kept): the flags parse
    pytest.param(["--remat-offload"], None, id="argv11-TPU workaround"),
    pytest.param(["--offload-opt", "--objective", "dmd"], None,
                 id="argv12-TPU workaround"),
    (["--config", str(CONFIGS / "self_forcing_dmd.yaml")], None),
    # sharded checkpoints are ported (this case's id kept): they parse
    pytest.param(["--mesh", "dp=2", "--ckpt-dir", "x"], None,
                 id="argv14-sharded checkpoints"),
    # tp in training is ported (this case's id kept): it parses
    pytest.param(["--mesh", "tp=2"], None, id="argv15-Queue 1"),
    (["--objective", "dmd", "--data-dir", "x"], "read no data"),
    # where train.py parses a host-offload flag and ignores it
    (["--offload-opt"], "--offload-opt with --objective teacher_forcing"),
    (["--offload-opt", "--objective", "flow"], "ignores it"),
    (["--offload-opt", "--objective", "ode"], "ignores it"),
    (["--remat-offload", "--objective", "flow"],
     "--remat-offload with --objective flow"),
    pytest.param(["--remat-offload", "--objective", "ode"], None,
                 id="remat-offload-ode"),
    pytest.param(["--offload-opt", "--remat-offload", "--config",
                  str(CONFIGS / "self_forcing_dmd.yaml")], None,
                 id="offload-config-dmd"),
])
def test_refused_flags_name_their_slice(argv, slice_name, capsys):
    """Flags that are not ported exit naming their ROADMAP slice or queue,
    `--data-dir` with a distillation objective exits saying it reads no
    data, a host-offload flag with an objective train.py ignores it for
    exits naming both; the flags and objectives that the port trains
    (slice_name None) parse, the distillation run configs included."""
    if slice_name is None:
        args = ttrain.parse_args(argv)
        flag_only = len(argv) == 1 or argv[1].startswith("--")
        assert getattr(args, argv[0][2:].replace("-", "_")) == (
            True if flag_only else argv[1])
        return
    with pytest.raises(SystemExit):
        ttrain.parse_args(argv)
    assert slice_name in capsys.readouterr().err


def test_cuda_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1", "--log-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# --data-dir: the trainer on shards, against train.py's
# ---------------------------------------------------------------------------

ROOT = CONFIGS.parent
DF, STEPS3 = 6, (1000, 750, 500)


def _jax_train_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("train")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two latent shards (3 and 2 clips of 6 frames) and an ODE shard (3
    trajectories over a 3-step list), as the data path writes them."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    (root / "lat").mkdir()
    for i, n in enumerate((3, 2)):
        np.savez(root / "lat" / f"shard_{i:05d}.npz",
                 latents=f32(n, DF, C, H, W), prompt_embeds=f32(n, 16, 64),
                 prompts=np.asarray([f"p{i}{j}" for j in range(n)],
                                    dtype=object))
    from mmpl_tpu_torch.data.ode_gen import write_ode_shard
    write_ode_shard(str(root / "ode" / "ode_00000.npz"),
                    f32(3, len(STEPS3) + 1, DF, C, H, W), ["a", "b", "c"],
                    f32(3, 16, 64))
    return root


@pytest.fixture
def head_weights(monkeypatch):
    """Both trainers start from one JAX init with a random head (a zero
    head makes every loss vacuous); returns its numpy tree."""
    tree = jax.tree.map(np.asarray, randomize_head(jdit.init_dit_params(
        jax.random.PRNGKey(0), j_tiny(), jnp.float32)))
    monkeypatch.setattr(jdit, "init_dit_params", lambda *a, **k:
                        jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(tdit, "init_dit_params", lambda cfg, *a, **k:
                        port_model(tree, cfg))
    return tree


def _spy_batches(monkeypatch):
    """The batches the JAX trainer's iterator yields and the port trainer's
    `_DataBatches` hands to its step."""
    from mmpl_tpu.data import datasets as jds
    seen = {"jax": [], "port": []}
    real_it, real_next = jds.batch_iterator, ttrain._DataBatches.next

    def j_it(*a, **kw):
        for b in real_it(*a, **kw):
            seen["jax"].append(b)
            yield b

    monkeypatch.setattr(jds, "batch_iterator", j_it)
    monkeypatch.setattr(ttrain._DataBatches, "next", lambda self: (
        seen["port"].append(real_next(self)) or seen["port"][-1]))
    return seen


def _first_loss(root, run):
    return json.loads((root / run / "metrics.jsonl").read_text()
                      .splitlines()[0])["loss"]


@pytest.mark.parametrize("objective", ["teacher_forcing", "flow"])
def test_data_dir_step_matches_jax(objective, shards, head_weights,
                                   monkeypatch, tmp_path):
    """`--data-dir` on latent shards, one step in each trainer (both trunks
    fp32): the port's batch equals the JAX trainer's, the first losses
    agree within 1e-5, and the loss and gradients of the fp32 loss on the
    two batches within the file's tolerances."""
    jtrain, seen = _jax_train_module(), _spy_batches(monkeypatch)
    tf = objective == "teacher_forcing"
    name = "make_teacher_forcing_loss_fn" if tf else "make_loss_fn"
    monkeypatch.setattr(jdiff, name, functools.partial(
        getattr(jdiff, name), compute_dtype=jnp.float32))
    monkeypatch.setattr(tdiff, name, functools.partial(
        getattr(tdiff, name), compute_dtype=torch.float32))
    shape = (1, DF, C, H, W)
    # the JAX trainer's step-0 loss key at --seed 3
    _, sub = jax.random.split(jax.random.PRNGKey(4))
    draws = jax_draws(sub, shape=shape) if tf else _flow_draws(sub, shape)
    monkeypatch.setattr(tdiff, "draw_teacher_forcing" if tf else "draw_flow",
                        lambda *a, **kw: dict(draws))
    base = ["--smoke", "--objective", objective, "--steps", "1",
            "--num-frames", str(DF), "--seed", "3", "--data-dir",
            str(shards / "lat"), "--log-dir", str(tmp_path)]
    assert jtrain.main(base + ["--run-name", "jax"]) == 0
    assert ttrain.main(base + ["--run-name", "port", "--device",
                               "cpu"]) == 0
    jb, tb = seen["jax"][0], seen["port"][0]
    np.testing.assert_array_equal(tb["latents"].numpy(), jb["latents"])
    np.testing.assert_array_equal(tb["prompt_embeds"].numpy(),
                                  jb["prompt_embeds"])
    np.testing.assert_allclose(_first_loss(tmp_path, "port"),
                               _first_loss(tmp_path, "jax"), rtol=1e-5)

    cfg = tiny_test_config()
    ctx = jnp.asarray(jb["prompt_embeds"])
    jbatch = {"latents": jnp.asarray(jb["latents"]), "context": ctx,
              "uncond_context": jnp.zeros_like(ctx)}
    sch = scheduler()
    jloss = (jdiff.make_teacher_forcing_loss_fn(
        cfg, sch, jmasks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:DF]),
        noise_aug_max_timestep=100) if tf else jdiff.make_loss_fn(cfg, sch))
    loss_w, grads_w = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, head_weights), jbatch, sub)
    tsch = tdiff.make_scheduler(8.0)
    tloss = (tdiff.make_teacher_forcing_loss_fn(
        cfg, tsch, jmasks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:DF]),
        noise_aug_max_timestep=100) if tf else tdiff.make_loss_fn(cfg, tsch))
    model = port_model(head_weights, cfg).requires_grad_(True)
    loss_g = tloss(model, {"latents": tb["latents"],
                           "context": tb["prompt_embeds"],
                           "uncond_context": torch.zeros_like(
                               tb["prompt_embeds"])}, draws)
    loss_g.backward()
    np.testing.assert_allclose(loss_g.item(), float(loss_w), rtol=1e-5)
    _grads_close(model, grads_w, cfg, atol=1e-4)


def test_ode_data_dir_step_matches_jax(shards, head_weights, monkeypatch,
                                       tmp_path):
    """`--objective ode --data-dir` on a trajectory shard: the port's batch
    equals the JAX trainer's, the first losses agree within 1e-5 (both
    fp32), and the loss and gradients of the trainer's ODE step on the two
    batches (the text K/V outside the gradient, as both trainers compute
    it) within the file's tolerances."""
    jtrain, seen = _jax_train_module(), _spy_batches(monkeypatch)
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    r1, _ = jax.random.split(sub)
    idx = tt(jax.random.randint(r1, (1, DF // 3), 0, len(STEPS3))).long()
    monkeypatch.setattr(ttrain, "loss_draws",
                        lambda g, step, role: {"generator": g, "idx": idx})
    base = ["--smoke", "--objective", "ode", "--steps", "1", "--num-frames",
            str(DF), "--denoising-step-list", "1000,750,500", "--data-dir",
            str(shards / "ode"), "--log-dir", str(tmp_path)]
    assert jtrain.main(base + ["--run-name", "jax"]) == 0
    assert ttrain.main(base + ["--run-name", "port", "--device",
                               "cpu"]) == 0
    jb, tb = seen["jax"][0], seen["port"][0]
    np.testing.assert_array_equal(tb["ode_latent"].numpy(),
                                  jb["ode_latent"])
    np.testing.assert_array_equal(tb["prompt_embeds"].numpy(),
                                  jb["prompt_embeds"])
    assert np.isfinite(_first_loss(tmp_path, "port"))
    np.testing.assert_allclose(_first_loss(tmp_path, "port"),
                               _first_loss(tmp_path, "jax"), rtol=1e-5)

    from mmpl_tpu.training import distillation as jdist
    from mmpl_tpu_torch.training import distillation as tdist
    cfg, sch = tiny_test_config(), scheduler()
    jp = jax.tree.map(jnp.asarray, head_weights)
    ode, ctx = jnp.asarray(jb["ode_latent"]), jnp.asarray(jb["prompt_embeds"])
    noisy, ts = jdist.prepare_ode_generator_input(ode, STEPS3, r1)
    jbatch = {"noisy_input": noisy, "clean_latent": ode[:, -1],
              "timestep": ts, "ctx_kv": jdit.precompute_context_kv(
                  jp, cfg, jdit.embed_text(jp, ctx))}
    (loss_w, _), grads_w = jax.value_and_grad(
        lambda p: jdist.ode_regression_loss(p, cfg, sch, jbatch,
                                            jax.random.PRNGKey(0)),
        has_aux=True)(jp)
    model = port_model(head_weights, cfg)
    tnoisy, tts = tdist.prepare_ode_generator_input(tb["ode_latent"], STEPS3,
                                                    idx)
    tbatch = {"noisy_input": tnoisy, "clean_latent": tb["ode_latent"][:, -1],
              "timestep": tts, "ctx_kv": ttrain._context_kv(
                  model, cfg, tb["prompt_embeds"])}
    loss_g, _ = tdist.ode_regression_loss(model.requires_grad_(True), cfg,
                                          tdiff.make_scheduler(8.0), tbatch)
    loss_g.backward()
    np.testing.assert_allclose(loss_g.item(), float(loss_w), rtol=1e-5)
    # the text K/V's parameters (text embedding, cross-attention k, v and
    # k-norm) are outside the step's gradient in both trainers
    _grads_close(model, grads_w, cfg, atol=1e-4, untouched=(
        "text_embedding.", *(f"blocks.{i}.cross_attn.{p}"
                             for i in range(cfg.num_layers)
                             for p in ("k.", "v.", "norm_k."))))


def _state(path):
    return torch.load(path / "train_state.pt", weights_only=True)


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("objective,data", [("teacher_forcing", "lat"),
                                            ("ode", "ode")])
def test_resumed_data_dir_run_equals_the_unbroken_one(objective, data,
                                                      shards, tmp_path):
    """Three steps over shards of 5 clips at batch 2 (a pass is 2 batches,
    so step 2 starts the second shuffle) unbroken, and resumed from step
    1: the step-3 state, the data position included, bit for bit."""
    base = ["--smoke", "--device", "cpu", "--objective", objective,
            "--steps", "3", "--batch-size", "2", "--num-frames", str(DF),
            "--denoising-step-list", "1000,750,500", "--data-dir",
            str(shards / data), "--ckpt-every", "1", "--log-dir",
            str(tmp_path)]
    assert ttrain.main(base + ["--run-name", "a", "--ckpt-dir",
                               str(tmp_path / "a")]) == 0
    assert ttrain.main(base + ["--run-name", "b", "--ckpt-dir",
                               str(tmp_path / "b"), "--resume",
                               str(tmp_path / "a" / "step1")]) == 0
    want = _state(tmp_path / "a" / "step3")
    assert want["data"] == 3 and _state(tmp_path / "a" / "step1")["data"] \
        == 1
    _equal(_state(tmp_path / "b" / "step3"), want)
    logs = [json.loads(x) for x in (tmp_path / "b" / "metrics.jsonl")
            .read_text().splitlines()]
    assert all(r["load_s"] >= 0 for r in logs if "loss" in r)


def test_data_dir_shape_and_content_checks(shards, capsys, tmp_path):
    """A shard of other latent frames exits naming both counts; ODE
    shards without prompt_embeds exit naming them; the distillation
    objectives exit (2) naming --data-dir."""
    base = ["--smoke", "--device", "cpu", "--steps", "1", "--log-dir",
            str(tmp_path)]
    with pytest.raises(SystemExit, match="latent frame count is 6; "
                                         "--num-frames gives 9"):
        ttrain.main(base + ["--num-frames", "9", "--data-dir",
                            str(shards / "lat")])
    from mmpl_tpu_torch.data.ode_gen import write_ode_shard
    write_ode_shard(str(tmp_path / "bare" / "o.npz"),
                    np.zeros((1, 4, DF, C, H, W), np.float32), ["x"])
    with pytest.raises(SystemExit, match="prompt_embeds"):
        ttrain.main(base + ["--objective", "ode", "--num-frames", str(DF),
                            "--denoising-step-list", "1000,750,500",
                            "--data-dir", str(tmp_path / "bare")])
    with pytest.raises(SystemExit) as e:
        ttrain.main(base + ["--objective", "dmd", "--data-dir",
                            str(shards / "lat")])
    assert e.value.code == 2
    assert "--data-dir with --objective dmd" in capsys.readouterr().err
