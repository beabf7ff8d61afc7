"""Host offload (`mmpl_tpu_torch/utils/memory.py`): the streamed AdamW, the
offloaded EMA, `offload_params` / `restore_params`, block inputs kept on
the host (`remat_offload`) and the trainer's `--offload-opt` /
`--remat-offload`, against the port's resident paths and the JAX
package's offloaded ones, on the CPU.

On the CPU every placement is a no-op and the streaming loops run as on
the card, so each offloaded path must equal the port's resident path bit
for bit.  Against the JAX package: the AdamW and the EMA within 1e-6 (the
port's AdamW against optax's, `test_torch_train_state.py`), the
teacher-forcing loss within rtol 1e-5 and its gradients within 1e-4
(`test_torch_training.py`), a 2-step DMD run's losses within 5e-5
(`tests/test_training.py`'s `--offload-opt` test)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.core.geometry import T2V_CLEAN_STEPS
from mmpl_tpu.schedulers.flow_match import FlowMatchScheduler as JFM
from mmpl_tpu.training import diffusion as jdiff
from mmpl_tpu.training import masks as jmasks
from mmpl_tpu.training import self_forcing as jsf
from mmpl_tpu.utils import memory as jmem
from mmpl_tpu.utils.ema import EmaParams as JEma
from mmpl_tpu_torch import train as ttrain
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.training import diffusion as tdiff
from mmpl_tpu_torch.utils import memory as tmem
from mmpl_tpu_torch.utils.ema import EmaParams
from test_torch_distill_draws import distill_draws, t
from test_torch_train_distill import (_assert_same, _jax_train_module,
                                      _metrics, _state,
                                      shared_weights)  # noqa: F401
from test_torch_training import (_few_torch_threads,  # noqa: F401
                                 _grads_close, jax_draws, port_model,
                                 scheduler, setup, tt)


def _tensors(seed, shapes=((4, 6), (3,), (2, 5))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _params(arrays):
    return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]


def _adamw_run(kind, arrays, steps=3, lr=3e-3, wd=1e-4):
    params = _params(arrays)
    opt = kind(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=wd)
    for step in range(steps):
        for p, g in zip(params, _tensors(10 + step, [a.shape
                                                     for a in arrays])):
            p.grad = torch.from_numpy(g)
        opt.step()
    return params, opt


def test_host_adamw_equals_the_resident_adamw():
    """Three steps: parameters, moments and `step` bit for bit, and the
    same state dict; each loads the other's state and takes the same next
    step."""
    arrays = _tensors(0)
    pa, resident = _adamw_run(torch.optim.AdamW, arrays)
    pb, host = _adamw_run(tmem.HostAdamW, arrays)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    _assert_same(resident.state_dict(), host.state_dict())
    assert host.host_bytes == 2 * sum(a.nbytes for a in arrays)
    # across the flag: the other optimizer's state, then one more step
    got = {}
    for src, kind in ((resident, tmem.HostAdamW), (host, torch.optim.AdamW)):
        params = [torch.nn.Parameter(p.detach().clone()) for p in pa]
        opt = kind(params, lr=3e-3, weight_decay=1e-4)
        opt.load_state_dict(src.state_dict())
        for p, g in zip(params, _tensors(20, [a.shape for a in arrays])):
            p.grad = torch.from_numpy(g)
        opt.step()
        got[kind] = params
    for a, b in zip(got[tmem.HostAdamW], got[torch.optim.AdamW]):
        assert torch.equal(a, b)


def test_host_adamw_matches_the_jax_host_adamw():
    arrays = _tensors(0)
    params, _ = _adamw_run(tmem.HostAdamW, arrays, lr=3e-3, wd=1e-4)
    tree = {str(i): jnp.asarray(a) for i, a in enumerate(arrays)}
    state = jmem.host_adamw_init(tree)
    for step in range(3):
        grads = {str(i): jnp.asarray(g) for i, g in enumerate(
            _tensors(10 + step, [a.shape for a in arrays]))}
        tree, state = jmem.host_adamw_update(tree, grads, state, 3e-3)
    for i, p in enumerate(params):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(tree[str(i)]), atol=1e-6,
                                   rtol=0)


def test_offloaded_ema_equals_the_resident_one_and_jax(setup):
    cfg, tree, _ = setup
    model = port_model(tree, cfg)
    jema = JEma(jax.tree.map(jnp.asarray, tree), decay=0.9, offload=True)
    resident = EmaParams(model, decay=0.9)
    host = EmaParams(model, decay=0.9, offload=True)
    assert host.host_bytes == sum(p.numel() * 4 for p in model.parameters())
    assert all(s.data_ptr() != p.data_ptr() for s, p in zip(
        host.shadow.values(), model.parameters()))
    rng = np.random.default_rng(3)
    for _ in range(2):
        tree = jax.tree.map(
            lambda a: a + rng.standard_normal(a.shape).astype(np.float32),
            tree)
        jema.update(jax.tree.map(jnp.asarray, tree))
        port = port_model(tree, cfg)
        resident.update(port)
        host.update(port)
    _assert_same(resident.shadow, host.shadow)
    from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax
    want = dit_state_from_jax(jax.tree.map(np.asarray, jema.shadow), cfg)
    for name, s in host.shadow.items():
        np.testing.assert_allclose(s.numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)
    # a saved shadow loads back into the host one
    other = EmaParams(model, decay=0.9, offload=True)
    other.load(resident.shadow)
    _assert_same(other.shadow, host.shadow)


def test_offload_restore_round_trip():
    """`test_aux.py`'s round trip: a dict and a module, bit for bit, new
    tensors (no storage shared with the input); the stats helpers."""
    params = {"w": torch.arange(8.0).reshape(2, 4), "b": torch.ones(4)}
    off = tmem.offload_params(params)
    assert all(off[k].data_ptr() != params[k].data_ptr() for k in params)
    back = tmem.restore_params(off)
    _assert_same(back, params)
    model = tdit.init_dit_params(tiny_test_config(),
                                 torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tmem.restore_params(tmem.offload_params(model)) is model
    _assert_same(model.state_dict(), before)
    assert not tmem.supports_host_compute_offload("cpu")
    assert tmem.hbm_bytes_in_use("cpu") is None
    assert tmem.free_hbm_gb("cpu") is None


@pytest.fixture
def packs(monkeypatch):
    """How many tensors `HostBoundaries` took, each of them non-empty."""
    seen = []
    real = tmem.HostBoundaries._pack

    def pack(self, x):
        seen.append(x.numel())
        return real(self, x)

    monkeypatch.setattr(tmem.HostBoundaries, "_pack", pack)
    return seen


def test_teacher_forcing_remat_offload(setup, packs):
    """At 6 frames (`tests/test_training.py`'s case): the loss and every
    gradient equal the plain path's bit for bit, with each block's input
    taken by the hooks, and match JAX's `remat_offload=True` loss and
    gradients as the plain path does."""
    cfg, tree, _ = setup
    shape = (1, 6, 16, 4, 4)
    fm = jmasks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:6])
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    batch = {"latents": rng.standard_normal(shape).astype(np.float32),
             "context": ctx, "uncond_context": np.zeros_like(ctx)}
    key = jax.random.PRNGKey(5)
    draws = jax_draws(key, shape=shape)
    tb = {k: tt(v) for k, v in batch.items()}
    out = {}
    for off in (False, True):
        loss_fn = tdiff.make_teacher_forcing_loss_fn(
            cfg, tdiff.make_scheduler(8.0), fm, num_frame_per_block=3,
            noise_aug_max_timestep=100, compute_dtype=torch.float32,
            remat_offload=off)
        model = port_model(tree, cfg).requires_grad_(True)
        loss = loss_fn(model, tb, draws)
        loss.backward()
        out[off] = (loss.detach(), model)
    assert sum(1 for n in packs if n) == cfg.num_layers
    assert torch.equal(out[False][0], out[True][0])
    for (n, a), b in zip(out[False][1].named_parameters(),
                         out[True][1].parameters()):
        assert torch.equal(a.grad, b.grad), n
    jloss = jdiff.make_teacher_forcing_loss_fn(
        cfg, scheduler(), fm, num_frame_per_block=3,
        noise_aug_max_timestep=100, compute_dtype=jnp.float32,
        remat_offload=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_w, grads_w = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, tree), jb, key)
    np.testing.assert_allclose(out[True][0].item(), float(loss_w),
                               rtol=1e-5)
    _grads_close(out[True][1], grads_w, cfg, atol=1e-4)


def _distill_grads(objective, rolling, offload):
    """The trainer's distillation bundle (`build_distillation`, random
    heads) and the gradients of its critic and generator losses."""
    argv = ["--smoke", "--objective", objective, "--num-frames", "6"]
    if rolling:
        argv += ["--num-training-frames", "9", "--rolling"]
    if offload:
        argv += ["--remat-offload"]
    args = ttrain.parse_args(argv)
    cfg = tiny_test_config()
    g = lambda s: torch.Generator().manual_seed(s)
    gen = tdit.randomize_head(tdit.init_dit_params(cfg, g(0)), g(1))
    models, dist, gen_loss, critic_loss, critic_keys = \
        ttrain.build_distillation(args, cfg, gen, torch.device("cpu"))
    for seed, m in enumerate(models.values()):
        if isinstance(m, tdit.WanDiT):
            tdit.randomize_head(m, g(20 + seed))
    F_roll = 9 if rolling else 6
    batch = ttrain.distill_batch(
        g(5), (1, F_roll, cfg.in_dim, 4, 4), cfg, "cpu",
        real_shape=(1, 6, cfg.in_dim, 4, 4) if objective == "gan" else None)
    batch["ctx_kv"] = ttrain._context_kv(gen, cfg, batch["context"])
    out = {}
    for role, keys, fn in (("critic", critic_keys, critic_loss),
                           ("generator", ("generator",), gen_loss)):
        for name, m in models.items():
            m.requires_grad_(name in keys)
            m.zero_grad(set_to_none=True)
        loss, _ = fn(models, batch, {"generator": g(7)})
        loss.backward()
        out[role] = (loss.detach(), {
            f"{k}.{n}": p.grad.clone() for k in keys
            for n, p in models[k].named_parameters() if p.grad is not None})
    return out


@pytest.mark.parametrize("objective,rolling", [
    ("dmd", False), ("dmd", True), ("gan", False)])
def test_distillation_remat_offload_grads(objective, rolling, packs):
    """The rollout's graded blocks and the scores (and the GAN critic's
    trunk) with their inputs taken by the hooks, under `rolling` too (which
    the JAX package demotes for a TPU compiler fault): the losses and the
    gradients equal the plain path's bit for bit."""
    plain = _distill_grads(objective, rolling, False)
    assert not packs
    off = _distill_grads(objective, rolling, True)
    assert sum(1 for n in packs if n) > 0
    for role in plain:
        assert torch.equal(plain[role][0], off[role][0]), role
        assert plain[role][1] and set(plain[role][1]) == set(off[role][1])
        for n, gr in plain[role][1].items():
            assert torch.equal(gr, off[role][1][n]), (role, n)


def _jax_steps(args, steps, F=3, nfpb=3):
    """The JAX distillation loop's inputs and its critic's and generator's
    draws for each of `steps` steps (`test_torch_train_distill.py`'s step
    0, followed along the key chain)."""
    cfg = j_tiny()
    js = JFM(shift=args.timestep_shift, sigma_min=0.0, extra_one_step=True)
    js.set_timesteps(1000, training=True)
    jro = jsf.SelfForcingRollout(cfg, js, ttrain._step_list(args))
    S = len(ttrain._step_list(args))
    shape = (1, F, 16, 4, 4)
    rng = jax.random.PRNGKey(1)
    out = []
    for _ in range(steps):
        rng, k1, k2, k3, _ = jax.random.split(rng, 5)
        ctx = jax.random.normal(k1, (1, cfg.text_len, cfg.text_dim))
        batch = {"context": t(ctx),
                 "uncond_context": torch.zeros_like(t(ctx)),
                 "noise": t(jax.random.normal(k2, shape))}
        draws = {role: distill_draws(k3, jro, [nfpb] * (F // nfpb), S, shape,
                                     kind=kind)
                 for role, kind in (("critic", "critic"),
                                    ("generator", "dmd"))}
        out.append((batch, draws))
    return out


def test_train_cli_offload_matches_plain_and_jax(shared_weights,
                                                 monkeypatch, tmp_path):
    """Two `--smoke` DMD steps through `train.main`: with `--offload-opt
    --remat-offload` the losses equal the plain run's and match `train.py`
    with the same flags within 5e-5."""
    flags = ["--offload-opt", "--remat-offload"]
    base = ["--smoke", "--steps", "2", "--objective", "dmd", "--num-frames",
            "3", "--dfake-gen-update-ratio", "1", "--log-dir", str(tmp_path)]
    assert _jax_train_module().main(base + flags + ["--run-name",
                                                    "jax"]) == 0
    steps = _jax_steps(ttrain.parse_args(base), 2)
    for run, extra in (("plain", []), ("offload", flags)):
        batches = iter([dict(b) for b, _ in steps])
        monkeypatch.setattr(ttrain, "distill_batch",
                            lambda *a, **kw: next(batches))
        monkeypatch.setattr(ttrain, "loss_draws", lambda g, step, role:
                            dict(steps[step][1][role]))
        assert ttrain.main(base + extra + ["--run-name", run, "--device",
                                           "cpu"]) == 0
    plain, off = _metrics(tmp_path, "plain"), _metrics(tmp_path, "offload")
    want = _metrics(tmp_path, "jax")
    assert len(plain) == len(off) == len(want) == 2
    for a, b, w in zip(plain, off, want):
        for k in ("critic_loss", "gen_loss"):
            assert a[k] == b[k], (k, a, b)
            assert abs(b[k] - w[k]) < 5e-5, (k, b, w)
    assert json.loads((tmp_path / "offload" / "config.json").read_text())[
        "offload_opt"] is True


@pytest.mark.parametrize("first,then", [(["--offload-opt"], []),
                                        ([], ["--offload-opt"])])
def test_resume_across_the_offload_flag(first, then, tmp_path):
    """One step with `first`'s flags and a checkpoint, the second step
    resumed with `then`'s: the second step's losses and the whole state
    after it equal an unbroken run's bit for bit, in the same format."""
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every",
            "1", "--objective", "dmd", "--num-frames", "3",
            "--dfake-gen-update-ratio", "1", "--log-dir", str(tmp_path)]
    assert ttrain.main(base + first + ["--ckpt-dir", str(tmp_path / "a"),
                                       "--run-name", "a"]) == 0
    one = base[:4] + ["1"] + base[5:]
    assert ttrain.main(one + first + ["--ckpt-dir", str(tmp_path / "b"),
                                      "--run-name", "b1"]) == 0
    assert ttrain.main(base + then + ["--ckpt-dir", str(tmp_path / "b"),
                                      "--run-name", "b2", "--resume",
                                      str(tmp_path / "b" / "step1")]) == 0
    a, b = _metrics(tmp_path, "a"), _metrics(tmp_path, "b2")
    a = [r for r in a if "critic_loss" in r]
    b = [r for r in b if "critic_loss" in r]
    assert (a[1]["critic_loss"], a[1]["gen_loss"]) == (b[0]["critic_loss"],
                                                       b[0]["gen_loss"])
    _assert_same(_state(tmp_path / "a" / "step2"),
                 _state(tmp_path / "b" / "step2"))
