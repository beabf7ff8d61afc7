"""The port trainer's distillation and ODE branches (`mmpl_tpu_torch.train`)
against `train.py` at `--smoke --device cpu`.

One step of `dmd`, `sid`, `causvid`, `gan` and `ode` (the critic's and the
generator's first losses, `--dfake-gen-update-ratio 1`) and of
`--config configs/self_forcing_dmd.yaml` in both trainers, on the JAX
trainer's weights (random heads in both), step-0 inputs and draws:
losses within 1e-5.  A resumed distillation run equals an unbroken one bit
for bit (models, both AdamW states, EMA, generators, the rollout-length
generator); `--export-pt` loads back."""

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
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.schedulers.flow_match import FlowMatchScheduler as JFM
from mmpl_tpu.training import gan as jgan
from mmpl_tpu.training import self_forcing as jsf
from mmpl_tpu_torch import train as ttrain
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.training import gan as tgan
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils.jax_params import (dit_state_from_jax,
                                             gan_head_state_from_jax)
from test_torch_distill_draws import (_few_torch_threads,  # noqa: F401
                                      distill_draws, t)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F = 3


def _jax_train_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("train")


@pytest.fixture
def shared_weights(monkeypatch):
    """Both trainers' random inits from the same JAX trees: the JAX
    `init_dit_params` gets a random head (a zero head makes every score
    vacuous), and the port's init of seed s loads the JAX init of
    PRNGKey(s) (the JAX trainer's keys: generator 0, fake 10, real 11,
    GAN head 12)."""
    real_init = jdit.init_dit_params

    def j_init(key, cfg, dtype=jnp.float32):
        p = real_init(key, cfg, dtype)
        p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
            jax.random.fold_in(key, 99), p["head"]["head"]["kernel"].shape)
        return p

    def t_init(cfg, generator, dtype=torch.float32, device="cpu"):
        tree = j_init(jax.random.PRNGKey(generator.initial_seed()), j_tiny())
        m = tdit.empty_dit(cfg, fused=False, dtype=torch.float32)
        m.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, tree),
                                             cfg))
        return m

    def t_head(generator, atten_dim, ffn_dim, device="cpu", **_):
        tree = jgan.init_gan_head_params(
            jax.random.PRNGKey(generator.initial_seed()),
            atten_dim=atten_dim, ffn_dim=ffn_dim, num_heads=4)
        h = tgan.GanHead(atten_dim, ffn_dim=ffn_dim)
        h.load_state_dict(gan_head_state_from_jax(
            jax.tree.map(np.asarray, tree)))
        return h

    monkeypatch.setattr(jdit, "init_dit_params", j_init)
    monkeypatch.setattr(tdit, "init_dit_params", t_init)
    monkeypatch.setattr(tgan, "init_gan_head_params", t_head)


def _metrics(root, run):
    lines = (root / run / "metrics.jsonl").read_text().splitlines()
    return [json.loads(ln) for ln in lines]


def _jax_step0(args, nfpb=3):
    """The JAX distillation loop's step-0 inputs (the rollout's length
    drawn when --num-training-frames exceeds --num-frames) and the draws
    of the critic's and the generator's losses (both from key k3)."""
    cfg = j_tiny()
    objective, steps = args.objective, ttrain._step_list(args)
    max_F = args.num_training_frames or F
    F_roll = jsf.sample_num_frames(np.random.default_rng(2), F, max_F,
                                   nfpb) if max_F > F else F
    _, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(1), 5)
    ctx = jax.random.normal(k1, (1, cfg.text_len, cfg.text_dim))
    batch = {"context": t(ctx), "uncond_context": torch.zeros_like(t(ctx)),
             "noise": t(jax.random.normal(k2, (1, F_roll, 16, 4, 4)))}
    if objective == "gan":
        batch["real_latents"] = t(jax.random.normal(k4, (1, F, 16, 4, 4)))
    js = JFM(shift=args.timestep_shift, sigma_min=0.0, extra_one_step=True)
    js.set_timesteps(1000, training=True)
    jro = jsf.SelfForcingRollout(cfg, js, steps)
    kinds = {"gan": ("gan_critic", "gan_gen"), "sid": ("critic", "sid")}
    ck, gk = kinds.get(objective, ("critic", "dmd"))
    shape = (1, F, 16, 4, 4)
    sizes = [nfpb] * (F_roll // nfpb)
    draws = {"critic": distill_draws(k3, jro, sizes, len(steps), shape,
                                     kind=ck),
             "generator": distill_draws(k3, jro, sizes, len(steps), shape,
                                        kind=gk)}
    return batch, draws


@pytest.mark.parametrize("objective,extra", [
    ("dmd", []), ("sid", []), ("causvid", ["--fake-guidance-scale", "2.0"]),
    ("gan", []),
    ("config_dmd", ["--config", str(ROOT / "configs" /
                                    "self_forcing_dmd.yaml")]),
])
def test_first_losses_match_jax(objective, extra, shared_weights,
                                monkeypatch, tmp_path):
    obj = [] if objective == "config_dmd" else ["--objective", objective]
    base = ["--smoke", "--steps", "1", "--num-frames", str(F),
            "--log-dir", str(tmp_path)] + obj + extra
    if objective != "config_dmd":
        base += ["--dfake-gen-update-ratio", "1"]
    jtrain = _jax_train_module()
    assert jtrain.main(base + ["--run-name", "jax"]) == 0
    args = ttrain.parse_args(base)
    batch, draws = _jax_step0(args)
    monkeypatch.setattr(ttrain, "distill_batch",
                        lambda *a, **kw: dict(batch))
    monkeypatch.setattr(ttrain, "loss_draws",
                        lambda g, step, role: dict(draws[role]))
    assert ttrain.main(base + ["--run-name", "port", "--device",
                               "cpu"]) == 0
    want, got = _metrics(tmp_path, "jax")[0], _metrics(tmp_path, "port")[0]
    keys = ["critic_loss"] + (["gen_loss"]
                              if objective != "config_dmd" else [])
    assert [k for k in ("critic_loss", "gen_loss") if k in got] == keys
    for k in keys:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_ode_first_loss_matches_jax(shared_weights, monkeypatch, tmp_path):
    base = ["--smoke", "--steps", "1", "--objective", "ode", "--num-frames",
            "6", "--denoising-step-list", "1000,750,500",
            "--log-dir", str(tmp_path)]
    jtrain = _jax_train_module()
    assert jtrain.main(base + ["--run-name", "jax"]) == 0
    cfg = j_tiny()
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))
    traj = t(jax.random.normal(k1, (1, 4, 6, 16, 4, 4)))
    ctx = t(jax.random.normal(k2, (1, cfg.text_len, cfg.text_dim)))
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    r1, _ = jax.random.split(sub)
    idx = t(jax.random.randint(r1, (1, 2), 0, 3))
    monkeypatch.setattr(ttrain, "ode_batch", lambda *a: (traj, ctx))
    monkeypatch.setattr(ttrain, "loss_draws",
                        lambda g, step, role: {"generator": g, "idx": idx})
    assert ttrain.main(base + ["--run-name", "port", "--device",
                               "cpu"]) == 0
    np.testing.assert_allclose(_metrics(tmp_path, "port")[0]["loss"],
                               _metrics(tmp_path, "jax")[0]["loss"],
                               rtol=1e-5)


def _state(path):
    return torch.load(path / "train_state.pt", weights_only=True)


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("objective", ["dmd", "gan", "ode"])
def test_resumed_distillation_equals_an_unbroken_one(objective, tmp_path):
    """Two steps unbroken (rollout lengths drawn in [3, 6], the last
    window sliced); one step, a checkpoint, and the second step resumed:
    the second step's losses and the whole state after it equal, bit for
    bit.  The export writes the generator and its EMA."""
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every",
            "1", "--objective", objective, "--log-dir", str(tmp_path)]
    if objective != "ode":
        base += ["--num-frames", "3", "--num-training-frames", "6",
                 "--dfake-gen-update-ratio", "1"]
    else:
        base += ["--num-frames", "3"]
    assert ttrain.main(base + ["--ckpt-dir", str(tmp_path / "a"),
                               "--run-name", "a", "--export-pt",
                               str(tmp_path / "a.pt")]) == 0
    assert ttrain.main(base[:4] + ["1"] + base[5:] + [
        "--ckpt-dir", str(tmp_path / "b"), "--run-name", "b1"]) == 0
    assert ttrain.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                               "--run-name", "b2", "--resume",
                               str(tmp_path / "b" / "step1")]) == 0
    key = "loss" if objective == "ode" else "critic_loss"
    a = [r for r in _metrics(tmp_path, "a") if key in r]
    b = [r for r in _metrics(tmp_path, "b2") if key in r]
    assert a[1][key] == b[0][key] and a[1].get("gen_loss") == b[0].get(
        "gen_loss")
    _assert_same(_state(tmp_path / "a" / "step2"),
                 _state(tmp_path / "b" / "step2"))
    st = _state(tmp_path / "a" / "step2")
    cfg = tiny_test_config()
    gen = tck.load_mmpl_generator(str(tmp_path / "a.pt"), cfg)
    _assert_same(gen.state_dict(), st["models"]["generator"])
    ema = tck.load_mmpl_generator(str(tmp_path / "a.pt"), cfg, use_ema=True)
    _assert_same(ema.state_dict(), st["models"]["generator"]
                 if objective == "ode" else st["ema"])
