"""Training checkpoints, resume, export and run configs of the port's trainer
(mmpl_tpu_torch.train, mmpl_tpu_torch.utils.train_state_io) on the CPU,
against the JAX package where it has a counterpart: the `.pt` export key
for key against `mmpl_tpu`'s `export_generator_pt`, `--config` against
`train.py`'s `apply_run_config`, and the AdamW state carried over from
optax.  Tolerances: 0 (bit for bit) for the resume, the export and its
loads; 1e-6 abs for one AdamW update after the optax state is carried
over (the same fp32 arithmetic in another order)."""

import importlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.utils import checkpoint as jck
from mmpl_tpu.utils.train_state_io import \
    export_generator_pt as j_export_generator_pt
from mmpl_tpu_torch import train as ttrain
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils import train_state_io as tsio
from mmpl_tpu_torch.utils.jax_params import (dit_state_from_jax,
                                             train_state_from_jax)
from test_torch_dit import jax_params_np, port_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_train_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("train")


def _losses(log_dir, run):
    lines = (log_dir / run / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, lines)
            if "loss" in r}


def _assert_same(a, b, where=""):
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
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


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    """Two steps unbroken; one step, a checkpoint, and a second step in a
    new trainer resumed from it: the second loss and the whole state after
    it (masters, AdamW state, EMA, generators) equal, bit for bit."""
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every",
            "1", "--log-dir", str(tmp_path)]
    assert ttrain.main(base + ["--run-name", "unbroken", "--ckpt-dir",
                               str(tmp_path / "u")]) == 0
    step1 = tmp_path / "u" / "step1"
    assert sorted(p.name for p in step1.iterdir()) == [tsio.STATE_FILE]
    assert ttrain.main(base + ["--run-name", "resumed", "--ckpt-dir",
                               str(tmp_path / "r"), "--resume",
                               str(step1)]) == 0
    assert not (tmp_path / "r" / "step1").exists()
    unbroken = _losses(tmp_path, "unbroken")
    resumed = _losses(tmp_path, "resumed")
    assert list(resumed) == [1] and resumed[1] == unbroken[1]
    want = tsio.restore_checkpoint(str(tmp_path / "u" / "step2"))
    got = tsio.restore_checkpoint(str(tmp_path / "r" / "step2"))
    assert got["step"] == 2
    _assert_same(got, want)


def test_checkpoint_io_is_atomic_and_checks_the_template(tmp_path):
    model = port_model(jax_params_np(j_tiny()), tiny_test_config())
    state = {"model": model.state_dict(), "step": 3}
    path = str(tmp_path / "step3")
    nbytes = tsio.save_checkpoint(path, state)
    assert sorted(p.name for p in (tmp_path / "step3").iterdir()) == [
        tsio.STATE_FILE]
    assert nbytes == (tmp_path / "step3" / tsio.STATE_FILE).stat().st_size
    _assert_same(tsio.restore_checkpoint(path, state), state)
    bad = dict(state["model"])
    bad["head.head.weight"] = bad["head.head.weight"][:1]
    with pytest.raises(ValueError, match="head.head.weight"):
        tsio.restore_checkpoint(path, {"model": bad, "step": 0})
    with pytest.raises(KeyError, match="ema"):
        tsio.restore_checkpoint(path, {**state, "ema": {}})


def test_export_equals_the_jax_export_and_loads_in_both(tmp_path):
    cfg = tiny_test_config()
    tree = jax_params_np(j_tiny(), seed=1)
    ema_tree = jax_params_np(j_tiny(), seed=2)
    model = port_model(tree, cfg)
    ema = dit_state_from_jax(ema_tree, cfg)
    p_t, p_j = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    tsio.export_generator_pt(p_t, model, ema, cfg)
    j_export_generator_pt(p_j, jax.tree.map(jnp.asarray, tree),
                          jax.tree.map(jnp.asarray, ema_tree), j_tiny())
    got = torch.load(p_t, weights_only=True)
    _assert_same(got, torch.load(p_j, weights_only=True))
    for use_ema, want in ((False, tree), (True, ema_tree)):
        want_sd = dit_state_from_jax(want, cfg)
        _assert_same(tck.load_mmpl_generator(p_t, cfg, use_ema).state_dict(),
                     want_sd)
        _assert_same(dit_state_from_jax(jax.tree.map(
            np.asarray, jck.load_mmpl_generator(p_t, j_tiny(), use_ema)),
            cfg), want_sd)
    with pytest.raises(NotImplementedError, match="i2v"):
        tsio.export_generator_pt(str(tmp_path / "i2v.pt"), model, None,
                                 tiny_test_config("i2v"))


def test_train_cli_exports_what_it_trained(tmp_path):
    """`--export-pt` writes the final masters and EMA: they load back
    through the port's loader as the last checkpoint holds them."""
    pt = str(tmp_path / "out.pt")
    assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                        "--log-dir", str(tmp_path), "--run-name", "x",
                        "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every",
                        "1", "--export-pt", pt]) == 0
    st = tsio.restore_checkpoint(str(tmp_path / "c" / "step1"))
    cfg = tiny_test_config()
    _assert_same(tck.load_mmpl_generator(pt, cfg).state_dict(), st["model"])
    _assert_same(tck.load_mmpl_generator(pt, cfg, use_ema=True).state_dict(),
                 st["ema"])


#: the port trainer's flags that `--config` may set
PORT_FLAGS = ("objective", "timestep_shift", "lr", "seed", "batch_size",
              "ema_decay", "num_frame_per_block", "generator_ckpt",
              "num_frames")


@pytest.mark.parametrize("extra", [[], ["--lr", "3e-4", "--seed=7"]])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_config_reads_as_the_jax_trainer_does(path, extra, capsys):
    jtrain = _jax_train_module()
    argv = ["--config", str(path)] + extra
    want = jtrain.apply_run_config(jtrain.parse_args(argv), argv)
    if want.objective in ttrain.LATER_OBJECTIVES:
        with pytest.raises(SystemExit):
            ttrain.parse_args(argv)
        err = capsys.readouterr().err
        assert f"--objective {want.objective} (from --config)" in err
        assert ttrain.LATER_OBJECTIVES[want.objective] in err
        return
    got = ttrain.parse_args(argv)
    for name in PORT_FLAGS:
        assert getattr(got, name) == getattr(want, name), name


def test_adamw_state_carried_from_optax_takes_the_same_step():
    """`train_state_from_jax`: an optax AdamW state (count 3, random
    moments) becomes the port's AdamW state; one update from the same
    gradients then gives the same masters."""
    cfg = tiny_test_config()
    rng = np.random.default_rng(4)
    tree = jax_params_np(j_tiny(), seed=3)
    rnd = lambda a, s: (s * rng.standard_normal(np.shape(a))).astype(
        np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    st = tx.init(params)
    adam = st[0]._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda a: jnp.asarray(rnd(a, 0.01)), params),
        nu=jax.tree.map(lambda a: jnp.asarray(np.abs(rnd(a, 1e-4))),
                        params))
    st = (adam,) + tuple(st[1:])
    grads = jax.tree.map(lambda a: rnd(a, 0.05), tree)
    upd, _ = tx.update(jax.tree.map(jnp.asarray, grads), st, params)
    want = dit_state_from_jax(jax.tree.map(
        np.asarray, optax.apply_updates(params, upd)), cfg)

    model = port_model(tree, cfg).requires_grad_(True)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.01)
    ckpt = train_state_from_jax(tree, st, tree, 3, cfg, opt, model)
    assert ckpt["step"] == 3
    opt.load_state_dict(ckpt["optimizer"])
    g = dit_state_from_jax(grads, cfg)
    for n, p in model.named_parameters():
        p.grad = g[n]
    opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)
