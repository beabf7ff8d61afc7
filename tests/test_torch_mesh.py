"""Port parity over real process groups: `mmpl_tpu_torch/parallel/mesh.py`
and the sequence-parallel moves of `parallel/collectives.py` on gloo,
across processes spawned by `torch.multiprocessing`.

The ranks (`test_torch_mesh_worker.py`) import only torch and the port;
their inputs and outputs go through `.npz` files in `tmp_path`, and the
JAX references run here, in the parent.  Every spawn is joined with its
own time limit and fails when it runs out (pytest-timeout is not among
the test requirements); each rank runs torch on one thread.  `init_distributed`
is held on its argument, COORDINATOR_ADDRESS and torchrun paths, the
ring and Ulysses on real `rotate` / `all_to_all`, against the JAX
package's attention and `dit_forward`."""

import copy
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.ops.attention import dense_attention
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.parallel import mesh as tmesh

import test_torch_mesh_worker as worker
from test_torch_dit import jax_params_np, port_model
from test_torch_distill_draws import few_threads

#: seconds a group of ranks may take, start-up included (the 2-rank
#: group's CLI window took ~85 s beside five other test workers)
SPAWN_LIMIT = 300


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = few_threads()
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, world, env, cases, inputs):
    np.savez(tmp_path / "inputs.npz", **inputs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, str(tmp_path), env, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {SPAWN_LIMIT} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = {r: (tmp_path / f"rank{r}.err").read_text()
              for r in range(world) if (tmp_path / f"rank{r}.err").exists()}
    assert not errors, errors
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _attention_reference(q, k, v):
    """JAX's dense attention and its grads under loss sum(out^2)."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    out = dense_attention(*args)
    grads = jax.grad(lambda *a: jnp.sum(dense_attention(*a) ** 2),
                     argnums=(0, 1, 2))(*args)
    return [np.asarray(x) for x in (out, *grads)]


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(shape).astype(np.float32) for n in "qkv"}


def test_ring_over_two_gloo_ranks(tmp_path):
    """The flash and the dense ring over a 2-rank gloo ring, forward and
    grads, against JAX's attention over the whole sequence; the ranks
    meet through torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
    RANK.  The serving CLI's --mesh tp=2 on them equals the CLI on one
    process."""
    inp = _qkv(0, (2, 32, 2, 16))
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": _free_port(),
           "WORLD_SIZE": 2, "RANK": "{rank}"}
    outs = _spawn(tmp_path, 2, env, ["ring", "cli_mesh"], inp)
    # the serving CLI's --mesh tp=2 against the CLI on one process
    from mmpl_tpu_torch import cli
    assert cli.main(["--model", "smoke", "--device", "cpu",
                     "--sampling-steps", "1", "--save-latents",
                     str(tmp_path / "cli.npy"), "--output",
                     str(tmp_path / "cli.mp4")]) == 0
    np.testing.assert_allclose(np.load(tmp_path / "cli_mesh.npy"),
                               np.load(tmp_path / "cli.npy"), atol=5e-4)
    want = _attention_reference(inp["q"], inp["k"], inp["v"])
    for out in outs:
        for impl in ("flash", "dense"):
            np.testing.assert_allclose(out[f"ring_{impl}"], want[0],
                                       atol=1e-5)
            for n, w in zip("qkv", want[1:]):
                np.testing.assert_allclose(out[f"ring_{impl}_d{n}"], w,
                                           atol=1e-4, err_msg=f"{impl} d{n}")


def test_usp_over_four_gloo_ranks(tmp_path):
    """sp = 2 x ring = 2 over 4 gloo ranks (COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID): Ulysses with the ring, forward and grads,
    against JAX's attention; usp_dit_forward against JAX's dit_forward;
    make_mesh's default fold and make_stage_meshes' split."""
    cfg_j = copy.deepcopy(j_tiny())
    cfg_j.num_heads = 2
    cfg_t = tiny_test_config()
    cfg_t.num_heads = 2
    tree = jax_params_np(cfg_j, seed=3)
    model = port_model(tree, cfg_t)
    rng = np.random.default_rng(4)
    inp = {**_qkv(1, (1, 32, 4, 16)),
           "lat": rng.standard_normal((1, 4, 16, 8, 8)).astype(np.float32),
           "t": np.asarray([700.0], np.float32),
           "ctx": rng.standard_normal((1, 16, 64)).astype(np.float32),
           "num_heads": np.asarray(2),
           **{f"dit.{k}": v.numpy() for k, v in model.state_dict().items()}}
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "NUM_PROCESSES": 4, "PROCESS_ID": "{rank}"}
    outs = _spawn(tmp_path, 4, env, ["ulysses", "usp", "meshes"], inp)
    want = _attention_reference(inp["q"], inp["k"], inp["v"])
    flow = np.asarray(jdit.dit_forward(
        jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(inp["lat"]),
        jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"])))
    for out in outs:
        np.testing.assert_allclose(out["usp_attn"], want[0], atol=1e-5)
        for n, w in zip("qkv", want[1:]):
            np.testing.assert_allclose(out[f"usp_attn_d{n}"], w, atol=1e-4,
                                       err_msg=f"d{n}")
        np.testing.assert_allclose(out["usp"], flow, atol=1e-5)
        assert list(out["default_names"]) == ["dp", "fsdp", "tp"]
        assert list(out["default_shape"]) == [1, 4, 1]
        np.testing.assert_array_equal(out["stage_ranks"],
                                      [[0, 1], [2, 3]])


def test_sharded_window_over_four_gloo_ranks(tmp_path):
    """The FPS window with the model sharded over (dp 1, fsdp 2, tp 2) and
    over (dp 2, tp 2) on 4 gloo ranks equals the single-device window
    (`tests/test_sharded_pipeline.py:45`), from the JAX key chain's
    reseed draws; the single-device window equals JAX's.  The few-step
    pipeline's rolling run over (dp 2, tp 2) equals its single-device run
    (`tests/test_sharded_pipeline.py:656`)."""
    from mmpl_tpu.pipelines.fps_inference import \
        CausalFPSInferencePipeline as JPipe
    from mmpl_tpu_torch.pipelines.fps_inference import \
        CausalFPSInferencePipeline as TPipe
    from test_torch_pipeline import _jax_reseed_noise
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    tree = jax_params_np(cfg_j, seed=5)
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((1, 21, 16, 4, 4)).astype(np.float32)
    cond, uncond = (rng.standard_normal((1, 16, 64)).astype(np.float32)
                    for _ in range(2))
    key = jax.random.PRNGKey(7)
    want = np.asarray(JPipe(cfg_j, jax.tree.map(jnp.asarray, tree),
                            sampling_steps=2, dtype=jnp.float32).inference(
        jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(uncond),
        rng=key))
    draws = _jax_reseed_noise(key, TPipe(cfg_t, port_model(tree, cfg_t),
                                         sampling_steps=2).plan, 0)
    anchors = []
    single = TPipe(cfg_t, port_model(tree, cfg_t), sampling_steps=2,
                   dtype=torch.float32).inference(
        torch.from_numpy(noise), torch.from_numpy(cond),
        torch.from_numpy(uncond), reseed_noise=draws,
        on_anchor=anchors.append).numpy()
    np.testing.assert_allclose(single, want, atol=1e-3)
    # the few-step pipeline, B = 2 over dp, 12 frames through a 6-slot
    # ring (`tests/test_sharded_pipeline.py:656`)
    from mmpl_tpu_torch.pipelines.causal_inference import \
        CausalInferencePipeline
    fs_noise = rng.standard_normal((2, 12, 16, 4, 4)).astype(np.float32)
    fs_cond = rng.standard_normal((2, 16, 64)).astype(np.float32)
    fewstep = CausalInferencePipeline(
        cfg_t, port_model(tree, cfg_t), denoising_step_list=(1000, 500),
        max_attention_frames=6, dtype=torch.float32).inference(
        torch.from_numpy(fs_noise), torch.from_numpy(fs_cond),
        generator=torch.Generator().manual_seed(7)).numpy()
    model = port_model(tree, cfg_t)
    inp = {"noise": noise, "cond": cond, "uncond": uncond,
           "fewstep_noise": fs_noise, "fewstep_cond": fs_cond,
           "num_heads": np.asarray(cfg_t.num_heads),
           **{f"rn_{gi}": v.numpy() for gi, v in draws.items()},
           **{f"dit.{k}": v.numpy() for k, v in model.state_dict().items()}}
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "NUM_PROCESSES": 4, "PROCESS_ID": "{rank}"}
    outs = _spawn(tmp_path, 4, env, ["sharded_window"], inp)
    for out in outs:
        assert out["fewstep_dp2_tp2"].shape == fewstep.shape == (2, 12, 16,
                                                                 4, 4)
        np.testing.assert_allclose(out["fewstep_dp2_tp2"], fewstep,
                                   atol=5e-4)
        for name in ("fsdp2_tp2", "dp2_tp2"):
            np.testing.assert_allclose(out[f"window_{name}"], single,
                                       atol=5e-4, err_msg=name)
            np.testing.assert_allclose(out[f"anchors_{name}"],
                                       anchors[0].numpy(), atol=5e-4,
                                       err_msg=name)


def test_sharded_training_over_four_gloo_ranks(tmp_path):
    """The trainer's --mesh (`tests/test_parallel.py:221`): the
    teacher-forcing loss and gradients over dp 2 x fsdp 2 (each dp rank
    on its row of a 2-row batch) and a DMD generator loss and gradients
    over fsdp 4 equal the single-process ones; the trainer's CLI runs one
    step of teacher forcing, DMD and the GAN objective over dp 2 x fsdp 2,
    rank 0 writing the metrics and the gathered `--export-pt`, which for
    teacher forcing equals one process's."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS
    from mmpl_tpu_torch.training import diffusion as tdiff
    from mmpl_tpu_torch.training import masks
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    tree = jax_params_np(cfg_j, seed=8)
    rng = np.random.default_rng(9)
    B, F = 2, 6
    draws = tdiff.draw_teacher_forcing(torch.Generator().manual_seed(10),
                                       (B, F, 16, 4, 4), 3, 1000, 100)
    ctx = rng.standard_normal((B, 16, 64)).astype(np.float32)
    inp = {"latents": rng.standard_normal((B, F, 16, 4, 4)).astype(
               np.float32), "context": ctx, "uncond_context": 0 * ctx,
           **{k: v.numpy() for k, v in draws.items()},
           "num_heads": np.asarray(cfg_t.num_heads),
           **{f"dit.{k}": v.numpy() for k, v in port_model(
               tree, cfg_t).state_dict().items()}}
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "NUM_PROCESSES": 4, "PROCESS_ID": "{rank}"}
    outs = _spawn(tmp_path, 4, env, ["train"], inp)

    model = port_model(tree, cfg_t).requires_grad_(True)
    loss_fn = tdiff.make_teacher_forcing_loss_fn(
        cfg_t, tdiff.make_scheduler(8.0),
        masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:F]),
        noise_aug_max_timestep=100, compute_dtype=torch.float32)
    batch = {k: torch.from_numpy(inp[k])
             for k in ("latents", "context", "uncond_context")}
    loss = loss_fn(model, batch, draws)
    loss.backward()
    tf = (float(loss.detach()), {n: p.grad.numpy()
                        for n, p in model.named_parameters()})

    args = train.parse_args(["--smoke", "--device", "cpu", "--batch-size",
                             "2", "--objective", "dmd", "--num-frames", "3"])
    models, _, gen_loss, _, _ = train.build_distillation(
        args, cfg_t, port_model(tree, cfg_t), torch.device("cpu"))
    models["generator"].requires_grad_(True)
    dbatch = train.distill_batch(torch.Generator().manual_seed(3),
                                 (2, 3, 16, 4, 4), cfg_t, torch.device("cpu"))
    dbatch["ctx_kv"] = train._context_kv(models["generator"], cfg_t,
                                         dbatch["context"])
    dloss, _ = gen_loss(models, dbatch,
                        {"generator": torch.Generator().manual_seed(4)})
    dloss.backward()
    dmd = (float(dloss.detach()), {n: p.grad.numpy() for n, p in
                          models["generator"].named_parameters()
                          if p.grad is not None})

    for out in outs:
        for tag, (want_loss, want) in (("tf", tf), ("dmd", dmd)):
            assert float(out[f"{tag}_loss"]) == pytest.approx(want_loss,
                                                             rel=1e-5)
            got = {k[len(tag) + 6:]: v for k, v in out.items()
                   if k.startswith(f"{tag}_grad.")}
            assert set(got) == set(want), tag
            scale = max(np.abs(g).max() for g in want.values())
            for n, g in want.items():
                np.testing.assert_allclose(got[n], g, atol=1e-5 * scale,
                                           err_msg=f"{tag} {n}")
    for objective in ("teacher_forcing", "dmd", "gan"):
        assert (tmp_path / "runs" / objective / "metrics.jsonl").exists()
    _assert_sharded_resume_exact(tmp_path, outs)
    # the sharded teacher-forcing step's export equals one process's (the
    # draws are split by rows, so it is the same step; one AdamW step
    # moves a weight by at most lr = 1e-5)
    argv = ["--smoke", "--device", "cpu", "--batch-size", "2", "--steps",
            "1", "--num-frames", "6", "--log-dir", str(tmp_path / "runs1"),
            "--export-pt", str(tmp_path / "single.pt")]
    assert train.main(argv) == 0
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    got, want = load(tmp_path / "teacher_forcing.pt"), \
        load(tmp_path / "single.pt")
    assert set(got) == set(want) == {"generator", "generator_ema"}
    for part in want:
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, atol=2e-5, rtol=0,
                                       msg=f"{part} {k}")


def _equal(a, b, where=""):
    """a == b bit for bit: nested dicts and lists of tensors, arrays and
    numbers."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _assert_resume_exact(tmp_path, mesh, world):
    """The worker's sharded checkpoints (`train_state_io.save_sharded`) on
    `world` ranks of the mesh shape `mesh`: teacher forcing's and DMD's
    step-2 state resumed from step 1 equals the unbroken run's bit for bit
    (masters, AdamW states, EMA, each rank's generators and step); each dp
    rank draws from its own stream, the tp ranks of a dp rank from the
    same one."""
    from mmpl_tpu_torch.utils import train_state_io as tsio
    tp = mesh.get("tp", 1)
    for objective in ("teacher_forcing", "dmd"):
        got, want = (tsio.sharded_to_state(str(
            tmp_path / "ckpt" / f"{objective}_{run}" / "step2"))
            for run in ("resumed", "unbroken"))
        assert len(want["ranks"]) == world
        assert all(r["mesh"] == mesh and r["step"] == 2
                   for r in want["ranks"])
        trained = ["generator"] if objective == "teacher_forcing" else [
            "generator", "fake_score"]
        if objective == "teacher_forcing":
            assert {"model", "optimizer", "ema"} <= set(want["tensors"])
        else:
            assert set(want["tensors"]["models"]) == set(trained)
            draws = [r["rng"]["draw"] for r in want["ranks"]]
            if mesh.get("dp", 1) > 1:
                assert not torch.equal(draws[0], draws[world // 2])
            if tp > 1:
                assert torch.equal(draws[0], draws[1])
        if tp > 1:
            # each tp rank's slices under their own keys
            assert any(k.endswith("@tp1")
                       for k in _flat_keys(want["tensors"]))
        _equal(got, want, objective)
        assert not (tmp_path / "ckpt" / f"{objective}_unbroken"
                    / "step2.tmp").exists()


def _flat_keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(f"{prefix}{k}")
        if isinstance(v, dict):
            out |= _flat_keys(v, f"{prefix}{k}.")
    return out


def _assert_sharded_resume_exact(tmp_path, outs):
    """`_assert_resume_exact` at dp 2 x fsdp 2; a restore onto another mesh
    exits naming both shapes."""
    _assert_resume_exact(tmp_path, {"dp": 2, "fsdp": 2}, 4)
    # DMD resumed with --offload-opt --remat-offload (HostAdamW over FSDP2
    # shards, the host EMA): the unbroken resident run's state, bit for bit
    from mmpl_tpu_torch.utils import train_state_io as tsio
    got, want = (tsio.sharded_to_state(str(tmp_path / "ckpt" / run / "step2"))
                 for run in ("dmd_offload", "dmd_unbroken"))
    _equal(got, want, "dmd_offload")
    for out in outs:
        msg = str(out["other_mesh_exit"])
        assert "{'dp': 2, 'fsdp': 2}" in msg and "{'dp': 1, 'fsdp': 4}" in msg


def test_generate_parallel_refuses_two_gloo_ranks(tmp_path):
    """generate_parallel's --coordinator / --num-processes / --process-id
    over 2 gloo ranks (one stage per process is ported; this test's name
    is kept): each rank exits 0 having run its stage's chunk, and the
    files are those one process writes, byte for byte."""
    from mmpl_tpu_torch import generate_parallel
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "NUM_PROCESSES": 2, "PROCESS_ID": "{rank}"}
    outs = _spawn(tmp_path, 2, env, ["generate_parallel"], {})
    assert [int(o["generate_parallel_rc"]) for o in outs] == [0, 0]
    n = torch.get_num_threads()
    torch.set_num_threads(1)            # as each rank runs
    try:
        assert generate_parallel.main(
            ["--device", "cpu", "--num-chunks", "2", "--sampling-steps",
             "1", "--output-dir", str(tmp_path / "one")]) == 0
    finally:
        torch.set_num_threads(n)
    got = sorted(p.name for p in (tmp_path / "videos").iterdir())
    want = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert got == want and len(want) == 2
    for name in want:
        a, b = (np.load(d / name) if name.endswith(".npy") else
                (d / name).read_bytes()
                for d in (tmp_path / "videos", tmp_path / "one"))
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) \
            else a == b, name


def test_init_distributed_argument_and_env_paths(monkeypatch):
    """A no-op without settings; otherwise the arguments, then the JAX
    package's variables, then torchrun's, reach init_process_group (gloo
    without a card); a partial setting is refused."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.init_distributed() is False
    calls = []
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    assert tmesh.init_distributed("host:1234", 8, 3) is True
    assert calls.pop() == ("gloo", {"init_method": "tcp://host:1234",
                                    "world_size": 8, "rank": 3})
    monkeypatch.setenv("COORDINATOR_ADDRESS", "envhost:99")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    assert tmesh.init_distributed() is True
    assert calls.pop() == ("gloo", {"init_method": "tcp://envhost:99",
                                    "world_size": 2, "rank": 1})
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("MASTER_ADDR", "master")
    monkeypatch.setenv("MASTER_PORT", "2345")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert tmesh.init_distributed() is True
    assert calls.pop() == ("gloo", {"init_method": "tcp://master:2345",
                                    "world_size": 4, "rank": 2})
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="process_id"):
        tmesh.init_distributed()
    assert not calls


def test_init_distributed_takes_a_backend(monkeypatch):
    """MMPL_DIST_BACKEND names the process group's backend (gloo for ranks
    that share a card, which NCCL refuses); unset, the card's NCCL or the
    CPU's gloo."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "MMPL_DIST_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    assert tmesh.init_distributed("h:1", 2, 0) is True
    monkeypatch.setenv("MMPL_DIST_BACKEND", "nccl")
    assert tmesh.init_distributed("h:1", 2, 0) is True
    monkeypatch.setenv("MMPL_DIST_BACKEND", "mpi")
    assert tmesh.init_distributed("h:1", 2, 0) is True
    assert calls == ["gloo", "nccl", "mpi"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh({"sp": 2})
