"""The process side of `test_torch_mesh.py`: one rank of a gloo group,
spawned by `torch.multiprocessing`.  It imports only torch and the port
(no JAX, no test module that imports JAX): inputs come from `inputs.npz`
in the work directory, results go to `rank<r>.npz`, a failure to
`rank<r>.err`.  It holds no test of its own."""

import os
import traceback

import numpy as np
import torch


def _case_ring(mesh, inp, out):
    """The ring (flash and dense) over `ring`: output and grads, gathered."""
    from mmpl_tpu_torch.parallel import sequence_parallel as tsp
    q, k, v = (torch.from_numpy(inp[n]) for n in "qkv")
    for impl in ("flash", "dense"):
        loc = [mesh.shard(x, 1, ("ring",)).clone().requires_grad_()
               for x in (q, k, v)]
        o = tsp.ring_attention(*loc, mesh.get_group("ring"), impl=impl)
        full = mesh.gather(o, 1, ("ring",))
        # every rank's loss is the same function of the gathered output
        torch.sum(full ** 2).backward()
        out[f"ring_{impl}"] = full.detach().numpy()
        for n, x in zip("qkv", loc):
            out[f"ring_{impl}_d{n}"] = mesh.gather(x.grad, 1,
                                                   ("ring",)).numpy()


def _case_ulysses(mesh, inp, out):
    """Ulysses over `sp` with the ring over `ring` (full USP attention)."""
    from mmpl_tpu_torch.parallel import sequence_parallel as tsp
    axes = ("sp", "ring")
    q, k, v = (torch.from_numpy(inp[n]) for n in "qkv")
    loc = [mesh.shard(x, 1, axes).clone().requires_grad_()
           for x in (q, k, v)]
    o = tsp.ulysses_attention(*loc, mesh.get_group("sp"),
                              mesh.get_group("ring"))
    full = mesh.gather(o, 1, axes)
    torch.sum(full ** 2).backward()
    out["usp_attn"] = full.detach().numpy()
    for n, x in zip("qkv", loc):
        out[f"usp_attn_d{n}"] = mesh.gather(x.grad, 1, axes).numpy()


def _tiny_model(inp):
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    cfg = tiny_test_config()
    cfg.num_heads = int(inp["num_heads"])
    model = dit.empty_dit(cfg, fused=False, dtype=torch.float32)
    model.load_state_dict({k[len("dit."):]: torch.from_numpy(v)
                           for k, v in inp.items() if k.startswith("dit.")})
    return cfg, model


def _case_usp(mesh, inp, out):
    """usp_dit_forward over sp x ring process groups."""
    from mmpl_tpu_torch.parallel import sequence_parallel as tsp
    cfg, model = _tiny_model(inp)
    with torch.no_grad():
        out["usp"] = tsp.usp_dit_forward(
            model, cfg, torch.from_numpy(inp["lat"]),
            torch.from_numpy(inp["t"]), torch.from_numpy(inp["ctx"]), mesh,
            ring_axis="ring").numpy()


def _case_sharded_window(inp, out):
    """A 2-step FPS window over (dp 1, fsdp 2, tp 2) and (dp 2, tp 2), and
    a few-step rolling run over (dp 2, tp 2)."""
    from mmpl_tpu_torch.parallel.mesh import make_mesh
    from mmpl_tpu_torch.pipelines.fps_inference import \
        CausalFPSInferencePipeline
    draws = {int(k[3:]): torch.from_numpy(v) for k, v in inp.items()
             if k.startswith("rn_")}
    for name, shape in (("fsdp2_tp2", {"dp": 1, "fsdp": 2, "tp": 2}),
                        ("dp2_tp2", {"dp": 2, "tp": 2})):
        cfg, model = _tiny_model(inp)
        pipe = CausalFPSInferencePipeline(cfg, model, sampling_steps=2,
                                          mesh=make_mesh(shape),
                                          dtype=torch.float32)
        anchors = []
        out[f"window_{name}"] = pipe.inference(
            torch.from_numpy(inp["noise"]), torch.from_numpy(inp["cond"]),
            torch.from_numpy(inp["uncond"]), reseed_noise=draws,
            on_anchor=lambda a: anchors.append(a)).numpy()
        out[f"anchors_{name}"] = anchors[0].numpy()
    # the few-step pipeline with the rolling ring, batch over dp
    from mmpl_tpu_torch.pipelines.causal_inference import \
        CausalInferencePipeline
    cfg, model = _tiny_model(inp)
    pipe = CausalInferencePipeline(cfg, model, denoising_step_list=(1000, 500),
                                   max_attention_frames=6,
                                   mesh=make_mesh({"dp": 2, "tp": 2}),
                                   dtype=torch.float32)
    out["fewstep_dp2_tp2"] = pipe.inference(
        torch.from_numpy(inp["fewstep_noise"]),
        torch.from_numpy(inp["fewstep_cond"]),
        generator=torch.Generator().manual_seed(7)).numpy()


def _case_cli_mesh(workdir):
    """The serving CLI's --mesh tp=2 in smoke mode: one 1-step window;
    rank 0 saves the latents."""
    from mmpl_tpu_torch import cli
    rc = cli.main(["--model", "smoke", "--device", "cpu", "--mesh",
                   "tp=2", "--sampling-steps", "1", "--save-latents",
                   os.path.join(workdir, "cli_mesh.npy"), "--output",
                   os.path.join(workdir, "cli_mesh.mp4")])
    assert rc == 0, rc


def _case_generate_parallel(workdir, out):
    """generate_parallel on a group of more than one process: refused
    (exit 2) before any model is built."""
    from mmpl_tpu_torch import generate_parallel
    out["generate_parallel_rc"] = np.asarray(generate_parallel.main(
        ["--device", "cpu", "--num-chunks", "1", "--output-dir",
         os.path.join(workdir, "videos")]))


def _full_grads(model) -> dict:
    return {n: p.grad.full_tensor().numpy()
            for n, p in model.named_parameters() if p.grad is not None}


def _case_train(workdir, inp, out):
    """The trainer's --mesh pieces (`train._Ranks`): the teacher-forcing
    loss and its gradients over dp 2 x fsdp 2, a DMD generator loss and
    its gradients over fsdp 4, each gathered; then the trainer's CLI with
    --mesh dp=2,fsdp=2 for teacher forcing, DMD and the GAN objective."""
    import torch.distributed as dist
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS
    from mmpl_tpu_torch.training import diffusion as tdiff
    from mmpl_tpu_torch.training import masks
    base = ["--smoke", "--device", "cpu", "--batch-size", "2"]
    ranks = train._Ranks(train.parse_args(base + ["--mesh", "dp=2,fsdp=2"]))
    cfg, model = _tiny_model(inp)
    F = inp["latents"].shape[1]
    loss_fn = tdiff.make_teacher_forcing_loss_fn(
        cfg, tdiff.make_scheduler(8.0),
        masks.fps_forcing_frame_mask(T2V_CLEAN_STEPS[:F]),
        noise_aug_max_timestep=100, compute_dtype=torch.float32)
    model = ranks.shard(model.requires_grad_(True))
    take = lambda keys: ranks.rows({k: torch.from_numpy(inp[k])
                                    for k in keys})
    batch = take(("latents", "context", "uncond_context"))
    draws = take(("idx", "noise", "idx_aug"))
    draws["coin"] = torch.from_numpy(inp["coin"])
    loss = model(loss_fn, batch, draws)
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total)
    out["tf_loss"] = (total / dist.get_world_size()).numpy()
    out.update({f"tf_grad.{n}": g for n, g in _full_grads(model).items()})

    args = train.parse_args(base + ["--objective", "dmd", "--num-frames",
                                    "3", "--mesh", "dp=1,fsdp=4"])
    ranks = train._Ranks(args)
    cfg, gen_model = _tiny_model(inp)
    models, _, gen_loss, _, _ = train.build_distillation(
        args, cfg, gen_model, torch.device("cpu"))
    models = {k: ranks.shard(m) for k, m in models.items()}
    for k, m in models.items():
        m.requires_grad_(k == "generator")
    batch = train.distill_batch(torch.Generator().manual_seed(3),
                                (2, 3, 16, 4, 4), cfg, torch.device("cpu"))
    batch["ctx_kv"] = ranks.in_forward([models["generator"]],
                                       train._context_kv,
                                       models["generator"], cfg,
                                       batch["context"])
    loss, _ = ranks.in_forward(
        list(models.values()), gen_loss, models, batch,
        {"generator": torch.Generator().manual_seed(4)})
    loss.backward()
    out["dmd_loss"] = loss.detach().numpy()
    out.update({f"dmd_grad.{n}": g
                for n, g in _full_grads(models["generator"]).items()})

    for objective in ("teacher_forcing", "dmd", "gan"):
        argv = base + ["--objective", objective, "--steps", "1",
                       "--num-frames", "6", "--dfake-gen-update-ratio", "1",
                       "--mesh", "dp=2,fsdp=2", "--log-dir",
                       os.path.join(workdir, "runs"), "--run-name",
                       objective, "--export-pt",
                       os.path.join(workdir, f"{objective}.pt")]
        assert train.main(argv) == 0, objective


def _case_meshes(out):
    """make_mesh's default fold and make_stage_meshes' split."""
    from mmpl_tpu_torch.parallel.mesh import make_mesh, make_stage_meshes
    m = make_mesh()
    out["default_names"] = np.asarray(m.mesh_dim_names)
    out["default_shape"] = np.asarray(m.mesh.shape)
    stages = make_stage_meshes(2, {"fsdp": 2})
    out["stage_ranks"] = np.stack([s.mesh.numpy() for s in stages])


def run(rank: int, world: int, workdir: str, env: dict, cases: list):
    torch.set_num_threads(1)
    try:
        os.environ.update({k: str(v).format(rank=rank)
                           for k, v in env.items()})
        import torch.distributed as dist
        from mmpl_tpu_torch.parallel.collectives import as_mesh
        from mmpl_tpu_torch.parallel.mesh import init_distributed, make_mesh
        assert init_distributed() is True
        assert dist.get_world_size() == world and dist.get_rank() == rank
        assert dist.get_backend() == "gloo"
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        for case in cases:
            if case == "ring":
                _case_ring(as_mesh(make_mesh({"ring": world})), inp, out)
            elif case == "ulysses":
                _case_ulysses(as_mesh(make_mesh({"sp": 2, "ring": 2})), inp,
                              out)
            elif case == "usp":
                _case_usp(make_mesh({"sp": 2, "ring": 2}), inp, out)
            elif case == "sharded_window":
                _case_sharded_window(inp, out)
            elif case == "cli_mesh":
                _case_cli_mesh(workdir)
            elif case == "train":
                _case_train(workdir, inp, out)
            elif case == "meshes":
                _case_meshes(out)
            elif case == "generate_parallel":
                _case_generate_parallel(workdir, out)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
