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


def _tiny_model(inp, prefix="dit."):
    from mmpl_tpu_torch.core.config import tiny_test_config
    from mmpl_tpu_torch.models import dit
    cfg = tiny_test_config()
    cfg.num_heads = int(inp["num_heads"])
    model = dit.empty_dit(cfg, fused=False, dtype=torch.float32)
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                           for k, v in inp.items() if k.startswith(prefix)})
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
    """generate_parallel on a group of 2 processes in smoke mode: a stage
    each, 2 chunks, each process writing its own chunk's file."""
    from mmpl_tpu_torch import generate_parallel
    out["generate_parallel_rc"] = np.asarray(generate_parallel.main(
        ["--device", "cpu", "--num-chunks", "2", "--sampling-steps", "1",
         "--output-dir", os.path.join(workdir, "videos")]))


def _draws(inp):
    return {int(k[3:]): torch.from_numpy(v) for k, v in inp.items()
            if k.startswith("rn_")}


def _case_int8_mesh(inp, out):
    """W8A8 with the int8 cache over (fsdp 2, tp 2) and (dp 2, tp 2), W8A16
    and `auto` with the int8 cache over (dp 2, tp 2): 2-step windows.
    Then, at (dp 2, tp 2), the unsharded window's own activations split
    over tp: fc2's input through a row-parallel W8A8 product (the summed
    int32 accumulators, the codes and scales, the output) and the commit's
    K tokens through the cache's codes, each split over the heads."""
    from mmpl_tpu_torch.ops import quant
    from mmpl_tpu_torch.parallel.collectives import as_mesh
    from mmpl_tpu_torch.parallel.mesh import make_mesh
    from mmpl_tpu_torch.pipelines.fps_inference import \
        CausalFPSInferencePipeline
    for name, shape, mode in (
            ("fsdp2_tp2_int8", {"dp": 1, "fsdp": 2, "tp": 2}, "int8"),
            ("dp2_tp2_int8", {"dp": 2, "tp": 2}, "int8"),
            ("dp2_tp2_int8wo", {"dp": 2, "tp": 2}, "int8wo"),
            ("dp2_tp2_auto", {"dp": 2, "tp": 2}, "auto")):
        cfg, model = _tiny_model(inp)
        pipe = CausalFPSInferencePipeline(
            cfg, model, sampling_steps=2, mesh=make_mesh(shape),
            quantize=mode, quantize_cache=True, dtype=torch.float32)
        out[f"window_{name}"] = pipe.inference(
            torch.from_numpy(inp["noise"]), torch.from_numpy(inp["cond"]),
            torch.from_numpy(inp["uncond"]),
            reseed_noise=_draws(inp)).numpy()
    mesh = as_mesh(make_mesh({"dp": 2, "tp": 2}))
    tp, r = mesh.get_group("tp"), mesh.coordinate("tp")
    x, w = torch.from_numpy(inp["fc2_x"]), torch.from_numpy(inp["fc2_w"])
    codes, scale = quant.quantize_weight(w)
    cols = lambda t: t.chunk(2, -1)[r].contiguous()
    xq, xs = quant.quantize_rows_split(cols(x), tp)
    acc = tp.all_reduce(quant.int8_gemm(xq, cols(codes), None, None,
                                        torch.int32))
    out.update(fc2_acc=acc.numpy(), fc2_xq=xq.numpy(), fc2_xs=xs.numpy(),
               fc2_y=quant.w8a8_matmul(cols(x), cols(codes), scale,
                                       group=tp).numpy())
    kq, ks = quant.quantize_rows_split(cols(torch.from_numpy(inp["k"])), tp)
    out.update(cache_codes=kq.numpy(), cache_scales=ks.numpy())


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

    # sharded checkpoints: two steps unbroken (saved after each), then the
    # second step again, resumed from the first one's checkpoint
    for objective in ("teacher_forcing", "dmd"):
        ckpt = lambda run: os.path.join(workdir, "ckpt", f"{objective}_{run}")
        argv = base + ["--objective", objective, "--steps", "2",
                       "--num-frames", "6", "--dfake-gen-update-ratio", "1",
                       "--mesh", "dp=2,fsdp=2", "--ckpt-every", "1",
                       "--log-dir", os.path.join(workdir, "runs_ckpt")]
        assert train.main(argv + ["--run-name", f"{objective}_unbroken",
                                  "--ckpt-dir", ckpt("unbroken")]) == 0
        assert train.main(argv + ["--run-name", f"{objective}_resumed",
                                  "--ckpt-dir", ckpt("resumed"), "--resume",
                                  os.path.join(ckpt("unbroken"), "step1")
                                  ]) == 0
    # DMD's second step resumed with the host-offload flags: the FSDP2
    # shards' moments and shadow on the host, the checkpoint the same
    assert train.main(argv + ["--run-name", "dmd_offload", "--offload-opt",
                              "--remat-offload", "--ckpt-dir",
                              ckpt("offload"), "--resume",
                              os.path.join(ckpt("unbroken"), "step1")]) == 0
    # a checkpoint restores onto a mesh of its own shape only
    try:
        train.main(argv + ["--mesh", "dp=1,fsdp=4", "--run-name", "other",
                           "--resume", os.path.join(ckpt("unbroken"),
                                                    "step1")])
    except SystemExit as e:
        out["other_mesh_exit"] = np.asarray(str(e))


def _tp_grads(ranks, model) -> dict:
    """Every parameter's whole gradient of a model sharded by `train._Ranks`
    (FSDP shards and tp slices gathered)."""
    return {n: g.numpy() for n, g in ranks.full(
        {n: p.grad for n, p in model.named_parameters()
         if p.grad is not None}).items()}


def _tf_step(mesh_spec, inp, out, tag):
    """The teacher-forcing loss and gradients over `mesh_spec`, each dp
    rank on its rows, gathered whole."""
    import torch.distributed as dist
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.core.geometry import T2V_CLEAN_STEPS
    from mmpl_tpu_torch.training import diffusion as tdiff
    from mmpl_tpu_torch.training import masks
    base = ["--smoke", "--device", "cpu", "--batch-size",
            str(inp["latents"].shape[0])]
    ranks = train._Ranks(train.parse_args(base + ["--mesh", mesh_spec]))
    cfg, model = _tiny_model(inp)
    cfg = ranks.layer_cfg(cfg)
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
    out[f"{tag}_loss"] = (total / dist.get_world_size()).numpy()
    out[f"{tag}_grad_norm"] = tdiff.grad_norm(model, ranks.tp_group).numpy()
    out.update({f"{tag}_grad.{n}": g
                for n, g in _tp_grads(ranks, model).items()})


def _case_tp_train(workdir, inp, out):
    """tp 2 on 2 ranks: the teacher-forcing loss and gradients, a DMD
    generator loss and gradients with the draws of `draws.pt`, then the
    trainer's CLI: teacher forcing and DMD for two steps saved after each,
    the second again resumed from the first's checkpoint, and the
    `--export-pt` of a teacher-forcing step."""
    from mmpl_tpu_torch import train
    from mmpl_tpu_torch.training import diffusion as tdiff
    from mmpl_tpu_torch.training import distillation as td
    from mmpl_tpu_torch.training.self_forcing import SelfForcingRollout
    _tf_step("tp=2", inp, out, "tf")
    # the DMD generator loss as tests/test_torch_distillation.py builds it
    ranks = train._Ranks(train.parse_args(["--smoke", "--device", "cpu",
                                           "--mesh", "tp=2"]))
    models = {k: _tiny_model(inp, f"{k}.")[1]
              for k in ("generator", "fake_score", "real_score")}
    cfg = ranks.layer_cfg(_tiny_model(inp)[0])
    models = {k: ranks.shard(m) for k, m in models.items()}
    sch = tdiff.make_scheduler(5.0)
    dist_ = td.Distiller(cfg, td.DistillationConfig(
        timestep_shift=5.0, real_guidance_scale=3.0),
        SelfForcingRollout(cfg, sch, (1000, 750, 500, 250)), sch)
    models["generator"].requires_grad_(True)
    saved = torch.load(os.path.join(workdir, "draws.pt"), weights_only=False)
    batch = {k: torch.from_numpy(inp[f"dmd_{k}"])
             for k in ("noise", "context", "uncond_context")}
    batch["ctx_kv"] = train._context_kv(models["generator"], cfg,
                                        batch["context"])
    loss, _ = dist_.dmd_generator_loss(models, batch, saved)
    loss.backward()
    out["dmd_loss"] = loss.detach().numpy()
    out.update({f"dmd_grad.{n}": g
                for n, g in _tp_grads(ranks, models["generator"]).items()})

    base = ["--smoke", "--device", "cpu", "--batch-size", "1",
            "--num-frames", "6", "--dfake-gen-update-ratio", "1",
            "--mesh", "tp=2", "--log-dir", os.path.join(workdir, "runs")]
    for objective in ("teacher_forcing", "dmd"):
        ckpt = lambda run: os.path.join(workdir, "ckpt", f"{objective}_{run}")
        argv = base + ["--objective", objective, "--steps", "2",
                       "--ckpt-every", "1"]
        assert train.main(argv + ["--run-name", f"{objective}_unbroken",
                                  "--ckpt-dir", ckpt("unbroken")]) == 0
        assert train.main(argv + ["--run-name", f"{objective}_resumed",
                                  "--ckpt-dir", ckpt("resumed"), "--resume",
                                  os.path.join(ckpt("unbroken"), "step1")
                                  ]) == 0
    assert train.main(base + ["--steps", "0", "--run-name", "export",
                              "--export-pt",
                              os.path.join(workdir, "tp2.pt")]) == 0


def _case_tp_mix_train(inp, out):
    """The teacher-forcing loss and gradients over dp 2 x tp 2 and over
    fsdp 2 x tp 2 (4 ranks)."""
    _tf_step("dp=2,tp=2", inp, out, "dp2_tp2")
    _tf_step("fsdp=2,tp=2", inp, out, "fsdp2_tp2")


def _case_stages(workdir, inp, out, tp):
    """`ChunkParallelPipeline(stage_meshes=...)`: 2 stages of the world's
    ranks (tp within a stage where each has 2), 3 chunks with the reseed
    draws of `draws.pt`; this process's chunks and its log."""
    import torch.distributed as dist
    from mmpl_tpu_torch.models import vae
    from mmpl_tpu_torch.parallel.chunk_pipeline import ChunkParallelPipeline
    from mmpl_tpu_torch.parallel.mesh import make_stage_meshes
    cfg, model = _tiny_model(inp)
    vm = vae.empty_vae(torch.float32)
    vm.load_state_dict({k[len("vae."):]: torch.from_numpy(v)
                        for k, v in inp.items() if k.startswith("vae.")})
    meshes = make_stage_meshes(2, {"tp": tp})
    pipe = ChunkParallelPipeline(cfg, model, vm, stage_meshes=meshes,
                                 sampling_steps=2, dtype=torch.float32)
    noises = [torch.from_numpy(inp[f"noise{i}"]) for i in range(3)]
    chunks = pipe.generate(noises, torch.from_numpy(inp["cond"]),
                           torch.from_numpy(inp["uncond"]),
                           reseed_noise=torch.load(
                               os.path.join(workdir, "draws.pt"),
                               weights_only=False))
    out[f"stages_tp{tp}_own"] = np.asarray(
        [i for i, c in enumerate(chunks) if c is not None])
    for i, c in enumerate(chunks):
        if c is not None:
            out[f"stages_tp{tp}_chunk{i}"] = c.numpy()
    out[f"stages_tp{tp}_log"] = np.asarray(
        [(e["chunk"], e["stage"]) for e in pipe.dispatch_log])
    out[f"stages_tp{tp}_rank"] = np.asarray(dist.get_rank())


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
            elif case == "int8_mesh":
                _case_int8_mesh(inp, out)
            elif case == "tp_train":
                _case_tp_train(workdir, inp, out)
            elif case == "tp_mix_train":
                _case_tp_mix_train(inp, out)
            elif case == "stages_tp1":
                _case_stages(workdir, inp, out, 1)
            elif case == "stages_tp2":
                _case_stages(workdir, inp, out, 2)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
