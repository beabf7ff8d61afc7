"""Port parity: whole-window latents of the planned-window pipeline, and the
port's CLI on the CPU."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.models import dit as jdit
from mmpl_tpu.pipelines.fps_inference import \
    CausalFPSInferencePipeline as JPipe
from mmpl_tpu_torch import cli
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.pipelines.fps_inference import \
    CausalFPSInferencePipeline as TPipe
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, C, H, W = 1, 16, 4, 4
STEPS = 2
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pipes():
    cfg = j_tiny()
    p = jdit.init_dit_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    p["head"]["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(99), p["head"]["head"]["kernel"].shape)
    jpipe = JPipe(cfg, p, sampling_steps=STEPS, timestep_shift=8.0,
                  guidance_scale=5.0, dtype=jnp.float32)
    tcfg = tiny_test_config()
    model = tdit.empty_dit(tcfg, fused=False, dtype=torch.float32)
    model.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, p),
                                             tcfg))
    tpipe = TPipe(tcfg, model, sampling_steps=STEPS, timestep_shift=8.0,
                  guidance_scale=5.0, dtype=torch.float32)
    return jpipe, tpipe


def _jax_reseed_noise(rng, plan, n_init):
    """Replay the JAX pipeline's key chain: one split per denoised group,
    then split(sub, R) draws for that group's reseeds."""
    out, consumed = {}, 0
    for gi, g in enumerate(plan.groups):
        if n_init > 0 and consumed < n_init:
            consumed += g.num_frames
            continue
        rng, sub = jax.random.split(rng)
        if g.reseed:
            keys = jax.random.split(sub, len(g.reseed))
            out[gi] = torch.from_numpy(np.concatenate(
                [np.asarray(jax.random.normal(k, (B, 1, C, H, W),
                                              jnp.float32)) for k in keys],
                axis=1))
    return out


@pytest.mark.parametrize("with_initial_latent", [False, True])
def test_window_latents_match(pipes, with_initial_latent):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(int(with_initial_latent))
    noise = rng.standard_normal((B, 21, C, H, W)).astype(np.float32)
    cond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    uncond = rng.standard_normal((B, 16, 64)).astype(np.float32)
    init = rng.standard_normal((B, 2, C, H, W)).astype(np.float32) \
        if with_initial_latent else None
    key = jax.random.PRNGKey(7)
    anchors_j, anchors_t = [], []
    want = np.asarray(jpipe.inference(
        jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(uncond),
        initial_latent=None if init is None else jnp.asarray(init), rng=key,
        on_anchor=lambda a: anchors_j.append(np.asarray(a))))
    got = tpipe.inference(
        torch.from_numpy(noise), torch.from_numpy(cond),
        torch.from_numpy(uncond),
        initial_latent=None if init is None else torch.from_numpy(init),
        reseed_noise=_jax_reseed_noise(key, tpipe.plan,
                                       0 if init is None else 2),
        on_anchor=lambda a: anchors_t.append(a.numpy())).numpy()
    assert got.shape == want.shape == (B, 21, C, H, W)
    assert np.abs(want - noise).mean() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert len(anchors_t) == len(anchors_j) == 1
    np.testing.assert_allclose(anchors_t[0], anchors_j[0], atol=1e-3)
    if init is not None:
        np.testing.assert_array_equal(got[:, :2], init)


def test_reseed_noise_comes_from_the_generator(pipes):
    _, tpipe = pipes
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, 21, C, H, W), (B, 16, 64), (B, 16, 64))]
    a = tpipe.inference(*args, generator=torch.Generator().manual_seed(5))
    b = tpipe.inference(*args, generator=torch.Generator().manual_seed(5))
    c = tpipe.inference(*args, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    # group 0/1 frames do not depend on the reseed noise; fill frames do
    torch.testing.assert_close(a[:, :4], c[:, :4], atol=0, rtol=0)
    assert (a[:, 4:10] - c[:, 4:10]).abs().max() > 1e-4


def test_cli_cpu_run_writes_bridged_frames(monkeypatch, tmp_path):
    written = {}

    def fake_write(path, frames, fps=16):
        written["frames"] = frames
        return path

    monkeypatch.setattr("mmpl_tpu_torch.utils.video_io.write_video",
                        fake_write)
    rc = cli.main(["--model", "smoke", "--duration", "2", "--sampling-steps",
                   "1", "--device", "cpu", "--output",
                   str(tmp_path / "out.mp4")])
    assert rc == 0
    frames = written["frames"]
    assert frames.shape == (81 + 76 * (2 - 1), 64, 64, 3)
    assert frames.dtype == np.uint8
    assert frames.max() > frames.min()


@pytest.mark.parametrize("flag,where", [
    (["--checkpoint-path", "x.pt"], None),
    (["--image", "x.png"], None),
    (["--wan-dir", "wan"], None),
    (["--mesh", "dp=2"], "Slice F"),
    (["--use-ema"], None),
    (["--model", "i2v-14B"], "Queue 3"),
])
def test_cli_refuses_flags_of_later_slices(flag, where, capsys):
    """Flags of later slices exit 2 naming their ROADMAP slice, and
    `--model i2v-14B` its known difference (ROADMAP Queue 3); the flags
    that earlier slices ported (checkpoints, EMA, the i2v image) parse."""
    if where is None:
        args = cli.parse_args(["--model", "smoke", "--device", "cpu", *flag])
        dest = flag[0][2:].replace("-", "_")
        assert getattr(args, dest) == (flag[1] if len(flag) > 1 else True)
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["--model", "smoke", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert where in capsys.readouterr().err


FEW_STEP = ["--config", str(ROOT / "configs" / "self_forcing_dmd.yaml")]


@pytest.mark.parametrize("case", ["taehv_path", "preview", "profile"])
def test_cli_slice_c_flags(case, tmp_path, monkeypatch, capsys):
    """The flags of the few-step slice: --preview writes the TAEHV preview
    of every block (here from a `taew2_1.pth`-style state dict given by
    --taehv-path), and without a few-step config exits 2 as the JAX CLI
    does; --profile on the planned-window pipeline times each window's
    phases."""
    written = {}

    def fake_write(path, frames, fps=16):
        written[path] = frames
        return path

    monkeypatch.setattr("mmpl_tpu_torch.utils.video_io.write_video",
                        fake_write)
    out, prev = str(tmp_path / "out.mp4"), str(tmp_path / "prev.mp4")
    base = ["--model", "smoke", "--device", "cpu", "--output", out]
    if case == "taehv_path":
        from mmpl_tpu_torch.models.taehv import init_taehv_params
        weights = tmp_path / "taew2_1.pth"
        torch.save(init_taehv_params(torch.Generator().manual_seed(3))
                   .state_dict(), weights)
        rc = cli.main(base + FEW_STEP + ["--preview", prev, "--taehv-path",
                                         str(weights)])
        assert rc == 0
        # 7 blocks of 3 latents: 9 frames, then 12 per block
        assert written[prev].shape == (9 + 6 * 12, 64, 64, 3)
        assert written[prev].dtype == np.uint8
        assert written[out].shape == (81, 64, 64, 3)
        assert "random TAEHV weights" not in capsys.readouterr().err
    elif case == "preview":
        assert cli.main(base + ["--preview", prev]) == 2
        assert "requires the few-step pipeline" in capsys.readouterr().err
        assert not written
    else:
        rc = cli.main(base + ["--sampling-steps", "1", "--profile"])
        assert rc == 0
        err = capsys.readouterr().err
        assert "window 0: denoise" in err and "window 0: vae decode" in err
        assert written[out].shape == (81, 64, 64, 3)


@pytest.mark.parametrize("config,pipeline", [
    ("self_forcing_dmd.yaml", "CausalInferencePipeline"),
    ("default_config.yaml", "CausalFPSInferencePipeline")])
def test_cli_selects_the_pipeline_by_the_config(config, pipeline,
                                                monkeypatch):
    """A config with denoising_step_list selects the few-step pipeline with
    the config's blocks, context noise and warped steps; one without, the
    planned-window pipeline."""
    seen = {}

    def fake_run_windows(pipe, *args, **kwargs):
        seen["pipe"] = pipe
        return np.zeros((1, 81, 64, 64, 3), np.uint8)

    monkeypatch.setattr(cli, "run_windows", fake_run_windows)
    monkeypatch.setattr("mmpl_tpu_torch.utils.video_io.write_video",
                        lambda path, frames, fps=16: path)
    assert cli.main(["--model", "smoke", "--device", "cpu", "--config",
                     str(ROOT / "configs" / config)]) == 0
    pipe = seen["pipe"]
    assert type(pipe).__name__ == pipeline
    if pipeline == "CausalInferencePipeline":
        assert pipe.num_frame_per_block == 3 and pipe.context_noise == 0
        assert pipe.denoising_step_list[0] == 1000.0
        assert 750.0 < pipe.denoising_step_list[1] < 1000.0   # warped
        assert pipe.dtype == torch.float32


def test_cli_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model", "smoke", "--device", "cuda"])
