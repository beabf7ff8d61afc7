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
    (["--checkpoint-path", "x.pt"], "Slice A item 10"),
    (["--image", "x.png"], "Slice D"),
    (["--wan-dir", "wan"], "Slice A item 10"),
    (["--taehv-path", "taew2_1.pth"], "Slice C"),
    (["--mesh", "dp=2"], "Slice F"),
    (["--preview", "p.mp4"], "Slice C"),
    (["--profile"], "Slice C"),
])
def test_cli_refuses_flags_of_later_slices(flag, where, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--model", "smoke", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert where in capsys.readouterr().err


def test_cli_refuses_few_step_config(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--model", "smoke", "--device", "cpu", "--config",
                  str(ROOT / "configs" / "self_forcing_dmd.yaml")])
    assert "Slice C" in capsys.readouterr().err


def test_cli_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model", "smoke", "--device", "cuda"])
