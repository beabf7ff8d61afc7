"""Port parity: the CLI's non-smoke path and the trainer's
`--generator-ckpt` on real files (mmpl_tpu_torch vs mmpl_tpu).

The files are synthetic, in the upstream layouts, written to `tmp_path`:
an MMPL generator `.pt` (`generator` / `generator_ema` under `model.`), a
Wan2.1 directory with `Wan2.1_VAE.pth`, a bf16 umT5 `.pth` and a
word-level tokenizer under `google/umt5-xxl`.  Both packages' model table
(`WAN_CONFIGS["t2v-1.3B"]`) and umT5 config are replaced by the tiny
ones; nothing is fetched."""

import importlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu import cli as jcli
from mmpl_tpu.core import config as jcfg
from mmpl_tpu.models import t5 as jt5
from mmpl_tpu.utils import checkpoint as jck
from mmpl_tpu_torch import cli
from mmpl_tpu_torch import train as ttrain
from mmpl_tpu_torch.core import config as tcfg
from mmpl_tpu_torch.models import dit as tdit
from mmpl_tpu_torch.models import t5 as tt5
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.training import diffusion as tdiff
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils.jax_params import dit_state_from_jax
from test_torch_i2v import (_capture_jax_inference, _no_video_writes, _png,
                            _record_port_inference)
from test_torch_tokenizer import save_word_tokenizer

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tier-1 runs several test workers at once on the CPU; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_with_t5(config):
    """The tiny DiT config of a package's config module, with the T2V
    configs' T5 file and tokenizer names (the tiny config has neither)."""
    base = config.T2V_1_3B
    return config.DotDict(config.tiny_test_config(),
                          t5_checkpoint=base.t5_checkpoint,
                          t5_tokenizer=base.t5_tokenizer)


def write_generator_pt(path, cfg, seed=0):
    """An MMPL `.pt` of the port's init (non-zero head) in bf16; the EMA
    differs from the generator in the head only."""
    g = torch.Generator().manual_seed(seed)
    model = tdit.randomize_head(
        tdit.init_dit_params(cfg, g, torch.float32), g)
    up = {k: v.to(torch.bfloat16)
          for k, v in tck.to_upstream(model.state_dict(), "dit").items()}
    ema = dict(up)
    for k in ("head.head.weight", "head.modulation"):
        ema[k] = (up[k].float() * 0.5).to(torch.bfloat16)
    torch.save({"generator": {f"model.{k}": v for k, v in up.items()},
                "generator_ema": {f"model.{k}": v for k, v in ema.items()}},
               path)
    return up, ema


def write_wan_dir(root, cfg, seed=1):
    """Wan2.1_VAE.pth (f32), the umT5 encoder in bf16 (TINY_T5) and the
    tokenizer, under the names the CLI reads."""
    root.mkdir(parents=True, exist_ok=True)
    vae_model = tvae.init_vae_params(torch.Generator().manual_seed(seed))
    torch.save(tck.to_upstream(vae_model.state_dict(), "vae"),
               root / cfg.vae_checkpoint)
    t5_model = tt5.init_t5_params(tt5.TINY_T5,
                                  torch.Generator().manual_seed(seed))
    torch.save({k: v.to(torch.bfloat16) for k, v in
                tck.to_upstream(t5_model.state_dict(), "t5").items()},
               root / cfg.t5_checkpoint)
    save_word_tokenizer(root / cfg.t5_tokenizer)
    return str(root)


@pytest.fixture
def tiny_tables(monkeypatch):
    """Both packages' `t2v-1.3B` and umT5 configs -> the tiny ones."""
    jtiny = _tiny_with_t5(jcfg)
    ttiny = _tiny_with_t5(tcfg)
    monkeypatch.setitem(jcfg.WAN_CONFIGS, "t2v-1.3B", jtiny)
    monkeypatch.setitem(tcfg.WAN_CONFIGS, "t2v-1.3B", ttiny)
    monkeypatch.setattr(jt5, "UMT5_XXL", jt5.TINY_T5)
    monkeypatch.setattr(tt5, "UMT5_XXL", tt5.TINY_T5)
    return ttiny


def _spy_generator_loads(monkeypatch, seen_j, seen_t):
    real_j, real_t = jck.load_mmpl_generator, tck.load_mmpl_generator

    def spy_j(*a, **kw):
        seen_j.append(jax.tree.map(np.asarray, real_j(*a, **kw)))
        return seen_j[-1]

    def spy_t(*a, **kw):
        model = real_t(*a, **kw)
        seen_t.append({k: v.clone() for k, v in model.state_dict().items()})
        return model
    monkeypatch.setattr(jck, "load_mmpl_generator", spy_j)
    monkeypatch.setattr(tck, "load_mmpl_generator", spy_t)


@pytest.mark.parametrize("case", ["ema_negative_image", "plain_t2v"])
def test_cli_real_files_match_jax(case, tiny_tables, monkeypatch, tmp_path):
    """The non-smoke path of both CLIs on the same files: the generator
    equals the JAX one cast to bf16 bit for bit (`--use-ema` takes the
    EMA), the cond / uncond states from `--prompt` and `--negative-prompt`
    (else Wan's default negative prompt) agree within 1e-5 (f32 T5), and
    `--image` hands window 0 the same latent within 1e-4 on the i2v
    plan.  The JAX windows are not run; the port's run (bf16, 1 step)
    writes its 81 frames."""
    cfg = tiny_tables
    up, ema = write_generator_pt(tmp_path / "mmpl.pt", cfg)
    wan = write_wan_dir(tmp_path / "Wan2.1-T2V-1.3B", cfg)
    argv = ["--model", "t2v-1.3B", "--checkpoint-path",
            str(tmp_path / "mmpl.pt"), "--wan-dir", wan, "--prompt",
            "a cat surfing a wave at sunset", "--height", "64", "--width",
            "64", "--sampling-steps", "1", "--duration", "1", "--output",
            str(tmp_path / "out.mp4")]
    image = case == "ema_negative_image"
    if image:
        argv += ["--use-ema", "--negative-prompt", "the lazy dog",
                 "--image", _png(tmp_path, 48, 96)]
    seen_j, seen_t, gen_j, gen_t, written = [], [], [], [], {}
    _capture_jax_inference(monkeypatch, seen_j)
    _record_port_inference(monkeypatch, seen_t)
    _spy_generator_loads(monkeypatch, gen_j, gen_t)
    _no_video_writes(monkeypatch, written)
    assert jcli.main(argv) == 0
    assert cli.main(argv + ["--device", "cpu"]) == 0

    want = dit_state_from_jax(gen_j[0], cfg)
    for k, v in gen_t[0].items():
        assert v.dtype == torch.bfloat16, k
        assert torch.equal(v, want[k].to(torch.bfloat16)), k
    src = ema if image else up
    assert torch.equal(gen_t[0]["head.head.weight"], src["head.head.weight"])
    j, t = seen_j[0], seen_t[0]
    assert t["dtype"] == torch.bfloat16
    assert j["plan"] == t["plan"] == ("i2v" if image else "t2v")
    for key in ("cond", "uncond"):
        assert t[key].shape == j[key].shape == (1, 512, 64)
        np.testing.assert_allclose(t[key], j[key], atol=1e-5, rtol=0)
    assert np.abs(t["cond"] - t["uncond"]).max() > 1e-2
    if image:
        assert t["initial_latent"].shape == (1, 1, 16, 8, 8)
        np.testing.assert_allclose(t["initial_latent"], j["initial_latent"],
                                   atol=1e-4)
    else:
        assert t["initial_latent"] is None is j["initial_latent"]
    frames = written[str(tmp_path / "out.mp4")]
    assert frames.shape == (81, 64, 64, 3) and frames.dtype == np.uint8


def test_cli_checkpoint_without_wan_dir_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["--checkpoint-path", "x.pt"])
    assert e.value.code == 2
    assert "--wan-dir" in capsys.readouterr().err


def _jax_train_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("train")


def _jax_first_batch(seed, cfg, lat_hw=(4, 4), F=21):
    """The JAX trainer's step-0 batch and loss key, replayed."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    k1, k2 = jax.random.split(k)
    latents = jax.random.normal(k1, (1, F, 16, *lat_hw))
    context = jax.random.normal(k2, (1, cfg.text_len, cfg.text_dim))
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 1))
    return latents, context, sub


def _jax_draws(rng, F=21, nfpb=3, aug_max=100, shape=(1, 21, 16, 4, 4)):
    """The draws of `make_teacher_forcing_loss_fn`'s key chain."""
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    nb = F // nfpb
    t = lambda a: torch.from_numpy(np.array(a))
    return {"idx": t(jax.random.randint(k1, (1, nb), 0, 1000)).long(),
            "noise": t(jax.random.normal(k2, shape, jnp.float32)),
            "idx_aug": t(jax.random.randint(k3, (1, nb), 0, aug_max)).long(),
            "coin": t(jax.random.uniform(k4, ()))}


@pytest.mark.parametrize("source", ["generator_ckpt", "wan_dir"])
def test_train_from_files_first_loss_matches_jax(source, monkeypatch,
                                                 tmp_path):
    """`train --smoke --generator-ckpt` (the MMPL `.pt`) or `--wan-dir` (a
    safetensors directory), one step each in both trainers on the JAX
    trainer's step-0 batch and draws: the first loss agrees within
    rtol 2e-3 (both trunks bf16 over fp32 masters; the fp32 trunk agrees
    within 1e-5 in tests/test_torch_training.py)."""
    from safetensors.torch import save_file
    cfg = tcfg.tiny_test_config()
    up, _ = write_generator_pt(tmp_path / "mmpl.pt", cfg, seed=3)
    if source == "generator_ckpt":
        flag = ["--generator-ckpt", str(tmp_path / "mmpl.pt")]
    else:
        (tmp_path / "wan").mkdir()
        save_file({k: v.contiguous() for k, v in up.items()},
                  str(tmp_path / "wan" / "diffusion_pytorch_model"
                      ".safetensors"))
        flag = ["--wan-dir", str(tmp_path / "wan")]
    jtrain = _jax_train_module()
    base = ["--smoke", "--steps", "1", "--log-dir", str(tmp_path)] + flag
    assert jtrain.main(base + ["--run-name", "jax"]) == 0

    latents, context, sub = _jax_first_batch(0, cfg)
    batch = {"latents": torch.from_numpy(np.array(latents)),
             "context": torch.from_numpy(np.array(context))}
    batch["uncond_context"] = torch.zeros_like(batch["context"])
    monkeypatch.setattr(ttrain, "synthetic_batch",
                        lambda *a, **kw: dict(batch))
    monkeypatch.setattr(tdiff, "draw_teacher_forcing",
                        lambda *a, **kw: _jax_draws(sub))
    loaded = []
    real = ttrain.load_generator
    monkeypatch.setattr(ttrain, "load_generator",
                        lambda *a: loaded.append(real(*a)) or loaded[-1])
    assert ttrain.main(base + ["--run-name", "port", "--device",
                               "cpu"]) == 0

    def loss(run):
        line = (tmp_path / run / "metrics.jsonl").read_text().splitlines()
        return json.loads(line[0])["loss"]
    assert np.isfinite(loss("port"))
    np.testing.assert_allclose(loss("port"), loss("jax"), rtol=2e-3)
    # the masters start as the file's bf16 values widened
    assert loaded[0].head.head.weight.dtype == torch.float32
    start = {k: v.float() for k, v in tck.convert_dit(up, cfg).items()}
    assert set(start) == {k for k, _ in loaded[0].named_parameters()}
