"""Port parity: checkpoint ingestion (mmpl_tpu_torch.utils.checkpoint vs
mmpl_tpu.utils.checkpoint).  Synthetic state dicts in the upstream key
layouts (WanModel, WanVAE_, umT5) are written to `tmp_path`; each port
conversion must equal the JAX package's conversion bridged through
`utils.jax_params`, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from mmpl_tpu.core.config import tiny_test_config as j_tiny
from mmpl_tpu.utils import checkpoint as jck
from mmpl_tpu_torch.core.config import tiny_test_config
from mmpl_tpu_torch.models import t5 as tt5
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils.jax_params import (dit_state_from_jax,
                                             t5_state_from_jax,
                                             vae_state_from_jax)
from test_checkpoint import make_synthetic_dit_sd


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape")
                        else x, tree)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _assert_states_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _vae_upstream(seed=0):
    """A WanVAE_-layout state dict (upstream names and gamma shapes) of
    random weights, as numpy."""
    model = tvae.init_vae_params(torch.Generator().manual_seed(seed))
    up = tck.to_upstream(model.state_dict(), "vae")
    return {k: v.numpy() for k, v in up.items()}, model


def _t5_upstream(seed=0, dtype=torch.float32):
    model = tt5.init_t5_params(tt5.TINY_T5,
                               torch.Generator().manual_seed(seed))
    return {k: v.to(dtype) for k, v in
            tck.to_upstream(model.state_dict(), "t5").items()}, model


def test_safetensors_f32_and_others(tmp_path):
    from safetensors.numpy import save_file
    rng = np.random.default_rng(4)
    tensors = {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
               "b.bias": rng.standard_normal(7).astype(np.float16),
               "c.ids": rng.integers(-9, 9, (2, 5)).astype(np.int64)}
    p = str(tmp_path / "x.safetensors")
    save_file(tensors, p)
    got = tck._load_safetensors(p)
    want = jck._load_safetensors(p)
    for k in tensors:
        np.testing.assert_array_equal(got[k].numpy(), tensors[k])
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_safetensors_bf16_stays_bf16(tmp_path):
    """bf16 stays bf16 in the port; widened, it equals the JAX reader's
    f32 bit for bit."""
    from safetensors.torch import save_file
    t = torch.randn(5, 6, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    p = str(tmp_path / "bf16.safetensors")
    save_file({"w": t, "v": t[:2].float()}, p)
    got = tck._load_safetensors(p)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], t)
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  jck._load_safetensors(p)["w"])
    assert got["v"].dtype == torch.float32


@pytest.mark.parametrize("fmt", ["pth", "safetensors", "dir"])
def test_load_torch_state_dict_formats(tmp_path, fmt):
    from safetensors.torch import save_file
    sd = {"x.weight": torch.arange(6.0).reshape(2, 3),
          "y": torch.ones(4, dtype=torch.bfloat16)}
    if fmt == "pth":
        p = tmp_path / "m.pth"
        torch.save({"state_dict": dict(sd, step=3)}, p)
    elif fmt == "safetensors":
        p = tmp_path / "m.safetensors"
        save_file(sd, str(p))
    else:
        p = tmp_path / "wan"
        p.mkdir()
        save_file({"x.weight": sd["x.weight"]},
                  str(p / "diffusion_pytorch_model-00001.safetensors"))
        save_file({"y": sd["y"]},
                  str(p / "diffusion_pytorch_model-00002.safetensors"))
    got = tck.load_torch_state_dict(str(p))
    want = jck.load_torch_state_dict(str(p))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k])


def test_strip_prefix():
    sd = {"model.a": 1, "b": 2, "xmodel.c": 3}
    assert tck.strip_prefix(sd, "model.") == jck.strip_prefix(sd, "model.")


def test_convert_dit_equals_the_bridged_jax_conversion():
    cfg = tiny_test_config()
    sd = make_synthetic_dit_sd(j_tiny())
    want = dit_state_from_jax(_np(jck.convert_dit(sd, j_tiny())), cfg)
    _assert_states_equal(tck.convert_dit(_torch_sd(sd), cfg), want)


def test_convert_dit_bf16_keeps_the_values():
    """A bf16 file loads into a bf16 generator with its own values (the
    JAX path widens to f32, then the CLI casts back to bf16)."""
    cfg = tiny_test_config()
    sd = {k: v.to(torch.bfloat16) for k, v in
          _torch_sd(make_synthetic_dit_sd(j_tiny())).items()}
    got = tck.convert_dit(sd, cfg, dtype=torch.bfloat16)
    widened = jck.convert_dit({k: v.float().numpy() for k, v in sd.items()},
                              j_tiny())
    want = dit_state_from_jax(_np(widened), cfg)
    for k in want:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], want[k].to(torch.bfloat16)), k


def test_convert_dit_refuses_i2v():
    """An i2v config takes the i2v leaves (tests/test_torch_i2v_dit.py
    converts a whole i2v file); a t2v file has none, and its conversion
    to an i2v DiT is refused, naming the first missing key."""
    cfg = tiny_test_config("i2v")
    sd = _torch_sd(make_synthetic_dit_sd(j_tiny("i2v")))
    with pytest.raises(KeyError, match="k_img"):
        tck.convert_dit(sd, cfg)


def test_convert_vae_equals_the_bridged_jax_conversion():
    up, model = _vae_upstream()
    assert up["encoder.middle.1.norm.gamma"].shape == (384, 1, 1)
    assert up["decoder.head.0.gamma"].shape == (96, 1, 1, 1)
    want = vae_state_from_jax(_np(jck.convert_vae(up)))
    got = tck.convert_vae(_torch_sd(up))
    _assert_states_equal(got, want)
    _assert_states_equal(got, model.state_dict())


def test_convert_t5_equals_the_bridged_jax_conversion():
    up, model = _t5_upstream()
    want = t5_state_from_jax(_np(jck.convert_t5(
        {k: v.numpy() for k, v in up.items()}, tt5.TINY_T5)))
    got = tck.convert_t5(up, tt5.TINY_T5)
    _assert_states_equal(got, want)
    _assert_states_equal(got, model.state_dict())


def _write_monolith(path, sd):
    """The MMPL `.pt`: generator and generator_ema under `model.`; the
    EMA is the generator times 0.5."""
    torch.save({"generator": {f"model.{k}": v for k, v in sd.items()},
                "generator_ema": {f"model.{k}": v * 0.5
                                  for k, v in sd.items()},
                "step": 7}, path)


@pytest.mark.parametrize("use_ema", [False, True])
def test_mmpl_monolith(tmp_path, use_ema):
    cfg = tiny_test_config()
    sd = _torch_sd(make_synthetic_dit_sd(j_tiny(), seed=5))
    p = str(tmp_path / "t2v_tiny.pt")
    _write_monolith(p, sd)
    model = tck.load_mmpl_generator(p, cfg, use_ema=use_ema)
    want = dit_state_from_jax(
        _np(jck.load_mmpl_generator(p, j_tiny(), use_ema=use_ema)), cfg)
    _assert_states_equal(model.state_dict(), want)
    scale = 0.5 if use_ema else 1.0
    torch.testing.assert_close(model.head.head.weight,
                               sd["head.head.weight"] * scale, atol=0,
                               rtol=0)
    assert not any(p.requires_grad for p in model.parameters())


def test_load_wan_dit_from_a_safetensors_dir(tmp_path):
    from safetensors.torch import save_file
    cfg = tiny_test_config()
    sd = _torch_sd(make_synthetic_dit_sd(j_tiny(), seed=6))
    d = tmp_path / "Wan2.1-T2V-tiny"
    d.mkdir()
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[:40]},
              str(d / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    save_file({k: sd[k] for k in keys[40:]},
              str(d / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    model = tck.load_wan_dit(str(d), cfg, dtype=torch.bfloat16)
    want = dit_state_from_jax(_np(jck.load_wan_dit(str(d), j_tiny())), cfg)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, want[k].to(torch.bfloat16)), k


@pytest.mark.parametrize("kind", ["dit", "vae", "t5"])
def test_a_missing_key_fails_and_names_it(tmp_path, kind):
    if kind == "dit":
        sd = _torch_sd(make_synthetic_dit_sd(j_tiny()))
        missing = "blocks.1.ffn.2.weight"
        load = lambda p: tck.load_mmpl_generator(p, tiny_test_config())
        del sd[missing]
        p = tmp_path / "g.pt"
        _write_monolith(p, sd)
    else:
        sd = _torch_sd(_vae_upstream()[0]) if kind == "vae" \
            else _t5_upstream()[0]
        missing = ("decoder.upsamples.3.resample.1.weight" if kind == "vae"
                   else "blocks.1.pos_embedding.embedding.weight")
        del sd[missing]
        p = tmp_path / f"{kind}.pth"
        torch.save(sd, p)
        load = (tck.load_vae if kind == "vae"
                else lambda p: tck.load_t5(p, tt5.TINY_T5))
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        load(str(p))


def test_extra_keys_are_ignored_and_shapes_checked(tmp_path):
    up, model = _t5_upstream(dtype=torch.bfloat16)
    up["encoder.extra"] = torch.zeros(3)
    p = tmp_path / "models_t5_umt5-xxl-enc-bf16.pth"
    torch.save(up, p)
    got = tck.load_t5(str(p), tt5.TINY_T5)
    for k, v in got.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, model.state_dict()[k].to(torch.bfloat16)
                           .float()), k
    up["blocks.0.attn.q.weight"] = up["blocks.0.attn.q.weight"].T.clone()
    up["blocks.0.attn.q.weight"] = up["blocks.0.attn.q.weight"][:, :32]
    torch.save(up, p)
    with pytest.raises(ValueError, match="blocks.0.attn.q.weight"):
        tck.load_t5(str(p), tt5.TINY_T5)


def test_loaded_vae_encodes_as_the_jax_one(tmp_path):
    """Wan2.1_VAE.pth through both loaders, then one encode (f32, within
    1e-4 as tests/test_torch_vae.py)."""
    import jax.numpy as jnp
    from mmpl_tpu.models import vae as jvae
    up, _ = _vae_upstream(seed=3)
    p = tmp_path / "Wan2.1_VAE.pth"
    torch.save(_torch_sd(up), p)
    px = np.random.default_rng(3).uniform(-1, 1, (1, 1, 3, 32, 32)).astype(
        np.float32)
    want = np.asarray(jvae.encode(jck.load_vae(str(p)), jnp.asarray(px)))
    got = tvae.encode(tck.load_vae(str(p)), torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (1, 1, 16, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_to_upstream_round_trips():
    cfg = tiny_test_config()
    from mmpl_tpu_torch.models import dit as tdit
    model = tdit.init_dit_params(cfg, torch.Generator().manual_seed(0),
                                 torch.float32)
    up = tck.to_upstream(model.state_dict(), "dit")
    assert up["patch_embedding.weight"].shape == (cfg.dim, cfg.in_dim, 1, 2,
                                                  2)
    assert "blocks.0.ffn.0.weight" in up and "time_projection.1.bias" in up
    _assert_states_equal(tck.convert_dit(up, cfg), model.state_dict())
