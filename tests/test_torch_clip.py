"""Port parity: the CLIP visual tower and the two-tower XLM-RoBERTa CLIP
(mmpl_tpu_torch.models.clip vs mmpl_tpu.models.clip), f32 on the CPU at
tiny widths, weights bridged with `utils.jax_params`.  Tolerances: 2e-5 abs
for the forwards (as test_torch_dit.py); 0 for the conversions.  The
resize: within 1e-5 of `jax.image`'s own weights applied in float64 and
normalised (2.6e-6 in [0, 1] over CLIP's std; torch's antialiased bicubic
is 1.1e-6 off that sum), and within 5e-5 of the JAX package's
`preprocess_image`, whose fp32 resize on the CPU is itself up to 8.3e-6
off the float64 sum (3.2e-5 after the std)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmpl_tpu.models import clip as jclip
from mmpl_tpu_torch.models import clip as tclip
from mmpl_tpu_torch.utils import checkpoint as tck
from mmpl_tpu_torch.utils.jax_params import (clip_visual_state_from_jax,
                                             xlm_roberta_clip_state_from_jax)

ATOL = 2e-5
#: a tiny tower; head dim 80, the width of ViT-H/14's heads
VIS = dict(image_size=28, patch_size=14, dim=160, mlp_ratio=2, num_heads=2,
           num_layers=3)
TEXT = dict(vocab_size=64, max_seq_len=24, type_size=1, pad_id=1, dim=16,
            num_heads=4, num_layers=2, eps=1e-5)
OUT_DIM = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jitter(tree, seed):
    """JAX init with non-trivial norms and biases, as numpy."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "'bias'" in name:
            return a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
        if "'weight'" in name:
            return a * (1 + 0.1 * rng.standard_normal(a.shape)).astype(
                a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def visual():
    tree = _jitter(jclip.init_clip_visual_params(jax.random.PRNGKey(0), VIS),
                   1)
    model = tclip.empty_clip_visual(VIS)
    model.load_state_dict(clip_visual_state_from_jax(tree, VIS))
    img = np.random.default_rng(2).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    return tree, model, img


@pytest.mark.parametrize("use_31_block", [True, False])
def test_visual_forward_matches(visual, use_31_block):
    tree, model, img = visual
    want = jclip.clip_visual_forward(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(img), VIS, use_31_block)
    got = tclip.clip_visual_forward(model, torch.from_numpy(img), VIS,
                                    use_31_block)
    assert got.shape == (2, 5, VIS["dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


def test_init_has_the_jax_leaves():
    model = tclip.init_clip_visual_params(VIS,
                                          torch.Generator().manual_seed(0))
    want = clip_visual_state_from_jax(jax.tree.map(
        np.asarray, jclip.init_clip_visual_params(jax.random.PRNGKey(0),
                                                  VIS)), VIS)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert torch.equal(model.blocks[2].norm2.weight, torch.ones(VIS["dim"]))


@pytest.mark.parametrize("hw", [(480, 832), (100, 150), (224, 300)])
def test_preprocess_image_matches_jax_resize(hw):
    """The i2v image at 480x832 -> 224 (antialiased downsampling on both
    axes), an upsampling, and one axis left alone."""
    from jax._src.image import scale as jscale
    img = np.random.default_rng(sum(hw)).uniform(
        -1, 1, (1, 3, *hw)).astype(np.float32)
    got = tclip.preprocess_image(torch.from_numpy(img)).numpy()
    assert got.shape == (1, 3, 224, 224)
    exact = img.astype(np.float64) * 0.5 + 0.5
    for axis, n in ((2, hw[0]), (3, hw[1])):
        if n != 224:
            w = np.asarray(jscale.compute_weight_mat(
                n, 224, 224 / n, 0.0, jscale._fill_keys_cubic_kernel,
                True), np.float64)
            exact = np.moveaxis(np.tensordot(exact, w, axes=([axis], [0])),
                                -1, axis)
    exact = (exact - jclip.CLIP_MEAN.reshape(1, 3, 1, 1)) \
        / jclip.CLIP_STD.reshape(1, 3, 1, 1)
    np.testing.assert_allclose(got, exact, atol=1e-5, rtol=0)
    want = np.asarray(jclip.preprocess_image(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_resize_without_antialias_is_not_the_jax_resize():
    """Why `antialias=True`: without it torch's bicubic (a = -0.75, no
    widened kernel) is far off JAX's cubic at the i2v ratio."""
    img = np.random.default_rng(0).uniform(-1, 1, (1, 3, 480, 832)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (1, 3, 224, 224),
                                       method="cubic"))
    got = F.interpolate(torch.from_numpy(img), size=(224, 224),
                        mode="bicubic", antialias=False,
                        align_corners=False).numpy()
    assert np.abs(got - want).max() > 0.1


def synthetic_clip_sd(seed=0):
    """An upstream XLMRobertaCLIP state dict (both towers) of random
    weights, as numpy (the layout of tests/test_aux.py)."""
    rng = np.random.default_rng(seed)
    d, td = VIS["dim"], TEXT["dim"]
    mid_v = d * VIS["mlp_ratio"]
    sd = {"log_scale": np.float32(np.log(1 / 0.07))}

    def add(name, *shape, bias=None):
        sd[name + ".weight"] = (rng.standard_normal(shape) * 0.05).astype(
            np.float32)
        if bias is not None:
            sd[name + ".bias"] = (rng.standard_normal(bias) * 0.05).astype(
                np.float32)

    sd["visual.patch_embedding.weight"] = (rng.standard_normal(
        (d, 3, 14, 14)) * 0.05).astype(np.float32)
    sd["visual.cls_embedding"] = rng.standard_normal((1, 1, d)).astype(
        np.float32)
    sd["visual.pos_embedding"] = rng.standard_normal((1, 5, d)).astype(
        np.float32)
    add("visual.pre_norm", d, bias=d)
    for i in range(VIS["num_layers"]):
        pre = f"visual.transformer.{i}"
        add(f"{pre}.norm1", d, bias=d)
        add(f"{pre}.attn.to_qkv", 3 * d, d, bias=3 * d)
        add(f"{pre}.attn.proj", d, d, bias=d)
        add(f"{pre}.norm2", d, bias=d)
        add(f"{pre}.mlp.0", mid_v, d, bias=mid_v)
        add(f"{pre}.mlp.2", d, mid_v, bias=d)
    add("textual.token_embedding", TEXT["vocab_size"], td)
    add("textual.pos_embedding", TEXT["max_seq_len"], td)
    add("textual.type_embedding", 1, td)
    add("textual.norm", td, bias=td)
    for i in range(TEXT["num_layers"]):
        pre = f"textual.blocks.{i}"
        for nm in ("q", "k", "v", "o"):
            add(f"{pre}.attn.{nm}", td, td, bias=td)
        add(f"{pre}.norm1", td, bias=td)
        add(f"{pre}.ffn.0", 4 * td, td, bias=4 * td)
        add(f"{pre}.ffn.2", td, 4 * td, bias=td)
        add(f"{pre}.norm2", td, bias=td)
    mid = (td + OUT_DIM) // 2
    add("textual.head.0", mid, td)
    add("textual.head.2", OUT_DIM, mid)
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_clip_visual_equals_the_bridged_jax_conversion():
    sd = synthetic_clip_sd()
    want = clip_visual_state_from_jax(
        jax.tree.map(np.asarray, jclip.convert_clip_visual(sd, VIS)), VIS)
    _assert_equal(tclip.convert_clip_visual(_torch_sd(sd), VIS), want)


def test_two_tower_forward_and_conversion_match(tmp_path):
    """The whole XLMRobertaCLIP: conversion bit for bit, both towers'
    forwards within 2e-5, and `load_clip` of the `.pth` (visual alone, and
    with the text tower) equal to the conversion."""
    sd = synthetic_clip_sd(seed=1)
    jtree = jclip.convert_xlm_roberta_clip(sd, VIS, TEXT)
    want_sd = xlm_roberta_clip_state_from_jax(
        jax.tree.map(np.asarray, jtree), VIS, TEXT)
    got_sd = tclip.convert_xlm_roberta_clip(_torch_sd(sd), VIS, TEXT)
    _assert_equal(got_sd, want_sd)

    path = str(tmp_path / "clip.pth")
    torch.save(_torch_sd(sd), path)
    full = tck.load_clip(path, VIS, text=True, text_cfg=TEXT)
    _assert_equal(full.state_dict(), want_sd)
    vis = tck.load_clip(path, VIS)
    _assert_equal(vis.state_dict(), {k[len("visual."):]: v for k, v in
                                     want_sd.items()
                                     if k.startswith("visual.")})

    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    ids = np.array([[0, 5, 2, 1], [0, 9, 7, 2]], np.int32)
    xi_j, xt_j = jclip.xlm_roberta_clip_forward(
        jtree, jnp.asarray(imgs), jnp.asarray(ids), VIS, TEXT)
    xi, xt = tclip.xlm_roberta_clip_forward(full, torch.from_numpy(imgs),
                                            torch.from_numpy(ids))
    assert xi.shape == (2, 5, VIS["dim"]) and xt.shape == (2, OUT_DIM)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_j), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xt_j), atol=ATOL,
                               rtol=1e-5)
    assert float(full.log_scale) == pytest.approx(np.log(1 / 0.07))
