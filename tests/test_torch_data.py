"""Port parity: the data path (`mmpl_tpu_torch/data/datasets.py`,
`fastproc.py`, `video_dataset.py`) against `mmpl_tpu/data/` on the CPU,
on the same clips and arrays.

`batch_iterator` yields the JAX package's batches for the same seed (and
after `skip`, the batches from there on); shards written by either
package are read by the other; the resample is within 1e-5 of the JAX
package's C helper; `TextVideoDataset` items equal JAX's (PIL path
exactly, the resample within 1e-5); `encode_shards` through the port's
VAE (the JAX tree bridged by `vae_state_from_jax`) is within
`test_torch_vae.py`'s encode tolerance (1e-4) of JAX's; `data_process
--synthetic --device cpu` writes shards."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmpl_tpu.data import datasets as jds
from mmpl_tpu.data import fastproc as jfp
from mmpl_tpu.data import video_dataset as jvd
from mmpl_tpu.models import vae as jvae
from mmpl_tpu_torch.data import datasets as tds
from mmpl_tpu_torch.data import fastproc as tfp
from mmpl_tpu_torch.data import video_dataset as tvd
from mmpl_tpu_torch.models import vae as tvae
from mmpl_tpu_torch.utils.jax_params import vae_state_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W = 32, 32


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Clips of 13 and 9 frames (.npy, .gif), one of 3 (too short), a PNG
    image and their CSV."""
    import imageio
    from PIL import Image
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    frames = lambda n: rng.integers(0, 255, (n, 40, 48, 3), dtype=np.uint8)
    np.save(d / "a.npy", frames(13))
    imageio.mimwrite(str(d / "b.gif"), list(frames(9)), duration=62,
                     loop=0)
    np.save(d / "short.npy", frames(3))
    Image.fromarray(frames(1)[0]).save(d / "img.png")
    (d / "meta.csv").write_text("file_name,text\na.npy,a red fox\n"
                                "b.gif,waves at dusk\nshort.npy,too short\n"
                                "img.png,a still image\n", encoding="utf-8")
    (d / "video.csv").write_text("file_name,text\na.npy,a red fox\n"
                                 "b.gif,waves at dusk\n", encoding="utf-8")
    return d


class _Items:
    """A small dataset of dict items (arrays, strings, numbers)."""

    def __init__(self, n):
        rng = np.random.default_rng(5)
        self.items = [{"x": rng.standard_normal((2, 3)).astype(np.float32),
                       "s": f"item {i}", "i": i} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("seed,batch,drop_last", [(0, 2, True),
                                                  (3, 3, True),
                                                  (1, 3, False)])
def test_batch_iterator_matches_jax(seed, batch, drop_last):
    """The same batches in the same order over several passes, and the
    port's `skip` starts where the JAX iterator is after that many."""
    data = _Items(7)
    it = jds.batch_iterator(data, batch, seed=seed, drop_last=drop_last)
    want = [next(it) for _ in range(10)]
    it = tds.batch_iterator(data, batch, seed=seed, drop_last=drop_last)
    for w in want:
        _same_batch(next(it), w)
    it = tds.batch_iterator(data, batch, seed=seed, drop_last=drop_last,
                            skip=4)
    for w in want[4:]:
        _same_batch(next(it), w)


def test_batch_iterator_skip_loads_nothing_and_refuses_an_empty_pass():
    loaded = []

    class Spy(_Items):
        def __getitem__(self, i):
            loaded.append(i)
            return super().__getitem__(i)

    it = tds.batch_iterator(Spy(5), 2, seed=0, skip=3)
    next(it)
    assert len(loaded) == 2
    with pytest.raises(ValueError, match="make no batch"):
        next(tds.batch_iterator(_Items(1), 2))


def test_text_and_image_datasets_match_jax(tmp_path):
    from PIL import Image
    (tmp_path / "p.txt").write_text("a cat\n\nsurfing\n", encoding="utf-8")
    (tmp_path / "e.txt").write_text("a cat, long\nsurfing, long\n",
                                    encoding="utf-8")
    args = (str(tmp_path / "p.txt"), str(tmp_path / "e.txt"))
    j, t = jds.TextDataset(*args), tds.TextDataset(*args)
    assert len(j) == len(t) == 2
    assert [j[i] for i in range(2)] == [t[i] for i in range(2)]
    img = np.random.default_rng(1).integers(0, 255, (50, 70, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "im.png")
    meta = tmp_path / "crop.json"
    meta.write_text(json.dumps([{"image_name": "im.png", "caption": "c",
                                 "crop": [2, 3, 60, 45]}]), encoding="utf-8")
    j, t = (m(str(tmp_path), str(meta), 24, 40)
            for m in (jds.TextImagePairDataset, tds.TextImagePairDataset))
    _same_batch(t[0], j[0])
    assert t[0]["image"].shape == (3, 24, 40)
    it = tds.cycle([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]


def test_lmdb_layout_matches_jax():
    """Without `lmdb` both packages' LMDB datasets raise ImportError; the
    row and shape readers decode the upstream entries alike."""
    rows = np.arange(24, dtype=np.float16).reshape(2, 3, 4)
    store = {b"ode_latent_shape": str(rows.shape).encode(),
             **{f"ode_latent_{i}_data".encode(): rows[i].tobytes()
                for i in range(2)}}

    class Env:
        def begin(self):
            class Txn:
                def __enter__(self):
                    return self

                def __exit__(self, *a):
                    return False

                def get(self, key):
                    return store[key]
            return Txn()

    for m in (jds, tds):
        assert m.get_array_shape_from_lmdb(Env(), "ode_latent") == (2, 3, 4)
        np.testing.assert_array_equal(m.retrieve_row_from_lmdb(
            Env(), "ode_latent", np.float16, (3, 4), 1), rows[1])
    for cls in (jds.ODERegressionLMDBDataset, tds.ODERegressionLMDBDataset,
                jds.ShardingLMDBDataset, tds.ShardingLMDBDataset):
        with pytest.raises(ImportError):
            cls("x")


def _c_helper():
    if not jfp.available():
        pytest.skip("the JAX package's C helper did not build here")
    return jfp


@pytest.mark.parametrize("th,tw", [(48, 64), (64, 40), (192, 240)])
def test_fastproc_matches_the_c_helper(th, tw):
    """Downscale in both axes, a crop of each orientation, and upscale
    (the geometries of tests/test_video_data.py:170-190), on smooth and on
    noisy frames: within 1e-5 of `mmpl_tpu/data/_fastproc.c`."""
    c = _c_helper()
    rng = np.random.default_rng(0)
    base = np.kron(rng.standard_normal((12, 15)), np.ones((8, 8)))
    smooth = np.clip(base * 25 + 128, 0, 255).astype(np.uint8)
    frames = np.stack([np.stack([smooth] * 3, -1),
                       rng.integers(0, 256, (96, 120, 3), dtype=np.uint8)])
    want = c.scale_crop_normalize_clip(frames, th, tw)
    got = tfp.scale_crop_normalize_clip(torch.from_numpy(frames), th, tw)
    assert got.dtype == torch.float32 and got.shape == (2, 3, th, tw)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # numpy input reads on the CPU alike
    np.testing.assert_array_equal(
        tfp.scale_crop_normalize_clip(frames, th, tw).numpy(), got.numpy())


def test_fastproc_odd_geometry_and_refusals():
    c = _c_helper()
    frames = np.random.default_rng(2).integers(0, 256, (1, 37, 53, 3),
                                               dtype=np.uint8)
    for th, tw in ((37, 53), (20, 11), (75, 31)):
        np.testing.assert_allclose(
            tfp.scale_crop_normalize_clip(frames, th, tw).numpy(),
            c.scale_crop_normalize_clip(frames, th, tw), atol=1e-5, rtol=0)
    assert tfp.available()
    with pytest.raises(ValueError, match="uint8"):
        tfp.scale_crop_normalize_clip(frames.astype(np.float32), 8, 8)


def _datasets(clips, csv="meta.csv", **kw):
    args = (str(clips), str(clips / csv))
    kw = dict(max_num_frames=9, num_frames=5, height=H, width=W, seed=4,
              **kw)
    native = kw.pop("use_native", False)
    return (jvd.TextVideoDataset(*args, use_native=native, **kw),
            tvd.TextVideoDataset(*args, use_native=native, device="cpu",
                                 **kw))


@pytest.mark.parametrize("native", [False, True])
def test_text_video_dataset_matches_jax(clips, native):
    """The same items from the same clips: the random-start window, the
    zero clip of a short video, the image as one frame; PIL's resample
    exactly, the port's resample within 1e-5 of the C helper's."""
    if native:
        _c_helper()
    j, t = _datasets(clips, use_native=native)
    assert len(j) == len(t) == 4
    for i in range(4):
        a, b = j[i], t[i]
        assert (a["text"], a["path"]) == (b["text"], b["path"])
        assert isinstance(b["video"], torch.Tensor)
        np.testing.assert_allclose(b["video"].numpy(), a["video"],
                                   atol=1e-5 if native else 0, rtol=0)
    assert not t[2]["video"].any() and t[0]["video"].shape == (5, 3, H, W)
    assert t[3]["video"].shape == (1, 3, H, W)


def test_text_video_dataset_i2v_first_frame_matches_jax(clips):
    j, t = _datasets(clips, csv="video.csv", is_i2v=True)
    for i in range(2):
        np.testing.assert_array_equal(t[i]["first_frame"],
                                      j[i]["first_frame"])
    j, t = _datasets(clips, is_i2v=True)
    for ds in (j, t):
        with pytest.raises(ValueError, match="i2v needs video"):
            ds[3]


def test_metadata_and_discovery_match_jax(clips, tmp_path):
    assert tvd.read_metadata_csv(str(clips / "meta.csv")) == \
        jvd.read_metadata_csv(str(clips / "meta.csv"))
    (tmp_path / "data" / "s1").mkdir(parents=True)
    (tmp_path / "data" / "s2").mkdir()
    (tmp_path / "meta").mkdir()
    (tmp_path / "meta" / "s1.csv").write_text("file_name,text\n")
    args = (str(tmp_path / "data"), str(tmp_path / "meta"))
    assert tvd.discover_paths(*args) == jvd.discover_paths(*args)
    enc = (jvd.synthetic_prompt_encoder(16, 64),
           tvd.synthetic_prompt_encoder(16, 64))
    np.testing.assert_array_equal(enc[0](["a", "b"]), enc[1](["a", "b"]))


def _fake_vae(pixels):
    """[1, T, 3, H, W] -> [1, 1 + (T - 1) / 4, 16, H / 8, W / 8]: a
    deterministic stand-in for the VAE."""
    x = np.asarray(pixels, np.float32)
    T = 1 + (x.shape[1] - 1) // 4
    pooled = x[:, ::4][:, :T].reshape(1, T, 3, H // 8, 8, W // 8, 8)
    pooled = pooled.mean(axis=(4, 6))
    return np.concatenate([pooled] * 6, axis=2)[:, :, :16]


def test_shards_read_across_the_two_packages(clips, tmp_path):
    """Shards written by each package's `encode_shards` (one shard per
    latent geometry: the image starts its own; the short clip skipped)
    hold the same arrays, and each package's TensorDictDataset reads the
    other's."""
    j, t = _datasets(clips)
    out = {}
    for name, ds, mod in (("jax", j, jvd), ("port", t, tvd)):
        vae = _fake_vae if name == "jax" else (
            lambda px: _fake_vae(px.numpy()))
        out[name] = mod.encode_shards(ds, str(tmp_path / name), vae,
                                      mod.synthetic_prompt_encoder(16, 64),
                                      shard_size=8)
        assert [os.path.basename(p) for p in out[name]] == [
            "shard_00000.npz", "shard_00001.npz"]
    for pj, pt in zip(out["jax"], out["port"]):
        zj, zt = (dict(np.load(p, allow_pickle=True)) for p in (pj, pt))
        assert set(zj) == set(zt) == {"latents", "prompt_embeds", "prompts"}
        for k in zj:
            np.testing.assert_array_equal(zt[k], zj[k])
    for src, reader in (("jax", tds), ("port", jds)):
        mine = (jds if reader is tds else tds).TensorDictDataset(
            str(tmp_path / src))
        other = reader.TensorDictDataset(str(tmp_path / src))
        assert len(mine) == len(other) == 3
        for i in range(3):
            _same_batch(other[i], mine[i])


def _numpy_vae_tree(seed):
    """A random VAE tree in `init_vae_params`' layout, filled by numpy
    (the JAX package's own init takes ~20 s on the CPU)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (np.ones if name == "gamma" else np.zeros)(
            leaf.shape, np.float32)

    shapes = jax.eval_shape(lambda k: jvae.init_vae_params(k, jnp.float32),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_encode_shards_through_the_vae_matches_jax(clips, tmp_path):
    """Each package's VAE on the same weights: the port encodes the
    5-frame clips in causal chunks (`encode_streaming`), JAX the whole
    clip; latents within 1e-4."""
    tree = _numpy_vae_tree(7)
    model = tvae.empty_vae(torch.float32)
    model.load_state_dict(vae_state_from_jax(tree))
    jenc = jax.jit(jvae.encode)
    jparams = jax.tree.map(jnp.asarray, tree)
    j, t = _datasets(clips, csv="video.csv")
    prompts = jvd.synthetic_prompt_encoder(16, 64)
    pj = jvd.encode_shards(j, str(tmp_path / "jax"),
                           lambda px: np.asarray(jenc(jparams, px)), prompts)
    pt = tvd.encode_shards(t, str(tmp_path / "port"), tvd._vae_encoder(model),
                           tvd.synthetic_prompt_encoder(16, 64))
    zj, zt = (np.load(p[0], allow_pickle=True) for p in (pj, pt))
    assert zt["latents"].shape == zj["latents"].shape == (2, 2, 16, 4, 4)
    assert np.abs(zj["latents"]).max() > 1e-2
    np.testing.assert_allclose(zt["latents"], zj["latents"], atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(zt["prompt_embeds"], zj["prompt_embeds"])


def test_data_process_synthetic_on_the_cpu(clips, tmp_path):
    """`python -m mmpl_tpu_torch.data.video_dataset --synthetic --device
    cpu`: the port's random VAE, the resample on the CPU, one shard of the
    readable clips."""
    out = tmp_path / "shards"
    paths = tvd.data_process([
        "--base_path", str(clips), "--metadata_path",
        str(clips / "video.csv"), "--output_path", str(out), "--synthetic",
        "--num_frames", "5", "--height", str(H), "--width", str(W),
        "--text_len", "16", "--text_dim", "64", "--use_native", "--device",
        "cpu"])
    assert len(paths) == 1
    items = tds.TensorDictDataset(str(out))
    assert len(items) == 2 and items[0]["latents"].shape == (2, 16, 4, 4)
    assert np.isfinite(items[1]["latents"]).all()
    assert items[1]["prompts"] == "waves at dusk"
    args = tvd.parse_args(["--base_path", "a", "--metadata_path", "b"])
    assert args.device == "cuda" and not args.use_native
