"""Port parity: i2v image loading (mmpl_tpu_torch.utils.media vs
mmpl_tpu.utils.media) from a file, base64 and a URL whose fetch is
replaced by the test (nothing is fetched)."""

import base64
import io

import numpy as np
import pytest
from PIL import Image

from mmpl_tpu.utils import media as jmedia
from mmpl_tpu_torch.utils import media as tmedia


def _png_bytes(h=50, w=70, seed=0, fmt="PNG", high=256):
    rgb = np.random.default_rng(seed).integers(0, high, (h, w, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format=fmt)
    return rgb, buf.getvalue()


@pytest.mark.parametrize("size", [None, (32, 48), (64, 40), (50, 70)])
def test_load_image_from_a_file(tmp_path, size):
    rgb, png = _png_bytes()
    p = tmp_path / "img.png"
    p.write_bytes(png)
    hw = size or (None, None)
    want = jmedia.load_image(str(p), *hw)
    got = tmedia.load_image(str(p), *hw)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (3, *(size or rgb.shape[:2]))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() <= 1.0
    if size is None:
        np.testing.assert_array_equal(
            got, rgb.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0)


@pytest.mark.parametrize("prefix", ["data:image/png;base64,", ""])
def test_load_image_from_base64(prefix):
    """A `data:` URL, or a bare base64 string.  A bare one must have no
    "/" in its first 256 characters, else both packages read it as a path:
    a BMP with pixel values under 63 has none."""
    _, bmp = _png_bytes(seed=1, fmt="BMP", high=63)
    src = base64.b64encode(bmp).decode()
    assert "/" not in src[:256] and len(src) > 512
    src = prefix + src
    want = jmedia.load_image(src, 32, 32)
    np.testing.assert_array_equal(tmedia.load_image(src, 32, 32), want)


def test_load_image_from_a_url(monkeypatch):
    _, png = _png_bytes(seed=2)
    seen = []

    def fake_fetch(url, timeout=30.0):
        seen.append(url)
        return png

    monkeypatch.setattr(tmedia, "fetch_url_bytes", fake_fetch)
    monkeypatch.setattr(jmedia, "fetch_url_bytes", fake_fetch)
    url = "https://example.invalid/cat.png"
    want = jmedia.load_image(url, 24, 40)
    got = tmedia.load_image(url, 24, 40)
    np.testing.assert_array_equal(got, want)
    assert seen == [url, url]


def test_resize_and_center_crop_matches():
    rgb, _ = _png_bytes(37, 91, seed=3)
    for h, w in ((16, 16), (40, 100), (90, 30)):
        got = tmedia.resize_and_center_crop(rgb, h, w)
        np.testing.assert_array_equal(
            got, jmedia.resize_and_center_crop(rgb, h, w))
        assert got.shape == (h, w, 3)


def test_image_array_is_load_image_after_decoding(tmp_path):
    """`image_array` is what `load_image` does after decoding the bytes
    (the path a caller takes with an image already in memory)."""
    rgb, png = _png_bytes(seed=4)
    p = tmp_path / "img.png"
    p.write_bytes(png)
    np.testing.assert_array_equal(tmedia.image_array(rgb, 32, 48),
                                  tmedia.load_image(str(p), 32, 48))
