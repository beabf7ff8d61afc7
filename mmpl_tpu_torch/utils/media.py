"""Image loading for i2v conditioning: file, base64 or URL -> [3, H, W].

Port of `resize_and_center_crop`, `fetch_url_bytes` and `load_image` of
`mmpl_tpu/utils/media.py`.  PIL is imported inside the functions that use
it.  `load_image` returns float32 in [-1, 1], the input convention of
`models/vae.encode`; `image_array` is its last step for an image that is
already an [H, W, 3] uint8 array.
"""

from __future__ import annotations

import base64
import io
from typing import Optional

import numpy as np


def resize_and_center_crop(image: np.ndarray, height: int,
                           width: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [height, width, 3]: scale to cover (bicubic),
    then crop the centre."""
    from PIL import Image
    h, w = image.shape[:2]
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    arr = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BICUBIC))
    top = (nh - height) // 2
    left = (nw - width) // 2
    return arr[top:top + height, left:left + width]


def fetch_url_bytes(url: str, timeout: float = 30.0) -> bytes:
    """The raw bytes behind an http(s) URL; a function of its own so that
    tests and offline deployments can replace the network hop."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def image_array(rgb: np.ndarray, height: Optional[int] = None,
                width: Optional[int] = None) -> np.ndarray:
    """[H, W, 3] uint8 -> [3, H, W] float32 in [-1, 1], resized and
    centre-cropped to (height, width) when both are given."""
    if height and width:
        rgb = resize_and_center_crop(rgb, height, width)
    return (rgb.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)


def load_image(source: str, height: Optional[int] = None,
               width: Optional[int] = None) -> np.ndarray:
    """An image from a file path, an http(s) URL or a base64 string (a
    `data:` URL, or a long string with no "/" in its first 256
    characters) -> [3, H, W] float32 in [-1, 1]."""
    from PIL import Image
    if source.startswith(("http://", "https://")):
        img = Image.open(io.BytesIO(fetch_url_bytes(source)))
    elif source.startswith("data:") or (len(source) > 512
                                        and "/" not in source[:256]):
        raw = source.split(",", 1)[-1]
        img = Image.open(io.BytesIO(base64.b64decode(raw)))
    else:
        img = Image.open(source)
    return image_array(np.asarray(img.convert("RGB")), height, width)
