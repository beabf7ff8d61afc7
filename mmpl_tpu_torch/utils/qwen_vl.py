"""Vision I/O helpers for the Qwen-VL prompt expander.

Port of `mmpl_tpu/utils/qwen_vl.py` (which imports no JAX; the port keeps
its own copy): `smart_resize` keeps an image inside a pixel budget at
factor-aligned sides; `fetch_image` loads from a path, URL, base64 data
or a PIL image (PIL imported when called) and resizes; `process_vision_info`
walks chat messages collecting their images, the inputs
`utils/prompt_extend.QwenPromptExpander` reads.
"""

from __future__ import annotations

import base64
import io
import math
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200


def round_by_factor(n: float, factor: int) -> int:
    return round(n / factor) * factor


def ceil_by_factor(n: float, factor: int) -> int:
    return math.ceil(n / factor) * factor


def floor_by_factor(n: float, factor: int) -> int:
    return math.floor(n / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> Tuple[int, int]:
    """Factor-aligned resize target within [min_pixels, max_pixels]."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width):.1f}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def fetch_image(image: Any, size_factor: int = IMAGE_FACTOR):
    """Load an image element (PIL / path / url / base64 / {'image': ...})
    and smart-resize it. Returns a PIL.Image."""
    from PIL import Image
    if isinstance(image, dict):
        image = image.get("image") or image.get("image_url")
    if hasattr(image, "convert"):          # PIL already
        img = image
    elif isinstance(image, str):
        if image.startswith("data:image"):
            raw = image.split(";base64,", 1)[-1]
            img = Image.open(io.BytesIO(base64.b64decode(raw)))
        elif image.startswith(("http://", "https://")):
            with urllib.request.urlopen(image, timeout=30) as r:
                img = Image.open(io.BytesIO(r.read()))
        elif image.startswith("file://"):
            img = Image.open(image[7:])
        else:
            img = Image.open(image)
    else:
        raise TypeError(f"unsupported image input: {type(image)}")
    img = img.convert("RGB")
    h, w = smart_resize(img.height, img.width, factor=size_factor)
    return img.resize((w, h))


def process_vision_info(messages: List[Dict[str, Any]]
                        ) -> Tuple[Optional[list], Optional[list]]:
    """Collect (image_inputs, video_inputs) from chat-format messages."""
    images = []
    videos = []
    for msg in messages:
        content = msg.get("content")
        if not isinstance(content, list):
            continue
        for ele in content:
            if not isinstance(ele, dict):
                continue
            if ele.get("type") == "image" or "image" in ele \
                    or "image_url" in ele:
                images.append(fetch_image(ele))
            elif ele.get("type") == "video" or "video" in ele:
                videos.append(ele.get("video"))
    return (images or None, videos or None)
