"""Video writing with backend fallback: mp4 -> ffmpeg binary -> gif -> npy.

Port of `mmpl_tpu/utils/video_io.py`: `write_video` returns the path
actually written, `read_video` reads any of them back.
"""

from __future__ import annotations

import shutil
import subprocess
import sys

import numpy as np


def write_video(path: str, frames: np.ndarray, fps: int = 16) -> str:
    """frames: [T, H, W, 3] uint8. Returns the output path written."""
    assert frames.dtype == np.uint8 and frames.ndim == 4
    try:
        import imageio
        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        pass
    if shutil.which("ffmpeg"):
        try:
            T, H, W, _ = frames.shape
            proc = subprocess.run(
                ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                 "-s", f"{W}x{H}", "-r", str(fps), "-i", "-",
                 "-pix_fmt", "yuv420p", path],
                input=frames.tobytes(), capture_output=True)
            if proc.returncode == 0:
                return path
        except Exception:
            pass
    try:
        import imageio
        gif = path.rsplit(".", 1)[0] + ".gif"
        imageio.mimwrite(gif, frames, duration=1000.0 / fps, loop=0)
        print(f"mp4 backend unavailable; wrote {gif}", file=sys.stderr)
        return gif
    except Exception:
        npy = path + ".npy"
        np.save(npy, frames)
        print(f"video backends unavailable; wrote {npy}", file=sys.stderr)
        return npy


def read_video(path: str) -> np.ndarray:
    """[T, H, W, 3] uint8 from mp4/gif/npy."""
    if path.endswith(".npy"):
        return np.load(path)
    import imageio
    return np.stack([np.asarray(f)[..., :3]
                     for f in imageio.mimread(path, memtest=False)])
