"""Raw clips to latent shards: the video dataset and offline encoding.

Port of `mmpl_tpu/data/video_dataset.py`:

  * `TextVideoDataset`: CSV-driven video / image loading, a random-start
    strided window of frames, the max-scale resize and centre crop, [-1, 1]
    normalisation; frames-leading clips [T, C, H, W] as torch tensors on
    the dataset's `device`.  With `use_native` the resample is
    `data/fastproc.py` on that device (no PIL: `.npy` clips are read by
    numpy); without it, PIL per frame as the JAX package does.  Short or
    unreadable videos give a zero clip; `is_i2v` adds the first frame.
  * `encode_shards` and the `data_process` CLI: each clip through the VAE
    (`models/vae.encode_streaming`, causal chunks of 1, then 4 frames, so
    the peak stays that of 4 frames) and each prompt through umT5
    (`utils/tokenizer.WanTextEncoder`), written as `.npz` shards in the
    JAX package's schema (`latents`, `prompt_embeds`, `prompts`, optional
    `image_embeds`) that `data/datasets.TensorDictDataset` and
    `python -m mmpl_tpu_torch.train --data-dir` read.  `--synthetic` (or
    no `--vae_path`) encodes with the port's VAE at random weights from
    `--seed` and hash-seeded prompt states.

    python -m mmpl_tpu_torch.data.video_dataset --base_path clips \\
        --metadata_path clips/meta.csv --output_path shards \\
        --vae_path Wan2.1/Wan2.1_VAE.pth \\
        --text_encoder_path Wan2.1/models_t5_umt5-xxl-enc-bf16.pth \\
        --tokenizer_path Wan2.1/google/umt5-xxl --use_native
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

VIDEO_EXTS = (".mp4", ".gif", ".webm", ".mkv", ".avi", ".mov", ".npy")
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")


def discover_paths(base_dir: str, metadata_dir: str
                   ) -> Tuple[List[str], List[str]]:
    """Pair the data sub-directories with same-named CSVs."""
    base_paths, metadata_paths = [], []
    for sub in sorted(os.listdir(base_dir)):
        p = os.path.join(base_dir, sub)
        csv_file = os.path.join(metadata_dir, f"{sub}.csv")
        if os.path.isdir(p) and os.path.exists(csv_file):
            base_paths.append(p)
            metadata_paths.append(csv_file)
    return base_paths, metadata_paths


def read_metadata_csv(path: str) -> List[Tuple[str, str]]:
    """(file, text) rows of a CSV with a `file_name` (or `file_path`)
    column and a `text` column."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return []
    name_col = "file_name" if "file_name" in rows[0] else "file_path"
    return [(r[name_col], r["text"]) for r in rows]


def scale_crop_resize(img, height: int, width: int):
    """A PIL image: max-scale bilinear resize, then centre crop."""
    from PIL import Image
    w, h = img.size
    scale = max(width / w, height / h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    x0 = (w - width) // 2
    y0 = (h - height) // 2
    return img.crop((x0, y0, x0 + width, y0 + height))


def _to_chw_norm(img) -> np.ndarray:
    """PIL RGB -> [C, H, W] float32 in [-1, 1]."""
    arr = np.asarray(img, np.float32) / 127.5 - 1.0
    return arr.transpose(2, 0, 1)


class TextVideoDataset:
    """Raw video / image and caption items: {"text", "video" [T, C, H, W]
    float32 in [-1, 1] on `device`, "path"} and, with `is_i2v`,
    "first_frame" [H, W, 3] uint8 (numpy)."""

    def __init__(self, base_path, metadata_path, max_num_frames: int = 81,
                 frame_interval: int = 1, num_frames: int = 81,
                 height: int = 480, width: int = 832, is_i2v: bool = False,
                 seed: int = 0, use_native: bool = False, device="cuda"):
        from ..utils.device import resolve_device
        if isinstance(base_path, str):
            base_path = [base_path]
        if isinstance(metadata_path, str):
            metadata_path = [metadata_path]
        self.path: List[str] = []
        self.text: List[str] = []
        for bp, mp in zip(base_path, metadata_path):
            for fname, text in read_metadata_csv(mp):
                self.path.append(os.path.join(bp, fname))
                self.text.append(text)
        self.max_num_frames = max_num_frames
        self.frame_interval = frame_interval
        self.num_frames = num_frames
        self.height, self.width = height, width
        self.is_i2v = is_i2v
        self.device = torch.device(device)
        resolve_device(self.device.type)
        self._rng = np.random.default_rng(seed)
        self.use_native = use_native

    def __len__(self) -> int:
        return len(self.path)

    def _read_all_frames(self, path: str) -> Optional[np.ndarray]:
        """[T, H, W, 3] uint8, or None if unreadable."""
        try:
            if path.endswith(".npy"):
                return np.load(path)
            import imageio
            return np.stack([np.asarray(f)[..., :3]
                             for f in imageio.mimread(path, memtest=False)])
        except Exception:
            return None

    def load_video(self, path: str) -> Optional[torch.Tensor]:
        """The random-start strided frame window -> [T, C, H, W]."""
        raw = self._read_all_frames(path)
        if raw is None:
            return None
        span = (self.num_frames - 1) * self.frame_interval
        if len(raw) < self.max_num_frames or len(raw) - 1 < span:
            return None
        hi = max(1, self.max_num_frames - span)
        start = int(self._rng.integers(0, hi))
        sel = raw[start:start + self.num_frames * self.frame_interval:
                  self.frame_interval]
        if self.use_native:
            from . import fastproc
            return fastproc.scale_crop_normalize_clip(
                torch.from_numpy(np.ascontiguousarray(sel)).to(self.device),
                self.height, self.width)
        from PIL import Image
        frames = [_to_chw_norm(scale_crop_resize(
            Image.fromarray(a), self.height, self.width)) for a in sel]
        return torch.from_numpy(np.stack(frames)).to(self.device)

    def load_image(self, path: str) -> torch.Tensor:
        """One image as a 1-frame video."""
        from PIL import Image
        img = Image.open(path).convert("RGB")
        return torch.from_numpy(_to_chw_norm(
            scale_crop_resize(img, self.height, self.width))[None]).to(
                self.device)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path, text = self.path[idx], self.text[idx]
        if path.lower().endswith(IMAGE_EXTS):
            if self.is_i2v:
                raise ValueError(
                    f"{path} is not a video; i2v needs video samples")
            video = self.load_image(path)
        else:
            video = self.load_video(path)
        if video is None:
            video = torch.zeros((self.num_frames, 3, self.height,
                                 self.width), device=self.device)
        data = {"text": text, "video": video, "path": path}
        if self.is_i2v:
            first = (video[0].permute(1, 2, 0).float().cpu().numpy()
                     + 1.0) * 127.5
            data["first_frame"] = np.clip(first, 0, 255).astype(np.uint8)
        return data


# ---------------------------------------------------------------------------
# Offline encoding -> TensorDictDataset shards
# ---------------------------------------------------------------------------

def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def synthetic_prompt_encoder(text_len: int, text_dim: int
                             ) -> Callable[[Sequence[str]], np.ndarray]:
    """Prompt states seeded from the prompt's sha256 (the JAX package's
    draws, so both packages give the same states)."""

    def encode(texts: Sequence[str]) -> np.ndarray:
        out = []
        for t in texts:
            seed = int.from_bytes(
                hashlib.sha256(t.encode()).digest()[:4], "little")
            out.append(np.random.default_rng(seed).standard_normal(
                (text_len, text_dim)).astype(np.float32))
        return np.stack(out)

    return encode


def encode_shards(dataset: TextVideoDataset, out_dir: str,
                  vae_encode: Callable, prompt_encode: Callable,
                  shard_size: int = 64,
                  image_encode: Optional[Callable] = None,
                  log: Callable[[str], None] = lambda s: None) -> List[str]:
    """Encode every clip and write `.npz` shards.

    vae_encode: [1, T, C, H, W] pixels -> [1, F, 16, h, w] latents;
    prompt_encode: list[str] -> [N, text_len, text_dim]; each a tensor or
    numpy.  A new shard starts where the latent geometry changes (images
    and clips); zero clips (unreadable or short videos) are skipped."""
    os.makedirs(out_dir, exist_ok=True)
    shard_paths: List[str] = []
    lat_buf: List[np.ndarray] = []
    emb_buf: List[np.ndarray] = []
    txt_buf: List[str] = []
    img_buf: List[np.ndarray] = []

    def flush():
        if not lat_buf:
            return
        path = os.path.join(out_dir, f"shard_{len(shard_paths):05d}.npz")
        arrays = {"latents": np.stack(lat_buf),
                  "prompt_embeds": np.stack(emb_buf),
                  "prompts": np.asarray(txt_buf, dtype=object)}
        if img_buf:
            arrays["image_embeds"] = np.stack(img_buf)
        np.savez(path, **arrays)
        shard_paths.append(path)
        log(f"wrote {path}: {len(lat_buf)} clips")
        lat_buf.clear(); emb_buf.clear(); txt_buf.clear(); img_buf.clear()

    for i in range(len(dataset)):
        item = dataset[i]
        video = item["video"]
        if not bool(torch.as_tensor(video).any()):
            log(f"skip (unreadable/short): {item['path']}")
            continue
        lat = _np32(vae_encode(video[None]))[0]
        emb = _np32(prompt_encode([item["text"]]))[0]
        if lat_buf and lat_buf[0].shape != lat.shape:
            flush()
        lat_buf.append(lat)
        emb_buf.append(emb)
        txt_buf.append(item["text"])
        if image_encode is not None and "first_frame" in item:
            img_buf.append(_np32(image_encode(item["first_frame"])))
        if len(lat_buf) >= shard_size:
            flush()
    flush()
    return shard_paths


def _vae_encoder(vae_model) -> Callable:
    from ..models import vae as vae_mod

    @torch.inference_mode()
    def vae_encode(pixels: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(pixels).to(vae_model.conv1.weight.device)
        if (x.shape[1] - 1) % 4:
            return vae_mod.encode(vae_model, x.float())
        return vae_mod.encode_streaming(vae_model, x.float())

    return vae_encode


def _build_real_encoders(args, device):
    """The Wan VAE and umT5 from their files (f32, on `device`)."""
    from ..models import t5
    from ..utils.checkpoint import load_t5, load_vae
    vae_encode = _vae_encoder(load_vae(args.vae_path, torch.float32, device))
    if args.text_encoder_path:
        from ..utils.tokenizer import WanTextEncoder
        te = WanTextEncoder(load_t5(args.text_encoder_path, t5.UMT5_XXL,
                                    torch.float32, device),
                            args.tokenizer_path)

        @torch.inference_mode()
        def prompt_encode(texts):
            return te(texts)["prompt_embeds"]
    else:
        prompt_encode = synthetic_prompt_encoder(args.text_len,
                                                 args.text_dim)
    return vae_encode, prompt_encode


def _build_synthetic_encoders(args, device):
    """The port's VAE at random weights from `--seed` and hash-seeded
    prompt states: the whole raw clip -> shard -> train plumbing without
    Wan weights."""
    from ..models import vae as vae_mod
    g = torch.Generator(device=device).manual_seed(args.seed)
    vae_model = vae_mod.init_vae_params(g, torch.float32, device)
    return _vae_encoder(vae_model), synthetic_prompt_encoder(args.text_len,
                                                             args.text_dim)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base_path", required=True,
                   help="root directory of video/image files")
    p.add_argument("--metadata_path", required=True,
                   help="CSV listing file_name,text")
    p.add_argument("--output_path", default="./data_shards")
    p.add_argument("--vae_path", default=None,
                   help="Wan2.1_VAE.pth (omit for --synthetic)")
    p.add_argument("--text_encoder_path", default=None,
                   help="models_t5_umt5-xxl-enc-bf16.pth")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="random VAE + hash prompts (smoke, no checkpoints)")
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--frame_interval", type=int, default=1)
    p.add_argument("--shard_size", type=int, default=64)
    p.add_argument("--text_len", type=int, default=512)
    p.add_argument("--text_dim", type=int, default=4096)
    p.add_argument("--is_i2v", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_native", action="store_true",
                   help="resample the clips on --device (data/fastproc.py) "
                        "instead of PIL per frame")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def data_process(argv=None) -> List[str]:
    from ..utils.device import resolve_device, set_float32_precision
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision()
    dataset = TextVideoDataset(
        args.base_path, args.metadata_path, max_num_frames=args.num_frames,
        frame_interval=args.frame_interval, num_frames=args.num_frames,
        height=args.height, width=args.width, is_i2v=args.is_i2v,
        seed=args.seed, use_native=args.use_native, device=device)
    if args.synthetic or not args.vae_path:
        vae_encode, prompt_encode = _build_synthetic_encoders(args, device)
    else:
        vae_encode, prompt_encode = _build_real_encoders(args, device)
    return encode_shards(
        dataset, args.output_path, vae_encode, prompt_encode,
        shard_size=args.shard_size,
        log=lambda s: print(s, file=sys.stderr, flush=True))


if __name__ == "__main__":
    data_process()
