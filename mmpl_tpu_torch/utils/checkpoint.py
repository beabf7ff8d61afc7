"""Checkpoint ingestion: upstream `.pt` / `.pth` / safetensors files -> the
port's modules.

Port of `mmpl_tpu/utils/checkpoint.py`.  The upstream layouts: base Wan
weights in a directory of safetensors shards (WanModel's parameter names),
T5, the VAE and CLIP as raw `.pth` state dicts, and MMPL fine-tunes as one
`.pt` holding `{'generator': ..., 'generator_ema': ...}` with every key
prefixed `model.`.

Each loader remaps the upstream names onto the port's module (built on the
meta device), converts each tensor to the asked dtype and device on its
own, and loads the result with `load_state_dict(strict=True,
assign=True)`: every parameter is filled, a missing upstream key raises a
KeyError that names it, and extra keys in the file are ignored.  `.pt` /
`.pth` files are read with `torch.load(mmap=True)` where their format
allows it, so only the tensors a loader takes are read from disk.  The
layouts: torch-style linear and conv weights are the port's own; the DiT's
Conv3d patch embedding [D, C, 1, 2, 2] becomes the port's linear [D, 4C]
(feature order c, ph, pw); the VAE's RMS-norm gammas [C, 1, 1(, 1)] become
[C].  `to_upstream` maps a port state dict back onto the upstream names
and shapes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, Tuple

import numpy as np
import torch

State = Dict[str, torch.Tensor]

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _load_safetensors(path: str) -> State:
    """A safetensors file -> {name: tensor}, read through a copy-on-write
    memory map (pages are read as the tensors are used); bf16 stays
    bf16."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + hlen)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        s, e = info["data_offsets"]
        raw = torch.from_numpy(data[s:e])
        out[name] = raw.view(_SAFETENSORS_DTYPES[info["dtype"]]).reshape(
            info["shape"])
    return out


def _torch_load(path: str):
    """torch.load on the CPU with the file memory-mapped where its format
    allows (the zip format; not the legacy one)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False,
                          mmap=True)
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path: str) -> State:
    """A `.pt` / `.pth` / `.safetensors` file, or a directory of
    safetensors shards (else its `diffusion_pytorch_model.bin` or
    `pytorch_model.bin`) -> {name: tensor}."""
    if os.path.isdir(path):
        tensors: State = {}
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".safetensors"):
                tensors.update(_load_safetensors(os.path.join(path, fn)))
        if tensors:
            return tensors
        for fn in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
            p = os.path.join(path, fn)
            if os.path.exists(p):
                path = p
                break
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    sd = _torch_load(path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def strip_prefix(sd: State, prefix: str) -> State:
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Name maps: the port's parameter name -> the upstream one
# ---------------------------------------------------------------------------

#: the i2v DiT's `img_emb` parts -> WanModel's `img_emb.proj` indices
_IMG_EMB = {"norm1": "0", "fc1": "1", "fc2": "3", "norm2": "4"}


def dit_source_key(key: str) -> str:
    """WanModel's name of a `models.dit.WanDiT` (unfused) parameter."""
    if key.startswith("img_emb."):
        _, part, leaf = key.split(".")
        return f"img_emb.proj.{_IMG_EMB[part]}.{leaf}"
    key = key.replace("time_projection.fc.", "time_projection.1.")
    return key.replace(".fc1.", ".0.").replace(".fc2.", ".2.")


def t5_source_key(key: str) -> str:
    """umT5's name of a `models.t5.T5Encoder` parameter."""
    return key.replace(".ffn.gate.", ".ffn.gate.0.").replace(
        ".pos_embedding.", ".pos_embedding.embedding.")


#: a VAE block's parts: residual block, resample, top-level sequences
_VAE_RES = {"norm1": "residual.0", "conv1": "residual.2",
            "norm2": "residual.3", "conv2": "residual.6"}
_VAE_RESAMPLE = {"resample": "resample.1"}
_VAE_SEQ = {"down": "downsamples", "up": "upsamples", "middle": "middle",
            "head_norm": "head.0", "head_conv": "head.2"}


def vae_source_key(key: str) -> str:
    """WanVAE_'s name of a `models.vae.WanVAE` parameter."""
    parts = key.split(".")
    if parts[0] in ("encoder", "decoder") and parts[1] in _VAE_SEQ:
        parts[1] = _VAE_SEQ[parts[1]]
        if parts[1] in ("downsamples", "upsamples", "middle"):
            parts[3] = _VAE_RES.get(parts[3],
                                    _VAE_RESAMPLE.get(parts[3], parts[3]))
    return ".".join(parts)


def _vae_gamma_shape(key: str, dim: int) -> Tuple[int, ...]:
    """The upstream RMS_norm gamma: [C, 1, 1] in an attention block
    (images=True), [C, 1, 1, 1] elsewhere."""
    attn = key.split(".")[-2] == "norm" and ".middle.1." in key
    return (dim, 1, 1) if attn else (dim, 1, 1, 1)


# ---------------------------------------------------------------------------
# Conversion and loading
# ---------------------------------------------------------------------------

def _convert(module: torch.nn.Module, sd: State,
             source: Callable[[str], str], dtype, device) -> State:
    """The port state dict of `module` (its names and shapes) from the
    upstream `sd`: each tensor taken by its upstream name, reshaped to the
    port's shape where only the layout differs, and moved to (device,
    dtype) on its own."""
    out = {}
    for key, like in module.state_dict().items():
        name = source(key)
        if name not in sd:
            raise KeyError(f"checkpoint lacks {name!r} (for {key})")
        t = sd[name]
        if tuple(t.shape) != tuple(like.shape):
            if t.numel() != like.numel() or not (
                    key == "patch_embedding.weight" or key.endswith(".gamma")):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                 f"expected {tuple(like.shape)}")
            t = t.reshape(like.shape)
        out[key] = t.to(device=device, dtype=dtype)
    return out


def convert_dit(sd: State, cfg, dtype=torch.float32,
                device="cpu") -> State:
    """WanModel state dict -> the state dict of `models.dit.WanDiT`
    (unfused self-attention); an i2v config also takes `img_emb.proj.
    {0,1,3,4}` and each cross-attention's `k_img`, `v_img`, `norm_k_img`."""
    from ..models.dit import WanDiT
    return _convert(WanDiT(cfg, fused=False, device="meta"), sd,
                    dit_source_key, dtype, device)


def _load(module: torch.nn.Module, state: State) -> torch.nn.Module:
    module.load_state_dict(state, strict=True, assign=True)
    return module


def load_wan_dit(path: str, cfg, dtype=torch.float32, device="cpu"):
    """Base Wan weights (a directory of safetensors shards, or one state
    dict file) -> `models.dit.WanDiT`."""
    from ..models.dit import WanDiT
    return _load(WanDiT(cfg, fused=False, dtype=dtype, device="meta"),
                 convert_dit(load_torch_state_dict(path), cfg, dtype,
                             device))


def load_mmpl_generator(path: str, cfg, use_ema: bool = False,
                        dtype=torch.float32, device="cpu"):
    """An MMPL fine-tune (`t2v_14B_8k.pt`-style: `generator` /
    `generator_ema`, keys under `model.`) -> `models.dit.WanDiT`."""
    from ..models.dit import WanDiT
    blob = _torch_load(path)
    sd = strip_prefix(blob["generator_ema" if use_ema else "generator"],
                      "model.")
    return _load(WanDiT(cfg, fused=False, dtype=dtype, device="meta"),
                 convert_dit(sd, cfg, dtype, device))


def convert_t5(sd: State, cfg: dict, dtype=torch.float32,
               device="cpu") -> State:
    """umT5 encoder state dict -> the state dict of `models.t5.T5Encoder`."""
    from ..models.t5 import T5Encoder
    return _convert(T5Encoder(cfg, device="meta"), sd, t5_source_key, dtype,
                    device)


def load_t5(path: str, cfg: dict, dtype=torch.float32, device="cpu"):
    from ..models.t5 import T5Encoder
    return _load(T5Encoder(cfg, dtype=dtype, device="meta"),
                 convert_t5(load_torch_state_dict(path), cfg, dtype, device))


def convert_vae(sd: State, dtype=torch.float32, device="cpu") -> State:
    """WanVAE_ state dict -> the state dict of `models.vae.WanVAE`."""
    from ..models.vae import WanVAE
    return _convert(WanVAE(device="meta"), sd, vae_source_key, dtype,
                    device)


def load_vae(path: str, dtype=torch.float32, device="cpu"):
    from ..models.vae import WanVAE
    return _load(WanVAE(dtype=dtype, device="meta"),
                 convert_vae(load_torch_state_dict(path), dtype, device))


def load_clip(path: str, cfg: dict = None, text: bool = False,
              text_cfg: dict = None, dtype=torch.float32, device="cpu"):
    """The upstream CLIP checkpoint
    (`models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth`) ->
    `models.clip.CLIPVisual` (the visual tower, what i2v runs), or with
    `text` the whole `models.clip.XLMRobertaCLIP` (both towers, the text
    head and `log_scale`)."""
    from ..models import clip
    cfg = cfg if cfg is not None else clip.VIT_H_14
    sd = load_torch_state_dict(path)
    if not text:
        return _load(clip.CLIPVisual(cfg, dtype, device="meta"),
                     clip.convert_clip_visual(sd, cfg, dtype, device))
    state = clip.convert_xlm_roberta_clip(sd, cfg, text_cfg, dtype, device)
    return _load(clip.XLMRobertaCLIP(cfg, text_cfg,
                                     state["head.fc2.weight"].shape[0],
                                     dtype, device="meta"), state)


def to_upstream(state: State, kind: str) -> State:
    """A port state dict ("dit", "t5" or "vae") under the upstream names
    and shapes, the inverse of the loaders' conversion (for writing files
    in the upstream layouts)."""
    source = {"dit": dit_source_key, "t5": t5_source_key,
              "vae": vae_source_key}[kind]
    out = {}
    for key, t in state.items():
        name = source(key)
        if kind == "dit" and key == "patch_embedding.weight":
            t = t.reshape(t.shape[0], -1, 1, 2, 2)
        elif kind == "vae" and key.endswith(".gamma"):
            t = t.reshape(_vae_gamma_shape(name, t.shape[0]))
        out[name] = t
    return out
