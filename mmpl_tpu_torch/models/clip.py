"""CLIP ViT-H/14 visual encoder (XLM-RoBERTa CLIP) for i2v conditioning.

Port of `mmpl_tpu/models/clip.py`.  The i2v pipeline runs the vision tower
through 31 of its 32 blocks (`use_31_block`) and takes the [B, 257, 1280]
image tokens, which the DiT's `img_emb` projects into cross-attention
context.  The full two-tower model (`XLMRobertaCLIP`, the text tower from
`models/xlm_roberta.py`) is here for parity and scoring.

Parameter names mirror the JAX tree (`blocks.<i>.attn.to_qkv.weight`,
`blocks.<i>.mlp.fc1.weight`, ...); `clip_visual_source_key` maps them onto
the upstream names (`transformer.<i>.mlp.0.weight`, ...).  The block:
pre-norm LayerNorms at eps 1e-5, one fused `to_qkv` projection, attention
through `ops/attention.attention` (K1 on the card, D = 80), an exact-GELU
MLP.

`preprocess_image` resizes as `jax.image.resize(method="cubic")` does:
Keys' cubic with a = -0.5 and, when downsampling, the kernel widened by the
inverse scale (antialiasing), each output's weights normalised to sum 1.
That is `F.interpolate(mode="bicubic", antialias=True)`, whose antialiased
path uses a = -0.5 (without `antialias` torch's bicubic uses a = -0.75 and
does not widen the kernel: 0.68 off at 480x832 -> 224).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .dit import MLP, Affine, layer_norm, linear

VIT_H_14 = dict(image_size=224, patch_size=14, dim=1280, mlp_ratio=4,
                num_heads=16, num_layers=32)

#: OpenCLIP normalisation constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

#: the CLIP text embedding's width (XLMRobertaCLIP embed_dim)
CLIP_EMBED_DIM = 1024


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, mid: int, **kw):
        super().__init__()
        self.norm1 = Affine(dim, bias=True, **kw)
        self.attn = CLIPAttention(dim, **kw)
        self.norm2 = Affine(dim, bias=True, **kw)
        self.mlp = MLP(dim, mid, dim, **kw)


class CLIPVisual(nn.Module):
    """The ViT: a bias-free patch convolution, a class token, learned
    positions, a pre-norm and the blocks."""

    def __init__(self, cfg: dict = VIT_H_14, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d, p = cfg["dim"], cfg["patch_size"]
        tokens = (cfg["image_size"] // p) ** 2 + 1
        self.cfg = dict(cfg)
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False, **kw)
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, d, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, d, **kw))
        self.pre_norm = Affine(d, bias=True, **kw)
        mid = int(d * cfg["mlp_ratio"])
        self.blocks = nn.ModuleList(CLIPBlock(d, mid, **kw)
                                    for _ in range(cfg["num_layers"]))
        self.requires_grad_(False)


def empty_clip_visual(cfg: dict = VIT_H_14, dtype=torch.float32,
                      device="cpu") -> CLIPVisual:
    """Allocated, uninitialised parameters (fill by init or load)."""
    return CLIPVisual(cfg, dtype, device="meta").to_empty(device=device)


@torch.no_grad()
def init_clip_visual_params(cfg: dict = VIT_H_14,
                            generator: Optional[torch.Generator] = None,
                            dtype=torch.float32,
                            device="cpu") -> CLIPVisual:
    """Random CLIPVisual with the JAX package's init: linears uniform in
    +-din^-1/2 with zero biases, the patch kernel, class token and
    positions normal * d^-1/2, unit norms."""
    model = empty_clip_visual(cfg, dtype, device)
    g = generator
    gain = 1.0 / math.sqrt(cfg["dim"])

    def lin(m: nn.Linear):
        a = 1.0 / math.sqrt(m.weight.shape[1])
        m.weight.copy_(torch.empty(m.weight.shape, device=device).uniform_(
            -a, a, generator=g))
        m.bias.zero_()

    def nrm(m: Affine):
        m.weight.fill_(1.0)
        m.bias.zero_()

    for blk in model.blocks:
        nrm(blk.norm1)
        nrm(blk.norm2)
        for m in (blk.attn.to_qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            lin(m)
    for w in (model.patch_embedding.weight, model.cls_embedding,
              model.pos_embedding):
        w.copy_(torch.randn(w.shape, generator=g, device=device) * gain)
    nrm(model.pre_norm)
    return model


def clip_visual_forward(model: CLIPVisual, images: torch.Tensor,
                        cfg: dict = VIT_H_14,
                        use_31_block: bool = True) -> torch.Tensor:
    """images [B, 3, H, W] (CLIP-normalised) -> tokens [B, 257, dim]; with
    `use_31_block` the last block is not run."""
    B = images.shape[0]
    d, n, p = cfg["dim"], cfg["num_heads"], cfg["patch_size"]
    x = F.conv2d(images, model.patch_embedding.weight.to(images.dtype),
                 stride=p)
    x = x.flatten(2).transpose(1, 2)                  # row-major tokens
    cls = model.cls_embedding.to(x.dtype).expand(B, 1, d)
    x = torch.cat([cls, x], dim=1) + model.pos_embedding.to(x.dtype)
    x = layer_norm(x, 1e-5, model.pre_norm.weight, model.pre_norm.bias)
    L = x.shape[1]
    depth = cfg["num_layers"] - (1 if use_31_block else 0)
    for blk in model.blocks[:depth]:
        h = layer_norm(x, 1e-5, blk.norm1.weight, blk.norm1.bias)
        q, k, v = linear(blk.attn.to_qkv, h).reshape(
            B, L, 3, n, d // n).unbind(2)
        x = x + linear(blk.attn.proj, attention(q, k, v).reshape(B, L, d))
        h = layer_norm(x, 1e-5, blk.norm2.weight, blk.norm2.bias)
        h = linear(blk.mlp.fc2, F.gelu(linear(blk.mlp.fc1, h),
                                       approximate="none"))
        x = x + h
    return x


# ---------------------------------------------------------------------------
# Image preprocessing
# ---------------------------------------------------------------------------

def preprocess_image(image: torch.Tensor, image_size: int = 224
                     ) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> CLIP-normalised [B, 3, 224, 224] fp32."""
    x = F.interpolate(image.float() * 0.5 + 0.5, size=(image_size,
                                                        image_size),
                      mode="bicubic", antialias=True, align_corners=False)
    mean = torch.as_tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# The two-tower model and the upstream layout
# ---------------------------------------------------------------------------

class XLMRobertaCLIP(nn.Module):
    """Both towers of the upstream XLMRobertaCLIP: `visual`, `textual`
    (XLM-RoBERTa), the text `head` and `log_scale`."""

    def __init__(self, vis_cfg: dict = VIT_H_14, text_cfg: dict = None,
                 embed_dim: int = CLIP_EMBED_DIM, dtype=torch.float32,
                 device=None):
        super().__init__()
        from .xlm_roberta import (XLM_ROBERTA_LARGE, XLMRoberta,
                                  XLMRobertaHead)
        text_cfg = text_cfg if text_cfg is not None else XLM_ROBERTA_LARGE
        kw = dict(dtype=dtype, device=device)
        self.vis_cfg, self.text_cfg = dict(vis_cfg), dict(text_cfg)
        self.visual = CLIPVisual(vis_cfg, **kw)
        self.textual = XLMRoberta(text_cfg, **kw)
        self.head = XLMRobertaHead(text_cfg["dim"], embed_dim, **kw)
        self.log_scale = nn.Parameter(torch.empty((), **kw))
        self.requires_grad_(False)


@torch.no_grad()
def init_xlm_roberta_clip_params(vis_cfg: dict = VIT_H_14,
                                 text_cfg: dict = None,
                                 embed_dim: int = CLIP_EMBED_DIM,
                                 generator: Optional[torch.Generator] = None,
                                 dtype=torch.float32,
                                 device="cpu") -> XLMRobertaCLIP:
    """Random XLMRobertaCLIP: each tower and the head with its own init,
    `log_scale` = log(1 / 0.07)."""
    from .xlm_roberta import (init_xlm_roberta_head_params,
                              init_xlm_roberta_params)
    model = XLMRobertaCLIP(vis_cfg, text_cfg, embed_dim, dtype,
                           device="meta")
    g = generator
    model.visual = init_clip_visual_params(vis_cfg, g, dtype, device)
    model.textual = init_xlm_roberta_params(model.text_cfg, g, dtype,
                                            device)
    model.head = init_xlm_roberta_head_params(model.text_cfg["dim"],
                                              embed_dim, g, dtype, device)
    model.log_scale = nn.Parameter(torch.full((), math.log(1 / 0.07),
                                              dtype=dtype, device=device),
                                   requires_grad=False)
    return model


def xlm_roberta_clip_forward(model: XLMRobertaCLIP, imgs: torch.Tensor,
                             txt_ids: torch.Tensor, vis_cfg: dict = None,
                             text_cfg: dict = None):
    """CLIP-normalised images + token ids -> (visual tokens of the full
    depth [B, 257, 1280], text embeddings [B, embed_dim])."""
    from .xlm_roberta import xlm_roberta_with_head
    vis_cfg = vis_cfg if vis_cfg is not None else model.vis_cfg
    text_cfg = text_cfg if text_cfg is not None else model.text_cfg
    xi = clip_visual_forward(model.visual, imgs, vis_cfg, use_31_block=False)
    xt = xlm_roberta_with_head(model.textual, model.head, txt_ids, text_cfg)
    return xi, xt


def clip_visual_source_key(key: str) -> str:
    """The upstream name (under `visual.`) of a CLIPVisual parameter."""
    key = key.replace("blocks.", "transformer.", 1)
    return key.replace(".mlp.fc1.", ".mlp.0.").replace(".mlp.fc2.",
                                                       ".mlp.2.")


def clip_source_key(key: str) -> str:
    """The upstream name of an XLMRobertaCLIP parameter."""
    from .xlm_roberta import xlm_roberta_source_key
    part, _, rest = key.partition(".")
    if part == "visual":
        return "visual." + clip_visual_source_key(rest)
    if part == "textual":
        return "textual." + xlm_roberta_source_key(rest)
    if part == "head":
        return "textual." + xlm_roberta_source_key(key)
    return key


def _visual_sd(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if any(k.startswith("visual.") for k in sd):
        return {k[len("visual."):]: v for k, v in sd.items()
                if k.startswith("visual.")}
    return sd


def convert_clip_visual(sd: Dict[str, torch.Tensor], cfg: dict = VIT_H_14,
                        dtype=torch.float32, device="cpu"):
    """The upstream state dict (the whole XLMRobertaCLIP, keys under
    `visual.`, or the visual tower alone) -> the state dict of
    `CLIPVisual`; the text tower's tensors are not read."""
    from ..utils.checkpoint import _convert
    return _convert(CLIPVisual(cfg, device="meta"), _visual_sd(sd),
                    clip_visual_source_key, dtype, device)


def convert_xlm_roberta_clip(sd: Dict[str, torch.Tensor],
                             vis_cfg: dict = VIT_H_14, text_cfg: dict = None,
                             dtype=torch.float32, device="cpu"):
    """The upstream XLMRobertaCLIP state dict -> the state dict of
    `XLMRobertaCLIP` (both towers, the head and `log_scale`); the head's
    width is read from `textual.head.2.weight`."""
    from ..utils.checkpoint import _convert
    embed_dim = sd["textual.head.2.weight"].shape[0]
    like = XLMRobertaCLIP(vis_cfg, text_cfg, embed_dim, device="meta")
    return _convert(like, sd, clip_source_key, dtype, device)
