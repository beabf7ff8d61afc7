"""XLM-RoBERTa text encoder (the CLIP text tower's backbone).

Port of `mmpl_tpu/models/xlm_roberta.py`: token + position + type
embeddings with a LayerNorm, post-norm blocks with exact-GELU MLPs and
key-padding attention, positions counted from pad_id + 1 at the non-pad
tokens (RoBERTa's convention).  `xlm_roberta_with_head` is the CLIP text
tower: masked mean pool, then a bias-free projection head.  The MMPL
pipelines never call it (i2v conditioning is visual only).

The masked attention is `ops/attention.dense_attention`, plain torch, as
in the JAX package (no flash kernel takes the key-padding mask there).
Parameter names follow the upstream module (`token_embedding.weight`,
`blocks.<i>.attn.q.weight`, ...) except the MLPs, which mirror the JAX
tree (`ffn.fc1` for the upstream `ffn.0`); `xlm_roberta_source_key` maps
them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention
from .dit import MLP, Affine, layer_norm, linear

XLM_ROBERTA_LARGE = dict(vocab_size=250002, max_seq_len=514, type_size=1,
                         pad_id=1, dim=1024, num_heads=16, num_layers=24,
                         eps=1e-5)


class Table(nn.Module):
    """An embedding table `weight` [rows, dim]."""

    def __init__(self, rows: int, dim: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(rows, dim, **kw))


class XLMRAttention(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)


class XLMRBlock(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.attn = XLMRAttention(dim, **kw)
        self.norm1 = Affine(dim, bias=True, **kw)
        self.ffn = MLP(dim, 4 * dim, dim, **kw)
        self.norm2 = Affine(dim, bias=True, **kw)


class XLMRoberta(nn.Module):
    def __init__(self, cfg: dict = XLM_ROBERTA_LARGE, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg["dim"]
        self.token_embedding = Table(cfg["vocab_size"], d, **kw)
        self.pos_embedding = Table(cfg["max_seq_len"], d, **kw)
        self.type_embedding = Table(cfg["type_size"], d, **kw)
        self.norm = Affine(d, bias=True, **kw)
        self.blocks = nn.ModuleList(XLMRBlock(d, **kw)
                                    for _ in range(cfg["num_layers"]))
        self.requires_grad_(False)


class XLMRobertaHead(nn.Module):
    """Linear(dim, mid, bias=False) -> GELU -> Linear(mid, out_dim,
    bias=False), mid = (dim + out_dim) // 2."""

    def __init__(self, dim: int = 1024, out_dim: int = 1024, **kw):
        super().__init__()
        mid = (dim + out_dim) // 2
        self.fc1 = nn.Linear(dim, mid, bias=False, **kw)
        self.fc2 = nn.Linear(mid, out_dim, bias=False, **kw)
        self.requires_grad_(False)


@torch.no_grad()
def init_xlm_roberta_params(cfg: dict = XLM_ROBERTA_LARGE,
                            generator: torch.Generator = None,
                            dtype=torch.float32,
                            device="cpu") -> XLMRoberta:
    """Random XLMRoberta with the JAX package's init: linears uniform in
    +-din^-1/2 with zero biases, embeddings normal * 0.02, unit norms."""
    model = XLMRoberta(cfg, dtype, device="meta").to_empty(device=device)
    g = generator
    for blk in model.blocks:
        for m in (blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.o,
                  blk.ffn.fc1, blk.ffn.fc2):
            _uniform(m, g)
            m.bias.zero_()
        for nrm in (blk.norm1, blk.norm2):
            nrm.weight.fill_(1.0)
            nrm.bias.zero_()
    for t in (model.token_embedding, model.pos_embedding,
              model.type_embedding):
        t.weight.copy_(torch.randn(t.weight.shape, generator=g,
                                   device=device) * 0.02)
    model.norm.weight.fill_(1.0)
    model.norm.bias.zero_()
    return model


@torch.no_grad()
def init_xlm_roberta_head_params(dim: int = 1024, out_dim: int = 1024,
                                 generator: torch.Generator = None,
                                 dtype=torch.float32,
                                 device="cpu") -> XLMRobertaHead:
    head = XLMRobertaHead(dim, out_dim, dtype=dtype, device="meta") \
        .to_empty(device=device)
    _uniform(head.fc1, generator)
    _uniform(head.fc2, generator)
    return head


def _uniform(m: nn.Linear, g: torch.Generator) -> None:
    a = m.weight.shape[1] ** -0.5
    m.weight.copy_(torch.empty(m.weight.shape, device=m.weight.device)
                   .uniform_(-a, a, generator=g))


def xlm_roberta_encode(model: XLMRoberta, ids: torch.Tensor,
                       cfg: dict = XLM_ROBERTA_LARGE) -> torch.Tensor:
    """ids [B, L] -> states [B, L, dim]."""
    B, L = ids.shape
    pad = cfg["pad_id"]
    ids = ids.long()
    mask = (ids != pad).long()
    pos = torch.cumsum(mask, dim=1) * mask + pad
    x = (model.token_embedding.weight[ids]
         + model.pos_embedding.weight[pos]
         + model.type_embedding.weight[torch.zeros_like(ids)])
    x = layer_norm(x, cfg["eps"], model.norm.weight, model.norm.bias)
    n = cfg["num_heads"]
    d = cfg["dim"] // n
    attn_mask = mask[:, None, None, :] > 0
    for blk in model.blocks:
        q, k, v = (linear(m, x).reshape(B, L, n, d)
                   for m in (blk.attn.q, blk.attn.k, blk.attn.v))
        att = dense_attention(q, k, v, mask=attn_mask).reshape(B, L, -1)
        x = layer_norm(x + linear(blk.attn.o, att), cfg["eps"],
                       blk.norm1.weight, blk.norm1.bias)
        h = linear(blk.ffn.fc2, F.gelu(linear(blk.ffn.fc1, x),
                                       approximate="none"))
        x = layer_norm(x + h, cfg["eps"], blk.norm2.weight, blk.norm2.bias)
    return x


def masked_mean_pool(states: torch.Tensor, ids: torch.Tensor,
                     pad_id: int = 1) -> torch.Tensor:
    """Mean of the non-pad tokens' states."""
    mask = (ids != pad_id).to(states.dtype)[:, :, None]
    return (states * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)


def xlm_roberta_with_head(model: XLMRoberta, head: XLMRobertaHead,
                          ids: torch.Tensor,
                          cfg: dict = XLM_ROBERTA_LARGE) -> torch.Tensor:
    """The CLIP text tower: encode, masked mean pool, projection head.
    Returns [B, out_dim]."""
    pooled = masked_mean_pool(xlm_roberta_encode(model, ids, cfg), ids,
                              cfg["pad_id"])
    h = F.gelu(linear(head.fc1, pooled), approximate="none")
    return linear(head.fc2, h)


def xlm_roberta_source_key(key: str) -> str:
    """The upstream name of an XLMRoberta (or XLMRobertaHead, under
    `head.`) parameter."""
    if key.startswith("head."):
        return key.replace("head.fc1.", "head.0.").replace("head.fc2.",
                                                           "head.2.")
    return key.replace(".ffn.fc1.", ".ffn.0.").replace(".ffn.fc2.",
                                                       ".ffn.2.")


def convert_xlm_roberta_text(sd: Dict[str, torch.Tensor],
                             cfg: dict = XLM_ROBERTA_LARGE,
                             dtype=torch.float32, device="cpu"):
    """The upstream XLMRobertaWithHead state dict (bare, or the whole
    XLMRobertaCLIP's with keys under `textual.`) -> (the XLMRoberta state
    dict, the XLMRobertaHead state dict)."""
    from ..utils.checkpoint import _convert, strip_prefix
    if any(k.startswith("textual.") for k in sd):
        sd = strip_prefix({k: v for k, v in sd.items()
                           if k.startswith("textual.")}, "textual.")
    out_dim = sd["head.2.weight"].shape[0]
    backbone = _convert(XLMRoberta(cfg, device="meta"), sd,
                        xlm_roberta_source_key, dtype, device)
    head = _convert(XLMRobertaHead(cfg["dim"], out_dim, device="meta"),
                    sd, lambda k: xlm_roberta_source_key("head." + k),
                    dtype, device)
    return backbone, head


def load_xlm_roberta_text(path: str, cfg: dict = XLM_ROBERTA_LARGE,
                          dtype=torch.float32, device="cpu"):
    """The CLIP text tower of the upstream checkpoint
    (`models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth`) ->
    (XLMRoberta, XLMRobertaHead)."""
    from ..utils.checkpoint import _load, load_torch_state_dict
    backbone, head = convert_xlm_roberta_text(load_torch_state_dict(path),
                                              cfg, dtype, device)
    out_dim = head["fc2.weight"].shape[0]
    return (_load(XLMRoberta(cfg, dtype, device="meta"), backbone),
            _load(XLMRobertaHead(cfg["dim"], out_dim, dtype=dtype,
                                 device="meta"), head))
