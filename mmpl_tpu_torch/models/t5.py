"""umT5-XXL text encoder.

Port of `mmpl_tpu/models/t5.py` (umT5-XXL: vocab 256384, dim 4096, ffn
10240, 64 heads, 24 layers, 32 relative-position buckets, a position bias
per layer: umT5's `shared_pos=False`).  Parameter names mirror the JAX
tree (`blocks.<i>.attn.q.weight`, `blocks.<i>.pos_embedding.weight`, ...);
linear weights are torch-style [out, in].

T5 specifics kept: no attention scaling, an fp32 softmax over the scores
plus the layer's position bias plus a `finfo(f32).min` key-padding bias,
the gated tanh-GELU feed-forward `fc2(fc1(x) * gelu(gate(x)))`, pre-norm
residuals without biases, a final RMS norm without mean subtraction, and
padded positions zeroed in the output.  The attention is a dense product
with an additive per-head bias; it runs as plain torch matmuls (the
port's flash kernel takes no per-head bias).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dit import Affine

UMT5_XXL = dict(vocab_size=256384, dim=4096, dim_attn=4096, dim_ffn=10240,
                num_heads=64, num_layers=24, num_buckets=32)

TINY_T5 = dict(vocab_size=128, dim=64, dim_attn=64, dim_ffn=128,
               num_heads=4, num_layers=2, num_buckets=8)


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """T5LayerNorm: RMS without mean subtraction, no bias; the mean of
    squares in fp32."""
    xf = x.float()
    y = x * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps).to(x.dtype)
    return weight.to(x.dtype) * y


def relative_position_buckets(length: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional bucket matrix [L, L] (int64)."""
    rel_pos = np.arange(length)[None, :] - np.arange(length)[:, None]
    nb = num_buckets // 2
    buckets = (rel_pos > 0).astype(np.int64) * nb
    rel = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) /
        math.log(max_dist / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return buckets


class Attention(nn.Module):
    def __init__(self, dim: int, dim_attn: int, **kw):
        super().__init__()
        self.q = nn.Linear(dim, dim_attn, bias=False, **kw)
        self.k = nn.Linear(dim, dim_attn, bias=False, **kw)
        self.v = nn.Linear(dim, dim_attn, bias=False, **kw)
        self.o = nn.Linear(dim_attn, dim, bias=False, **kw)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dim_ffn: int, **kw):
        super().__init__()
        self.gate = nn.Linear(dim, dim_ffn, bias=False, **kw)
        self.fc1 = nn.Linear(dim, dim_ffn, bias=False, **kw)
        self.fc2 = nn.Linear(dim_ffn, dim, bias=False, **kw)


class T5Block(nn.Module):
    def __init__(self, cfg: dict, **kw):
        super().__init__()
        d = cfg["dim"]
        self.norm1 = Affine(d, **kw)
        self.attn = Attention(d, cfg["dim_attn"], **kw)
        self.norm2 = Affine(d, **kw)
        self.ffn = FeedForward(d, cfg["dim_ffn"], **kw)
        self.pos_embedding = nn.Embedding(cfg["num_buckets"],
                                          cfg["num_heads"], **kw)


class T5Encoder(nn.Module):
    """ids [B, L] int (and a {0, 1} mask [B, L]) -> states [B, L, dim],
    padded positions zeroed."""

    def __init__(self, cfg: dict, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = dict(cfg)
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["dim"],
                                            **kw)
        self.blocks = nn.ModuleList(T5Block(cfg, **kw)
                                    for _ in range(cfg["num_layers"]))
        self.norm = Affine(cfg["dim"], **kw)
        self.requires_grad_(False)

    @torch.inference_mode()
    def forward(self, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L = ids.shape
        n = self.cfg["num_heads"]
        dh = self.cfg["dim_attn"] // n
        if mask is None:
            mask = torch.ones((B, L), dtype=torch.int32, device=ids.device)
        buckets = torch.as_tensor(
            relative_position_buckets(L, self.cfg["num_buckets"]),
            device=ids.device)
        neg = torch.finfo(torch.float32).min
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, neg)
        x = self.token_embedding.weight[ids.long()]
        for blk in self.blocks:
            # [L, L, n] -> [1, n, L, L]
            pos_bias = blk.pos_embedding.weight[buckets].permute(2, 0, 1)[None]
            h = t5_layer_norm(x, blk.norm1.weight)
            q, k, v = (F.linear(h, lin.weight.to(h.dtype)).reshape(B, L, n, dh)
                       for lin in (blk.attn.q, blk.attn.k, blk.attn.v))
            scores = torch.einsum("binc,bjnc->bnij", q.float(), k.float())
            scores = scores + pos_bias.float() + mask_bias
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            att = torch.einsum("bnij,bjnc->binc", probs, v).reshape(B, L, -1)
            x = x + F.linear(att, blk.attn.o.weight.to(x.dtype))
            h = t5_layer_norm(x, blk.norm2.weight)
            gelu_gate = F.gelu(F.linear(h, blk.ffn.gate.weight.to(h.dtype)),
                               approximate="tanh")
            y = F.linear(h, blk.ffn.fc1.weight.to(h.dtype)) * gelu_gate
            x = x + F.linear(y, blk.ffn.fc2.weight.to(x.dtype))
        x = t5_layer_norm(x, self.norm.weight)
        return x * (mask[:, :, None] > 0)


def empty_t5(cfg: dict, dtype=torch.float32, device="cpu") -> T5Encoder:
    """Allocated, uninitialised parameters (fill by init or load)."""
    return T5Encoder(cfg, dtype, device="meta").to_empty(device=device)


@torch.no_grad()
def init_t5_params(cfg: dict, generator: torch.Generator,
                   dtype=torch.float32, device="cpu") -> T5Encoder:
    """Random T5Encoder with the JAX package's init: normal linears with
    std (d * da)^-1/2 for q, d^-1/2 for k, v, gate and fc1,
    (n * da / n)^-1/2 for o, dffn^-1/2 for fc2, (2 * buckets * n)^-1/2 for
    the position embeddings, unit-normal token embeddings, unit norms."""
    model = empty_t5(cfg, dtype, device)
    d, da, dffn = cfg["dim"], cfg["dim_attn"], cfg["dim_ffn"]
    n, nb = cfg["num_heads"], cfg["num_buckets"]
    g = generator
    for blk in model.blocks:
        for w, std in ((blk.attn.q.weight, (d * da) ** -0.5),
                       (blk.attn.k.weight, d ** -0.5),
                       (blk.attn.v.weight, d ** -0.5),
                       (blk.attn.o.weight, (n * (da // n)) ** -0.5),
                       (blk.ffn.gate.weight, d ** -0.5),
                       (blk.ffn.fc1.weight, d ** -0.5),
                       (blk.ffn.fc2.weight, dffn ** -0.5),
                       (blk.pos_embedding.weight, (2 * nb * n) ** -0.5)):
            w.normal_(0.0, std, generator=g)
        blk.norm1.weight.fill_(1.0)
        blk.norm2.weight.fill_(1.0)
    model.token_embedding.weight.normal_(0.0, 1.0, generator=g)
    model.norm.weight.fill_(1.0)
    return model

