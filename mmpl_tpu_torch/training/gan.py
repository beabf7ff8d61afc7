"""R3GAN-style GAN objective on DiT features.

Port of `mmpl_tpu/training/gan.py`: the fake-score DiT runs in classify
mode, its hidden states tapped after blocks {13, 21, 29}; each tap feeds a
GAN attention block whose query is a learned register token (one query row
over the tapped tokens, K1 forward and K2 / K3 backward on the card); the
pooled tokens, optionally with 10x the time embedding, pass through a
small classification branch.  The head is an `nn.Module` (`GanHead`) whose
parameter names are the JAX tree's leaf names, so
`utils/jax_params.gan_head_state_from_jax` maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.dit import (MLP, Affine, block_forward, embed_text,
                          layer_norm, linear, mlp, patchify,
                          precompute_context_kv, qkv_project, remat,
                          rms_norm, run_block, time_embed)
from ..ops.attention import attention
from ..ops.rope import window_rope_table

GAN_TAP_LAYERS = (13, 21, 29)


class GanCrossAttention(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.o = nn.Linear(d, d, **kw)
        self.norm_q = Affine(d, **kw)
        self.norm_k = Affine(d, **kw)


class GanBlock(nn.Module):
    def __init__(self, d: int, ffn_dim: int, **kw):
        super().__init__()
        self.norm3 = Affine(d, bias=True, **kw)
        self.cross_attn = GanCrossAttention(d, **kw)
        self.norm2 = Affine(d, bias=True, **kw)
        self.ffn = MLP(d, ffn_dim, d, **kw)


class ClsBranch(nn.Module):
    def __init__(self, in_dim: int, num_class: int, **kw):
        super().__init__()
        self.norm = Affine(in_dim, bias=True, **kw)
        self.fc1 = nn.Linear(in_dim, 1536, **kw)
        self.fc2 = nn.Linear(1536, num_class, **kw)


class GanHead(nn.Module):
    """Register tokens, GAN attention blocks and the classification
    branch."""

    def __init__(self, atten_dim: int = 1536, num_class: int = 1,
                 time_embed_dim: int = 0, num_registers: int = 3,
                 ffn_dim: int = 8192, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = atten_dim
        self.register_tokens = nn.Parameter(torch.empty(num_registers, d,
                                                        **kw))
        self.register_norm = Affine(d, **kw)
        self.gan_blocks = nn.ModuleList(GanBlock(d, ffn_dim, **kw)
                                        for _ in range(num_registers))
        self.cls_branch = ClsBranch(d * num_registers + time_embed_dim,
                                    num_class, **kw)


def _xavier(lin: nn.Linear, g: torch.Generator) -> None:
    dout, din = lin.weight.shape
    a = math.sqrt(6.0 / (din + dout))
    lin.weight.copy_(torch.empty(lin.weight.shape, device=lin.weight.device)
                     .uniform_(-a, a, generator=g))
    lin.bias.zero_()


@torch.no_grad()
def init_gan_head_params(generator: torch.Generator, atten_dim: int = 1536,
                         num_class: int = 1, time_embed_dim: int = 0,
                         num_registers: int = 3, ffn_dim: int = 8192,
                         dtype=torch.float32, device="cpu") -> GanHead:
    """A random head: xavier-uniform linears, N(0, 0.02) register tokens,
    unit norm weights, zero biases."""
    head = GanHead(atten_dim, num_class, time_embed_dim, num_registers,
                   ffn_dim, dtype, device="meta").to_empty(device=device)
    g = generator
    head.register_tokens.copy_(torch.randn(
        head.register_tokens.shape, generator=g, device=device) * 0.02)
    for m in head.modules():
        if isinstance(m, nn.Linear):
            _xavier(m, g)
        elif isinstance(m, Affine):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
    return head


def _gan_cross_attn(bp: GanBlock, x: torch.Tensor, token: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Query = the register token, keys / values = the tapped hidden
    states; then the token's residual and FFN."""
    B, L, D = x.shape
    n = num_heads
    d = D // n
    ca = bp.cross_attn
    xn = layer_norm(x, 1e-6, bp.norm3.weight, bp.norm3.bias)
    q = rms_norm(linear(ca.q, token), ca.norm_q.weight).reshape(B, -1, n, d)
    k = rms_norm(linear(ca.k, xn), ca.norm_k.weight).reshape(B, L, n, d)
    v = linear(ca.v, xn).reshape(B, L, n, d)
    out = attention(q, k, v).reshape(B, -1, D)
    tok = token + linear(ca.o, out)
    return mlp(bp.ffn, layer_norm(tok, 1e-6, bp.norm2.weight,
                                  bp.norm2.bias)) + tok


def gan_tap_layers(num_layers: int, num_registers: int):
    """The tapped blocks: GAN_TAP_LAYERS, or, where the trunk is too shallow
    for them, `num_registers` evenly spaced ones."""
    taps = [i for i in GAN_TAP_LAYERS if i < num_layers]
    if len(taps) != num_registers:
        taps = sorted(min(num_layers - 1,
                          max(0, round((j + 1) * num_layers
                                       / num_registers) - 1))
                      for j in range(num_registers))
    return taps


def dit_forward_classify(model, head: GanHead, cfg, latents: torch.Tensor,
                         t: torch.Tensor, context: torch.Tensor,
                         concat_time_embeddings: bool = False,
                         gan_num_heads: Optional[int] = None,
                         remat_blocks: bool = False) -> torch.Tensor:
    """Bidirectional DiT features -> GAN logits [B, num_class].  The blocks
    past the last tap are not run.  remat_blocks recomputes each block in
    the backward pass."""
    B, Fr, C, H, W = latents.shape
    grid = (H // cfg.patch_size[1], W // cfg.patch_size[2])
    x = patchify(model.patch_embedding, latents, cfg.patch_size)
    if t.ndim == 1:
        t = t[:, None]
    e, e0 = time_embed(model, cfg, t.expand(B, Fr))
    ctx_kv = precompute_context_kv(model, cfg,
                                   embed_text(model, context.to(x.dtype)))
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    cos_np, sin_np = window_rope_table(Fr, grid[0], grid[1], d)
    cos = torch.as_tensor(cos_np, device=x.device)
    sin = torch.as_tensor(sin_np, device=x.device)

    def block_fn(x, blk, ckv):
        def self_attn_fn(xm):
            q, k, v = qkv_project(blk.self_attn, xm, n, d, cos, sin)
            return linear(blk.self_attn.o,
                          attention(q, k, v).reshape(B, xm.shape[1], -1))
        return block_forward(blk, cfg, x, e0, self_attn_fn, ckv, Fr)

    R = head.register_tokens.shape[0]
    taps = gan_tap_layers(cfg.num_layers, R)
    registers = rms_norm(head.register_tokens, head.register_norm.weight)
    registers = registers[None].expand(B, -1, -1).to(x.dtype)
    feats = []
    prev = 0
    for gi, tap in enumerate(taps):
        for li in range(prev, tap + 1):
            step = lambda x, li=li: run_block(
                model.blocks[li], lambda b, x: block_fn(x, b, ctx_kv[li]),
                x)
            x = remat(step, x) if remat_blocks else step(x)
        prev = tap + 1
        gp = head.gan_blocks[gi % len(head.gan_blocks)]
        feats.append(_gan_cross_attn(gp, x, registers[:, gi:gi + 1],
                                     gan_num_heads or cfg.num_heads))

    final = torch.cat(feats, dim=1)                      # [B, taps, D]
    cb = head.cls_branch
    if concat_time_embeddings:
        final = torch.cat([final, 10.0 * e[:, :1].to(final.dtype)], dim=1)
    h = layer_norm(final.reshape(B, -1), 1e-5, cb.norm.weight, cb.norm.bias)
    h = F.silu(linear(cb.fc1, h))
    return linear(cb.fc2, h)


def r3gan_generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.softplus(-logits_fake))


def r3gan_critic_loss(logits_real: torch.Tensor,
                      logits_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.softplus(-logits_real)) + \
        torch.mean(F.softplus(logits_fake))
