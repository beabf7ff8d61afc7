"""Wan DiT layers for the planned-window serving path and training.

Port of the parts of `mmpl_tpu/models/dit.py` that the FPS pipeline and the
teacher-forcing trainer run.
Parameters live in `nn.Module`s whose names mirror the JAX parameter tree
(`blocks.<i>.self_attn.qkv.weight`, ...), so `utils/jax_params.py` maps one
onto the other.  Linear weights are torch-style [out, in].  Layers are
plain functions over those modules, as in the JAX package:

  * `linear` casts the weight to the activation dtype;
  * norms compute in fp32 and cast back;
  * the AdaLN modulation runs in fp32, `modulate`/`gate` cast shift, scale
    and gate to the activation dtype.

Parameters do not require gradients unless a trainer turns them on
(`training/diffusion.py`).  `call_with` runs a layer function over a cast
copy of a module's parameters (the trainer's bf16 trunk over fp32
masters), and `remat` recomputes a block in the backward pass.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.rope import apply_rope, apply_rope_split, split_rope_permutation


class Affine(nn.Module):
    """A norm's `weight` (and optional `bias`)."""

    def __init__(self, dim: int, bias: bool = False, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **kw))
        self.bias = nn.Parameter(torch.empty(dim, **kw)) if bias else None


class SelfAttention(nn.Module):
    def __init__(self, dim: int, fused: bool, **kw):
        super().__init__()
        if fused:
            self.qkv = nn.Linear(dim, 3 * dim, **kw)
        else:
            self.q = nn.Linear(dim, dim, **kw)
            self.k = nn.Linear(dim, dim, **kw)
            self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)
        self.norm_q = Affine(dim, **kw)
        self.norm_k = Affine(dim, **kw)

    @property
    def fused(self) -> bool:
        return hasattr(self, "qkv")


class CrossAttention(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)
        self.norm_q = Affine(dim, **kw)
        self.norm_k = Affine(dim, **kw)


class MLP(nn.Module):
    def __init__(self, din: int, dhidden: int, dout: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(din, dhidden, **kw)
        self.fc2 = nn.Linear(dhidden, dout, **kw)


class Block(nn.Module):
    """One WanAttentionBlock."""

    def __init__(self, cfg, fused: bool, **kw):
        super().__init__()
        d = cfg.dim
        self.self_attn = SelfAttention(d, fused, **kw)
        self.cross_attn = CrossAttention(d, **kw)
        self.ffn = MLP(d, cfg.ffn_dim, d, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 6, d, **kw))
        self.norm3 = Affine(d, bias=True, **kw) if cfg.cross_attn_norm \
            else None


class TimeProjection(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.fc = nn.Linear(dim, 6 * dim, **kw)


class Head(nn.Module):
    def __init__(self, dim: int, out: int, **kw):
        super().__init__()
        self.head = nn.Linear(dim, out, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 2, dim, **kw))


class WanDiT(nn.Module):
    """Parameter container of the (causal FPS) Wan DiT, t2v."""

    def __init__(self, cfg, fused: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = cfg.dim
        pt, ph, pw = cfg.patch_size
        self.patch_embedding = nn.Linear(pt * ph * pw * cfg.in_dim, d, **kw)
        self.text_embedding = MLP(cfg.text_dim, d, d, **kw)
        self.time_embedding = MLP(cfg.freq_dim, d, d, **kw)
        self.time_projection = TimeProjection(d, **kw)
        self.blocks = nn.ModuleList(Block(cfg, fused, **kw)
                                    for _ in range(cfg.num_layers))
        self.head = Head(d, pt * ph * pw * cfg.out_dim, **kw)
        self.requires_grad_(False)


def empty_dit(cfg, fused: bool = False, dtype=torch.bfloat16,
              device="cpu") -> WanDiT:
    """Allocated, uninitialised parameters (fill by init or load)."""
    return WanDiT(cfg, fused, dtype, device="meta").to_empty(device=device)


class _Bound(nn.Module):
    """`forward(fn, ...)` = fn(module, ...), so that `functional_call` can
    run any layer function over substituted parameters."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args, **kwargs):
        return fn(self.m, *args, **kwargs)


def call_with(module: nn.Module, params: Dict[str, torch.Tensor], fn,
              *args, **kwargs):
    """fn(module, *args, **kwargs) with the module's parameters replaced by
    `params` (names as in `named_parameters`) for the call; gradients flow
    back to whatever `params` were made from."""
    return torch.func.functional_call(
        _Bound(module), {f"m.{k}": v for k, v in params.items()},
        (fn,) + args, kwargs)


def cast_params(module: nn.Module, dtype: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """The module's floating parameters cast to `dtype` (differentiable)."""
    return {n: p.to(dtype) if p.is_floating_point() else p
            for n, p in module.named_parameters()}


def remat(fn: Callable[[torch.Tensor], torch.Tensor],
          x: torch.Tensor) -> torch.Tensor:
    """fn(x) whose activations are recomputed in the backward pass instead
    of kept (per-block rematerialisation, the role of `remat_layer`
    without `offload`); fn must read what it closes over identically when
    it is run again."""
    return checkpoint(fn, x, use_reentrant=False)


# ---------------------------------------------------------------------------
# Initialisation (random weights from an explicit generator)
# ---------------------------------------------------------------------------

def _init_linear(lin: nn.Linear, g: torch.Generator, std: Optional[float] = None,
                 zero: bool = False) -> None:
    w = lin.weight
    if zero:
        w.zero_()
    elif std is not None:
        w.copy_(torch.randn(w.shape, generator=g, device=w.device) * std)
    else:
        dout, din = w.shape
        a = math.sqrt(6.0 / (din + dout))
        w.copy_(torch.empty(w.shape, device=w.device).uniform_(
            -a, a, generator=g))
    if lin.bias is not None:
        lin.bias.zero_()


@torch.no_grad()
def init_dit_params(cfg, generator: torch.Generator, dtype=torch.bfloat16,
                    device="cpu") -> WanDiT:
    """Random WanDiT (unfused self-attention) with the reference init:
    xavier-uniform linears, N(0, 0.02) embeddings, zero head, N(0, 1/d)
    modulations, unit norm weights, zero biases."""
    model = empty_dit(cfg, fused=False, dtype=dtype, device=device)
    g = generator
    d = cfg.dim
    for blk in model.blocks:
        for lin in (blk.self_attn.q, blk.self_attn.k, blk.self_attn.v,
                    blk.self_attn.o, blk.cross_attn.q, blk.cross_attn.k,
                    blk.cross_attn.v, blk.cross_attn.o, blk.ffn.fc1,
                    blk.ffn.fc2):
            _init_linear(lin, g)
        for nrm in (blk.self_attn.norm_q, blk.self_attn.norm_k,
                    blk.cross_attn.norm_q, blk.cross_attn.norm_k):
            nrm.weight.fill_(1.0)
        blk.modulation.copy_(torch.randn(blk.modulation.shape, generator=g,
                                         device=device) / math.sqrt(d))
        if blk.norm3 is not None:
            blk.norm3.weight.fill_(1.0)
            blk.norm3.bias.zero_()
    _init_linear(model.patch_embedding, g)
    for m in (model.text_embedding, model.time_embedding):
        _init_linear(m.fc1, g, std=0.02)
        _init_linear(m.fc2, g, std=0.02)
    _init_linear(model.time_projection.fc, g)
    _init_linear(model.head.head, g, zero=True)
    model.head.modulation.copy_(torch.randn(
        model.head.modulation.shape, generator=g, device=device)
        / math.sqrt(d))
    return model


@torch.no_grad()
def fuse_qkv_params(model: WanDiT, num_heads: int) -> WanDiT:
    """Fuse each block's q/k/v into one [3D, D] projection and permute the
    q/k output channels (and their norm weights) to the split-half RoPE
    layout.  Done in place, once, at pipeline construction."""
    for blk in model.blocks:
        sa = blk.self_attn
        if sa.fused:
            continue
        D = sa.q.weight.shape[0]
        perm = torch.as_tensor(split_rope_permutation(num_heads,
                                                      D // num_heads),
                               device=sa.q.weight.device)
        p = lambda t: t.index_select(0, perm)
        fused = SelfAttention(D, True, dtype=sa.q.weight.dtype,
                              device="meta").to_empty(
                                  device=sa.q.weight.device)
        fused.qkv.weight.copy_(torch.cat([p(sa.q.weight), p(sa.k.weight),
                                          sa.v.weight], 0))
        fused.qkv.bias.copy_(torch.cat([p(sa.q.bias), p(sa.k.bias),
                                        sa.v.bias], 0))
        fused.o = sa.o
        fused.norm_q.weight.copy_(p(sa.norm_q.weight))
        fused.norm_k.weight.copy_(p(sa.norm_k.weight))
        fused.requires_grad_(False)
        blk.self_attn = fused
    return model


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def mlp(m: MLP, x: torch.Tensor) -> torch.Tensor:
    return linear(m.fc2, F.gelu(linear(m.fc1, x), approximate="tanh"))


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=pos.device) / half)
    sinusoid = pos[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


def patchify(lin: nn.Linear, latents: torch.Tensor,
             patch_size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, F, C, H, W] -> tokens [B, F*gh*gw, dim]; feature order
    (c, ph, pw) as the reference Conv3d patch embedding."""
    B, Fr, C, H, W = latents.shape
    pt, ph, pw = patch_size
    assert pt == 1, "temporal patch is 1 in all Wan configs"
    gh, gw = H // ph, W // pw
    x = latents.permute(0, 1, 3, 4, 2)                    # [B,F,H,W,C]
    x = x.reshape(B, Fr, gh, ph, gw, pw, C)
    x = x.permute(0, 1, 2, 4, 6, 3, 5)                    # [B,F,gh,gw,C,ph,pw]
    x = x.reshape(B, Fr * gh * gw, C * ph * pw)
    return linear(lin, x)


def unpatchify(x: torch.Tensor, num_frames: int, grid: Tuple[int, int],
               patch_size: Tuple[int, int, int], out_dim: int) -> torch.Tensor:
    """tokens [B, L, pt*ph*pw*C] (feature order (pt, ph, pw, c)) ->
    [B, F, C, H, W]."""
    B = x.shape[0]
    pt, ph, pw = patch_size
    gh, gw = grid
    x = x.reshape(B, num_frames, gh, gw, pt, ph, pw, out_dim)
    x = x.permute(0, 1, 4, 7, 2, 5, 3, 6)     # [B,F,pt,C,gh,ph,gw,pw]
    return x.reshape(B, num_frames * pt, out_dim, gh * ph, gw * pw)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
             num_frames: int) -> torch.Tensor:
    """x [B, F*S, D] modulated per frame by shift/scale [B, F, 1, D]."""
    B, L, D = x.shape
    xs = x.reshape(B, num_frames, L // num_frames, D)
    xs = xs * (1 + scale.to(x.dtype)) + shift.to(x.dtype)
    return xs.reshape(B, L, D)


def gate(x: torch.Tensor, g: torch.Tensor, num_frames: int) -> torch.Tensor:
    B, L, D = x.shape
    xs = x.reshape(B, num_frames, L // num_frames, D)
    return (xs * g.to(x.dtype)).reshape(B, L, D)


# ---------------------------------------------------------------------------
# Attention layers and the block
# ---------------------------------------------------------------------------

def qkv_project(sa: SelfAttention, x: torch.Tensor, n: int, d: int,
                cos: Optional[torch.Tensor] = None,
                sin: Optional[torch.Tensor] = None):
    """q/k/v projection, QK RMS-norm and RoPE; returns [B, L, n, d] each.

    Fused params carry q/k in the split-half RoPE layout; unfused params
    keep the interleaved pairing.  q.k^T is the same either way."""
    B, L, _ = x.shape
    if sa.fused:
        q, k, v = linear(sa.qkv, x).chunk(3, dim=-1)
    else:
        q, k, v = linear(sa.q, x), linear(sa.k, x), linear(sa.v, x)
    q = rms_norm(q, sa.norm_q.weight).reshape(B, L, n, d)
    k = rms_norm(k, sa.norm_k.weight).reshape(B, L, n, d)
    v = v.reshape(B, L, n, d)
    if cos is not None:
        rope = apply_rope_split if sa.fused else apply_rope
        q = rope(q, cos, sin, out_dtype=v.dtype)
        k = rope(k, cos, sin, out_dtype=v.dtype)
    return q, k, v


def cross_attention(ca: CrossAttention, x: torch.Tensor, ctx_k: torch.Tensor,
                    ctx_v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Text cross-attention with precomputed context K/V."""
    B, L, D = x.shape
    d = D // num_heads
    q = rms_norm(linear(ca.q, x), ca.norm_q.weight).reshape(
        B, L, num_heads, d)
    out = attention(q, ctx_k, ctx_v)
    return linear(ca.o, out.reshape(B, L, D))


def precompute_context_kv(model: WanDiT, cfg, context_emb: torch.Tensor
                          ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cross-attention K/V [B, T, N, d] of an embedded context."""
    B, T, _ = context_emb.shape
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    out = []
    for blk in model.blocks:
        ca = blk.cross_attn
        k = rms_norm(linear(ca.k, context_emb),
                     ca.norm_k.weight).reshape(B, T, n, d)
        v = linear(ca.v, context_emb).reshape(B, T, n, d)
        out.append({"k": k, "v": v})
    return out


def block_forward(blk: Block, cfg, x: torch.Tensor, e: torch.Tensor,
                  self_attn_fn: Callable[[torch.Tensor], torch.Tensor],
                  ctx_kv: Dict[str, torch.Tensor],
                  num_frames: int) -> torch.Tensor:
    """One transformer block; e [B, F, 6, D] fp32."""
    e6 = blk.modulation.float()[None] + e.float()          # [B,F,6,D]
    shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = (
        e6[:, :, i:i + 1] for i in range(6))

    y = self_attn_fn(modulate(layer_norm(x, cfg.eps), shift_sa, scale_sa,
                              num_frames))
    x = x + gate(y, gate_sa, num_frames)

    xc = layer_norm(x, cfg.eps, blk.norm3.weight, blk.norm3.bias) \
        if blk.norm3 is not None else x
    x = x + cross_attention(blk.cross_attn, xc, ctx_kv["k"], ctx_kv["v"],
                            cfg.num_heads)

    y = mlp(blk.ffn, modulate(layer_norm(x, cfg.eps), shift_ff, scale_ff,
                              num_frames))
    return x + gate(y, gate_ff, num_frames)


def head_forward(head: Head, cfg, x: torch.Tensor, e: torch.Tensor,
                 num_frames: int) -> torch.Tensor:
    """Final AdaLN head; e [B, F, D] fp32."""
    e2 = head.modulation.float()[None] + e.float()[:, :, None]   # [B,F,2,D]
    shift, scale = e2[:, :, 0:1], e2[:, :, 1:2]
    return linear(head.head, modulate(layer_norm(x, cfg.eps), shift, scale,
                                      num_frames))


def time_embed(model: WanDiT, cfg, t: torch.Tensor):
    """t [B, F] -> e [B, F, D], e0 [B, F, 6, D]; fp32."""
    B, Fr = t.shape
    sin = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1))
    te = model.time_embedding
    e = linear(te.fc2, F.silu(linear(te.fc1, sin.float())))
    e0 = linear(model.time_projection.fc, F.silu(e))
    return e.reshape(B, Fr, cfg.dim), e0.reshape(B, Fr, 6, cfg.dim)


def embed_text(model: WanDiT, context: torch.Tensor) -> torch.Tensor:
    """text encoder states [B, T, text_dim] -> [B, T, dim]."""
    return mlp(model.text_embedding, context)


def randomize_head(model: WanDiT, generator: torch.Generator,
                   std: float = 0.05) -> WanDiT:
    """Give the zero-initialised output head random weights, so that a
    random-weight model predicts a non-zero flow (tests, chip smoke)."""
    w = model.head.head.weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                * std)
    return model
