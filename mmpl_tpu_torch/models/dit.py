"""Wan DiT layers for the planned-window serving path and training.

Port of `mmpl_tpu/models/dit.py`: the layers that the FPS pipeline, the
teacher-forcing trainer and the whole-clip pipelines (`pipelines/
wan_reference.py`) run, for the t2v DiT and its i2v variant (the CLIP
image projection `img_emb` and the image keys and values `k_img` / `v_img`
of each cross-attention).
Parameters live in `nn.Module`s whose names mirror the JAX parameter tree
(`blocks.<i>.self_attn.qkv.weight`, ...), so `utils/jax_params.py` maps one
onto the other.  Linear weights are torch-style [out, in].  Layers are
plain functions over those modules, as in the JAX package:

  * `linear` casts the weight to the activation dtype, or runs the int8
    product of a `QuantLinear` (`quantize_params`, `ops/quant.py`);
  * norms compute in fp32 and cast back;
  * the AdaLN modulation runs in fp32, `modulate`/`gate` cast shift, scale
    and gate to the activation dtype.

Parameters do not require gradients unless a trainer turns them on
(`training/diffusion.py`).  `call_with` runs a layer function over a cast
copy of a module's parameters (the trainer's bf16 trunk over fp32
masters), and `remat` recomputes a block in the backward pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.quant import QuantLinear
from ..ops.rope import (apply_rope, apply_rope_split, split_rope_permutation,
                        window_rope_table)


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
    """Text cross-attention; with `image`, also the i2v image keys and
    values (`k_img`, `v_img`, `norm_k_img`)."""

    def __init__(self, dim: int, image: bool = False, **kw):
        super().__init__()
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)
        self.norm_q = Affine(dim, **kw)
        self.norm_k = Affine(dim, **kw)
        if image:
            self.k_img = nn.Linear(dim, dim, **kw)
            self.v_img = nn.Linear(dim, dim, **kw)
            self.norm_k_img = Affine(dim, **kw)


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
        self.cross_attn = CrossAttention(d, image=cfg.model_type == "i2v",
                                         **kw)
        self.ffn = MLP(d, cfg.ffn_dim, d, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 6, d, **kw))
        self.norm3 = Affine(d, bias=True, **kw) if cfg.cross_attn_norm \
            else None

    def forward(self, fn, *args, **kwargs):
        """fn(self, *args, **kwargs): the layer functions run through the
        module's call, so that its hooks (an FSDP unit's gather of its
        parameters, `parallel/mesh.shard_for_training`) wrap them."""
        return fn(self, *args, **kwargs)


class TimeProjection(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.fc = nn.Linear(dim, 6 * dim, **kw)


class Head(nn.Module):
    def __init__(self, dim: int, out: int, **kw):
        super().__init__()
        self.head = nn.Linear(dim, out, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 2, dim, **kw))


#: width of the CLIP ViT-H/14 image tokens that `img_emb` projects
CLIP_DIM = 1280


class ImageEmbedding(nn.Module):
    """MLPProj of the i2v DiT: LayerNorm, fc1, GELU, fc2, LayerNorm."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.norm1 = Affine(CLIP_DIM, bias=True, **kw)
        self.fc1 = nn.Linear(CLIP_DIM, CLIP_DIM, **kw)
        self.fc2 = nn.Linear(CLIP_DIM, dim, **kw)
        self.norm2 = Affine(dim, bias=True, **kw)


class WanDiT(nn.Module):
    """Parameter container of the Wan DiT (t2v, or i2v with `img_emb`)."""

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
        self.img_emb = ImageEmbedding(d, **kw) \
            if cfg.model_type == "i2v" else None
        self.requires_grad_(False)

    forward = Block.forward


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


#: `remat` under another name, for the functions whose flag is `remat`
_remat = remat


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
    i2v = model.img_emb is not None
    for blk in model.blocks:
        ca = blk.cross_attn
        for lin in (blk.self_attn.q, blk.self_attn.k, blk.self_attn.v,
                    blk.self_attn.o, ca.q, ca.k, ca.v, ca.o, blk.ffn.fc1,
                    blk.ffn.fc2) + ((ca.k_img, ca.v_img) if i2v else ()):
            _init_linear(lin, g)
        for nrm in (blk.self_attn.norm_q, blk.self_attn.norm_k, ca.norm_q,
                    ca.norm_k) + ((ca.norm_k_img,) if i2v else ()):
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
    if i2v:
        ie = model.img_emb
        _init_linear(ie.fc1, g)
        _init_linear(ie.fc2, g)
        for nrm in (ie.norm1, ie.norm2):
            nrm.weight.fill_(1.0)
            nrm.bias.zero_()
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
# int8 projections (ops/quant.py)
# ---------------------------------------------------------------------------

#: the block projections that quantise; cross-attention k/v run once per
#: window (`precompute_context_kv`) and stay float, as do attention, the
#: norms, AdaLN, the head and the embeddings
AUTO_QUANT_TARGETS = ("self_attn.qkv", "self_attn.o", "cross_attn.q",
                      "cross_attn.o", "ffn.fc1", "ffn.fc2")

#: report of the most recent `auto_quantize` (policy and measured errors)
last_auto_quantize_report: dict = {}


def _target_slots(model: WanDiT, policy: Dict[str, str]):
    """(parent module, attribute, mode) of each float block projection that
    `policy` ({target: "int8" | "int8wo"}) names; a target the blocks do
    not have (qkv when not fused) is skipped."""
    for blk in model.blocks:
        for tgt, mode in policy.items():
            mod, name = tgt.split(".")
            parent = getattr(blk, mod)
            if isinstance(getattr(parent, name, None), nn.Linear):
                yield parent, name, mode


@torch.no_grad()
def quantize_params_mixed(model: WanDiT, policy: Dict[str, str]) -> WanDiT:
    """Replace each projection that `policy` names by its `QuantLinear`
    (W8A8 for "int8", W8A16 for "int8wo"), in place; the float weights are
    dropped, not kept beside the codes."""
    for parent, name, mode in list(_target_slots(model, policy)):
        setattr(parent, name, QuantLinear.from_linear(
            getattr(parent, name), weight_only=mode == "int8wo"))
    return model


def quantize_params(model: WanDiT, weight_only: bool = False) -> WanDiT:
    """int8-quantise the block projections AUTO_QUANT_TARGETS (W8A8, or
    W8A16 with `weight_only`), in place, once at load, after
    `fuse_qkv_params`."""
    mode = "int8wo" if weight_only else "int8"
    return quantize_params_mixed(model, dict.fromkeys(AUTO_QUANT_TARGETS,
                                                      mode))


@contextlib.contextmanager
def _quantized(model: WanDiT, policy: Dict[str, str]):
    """The model with `policy` applied inside the block; the float
    projections are put back on exit."""
    saved = [(parent, name, getattr(parent, name))
             for parent, name, _ in _target_slots(model, policy)]
    try:
        yield quantize_params_mixed(model, policy)
    finally:
        for parent, name, lin in saved:
            setattr(parent, name, lin)


@torch.no_grad()
def auto_quantize(model: WanDiT, cfg, rel_threshold: float = 0.03,
                  probe_frames: int = 3, probe_hw: Tuple[int, int] = (16, 16),
                  seed: int = 0):
    """Per-projection W8A8 / W8A16 policy from the loaded weights, applied
    in place.

    For each target, only that projection is quantised W8A8 and the
    relative error of a bidirectional forward (`dit_forward`) on a small
    random probe is measured; targets within `rel_threshold` run W8A8, the
    rest W8A16.  A zero head (the reference init) would make every error
    vacuous, so the probe then runs with a fixed random head, put back to
    zero afterwards.  Returns (model, report); the report is also kept in
    `last_auto_quantize_report`."""
    global last_auto_quantize_report
    dtype = model.blocks[0].modulation.dtype
    device = model.blocks[0].modulation.device
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    head = model.head.head.weight
    random_head = not bool(head.any())
    hh, ww = probe_hw
    x = torch.randn((1, probe_frames, cfg.in_dim, hh, ww), generator=gen(
        seed + 1), device=device).to(dtype)
    t = torch.full((1, probe_frames), 500.0, device=device)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen(
        seed + 2), device=device).to(dtype)

    def rel_err(policy):
        with _quantized(model, policy):
            got = dit_forward(model, cfg, x, t, ctx).double()
        return ((got - ref).norm() / max(ref.norm().item(), 1e-12)).item()

    try:
        if random_head:
            head.copy_(torch.randn(head.shape, generator=gen(99),
                                   device=device) * 0.05)
        ref = dit_forward(model, cfg, x, t, ctx).double()
        policy, errs = {}, {}
        for tgt in AUTO_QUANT_TARGETS:
            if next(_target_slots(model, {tgt: "int8"}), None) is None:
                continue
            errs[tgt] = rel_err({tgt: "int8"})
            policy[tgt] = "int8" if errs[tgt] <= rel_threshold else "int8wo"
        mixed_rel = rel_err(policy)
    finally:
        if random_head:
            head.zero_()
    quantize_params_mixed(model, policy)
    report = {"policy": policy, "per_target_rel_err": errs,
              "mixed_rel_err": mixed_rel, "rel_threshold": rel_threshold,
              "probed_with_random_head": random_head}
    last_auto_quantize_report = report
    print(f"auto-quantize: policy={policy} mixed_rel={mixed_rel:.4f} "
          f"(threshold {rel_threshold})", file=sys.stderr, flush=True)
    return model, report


def apply_quantize(model: WanDiT, quantize: Optional[str],
                   cfg=None) -> WanDiT:
    """quantize in {None, "int8", "int8wo", "auto"}, in place; "auto" runs
    `auto_quantize` (needs cfg)."""
    if quantize is None:
        return model
    if quantize in ("int8", "int8wo"):
        return quantize_params(model, weight_only=quantize == "int8wo")
    if quantize == "auto":
        if cfg is None:
            raise ValueError("quantize='auto' needs the model cfg")
        return auto_quantize(model, cfg)[0]
    raise ValueError(f"quantize={quantize!r} (int8, int8wo or auto)")


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def linear(lin: nn.Module, x: torch.Tensor, group=None) -> torch.Tensor:
    """x @ W^T + b.  With `group` (a row-parallel projection of a
    tensor-parallel model: o, fc2) the ranks' partial products are summed
    across the group before the bias."""
    if isinstance(lin, QuantLinear):
        y = lin.matmul(x)
    else:
        y = torch.matmul(x, lin.weight.to(x.dtype).t())
    if group is not None:
        y = group.all_reduce(y)
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6, group=None) -> torch.Tensor:
    """RMS norm over the last dim; with `group` (a tensor-parallel group
    whose ranks each hold a slice of that dim, as the QK-norms of a
    head-sharded model do) over the whole width, the sum of squares
    reduced across the group."""
    xf = x.float()
    if group is None:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ms = group.all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True)) \
            / (x.shape[-1] * group.size)
    normed = xf * torch.rsqrt(ms + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerSharding:
    """How the layers of a model sharded for inference run
    (`parallel/mesh.shard_params_for_inference` returns it, and the
    sampling pipelines pass it in `cfg.sharding`; absent, the layers run
    whole).  tp: the ranks the heads and the ffn are split over;
    tp_group: their group (a `parallel/collectives` group), over which the
    row-parallel projections (o, fc2) sum their partial products and the
    QK-norms their sums of squares, None for tp = 1; unshard(blk): the
    block's parameters gathered across fsdp ({name: tensor}), or None."""
    tp: int = 1
    tp_group: object = None
    unshard: Optional[Callable] = None


#: the layers of a model that is not sharded
WHOLE = LayerSharding()


def sharding_of(cfg) -> LayerSharding:
    """The `LayerSharding` of a sharded model's cfg, else `WHOLE`."""
    return cfg.get("sharding", WHOLE)


def run_block(blk: Block, fn, *args, dtype: Optional[torch.dtype] = None,
              unshard: Optional[Callable] = None):
    """fn(blk, *args) through the block's call (`Block.forward`); with
    `dtype`, over its parameters cast to dtype (the bf16 trunk over fp32
    masters; a recomputation in the backward pass reads the same cast
    values); with `unshard` (`LayerSharding.unshard`), over the block's
    parameters gathered across fsdp."""
    if unshard is not None:
        return call_with(blk, unshard(blk), fn, *args)
    if dtype is None:
        return blk(fn, *args)
    return blk(lambda b, *a: call_with(b, cast_params(b, dtype), fn, *a),
               *args)


def local_heads(cfg) -> int:
    """Attention heads of this rank: all of them, or 1/tp of them in a
    model sharded over tp ranks (`cfg.sharding`)."""
    return cfg.num_heads // sharding_of(cfg).tp


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


def mlp(m: MLP, x: torch.Tensor, group=None) -> torch.Tensor:
    """fc2(gelu(fc1(x))); `group`: fc2's tensor-parallel group."""
    return linear(m.fc2, F.gelu(linear(m.fc1, x), approximate="tanh"),
                  group)


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
                sin: Optional[torch.Tensor] = None, group=None):
    """q/k/v projection, QK RMS-norm and RoPE; returns [B, L, n, d] each.

    Fused params carry q/k in the split-half RoPE layout; unfused params
    keep the interleaved pairing.  q.k^T is the same either way.  group:
    the tensor-parallel group of a head-sharded model (the QK-norms')."""
    B, L, _ = x.shape
    if sa.fused:
        q, k, v = linear(sa.qkv, x).chunk(3, dim=-1)
    else:
        q, k, v = linear(sa.q, x), linear(sa.k, x), linear(sa.v, x)
    q = rms_norm(q, sa.norm_q.weight, group=group).reshape(B, L, n, d)
    k = rms_norm(k, sa.norm_k.weight, group=group).reshape(B, L, n, d)
    v = v.reshape(B, L, n, d)
    if cos is not None:
        rope = apply_rope_split if sa.fused else apply_rope
        q = rope(q, cos, sin, out_dtype=v.dtype)
        k = rope(k, cos, sin, out_dtype=v.dtype)
    return q, k, v


def cross_attention(ca: CrossAttention, x: torch.Tensor, ctx_k: torch.Tensor,
                    ctx_v: torch.Tensor, num_heads: int,
                    img_k: Optional[torch.Tensor] = None,
                    img_v: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """Text cross-attention with precomputed context K/V; with `img_k` /
    `img_v` (i2v) a second attention over the image tokens is added.
    num_heads: this rank's heads (`local_heads`); group: the
    tensor-parallel group of a head-sharded model."""
    B, L, _ = x.shape
    q = rms_norm(linear(ca.q, x), ca.norm_q.weight, group=group)
    q = q.reshape(B, L, num_heads, q.shape[-1] // num_heads)
    out = attention(q, ctx_k, ctx_v)
    if img_k is not None:
        out = out + attention(q, img_k, img_v)
    return linear(ca.o, out.reshape(B, L, -1), group)


def precompute_context_kv(model: WanDiT, cfg, context_emb: torch.Tensor,
                          img_emb: Optional[torch.Tensor] = None
                          ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cross-attention K/V [B, T, N, d] of an embedded context;
    with `img_emb` [B, Ti, D] (i2v) also `k_img` / `v_img` [B, Ti, N, d]."""
    B, T, _ = context_emb.shape
    n, d = local_heads(cfg), cfg.dim // cfg.num_heads
    sh = sharding_of(cfg)

    def kv_of(blk: Block) -> Dict[str, torch.Tensor]:
        ca = blk.cross_attn
        k = rms_norm(linear(ca.k, context_emb), ca.norm_k.weight,
                     group=sh.tp_group).reshape(B, T, n, d)
        v = linear(ca.v, context_emb).reshape(B, T, n, d)
        kv = {"k": k, "v": v}
        if img_emb is not None:
            Ti = img_emb.shape[1]
            kv["k_img"] = rms_norm(
                linear(ca.k_img, img_emb), ca.norm_k_img.weight,
                group=sh.tp_group).reshape(B, Ti, n, d)
            kv["v_img"] = linear(ca.v_img, img_emb).reshape(B, Ti, n, d)
        return kv

    return [run_block(blk, kv_of, unshard=sh.unshard)
            for blk in model.blocks]


def block_forward(blk: Block, cfg, x: torch.Tensor, e: torch.Tensor,
                  self_attn_fn: Callable[[torch.Tensor], torch.Tensor],
                  ctx_kv: Dict[str, torch.Tensor],
                  num_frames: int) -> torch.Tensor:
    """One transformer block; e [B, F, 6, D] fp32.  The cross-attention
    and the ffn run sharded where `cfg.sharding` says so; self_attn_fn
    takes care of its own."""
    sh = sharding_of(cfg)
    e6 = blk.modulation.float()[None] + e.float()          # [B,F,6,D]
    shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = (
        e6[:, :, i:i + 1] for i in range(6))

    y = self_attn_fn(modulate(layer_norm(x, cfg.eps), shift_sa, scale_sa,
                              num_frames))
    x = x + gate(y, gate_sa, num_frames)

    xc = layer_norm(x, cfg.eps, blk.norm3.weight, blk.norm3.bias) \
        if blk.norm3 is not None else x
    x = x + cross_attention(blk.cross_attn, xc, ctx_kv["k"], ctx_kv["v"],
                            cfg.num_heads // sh.tp, ctx_kv.get("k_img"),
                            ctx_kv.get("v_img"), sh.tp_group)

    y = mlp(blk.ffn, modulate(layer_norm(x, cfg.eps), shift_ff, scale_ff,
                              num_frames), sh.tp_group)
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


def embed_image_clip(model: WanDiT, clip_fea: torch.Tensor) -> torch.Tensor:
    """CLIP image tokens [B, 257, 1280] -> [B, 257, dim] (MLPProj, exact
    GELU, LayerNorms at eps 1e-5)."""
    p = model.img_emb
    x = layer_norm(clip_fea, 1e-5, p.norm1.weight, p.norm1.bias)
    x = linear(p.fc2, F.gelu(linear(p.fc1, x), approximate="none"))
    return layer_norm(x, 1e-5, p.norm2.weight, p.norm2.bias)


def randomize_head(model: WanDiT, generator: torch.Generator,
                   std: float = 0.05) -> WanDiT:
    """Give the zero-initialised output head random weights, so that a
    random-weight model predicts a non-zero flow (tests, chip smoke)."""
    w = model.head.head.weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                * std)
    return model


# ---------------------------------------------------------------------------
# Bidirectional forward
# ---------------------------------------------------------------------------

def dit_forward(model: WanDiT, cfg, latents: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor,
                clip_fea: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None,
                remat: bool = False,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The bidirectional Wan DiT: latents [B, F, C, H, W], t [B] or
    [B, F], context [B, T, text_dim] -> flow [B, F, C_out, H, W].  Every
    token attends every token of the window; RoPE runs at frames 0..F-1.
    i2v: `clip_fea` [B, 257, 1280] CLIP image tokens (the image
    cross-attention), `y` [B, F, C', H, W] concatenated to the latents
    along channels before the patch embedding.  remat=True recomputes
    each block in the backward pass (the score models and the flow
    objective, which train through this forward); it changes no value.
    compute_dtype: the parameters are read cast to it (the bf16 trunk over
    fp32 masters, grads flowing back through the cast): the embeddings and
    the head here, each block's inside its own (recomputed) step, so that
    the recomputation reads the same cast values."""
    if compute_dtype is None:
        return _dit_forward(model, cfg, latents, t, context, clip_fea, y,
                            remat, None)
    outer = {n: p.to(compute_dtype) for n, p in model.named_parameters()
             if not n.startswith("blocks.")}
    return call_with(model, outer, _dit_forward, cfg, latents, t, context,
                     clip_fea, y, remat, compute_dtype)


def _dit_forward(model, cfg, latents, t, context, clip_fea, y, remat,
                 block_dtype):
    if y is not None:
        latents = torch.cat([latents, y.to(latents.dtype)], dim=2)
    B, Fr, C, H, W = latents.shape
    grid = (H // cfg.patch_size[1], W // cfg.patch_size[2])
    n, d = cfg.num_heads, cfg.dim // cfg.num_heads
    x = patchify(model.patch_embedding, latents, cfg.patch_size)
    if t.ndim == 1:
        t = t[:, None]
    e, e0 = time_embed(model, cfg, t.expand(B, Fr))
    img = embed_image_clip(model, clip_fea.to(x.dtype)) \
        if clip_fea is not None else None
    ctx_kv = precompute_context_kv(model, cfg,
                                   embed_text(model, context.to(x.dtype)), img)
    cos_np, sin_np = window_rope_table(Fr, grid[0], grid[1], d)
    cos = torch.as_tensor(cos_np, device=x.device)
    sin = torch.as_tensor(sin_np, device=x.device)

    def block_fn(x, blk, ckv):
        def self_attn_fn(xm):
            q, k, v = qkv_project(blk.self_attn, xm, n, d, cos, sin)
            return linear(blk.self_attn.o,
                          attention(q, k, v).reshape(B, xm.shape[1], -1))
        return block_forward(blk, cfg, x, e0, self_attn_fn, ckv, Fr)

    for blk, ckv in zip(model.blocks, ctx_kv):
        step = lambda x, blk=blk, ckv=ckv: run_block(
            blk, lambda b, x: block_fn(x, b, ckv), x, dtype=block_dtype)
        x = _remat(step, x) if remat else step(x)
    x = head_forward(model.head, cfg, x, e, Fr)
    return unpatchify(x, Fr, grid, cfg.patch_size, cfg.out_dim)
