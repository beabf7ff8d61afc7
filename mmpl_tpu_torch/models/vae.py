"""Wan2.1 causal 3D video VAE (encode, decode, streaming decode).

Port of `mmpl_tpu/models/vae.py` (f32, bf16 and the int8 decoder).
Public functions keep the JAX package's [B, T, C, H, W] layout; inside,
activations are torch's [B, C, T, H, W].  Parameters live in `nn.Module`s
named after the JAX tree (`decoder.up.3.resample.weight`, ...), convs with
torch-style OIDHW / OIHW weights.

`quantize_vae_decoder` turns every decoder conv (and `conv2`) into int8
codes with per-output-channel scales (`QuantConv`).  Such a conv quantises
its input with one dynamic scale per tensor and runs as an im2col of the
zero-padded codes through the int8 product P2 (`ops/quant.int8_gemm`, exact
int32 accumulation, epilogue acc * (xs * s_w)), in row chunks of at most
~1 GiB of im2col.

Causal temporal convs pad 2*(kt//2) zero frames in front.  First-frame
special cases: downsample3d passes frame 0 through and runs its stride-2
conv from frame 0; upsample3d passes frame 0 through and gives frames >= 1
zero history.  `decode_streaming` decodes one latent frame at a time with
explicit per-conv caches of the last 2 input frames, in decode order.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops.quant import amax_scale, int8_gemm, quantize_weight

LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
    dtype=np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160],
    dtype=np.float32)

VAE_DIM = 96
VAE_Z_DIM = 16
DIM_MULT = (1, 2, 4, 4)
NUM_RES_BLOCKS = 2
TEMPORAL_DOWN = (False, True, True)
CACHE_T = 2


def encoder_specs() -> List[Tuple[str, int, int]]:
    """[(kind, in_dim, out_dim)] for the encoder's down blocks."""
    dims = [VAE_DIM * u for u in (1,) + DIM_MULT]
    specs = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din
        for _ in range(NUM_RES_BLOCKS):
            specs.append(("res", d, dout))
            d = dout
        if i != len(DIM_MULT) - 1:
            kind = "downsample3d" if TEMPORAL_DOWN[i] else "downsample2d"
            specs.append((kind, dout, dout))
    return specs


def decoder_specs() -> List[Tuple[str, int, int]]:
    """[(kind, in_dim, out_dim)] for the decoder's up blocks."""
    dims = [VAE_DIM * u for u in (DIM_MULT[-1],) + DIM_MULT[::-1]]
    temporal_up = TEMPORAL_DOWN[::-1]
    specs = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        d = din // 2 if i in (1, 2, 3) else din
        for _ in range(NUM_RES_BLOCKS + 1):
            specs.append(("res", d, dout))
            d = dout
        if i != len(DIM_MULT) - 1:
            kind = "upsample3d" if temporal_up[i] else "upsample2d"
            specs.append((kind, dout, dout // 2))
    return specs


# ---------------------------------------------------------------------------
# Parameter modules
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """Conv weight (OIDHW, or OIHW for a 2D conv) and bias."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, ...], **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel, **kw))
        self.bias = nn.Parameter(torch.empty(cout, **kw))


class QuantConv(nn.Module):
    """int8 codes of a conv: `weight_q` int8 (OIDHW or OIHW), `scale` f32
    [Cout] (per output channel) and the float `bias`.  `im2col_weight()`
    keeps the codes as the im2col product's [Cout, K] matrix, built at
    first use and again after `load_state_dict`."""

    def __init__(self, shape: Tuple[int, ...], bias_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(shape, dtype=torch.int8,
                                                     device=device))
        self.register_buffer("scale", torch.ones(shape[0], dtype=torch.float32,
                                                 device=device))
        self.bias = nn.Parameter(torch.zeros(shape[0], dtype=bias_dtype,
                                             device=device),
                                 requires_grad=False)
        self.register_buffer("weight_im2col", None, persistent=False)
        self.register_load_state_dict_post_hook(QuantConv._drop_im2col)

    @staticmethod
    def _drop_im2col(module: "QuantConv", _incompatible_keys) -> None:
        module.weight_im2col = None

    def im2col_weight(self) -> torch.Tensor:
        """The codes as [Cout, K], K ordered (kt, kh, kw, C) like the
        channels-last im2col of `_int8_conv`."""
        if self.weight_im2col is None:
            w = self.weight_q if self.weight_q.ndim == 5 \
                else self.weight_q[:, :, None]
            self.weight_im2col = w.permute(0, 2, 3, 4, 1).reshape(
                w.shape[0], -1).contiguous()
        return self.weight_im2col

    @classmethod
    @torch.no_grad()
    def from_conv(cls, p: Conv) -> "QuantConv":
        w = p.weight
        q = cls(tuple(w.shape), p.bias.dtype, w.device)
        codes, scale = quantize_weight(w.reshape(w.shape[0], -1))
        q.weight_q.copy_(codes.reshape(w.shape))
        q.scale.copy_(scale)
        q.bias.copy_(p.bias)
        return q


class Gamma(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim, **kw))


class ResBlock(nn.Module):
    def __init__(self, din: int, dout: int, **kw):
        super().__init__()
        self.norm1 = Gamma(din, **kw)
        self.conv1 = Conv(din, dout, (3, 3, 3), **kw)
        self.norm2 = Gamma(dout, **kw)
        self.conv2 = Conv(dout, dout, (3, 3, 3), **kw)
        self.shortcut = Conv(din, dout, (1, 1, 1), **kw) if din != dout \
            else None


class AttnBlock(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.norm = Gamma(dim, **kw)
        self.to_qkv = Conv(dim, 3 * dim, (1, 1), **kw)
        self.proj = Conv(dim, dim, (1, 1), **kw)


class Resample(nn.Module):
    def __init__(self, kind: str, din: int, dout: int, **kw):
        super().__init__()
        self.kind = kind
        self.resample = Conv(din, dout, (3, 3), **kw)
        if kind == "downsample3d":
            self.time_conv = Conv(din, din, (3, 1, 1), **kw)
        elif kind == "upsample3d":
            self.time_conv = Conv(din, 2 * din, (3, 1, 1), **kw)
        else:
            self.time_conv = None


def _block(spec, **kw) -> nn.Module:
    kind, din, dout = spec
    return ResBlock(din, dout, **kw) if kind == "res" \
        else Resample(kind, din, dout, **kw)


class Encoder(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        dims = [VAE_DIM * u for u in (1,) + DIM_MULT]
        e_out = dims[-1]
        self.conv1 = Conv(3, dims[0], (3, 3, 3), **kw)
        self.down = nn.ModuleList(_block(s, **kw) for s in encoder_specs())
        self.middle = nn.ModuleList([ResBlock(e_out, e_out, **kw),
                                     AttnBlock(e_out, **kw),
                                     ResBlock(e_out, e_out, **kw)])
        self.head_norm = Gamma(e_out, **kw)
        self.head_conv = Conv(e_out, 2 * VAE_Z_DIM, (3, 3, 3), **kw)


class Decoder(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        d0 = VAE_DIM * DIM_MULT[-1]
        self.conv1 = Conv(VAE_Z_DIM, d0, (3, 3, 3), **kw)
        self.middle = nn.ModuleList([ResBlock(d0, d0, **kw),
                                     AttnBlock(d0, **kw),
                                     ResBlock(d0, d0, **kw)])
        self.up = nn.ModuleList(_block(s, **kw) for s in decoder_specs())
        self.head_norm = Gamma(VAE_DIM, **kw)
        self.head_conv = Conv(VAE_DIM, 3, (3, 3, 3), **kw)


class WanVAE(nn.Module):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.encoder = Encoder(**kw)
        self.conv1 = Conv(2 * VAE_Z_DIM, 2 * VAE_Z_DIM, (1, 1, 1), **kw)
        self.conv2 = Conv(VAE_Z_DIM, VAE_Z_DIM, (1, 1, 1), **kw)
        self.decoder = Decoder(**kw)
        self.requires_grad_(False)


def empty_vae(dtype=torch.float32, device="cpu") -> WanVAE:
    return WanVAE(dtype, device="meta").to_empty(device=device)


@torch.no_grad()
def quantize_vae_decoder(vae: WanVAE) -> WanVAE:
    """int8-quantise every decoder conv and the post-latent `conv2`, in
    place (W8A8: per-output-channel weight scales, per-tensor dynamic
    activation scales); the encoder is untouched.  `decode` and
    `decode_streaming` share the conv dispatch."""
    for parent in [vae, *vae.decoder.modules()]:
        for name, child in list(parent.named_children()):
            if isinstance(child, Conv) and (parent is not vae
                                            or name == "conv2"):
                setattr(parent, name, QuantConv.from_conv(child))
    return vae


@torch.no_grad()
def init_vae_params(generator: torch.Generator, dtype=torch.float32,
                    device="cpu") -> WanVAE:
    """Random VAE: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) conv weights and
    biases, unit gammas, zero attention output projections."""
    vae = empty_vae(dtype, device)
    for m in vae.modules():
        if isinstance(m, Conv):
            a = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                p.copy_(torch.empty(p.shape, device=device).uniform_(
                    -a, a, generator=generator))
        elif isinstance(m, Gamma):
            m.gamma.fill_(1.0)
    for m in vae.modules():
        if isinstance(m, AttnBlock):
            m.proj.weight.zero_()
    return vae


# ---------------------------------------------------------------------------
# Primitive layers (x [B, C, T, H, W])
# ---------------------------------------------------------------------------

def _add_bias(y: torch.Tensor, p: Conv) -> torch.Tensor:
    """Bias added after the conv in the activation dtype, as the JAX
    package does (a bias fused into a bf16 conv rounds differently)."""
    return y + p.bias.to(y.dtype)[None, :, None, None, None]


#: int8 convs run and the im2col row chunks (P2 launches on the card) they
#: took, counted at the conv dispatch
int8_conv_counts = {"convs": 0, "chunks": 0}

#: bytes of int8 im2col one P2 call takes at most (~1 GiB)
IM2COL_BYTES = 1 << 30

#: profiler ranges of an int8 conv's parts besides P2: the activation
#: codes, the im2col copies, the copy of each product into the output
INT8_CONV_RANGES = ("vae.int8_conv.quantize", "vae.int8_conv.im2col",
                    "vae.int8_conv.scatter")


def _quant_act(x: torch.Tensor):
    """One dynamic int8 scale for the whole tensor: per-token scales do not
    fit a conv, whose every output mixes kt*kh*kw positions."""
    xf = x.float()
    xs = amax_scale(xf.abs().amax())
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def _row_blocks(To: int, Ho: int, row_bytes: int):
    """(t0, t1, h0, h1) blocks of output rows whose im2col fits
    IM2COL_BYTES: whole frames where a frame fits, else rows of one."""
    frame = Ho * row_bytes
    if frame <= IM2COL_BYTES:
        step = IM2COL_BYTES // frame
        for t0 in range(0, To, step):
            yield t0, min(t0 + step, To), 0, Ho
        return
    step = max(1, IM2COL_BYTES // row_bytes)
    for t0 in range(To):
        for h0 in range(0, Ho, step):
            yield t0, t0 + 1, h0, min(h0 + step, Ho)


def _int8_conv(p: QuantConv, x: torch.Tensor, stride, pads) -> torch.Tensor:
    """x [B, C, T, H, W] conv the int8 weight, zero pads (t front, h, w):
    the exact integer conv of the codes as im2col products through P2.
    The im2col is channels-last, K ordered (kt, kh, kw, C), so that its
    copy moves whole runs of C codes."""
    quantize, im2col, scatter = INT8_CONV_RANGES
    with record_function(quantize):
        xq, xs = _quant_act(x)
    Cout, Cin, *ks = p.weight_q.shape
    kt, kh, kw = ks if len(ks) == 3 else (1, *ks)
    t_pad, ph, pw = pads
    with record_function(im2col):
        xq = F.pad(xq, (pw, pw, ph, ph, t_pad, 0)).permute(0, 2, 3, 4, 1)
        cols = xq.contiguous().unfold(1, kt, stride[0]).unfold(
            2, kh, stride[1]).unfold(3, kw, stride[2]).permute(
                0, 1, 2, 3, 5, 6, 7, 4)             # [B,To,Ho,Wo,kt,kh,kw,C]
    B, To, Ho, Wo = cols.shape[:4]
    K = Cin * kt * kh * kw
    wm = p.im2col_weight()
    sw = xs * p.scale                      # the epilogue's acc * (xs * s_w)
    out = torch.empty((B, To, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    int8_conv_counts["convs"] += 1
    for b in range(B):
        for t0, t1, h0, h1 in _row_blocks(To, Ho, Wo * K):
            with record_function(im2col):
                a = cols[b, t0:t1, h0:h1].reshape(-1, K)
            y = int8_gemm(a, wm, None, sw, x.dtype)
            with record_function(scatter):
                out[b, t0:t1, h0:h1] = y.reshape(t1 - t0, h1 - h0, Wo, Cout)
            int8_conv_counts["chunks"] += 1
    return out.permute(0, 4, 1, 2, 3)


def _conv3d(p, x: torch.Tensor, stride=(1, 1, 1), t_pad=None) -> torch.Tensor:
    """Causal 3D conv: t_pad (default 2*(kt//2)) zero frames in front,
    spatial SAME; int8 for a `QuantConv`."""
    kt, kh, kw = (p.weight_q if isinstance(p, QuantConv)
                  else p.weight).shape[2:]
    t_pad = 2 * (kt // 2) if t_pad is None else t_pad
    if isinstance(p, QuantConv):
        return _add_bias(_int8_conv(p, x, stride, (t_pad, kh // 2, kw // 2)),
                         p)
    if t_pad:
        x = F.pad(x, (0, 0, 0, 0, t_pad, 0))
    y = F.conv3d(x, p.weight.to(x.dtype), stride=stride,
                 padding=(0, kh // 2, kw // 2))
    return _add_bias(y, p)


def _conv2d(p, x: torch.Tensor, stride: int = 1,
            same: bool = True) -> torch.Tensor:
    """Per-frame 2D conv, as a conv3d with a temporal extent of 1; int8
    for a `QuantConv`."""
    kh, kw = (p.weight_q if isinstance(p, QuantConv)
              else p.weight).shape[2:]
    pad = (0, kh // 2, kw // 2) if same else (0, 0, 0)
    if isinstance(p, QuantConv):
        return _add_bias(_int8_conv(p, x, (1, stride, stride), pad), p)
    y = F.conv3d(x, p.weight.to(x.dtype)[:, :, None],
                 stride=(1, stride, stride), padding=pad)
    return _add_bias(y, p)


def _rms_norm(p: Gamma, x: torch.Tensor) -> torch.Tensor:
    """F.normalize over channels * sqrt(C) * gamma, in fp32."""
    C = x.shape[1]
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    y = xf / torch.clamp(n, min=1e-12) * math.sqrt(C)
    g = p.gamma.to(x.dtype).float()[None, :, None, None, None]
    return (y * g).to(x.dtype)


def _norm_silu(p: Gamma, x: torch.Tensor) -> torch.Tensor:
    """silu(_rms_norm(x)) computed in fp32 and rounded once (XLA keeps the
    fused norm + silu in fp32 too)."""
    C = x.shape[1]
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    y = xf / torch.clamp(n, min=1e-12) * math.sqrt(C)
    g = p.gamma.to(x.dtype).float()[None, :, None, None, None]
    return F.silu(y * g).to(x.dtype)


def _res_block(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = _conv3d(p.shortcut, x) if p.shortcut is not None else x
    y = _conv3d(p.conv1, _norm_silu(p.norm1, x))
    return _conv3d(p.conv2, _norm_silu(p.norm2, y)) + h


def _attn_block(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    """Single-head per-frame spatial attention."""
    B, C, T, H, W = x.shape
    qkv = _conv2d(p.to_qkv, _rms_norm(p.norm, x))          # [B,3C,T,H,W]
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(B * T, H * W, 3, C)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(C)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.matmul(probs, v).reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
    return _conv2d(p.proj, o) + x


def _upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


def _spatial_downsample(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """ZeroPad2d((0,1,0,1)) + 3x3 stride-2 conv."""
    return _conv2d(p, F.pad(x, (0, 1, 0, 1)), stride=2, same=False)


def _unpack_time_pairs(z: torch.Tensor, C: int) -> torch.Tensor:
    """[B, 2C, t, H, W] (channel = half*C + c) -> [B, C, 2t, H, W] with the
    half-0 frame first."""
    B, _, t, H, W = z.shape
    z = z.reshape(B, 2, C, t, H, W).permute(0, 2, 3, 1, 4, 5)
    return z.reshape(B, C, 2 * t, H, W)


def _temporal_upsample_full(p: Conv, x: torch.Tensor) -> torch.Tensor:
    C = x.shape[1]
    z = _unpack_time_pairs(_conv3d(p, x[:, :, 1:]), C)
    return torch.cat([x[:, :, :1], z], dim=2)


def _temporal_downsample_full(p: Conv, x: torch.Tensor) -> torch.Tensor:
    y = _add_bias(F.conv3d(x, p.weight.to(x.dtype), stride=(2, 1, 1)), p)
    return torch.cat([x[:, :, :1], y], dim=2)


def _apply_block(blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(blk, ResBlock):
        return _res_block(blk, x)
    if isinstance(blk, AttnBlock):
        return _attn_block(blk, x)
    if blk.kind == "downsample2d":
        return _spatial_downsample(blk.resample, x)
    if blk.kind == "downsample3d":
        x = _spatial_downsample(blk.resample, x)
        return _temporal_downsample_full(blk.time_conv, x)
    if blk.kind == "upsample2d":
        return _conv2d(blk.resample, _upsample_nearest2x(x))
    if blk.kind == "upsample3d":
        x = _temporal_upsample_full(blk.time_conv, x)
        return _conv2d(blk.resample, _upsample_nearest2x(x))
    raise ValueError(blk.kind)


def encoder_forward(p: Encoder, x: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, T, H, W] -> raw mu/logvar [B, 2z, T', H/8, W/8]."""
    x = _conv3d(p.conv1, x)
    for blk in p.down:
        x = _apply_block(blk, x)
    x = _res_block(p.middle[0], x)
    x = _attn_block(p.middle[1], x)
    x = _res_block(p.middle[2], x)
    x = _norm_silu(p.head_norm, x)
    return _conv3d(p.head_conv, x)


def decoder_forward(p: Decoder, z: torch.Tensor) -> torch.Tensor:
    """latents [B, z, T, h, w] -> pixels [B, 3, 1+4(T-1), 8h, 8w]."""
    x = _conv3d(p.conv1, z)
    x = _res_block(p.middle[0], x)
    x = _attn_block(p.middle[1], x)
    x = _res_block(p.middle[2], x)
    for blk in p.up:
        x = _apply_block(blk, x)
    x = _norm_silu(p.head_norm, x)
    return _conv3d(p.head_conv, x)


def _stats(like: torch.Tensor):
    shape = (1, VAE_Z_DIM, 1, 1, 1)
    mean = torch.as_tensor(LATENT_MEAN, device=like.device).to(like.dtype)
    std = torch.as_tensor(LATENT_STD, device=like.device).to(like.dtype)
    return mean.reshape(shape), std.reshape(shape)


@torch.inference_mode()
def encode(vae: WanVAE, pixels: torch.Tensor) -> torch.Tensor:
    """[B, T_pix, 3, H, W] -> normalised latents [B, T_lat, 16, H/8, W/8]."""
    out = encoder_forward(vae.encoder, pixels.permute(0, 2, 1, 3, 4))
    out = _conv3d(vae.conv1, out)
    mean, std = _stats(out)
    mu = (out[:, :VAE_Z_DIM] - mean) / std
    return mu.permute(0, 2, 1, 3, 4)


@torch.inference_mode()
def decode(vae: WanVAE, latents: torch.Tensor,
           clamp: bool = True) -> torch.Tensor:
    """[B, T_lat, 16, h, w] -> pixels [B, T_pix, 3, 8h, 8w] in [-1, 1]."""
    z = latents.permute(0, 2, 1, 3, 4)
    mean, std = _stats(z)
    z = _conv3d(vae.conv2, z * std + mean)
    x = decoder_forward(vae.decoder, z)
    if clamp:
        x = torch.clamp(x, -1.0, 1.0)
    return x.permute(0, 2, 1, 3, 4)


# ---------------------------------------------------------------------------
# Streaming decode (one latent frame at a time, explicit conv caches)
# ---------------------------------------------------------------------------

def _stream_causal_conv(p: Conv, x: torch.Tensor, cache: torch.Tensor):
    full = torch.cat([cache, x], dim=2)
    return _conv3d(p, full, t_pad=0), full[:, :, -CACHE_T:]


def _stream_res_block(p: ResBlock, x: torch.Tensor, caches: list):
    h = _conv3d(p.shortcut, x) if p.shortcut is not None else x
    y = _norm_silu(p.norm1, x)
    y, c0 = _stream_causal_conv(p.conv1, y, caches[0])
    y = _norm_silu(p.norm2, y)
    y, c1 = _stream_causal_conv(p.conv2, y, caches[1])
    return y + h, [c0, c1]


def _stream_temporal_upsample(p: Conv, x: torch.Tensor, cache: torch.Tensor,
                              is_first: bool):
    if is_first:
        return x, cache
    full = torch.cat([cache, x], dim=2)
    y = _unpack_time_pairs(_conv3d(p, full, t_pad=0), x.shape[1])
    return y, full[:, :, -CACHE_T:]


def init_decoder_cache(vae: WanVAE, batch: int, lat_h: int, lat_w: int,
                       dtype=torch.float32, device="cpu"
                       ) -> List[torch.Tensor]:
    """Zero caches [B, C, 2, h, w], in decode traversal order."""
    caches = []

    def conv_cache(cin, h, w):
        caches.append(torch.zeros((batch, cin, CACHE_T, h, w), dtype=dtype,
                                  device=device))

    d0 = VAE_DIM * DIM_MULT[-1]
    h, w = lat_h, lat_w
    conv_cache(VAE_Z_DIM, h, w)
    for _ in range(2):
        conv_cache(d0, h, w)
        conv_cache(d0, h, w)
    for kind, din, dout in decoder_specs():
        if kind == "res":
            conv_cache(din, h, w)
            conv_cache(dout, h, w)
        elif kind == "upsample3d":
            conv_cache(din, h, w)
            h, w = h * 2, w * 2
        elif kind == "upsample2d":
            h, w = h * 2, w * 2
    conv_cache(VAE_DIM, h, w)
    return caches


def _decode_chunk(vae: WanVAE, z: torch.Tensor, caches: List[torch.Tensor],
                  is_first: bool):
    """One latent chunk [B, z, t, h, w] -> pixel frames + new caches."""
    p = vae.decoder
    it = iter(caches)
    new = []
    x, c = _stream_causal_conv(p.conv1, z, next(it))
    new.append(c)
    x, cs = _stream_res_block(p.middle[0], x, [next(it), next(it)])
    new.extend(cs)
    x = _attn_block(p.middle[1], x)
    x, cs = _stream_res_block(p.middle[2], x, [next(it), next(it)])
    new.extend(cs)
    for blk in p.up:
        if isinstance(blk, ResBlock):
            x, cs = _stream_res_block(blk, x, [next(it), next(it)])
            new.extend(cs)
        elif blk.kind == "upsample3d":
            x, c = _stream_temporal_upsample(blk.time_conv, x, next(it),
                                             is_first)
            new.append(c)
            x = _conv2d(blk.resample, _upsample_nearest2x(x))
        else:
            x = _conv2d(blk.resample, _upsample_nearest2x(x))
    x = _norm_silu(p.head_norm, x)
    x, c = _stream_causal_conv(p.head_conv, x, next(it))
    new.append(c)
    return x, new


@torch.inference_mode()
def decode_streaming(vae: WanVAE, latents: torch.Tensor,
                     clamp: bool = True) -> torch.Tensor:
    """Frame-streaming decode, identical to `decode`:
    [B, T, 16, h, w] -> [B, 1+4(T-1), 3, 8h, 8w]."""
    B, T, C, H, W = latents.shape
    z = latents.permute(0, 2, 1, 3, 4)
    mean, std = _stats(z)
    z = _conv3d(vae.conv2, z * std + mean)
    caches = init_decoder_cache(vae, B, H, W, z.dtype, z.device)
    outs = []
    for t in range(T):
        px, caches = _decode_chunk(vae, z[:, :, t:t + 1], caches,
                                   is_first=(t == 0))
        outs.append(px)
    out = torch.cat(outs, dim=2)
    if clamp:
        out = torch.clamp(out, -1.0, 1.0)
    return out.permute(0, 2, 1, 3, 4)


@torch.inference_mode()
def decode_to_frames(vae: WanVAE, latents: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Production decode: bf16 streaming decode to display-ready frames.

    Weights and latents run in bf16 (weights are cast at each conv; an
    int8 conv's scales stay f32).
    Returns (frames [B, T, H, W, 3] uint8, tail [B, 5, 3, H, W] fp32 in
    [-1, 1], the causal suffix the inter-window bridge re-encodes).
    """
    out32 = decode_streaming(vae, latents.to(torch.bfloat16)).float()
    u8 = torch.round((out32 * 0.5 + 0.5) * 255.0).to(torch.uint8)
    return u8.permute(0, 1, 3, 4, 2).contiguous(), out32[:, -5:]
