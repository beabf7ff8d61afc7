"""TAEHV, the tiny video autoencoder of the fast preview.

Port of `mmpl_tpu/models/taehv.py` (the reference's `demo_utils/taehv.py`,
weights `taew2_1.pth` for Wan2.1): a small conv autoencoder whose temporal
machinery is three primitives:

  * MemBlock: three 3x3 convs over [x, the previous frame's x] with a
    residual (a 1x1 `skip` conv when the channel counts differ);
  * TPool: `stride` consecutive frames folded into channels, then a 1x1
    conv;
  * TGrow: a 1x1 conv that expands channels into `stride` output frames.

`TAEHV` is an `nn.Module` whose parameter names are the upstream
checkpoint's keys (`decoder.{i}.conv.{0,2,4}`, `.skip`, `.conv` of a
TPool / TGrow, `encoder.{i}` of a conv), so `taew2_1.pth` loads with
`load_state_dict` as it is.  Tensors are NTCHW at the public functions, as
in the JAX package; each conv runs per frame on [N*T, C, H, W] with
symmetric padding (torch's `padding=1` pads both sides even at stride 2,
which the reference relies on).  A MemBlock's "past" is the sequence
shifted by one frame with a zero in front (the reference's parallel mode);
the streaming decode carries each MemBlock's last input frame instead.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: (kind, args) rows at the indices of the upstream nn.Sequential.  kinds:
#: conv(cin, cout, stride, bias), relu, mem(cin, cout), tpool(n, stride),
#: tgrow(n, stride), upsample(scale), clamp
ENCODER_LAYOUT: Tuple = (
    ("conv", 3, 64, 1, True), ("relu",),
    ("tpool", 64, 2), ("conv", 64, 64, 2, False), ("mem", 64, 64),
    ("mem", 64, 64), ("mem", 64, 64),
    ("tpool", 64, 2), ("conv", 64, 64, 2, False), ("mem", 64, 64),
    ("mem", 64, 64), ("mem", 64, 64),
    ("tpool", 64, 1), ("conv", 64, 64, 2, False), ("mem", 64, 64),
    ("mem", 64, 64), ("mem", 64, 64),
    ("conv", 64, 16, 1, True),
)

DECODER_LAYOUT: Tuple = (
    ("clamp",), ("conv", 16, 256, 1, True), ("relu",),
    ("mem", 256, 256), ("mem", 256, 256), ("mem", 256, 256),
    ("upsample", 2), ("tgrow", 256, 1), ("conv", 256, 128, 1, False),
    ("mem", 128, 128), ("mem", 128, 128), ("mem", 128, 128),
    ("upsample", 2), ("tgrow", 128, 2), ("conv", 128, 64, 1, False),
    ("mem", 64, 64), ("mem", 64, 64), ("mem", 64, 64),
    ("upsample", 2), ("tgrow", 64, 2), ("conv", 64, 64, 1, False),
    ("relu",), ("conv", 64, 3, 1, True),
)

#: warm-up frames of the full temporal upscale (2**2 - 1) that the first
#: decoded chunk drops
FRAMES_TO_TRIM = 3


class MemBlock(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(2 * cin, cout, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1, **kw), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1, **kw))
        self.skip = (nn.Conv2d(cin, cout, 1, bias=False, **kw)
                     if cin != cout else None)


class TimeConv(nn.Module):
    """TPool / TGrow: a 1x1 conv named `conv`, as upstream."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False, **kw)


def _layer(row, **kw) -> nn.Module:
    kind = row[0]
    if kind == "conv":
        _, cin, cout, stride, bias = row
        return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias,
                         **kw)
    if kind == "mem":
        return MemBlock(row[1], row[2], **kw)
    if kind == "tpool":
        return TimeConv(row[1] * row[2], row[1], **kw)
    if kind == "tgrow":
        return TimeConv(row[1], row[1] * row[2], **kw)
    return nn.Identity()          # relu, clamp, upsample: no parameters


class TAEHV(nn.Module):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        self.encoder = nn.Sequential(*(_layer(r, **kw)
                                       for r in ENCODER_LAYOUT))
        self.decoder = nn.Sequential(*(_layer(r, **kw)
                                       for r in DECODER_LAYOUT))


@torch.no_grad()
def init_taehv_params(generator: torch.Generator, dtype=torch.float32,
                      device="cpu") -> TAEHV:
    """Random TAEHV from `generator`: each kernel uniform in +-1/sqrt(fan
    in), biases zero (the JAX package's init, not its draws)."""
    model = TAEHV(dtype=dtype, device=device)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            a = 1.0 / np.sqrt(m.in_channels * m.kernel_size[0]
                              * m.kernel_size[1])
            w = torch.rand(m.weight.shape, generator=generator,
                           device=device, dtype=torch.float32)
            m.weight.copy_((2 * w - 1) * a)
            if m.bias is not None:
                m.bias.zero_()
    return model


def _conv(p: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Per-frame conv of x [N, T, C, H, W]."""
    N, T = x.shape[:2]
    y = F.conv2d(x.reshape((N * T,) + x.shape[2:]), p.weight.to(x.dtype),
                 None if p.bias is None else p.bias.to(x.dtype),
                 stride=p.stride, padding=p.padding)
    return y.reshape((N, T) + y.shape[1:])


def _mem(p: MemBlock, x: torch.Tensor, past: torch.Tensor) -> torch.Tensor:
    c0, _, c1, _, c2 = p.conv
    h = torch.relu(_conv(c0, torch.cat([x, past], dim=2)))
    h = torch.relu(_conv(c1, h))
    h = _conv(c2, h)
    skip = _conv(p.skip, x) if p.skip is not None else x
    return torch.relu(h + skip)


def _apply_seq(layers: nn.Sequential, layout, x: torch.Tensor,
               state: Optional[List[torch.Tensor]] = None):
    """x [N, T, C, H, W] through a layout.  state None: each MemBlock's
    past frame before the first is zero (the parallel mode); else the last
    input frame each MemBlock saw in the previous chunk, in order.
    Returns (x, the state to carry)."""
    new_state: List[torch.Tensor] = []
    for p, row in zip(layers, layout):
        kind = row[0]
        if kind == "conv":
            x = _conv(p, x)
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "clamp":
            x = torch.tanh(x / 3.0) * 3.0
        elif kind == "mem":
            prev = (torch.zeros_like(x[:, :1]) if state is None
                    else state[len(new_state)][:, None].to(x.dtype))
            new_state.append(x[:, -1])
            x = _mem(p, x, torch.cat([prev, x[:, :-1]], dim=1))
        elif kind == "tpool":
            stride = row[2]
            if stride > 1:
                N, T, C, H, W = x.shape
                x = x.reshape(N, T // stride, stride * C, H, W)
            x = _conv(p.conv, x)
        elif kind == "tgrow":
            stride = row[2]
            x = _conv(p.conv, x)
            if stride > 1:
                N, T, SC, H, W = x.shape
                x = x.reshape(N, T * stride, SC // stride, H, W)
        elif kind == "upsample":
            scale = row[1]
            if scale > 1:
                N, T = x.shape[:2]
                x = F.interpolate(x.flatten(0, 1), scale_factor=scale,
                                  mode="nearest").unflatten(0, (N, T))
    return x, new_state


@torch.inference_mode()
def taehv_encode(model: TAEHV, video: torch.Tensor) -> torch.Tensor:
    """video [N, T, 3, H, W] in [0, 1] -> latents [N, T/4, 16, H/8, W/8]."""
    return _apply_seq(model.encoder, ENCODER_LAYOUT, video)[0]


@torch.inference_mode()
def taehv_decode(model: TAEHV, latents: torch.Tensor,
                 trim: bool = True) -> torch.Tensor:
    """latents [N, T, 16, h, w] -> video [N, 4T (- 3), 3, 8h, 8w] in about
    [0, 1]."""
    x = _apply_seq(model.decoder, DECODER_LAYOUT, latents)[0]
    return x[:, FRAMES_TO_TRIM:] if trim else x


@torch.inference_mode()
def taehv_decode_streaming(model: TAEHV, latents: torch.Tensor,
                           state: Optional[List[torch.Tensor]] = None):
    """Chunked decode: latents [N, T, 16, h, w] -> (video chunk, state).
    The first chunk (state None) drops the 3 warm-up frames as
    `taehv_decode` does; later chunks take the returned state and give all
    4T frames.  The chunks joined equal the whole decode."""
    x, new_state = _apply_seq(model.decoder, DECODER_LAYOUT, latents, state)
    return (x[:, FRAMES_TO_TRIM:] if state is None else x), new_state
