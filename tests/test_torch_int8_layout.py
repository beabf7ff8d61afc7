"""The host's choices for P2 and Q (`ops/quant.py`): P2's tile width
(`p2_tile_n`) and Q's layout (`q_row_warps`) at every shape that
`chip_smoke.py` holds the kernels to (`INT8_SHAPES`) and at every int8
conv of the VAE decoder; the int8 conv's profiler ranges.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import ast
import math
import pathlib

import numpy as np
import pytest
import torch

from mmpl_tpu_torch.models import vae
from mmpl_tpu_torch.ops import quant

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke_int8_shapes():
    """`chip_smoke.INT8_SHAPES`, read from the source (importing the
    script needs the card)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text(encoding="utf-8"))
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "INT8_SHAPES"):
            return eval(compile(ast.Expression(node.value), "chip_smoke.py",
                                "eval"), {"torch": torch})
    raise AssertionError("chip_smoke.py has no INT8_SHAPES")


SMOKE_SHAPES = _chip_smoke_int8_shapes()


def _decoder_convs():
    """(name, K, N) of every conv that `quantize_vae_decoder` makes int8:
    the decoder's and the post-latent conv2, K their im2col depth."""
    model = vae.WanVAE(device="meta")
    convs = [("conv2", model.conv2)] + [
        (f"decoder.{n}", m) for n, m in model.decoder.named_modules()
        if isinstance(m, vae.Conv)]
    return [(name, math.prod(m.weight.shape[1:]), m.weight.shape[0])
            for name, m in convs]


DECODER_CONVS = _decoder_convs()


def test_the_smoke_shapes_cover_the_dit_and_the_vae():
    labels = {s[0] for s in SMOKE_SHAPES}
    assert {"g23_fc1", "g23_fc2", "g0_o", "vae_96ch", "vae_head",
            "vae_conv2", "vae_conv1"} <= labels
    assert {(K, N) for _, K, N in DECODER_CONVS} >= {
        (s[2], s[3]) for s in SMOKE_SHAPES if s[0].startswith("vae_")}


def _covers(N: int, tile: int) -> None:
    assert tile in quant.P2_TILE_N
    if N <= quant.P2_TILE_N[0]:
        # one tile a row panel, and no narrower tile would cover N
        assert tile >= N and (tile == quant.P2_TILE_N[-1] or tile // 2 < N)
    else:
        padded = lambda t: -(-N // t) * t
        assert tile in quant.P2_TILE_N[:2]
        assert padded(tile) == min(padded(t) for t in quant.P2_TILE_N[:2])


@pytest.mark.parametrize("label,M,K,N,act,out", SMOKE_SHAPES,
                         ids=[s[0] for s in SMOKE_SHAPES])
def test_tile_and_layout_cover_each_smoke_shape(label, M, K, N, act, out):
    tile = quant.p2_tile_n(N)
    _covers(N, tile)
    if label.startswith("g"):       # the DiT's widths fill their tiles
        assert N % tile == 0 and tile == 256
    assert K % 16 == 0
    if act is not None:             # Q reads each of these rows once
        warps = quant.q_row_warps(K)
        assert warps in (1, quant.Q_ROW_WARPS)
        assert K <= 32 * warps * quant.Q_THREAD_ELEMS


@pytest.mark.parametrize("name,K,N", DECODER_CONVS,
                         ids=[c[0] for c in DECODER_CONVS])
def test_tile_covers_each_decoder_conv(name, K, N):
    assert K % 16 == 0, "P2 takes K in multiples of 16"
    _covers(N, quant.p2_tile_n(N))


@pytest.mark.parametrize("N,tile", [(3, 16), (16, 16), (17, 32), (96, 128),
                                    (192, 256), (200, 256), (256, 256),
                                    (384, 128), (640, 128), (1536, 256),
                                    (4608, 256), (8960, 256), (8961, 128)])
def test_tile_width(N, tile):
    assert quant.p2_tile_n(N) == tile


@pytest.mark.parametrize("K,warps", [(16, 1), (1536, 1), (2048, 1),
                                     (2064, 8), (8960, 8), (16384, 8),
                                     (16400, 0)])
def test_q_layout_by_row_length(K, warps):
    assert quant.q_row_warps(K) == warps


def test_int8_conv_marks_its_parts_for_the_profiler():
    """The ranges chip_smoke's int8 decode profile reads: the activation
    codes, the im2col copies and the output copies of each int8 conv."""
    from torch.profiler import ProfilerActivity, profile
    conv = vae.Conv(16, 8, (3, 3, 3))
    torch.nn.init.uniform_(conv.weight, -0.1, 0.1)
    torch.nn.init.uniform_(conv.bias, -0.1, 0.1)
    q = vae.QuantConv.from_conv(conv)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 2, 4, 5)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vae._conv3d(q, x)
    keys = {e.key for e in prof.key_averages()}
    assert set(vae.INT8_CONV_RANGES) <= keys
