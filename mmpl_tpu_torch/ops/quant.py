"""int8 projections: per-channel weight codes, per-token activation codes,
the W8A8 and W8A16 products, and the two kernels behind them.

Port of `mmpl_tpu/ops/quant.py`.  The scheme (symmetric, no calibration):

  W_q[n, k] = round(W[n, k] / s_w[n]),   s_w[n] = max(max_k |W[n, k]| / 127, 1e-12)
  x_q[t, k] = round(x[t, k] / s_x[t]),   s_x[t] = max(max_k |x[t, k]| / 127, 1e-12)
  y[t, n]   = ((float(x_q @ W_q^T)_int32 * s_x[t]) * s_w[n]).to(out dtype)

Weights keep torch's `nn.Linear` layout [N, K], K contiguous: the
column-major B operand of the int8 product.  Rounding is half to even and
the divisions are true divisions (no reciprocal), as `quant.py` writes
them, so the codes equal the eager JAX package's bit for bit (a jitted
XLA program divides by 127 through its reciprocal: ROADMAP, Queue 3).

Two hand-written kernels in `csrc/int8_gemm.cu`:

  * P2, `int8_gemm`: int8 [M, K] x int8 [N, K] -> int32 accumulator, with
    the rescale epilogue; it replaces the TPU probe kernels
    `_mm_s8_kernel` / `_mm_s8_kloop_kernel` (tools/pallas_int8_mm_probe.py)
    and the XLA s8 dot of `w8a8_matmul`;
  * Q, `quantize_rows`: per-row amax, then codes and scales in one kernel
    (`quant.py:49-52`, fused by XLA on the TPU).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain version.  The plain int8 product is exact: float
matmuls of the codes over K-slices short enough that no sum rounds.
W8A16 is a library matmul over the codes cast to the activation dtype, as
XLA computes it outside any kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

#: launches of each hand-written kernel, counted where the launch succeeds
launch_counts = {"int8_gemm": 0, "quantize_rows": 0}

#: element type codes of the C interface (csrc/int8_gemm.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 3}

#: activation dtypes Q takes, output dtypes P2 writes
ACT_DTYPES = (torch.float32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def amax_scale(amax: torch.Tensor, clip: float = 127.0) -> torch.Tensor:
    """max(amax / clip, 1e-12) in fp32, by a true division: a division by
    a Python number is a multiplication by its reciprocal on CUDA tensors,
    which can differ from the quotient in the last bit."""
    return torch.clamp_min(amax / torch.full_like(amax, clip), 1e-12)


def quantize_weight(w: torch.Tensor, clip: float = 127.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 codes of w [..., N, K] (the amax
    runs over K).  Returns (int8 [..., N, K], scale f32 [..., N])."""
    wf = w.float()
    scale = amax_scale(wf.abs().amax(dim=-1), clip)
    wq = torch.clamp(torch.round(wf / scale[..., None]), -clip, clip)
    return wq.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) int8 codes of x [..., K] in fp32 arithmetic:
    (int8 [..., K], scale f32 [...])."""
    xf = x.float()
    s = amax_scale(xf.abs().amax(dim=-1))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


#: K-slice of the plain product: a sum of at most 1024 products of int8
#: codes stays within 2**24 in magnitude, so fp32 holds it exactly
_EXACT_K = 1024
#: elements of `a` the plain product turns into floats at a time
_PLAIN_ELEMS = 1 << 24


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                    sx: Optional[torch.Tensor], sw: Optional[torch.Tensor],
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a int8 [M, K] times b int8 [N, K]^T, exact: float products of the
    codes over K-slices of 1024, summed in int32 (fp32 on the CPU, fp64 on
    the card, where an fp32 product may run in TF32).  out_dtype int32
    returns the accumulator; otherwise ((float(acc) * sx[m]) *
    sw[n]).to(out_dtype), sx None meaning 1."""
    M, K = a.shape
    ft = torch.float32 if a.device.type == "cpu" else torch.float64
    bt = b.to(ft).t()
    acc = torch.zeros((M, b.shape[0]), dtype=torch.int32, device=a.device)
    rows = max(1, _PLAIN_ELEMS // max(K, 1))
    for m0 in range(0, M, rows):
        af = a[m0:m0 + rows].to(ft)
        for k0 in range(0, K, _EXACT_K):
            acc[m0:m0 + rows] += torch.matmul(
                af[:, k0:k0 + _EXACT_K], bt[k0:k0 + _EXACT_K]).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = acc.float()
    if sx is not None:
        y = y * sx[:, None]
    return (y * sw[None, :]).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _launch(fn: str, counter: str, device, *args) -> None:
    from . import _build
    lib = _build.library("int8_gemm")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: CUDA error {rc}")
    launch_counts[counter] += 1


def _check_2d(what: str, name: str, x: torch.Tensor, dtypes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} must be a CUDA tensor")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: {name} is {x.dtype}, want one of {dtypes}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                         f"aligned 2-D tensor, got {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if x.shape[1] % 16:
        raise ValueError(f"{what}: K = {x.shape[1]} is not a multiple of 16")


def _check_vec(what: str, name: str, v: torch.Tensor, n: int, device) -> None:
    if (v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous()
            or v.device != device):
        raise ValueError(f"{what}: {name} must be contiguous fp32 [{n}] on "
                         f"{device}, got {v.dtype} {tuple(v.shape)}")


def quantize_rows_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch Q (`csrc/int8_gemm.cu`) on x [M, K] (bf16 or fp32,
    contiguous, K a multiple of 16): (int8 [M, K], scale f32 [M])."""
    _check_2d("quantize_rows", "x", x, ACT_DTYPES)
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M:
        _launch("mmpl_quantize_rows", "quantize_rows", x.device,
                _DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(),
                s.data_ptr(), M, K)
    return q, s


def int8_gemm_cuda(a: torch.Tensor, b: torch.Tensor,
                   sx: Optional[torch.Tensor], sw: Optional[torch.Tensor],
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch P2 (`csrc/int8_gemm.cu`): a int8 [M, K] row-major times b
    int8 [N, K] (K contiguous, a multiple of 16).  out_dtype int32 writes
    the accumulator (sx, sw unused); fp32 or bf16 write
    (float(acc) * sx[m]) * sw[n], sx None meaning 1."""
    _check_2d("int8_gemm", "a", a, (torch.int8,))
    _check_2d("int8_gemm", "b", b, (torch.int8,))
    M, K = a.shape
    N = b.shape[0]
    if b.shape[1] != K or b.device != a.device:
        raise ValueError(f"int8_gemm: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} on {a.device}, {b.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_gemm: output dtype {out_dtype}")
    if out_dtype != torch.int32:
        if sx is not None:
            _check_vec("int8_gemm", "sx", sx, M, a.device)
        if sw is None:
            raise ValueError("int8_gemm: a scaled output needs sw")
        _check_vec("int8_gemm", "sw", sw, N, a.device)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M and N:
        scaled = out_dtype != torch.int32
        _launch("mmpl_int8_gemm", "int8_gemm", a.device,
                _DTYPE_CODES[out_dtype], a.data_ptr(), b.data_ptr(),
                sx.data_ptr() if scaled and sx is not None else None,
                sw.data_ptr() if scaled else None, out.data_ptr(), M, N, K)
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q on CUDA tensors, its plain version on CPU tensors."""
    if _on_cuda(x, "quantize_rows"):
        return quantize_rows_cuda(x)
    return quantize_rows_plain(x)


def int8_gemm(a: torch.Tensor, b: torch.Tensor, sx: Optional[torch.Tensor],
              sw: Optional[torch.Tensor],
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """P2 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cuda(a, "int8_gemm"):
        return int8_gemm_cuda(a, b, sx, sw, out_dtype)
    return int8_gemm_plain(a, b, sx, sw, out_dtype)


def w8a8_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ dequant(wq)^T with per-token dynamic activation codes.

    x [..., K] float; wq int8 [N, K]; wscale f32 [N].  Q then P2."""
    out_dtype = out_dtype or x.dtype
    K = x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, K).contiguous())
    y = int8_gemm(xq, wq, xs, wscale, out_dtype)
    return y.reshape(*x.shape[:-1], wq.shape[0])


def w8a16_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Weight-only: y = (x @ wq^T) * s_w, the codes cast to x's dtype (exact
    for |code| <= 127).  In bf16 the product is rounded to bf16 before the
    scale, where XLA keeps it fp32 until after (ROADMAP Queue 3)."""
    out_dtype = out_dtype or x.dtype
    y = torch.matmul(x, wq.to(x.dtype).t())
    return (y.float() * wscale).to(out_dtype)


# ---------------------------------------------------------------------------
# The quantised linear layer
# ---------------------------------------------------------------------------

class QuantLinear(nn.Module):
    """int8 codes of a linear layer: `weight_q` (W8A8) or `weight_w8`
    (W8A16) int8 [N, K], `scale` f32 [N] and the float `bias`; the role of
    `quantize_linear_params` (`mmpl_tpu/ops/quant.py:77`)."""

    def __init__(self, out_features: int, in_features: int,
                 weight_only: bool = False, bias: bool = True,
                 bias_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.weight_only = weight_only
        self.register_buffer(self.code_name, torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=bias_dtype, device=device),
            requires_grad=False) if bias else None

    @property
    def code_name(self) -> str:
        return "weight_w8" if self.weight_only else "weight_q"

    @property
    def codes(self) -> torch.Tensor:
        return getattr(self, self.code_name)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, weight_only: bool = False
                    ) -> "QuantLinear":
        N, K = lin.weight.shape
        bias = lin.bias
        q = cls(N, K, weight_only, bias is not None,
                bias.dtype if bias is not None else lin.weight.dtype,
                device=lin.weight.device)
        codes, scale = quantize_weight(lin.weight)
        q.codes.copy_(codes)
        q.scale.copy_(scale)
        if bias is not None:
            q.bias.copy_(bias)
        return q

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K] -> [..., N] in x's dtype, without the bias."""
        fn = w8a16_matmul if self.weight_only else w8a8_matmul
        return fn(x, self.codes, self.scale)
