"""Attention: the flash kernels K1-K6, their plain versions and the dispatch.

Port of `mmpl_tpu/ops/attention.py`.  Layout is [B, L, N, D] throughout.

  * `flash_attention` is unmasked softmax attention, differentiable: K1
    (`csrc/flash_fwd.cu`) forward, K2 / K3 (`csrc/flash_bwd.cu`) backward.
    MMPL inference needs no mask (the planned visibility is a gather of
    whole frames, `models/fps_dit.py`); training's cross-attention runs it
    too.  In bf16 / fp16, K1 runs the Hopper body of
    `csrc/flash_fwd_sm90.cuh` (wgmma, TMA, a producer warpgroup and two
    consumer warpgroups, exp2 softmax); fp32 runs the FMA
    template body of `flash_fwd.cu`.  The same holds for K2 / K3: bf16 /
    fp16 run the Hopper body of `csrc/flash_bwd_sm90.cuh`, whose dKV splits
    each key block's query loop over `bwd_query_splits` blocks where the key
    blocks alone would not fill the card; fp32 runs the template body of
    `flash_bwd.cu`.
  * `flash_attention_exp2` is P1, the exp2 probe's forward (O only, exp or
    exp2, with or without the in-kernel pad test), on the same two bodies;
    no path of the model runs it, `mmpl_tpu_torch.tools.exp2_probe`
    measures it against K1.
  * `frame_masked_attention` is the training self-attention under a
    frame-granular mask (token i attends token j iff
    frame_mask[q_frame_ids[i], kv_frame_ids[j]]): K4 forward, K5 / K6
    backward.  Whole tiles that the mask forbids are skipped through tile
    tables built on the device (`mask_tiles`): 64x64 (`tile_table`) for
    the fp32 template, pooled to 128x128 for the Hopper K4 and K6 and to
    64x128 for the Hopper K5, which run in bf16 / fp16 as masked
    instantiations of K1's, K3's and K2's bodies.

On CUDA tensors each wrapper launches its hand-written kernel or raises; on
CPU tensors the same `autograd.Function`s run the plain versions, forward
and backward (exact fp32, in query-row chunks).  There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from fractions import Fraction
from typing import List, NamedTuple, Optional, Tuple

import torch

#: guards `launch_counts`: the chunk pipeline's stages launch from threads
_count_lock = threading.Lock()
#: launches of each hand-written kernel, counted where the launch succeeds
launch_counts = {"flash_fwd": 0, "flash_masked_fwd": 0, "flash_bwd_dkv": 0,
                 "flash_bwd_dq": 0, "flash_masked_bwd_dkv": 0,
                 "flash_masked_bwd_dq": 0, "flash_exp2": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: rows of the template body's Q, K and V tiles (csrc/flash_common.cuh
#: TILE): the frame mask's tile table and P1's `mask_pad=False` contract
#: are in these units (the Hopper body's 128-key tiles are right for any
#: multiple of 64)
TILE = 64

#: log2(e), folded into K1's scale and P1's by its exp2 variants
LOG2E = 1.4426950408889634

#: the Hopper bodies' mask tiles in units of TILE (queries, keys): K4's
#: 128 x 128 (csrc/flash_fwd_sm90.cuh kBlockM, kBlockN), which K6 reads too
#: (csrc/flash_bwd_sm90.cuh kQueryBlock, kKeyTile), and K5's 64-query
#: tiles of a 128-key block (csrc/flash_bwd_sm90.cuh kQueryTile, kKeyBlock)
FWD_MASK_TILE = (2, 2)
DKV_MASK_TILE = (1, 2)
#: the `MaskTiles` table that each Hopper masked kernel reads, by part
COARSE_TABLE = {"fwd": "fwd", "dkv": "dkv", "dq": "fwd"}
#: frames whose [F, F] table the Hopper K4 / K5 / K6 hold in shared memory
#: (csrc/sm90_common.cuh kMaxFrames)
SM90_MAX_FRAMES = 192

#: bytes of fp32 scores the plain versions hold at once (~1 GiB)
_PLAIN_SCORE_BYTES = 1 << 30

#: the Hopper backward's dKV block (keys) and the query tile it streams
#: (csrc/flash_bwd_sm90.cuh kKeyBlock, kQueryTile)
BWD_KEY_BLOCK = 128
BWD_QUERY_TILE = 64
#: the dKV query split's limits: splits, query tiles per split, and bytes of
#: the fp32 partials (counted at the widest head dim, 128)
BWD_MAX_SPLITS = 16
BWD_MIN_SPLIT_TILES = 4
BWD_MAX_WORKSPACE = 64 << 20


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def bwd_query_splits(B: int, N: int, Lq: int, Lk: int, sms: int) -> int:
    """How many blocks share each key block's query loop in the Hopper dKV
    kernel (K2 in bf16 / fp16).  1 where the key blocks, B * N *
    ceil(Lk / 128), fill the card's `sms` SMs.  Else the s whose grid
    finishes in the fewest waves per unit of work, ceil(blocks * s / sms) /
    s (ties to the smaller s), with s <= BWD_MAX_SPLITS, at least
    BWD_MIN_SPLIT_TILES query tiles a split, and the fp32 partials
    (2 * s * B * N * Lk * 128 * 4 bytes) within BWD_MAX_WORKSPACE."""
    blocks = B * N * -(-Lk // BWD_KEY_BLOCK)
    tiles = -(-Lq // BWD_QUERY_TILE)
    most = min(BWD_MAX_SPLITS, tiles // BWD_MIN_SPLIT_TILES,
               BWD_MAX_WORKSPACE // max(1, 2 * B * N * Lk * 128 * 4))
    if blocks >= sms or most < 2:
        return 1
    return min(range(1, most + 1),
               key=lambda s: (Fraction(-(-blocks * s // sms), s), s))


def bwd_split_rows(Lq: int, splits: int) -> List[Tuple[int, int]]:
    """The query rows [start, end) of each split, as the dKV kernel deals
    them: split z takes the query tiles [z * T // splits, (z + 1) * T //
    splits) of the T = ceil(Lq / 64), the last one ragged."""
    tiles = -(-Lq // BWD_QUERY_TILE)
    edge = lambda z: min(z * tiles // splits * BWD_QUERY_TILE, Lq)
    return [(edge(z), edge(z + 1)) for z in range(splits)]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention; fp32 softmax, probabilities cast to v's dtype.

    `mask` is boolean, broadcastable to [B, N, Lq, Lk]; True = attend.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    scores = torch.einsum("bqnd,bknd->bnqk", qf, k.float())
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Plain versions (exact fp32, query-row chunks)
# ---------------------------------------------------------------------------

def _row_chunks(B: int, N: int, Lq: int, Lk: int):
    rows = max(1, _PLAIN_SCORE_BYTES // (4 * B * N * max(Lk, 1)))
    return range(0, Lq, rows), rows


def _allowed(mask, s: int, rows: int) -> Optional[torch.Tensor]:
    """[r, Lk] bool token mask of query rows s..s+rows, or None."""
    if mask is None:
        return None
    q_ids, kv_ids, fm = mask
    return fm[q_ids[s:s + rows].long()][:, kv_ids.long()]


def _plain_fwd(q, k, v, scale, mask=None):
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    kf = k.float().permute(0, 2, 3, 1)                 # [B, N, D, Lk]
    vf = v.float().permute(0, 2, 1, 3)                 # [B, N, Lk, D]
    starts, rows = _row_chunks(B, N, Lq, Lk)
    outs, lses = [], []
    for s in starts:
        qc = q[:, s:s + rows].float().permute(0, 2, 1, 3)   # [B, N, r, D]
        scores = torch.matmul(qc, kf) * scale               # [B, N, r, Lk]
        allowed = _allowed(mask, s, rows)
        if allowed is not None:
            scores = scores.masked_fill(~allowed, -math.inf)
        m = scores.amax(dim=-1, keepdim=True)
        shift = torch.where(m == -math.inf, torch.zeros_like(m), m)
        p = torch.exp(scores - shift)                       # exp(-inf) = 0
        del scores
        l = p.sum(dim=-1, keepdim=True)
        lsafe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append((torch.matmul(p, vf) / lsafe).permute(0, 2, 1, 3))
        lse = m + torch.log(lsafe)
        lses.append(torch.where(m == -math.inf, m, lse)[..., 0])
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out, torch.cat(lses, dim=-1)


def _plain_bwd(q, k, v, do, lse, delta, scale, mask=None):
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    kf = k.float().permute(0, 2, 1, 3)                 # [B, N, Lk, D]
    vf = v.float().permute(0, 2, 1, 3)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    starts, rows = _row_chunks(B, N, Lq, Lk)
    for s in starts:
        qc = q[:, s:s + rows].float().permute(0, 2, 1, 3)   # [B, N, r, D]
        doc = do[:, s:s + rows].float().permute(0, 2, 1, 3)
        lc = lse[:, :, s:s + rows, None]
        live = lc != -math.inf
        scores = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        p = torch.exp(scores - torch.where(live, lc, torch.zeros_like(lc)))
        del scores
        keep = live if mask is None else live & _allowed(mask, s, rows)
        p = torch.where(keep, p, torch.zeros_like(p))
        dv += torch.matmul(p.transpose(-1, -2), doc)
        ds = p * (torch.matmul(doc, vf.transpose(-1, -2))
                  - delta[:, :, s:s + rows, None])
        del p
        dqs.append((scale * torch.matmul(ds, kf)).permute(0, 2, 1, 3))
        dk += scale * torch.matmul(ds.transpose(-1, -2), qc)
    dq = torch.cat(dqs, dim=1).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 softmax attention, the plain version of K1.

    Computes in chunks of query rows so that the fp32 scores held at once
    stay near 1 GiB (at B=2, N=12, Lk=32760 that is 341 rows).  Returns
    (O [B, Lq, N, D] in q's dtype, lse [B, N, Lq] fp32).
    """
    return _plain_fwd(q, k, v, _scale(q, scale))


def flash_attention_bwd_plain(q, k, v, do, lse, delta, scale=None):
    """The plain version of K2 and K3: (dq, dk, dv) of softmax attention
    from the saved lse and delta = rowsum(dO * O), both [B, N, Lq] fp32."""
    return _plain_bwd(q, k, v, do, lse, delta, _scale(q, scale))


def frame_masked_attention_plain(q, k, v, q_frame_ids, kv_frame_ids,
                                 frame_mask, scale=None):
    """The plain version of K4: (O, lse) under the frame mask; a row that
    sees no key gets O = 0 and lse = -inf."""
    mask = _as_mask(q_frame_ids, kv_frame_ids, frame_mask, q.device)
    _check_frame_ids(*mask)
    return _plain_fwd(q, k, v, _scale(q, scale), mask)


def frame_masked_attention_bwd_plain(q, k, v, do, lse, delta, q_frame_ids,
                                     kv_frame_ids, frame_mask, scale=None):
    """The plain version of K5 and K6: (dq, dk, dv) under the frame mask;
    p is 0 on forbidden pairs and on rows whose lse is -inf."""
    mask = _as_mask(q_frame_ids, kv_frame_ids, frame_mask, q.device)
    _check_frame_ids(*mask)
    return _plain_bwd(q, k, v, do, lse, delta, _scale(q, scale), mask)


def _check_mask_pad(Lk: int, mask_pad: bool) -> None:
    if not mask_pad and Lk % TILE:
        raise ValueError(f"flash_exp2: mask_pad=False needs Lk a multiple "
                         f"of the {TILE}-key tile, got Lk={Lk} (the pad "
                         f"test is what masks the last tile's keys)")


def flash_attention_exp2_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, use_exp2: bool = True,
                               mask_pad: bool = True,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The plain version of P1: O [B, Lq, N, D] in q's dtype.  fp32 scores
    in query-row chunks, times scale (times log2(e) with `use_exp2`, then
    exp2 in place of exp); P rounded to v's dtype before the PV product,
    which accumulates in fp32, then divided by the fp32 row sum.
    `mask_pad` changes nothing here (there is no padded tile) but is
    refused where the kernel refuses it."""
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    _check_mask_pad(Lk, mask_pad)
    sc = _scale(q, scale) * (LOG2E if use_exp2 else 1.0)
    kf = k.float().permute(0, 2, 3, 1)                 # [B, N, D, Lk]
    vf = v.float().permute(0, 2, 1, 3)                 # [B, N, Lk, D]
    starts, rows = _row_chunks(B, N, Lq, Lk)
    outs = []
    for s in starts:
        qc = q[:, s:s + rows].float().permute(0, 2, 1, 3)   # [B, N, r, D]
        scores = torch.matmul(qc, kf) * sc
        scores -= scores.amax(dim=-1, keepdim=True)
        p = torch.exp2(scores) if use_exp2 else torch.exp(scores)
        del scores
        l = p.sum(dim=-1, keepdim=True)
        lsafe = torch.where(l == 0, torch.ones_like(l), l)
        pv = torch.matmul(p.to(v.dtype).float(), vf)
        outs.append((pv / lsafe).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# The frame mask on the device
# ---------------------------------------------------------------------------

def _as_mask(q_frame_ids, kv_frame_ids, frame_mask, device):
    """(q ids int32 [Lq], kv ids int32 [Lk], mask bool [F, F]) on `device`;
    the kernels read the bool table as bytes (0 or 1)."""
    conv = lambda a, dt: torch.as_tensor(a, device=device).to(
        dt).contiguous()
    return (conv(q_frame_ids, torch.int32), conv(kv_frame_ids, torch.int32),
            conv(frame_mask, torch.bool))


def _check_frame_ids(q_frame_ids, kv_frame_ids, frame_mask) -> None:
    """Refuse frame ids outside [0, F): the kernels index the [F, F] table
    with them unchecked.  One device sync; run where the table is built."""
    ids = torch.cat([q_frame_ids.reshape(-1), kv_frame_ids.reshape(-1)])
    if ids.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(ids)).tolist()
    F = frame_mask.shape[0]
    if lo < 0 or hi >= F:
        raise ValueError(f"frame ids span [{lo}, {hi}], outside [0, {F}) "
                         f"of the [{F}, {F}] frame mask")


def _presence(ids: torch.Tensor, F: int) -> torch.Tensor:
    """[ceil(L/TILE), F] fp32: 1 where frame f has a token in the tile."""
    n = -(-ids.numel() // TILE)
    p = torch.zeros((n, F), dtype=torch.float32, device=ids.device)
    tiles = torch.arange(ids.numel(), device=ids.device) // TILE
    p[tiles, ids.long()] = 1.0
    return p


def tile_table(q_frame_ids: torch.Tensor, kv_frame_ids: torch.Tensor,
               frame_mask: torch.Tensor) -> torch.Tensor:
    """uint8 [ceil(Lq/64), ceil(Lk/64)] over the kernels' 64x64 tiles:
    0 = no frame pair in the tile is allowed (skipped), 1 = some are (each
    pair tested), 2 = all are (no test).  Built vectorised on the ids'
    device from the per-tile frame presence P_q, P_k: a tile admits a pair
    iff (P_q fm P_k^T) > 0, and forbids none iff (P_q ~fm P_k^T) == 0.
    The table belongs to these ids, this mask and TILE; build it with them
    (`fps_forward_train` does so once per forward for all layers).  It
    refuses ids outside [0, F), so a table it returned vouches for them."""
    _check_frame_ids(q_frame_ids, kv_frame_ids, frame_mask)
    F = frame_mask.shape[0]
    pq = _presence(q_frame_ids, F)
    pk = _presence(kv_frame_ids, F)
    fm = frame_mask.to(device=pq.device, dtype=torch.float32)
    some = (pq @ fm @ pk.t()) > 0
    every = (pq @ (1.0 - fm) @ pk.t()) == 0
    return torch.where(some, torch.where(every, 2, 1), 0).to(torch.uint8)


def pool_tiles(table: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A tile table over tiles of `rows` x `cols` of `table`'s tiles: 0
    iff every tile within is 0, 2 iff every one is 2, else 1 (the ragged
    last row and column pool the tiles they hold).  Exact, not just
    conservative: the 64x64 classes already match the token-level mask."""
    nq, nk = table.shape
    pad = (0, -nk % cols, 0, -nq % rows)

    def pooled(x: torch.Tensor, fill: int, reduce) -> torch.Tensor:
        x = torch.nn.functional.pad(x.to(torch.uint8), pad, value=fill)
        return reduce(x.view(x.shape[0] // rows, rows, x.shape[1] // cols,
                             cols), dim=(1, 3)).bool()

    some = pooled(table != 0, 0, torch.amax)
    every = pooled(table == 2, 1, torch.amin)
    return torch.where(some, torch.where(every, 2, 1), 0).to(torch.uint8)


class MaskTiles(NamedTuple):
    """The tile tables of one frame mask and its ids (`mask_tiles`):
    `t64` is `tile_table` (64 x 64 tiles: K4-K6 in fp32), `fwd` pools it
    to the bf16 / fp16 K4's and K6's 128 x 128 tiles and `dkv` to the
    bf16 / fp16 K5's 64 x 128, stored key-block major ([ceil(Lk/128),
    ceil(Lq/64)]: one contiguous row a key block)."""
    t64: torch.Tensor
    fwd: torch.Tensor
    dkv: torch.Tensor


def mask_tiles(q_frame_ids: torch.Tensor, kv_frame_ids: torch.Tensor,
               frame_mask: torch.Tensor) -> MaskTiles:
    """Every tile table the masked kernels read, built on the ids' device
    (`tile_table`, which refuses ids outside [0, F), pooled by
    `pool_tiles`).  Build them once with the ids and mask they belong to
    (`fps_forward_train` does so once per forward for all layers)."""
    t64 = tile_table(q_frame_ids, kv_frame_ids, frame_mask)
    return MaskTiles(t64, pool_tiles(t64, *FWD_MASK_TILE),
                     pool_tiles(t64, *DKV_MASK_TILE).t().contiguous())


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_operand(what: str, name: str, x: torch.Tensor,
                   dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise ValueError(f"{what}: {name} is {x.dtype}, q is {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"{what}: {name} needs a contiguous head dim")
    vec = 16 // x.element_size()
    if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
        raise ValueError(f"{what}: {name} must be 16-byte aligned with "
                         f"strides that are multiples of {vec} elements")


def _check_qkv(what: str, q, k, v) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: q, k and v must be CUDA tensors")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    if D % 8 or not 0 < D <= 128:
        raise ValueError(f"{what}: head dim {D} unsupported (a multiple of "
                         f"8 up to 128)")
    if k.shape != (B, Lk, N, D) or v.shape != k.shape or Lk == 0:
        raise ValueError(f"{what}: bad shapes {q.shape} {k.shape} {v.shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(what, name, x, q.dtype)


def _strides(*xs) -> list:
    return [s for x in xs for s in x.stride()[:3]]


def _mask_args(what: str, mask, tiles, Lq: int, Lk: int, device,
               coarse: str, hopper: bool = False):
    """The mask arguments of a masked entry: the ids, the frame table, the
    64 x 64 table, the `coarse` table of `tiles` ("fwd" or "dkv") and F.
    `hopper`: the call runs a Hopper body, which holds the frame table in
    shared memory."""
    q_ids, kv_ids, fm = mask
    if not isinstance(tiles, MaskTiles):
        raise ValueError(f"{what}: tiles must be the MaskTiles of "
                         f"mask_tiles, got {type(tiles).__name__}")
    if q_ids.shape != (Lq,) or kv_ids.shape != (Lk,):
        raise ValueError(f"{what}: frame ids {tuple(q_ids.shape)} "
                         f"{tuple(kv_ids.shape)} for Lq={Lq}, Lk={Lk}")
    if fm.ndim != 2 or fm.shape[0] != fm.shape[1]:
        raise ValueError(f"{what}: frame mask must be [F, F], got "
                         f"{tuple(fm.shape)}")
    nq, nk = -(-Lq // TILE), -(-Lk // TILE)
    cq, ck = -(-nq // FWD_MASK_TILE[0]), -(-nk // FWD_MASK_TILE[1])
    dq, dk = -(-nq // DKV_MASK_TILE[0]), -(-nk // DKV_MASK_TILE[1])
    for name, x, want in (("t64", tiles.t64, (nq, nk)),
                          ("fwd", tiles.fwd, (cq, ck)),
                          ("dkv", tiles.dkv, (dk, dq))):
        if tuple(x.shape) != want or x.dtype != torch.uint8:
            raise ValueError(f"{what}: tile table {name} {tuple(x.shape)} "
                             f"{x.dtype}, want {want} uint8")
    if fm.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{what}: frame mask is {fm.dtype}, want bool")
    if hopper and fm.shape[0] > SM90_MAX_FRAMES:
        raise ValueError(f"{what}: {fm.shape[0]} frames; the bf16 / fp16 "
                         f"kernel holds at most {SM90_MAX_FRAMES}")
    for x in (q_ids, kv_ids, fm, *tiles):
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{what}: mask tensors must be contiguous on "
                             f"{device}")
    return [q_ids.data_ptr(), kv_ids.data_ptr(), fm.data_ptr(),
            tiles.t64.data_ptr(), getattr(tiles, coarse).data_ptr(),
            fm.shape[0]]


#: the Hopper body's own return codes (csrc/flash_fwd_sm90.cuh)
_LAUNCH_ERRORS = {-1: "cuTensorMapEncodeTiled is not available",
                  -2: "cuTensorMapEncodeTiled refused an operand's TMA map"}


def _launch(lib_name: str, fn: str, counter: str, device, *args) -> None:
    from . import _build
    lib = _build.library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{counter} launch failed: {why}")
    with _count_lock:
        launch_counts[counter] += 1


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None, mask=None,
                   tiles: Optional[MaskTiles] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 (or, with `mask` = (q ids, kv ids, frame mask) and its
    `tiles` from `mask_tiles`, K4) from `csrc/flash_fwd.cu` on CUDA
    tensors.

    q [B, Lq, N, D], k/v [B, Lk, N, D]; fp32, bf16 or fp16 with D a
    multiple of 8 up to 128.  Returns (O, lse [B, N, Lq]), lse in natural
    log.  bf16 / fp16 run the Hopper body (K4 over `tiles.fwd`, up to
    SM90_MAX_FRAMES frames), fp32 the template body (K4 over `tiles.t64`).
    K1 takes its scale with log2(e) folded in (its softmax is exp2); K4's
    entry takes the natural scale."""
    what = "flash_fwd" if mask is None else "flash_masked_fwd"
    _check_qkv(what, q, k, v)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    scale = _scale(q, scale)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, N, Lq), dtype=torch.float32, device=q.device)
    if Lq == 0:
        return o, lse
    head = [_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr()]
    tail = [B, Lq, Lk, N, D] + _strides(q, k, v, o)
    if mask is None:
        _launch("flash_fwd", "mmpl_flash_fwd", what, q.device, *head, *tail,
                float(scale * LOG2E))
    else:
        margs = _mask_args(what, mask, tiles, Lq, Lk, q.device,
                           COARSE_TABLE["fwd"], q.dtype != torch.float32)
        _launch("flash_fwd", "mmpl_flash_masked_fwd", what, q.device,
                *head, *margs, *tail, float(scale))
    return o, lse


def flash_exp2_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    use_exp2: bool = True, mask_pad: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch P1 from `csrc/flash_fwd.cu` on CUDA tensors (bf16 / fp16 on
    the Hopper body, fp32 on the template body); operands as
    `flash_fwd_cuda`.  Returns O; `mask_pad=False` needs Lk a multiple of
    64."""
    what = "flash_exp2"
    _check_qkv(what, q, k, v)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    _check_mask_pad(Lk, mask_pad)
    sc = _scale(q, scale) * (LOG2E if use_exp2 else 1.0)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if Lq == 0:
        return o
    _launch("flash_fwd", "mmpl_flash_exp2", what, q.device,
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), int(use_exp2), int(mask_pad), B, Lq, Lk, N, D,
            *_strides(q, k, v, o), float(sc))
    return o


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_mask_args(part: str, mask, tiles, Lq: int, Lk: int, device,
                   dtype: torch.dtype) -> list:
    """The mask arguments of the masked dKV (K5, `part` = "dkv") or dQ
    (K6, "dq") entry: both take their coarse table (`COARSE_TABLE`), which
    bf16 / fp16 read on the Hopper body (so F is held to SM90_MAX_FRAMES);
    fp32 reads the 64 x 64 one."""
    return _mask_args(f"flash_masked_bwd_{part}", mask, tiles, Lq, Lk,
                      device, COARSE_TABLE[part], dtype != torch.float32)


def _bwd_launch(part: str, q, k, v, do, lse, delta, outs, scale, mask,
                tiles) -> None:
    """Launch the dKV (`part` = "dkv", outs = (dk, dv)) or dQ ("dq",
    outs = (dq,)) kernel of `csrc/flash_bwd.cu`, masked with `mask` and its
    `tiles` (`_bwd_mask_args`).  The unmasked bf16 / fp16 dKV takes its
    query split (`bwd_query_splits`) and, when it splits, an fp32 workspace
    for the partials; the masked one (K5) never splits."""
    masked = mask is not None
    what = "flash_masked_bwd" if masked else "flash_bwd"
    _check_qkv(what, q, k, v)
    if not do.is_cuda or do.shape != q.shape:
        raise ValueError(f"{what}: dO {tuple(do.shape)} must be a CUDA "
                         f"tensor of q's shape")
    _check_operand(what, "dO", do, q.dtype)
    B, Lq, N, D = q.shape
    Lk = k.shape[1]
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (B, N, Lq) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{what}: {name} must be contiguous fp32 "
                             f"[B, N, Lq] on {q.device}")
    if Lq == 0:
        for x in outs:
            x.zero_()
        return
    margs = (_bwd_mask_args(part, mask, tiles, Lq, Lk, q.device, q.dtype)
             if masked else [])
    split = []
    if part == "dkv" and not masked:
        splits = (1 if q.dtype == torch.float32 else bwd_query_splits(
            B, N, Lq, Lk, _sm_count(q.device.index)))
        ws = (torch.empty((2, splits, B, N, Lk, D), dtype=torch.float32,
                          device=q.device) if splits > 1 else None)
        split = [None if ws is None else ws.data_ptr(), splits]
    ins = [_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
           do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    strides = _strides(q, k, v, do, *outs) + [0] * 3 * (2 - len(outs))
    fn = f"mmpl_{what}_{part}"
    _launch("flash_bwd", fn, f"{what}_{part}", q.device, *ins,
            *(x.data_ptr() for x in outs), *split, *margs, B, Lq, Lk, N, D,
            (ctypes.c_longlong * 18)(*strides), float(_scale(q, scale)))


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale=None, mask=None,
                       tiles=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dKV kernel (K2, or K5 with `mask` and its `tiles`) from
    `csrc/flash_bwd.cu` (bf16 / fp16 K2 and K5: `csrc/flash_bwd_sm90.cuh`,
    K2 with its reduce in the same launch count when it splits the
    queries).  dO is read through its strides (the same rules as q); lse
    and delta = rowsum(dO * O) are contiguous [B, N, Lq] fp32.  Returns
    (dk, dv), contiguous, in k's dtype."""
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_launch("dkv", q, k, v, do, lse, delta, (dk, dv), scale, mask, tiles)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale=None, mask=None,
                      tiles=None) -> torch.Tensor:
    """Launch the dQ kernel (K3, or K6 with `mask` and its `tiles`) from
    `csrc/flash_bwd.cu` (bf16 / fp16 K3 and K6: `csrc/flash_bwd_sm90.cuh`);
    arguments as `flash_bwd_dkv_cuda`.  Returns dq."""
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _bwd_launch("dq", q, k, v, do, lse, delta, (dq,), scale, mask, tiles)
    return dq


def flash_bwd_cuda(q, k, v, do, lse, delta, scale=None, mask=None,
                   tiles=None):
    """Both backward kernels; returns (dq, dk, dv)."""
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, mask, tiles)
    return flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, mask,
                             tiles), dk, dv


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------

def _device_check(q: torch.Tensor) -> bool:
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return False


def _fwd(q, k, v, scale, mask, tiles):
    if _device_check(q):
        return flash_fwd_cuda(q, k, v, scale, mask, tiles)
    return _plain_fwd(q, k, v, _scale(q, scale), mask)


def _bwd(q, k, v, o, lse, do, scale, mask, tiles):
    # delta = rowsum(dO * O) in fp32 (attention.py:527), [B, N, Lq]
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    if _device_check(q):
        # dO is read through its strides; only a layout the kernel cannot
        # read (head dim not contiguous, misaligned) is copied, once
        if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
                s % (16 // do.element_size()) for s in do.stride()[:3]):
            do = do.contiguous()
        return flash_bwd_cuda(q, k, v, do, lse, delta, scale, mask, tiles)
    return _plain_bwd(q, k, v, do, lse, delta, _scale(q, scale), mask)


class _FlashAttention(torch.autograd.Function):
    """Softmax attention with the flash backward: K1 / K2 / K3 on CUDA,
    the plain versions on the CPU; with a frame mask K4 / K5 / K6."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mask, tiles):
        o, lse = _fwd(q, k, v, scale, mask, tiles)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.mask, ctx.tiles = scale, mask, tiles
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, ctx.scale, ctx.mask,
                          ctx.tiles)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, scale, mask, tiles):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, _ = _FlashAttention.apply(q, k, v, scale, mask, tiles)
        return out
    return _fwd(q, k, v, scale, mask, tiles)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors (no autograd).

    Returns (out [B, Lq, N, D], lse [B, N, Lq] fp32).
    """
    return _fwd(q, k, v, scale, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable unmasked attention: K1 forward, K2 / K3 backward."""
    return _attend(q, k, v, scale, None, None)


def flash_attention_bwd(q, k, v, do, lse, delta, scale=None):
    """(dq, dk, dv) of unmasked attention from a given lse and delta =
    rowsum(dO * O), both [B, N, Lq] fp32 (K2 / K3 on CUDA tensors, their
    plain version on CPU tensors).  The ring's backward passes the whole
    sequence's lse and delta with each chunk of keys."""
    if _device_check(q):
        return flash_bwd_cuda(q, k, v, do, lse, delta, scale)
    return _plain_bwd(q, k, v, do, lse, delta, _scale(q, scale))


def dense_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention and its per-query logsumexp, differentiable through
    torch's autograd (the dense ring of `parallel/sequence_parallel.py`,
    the plain version of `ring_flash_attention`).  Returns (out [B, Lq, N,
    D], lse [B, N, Lq] fp32)."""
    qf = q.float() * _scale(q, scale)
    scores = torch.einsum("bqnd,bknd->bnqk", qf, k.float())
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnqk,bknd->bqnd", (p / l).to(v.dtype), v)
    return out, (m + torch.log(l))[..., 0]


def merge_lse(out: torch.Tensor, lse: torch.Tensor, o_c: torch.Tensor,
              lse_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax merge of two attention results over disjoint keys:
    out / o_c [B, Lq, N, D] weighted by their lse [B, N, Lq]; returns the
    merged (out fp32, lse).  Differentiable."""
    m = torch.maximum(lse, lse_c)
    w, w_c = torch.exp(lse - m), torch.exp(lse_c - m)
    tot = w + w_c
    wq = (w / tot).transpose(1, 2)[..., None]
    wc = (w_c / tot).transpose(1, 2)[..., None]
    return out.float() * wq + o_c.float() * wc, m + torch.log(tot)


def _ring_fwd(q, k, v, group, scale):
    out, lse = flash_attention_lse(q, k, v, scale)
    out = out.float()
    kr, vr = k, v
    for _ in range(group.size - 1):
        kr, vr = group.rotate(kr), group.rotate(vr)
        o_c, lse_c = flash_attention_lse(q, kr, vr, scale)
        out, lse = merge_lse(out, lse, o_c, lse_c)
    return out.to(q.dtype), lse.contiguous()


class _RingFlashAttention(torch.autograd.Function):
    """Ring attention with its backward defined over the whole ring (the
    JAX package's custom VJP, `attention.py:622-713`): the forward rotates
    the K/V chunks and merges one K1 call per chunk by lse; the backward
    runs K2 and K3 per chunk with the GLOBAL lse and delta, each chunk's
    share of the full softmax's gradient being exactly p = exp(s -
    lse_global); the dK / dV accumulators travel the ring with their chunk
    and come home after `ring` rotations."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        out, lse = _ring_fwd(q, k, v, group, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        do = g.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kr, vr = k, v
        for _ in range(group.size):
            dq_c, dk_c, dv_c = flash_attention_bwd(q, kr, vr, do, lse, delta,
                                                   ctx.scale)
            dq += dq_c.float()
            dk += dk_c.float()
            dv += dv_c.float()
            if group.size > 1:
                kr, vr = group.rotate(kr), group.rotate(vr)
                dk, dv = group.rotate(dk), group.rotate(dv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Differentiable ring attention over a sequence-sharded K/V: q / k / v
    [B, L/ring, N, D] are this rank's shards (or, in an in-process group,
    every rank's stacked along B), `group` a group of
    `parallel/collectives.py` (`size`, `rotate`).  K1 per chunk forward,
    K2 / K3 per chunk backward on CUDA tensors; the plain versions on CPU
    tensors.  The merge runs in fp32 and rounds once, at the end."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingFlashAttention.apply(q, k, v, group, scale)
    return _ring_fwd(q, k, v, group, scale)[0]


def flash_attention_exp2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         use_exp2: bool = True, mask_pad: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """P1: softmax attention, O only (no autograd), exp or exp2, with or
    without the pad test on the last key tile.  The kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if _device_check(q):
        return flash_exp2_cuda(q, k, v, use_exp2, mask_pad, scale)
    return flash_attention_exp2_plain(q, k, v, use_exp2, mask_pad, scale)


def frame_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_frame_ids, kv_frame_ids, frame_mask,
                           scale: Optional[float] = None,
                           tiles: Optional[MaskTiles] = None
                           ) -> torch.Tensor:
    """Differentiable attention under a frame-granular boolean mask.

    q [B, Lq, N, D], k/v [B, Lk, N, D]; q_frame_ids [Lq] and kv_frame_ids
    [Lk] are int frame ids in [0, F); frame_mask [F, F] bool (True =
    attend).  `tiles` is `mask_tiles` of the same ids and mask (built here
    when not given; building it refuses ids outside [0, F)).  A row that
    sees no key gets O = 0 and zero grads.
    """
    mask = _as_mask(q_frame_ids, kv_frame_ids, frame_mask, q.device)
    if tiles is None:
        tiles = mask_tiles(*mask)
    return _attend(q, k, v, scale, mask, tiles)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Main dispatch: masked attention runs dense, unmasked attention runs
    `flash_attention` (K1-K3 on CUDA, the plain versions on the CPU)."""
    if mask is not None:
        return dense_attention(q, k, v, mask=mask, scale=scale)
    return flash_attention(q, k, v, scale=scale)
