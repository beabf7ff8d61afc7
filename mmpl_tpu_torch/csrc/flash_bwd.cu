// Flash-attention backward, plain C interface for ctypes: the entries of
// K2 / K3 and of their masked forms K5 / K6.
//
//  * K2, dK and dV: `_flash_bwd_dkv_kernel` (mmpl_tpu/ops/attention.py:373,
//    pallas_call :553).  K3, dQ: `_flash_bwd_dq_kernel` (:417, :578).  In
//    bf16 / fp16 both run the Hopper body of flash_bwd_sm90.cuh: TMA
//    producer, wgmma consumers, warp specialisation, and for dK / dV a split
//    of each key block's query loop over several blocks with a
//    deterministic reduce when the key blocks alone would not fill the card
//    (see that file).  fp32 K2 runs the split-TF32 wgmma body of
//    flash_bwd_f32_sm90.cuh (three passes a product, a producer warpgroup
//    that splits Q and dO and writes them as rows and as columns, one
//    consumer warpgroup of 64 keys over 32-query tiles; see that file);
//    fp32 K3 the split-TF32 wgmma body of flash_bwd_dq_f32_sm90.cuh (K2's
//    design turned round: Q and dO resident, 64 queries over 32-key tiles
//    whose K and V rows and K columns two slots take in turn).
//    bf16 / fp16 K2 and K3 also run two other schedules
//    (`flash_bwd_sched_sm90.cuh`, entry `mmpl_flash_bwd_sched`, chosen by
//    ops/attention.py `bwd_schedule`): a fused walk of both where the
//    queries fit one 64-row tile (dQ's per-key-block partials summed by a
//    deterministic reduce), a persistent walk of K3 at short keys, and an
//    ordered walk of both at long keys (dQ's shares added across the key
//    blocks in key-block order, ordered by counters between the blocks).
//  * K5 / K6, the same under the frame mask: `_masked_bwd_dkv_kernel`
//    (:783, :963) and `_masked_bwd_dq_kernel` (:821, :992).  bf16 / fp16
//    K5 and K6 run the masked instantiations of the Hopper dKV and dQ
//    bodies of flash_bwd_sm90.cuh (K5 over the 64 x 128 coarse table, never
//    split; K6 over the 128 x 128 one); fp32 K5 and K6 run the masked
//    kernels of the fp32 K2 and K3 bodies over the 64 x 64 table, two
//    32-row tiles an entry.  p is 0 where the mask forbids the pair, past
//    the ragged edges and on rows whose lse is -inf (rows that saw no key:
//    the guard of `_masked_p`, :771-780); the mask is read from the
//    per-token frame ids and the [F, F] table, and the tile table (0 skip,
//    1 test pairs, 2 all allowed) skips whole tiles.  delta = rowsum(dO o O)
//    comes in computed (the plain torch op of
//    mmpl_tpu_torch/ops/attention.py).
//
// What bounds them on an H100: operations.  dKV does four products per
// tile (S, dP, dV, dK: 8*B*N*Lq*Lk*D FLOPs), dQ three (S, dP, dQ: 6*...),
// times the admitted share of tiles when masked; the bytes are
// B*N*(Lq+Lk)*D elements in and out, far below the ridge at the training
// shapes.  So every body keeps the products on the tensor cores with the
// scores, probabilities and accumulators in registers (fp32 as split TF32,
// three passes a product).  Each block owns its outputs: no atomics, and
// no second pass except the bf16 / fp16 dKV split's ordered reduce.
//
// Numerics: the Hopper body takes bf16/fp16 operands on the tensor cores
// with fp32 accumulation; p and dS are rounded to the input type before
// their products (dV, and dK / dQ); dP, p before rounding, and every
// accumulator stay fp32.  The TPU kernels run the dO and dS products in
// fp32 (:393, :403-409): a known difference, measured in ROADMAP.md Queue
// 3.  The fp32 bodies keep p and dS in fp32 and take every product as
// split TF32.
//
// Layout: q, do, dq [B, Lq, N, D]; k, v, dk, dv [B, Lk, N, D], all through
// element strides with a contiguous head dim; lse and delta contiguous
// [B, N, Lq] fp32.  64-bit offsets throughout.

#include <cstring>

#include "flash_common.cuh"
#include "flash_bwd_dq_f32_sm90.cuh"
#include "flash_bwd_f32_sm90.cuh"
#include "flash_bwd_sm90.cuh"
#include "flash_bwd_sched_sm90.cuh"

namespace {

using namespace mmpl;

struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;  // q, k, v, dO
  long long ab, al, ah, cb, cl, ch;                          // dK / dQ, dV
};

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dK, dV (dkv) or dQ (dq)
  int B, Lq, Lk, N, D;
  Strides st;
  float scale;
  FrameMask mask;
};

// fp32 K2, or K5 with kMasked (over `a.mask`'s 64 x 64 table), on the
// split-TF32 wgmma body; D <= 128 was checked.
template <bool kMasked>
int f32_dkv(const Args& a, void* stream) {
  const Strides& st = a.st;
  const FwdStrides in{st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl, st.vh, 0, 0, 0};
  const sm90::F32BwdParams p{static_cast<float*>(a.out0), static_cast<float*>(a.out1),
                             static_cast<const float*>(a.lse),
                             static_cast<const float*>(a.delta),
                             st.ab, st.al, st.ah, st.cb, st.cl, st.ch,
                             a.Lq, a.Lk, a.N, a.D, a.scale, a.scale * sm90::kLog2e};
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d = static_cast<const float*>(a.dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.D <= 64 ? sm90::launch_f32_dkv<64, kMasked>(q, k, v, d, in, st.db, st.dl, st.dh, p,
                                                       a.mask, a.B, s)
                   : sm90::launch_f32_dkv<128, kMasked>(q, k, v, d, in, st.db, st.dl, st.dh, p,
                                                        a.mask, a.B, s);
}

// fp32 K3, or K6 with kMasked (over `a.mask`'s 64 x 64 table), on the
// split-TF32 wgmma body; D <= 128 was checked.
template <bool kMasked>
int f32_dq(const Args& a, void* stream) {
  const Strides& st = a.st;
  const FwdStrides in{st.qb, st.ql, st.qh, st.kb, st.kl, st.kh, st.vb, st.vl, st.vh, 0, 0, 0};
  const sm90::F32DqParams p{static_cast<float*>(a.out0), static_cast<const float*>(a.lse),
                            static_cast<const float*>(a.delta), st.ab, st.al, st.ah,
                            a.Lq, a.Lk, a.N, a.D, a.scale, a.scale * sm90::kLog2e};
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d = static_cast<const float*>(a.dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.D <= 64 ? sm90::launch_f32_dq<64, kMasked>(q, k, v, d, in, st.db, st.dl, st.dh, p,
                                                      a.mask, a.B, s)
                   : sm90::launch_f32_dq<128, kMasked>(q, k, v, d, in, st.db, st.dl, st.dh, p,
                                                       a.mask, a.B, s);
}

FrameMask make_mask(const void* qf, const void* kf, const void* fm, const void* tiles, int F,
                    int Lk) {
  return FrameMask{static_cast<const int*>(qf), static_cast<const int*>(kf),
                   static_cast<const unsigned char*>(fm),
                   static_cast<const unsigned char*>(tiles), F, (Lk + TILE - 1) / TILE};
}

// bf16 / fp16 K2 or K3 on the Hopper body (K5 or K6 with kMasked,
// `a.mask` holding the coarse table); D <= 128 was checked.
template <typename T, bool kDKV, bool kMasked = false>
int launch_sm90(const Args& a, const long long* strides, void* ws, int splits,
                cudaStream_t stream) {
  const Strides& st = a.st;
  const sm90::BwdParams p{a.out0, a.out1, static_cast<float*>(ws),
                          static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
                          st.ab, st.al, st.ah, st.cb, st.cl, st.ch,
                          a.B, a.Lq, a.Lk, a.N, a.D, splits,
                          a.scale, a.scale * sm90::kLog2e};
  if constexpr (kMasked && kDKV)
    return a.D <= 64
               ? sm90::launch_masked_dkv<T, 64>(a.q, a.k, a.v, a.dout, strides, p, a.mask, stream)
               : sm90::launch_masked_dkv<T, 128>(a.q, a.k, a.v, a.dout, strides, p, a.mask,
                                                 stream);
  else if constexpr (kMasked)
    return a.D <= 64
               ? sm90::launch_masked_dq<T, 64>(a.q, a.k, a.v, a.dout, strides, p, a.mask, stream)
               : sm90::launch_masked_dq<T, 128>(a.q, a.k, a.v, a.dout, strides, p, a.mask,
                                                stream);
  else if constexpr (kDKV)
    return a.D <= 64 ? sm90::launch_dkv<T, 64>(a.q, a.k, a.v, a.dout, strides, p, stream)
                     : sm90::launch_dkv<T, 128>(a.q, a.k, a.v, a.dout, strides, p, stream);
  else
    return a.D <= 64 ? sm90::launch_dq<T, 64>(a.q, a.k, a.v, a.dout, strides, p, stream)
                     : sm90::launch_dq<T, 128>(a.q, a.k, a.v, a.dout, strides, p, stream);
}

// The unmasked entries: bf16 / fp16 on the Hopper body, fp32 K2 and K3 on
// their split-TF32 bodies.  `splits` > 1 (bf16 / fp16
// dKV only) needs the fp32 workspace `ws` of 2 * splits * B * N * Lk * D
// values.
template <bool kDKV>
int unmasked(int dtype, const Args& a, const long long* strides, void* ws, int splits,
             void* stream) {
  if (a.D <= 0 || a.D > 128 || a.D % 8 || splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (splits != 1) return (int)cudaErrorInvalidValue;
      if constexpr (kDKV)
        return f32_dkv<false>(a, stream);
      else
        return f32_dq<false>(a, stream);
    case 1:
      return launch_sm90<__nv_bfloat16, kDKV>(a, strides, ws, splits, s);
    case 2:
      return launch_sm90<__half, kDKV>(a, strides, ws, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The masked entries take the frame ids, table and tile table of
// mmpl_flash_masked_fwd (flash_fwd.cu) after the outputs, then `coarse`,
// the table that the bf16 / fp16 Hopper body reads (F up to
// sm90::kMaxFrames): for dKV the table over 64 queries x 128 keys stored
// key-block major ([ceil(Lk/128), ceil(Lq/64)]), for dQ the 128 x 128
// table of the forward ([ceil(Lq/128), ceil(Lk/128)]).  fp32 (the
// split-TF32 bodies of K5 and K6) reads `tiles`.
// The tables' widths are taken from Lq and Lk: the caller checks their
// shapes (`_mask_args`, mmpl_tpu_torch/ops/attention.py).
template <bool kDKV>
int masked(int dtype, Args& a, const void* coarse, const long long* strides, void* stream) {
  if (a.D <= 0 || a.D > 128 || a.D % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if constexpr (kDKV)
      return f32_dkv<true>(a, stream);
    else
      return f32_dq<true>(a, stream);
  }
  a.mask.tiles = static_cast<const unsigned char*>(coarse);
  a.mask.nkt = kDKV ? (a.Lq + sm90::kQueryTile - 1) / sm90::kQueryTile
                    : (a.Lk + sm90::kKeyTile - 1) / sm90::kKeyTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_sm90<__nv_bfloat16, kDKV, true>(a, strides, nullptr, 1, s);
    case 2:
      return launch_sm90<__half, kDKV, true>(a, strides, nullptr, 1, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements,
// (batch, row, head) for q, k, v, dO, then the outputs.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// sm90::kErrNoEncoder / kErrTensorMap (< 0) when a tensor map could not be
// built.  `ws` / `splits`: the dKV query split of the Hopper body (ws may
// be null with splits = 1).
extern "C" int mmpl_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, void* ws, int splits, int B, int Lq,
                                  int Lk, int N, int D, const long long* strides, float scale,
                                  void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, N, D, {}, scale, FrameMask{}};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return unmasked<true>(dtype, a, strides, ws, splits, stream);
}

extern "C" int mmpl_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int Lq, int Lk, int N, int D,
                                 const long long* strides, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Lq, Lk, N, D, {}, scale, FrameMask{}};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return unmasked<false>(dtype, a, strides, nullptr, 1, stream);
}

extern "C" int mmpl_flash_masked_bwd_dkv(int dtype, const void* q, const void* k,
                                         const void* v, const void* dout, const void* lse,
                                         const void* delta, void* dk, void* dv,
                                         const void* qf, const void* kf, const void* fm,
                                         const void* tiles, const void* coarse, int F, int B,
                                         int Lq, int Lk, int N, int D,
                                         const long long* strides, float scale,
                                         void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, N, D, {}, scale,
         make_mask(qf, kf, fm, tiles, F, Lk)};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return masked<true>(dtype, a, coarse, strides, stream);
}

extern "C" int mmpl_flash_masked_bwd_dq(int dtype, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        const void* delta, void* dq, const void* qf,
                                        const void* kf, const void* fm, const void* tiles,
                                        const void* coarse, int F, int B, int Lq, int Lk,
                                        int N, int D, const long long* strides, float scale,
                                        void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Lq, Lk, N, D, {}, scale,
         make_mask(qf, kf, fm, tiles, F, Lk)};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return masked<false>(dtype, a, coarse, strides, stream);
}

// The scheduled entry's integer arguments as ops/attention.py
// `_bwd_sched_args` packs them, 42 int64s: a short shape's call is
// host-bound, and 25 arguments converted one by one by ctypes cost some of
// it.  `st`: the element strides (batch, row, head) of q, k, v, dO, dQ, dK
// and dV (0 for an output the call does not write); `cnt`: the ordered
// walk's counters (0 for the other modes).
struct BwdSchedArgs {
  long long dtype, q, k, v, dout, lse, delta, dq, dk, dv, ws, mode, parts, splits, sms;
  long long B, Lq, Lk, N, D;
  long long st[21];
  long long cnt;
};

namespace {

// K2 on the grid (its query split over `a.splits` blocks, `a.ws` the
// split's partials): q, k, v and dO's strides, then dK's and dV's.
int grid_dkv(const BwdSchedArgs& a, float scale, void* stream) {
  auto ptr = [](long long x) { return reinterpret_cast<void*>(static_cast<uintptr_t>(x)); };
  long long st[18];
  memcpy(st, a.st, 12 * sizeof(long long));
  memcpy(st + 12, a.st + 15, 6 * sizeof(long long));
  Args g{ptr(a.q), ptr(a.k), ptr(a.v), ptr(a.dout), ptr(a.lse), ptr(a.delta), ptr(a.dk),
         ptr(a.dv), (int)a.B, (int)a.Lq, (int)a.Lk, (int)a.N, (int)a.D, {}, scale, FrameMask{}};
  g.st = *reinterpret_cast<const Strides*>(st);
  return unmasked<true>((int)a.dtype, g, st, ptr(a.ws), (int)a.splits, stream);
}

}  // namespace

// K2 and / or K3 under a schedule (ops/attention.py `bwd_schedule`):
// `parts` 1 dK and dV, 2 dQ, 3 both.  Mode 0: K2 (with its query split
// over `splits` blocks and the reduce when splits > 1, `ws` its partials)
// and K3 on one block per key block / query block, as mmpl_flash_bwd_dkv
// and mmpl_flash_bwd_dq; 1: K2 as in mode 0, K3 under the persistent walk;
// 2 (parts 3, Lq <= 64): the fused walk and its dQ reduce, `ws` the fp32
// partials (ceil(Lk / 128) * B * N * Lq * D floats); 3 (parts 3): the
// ordered walk, `ws` its fp32 sums (B * N * ceil(Lq / 64) * 8192 floats)
// and `cnt` its zeroed counters (B * N * ceil(Lq / 64) * 2 int32).  Modes
// 1-3 take bf16 / fp16 and run on min(sms, units) blocks.  `scale` is the
// natural one.
extern "C" int mmpl_flash_bwd_sched(const void* packed, float scale, void* stream) {
  BwdSchedArgs a;
  memcpy(&a, packed, sizeof a);
  const int dtype = (int)a.dtype, mode = (int)a.mode, parts = (int)a.parts;
  const int B = (int)a.B, Lq = (int)a.Lq, Lk = (int)a.Lk, N = (int)a.N, D = (int)a.D;
  if (D <= 0 || D > 128 || D % 8 || mode < 0 || mode > 3 || parts < 1 || parts > 3 ||
      (mode != 0 && dtype != 1 && dtype != 2) || (mode >= 2 && (parts != 3 || a.ws == 0)) ||
      (mode == 3 && a.cnt == 0))
    return (int)cudaErrorInvalidValue;
  auto ptr = [](long long x) { return reinterpret_cast<void*>(static_cast<uintptr_t>(x)); };
  const void *q = ptr(a.q), *k = ptr(a.k), *v = ptr(a.v), *dout = ptr(a.dout);
  void *dq = ptr(a.dq), *dk = ptr(a.dk), *dv = ptr(a.dv), *ws = ptr(a.ws);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 3) {
    sm90::OrderedParams p{static_cast<const float*>(ptr(a.lse)),
                          static_cast<const float*>(ptr(a.delta)),
                          static_cast<float*>(ws), static_cast<int*>(ptr(a.cnt)),
                          B, N, Lq, Lk, D, 0, 0, 0, scale, scale * sm90::kLog2e};
    const int sms = (int)a.sms;
    return dtype == 1 ? sm90::launch_ordered<__nv_bfloat16, 128>(q, k, v, dout, dq, dk, dv,
                                                                 a.st, p, sms, s)
                      : sm90::launch_ordered<__half, 128>(q, k, v, dout, dq, dk, dv, a.st, p,
                                                          sms, s);
  }
  if (mode != 0 && (parts & 2)) {
    sm90::BwdSchedParams p{static_cast<const float*>(ptr(a.lse)),
                           static_cast<const float*>(ptr(a.delta)),
                           mode == 2 ? static_cast<float*>(ws) : nullptr,
                           B, N, Lq, Lk, D, 0, 0, 0, 0, scale, scale * sm90::kLog2e};
    const int sms = (int)a.sms;
    if (mode == 2)
      return dtype == 1
                 ? sm90::launch_fused<__nv_bfloat16, 128>(q, k, v, dout, dq, dk, dv, a.st, p,
                                                          sms, s)
                 : sm90::launch_fused<__half, 128>(q, k, v, dout, dq, dk, dv, a.st, p, sms, s);
    if (parts & 1) {
      // K2 first, on the grid, as in mode 0
      const int rc = grid_dkv(a, scale, stream);
      if (rc != 0) return rc;
    }
    return dtype == 1
               ? sm90::launch_dq_persistent<__nv_bfloat16, 128>(q, k, v, dout, dq, a.st, p, sms, s)
               : sm90::launch_dq_persistent<__half, 128>(q, k, v, dout, dq, a.st, p, sms, s);
  }
  if (parts & 1) {
    const int rc = grid_dkv(a, scale, stream);
    if (rc != 0) return rc;
  }
  if (!(parts & 2)) return 0;
  // K3 on the grid: q, k, v, dO, then dQ's strides as the first output's
  long long st[18] = {};
  memcpy(st, a.st, 15 * sizeof(long long));
  Args g{q, k, v, dout, ptr(a.lse), ptr(a.delta), dq, nullptr, B, Lq, Lk, N, D, {}, scale,
         FrameMask{}};
  g.st = *reinterpret_cast<const Strides*>(st);
  return unmasked<false>(dtype, g, st, nullptr, 1, stream);
}
