// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
// Three kernels, each on a Hopper body:
//
//  * K1, unmasked.  Replaces the TPU kernel `_flash_fwd_kernel`
//    (mmpl_tpu/ops/attention.py:324, launched by `_flash_vjp_fwd_impl`):
//    O = softmax(scale * Q K^T) V per (batch, head) and the natural-log lse.
//  * K4, frame-masked.  Replaces `_masked_fwd_kernel` (attention.py:725,
//    launched by `_masked_vjp_fwd_impl`): token i attends token j iff
//    fm[qf[i], kf[j]].  The kernel reads the per-token frame ids and the
//    [F, F] table itself, where the TPU kernel rebuilt each tile's mask with
//    two one-hot matmuls (:716-722).  A tile that the tile table marks 0 is
//    never loaded; one marked 2 (every frame pair allowed) skips the
//    per-element test.  A row that sees no key gets O = 0 and lse = -inf.
//    The bf16 / fp16 body reads the table pooled to its 128 x 128 tiles,
//    the fp32 body the 64 x 64 one.
//  * P1, the exp2 probe.  Replaces `_fwd_kernel` (tools/exp2_probe.py:42,
//    launched through `variant` :85 at :95): K1 with two choices, kExp2
//    (log2(e) folded into the scale on the host, exp2 for both alpha and p,
//    :54, :64-66) and kPadMask (keep or drop the per-element col < Lk test;
//    dropping it is only defined when Lk is a multiple of 64, which the
//    wrapper enforces), and it writes O only.  The probe's grid floors
//    Lq / block_q and Lk / block_k (:92); here a ragged Lq is handled as in
//    K1, and a ragged Lk only with the pad test on.
//
// The bodies, by type:
//
//  * bf16 and fp16 K1, K4 and P1 run `flash_fwd_sm90.cuh`: wgmma, TMA and
//    warp specialisation, 128 query rows and 128-key tiles a block (its
//    note says what bounds it and what the design does about it).  K1 takes
//    its scale with log2(e) folded in and returns the lse in natural log;
//    K4's entry takes the natural scale and folds log2(e) in itself.
//  * fp32 K1, K4 and P1 run `flash_fwd_f32_sm90.cuh`: split TF32 on wgmma
//    (three passes a product, about 21 bits of each operand), a producer
//    warpgroup that splits Q, K and V and writes V transposed to shared
//    memory, one consumer warpgroup of 64 query rows over 32-key stages
//    (its note says what bounds it); K4 as its masked kernel, walking the
//    32-key tiles of its row of the 64 x 64 table, and P1 as its kernel
//    with P1's choices and no lse.  fp32 is the default trunk of the
//    trainer's ODE and distillation objectives, so its K1 runs at their
//    shapes.
//
// bf16 / fp16 K1 also runs two other schedules of its Hopper body
// (`flash_fwd_sched_sm90.cuh`, entry `mmpl_flash_fwd_sched`, chosen by
// ops/attention.py `fwd_schedule`): a persistent walk over the (query
// block, head, batch) units at short keys, and a split of the keys with a
// merge where few query blocks meet long keys.
//
// All keep an online softmax in fp32 (m, l, acc), round P to the input
// type before the PV product (the fp32 split-TF32 body splits it into two TF32
// parts), and write O in the input type and (K1, K4)
// lse in fp32 (l == 0 guarded as on the TPU; in K4 the shift/alpha guards
// of attention.py:750-752 keep a row that has seen only masked scores at
// m = -inf without NaNs).
//
// Layout: q [B, Lq, N, D], k/v [B, Lk, N, D], o [B, Lq, N, D] read and
// written through element strides (the head dim is contiguous); lse is a
// contiguous [B, N, Lq] fp32 array.  The ragged Lq and Lk edges are masked
// in the kernels, so the caller pads nothing.  All offsets are 64-bit: one
// K of the 1.3B CFG cache holds 2.16e9 elements.
//
// What bounds them on an H100: operations.  The work is 4*B*N*Lq*Lk*D FLOPs
// (two products; for K4 times the admitted share of tiles) against
// B*N*(2*Lq + 2*Lk)*D input/output elements; at the main path's shapes
// (Lq, Lk >= 3120, D = 128) that is far above the card's ~295 FLOP/byte
// ridge, so the tensor cores are the limit.  Each body pads the head dim
// to a compile-time width kD (64 or 128) with zeros, so every D that is a
// multiple of 8 up to 128 works.

#include <string.h>

#include "flash_common.cuh"
#include "flash_fwd_f32_sm90.cuh"
#include "flash_fwd_sched_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace mmpl;

bool bad_head_dim(int D) { return D <= 0 || D > 128 || D % 8; }

// K4 in fp32 on fp32 K1's split-TF32 wgmma body, over the 64 x 64 table;
// `scale` is the natural one.
int masked_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Lq,
               int Lk, int N, int D, const FwdStrides& st, float scale, const FrameMask& mask,
               cudaStream_t s) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  const float sc = scale * sm90::kLog2e;
  return D <= 64
             ? sm90::launch_f32_masked_fwd<64>(qp, kp, vp, op, l, B, Lq, Lk, N, D, st, sc, mask, s)
             : sm90::launch_f32_masked_fwd<128>(qp, kp, vp, op, l, B, Lq, Lk, N, D, st, sc, mask,
                                                s);
}

// K4 in bf16 / fp16 on the wgmma body; `scale` is the natural one.
template <typename T>
int masked_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Lq,
                int Lk, int N, int D, const FwdStrides& st, float scale, const FrameMask& mask,
                cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  const float sc = scale * sm90::kLog2e;
  return D <= 64 ? sm90::launch_masked<T, 64>(q, k, v, o, l, B, Lq, Lk, N, D, st, sc, mask, s)
                 : sm90::launch_masked<T, 128>(q, k, v, o, l, B, Lq, Lk, N, D, st, sc, mask, s);
}

// K1 in bf16 / fp16 on the wgmma body.
template <typename T>
int fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Lq,
             int Lk, int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  return D <= 64
             ? sm90::launch<T, 64, true, true, true>(q, k, v, o, l, B, Lq, Lk, N, D, st, scale, s)
             : sm90::launch<T, 128, true, true, true>(q, k, v, o, l, B, Lq, Lk, N, D, st, scale,
                                                      s);
}

// K1 in bf16 / fp16 under the persistent walk or the key split, at kD = 128
// for every D (the head dim past D loads as zeros): no path runs these
// schedules at D <= 64, and each width's instantiations cost the build
// (chip_smoke.py's time limit counts it).
template <typename T>
int sched_sm90(const void* q, const void* k, const void* v, void* o, void* lse, float* ws,
               int splits, int sms, int B, int Lq, int Lk, int N, int D, const FwdStrides& st,
               float scale, cudaStream_t s) {
  return sm90::launch_sched<T, 128>(q, k, v, o, static_cast<float*>(lse), ws, splits, sms, B, Lq,
                                    Lk, N, D, st, scale, s);
}

// K1 on one grid block per 128-query block: the split-TF32 body for fp32,
// the wgmma body for bf16 / fp16.
int fwd_grid(int dtype, const void* q, const void* k, const void* v, void* o, void* lse, int B,
             int Lq, int Lk, int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return D <= 64 ? sm90::launch_f32_fwd<64>(static_cast<const float*>(q),
                                                static_cast<const float*>(k),
                                                static_cast<const float*>(v),
                                                static_cast<float*>(o), static_cast<float*>(lse),
                                                B, Lq, Lk, N, D, st, scale, s)
                     : sm90::launch_f32_fwd<128>(static_cast<const float*>(q),
                                                 static_cast<const float*>(k),
                                                 static_cast<const float*>(v),
                                                 static_cast<float*>(o), static_cast<float*>(lse),
                                                 B, Lq, Lk, N, D, st, scale, s);
    case 1:
      return fwd_sm90<__nv_bfloat16>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    case 2:
      return fwd_sm90<__half>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One P1 variant at one width: the split-TF32 wgmma body for fp32, the
// wgmma body for bf16 / fp16.
template <typename T, int kD, bool kExp2, bool kPadMask>
int exp2_launch(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
                int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return sm90::launch_f32_fwd<kD, kExp2, kPadMask, false>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), nullptr, B, Lq, Lk, N, D, st, scale, s);
  else
    return sm90::launch<T, kD, kExp2, kPadMask, false>(q, k, v, o, nullptr, B, Lq, Lk, N, D,
                                                       st, scale, s);
}

template <typename T, int kD>
int exp2_variant(bool use_exp2, bool mask_pad, const void* q, const void* k, const void* v,
                 void* o, int B, int Lq, int Lk, int N, int D, const FwdStrides& st,
                 float scale, cudaStream_t s) {
  if (use_exp2)
    return mask_pad ? exp2_launch<T, kD, true, true>(q, k, v, o, B, Lq, Lk, N, D, st, scale, s)
                    : exp2_launch<T, kD, true, false>(q, k, v, o, B, Lq, Lk, N, D, st, scale, s);
  return mask_pad ? exp2_launch<T, kD, false, true>(q, k, v, o, B, Lq, Lk, N, D, st, scale, s)
                  : exp2_launch<T, kD, false, false>(q, k, v, o, B, Lq, Lk, N, D, st, scale, s);
}

template <typename T>
int exp2_width(bool use_exp2, bool mask_pad, const void* q, const void* k, const void* v,
               void* o, int B, int Lq, int Lk, int N, int D, const FwdStrides& st, float scale,
               cudaStream_t s) {
  return D <= 64
             ? exp2_variant<T, 64>(use_exp2, mask_pad, q, k, v, o, B, Lq, Lk, N, D, st, scale, s)
             : exp2_variant<T, 128>(use_exp2, mask_pad, q, k, v, o, B, Lq, Lk, N, D, st, scale,
                                    s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements.
// Returns cudaGetLastError() after the launch (0 = launched), or
// sm90::kErrNoEncoder / kErrTensorMap (< 0) when a tensor map could not be
// built.

// K1.  `scale` holds log2(e) (exp2 softmax); lse comes back in natural log.
extern "C" int mmpl_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse, int B, int Lq,
                              int Lk, int N, int D, long long sqb,
                              long long sql, long long sqh, long long skb,
                              long long skl, long long skh, long long svb,
                              long long svl, long long svh, long long sob,
                              long long sol, long long soh, float scale,
                              void* stream) {
  if (bad_head_dim(D)) return (int)cudaErrorInvalidValue;
  const FwdStrides st{sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh};
  return fwd_grid(dtype, q, k, v, o, lse, B, Lq, Lk, N, D, st, scale,
                  static_cast<cudaStream_t>(stream));
}

// The scheduled K1 entry's integer arguments as ops/attention.py
// `_sched_args` packs them, 27 int64s: a short shape's call is host-bound,
// and 30 arguments converted one by one by ctypes cost ~8 us of it.
struct SchedArgs {
  long long dtype, q, k, v, o, lse, ws, mode, splits, sms, B, Lq, Lk, N, D;
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh;
};

// K1 under a schedule (ops/attention.py `fwd_schedule`): mode 0 one block
// per 128-query block (as mmpl_flash_fwd), 1 the persistent walk, 2 the
// key split over `splits` ranges with the fp32 workspace `ws` (S * B * N *
// Lq * (D + 1) floats) and the merge, in one call.  Modes 1 and 2 take
// bf16 / fp16 and run on min(sms, units) blocks.  `scale` holds log2(e).
extern "C" int mmpl_flash_fwd_sched(const void* packed, float scale, void* stream) {
  SchedArgs a;
  memcpy(&a, packed, sizeof a);
  const int dtype = (int)a.dtype, mode = (int)a.mode, splits = (int)a.splits, D = (int)a.D;
  if (bad_head_dim(D) || mode < 0 || mode > 2 || (mode == 1 && splits != 1) ||
      (mode == 2 && splits < 2) || (mode != 0 && dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  auto ptr = [](long long x) { return reinterpret_cast<void*>(static_cast<uintptr_t>(x)); };
  const void *q = ptr(a.q), *k = ptr(a.k), *v = ptr(a.v);
  void *o = ptr(a.o), *lse = ptr(a.lse);
  const int B = (int)a.B, Lq = (int)a.Lq, Lk = (int)a.Lk, N = (int)a.N;
  const FwdStrides st{a.sqb, a.sql, a.sqh, a.skb, a.skl, a.skh,
                      a.svb, a.svl, a.svh, a.sob, a.sol, a.soh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return fwd_grid(dtype, q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
  float* ws = mode == 2 ? static_cast<float*>(ptr(a.ws)) : nullptr;
  return dtype == 1 ? sched_sm90<__nv_bfloat16>(q, k, v, o, lse, ws, splits, (int)a.sms, B, Lq,
                                                Lk, N, D, st, scale, s)
                    : sched_sm90<__half>(q, k, v, o, lse, ws, splits, (int)a.sms, B, Lq, Lk,
                                         N, D, st, scale, s);
}

// K4.  qf [Lq] / kf [Lk] int32 frame ids in [0, F); fm [F, F] uint8; tiles
// [ceil(Lq/64), ceil(Lk/64)] uint8 (0 skip, 1 test pairs, 2 all allowed),
// read by fp32; coarse, the same over 128 x 128 tiles [ceil(Lq/128),
// ceil(Lk/128)], read by bf16 / fp16 (F up to sm90::kMaxFrames).  `scale`
// is the natural one.
extern "C" int mmpl_flash_masked_fwd(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* qf, const void* kf, const void* fm,
                                     const void* tiles, const void* coarse, int F, int B, int Lq,
                                     int Lk, int N, int D, long long sqb,
                                     long long sql, long long sqh, long long skb,
                                     long long skl, long long skh, long long svb,
                                     long long svl, long long svh, long long sob,
                                     long long sol, long long soh, float scale,
                                     void* stream) {
  if (bad_head_dim(D)) return (int)cudaErrorInvalidValue;
  const FwdStrides st{sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh};
  const FrameMask mask{static_cast<const int*>(qf), static_cast<const int*>(kf),
                       static_cast<const unsigned char*>(fm),
                       static_cast<const unsigned char*>(tiles), F, (Lk + TILE - 1) / TILE};
  const FrameMask wide{mask.qf, mask.kf, mask.fm, static_cast<const unsigned char*>(coarse), F,
                       (Lk + sm90::kBlockN - 1) / sm90::kBlockN};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return masked_f32(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, mask, s);
    case 1:
      return masked_sm90<__nv_bfloat16>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, wide, s);
    case 2:
      return masked_sm90<__half>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, wide, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// P1.  use_exp2 / mask_pad select the variant; with mask_pad == 0, Lk must
// be a multiple of 64.  Writes O only.
extern "C" int mmpl_flash_exp2(int dtype, const void* q, const void* k, const void* v,
                               void* o, int use_exp2, int mask_pad, int B, int Lq, int Lk,
                               int N, int D, long long sqb, long long sql, long long sqh,
                               long long skb, long long skl, long long skh, long long svb,
                               long long svl, long long svh, long long sob, long long sol,
                               long long soh, float scale, void* stream) {
  if (bad_head_dim(D) || (!mask_pad && Lk % TILE)) return (int)cudaErrorInvalidValue;
  const FwdStrides st{sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return exp2_width<float>(use_exp2, mask_pad, q, k, v, o, B, Lq, Lk, N, D, st, scale, s);
    case 1:
      return exp2_width<__nv_bfloat16>(use_exp2, mask_pad, q, k, v, o, B, Lq, Lk, N, D, st, scale,
                                       s);
    case 2:
      return exp2_width<__half>(use_exp2, mask_pad, q, k, v, o, B, Lq, Lk, N, D, st, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
