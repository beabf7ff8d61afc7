// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
// Three kernels, two bodies:
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
//    The Hopper body reads the table pooled to its 128 x 128 tiles, the
//    template body the 64 x 64 one.
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
//  * fp32 K1, K4 and P1 run the template body below: each of 4 warps owns
//    16 of a block's 64 query rows and holds its scores, probabilities and
//    output accumulator in registers (FMA in the mma.sync m16n8k16
//    fragment layout of flash_common.cuh), and the block double-buffers the
//    64-key K/V tiles with cp.async.  fp32 is the smoke configuration: a
//    TF32 wgmma could not meet its 1e-4 tolerance, so fp32 stays off the
//    tensor cores.  The body's K1 uses exp2 as the Hopper one does (the
//    same scale).
//
// All keep an online softmax in fp32 (m, l, acc), round P to the input
// type before the PV product, and write O in the input type and (K1, K4)
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
// ridge, so the tensor cores are the limit.
//
// The template body's block: 64 query rows of one (b, head), 4 warps.  The
// head dim is padded to the compile-time width kD (64 or 128) with zeros
// in shared memory (cp.async's src-size operand zero-fills the lanes past
// D, as it does the rows past L), so every D that is a multiple of 8 up to
// 128 works.

#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace mmpl;

// Shared memory of the template body (fp32): Q, two K and two V tiles, and
// each warp's P rows.
template <int kD>
struct FwdSmem {
  static constexpr size_t bytes =
      sizeof(float) * (5 * Pitch<float, kD>::tile + TILE * Pitch<float, kD>::pld);
};

template <bool kExp2>
__device__ __forceinline__ float softmax_exp(float x) {
  return kExp2 ? exp2f(x) : expf(x);
}

template <typename T, int kD, bool kMasked, bool kExp2, bool kPadMask, bool kLse>
__device__ __forceinline__ void flash_fwd_body(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, T* __restrict__ o,
                                               float* __restrict__ lse, int Lq, int Lk, int N,
                                               int D, const FwdStrides& st, float scale,
                                               const FrameMask& mask) {
  static_assert(Pitch<T, kD>::kFloat, "bf16 / fp16 run the Hopper body");
  constexpr int TL = Pitch<T, kD>::tile;
  constexpr int DT = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  auto Ks = [&](int stage) { return Qs + (1 + stage) * TL; };
  auto Vs = [&](int stage) { return Qs + (3 + stage) * TL; };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;

  const int nkb = (Lk + TILE - 1) / TILE;
  const unsigned char* trow = kMasked ? mask.tiles + (long long)blockIdx.x * mask.nkt : nullptr;
  // frame-table rows of this thread's two query rows (-1: past Lq)
  const unsigned char* fmrow[2] = {nullptr, nullptr};
  if (kMasked) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + g + 8 * i;
      fmrow[i] = row < Lq ? mask.fm + (long long)mask.qf[row] * mask.F : nullptr;
    }
  }

  int kb = next_tile<kMasked>(trow, 1, 0, nkb);
  load_tile<T, kD>(Qs, qg, st.ql, q0, Lq, D);
  if (kb < nkb) {
    load_tile<T, kD>(Ks(0), kg, st.kl, kb * TILE, Lk, D);
    load_tile<T, kD>(Vs(0), vg, st.vl, kb * TILE, Lk, D);
  }
  cp_async_commit();

  float acc[DT][4] = {};                 // output rows g, g + 8
  float m[2] = {-INFINITY, -INFINITY};   // running row max
  float l[2] = {0.f, 0.f};               // this lane's share of the row sum

  for (int stage = 0; kb < nkb; stage ^= 1) {
    const int nxt = next_tile<kMasked>(trow, 1, kb + 1, nkb);
    if (nxt < nkb) {
      load_tile<T, kD>(Ks(stage ^ 1), kg, st.kl, nxt * TILE, Lk, D);
      load_tile<T, kD>(Vs(stage ^ 1), vg, st.vl, nxt * TILE, Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks(stage);
    const T* Vt = Vs(stage);

    // S = Q K^T for this warp's 16 rows (raw fp32 dot products)
    float s[8][4];
    fma_abt<kD>(s, Qs, warp * 16, Kt, D);

    // online softmax; each row's 64 scores live in the 4 lanes of a quad
    const int kvalid = Lk - kb * TILE;
    const bool test_pairs = kMasked && trow[kb] != 2;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        bool ok = !kPadMask || col < kvalid;
        if (test_pairs) {
          const unsigned char* fr = fmrow[e >> 1];
          ok = ok && fr != nullptr && fr[mask.kf[kb * TILE + col]] != 0;
        }
        const float x = ok ? s[j][e] * scale : -INFINITY;
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      // only a masked row can have seen no score yet: every key tile of
      // the unmasked kernel holds a valid key, and there the guard cost 8%
      // of K1's time at the serving shapes on an H100
      shift[i] = kMasked && m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = m[i] == -INFINITY ? 0.f : softmax_exp<kExp2>(m[i] - shift[i]);
      m[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = softmax_exp<kExp2>(s[j][e] - shift[e >> 1]);  // exp(-inf) = 0
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + psum[i];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      acc[c][0] *= alpha[0]; acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1]; acc[c][3] *= alpha[1];
    }

    // O += P V
    float* Pw = reinterpret_cast<float*>(smem + sizeof(T) * 5 * TL) +
                warp * 16 * Pitch<T, kD>::pld;
    fma_pb<kD>(acc, s, Vt, Pw);
    __syncthreads();  // every warp is done with this stage before it is refilled
    kb = nxt;
  }
  cp_async_wait<0>();  // the Q copy when the mask admitted no tile

  T* og = o + b * st.ob + h * st.oh;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / lsafe;
    const int row = q0 + warp * 16 + g + 8 * i;
    if (kLse && row < Lq && t == 0)  // natural log; m is in log2 units with exp2
      lse[(b * N + h) * (long long)Lq + row] =
          m[i] == -INFINITY ? -INFINITY
                            : kExp2 ? (m[i] + log2f(lsafe)) * 0.6931471805599453f
                                    : m[i] + logf(lsafe);
  }
  store_rows<T, kD>(og, st.ol, q0 + warp * 16 + g, Lq, D, acc, inv[0], inv[1]);
}

// K1 on the template body: fp32 only (bf16 / fp16 run sm90::launch);
// `scale` holds log2(e).
template <typename T, int kD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int N, int D,
                 FwdStrides st, float scale) {
  flash_fwd_body<T, kD, false, true, true, true>(q, k, v, o, lse, Lq, Lk, N, D, st, scale,
                                                 FrameMask{});
}

// K4 on the template body: fp32 only (bf16 / fp16 run
// sm90::launch_masked).
template <typename T, int kD>
__global__ void __launch_bounds__(THREADS)
flash_masked_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int Lq, int Lk, int N, int D,
                        FwdStrides st, float scale, FrameMask mask) {
  flash_fwd_body<T, kD, true, false, true, true>(q, k, v, o, lse, Lq, Lk, N, D, st, scale,
                                                 mask);
}

// P1 on the template body: fp32 only; `scale` holds log2(e) when kExp2.
template <typename T, int kD, bool kExp2, bool kPadMask>
__global__ void __launch_bounds__(THREADS)
flash_exp2_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
                  int N, int D, FwdStrides st, float scale) {
  flash_fwd_body<T, kD, false, kExp2, kPadMask, false>(q, k, v, o, nullptr, Lq, Lk, N, D, st,
                                                       scale, FrameMask{});
}

template <typename Kernel, typename... Args>
int launch_body(Kernel kernel, size_t bytes, int B, int Lq, int N, cudaStream_t stream,
                Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + TILE - 1) / TILE, N, B);
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_head_dim(int D) { return D <= 0 || D > 128 || D % 8; }

template <typename T, int kD>
int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Lq,
            int Lk, int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  return launch_body(flash_fwd_kernel<T, kD>, FwdSmem<kD>::bytes, B, Lq, N, s,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                     Lq, Lk, N, D, st, scale);
}

template <typename T, int kD>
int masked_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Lq,
               int Lk, int N, int D, const FwdStrides& st, float scale, const FrameMask& mask,
               cudaStream_t s) {
  return launch_body(flash_masked_fwd_kernel<T, kD>, FwdSmem<kD>::bytes, B, Lq, N, s,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                     Lq, Lk, N, D, st, scale, mask);
}

template <typename T>
int masked_width(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                 int Lq, int Lk, int N, int D, const FwdStrides& st, float scale,
                 const FrameMask& mask, cudaStream_t s) {
  return D <= 64 ? masked_fwd<T, 64>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, mask, s)
                 : masked_fwd<T, 128>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, mask, s);
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

template <typename T, int kD, bool kExp2, bool kPadMask>
int exp2_f32(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
             int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  return launch_body(flash_exp2_kernel<T, kD, kExp2, kPadMask>, FwdSmem<kD>::bytes, B, Lq,
                     N, s, static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, N, D, st, scale);
}

// One P1 variant at one width: the template body for fp32, the wgmma body
// for bf16 / fp16.
template <typename T, int kD, bool kExp2, bool kPadMask>
int exp2_launch(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
                int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return exp2_f32<T, kD, kExp2, kPadMask>(q, k, v, o, B, Lq, Lk, N, D, st, scale, s);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return D <= 64 ? fwd_f32<float, 64>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s)
                     : fwd_f32<float, 128>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    case 1:
      return fwd_sm90<__nv_bfloat16>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    case 2:
      return fwd_sm90<__half>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
      return masked_width<float>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, mask, s);
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
