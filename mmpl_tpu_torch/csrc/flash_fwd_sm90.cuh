// Flash-attention forward for Hopper (sm_90a) on wgmma, TMA and warp
// specialisation: the bf16 / fp16 body of K1 and P1 (csrc/flash_fwd.cu).
//
//  * K1 (`flash_fwd_sm90_kernel`) replaces `_flash_fwd_kernel`
//    (mmpl_tpu/ops/attention.py:324): O = softmax(scale * Q K^T) V per
//    (batch, head) and the natural-log lse [B, N, Lq] in fp32.
//  * P1 (`flash_exp2_sm90_kernel`) replaces the exp2 probe's `_fwd_kernel`
//    (tools/exp2_probe.py:42): O only, exp or exp2, with or without the
//    per-element pad test on the last key tile.
//
// What bounds it on an H100: operations (4*B*N*Lq*Lk*D FLOPs against
// B*N*(2*Lq + 2*Lk)*D elements in and out, far above the card's ~295
// FLOP/byte ridge at the main path's shapes), so the design keeps the
// tensor cores busy:
//
//  * Block: 128 query rows of one (b, head), 384 threads in three
//    warpgroups.  Warpgroup 0 is the producer: one thread loads Q once and
//    keeps the 128-key K and V tiles in flight with TMA through a ring of
//    kStages stages, each with a full and an empty mbarrier for K and for
//    V.  Warpgroups 1 and 2 are consumers of 64 query rows each; they issue
//    no loads and meet at no block-wide barrier.  setmaxnreg moves the
//    producer's registers to the consumers (24 / 240 a thread).
//  * Both products on wgmma with fp32 accumulators in registers:
//    S = Q K^T as m64n128k16 with Q and K read from shared memory through
//    128-byte-swizzled descriptors (K-major), and O += P V as m64n{kD}k16
//    with P in registers (the S accumulator rounded to the input type and
//    packed in place: the accumulator's fragment is the A operand's) and V
//    read through the descriptor's transpose bit (V is [keys, D], MN-major
//    for this product), so nothing is transposed in shared memory.
//  * Overlap inside a consumer: tile j+1's S product is issued before tile
//    j's PV product, and the softmax of tile j+1 runs while PV of tile j is
//    on the tensor cores (no ping-pong between the two consumers).
//  * Softmax in fp32 on x = s * scale; exp2 with log2(e) folded into the
//    scale on the host for K1 and P1's exp2 variants, exp for P1's exp
//    variants.  K1's lse is returned natural-log: (m + log2 l) * ln 2.
//  * The ragged edges: TMA zero-fills rows past L and columns past D (the
//    head dim is padded to kD = 64 or 128 that way, and output columns
//    >= D are dropped).  A zero-filled key scores 0, not -inf, so the last
//    key tile, and only it, masks: per element with the pad test, or (P1
//    without it, legal only for Lk a multiple of 64) by dropping the tile's
//    upper 64 keys as a whole when it holds 64.  Rows past Lq are not
//    stored.
//
// Shared memory at kD = 128: Q 32 KB, K and V 2 x 2 x 32 KB, one block per
// SM.  Each 128-column row is two 64-column TMA boxes (128 bytes, the
// swizzle's width), each box 1024-byte aligned.  Operands are read through
// 4-D tensor maps (D, N, L, B) built on the host from the element strides,
// so a q that is a view of the fused qkv projection is read in place.  The
// mbarrier, TMA, wgmma and tensor-map helpers are shared with the backward
// body (sm90_common.cuh).
#pragma once

#include "sm90_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kBlockM = 128;      // query rows of a block
constexpr int kBlockN = 128;      // keys of a K / V tile
constexpr int kStages = 2;        // K / V tiles in flight
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kBoxBytes = kBlockN * 128;   // one [128 rows, 64 columns] box
constexpr int kConsumerWarps = 8;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockM == kBlockN, "a Q box and a K / V box share kBoxBytes");

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int kD>
struct Layout {
  static constexpr int halves = kD / kBox;
  static constexpr int tile = halves * kBoxBytes;  // a Q, K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + tile;
  static constexpr int v = k + kStages * tile;
  static constexpr int bar = v + kStages * tile;
  // q_full, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int bytes = bar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

struct Params {
  void* o;
  float* lse;
  long long ob, ol, oh;  // o's element strides
  int Lq, Lk, N, D;
  float scale;           // log2(e) folded in for exp2
};

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------

template <bool kExp2>
__device__ __forceinline__ float softmax_exp(float x) {
  return kExp2 ? ex2(x) : expf(x);
}

// S = Q K^T for one consumer: its 64 rows of Q (at qa) against a K tile.
template <typename T, int kD>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qa, uint32_t ka) {
  issue_ss<T, kD, kBlockN>(s, qa, kBoxBytes, ka, kBoxBytes);
}

// O += P V over a V tile, 16 keys a step.
template <typename T, int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pf)[8][4],
                                         uint32_t va) {
  issue_rs<T, kD, kBlockN>(o, pf, va, kBoxBytes);
}

// Scale the raw scores, mask the last tile's missing keys, update the row
// max m and sum l, and leave the unnormalised probabilities in s.  Element
// i of the accumulator is row g + 8 * ((i >> 1) & 1), column
// 8 * (i / 4) + 2 * t + (i & 1).
template <bool kExp2, bool kPadMask>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale, int valid,
                                               int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] *= scale;
  if (valid < kBlockN) {  // the last tile, ragged
    if (kPadMask) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    } else {  // Lk is a multiple of 64: the tile holds 64 keys
#pragma unroll
      for (int i = 32; i < 64; ++i) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds a key, so m_new is finite; exp(-inf) = 0 on the first
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = softmax_exp<kExp2>(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = softmax_exp<kExp2>(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

template <typename T, int kD, bool kExp2, bool kPadMask, bool kLse>
__device__ __forceinline__ void flash_fwd_sm90_body(const CUtensorMap& qm, const CUtensorMap& km,
                                                    const CUtensorMap& vm, const Params& p) {
  static_assert(!kLse || kExp2, "the lse is converted from the exp2 domain");
  using L = Layout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::bar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkb = (p.Lk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one thread issues every load
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::tile);
#pragma unroll
      for (int c = 0; c < L::halves; ++c)
        tma_load(base + L::q + c * kBoxBytes, qm, q_full, c * kBox, h, q0, b);
      for (int j = 0; j < nkb; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;  // the first round passes
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c)
          tma_load(base + L::k + s * L::tile + c * kBoxBytes, km, k_full(s), c * kBox, h,
                   j * kBlockN, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c)
          tma_load(base + L::v + s * L::tile + c * kBoxBytes, vm, v_full(s), c * kBox, h,
                   j * kBlockN, b);
      }
    }
  } else {
    // consumers: 64 query rows each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const uint32_t qa = base + L::q + cw * 64 * 128;

    float s[64];
    float o[kD / 2];
    uint32_t pf[8][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    const int last_valid = p.Lk - (nkb - 1) * kBlockN;
    auto valid_of = [&](int j) { return j == nkb - 1 ? last_valid : kBlockN; };

    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_qk<T, kD>(s, qa, base + L::k);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    if (signals) mbar_arrive(k_empty(0));
    online_softmax<kExp2, kPadMask>(s, m, l, alpha, p.scale, valid_of(0), t);
    pack_frag<T, 8>(pf, s);

    for (int j = 1; j < nkb; ++j) {
      const int st = j % kStages;
      const int sp = (j - 1) % kStages;
      mbar_wait(k_full(st), (j / kStages) & 1);
      fence_regs(s);
      fence_regs(o);
      fence_regs(pf);
      wg_fence();
      issue_qk<T, kD>(s, qa, base + L::k + st * L::tile);
      wg_commit();
      mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
      issue_pv<T, kD>(o, pf, base + L::v + sp * L::tile);
      wg_commit();
      wg_wait<1>();  // S of tile j is in; PV of tile j-1 may still run
      fence_regs(s);
      if (signals) mbar_arrive(k_empty(st));
      online_softmax<kExp2, kPadMask>(s, m, l, alpha, p.scale, valid_of(j), t);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      if (signals) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_frag<T, 8>(pf, s);
    }
    const int sl = (nkb - 1) % kStages;
    mbar_wait(v_full(sl), ((nkb - 1) / kStages) & 1);
    fence_regs(o);
    fence_regs(pf);
    wg_fence();
    issue_pv<T, kD>(o, pf, base + L::v + sl * L::tile);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);

    T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lsafe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lsafe;
      const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
      if (row >= p.Lq) continue;
      if (kLse && t == 0)
        p.lse[((long long)b * p.N + h) * p.Lq + row] =
            m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(lsafe)) * kLn2;
      T* orow = og + (long long)row * p.ol;
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack2<T>(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

// K1: O and the natural-log lse; `scale` holds log2(e).
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                      const __grid_constant__ CUtensorMap km,
                      const __grid_constant__ CUtensorMap vm, const Params p) {
  flash_fwd_sm90_body<T, kD, true, true, true>(qm, km, vm, p);
}

// P1: O only; `scale` holds log2(e) when kExp2.
template <typename T, int kD, bool kExp2, bool kPadMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_exp2_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                       const __grid_constant__ CUtensorMap km,
                       const __grid_constant__ CUtensorMap vm, const Params p) {
  flash_fwd_sm90_body<T, kD, kExp2, kPadMask, false>(qm, km, vm, p);
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// K1 (kLse) or P1.  Returns 0, a cudaError_t or one of the codes above.
template <typename T, int kD, bool kExp2, bool kPadMask, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq,
           int Lk, int N, int D, const FwdStrides& st, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode<T>(&qm, q, B, Lq, N, D, st.qb, st.ql, st.qh);
  if (rc == 0) rc = encode<T>(&km, k, B, Lk, N, D, st.kb, st.kl, st.kh);
  if (rc == 0) rc = encode<T>(&vm, v, B, Lk, N, D, st.vb, st.vl, st.vh);
  if (rc != 0) return rc;
  const Params p{o, lse, st.ob, st.ol, st.oh, Lq, Lk, N, D, scale};
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, N, B);
  constexpr int bytes = Layout<kD>::bytes;
  cudaError_t err;
  if constexpr (kLse) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<T, kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_sm90_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(qm, km, vm, p);
  } else {
    err = cudaFuncSetAttribute(flash_exp2_sm90_kernel<T, kD, kExp2, kPadMask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_exp2_sm90_kernel<T, kD, kExp2, kPadMask><<<grid, kThreads, bytes, stream>>>(qm, km, vm,
                                                                                      p);
  }
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
