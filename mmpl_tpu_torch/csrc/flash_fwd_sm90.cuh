// Flash-attention forward for Hopper (sm_90a) on wgmma, TMA and warp
// specialisation: the bf16 / fp16 body of K1, K4 and P1 (csrc/flash_fwd.cu).
//
//  * K1 (`flash_fwd_sm90_kernel`) replaces `_flash_fwd_kernel`
//    (mmpl_tpu/ops/attention.py:324): O = softmax(scale * Q K^T) V per
//    (batch, head) and the natural-log lse [B, N, Lq] in fp32.
//  * K4 (`flash_masked_fwd_sm90_kernel`) replaces `_masked_fwd_kernel`
//    (:725): the same under the frame mask, token i attends token j iff
//    fm[qf[i], kf[j]] (the kMasked instantiation; see "The frame mask").
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
// The frame mask (K4).  The block walks only the key tiles that the
// coarse table (ops/attention.py `mask_tiles`: one byte per 128 x 128
// tile, 0 no pair allowed, 1 some, 2 all) admits on its row:
//
//  * The producer warp reads the row 32 tiles at a time (a ballot) and, for
//    each admitted tile in order, writes the tile's index, its class and
//    its 128 keys' frame ids into a ring of kMetaSlots TileMeta slots
//    before its k_full arrival (32 arrivals, lane 0's with the bytes);
//    skipped tiles cost no TMA and no wgmma.  Slot j % kMetaSlots is
//    rewritten only after the k_empty of step j - kStages, which every
//    consumer warp signals after the softmax of step j - 2 kStages.
//  * Each consumer warp counts the admitted tiles of the row itself (a
//    ballot and popc while Q loads), so the consumers run the same
//    pipeline over n steps as K1 over nkb, with no terminator.
//  * Only class-1 tiles test each pair: the [F, F] table sits in shared
//    memory (loaded once a block), each thread keeps its two rows' offsets
//    into it, and a forbidden score becomes -inf before the row max.
//  * A row that has seen no allowed key keeps m = -inf: its shift is 0
//    (the guards of attention.py:749-752), so alpha and every p are 0, and
//    the epilogue writes O = 0 and lse = -inf.  A block with no admitted
//    tile (n = 0) skips the products and still runs the epilogue; nothing
//    leaves the consumer branch early (ptxas ignores setmaxnreg with an
//    early exit there).
//
// Shared memory at kD = 128: Q 32 KB, K and V 2 x 2 x 32 KB, one block per
// SM; K4 adds the metadata ring and the frame table (F * F bytes).  Each
// 128-column row is two 64-column TMA boxes (128 bytes, the swizzle's
// width), each box 1024-byte aligned.  Operands are read through
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
constexpr int kMetaSlots = 2 * kStages;  // K4: the walk's metadata ring

static_assert(kBlockM == kBlockN, "a Q box and a K / V box share kBoxBytes");

static_assert(sizeof(TileMeta::kf) == kBlockN, "a TileMeta holds one key tile's frame ids");

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
  // K4: the TileMeta ring after the barriers, then the [F, F] frame table
  static constexpr int meta = bar + 8 * (1 + 4 * kStages) + 8;
  static constexpr int fm = meta + kMetaSlots * (int)sizeof(TileMeta);
  static constexpr int masked_bytes(int F) { return fm + (F * F + 15) / 16 * 16 + 1024; }
};
static_assert(Layout<128>::masked_bytes(kMaxFrames) <= kMaxSmem,
              "K4's frame table fits at kMaxFrames");

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
// 8 * (i / 4) + 2 * t + (i & 1).  kMasked (K4): a row may have seen no
// allowed key yet.
template <bool kExp2, bool kPadMask, bool kMasked = false>
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
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile of K1 holds a key, so m_new is finite; exp(-inf) = 0 on the
    // first.  A K4 row that has seen no allowed key shifts by 0, so alpha
    // and its p stay 0 (the guards of attention.py:749-752)
    const float m_new = fmaxf(m[r], mx[r]);
    shift[r] = kMasked && m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = softmax_exp<kExp2>(m[r] - shift[r]);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = softmax_exp<kExp2>(s[i] - shift[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// K4, on a class-1 tile: the scores of the pairs that the frame table `fm`
// (in shared memory) forbids become -inf; `qoff` holds this thread's two
// rows' offsets into the table.
__device__ __forceinline__ void forbid_pairs(float (&s)[64], int t, const TileMeta& mt,
                                             const unsigned char* fm, const int (&qoff)[2]) {
  if (mt.cls != 2) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (!fm[qoff[(i >> 1) & 1] + mt.kf[8 * (i / 4) + 2 * t + (i & 1)]]) s[i] = -INFINITY;
  }
}

// K4 (kMasked) reads `mask`: its `tiles` are the 128 x 128 table, `nkt`
// that table's columns.
template <typename T, int kD, bool kExp2, bool kPadMask, bool kLse, bool kMasked = false>
__device__ __forceinline__ void flash_fwd_sm90_body(const CUtensorMap& qm, const CUtensorMap& km,
                                                    const CUtensorMap& vm, const Params& p,
                                                    const FrameMask& mask) {
  static_assert(!kLse || kExp2, "the lse is converted from the exp2 domain");
  using L = Layout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::bar;
  // K4: the metadata ring and the frame table (generic pointers)
  unsigned char* const aligned = smem_raw + (base - smem_addr(smem_raw));
  TileMeta* const meta = reinterpret_cast<TileMeta*>(aligned + L::meta);
  unsigned char* const fm_s = aligned + L::fm;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkb = (p.Lk + kBlockN - 1) / kBlockN;
  // K4: this block's row of the coarse table
  const unsigned char* const trow =
      kMasked ? mask.tiles + (long long)blockIdx.x * mask.nkt : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), kMasked ? 32 : 1);  // K4: the producer warp's lanes
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kMasked) {
    for (int i = threadIdx.x; i < mask.F * mask.F; i += kThreads) fm_s[i] = mask.fm[i];
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one thread issues every load (K4: one warp walks the row)
    regs_dealloc<24>();
    if constexpr (kMasked) {
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        if (lane == 0) {
          mbar_expect_tx(q_full, L::tile);
#pragma unroll
          for (int c = 0; c < L::halves; ++c)
            tma_load(base + L::q + c * kBoxBytes, qm, q_full, c * kBox, h, q0, b);
        }
        int j = 0;  // step of the walk: stage j % kStages, slot j % kMetaSlots
        for (int c0 = 0; c0 < nkb; c0 += 32) {
          const int cls_l = c0 + lane < nkb ? trow[c0 + lane] : 0;
          for (uint32_t todo = __ballot_sync(0xffffffffu, cls_l != 0); todo; ++j) {
            const int bit = __ffs(todo) - 1;
            todo &= todo - 1;
            const int kt = c0 + bit;
            const int cls = __shfl_sync(0xffffffffu, cls_l, bit);
            const int s = j % kStages;
            const uint32_t free_parity = ((j / kStages) & 1) ^ 1;  // the first round passes
            mbar_wait(k_empty(s), free_parity);
            TileMeta& mt = meta[j % kMetaSlots];
#pragma unroll
            for (int i = 0; i < kBlockN / 32; ++i) {
              const int key = kt * kBlockN + lane + 32 * i;
              mt.kf[lane + 32 * i] = key < p.Lk ? (unsigned char)mask.kf[key] : 0;
            }
            if (lane == 0) {
              mt.tile = kt;
              mt.cls = cls;
              mbar_expect_tx(k_full(s), L::tile);
#pragma unroll
              for (int c = 0; c < L::halves; ++c)
                tma_load(base + L::k + s * L::tile + c * kBoxBytes, km, k_full(s), c * kBox, h,
                         kt * kBlockN, b);
              mbar_wait(v_empty(s), free_parity);
              mbar_expect_tx(v_full(s), L::tile);
#pragma unroll
              for (int c = 0; c < L::halves; ++c)
                tma_load(base + L::v + s * L::tile + c * kBoxBytes, vm, v_full(s), c * kBox, h,
                         kt * kBlockN, b);
            } else {
              mbar_arrive(k_full(s));
            }
          }
        }
      }
    } else if (threadIdx.x == 0) {
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

    // the steps of the walk: every key tile, or K4's admitted ones, which
    // each warp counts while Q loads; K4 also keeps its two rows' offsets
    // into the frame table
    int n = nkb;
    int qoff[2] = {0, 0};
    if constexpr (kMasked) {
      n = count_admitted(trow, nkb, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
        qoff[r] = row < p.Lq ? mask.qf[row] * mask.F : 0;
      }
    }

    mbar_wait(q_full, 0);
    if (!kMasked || n > 0) {
      mbar_wait(k_full(0), 0);
      wg_fence();
      issue_qk<T, kD>(s, qa, base + L::k);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      if (signals) mbar_arrive(k_empty(0));
      if constexpr (kMasked) {
        forbid_pairs(s, t, meta[0], fm_s, qoff);
        online_softmax<kExp2, true, true>(s, m, l, alpha, p.scale, valid_of(meta[0].tile), t);
      } else {
        online_softmax<kExp2, kPadMask>(s, m, l, alpha, p.scale, valid_of(0), t);
      }
      pack_frag<T, 8>(pf, s);
    }

    for (int j = 1; j < n; ++j) {
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
      if constexpr (kMasked) {
        const TileMeta& mt = meta[j % kMetaSlots];
        forbid_pairs(s, t, mt, fm_s, qoff);
        online_softmax<kExp2, true, true>(s, m, l, alpha, p.scale, valid_of(mt.tile), t);
      } else {
        online_softmax<kExp2, kPadMask>(s, m, l, alpha, p.scale, valid_of(j), t);
      }
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      if (signals) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_frag<T, 8>(pf, s);
    }
    if (!kMasked || n > 0) {
      const int sl = (n - 1) % kStages;
      mbar_wait(v_full(sl), ((n - 1) / kStages) & 1);
      fence_regs(o);
      fence_regs(pf);
      wg_fence();
      issue_pv<T, kD>(o, pf, base + L::v + sl * L::tile);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
    }

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
  flash_fwd_sm90_body<T, kD, true, true, true>(qm, km, vm, p, FrameMask{});
}

// K4: O and the natural-log lse under the frame mask; `scale` holds
// log2(e).
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_masked_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                             const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm, const Params p,
                             const FrameMask mask) {
  flash_fwd_sm90_body<T, kD, true, true, true, true>(qm, km, vm, p, mask);
}

// P1: O only; `scale` holds log2(e) when kExp2.
template <typename T, int kD, bool kExp2, bool kPadMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_exp2_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                       const __grid_constant__ CUtensorMap km,
                       const __grid_constant__ CUtensorMap vm, const Params p) {
  flash_fwd_sm90_body<T, kD, kExp2, kPadMask, false>(qm, km, vm, p, FrameMask{});
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// q, k and v's tensor maps.  0 or a tensor-map code.
template <typename T>
int encode_qkv(CUtensorMap (&m)[3], const void* q, const void* k, const void* v, int B, int Lq,
               int Lk, int N, int D, const FwdStrides& st) {
  int rc = encode<T>(&m[0], q, B, Lq, N, D, st.qb, st.ql, st.qh);
  if (rc == 0) rc = encode<T>(&m[1], k, B, Lk, N, D, st.kb, st.kl, st.kh);
  if (rc == 0) rc = encode<T>(&m[2], v, B, Lk, N, D, st.vb, st.vl, st.vh);
  return rc;
}

// K1 (kLse) or P1.  Returns 0, a cudaError_t or one of the codes above.
template <typename T, int kD, bool kExp2, bool kPadMask, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq,
           int Lk, int N, int D, const FwdStrides& st, float scale, cudaStream_t stream) {
  CUtensorMap m[3];
  const int rc = encode_qkv<T>(m, q, k, v, B, Lq, Lk, N, D, st);
  if (rc != 0) return rc;
  const Params p{o, lse, st.ob, st.ol, st.oh, Lq, Lk, N, D, scale};
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, N, B);
  constexpr int bytes = Layout<kD>::bytes;
  cudaError_t err;
  if constexpr (kLse) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<T, kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_sm90_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(m[0], m[1], m[2], p);
  } else {
    err = cudaFuncSetAttribute(flash_exp2_sm90_kernel<T, kD, kExp2, kPadMask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_exp2_sm90_kernel<T, kD, kExp2, kPadMask><<<grid, kThreads, bytes, stream>>>(
        m[0], m[1], m[2], p);
  }
  return (int)cudaGetLastError();
}

// K4: `mask.tiles` is the 128 x 128 coarse table ([ceil(Lq/128), nkt]),
// `scale` holds log2(e).  F up to kMaxFrames (the frame table's shared
// memory).
template <typename T, int kD>
int launch_masked(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int Lq, int Lk, int N, int D, const FwdStrides& st, float scale,
                  const FrameMask& mask, cudaStream_t stream) {
  if (mask.F <= 0 || mask.F > kMaxFrames || mask.nkt != (Lk + kBlockN - 1) / kBlockN)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];
  const int rc = encode_qkv<T>(m, q, k, v, B, Lq, Lk, N, D, st);
  if (rc != 0) return rc;
  const Params p{o, lse, st.ob, st.ol, st.oh, Lq, Lk, N, D, scale};
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, N, B);
  const int bytes = Layout<kD>::masked_bytes(mask.F);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_masked_fwd_sm90_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_masked_fwd_sm90_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(m[0], m[1], m[2], p,
                                                                        mask);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
