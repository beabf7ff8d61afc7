// Flash-attention backward for Hopper (sm_90a) on wgmma, TMA and warp
// specialisation: the bf16 / fp16 bodies of K2, K3, K5 and K6 (entries
// in csrc/flash_bwd.cu).
//
//  * K2 (`flash_bwd_dkv_sm90_kernel`, with `flash_bwd_dkv_reduce_kernel`)
//    replaces `_flash_bwd_dkv_kernel` (mmpl_tpu/ops/attention.py:373):
//    dV = sum P^T dO and dK = scale * sum dS^T Q over the queries.
//  * K5 (`flash_masked_bwd_dkv_sm90_kernel`) replaces
//    `_masked_bwd_dkv_kernel` (:783): the same under the frame mask, p = 0
//    on forbidden pairs and on rows whose lse is -inf (`_masked_p`, :771).
//  * K3 (`flash_bwd_dq_sm90_kernel`) replaces `_flash_bwd_dq_kernel`
//    (:417): dQ = scale * sum dS K over the keys.
//  * K6 (`flash_masked_bwd_dq_sm90_kernel`) replaces
//    `_masked_bwd_dq_kernel` (:821): the same under the frame mask.
//
// All recompute P = exp(scale * Q K^T - lse) from the natural-log lse that
// K1 saved (as exp2, with log2(e) folded into the scale and into each row's
// lse once), and dS = P o (dO V^T - delta) with delta = rowsum(dO o O) as
// the wrapper computed it.  P and dS are rounded to the input type before
// their products; every accumulator is fp32 (the known difference from the
// TPU kernels, ROADMAP.md Queue 3).
//
// What bounds them on an H100: operations (dKV 8 and dQ 6 FLOPs per
// query-key-dim triple against (Lq + Lk) * D elements in and out), so the
// design keeps the tensor cores fed:
//
//  * dKV block: 128 keys of one (b, head), 384 threads.  Warpgroup 0 is the
//    producer: one warp loads K and V once by TMA and streams 64-query Q
//    and dO tiles through a ring of kDkvStages stages (full and empty
//    mbarriers), writing the tile's 64 lse * log2(e) and delta values
//    beside them.  Warpgroups 1 and 2 own 64 keys each and run four wgmma
//    products a tile: S^T = K Q^T and dP^T = V dO^T (m64n64, both operands
//    K-major from shared memory), then P^T and dS^T in registers, then
//    dV += P^T dO and dK += dS^T Q (m64n{kD}, A from registers as packed
//    accumulators, dO and Q read MN-major through the transpose bit: one
//    TMA tile, two descriptors, nothing transposed).  setmaxnreg gives the
//    consumers 240 registers (the dK and dV accumulators alone are 128 at
//    D = 128).
//  * The query split: at short Lk (the training cross-attention, 4 key
//    blocks a head) the key blocks leave most SMs idle and each walks every
//    query tile alone.  With splits > 1 the grid runs `splits` blocks per
//    key block, each over its own contiguous share of the query tiles; they
//    write fp32 partials to a workspace [2, splits, B, N, Lk, D] and
//    `flash_bwd_dkv_reduce_kernel`, in the same call, sums them in a fixed
//    order (the same bits on every call), scales dK and writes dK and dV in
//    the input type.  The wrapper picks `splits` (ops/attention.py
//    `bwd_query_splits`); splits = 1 writes dK and dV directly.
//  * dQ block: 128 queries of one (b, head), the same three warpgroups.
//    Q and dO load once; K and V stream in 128-key tiles through
//    kDqStages stages.  Each consumer owns 64 queries, keeps its rows' lse
//    and delta in registers and runs S = Q K^T and dP = dO V^T (m64n128,
//    shared memory) and dQ += dS K (dS from registers, K MN-major).
//  * No overlap of products inside a consumer yet: the two consumers of a
//    block interleave on the tensor cores.
//  * K5, the frame mask: the dKV body walks only the 64-query tiles that
//    the coarse table (ops/attention.py `mask_tiles`, one byte per 64
//    queries x 128 keys, stored key-block major so that a block's tiles are
//    one contiguous row) admits, never split.  The producer warp reads the
//    row 32 tiles at a time (a ballot) and, beside each admitted tile's lse
//    and delta, writes its class and its 64 queries' rows of the frame
//    table (frame id times F) into the stage's QueryMeta; each consumer
//    warp counts the admitted tiles itself while K and V load.  Consumers
//    keep their two keys' frame ids in registers and the [F, F] table in
//    shared memory; on class-1 tiles only, a pass before the per-element
//    step sets the scores of forbidden pairs to -inf, so that p_ds, the same
//    step as K2's, gives them p = ex2(-inf) = 0.  Rows whose lse is -inf
//    (they saw no key in the forward) get p = 0 on every tile: the producer
//    hands them +inf as lse * log2(e), where ex2(s c - (-inf)) would be
//    +inf.  With both tests folded into p_ds's `keep` instead, K5 took
//    37.4 ms against 26.9-27.9 at the 1.3B teacher-forcing shape on an
//    H100 (chip_smoke.py kernel_masked): the tests held registers across
//    the whole step.  A block with no admitted tile writes dK = dV = 0.
//  * K6, the frame mask on the dQ body: K4's walk (the 128 x 128 table,
//    query-block major) on K3's body (flash_bwd_dq_sm90_body.cuh, included
//    by both kernels).  The producer becomes a warp that reads the block's
//    row 32 tiles a ballot and, beside each admitted tile's K and V, writes
//    the stage's TileMeta (the tile's index, its class, its 128 keys' frame
//    ids); each consumer warp counts the admitted tiles while Q and dO
//    load.  The table is held as bits (F * ceil(F / 32) words, built by the
//    block from the byte table at its start): a byte a pair on top of K3's
//    197,672 bytes would pass the H100's opt-in limit above F = 185.  As
//    in K5, class-1 tiles alone run a pass that sets forbidden scores to
//    -inf before K3's unchanged step (it reads the thread's two rows' frame
//    ids there: with the rows' table offsets held in registers instead, K6
//    took 2.4% longer at the 1.3B teacher-forcing shape on an H100,
//    mmpl_tpu_torch/tools/flash_compare.py), rows whose lse is -inf get
//    +inf as lse * log2(e), and keys past Lk are masked on the tile whose
//    own index is the last.  A block with no admitted tile writes dQ = 0.
//  * The ragged edges: TMA zero-fills rows past L and columns past D (D is
//    padded to kD = 64 or 128).  Query rows past Lq have q = dO = 0 and the
//    producer writes lse = delta = 0 for them without reading memory, so
//    they add exactly 0 to dK and dV.  Keys past Lk score 0, not -inf, and
//    exp2(-lse) can overflow, so p is set to 0 for them explicitly (the
//    keys of the last dQ tile, the key rows of a dKV block).  Rows past Lq
//    and Lk are not stored.
//
// Shared memory at kD = 128: dKV K and V 2 x 32 KB, Q and dO 3 x 2 x 16 KB
// (K5 adds a QueryMeta per stage and the F * F frame table); dQ Q and dO
// 2 x 32 KB, K and V 2 x 2 x 32 KB (K6 adds a TileMeta per stage and the
// table's bits, 4,608 bytes at F = 192).  One block per SM.
#pragma once

#include "sm90_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kBwdThreads = 384;      // producer warpgroup + two consumers
constexpr int kBwdConsumerWarps = 8;
constexpr int kKeyBlock = 128;        // dKV: keys of a block, 64 a consumer
constexpr int kQueryTile = 64;        // dKV: queries of a streamed Q / dO tile
constexpr int kQueryBlock = 128;      // dQ: queries of a block, 64 a consumer
constexpr int kKeyTile = 128;         // dQ: keys of a streamed K / V tile
constexpr int kDkvStages = 3;
constexpr int kDqStages = 2;
constexpr int kRowBytes = 128;        // one row of a box

// K6: 32-bit words of a row of the frame table's bits.
__host__ __device__ constexpr int fm_words(int F) { return (F + 31) / 32; }

// K5: a stage's 64 queries, beside their lse and delta.
struct QueryMeta {
  int cls;                          // 1: test each pair, 2: every pair allowed
  unsigned short fmrow[kQueryTile];  // frame id * F: the query's row of the table
  unsigned char pad[12];
};
static_assert(sizeof(QueryMeta) % 16 == 0, "QueryMeta slots stay 16-byte aligned");

struct BwdParams {
  void* out0;          // dK (dKV) or dQ
  void* out1;          // dV (dKV)
  float* ws;           // dKV, splits > 1: fp32 partials [2, splits, B, N, Lk, D]
  const float* lse;    // [B, N, Lq] fp32, natural log
  const float* delta;  // [B, N, Lq] fp32
  long long ab, al, ah, cb, cl, ch;  // out0's, out1's element strides (batch, row, head)
  int B, Lq, Lk, N, D, splits;
  float scale;         // the natural softmax scale: dK, dQ = scale * their sums
  float scale_log2;    // scale * log2(e), the exponent's
};

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int kD>
struct DkvLayout {
  static constexpr int halves = kD / kBox;
  static constexpr int kv_box = kKeyBlock * kRowBytes;   // [128 keys, 64 columns]
  static constexpr int kv_tile = halves * kv_box;
  static constexpr int q_box = kQueryTile * kRowBytes;   // [64 queries, 64 columns]
  static constexpr int q_tile = halves * q_box;
  static constexpr int k = 0;
  static constexpr int v = k + kv_tile;
  static constexpr int q = v + kv_tile;                  // Q of each stage
  static constexpr int d = q + kDkvStages * q_tile;      // dO of each stage
  static constexpr int rows = d + kDkvStages * q_tile;   // [stage][lse * log2(e) | delta][64]
  static constexpr int bar = rows + kDkvStages * 2 * kQueryTile * 4;
  // kv_full, then full and empty of each stage
  static constexpr int bytes = bar + 8 * (1 + 2 * kDkvStages) + 1024;  // + alignment slack
  // K5: a QueryMeta per stage after the barriers, then the [F, F] frame table
  static constexpr int meta = bar + 64;
  static constexpr int fm = meta + kDkvStages * (int)sizeof(QueryMeta);
  static constexpr int masked_bytes(int F) { return fm + (F * F + 15) / 16 * 16 + 1024; }
  static_assert(8 * (1 + 2 * kDkvStages) <= 64, "the barriers fit before the QueryMeta");
};

template <int kD>
struct DqLayout {
  static constexpr int halves = kD / kBox;
  static constexpr int box = kQueryBlock * kRowBytes;    // [128 rows, 64 columns]
  static constexpr int tile = halves * box;              // a Q, dO, K or V tile
  static constexpr int q = 0;
  static constexpr int d = q + tile;
  static constexpr int k = d + tile;                     // K of each stage
  static constexpr int v = k + kDqStages * tile;         // V of each stage
  static constexpr int bar = v + kDqStages * tile;
  // qd_full, then full and empty of each stage
  static constexpr int bytes = bar + 8 * (1 + 2 * kDqStages) + 1024;
  // K6: a TileMeta per stage after the barriers, then the [F, F] frame
  // table as bits (a byte a pair would pass the opt-in limit at kMaxFrames)
  static constexpr int meta = bar + 64;
  static constexpr int fm = meta + kDqStages * (int)sizeof(TileMeta);
  static constexpr int masked_bytes(int F) { return fm + 4 * F * fm_words(F) + 1024; }
  static_assert(8 * (1 + 2 * kDqStages) <= 64, "the barriers fit before the TileMeta");
};

static_assert(kQueryBlock == kKeyTile, "the dQ block's Q / dO and K / V boxes share DqLayout::box");
static_assert(sizeof(TileMeta::kf) == kKeyTile, "a TileMeta holds one key tile's frame ids");
static_assert(DkvLayout<128>::masked_bytes(kMaxFrames) <= kMaxSmem,
              "K5's frame table fits at kMaxFrames");
static_assert(DqLayout<128>::masked_bytes(kMaxFrames) <= kMaxSmem,
              "K6's frame table fits at kMaxFrames");

// The per-element step: p = exp2(s * scale_log2 - lse2) from the saved lse
// (lse2 = lse * log2(e)), 0 where `keep` is false, and dS = p (dP - delta).
// `s` becomes p and `dp` becomes dS, both fp32 until they are packed for
// their products.  A masked variant folds its pair test into `keep`.
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float delta,
                                     float scale_log2, bool keep) {
  const float p = keep ? ex2(s * scale_log2 - lse2) : 0.f;
  s = p;
  dp = p * (dp - delta);
}

// A consumer's [64, kD] accumulator times `mul`, rounded to T, into rows
// row0 + 16 w (+ 8) of a strided [L, D] slab; rows >= L and columns >= D
// are dropped.
template <typename T, int kD>
__device__ __forceinline__ void store_acc(T* dst, long long srow, int row0, int L, int D,
                                          const float (&acc)[kD / 2], float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    T* orow = dst + (long long)row * srow;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack2<T>(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
    }
  }
}

// The same accumulator in fp32 into a packed [L, D] slab of the workspace.
template <int kD>
__device__ __forceinline__ void store_partial(float* dst, int row0, int L, int D,
                                              const float (&acc)[kD / 2]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* orow = dst + (long long)row * D;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

// K2 (K5 with kMasked): dK and dV of 128 keys over this block's share of
// the query tiles (K5: the admitted ones of `mask`, whose `tiles` are the
// key-block-major table [ceil(Lk/128), nkt = ceil(Lq/64)]).
template <typename T, int kD, bool kMasked>
__device__ __forceinline__ void flash_bwd_dkv_sm90_body(const CUtensorMap& qm,
                                                        const CUtensorMap& km,
                                                        const CUtensorMap& vm,
                                                        const CUtensorMap& dm,
                                                        const BwdParams& p,
                                                        const FrameMask& mask) {
  using L = DkvLayout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::rows);
  // K5: the stages' QueryMeta and the frame table
  QueryMeta* const qmeta = reinterpret_cast<QueryMeta*>(smem_raw + (base - raw) + L::meta);
  unsigned char* const fm_s = smem_raw + (base - raw) + L::fm;
  const uint32_t kv_full = base + L::bar;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kDkvStages + s); };

  const int k0 = blockIdx.x * kKeyBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z / p.splits;
  const int z = blockIdx.z - b * p.splits;
  // this block's query tiles: [t0, t0 + nt), split z of `splits`
  const int nqt = (p.Lq + kQueryTile - 1) / kQueryTile;
  const int t0 = (int)((long long)z * nqt / p.splits);
  const int nt = (int)((long long)(z + 1) * nqt / p.splits) - t0;
  // K5 (splits = 1): this key block's row of the key-block-major table
  const unsigned char* const trow =
      kMasked ? mask.tiles + (long long)blockIdx.x * mask.nkt : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes (lane 0 with the TMA bytes)
      mbar_init(empty(s), kBwdConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kMasked) {
    for (int i = threadIdx.x; i < mask.F * mask.F; i += kBwdThreads) fm_s[i] = mask.fm[i];
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one warp; lane 0 issues the TMA loads, every lane two rows
    // of lse and delta
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kv_tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c) {
          tma_load(base + L::k + c * L::kv_box, km, kv_full, c * kBox, h, k0, b);
          tma_load(base + L::v + c * L::kv_box, vm, kv_full, c * kBox, h, k0, b);
        }
      }
      const long long rb = ((long long)b * p.N + h) * p.Lq;
      if constexpr (kMasked) {
        int i = 0;  // step of the walk: stage i % kDkvStages
        for (int c0 = 0; c0 < nqt; c0 += 32) {
          const int cls_l = c0 + lane < nqt ? trow[c0 + lane] : 0;
          for (uint32_t todo = __ballot_sync(0xffffffffu, cls_l != 0); todo; ++i) {
            const int bit = __ffs(todo) - 1;
            todo &= todo - 1;
            const int cls = __shfl_sync(0xffffffffu, cls_l, bit);
            const int s = i % kDkvStages;
            const int q0 = (c0 + bit) * kQueryTile;
            mbar_wait(empty(s), ((i / kDkvStages) & 1) ^ 1);  // the first round passes
            float* r = rows + s * 2 * kQueryTile;
            QueryMeta& mq = qmeta[s];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int row = q0 + lane + 32 * j;
              const bool in = row < p.Lq;  // past Lq nothing is read: 0, 0
              const float lse = in ? p.lse[rb + row] : 0.f;
              // a row that saw no key: +inf, so that p = ex2(s c - inf) = 0
              r[lane + 32 * j] = lse == -INFINITY ? INFINITY : lse * kLog2e;
              r[kQueryTile + lane + 32 * j] = in ? p.delta[rb + row] : 0.f;
              mq.fmrow[lane + 32 * j] = in ? mask.qf[row] * mask.F : 0;
            }
            if (lane == 0) {
              mq.cls = cls;
              mbar_expect_tx(full(s), 2 * L::q_tile);
#pragma unroll
              for (int c = 0; c < L::halves; ++c) {
                tma_load(base + L::q + s * L::q_tile + c * L::q_box, qm, full(s), c * kBox, h,
                         q0, b);
                tma_load(base + L::d + s * L::q_tile + c * L::q_box, dm, full(s), c * kBox, h,
                         q0, b);
              }
            } else {
              mbar_arrive(full(s));
            }
          }
        }
      } else {
        for (int i = 0; i < nt; ++i) {
          const int s = i % kDkvStages;
          const int q0 = (t0 + i) * kQueryTile;
          mbar_wait(empty(s), ((i / kDkvStages) & 1) ^ 1);  // the first round passes
          float* r = rows + s * 2 * kQueryTile;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int row = q0 + lane + 32 * j;
            const bool in = row < p.Lq;  // past Lq nothing is read: 0, 0
            r[lane + 32 * j] = in ? p.lse[rb + row] * kLog2e : 0.f;
            r[kQueryTile + lane + 32 * j] = in ? p.delta[rb + row] : 0.f;
          }
          if (lane == 0) {
            mbar_expect_tx(full(s), 2 * L::q_tile);
#pragma unroll
            for (int c = 0; c < L::halves; ++c) {
              tma_load(base + L::q + s * L::q_tile + c * L::q_box, qm, full(s), c * kBox, h, q0,
                       b);
              tma_load(base + L::d + s * L::q_tile + c * L::q_box, dm, full(s), c * kBox, h, q0,
                       b);
            }
          } else {
            mbar_arrive(full(s));
          }
        }
      }
    }
  } else {
    // consumers: 64 keys each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const uint32_t ka = base + L::k + cw * 64 * kRowBytes;
    const uint32_t va = base + L::v + cw * 64 * kRowBytes;
    const int key0 = k0 + cw * 64 + warp * 16 + g;  // this thread's keys key0, key0 + 8
    const bool keep0 = key0 < p.Lk;
    const bool keep1 = key0 + 8 < p.Lk;

    float dk[kD / 2], dv[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pf[4][4], df[4][4];

    // the steps of the walk: this split's query tiles, or K5's admitted
    // ones, which each warp counts while K and V load; K5 also keeps its
    // two keys' frame ids
    int n = nt;
    int kfr[2] = {0, 0};
    if constexpr (kMasked) {
      n = count_admitted(trow, nqt, lane);
      kfr[0] = keep0 ? mask.kf[key0] : 0;
      kfr[1] = keep1 ? mask.kf[key0 + 8] : 0;
    }

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kDkvStages;
      const uint32_t qa = base + L::q + s * L::q_tile;
      const uint32_t da = base + L::d + s * L::q_tile;
      mbar_wait(full(s), (i / kDkvStages) & 1);
      fence_regs(dk);
      fence_regs(dv);
      wg_fence();
      issue_ss<T, kD, 64>(st, ka, L::kv_box, qa, L::q_box);   // S^T = K Q^T
      issue_ss<T, kD, 64>(dpt, va, L::kv_box, da, L::q_box);  // dP^T = V dO^T
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // element e is key row g + 8 ((e >> 1) & 1), query column c below
      const float* r = rows + s * 2 * kQueryTile;
      if constexpr (kMasked) {
        // a class-1 tile: the pairs the frame table forbids score -inf
        const QueryMeta& mq = qmeta[s];
        if (mq.cls != 2) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (!fm_s[mq.fmrow[8 * (e / 4) + 2 * t + (e & 1)] + kfr[(e >> 1) & 1]])
              st[e] = -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e / 4) + 2 * t + (e & 1);
        p_ds(st[e], dpt[e], r[c], r[kQueryTile + c], p.scale_log2, (e & 2) ? keep1 : keep0);
      }
      pack_frag<T, 4>(pf, st);
      pack_frag<T, 4>(df, dpt);
      fence_regs(pf);
      fence_regs(df);
      wg_fence();
      issue_rs<T, kD, kQueryTile>(dv, pf, da, L::q_box);  // dV += P^T dO
      issue_rs<T, kD, kQueryTile>(dk, df, qa, L::q_box);  // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (signals) mbar_arrive(empty(s));
    }

    if (p.splits == 1) {
      store_acc<T, kD>(static_cast<T*>(p.out0) + b * p.ab + h * p.ah, p.al, key0, p.Lk, p.D,
                       dk, p.scale);
      store_acc<T, kD>(static_cast<T*>(p.out1) + b * p.cb + h * p.ch, p.cl, key0, p.Lk, p.D,
                       dv, 1.f);
    } else {
      const long long plane = (long long)p.B * p.N * p.Lk * p.D;
      float* wk = p.ws + z * plane + ((long long)b * p.N + h) * p.Lk * p.D;
      store_partial<kD>(wk, key0, p.Lk, p.D, dk);
      store_partial<kD>(wk + p.splits * plane, key0, p.Lk, p.D, dv);
    }
  }
}

// K2: dK and dV of 128 keys over this block's share of the query tiles.
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                          const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap vm,
                          const __grid_constant__ CUtensorMap dm, const BwdParams p) {
  flash_bwd_dkv_sm90_body<T, kD, false>(qm, km, vm, dm, p, FrameMask{});
}

// K5: dK and dV of 128 keys over the query tiles the frame mask admits.
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_masked_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                                 const __grid_constant__ CUtensorMap km,
                                 const __grid_constant__ CUtensorMap vm,
                                 const __grid_constant__ CUtensorMap dm, const BwdParams p,
                                 const FrameMask mask) {
  flash_bwd_dkv_sm90_body<T, kD, true>(qm, km, vm, dm, p, mask);
}

// K2's second pass when splits > 1: dK = scale * sum_z partial dK, dV =
// sum_z partial dV, summed in the order z = 0, 1, ..., four values a
// thread, written in T at the outputs' strides.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dkv_reduce_kernel(const BwdParams p) {
  const long long plane = (long long)p.B * p.N * p.Lk * p.D;
  const long long n4 = plane / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int which = i >= n4;  // 0: dK, 1: dV
    const long long e = (i - which * n4) * 4;
    const float* src = p.ws + which * p.splits * plane + e;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int z = 1; z < p.splits; ++z) {
      const float4 x = *reinterpret_cast<const float4*>(src + z * plane);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int d = (int)(e % p.D);
    const long long row = e / p.D;  // (b, h, key)
    const int key = (int)(row % p.Lk);
    const long long bh = row / p.Lk;
    const int h = (int)(bh % p.N);
    const int b = (int)(bh / p.N);
    const float mul = which ? 1.f : p.scale;
    T* out = which ? static_cast<T*>(p.out1) + b * p.cb + key * p.cl + h * p.ch
                   : static_cast<T*>(p.out0) + b * p.ab + key * p.al + h * p.ah;
    uint2 packed;
    packed.x = pack2<T>(acc.x * mul, acc.y * mul);
    packed.y = pack2<T>(acc.z * mul, acc.w * mul);
    *reinterpret_cast<uint2*>(out + d) = packed;
  }
}

// K6, on a class-1 tile: the scores of the pairs that the frame table's
// bits `fmw` (row f in fm_words(F) words, bit k % 32 of word k / 32)
// forbid become -inf; this thread's rows are row0 and row0 + 8.
__device__ __forceinline__ void forbid_pairs_bits(float (&s)[64], int t, const TileMeta& mt,
                                                  const uint32_t* fmw, const FrameMask& mask,
                                                  int row0, int Lq) {
  if (mt.cls != 2) {
    const int words = fm_words(mask.F);
    int qoff[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qoff[r] = row0 + 8 * r < Lq ? mask.qf[row0 + 8 * r] * words : 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kf = mt.kf[8 * (i / 4) + 2 * t + (i & 1)];
      if (!((fmw[qoff[(i >> 1) & 1] + (kf >> 5)] >> (kf & 31)) & 1u)) s[i] = -INFINITY;
    }
  }
}

// K3: dQ of 128 queries over every key tile.
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                         const __grid_constant__ CUtensorMap km,
                         const __grid_constant__ CUtensorMap vm,
                         const __grid_constant__ CUtensorMap dm, const BwdParams p) {
  constexpr bool kMasked = false;
  const FrameMask mask{};
#include "flash_bwd_dq_sm90_body.cuh"
}

// K6: dQ of 128 queries over the key tiles the frame mask admits.
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_masked_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                                const __grid_constant__ CUtensorMap km,
                                const __grid_constant__ CUtensorMap vm,
                                const __grid_constant__ CUtensorMap dm, const BwdParams p,
                                const FrameMask mask) {
  constexpr bool kMasked = true;
#include "flash_bwd_dq_sm90_body.cuh"
}

// ---------------------------------------------------------------------------
// Host side: the launches.  `st` holds the element strides (batch, row,
// head) of q, k, v and dO.  Each returns 0, a cudaError_t or one of the
// tensor-map codes of sm90_common.cuh.
// ---------------------------------------------------------------------------

template <typename T>
int encode_qkvd(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                const void* dout, const long long* st, const BwdParams& p, int q_rows,
                int k_rows) {
  int rc = encode<T>(&m[0], q, p.B, p.Lq, p.N, p.D, st[0], st[1], st[2], q_rows);
  if (rc == 0) rc = encode<T>(&m[1], k, p.B, p.Lk, p.N, p.D, st[3], st[4], st[5], k_rows);
  if (rc == 0) rc = encode<T>(&m[2], v, p.B, p.Lk, p.N, p.D, st[6], st[7], st[8], k_rows);
  if (rc == 0) rc = encode<T>(&m[3], dout, p.B, p.Lq, p.N, p.D, st[9], st[10], st[11], q_rows);
  return rc;
}

// K5 (splits = 1): `mask.tiles` is the key-block-major 64 x 128 table.
template <typename T, int kD>
int launch_masked_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const long long* st, const BwdParams& p, const FrameMask& mask,
                      cudaStream_t stream) {
  if (p.splits != 1 || mask.F <= 0 || mask.F > kMaxFrames) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  const int rc = encode_qkvd<T>(m, q, k, v, dout, st, p, kQueryTile, kKeyBlock);
  if (rc != 0) return rc;
  const int bytes = DkvLayout<kD>::masked_bytes(mask.F);
  const cudaError_t err = cudaFuncSetAttribute(flash_masked_bwd_dkv_sm90_kernel<T, kD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Lk + kKeyBlock - 1) / kKeyBlock, p.N, p.B);
  flash_masked_bwd_dkv_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(m[0], m[1], m[2],
                                                                               m[3], p, mask);
  return (int)cudaGetLastError();
}

// K6: `mask.tiles` is the 128 x 128 table ([ceil(Lq/128), nkt]).
template <typename T, int kD>
int launch_masked_dq(const void* q, const void* k, const void* v, const void* dout,
                     const long long* st, const BwdParams& p, const FrameMask& mask,
                     cudaStream_t stream) {
  if (mask.F <= 0 || mask.F > kMaxFrames) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  const int rc = encode_qkvd<T>(m, q, k, v, dout, st, p, kQueryBlock, kKeyTile);
  if (rc != 0) return rc;
  const int bytes = DqLayout<kD>::masked_bytes(mask.F);
  const cudaError_t err = cudaFuncSetAttribute(flash_masked_bwd_dq_sm90_kernel<T, kD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Lq + kQueryBlock - 1) / kQueryBlock, p.N, p.B);
  flash_masked_bwd_dq_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(m[0], m[1], m[2],
                                                                              m[3], p, mask);
  return (int)cudaGetLastError();
}

// K2, then its reduce when p.splits > 1 (p.ws holding the partials).
template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const long long* st, const BwdParams& p, cudaStream_t stream) {
  CUtensorMap m[4];
  const int rc = encode_qkvd<T>(m, q, k, v, dout, st, p, kQueryTile, kKeyBlock);
  if (rc != 0) return rc;
  constexpr int bytes = DkvLayout<kD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Lk + kKeyBlock - 1) / kKeyBlock, p.N, p.B * p.splits);
  flash_bwd_dkv_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(m[0], m[1], m[2],
                                                                        m[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long n4 = 2LL * p.B * p.N * p.Lk * p.D / 4;
  const long long most = 132LL * 16;  // a grid-stride loop past this
  const int blocks = (int)((n4 + 255) / 256 < most ? (n4 + 255) / 256 : most);
  flash_bwd_dkv_reduce_kernel<T><<<blocks, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// K3.
template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const long long* st, const BwdParams& p, cudaStream_t stream) {
  CUtensorMap m[4];
  const int rc = encode_qkvd<T>(m, q, k, v, dout, st, p, kQueryBlock, kKeyTile);
  if (rc != 0) return rc;
  constexpr int bytes = DqLayout<kD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Lq + kQueryBlock - 1) / kQueryBlock, p.N, p.B);
  flash_bwd_dq_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(m[0], m[1], m[2], m[3],
                                                                       p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
