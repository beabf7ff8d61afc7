// K2 and K3's bf16 / fp16 Hopper bodies (flash_bwd_sm90.cuh) under three
// other schedules, for the shapes where one block per key block or per
// query block exposes each block's fill and drain, or where K2 and K3
// apart repeat two products (ops/attention.py `bwd_schedule` picks the
// schedule; csrc/flash_bwd.cu `mmpl_flash_bwd_sched` launches it; the
// third, the ordered walk, is described before its kernel below):
//
//  * The fused walk (`flash_bwd_fused_sm90_kernel`), where the queries fit
//    one 64-row tile (the GAN head's one query row over 32760 keys): K2's
//    grid there is 6,144 blocks of 128 keys, each streaming one Q / dO tile
//    with a prologue (K and V by TMA) and an epilogue (dK and dV) that
//    nothing overlaps, and K3 reads K and V a second time from 24 blocks
//    that each walk every key tile alone.  Here min(#SMs, units) blocks
//    walk the units (128-key block, head, batch) in one pipeline: the
//    producer loads the next unit's K / V and Q / dO into the second of two
//    buffers while the consumers finish the current unit.  Each consumer
//    warpgroup owns 64 keys and runs K2's step once (S^T = K Q^T, dP^T = V
//    dO^T, P^T and dS^T, dV = P^T dO, dK = dS^T Q).  Then dQ's share of the
//    unit is computed from what is already resident: each consumer writes
//    its dS^T (64 keys x 64 queries, rounded to T) to shared memory, and,
//    once both have, consumer c runs dQ[:, 64 c .. 64 c + 63] = dS K over
//    the unit's 128 keys (wgmma m64n64, A = dS^T and B = K both MN-major,
//    read through the transpose bits).  That fp32 partial (rows < Lq) goes
//    to a workspace [nkb, B, N, Lq, D]; `flash_bwd_dq_reduce_kernel` sums
//    the key blocks' partials in a fixed order (the same bits every call,
//    no atomics), scales and rounds, launched with programmatic dependent
//    launch.  dK and dV leave through shared memory and TMA stores: dV
//    into the consumer's rows of the unit's V buffer (dead after dP^T), dK
//    into its rows of the K buffer once both dQ products have read K; the
//    buffer goes back to the producer once the stores have read it,
//    checked a unit later so that the wait overlaps that unit's products.
//  * The persistent dQ walk (`flash_bwd_dq_persistent_sm90_kernel`), short
//    keys (the teacher-forcing and score cross-attention, 512 keys: 4 key
//    tiles a 128-query block): K3's step over the units (128-query block,
//    head, batch).  Two Q / dO buffers beside K3's two 128-key K / V stages
//    would take 256 KB, so the keys stream in 64-key tiles (three stages of
//    2 x 16 KB at kD = 128) and the producer loads the next unit's Q and dO
//    while the consumers finish the current one; each consumer thread reads
//    its rows' lse and delta a unit ahead into registers.  dQ leaves
//    through shared memory (the consumer's rows of the unit's Q buffer, dead
//    after its last S) and a TMA store.
//
// What bounds them: at one query row the bytes of K and V in and of dK and
// dV out (the fused walk reads K and V once for all three gradients, where
// K2 and K3 read them twice); at short keys operations and the L2.  Every
// unit runs the parent's arithmetic: exp2 with log2(e) folded into the
// scale and each row's lse, P and dS rounded to T before their products,
// fp32 accumulators, keys past Lk masked per element, query rows past Lq
// zero (q = dO = 0, lse = delta = 0) and never stored.  Both kernels run at
// kD = 128 for every D (the head dim past D loads as zeros and is not
// stored).  Shared memory at kD = 128: fused 2 x (K, V 64 KB) + 2 x (Q, dO
// 32 KB) + dS^T 16 KB, 210 KB; persistent dQ 2 x (Q, dO 64 KB) + 3 x (K, V
// 32 KB), 224 KB.
#pragma once

#include "flash_bwd_sm90.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kBwdBufs = 2;         // the current unit's buffers and the next one's
constexpr int kDqpKeyTile = 64;     // the persistent dQ walk's key tile
constexpr int kDqpStages = 3;       // (two: 4% slower at 512 keys on the H100)
constexpr int kDqReduceWarps = 32;  // the reduce's ranges of key blocks
constexpr int kDqReduceLoads = 8;   // a lane's loads in flight

struct BwdSchedParams {
  const float* lse;    // [B, N, Lq] fp32, natural log
  const float* delta;  // [B, N, Lq] fp32
  float* ws;           // fused: fp32 dQ partials [nkb, B, N, Lq, D]
  int B, N, Lq, Lk, D;
  int nkb;             // fused: ceil(Lk / 128)
  int qblocks;         // persistent dQ: ceil(Lq / 128)
  int nkt;             // persistent dQ: ceil(Lk / 64)
  int units;
  float scale;         // the natural softmax scale
  float scale_log2;    // scale * log2(e), the exponent's
};

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int kD>
struct FusedLayout {
  static constexpr int halves = kD / kBox;
  static constexpr int kv_box = kKeyBlock * kRowBytes;  // [128 keys, 64 columns]
  static constexpr int kv_tile = halves * kv_box;
  static constexpr int kv_buf = 2 * kv_tile;             // K, then V
  static constexpr int q_box = kQueryTile * kRowBytes;   // [64 queries, 64 columns]
  static constexpr int q_tile = halves * q_box;
  static constexpr int qd_buf = 2 * q_tile;              // Q, then dO
  static constexpr int ds_rows = 64 * kRowBytes;         // a consumer's dS^T rows
  static constexpr int kv = 0;
  static constexpr int qd = kv + kBwdBufs * kv_buf;
  static constexpr int ds = qd + kBwdBufs * qd_buf;      // dS^T [128 keys, 64 queries]
  static constexpr int rows = ds + 2 * ds_rows;          // [buf][lse * log2(e) | delta][64]
  static constexpr int bar = rows + kBwdBufs * 2 * kQueryTile * 4;
  // kv_full, kv_empty, qd_full, qd_empty of each buffer
  static constexpr int bytes = bar + 8 * 4 * kBwdBufs + 1024;  // + alignment slack
};
static_assert(FusedLayout<128>::bytes <= kMaxSmem, "the fused walk's buffers fit");

template <int kD>
struct DqpLayout {
  static constexpr int halves = kD / kBox;
  static constexpr int q_box = kQueryBlock * kRowBytes;  // [128 queries, 64 columns]
  static constexpr int q_tile = halves * q_box;
  static constexpr int qd_buf = 2 * q_tile;              // Q, then dO
  static constexpr int k_box = kDqpKeyTile * kRowBytes;  // [64 keys, 64 columns]
  static constexpr int k_tile = halves * k_box;
  static constexpr int qd = 0;
  static constexpr int k = qd + kBwdBufs * qd_buf;       // K of each stage
  static constexpr int v = k + kDqpStages * k_tile;      // V of each stage
  static constexpr int bar = v + kDqpStages * k_tile;
  // qd_full, qd_empty of each buffer, then full and empty of each stage
  static constexpr int bytes = bar + 8 * (2 * kBwdBufs + 2 * kDqpStages) + 1024;
};
static_assert(DqpLayout<128>::bytes <= kMaxSmem, "the persistent dQ walk's buffers fit");

// d = A B for one k16 step, m64n64, both operands MN-major in shared memory
// (the transpose bits): the fused walk's dQ = dS K, its contraction the
// keys, A = dS^T and B = K as they lie.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d);

#define MMPL_WGMMA_SS_N64_TT(T, TY)                                                        \
  template <>                                                                              \
  __device__ __forceinline__ void wgmma_ss_n64_tt<T>(float (&d)[32], uint64_t a,           \
                                                     uint64_t b, int scale_d) {            \
    asm volatile(                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                        \
        "{"                                                                                \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
        "%32, %33, p, 1, 1, 1, 1;\n}\n"                                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),    \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),    \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                                         \
        : "l"(a), "l"(b), "r"(scale_d));                                                   \
  }
MMPL_WGMMA_SS_N64_TT(__nv_bfloat16, "bf16")
MMPL_WGMMA_SS_N64_TT(__half, "f16")
#undef MMPL_WGMMA_SS_N64_TT

__device__ __forceinline__ void st_shared32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// A consumer's [64, kD] accumulator times `mul`, rounded to T, into its 64
// rows of a tile of 128-byte-swizzled [rows, 64 columns] boxes at `rows0`
// (box c `box` bytes past box 0), for a TMA store.
template <typename T, int kD>
__device__ __forceinline__ void acc_to_boxes(uint32_t rows0, int box, const float (&acc)[kD / 2],
                                             float mul, int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rt = warp * 16 + g + 8 * r;  // row of the warpgroup's 64
    // the 16-byte unit c % 8 of row rt sits at unit (c % 8) ^ (rt % 8),
    // rt % 8 == g: a warp's stores fall on 32 banks
#pragma unroll
    for (int c = 0; c < kD / 8; ++c)
      st_shared32(rows0 + (c / 8) * box + rt * 128 + (((c % 8) ^ g) << 4) + 4 * t,
                  pack2<T>(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul));
  }
}

// The fused walk's unit: 128 keys from k0 of (b, h).  Units run head
// fastest, then key block and batch, so that the blocks of a wave read and
// write whole rows of K, V, dK and dV (every head's 256 bytes of a row) at
// once: key block fastest left each row's other heads to later waves, and
// the walk took 2.5-3% longer at the GAN head's one query row on the H100.
struct KvUnit {
  int kb, h, b;
};

__device__ __forceinline__ KvUnit kv_unit_of(int u, const BwdSchedParams& p) {
  KvUnit w;
  w.h = u % p.N;
  const int r = u / p.N;
  w.kb = r % p.nkb;
  w.b = r / p.nkb;
  return w;
}

// The same over N heads and nkb key blocks (the ordered walk's units).
__device__ __forceinline__ KvUnit kv_unit_of(int u, int N, int nkb) {
  KvUnit w;
  w.h = u % N;
  const int r = u / N;
  w.kb = r % nkb;
  w.b = r / nkb;
  return w;
}

// K2 + K3 where Lq <= 64: dK and dV of each unit through TMA stores, its
// dQ partial into the workspace.
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_fused_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap dm,
                            const __grid_constant__ CUtensorMap dkm,
                            const __grid_constant__ CUtensorMap dvm, const BwdSchedParams p) {
  static_assert(kD == 128, "the fused walk splits dQ's 128 columns between its consumers");
  using L = FusedLayout<kD>;
  // the reduce may launch now and wait (its griddepcontrol.wait) for this
  // grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::rows);
  const uint32_t bars = base + L::bar;
  auto kv_full = [&](int n) { return bars + 8 * n; };
  auto kv_empty = [&](int n) { return bars + 8 * (kBwdBufs + n); };
  auto qd_full = [&](int n) { return bars + 8 * (2 * kBwdBufs + n); };
  auto qd_empty = [&](int n) { return bars + 8 * (3 * kBwdBufs + n); };
  auto kvbuf = [&](int i) { return base + L::kv + i % kBwdBufs * L::kv_buf; };
  auto qdbuf = [&](int i) { return base + L::qd + i % kBwdBufs * L::qd_buf; };
  // the parity of a buffer's i-th filling
  auto parity = [&](int i) { return (uint32_t)(i / kBwdBufs) & 1; };

  if (threadIdx.x == 0) {
    for (int n = 0; n < kBwdBufs; ++n) {
      mbar_init(kv_full(n), 1);
      mbar_init(kv_empty(n), 2);  // each consumer's lead, once its stores have read it
      mbar_init(qd_full(n), 32);  // the producer warp's lanes (lane 0 with the TMA bytes)
      mbar_init(qd_empty(n), kBwdConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one warp; lane 0 issues the TMA loads, every lane two rows
    // of lse and delta
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int u = blockIdx.x, i = 0; u < p.units; u += gridDim.x, ++i) {
        const KvUnit w = kv_unit_of(u, p);
        const int n = i % kBwdBufs;
        const uint32_t free_parity = parity(i) ^ 1;  // the first filling passes
        if (lane == 0) {
          mbar_wait(kv_empty(n), free_parity);
          mbar_expect_tx(kv_full(n), L::kv_buf);
#pragma unroll
          for (int c = 0; c < L::halves; ++c) {
            tma_load(kvbuf(i) + c * L::kv_box, km, kv_full(n), c * kBox, w.h, w.kb * kKeyBlock,
                     w.b);
            tma_load(kvbuf(i) + L::kv_tile + c * L::kv_box, vm, kv_full(n), c * kBox, w.h,
                     w.kb * kKeyBlock, w.b);
          }
        }
        mbar_wait(qd_empty(n), free_parity);
        float* r = rows + n * 2 * kQueryTile;
        const long long rb = ((long long)w.b * p.N + w.h) * p.Lq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = lane + 32 * j;
          const bool in = row < p.Lq;  // past Lq nothing is read: 0, 0
          r[row] = in ? p.lse[rb + row] * kLog2e : 0.f;
          r[kQueryTile + row] = in ? p.delta[rb + row] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(qd_full(n), L::qd_buf);
#pragma unroll
          for (int c = 0; c < L::halves; ++c) {
            tma_load(qdbuf(i) + c * L::q_box, qm, qd_full(n), c * kBox, w.h, 0, w.b);
            tma_load(qdbuf(i) + L::q_tile + c * L::q_box, dm, qd_full(n), c * kBox, w.h, 0, w.b);
          }
        } else {
          mbar_arrive(qd_full(n));
        }
      }
    }
  } else {
    // consumers: 64 keys of each unit each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const bool lead = tid == 0;      // stores dK and dV, gives the K / V buffer back
    const uint32_t mine = cw * 64 * kRowBytes;  // this consumer's rows of a box
    const uint32_t ds = base + L::ds;

    float dk[kD / 2], dv[kD / 2];
    float st[32], dpt[32];
    uint32_t pf[4][4], df[4][4];
    int release = -1;  // the K / V buffer whose dK / dV stores are out, to give back

    // the K / V buffer back to the producer once its stores have read it
    auto give_back = [&]() {
      if (release >= 0) {
        if (lead) {
          bulk_wait<0, true>();
          mbar_arrive(kv_empty(release));
        }
        release = -1;
      }
    };

    for (int u = blockIdx.x, i = 0; u < p.units; u += gridDim.x, ++i) {
      const KvUnit w = kv_unit_of(u, p);
      const int n = i % kBwdBufs;
      const uint32_t ka = kvbuf(i) + mine;
      const uint32_t va = kvbuf(i) + L::kv_tile + mine;
      const uint32_t qa = qdbuf(i);
      const uint32_t da = qdbuf(i) + L::q_tile;
      const int k0 = w.kb * kKeyBlock;
      const int key0 = k0 + cw * 64 + warp * 16 + g;  // this thread's keys key0, key0 + 8
      const bool keep0 = key0 < p.Lk;
      const bool keep1 = key0 + 8 < p.Lk;
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) dk[c] = dv[c] = 0.f;

      mbar_wait(kv_full(n), parity(i));
      mbar_wait(qd_full(n), parity(i));
      fence_regs(dk);
      fence_regs(dv);
      wg_fence();
      issue_ss<T, kD, 64>(st, ka, L::kv_box, qa, L::q_box);   // S^T = K Q^T
      issue_ss<T, kD, 64>(dpt, va, L::kv_box, da, L::q_box);  // dP^T = V dO^T
      wg_commit();
      give_back();  // the last unit's buffer, while the products run
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // element e is key row g + 8 ((e >> 1) & 1), query column c below
      const float* r = rows + n * 2 * kQueryTile;
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
      issue_rs<T, kD, kQueryTile>(dv, pf, da, L::q_box);  // dV = P^T dO
      issue_rs<T, kD, kQueryTile>(dk, df, qa, L::q_box);  // dK = dS^T Q
      wg_commit();
      // dS^T to its rows [64 cw, 64 cw + 64) of the dS^T tile while the
      // products run: df[kk][e] holds queries 16 kk + 8 (e >> 1) + 2 t and
      // + 1 of key row g + 8 (e & 1) of the warp's 16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rt = warp * 16 + g + 8 * (e & 1);
          st_shared32(ds + mine + rt * 128 + (((2 * kk + (e >> 1)) ^ g) << 4) + 4 * t, df[kk][e]);
        }
      fence_async_smem();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (signals) mbar_arrive(qd_empty(n));  // Q and dO are read
      // dV into this consumer's rows of the V buffer (dead since dP^T)
      acc_to_boxes<T, kD>(va, L::kv_box, dv, 1.f, warp, g, t);
      // both consumers' dS^T are in: dQ's columns [64 cw, 64 cw + 64) over
      // the unit's 128 keys
      bar_sync(1, 256);
      float dq[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKeyBlock / 16; ++kk)
        wgmma_ss_n64_tt<T>(dq, smem_desc(ds + kk * 16 * kRowBytes, 64 * kRowBytes),
                           smem_desc(kvbuf(i) + cw * L::kv_box + kk * 16 * kRowBytes, L::kv_box),
                           kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      // both dQ products have read K (and dS^T): dK into this consumer's
      // rows of the K buffer, then both tiles out by TMA
      bar_sync(1, 256);
      acc_to_boxes<T, kD>(ka, L::kv_box, dk, p.scale, warp, g, t);
      fence_async_smem();
      bar_sync(2 + cw, 128);
      if (lead) {
#pragma unroll
        for (int c = 0; c < L::halves; ++c) {
          tma_store(dkm, ka + c * L::kv_box, c * kBox, w.h, k0 + cw * 64, w.b);
          tma_store(dvm, va + c * L::kv_box, c * kBox, w.h, k0 + cw * 64, w.b);
        }
        bulk_commit();
      }
      release = n;
      // the fp32 partial's rows < Lq: element e is query row g + 8 ((e >>
      // 1) & 1) of the warp's 16, column 64 cw + 8 (e / 4) + 2 t + (e & 1)
      float* const part = p.ws + (((long long)w.kb * p.B + w.b) * p.N + w.h) * p.Lq * p.D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = warp * 16 + g + 8 * rr;
        if (row >= p.Lq) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = cw * 64 + 8 * c + 2 * t;
          if (col < p.D)
            *reinterpret_cast<float2*>(part + (long long)row * p.D + col) =
                make_float2(dq[4 * c + 2 * rr], dq[4 * c + 2 * rr + 1]);
        }
      }
    }
    if (lead) bulk_wait<0, false>();  // the last stores are out
  }
}

// The fused walk's second pass: dQ = scale * sum_z partial_z over the key
// blocks, summed in a fixed order: warp w of a block sums z in [w nkb / W,
// (w + 1) nkb / W) of the W = kDqReduceWarps in order from 0, then the W
// warps' sums are added in order w = 0, 1, ... from 0 (ops/attention.py
// `_dq_partials_summed`), two values a lane, 64 consecutive values of [B,
// N, Lq, D] a block; written in T at dQ's element strides.  The partials
// sit in the L2, so the time is the loads' latency: 32 warps of a lane's 8
// loads at once (8 warps of 4 at a time left 19 us after the walk at the
// GAN head's 256 key blocks, 32 of 8 about 8 us, on the H100).
template <typename T>
__global__ void __launch_bounds__(32 * kDqReduceWarps)
flash_bwd_dq_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dq, int B, int N,
                           int Lq, int D, int nkb, long long ab, long long al, long long ah,
                           float scale) {
  // launched while the fused walk runs (programmatic dependent launch):
  // wait for its grid and its stores
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float2 part[kDqReduceWarps][32];
  const long long plane = (long long)B * N * Lq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long e = (long long)blockIdx.x * 64 + 2 * lane;  // D is even: e, e + 1 share a row
  float2 acc = make_float2(0.f, 0.f);
  if (e < plane) {
    // kDqReduceLoads loads in flight, then their sums in order
    const int z1 = (warp + 1) * nkb / kDqReduceWarps;
    int z = warp * nkb / kDqReduceWarps;
    for (; z + kDqReduceLoads <= z1; z += kDqReduceLoads) {
      float2 x[kDqReduceLoads];
#pragma unroll
      for (int i = 0; i < kDqReduceLoads; ++i)
        x[i] = *reinterpret_cast<const float2*>(ws + (z + i) * plane + e);
#pragma unroll
      for (int i = 0; i < kDqReduceLoads; ++i) {
        acc.x += x[i].x;
        acc.y += x[i].y;
      }
    }
    for (; z < z1; ++z) {
      const float2 x = *reinterpret_cast<const float2*>(ws + z * plane + e);
      acc.x += x.x;
      acc.y += x.y;
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || e >= plane) return;
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kDqReduceWarps; ++w) {
    s.x += part[w][lane].x;
    s.y += part[w][lane].y;
  }
  const int d = (int)(e % D);
  const long long row = e / D;  // (b, h, query)
  const int q = (int)(row % Lq);
  const long long bh = row / Lq;
  T* out = dq + bh / N * ab + bh % N * ah + (long long)q * al + d;
  *reinterpret_cast<uint32_t*>(out) = pack2<T>(s.x * scale, s.y * scale);
}

// The persistent dQ walk's unit: 128 queries from q0 of (b, h).  Units run
// head fastest, as the fused walk's: a wave reads whole rows of Q and dO
// and writes whole rows of dQ (K and V, a few hundred keys, sit in the L2;
// query block fastest ran no faster on the H100).
struct QUnit {
  int q0, h, b;
};

__device__ __forceinline__ QUnit q_unit_of(int u, const BwdSchedParams& p) {
  QUnit w;
  w.h = u % p.N;
  const int r = u / p.N;
  w.q0 = r % p.qblocks * kQueryBlock;
  w.b = r / p.qblocks;
  return w;
}

// K3 over short keys: the persistent walk, dQ through a TMA store (`dqm`,
// 64-row boxes).
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_persistent_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                                    const __grid_constant__ CUtensorMap km,
                                    const __grid_constant__ CUtensorMap vm,
                                    const __grid_constant__ CUtensorMap dm,
                                    const __grid_constant__ CUtensorMap dqm,
                                    const BwdSchedParams p) {
  using L = DqpLayout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::bar;
  auto qd_full = [&](int n) { return bars + 8 * n; };
  auto qd_empty = [&](int n) { return bars + 8 * (kBwdBufs + n); };
  auto full = [&](int s) { return bars + 8 * (2 * kBwdBufs + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kBwdBufs + kDqpStages + s); };
  auto qdbuf = [&](int i) { return base + L::qd + i % kBwdBufs * L::qd_buf; };
  auto parity = [&](int i) { return (uint32_t)(i / kBwdBufs) & 1; };

  if (threadIdx.x == 0) {
    for (int n = 0; n < kBwdBufs; ++n) {
      mbar_init(qd_full(n), 1);
      mbar_init(qd_empty(n), 2);  // each consumer's lead, once its dQ store has read it
    }
    for (int s = 0; s < kDqpStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kBwdConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one thread loads each unit's Q and dO, then its K / V
    // tiles
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int j = 0;  // step of the walk: stage j % kDqpStages
      for (int u = blockIdx.x, i = 0; u < p.units; u += gridDim.x, ++i) {
        const QUnit w = q_unit_of(u, p);
        const int n = i % kBwdBufs;
        mbar_wait(qd_empty(n), parity(i) ^ 1);  // the first filling passes
        mbar_expect_tx(qd_full(n), L::qd_buf);
#pragma unroll
        for (int c = 0; c < L::halves; ++c) {
          tma_load(qdbuf(i) + c * L::q_box, qm, qd_full(n), c * kBox, w.h, w.q0, w.b);
          tma_load(qdbuf(i) + L::q_tile + c * L::q_box, dm, qd_full(n), c * kBox, w.h, w.q0,
                   w.b);
        }
        for (int kt = 0; kt < p.nkt; ++kt, ++j) {
          const int s = j % kDqpStages;
          mbar_wait(empty(s), ((j / kDqpStages) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(full(s), 2 * L::k_tile);
#pragma unroll
          for (int c = 0; c < L::halves; ++c) {
            tma_load(base + L::k + s * L::k_tile + c * L::k_box, km, full(s), c * kBox, w.h,
                     kt * kDqpKeyTile, w.b);
            tma_load(base + L::v + s * L::k_tile + c * L::k_box, vm, full(s), c * kBox, w.h,
                     kt * kDqpKeyTile, w.b);
          }
        }
      }
    }
  } else {
    // consumers: 64 queries of each unit each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const bool lead = tid == 0;      // stores dQ, gives the Q / dO buffer back
    const uint32_t mine = cw * 64 * kRowBytes;  // this consumer's rows of a box
    const int last_valid = p.Lk - (p.nkt - 1) * kDqpKeyTile;

    float dq[kD / 2];
    float sc[32], dp[32];
    uint32_t df[4][4];
    // this thread's rows' lse * log2(e) and delta, read a unit ahead: rows
    // past Lq read nothing (0, 0)
    float lse2[2], dl[2], next_lse2[2], next_dl[2];
    auto read_rows = [&](int u, float (&l2)[2], float (&d)[2]) {
      if (u >= p.units) return;
      const QUnit w = q_unit_of(u, p);
      const long long rb = ((long long)w.b * p.N + w.h) * p.Lq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w.q0 + cw * 64 + warp * 16 + g + 8 * r;
        const bool in = row < p.Lq;
        l2[r] = in ? p.lse[rb + row] * kLog2e : 0.f;
        d[r] = in ? p.delta[rb + row] : 0.f;
      }
    };
    read_rows(blockIdx.x, next_lse2, next_dl);
    int j = 0;         // step of the walk: stage j % kDqpStages
    int release = -1;  // the Q / dO buffer whose dQ store is out, to give back

    // the Q / dO buffer back to the producer once dQ's store has read it
    auto give_back = [&]() {
      if (release >= 0) {
        if (lead) {
          bulk_wait<0, true>();
          mbar_arrive(qd_empty(release));
        }
        release = -1;
      }
    };

    for (int u = blockIdx.x, i = 0; u < p.units; u += gridDim.x, ++i) {
      const QUnit w = q_unit_of(u, p);
      const int n = i % kBwdBufs;
      const uint32_t qa = qdbuf(i) + mine;
      const uint32_t da = qdbuf(i) + L::q_tile + mine;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = next_lse2[r];
        dl[r] = next_dl[r];
      }
      read_rows(u + gridDim.x, next_lse2, next_dl);
      mbar_wait(qd_full(n), parity(i));
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) dq[c] = 0.f;

      for (int kt = 0; kt < p.nkt; ++kt, ++j) {
        const int s = j % kDqpStages;
        const uint32_t ka = base + L::k + s * L::k_tile;
        const uint32_t va = base + L::v + s * L::k_tile;
        mbar_wait(full(s), (j / kDqpStages) & 1);
        fence_regs(dq);
        wg_fence();
        issue_ss<T, kD, kDqpKeyTile>(sc, qa, L::q_box, ka, L::k_box);  // S = Q K^T
        issue_ss<T, kD, kDqpKeyTile>(dp, da, L::q_box, va, L::k_box);  // dP = dO V^T
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        // element e is query row g + 8 ((e >> 1) & 1), key column c below;
        // keys past Lk (those of the last key tile) are masked
        const int valid = kt == p.nkt - 1 ? last_valid : kDqpKeyTile;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e / 4) + 2 * t + (e & 1);
          const int rr = (e >> 1) & 1;
          p_ds(sc[e], dp[e], lse2[rr], dl[rr], p.scale_log2, c < valid);
        }
        pack_frag<T, 4>(df, dp);
        fence_regs(df);
        wg_fence();
        issue_rs<T, kD, kDqpKeyTile>(dq, df, ka, L::k_box);  // dQ += dS K
        wg_commit();
        give_back();  // the last unit's buffer, while the product runs
        wg_wait<0>();
        fence_regs(dq);
        if (signals) mbar_arrive(empty(s));
      }
      // dQ into this consumer's rows of the unit's Q buffer (its last S is
      // in), then out by TMA
      acc_to_boxes<T, kD>(qa, L::q_box, dq, p.scale, warp, g, t);
      fence_async_smem();
      bar_sync(1 + cw, 128);
      if (lead) {
#pragma unroll
        for (int c = 0; c < L::halves; ++c)
          tma_store(dqm, qa + c * L::q_box, c * kBox, w.h, w.q0 + cw * 64, w.b);
        bulk_commit();
      }
      release = n;
    }
    give_back();
    if (lead) bulk_wait<0, false>();  // the last stores are out
  }
}

// ---------------------------------------------------------------------------
// The ordered walk (`flash_bwd_ordered_sm90_kernel`): K2 and K3 in one pass
// over each 128-key block at any Lq, dQ added across the key blocks in
// key-block order; replaces `_flash_bwd_dkv_kernel` and
// `_flash_bwd_dq_kernel` (mmpl_tpu/ops/attention.py:373, :417) at long
// keys.
//
// On the grid K2 (S^T, dP^T, dV, dK) and K3 (S, dP, dQ) run 7 products
// where the gradients need 5, and read Q, K, V and dO twice.  Here
// min(#SMs, units) blocks walk the units (128-key block, head, batch) of
// the fused walk (head fastest), each running K2's grid body over the
// unit's 64-query tiles: K and V load once by TMA, the producer warp
// streams Q / dO tiles with their rows' lse * log2(e) and delta through
// kOrdStages stages, each consumer warpgroup owns 64 keys and runs K2's
// step and writes its dS^T (rounded to T) to one of two dS^T buffers; once
// both have (one barrier a step), it queues the tile's share of dQ for its
// 64 columns, dQ[:, 64 c .. 64 c + 63] = dS K over the unit's 128 keys
// (the fused walk's product), behind its dV and dK.  The fp32 share goes
// to the consumer's staging buffer in the sums' fragment order (element i
// of thread t of k-group g at float 4 (128 g + t) + i: one 16 KB block a
// consumer) and the consumer goes on to the next tile.
//
// The adds.  `acc` holds, for each (b, h, 64-query tile, column half), one
// 16 KB fp32 block in that order; `cnt` one int32 for each, zeroed by the
// caller.  A writer thread per consumer (lane 0 of warps 1 and 2 of the
// producer warpgroup) takes each staged share: key block j waits until the
// block's counter reads j (ld.acquire.gpu), then adds the share to the
// block with one bulk reduce (cp.reduce.async.bulk .add.f32; key block 0
// copies instead, so no memset), frees the staging buffer once the bulk
// copy has read it, waits for the add to complete (cp.async.bulk
// .wait_group 0, then the async-proxy fence) and publishes j + 1
// (st.release.gpu).  So every element of dQ is the fp32 sum over the key
// blocks in the order 0, 1, 2, ...: the same bits on every call.  (Publishing
// a tile only once the next one's add was out made a wave's chain of key
// blocks lag a tile at each link: slower at short shapes on the H100.)
// `flash_bwd_ordered_out_kernel`, launched with programmatic dependent
// launch, scales the sums, rounds them to T and stores dQ's rows < Lq and
// columns < D (the last key block's writer reading its blocks back, its
// loads one at a time at 24 registers, held its consumers back several
// times a tile's time).  dK and dV leave as in the fused walk, through the
// unit's K / V buffer and TMA stores; the producer loads the next unit's
// first Q / dO tiles before it waits for that buffer.
//
// No deadlock: all blocks are resident (one per SM, grid <= #SMs); a block
// takes its units in increasing order (u = blockIdx.x + i gridDim.x);
// unit u waits only on unit u - N (the same head and batch, the key block
// before), a lower number; and a writer publishes each add before it
// takes the next share.  Then the lowest unit whose adds are not all
// published has every unit it waits on published, and its block, which
// has finished all its lower units, runs it.  (Two walks on two streams
// at once could each hold SMs the other's blocks wait for: the port
// launches them on one stream.)
//
// What bounds it: operations (5 products, 10 B N Lq Lk D FLOPs), and the
// adds' traffic: ceil(Lk / 128) fp32 shares of dQ reduced in the L2 (the
// blocks of a wave walk the same query tiles of one head at once, so a
// tile's adds meet it there).  The two consumers meet once a step, so they
// compute P and dS at the same time and the tensor cores wait meanwhile;
// the ways round it tried on the H100 (each consumer queueing the last
// step's dQ behind this step's dV and dK, with mbarriers in place of the
// barrier) made ptxas serialize the wgmma groups or spill, and ran
// slower.  Arithmetic as K2's grid body: exp2 with
// log2(e) folded into the scale and each row's lse, P and dS rounded to T
// before their products, fp32 accumulators, keys past Lk masked per
// element, query rows past Lq zero (q = dO = 0, lse = delta = 0, so their
// dS is 0) and never stored; kD = 128 for every D.  Shared memory at kD =
// 128: K, V 64 KB, Q / dO 3 x 32 KB, dS^T 2 x 16 KB, staging 2 x 16 KB.
// ---------------------------------------------------------------------------

constexpr int kOrdStages = 3;                    // Q / dO stages
constexpr int kOrdShare = 64 * 64 * 4;           // bytes of a consumer's fp32 dQ share
constexpr int kOrdMaxSpins = 1 << 27;            // polls of a counter before a trap

struct OrderedParams {
  const float* lse;    // [B, N, Lq] fp32, natural log
  const float* delta;  // [B, N, Lq] fp32
  float* acc;          // fp32 dQ sums: [B, N, nqt, 2, 4096] in fragment order
  int* cnt;            // [B, N, nqt, 2], zeroed: the key blocks added so far
  int B, N, Lq, Lk, D;
  int nkb;             // ceil(Lk / 128)
  int nqt;             // ceil(Lq / 64)
  int units;
  float scale;         // the natural softmax scale
  float scale_log2;    // scale * log2(e), the exponent's
};

template <int kD>
struct OrderedLayout {
  static constexpr int halves = kD / kBox;
  static constexpr int kv_box = kKeyBlock * kRowBytes;  // [128 keys, 64 columns]
  static constexpr int kv_tile = halves * kv_box;
  static constexpr int q_box = kQueryTile * kRowBytes;  // [64 queries, 64 columns]
  static constexpr int q_tile = halves * q_box;
  static constexpr int ds_buf = 2 * 64 * kRowBytes;     // dS^T [128 keys, 64 queries]
  static constexpr int kv = 0;                          // K, then V
  static constexpr int q = kv + 2 * kv_tile;            // Q of each stage
  static constexpr int d = q + kOrdStages * q_tile;     // dO of each stage
  static constexpr int ds = d + kOrdStages * q_tile;    // two dS^T buffers
  static constexpr int stage = ds + 2 * ds_buf;         // each consumer's dQ share
  static constexpr int rows = stage + 2 * kOrdShare;    // [stage][lse * log2(e) | delta][64]
  static constexpr int bar = rows + kOrdStages * 2 * kQueryTile * 4;
  // kv_full, kv_empty, full and empty of each stage, staged_full and
  // staged_empty of each consumer
  static constexpr int bytes = bar + 8 * (2 + 2 * kOrdStages + 4) + 1024;
};
static_assert(OrderedLayout<128>::bytes <= kMaxSmem, "the ordered walk's buffers fit");

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// Order the async proxy's global accesses with the generic proxy's.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// `bytes` of shared memory at `src` copied to, or added (fp32) into,
// global memory at `dst`, in a bulk group of this thread.
__device__ __forceinline__ void bulk_copy_out(float* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_add_out(float* dst, uint32_t src, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(src), "r"(bytes)
               : "memory");
}

// K2 + K3 at any Lq: dK and dV of each unit through TMA stores, dQ summed
// across the key blocks in order.
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_ordered_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                              const __grid_constant__ CUtensorMap km,
                              const __grid_constant__ CUtensorMap vm,
                              const __grid_constant__ CUtensorMap dm,
                              const __grid_constant__ CUtensorMap dkm,
                              const __grid_constant__ CUtensorMap dvm, const OrderedParams p) {
  static_assert(kD == 128, "the ordered walk splits dQ's 128 columns between its consumers");
  using L = OrderedLayout<kD>;
  // dQ's out kernel may launch now and wait (its griddepcontrol.wait) for
  // this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::rows);
  const uint32_t bars = base + L::bar;
  const uint32_t kv_full = bars;
  const uint32_t kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + kOrdStages + s); };
  auto staged_full = [&](int c) { return bars + 8 * (2 + 2 * kOrdStages + c); };
  auto staged_empty = [&](int c) { return bars + 8 * (4 + 2 * kOrdStages + c); };
  auto staging = [&](int c) { return base + L::stage + c * kOrdShare; };
  const uint32_t ka0 = base + L::kv;
  const uint32_t va0 = base + L::kv + L::kv_tile;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);  // each consumer's lead, once its stores have read it
    for (int s = 0; s < kOrdStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes (lane 0 with the TMA bytes)
      mbar_init(empty(s), kBwdConsumerWarps);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(staged_full(c), 128);  // the consumer's threads
      mbar_init(staged_empty(c), 1);   // its writer, once the bulk copy has read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    regs_dealloc<24>();
    const int pw = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (pw == 0) {
      // producer: lane 0 issues the TMA loads, every lane two rows of lse
      // and delta; a unit's first Q / dO tiles go out before its K and V,
      // which wait for the last unit's dK / dV stores
      int j = 0;  // step of the walk: stage j % kOrdStages
      for (int u = blockIdx.x, n = 0; u < p.units; u += gridDim.x, ++n) {
        const KvUnit w = kv_unit_of(u, p.N, p.nkb);
        const int kv_at = p.nqt < kOrdStages ? p.nqt : kOrdStages;
        const long long rb = ((long long)w.b * p.N + w.h) * p.Lq;
        for (int i = 0; i <= p.nqt; ++i) {
          if (i == kv_at && lane == 0) {
            mbar_wait(kv_empty, (n & 1) ^ 1);  // the first unit passes
            mbar_expect_tx(kv_full, 2 * L::kv_tile);
#pragma unroll
            for (int c = 0; c < L::halves; ++c) {
              tma_load(ka0 + c * L::kv_box, km, kv_full, c * kBox, w.h, w.kb * kKeyBlock, w.b);
              tma_load(va0 + c * L::kv_box, vm, kv_full, c * kBox, w.h, w.kb * kKeyBlock, w.b);
            }
          }
          if (i == p.nqt) break;
          const int s = j % kOrdStages;
          const int q0 = i * kQueryTile;
          mbar_wait(empty(s), ((j / kOrdStages) & 1) ^ 1);  // the first round passes
          float* r = rows + s * 2 * kQueryTile;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int row = q0 + lane + 32 * jj;
            const bool in = row < p.Lq;  // past Lq nothing is read: 0, 0
            r[lane + 32 * jj] = in ? p.lse[rb + row] * kLog2e : 0.f;
            r[kQueryTile + lane + 32 * jj] = in ? p.delta[rb + row] : 0.f;
          }
          if (lane == 0) {
            mbar_expect_tx(full(s), 2 * L::q_tile);
#pragma unroll
            for (int c = 0; c < L::halves; ++c) {
              tma_load(base + L::q + s * L::q_tile + c * L::q_box, qm, full(s), c * kBox, w.h, q0,
                       w.b);
              tma_load(base + L::d + s * L::q_tile + c * L::q_box, dm, full(s), c * kBox, w.h, q0,
                       w.b);
            }
          } else {
            mbar_arrive(full(s));
          }
          ++j;
        }
      }
    } else if ((pw == 1 || pw == 2) && lane == 0) {
      // writer of consumer c = pw - 1's dQ shares: one thread orders and
      // issues the adds and publishes them
      const int c = pw - 1;
      int j = 0;  // step of the walk
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const KvUnit w = kv_unit_of(u, p.N, p.nkb);
        for (int i = 0; i < p.nqt; ++i, ++j) {
          const long long blk = (((long long)w.b * p.N + w.h) * p.nqt + i) * 2 + c;
          mbar_wait(staged_full(c), j & 1);
          if (w.kb > 0) {
            // key block kb adds after kb - 1; a wait past ~30 s traps (a
            // failed launch, not a hung card)
            for (int spins = 0; ld_acquire_gpu(p.cnt + blk) != w.kb; ++spins) {
              if (spins == kOrdMaxSpins) __trap();
              __nanosleep(256);
            }
            fence_async_global();
            bulk_add_out(p.acc + blk * 4096, staging(c), kOrdShare);
          } else {
            bulk_copy_out(p.acc + blk * 4096, staging(c), kOrdShare);
          }
          bulk_commit();
          bulk_wait<0, true>();
          mbar_arrive(staged_empty(c));  // the staging buffer is read
          bulk_wait<0, false>();         // the add is complete: publish it
          if (w.kb + 1 < p.nkb) {        // (the out kernel reads the last one)
            fence_async_global();
            st_release_gpu(p.cnt + blk, w.kb + 1);
          }
        }
      }
    }
  } else {
    // consumers: 64 keys of each unit each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const bool lead = tid == 0;      // stores dK and dV, gives the K / V buffer back
    const uint32_t mine = cw * 64 * kRowBytes;  // this consumer's rows of a box
    const uint32_t ka = ka0 + mine;
    const uint32_t va = va0 + mine;

    float dk[kD / 2], dv[kD / 2];
    float st[32], dpt[32];
    uint32_t pf[4][4], df[4][4];
    int j = 0;  // step of the walk: stage j % kOrdStages, dS^T buffer j % 2

    for (int u = blockIdx.x, n = 0; u < p.units; u += gridDim.x, ++n) {
      const KvUnit w = kv_unit_of(u, p.N, p.nkb);
      const int k0 = w.kb * kKeyBlock;
      const int key0 = k0 + cw * 64 + warp * 16 + g;  // this thread's keys key0, key0 + 8
      const bool keep0 = key0 < p.Lk;
      const bool keep1 = key0 + 8 < p.Lk;
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) dk[c] = dv[c] = 0.f;
      mbar_wait(kv_full, n & 1);

      for (int i = 0; i < p.nqt; ++i, ++j) {
        const int s = j % kOrdStages;
        const uint32_t qa = base + L::q + s * L::q_tile;
        const uint32_t da = base + L::d + s * L::q_tile;
        const uint32_t ds = base + L::ds + (j & 1) * L::ds_buf;
        mbar_wait(full(s), (j / kOrdStages) & 1);
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
        // dS^T to its rows [64 cw, 64 cw + 64) of this step's buffer while
        // the products run (the buffer's last readers, step j - 2's dQ
        // products, finished before both consumers passed step j - 1's
        // barrier)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rt = warp * 16 + g + 8 * (e & 1);
            st_shared32(ds + mine + rt * 128 + (((2 * kk + (e >> 1)) ^ g) << 4) + 4 * t,
                        df[kk][e]);
          }
        fence_async_smem();
        // both consumers' dS^T are in: dQ's columns [64 cw, 64 cw + 64)
        // over the unit's 128 keys, queued behind dV and dK
        bar_sync(1, 256);
        float dq[32];
#pragma unroll
        for (int kk = 0; kk < kKeyBlock / 16; ++kk)
          wgmma_ss_n64_tt<T>(dq, smem_desc(ds + kk * 16 * kRowBytes, 64 * kRowBytes),
                             smem_desc(ka0 + cw * L::kv_box + kk * 16 * kRowBytes, L::kv_box),
                             kk > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(dq);
        if (signals) mbar_arrive(empty(s));  // Q and dO are read
        // the share to the staging buffer in fragment order, for the writer
        mbar_wait(staged_empty(cw), (j & 1) ^ 1);  // the first step passes
        const uint32_t sa = staging(cw) + tid * 16;
#pragma unroll
        for (int kg = 0; kg < 8; ++kg)
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(sa + kg * 2048),
                       "f"(dq[4 * kg]), "f"(dq[4 * kg + 1]), "f"(dq[4 * kg + 2]),
                       "f"(dq[4 * kg + 3])
                       : "memory");
        fence_async_smem();
        mbar_arrive(staged_full(cw));
      }

      // dV into this consumer's rows of the V buffer (dead since the last
      // dP^T); once both consumers' last dQ products have read K, dK into
      // its rows of the K buffer; then both out by TMA and the buffer back
      // to the producer once the stores have read it
      acc_to_boxes<T, kD>(va, L::kv_box, dv, 1.f, warp, g, t);
      bar_sync(1, 256);
      acc_to_boxes<T, kD>(ka, L::kv_box, dk, p.scale, warp, g, t);
      fence_async_smem();
      bar_sync(2 + cw, 128);
      if (lead) {
#pragma unroll
        for (int c = 0; c < L::halves; ++c) {
          tma_store(dkm, ka + c * L::kv_box, c * kBox, w.h, k0 + cw * 64, w.b);
          tma_store(dvm, va + c * L::kv_box, c * kBox, w.h, k0 + cw * 64, w.b);
        }
        bulk_commit();
        bulk_wait<0, true>();
        mbar_arrive(kv_empty);
      }
    }
    if (lead) bulk_wait<0, false>();  // the last stores are out
  }
}

// The ordered walk's second pass: dQ = scale * the fp32 sums, rounded to
// T, rows < Lq and columns < D, at dQ's element strides.  Float4 f of a
// (b, h, tile, half) block is thread f % 128's k-group f / 128 % 8 of the
// walk's consumer: query rows 16 w + g and + 8 of the tile, columns 64
// half + 8 (f / 128 % 8) + 2 t and + 1 (w, g, t of that thread).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_ordered_out_kernel(const float4* __restrict__ acc, T* __restrict__ dq, int N, int Lq,
                             int D, int nqt, long long n4, long long ab, long long al,
                             long long ah, float scale) {
  // launched while the walk runs (programmatic dependent launch): wait
  // for its grid and its adds
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (long long f = blockIdx.x * 256LL + threadIdx.x; f < n4; f += 256LL * gridDim.x) {
    const int th = (int)(f % 128);
    const int col = (int)(f / 1024 % 2) * 64 + (int)(f / 128 % 8) * 8 + 2 * (th % 4);
    const long long r = f / 2048;  // (b, h, tile)
    const int row = (int)(r % nqt) * kQueryTile + th / 32 * 16 + th % 32 / 4;
    if (col >= D || row >= Lq) continue;
    const long long bh = r / nqt;
    const float4 x = acc[f];
    T* const out = dq + bh / N * ab + bh % N * ah + col;
    *reinterpret_cast<uint32_t*>(out + row * al) = pack2<T>(x.x * scale, x.y * scale);
    if (row + 8 < Lq)
      *reinterpret_cast<uint32_t*>(out + (row + 8) * al) = pack2<T>(x.z * scale, x.w * scale);
  }
}

// ---------------------------------------------------------------------------
// Host side: the launches.  `st` holds the element strides (batch, row,
// head) of q, k, v, dO, dQ, dK and dV.  Each returns 0, a cudaError_t or
// one of the tensor-map codes of sm90_common.cuh.
// ---------------------------------------------------------------------------

constexpr int kBwdMaxDevices = 64;
// The devices each kernel was opted in on.  `static`: internal linkage in
// each library of this source.  (In an unnamed namespace, which nvcc names
// after the source file, or as a static in a template function, it was one
// object for every library of this source in the process, and a second
// library built from it launched its kernels without the opt-in.)
template <typename T, bool kFused>
static bool bwd_smem_ready[kBwdMaxDevices];

// The dynamic shared memory a kernel may take, opted in once per device; 0
// or a cudaError_t.  The call costs microseconds, which a short shape's
// launch feels.
template <typename Kernel>
int bwd_opt_in_smem(Kernel kernel, int bytes, bool (&done)[kBwdMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kBwdMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kBwdMaxDevices) done[dev] = true;
  return (int)err;
}

// The fused walk on min(sms, units) blocks, then its reduce: `p.ws` holds
// nkb * B * N * Lq * D floats; Lq <= 64.
template <typename T, int kD>
int launch_fused(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 void* dk, void* dv, const long long* st, BwdSchedParams p, int sms,
                 cudaStream_t stream) {
  p.nkb = (p.Lk + kKeyBlock - 1) / kKeyBlock;
  const long long units = (long long)p.nkb * p.N * p.B;
  if (p.Lq > kQueryTile || p.ws == nullptr || sms < 1 || units > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  CUtensorMap m[6];
  int rc = encode<T>(&m[0], q, p.B, p.Lq, p.N, p.D, st[0], st[1], st[2], kQueryTile);
  if (rc == 0) rc = encode<T>(&m[1], k, p.B, p.Lk, p.N, p.D, st[3], st[4], st[5], kKeyBlock);
  if (rc == 0) rc = encode<T>(&m[2], v, p.B, p.Lk, p.N, p.D, st[6], st[7], st[8], kKeyBlock);
  if (rc == 0) rc = encode<T>(&m[3], dout, p.B, p.Lq, p.N, p.D, st[9], st[10], st[11], kQueryTile);
  if (rc == 0) rc = encode<T>(&m[4], dk, p.B, p.Lk, p.N, p.D, st[15], st[16], st[17], 64);
  if (rc == 0) rc = encode<T>(&m[5], dv, p.B, p.Lk, p.N, p.D, st[18], st[19], st[20], 64);
  constexpr int bytes = FusedLayout<kD>::bytes;
  if (rc == 0)
    rc = bwd_opt_in_smem(flash_bwd_fused_sm90_kernel<T, kD>, bytes, bwd_smem_ready<T, true>);
  if (rc != 0) return rc;
  const int grid = (int)(units < sms ? units : sms);
  flash_bwd_fused_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(m[0], m[1], m[2], m[3],
                                                                          m[4], m[5], p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)p.B * p.N * p.Lq * p.D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((plane + 63) / 64));
  cfg.blockDim = dim3(32 * kDqReduceWarps);
  cfg.stream = stream;
  cudaLaunchAttribute early;  // programmatic dependent launch
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_bwd_dq_reduce_kernel<T>, (const float*)p.ws,
                                 static_cast<T*>(dq), p.B, p.N, p.Lq, p.D, p.nkb, st[12],
                                 st[13], st[14], p.scale);
}

// The ordered walk on min(sms, units) blocks, then dQ's out kernel:
// `p.acc` holds B * N * ceil(Lq / 64) * 8192 floats, `p.cnt` B * N *
// ceil(Lq / 64) * 2 int32 zeros.
template <typename T>
static bool ordered_smem_ready[kBwdMaxDevices];

template <typename T, int kD>
int launch_ordered(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, const long long* st, OrderedParams p, int sms,
                   cudaStream_t stream) {
  p.nkb = (p.Lk + kKeyBlock - 1) / kKeyBlock;
  p.nqt = (p.Lq + kQueryTile - 1) / kQueryTile;
  const long long units = (long long)p.nkb * p.N * p.B;
  if (p.acc == nullptr || p.cnt == nullptr || dq == nullptr || sms < 1 ||
      units > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  CUtensorMap m[6];
  int rc = encode<T>(&m[0], q, p.B, p.Lq, p.N, p.D, st[0], st[1], st[2], kQueryTile);
  if (rc == 0) rc = encode<T>(&m[1], k, p.B, p.Lk, p.N, p.D, st[3], st[4], st[5], kKeyBlock);
  if (rc == 0) rc = encode<T>(&m[2], v, p.B, p.Lk, p.N, p.D, st[6], st[7], st[8], kKeyBlock);
  if (rc == 0) rc = encode<T>(&m[3], dout, p.B, p.Lq, p.N, p.D, st[9], st[10], st[11], kQueryTile);
  if (rc == 0) rc = encode<T>(&m[4], dk, p.B, p.Lk, p.N, p.D, st[15], st[16], st[17], 64);
  if (rc == 0) rc = encode<T>(&m[5], dv, p.B, p.Lk, p.N, p.D, st[18], st[19], st[20], 64);
  constexpr int bytes = OrderedLayout<kD>::bytes;
  if (rc == 0)
    rc = bwd_opt_in_smem(flash_bwd_ordered_sm90_kernel<T, kD>, bytes, ordered_smem_ready<T>);
  if (rc != 0) return rc;
  const int grid = (int)(units < sms ? units : sms);
  flash_bwd_ordered_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n4 = (long long)p.B * p.N * p.nqt * 2048;
  const long long most = 16LL * sms;  // a grid-stride loop past this
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n4 + 255) / 256 < most ? (n4 + 255) / 256 : most));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute early;  // programmatic dependent launch
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_bwd_ordered_out_kernel<T>,
                                 reinterpret_cast<const float4*>(p.acc), static_cast<T*>(dq),
                                 p.N, p.Lq, p.D, p.nqt, n4, st[12], st[13], st[14], p.scale);
}

// The persistent dQ walk on min(sms, units) blocks.
template <typename T, int kD>
int launch_dq_persistent(const void* q, const void* k, const void* v, const void* dout, void* dq,
                         const long long* st, BwdSchedParams p, int sms, cudaStream_t stream) {
  p.qblocks = (p.Lq + kQueryBlock - 1) / kQueryBlock;
  p.nkt = (p.Lk + kDqpKeyTile - 1) / kDqpKeyTile;
  const long long units = (long long)p.qblocks * p.N * p.B;
  if (sms < 1 || units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  CUtensorMap m[5];
  int rc = encode<T>(&m[0], q, p.B, p.Lq, p.N, p.D, st[0], st[1], st[2], kQueryBlock);
  if (rc == 0) rc = encode<T>(&m[1], k, p.B, p.Lk, p.N, p.D, st[3], st[4], st[5], kDqpKeyTile);
  if (rc == 0) rc = encode<T>(&m[2], v, p.B, p.Lk, p.N, p.D, st[6], st[7], st[8], kDqpKeyTile);
  if (rc == 0) rc = encode<T>(&m[3], dout, p.B, p.Lq, p.N, p.D, st[9], st[10], st[11], kQueryBlock);
  if (rc == 0) rc = encode<T>(&m[4], dq, p.B, p.Lq, p.N, p.D, st[12], st[13], st[14], 64);
  constexpr int bytes = DqpLayout<kD>::bytes;
  if (rc == 0)
    rc = bwd_opt_in_smem(flash_bwd_dq_persistent_sm90_kernel<T, kD>, bytes,
                         bwd_smem_ready<T, false>);
  if (rc != 0) return rc;
  const int grid = (int)(units < sms ? units : sms);
  flash_bwd_dq_persistent_sm90_kernel<T, kD><<<grid, kBwdThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
