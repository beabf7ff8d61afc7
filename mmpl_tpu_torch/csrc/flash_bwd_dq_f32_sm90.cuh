// Flash-attention backward for Hopper (sm_90a) in fp32 on the tensor
// cores: the fp32 body of K3 and K6, dQ (csrc/flash_bwd.cu,
// `flash_bwd_dq_f32_sm90_kernel` and `flash_masked_bwd_dq_f32_sm90_kernel`).
//
// Replaces `_flash_bwd_dq_kernel` (mmpl_tpu/ops/attention.py:417) and, with
// kMasked, `_masked_bwd_dq_kernel` (:821): dQ = scale * sum dS K over the
// keys, with P = exp(scale * Q K^T - lse) from the natural-log lse that K1
// saved and dS = P o (dO V^T - delta), delta = rowsum(dO o O) as the
// wrapper computed it.  P and dS stay fp32 (split, below), as the TPU
// kernel keeps them (attention.py:440-448).
//
// What bounds it on an H100: operations (6*B*N*Lq*Lk*D FLOPs, three
// products, times the admitted share of tiles when masked, against
// B*N*(3*Lq + 2*Lk)*D fp32 elements in and out).  As in fp32 K1 and K2
// (flash_fwd_f32_sm90.cuh, flash_bwd_f32_sm90.cuh), fp32 reaches the
// tensor cores only as TF32, and split TF32 (sm90_common.cuh) takes three
// passes a product, so the body can reach at most a third of the TF32
// rate.  The design is K2's turned round: the queries stay, the keys
// stream.
//
//  * Block: 64 query rows of one (b, head), 256 threads.  Warpgroup 1 is
//    the consumer and runs three products a tile of 32 keys, each as
//    a_lo b_hi + a_hi b_lo + a_hi b_hi: S = Q K^T and dP = dO V^T
//    (m64n32k8, Q and dO resident, K and V the tile's rows), then dS split
//    in registers, then dQ += dS K (m64n{kD}k8, A from registers, K read as
//    K^T: keys contiguous).
//  * TF32 takes only K-major shared-memory operands, so K is needed twice:
//    as rows (the contraction over the head dim) and as columns (over the
//    keys).  Warpgroup 0 is the producer: each thread reads 32 head-dim
//    columns of one key row of K and V from device memory into registers
//    (strided, 64-bit offsets, zeros past Lk and D), and writes them split,
//    swizzled, K and V as rows and then, from K's registers split again, K
//    as columns with the keys of each group of 8 in the order that makes
//    the dS accumulator the A fragment as it stands (`tf32_slot`).  Q and
//    dO are written once, as rows.
//  * Shared memory at kD = 128: Q and dO hi and lo, 4 x 32 KB, resident;
//    slot R, a tile's K and V rows hi and lo (4 x 16 KB), and slot C, its
//    K^T hi and lo (2 x 16 KB), each with a full and an empty mbarrier:
//    224 KB, one block an SM (kD = 64 halves it).  Only one tile's
//    operands fit, so the slots take turns: R is free once S and dP are
//    done, and the producer writes the next tile's rows while the consumer
//    runs its per-element step and dQ; C is free once dQ is done, and the
//    producer writes the next K^T while the consumer runs the next S and
//    dP.  The next tile's V is read from device memory once its rows are
//    written, its K once K^T is.
//  * The per-element step as in the bf16 body: p = exp2(s * scale *
//    log2(e) - lse * log2(e)), dS = p (dP - delta).  Each consumer thread's
//    two rows keep lse * log2(e) and delta in registers for the whole key
//    loop.  p is 0, by a select and not by a product, for keys past Lk
//    (whose score is 0: exp(0 - lse) overflows under a very negative lse,
//    and inf * 0 is NaN), for rows whose lse is -inf (masked rows that saw
//    no key: the guard of `_masked_p`, :771-780) and rows past Lq, and, in
//    K6, for pairs the frame table forbids.  Query rows past Lq are not
//    stored.
//  * K6 (kMasked) walks the admitted 32-key tiles of the block's row of the
//    64 x 64 tile table (`mask.tiles`, `tiles.t64`): an entry covers two
//    tiles; 0 skips both, 2 admits every pair, 1 tests each pair against
//    the frame ids and the [F, F] table.  The producer writes each tile's
//    index, class and key frame ids with its rows, and the consumer reads
//    them before it frees slot R.  A block with no admitted tile writes
//    dQ = 0.
//  * The tensor cores' fp32 sums drift (flash_fwd_f32_sm90.cuh): dQ
//    accumulates in registers for kF32DqFold tiles, then each thread adds
//    its values into the fp32 output (its own elements: no atomics; the
//    block owns its 64 rows, and no split of the key loop, so every call
//    gives the same bits) and restarts from 0.
//  * S and dP's chains are interleaved, so the tensor cores never wait on
//    one accumulator's last product, each with its two small passes first.
//    Registers: the consumer holds dQ (kD / 2), S and dP (32) and dS's two
//    split fragments (32); 255 a thread at kD = 128, 4 bytes of spills.
//  * Measured on an H100 (4680 x 4680 and 4680 x 32760, B = 1, N = 12):
//    this body 52-54 TFLOP/s (6*...*D over its time), 3.5-3.8x the FMA
//    template and 10-11% of the TF32 bound; K1's order (the next tile's S
//    and dP issued before this tile's dQ, the producer writing rows a tile
//    ahead of the columns) 32-33; with the producer's stores off (timing
//    only) 60-63, so the producer's turns cost ~15% and the consumer's own
//    chain holds the rest.  Q's hi plane in registers (fp32 K1's choice)
//    was not tried: the consumer is at 255 registers, and in K1 it gained
//    nothing.  16 tiles a fold: dQ 5.4e-6 (relative) from the plain
//    version at 32760 keys.
#pragma once

#include "flash_bwd_f32_sm90.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kF32DqBlock = 64;    // query rows of a block
constexpr int kF32DqKeyTile = 32;  // keys of a tile: one 128-byte row of K^T
// key tiles that dQ accumulates on the tensor cores before it is folded
// into the fp32 output
constexpr int kF32DqFold = 16;

template <int kD>
struct F32DqLayout {
  static constexpr int boxes = kD / 32;
  static constexpr int q_box = kF32DqBlock * 128;     // [64 rows, 32 columns]
  static constexpr int q_plane = boxes * q_box;
  static constexpr int k_box = kF32DqKeyTile * 128;   // [32 keys, 32 columns]
  static constexpr int k_plane = boxes * k_box;       // = kD * 128, a K^T plane
  static constexpr int q = 0;                         // Q hi, Q lo
  static constexpr int d = q + 2 * q_plane;           // dO hi, dO lo
  static constexpr int k = d + 2 * q_plane;           // slot R: K hi, K lo, V hi, V lo
  static constexpr int v = k + 2 * k_plane;
  static constexpr int kt = v + 2 * k_plane;          // slot C: K^T hi, K^T lo
  static constexpr int meta = kt + 2 * k_plane;       // K6's F32TileMeta, with slot R
  static constexpr int bar = meta + 256;
  // qd_full, r_full, r_empty, c_full, c_empty
  static constexpr int bytes = bar + 8 * 5 + 1024;    // + alignment slack
  static_assert(sizeof(F32TileMeta) <= 256, "the tile's meta fits its room");
  static_assert(kF32DqKeyTile == 32, "F32TileMeta holds a 32-key tile");
};
static_assert(F32DqLayout<128>::bytes <= kMaxSmem, "the fp32 K3 body fits one block an SM");

struct F32DqParams {
  float* dq;
  const float* lse;    // [B, N, Lq] fp32, natural log
  const float* delta;  // [B, N, Lq] fp32
  long long ab, al, ah;  // dq's element strides (batch, row, head)
  int Lq, Lk, N, D;
  float scale;         // the natural softmax scale: dQ = scale * its sum
  float scale_log2;    // scale * log2(e), the exponent's
};

// S = Q K^T and dP = dO V^T for a 32-key tile, 3 passes a k8 step over the
// head dim, A the resident Q and dO, B the tile's K and V rows in slot R
// (`d0` the descriptor of the layout's base); the two chains interleaved,
// each with its two small passes first; the first product of each
// overwrites it.
template <int kD>
__device__ __forceinline__ void f32_dq_issue_rows(float (&s)[16], float (&dp)[16], uint64_t d0) {
  using L = F32DqLayout<kD>;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t a = (kk / 4) * L::q_box + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * L::k_box + (kk % 4) * 32;
    wgmma_tf32_ss_n32(s, desc_at(d0, L::q + L::q_plane + a), desc_at(d0, L::k + b), kk > 0);
    wgmma_tf32_ss_n32(dp, desc_at(d0, L::d + L::q_plane + a), desc_at(d0, L::v + b), kk > 0);
    wgmma_tf32_ss_n32(s, desc_at(d0, L::q + a), desc_at(d0, L::k + L::k_plane + b), 1);
    wgmma_tf32_ss_n32(dp, desc_at(d0, L::d + a), desc_at(d0, L::v + L::k_plane + b), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t a = (kk / 4) * L::q_box + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * L::k_box + (kk % 4) * 32;
    wgmma_tf32_ss_n32(s, desc_at(d0, L::q + a), desc_at(d0, L::k + b), 1);
    wgmma_tf32_ss_n32(dp, desc_at(d0, L::d + a), desc_at(d0, L::v + b), 1);
  }
}

// dQ += dS K over the tile's 32 keys: A dS's split fragments, B K^T in
// slot C (`d0` as above).
template <int kD>
__device__ __forceinline__ void f32_dq_issue_cols(float (&dq)[kD / 2], const uint32_t (&dh)[4][4],
                                                  const uint32_t (&dl)[4][4], uint64_t d0) {
  using L = F32DqLayout<kD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t kh = desc_at(d0, L::kt + kk * 32);
    wgmma_tf32_rs<kD>(dq, dl[kk], kh);
    wgmma_tf32_rs<kD>(dq, dh[kk], desc_at(kh, L::k_plane));
    wgmma_tf32_rs<kD>(dq, dh[kk], kh);
  }
}

// K3 in fp32 (K6 with kMasked): dQ of 64 query rows over every key tile,
// or over the admitted ones of `mask`.
template <int kD, bool kMasked>
__device__ __forceinline__ void f32_dq_body(const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dout, const FwdStrides& st,
                                            long long dsb, long long dsl, long long dsh,
                                            const F32DqParams& p, const FrameMask& mask) {
  using L = F32DqLayout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);  // generic pointer to `base`
  F32TileMeta* const meta = reinterpret_cast<F32TileMeta*>(sm + L::meta);
  const uint32_t qd_full = base + L::bar;
  const uint32_t r_full = qd_full + 8, r_empty = qd_full + 16;
  const uint32_t c_full = qd_full + 24, c_empty = qd_full + 32;

  const int q0 = blockIdx.x * kF32DqBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nt = (p.Lk + kF32DqKeyTile - 1) / kF32DqKeyTile;
  // K6: this query block's row of the 64 x 64 table; entry j / 2 covers
  // the 32-key tile j
  const unsigned char* const trow =
      kMasked ? mask.tiles + (long long)blockIdx.x * mask.nkt : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 128);  // every producer thread
    mbar_init(r_full, 128);
    mbar_init(c_full, 128);
    mbar_init(r_empty, 4);    // every consumer warp
    mbar_init(c_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < 4) {
    // producer: warp w holds head-dim columns [32 w, 32 w + 32) of one
    // token row a lane (warps past kD / 32 only arrive)
    const bool works = warp < kD / 32;
    const int c0 = 32 * warp;
    const float* kg = k + b * st.kb + h * st.kh;
    const float* vg = v + b * st.vb + h * st.vh;
    float4 kx[8], vx[8];  // a tile's K and V rows as read
    uint4 hi[8], lo[8];   // one of them split
    if (works) {
      const float* qg = q + b * st.qb + h * st.qh;
      const float* dg = dout + b * dsb + h * dsh;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + 32 * half + lane;
        const int r = 32 * half + lane;
        load_row32(kx, qg + (long long)row * st.ql, row < p.Lq, c0, p.D);
        load_row32(vx, dg + (long long)row * dsl, row < p.Lq, c0, p.D);
        unsigned char* qb = sm + L::q + warp * L::q_box;
        unsigned char* db = sm + L::d + warp * L::q_box;
        split_row32(kx, hi, lo);
        store_row_split(qb, qb + L::q_plane, r, hi, lo);
        split_row32(vx, hi, lo);
        store_row_split(db, db + L::q_plane, r, hi, lo);
      }
    }
    fence_async_smem();
    mbar_arrive(qd_full);

    // the next tile the walk admits from tile j on (K3: j itself)
    auto next = [&](int j) {
      if constexpr (kMasked)
        while (j < nt && trow[j >> 1] == 0) ++j;
      return j;
    };
    auto load_k = [&](int j) {
      const int key = j * kF32DqKeyTile + lane;
      load_row32(kx, kg + (long long)key * st.kl, key < p.Lk, c0, p.D);
    };
    auto load_v = [&](int j) {
      const int key = j * kF32DqKeyTile + lane;
      load_row32(vx, vg + (long long)key * st.vl, key < p.Lk, c0, p.D);
    };
    int j = next(0);
    if (works && j < nt) {
      load_k(j);
      load_v(j);
    }
    // each tile: split K, fill slot R with K's and V's rows (K6: and the
    // tile's meta); split K again, fill slot C with its columns.  Each use
    // waits for the release of the slot's use before it (the first passes)
    for (int i = 0; j < nt; ++i) {
      const int jn = next(j + 1);
      if (works) split_row32(kx, hi, lo);
      mbar_wait(r_empty, (i & 1) ^ 1);
      if constexpr (kMasked) {
        if (warp == 0) {
          const int key = j * kF32DqKeyTile + lane;
          meta->kf[lane] = key < p.Lk ? mask.kf[key] : 0;
          if (lane == 0) {
            meta->tile = j;
            meta->cls = trow[j >> 1];
          }
        }
      }
      if (works) {
        unsigned char* kb = sm + L::k + warp * L::k_box;
        unsigned char* vb = sm + L::v + warp * L::k_box;
        store_row_split(kb, kb + L::k_plane, lane, hi, lo);
        split_row32(vx, hi, lo);
        store_row_split(vb, vb + L::k_plane, lane, hi, lo);
      }
      fence_async_smem();
      mbar_arrive(r_full);
      if (works && jn < nt) load_v(jn);
      if (works) split_row32(kx, hi, lo);
      mbar_wait(c_empty, (i & 1) ^ 1);
      if (works) store_col_split(sm + L::kt, sm + L::kt + L::k_plane, c0, tf32_slot(lane), hi, lo);
      fence_async_smem();
      mbar_arrive(c_full);
      if (works && jn < nt) load_k(jn);
      j = jn;
    }
  } else {
    // consumer: the block's 64 query rows
    const int cwarp = warp - 4;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const int row0 = q0 + cwarp * 16 + g;  // this thread's rows row0, row0 + 8
    float lse2[2], dl[2];
    bool live[2];
    const unsigned char* fmrow[2] = {nullptr, nullptr};  // K6: the rows' frame-table rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < p.Lq;
      const long long at = (b * p.N + h) * (long long)p.Lq + row;
      const float ls = in ? __ldg(p.lse + at) : -INFINITY;
      live[r] = ls != -INFINITY;  // past Lq, or a row that saw no key: p = 0
      lse2[r] = live[r] ? ls * kLog2e : 0.f;
      dl[r] = in ? __ldg(p.delta + at) : 0.f;
      if constexpr (kMasked)
        if (in) fmrow[r] = mask.fm + (long long)mask.qf[row] * mask.F;
    }
    // the steps of the walk: every key tile, or K6's admitted ones (two a
    // 64 x 64 entry, one for a last entry that covers a single tile)
    int n = nt;
    if constexpr (kMasked)
      n = 2 * count_admitted(trow, mask.nkt, lane) - ((nt & 1) && trow[mask.nkt - 1] != 0);
    float* const dq_out = p.dq + b * p.ab + h * p.ah;

    float dq[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
    float s[16], dp[16];
    uint32_t dh[4][4], dlo[4][4];

    const uint64_t d0 = smem_desc(base, 16);
    mbar_wait(qd_full, 0);
    for (int i = 0; i < n; ++i) {
      mbar_wait(r_full, i & 1);
      fence_regs(dq);
      wg_fence();
      // S = Q K^T, dP = dO V^T
      f32_dq_issue_rows<kD>(s, dp, d0);
      wg_commit();
      // while they run: which of this thread's pairs count.  Element e is
      // query row g + 8 ((e >> 1) & 1), key column c = 8 (e / 4) + 2 t +
      // (e & 1) of the tile
      int tile = i, cls = 2;
      if constexpr (kMasked) {
        tile = meta->tile;
        cls = meta->cls;
      }
      const int valid = p.Lk - tile * kF32DqKeyTile;
      uint32_t ok = 0;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = 8 * (e / 4) + 2 * t + (e & 1);
        const int r = (e >> 1) & 1;
        bool on = live[r] && c < valid;
        if constexpr (kMasked)
          if (cls == 1) on = on && fmrow[r] != nullptr && fmrow[r][meta->kf[c]] != 0;
        ok |= (uint32_t)on << e;
      }
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if constexpr (kMasked) __syncwarp();  // every lane has read the meta
      if (signals) mbar_arrive(r_empty);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = (e >> 1) & 1;
        const float pe = (ok >> e) & 1u ? ex2(s[e] * p.scale_log2 - lse2[r]) : 0.f;
        dp[e] = pe * (dp[e] - dl[r]);  // dS
      }
      split_frag<4>(dh, dlo, dp);
      mbar_wait(c_full, i & 1);
      fence_regs(dh);
      fence_regs(dlo);
      wg_fence();
      // dQ += dS K
      f32_dq_issue_cols<kD>(dq, dh, dlo, d0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      fence_regs(dh);
      fence_regs(dlo);
      if (signals) mbar_arrive(c_empty);
      if ((i + 1) % kF32DqFold == 0 || i == n - 1)
        f32_fold_acc<kD>(dq_out, p.al, row0, p.Lq, p.D, dq, p.scale, i < kF32DqFold);
    }
    if (n == 0)  // K6, no admitted tile: dQ = 0
      f32_fold_acc<kD>(dq_out, p.al, row0, p.Lq, p.D, dq, p.scale, true);
  }
}

template <int kD>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
flash_bwd_dq_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const FwdStrides st, const long long dsb, const long long dsl,
                             const long long dsh, const F32DqParams p) {
  f32_dq_body<kD, false>(q, k, v, dout, st, dsb, dsl, dsh, p, FrameMask{});
}

template <int kD>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
flash_masked_bwd_dq_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const FwdStrides st, const long long dsb,
                                    const long long dsl, const long long dsh,
                                    const F32DqParams p, const FrameMask mask) {
  f32_dq_body<kD, true>(q, k, v, dout, st, dsb, dsl, dsh, p, mask);
}

// K3 in fp32 at head-dim width kD (K6 with kMasked, over `mask`'s 64 x 64
// table): `st` holds q's, k's and v's element strides, (dsb, dsl, dsh)
// dO's.  0 or a cudaError_t.
template <int kD, bool kMasked>
int launch_f32_dq(const float* q, const float* k, const float* v, const float* dout,
                  const FwdStrides& st, long long dsb, long long dsl, long long dsh,
                  const F32DqParams& p, const FrameMask& mask, int B, cudaStream_t stream) {
  constexpr int bytes = F32DqLayout<kD>::bytes;
  const dim3 grid((p.Lq + kF32DqBlock - 1) / kF32DqBlock, p.N, B);
  cudaError_t err;
  if constexpr (kMasked) {
    err = cudaFuncSetAttribute(flash_masked_bwd_dq_f32_sm90_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_masked_bwd_dq_f32_sm90_kernel<kD><<<grid, kF32BwdThreads, bytes, stream>>>(
        q, k, v, dout, st, dsb, dsl, dsh, p, mask);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_sm90_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_sm90_kernel<kD><<<grid, kF32BwdThreads, bytes, stream>>>(
        q, k, v, dout, st, dsb, dsl, dsh, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
