// Flash-attention backward for Hopper (sm_90a) in fp32 on the tensor
// cores: the fp32 body of K2 and K5, dK and dV (csrc/flash_bwd.cu,
// `flash_bwd_dkv_f32_sm90_kernel` and `flash_masked_bwd_dkv_f32_sm90_kernel`).
//
// Replaces `_flash_bwd_dkv_kernel` (mmpl_tpu/ops/attention.py:373) and, with
// kMasked, `_masked_bwd_dkv_kernel` (:783): dV = sum P^T dO and dK = scale *
// sum dS^T Q over the queries, with P = exp(scale * Q K^T - lse) from the
// natural-log lse that K1 saved and dS = P o (dO V^T - delta), delta =
// rowsum(dO o O) as the wrapper computed it.  P and dS stay fp32 (split,
// below), as the TPU kernel keeps them (attention.py:393, :403-409).
//
// What bounds it on an H100: operations (8*B*N*Lq*Lk*D FLOPs, four
// products, times the admitted share of tiles when masked, against
// B*N*(2*Lq + 4*Lk)*D fp32 elements in and out).  As in
// the fp32 K1 (flash_fwd_f32_sm90.cuh), fp32 reaches the tensor cores
// only as TF32, and split TF32 (sm90_common.cuh) takes three passes a
// product, so the body can reach at most a third of the TF32 rate.  What
// the design does about it:
//
//  * Block: 64 keys of one (b, head), 256 threads.  Warpgroup 1 is the
//    consumer and runs four products a tile of 32 queries, each as
//    a_lo b_hi + a_hi b_lo + a_hi b_hi: S^T = K Q^T and dP^T = V dO^T
//    (m64n32k8, K and V from shared memory as they lie), then P^T and dS^T
//    split in registers, then dV += P^T dO and dK += dS^T Q (m64n{kD}k8, A
//    from registers, dO and Q read as dO^T and Q^T).
//  * TF32 takes only K-major shared-memory operands, so dO and Q are
//    needed twice: as rows (the contraction over the head dim) and as
//    columns (over the queries).  Warpgroup 0 is the producer: each thread
//    reads 32 head-dim columns of one query row of Q and dO from device
//    memory into registers (strided, 64-bit offsets, zeros past Lq and D),
//    and writes them split, swizzled, first as rows and then, from the
//    same registers, as columns with the queries of each group of 8 in the
//    order that makes the S^T and dP^T accumulators the A fragments as
//    they stand (`tf32_slot`).  K and V are written once, as rows.
//  * Shared memory at kD = 128: K and V hi and lo, 4 x 32 KB, resident;
//    two slots of 32 KB (a hi and a lo plane of 32 x 128) take a tile's
//    four operands in turn: slot A holds Q, then dO^T; slot B dO, then
//    Q^T, each use with a full and an empty mbarrier.  The producer
//    writes a tile's columns while the consumer finishes S^T and dP^T and
//    its per-element step, and the next tile's rows while it runs dV and
//    dK: 192 KB, one block per SM (kD = 64 halves it).  Holding both the
//    rows and the columns of a 64-query tile would take 256 KB on top of
//    K and V, hence 32 queries a tile and the slots taking turns.
//  * The per-element step as in the bf16 body (p = exp2(s * scale *
//    log2(e) - lse * log2(e)), dS = p (dP - delta)); the producer writes
//    the tile's lse * log2(e) and delta to shared memory with dO's rows,
//    so the consumer does not hold them across the products.  Query rows
//    past Lq have q = dO = 0 and lse = delta = 0, so they add exactly 0;
//    keys past Lk get p = 0 and are not stored.
//  * The tensor cores' fp32 sums drift (flash_fwd_f32_sm90.cuh): dK and dV
//    accumulated over all 1,024 query tiles of 32760 queries were 2.3e-4
//    from the plain version on an H100.  So they accumulate in registers
//    for kF32DkvFold tiles, then each thread adds its values into the
//    fp32 outputs (its own elements: no atomics; the block owns its 64
//    keys' rows, and no split of the query loop) and restarts from 0:
//    4.3e-6 at 32760 queries.
//  * The products' chains are interleaved two by two (S^T with dP^T, dV
//    with dK), so the tensor cores never wait on one accumulator's last
//    product: 52 against 36 TFLOP/s one chain after the other at 4680 x
//    32760 on an H100.  S^T and dP^T take their two small passes first.
//    Registers: the consumer holds dK and dV (kD / 2 each), S^T and dP^T
//    (32) and the four split fragments (64): 255 a thread at kD = 128,
//    with ~70 bytes of spills.
//  * K5 (kMasked) walks the admitted 32-query tiles of the block's column
//    of the 64 x 64 tile table (`mask.tiles`, `tiles.t64`, query-major, so
//    entry i of the column is tiles[i * nkt + blockIdx.x]): an entry
//    covers two tiles (the last one, where ceil(Lq / 32) is odd); 0 skips
//    both and is never loaded, 2 admits every pair, 1 tests each pair
//    fm[qf[q], kf[k]] (the [F, F] table read from device memory, L2
//    resident, so F is unbounded).  The producer writes each tile's class
//    and query frame ids with dO's rows, beside its lse and delta, and
//    writes lse = +inf for the rows whose lse is -inf (masked rows that
//    saw no key: the guard of `_masked_p`, :771-780), so that their p is
//    exp2(-inf) = 0 and not inf times 0.  The consumer makes a 16-bit mask
//    of its pairs once S^T and dP^T are in (a class-2 tile's is fixed for
//    the thread): made while they ran, as fp32 K6 does, it held K5 at 2.0x
//    the FMA template's speed at the teacher-forcing self-attention on an
//    H100, against 2.8x made here (`flash_compare --kernel masked --dtype
//    float32`).  The folds count the tiles walked; a key
//    block with no admitted tile writes dK = dV = 0.  The class and ids
//    take 256 bytes beside K2's 192 KB.
#pragma once

#include "sm90_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kF32BwdThreads = 256;  // producer warpgroup + one consumer
constexpr int kF32KeyBlock = 64;    // keys of a block
constexpr int kF32QueryTile = 32;   // queries of a tile: one 128-byte row of Q^T
// query tiles that dK and dV accumulate on the tensor cores before they
// are folded into the fp32 outputs
constexpr int kF32DkvFold = 16;

// K5: a query tile's class and frame ids, handed over with its rows
struct F32DkvMeta {
  int cls;                   // 1: test each pair, 2: every pair allowed
  int qf[kF32QueryTile];     // its queries' frame ids (0 past Lq)
};

template <int kD, bool kMasked = false>
struct F32DkvLayout {
  static constexpr int boxes = kD / 32;
  static constexpr int kv_box = kF32KeyBlock * 128;        // [64 keys, 32 columns]
  static constexpr int kv_plane = boxes * kv_box;
  static constexpr int q_box = kF32QueryTile * 128;        // [32 queries, 32 columns]
  static constexpr int plane = boxes * q_box;              // = kD * 128, a transposed plane
  static constexpr int k = 0;                              // K hi, K lo, V hi, V lo
  static constexpr int v = k + 2 * kv_plane;
  static constexpr int a = v + 2 * kv_plane;               // slot A: hi, lo
  static constexpr int b = a + 2 * plane;                  // slot B: hi, lo
  // the tile's lse * log2(e) and delta, 32 each, written with slot B's dO
  static constexpr int rows = b + 2 * plane;
  // K5's F32DkvMeta, written with them
  static constexpr int meta = rows + 2 * kF32QueryTile * 4;
  static constexpr int bar = meta + (kMasked ? 256 : 0);
  // kv_full, a_full, a_empty, b_full, b_empty
  static constexpr int bytes = bar + 8 * 5 + 1024;  // + alignment slack
  static_assert(plane == kD * 128, "a row-major and a transposed plane have one size");
  static_assert(sizeof(F32DkvMeta) <= 256, "the tile's meta fits its room");
};
static_assert(F32DkvLayout<128, true>::bytes <= kMaxSmem,
              "the fp32 K2 and K5 body fits one block an SM");

// K5: the admitted entries of a column of `n` entries `stride` bytes apart,
// counted by each lane of a warp.
__device__ __forceinline__ int count_admitted_col(const unsigned char* col, long long stride, int n,
                                                  int lane) {
  int count = 0;
  for (int i = lane; i < n; i += 32) count += col[(long long)i * stride] != 0;
  return (int)__reduce_add_sync(0xffffffffu, (unsigned)count);
}

struct F32BwdParams {
  float* dk;
  float* dv;
  const float* lse;    // [B, N, Lq] fp32, natural log
  const float* delta;  // [B, N, Lq] fp32
  long long ab, al, ah, cb, cl, ch;  // dk's, dv's element strides (batch, row, head)
  int Lq, Lk, N, D;
  float scale;         // the natural softmax scale: dK = scale * its sum
  float scale_log2;    // scale * log2(e), the exponent's
};

// S^T = K Q^T and dP^T = V dO^T for a 32-query tile, 3 passes a k8 step
// over the head dim, A the resident K and V, B the tile's Q and dO rows in
// slots A and B (`d0` the descriptor of the layout's base; every plane at
// its fixed offset, lo a plane after hi).  The two products' chains are
// interleaved, so the tensor cores never wait on one accumulator's last
// product, each with its two small passes first; the first product of
// each overwrites it.
template <int kD>
__device__ __forceinline__ void f32_issue_rows(float (&s)[16], float (&dp)[16], uint64_t d0) {
  using L = F32DkvLayout<kD>;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t a = (kk / 4) * L::kv_box + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * L::q_box + (kk % 4) * 32;
    wgmma_tf32_ss_n32(s, desc_at(d0, L::k + L::kv_plane + a), desc_at(d0, L::a + b), kk > 0);
    wgmma_tf32_ss_n32(dp, desc_at(d0, L::v + L::kv_plane + a), desc_at(d0, L::b + b), kk > 0);
    wgmma_tf32_ss_n32(s, desc_at(d0, L::k + a), desc_at(d0, L::a + L::plane + b), 1);
    wgmma_tf32_ss_n32(dp, desc_at(d0, L::v + a), desc_at(d0, L::b + L::plane + b), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t a = (kk / 4) * L::kv_box + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * L::q_box + (kk % 4) * 32;
    wgmma_tf32_ss_n32(s, desc_at(d0, L::k + a), desc_at(d0, L::a + b), 1);
    wgmma_tf32_ss_n32(dp, desc_at(d0, L::v + a), desc_at(d0, L::b + b), 1);
  }
}

// dV += P^T dO and dK += dS^T Q over the tile's 32 queries: A the split
// fragments, B the transposed planes dO^T and Q^T in slots A and B (`d0`
// as above); the two chains interleaved.
template <int kD>
__device__ __forceinline__ void f32_issue_cols(float (&dv)[kD / 2], float (&dk)[kD / 2],
                                               const uint32_t (&ph)[4][4],
                                               const uint32_t (&pl)[4][4],
                                               const uint32_t (&dh)[4][4],
                                               const uint32_t (&dl)[4][4], uint64_t d0) {
  using L = F32DkvLayout<kD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs<kD>(dv, pl[kk], desc_at(d0, L::a + kk * 32));
    wgmma_tf32_rs<kD>(dk, dl[kk], desc_at(d0, L::b + kk * 32));
    wgmma_tf32_rs<kD>(dv, ph[kk], desc_at(d0, L::a + L::plane + kk * 32));
    wgmma_tf32_rs<kD>(dk, dh[kk], desc_at(d0, L::b + L::plane + kk * 32));
    wgmma_tf32_rs<kD>(dv, ph[kk], desc_at(d0, L::a + kk * 32));
    wgmma_tf32_rs<kD>(dk, dh[kk], desc_at(d0, L::b + kk * 32));
  }
}

// A consumer's [64, kD] fp32 accumulator times `mul` added into (`first`:
// written to) rows row0 + 16 w (+ 8) of a strided [L, D] slab, and zeroed;
// rows >= L and columns >= D are dropped.  Each element is this thread's
// alone, so the sum needs no atomics.
template <int kD>
__device__ __forceinline__ void f32_fold_acc(float* dst, long long srow, int row0, int L, int D,
                                             float (&acc)[kD / 2], float mul, bool first) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float* orow = dst + (long long)row * srow;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (row < L && col < D) {
        float2* at = reinterpret_cast<float2*>(orow + col);
        const float2 was = first ? make_float2(0.f, 0.f) : *at;
        *at = make_float2(fmaf(acc[4 * c + 2 * r], mul, was.x),
                          fmaf(acc[4 * c + 2 * r + 1], mul, was.y));
      }
      acc[4 * c + 2 * r] = acc[4 * c + 2 * r + 1] = 0.f;
    }
  }
}

// K2 in fp32 (K5 with kMasked): dK and dV of 64 keys over every query
// tile, or over the admitted ones of `mask`.
template <int kD, bool kMasked>
__device__ __forceinline__ void f32_dkv_body(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout, const FwdStrides& st,
                                             long long dsb, long long dsl, long long dsh,
                                             const F32BwdParams& p, const FrameMask& mask) {
  using L = F32DkvLayout<kD, kMasked>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);  // generic pointer to `base`
  F32DkvMeta* const meta = reinterpret_cast<F32DkvMeta*>(sm + L::meta);
  const uint32_t kv_full = base + L::bar;
  const uint32_t a_full = kv_full + 8, a_empty = kv_full + 16;
  const uint32_t b_full = kv_full + 24, b_empty = kv_full + 32;

  const int k0 = blockIdx.x * kF32KeyBlock;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nt = (p.Lq + kF32QueryTile - 1) / kF32QueryTile;
  // K5: this key block's column of the 64 x 64 table; entry i / 2 covers
  // the 32-query tile i
  const unsigned char* const tcol = kMasked ? mask.tiles + blockIdx.x : nullptr;
  auto entry = [&](int i) { return tcol[(long long)(i >> 1) * mask.nkt]; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 128);  // every producer thread
    mbar_init(a_full, 128);
    mbar_init(b_full, 128);
    mbar_init(a_empty, 4);    // every consumer warp
    mbar_init(b_empty, 4);
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
    const float* qg = q + b * st.qb + h * st.qh;
    const float* dg = dout + b * dsb + h * dsh;
    float4 qx[8], dx[8];  // a tile's Q and dO rows as read
    uint4 hi[8], lo[8];   // one of them split
    if (works) {
      const float* kg = k + b * st.kb + h * st.kh;
      const float* vg = v + b * st.vb + h * st.vh;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = k0 + 32 * half + lane;
        const int r = 32 * half + lane;
        load_row32(qx, kg + (long long)key * st.kl, key < p.Lk, c0, p.D);
        load_row32(dx, vg + (long long)key * st.vl, key < p.Lk, c0, p.D);
        unsigned char* kb = sm + L::k + warp * L::kv_box;
        unsigned char* vb = sm + L::v + warp * L::kv_box;
        split_row32(qx, hi, lo);
        store_row_split(kb, kb + L::kv_plane, r, hi, lo);
        split_row32(dx, hi, lo);
        store_row_split(vb, vb + L::kv_plane, r, hi, lo);
      }
    }
    fence_async_smem();
    mbar_arrive(kv_full);

    // the next tile the walk admits from tile i on (K2: i itself)
    auto next = [&](int i) {
      if constexpr (kMasked)
        while (i < nt && entry(i) == 0) ++i;
      return i;
    };
    auto load_q = [&](int i) {
      const int row = i * kF32QueryTile + lane;
      load_row32(qx, qg + (long long)row * st.ql, row < p.Lq, c0, p.D);
    };
    auto load_d = [&](int i) {
      const int row = i * kF32QueryTile + lane;
      load_row32(dx, dg + (long long)row * dsl, row < p.Lq, c0, p.D);
    };
    // the lse * log2(e) and delta of this lane's query: the tile's (c) and
    // the next one's (n), read with its rows; K5 also its frame id and the
    // tile's class
    float* const rows = reinterpret_cast<float*>(sm + L::rows);
    const long long rb = (b * p.N + h) * (long long)p.Lq;
    float lse_c = 0.f, del_c = 0.f, lse_n = 0.f, del_n = 0.f;
    int qf_c = 0, qf_n = 0, cls_c = 0, cls_n = 0;
    auto load_rows = [&](int i) {
      const int qi = i * kF32QueryTile + lane;
      const bool in = qi < p.Lq;  // past Lq nothing is read: 0, 0
      lse_n = in ? __ldg(p.lse + rb + qi) * kLog2e : 0.f;
      del_n = in ? __ldg(p.delta + rb + qi) : 0.f;
      if constexpr (kMasked) {
        if (lse_n == -INFINITY) lse_n = INFINITY;  // a row that saw no key: p = 0
        qf_n = in ? __ldg(mask.qf + qi) : 0;
        cls_n = entry(i);
      }
    };
    // write a slot's use n (its hi plane at `at`) from hi / lo: wait for use
    // n - 1's release, write, make the writes visible to the tensor cores,
    // arrive
    auto fill = [&](uint32_t empty, uint32_t full, int n, int at, bool cols) {
      mbar_wait(empty, (n & 1) ^ 1);  // the first use passes
      if (at == L::b && !cols && warp == 0) {  // with dO's rows, the tile's lse and delta
        rows[lane] = lse_c;
        rows[kF32QueryTile + lane] = del_c;
        if constexpr (kMasked) {  // and its frame ids and class
          meta->qf[lane] = qf_c;
          if (lane == 0) meta->cls = cls_c;
        }
      }
      if (works) {
        if (cols)
          store_col_split(sm + at, sm + at + L::plane, c0, tf32_slot(lane), hi, lo);
        else
          store_row_split(sm + at + warp * L::q_box, sm + at + L::plane + warp * L::q_box, lane,
                          hi, lo);
      }
      fence_async_smem();
      mbar_arrive(full);
    };
    // each tile: split Q, fill slot A with its rows; split dO, fill slot B
    // with its rows and slot A with its columns; split Q again, fill slot B
    // with its columns.  The next tile's dO is read once dO's last form is
    // written, its Q once Q's is (holding both split at once ran 5% slower
    // on an H100: more registers, more spills).  K2's loop, written as
    // before K5 shared the body: the walk's loop below, or this one in the
    // form of a lambda both drive, changed the code K2 compiles to
    if constexpr (!kMasked) {
      if (works && nt > 0) {
        load_q(0);
        load_d(0);
        load_rows(0);
      }
      for (int i = 0; i < nt; ++i) {
        lse_c = lse_n;
        del_c = del_n;
        if (works) split_row32(qx, hi, lo);
        fill(a_empty, a_full, 2 * i, L::a, false);      // Q: S^T
        if (works) split_row32(dx, hi, lo);
        fill(b_empty, b_full, 2 * i, L::b, false);      // dO: dP^T
        fill(a_empty, a_full, 2 * i + 1, L::a, true);   // dO^T: dV
        if (works && i + 1 < nt) load_d(i + 1);
        if (works) split_row32(qx, hi, lo);
        fill(b_empty, b_full, 2 * i + 1, L::b, true);   // Q^T: dK
        if (works && i + 1 < nt) {
          load_q(i + 1);
          load_rows(i + 1);
        }
      }
      return;
    }
    // K5: the same over the admitted tiles, tile `in` the next one
    int i = next(0);
    if (works && i < nt) {
      load_q(i);
      load_d(i);
      load_rows(i);
    }
    while (i < nt) {
      const int in = next(i + 1);
      lse_c = lse_n;
      del_c = del_n;
      qf_c = qf_n;
      cls_c = cls_n;
      if (works) split_row32(qx, hi, lo);
      fill(a_empty, a_full, 0, L::a, false);  // Q: S^T
      if (works) split_row32(dx, hi, lo);
      fill(b_empty, b_full, 0, L::b, false);  // dO: dP^T
      fill(a_empty, a_full, 1, L::a, true);   // dO^T: dV
      if (works && in < nt) load_d(in);
      if (works) split_row32(qx, hi, lo);
      fill(b_empty, b_full, 1, L::b, true);   // Q^T: dK
      if (works && in < nt) {
        load_q(in);
        load_rows(in);
      }
      i = in;
    }
  } else {
    // consumer: the block's 64 keys
    const int cwarp = warp - 4;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const int key0 = k0 + cwarp * 16 + g;  // this thread's keys key0, key0 + 8
    const bool keep0 = key0 < p.Lk;
    const bool keep1 = key0 + 8 < p.Lk;
    const float* const rows = reinterpret_cast<const float*>(sm + L::rows);
    float* const dk_out = p.dk + b * p.ab + h * p.ah;
    float* const dv_out = p.dv + b * p.cb + h * p.ch;
    // the steps of the walk: every query tile, or K5's admitted ones (two
    // a 64 x 64 entry, one for a last entry that covers a single tile)
    int n = nt;
    // K5: the frame table's columns of this thread's two keys, and which of
    // its pairs a tile of class 2 keeps (element e's key: e >> 1 & 1)
    const unsigned char* fmcol[2] = {nullptr, nullptr};
    uint32_t keeps = 0;
    if constexpr (kMasked) {
      const int nq = (nt + 1) / 2;
      n = 2 * count_admitted_col(tcol, mask.nkt, nq, lane) - ((nt & 1) && entry(nt - 1) != 0);
      fmcol[0] = keep0 ? mask.fm + __ldg(mask.kf + key0) : nullptr;
      fmcol[1] = keep1 ? mask.fm + __ldg(mask.kf + key0 + 8) : nullptr;
#pragma unroll
      for (int e = 0; e < 16; ++e) keeps |= (uint32_t)((e & 2) ? keep1 : keep0) << e;
    }

    float dk[kD / 2], dv[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
    float sT[16], dpT[16];
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];

    const uint64_t d0 = smem_desc(base, 16);
    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      mbar_wait(a_full, 0);
      mbar_wait(b_full, 0);
      fence_regs(dk);
      fence_regs(dv);
      wg_fence();
      // S^T = K Q^T, dP^T = V dO^T
      f32_issue_rows<kD>(sT, dpT, d0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      if (signals) {
        mbar_arrive(a_empty);
        mbar_arrive(b_empty);
      }
      // element e is key row g + 8 ((e >> 1) & 1), query column
      // c = 8 (e / 4) + 2 t + (e & 1), its lse * log2(e) and delta in `rows`
      // (slot B's, until its release after dK).  K5: which of this thread's
      // pairs count, tested on a class-1 tile.  Here and not while S^T and
      // dP^T run (the note above)
      uint32_t ok = keeps;
      if constexpr (kMasked) {
        if (meta->cls == 1) {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int c = 8 * (e / 4) + 2 * t + (e & 1);
            const unsigned char* col = fmcol[(e >> 1) & 1];
            if (col == nullptr || col[(long long)meta->qf[c] * mask.F] == 0) ok &= ~(1u << e);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = 8 * (e / 4) + 2 * t + (e & 1);
        bool keep;
        if constexpr (kMasked)
          keep = (ok >> e) & 1u;
        else
          keep = (e & 2) ? keep1 : keep0;
        const float pe = keep ? ex2(sT[e] * p.scale_log2 - rows[c]) : 0.f;
        sT[e] = pe;
        dpT[e] = pe * (dpT[e] - rows[kF32QueryTile + c]);
      }
      split_frag<4>(ph, pl, sT);
      split_frag<4>(dh, dl, dpT);
      mbar_wait(a_full, 1);
      mbar_wait(b_full, 1);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
      wg_fence();
      // dV += P^T dO, dK += dS^T Q
      f32_issue_cols<kD>(dv, dk, ph, pl, dh, dl, d0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
      if (signals) {
        mbar_arrive(a_empty);
        mbar_arrive(b_empty);
      }
      if ((i + 1) % kF32DkvFold == 0 || i == n - 1) {
        f32_fold_acc<kD>(dk_out, p.al, key0, p.Lk, p.D, dk, p.scale, i < kF32DkvFold);
        f32_fold_acc<kD>(dv_out, p.cl, key0, p.Lk, p.D, dv, 1.f, i < kF32DkvFold);
      }
    }
    if (n == 0) {  // no query, or K5 with no admitted tile: dK = dV = 0
      f32_fold_acc<kD>(dk_out, p.al, key0, p.Lk, p.D, dk, p.scale, true);
      f32_fold_acc<kD>(dv_out, p.cl, key0, p.Lk, p.D, dv, 1.f, true);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
flash_bwd_dkv_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const FwdStrides st, const long long dsb, const long long dsl,
                              const long long dsh, const F32BwdParams p) {
  f32_dkv_body<kD, false>(q, k, v, dout, st, dsb, dsl, dsh, p, FrameMask{});
}

template <int kD>
__global__ void __launch_bounds__(kF32BwdThreads, 1)
flash_masked_bwd_dkv_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, const float* __restrict__ dout,
                                     const FwdStrides st, const long long dsb,
                                     const long long dsl, const long long dsh,
                                     const F32BwdParams p, const FrameMask mask) {
  f32_dkv_body<kD, true>(q, k, v, dout, st, dsb, dsl, dsh, p, mask);
}

// K2 in fp32 at head-dim width kD (K5 with kMasked, over `mask`'s 64 x 64
// table): `st` holds q's, k's and v's element strides, (dsb, dsl, dsh)
// dO's.  0 or a cudaError_t.
template <int kD, bool kMasked>
int launch_f32_dkv(const float* q, const float* k, const float* v, const float* dout,
                   const FwdStrides& st, long long dsb, long long dsl, long long dsh,
                   const F32BwdParams& p, const FrameMask& mask, int B, cudaStream_t stream) {
  constexpr int bytes = F32DkvLayout<kD, kMasked>::bytes;
  const dim3 grid((p.Lk + kF32KeyBlock - 1) / kF32KeyBlock, p.N, B);
  cudaError_t err;
  if constexpr (kMasked) {
    err = cudaFuncSetAttribute(flash_masked_bwd_dkv_f32_sm90_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_masked_bwd_dkv_f32_sm90_kernel<kD><<<grid, kF32BwdThreads, bytes, stream>>>(
        q, k, v, dout, st, dsb, dsl, dsh, p, mask);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_sm90_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32_sm90_kernel<kD><<<grid, kF32BwdThreads, bytes, stream>>>(
        q, k, v, dout, st, dsb, dsl, dsh, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
