// Flash-attention forward for Hopper (sm_90a) in fp32 on the tensor cores:
// the fp32 body of K1, K4 and P1 (csrc/flash_fwd.cu,
// `flash_fwd_f32_sm90_kernel`, `flash_masked_fwd_f32_sm90_kernel` and
// `flash_exp2_f32_sm90_kernel`).
//
// Replaces `_flash_fwd_kernel` (mmpl_tpu/ops/attention.py:324): O =
// softmax(scale * Q K^T) V per (batch, head) and the natural-log lse
// [B, N, Lq] in fp32, for fp32 q, k and v (the default trunk of the
// trainer's ODE and distillation objectives).  With kMasked it replaces
// `_masked_fwd_kernel` (:725), the same under a frame mask.  P1, the exp2 probe's
// forward (`_fwd_kernel`, tools/exp2_probe.py:42), is the same body with
// the bf16 body's three choices: kExp2 (log2(e) folded into the scale on
// the host and exp2 for alpha, p and the folds' rescale, or exp on the
// natural scale), kPadMask (keep or drop the test of the keys past Lk on
// the last tile; dropped only where Lk is a multiple of 64, so every
// 32-key tile is whole) and kLse (K1 writes the lse, P1 O only).
//
// What bounds it on an H100: operations.  The work is 4*B*N*Lq*Lk*D FLOPs
// against B*N*(2*Lq + 2*Lk)*D fp32 elements in and out, far above the
// card's ridge at those shapes.  fp32 reaches the tensor cores only as
// TF32 (495 TFLOP/s dense), whose 10 mantissa bits miss the fp32 paths'
// 1e-4 tolerance; split TF32 (sm90_common.cuh) keeps about 21 bits of each
// operand for three products per product, so this body can reach at most a
// third of the TF32 rate (165 TFLOP/s of attention), against 67 TFLOP/s
// for any FMA body.  The design keeps the three passes on wgmma:
//
//  * Block: 64 query rows of one (b, head), 256 threads in two
//    warpgroups.  Warpgroup 1 is the consumer: S = Q K^T as m64n32k8 with
//    K from shared memory, O += P V as m64n{kD}k8 with P in registers,
//    each product as a_lo b_hi + a_hi b_lo + a_hi b_hi.  Tile j+1's S
//    product is issued before tile j's PV product, so the softmax of tile
//    j+1 runs while PV of tile j is on the tensor cores.
//  * Warpgroup 0 is the producer, and prepares the operands: TF32 takes
//    only K-major shared-memory operands, so the PV product needs V
//    transposed (keys contiguous), and every shared-memory operand needs a
//    hi and a lo plane.  Each producer thread reads 32 head-dim columns of
//    one token row from device memory into registers (strided, 64-bit
//    offsets, zeros past L and D), splits them, and writes them swizzled
//    as the consumer's descriptors read them: Q and K as rows, V as
//    columns of Vt, its keys in each group of 8 in the order that makes the
//    S accumulator the PV product's A fragment as it stands (`tf32_slot`).
//    Reading through registers and not by TMA is the design's choice: the
//    values have to pass through registers to be split and transposed, so
//    a TMA copy would be read back by the same threads and cost a staging
//    buffer the shared memory does not have at kD = 128.  The next tile's
//    rows are read while the producer waits for a free stage (two tiles in
//    registers measured no faster on an H100): each tile is split as soon
//    as it is in registers, the next one's reads are issued at once, and
//    only the stores wait for the free stage.
//  * The ring: kF32Stages stages of (K hi, K lo, Vt hi, Vt lo), 32 keys a
//    stage (one 128-byte row of Vt), each with full and empty mbarriers for
//    the K and the V half; the producer threads make their writes visible
//    to the tensor cores (fence.proxy.async) before they arrive.
//  * Softmax in fp32 as in the bf16 body (exp2, log2(e) folded into the
//    scale on the host; m, l, the l == 0 guard, the natural-log lse).  P is
//    split in registers (p - rna_tf32(p) and its rounding).  The last key
//    tile masks the keys past Lk per element; rows past Lq are not stored.
//  * The tensor cores' fp32 sums drift: each wgmma that adds into a large
//    accumulator loses a fraction of its last bit, always the same way
//    (~2e-8 of the value a wgmma on an H100; over 32760 queries dV was
//    2.3e-4 from the plain version, and O's largest error over 32760 keys
//    1.8e-5, 35x the template's).  So O accumulates on the tensor cores
//    for kF32Fold tiles only, is then added to an fp32 copy in shared
//    memory with rounded sums (scaled to the new row maxima) and restarts
//    from 0: O's error 4.8e-7, for ~4% of the time.  S takes its two small
//    passes first.
//  * K4 (kMasked) walks the admitted 32-key tiles of the block's row of the
//    64 x 64 tile table (`mask.tiles`, `tiles.t64`): an entry covers two
//    tiles (one for a last entry where ceil(Lk / 32) is odd); 0 skips both
//    and is never loaded, 2 admits every pair, 1 tests each pair
//    fm[qf[q], kf[k]] (the [F, F] table read from device memory, L2
//    resident, so F is unbounded).  The producer writes each tile's index,
//    class and key frame ids with its K half; the consumer turns them into
//    a 16-bit mask of its elements, the keys past Lk included, while PV of
//    the step before runs and before it frees the K stage.  A row that has
//    seen no allowed key keeps m = -inf: the softmax shifts it by 0 and the
//    fold scales it by 0, so it stays at O = 0 without NaNs, and a row that
//    sees nothing ends with O = 0 and lse = -inf.  The folds count the
//    tiles walked.  The tiles' meta takes 512 bytes beside K1's 224 KB.
//  * S = Q K^T would read Q's 64-row A slice from shared memory for every
//    wgmma, twice the bytes of K's 32-row B slice: the consumer holds Q's
//    hi plane in registers as A fragments (read once a block), so two of
//    S's three passes read only K.
//
// Shared memory at kD = 128: Q hi and lo 2 x 32 KB, per stage K hi and lo
// 2 x 16 KB and Vt hi and lo 2 x 16 KB, and O's fp32 copy 32 KB: 64 + 2 x
// 64 + 32 = 224 KB, one block per SM (kD = 64 halves it).  Registers: the
// consumer holds S (16), O (kD / 2), Q's hi fragments (kD / 2) and P's
// fragments (32), the producer a tile's K and V rows as read and split
// (6 x 32 values); 252 a thread at kD = 128, no spill.
#pragma once

#include "sm90_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kF32Threads = 256;   // producer warpgroup + one consumer
constexpr int kF32BlockM = 64;     // query rows of a block
constexpr int kF32KeyTile = 32;    // keys of a stage: one 128-byte row of Vt
constexpr int kF32Stages = 2;
// key tiles that O accumulates on the tensor cores before it is folded
// into its fp32 copy in shared memory
constexpr int kF32Fold = 16;

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int kD, bool kMasked = false>
struct F32FwdLayout {
  static constexpr int boxes = kD / 32;                    // 32-column boxes of a row
  static constexpr int q_box = kF32BlockM * 128;           // [64 rows, 32 columns]
  static constexpr int q_plane = boxes * q_box;
  static constexpr int k_box = kF32KeyTile * 128;          // [32 keys, 32 columns]
  static constexpr int k_plane = boxes * k_box;
  static constexpr int vt_plane = kD * 128;                // [kD rows, 32 keys]
  static constexpr int q = 0;                              // Q hi, then Q lo
  static constexpr int kv = q + 2 * q_plane;
  // stage s: K hi, K lo, Vt hi, Vt lo
  static constexpr int stage = 2 * k_plane + 2 * vt_plane;
  // O's fp32 copy: each consumer thread's kD / 2 values, 128 threads apart
  static constexpr int o = kv + kF32Stages * stage;
  // K4: each stage's F32TileMeta, written with its K half
  static constexpr int meta = o + (kD / 2) * 128 * 4;
  static constexpr int bar = meta + (kMasked ? kF32Stages * 256 : 0);
  // q_full, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int bytes = bar + 8 * (1 + 4 * kF32Stages) + 1024;  // + alignment slack
  static_assert(sizeof(F32TileMeta) <= 256, "the tile's meta fits its room");
};
static_assert(F32FwdLayout<128, true>::bytes <= kMaxSmem,
              "the fp32 K1 and K4 body fits one block an SM");

// S = Q K^T of a stage, 3 passes a k8 step over the head dim, the two
// small ones first (the tensor cores' sums lose more of a large
// accumulator): q_lo k_hi with Q's lo plane from shared memory (`q` the
// address of Q's hi plane, lo a plane later), q_hi k_lo and q_hi k_hi with
// Q's hi plane from registers (`qa`, the A fragments of every k8 step:
// Q is the same for every tile, so only K is read a tile); `k` the
// address of the stage's K hi plane.  The first product overwrites s.
template <int kD>
__device__ __forceinline__ void f32_issue_qk(float (&s)[16], const uint32_t (&qa)[kD / 8][4],
                                             uint32_t q, uint32_t k) {
  using L = F32FwdLayout<kD>;
  const uint64_t dq = smem_desc(q + L::q_plane, 16), dk = smem_desc(k, 16);
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint32_t at = (kk % 4) * 32;
    const uint64_t kh = desc_at(dk, (kk / 4) * L::k_box + at);
    wgmma_tf32_ss_n32(s, desc_at(dq, (kk / 4) * L::q_box + at), kh, kk > 0);
    wgmma_tf32_rs<32>(s, qa[kk], desc_at(kh, L::k_plane));
  }
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk)
    wgmma_tf32_rs<32>(s, qa[kk], desc_at(dk, (kk / 4) * L::k_box + (kk % 4) * 32));
}

// O += P V of a stage (`vt` the address of its Vt hi plane, lo a plane
// later): 4 k8 steps over the 32 keys.
template <int kD>
__device__ __forceinline__ void f32_issue_pv(float (&o)[kD / 2], const uint32_t (&ph)[4][4],
                                             const uint32_t (&pl)[4][4], uint32_t vt) {
  using L = F32FwdLayout<kD>;
  const uint64_t dv = smem_desc(vt, 16);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t vh = desc_at(dv, kk * 32);
    wgmma_tf32_rs<kD>(o, pl[kk], vh);
    wgmma_tf32_rs<kD>(o, ph[kk], desc_at(vh, L::vt_plane));
    wgmma_tf32_rs<kD>(o, ph[kk], vh);
  }
}

// The online softmax of one 32-key tile (the bf16 body's, over 16
// accumulator elements): scale, mask the keys past `valid` (kPadMask) or,
// in K4 (kMasked), every element whose bit of `ok` is clear, update m and
// l, leave the unnormalised probabilities in s.
template <bool kExp2, bool kPadMask, bool kMasked = false>
__device__ __forceinline__ void f32_softmax(float (&s)[16], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], float scale, int valid, int t,
                                            uint32_t ok = 0xffffu) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] *= scale;
  if constexpr (kMasked) {
    if (ok != 0xffffu) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (!((ok >> i) & 1u)) s[i] = -INFINITY;
    }
  } else if (kPadMask && valid < kF32KeyTile) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // K1: every tile holds a key, so m_new is finite; exp2(-inf) = 0 on the
    // first.  K4: a row that has seen no allowed key keeps m = -inf and
    // shifts by 0, so alpha and its p are exp2(-inf) = 0 and not NaN (the
    // guards of attention.py:750-752)
    const float m_new = fmaxf(m[r], mx[r]);
    shift[r] = kMasked && m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = softmax_exp<kExp2>(m[r] - shift[r]);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[i] = softmax_exp<kExp2>(s[i] - shift[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// K1 in fp32 (kLse): O and the natural-log lse, `scale` holding log2(e);
// P1 (kExp2, kPadMask): O only, `scale` holding log2(e) when kExp2; K4
// (kMasked, with kLse): K1 over the 32-key tiles that the block's row of
// `mask.tiles` (the 64 x 64 table) admits.
template <int kD, bool kExp2, bool kPadMask, bool kLse, bool kMasked = false>
__device__ __forceinline__ void f32_fwd_body(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v, float* __restrict__ o,
                                             float* __restrict__ lse, int Lq, int Lk, int N, int D,
                                             const FwdStrides& st, float scale,
                                             const FrameMask& mask) {
  static_assert(!kLse || kExp2, "the lse is converted from the exp2 domain");
  static_assert(!kMasked || (kLse && kPadMask), "K4 is K1 over a walk");
  using L = F32FwdLayout<kD, kMasked>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t q_full = base + L::bar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kF32Stages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kF32Stages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kF32Stages + s); };
  auto k_at = [&](int s) { return L::kv + s * L::stage; };  // K hi; K lo a plane later
  auto vt_at = [&](int s) { return L::kv + s * L::stage + 2 * L::k_plane; };
  auto meta_at = [&](int s) { return reinterpret_cast<F32TileMeta*>(sm + L::meta + 256 * s); };

  const int q0 = blockIdx.x * kF32BlockM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nkb = (Lk + kF32KeyTile - 1) / kF32KeyTile;
  // K4: this query block's row of the 64 x 64 table; entry j / 2 covers the
  // 32-key tile j
  const unsigned char* const trow =
      kMasked ? mask.tiles + (long long)blockIdx.x * mask.nkt : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(k_full(s), 128);  // every producer thread
      mbar_init(v_full(s), 128);
      mbar_init(k_empty(s), 4);   // every consumer warp
      mbar_init(v_empty(s), 4);
    }
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
    const float* kg = k + b * st.kb + h * st.kh;
    const float* vg = v + b * st.vb + h * st.vh;
    float4 kx[8], vx[8];      // a tile's rows as read
    uint4 kh[8], kl[8], vh[8], vl[8];  // and split
    if (works) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + 32 * half + lane;
        load_row32(kx, qg + (long long)row * st.ql, row < Lq, c0, D);
        split_row32(kx, kh, kl);
        unsigned char* hi = sm + L::q + warp * L::q_box;
        store_row_split(hi, hi + L::q_plane, 32 * half + lane, kh, kl);
      }
    }
    fence_async_smem();
    mbar_arrive(q_full);

    // the next tile the walk admits from tile j on (K1, P1: j itself)
    auto next = [&](int j) {
      if constexpr (kMasked)
        while (j < nkb && trow[j >> 1] == 0) ++j;
      return j;
    };
    auto load_tile = [&](int j) {
      const int key = j * kF32KeyTile + lane;
      load_row32(kx, kg + (long long)key * st.kl, key < Lk, c0, D);
      load_row32(vx, vg + (long long)key * st.vl, key < Lk, c0, D);
    };
    int j = next(0);
    if (works && j < nkb) load_tile(j);
    // step i of the walk fills stage i % kF32Stages with tile j
    for (int i = 0; j < nkb; ++i) {
      const int jn = next(j + 1);
      const int s = i % kF32Stages;
      const uint32_t free_parity = ((i / kF32Stages) & 1) ^ 1;  // the first round passes
      if (works) {  // split, read the next tile, then wait only to store
        split_row32(kx, kh, kl);
        split_row32(vx, vh, vl);
        if (jn < nkb) load_tile(jn);
      }
      mbar_wait(k_empty(s), free_parity);
      if (works) {
        unsigned char* hi = sm + k_at(s) + warp * L::k_box;
        store_row_split(hi, hi + L::k_plane, lane, kh, kl);
      }
      if constexpr (kMasked) {  // K4: the tile, its class and its keys' frame ids
        if (warp == 0) {
          const int key = j * kF32KeyTile + lane;
          F32TileMeta* const mt = meta_at(s);
          mt->kf[lane] = key < Lk ? mask.kf[key] : 0;
          if (lane == 0) {
            mt->tile = j;
            mt->cls = trow[j >> 1];
          }
        }
      }
      fence_async_smem();
      mbar_arrive(k_full(s));
      mbar_wait(v_empty(s), free_parity);
      if (works) {
        unsigned char* hi = sm + vt_at(s);
        store_col_split(hi, hi + L::vt_plane, c0, tf32_slot(lane), vh, vl);
      }
      fence_async_smem();
      mbar_arrive(v_full(s));
      j = jn;
    }
  } else {
    // consumer: the block's 64 query rows
    const int cwarp = warp - 4;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp

    float s[16];
    float acc[kD / 2];
    uint32_t qa[kD / 8][4];  // Q's hi plane as the A fragments of S's k8 steps
    uint32_t ph[4][4], pl[4][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    // O's fp32 copy (this thread's values at om[128 i]) and the row maxima
    // it was last scaled to: every kF32Fold tiles acc is added to it with
    // a rounded fp32 sum and restarts from 0 (the note above)
    float* const om = reinterpret_cast<float*>(sm + L::o) + (threadIdx.x - 128);
    float mf[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) om[128 * i] = 0.f;
    auto fold = [&]() {
      float f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // 0 before the first fold (mf = -inf); K4: 0 too while the row has
        // seen no allowed key (m = mf = -inf, acc = 0)
        f[r] = kMasked && m[r] == -INFINITY ? 0.f : softmax_exp<kExp2>(mf[r] - m[r]);
        mf[r] = m[r];
      }
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) {
        om[128 * i] = fmaf(om[128 * i], f[(i >> 1) & 1], acc[i]);
        acc[i] = 0.f;
      }
    };
    // the steps of the walk: every key tile, or K4's admitted ones (two a
    // 64 x 64 entry, one for a last entry that covers a single tile)
    int n = nkb;
    // K4: the frame-table row of each of this thread's two query rows, as
    // an offset into mask.fm (-1 past Lq)
    int fmrow[2] = {-1, -1};
    if constexpr (kMasked) {
      n = 2 * count_admitted(trow, mask.nkt, lane) - ((nkb & 1) && trow[mask.nkt - 1] != 0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + cwarp * 16 + g + 8 * r;
        if (row < Lq) fmrow[r] = mask.qf[row] * mask.F;
      }
    }
    const int last_valid = Lk - (nkb - 1) * kF32KeyTile;
    // K1's and P1's pad test; K4 makes its own in pairs(), from the tile's
    // index (its walk steps are not tile indices)
    auto valid_of = [&](int j) {
      return !kMasked && j == nkb - 1 ? last_valid : kF32KeyTile;
    };
    // K4: the bits of this thread's 16 elements that count in stage sc's
    // tile (element e: query row g + 8 ((e >> 1) & 1), key column 8 (e / 4)
    // + 2 t + (e & 1)): the keys below Lk (K1's pad test: the frame ids
    // past Lk are 0, not a mask) and, on a class-1 tile, the pairs the
    // frame table allows.  Read before the consumer frees the K stage, whose
    // meta the producer then rewrites
    auto pairs = [&](int sc) -> uint32_t {
      if constexpr (!kMasked) {
        return 0xffffu;
      } else {
        const F32TileMeta* const mt = meta_at(sc);
        const int valid = Lk - mt->tile * kF32KeyTile;
        const bool test = mt->cls == 1;
        if (!test && valid >= kF32KeyTile) return 0xffffu;
        uint32_t ok = 0;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int c = 8 * (e / 4) + 2 * t + (e & 1);
          const int fr = fmrow[(e >> 1) & 1];
          bool on = c < valid;
          if (test) on = on && fr >= 0 && mask.fm[fr + mt->kf[c]] != 0;
          ok |= (uint32_t)on << e;
        }
        return ok;
      }
    };

    mbar_wait(q_full, 0);
    {
      const int r0 = cwarp * 16 + g;
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
          const int c = 8 * kk + t + 4 * (e >> 1);
          qa[kk][e] = *reinterpret_cast<const uint32_t*>(
              sm + L::q + (c / 32) * L::q_box + swz32(r0 + 8 * (e & 1), c % 32));
        }
    }
    if (n > 0) {
      mbar_wait(k_full(0), 0);
      wg_fence();
      f32_issue_qk<kD>(s, qa, base + L::q, base + k_at(0));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      const uint32_t ok = pairs(0);
      if constexpr (kMasked) __syncwarp();  // every lane has read the meta
      if (signals) mbar_arrive(k_empty(0));
      f32_softmax<kExp2, kPadMask, kMasked>(s, m, l, alpha, scale, valid_of(0), t, ok);
      split_frag<4>(ph, pl, s);
    }
    for (int i = 1; i < n; ++i) {
      const int sc = i % kF32Stages;
      const int sp = (i - 1) % kF32Stages;
      mbar_wait(k_full(sc), (i / kF32Stages) & 1);
      fence_regs(s);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
      f32_issue_qk<kD>(s, qa, base + L::q, base + k_at(sc));
      wg_commit();
      mbar_wait(v_full(sp), ((i - 1) / kF32Stages) & 1);
      f32_issue_pv<kD>(acc, ph, pl, base + vt_at(sp));
      wg_commit();
      wg_wait<1>();  // S of step i is in; PV of step i-1 may still run
      fence_regs(s);
      const uint32_t ok = pairs(sc);
      if constexpr (kMasked) __syncwarp();  // every lane has read the meta
      if (signals) mbar_arrive(k_empty(sc));
      f32_softmax<kExp2, kPadMask, kMasked>(s, m, l, alpha, scale, valid_of(i), t, ok);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (signals) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) acc[c] *= alpha[(c >> 1) & 1];
      if (i % kF32Fold == 0) fold();  // steps i - kF32Fold .. i - 1
      split_frag<4>(ph, pl, s);
    }
    if (n > 0) {
      const int sl = (n - 1) % kF32Stages;
      mbar_wait(v_full(sl), ((n - 1) / kF32Stages) & 1);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wg_fence();
      f32_issue_pv<kD>(acc, ph, pl, base + vt_at(sl));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    fold();

    float* og = o + b * st.ob + h * st.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lsafe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lsafe;
      const int row = q0 + cwarp * 16 + g + 8 * r;
      if (row >= Lq) continue;
      if (kLse && t == 0)
        lse[(b * N + h) * (long long)Lq + row] =
            m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(lsafe)) * 0.6931471805599453f;
      float* orow = og + (long long)row * st.ol;
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(om[128 * (4 * c + 2 * r)] * inv, om[128 * (4 * c + 2 * r + 1)] * inv);
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int Lq, int Lk, int N, int D,
                          const FwdStrides st, float scale) {
  f32_fwd_body<kD, true, true, true>(q, k, v, o, lse, Lq, Lk, N, D, st, scale, FrameMask{});
}

template <int kD>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_masked_fwd_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ o,
                                 float* __restrict__ lse, int Lq, int Lk, int N, int D,
                                 const FwdStrides st, float scale, const FrameMask mask) {
  f32_fwd_body<kD, true, true, true, true>(q, k, v, o, lse, Lq, Lk, N, D, st, scale, mask);
}

template <int kD, bool kExp2, bool kPadMask>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_exp2_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Lq, int Lk,
                           int N, int D, const FwdStrides st, float scale) {
  f32_fwd_body<kD, kExp2, kPadMask, false>(q, k, v, o, nullptr, Lq, Lk, N, D, st, scale,
                                           FrameMask{});
}

// One launch of an fp32 forward kernel over 64-query blocks with `bytes` of
// dynamic shared memory.  0 or a cudaError_t.
template <typename Kernel, typename... Args>
int launch_f32_kernel(Kernel kernel, int bytes, int B, int Lq, int N, cudaStream_t stream,
                      Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kF32BlockM - 1) / kF32BlockM, N, B);
  kernel<<<grid, kF32Threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// K1 in fp32 at head-dim width kD (kLse; `scale` holds log2(e)), or P1 (O
// only; `lse` unused).  0 or a cudaError_t.
template <int kD, bool kExp2 = true, bool kPadMask = true, bool kLse = true>
int launch_f32_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                   int Lq, int Lk, int N, int D, const FwdStrides& st, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = F32FwdLayout<kD>::bytes;
  if constexpr (kLse)
    return launch_f32_kernel(flash_fwd_f32_sm90_kernel<kD>, bytes, B, Lq, N, stream, q, k, v, o,
                             lse, Lq, Lk, N, D, st, scale);
  else
    return launch_f32_kernel(flash_exp2_f32_sm90_kernel<kD, kExp2, kPadMask>, bytes, B, Lq, N,
                             stream, q, k, v, o, Lq, Lk, N, D, st, scale);
}

// K4 in fp32 at head-dim width kD over `mask`'s 64 x 64 table; `scale`
// holds log2(e).  0 or a cudaError_t.
template <int kD>
int launch_f32_masked_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                          int B, int Lq, int Lk, int N, int D, const FwdStrides& st, float scale,
                          const FrameMask& mask, cudaStream_t stream) {
  return launch_f32_kernel(flash_masked_fwd_f32_sm90_kernel<kD>, F32FwdLayout<kD, true>::bytes,
                           B, Lq, N, stream, q, k, v, o, lse, Lq, Lk, N, D, st, scale, mask);
}

}  // namespace sm90
}  // namespace mmpl
