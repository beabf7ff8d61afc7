// K1's bf16 / fp16 Hopper body (flash_fwd_sm90.cuh) under two other
// schedules, for the shapes where one block per 128-query block leaves the
// card idle or exposes each block's fill and drain (ops/attention.py
// `fwd_schedule` picks the schedule; csrc/flash_fwd.cu `mmpl_flash_fwd_sched`
// launches it):
//
//  * Persistent (`flash_fwd_persistent_sm90_kernel`), short keys: min(#SMs,
//    units) blocks, each walking the units (128-query block, head, batch)
//    u = blockIdx.x, + gridDim.x, ... in one pipeline.  At 257-512 keys a
//    unit is 3-4 key tiles, and the parent's per-block prologue (Q and the
//    first K / V by TMA, nothing to overlap them with), its epilogue (O as
//    4-byte stores, row by row) and the block's launch cost as much as the
//    products.  Here the producer loads the next unit's Q into the second Q
//    buffer and its first K / V tiles while the consumers finish the
//    current unit, and the unit's last PV is issued with the next unit's
//    first S.  Inside a unit the consumers run the parent's loop as it
//    stands (S(j) and PV(j - 1) issued together, the softmax of j under PV
//    of j - 1): issuing S at the end of each step instead, so that the
//    epilogue could run under the next unit's second S, made every step
//    slower on the H100 (not kept).  O leaves through shared memory: each
//    consumer warpgroup writes its 64 rows, rounded, into its rows of the
//    unit's Q buffer (Q is dead once the unit's last S is in) in the TMA's
//    128-byte swizzle, and one thread stores them with a TMA store; the
//    buffer goes back to the producer (its q_empty) once the store has read
//    it, checked a step later so the wait overlaps that step's products.
//  * Key split (`flash_fwd_split_sm90_kernel`), few query blocks and long
//    keys (the GAN head's one query row over 32760 keys: 24 blocks on 132
//    SMs, each walking 256 tiles alone): the units are (128-query block,
//    split, head, batch), split z walking key tiles [z T / S, (z + 1) T /
//    S) of T, in the same walk.  Each writes its rows' O, normalised, in
//    fp32 and their natural-log lse to the workspace; `flash_fwd_merge_kernel`
//    folds the splits in order, launched with programmatic dependent launch
//    so that its launch overlaps the split kernel.  Where Lq <= 64 (every
//    unit's rows 64-127 past Lq) consumer 1 computes nothing and frees each
//    stage as it fills.
//
// What bounds them: at short keys operations and the L2 (every unit
// rereads its head's K and V), at one query row the bytes of K and V; the
// design's point is to keep every SM's tensor cores or loads busy.  Each
// unit runs the parent's pipeline: 128-key tiles, 2 stages, S = Q K^T and
// O += P V on wgmma, the online softmax of flash_fwd_sm90.cuh (exp2, the
// last tile masked per element), 24 / 240 registers a producer / consumer
// thread.  Shared memory at kD = 128: two Q buffers (2 x 32 KB) and the
// K / V stages (2 x 2 x 32 KB), 192 KB.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kQBufs = 2;  // the current unit's Q and the next one's

// Byte offsets in the 1024-aligned dynamic shared memory.  (The split with
// one Q buffer and three stages ran no faster at the GAN head's one query
// row on the H100: not kept.)
template <int kD>
struct SchedLayout {
  static constexpr int halves = Layout<kD>::halves;
  static constexpr int tile = Layout<kD>::tile;  // a Q, K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + kQBufs * tile;
  static constexpr int v = k + kStages * tile;
  static constexpr int bar = v + kStages * tile;
  // q_full, q_empty per Q buffer, then k_full, v_full, k_empty, v_empty per
  // stage
  static constexpr int bytes = bar + 8 * (2 * kQBufs + 4 * kStages) + 1024;  // + alignment slack
};
static_assert(SchedLayout<128>::bytes <= kMaxSmem, "two Q buffers and the stages fit");

struct SchedParams {
  float* lse;        // persistent: the natural-log lse [B, N, Lq]
  float* part;       // split: O of each split, fp32 [S, B, N, Lq, D]
  float* part_lse;   // split: its natural-log lse [S, B, N, Lq]
  int B, N, Lq, Lk, D;
  float scale;       // log2(e) folded in
  int qblocks;       // ceil(Lq / 128)
  int nkb;           // ceil(Lk / 128)
  int splits;        // S (1: persistent)
  int units;         // qblocks * S * N * B
};

// One unit of the walk: 128 query rows from q0 of (b, h) over the key tiles
// [t0, t1).  Units run query block fastest, then split, head and batch, so
// the blocks of one wave share their heads' K and V in the L2.
struct Unit {
  int q0, h, b, z, t0, t1;
};

__device__ __forceinline__ Unit unit_of(int u, const SchedParams& p) {
  Unit w;
  w.q0 = u % p.qblocks * kBlockM;
  int r = u / p.qblocks;
  w.z = r % p.splits;
  r /= p.splits;
  w.h = r % p.N;
  w.b = r / p.N;
  w.t0 = w.z * p.nkb / p.splits;
  w.t1 = (w.z + 1) * p.nkb / p.splits;
  return w;
}

// `n` arrivals on a barrier at once.
__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, uint32_t n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(n) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// One consumer warpgroup's 64 rows of a finished unit: O = o / l and the
// lse.  Persistent: O rounded into this warpgroup's rows of the unit's Q
// buffer (`qrows`: box 0's first row of them; box c lies c * kBoxBytes on)
// and stored by `lead` with a TMA store; split: O in fp32 and the lse to
// the workspace.  Ends at the warpgroup's barrier, after which no thread
// reads the unit's Q buffer.
template <typename T, int kD, bool kSplit>
__device__ __forceinline__ void sched_epilogue(const float (&o)[kD / 2], const float (&m)[2],
                                               float (&l)[2], const Unit& w, uint32_t qrows,
                                               const CUtensorMap& om, const SchedParams& p,
                                               int cw, int warp, int g, int t, bool lead) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lsafe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / lsafe;
    const float lse = m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(lsafe)) * kLn2;
    const int rt = warp * 16 + g + 8 * r;  // row of the warpgroup's 64
    const int row = w.q0 + cw * 64 + rt;
    if constexpr (kSplit) {
      if (row >= p.Lq) continue;
      const long long prow =
          (((long long)w.z * p.B + w.b) * p.N + w.h) * p.Lq + row;
      if (t == 0) p.part_lse[prow] = lse;
      float* dst = p.part + prow * p.D;
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < p.D)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
    } else {
      if (t == 0 && row < p.Lq) p.lse[((long long)w.b * p.N + w.h) * p.Lq + row] = lse;
      // the 16-byte unit c % 8 of row rt sits at unit (c % 8) ^ (rt % 8),
      // rt % 8 == g: a warp's stores fall on 32 banks
#pragma unroll
      for (int c = 0; c < kD / 8; ++c)
        st_shared(qrows + (c / 8) * kBoxBytes + rt * 128 + (((c % 8) ^ g) << 4) + 4 * t,
                  pack2<T>(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv));
    }
  }
  if constexpr (!kSplit) fence_async_smem();
  bar_sync(1 + cw, 128);
  if constexpr (!kSplit) {
    if (lead) {
#pragma unroll
      for (int c = 0; c < kD / kBox; ++c)
        tma_store(om, qrows + c * kBoxBytes, c * kBox, w.h, w.q0 + cw * 64, w.b);
      bulk_commit();
    }
  }
}

template <typename T, int kD, bool kSplit>
__device__ __forceinline__ void flash_fwd_sched_body(const CUtensorMap& qm, const CUtensorMap& km,
                                                     const CUtensorMap& vm, const CUtensorMap& om,
                                                     const SchedParams& p) {
  using L = SchedLayout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::bar;
  auto q_full = [&](int n) { return bars + 8 * n; };
  auto q_empty = [&](int n) { return bars + 8 * (kQBufs + n); };
  auto k_full = [&](int s) { return bars + 8 * (2 * kQBufs + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 * kQBufs + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 * kQBufs + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 * kQBufs + 3 * kStages + s); };
  // the Q buffer of a block's i-th unit and the parity of its i-th filling
  auto qbuf = [&](int i) { return base + L::q + i % kQBufs * L::tile; };
  auto q_parity = [&](int i) { return (uint32_t)(i / kQBufs) & 1; };

  if (threadIdx.x == 0) {
    for (int n = 0; n < kQBufs; ++n) {
      mbar_init(q_full(n), 1);
      mbar_init(q_empty(n), kConsumerWarps);
    }
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
    // producer: one thread loads each unit's Q, then its K / V tiles
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int j = 0;  // step of the walk: stage j % kStages
      for (int u = blockIdx.x, i = 0; u < p.units; u += gridDim.x, ++i) {
        const Unit w = unit_of(u, p);
        mbar_wait(q_empty(i % kQBufs), q_parity(i) ^ 1);  // the first filling passes
        mbar_expect_tx(q_full(i % kQBufs), L::tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c)
          tma_load(qbuf(i) + c * kBoxBytes, qm, q_full(i % kQBufs), c * kBox, w.h, w.q0, w.b);
        for (int kt = w.t0; kt < w.t1; ++kt, ++j) {
          const int s = j % kStages;
          const uint32_t free_parity = ((j / kStages) & 1) ^ 1;  // the first round passes
          mbar_wait(k_empty(s), free_parity);
          mbar_expect_tx(k_full(s), L::tile);
#pragma unroll
          for (int c = 0; c < L::halves; ++c)
            tma_load(base + L::k + s * L::tile + c * kBoxBytes, km, k_full(s), c * kBox, w.h,
                     kt * kBlockN, w.b);
          mbar_wait(v_empty(s), free_parity);
          mbar_expect_tx(v_full(s), L::tile);
#pragma unroll
          for (int c = 0; c < L::halves; ++c)
            tma_load(base + L::v + s * L::tile + c * kBoxBytes, vm, v_full(s), c * kBox, w.h,
                     kt * kBlockN, w.b);
        }
      }
    }
  } else if (wg == 2 && p.Lq <= 64) {
    // consumer 1 where every unit's rows 64-127 lie past Lq (one query row
    // over long keys): it computes nothing and frees each Q buffer and
    // stage as it fills, so consumer 0 alone holds them
    regs_alloc<240>();
    const bool signals = threadIdx.x % 32 == 0;
    int jg = 0;
    for (int u = blockIdx.x, i = 0; u < p.units; u += gridDim.x, ++i) {
      const Unit w = unit_of(u, p);
      mbar_wait(q_full(i % kQBufs), q_parity(i));
      if (signals) mbar_arrive(q_empty(i % kQBufs));
      for (int kt = w.t0; kt < w.t1; ++kt, ++jg) {
        const int st = jg % kStages;
        const uint32_t parity = (jg / kStages) & 1;
        mbar_wait(k_full(st), parity);
        if (signals) mbar_arrive(k_empty(st));
        mbar_wait(v_full(st), parity);
        if (signals) mbar_arrive(v_empty(st));
      }
    }
  } else {
    // consumers: 64 query rows of each unit each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const bool lead = tid == 0;      // stores O, frees the Q buffer
    const uint32_t rows = cw * 64 * 128;  // this warpgroup's rows of a box

    float s[64];
    float o[kD / 2];
    uint32_t pf[8][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int c = 0; c < kD / 2; ++c) o[c] = 0.f;
    auto valid_of = [&](int kt) { return min(kBlockN, p.Lk - kt * kBlockN); };

    int u = blockIdx.x;  // the current unit, the block's i-th
    int i = 0;
    Unit w = unit_of(u, p);
    int jg = 0;          // step of the walk: stage jg % kStages
    int release = -1;    // the Q buffer whose O store is out, to give back

    // the Q buffer back to the producer, from `lead` for the warpgroup's
    // warps (past the epilogue's barrier, their S products on it are in),
    // once O's store has read it
    auto give_back = [&]() {
      if (release >= 0) {
        if (lead) {
          if constexpr (!kSplit) bulk_wait<0, true>();
          mbar_arrive_n(q_empty(release), kConsumerWarps / 2);
        }
        release = -1;
      }
    };

    mbar_wait(q_full(0), 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_qk<T, kD>(s, qbuf(0) + rows, base + L::k);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    if (signals) mbar_arrive(k_empty(0));
    online_softmax<true, true>(s, m, l, alpha, p.scale, valid_of(w.t0), t);
    pack_frag<T, 8>(pf, s);

    for (;;) {
      // the unit's other key tiles, as flash_fwd_sm90.cuh's loop
      for (int kt = w.t0 + 1; kt < w.t1; ++kt) {
        ++jg;
        const int st = jg % kStages;
        const int sp = (jg - 1) % kStages;
        mbar_wait(k_full(st), (jg / kStages) & 1);
        fence_regs(s);
        fence_regs(o);
        fence_regs(pf);
        wg_fence();
        issue_qk<T, kD>(s, qbuf(i) + rows, base + L::k + st * L::tile);
        wg_commit();
        mbar_wait(v_full(sp), ((jg - 1) / kStages) & 1);
        issue_pv<T, kD>(o, pf, base + L::v + sp * L::tile);
        wg_commit();
        give_back();   // while the products run
        wg_wait<1>();  // S of this tile is in; PV of the last may still run
        fence_regs(s);
        if (signals) mbar_arrive(k_empty(st));
        online_softmax<true, true>(s, m, l, alpha, p.scale, valid_of(kt), t);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(pf);
        if (signals) mbar_arrive(v_empty(sp));
#pragma unroll
        for (int c = 0; c < kD / 2; ++c) o[c] *= alpha[(c >> 1) & 1];
        pack_frag<T, 8>(pf, s);
      }
      // the unit's last PV, the next unit's first S issued before it
      const Unit pw = w;
      const int pi = i;
      const int sp = jg % kStages;
      const uint32_t v_parity = (jg / kStages) & 1;
      float pm[2] = {m[0], m[1]};
      float pl[2] = {l[0], l[1]};
      u += gridDim.x;
      const bool more = u < p.units;
      if (more) {
        ++i;
        ++jg;
        w = unit_of(u, p);
        give_back();  // before the wait: the producer may need it for Q(i)
        mbar_wait(q_full(i % kQBufs), q_parity(i));
        const int st = jg % kStages;
        mbar_wait(k_full(st), (jg / kStages) & 1);
        fence_regs(s);
        fence_regs(o);
        fence_regs(pf);
        wg_fence();
        issue_qk<T, kD>(s, qbuf(i) + rows, base + L::k + st * L::tile);
        wg_commit();
        mbar_wait(v_full(sp), v_parity);
        issue_pv<T, kD>(o, pf, base + L::v + sp * L::tile);
        wg_commit();
        wg_wait<1>();
        fence_regs(s);
        if (signals) mbar_arrive(k_empty(st));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = -INFINITY;
          l[r] = 0.f;
        }
        online_softmax<true, true>(s, m, l, alpha, p.scale, valid_of(w.t0), t);
      } else {
        mbar_wait(v_full(sp), v_parity);
        fence_regs(o);
        fence_regs(pf);
        wg_fence();
        issue_pv<T, kD>(o, pf, base + L::v + sp * L::tile);
        wg_commit();
      }
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      if (signals) mbar_arrive(v_empty(sp));
      sched_epilogue<T, kD, kSplit>(o, pm, pl, pw, qbuf(pi) + rows, om, p, cw, warp, g, t,
                                    lead);
      if (!more) break;
      release = pi % kQBufs;
#pragma unroll
      for (int c = 0; c < kD / 2; ++c) o[c] = 0.f;
      pack_frag<T, 8>(pf, s);
    }
    if constexpr (!kSplit) {
      if (lead) bulk_wait<0, false>();  // the last stores are out
    }
  }
}

// K1 over short keys: the persistent walk, O through a TMA store (`om`,
// 64-row boxes); `scale` holds log2(e).
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_persistent_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                                 const __grid_constant__ CUtensorMap km,
                                 const __grid_constant__ CUtensorMap vm,
                                 const __grid_constant__ CUtensorMap om, const SchedParams p) {
  flash_fwd_sched_body<T, kD, false>(qm, km, vm, om, p);
}

// K1 with the keys split: each split's O (fp32) and lse to the workspace,
// which flash_fwd_merge_kernel folds; `scale` holds log2(e).
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_split_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm, const SchedParams p) {
  // the merge may launch now and wait (its griddepcontrol.wait) on the SMs
  // this grid leaves free
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  flash_fwd_sched_body<T, kD, true>(qm, km, vm, qm, p);
}

// The splits of each row folded in split order (the same bits every call):
// O = sum_z w_z O_z / sum_z w_z with w_z = exp(lse_z - max lse), lse = max
// + log sum_z w_z; a row whose every split has lse = -inf gets O = 0 and lse
// = -inf.  One warp a row of [B, N, Lq]; O through its element strides.
template <typename T>
__global__ void __launch_bounds__(128)
flash_fwd_merge_kernel(const float* __restrict__ part, const float* __restrict__ part_lse,
                       T* __restrict__ o, float* __restrict__ lse, int B, int N, int Lq, int D,
                       int splits, long long ob, long long ol, long long oh) {
  // launched while the split kernel runs (programmatic dependent launch):
  // wait for its grid and its stores
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long rows = (long long)B * N * Lq;
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, part_lse[z * rows + row]);
  const int q = (int)(row % Lq);
  const long long bh = row / Lq;
  T* orow = o + bh / N * ob + bh % N * oh + (long long)q * ol;
  const bool none = mx == -INFINITY;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += none ? 0.f : expf(part_lse[z * rows + row] - mx);
  const float inv = none ? 0.f : 1.f / sum;
  for (int c = 2 * lane; c < D; c += 64) {
    float x = 0.f, y = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float wz = none ? 0.f : expf(part_lse[z * rows + row] - mx);
      const float2 v = *reinterpret_cast<const float2*>(part + (z * rows + row) * D + c);
      x += wz * v.x;
      y += wz * v.y;
    }
    *reinterpret_cast<uint32_t*>(orow + c) = pack2<T>(x * inv, y * inv);
  }
  if (lane == 0) lse[row] = none ? -INFINITY : mx + logf(sum);
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// The dynamic shared memory a kernel may take, opted in once per device
// (`done`: the devices it was for); 0 or a cudaError_t.  The call costs
// microseconds, which a short shape's launch feels.
constexpr int kMaxDevices = 64;
// The devices each kernel was opted in on.  `static`: internal linkage in
// each library of this source.  (In an unnamed namespace, which nvcc names
// after the source file, or as a static in a template function, it was one
// object for every library of this source in the process: flash_compare
// loads a baseline's beside this one, and the second skipped its opt-in.)
template <typename T, int kD, bool kSplit>
static bool smem_ready[kMaxDevices];

template <typename Kernel>
int opt_in_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)err;
}

// K1 under the persistent walk (`splits` == 1) or the key split (`splits`
// > 1, `ws` the fp32 workspace of S * B * N * Lq * (D + 1) floats, then the
// merge) on min(sms, units) blocks.  Returns 0, a cudaError_t or a
// tensor-map code.
template <typename T, int kD>
int launch_sched(const void* q, const void* k, const void* v, void* o, float* lse, float* ws,
                 int splits, int sms, int B, int Lq, int Lk, int N, int D, const FwdStrides& st,
                 float scale, cudaStream_t stream) {
  CUtensorMap m[3], om;
  int rc = encode_qkv<T>(m, q, k, v, B, Lq, Lk, N, D, st);
  if (rc != 0) return rc;
  SchedParams p;
  p.lse = lse;
  p.part = ws;
  p.part_lse = ws == nullptr ? nullptr : ws + (long long)splits * B * N * Lq * D;
  p.B = B;
  p.N = N;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.scale = scale;
  p.qblocks = (Lq + kBlockM - 1) / kBlockM;
  p.nkb = (Lk + kBlockN - 1) / kBlockN;
  p.splits = splits;
  const long long units = (long long)p.qblocks * splits * N * B;
  if (splits < 1 || splits > p.nkb || (splits > 1) != (ws != nullptr) || sms < 1 ||
      units > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  const int grid = (int)(units < sms ? units : sms);
  constexpr int bytes = SchedLayout<kD>::bytes;
  if (splits == 1) {
    rc = encode<T>(&om, o, B, Lq, N, D, st.ob, st.ol, st.oh, 64);
    if (rc == 0)
      rc = opt_in_smem(flash_fwd_persistent_sm90_kernel<T, kD>, bytes,
                       smem_ready<T, kD, false>);
    if (rc != 0) return rc;
    flash_fwd_persistent_sm90_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(m[0], m[1], m[2],
                                                                               om, p);
    return (int)cudaGetLastError();
  }
  rc = opt_in_smem(flash_fwd_split_sm90_kernel<T, kD>, bytes, smem_ready<T, kD, true>);
  if (rc != 0) return rc;
  flash_fwd_split_sm90_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(m[0], m[1], m[2], p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * N * Lq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute early;  // programmatic dependent launch
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_fwd_merge_kernel<T>, (const float*)p.part,
                                 (const float*)p.part_lse, static_cast<T*>(o), lse, B, N, Lq,
                                 D, splits, st.ob, st.ol, st.oh);
}

}  // namespace sm90
}  // namespace mmpl
