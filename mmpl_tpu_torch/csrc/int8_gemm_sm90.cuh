// P2, the int8 product, for Hopper (sm_90a) on wgmma s8 and TMA: the body
// behind `mmpl_int8_gemm` (csrc/int8_gemm.cu).
//
// It replaces the TPU probe kernels `_mm_s8_kernel`
// (tools/pallas_int8_mm_probe.py:38, called at :49) and
// `_mm_s8_kloop_kernel` (:61, called at :82), the hand-written Pallas form
// of the s8 x s8 -> s32 dot that `w8a8_matmul` (mmpl_tpu/ops/quant.py:41)
// leaves to XLA.  C[m, n] = sum_k A[m, k] * B[n, k] in int32 (exact), then
// out = (float(acc) * sx[m]) * sw[n] in that order, as fp32 or bf16; or the
// int32 accumulator itself.  A is int8 [M, K] row-major (the per-token
// activation codes), B int8 [N, K] (torch's Linear layout): both K-major,
// the only layout wgmma takes for 8-bit types.
//
// What bounds it on an H100: operations at the DiT's shapes (2*M*N*K
// against M*K + N*K + 2*M*N bytes: ~900 operations a byte at M = 18720,
// K = 1536, N = 8960, above the card's ~590 int8 ridge); bytes at the VAE's
// narrow im2col products (N <= 384), where A is read once.  The design:
//
//  * A tile is 128 rows x BN columns; BN = 256, 128, 64, 32 or 16, chosen
//    on the host from N (ops/quant.py:p2_tile_n).  384 threads in three
//    warpgroups: warpgroup 0 is the producer, whose one thread keeps TMA
//    loads in flight through a ring of 192 KB (4 stages at BN = 256, up to
//    8 at narrow tiles; a stage is 128 bytes of K: a [128, 128] box of A
//    and a [BN, 128] box of B, 128-byte swizzled); warpgroups 1 and 2 own
//    64 rows each and run four
//    wgmma.m64nBNk32.s32.s8.s8 a stage from shared memory (the descriptors
//    step 32 bytes along the swizzled row, as the bf16 k16 steps do), with
//    the s32 accumulator in registers (BN / 2 a thread).  setmaxnreg moves
//    the producer's registers to the consumers (24 / 240 a thread).
//  * Persistent: one block per SM walks the tiles, N fastest, so that the
//    blocks in flight share A's row panels and B stays in L2; the producer
//    runs ahead into the next tile while the consumers store this one, and
//    the stage counters run on across tiles.
//  * The epilogue goes out through TMA stores where an output row is a
//    multiple of 16 bytes and a tile at least 128 bytes wide (every DiT
//    shape): each consumer rounds its 64 rows a 128-byte column chunk at a
//    time into one of two swizzled staging boxes and one thread stores the
//    box, so the stores of one chunk overlap the rounding of the next and
//    the last ones the next tile's products.  Elsewhere (N = 3, odd N,
//    narrow tiles) each thread writes its column pairs from registers.  A
//    warp's register stores reach 8 rows of 16 bytes each; on the H100
//    they took about as long as a tile's products at K = 1536.
//  * The ragged M, N and K edges are zero-filled by TMA loads; rows past M
//    and columns past N are not stored (TMA stores clip them).
//  * No split of K across blocks: every call sums in the same order and
//    gives the same bits.
//
// The codes are mapped as unsigned bytes (cuTensorMapEncodeTiled has no
// signed 8-bit type): TMA moves the bits unchanged.
#pragma once

#include "sm90_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kGemmM = 128;         // rows of a tile
constexpr int kGemmK = 128;         // bytes of K a stage: one swizzled box
constexpr int kGemmThreads = 384;   // producer warpgroup + two consumers
constexpr int kRingBytes = 192 * 1024;
constexpr int kStageOut = 64 * 128;  // a staging box: 64 rows of 128 bytes

// Byte offsets in the 1024-aligned dynamic shared memory: the ring, two
// staging boxes per consumer, the barriers and the tile's sw.
template <int BN>
struct GemmLayout {
  static_assert(BN % 16 == 0 && BN >= 16 && BN <= 256, "BN is a wgmma width");
  static constexpr int a_bytes = kGemmM * kGemmK;   // 16 KB, 1024-aligned
  static constexpr int stage = a_bytes + BN * kGemmK;
  static constexpr int stages = kRingBytes / stage < 8 ? kRingBytes / stage : 8;
  static constexpr int out = stages * stage;
  static constexpr int bar = out + 4 * kStageOut;   // full, then empty, per stage
  static constexpr int scales = bar + 16 * stages;
  static constexpr int bytes = scales + 4 * BN + 1024;  // + alignment slack
  static_assert(bytes <= 232448, "more shared memory than a block may use");
};

// d (+)= A B^T for one k32 step: 64 rows of A and BN rows of B, both
// K-major in shared memory.  scale_d 0 overwrites d.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <typename Out> struct GemmOut;
template <> struct GemmOut<float> {
  static __device__ __forceinline__ float cvt(int acc, float a, float w) {
    return (__int2float_rn(acc) * a) * w;
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};
template <> struct GemmOut<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 cvt(int acc, float a, float w) {
    return __float2bfloat16((__int2float_rn(acc) * a) * w);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 x,
                                                __nv_bfloat16 y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(x, y);
  }
};
template <> struct GemmOut<int> {
  static __device__ __forceinline__ int cvt(int acc, float, float) { return acc; }
  static __device__ __forceinline__ void store2(int* p, int x, int y) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  }
};

// Named barriers of the consumers (bar_sync): 1 both warpgroups, 2 + c
// warpgroup c.

// The staged epilogue of one consumer: its 64 x BN accumulator, 128 bytes
// of columns (kCols) a chunk, rounded into staging box `buf` (flipped per
// chunk) and stored by thread 0 of the warpgroup.  A box row is 128 bytes,
// 128-byte swizzled as the map stores it: the 16-byte unit j of row r sits
// at unit j ^ (r % 8), so a warp's 4- or 8-byte writes spread over the
// banks.
template <int BN, typename Out>
__device__ __forceinline__ void stage_tile(const int (&acc)[BN / 2], const float (&av)[2],
                                           const float* __restrict__ ws, const CUtensorMap& om,
                                           unsigned char* boxes, uint32_t boxes_addr, int& buf,
                                           int row0, int n0, int tid, int bar_id) {
  constexpr int kCols = 128 / (int)sizeof(Out);
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's first row of the 64
  const int t = tid % 4;
#pragma unroll
  for (int chunk = 0; chunk < BN / kCols; ++chunk) {
    if (tid == 0) bulk_wait<1, true>();  // the store that last read this box is done
    bar_sync(bar_id, 128);
    unsigned char* box = boxes + buf * kStageOut;
#pragma unroll
    for (int cc = 0; cc < kCols / 8; ++cc) {
      const int c8 = chunk * (kCols / 8) + cc;  // the tile's 8-column group
      const float w0 = ws != nullptr ? ws[8 * c8 + 2 * t] : 1.f;
      const float w1 = ws != nullptr ? ws[8 * c8 + 2 * t + 1] : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int off = (8 * cc + 2 * t) * (int)sizeof(Out);
        Out* p = reinterpret_cast<Out*>(box + r * 128 + (((off / 16) ^ (r % 8)) * 16) + off % 16);
        GemmOut<Out>::store2(p, GemmOut<Out>::cvt(acc[4 * c8 + 2 * h], av[h], w0),
                             GemmOut<Out>::cvt(acc[4 * c8 + 2 * h + 1], av[h], w1));
      }
    }
    fence_async_smem();
    bar_sync(bar_id, 128);
    if (tid == 0) {
      tma_store(om, boxes_addr + buf * kStageOut, n0 + chunk * kCols, 0, row0, 0);
      bulk_commit();
    }
    buf ^= 1;
  }
}

// One consumer's 64 x BN accumulator into out from registers: element i
// of the fragment is row g + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 t +
// (i & 1).  ws holds the tile's sw in shared memory (null: 1).
template <int BN, typename Out>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2],
                                           const float* __restrict__ sx,
                                           const float* __restrict__ ws, Out* __restrict__ out,
                                           int M, int N, int row0, int n0, int t) {
  const bool pairs = (N % 2) == 0;  // two neighbouring outputs are aligned
  float av[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    av[h] = sx != nullptr && row < M ? sx[row] : 1.f;
  }
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * t;
    if (col >= N) continue;
    const bool two = col + 1 < N;
    const float w0 = ws != nullptr ? ws[8 * c + 2 * t] : 1.f;
    const float w1 = ws != nullptr ? ws[8 * c + 2 * t + 1] : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      Out* o = out + (long long)row * N + col;
      const Out y0 = GemmOut<Out>::cvt(acc[4 * c + 2 * h], av[h], w0);
      if (two) {
        const Out y1 = GemmOut<Out>::cvt(acc[4 * c + 2 * h + 1], av[h], w1);
        if (pairs) {
          GemmOut<Out>::store2(o, y0, y1);
        } else {
          o[0] = y0;
          o[1] = y1;
        }
      } else {
        o[0] = y0;
      }
    }
  }
}

// om: the output's map, used where `staged` (the host's test: rows a
// multiple of 16 bytes, a tile at least 128 bytes wide).
template <int BN, typename Out>
__global__ void __launch_bounds__(kGemmThreads, 1)
int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap am,
                      const __grid_constant__ CUtensorMap bm,
                      const __grid_constant__ CUtensorMap om, const float* __restrict__ sx,
                      const float* __restrict__ sw, Out* __restrict__ out, int M, int N, int K,
                      int staged) {
  using L = GemmLayout<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full0 = base + L::bar;
  auto full = [&](int s) { return full0 + 8 * s; };
  auto empty = [&](int s) { return full0 + 8 * (L::stages + s); };

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + kGemmM - 1) / kGemmM) * n_tiles;
  const int kb = (K + kGemmK - 1) / kGemmK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one thread issues every load
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t free_parity = 1;  // the first round passes
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kGemmM;
        const int n0 = (tile % n_tiles) * BN;
        for (int j = 0; j < kb; ++j) {
          mbar_wait(empty(s), free_parity);
          mbar_expect_tx(full(s), L::stage);
          const uint32_t dst = base + s * L::stage;
          tma_load(dst, am, full(s), j * kGemmK, 0, m0, 0);
          tma_load(dst + L::a_bytes, bm, full(s), j * kGemmK, 0, n0, 0);
          if (++s == L::stages) {
            s = 0;
            free_parity ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: 64 rows each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const bool signals = lane == 0;
    const int row_in_tile = cw * 64 + (tid / 32) * 16 + lane / 4;
    float* ws = reinterpret_cast<float*>(smem + L::scales);
    int buf = 0;  // the staging box the next chunk goes to
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0;
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kGemmM;
      const int n0 = (tile % n_tiles) * BN;
      int prev = 0;
      for (int j = 0; j < kb; ++j) {
        mbar_wait(full(s), parity);
        const uint32_t a = base + s * L::stage + cw * 64 * 128;
        const uint32_t b = base + s * L::stage + L::a_bytes;
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kGemmK / 32; ++kk)
          wgmma_s8<BN>(acc, smem_desc(a + 32 * kk, 16), smem_desc(b + 32 * kk, 16),
                       j > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (j > 0 && signals) mbar_arrive(empty(prev));
        prev = s;
        if (++s == L::stages) {
          s = 0;
          parity ^= 1;
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      if (signals) mbar_arrive(empty(prev));
      // the tile's sw, once both consumers' last epilogue has read it
      bar_sync(1, 256);
      if (sw != nullptr)
        for (int c = threadIdx.x - 128; c < BN; c += 256) ws[c] = n0 + c < N ? sw[n0 + c] : 1.f;
      bar_sync(1, 256);
      const float* w = sw != nullptr ? ws : nullptr;
      if constexpr (BN * sizeof(Out) >= 128) {
        if (staged) {
          float av[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + row_in_tile + 8 * h;
            av[h] = sx != nullptr && row < M ? sx[row] : 1.f;
          }
          const uint32_t off = L::out + cw * 2 * kStageOut;
          stage_tile<BN, Out>(acc, av, w, om, smem + off, base + off, buf, m0 + cw * 64, n0,
                              tid, 2 + cw);
          continue;
        }
      }
      store_tile<BN, Out>(acc, sx, w, out, M, N, m0 + row_in_tile, n0, lane % 4);
    }
    if (tid == 0) bulk_wait<0, false>();  // the last stores are out
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// Returns 0, a cudaError_t or one of sm90_common's codes.
template <int BN, typename Out>
int launch_int8_gemm(const void* a, const void* b, const float* sx, const float* sw, Out* out,
                     int M, int N, int K, cudaStream_t stream) {
  CUtensorMap am, bm, om;
  int rc = encode<int8_t>(&am, a, 1, M, 1, K, 0, K, K, kGemmM);
  if (rc == 0) rc = encode<int8_t>(&bm, b, 1, N, 1, K, 0, K, K, BN);
  const int staged = BN * (int)sizeof(Out) >= 128 && (N * sizeof(Out)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (rc == 0) {
    if (staged)
      rc = encode<Out>(&om, out, 1, M, 1, N, 0, N, N, 64);
    else
      om = bm;  // not read
  }
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((M + kGemmM - 1) / kGemmM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  constexpr int bytes = GemmLayout<BN>::bytes;
  err = cudaFuncSetAttribute(int8_gemm_sm90_kernel<BN, Out>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int8_gemm_sm90_kernel<BN, Out><<<grid, kGemmThreads, bytes, stream>>>(am, bm, om, sx, sw, out,
                                                                         M, N, K, staged);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
