// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the fp32 K4 template body's cp.async tile loads with
// zero-filled edges and FMA products, the frame-mask arguments, and the
// packing of two floats to 16 bits that the Hopper bodies use.
//
// Fragment layout of the template body (that of the m16n8 accumulator of
// mma.sync, kept by its FMA products): lane = 4*g + t holds,
// for each 8-column tile j, element e of rows g (e = 0, 1) and g + 8
// (e = 2, 3) at columns 8*j + 2*t + (e & 1).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace mmpl {

constexpr int TILE = 64;      // rows of every Q, K, V, dO tile
constexpr int THREADS = 128;  // 4 warps, 16 rows each

// Row pitch of a [TILE, kD] tile in shared memory: 16 bytes past the data,
// so that consecutive rows start in different banks.
template <typename T, int kD>
struct Pitch {
  static constexpr int ld = kD + 16 / (int)sizeof(T);
  static constexpr int tile = TILE * ld;  // elements per tile
  static constexpr int pld = TILE + 4;    // fp32 P row pitch (FMA path)
};

// Frame mask: token i may attend token j iff fm[qf[i] * F + kf[j]] != 0.
// tiles[qt * nkt + kt] is 0 (no pair allowed: skip), 1 (test each pair) or
// 2 (every pair allowed) for the TILE x TILE tile (qt, kt); the bf16 /
// fp16 Hopper K4-K6 get their coarser tables through the same struct (their
// notes in flash_fwd_sm90.cuh and flash_bwd_sm90.cuh).
struct FrameMask {
  const int* qf;
  const int* kf;
  const unsigned char* fm;
  const unsigned char* tiles;
  int F;
  int nkt;
};

// Element strides of the forward's q, k, v and o (batch, row, head).
struct FwdStrides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `valid == false` writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + TILE) of a strided [L, D] slab into a [TILE, kD] tile;
// rows past `rows` and columns past D are zero-filled.  D is a multiple of
// 16 bytes' worth of elements, so a 16-byte chunk is all data or all pad.
template <typename T, int kD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long srow, int row0,
                                          int rows, int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = kD / VEC;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i - r * CHUNKS) * VEC;
    const bool valid = row0 + r < rows && c < D;
    const T* g = valid ? src + (long long)(row0 + r) * srow + c : src;
    cp_async16(dst + r * Pitch<T, kD>::ld + c, g, valid);
  }
}

// Two floats rounded to T and packed into one register, `lo` in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[16 rows x 64 cols] (8 fragment tiles) = A B^T over D, fp32 FMA:
// A is the warp's 16 rows of `a` (rows a_row0 .. +16 of a [TILE, kD] tile),
// B the 64 rows of `b`.  Both tiles in shared memory, pitch LD.
template <int kD>
__device__ __forceinline__ void fma_abt(float (&acc)[8][4], const float* a, int a_row0,
                                        const float* b, int D) {
  constexpr int LD = Pitch<float, kD>::ld;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float* ar0 = a + (a_row0 + g) * LD;
  const float* ar1 = ar0 + 8 * LD;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* br0 = b + (8 * j + 2 * t) * LD;
    const float* br1 = br0 + LD;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    for (int d = 0; d < D; ++d) {
      a00 = fmaf(ar0[d], br0[d], a00);
      a01 = fmaf(ar0[d], br1[d], a01);
      a10 = fmaf(ar1[d], br0[d], a10);
      a11 = fmaf(ar1[d], br1[d], a11);
    }
    acc[j][0] = a00; acc[j][1] = a01; acc[j][2] = a10; acc[j][3] = a11;
  }
}

// out[16 rows x kD] += P B, fp32 FMA: P is the warp's [16 x 64] fragment
// array, passed through the warp's [16, pld] fp32 scratch `pw` in shared
// memory; B a [TILE, kD] tile in shared memory.
template <int kD>
__device__ __forceinline__ void fma_pb(float (&out)[kD / 8][4], const float (&p)[8][4],
                                       const float* b, float* pw) {
  constexpr int LD = Pitch<float, kD>::ld;
  constexpr int PLD = Pitch<float, kD>::pld;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pw[(g + 8 * (e >> 1)) * PLD + 8 * j + 2 * t + (e & 1)] = p[j][e];
  }
  __syncwarp();
  for (int key = 0; key < TILE; ++key) {
    const float p0 = pw[g * PLD + key];
    const float p1 = pw[(g + 8) * PLD + key];
    const float* br = b + key * LD + 2 * t;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const float v0 = br[8 * c], v1 = br[8 * c + 1];
      out[c][0] = fmaf(p0, v0, out[c][0]);
      out[c][1] = fmaf(p0, v1, out[c][1]);
      out[c][2] = fmaf(p1, v0, out[c][2]);
      out[c][3] = fmaf(p1, v1, out[c][3]);
    }
  }
  __syncwarp();
}

// Write the warp's [16, kD] accumulator, times `mul`, to rows row0, row0 + 8
// of a strided [L, D] slab (rows >= L and columns >= D are dropped).
template <typename T, int kD>
__device__ __forceinline__ void store_rows(T* dst, long long srow, int row0, int L, int D,
                                           const float (&acc)[kD / 8][4], float mul0,
                                           float mul1) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= L) continue;
    const float mul = i ? mul1 : mul0;
    T* orow = dst + (long long)row * srow;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < D) {
        orow[col] = from_f<T>(acc[c][2 * i] * mul);
        orow[col + 1] = from_f<T>(acc[c][2 * i + 1] * mul);
      }
    }
  }
}

// The next key tile at or after `from` that the tile table's `row` admits.
__device__ __forceinline__ int next_tile(const unsigned char* row, int from, int n) {
  while (from < n && row[from] == 0) ++from;
  return from;
}

}  // namespace mmpl
