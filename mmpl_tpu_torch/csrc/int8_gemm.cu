// int8 projections for Hopper (sm_90a), plain C interface for ctypes.  Two
// kernels:
//
//  * P2, `int8_gemm_kernel`.  Replaces the TPU probe kernels `_mm_s8_kernel`
//    (tools/pallas_int8_mm_probe.py:38, called at :49) and
//    `_mm_s8_kloop_kernel` (:61, called at :82), the hand-written Pallas form
//    of the s8 x s8 -> s32 dot that `w8a8_matmul` (mmpl_tpu/ops/quant.py:41)
//    leaves to XLA.  C[m, n] = sum_k A[m, k] * B[n, k] in int32 (exact), then
//    the epilogue out = (float(acc) * sx[m]) * sw[n] in that order, written as
//    fp32 or bf16; or the int32 accumulator itself.  A is int8 [M, K]
//    row-major (the per-token activation codes), B int8 [N, K] K-contiguous
//    (torch's Linear layout: the col-major B operand of mma.sync, so neither
//    operand needs a transpose).
//  * Q, `quantize_rows_kernel`.  The per-token activation quantisation of
//    quant.py:49-52 (XLA-fused on the TPU): s = max(amax_k |x| / 127, 1e-12),
//    q = clip(rint(x / s), -127, 127), in fp32 with true divisions and
//    round-half-even, so the codes equal the plain version's bit for bit.
//
// What bounds P2 on an H100: operations at the main path's shapes.  The work
// is 2*M*N*K int8 operations against M*K + N*K input bytes and M*N outputs;
// at M = 18720, K = 1536, N = 8960 that is ~2,700 operations per byte,
// far above the card's ~590 int8 operations per byte ridge (1,979 TOPS over
// 3.35 TB/s).  The design is the simple one: a 128 x 128 block tile, 8 warps
// each owning 64 x 32 of it with its int32 accumulators in registers
// (mma.sync m16n8k32 s8.s8.s32, operands through ldmatrix), 64-byte K steps
// double-buffered with cp.async, the ragged M, N and K edges zero-filled by
// cp.async's src-size operand.  No wgmma, no TMA: mma.sync reaches only part
// of Hopper's int8 rate, which is later work.  K must be a multiple of 16
// (a 16-byte chunk is then all data or all padding).
//
// What bounds Q: bytes (one read of x, one write of the codes; the row is
// read a second time from cache).  One warp owns one row and loads 16 bytes
// per lane per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BM = 128;          // block rows (M)
constexpr int BN = 128;          // block columns (N)
constexpr int BK = 64;           // bytes of K per pipeline stage
constexpr int GEMM_THREADS = 256;
constexpr int LDS = BK + 16;     // shared-memory row pitch: ldmatrix rows in distinct banks
constexpr int STAGE = (BM + BN) * LDS;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 128) and bytes [k0, k0 + BK) of a row-major [R, K] int8
// matrix into a [128, LDS] tile; rows past R and bytes past K read as zero.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int row0, int R,
                                          int k0, int K) {
  constexpr int CHUNKS = BK / 16;
  for (int i = threadIdx.x; i < 128 * CHUNKS; i += GEMM_THREADS) {
    const int r = i / CHUNKS;
    const int c = (i - r * CHUNKS) * 16;
    const bool valid = row0 + r < R && k0 + c < K;
    const int8_t* g = valid ? src + (long long)(row0 + r) * K + k0 + c : src;
    mmpl::cp_async16(dst + r * LDS + c, g, valid);
  }
}

template <typename Out> struct Epilogue;
template <> struct Epilogue<float> {
  static __device__ __forceinline__ float cvt(int acc, float a, float w) {
    return (__int2float_rn(acc) * a) * w;
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};
template <> struct Epilogue<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 cvt(int acc, float a, float w) {
    return __float2bfloat16((__int2float_rn(acc) * a) * w);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 x,
                                                __nv_bfloat16 y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(x, y);
  }
};
template <> struct Epilogue<int> {
  static __device__ __forceinline__ int cvt(int acc, float, float) { return acc; }
  static __device__ __forceinline__ void store2(int* p, int x, int y) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  }
};

// One block: output rows [128 * blockIdx.x, +128), columns [128 * blockIdx.y,
// +128).  Warp w owns rows 64 * (w / 4) and columns 32 * (w % 4) of the tile:
// 4 x 4 m16n8 accumulator tiles.
template <typename Out>
__global__ void __launch_bounds__(GEMM_THREADS)
    int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     Out* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) int8_t smem[2 * STAGE];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = 64 * (warp / 4);
  const int wn = 32 * (warp % 4);
  const int mi = lane / 8;   // which 8x8 matrix this lane addresses for ldmatrix
  const int r = lane % 8;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int steps = (K + BK - 1) / BK;
  load_tile(smem, a, m0, M, 0, K);
  load_tile(smem + BM * LDS, b, n0, N, 0, K);
  mmpl::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    int8_t* cur = smem + (s & 1) * STAGE;
    if (s + 1 < steps) {  // the next step into the other buffer, read last at s - 1
      int8_t* nxt = smem + ((s + 1) & 1) * STAGE;
      load_tile(nxt, a, m0, M, (s + 1) * BK, K);
      load_tile(nxt + BM * LDS, b, n0, N, (s + 1) * BK, K);
    }
    mmpl::cp_async_commit();
    mmpl::cp_async_wait<1>();
    __syncthreads();
    const int8_t* sa = cur;
    const int8_t* sb = cur + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mmpl::ldsm_x4(af[i], sa + (wm + 16 * i + r + 8 * (mi & 1)) * LDS + 32 * kk + 16 * (mi >> 1));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // n8 tiles 2*jp, 2*jp + 1
        uint32_t bf[4];
        mmpl::ldsm_x4(bf, sb + (wn + 8 * (2 * jp + (mi >> 1)) + r) * LDS + 32 * kk + 16 * (mi & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_s8(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_s8(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled at step s + 1
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const bool pairs = (N % 2) == 0;  // two neighbouring outputs are 8-byte aligned
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + g + 8 * h;
      if (row >= M) continue;
      const float av = sx ? sx[row] : 1.f;
      Out* orow = out + (long long)row * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        if (col >= N) continue;
        const float w0 = sw ? sw[col] : 1.f;
        const Out y0 = Epilogue<Out>::cvt(acc[i][j][2 * h], av, w0);
        if (col + 1 < N) {
          const Out y1 = Epilogue<Out>::cvt(acc[i][j][2 * h + 1], av, sw ? sw[col + 1] : 1.f);
          if (pairs) {
            Epilogue<Out>::store2(orow + col, y0, y1);
          } else {
            orow[col] = y0;
            orow[col + 1] = y1;
          }
        } else {
          orow[col] = y0;
        }
      }
    }
  }
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// One warp per row of a contiguous x [M, K] (K a multiple of 16): the
// row's amax, then its codes and scale.
template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                     float* __restrict__ scale, int M, int K) {
  constexpr int V = Vec<T>::n;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int k = V * lane; k < K; k += 32 * V) {
    float v[V];
    Vec<T>::load(xr + k, v);
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax / 127.f, 1e-12f);
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + row * K;
  for (int k = V * lane; k < K; k += 32 * V) {
    float v[V];
    Vec<T>::load(xr + k, v);
    uint32_t w[V / 4];  // the codes, four to a word, lowest address in the low byte
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (int)fminf(fmaxf(rintf(v[4 * i + e] / s), -127.f), 127.f);
        w[i] |= (uint32_t)(uint8_t)(int8_t)c << (8 * e);
      }
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(qr + k) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr + k) = w[0];
    }
  }
}

template <typename Out>
int launch_gemm(const void* a, const void* b, const void* sx, const void* sw, void* out, int M,
                int N, int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_gemm_kernel<Out><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<Out*>(out), M, N,
      K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, int M, int K, cudaStream_t stream) {
  constexpr int ROWS = 8;  // warps per block
  quantize_rows_kernel<T><<<(M + ROWS - 1) / ROWS, 32 * ROWS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), M, K);
  return (int)cudaGetLastError();
}

}  // namespace

// P2.  out_dtype: 0 = float32, 1 = bfloat16, 3 = int32 (the accumulator; sx
// and sw unused).  sx may be null (1); a [M, K] and b [N, K] contiguous int8,
// 16-byte aligned, K a multiple of 16; out contiguous [M, N].  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mmpl_int8_gemm(int out_dtype, const void* a, const void* b, const void* sx,
                              const void* sw, void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if ((N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      if (!sw) return (int)cudaErrorInvalidValue;
      return launch_gemm<float>(a, b, sx, sw, out, M, N, K, s);
    case 1:
      if (!sw) return (int)cudaErrorInvalidValue;
      return launch_gemm<__nv_bfloat16>(a, b, sx, sw, out, M, N, K, s);
    case 3:
      return launch_gemm<int>(a, b, nullptr, nullptr, out, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Q.  dtype: 0 = float32, 1 = bfloat16; x [M, K] and q int8 [M, K]
// contiguous and 16-byte aligned, K a multiple of 16; scale fp32 [M].
extern "C" int mmpl_quantize_rows(int dtype, const void* x, void* q, void* scale, int M, int K,
                                  void* stream) {
  if (M <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_quantize<float>(x, q, scale, M, K, s);
    case 1:
      return launch_quantize<__nv_bfloat16>(x, q, scale, M, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
