// int8 projections for Hopper (sm_90a), plain C interface for ctypes.  Two
// kernels:
//
//  * P2, `int8_gemm_sm90_kernel` (csrc/int8_gemm_sm90.cuh): the int8
//    product C = A B^T in exact int32 with the rescale epilogue, on wgmma
//    s8 and TMA.  It replaces the TPU probe kernels `_mm_s8_kernel` and
//    `_mm_s8_kloop_kernel` (tools/pallas_int8_mm_probe.py:38 and :61); the
//    header says what bounds it and how it is built.
//  * Q, the per-token activation quantisation of quant.py:49-52 (XLA-fused
//    on the TPU): s = max(amax_k |x| / 127, 1e-12), q = clip(rint(x / s),
//    -127, 127), in fp32 with true divisions and round-half-even, so the
//    codes equal the plain version's bit for bit.
//
// What bounds Q: bytes (one read of x, one write of the codes).  So the
// row is read once: `quantize_rows_sm90_kernel` holds it in registers,
// eight elements (one or two 16-byte loads) a slot and up to kSlots slots
// a thread, reduces the amax over a warp (rows of up to 2,048 elements) or
// a block of kRowWarps warps (up to 16,384, amax through shared memory),
// and writes the codes from the registers with 8-byte stores.  The host
// chooses the layout from K (ops/quant.py:q_row_warps).  A longer row
// keeps `quantize_rows_kernel`, one warp a row that reads the row twice
// (the second read from cache).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemm_sm90.cuh"

namespace {

constexpr int kSlots = 8;      // eight-element slots a thread holds
constexpr int kRowWarps = 8;   // warps of a block that owns one row

// Eight consecutive elements of a row, as loaded (16 or 32 bytes).
template <typename T> struct Eight;
template <> struct Eight<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = *reinterpret_cast<const float4*>(p);
    hi = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
};
template <> struct Eight<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax / 127.f, 1e-12f); }

// Eight codes, the lowest address in the low byte.
__device__ __forceinline__ uint2 codes8(const float (&v)[8], float s) {
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = (int)fminf(fmaxf(rintf(v[e] / s), -127.f), 127.f);
    w[e / 4] |= (uint32_t)(uint8_t)(int8_t)c << (8 * (e % 4));
  }
  return make_uint2(w[0], w[1]);
}

// Q in one read.  kWarps = 1: eight rows a block, a warp each; kWarps =
// kRowWarps: one row a block.  Thread i of a row holds slots i, i + T, ...
// (T threads a row), so a warp's loads and stores are contiguous.
template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps == 1 ? 256 : 32 * kWarps)
    quantize_rows_sm90_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                              float* __restrict__ scale, int M, int K) {
  constexpr int kThreads = 32 * kWarps;  // threads of a row
  const int i = kWarps == 1 ? threadIdx.x % 32 : threadIdx.x;
  const long long row =
      kWarps == 1 ? (long long)blockIdx.x * 8 + threadIdx.x / 32 : (long long)blockIdx.x;
  if (row >= M) return;  // whole warps (kWarps = 1); never with one row a block
  const int slots = K / 8;
  const T* xr = x + row * K;
  Eight<T> held[kSlots];
  float amax = 0.f;
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int slot = i + r * kThreads;
    if (slot < slots) {
      held[r].load(xr + 8 * slot);
      float v[8];
      held[r].get(v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if constexpr (kWarps > 1) {
    __shared__ float part[kWarps];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, part[w]);
  }
  const float s = row_scale(amax);
  if (i == 0) scale[row] = s;
  int8_t* qr = q + row * K;
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int slot = i + r * kThreads;
    if (slot < slots) {
      float v[8];
      held[r].get(v);
      *reinterpret_cast<uint2*>(qr + 8 * slot) = codes8(v, s);
    }
  }
}

// Q for rows longer than the one-read layouts hold: one warp a row, the
// amax, then the codes from a second read.
template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                     float* __restrict__ scale, int M, int K) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int k = 8 * lane; k < K; k += 32 * 8) {
    Eight<T> e;
    e.load(xr + k);
    float v[8];
    e.get(v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = row_scale(amax);
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + row * K;
  for (int k = 8 * lane; k < K; k += 32 * 8) {
    Eight<T> e;
    e.load(xr + k);
    float v[8];
    e.get(v);
    *reinterpret_cast<uint2*>(qr + k) = codes8(v, s);
  }
}

template <int BN>
int launch_gemm(int out_dtype, const void* a, const void* b, const float* sx, const float* sw,
                void* out, int M, int N, int K, cudaStream_t s) {
  using mmpl::sm90::launch_int8_gemm;
  switch (out_dtype) {
    case 0:
      return launch_int8_gemm<BN, float>(a, b, sx, sw, static_cast<float*>(out), M, N, K, s);
    case 1:
      return launch_int8_gemm<BN, __nv_bfloat16>(a, b, sx, sw,
                                                 static_cast<__nv_bfloat16*>(out), M, N, K, s);
    default:
      return launch_int8_gemm<BN, int>(a, b, nullptr, nullptr, static_cast<int*>(out), M, N, K,
                                       s);
  }
}

template <typename T>
int launch_quantize(const void* xv, void* qv, void* sv, int M, int K, int warps,
                    cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  int8_t* q = static_cast<int8_t*>(qv);
  float* s = static_cast<float*>(sv);
  switch (warps) {
    case 1:
      quantize_rows_sm90_kernel<T, 1><<<(M + 7) / 8, 256, 0, stream>>>(x, q, s, M, K);
      break;
    case kRowWarps:
      quantize_rows_sm90_kernel<T, kRowWarps><<<M, 32 * kRowWarps, 0, stream>>>(x, q, s, M, K);
      break;
    default:
      quantize_rows_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(x, q, s, M, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// P2.  out_dtype: 0 = float32, 1 = bfloat16, 3 = int32 (the accumulator; sx
// and sw unused).  sx may be null (1); a [M, K] and b [N, K] contiguous int8,
// 16-byte aligned, K a multiple of 16; out contiguous [M, N].  bn: the tile
// width, 256, 128, 64, 32 or 16 (ops/quant.py:p2_tile_n).  Returns 0 once
// launched, else a cudaError_t or a negative tensor-map code.
extern "C" int mmpl_int8_gemm(int out_dtype, const void* a, const void* b, const void* sx,
                              const void* sw, void* out, int M, int N, int K, int bn,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != 1 && out_dtype != 3) return (int)cudaErrorInvalidValue;
  if (out_dtype != 3 && !sw) return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(sx);
  const float* w = static_cast<const float*>(sw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 256: return launch_gemm<256>(out_dtype, a, b, x, w, out, M, N, K, s);
    case 128: return launch_gemm<128>(out_dtype, a, b, x, w, out, M, N, K, s);
    case 64: return launch_gemm<64>(out_dtype, a, b, x, w, out, M, N, K, s);
    case 32: return launch_gemm<32>(out_dtype, a, b, x, w, out, M, N, K, s);
    case 16: return launch_gemm<16>(out_dtype, a, b, x, w, out, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Q.  dtype: 0 = float32, 1 = bfloat16; x [M, K] and q int8 [M, K]
// contiguous and 16-byte aligned, K a multiple of 16; scale fp32 [M].
// warps: the layout (ops/quant.py:q_row_warps): 1 or 8 warps a row read
// once, 0 the two-read loop; a one-read layout must hold the row.
extern "C" int mmpl_quantize_rows(int dtype, const void* x, void* q, void* scale, int M, int K,
                                  int warps, void* stream) {
  if (M <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if (warps != 0 && warps != 1 && warps != kRowWarps) return (int)cudaErrorInvalidValue;
  if (warps > 0 && K / 8 > 32 * warps * kSlots) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_quantize<float>(x, q, scale, M, K, warps, s);
    case 1:
      return launch_quantize<__nv_bfloat16>(x, q, scale, M, K, warps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
