// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the 64 x 64 tile of the frame mask's table, the
// frame-mask and stride arguments, and the packing of two floats to 16
// bits that the Hopper bodies use.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace mmpl {

// Side of a tile of the frame mask's finest table (ops/attention.py TILE):
// the fp32 K4-K6 walk its rows and columns, an entry two 32-row tiles of
// theirs, and P1 without its pad test takes Lk in these units.
constexpr int TILE = 64;

// Frame mask: token i may attend token j iff fm[qf[i] * F + kf[j]] != 0.
// tiles[qt * nkt + kt] is 0 (no pair allowed: skip), 1 (test each pair) or
// 2 (every pair allowed) for the tile (qt, kt) of a table: the TILE x TILE
// one for the fp32 bodies, the coarser ones of the bf16 / fp16 bodies
// (their notes in flash_fwd_sm90.cuh and flash_bwd_sm90.cuh).
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

}  // namespace mmpl
