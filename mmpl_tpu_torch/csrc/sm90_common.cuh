// Hopper (sm_90a) building blocks shared by the wgmma + TMA bodies of the
// flash forward (flash_fwd_sm90.cuh: K1, K4, P1), the backward
// (flash_bwd_sm90.cuh: K2, K3, K5, K6) and the int8 product
// (int8_gemm_sm90.cuh: P2): mbarriers, TMA loads, wgmma and its
// shared-memory descriptors, setmaxnreg, the masked walks' TileMeta, and
// the host-side tensor maps.
//
// Every operand tile lands in shared memory as [rows, 64 columns] boxes of
// 16-bit values, 128 bytes a row, 128-byte swizzled, each box 1024-byte
// aligned; a 128-column head dim is two boxes.  One box is read through
// two kinds of descriptor: K-major (the contraction runs along its
// columns: Q and K for S = Q K^T) and MN-major with the transpose bit (the
// contraction runs along its rows: V for O += P V), so no tile is ever
// transposed in shared memory.
//
// wgmma accumulator layout (m64nN, fp32): warp w of the warpgroup owns rows
// 16 w .. 16 w + 15; lane 4 g + t holds element i at row g + 8 ((i >> 1) & 1),
// column 8 (i / 4) + 2 t + (i & 1).  That is also the layout of the A
// operand from registers, so an accumulator rounded to 16 bits and packed
// in pairs (pack_frag) is the next product's A operand as it stands.
#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kBox = 64;  // columns of a TMA box: 128 bytes of 16-bit values
// Frames of the [F, F] table that the masked bodies (K4, K5, K6) keep in
// shared memory (ops/attention.py SM90_MAX_FRAMES)
constexpr int kMaxFrames = 192;
// Dynamic shared memory a block may opt in to on an H100
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// K4 and K6: one admitted 128-key tile of a masked walk, as the producer
// hands it over.
struct TileMeta {
  int tile;               // the key tile (128 keys)
  int cls;                // 1: test each pair, 2: every pair allowed
  unsigned char kf[128];  // its keys' frame ids (0 past Lk)
  unsigned char pad[8];
};
static_assert(sizeof(TileMeta) % 16 == 0, "TileMeta slots stay 16-byte aligned");

// ---------------------------------------------------------------------------
// mbarrier, TMA, wgmma and setmaxnreg
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the completion of the barrier's phase of this parity.  (No
// timeout that traps: an exit path in the loop made ptxas 12.9 hold the
// consumers near 176 registers despite setmaxnreg, spill and serialise
// every wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One [rows, 64 columns] box of a (D, N, L, B) map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// One [rows, 128 bytes] box of shared memory out to a (D, N, L, B) map
// (elements outside the map are not written), in a bulk group of this
// thread; the async proxy must see the box first (fence_async_smem).
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int col,
                                          int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared
// memory (kRead) or are still running at all.
template <int N, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Keep the compiler from moving register reads and writes across the
// asynchronous products that own these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The nonzero bytes among row[0, n), counted by one warp (`lane` its
// lane): the masked bodies' admitted tiles of a coarse-table row.  Four
// loads a lane in flight at once.
__device__ __forceinline__ int count_admitted(const unsigned char* row, int n, int lane) {
  int count = 0;
  for (int c0 = 0; c0 < n; c0 += 128) {
    bool on[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c0 + 32 * u + lane;
      on[u] = i < n && row[i] != 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) count += __popc(__ballot_sync(0xffffffffu, on[u]));
  }
  return count;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major: 8-row groups 1024 bytes apart (the stride offset), the leading
// offset unused.  MN-major: 8-row groups (along the contraction) 1024 bytes
// apart, the next 64 columns (the other box) `lead` bytes away.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lead >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B for one k16 step.  SS: A and B K-major in shared memory, N =
// 128 or 64.  RS: A in registers (the accumulator fragment layout), B
// MN-major.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d);
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d);
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss_n128<__nv_bfloat16>(float (&d)[64], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(float (&d)[32],
                                                    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(float (&d)[64],
                                                    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_n128<__half>(float (&d)[64], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<__half, 64>(float (&d)[32],
                                                    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<__half, 128>(float (&d)[64],
                                                    const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// m64n64k16 with both operands K-major in shared memory (the backward's
// S^T = K Q^T and dP^T = V dO^T over 64-query tiles).
#define MMPL_WGMMA_SS_N64(T, TY)                                                           \
  template <>                                                                              \
  __device__ __forceinline__ void wgmma_ss_n64<T>(float (&d)[32], uint64_t a, uint64_t b,  \
                                                  int scale_d) {                           \
    asm volatile(                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                        \
        "{"                                                                                \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
        "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),    \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),    \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                                         \
        : "l"(a), "l"(b), "r"(scale_d));                                                   \
  }
MMPL_WGMMA_SS_N64(__nv_bfloat16, "bf16")
MMPL_WGMMA_SS_N64(__half, "f16")
#undef MMPL_WGMMA_SS_N64

// d (+)= A B^T over the head dim, k16 steps: A (64 rows at `a`) and B (N
// rows at `b`) K-major, each head dim's second 64 columns `a_box` /
// `b_box` bytes past its first.  The first step overwrites d.
template <typename T, int kD, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a, uint32_t a_box,
                                         uint32_t b, uint32_t b_box) {
  static_assert(N == 64 || N == 128, "wgmma_ss is built for N = 64 and 128");
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = smem_desc(a + (kk / 4) * a_box + col, 16);
    const uint64_t db = smem_desc(b + (kk / 4) * b_box + col, 16);
    if constexpr (N == 128)
      wgmma_ss_n128<T>(d, da, db, kk > 0);
    else
      wgmma_ss_n64<T>(d, da, db, kk > 0);
  }
}

// d += A B over K rows of B, 16 a step: A in registers (K / 16 fragments),
// B MN-major at `b` (its rows are the contraction), its second 64 columns
// `b_box` bytes past its first.
template <typename T, int kD, int K>
__device__ __forceinline__ void issue_rs(float (&d)[kD / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<T, kD>(d, a[kk], smem_desc(b + kk * 16 * 128, b_box));
}

// An accumulator of 8 R columns rounded to T and packed as the A operand of
// R k16 steps.
template <typename T, int R>
__device__ __forceinline__ void pack_frag(uint32_t (&f)[R][4], const float (&s)[8 * R]) {
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[kk][e] = pack2<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

// Error codes besides cudaError_t's: cuTensorMapEncodeTiled is not
// available, or it refused an operand's map
constexpr int kErrNoEncoder = -1;
constexpr int kErrTensorMap = -2;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime loaded, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The map's element type: int8 codes as unsigned bytes (the tensor maps
// have no signed 8-bit type; the bits are moved unchanged).
template <typename T>
constexpr CUtensorMapDataType tensor_map_type() {
  return std::is_same<T, __half>::value     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
         : std::is_same<T, int8_t>::value   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, int>::value      ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// [B, L, N, D] through element strides (sb, sl, sh) as the 4-D map (D, N,
// L, B) with a (128 bytes, 1, rows, 1) box: 64 16-bit values, 128 int8
// codes or 32 32-bit values.  A dimension of size 1 is never stepped and gets a packed stride.
// Rows past L and columns past D load as zeros.  0 on success.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int B, int L, int N, int D, long long sb,
           long long sl, long long sh, int rows = 128) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)sl * es, (cuuint64_t)sb * es};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = i == 0 ? dims[0] * es : strides[i - 1] * dims[i];
  const cuuint32_t box[4] = {128 / (cuuint32_t)es, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = tensor_map_type<T>();
  const CUresult rc = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

}  // namespace sm90
}  // namespace mmpl
