// Flash-attention forward for Hopper (sm_90a) on wgmma, TMA and warp
// specialisation: the bf16 / fp16 body of K1 and P1 (csrc/flash_fwd.cu).
//
//  * K1 (`flash_fwd_sm90_kernel`) replaces `_flash_fwd_kernel`
//    (mmpl_tpu/ops/attention.py:324): O = softmax(scale * Q K^T) V per
//    (batch, head) and the natural-log lse [B, N, Lq] in fp32.
//  * P1 (`flash_exp2_sm90_kernel`) replaces the exp2 probe's `_fwd_kernel`
//    (tools/exp2_probe.py:42): O only, exp or exp2, with or without the
//    per-element pad test on the last key tile.
//
// What bounds it on an H100: operations (4*B*N*Lq*Lk*D FLOPs against
// B*N*(2*Lq + 2*Lk)*D elements in and out, far above the card's ~295
// FLOP/byte ridge at the main path's shapes), so the design keeps the
// tensor cores busy:
//
//  * Block: 128 query rows of one (b, head), 384 threads in three
//    warpgroups.  Warpgroup 0 is the producer: one thread loads Q once and
//    keeps the 128-key K and V tiles in flight with TMA through a ring of
//    kStages stages, each with a full and an empty mbarrier for K and for
//    V.  Warpgroups 1 and 2 are consumers of 64 query rows each; they issue
//    no loads and meet at no block-wide barrier.  setmaxnreg moves the
//    producer's registers to the consumers (24 / 240 a thread).
//  * Both products on wgmma with fp32 accumulators in registers:
//    S = Q K^T as m64n128k16 with Q and K read from shared memory through
//    128-byte-swizzled descriptors (K-major), and O += P V as m64n{kD}k16
//    with P in registers (the S accumulator rounded to the input type and
//    packed in place: the accumulator's fragment is the A operand's) and V
//    read through the descriptor's transpose bit (V is [keys, D], MN-major
//    for this product), so nothing is transposed in shared memory.
//  * Overlap inside a consumer: tile j+1's S product is issued before tile
//    j's PV product, and the softmax of tile j+1 runs while PV of tile j is
//    on the tensor cores (no ping-pong between the two consumers).
//  * Softmax in fp32 on x = s * scale; exp2 with log2(e) folded into the
//    scale on the host for K1 and P1's exp2 variants, exp for P1's exp
//    variants.  K1's lse is returned natural-log: (m + log2 l) * ln 2.
//  * The ragged edges: TMA zero-fills rows past L and columns past D (the
//    head dim is padded to kD = 64 or 128 that way, and output columns
//    >= D are dropped).  A zero-filled key scores 0, not -inf, so the last
//    key tile, and only it, masks: per element with the pad test, or (P1
//    without it, legal only for Lk a multiple of 64) by dropping the tile's
//    upper 64 keys as a whole when it holds 64.  Rows past Lq are not
//    stored.
//
// Shared memory at kD = 128: Q 32 KB, K and V 2 x 2 x 32 KB, one block per
// SM.  Each 128-column row is two 64-column TMA boxes (128 bytes, the
// swizzle's width), each box 1024-byte aligned.  Operands are read through
// 4-D tensor maps (D, N, L, B) built on the host from the element strides,
// so a q that is a view of the fused qkv projection is read in place.
#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace mmpl {
namespace sm90 {

constexpr int kBlockM = 128;      // query rows of a block
constexpr int kBlockN = 128;      // keys of a K / V tile
constexpr int kStages = 2;        // K / V tiles in flight
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kBox = 64;          // columns of a TMA box: 128 bytes of 16-bit values
constexpr int kBoxBytes = kBlockN * 128;   // one [128 rows, 64 columns] box
constexpr int kConsumerWarps = 8;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockM == kBlockN, "a Q box and a K / V box share kBoxBytes");

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int kD>
struct Layout {
  static constexpr int halves = kD / kBox;
  static constexpr int tile = halves * kBoxBytes;  // a Q, K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + tile;
  static constexpr int v = k + kStages * tile;
  static constexpr int bar = v + kStages * tile;
  // q_full, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int bytes = bar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

struct Params {
  void* o;
  float* lse;
  long long ob, ol, oh;  // o's element strides
  int Lq, Lk, N, D;
  float scale;           // log2(e) folded in for exp2
};

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

// One [128 rows, 64 columns] box of a (D, N, L, B) map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
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
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major (Q, K): 8-row groups 1024 bytes apart (the stride offset), the
// leading offset unused.  MN-major (V): 8-key groups 1024 bytes apart, the
// next 64 columns (the other box) `lead` bytes away.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lead >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
template <bool kExp2>
__device__ __forceinline__ float softmax_exp(float x) {
  return kExp2 ? ex2(x) : expf(x);
}

// d (+)= A B for one k16 step.  SS: A and B K-major in shared memory, N =
// 128.  RS: A in registers (the accumulator fragment layout), B MN-major.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
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

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------

// S = Q K^T for one consumer: its 64 rows of Q (at qa) against a K tile.
template <typename T, int kD>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128<T>(s, smem_desc(qa + off, 16), smem_desc(ka + off, 16), kk > 0);
  }
}

// O += P V over a V tile, 16 keys a step.
template <typename T, int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pf)[8][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_rs<T, kD>(o, pf[kk], smem_desc(va + kk * 16 * 128, kBoxBytes));
}

// Scale the raw scores, mask the last tile's missing keys, update the row
// max m and sum l, and leave the unnormalised probabilities in s.  Element
// i of the accumulator is row g + 8 * ((i >> 1) & 1), column
// 8 * (i / 4) + 2 * t + (i & 1).
template <bool kExp2, bool kPadMask>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale, int valid,
                                               int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] *= scale;
  if (valid < kBlockN) {  // the last tile, ragged
    if (kPadMask) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    } else {  // Lk is a multiple of 64: the tile holds 64 keys
#pragma unroll
      for (int i = 32; i < 64; ++i) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds a key, so m_new is finite; exp(-inf) = 0 on the first
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = softmax_exp<kExp2>(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = softmax_exp<kExp2>(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// P rounded to T and packed as the A operand of 8 k16 steps.
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pf[kk][e] = pack2<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

template <typename T, int kD, bool kExp2, bool kPadMask, bool kLse>
__device__ __forceinline__ void flash_fwd_sm90_body(const CUtensorMap& qm, const CUtensorMap& km,
                                                    const CUtensorMap& vm, const Params& p) {
  static_assert(!kLse || kExp2, "the lse is converted from the exp2 domain");
  using L = Layout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::bar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkb = (p.Lk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
    // producer: one thread issues every load
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::tile);
#pragma unroll
      for (int c = 0; c < L::halves; ++c)
        tma_load(base + L::q + c * kBoxBytes, qm, q_full, c * kBox, h, q0, b);
      for (int j = 0; j < nkb; ++j) {
        const int s = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;  // the first round passes
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c)
          tma_load(base + L::k + s * L::tile + c * kBoxBytes, km, k_full(s), c * kBox, h,
                   j * kBlockN, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c)
          tma_load(base + L::v + s * L::tile + c * kBoxBytes, vm, v_full(s), c * kBox, h,
                   j * kBlockN, b);
      }
    }
  } else {
    // consumers: 64 query rows each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const uint32_t qa = base + L::q + cw * 64 * 128;

    float s[64];
    float o[kD / 2];
    uint32_t pf[8][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    const int last_valid = p.Lk - (nkb - 1) * kBlockN;
    auto valid_of = [&](int j) { return j == nkb - 1 ? last_valid : kBlockN; };

    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_qk<T, kD>(s, qa, base + L::k);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    if (signals) mbar_arrive(k_empty(0));
    online_softmax<kExp2, kPadMask>(s, m, l, alpha, p.scale, valid_of(0), t);
    pack_p<T>(pf, s);

    for (int j = 1; j < nkb; ++j) {
      const int st = j % kStages;
      const int sp = (j - 1) % kStages;
      mbar_wait(k_full(st), (j / kStages) & 1);
      fence_regs(s);
      fence_regs(o);
      fence_regs(pf);
      wg_fence();
      issue_qk<T, kD>(s, qa, base + L::k + st * L::tile);
      wg_commit();
      mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
      issue_pv<T, kD>(o, pf, base + L::v + sp * L::tile);
      wg_commit();
      wg_wait<1>();  // S of tile j is in; PV of tile j-1 may still run
      fence_regs(s);
      if (signals) mbar_arrive(k_empty(st));
      online_softmax<kExp2, kPadMask>(s, m, l, alpha, p.scale, valid_of(j), t);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      if (signals) mbar_arrive(v_empty(sp));
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p<T>(pf, s);
    }
    const int sl = (nkb - 1) % kStages;
    mbar_wait(v_full(sl), ((nkb - 1) / kStages) & 1);
    fence_regs(o);
    fence_regs(pf);
    wg_fence();
    issue_pv<T, kD>(o, pf, base + L::v + sl * L::tile);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);

    T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lsafe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / lsafe;
      const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
      if (row >= p.Lq) continue;
      if (kLse && t == 0)
        p.lse[((long long)b * p.N + h) * p.Lq + row] =
            m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(lsafe)) * kLn2;
      T* orow = og + (long long)row * p.ol;
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack2<T>(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

// K1: O and the natural-log lse; `scale` holds log2(e).
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                      const __grid_constant__ CUtensorMap km,
                      const __grid_constant__ CUtensorMap vm, const Params p) {
  flash_fwd_sm90_body<T, kD, true, true, true>(qm, km, vm, p);
}

// P1: O only; `scale` holds log2(e) when kExp2.
template <typename T, int kD, bool kExp2, bool kPadMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_exp2_sm90_kernel(const __grid_constant__ CUtensorMap qm,
                       const __grid_constant__ CUtensorMap km,
                       const __grid_constant__ CUtensorMap vm, const Params p) {
  flash_fwd_sm90_body<T, kD, kExp2, kPadMask, false>(qm, km, vm, p);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch
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

// [B, L, N, D] through element strides (sb, sl, sh) as the 4-D map (D, N,
// L, B) with a (64, 1, 128, 1) box; a dimension of size 1 is never stepped
// and gets a packed stride.  0 on success.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int B, int L, int N, int D, long long sb,
           long long sl, long long sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)sl * es, (cuuint64_t)sb * es};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = i == 0 ? dims[0] * es : strides[i - 1] * dims[i];
  const cuuint32_t box[4] = {kBox, 1, kBlockN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult rc = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// K1 (kLse) or P1.  Returns 0, a cudaError_t or one of the codes above.
template <typename T, int kD, bool kExp2, bool kPadMask, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Lq,
           int Lk, int N, int D, const FwdStrides& st, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int rc = encode<T>(&qm, q, B, Lq, N, D, st.qb, st.ql, st.qh);
  if (rc == 0) rc = encode<T>(&km, k, B, Lk, N, D, st.kb, st.kl, st.kh);
  if (rc == 0) rc = encode<T>(&vm, v, B, Lk, N, D, st.vb, st.vl, st.vh);
  if (rc != 0) return rc;
  const Params p{o, lse, st.ob, st.ol, st.oh, Lq, Lk, N, D, scale};
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, N, B);
  constexpr int bytes = Layout<kD>::bytes;
  cudaError_t err;
  if constexpr (kLse) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<T, kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_sm90_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(qm, km, vm, p);
  } else {
    err = cudaFuncSetAttribute(flash_exp2_sm90_kernel<T, kD, kExp2, kPadMask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_exp2_sm90_kernel<T, kD, kExp2, kPadMask><<<grid, kThreads, bytes, stream>>>(qm, km, vm,
                                                                                      p);
  }
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace mmpl
