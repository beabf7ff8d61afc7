// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` (mmpl_tpu/ops/attention.py:324,
// launched by `_flash_vjp_fwd_impl`): O = softmax(scale * Q K^T) V per
// (batch, head), unmasked, with an online softmax in fp32 (m, l, acc), P
// rounded to the input type before the PV product, O in the input type and
// lse = m + log(l) in fp32 (l == 0 guarded as on the TPU).
//
// Layout: q [B, Lq, N, D], k/v [B, Lk, N, D], o [B, Lq, N, D] read and
// written through element strides (the head dim is contiguous); lse is a
// contiguous [B, N, Lq] fp32 array.  The ragged Lq and Lk edges are masked
// here (zero-filled rows, -inf scores), so the caller pads nothing.  All
// offsets are 64-bit: one K of the 1.3B CFG cache holds 2.16e9 elements.
//
// What bounds it on an H100: operations.  The work is 4*B*N*Lq*Lk*D FLOPs
// (two products) against B*N*(2*Lq + 2*Lk)*D input/output elements; at the
// main path's shapes (Lq, Lk >= 3120, D = 128) that is far above the card's
// ~295 FLOP/byte ridge, so the tensor cores are the limit.  The design keeps
// the tensor cores fed without a round trip through shared memory between
// the two products: each warp owns 16 query rows, holds its Q fragments,
// its scores S, its probabilities P and its output accumulator in registers
// (mma.sync m16n8k16, bf16/fp16 in, fp32 accumulate; the S accumulator
// fragments are re-packed in place as the A operand of PV), and the block
// double-buffers the 64-key K/V tiles with cp.async so the next tile loads
// while the current one is multiplied.  It is the simple version: no wgmma,
// no TMA, no warp specialisation.
//
// One block: 64 query rows of one (b, head), 4 warps.  The head dim is
// padded to the compile-time width kD (64 or 128) with zeros in shared
// memory.  bf16/fp16 take D any multiple of 16 up to 128.  fp32 inputs (the
// smoke configuration) take a plain FMA path through the same template, in
// the same fragment layout: D any multiple of 8 up to 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 128;  // 4 warps

// Shared memory: Q, then K and V in two stages each, then (fp32 only) the
// per-warp P rows that the FMA path reads back.  Row pitches are 16 bytes
// past the data so that ldmatrix rows fall in distinct banks.
template <typename T, int kD>
struct Smem {
  static constexpr bool kFloat = std::is_same<T, float>::value;
  static constexpr int ld = kD + 16 / (int)sizeof(T);
  static constexpr int tile = BQ * ld;  // elements per tile (BQ == BK)
  static constexpr int pld = BK + 4;    // fp32 P row pitch
  static constexpr size_t bytes =
      sizeof(T) * 5 * tile + (kFloat ? sizeof(float) * BQ * pld : 0);
};

struct Strides {
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

// Rows [row0, row0 + 64) of a strided [L, D] slab into a [64, kD] tile;
// rows past `rows` and columns past D are zero-filled.
template <typename T, int kD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long srow, int row0,
                                          int rows, int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = kD / VEC;
  for (int i = threadIdx.x; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i - r * CHUNKS) * VEC;
    const bool valid = row0 + r < rows && c < D;
    const T* g = valid ? src + (long long)(row0 + r) * srow + c : src;
    cp_async16(dst + r * Smem<T, kD>::ld + c, g, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one m16n8k16 tile, fp32 accumulate.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Fragment layout (the m16n8 accumulator of mma.sync): lane = 4*g + t holds,
// for each 8-column tile j, element e of rows g (e = 0, 1) and g + 8
// (e = 2, 3) at columns 8*j + 2*t + (e & 1).  S uses it over 64 keys (8
// tiles), the output accumulator over kD columns (kD/8 tiles).
template <typename T, int kD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int N, int D,
                 Strides st, float scale) {
  using SM = Smem<T, kD>;
  constexpr bool kFloat = SM::kFloat;
  constexpr int LD = SM::ld;
  constexpr int DT = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  auto Ks = [&](int stage) { return Qs + (1 + stage) * SM::tile; };
  auto Vs = [&](int stage) { return Qs + (3 + stage) * SM::tile; };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;

  load_tile<T, kD>(Qs, qg, st.ql, q0, Lq, D);
  load_tile<T, kD>(Ks(0), kg, st.kl, 0, Lk, D);
  load_tile<T, kD>(Vs(0), vg, st.vl, 0, Lk, D);
  cp_async_commit();

  float acc[DT][4] = {};                 // output rows g, g + 8
  float m[2] = {-INFINITY, -INFINITY};   // running row max
  float l[2] = {0.f, 0.f};               // this lane's share of the row sum
  uint32_t qf[kD / 16][4];               // Q as A fragments (16-bit path)

  const int nkb = (Lk + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int stage = kb & 1;
    if (kb + 1 < nkb) {
      load_tile<T, kD>(Ks(stage ^ 1), kg, st.kl, (kb + 1) * BK, Lk, D);
      load_tile<T, kD>(Vs(stage ^ 1), vg, st.vl, (kb + 1) * BK, Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks(stage);
    const T* Vt = Vs(stage);

    // S = Q K^T for this warp's 16 rows (raw fp32 dot products)
    float s[8][4];
    if constexpr (kFloat) {
      const float* qr0 = Qs + (warp * 16 + g) * LD;
      const float* qr1 = qr0 + 8 * LD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kr0 = Kt + (8 * j + 2 * t) * LD;
        const float* kr1 = kr0 + LD;
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        for (int d = 0; d < D; ++d) {
          a00 = fmaf(qr0[d], kr0[d], a00);
          a01 = fmaf(qr0[d], kr1[d], a01);
          a10 = fmaf(qr1[d], kr0[d], a10);
          a11 = fmaf(qr1[d], kr1[d], a11);
        }
        s[j][0] = a00; s[j][1] = a01; s[j][2] = a10; s[j][3] = a11;
      }
    } else {
      const int mi = lane / 8;  // which 8x8 matrix this lane addresses
      const int r = lane % 8;
      if (kb == 0) {
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          ldsm_x4(qf[kk], Qs + (warp * 16 + r + 8 * (mi & 1)) * LD + 16 * kk + 8 * (mi >> 1));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {  // key tiles 2*jp, 2*jp + 1
          uint32_t bk[4];
          ldsm_x4(bk, Kt + (8 * (2 * jp + (mi >> 1)) + r) * LD + 16 * kk + 8 * (mi & 1));
          mma16816<T>(s[2 * jp], qf[kk], bk[0], bk[1]);
          mma16816<T>(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
        }
      }
    }

    // online softmax; each row's 64 scores live in the 4 lanes of a quad
    const int kvalid = Lk - kb * BK;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 8 * j + 2 * t + (e & 1) < kvalid ? s[j][e] * scale : -INFINITY;
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + psum[i];
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      acc[c][0] *= alpha[0]; acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1]; acc[c][3] *= alpha[1];
    }

    // O += P V, P rounded to the input type first
    if constexpr (kFloat) {
      float* Pw = reinterpret_cast<float*>(smem + sizeof(T) * 5 * SM::tile) +
                  warp * 16 * SM::pld;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Pw[(g + 8 * (e >> 1)) * SM::pld + 8 * j + 2 * t + (e & 1)] = s[j][e];
      }
      __syncwarp();
      for (int key = 0; key < BK; ++key) {
        const float p0 = Pw[g * SM::pld + key];
        const float p1 = Pw[(g + 8) * SM::pld + key];
        const float* vr = Vt + key * LD + 2 * t;
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          const float v0 = vr[8 * c], v1 = vr[8 * c + 1];
          acc[c][0] = fmaf(p0, v0, acc[c][0]);
          acc[c][1] = fmaf(p0, v1, acc[c][1]);
          acc[c][2] = fmaf(p1, v0, acc[c][2]);
          acc[c][3] = fmaf(p1, v1, acc[c][3]);
        }
      }
      __syncwarp();
    } else {
      const int mi = lane / 8;
      const int r = lane % 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys: score tiles 2kk, 2kk+1
        const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                                pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                                pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int cp = 0; cp < DT / 2; ++cp) {  // output tiles 2*cp, 2*cp + 1
          uint32_t bv[4];
          ldsm_x4_trans(bv, Vt + (16 * kk + 8 * (mi & 1) + r) * LD + 8 * (2 * cp + (mi >> 1)));
          mma16816<T>(acc[2 * cp], pa, bv[0], bv[1]);
          mma16816<T>(acc[2 * cp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  T* og = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Lq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    T* orow = og + (long long)row * st.ol;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < D) {
        orow[col] = from_f<T>(acc[c][2 * i] / lsafe);
        orow[col + 1] = from_f<T>(acc[c][2 * i + 1] / lsafe);
      }
    }
    if (t == 0) lse[(b * N + h) * (long long)Lq + row] = m[i] + logf(lsafe);
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Lq, int Lk, int N, int D, const Strides& st, float scale,
           cudaStream_t stream) {
  const int bytes = (int)Smem<T, kD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, N, B);
  flash_fwd_kernel<T, kD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Lq, Lk, N, D, st, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int Lq, int Lk, int N, int D, const Strides& st, float scale,
                 cudaStream_t stream) {
  return D <= 64 ? launch<T, 64>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, stream)
                 : launch<T, 128>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mmpl_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse, int B, int Lq,
                              int Lk, int N, int D, long long sqb,
                              long long sql, long long sqh, long long skb,
                              long long skl, long long skh, long long svb,
                              long long svl, long long svh, long long sob,
                              long long sol, long long soh, float scale,
                              void* stream) {
  if (D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
  const Strides st{sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_width<float>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    case 1: return launch_width<__nv_bfloat16>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    case 2: return launch_width<__half>(q, k, v, o, lse, B, Lq, Lk, N, D, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
