// Flash-attention backward, plain C interface for ctypes: the entries of
// K2 / K3 and of their masked forms K5 / K6, and the fp32 template body.
//
//  * K2, dK and dV: `_flash_bwd_dkv_kernel` (mmpl_tpu/ops/attention.py:373,
//    pallas_call :553).  K3, dQ: `_flash_bwd_dq_kernel` (:417, :578).  In
//    bf16 / fp16 both run the Hopper body of flash_bwd_sm90.cuh: TMA
//    producer, wgmma consumers, warp specialisation, and for dK / dV a split
//    of each key block's query loop over several blocks with a
//    deterministic reduce when the key blocks alone would not fill the card
//    (see that file).  fp32 runs the template below.
//  * K5 / K6, the same under the frame mask: `_masked_bwd_dkv_kernel`
//    (:783, :963) and `_masked_bwd_dq_kernel` (:821, :992).  bf16 / fp16
//    K5 and K6 run the masked instantiations of the Hopper dKV and dQ
//    bodies of flash_bwd_sm90.cuh (K5 over the 64 x 128 coarse table, never
//    split; K6 over the 128 x 128 one); fp32 K5 and K6 run the template
//    below.
//
// What bounds them on an H100: operations.  dKV does four products per
// tile (S, dP, dV, dK: 8*B*N*Lq*Lk*D FLOPs), dQ three (S, dP, dQ: 6*...),
// times the admitted share of tiles when masked; the bytes are
// B*N*(Lq+Lk)*D elements in and out, far below the ridge at the training
// shapes.  So the Hopper body keeps the products on the tensor cores with
// the scores, probabilities and accumulators in registers.  The template
// is fp32 only, the smoke configuration: FMA in the mma.sync m16n8
// fragment layout of flash_common.cuh, no TMA, no warp specialisation.
//
// The template: one block of 4 warps owns 64 keys (dKV) or 64 query rows
// (dQ) of one (b, head) and loops over the admitted tiles of the other
// side, double-buffered with cp.async; per tile it recomputes
// P = exp(scale * Q K^T - lse) from the saved lse, dS = P o (dO V^T -
// delta), and accumulates dV += P^T dO and dK += scale * dS^T Q, or dQ +=
// scale * dS K.  Each block owns its outputs: no atomics, no second pass.
// p is 0 where the mask forbids the pair, past the ragged edges and on
// rows whose lse is -inf (rows that saw no key: the guard of `_masked_p`,
// :771-780).  The mask is read from the per-token frame ids and the
// [F, F] table, and the tile table (0 skip, 1 test pairs, 2 all allowed)
// skips whole tiles, as in flash_fwd.cu.  delta = rowsum(dO o O) comes in
// computed (the plain torch op of mmpl_tpu_torch/ops/attention.py).
//
// Numerics: the Hopper body takes bf16/fp16 operands on the tensor cores
// with fp32 accumulation; p and dS are rounded to the input type before
// their products (dV, and dK / dQ); dP, p before rounding, and every
// accumulator stay fp32.  The TPU kernels run the dO and dS products in
// fp32 (:393, :403-409): a known difference, measured in ROADMAP.md Queue
// 3.  The template computes in fp32 throughout.
//
// Layout: q, do, dq [B, Lq, N, D]; k, v, dk, dv [B, Lk, N, D], all through
// element strides with a contiguous head dim; lse and delta contiguous
// [B, N, Lq] fp32.  64-bit offsets throughout.

#include "flash_common.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace mmpl;

struct Strides {
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;  // q, k, v, dO
  long long ab, al, ah, cb, cl, ch;                          // dK / dQ, dV
};

// Shared memory of the template (fp32): two resident tiles, two streamed
// tiles in two stages, the streamed rows' lse, delta (and frame ids), and
// the per-warp P rows of the FMA products.
template <int kD>
struct BwdSmem {
  static constexpr size_t tiles = sizeof(float) * 6 * Pitch<float, kD>::tile;
  static constexpr size_t rows = 2 * TILE * (2 * sizeof(float) + sizeof(int));
  static constexpr size_t bytes = tiles + rows + sizeof(float) * TILE * Pitch<float, kD>::pld;
};

// dK, dV for 64 keys; streams the admitted query tiles.
template <int kD, bool kMasked>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int N,
                     int D, Strides st, float scale, FrameMask mask) {
  constexpr int TL = Pitch<float, kD>::tile;
  constexpr int DT = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + TL;
  auto Qs = [&](int stage) { return Ks + (2 + stage) * TL; };
  auto Ds = [&](int stage) { return Ks + (4 + stage) * TL; };
  float* lse_s = reinterpret_cast<float*>(smem + BwdSmem<kD>::tiles);  // [2][TILE]
  float* dl_s = lse_s + 2 * TILE;                                     // [2][TILE]
  int* qf_s = reinterpret_cast<int*>(dl_s + 2 * TILE);                // [2][TILE]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  const float* dg = dout + b * st.db + h * st.dh;
  const float* lse_g = lse + (b * N + h) * (long long)Lq;
  const float* dl_g = delta + (b * N + h) * (long long)Lq;
  // this warp's P rows of the FMA products
  float* Pw = reinterpret_cast<float*>(smem + BwdSmem<kD>::tiles + BwdSmem<kD>::rows) +
              warp * 16 * Pitch<float, kD>::pld;

  const int nqb = (Lq + TILE - 1) / TILE;
  // the tile table's column of this key tile, walked down the query tiles
  const unsigned char* tcol = kMasked ? mask.tiles + blockIdx.x : nullptr;
  int kfr[2] = {-1, -1};  // frame ids of this thread's two key rows
  if (kMasked) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + warp * 16 + g + 8 * i;
      kfr[i] = row < Lk ? mask.kf[row] : -1;
    }
  }
  // lse (-inf past Lq), delta and the frame ids of query tile `qb`
  auto load_rows = [&](int stage, int qb) {
    if (threadIdx.x < TILE) {
      const int row = qb * TILE + threadIdx.x;
      const bool in = row < Lq;
      lse_s[stage * TILE + threadIdx.x] = in ? lse_g[row] : -INFINITY;
      dl_s[stage * TILE + threadIdx.x] = in ? dl_g[row] : 0.f;
      if (kMasked) qf_s[stage * TILE + threadIdx.x] = in ? mask.qf[row] : 0;
    }
  };

  int qb = next_tile<kMasked>(tcol, mask.nkt, 0, nqb);
  load_tile<float, kD>(Ks, kg, st.kl, k0, Lk, D);
  load_tile<float, kD>(Vs, vg, st.vl, k0, Lk, D);
  if (qb < nqb) {
    load_tile<float, kD>(Qs(0), qg, st.ql, qb * TILE, Lq, D);
    load_tile<float, kD>(Ds(0), dg, st.dl, qb * TILE, Lq, D);
    load_rows(0, qb);
  }
  cp_async_commit();

  float dk_acc[DT][4] = {};  // key rows g, g + 8
  float dv_acc[DT][4] = {};

  for (int stage = 0; qb < nqb; stage ^= 1) {
    const int nxt = next_tile<kMasked>(tcol, mask.nkt, qb + 1, nqb);
    if (nxt < nqb) {
      load_tile<float, kD>(Qs(stage ^ 1), qg, st.ql, nxt * TILE, Lq, D);
      load_tile<float, kD>(Ds(stage ^ 1), dg, st.dl, nxt * TILE, Lq, D);
      load_rows(stage ^ 1, nxt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs(stage);
    const float* Dt = Ds(stage);
    const float* lse_t = lse_s + stage * TILE;
    const float* dl_t = dl_s + stage * TILE;
    const int* qf_t = qf_s + stage * TILE;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float s[8][4], dp[8][4];
    fma_abt<kD>(s, Ks, warp * 16, Qt, D);
    fma_abt<kD>(dp, Vs, warp * 16, Dt, D);

    const bool test_pairs = kMasked && tcol[(long long)qb * mask.nkt] != 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);  // query within the tile
        const float ls = lse_t[col];
        bool ok = ls != -INFINITY;
        if (test_pairs) {
          const int kf = kfr[e >> 1];
          ok = ok && kf >= 0 && mask.fm[(long long)qf_t[col] * mask.F + kf] != 0;
        }
        const float p = ok ? expf(s[j][e] * scale - ls) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_t[col]);  // dS^T
      }
    }

    // dV += P^T dO, dK += dS^T Q (scale applied at the end)
    fma_pb<kD>(dv_acc, s, Dt, Pw);
    fma_pb<kD>(dk_acc, dp, Qt, Pw);
    __syncthreads();  // every warp is done with this stage before it is refilled
    qb = nxt;
  }
  cp_async_wait<0>();  // the K/V copies when the mask admitted no tile

  const int row0 = k0 + warp * 16 + g;
  store_rows<float, kD>(dk + b * st.ab + h * st.ah, st.al, row0, Lk, D, dk_acc, scale, scale);
  store_rows<float, kD>(dv + b * st.cb + h * st.ch, st.cl, row0, Lk, D, dv_acc, 1.f, 1.f);
}

// dQ for 64 query rows; streams the admitted key tiles.
template <int kD, bool kMasked>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Lq, int Lk, int N, int D, Strides st,
                    float scale, FrameMask mask) {
  constexpr int TL = Pitch<float, kD>::tile;
  constexpr int DT = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ds = Qs + TL;
  auto Ks = [&](int stage) { return Qs + (2 + stage) * TL; };
  auto Vs = [&](int stage) { return Qs + (4 + stage) * TL; };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  const float* dg = dout + b * st.db + h * st.dh;
  // this warp's P rows of the FMA product
  float* Pw = reinterpret_cast<float*>(smem + BwdSmem<kD>::tiles + BwdSmem<kD>::rows) +
              warp * 16 * Pitch<float, kD>::pld;

  const int nkb = (Lk + TILE - 1) / TILE;
  const unsigned char* trow = kMasked ? mask.tiles + (long long)blockIdx.x * mask.nkt : nullptr;
  float ls[2], dl[2];
  const unsigned char* fmrow[2] = {nullptr, nullptr};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const bool in = row < Lq;
    ls[i] = in ? lse[(b * N + h) * (long long)Lq + row] : -INFINITY;
    dl[i] = in ? delta[(b * N + h) * (long long)Lq + row] : 0.f;
    if (kMasked && in) fmrow[i] = mask.fm + (long long)mask.qf[row] * mask.F;
  }

  int kb = next_tile<kMasked>(trow, 1, 0, nkb);
  load_tile<float, kD>(Qs, qg, st.ql, q0, Lq, D);
  load_tile<float, kD>(Ds, dg, st.dl, q0, Lq, D);
  if (kb < nkb) {
    load_tile<float, kD>(Ks(0), kg, st.kl, kb * TILE, Lk, D);
    load_tile<float, kD>(Vs(0), vg, st.vl, kb * TILE, Lk, D);
  }
  cp_async_commit();

  float dq_acc[DT][4] = {};  // query rows g, g + 8

  for (int stage = 0; kb < nkb; stage ^= 1) {
    const int nxt = next_tile<kMasked>(trow, 1, kb + 1, nkb);
    if (nxt < nkb) {
      load_tile<float, kD>(Ks(stage ^ 1), kg, st.kl, nxt * TILE, Lk, D);
      load_tile<float, kD>(Vs(stage ^ 1), vg, st.vl, nxt * TILE, Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks(stage);
    const float* Vt = Vs(stage);

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
    fma_abt<kD>(s, Qs, warp * 16, Kt, D);
    fma_abt<kD>(dp, Ds, warp * 16, Vt, D);

    const int kvalid = Lk - kb * TILE;
    const bool test_pairs = kMasked && trow[kb] != 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);  // key within the tile
        const int i = e >> 1;
        bool ok = col < kvalid && ls[i] != -INFINITY;
        if (test_pairs) ok = ok && fmrow[i] != nullptr && fmrow[i][mask.kf[kb * TILE + col]] != 0;
        const float p = ok ? expf(s[j][e] * scale - ls[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[i]);  // dS
      }
    }

    // dQ += dS K (scale applied at the end)
    fma_pb<kD>(dq_acc, dp, Kt, Pw);
    __syncthreads();
    kb = nxt;
  }
  cp_async_wait<0>();

  store_rows<float, kD>(dq + b * st.ab + h * st.ah, st.al, q0 + warp * 16 + g, Lq, D, dq_acc,
                        scale, scale);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dK, dV (dkv) or dQ (dq)
  int B, Lq, Lk, N, D;
  Strides st;
  float scale;
  FrameMask mask;
};

template <int kD, bool kMasked, bool kDKV>
int launch(const Args& a, cudaStream_t stream) {
  const int bytes = (int)BwdSmem<kD>::bytes;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* dl = static_cast<const float*>(a.delta);
  cudaError_t err;
  if constexpr (kDKV) {
    auto fn = flash_bwd_dkv_kernel<kD, kMasked>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.Lk + TILE - 1) / TILE, a.N, a.B);
    fn<<<grid, THREADS, bytes, stream>>>(q, k, v, d, lse, dl, static_cast<float*>(a.out0),
                                         static_cast<float*>(a.out1), a.Lq, a.Lk, a.N, a.D,
                                         a.st, a.scale, a.mask);
  } else {
    auto fn = flash_bwd_dq_kernel<kD, kMasked>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.Lq + TILE - 1) / TILE, a.N, a.B);
    fn<<<grid, THREADS, bytes, stream>>>(q, k, v, d, lse, dl, static_cast<float*>(a.out0),
                                         a.Lq, a.Lk, a.N, a.D, a.st, a.scale, a.mask);
  }
  return (int)cudaGetLastError();
}

// fp32 on the template; D <= 128 was checked.
template <bool kMasked, bool kDKV>
int launch_f32(const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.D <= 64 ? launch<64, kMasked, kDKV>(a, s) : launch<128, kMasked, kDKV>(a, s);
}

FrameMask make_mask(const void* qf, const void* kf, const void* fm, const void* tiles, int F,
                    int Lk) {
  return FrameMask{static_cast<const int*>(qf), static_cast<const int*>(kf),
                   static_cast<const unsigned char*>(fm),
                   static_cast<const unsigned char*>(tiles), F, (Lk + TILE - 1) / TILE};
}

// bf16 / fp16 K2 or K3 on the Hopper body (K5 or K6 with kMasked,
// `a.mask` holding the coarse table); D <= 128 was checked.
template <typename T, bool kDKV, bool kMasked = false>
int launch_sm90(const Args& a, const long long* strides, void* ws, int splits,
                cudaStream_t stream) {
  const Strides& st = a.st;
  const sm90::BwdParams p{a.out0, a.out1, static_cast<float*>(ws),
                          static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
                          st.ab, st.al, st.ah, st.cb, st.cl, st.ch,
                          a.B, a.Lq, a.Lk, a.N, a.D, splits,
                          a.scale, a.scale * sm90::kLog2e};
  if constexpr (kMasked && kDKV)
    return a.D <= 64
               ? sm90::launch_masked_dkv<T, 64>(a.q, a.k, a.v, a.dout, strides, p, a.mask, stream)
               : sm90::launch_masked_dkv<T, 128>(a.q, a.k, a.v, a.dout, strides, p, a.mask,
                                                 stream);
  else if constexpr (kMasked)
    return a.D <= 64
               ? sm90::launch_masked_dq<T, 64>(a.q, a.k, a.v, a.dout, strides, p, a.mask, stream)
               : sm90::launch_masked_dq<T, 128>(a.q, a.k, a.v, a.dout, strides, p, a.mask,
                                                stream);
  else if constexpr (kDKV)
    return a.D <= 64 ? sm90::launch_dkv<T, 64>(a.q, a.k, a.v, a.dout, strides, p, stream)
                     : sm90::launch_dkv<T, 128>(a.q, a.k, a.v, a.dout, strides, p, stream);
  else
    return a.D <= 64 ? sm90::launch_dq<T, 64>(a.q, a.k, a.v, a.dout, strides, p, stream)
                     : sm90::launch_dq<T, 128>(a.q, a.k, a.v, a.dout, strides, p, stream);
}

// The unmasked entries: fp32 on the template, bf16 / fp16 on the Hopper
// body.  `splits` > 1 (bf16 / fp16 dKV only) needs the fp32 workspace `ws`
// of 2 * splits * B * N * Lk * D values.
template <bool kDKV>
int unmasked(int dtype, const Args& a, const long long* strides, void* ws, int splits,
             void* stream) {
  if (a.D <= 0 || a.D > 128 || a.D % 8 || splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return splits == 1 ? launch_f32<false, kDKV>(a, stream) : (int)cudaErrorInvalidValue;
    case 1:
      return launch_sm90<__nv_bfloat16, kDKV>(a, strides, ws, splits, s);
    case 2:
      return launch_sm90<__half, kDKV>(a, strides, ws, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The masked entries take the frame ids, table and tile table of
// mmpl_flash_masked_fwd (flash_fwd.cu) after the outputs, then `coarse`,
// the table that the bf16 / fp16 Hopper body reads (F up to
// sm90::kMaxFrames): for dKV the table over 64 queries x 128 keys stored
// key-block major ([ceil(Lk/128), ceil(Lq/64)]), for dQ the 128 x 128
// table of the forward ([ceil(Lq/128), ceil(Lk/128)]).  fp32 reads `tiles`.
// The tables' widths are taken from Lq and Lk: the caller checks their
// shapes (`_mask_args`, mmpl_tpu_torch/ops/attention.py).
template <bool kDKV>
int masked(int dtype, Args& a, const void* coarse, const long long* strides, void* stream) {
  if (a.D <= 0 || a.D > 128 || a.D % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32<true, kDKV>(a, stream);
  a.mask.tiles = static_cast<const unsigned char*>(coarse);
  a.mask.nkt = kDKV ? (a.Lq + sm90::kQueryTile - 1) / sm90::kQueryTile
                    : (a.Lk + sm90::kKeyTile - 1) / sm90::kKeyTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_sm90<__nv_bfloat16, kDKV, true>(a, strides, nullptr, 1, s);
    case 2:
      return launch_sm90<__half, kDKV, true>(a, strides, nullptr, 1, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements,
// (batch, row, head) for q, k, v, dO, then the outputs.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// sm90::kErrNoEncoder / kErrTensorMap (< 0) when a tensor map could not be
// built.  `ws` / `splits`: the dKV query split of the Hopper body (ws may
// be null with splits = 1).
extern "C" int mmpl_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, void* ws, int splits, int B, int Lq,
                                  int Lk, int N, int D, const long long* strides, float scale,
                                  void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, N, D, {}, scale, FrameMask{}};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return unmasked<true>(dtype, a, strides, ws, splits, stream);
}

extern "C" int mmpl_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int Lq, int Lk, int N, int D,
                                 const long long* strides, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Lq, Lk, N, D, {}, scale, FrameMask{}};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return unmasked<false>(dtype, a, strides, nullptr, 1, stream);
}

extern "C" int mmpl_flash_masked_bwd_dkv(int dtype, const void* q, const void* k,
                                         const void* v, const void* dout, const void* lse,
                                         const void* delta, void* dk, void* dv,
                                         const void* qf, const void* kf, const void* fm,
                                         const void* tiles, const void* coarse, int F, int B,
                                         int Lq, int Lk, int N, int D,
                                         const long long* strides, float scale,
                                         void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, N, D, {}, scale,
         make_mask(qf, kf, fm, tiles, F, Lk)};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return masked<true>(dtype, a, coarse, strides, stream);
}

extern "C" int mmpl_flash_masked_bwd_dq(int dtype, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        const void* delta, void* dq, const void* qf,
                                        const void* kf, const void* fm, const void* tiles,
                                        const void* coarse, int F, int B, int Lq, int Lk,
                                        int N, int D, const long long* strides, float scale,
                                        void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, B, Lq, Lk, N, D, {}, scale,
         make_mask(qf, kf, fm, tiles, F, Lk)};
  a.st = *reinterpret_cast<const Strides*>(strides);
  return masked<false>(dtype, a, coarse, strides, stream);
}
