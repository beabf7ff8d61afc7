// The body of K3 and K6 (flash_bwd_sm90.cuh): dQ of 128 queries over every
// key tile, or with kMasked over the admitted ones of `mask`, whose `tiles`
// are the 128 x 128 table [ceil(Lq/128), nkt = ceil(Lk/128)].
//
// Included inside the braces of each kernel, which declare `kMasked` (a
// constexpr bool) and `mask` (K3: an empty FrameMask) beside their
// parameters qm, km, vm, dm and p.  It is no function: the same code reached
// through an inlined function gave K3 other SASS at D = 128 (ptxas scheduled
// and allocated registers differently), and K3 keeps the SASS it had as a
// kernel of its own.  No include guard: it is meant to be included twice.
  using L = DqLayout<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // K6: the stages' TileMeta and the frame table's bits (generic pointers)
  unsigned char* const aligned = smem_raw + (base - smem_addr(smem_raw));
  TileMeta* const tmeta = reinterpret_cast<TileMeta*>(aligned + L::meta);
  uint32_t* const fmw = reinterpret_cast<uint32_t*>(aligned + L::fm);
  const uint32_t qd_full = base + L::bar;
  auto full = [&](int s) { return qd_full + 8 * (1 + s); };
  auto empty = [&](int s) { return qd_full + 8 * (1 + kDqStages + s); };

  const int q0 = blockIdx.x * kQueryBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkt = (p.Lk + kKeyTile - 1) / kKeyTile;
  // K6: this query block's row of the 128 x 128 table
  auto trow = [&] { return mask.tiles + (long long)blockIdx.x * mask.nkt; };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      if constexpr (kMasked)
        mbar_init(full(s), 32);  // the producer warp's lanes
      else
        mbar_init(full(s), 1);
      mbar_init(empty(s), kBwdConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kMasked) {
    // the [F, F] table to bits, one word a warp's ballot
    const int words = fm_words(mask.F);
    for (int w = threadIdx.x / 32; w < mask.F * words; w += kBwdThreads / 32) {
      const int f = w / words;
      const int c = (w - f * words) * 32 + threadIdx.x % 32;
      const uint32_t bits = __ballot_sync(0xffffffffu, c < mask.F && mask.fm[f * mask.F + c] != 0);
      if (threadIdx.x % 32 == 0) fmw[w] = bits;
    }
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {
    // producer: one thread issues every load (K6: one warp walks the row)
    regs_dealloc<24>();
    if constexpr (kMasked) {
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        if (lane == 0) {
          mbar_expect_tx(qd_full, 2 * L::tile);
#pragma unroll
          for (int c = 0; c < L::halves; ++c) {
            tma_load(base + L::q + c * L::box, qm, qd_full, c * kBox, h, q0, b);
            tma_load(base + L::d + c * L::box, dm, qd_full, c * kBox, h, q0, b);
          }
        }
        int j = 0;  // step of the walk: stage and slot j % kDqStages
        for (int c0 = 0; c0 < nkt; c0 += 32) {
          const int cls_l = c0 + lane < nkt ? trow()[c0 + lane] : 0;
          for (uint32_t todo = __ballot_sync(0xffffffffu, cls_l != 0); todo; ++j) {
            const int bit = __ffs(todo) - 1;
            todo &= todo - 1;
            const int kt = c0 + bit;
            const int cls = __shfl_sync(0xffffffffu, cls_l, bit);
            const int s = j % kDqStages;
            mbar_wait(empty(s), ((j / kDqStages) & 1) ^ 1);  // the first round passes
            TileMeta& mt = tmeta[s];
#pragma unroll
            for (int i = 0; i < kKeyTile / 32; ++i) {
              const int key = kt * kKeyTile + lane + 32 * i;
              mt.kf[lane + 32 * i] = key < p.Lk ? (unsigned char)mask.kf[key] : 0;
            }
            if (lane == 0) {
              mt.tile = kt;
              mt.cls = cls;
              mbar_expect_tx(full(s), 2 * L::tile);
#pragma unroll
              for (int c = 0; c < L::halves; ++c) {
                tma_load(base + L::k + s * L::tile + c * L::box, km, full(s), c * kBox, h,
                         kt * kKeyTile, b);
                tma_load(base + L::v + s * L::tile + c * L::box, vm, full(s), c * kBox, h,
                         kt * kKeyTile, b);
              }
            } else {
              mbar_arrive(full(s));
            }
          }
        }
      }
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * L::tile);
#pragma unroll
      for (int c = 0; c < L::halves; ++c) {
        tma_load(base + L::q + c * L::box, qm, qd_full, c * kBox, h, q0, b);
        tma_load(base + L::d + c * L::box, dm, qd_full, c * kBox, h, q0, b);
      }
      for (int j = 0; j < nkt; ++j) {
        const int s = j % kDqStages;
        mbar_wait(empty(s), ((j / kDqStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(s), 2 * L::tile);
#pragma unroll
        for (int c = 0; c < L::halves; ++c) {
          tma_load(base + L::k + s * L::tile + c * L::box, km, full(s), c * kBox, h,
                   j * kKeyTile, b);
          tma_load(base + L::v + s * L::tile + c * L::box, vm, full(s), c * kBox, h,
                   j * kKeyTile, b);
        }
      }
    }
  } else {
    // consumers: 64 queries each
    regs_alloc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool signals = lane == 0;
    const uint32_t qa = base + L::q + cw * 64 * kRowBytes;
    const uint32_t da = base + L::d + cw * 64 * kRowBytes;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows row0, row0 + 8
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool in = row < p.Lq;
      const long long at = ((long long)b * p.N + h) * p.Lq + row;
      lse2[r] = in ? p.lse[at] * kLog2e : 0.f;
      // K6, a row that saw no key: +inf, so that p = ex2(s c - inf) = 0
      if constexpr (kMasked) lse2[r] = lse2[r] == -INFINITY ? INFINITY : lse2[r];
      dl[r] = in ? p.delta[at] : 0.f;
    }
    const int last_valid = p.Lk - (nkt - 1) * kKeyTile;

    // the steps of the walk: every key tile, or K6's admitted ones, which
    // each warp counts while Q and dO load
    int n = nkt;
    if constexpr (kMasked) n = count_admitted(trow(), nkt, lane);

    float dq[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
    float sc[64], dp[64];
    uint32_t df[8][4];

    mbar_wait(qd_full, 0);
    for (int j = 0; j < n; ++j) {
      const int s = j % kDqStages;
      const uint32_t ka = base + L::k + s * L::tile;
      const uint32_t va = base + L::v + s * L::tile;
      mbar_wait(full(s), (j / kDqStages) & 1);
      fence_regs(dq);
      wg_fence();
      issue_ss<T, kD, kKeyTile>(sc, qa, L::box, ka, L::box);  // S = Q K^T
      issue_ss<T, kD, kKeyTile>(dp, da, L::box, va, L::box);  // dP = dO V^T
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // element e is query row g + 8 ((e >> 1) & 1), key column c below;
      // keys past Lk (those of the last key tile, by its own index) are
      // masked
      int valid;
      if constexpr (kMasked) {
        // a class-1 tile: the pairs the frame table forbids score -inf
        const TileMeta& mt = tmeta[s];
        forbid_pairs_bits(sc, t, mt, fmw, mask, row0, p.Lq);
        valid = mt.tile == nkt - 1 ? last_valid : kKeyTile;
      } else {
        valid = j == nkt - 1 ? last_valid : kKeyTile;
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int c = 8 * (e / 4) + 2 * t + (e & 1);
        const int r = (e >> 1) & 1;
        p_ds(sc[e], dp[e], lse2[r], dl[r], p.scale_log2, c < valid);
      }
      pack_frag<T, 8>(df, dp);
      fence_regs(df);
      wg_fence();
      issue_rs<T, kD, kKeyTile>(dq, df, ka, L::box);  // dQ += dS K
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      if (signals) mbar_arrive(empty(s));
    }
    // a K6 block with no admitted tile writes dQ = 0
    store_acc<T, kD>(static_cast<T*>(p.out0) + b * p.ab + h * p.ah, p.al, row0, p.Lq, p.D, dq,
                     p.scale);
  }
