// K3 at head dim 256 in K2's layout: the `dq256_64_rows` variant of
// tools/torch_split_variants.py --family d256, which inserts this text into
// a copy of csrc/flash_dq_sm90.cuh (before make_dq_maps) and launches it
// in place of `dq256_tile`, with 64-row CTAs and 64-key tiles.  It is not
// part of the package's build.
//
// One CTA of the two consumer warpgroups per 64 query rows.  Per 64-key
// tile each warpgroup computes S^T = K q'^T and dP^T = V dO^T for the
// tile's 64 keys against its own 32 query rows (m64n32k16 over 16 k16
// slices of the head dim, as K2's `dkdv256_tile`), forms p and dS in f32
// registers, and stores dS^T, rounded to 16 bits, as its panel of a
// 64-key x 64-query buffer (two buffers, alternate tiles).  After one
// named barrier each warpgroup adds dQ[64 rows, its 128 columns] += dS K
// with both operands from shared memory, MN-major (`Wgmma<128, T>::ss_t`,
// which the variant adds to its copy of wgmma_sm90.cuh).  6 d FLOP a
// causal pair; 8 KB stored and one barrier a key tile.  Shared memory: q'
// + dO + 2 (K, V) stages + 2 dS^T buffers, 64 + 128 + 16 KB.

// Layout: q' and dO of the CTA's 64 query rows, 2 (K, V) stages of 64
// keys, and two dS^T buffers, each 64 key rows x 64 query columns as two
// panels of 32 query columns (panel c written by consumer warpgroup c).
struct Dq256Rows64Smem {
  static constexpr int D = 256, STAGES = 2;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t Q_PANEL = 64 * PANEL * 2;   // 4 KB
  static constexpr uint32_t KV_PANEL = 64 * PANEL * 2;  // 4 KB
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t KV_BYTES = PANELS * KV_PANEL;
  static constexpr uint32_t DS_PANEL = 64 * PANEL * 2;
  static constexpr uint32_t DS_BYTES = (64 / PANEL) * DS_PANEL;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + Q_BYTES;
  static constexpr uint32_t k = dout + Q_BYTES;
  static constexpr uint32_t v = k + STAGES * KV_BYTES;
  static constexpr uint32_t ds = v + STAGES * KV_BYTES;  // dS^T x 2
  static constexpr uint32_t bars = ds + 2 * DS_BYTES;
  // qdo_full, then k_full, v_full, k_empty, v_empty [STAGES] each
  static constexpr uint32_t N_BARS = 1 + 4 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// One CTA of 256 threads computes dq of query rows [q0, q0 + 64) of head
// `bh`; the arguments are dq256_tile's.
template <typename T>
__device__ __forceinline__ void dq256_rows64_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int bh, int q0,
    int sq, int sk, float scale_r, float dq_scale, int causal) {
  using L = Dq256Rows64Smem;
  constexpr int D = L::D, STAGES = L::STAGES, KEYS = 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base + L::q, do_s = base + L::dout;
  const uint32_t k_s = base + L::k, v_s = base + L::v;
  const uint32_t qdo_full = base + L::bars;
  const uint32_t k_full = qdo_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  // Key tiles with a key some row of the CTA sees: under a causal mask,
  // up to the one that holds row q0 + 63 (rows and key tiles are both 64
  // long, so both warpgroups see every one of them).
  static_assert(KEYS == 64, "a causal CTA ends at its diagonal tile");
  int n_kt = (sk + KEYS - 1) / KEYS;
  if (causal) n_kt = min(n_kt, q0 / KEYS + 1);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warpgroup c computes S^T and dP^T for query rows [32 c, 32 c + 32) of
  // the CTA and owns columns [128 c, 128 c + 128) of dQ, all 64 rows.
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8: the second key/row
  const int cq = 2 * (lane % 4);                // + 8 i + j: the column
  const int qh = 32 * c;                        // query rows of S^T
  const float scale_log2 = scale_r * LOG2E;

  // Thread 0 loads tile kt's K (V) into its stage once both warpgroups
  // have released the stage's previous tile; called where none of its
  // warpgroup's products is in flight.
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t full,
                  uint32_t empty, int kt) {
    if (threadIdx.x == 0 && kt < n_kt) {
      const int st = kt % STAGES;
      if (kt >= STAGES) mbar_wait(empty + 8 * st, (kt / STAGES - 1) & 1);
      mbar_expect_tx(full + 8 * st, L::KV_BYTES);
      tma_tile<D>(dst + st * L::KV_BYTES, map, full + 8 * st, KEYS,
                  kt * KEYS, bh);
    }
  };
  if (threadIdx.x == 0 && n_kt > 0) {
    mbar_expect_tx(qdo_full, 2 * L::Q_BYTES);
    tma_tile<D>(q_s, mq, qdo_full, 64, q0, bh);
    tma_tile<D>(do_s, mdo, qdo_full, 64, q0, bh);
  }
  for (int kt = 0; kt < STAGES; ++kt) {
    load(v_s, mv, v_full, v_empty, kt);
    load(k_s, mk, k_full, k_empty, kt);
  }

  // lse in log2 units and delta of this thread's 8 query rows qh + 8 i +
  // cq + j (POS_BIG and 0 past sq: p and dS are exactly 0 there).
  float lse2[4][2], dl[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + qh + 8 * i + cq + j;
      const size_t at = (size_t)bh * sq + row;
      lse2[i][j] = (row < sq ? lse[at] : POS_BIG) * LOG2E;
      dl[i][j] = row < sq ? delta[at] : 0.f;
    }

  float dq_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

  // dS in place of dP^T (p no longer needed): rows are the tile's keys
  // r_lo (h = 0) and r_lo + 8, columns this warpgroup's query rows qh +
  // 8 i + cq + j.  The mask is compiled in only for tiles that straddle
  // the diagonal or the ragged key tail.
  auto dscores = [&](float (&s)[16], float (&dp)[16], int k0, auto masked) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qr = q0 + qh + 8 * i + cq + j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * i + 2 * h + j;
          const float pe = ex2(fmaf(s[e], scale_log2, -lse2[i][j]));
          const int kr = k0 + r_lo + 8 * h;
          const bool off = decltype(masked)::value &&
                           (kr >= sk || (causal && kr > qr));
          dp[e] = off ? 0.f : pe * (dp[e] - dl[i][j]) * scale_r;
        }
      }
  };
  using Plain = std::integral_constant<bool, false>;
  using Masked = std::integral_constant<bool, true>;
  // Every consumer warp releases a stage after its own wgmma wait.
  auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };

  if (n_kt > 0) mbar_wait(qdo_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES, ph = (kt / STAGES) & 1;
    const int k0 = kt * KEYS;
    const uint32_t kt_s = k_s + st * L::KV_BYTES;
    const uint32_t vt_s = v_s + st * L::KV_BYTES;
    const uint32_t ds_off = L::ds + (kt % 2) * L::DS_BYTES;
    mbar_wait(k_full + 8 * st, ph);
    mbar_wait(v_full + 8 * st, ph);

    // S^T = K q'^T and dP^T = V dO^T, M = the tile's 64 keys, N = this
    // warpgroup's 32 query rows, over the 16 k16 slices of the head dim.
    float s[16], dp[16];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
      const uint32_t kp = (kk / 2) * L::KV_PANEL + off;
      const uint32_t qp = (kk / 2) * L::Q_PANEL + qh * 64 + off;
      Wgmma<32, T>::ss(s, desc(kt_s + kp, 16, 512), desc(q_s + qp, 16, 512),
                       kk > 0);
      Wgmma<32, T>::ss(dp, desc(vt_s + kp, 16, 512),
                       desc(do_s + qp, 16, 512), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    release(v_empty + 8 * st);
    load(v_s, mv, v_full, v_empty, kt + STAGES);

    if (k0 + KEYS > sk || (causal && k0 + KEYS - 1 > q0 + qh))
      dscores(s, dp, k0, Masked{});
    else
      dscores(s, dp, k0, Plain{});

    // dS^T, 16 bits, into this warpgroup's panel of the tile's buffer:
    // key row kr, 16-byte chunk i, swizzled as TMA would have written it.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = r_lo + 8 * h;
        const uint32_t at = ds_off + c * L::DS_PANEL + kr * 64 +
                            ((i ^ ((kr >> 1) & 3)) << 4) + cq * 2;
        *reinterpret_cast<uint32_t*>(gbase + at) =
            pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);
      }
    fence_async_shared();
    bar_sync(1, 256);  // both halves in place

    // dQ[:, 128 c + ...] += dS K: K = the tile's 64 keys, A = dS^T from
    // the buffer and B = K as it arrived, both MN-major.
    pin(dq_acc);
    wg_fence();
#pragma unroll
    for (int jk = 0; jk < KEYS / 16; ++jk)
      Wgmma<128, T>::ss_t(
          dq_acc, desc(base + ds_off + jk * 16 * 64, L::DS_PANEL, 512),
          desc(kt_s + 4 * c * L::KV_PANEL + jk * 16 * 64, L::KV_PANEL, 512),
          1);
    wg_commit();
    wg_wait<0>();
    pin(dq_acc);
    release(k_empty + 8 * st);
    load(k_s, mk, k_full, k_empty, kt + STAGES);
  }

  // dq = dQ * dq_scale in f32, cast, stored straight from registers: rows
  // r_lo (h = 0) and r_lo + 8, this warpgroup's 128 columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r_lo + 8 * h;
    if (row >= sq) continue;
    T* dst = dq + ((size_t)bh * sq + row) * D + 128 * c + cq;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = 4 * i + 2 * h;
      *reinterpret_cast<uint32_t*>(dst + 8 * i) =
          pack2<T>(dq_acc[e] * dq_scale, dq_acc[e + 1] * dq_scale);
    }
  }
}
