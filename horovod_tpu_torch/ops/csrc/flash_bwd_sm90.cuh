// The flash-attention backward body of K5 (ring_flash.cu,
// hvdt_ring_flash_bwd, a ring step's offsets), for Hopper (sm_90a); with
// WITH_DQ off it is also K2 (flash_bwd_split.cu, hvdt_flash_bwd_dkdv), the
// dK/dV half of the split backward, which replaces
// `_flash_bwd_dkdv_kernel` (horovod_tpu/ops/attention.py:429).  B2
// (flash_bwd.cu, the main path's backward) ran this body at zero offsets
// until it took its own, flash_b2_sm90.cuh, whose math is this one's.
//
// Replaces the Pallas TPU kernel `_combined_bwd_kernel`
// (horovod_tpu/ops/attention.py:498, math in `_bwd_block_math` :386) with
// rotate=True (B5; the copy blocks of the rotation are ring_flash.cu's):
// one recompute of P and dP per (query tile, key tile) pair feeds dK, dV
// and dQ.  Per pair, with the query rows at
// absolute position q_off + q0 and the keys at k_off + k0:
//   s  = q' k^T * scale_r, masked to NEG_INF (p exactly 0 there);
//   p  = exp(s - lse), exactly 0 on POS_BIG rows (no mass);
//   dp = dO v^T;
//   dS = p (dp - delta) scale_r;
// p and dS rounded to the storage dtype before the products that take
// them; dV = sum P^T dO, dK = sum dS^T q', dQ = sum dS k.  q' is q
// pre-scaled by the power-of-two part of sm_scale, so dK is exact in q'
// units and dQ comes out in q' units (the ring rescales its running total
// once).  delta = rowsum(dO * o) is
// the caller's, as the reference computes it outside Pallas.
//
// Bound on the card.  K5 on a wholly visible ring step (bh 32, 1024 x
// 1024, head dim 64, bf16): 21.5 GFLOP (five products, 10 d FLOP per
// pair), so 0.0217 ms of tensor-core time at 989 TFLOP/s.
// Bound by the tensor cores, so the design keeps them fed and keeps every
// intermediate but dS out of shared memory:
//
// * 16-bit inputs: one CTA of three warpgroups per 128-key tile, heavy
//   (early, under a causal mask) key tiles first in the grid.  Warpgroup 0
//   is the producer: one thread TMA-loads the K and V tiles once (3-D
//   tensor maps (D, s, bh), so a ragged tile zero-fills inside its head)
//   and streams the (q', dO) tiles of 64 query rows through a ring of
//   BWD_STAGES stages with full/empty mbarrier pairs; one warp copies each
//   tile's lse and delta rows beside them (POS_BIG and 0 past the end, so
//   any length works without padding).  It then gives its registers away
//   (setmaxnreg).  Warpgroups 1 and 2 each own 64 keys and keep dK and dV
//   in f32 registers for the whole loop.  Per query tile, S^T = K q'^T and
//   dP^T = V dO^T by wgmma from shared memory (M = keys), so P^T and dS^T
//   land in registers as the A operands of dV += P^T dO and dK += dS^T q'
//   (dO and q' read MN-major, as they arrived).  dQ = dS K needs dS from
//   shared memory: each warpgroup stores its dS^T (key rows by query
//   columns, the 64-byte swizzle of the TMA tiles) into one of two
//   buffers, the consumers meet at a named barrier, and wgmma reads dS^T
//   and K both MN-major.  The dQ product is split between the warpgroups
//   by head-dim columns at D 64 and 128 (D / 2 columns over all 128 keys
//   each) and by keys at D 32 and 96 (each its own 64 keys, all columns:
//   a 16- or 48-column half would start inside a swizzle panel).  Each
//   warpgroup writes its f32 dQ tile into shared memory (128-byte
//   swizzle) and one thread adds it to the caller's buffer with a TMA
//   reduce (`cp.reduce.async.bulk.tensor`), so the adds leave the SM's
//   load/store path: ceil(s / 128) adds per element (twice that at D
//   32/96), in an order that changes from run to run.  The mask is
//   compiled into a second copy of the elementwise step that only the
//   tiles straddling the diagonal or the ragged key tail take; no product
//   is in flight across a branch.  Registers, not shared memory, hold the
//   SM to one CTA; shared memory per CTA, (K, V) + 2 stages of (q', dO) +
//   2 dS^T buffers + 2 dQ tiles: D 32: 16 + 16 + 32 + 16 KB; D 64: 32 +
//   32 + 32 + 16 KB; D 96: 48 + 48 + 32 + 48 KB; D 128: 64 + 64 + 32 + 32
//   KB.  K2 (WITH_DQ off) compiles out the dS^T stores, their named
//   barrier, the dQ product and its adds: no dQ buffers and no fifth
//   tensor map, and DKDV_STAGES (q', dO) stages in their place, so dK and
//   dV are its only outputs, stored from registers in the input dtype.
// * Head dim 256 (K2 only; `dkdv256_tile`): S^T and dP^T are computed
//   once per (key, query row) pair and shared through shared memory.  One
//   CTA per 64 keys.  Per 64-row query step each consumer warpgroup
//   computes S^T = K q'^T and dP^T = V dO^T for the CTA's 64 keys against
//   its own 32 rows (m64n32k16 over 16 k16 slices of the head dim), forms
//   p and dS in registers (each thread's lse and delta read from global
//   memory while the products run), and stores P^T and dS^T, rounded to
//   16 bits, as its panel of two 64-key x 64-query buffers (the 64-byte
//   swizzle of the TMA tiles; two pairs of buffers, alternate steps).
//   After one named barrier each warpgroup adds dV[:, its 128 columns] +=
//   P^T dO and dK[:, its 128 columns] += dS^T q' with both operands from
//   shared memory (A K-major, B MN-major as it arrived:
//   `Wgmma<128, T>::ss_tb`).  Tensor-core work: 8 d FLOP a pair, the
//   caller's (the column split this body replaced computed S^T and dP^T
//   in both warpgroups, 12 d).  The cost is 16 KB stored and one barrier
//   a query step.  dK and dV take 2 x 64 f32 registers a thread beside S^T
//   and dP^T's 32, more than a thread of a 384-thread CTA gets
//   (sm90_common.cuh), so the CTA is the two consumer warpgroups alone
//   (DKDV256_THREADS): thread 0 loads K and V once and each step's (q',
//   dO) tiles into its stage once both warpgroups have released the
//   stage's previous step, at the end of a step, two steps ahead of use.
//   Shared memory: (K, V) + 2 (q', dO) stages + 2 x (P^T, dS^T), 64 + 128
//   + 32 KB.  Every consumer warp releases a stage after its own wgmma
//   wait (the empty barriers count the 8 consumer warps).
// * f32 inputs: B2's, K5's and K2's bodies are the 3xTF32 wgmma ones of
//   flash_wide_f32_sm90.cuh (wide32::dkdv_tile).
//
// A CTA whose keys no query row sees (a causal ring step whose held keys
// all lie in the queries' future) issues no load and waits on no barrier:
// it writes dK = dV = 0.  Every mbarrier wait traps after 2 s
// (sm90_common.cuh).

#pragma once

#include "sm90_common.cuh"

namespace hvdt {
namespace sm90 {

constexpr int BWD_BN = 128;    // keys per CTA: 64 per consumer warpgroup
constexpr int BWD_BM = 64;     // query rows per step of the loop
constexpr int BWD_STAGES = 2;  // (q', dO, lse, delta) tiles in flight
// K2's stages: the shared memory that K5's dS^T and dQ buffers take holds
// a third (q', dO) stage instead.
constexpr int DKDV_STAGES = 3;
constexpr int WG_KEYS = 64;    // keys per consumer warpgroup
// K2 at head dim 256 (dkdv256_tile): keys per CTA, (q', dO) stages, the
// arrivals that release a stage (every consumer warp), threads per CTA.
constexpr int DKDV256_KEYS = 64;
constexpr int DKDV256_STAGES = 2;
constexpr int DKDV256_EMPTY = 8;
constexpr int DKDV256_THREADS = 256;  // the two consumer warpgroups

// Keys per CTA: BWD_BN up to head dim 128, DKDV256_KEYS at 256 (K2 only:
// K5 takes head dims to 128).
template <int D>
__host__ __device__ constexpr int bwd_keys() {
  return D == 256 ? DKDV256_KEYS : BWD_BN;
}

// WITH_DQ: K5's layout; without it, K2's (no dS^T or dQ
// buffers, DKDV_STAGES stages).  Head dims to 128.
template <int D, bool WITH_DQ = true>
struct BwdSmem {
  static_assert(D <= 128, "head dim 256 is dkdv256_tile's");
  static constexpr int STAGES = WITH_DQ ? BWD_STAGES : DKDV_STAGES;
  // dQ = dS K split by keys (each consumer warpgroup its own 64 keys, all
  // D columns) where half the head dim is not a whole number of panels.
  static constexpr bool SPLIT_KEYS = (D / 2) % PANEL != 0;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t K_PANEL = BWD_BN * PANEL * 2;
  static constexpr uint32_t Q_PANEL = BWD_BM * PANEL * 2;  // 4 KB
  static constexpr uint32_t K_BYTES = PANELS * K_PANEL;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  // dS^T: BWD_BM / PANEL panels of 128 key rows x 32 query columns.
  static constexpr uint32_t DS_PANEL = BWD_BN * PANEL * 2;
  static constexpr uint32_t DS_BYTES = (BWD_BM / PANEL) * DS_PANEL;
  // A consumer warpgroup's f32 dQ tile: DQ_N / 32 panels of 64 rows x
  // 128 B, 128-byte swizzle, as the TMA reduce reads it.
  static constexpr int DQ_N = SPLIT_KEYS ? D : D / 2;
  static constexpr uint32_t DQ_PANEL = BWD_BM * 32 * 4;
  static constexpr uint32_t DQ_BYTES = (DQ_N / 32) * DQ_PANEL;
  static constexpr uint32_t STAT_FLOATS = 2 * BWD_BM;  // lse, then delta
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + K_BYTES;
  static constexpr uint32_t q = v + K_BYTES;
  static constexpr uint32_t dout = q + STAGES * Q_BYTES;
  static constexpr uint32_t ds = dout + STAGES * Q_BYTES;  // 2 buffers
  static constexpr uint32_t dq =  // one per warpgroup
      ds + (WITH_DQ ? 2 * DS_BYTES : 0);
  static constexpr uint32_t stats = dq + (WITH_DQ ? 2 * DQ_BYTES : 0);
  static constexpr uint32_t bars = stats + STAGES * STAT_FLOATS * 4;
  // kv_full, then full[STAGES], empty[STAGES]
  static constexpr uint32_t N_BARS = 1 + 2 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
  static_assert(D % PANEL == 0, "head dim is a multiple of 32");
};

// The 16-bit body: one CTA of NTHREADS threads computes dK and dV of keys
// [k0, k0 + BWD_BN) of head `bh` and, WITH_DQ, adds their share of dQ
// into the f32 tensor behind `mdq` (K2 compiles the dQ product, the dS^T
// stores, their barrier and the adds out, and passes no `mdq`).  mq, mdo
// (boxes of BWD_BM rows), mk, mv (BWD_BN rows), mdq (f32, BWD_BM rows):
// tensor maps of q', dO and dq (bh, sq, D) and k, v (bh, sk, D) in the
// kernel's parameter space.  lse, delta (bh, sq) f32; dk, dv (bh, sk, D)
// in OT.
template <typename T, int D, typename OT, bool WITH_DQ = true>
__device__ __forceinline__ void bwd_ktile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mdq,
    const float* __restrict__ lse, const float* __restrict__ delta,
    OT* __restrict__ dk, OT* __restrict__ dv, int bh, int k0, int sq,
    int sk, int q_off, int k_off, float scale_r, int causal) {
  using L = BwdSmem<D, WITH_DQ>;
  constexpr int STAGES = L::STAGES;
  constexpr int KEYS = BWD_BN;
  constexpr bool SPLIT_KEYS = L::SPLIT_KEYS;
  constexpr int DQ_N = L::DQ_N;  // dQ columns per warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base + L::k, v_s = base + L::v, q_s = base + L::q;
  const uint32_t do_s = base + L::dout;
  float* const stats = reinterpret_cast<float*>(gbase + L::stats);
  const uint32_t kv_full = base + L::bars;
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;

  // Query tiles that see a key of this tile: under a causal mask, from
  // the first whose last absolute row reaches the tile's first key
  // (reference: `q_start + block_q - 1 >= k_start`).
  const int n_qt = (sq + BWD_BM - 1) / BWD_BM;
  int qt0 = 0;
  if (causal) {
    const int need = k_off + k0 - q_off - BWD_BM + 1;
    qt0 = need <= 0 ? 0 : (need + BWD_BM - 1) / BWD_BM;
  }
  const int n_it = max(0, n_qt - qt0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA thread + the stats warp
      mbar_init(empty + 8 * s, 2);      // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: thread 0 issues the TMA loads, warp 1 copies lse and
    // delta; both wait for a stage to be released before refilling it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(kv_full, 2 * L::K_BYTES);
      tma_tile<D>(k_s, mk, kv_full, KEYS, k0, bh);
      tma_tile<D>(v_s, mv, kv_full, KEYS, k0, bh);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)
          mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const int q0 = (qt0 + it) * BWD_BM;
        mbar_expect_tx(full + 8 * st, 2 * L::Q_BYTES);
        tma_tile<D>(q_s + st * L::Q_BYTES, mq, full + 8 * st, BWD_BM, q0,
                    bh);
        tma_tile<D>(do_s + st * L::Q_BYTES, mdo, full + 8 * st, BWD_BM, q0,
                    bh);
      }
    } else if (warp == 1 && n_it > 0) {
      const size_t row0 = (size_t)bh * sq;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)
          mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const int q0 = (qt0 + it) * BWD_BM;
        float* sl = stats + st * L::STAT_FLOATS;
        for (int r = lane; r < BWD_BM; r += 32) {
          const int row = q0 + r;
          sl[r] = row < sq ? lse[row0 + row] : POS_BIG;
          sl[BWD_BM + r] = row < sq ? delta[row0 + row] : 0.f;
        }
        mbar_arrive(full + 8 * st);
      }
    }
  } else {
    // Consumers: warpgroup c owns keys [k0 + 64 c, k0 + 64 c + 64) and all
    // columns of dK and dV.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int key_row0 = c * WG_KEYS;             // within the tile
    const int key_first = k0 + key_row0;          // within the held keys
    const float scale_log2 = scale_r * LOG2E;
    // dQ: k16 slices [J0, J0 + JN) of the keys, columns [col0, + DQ_N).
    constexpr int JN = SPLIT_KEYS ? WG_KEYS / 16 : BWD_BN / 16;
    const int j0 = SPLIT_KEYS ? c * (WG_KEYS / 16) : 0;
    const int col0 = SPLIT_KEYS ? 0 : c * DQ_N;
    const uint32_t dq_off = L::dq + c * L::DQ_BYTES;
    constexpr int QK_STEPS = D / 16, Q_SLICES = BWD_BM / 16;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    // p and dS of one query tile in place of S^T and dP^T: rows are this
    // warpgroup's keys r_lo (h = 0) and r_lo + 8, columns the tile's
    // queries.  The mask is compiled in only for tiles that straddle the
    // diagonal or the ragged key tail (`masked`).
    auto grads = [&](float (&s)[32], float (&dp)[32], const float* sl,
                     int q0, auto masked) {
#pragma unroll
      for (int i = 0; i < BWD_BM / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = 8 * i + cq + j;
          const float lse2 = sl[qc] * LOG2E, dl = sl[BWD_BM + qc];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * i + 2 * h + j;
            float p = ex2(fmaf(s[e], scale_log2, -lse2));
            if constexpr (decltype(masked)::value) {
              const int kr = key_first + r_lo + 8 * h;
              if (kr >= sk || (causal && k_off + kr > q_off + q0 + qc))
                p = 0.f;
            }
            dp[e] = p * (dp[e] - dl) * scale_r;
            s[e] = p;
          }
        }
    };
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;

    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      const int q0 = (qt0 + it) * BWD_BM;
      const uint32_t qt_s = q_s + st * L::Q_BYTES;
      const uint32_t dot_s = do_s + st * L::Q_BYTES;
      const uint32_t ds_off = L::ds + (it % 2) * L::DS_BYTES;
      mbar_wait(full + 8 * st, ph);

      // S^T = K q'^T and dP^T = V dO^T (M = this warpgroup's keys).
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QK_STEPS; ++kk) {
        const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
        const uint32_t panel = (kk / 2) * L::K_PANEL + key_row0 * 64 + off;
        const uint32_t qpanel = (kk / 2) * L::Q_PANEL + off;
        Wgmma<BWD_BM, T>::ss(s, desc(k_s + panel, 16, 512),
                             desc(qt_s + qpanel, 16, 512), kk > 0);
        Wgmma<BWD_BM, T>::ss(dp, desc(v_s + panel, 16, 512),
                             desc(dot_s + qpanel, 16, 512), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      pin(s);
      pin(dp);

      const float* sl = stats + st * L::STAT_FLOATS;
      const bool masked =
          key_first + WG_KEYS > sk ||
          (causal && k_off + key_first + WG_KEYS - 1 > q_off + q0);
      if (masked)
        grads(s, dp, sl, q0, Masked{});
      else
        grads(s, dp, sl, q0, Plain{});

      // P^T and dS^T to 16 bits as A operands (query columns 8 i .. 8 i +
      // 7: k-slice i / 2, registers h and 2 + h), and dS^T into shared
      // memory: key row kr, 16-byte chunk i % 4 of query panel i / 4,
      // swizzled as TMA would have written it.
      uint32_t pa[Q_SLICES][4], dsa[Q_SLICES][4];
#pragma unroll
      for (int i = 0; i < BWD_BM / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[i / 2][(i % 2) * 2 + h] =
              pack2<T>(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]);
          const uint32_t w = pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);
          dsa[i / 2][(i % 2) * 2 + h] = w;
          if constexpr (WITH_DQ) {
            const int kr = key_row0 + r_lo + 8 * h;
            const uint32_t at = ds_off + (i / 4) * L::DS_PANEL + kr * 64 +
                                (((i % 4) ^ ((kr >> 1) & 3)) << 4) + cq * 2;
            *reinterpret_cast<uint32_t*>(gbase + at) = w;
          }
        }
      if constexpr (WITH_DQ) {
        fence_async_shared();
        // dS^T of the keys this warpgroup's dQ product reads is in place.
        bar_sync(SPLIT_KEYS ? 1 + c : 1, SPLIT_KEYS ? 128 : 256);
      }

      float dq_acc[DQ_N / 2];
      pin(dk_acc);
      pin(dv_acc);
      wg_fence();
#pragma unroll
      for (int j = 0; j < Q_SLICES; ++j)
        Wgmma<D, T>::rs(dv_acc, pa[j],
                        desc(dot_s + j * 16 * 64, L::Q_PANEL, 512));
#pragma unroll
      for (int j = 0; j < Q_SLICES; ++j)
        Wgmma<D, T>::rs(dk_acc, dsa[j],
                        desc(qt_s + j * 16 * 64, L::Q_PANEL, 512));
      if constexpr (WITH_DQ) {
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) {
          const int j = j0 + jj;
          Wgmma<DQ_N, T>::ss_t(
              dq_acc, desc(base + ds_off + j * 16 * 64, L::DS_PANEL, 512),
              desc(k_s + (col0 / PANEL) * L::K_PANEL + j * 16 * 64,
                   L::K_PANEL, 512),
              jj > 0);
        }
      }
      wg_commit();
      wg_wait<0>();
      pin(dk_acc);
      pin(dv_acc);
      if constexpr (WITH_DQ) pin(dq_acc);
      pin(pa);
      pin(dsa);
      mbar_arrive_if(empty + 8 * st, tid == 0);
      if constexpr (WITH_DQ) {
        // This tile's dQ into the caller's f32 tensor: into this
        // warpgroup's buffer (row r, column col: panel col / 32, 16-byte
        // chunk (col % 32) / 4 ^ r % 8), then one TMA reduce-add per panel
        // (rows past sq are not written).  The previous tile's reduce must
        // have read the buffer first.
        if (tid == 0) bulk_wait_all<true>();
        bar_sync(3 + c, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;
#pragma unroll
          for (int i = 0; i < DQ_N / 8; ++i) {
            const int col = 8 * i + cq;
            const uint32_t at = dq_off + (col / 32) * L::DQ_PANEL +
                                r * 128 +
                                ((((col % 32) / 4) ^ (r % 8)) << 4) +
                                (col % 4) * 4;
            *reinterpret_cast<float2*>(gbase + at) = make_float2(
                dq_acc[4 * i + 2 * h], dq_acc[4 * i + 2 * h + 1]);
          }
        }
        fence_async_shared();
        bar_sync(3 + c, 128);
        if (tid == 0) {
#pragma unroll
          for (int p = 0; p < DQ_N / 32; ++p)
            tma_reduce_add(mdq, base + dq_off + p * L::DQ_PANEL,
                           col0 + 32 * p, q0, bh);
          bulk_commit();
        }
      }
    }
    // The adds complete before the CTA's shared memory goes away.
    if constexpr (WITH_DQ)
      if (tid == 0) bulk_wait_all<false>();

    // dK and dV of this warpgroup's keys.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_first + r_lo + 8 * h;
      if (key >= sk) continue;
      OT* dkr = dk + ((size_t)bh * sk + key) * D + cq;
      OT* dvr = dv + ((size_t)bh * sk + key) * D + cq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int e = 4 * i + 2 * h;
        if constexpr (std::is_same<OT, float>::value) {
          *reinterpret_cast<float2*>(dkr + 8 * i) =
              make_float2(dk_acc[e], dk_acc[e + 1]);
          *reinterpret_cast<float2*>(dvr + 8 * i) =
              make_float2(dv_acc[e], dv_acc[e + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(dkr + 8 * i) =
              pack2<T>(dk_acc[e], dk_acc[e + 1]);
          *reinterpret_cast<uint32_t*>(dvr + 8 * i) =
              pack2<T>(dv_acc[e], dv_acc[e + 1]);
        }
      }
    }
  }
}

// K2's layout at head dim 256: K and V of the CTA's 64 keys, DKDV256_STAGES
// (q', dO) stages of 64 query rows, and two pairs of (P^T, dS^T) buffers,
// each 64 key rows x 64 query columns as two panels of 32 query columns
// (panel c written by consumer warpgroup c).
struct Dkdv256Smem {
  static constexpr int D = 256, STAGES = DKDV256_STAGES;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t K_PANEL = DKDV256_KEYS * PANEL * 2;  // 4 KB
  static constexpr uint32_t Q_PANEL = BWD_BM * PANEL * 2;        // 4 KB
  static constexpr uint32_t K_BYTES = PANELS * K_PANEL;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t PT_PANEL = DKDV256_KEYS * PANEL * 2;
  static constexpr uint32_t PT_BYTES = (BWD_BM / PANEL) * PT_PANEL;
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + K_BYTES;
  static constexpr uint32_t q = v + K_BYTES;
  static constexpr uint32_t dout = q + STAGES * Q_BYTES;
  static constexpr uint32_t pt = dout + STAGES * Q_BYTES;  // P^T, dS^T x 2
  static constexpr uint32_t bars = pt + 4 * PT_BYTES;
  // kv_full, then full[STAGES], empty[STAGES]
  static constexpr uint32_t N_BARS = 1 + 2 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K2's 16-bit body at head dim 256 (the file's note gives the design): one
// CTA of DKDV256_THREADS threads, the two consumer warpgroups, computes dK
// and dV of keys [k0, k0 + DKDV256_KEYS) of head `bh`, at zero offsets.
// mq, mdo (boxes of BWD_BM rows), mk, mv (DKDV256_KEYS rows): tensor maps
// of q', dO (bh, sq, 256) and k, v (bh, sk, 256).  lse, delta (bh, sq)
// f32; dk, dv (bh, sk, 256) in T.
template <typename T>
__device__ __forceinline__ void dkdv256_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int bh, int k0, int sq, int sk, float scale_r,
    int causal) {
  using L = Dkdv256Smem;
  constexpr int D = L::D, STAGES = L::STAGES, KEYS = DKDV256_KEYS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base + L::k, v_s = base + L::v, q_s = base + L::q;
  const uint32_t do_s = base + L::dout;
  const uint32_t kv_full = base + L::bars;
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;

  // Query steps that see a key of this CTA: under a causal mask, from the
  // one that holds row k0 (steps and key tiles are both 64 long).
  static_assert(KEYS == BWD_BM, "a causal CTA starts at its diagonal step");
  const int n_qt = (sq + BWD_BM - 1) / BWD_BM;
  const int first_qt = causal ? k0 / BWD_BM : 0;
  const int n_steps = max(0, n_qt - first_qt);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, DKDV256_EMPTY);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warpgroup c computes S^T and dP^T for query rows [32 c, 32 c + 32) of
  // each step and owns columns [128 c, 128 c + 128) of dK and dV, all 64
  // keys.
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second key
  const int cq = 2 * (lane % 4);                // + 8 i + j: the column
  const int qh = 32 * c;                        // query rows of S^T
  const uint32_t cols = (128 * c / PANEL) * L::Q_PANEL;  // of dK, dV
  const float scale_log2 = scale_r * LOG2E;
  const float* const lse_h = lse + (size_t)bh * sq;
  const float* const delta_h = delta + (size_t)bh * sq;

  // Thread 0 loads: K and V once, and step it's (q', dO) tiles into its
  // stage once both warpgroups have released the stage's previous step;
  // called where none of its warpgroup's products is in flight.
  auto load_step = [&](int it) {
    if (threadIdx.x == 0 && it < n_steps) {
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
      const int q0 = (first_qt + it) * BWD_BM;
      mbar_expect_tx(full + 8 * st, 2 * L::Q_BYTES);
      tma_tile<D>(q_s + st * L::Q_BYTES, mq, full + 8 * st, BWD_BM, q0, bh);
      tma_tile<D>(do_s + st * L::Q_BYTES, mdo, full + 8 * st, BWD_BM, q0,
                  bh);
    }
  };
  if (threadIdx.x == 0 && n_steps > 0) {
    mbar_expect_tx(kv_full, 2 * L::K_BYTES);
    tma_tile<D>(k_s, mk, kv_full, KEYS, k0, bh);
    tma_tile<D>(v_s, mv, kv_full, KEYS, k0, bh);
  }
  for (int it = 0; it < STAGES; ++it) load_step(it);

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // p and dS of this warpgroup's 32 query rows in place of S^T and dP^T:
  // rows are the CTA's keys r_lo (h = 0) and r_lo + 8, columns the step's
  // queries qh + 8 i + cq + j, whose lse (in log2 units) and delta are
  // lse2[i][j] and dl[i][j].  The mask is compiled in only for steps that
  // straddle the diagonal or the ragged key tail.
  auto p_and_ds = [&](float (&s)[16], float (&dp)[16],
                      const float (&lse2)[4][2], const float (&dl)[4][2],
                      int q0, auto masked) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = qh + 8 * i + cq + j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * i + 2 * h + j;
          const float pe = ex2(fmaf(s[e], scale_log2, -lse2[i][j]));
          const int kr = k0 + r_lo + 8 * h;
          const bool off = decltype(masked)::value &&
                           (kr >= sk || (causal && kr > q0 + qc));
          dp[e] = off ? 0.f : pe * (dp[e] - dl[i][j]) * scale_r;
          s[e] = off ? 0.f : pe;
        }
      }
  };
  using Plain = std::integral_constant<bool, false>;
  using Masked = std::integral_constant<bool, true>;
  // Every consumer warp releases a stage after its own wgmma wait.
  auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };

  if (n_steps > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % STAGES, ph = (it / STAGES) & 1;
    const int q0 = (first_qt + it) * BWD_BM;
    const uint32_t qt_s = q_s + st * L::Q_BYTES;
    const uint32_t dot_s = do_s + st * L::Q_BYTES;
    const uint32_t pt_off = L::pt + (it % 2) * 2 * L::PT_BYTES;
    const uint32_t ds_off = pt_off + L::PT_BYTES;
    // lse and delta of this thread's 8 query columns (POS_BIG and 0 past
    // sq: p and dS are exactly 0 there), read while the products run.
    float lse2[4][2], dl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = q0 + qh + 8 * i + cq + j;
        lse2[i][j] = (row < sq ? lse_h[row] : POS_BIG) * LOG2E;
        dl[i][j] = row < sq ? delta_h[row] : 0.f;
      }
    mbar_wait(full + 8 * st, ph);

    // S^T = K q'^T and dP^T = V dO^T, M = the 64 keys, N = this
    // warpgroup's 32 query rows, over the 16 k16 slices of the head dim.
    float s[16], dp[16];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
      const uint32_t kp = (kk / 2) * L::K_PANEL + off;
      const uint32_t qp = (kk / 2) * L::Q_PANEL + qh * 64 + off;
      Wgmma<32, T>::ss(s, desc(k_s + kp, 16, 512), desc(qt_s + qp, 16, 512),
                       kk > 0);
      Wgmma<32, T>::ss(dp, desc(v_s + kp, 16, 512),
                       desc(dot_s + qp, 16, 512), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    if (k0 + KEYS > sk || (causal && k0 + KEYS - 1 > q0 + qh))
      p_and_ds(s, dp, lse2, dl, q0, Masked{});
    else
      p_and_ds(s, dp, lse2, dl, q0, Plain{});

    // P^T and dS^T, 16 bits, into this warpgroup's panel of the step's
    // buffers: key row kr, 16-byte chunk i, swizzled as TMA would have
    // written it.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = r_lo + 8 * h;
        const uint32_t at = c * L::PT_PANEL + kr * 64 +
                            ((i ^ ((kr >> 1) & 3)) << 4) + cq * 2;
        const int e = 4 * i + 2 * h;
        *reinterpret_cast<uint32_t*>(gbase + pt_off + at) =
            pack2<T>(s[e], s[e + 1]);
        *reinterpret_cast<uint32_t*>(gbase + ds_off + at) =
            pack2<T>(dp[e], dp[e + 1]);
      }
    fence_async_shared();
    bar_sync(1, 256);  // both halves in place

    // dV[:, cols] += P^T dO[:, cols], dK[:, cols] += dS^T q'[:, cols]: K =
    // the step's 64 query rows, A from the buffers (K-major), B as the
    // tiles arrived (MN-major).
    pin(dk_acc);
    pin(dv_acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BWD_BM / 16; ++j) {
      const uint32_t a = (j / 2) * L::PT_PANEL + (j % 2) * 32;
      Wgmma<128, T>::ss_tb(dv_acc, desc(base + pt_off + a, 16, 512),
                           desc(dot_s + cols + j * 16 * 64, L::Q_PANEL, 512),
                           1);
      Wgmma<128, T>::ss_tb(dk_acc, desc(base + ds_off + a, 16, 512),
                           desc(qt_s + cols + j * 16 * 64, L::Q_PANEL, 512),
                           1);
    }
    wg_commit();
    wg_wait<0>();
    pin(dk_acc);
    pin(dv_acc);
    release(empty + 8 * st);
    load_step(it + STAGES);
  }

  // dK and dV of the 64 keys, this warpgroup's 128 columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r_lo + 8 * h;
    if (key >= sk) continue;
    T* dkr = dk + ((size_t)bh * sk + key) * D + 128 * c + cq;
    T* dvr = dv + ((size_t)bh * sk + key) * D + 128 * c + cq;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * i) =
          pack2<T>(dk_acc[4 * i + 2 * h], dk_acc[4 * i + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * i) =
          pack2<T>(dv_acc[4 * i + 2 * h], dv_acc[4 * i + 2 * h + 1]);
    }
  }
}

// The maps of one launch: q', dO and the f32 dq in boxes of BWD_BM rows,
// k and v in boxes of bwd_keys<D>() rows; four without a `dq` (K2).
template <typename T, int D>
int make_bwd_maps(CUtensorMap* maps, const void* q, const void* dout,
                  const void* k, const void* v, float* dq, int bh, int sq,
                  int sk) {
  int e = make_map<T>(&maps[0], q, bh, sq, D, BWD_BM);
  if (e == 0) e = make_map<T>(&maps[1], dout, bh, sq, D, BWD_BM);
  if (e == 0) e = make_map<T>(&maps[2], k, bh, sk, D, bwd_keys<D>());
  if (e == 0) e = make_map<T>(&maps[3], v, bh, sk, D, bwd_keys<D>());
  if (e == 0 && dq != nullptr)
    e = make_map<float>(&maps[4], dq, bh, sq, D, BWD_BM);
  return e;
}

}  // namespace sm90

}  // namespace hvdt
