// K3's 16-bit body (flash_bwd_split.cu, hvdt_flash_bwd_dq): dQ of one
// query tile of the split flash backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`
// (horovod_tpu/ops/attention.py:465, launched by `_split_bwd_call` :930,
// math in `_bwd_block_math` :386): each query tile walks its key tiles
// and sums dQ = sum_j dS_j K_j, with, per (query tile, key tile) pair,
//   s  = q' k^T * scale_r, masked (p exactly 0 there);
//   p  = exp(s - lse), exactly 0 on POS_BIG rows (no mass);
//   dp = dO v^T;
//   dS = p (dp - delta) scale_r, rounded to the storage dtype;
// and dQ times the pow2 factor `dq_scale` in f32 before the cast (q' is q
// pre-scaled by it, so dQ is summed in q' units).  lse and delta are the
// caller's (delta = rowsum(dO * o), outside the kernel as in the
// reference).
//
// Bound on the card.  At the split path's shape (bh 1040, seq 512, head
// dim 64, bf16, causal): 52.4 GFLOP (three products, 6 d FLOP per causal
// pair) against 345 MB (q', dO, K, V, lse, delta read once, dq written
// once), so 0.1030 ms by bytes, 0.0530 ms of tensor-core time.  Near the
// ridge, so the design keeps the tensor cores fed and sends no
// intermediate to shared memory.  It is the forward's skeleton
// (flash_fwd_sm90.cuh) with a second operand tile and no online softmax:
//
// * One CTA of three warpgroups per 128-row query tile, heavy (late,
//   under a causal mask) query tiles first in the grid.  Warpgroup 0 is
//   the producer: one thread TMA-loads the q' and dO tiles once (3-D
//   tensor maps (D, s, bh), so a ragged tile zero-fills inside its head)
//   and streams K and V tiles through a ring of DQ_STAGES stages with
//   full/empty mbarrier pairs, then gives its registers away
//   (setmaxnreg).  Warpgroups 1 and 2 each own 64 query rows and read
//   their rows' lse and delta once into registers (POS_BIG and 0 past
//   sq).  Per key tile, S = q' K^T and dP = dO V^T by wgmma from shared
//   memory (both K-major, as the forward's S), so p and dS land in
//   registers with query rows on M; dS is rounded to 16 bits in registers
//   as the A operand of dQ += dS K (K read MN-major, as the forward reads
//   V for P V).  V is released once dP has read it, K once the dQ
//   product has.  dQ stays in f32 registers for the whole loop, so there
//   are no atomics, no f32 workspace and no flush kernel.
// * The loop is pipelined within each warpgroup: S and dP of key tile j
//   are issued ahead of dQ += dS K of tile j - 1, and the elementwise
//   step of tile j runs while that product is in flight.  The mask is
//   compiled into a second copy of the step that only the tiles
//   straddling the diagonal or the ragged key tail take, so nothing
//   branches while a product is in flight (ptxas C7520).
// * Key tile (dq_key_tile): 64 keys at every head dim.  Per consumer
//   thread S and dP take 2 x 32 f32 registers, the packed dS 16 and dQ
//   D / 2: 96 at D 32, 112 at 64, 128 at 96, 144 at 128.  With 128-key
//   tiles (176 and 192 at D 32 and 64) ptxas spilled and serialized the
//   wgmma (C7512), and K3 ran 1.5-1.8x slower; at 64 keys ptxas reports
//   no spill at D 32 and 64, 16 B at 96, and 176 B with C7512 at 128.
//   The short tiles leave shared memory for DQ_STAGES (K, V) stages:
//   q' + dO + 3 stages, D 32: 16 + 24 KB; D 64: 32 + 48 KB; D 96: 48 +
//   72 KB; D 128: 64 + 96 KB.  tools/torch_split_variants.py times the
//   alternatives (128-key tiles, two or four stages).
// * Head dim 256 (`dq256_tile`): S and dP are computed once per (query
//   row, key) pair, each consumer warpgroup for its own rows, as K1 at
//   256 computes S (flash_fwd_sm90.cuh).  One CTA per 128 query rows,
//   each consumer warpgroup 64 of them.  Per 32-key tile each warpgroup
//   computes S = q' K^T and dP = dO V^T for its rows (m64n32k16 over the
//   16 k16 slices of the head dim, both operands K-major), forms p and dS
//   in f32 registers, rounds dS to 16 bits in registers as the A operand
//   and adds all 256 columns of dQ += dS K as two N = 128 products a k16
//   slice (K read MN-major), as K1 adds O += P V.  Tensor-core work: 6 d
//   FLOP a causal pair, the caller's (the column split this body replaced
//   computed S and dP in both warpgroups, 10 d).  No exchange between the
//   warpgroups and no named barrier; K and V are streamed once per 128
//   rows.  Registers: dQ 128 f32 a thread beside S and dP's 32 and dS's
//   8, more than a thread of a 384-thread CTA gets (sm90_common.cuh), so
//   the CTA is the two consumer warpgroups alone (DQ256_THREADS): thread
//   0 loads q' and dO once and each tile's V and K into its stage once
//   both warpgroups have released it (V after S and dP, K after the dQ
//   product), two tiles ahead of use.  Shared memory: q' + dO 128 KB,
//   which leaves room for 32-key tiles only: 2 (K, V) stages of 32 KB.
//   Every consumer warp releases a stage after its own wgmma wait (the
//   empty barriers count the 8 consumer warps).  The grid is ordered by
//   its size (sm90::tile_order), heavy (late) query tiles first.  K2's
//   layout turned for dQ (64-row CTAs, S^T and dP^T of half the rows per
//   warpgroup, dS^T shared through shared memory, each warpgroup 128
//   columns of dQ) computes the same once per pair and ran 5-6% slower at
//   1040 x 512 x 256 and 3-4% at 32 x 1024 x 256 on an H100
//   (tools/torch_split_variants.py --family d256, dq256_64_rows).
// * Causal: key tiles wholly past the tile's last row are not loaded; a
//   warpgroup whose rows see none of a loaded tile, or whose rows all lie
//   past sq, waits for it and releases it.  Every mbarrier wait traps
//   after 2 s (sm90_common.cuh).

#pragma once

#include "sm90_common.cuh"

namespace hvdt {
namespace sm90 {

constexpr int DQ_BM = 128;      // query rows per CTA
constexpr int DQ_WG_ROWS = 64;  // query rows per consumer warpgroup
constexpr int DQ_STAGES = 3;    // (K, V) tiles in flight
// K3 at head dim 256 (dq256_tile): query rows per CTA, keys per tile, (K,
// V) stages, the arrivals that release a stage (every consumer warp),
// threads per CTA.
constexpr int DQ256_ROWS = 128;
constexpr int DQ256_KEYS = 32;
constexpr int DQ256_STAGES = 2;
constexpr int DQ256_EMPTY = 8;
constexpr int DQ256_THREADS = 256;  // the two consumer warpgroups

// Query rows per CTA: DQ_BM up to head dim 128, DQ256_ROWS at 256.
template <int D>
__host__ __device__ constexpr int dq_rows() {
  return D == 256 ? DQ256_ROWS : DQ_BM;
}

// Keys per tile: 64 at every head dim (DQ256_KEYS at 256).  At 128 keys
// S, dP, the packed dS and dQ of the pipelined loop outgrow the
// consumers' registers and ptxas spills.
template <int D>
constexpr int dq_key_tile() {
  return D == 256 ? DQ256_KEYS : 64;
}

template <int D>
struct DqSmem {
  static_assert(D <= 128, "head dim 256 is dq256_tile's");
  static constexpr int BN = dq_key_tile<D>();
  static constexpr int STAGES = DQ_STAGES;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t Q_PANEL = DQ_BM * PANEL * 2;
  static constexpr uint32_t KV_PANEL = BN * PANEL * 2;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t KV_BYTES = PANELS * KV_PANEL;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + Q_BYTES;
  static constexpr uint32_t k = dout + Q_BYTES;
  static constexpr uint32_t v = k + STAGES * KV_BYTES;
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;
  // qdo_full, then k_full, v_full, k_empty, v_empty [STAGES] each
  static constexpr uint32_t N_BARS = 1 + 4 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
  static_assert(D % PANEL == 0, "head dim is a multiple of 32");
};

// One CTA of NTHREADS threads computes dq of rows [q0, q0 + DQ_BM) of
// head `bh`, head dims to 128.  mq, mdo (boxes of DQ_BM rows), mk, mv
// (dq_key_tile<D>() rows):
// tensor maps of q', dO (bh, sq, D) and k, v (bh, sk, D) in the kernel's
// parameter space.  lse, delta (bh, sq) f32; dq (bh, sq, D) in T.
template <typename T, int D>
__device__ __forceinline__ void dq_qtile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int bh, int q0,
    int sq, int sk, float scale_r, float dq_scale, int causal) {
  using L = DqSmem<D>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  constexpr int ROWS = DQ_BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q, do_s = base + L::dout;
  const uint32_t k_s = base + L::k, v_s = base + L::v;
  const uint32_t qdo_full = base + L::bars;
  const uint32_t k_full = qdo_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  int n_kt = (sk + BN - 1) / BN;
  // Causal: key tiles that start past the CTA's last row are wholly
  // masked (reference: `k_start <= q_start + block_q - 1`).
  if (causal) n_kt = min(n_kt, (q0 + ROWS - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2);  // one arrival per consumer warpgroup
      mbar_init(v_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.  K and V of a stage are released apart: V once dP = dO
    // V^T has read it, K once dQ += dS K has.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && n_kt > 0) {
      mbar_expect_tx(qdo_full, 2 * L::Q_BYTES);
      tma_tile<D>(q_s, mq, qdo_full, ROWS, q0, bh);
      tma_tile<D>(do_s, mdo, qdo_full, ROWS, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES, used = (kt / STAGES - 1) & 1;
        if (kt >= STAGES) mbar_wait(k_empty + 8 * st, used);
        mbar_expect_tx(k_full + 8 * st, L::KV_BYTES);
        tma_tile<D>(k_s + st * L::KV_BYTES, mk, k_full + 8 * st, BN,
                    kt * BN, bh);
        if (kt >= STAGES) mbar_wait(v_empty + 8 * st, used);
        mbar_expect_tx(v_full + 8 * st, L::KV_BYTES);
        tma_tile<D>(v_s + st * L::KV_BYTES, mv, v_full + 8 * st, BN,
                    kt * BN, bh);
      }
    }
  } else {
    // Consumers: warpgroup c owns rows [q0 + 64 c, q0 + 64 c + 64) and
    // all columns of dQ.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = c * DQ_WG_ROWS;  // within the CTA
    const int wg_first = q0 + row0;
    const float scale_log2 = scale_r * LOG2E;
    constexpr int QK_STEPS = D / 16, DQ_STEPS = BN / 16;
    // Key tiles with a key some row of this warpgroup sees: the rest (a
    // causal suffix, or all where the rows lie past sq) only pass through
    // the barriers.
    int n_live = wg_first < sq ? n_kt : 0;
    if (causal) n_live = min(n_live, (wg_first + DQ_WG_ROWS - 1) / BN + 1);

    // lse in log2 units and delta of rows r_lo (h = 0) and r_lo + 8.
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg_first + r_lo + 8 * h;
      const size_t at = (size_t)bh * sq + row;
      lse2[h] = (row < sq ? lse[at] : POS_BIG) * LOG2E;
      dl[h] = row < sq ? delta[at] : 0.f;
    }

    float dq_acc[D / 2];
    float s[BN / 2], dp[BN / 2];  // S and dP, then p and dS in f32
    uint32_t dsa[DQ_STEPS][4];    // dS as the A operand, per k16 slice
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    // S = q' K^T and dP = dO V^T of stage st, issued (not waited for).
    auto issue_sdp = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < QK_STEPS; ++kk) {
        const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
        const uint32_t a = (kk / 2) * L::Q_PANEL + row0 * 64 + off;
        const uint32_t b =
            st * L::KV_BYTES + (kk / 2) * L::KV_PANEL + off;
        Wgmma<BN, T>::ss(s, desc(q_s + a, 16, 512), desc(k_s + b, 16, 512),
                         kk > 0);
        Wgmma<BN, T>::ss(dp, desc(do_s + a, 16, 512),
                         desc(v_s + b, 16, 512), kk > 0);
      }
      wg_commit();
    };
    // dQ += dS K of stage st, issued (not waited for).
    auto issue_dq = [&](int st) {
#pragma unroll
      for (int j = 0; j < DQ_STEPS; ++j) {
        const uint64_t b = desc(k_s + st * L::KV_BYTES + j * 16 * 64,
                                L::KV_PANEL, 512);
        Wgmma<D, T>::rs(dq_acc, dsa[j], b);
      }
      wg_commit();
    };
    // p and dS of key tile kt in place of dP, rows r_lo (h = 0) and
    // r_lo + 8, columns the tile's keys.  The mask is compiled in only
    // for tiles that straddle the diagonal or the ragged tail (`masked`).
    auto grads = [&](int kt, auto masked) {
      const int k0 = kt * BN;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 4 * i + 2 * h + j;
            float p = ex2(fmaf(s[e], scale_log2, -lse2[h]));
            if constexpr (decltype(masked)::value) {
              const int key = k0 + 8 * i + cq + j;
              const int row = wg_first + r_lo + 8 * h;
              if (key >= sk || (causal && key > row)) p = 0.f;
            }
            dp[e] = p * (dp[e] - dl[h]) * scale_r;
          }
    };
    // dS to 16 bits as the A operand: for key columns 8 i .. 8 i + 7,
    // k-slice i / 2, registers h (slice columns 0-7) and 2 + h (8-15).
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dsa[i / 2][(i % 2) * 2 + h] =
              pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);
    };
    // Tile kt >= 1, pipelined: S and dP of tile kt are issued ahead of
    // dQ += dS K of tile kt - 1, and the elementwise step of tile kt runs
    // while that product is in flight.  Nothing between an issue and its
    // wait branches.
    auto step = [&](int kt, auto masked) {
      const int st = kt % STAGES, ph = (kt / STAGES) & 1;
      const int pst = (kt - 1) % STAGES;
      mbar_wait(k_full + 8 * st, ph);
      mbar_wait(v_full + 8 * st, ph);
      pin(s);
      pin(dp);
      pin(dq_acc);
      wg_fence();
      issue_sdp(st);
      issue_dq(pst);
      wg_wait<1>();  // S and dP of tile kt are in; dQ of kt - 1 may run on
      pin(s);
      pin(dp);
      mbar_arrive_if(v_empty + 8 * st, tid == 0);
      grads(kt, masked);
      wg_wait<0>();
      pin(dq_acc);
      pin(dsa);
      mbar_arrive_if(k_empty + 8 * pst, tid == 0);
      pack();
    };

    // Leading tiles need no mask; from the first that straddles the
    // diagonal or the ragged tail on, every live tile does.
    int n_plain = min(n_live, sk / BN);
    if (causal) {
      const int x = wg_first - BN + 1;  // k0 <= x: no key masked
      n_plain = min(n_plain, x < 0 ? 0 : x / BN + 1);
    }
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;
    if (n_live > 0) {
      mbar_wait(qdo_full, 0);
      mbar_wait(k_full, 0);
      mbar_wait(v_full, 0);
      pin(s);
      pin(dp);
      wg_fence();
      issue_sdp(0);
      wg_wait<0>();
      pin(s);
      pin(dp);
      mbar_arrive_if(v_empty, tid == 0);
      if (n_plain > 0)
        grads(0, Plain{});
      else
        grads(0, Masked{});
      pack();
    }
    for (int kt = 1; kt < n_plain; ++kt) step(kt, Plain{});
    for (int kt = max(n_plain, 1); kt < n_live; ++kt) step(kt, Masked{});
    if (n_live > 0) {
      const int st = (n_live - 1) % STAGES;
      pin(dq_acc);
      wg_fence();
      issue_dq(st);
      wg_wait<0>();
      pin(dq_acc);
      mbar_arrive_if(k_empty + 8 * st, tid == 0);
    }
    // Tiles no row of this warpgroup sees: wait for each to land (so the
    // release below cannot complete an earlier use of its stage), release.
    for (int kt = n_live; kt < n_kt; ++kt) {
      const int st = kt % STAGES, ph = (kt / STAGES) & 1;
      mbar_wait(k_full + 8 * st, ph);
      mbar_wait(v_full + 8 * st, ph);
      mbar_arrive_if(k_empty + 8 * st, tid == 0);
      mbar_arrive_if(v_empty + 8 * st, tid == 0);
    }

    // dq = dQ * dq_scale in f32, cast, stored straight from registers.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg_first + r_lo + 8 * h;
      if (row >= sq) continue;
      T* dst = dq + ((size_t)bh * sq + row) * D + cq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack2<T>(dq_acc[4 * i + 2 * h] * dq_scale,
                     dq_acc[4 * i + 2 * h + 1] * dq_scale);
    }
  }
}

// K3's layout at head dim 256: q' and dO of the CTA's DQ256_ROWS query
// rows and DQ256_STAGES (K, V) stages of DQ256_KEYS keys.
struct Dq256Smem {
  static constexpr int D = 256, STAGES = DQ256_STAGES;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t Q_PANEL = DQ256_ROWS * PANEL * 2;   // 8 KB
  static constexpr uint32_t KV_PANEL = DQ256_KEYS * PANEL * 2;  // 2 KB
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t KV_BYTES = PANELS * KV_PANEL;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + Q_BYTES;
  static constexpr uint32_t k = dout + Q_BYTES;
  static constexpr uint32_t v = k + STAGES * KV_BYTES;
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;
  // qdo_full, then k_full, v_full, k_empty, v_empty [STAGES] each
  static constexpr uint32_t N_BARS = 1 + 4 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K3's 16-bit body at head dim 256 (the file's note gives the design): one
// CTA of DQ256_THREADS threads, the two consumer warpgroups, computes dq
// of query rows [q0, q0 + DQ256_ROWS) of head `bh`.  mq, mdo (boxes of
// DQ256_ROWS rows), mk, mv (DQ256_KEYS rows): tensor maps of q', dO (bh,
// sq, 256) and k, v (bh, sk, 256).  lse, delta (bh, sq) f32; dq (bh, sq,
// 256) in T.
template <typename T>
__device__ __forceinline__ void dq256_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int bh, int q0,
    int sq, int sk, float scale_r, float dq_scale, int causal) {
  using L = Dq256Smem;
  constexpr int D = L::D, STAGES = L::STAGES, KEYS = DQ256_KEYS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q, do_s = base + L::dout;
  const uint32_t k_s = base + L::k, v_s = base + L::v;
  const uint32_t qdo_full = base + L::bars;
  const uint32_t k_full = qdo_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  // Causal: key tiles that start past the CTA's last row are wholly
  // masked and not loaded.
  int n_kt = (sk + KEYS - 1) / KEYS;
  if (causal) n_kt = min(n_kt, (q0 + DQ256_ROWS - 1) / KEYS + 1);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, DQ256_EMPTY);
      mbar_init(v_empty + 8 * s, DQ256_EMPTY);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64) and all 256
  // columns of dQ.
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
  const int cq = 2 * (lane % 4);                // + 8 i + j: the column
  const int row0 = DQ_WG_ROWS * c;              // within the CTA
  const int wg_first = q0 + row0;
  const float scale_log2 = scale_r * LOG2E;

  // Thread 0 loads tile kt's V (K) into its stage once both warpgroups
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
    tma_tile<D>(q_s, mq, qdo_full, DQ256_ROWS, q0, bh);
    tma_tile<D>(do_s, mdo, qdo_full, DQ256_ROWS, q0, bh);
  }
  for (int kt = 0; kt < STAGES; ++kt) {
    load(v_s, mv, v_full, v_empty, kt);
    load(k_s, mk, k_full, k_empty, kt);
  }

  // Key tiles with a key some row of this warpgroup sees: the rest (a
  // causal suffix, or all where the rows lie past sq) only pass through
  // the barriers.
  int n_live = wg_first < sq ? n_kt : 0;
  if (causal) n_live = min(n_live, (wg_first + DQ_WG_ROWS - 1) / KEYS + 1);

  // lse in log2 units and delta of rows r_lo (h = 0) and r_lo + 8
  // (POS_BIG and 0 past sq: p and dS are exactly 0 there).
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wg_first + r_lo + 8 * h;
    const size_t at = (size_t)bh * sq + row;
    lse2[h] = (row < sq ? lse[at] : POS_BIG) * LOG2E;
    dl[h] = row < sq ? delta[at] : 0.f;
  }

  float dq_acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dq_acc[i] = 0.f;

  // dS in place of dP (p no longer needed): rows r_lo (h = 0) and r_lo +
  // 8, columns the tile's keys.  The mask is compiled in only for tiles
  // that straddle the diagonal or the ragged key tail.
  auto dscores = [&](float (&s)[16], float (&dp)[16], int k0, auto masked) {
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * i + 2 * h + j;
          const float pe = ex2(fmaf(s[e], scale_log2, -lse2[h]));
          const int key = k0 + 8 * i + cq + j;
          const int row = wg_first + r_lo + 8 * h;
          const bool off = decltype(masked)::value &&
                           (key >= sk || (causal && key > row));
          dp[e] = off ? 0.f : pe * (dp[e] - dl[h]) * scale_r;
        }
  };
  using Plain = std::integral_constant<bool, false>;
  using Masked = std::integral_constant<bool, true>;
  // Every consumer warp releases a stage after its own wgmma wait.
  auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };

  if (n_live > 0) mbar_wait(qdo_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES, ph = (kt / STAGES) & 1;
    const int k0 = kt * KEYS;
    const uint32_t kt_s = k_s + st * L::KV_BYTES;
    const uint32_t vt_s = v_s + st * L::KV_BYTES;
    mbar_wait(k_full + 8 * st, ph);
    mbar_wait(v_full + 8 * st, ph);
    if (kt >= n_live) {
      // No row of this warpgroup sees the tile: pass it on.
      release(v_empty + 8 * st);
      load(v_s, mv, v_full, v_empty, kt + STAGES);
      release(k_empty + 8 * st);
      load(k_s, mk, k_full, k_empty, kt + STAGES);
      continue;
    }

    // S = q' K^T and dP = dO V^T, M = this warpgroup's 64 query rows, N =
    // the tile's 32 keys, over the 16 k16 slices of the head dim.
    float s[16], dp[16];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
      const uint32_t a = (kk / 2) * L::Q_PANEL + row0 * 64 + off;
      const uint32_t b = (kk / 2) * L::KV_PANEL + off;
      Wgmma<KEYS, T>::ss(s, desc(q_s + a, 16, 512), desc(kt_s + b, 16, 512),
                         kk > 0);
      Wgmma<KEYS, T>::ss(dp, desc(do_s + a, 16, 512),
                         desc(vt_s + b, 16, 512), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    release(v_empty + 8 * st);
    load(v_s, mv, v_full, v_empty, kt + STAGES);

    if (k0 + KEYS > sk || (causal && k0 + KEYS - 1 > wg_first))
      dscores(s, dp, k0, Masked{});
    else
      dscores(s, dp, k0, Plain{});

    // dS to 16 bits as the A operand: key columns 8 i .. 8 i + 7, k16
    // slice i / 2, registers h (slice columns 0-7) and 2 + h (8-15).
    uint32_t dsa[KEYS / 16][4];
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dsa[i / 2][(i % 2) * 2 + h] =
            pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);

    // dQ += dS K as two N = 128 products a k16 slice (columns 0-127 and
    // 128-255), K read MN-major as it arrived.
    pin(dq_acc);
    wg_fence();
#pragma unroll
    for (int jk = 0; jk < KEYS / 16; ++jk) {
      const uint32_t b = kt_s + jk * 16 * 64;
      Wgmma<128, T>::rs(part<64, 0>(dq_acc), dsa[jk],
                        desc(b, L::KV_PANEL, 512));
      Wgmma<128, T>::rs(part<64, 1>(dq_acc), dsa[jk],
                        desc(b + 4 * L::KV_PANEL, L::KV_PANEL, 512));
    }
    wg_commit();
    wg_wait<0>();
    pin(dq_acc);
    pin(dsa);
    release(k_empty + 8 * st);
    load(k_s, mk, k_full, k_empty, kt + STAGES);
  }

  // dq = dQ * dq_scale in f32, cast, stored straight from registers: rows
  // r_lo (h = 0) and r_lo + 8, all 256 columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wg_first + r_lo + 8 * h;
    if (row >= sq) continue;
    T* dst = dq + ((size_t)bh * sq + row) * D + cq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int e = 4 * i + 2 * h;
      *reinterpret_cast<uint32_t*>(dst + 8 * i) =
          pack2<T>(dq_acc[e] * dq_scale, dq_acc[e + 1] * dq_scale);
    }
  }
}

// The four maps of one launch: q' and dO in boxes of dq_rows<D>() rows, k
// and v in boxes of the key tile.
template <typename T, int D>
int make_dq_maps(CUtensorMap* maps, const void* q, const void* dout,
                 const void* k, const void* v, int bh, int sq, int sk) {
  int e = make_map<T>(&maps[0], q, bh, sq, D, dq_rows<D>());
  if (e == 0) e = make_map<T>(&maps[1], dout, bh, sq, D, dq_rows<D>());
  if (e == 0) e = make_map<T>(&maps[2], k, bh, sk, D, dq_key_tile<D>());
  if (e == 0) e = make_map<T>(&maps[3], v, bh, sk, D, dq_key_tile<D>());
  return e;
}

}  // namespace sm90
}  // namespace hvdt
