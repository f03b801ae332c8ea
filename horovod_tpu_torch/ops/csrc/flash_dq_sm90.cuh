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
// * Head dim 256: the consumers split dQ's columns instead of the rows
//   (col_split): one CTA per 64 query rows, both consumer warpgroups
//   compute S and dP over the whole head dim, each accumulates its 128
//   columns of dQ (the registers of head dim 128; 1.67x the products of
//   one pass); two (K, V) stages of 64 KB: q' + dO + 2 stages, 64 + 128
//   KB.
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

// Query rows per CTA: DQ_BM, and DQ_WG_ROWS at the wide head dim, where
// both consumer warpgroups own the same rows and split dQ's columns
// (col_split).
template <int D>
__host__ __device__ constexpr int dq_rows() {
  return col_split<D>() ? DQ_WG_ROWS : DQ_BM;
}

// Keys per tile: 64 at every head dim.  At 128 keys S, dP, the packed dS
// and dQ of the pipelined loop outgrow the consumers' registers and ptxas
// spills.
template <int D>
constexpr int dq_key_tile() {
  return 64;
}

template <int D>
struct DqSmem {
  static constexpr int BN = dq_key_tile<D>();
  // Two stages at the wide head dim, where a (K, V) stage is 64 KB.
  static constexpr int STAGES = col_split<D>() ? 2 : DQ_STAGES;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t Q_PANEL = dq_rows<D>() * PANEL * 2;
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

// One CTA of NTHREADS threads computes dq of rows [q0, q0 + dq_rows<D>())
// of head `bh`.  mq, mdo (boxes of dq_rows<D>() rows), mk, mv
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
  constexpr int ROWS = dq_rows<D>(), DV = out_cols<D>();
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
    // all columns of dQ or, at the wide head dim, rows [q0, q0 + 64) and
    // columns [c D / 2, (c + 1) D / 2).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = col_split<D>() ? 0 : c * DQ_WG_ROWS;  // within the CTA
    const int col0 = col_split<D>() ? c * DV : 0;          // of dQ
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

    float dq_acc[DV / 2];
    float s[BN / 2], dp[BN / 2];  // S and dP, then p and dS in f32
    uint32_t dsa[DQ_STEPS][4];    // dS as the A operand, per k16 slice
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dq_acc[i] = 0.f;

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
        const uint64_t b =
            desc(k_s + st * L::KV_BYTES + (col0 / PANEL) * L::KV_PANEL +
                     j * 16 * 64,
                 L::KV_PANEL, 512);
        Wgmma<DV, T>::rs(dq_acc, dsa[j], b);
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
      T* dst = dq + ((size_t)bh * sq + row) * D + col0 + cq;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack2<T>(dq_acc[4 * i + 2 * h] * dq_scale,
                     dq_acc[4 * i + 2 * h + 1] * dq_scale);
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
