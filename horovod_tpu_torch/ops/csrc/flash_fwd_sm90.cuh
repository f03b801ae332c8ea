// The flash-attention forward body shared by K1 (flash_fwd.cu, zero
// offsets) and K4 (ring_flash.cu, a ring step's offsets), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels `_flash_kernel`
// (horovod_tpu/ops/attention.py:356, with `_attend_block`) and
// `_step_kernel` (horovod_tpu/ops/ring_flash.py:78): one query tile of
// o = softmax(q' k^T * scale_r) v and its f32 logsumexp, where q' arrives
// pre-scaled by the exact power-of-two part of sm_scale and scale_r is the
// f32 residual, with the query rows at absolute position q_off + q0 and the
// keys at k_off for the causal mask across ring shards.
//
// Bound on the card.  K1 at the training shape (bh 128, seq 1024, head_dim
// 64, bf16, causal): 17.2 GFLOP against 67.6 MB, so 0.0202 ms by bytes
// (0.0174 ms of tensor-core time at 989 TFLOP/s).  K4 on a wholly visible
// ring step (bh 32, 1024 x 1024, head_dim 64): 8.59 GFLOP against 16.9 MB,
// 0.0087 ms by operations.  Both sit near the ridge, so the design keeps
// the tensor cores fed and never sends an intermediate to shared memory:
//
// * 16-bit inputs: one CTA of three warpgroups per 128-row query tile.
//   Warpgroup 0 is the producer: one thread issues TMA loads (3-D tensor
//   maps (D, s, bh), so a ragged tile zero-fills inside its own head) of
//   the Q tile once and of K and V tiles into a ring of STAGES
//   shared-memory stages, each with mbarrier full/empty pairs (K is
//   released once S = Q K^T has read it, V once O += P V has), and gives
//   its registers away (setmaxnreg).  Warpgroups 1 and 2 each own 64 query
//   rows: S = Q K^T by wgmma from shared memory into f32 registers, the
//   online softmax in registers, P rounded to the storage dtype in
//   registers as the A operand of O += P V (V read MN-major, as it
//   arrived), O in registers for the whole loop.  The loop is pipelined
//   within each warpgroup: S of key tile j is issued ahead of P V of tile
//   j - 1, and the softmax of tile j runs while that product is in
//   flight; the mask is compiled into a second copy of the loop that only
//   the tiles straddling the diagonal or the ragged tail take, so nothing
//   branches while a product is in flight (ptxas would serialize it).
//   Tiles sit in 64-byte swizzle panels of 32 head-dim elements, which
//   tile head dims 32/64/96/128 alike.  Key tile: 128 keys up to head dim
//   64, 64 keys above (at 128, S, P and O of the pipelined loop spill the
//   consumers' registers).  Shared memory per CTA, Q + 2 stages of K and
//   V: D 32: 8 + 32 KB; D 64: 16 + 64 KB; D 96: 24 + 48 KB; D 128: 32 +
//   64 KB.  Registers, not shared memory, hold the SM to one CTA (384
//   threads at 168 registers; 40 for the producer, 232 for the consumers
//   after setmaxnreg).
// * Head dim 256 (K1 only; any head dim above 128 runs zero-padded to
//   it): at 128 query rows O alone would take 128 f32 registers per
//   consumer thread, so the consumers split O's columns instead of its
//   rows (col_split): one CTA per 64 query rows, both consumer warpgroups
//   compute S = Q K^T over the whole head dim (16 k16 slices from shared
//   memory) with the same online softmax, and each accumulates O over its
//   128 columns of V.  The registers are those of head dim 128 with
//   64-key tiles; S is computed twice per key tile (1.5x the products of
//   one pass), and every Q, K and V tile in shared memory serves both
//   warpgroups.  Shared memory: Q + 2 stages of K and V, 32 + 128 KB.
// * f32 inputs (K4; K1's f32 runs the 3xTF32 wgmma body of
//   flash_wide_f32_sm90.cuh): a SIMT body with scalar FMAs in full f32,
//   64 x 64 tiles through shared memory.
//
// Semantics of the reference (horovod_tpu/ops/attention.py:320-335):
// masked logits are NEG_INF, m_safe keeps rows with no key so far at zero
// mass, alpha = exp(m_prev - m_safe) rescales l and O, p is rounded to the
// storage dtype against the running max after its key tile, o = O / l (0
// where l == 0), lse = m + log l (POS_BIG where l == 0).  The 16-bit body
// computes exp as exp2 with scale_r * log2(e) folded into the logits.
// Causal work: key tiles wholly past the tile's last absolute row are not
// loaded; the mask is applied only on tiles that straddle the diagonal or
// the ragged tail; the heavy query tiles come first in the grid.  A CTA
// with no key tile at all (a ring step wholly in the future) issues no
// load and waits on no barrier: it writes o = 0 and lse = POS_BIG.

#pragma once

#include "sm90_common.cuh"

namespace hvdt {
namespace sm90 {

constexpr int BM = 128;        // query rows per CTA
constexpr int WG_ROWS = 64;    // query rows per consumer warpgroup
constexpr int STAGES = 2;      // K/V tiles in flight

// Query rows per CTA: BM, and WG_ROWS at the wide head dim, where both
// consumer warpgroups own the same rows (col_split).
template <int D>
__host__ __device__ constexpr int fwd_rows() {
  return col_split<D>() ? WG_ROWS : BM;
}

// Shared-memory layout of one CTA: a tile of R rows is D / PANEL panels of
// R x 64 bytes, each as TMA writes it with 64-byte swizzle.
// Keys per tile: 128 up to head dim 64; 64 above, where S, P and O of the
// pipelined loop would not fit the consumers' registers at 128.
template <int D>
constexpr int key_tile() {
  return D <= 64 ? 128 : 64;
}

template <int D>
struct Smem {
  static constexpr int BN = key_tile<D>();
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t Q_PANEL = fwd_rows<D>() * PANEL * 2;
  static constexpr uint32_t KV_PANEL = BN * PANEL * 2;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t KV_BYTES = PANELS * KV_PANEL;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + Q_BYTES;
  static constexpr uint32_t v = k + STAGES * KV_BYTES;
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;
  // q_full, then k_full, v_full, k_empty, v_empty [STAGES] each
  static constexpr uint32_t N_BARS = 1 + 4 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
  static_assert(D % PANEL == 0, "head dim is a multiple of 32");
};

// The 16-bit body: one CTA of NTHREADS threads computes rows
// [q0, q0 + fwd_rows<D>()) of head `bh`.  mq, mk, mv: tensor maps of q
// (bh, sq, D) and k, v (bh, sk, D) in the kernel's parameter space.  o
// (bh, sq, D), lse (bh, sq).
template <typename T, int D>
__device__ __forceinline__ void fwd_tile(const CUtensorMap* mq,
                                         const CUtensorMap* mk,
                                         const CUtensorMap* mv, T* o,
                                         float* lse, int bh, int q0, int sq,
                                         int sk, int q_off, int k_off,
                                         float scale_r, int causal) {
  using L = Smem<D>;
  constexpr int BN = L::BN;
  constexpr int ROWS = fwd_rows<D>(), DV = out_cols<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q, k_s = base + L::k, v_s = base + L::v;
  const uint32_t q_full = base + L::bars;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  // Absolute position of this CTA's first query row.
  const int q_abs = q_off + q0;
  int n_kt = (sk + BN - 1) / BN;
  if (causal) {
    // Key tiles that start past the CTA's last absolute row are wholly
    // masked (reference: `k_start <= q_start + block_q - 1`); a held
    // shard wholly in the future leaves none.
    const int lim = q_abs + ROWS - 1 - k_off;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / BN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
    // Producer.  K and V of a stage are released apart: K once S = Q K^T
    // has read it, V once O += P V has.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && n_kt > 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      tma_tile<D>(q_s, mq, q_full, ROWS, q0, bh);
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
    // all columns of O or, at the wide head dim, rows [q0, q0 + 64) and
    // columns [c D / 2, (c + 1) D / 2).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = col_split<D>() ? 0 : c * WG_ROWS;  // within the CTA
    const int col0 = col_split<D>() ? c * DV : 0;       // of O
    const int wg_first = q_abs + row0;            // absolute rows
    const float scale_log2 = scale_r * LOG2E;
    constexpr int QK_STEPS = D / 16, PV_STEPS = BN / 16;
    // Key tiles with a key some row of this warpgroup sees: the rest (a
    // causal suffix) only pass through the barriers.
    int n_live = n_kt;
    if (causal) {
      const int lim = wg_first + WG_ROWS - 1 - k_off;
      n_live = lim < 0 ? 0 : min(n_kt, lim / BN + 1);
    }

    float acc[DV / 2];
    float s[BN / 2];        // S, then P in f32
    uint32_t pa[PV_STEPS][4];  // P as the A operand, per k16 slice
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;

    // S = Q K^T of key tile stage st, issued (not waited for).
    auto issue_qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < QK_STEPS; ++kk) {
        const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
        const uint64_t a =
            desc(q_s + (kk / 2) * L::Q_PANEL + row0 * 64 + off, 16, 512);
        const uint64_t b =
            desc(k_s + st * L::KV_BYTES + (kk / 2) * L::KV_PANEL + off, 16,
                 512);
        Wgmma<BN, T>::ss(s, a, b, kk > 0);
      }
      wg_commit();
    };
    // O += P V of stage st, issued (not waited for).
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int j = 0; j < PV_STEPS; ++j) {
        const uint64_t b =
            desc(v_s + st * L::KV_BYTES + (col0 / PANEL) * L::KV_PANEL +
                     j * 16 * 64,
                 L::KV_PANEL, 512);
        Wgmma<DV, T>::rs(acc, pa[j], b);
      }
      wg_commit();
    };
    // Online softmax of key tile kt in log2 units, rows r_lo (h = 0) and
    // r_lo + 8: m, l and alpha updated, p left in s.  Touches no O.  The
    // mask is compiled in only for tiles that straddle the diagonal or the
    // ragged tail (`masked`).
    auto softmax = [&](int kt, auto masked) {
      const int k0 = kt * BN;
      const int k_abs = k_off + k0;
      // Keys of this tile at or past key_end are masked (the ragged tail).
      const int key_end = sk - k0;
      if constexpr (decltype(masked)::value) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int key = 8 * i + cq + j;
              const int row = wg_first + r_lo + 8 * h;
              if (key >= key_end || (causal && k_abs + key > row))
                s[4 * i + 2 * h + j] = NEG_INF;
            }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new =
            fmaxf(m[h], mx <= NEG_INF / 2 ? NEG_INF : mx * scale_log2);
        // m_safe keeps rows with no unmasked key so far at zero mass:
        // exp2(NEG_INF - 0) underflows to 0 for p and for alpha.
        const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
        alpha[h] = ex2(m[h] - m_safe);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[4 * i + 2 * h + j];
            x = ex2(fmaf(x, scale_log2, -m_safe));
            sum += x;
          }
        l[h] = l[h] * alpha[h] + sum;  // this thread's columns only
        m[h] = m_new;
      }
    };
    // O *= alpha per row, then P to 16 bits as the A operand: for key
    // columns 8 i .. 8 i + 7, k-slice i / 2, registers h (slice columns
    // 0-7) and 2 + h (columns 8-15).
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * i + 2 * h] *= alpha[h];
          acc[4 * i + 2 * h + 1] *= alpha[h];
        }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          pa[i / 2][(i % 2) * 2 + h] =
              pack2<T>(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]);
    };
    // Tile kt >= 1, pipelined: S of tile kt is issued ahead of O += P V of
    // tile kt - 1, and the softmax of tile kt runs while that product is
    // in flight.  Nothing between an issue and its wait branches.
    auto step = [&](int kt, auto masked) {
      const int st = kt % STAGES, ph = (kt / STAGES) & 1;
      const int pst = (kt - 1) % STAGES, pph = ((kt - 1) / STAGES) & 1;
      mbar_wait(k_full + 8 * st, ph);
      mbar_wait(v_full + 8 * pst, pph);
      pin(s);
      pin(acc);
      wg_fence();
      issue_qk(st);
      issue_pv(pst);
      wg_wait<1>();  // S of tile kt is in; P V of tile kt - 1 may run on
      pin(s);
      mbar_arrive_if(k_empty + 8 * st, tid == 0);
      softmax(kt, masked);
      wg_wait<0>();
      pin(acc);
      pin(pa);
      mbar_arrive_if(v_empty + 8 * pst, tid == 0);
      rescale_and_pack();
    };

    // Leading tiles need no mask; from the first that straddles the
    // diagonal or the ragged tail on, every live tile does.
    int n_plain = min(n_live, sk / BN);
    if (causal) {
      const int x = wg_first - k_off - BN + 1;  // k0 <= x: no key masked
      n_plain = min(n_plain, x < 0 ? 0 : x / BN + 1);
    }
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;
    if (n_live > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(k_full, 0);
      pin(s);
      wg_fence();
      issue_qk(0);
      wg_wait<0>();
      pin(s);
      mbar_arrive_if(k_empty, tid == 0);
      if (n_plain > 0)
        softmax(0, Plain{});
      else
        softmax(0, Masked{});
      rescale_and_pack();
    }
    for (int kt = 1; kt < n_plain; ++kt) step(kt, Plain{});
    for (int kt = max(n_plain, 1); kt < n_live; ++kt) step(kt, Masked{});
    if (n_live > 0) {
      const int st = (n_live - 1) % STAGES;
      mbar_wait(v_full + 8 * st, ((n_live - 1) / STAGES) & 1);
      pin(acc);
      wg_fence();
      issue_pv(st);
      wg_wait<0>();
      pin(acc);
      mbar_arrive_if(v_empty + 8 * st, tid == 0);
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

    // Finalize: o = O / l, lse = m + log l (POS_BIG, o = 0 where l == 0).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = q0 + row0 + r_lo + 8 * h;
      if (row >= sq) continue;
      const float inv = lt == 0.f ? 1.f : 1.f / lt;
      T* dst = o + ((size_t)bh * sq + row) * D + col0 + cq;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack2<T>(acc[4 * i + 2 * h] * inv, acc[4 * i + 2 * h + 1] * inv);
      // Both warpgroups of a column-split CTA hold the same l and m.
      if (lane % 4 == 0 && (!col_split<D>() || c == 0))
        lse[(size_t)bh * sq + row] =
            lt == 0.f ? POS_BIG : m[h] * LN2 + logf(lt);
    }
  }
}

// The three maps of one launch.
template <typename T, int D>
int make_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
              const void* q, const void* k, const void* v, int bh, int sq,
              int sk) {
  int e = make_map<T>(mq, q, bh, sq, D, fwd_rows<D>());
  if (e == 0) e = make_map<T>(mk, k, bh, sk, D, key_tile<D>());
  if (e == 0) e = make_map<T>(mv, v, bh, sk, D, key_tile<D>());
  return e;
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// The f32 body: 128 threads, one query tile of f32_tile<D>() rows (64; 32
// at head dim 256), key tiles of as many rows staged through shared
// memory, products by scalar FMA (mm_smem).
// ---------------------------------------------------------------------------

template <int D>
struct F32FwdSmem {
  using T = float;
  static constexpr int BM = f32_tile<D>(), BN = BM;  // square tiles
  static constexpr int LDT = D + PAD;   // q, k, v tiles
  static constexpr int LDP = BN + PAD;  // probabilities
  static constexpr int LDS = BN + 4;    // logits
  static constexpr int LDA = D + 4;     // output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + BM * LDT * sizeof(T));
  static constexpr size_t v = align128(k + BN * LDT * sizeof(T));
  static constexpr size_t p = align128(v + BN * LDT * sizeof(T));
  static constexpr size_t s = align128(p + BM * LDP * sizeof(T));
  static constexpr size_t acc = align128(s + BM * LDS * sizeof(float));
  static constexpr size_t m = align128(acc + BM * LDA * sizeof(float));
  static constexpr size_t l = m + BM * sizeof(float);
  static constexpr size_t alpha = l + BM * sizeof(float);
  static constexpr size_t bytes = alpha + BM * sizeof(float);
};

// Rows [q0, q0 + f32_tile<D>()) of one head; q, k, v, o already offset to
// the head.
template <int D>
__device__ __forceinline__ void fwd_tile_f32(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             float* __restrict__ o,
                                             float* __restrict__ lse, int q0,
                                             int sq, int sk, int q_off,
                                             int k_off, float scale_r,
                                             int causal) {
  using T = float;
  using L = F32FwdSmem<D>;
  constexpr int BM = L::BM, BN = L::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  T* Ps = reinterpret_cast<T*>(smem + L::p);
  float* S = reinterpret_cast<float*>(smem + L::s);
  float* Acc = reinterpret_cast<float*>(smem + L::acc);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);
  float* a_s = reinterpret_cast<float*>(smem + L::alpha);

  load_tile<D, BM>(Qs, L::LDT, q, q0, sq);
  for (int i = threadIdx.x; i < BM * L::LDA; i += NT) Acc[i] = 0.f;
  if (threadIdx.x < BM) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }

  int n_kt = (sk + BN - 1) / BN;
  if (causal) {
    const int lim = q_off + q0 + BM - 1 - k_off;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / BN + 1);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // previous tile's readers of Ks/Vs/Ps are done
    load_tile<D, BN>(Ks, L::LDT, k, k0, sk);
    load_tile<D, BN>(Vs, L::LDT, v, k0, sk);
    __syncthreads();
    mm_smem<BM, BN, D, true, false>(S, L::LDS, Qs, L::LDT, Ks, L::LDT);
    __syncthreads();
    // Online softmax, one warp per BM / 4 rows, BN / 32 columns per lane.
    for (int r = warp * (BM / 4); r < (warp + 1) * (BM / 4); ++r) {
      const int qpos = q_off + q0 + r;
      float sv[BN / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        float x = S[r * L::LDS + c] * scale_r;
        if (k0 + c >= sk || (causal && k_off + k0 + c > qpos)) x = NEG_INF;
        sv[j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const float p = expf(sv[j] - m_safe);
        Ps[r * L::LDP + lane + 32 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * D; i += NT) {
      const int r = i / D, c = i % D;
      Acc[r * L::LDA + c] *= a_s[r];
    }
    __syncthreads();
    mm_smem<BM, D, BN, false, true>(Acc, L::LDA, Ps, L::LDP, Vs, L::LDT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq) {
      const float l = l_s[r];
      o[(size_t)(q0 + r) * D + c] = Acc[r * L::LDA + c] / (l == 0.f ? 1.f : l);
    }
  }
  if (threadIdx.x < BM && q0 + threadIdx.x < sq) {
    const float l = l_s[threadIdx.x];
    lse[q0 + threadIdx.x] =
        l == 0.f ? POS_BIG : m_s[threadIdx.x] + logf(fmaxf(l, 1e-37f));
  }
}

}  // namespace hvdt
