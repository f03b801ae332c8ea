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
//   threads at 168 registers, sm90_common.cuh).
// * Head dim 256 (K1 only; any head dim from 129 runs zero-padded to
//   it): the same loop, 128 query rows a CTA, each consumer warpgroup its
//   64 rows and all 256 columns of O, so S = Q K^T (16 k16 slices from
//   shared memory) is computed once per (row, key) pair: 4 d FLOP of
//   tensor-core work a pair, the caller's (the column split this body
//   replaced computed S in both warpgroups, 6 d).  O takes 128 f32
//   registers a thread and O += P V runs as two N = 128 products a k16
//   slice; with S (FWD256_KEYS / 2) and P beside it in the pipelined loop
//   that is more than ptxas gives a thread of a 384-thread CTA (168:
//   ptxas allocates to the launch bound whatever setmaxnreg asks, and
//   spilled 1.2 KB here), so the CTA is the two consumer warpgroups
//   alone, 256 threads, up to 255 registers a thread (FOLD): thread 0 of
//   warpgroup 0 loads Q and the K tiles, thread 0 of warpgroup 1 the V
//   tiles, each into its stage once both warpgroups have released the
//   stage's previous tile, at the end of a step, where none of the
//   loader's own products is in flight (a branch there would serialize
//   them); a tile is loaded a whole step ahead of its use.  Shared memory:
//   Q + 2 stages of K and V, 64 + 128 KB at 64 keys (64 + 160 KB at 80,
//   under the 227 KB a CTA may hold).  Every consumer warp releases a
//   stage after its own wgmma wait (the empty barriers count the 8
//   consumer warps, as in flash_wide_sm90.cuh), where the narrower bodies
//   release once a warpgroup.
// * f32 inputs: K1's and K4's body is the 3xTF32 wgmma one of
//   flash_wide_f32_sm90.cuh (wide32::fwd_tile).
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
constexpr int FWD256_KEYS = 64;  // keys per tile at head dim 256

// Shared-memory layout of one CTA: a tile of R rows is D / PANEL panels of
// R x 64 bytes, each as TMA writes it with 64-byte swizzle.
// Keys per tile: 128 up to head dim 64; 64 above, where S, P and O of the
// pipelined loop would not fit the consumers' registers at 128; at 256
// FWD256_KEYS.
template <int D>
constexpr int key_tile() {
  return D == 256 ? FWD256_KEYS : D <= 64 ? 128 : 64;
}

// Threads per CTA: a producer warpgroup and two consumer warpgroups up to
// head dim 128; the consumers alone at 256, where they load too.
template <int D>
__host__ __device__ constexpr int fwd_threads() {
  return D == 256 ? 256 : NTHREADS;
}

template <int D>
struct Smem {
  static constexpr int BN = key_tile<D>();
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t Q_PANEL = BM * PANEL * 2;
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

// The 16-bit body: one CTA of fwd_threads<D>() threads computes rows
// [q0, q0 + BM) of head `bh`.  mq, mk, mv: tensor maps of q
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
  constexpr bool FOLD = D == 256;  // no producer warpgroup
  // Arrivals that release a K or V stage: one a consumer warpgroup (its
  // thread 0), or with FOLD one a consumer warp (its lane 0, after that
  // warp's own wgmma wait).
  constexpr int EMPTY_ARRIVALS = FOLD ? 8 : 2;
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
    const int lim = q_abs + BM - 1 - k_off;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / BN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, EMPTY_ARRIVALS);
      mbar_init(v_empty + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (!FOLD && wg == 0) {
    // Producer.  K and V of a stage are released apart: K once S = Q K^T
    // has read it, V once O += P V has.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && n_kt > 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      tma_tile<D>(q_s, mq, q_full, BM, q0, bh);
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
    // all columns of O.
    if constexpr (!FOLD)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
          CONSUMER_REGS));
    const int c = FOLD ? wg : wg - 1, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = c * WG_ROWS;                 // within the CTA
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

    float acc[D / 2];
    float s[BN / 2];        // S, then P in f32
    uint32_t pa[PV_STEPS][4];  // P as the A operand, per k16 slice
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // This warpgroup's share of releasing a stage (EMPTY_ARRIVALS).
    auto release = [&](uint32_t bar) {
      mbar_arrive_if(bar, FOLD ? lane == 0 : tid == 0);
    };
    // FOLD: key tile j's K (thread 0 of warpgroup 0) or V (of warpgroup 1)
    // into its stage, once both warpgroups have released the stage's
    // previous tile; called where no product of this warpgroup is in
    // flight.
    auto load = [&](int j, int loader, uint32_t tiles, uint32_t full,
                    uint32_t empty, const CUtensorMap* map) {
      if constexpr (FOLD) {
        if (c == loader && tid == 0 && j < n_kt) {
          const int st = j % STAGES;
          if (j >= STAGES) mbar_wait(empty + 8 * st, (j / STAGES - 1) & 1);
          mbar_expect_tx(full + 8 * st, L::KV_BYTES);
          tma_tile<D>(tiles + st * L::KV_BYTES, map, full + 8 * st, BN,
                      j * BN, bh);
        }
      }
    };
    auto load_k = [&](int j) { load(j, 0, k_s, k_full, k_empty, mk); };
    auto load_v = [&](int j) { load(j, 1, v_s, v_full, v_empty, mv); };
    if constexpr (FOLD) {
      if (c == 0 && tid == 0 && n_kt > 0) {
        mbar_expect_tx(q_full, L::Q_BYTES);
        tma_tile<D>(q_s, mq, q_full, BM, q0, bh);
      }
      for (int j = 0; j < STAGES; ++j) {
        load_k(j);
        load_v(j);
      }
    }

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
    // O += P V of stage st, issued (not waited for); at head dim 256 as
    // two N = 128 products, columns [0, 128) and [128, 256) (V's panels
    // 0-3 and 4-7).
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int j = 0; j < PV_STEPS; ++j) {
        const uint32_t vj = v_s + st * L::KV_BYTES + j * 16 * 64;
        if constexpr (D == 256) {
          Wgmma<128, T>::rs(part<64, 0>(acc), pa[j],
                            desc(vj, L::KV_PANEL, 512));
          Wgmma<128, T>::rs(part<64, 1>(acc), pa[j],
                            desc(vj + 4 * L::KV_PANEL, L::KV_PANEL, 512));
        } else {
          Wgmma<D, T>::rs(acc, pa[j], desc(vj, L::KV_PANEL, 512));
        }
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
      for (int i = 0; i < D / 8; ++i)
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
      release(k_empty + 8 * st);
      softmax(kt, masked);
      wg_wait<0>();
      pin(acc);
      pin(pa);
      release(v_empty + 8 * pst);
      rescale_and_pack();
      load_k(kt + STAGES);
      load_v(kt - 1 + STAGES);
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
      release(k_empty);
      if (n_plain > 0)
        softmax(0, Plain{});
      else
        softmax(0, Masked{});
      rescale_and_pack();
      load_k(STAGES);
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
      release(v_empty + 8 * st);
      load_v(n_live - 1 + STAGES);
    }
    // Tiles no row of this warpgroup sees: wait for each to land (so the
    // release below cannot complete an earlier use of its stage), release.
    for (int kt = n_live; kt < n_kt; ++kt) {
      const int st = kt % STAGES, ph = (kt / STAGES) & 1;
      mbar_wait(k_full + 8 * st, ph);
      mbar_wait(v_full + 8 * st, ph);
      release(k_empty + 8 * st);
      release(v_empty + 8 * st);
      load_k(kt + STAGES);
      load_v(kt + STAGES);
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
      T* dst = o + ((size_t)bh * sq + row) * D + cq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack2<T>(acc[4 * i + 2 * h] * inv, acc[4 * i + 2 * h + 1] * inv);
      if (lane % 4 == 0)
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
  int e = make_map<T>(mq, q, bh, sq, D, BM);
  if (e == 0) e = make_map<T>(mk, k, bh, sk, D, key_tile<D>());
  if (e == 0) e = make_map<T>(mv, v, bh, sk, D, key_tile<D>());
  return e;
}

}  // namespace sm90

}  // namespace hvdt
