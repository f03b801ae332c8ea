// K1, K2 and K3 above head dim 256 in 16 bits, for Hopper (sm_90a): the
// wgmma and TMA wide bodies of the flash forward (flash_fwd_wide) and of
// the split backward's dK/dV and dQ halves (flash_bwd_dkdv_wide,
// flash_bwd_dq_wide).  flash_wide.cu launches them for fp16 and bf16; in
// f32 K1 and K2 run 3xTF32 bodies (flash_wide_f32_sm90.cuh: one TF32
// product does not keep f32 to 1e-4, three do) and K3 a SIMT body.
//
// They replace the Pallas TPU kernels `_flash_kernel`
// (horovod_tpu/ops/attention.py:356, pallas_call :1047),
// `_flash_bwd_dkdv_kernel` (:429, pallas_call :914) and
// `_flash_bwd_dq_kernel` (:465, pallas_call :930, math in `_bwd_block_math`
// :386) at the head dims the reference computes above 256.  Semantics as
// the SIMT bodies' note in flash_wide.cu and the reference's (:320-335):
// masked logits NEG_INF, m_safe, alpha rescaling, l summed over unrounded
// p, lse = POS_BIG and o = 0 for rows with no key, p and dS rounded to the
// storage dtype before the products that take them, dQ summed in f32 and
// times dq_scale in f32 before the cast, a ragged tail zero-filled and
// masked.
//
// Bound on the card: by operations or bytes near the ridge (K1 4 d FLOP
// per causal pair against 8 d bytes per row, K2 8 d, K3 6 d), like the
// bodies up to 256.  What held the SIMT bodies at 0.2-1.0 % of that bound,
// and what this design does about each:
//  1. No tensor cores: every product was a scalar fmaf on operands the
//     threads converted to f32.  Here every product is a wgmma from
//     shared memory (S = Q K^T, S^T = K q'^T, dP^T = V dO^T, K3's S = q'
//     K^T and dP = dO V^T) or with P / dS as the register A operand (O +=
//     P V, dV += P^T dO, dK += dS^T q', dQ += dS K), f32 accumulators in
//     registers.
//  2. Synchronous loads that never overlapped the math: threads converted
//     every element into padded f32 tiles behind two __syncthreads() per
//     32-column chunk.  Here one producer warp issues TMA loads into rings
//     of stages under full/empty mbarrier pairs; the loads run ahead of
//     the two consumer warpgroups, which overlap each other's products and
//     elementwise steps.  A CTA is the two consumer warpgroups (threads
//     0-255) and that one warp, 288 threads, with no setmaxnreg: ptxas
//     held the consumers to 168 registers a thread either way, and with a
//     whole producer warpgroup handing its registers over K2 spilled twice
//     the bytes.
//  3. S (and dP) recomputed per 128-column output block, ceil(d / 128)
//     times, 128 + 128 + 32 at 288.  Here a CTA owns a window of NP output
//     panels (K1 4, 128 columns; K2 3, 96 columns, so that dK and dV fit
//     the registers beside S^T and dP^T; K3 4) and computes S once for it:
//     its two consumer warpgroups split the rows (queries in K1 and K3,
//     keys in K2), not the columns.  The column CTAs of a tile own
//     balanced shares of the d / 32 panels (3 + 3 + 3 at 288), each at
//     least 2 panels; a share short of NP panels shifts its window left
//     inside the head dim and stores its own panels alone.  S recompute
//     per row: K1 and K3 ceil(d / 128) (3 at 288, 4 at 512, 8 at 1024), K2
//     ceil(d / 96) (3, 6, 11); so K1 does ceil(d / 128) (2 d + 256) FLOP
//     per pair against the caller's 4 d (2.2x at 288, 2.5x at 512, 4.6x at
//     1000 run as 1024), K2 ceil(d / 96) (4 d + 384) against 8 d (2.0x,
//     3.6x, 6.2x) and K3 ceil(d / 128) (4 d + 256) against 6 d (2.4x,
//     3.0x, 5.8x).
//  4. 64 x 64 tiles, 256 threads, 4 x 4 thread tiles: few FMAs per shared
//     read.  Here 128-row (K1, K3) and 128-key (K2) CTAs, 64 rows per
//     consumer warpgroup, m64n128k16 (K1's S, O; K3's dQ), m64n64k16
//     (K3's S, dP) and m64n32k16 / m64n96k16 (K2's S^T, dP^T / dV, dK)
//     products.  K2 steps over the queries 32 rows at a time, so that S^T
//     and dP^T take 32 registers beside dK's and dV's 96: 64-row steps, or
//     4-panel windows, spilled and ran 2x slower.  K3 takes 64-key tiles:
//     S and dP 32 registers each, the packed dS 16 and dQ 64, 128 beside
//     the addresses, so ptxas spills 32 B and serializes the products
//     (C7512).  Kept all the same: 32-key tiles (135 registers) and
//     3-panel windows (162) build clean but ran 1.3-1.4x slower at 512
//     and 1024 (tools/torch_split_variants.py --family wide): every key
//     tile re-streams the CTA's 128 rows of q' and dO from L2 (44 FLOP a
//     byte at 64 keys, half that at 32), and at 64 keys K3 already moves
//     4.9-6.5 TB/s of it (PERF.md).
//
// Shared memory is the constraint at these widths (a 64-row bf16 tile of
// the whole head dim is 128 KB at 1024), so neither side of S stays
// resident: the (Q, K) chunks of S, K2's (K, V, q', dO) chunks of S^T and
// dP^T, and K3's (q', dO, K, V) chunks of S and dP stream through a ring
// of TMA stages in CHUNK_PANELS panels of 32 head-dim columns (a last
// chunk of one panel where d / 32 is odd), and S (and dP) accumulate
// across the chunks in f32 registers with wgmma's scale-d (the first chunk
// overwrites, the rest add).  Every CTA of a tile runs the same products
// in the same chunk order, so the column CTAs agree bit for bit on m and
// l, and only the first writes lse.  A wgmma group is waited for before
// the next barrier wait, so no branch lies between an issue and its wait
// (ptxas would serialize the products, C7520); the causal / ragged mask is
// a second copy of the elementwise step.
//
// Tiles sit in shared memory as 64-byte-swizzle panels (sm90_common.cuh),
// loaded through 3-D tensor maps over (d, s, bh) with d a run-time
// multiple of 32 (a 2 d byte row stride, 16-byte aligned as TMA needs).
// Grids are 1-D, (tiles x column CTAs x bh) blocks, heavy tiles first.
// Shared memory: K1 3 (Q, K) stages of 32 KB + 2 V stages of 32 KB = 160
// KB; K2 3 (K, V, q', dO) stages of 40 KB + 2 (q', dO) column stages of
// 12 KB and their lse / delta = 144 KB; K3 3 (q', dO, K, V) stages of 48
// KB + 2 K windows of 16 KB = 176 KB.  Under a causal mask, key tiles
// wholly past a tile's last row are neither loaded nor computed (K1, K3),
// nor query tiles wholly before a key tile's first key (K2); a K3
// warpgroup whose rows see none of a loaded key tile waits for its stages
// and releases them.  Each consumer warp's lane 0 releases a stage after
// that warp's own wgmma wait (the empty barriers count the 8 consumer
// warps), so a stage is refilled only when no warp still reads it.  Every
// mbarrier wait traps after 2 s.

#pragma once

#include "sm90_common.cuh"

namespace hvdt {
namespace wide90 {

using namespace sm90;

constexpr int CHUNK_PANELS = 2;  // head-dim panels per chunk of S (64 cols)
// Two consumer warpgroups, threads 0-255, then the producer warp.
constexpr int WIDE_THREADS = 2 * 128 + 32;

// This thread's warpgroup (2: the producer warp), broadcast from lane 0 so
// that ptxas sees a warp-uniform value: every branch on it, or on what
// derives from it, is then uniform, and no wgmma sits on a path it takes
// for divergent (C7520: the products would be serialized).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// K1: query rows per CTA (64 per consumer warpgroup), keys per tile.
constexpr int FWD_ROWS = 128;
constexpr int FWD_KEYS = 128;
constexpr int FWD_NP = 4;       // output panels per CTA (128 columns)
constexpr int FWD_STAGES = 3;   // (Q, K) chunks in flight
constexpr int FWD_VSTAGES = 2;  // V windows in flight
// K2: keys per CTA (64 per consumer warpgroup), query rows per step.
constexpr int DKDV_KEYS = 128;
constexpr int DKDV_ROWS = 32;
constexpr int DKDV_NP = 3;       // output panels per CTA (96 columns)
constexpr int DKDV_STAGES = 3;   // (K, V, q', dO) chunks in flight
constexpr int DKDV_CSTAGES = 2;  // (q', dO) column windows in flight
// K3: query rows per CTA (64 per consumer warpgroup), keys per tile.
constexpr int DQ_ROWS = 128;
constexpr int DQ_KEYS = 64;
constexpr int DQ_NP = 4;       // output panels per CTA (128 columns)
constexpr int DQ_STAGES = 3;   // (q', dO, K, V) chunks in flight
constexpr int DQ_KSTAGES = 2;  // K windows in flight

constexpr uint32_t PANEL_ROW = PANEL * 2;  // bytes per row of a panel

// A stage is released by each consumer warp's lane 0 after that warp's own
// wgmma wait, so the empty barriers count the 8 consumer warps: no warp
// can still be reading a stage that the producer refills.
constexpr int EMPTY_ARRIVALS = 8;
__device__ __forceinline__ void release(uint32_t bar) {
  mbar_arrive_if(bar, threadIdx.x % 32 == 0);
}

// Column CTAs per tile when each computes a window of NP panels: the
// fewest that cover the head dim's d / 32 panels.
template <int NP>
__host__ __device__ inline int col_ctas(int d) {
  return (d / PANEL + NP - 1) / NP;
}
// Column CTA cc's balanced share: `own` panels from `start`, inside the
// NP-panel window from `w0` that it computes (d / 32 > NP above 256).
struct Cols {
  int start, own, w0;
};
template <int NP>
__device__ __forceinline__ Cols col_share(int d, int cc) {
  const int panels = d / PANEL, n_cc = col_ctas<NP>(d);
  const int base = panels / n_cc, extra = panels % n_cc;
  Cols c;
  c.own = base + (cc < extra);
  c.start = cc * base + min(cc, extra);
  c.w0 = min(c.start, panels - NP);
  return c;
}

struct FwdSmem {
  static constexpr uint32_t Q_PANEL = FWD_ROWS * PANEL_ROW;  // 8 KB
  static constexpr uint32_t K_PANEL = FWD_KEYS * PANEL_ROW;  // 8 KB
  static constexpr uint32_t A_BYTES = CHUNK_PANELS * (Q_PANEL + K_PANEL);
  static constexpr uint32_t V_BYTES = FWD_NP * K_PANEL;
  static constexpr uint32_t a = 0;  // stage s: Q panels, then K panels
  static constexpr uint32_t v = a + FWD_STAGES * A_BYTES;
  static constexpr uint32_t bars = v + FWD_VSTAGES * V_BYTES;
  // a_full, a_empty [FWD_STAGES], v_full, v_empty [FWD_VSTAGES]
  static constexpr uint32_t N_BARS = 2 * FWD_STAGES + 2 * FWD_VSTAGES;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K1: o's own columns and (column CTA 0) lse of query rows [q0, q0 +
// FWD_ROWS) of head bh.  mq: map of q' (bh, sq, d), boxes of FWD_ROWS
// rows; mk, mv: k, v (bh, sk, d), boxes of FWD_KEYS rows.
template <typename T>
__device__ __forceinline__ void fwd_tile(const CUtensorMap* mq,
                                         const CUtensorMap* mk,
                                         const CUtensorMap* mv, T* o,
                                         float* lse, int bh, int cc, int q0,
                                         int sq, int sk, int d,
                                         float scale_r, int causal) {
  using L = FwdSmem;
  constexpr int BN = FWD_KEYS, NP = FWD_NP, CW = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_full = base + L::bars, a_empty = a_full + 8 * FWD_STAGES;
  const uint32_t v_full = a_empty + 8 * FWD_STAGES;
  const uint32_t v_empty = v_full + 8 * FWD_VSTAGES;
  const int panels = d / PANEL;
  const int n_ch = (panels + CHUNK_PANELS - 1) / CHUNK_PANELS;
  const Cols cols = col_share<NP>(d, cc);

  int n_kt = (sk + BN - 1) / BN;
  // Key tiles past the CTA's last row are wholly masked.
  if (causal) n_kt = min(n_kt, (q0 + FWD_ROWS - 1) / BN + 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, EMPTY_ARRIVALS);
    }
#pragma unroll
    for (int s = 0; s < FWD_VSTAGES; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {
    // Producer: per key tile, the (Q, K) chunks of S, then the V window.
    if (threadIdx.x == 256) {
      int g = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        for (int ch = 0; ch < n_ch; ++ch, ++g) {
          const int st = g % FWD_STAGES;
          if (g >= FWD_STAGES)
            mbar_wait(a_empty + 8 * st, (g / FWD_STAGES - 1) & 1);
          const int np = min(CHUNK_PANELS, panels - ch * CHUNK_PANELS);
          const uint32_t sa = base + L::a + st * L::A_BYTES;
          mbar_expect_tx(a_full + 8 * st, np * (L::Q_PANEL + L::K_PANEL));
          for (int p = 0; p < np; ++p) {
            const int col = (ch * CHUNK_PANELS + p) * PANEL;
            tma_load(sa + p * L::Q_PANEL, mq, a_full + 8 * st, col, q0, bh);
            tma_load(sa + CHUNK_PANELS * L::Q_PANEL + p * L::K_PANEL, mk,
                     a_full + 8 * st, col, kt * BN, bh);
          }
        }
        const int vs = kt % FWD_VSTAGES;
        if (kt >= FWD_VSTAGES)
          mbar_wait(v_empty + 8 * vs, (kt / FWD_VSTAGES - 1) & 1);
        mbar_expect_tx(v_full + 8 * vs, L::V_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::v + vs * L::V_BYTES + p * L::K_PANEL, mv,
                   v_full + 8 * vs, (cols.w0 + p) * PANEL, kt * BN, bh);
      }
    }
  } else {
    // Consumers: warpgroup c owns rows [q0 + 64 c, q0 + 64 c + 64) and the
    // CTA's window of O's columns.
    const int c = wg, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = c * 64;                      // within the CTA
    const int wg_first = q0 + row0;
    const float scale_log2 = scale_r * LOG2E;
    constexpr int PV_STEPS = BN / 16;

    float acc[CW / 2];
    float s[BN / 2];           // S, then P in f32
    uint32_t pa[PV_STEPS][4];  // P as the A operand, per k16 slice
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;

    // S (+)= Q K^T over the chunk's NPANEL panels of stage st.
    auto issue_qk = [&](uint32_t sa, bool first, auto npanel) {
      constexpr int STEPS = decltype(npanel)::value * 2;
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
        const uint64_t qa = desc(
            sa + (kk / 2) * L::Q_PANEL + row0 * PANEL_ROW + off, 16, 512);
        const uint64_t kb = desc(sa + CHUNK_PANELS * L::Q_PANEL +
                                     (kk / 2) * L::K_PANEL + off,
                                 16, 512);
        Wgmma<BN, T>::ss(s, qa, kb, !(first && kk == 0));
      }
      wg_commit();
      wg_wait<0>();
    };
    // Online softmax of key tile kt in log2 units, rows r_lo (h = 0) and
    // r_lo + 8: m, l and alpha updated, p left in s.
    auto softmax = [&](int kt, auto masked) {
      const int k0 = kt * BN;
      const int key_end = sk - k0;  // keys at or past it: the ragged tail
      if constexpr (decltype(masked)::value) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int key = 8 * i + cq + j;
              const int row = wg_first + r_lo + 8 * h;
              if (key >= key_end || (causal && k0 + key > row))
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
        // m_safe keeps rows with no unmasked key so far at zero mass.
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

    // Leading tiles need no mask; from the first that straddles the
    // diagonal or the ragged tail on, every tile does.
    int n_plain = min(n_kt, sk / BN);
    if (causal) {
      const int x = wg_first - BN + 1;  // k0 <= x: no key masked
      n_plain = min(n_plain, x < 0 ? 0 : x / BN + 1);
    }
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;
    using One = std::integral_constant<int, 1>;
    using Full = std::integral_constant<int, CHUNK_PANELS>;

    int g = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % FWD_STAGES;
        mbar_wait(a_full + 8 * st, (g / FWD_STAGES) & 1);
        const uint32_t sa = base + L::a + st * L::A_BYTES;
        pin(s);
        wg_fence();
        if (panels - ch * CHUNK_PANELS < CHUNK_PANELS)
          issue_qk(sa, ch == 0, One{});
        else
          issue_qk(sa, ch == 0, Full{});
        pin(s);
        release(a_empty + 8 * st);
      }
      if (kt < n_plain)
        softmax(kt, Plain{});
      else
        softmax(kt, Masked{});
      // O *= alpha per row, then P to 16 bits as the A operand: key
      // columns 8 i .. 8 i + 7 are k-slice i / 2, registers h (slice
      // columns 0-7) and 2 + h (columns 8-15).
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
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
      // O += P V over the CTA's window (V read MN-major, as it arrived).
      const int vs = kt % FWD_VSTAGES;
      mbar_wait(v_full + 8 * vs, (kt / FWD_VSTAGES) & 1);
      const uint32_t sv = base + L::v + vs * L::V_BYTES;
      pin(acc);
      wg_fence();
#pragma unroll
      for (int j = 0; j < PV_STEPS; ++j)
        Wgmma<CW, T>::rs(acc, pa[j],
                         desc(sv + j * 16 * PANEL_ROW, L::K_PANEL, 512));
      wg_commit();
      wg_wait<0>();
      pin(acc);
      pin(pa);
      release(v_empty + 8 * vs);
    }

    // Finalize: o = O / l on the own columns, lse = m + log l (POS_BIG,
    // o = 0 where l == 0) from column CTA 0.
    const int own0 = (cols.start - cols.w0) * PANEL;
    const int own1 = own0 + cols.own * PANEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = wg_first + r_lo + 8 * h;
      if (row >= sq) continue;
      const float inv = lt == 0.f ? 1.f : 1.f / lt;
      T* dst = o + ((size_t)bh * sq + row) * d + cols.w0 * PANEL + cq;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
        if (8 * i >= own0 && 8 * i < own1)
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              pack2<T>(acc[4 * i + 2 * h] * inv,
                       acc[4 * i + 2 * h + 1] * inv);
      if (lane % 4 == 0 && cc == 0)
        lse[(size_t)bh * sq + row] =
            lt == 0.f ? POS_BIG : m[h] * LN2 + logf(lt);
    }
  }
}

struct DkdvSmem {
  static constexpr uint32_t K_PANEL = DKDV_KEYS * PANEL_ROW;  // 8 KB
  static constexpr uint32_t Q_PANEL = DKDV_ROWS * PANEL_ROW;  // 2 KB
  // Stage s of the chunk ring: K, V, q', dO panels of the chunk.
  static constexpr uint32_t A_K = 0;
  static constexpr uint32_t A_V = A_K + CHUNK_PANELS * K_PANEL;
  static constexpr uint32_t A_Q = A_V + CHUNK_PANELS * K_PANEL;
  static constexpr uint32_t A_DO = A_Q + CHUNK_PANELS * Q_PANEL;
  static constexpr uint32_t A_BYTES = A_DO + CHUNK_PANELS * Q_PANEL;
  // Stage s of the column ring: the window's q', then dO panels.
  static constexpr uint32_t C_BYTES = 2 * DKDV_NP * Q_PANEL;
  static constexpr uint32_t STAT_FLOATS = 2 * DKDV_ROWS;  // lse, delta
  static constexpr uint32_t a = 0;
  static constexpr uint32_t c = a + DKDV_STAGES * A_BYTES;
  static constexpr uint32_t stats = c + DKDV_CSTAGES * C_BYTES;
  static constexpr uint32_t bars = stats + DKDV_CSTAGES * STAT_FLOATS * 4;
  // a_full, a_empty [DKDV_STAGES], c_full, c_empty [DKDV_CSTAGES]
  static constexpr uint32_t N_BARS = 2 * DKDV_STAGES + 2 * DKDV_CSTAGES;
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K2: dK's and dV's own columns of keys [k0, k0 + DKDV_KEYS) of head bh.
// mq, mdo: maps of q', dO (bh, sq, d), boxes of DKDV_ROWS rows; mk, mv: k,
// v (bh, sk, d), boxes of DKDV_KEYS rows.  lse, delta: (bh, sq) f32.
template <typename T>
__device__ __forceinline__ void dkdv_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int bh, int cc, int k0, int sq, int sk, int d, float scale_r,
    int causal) {
  using L = DkdvSmem;
  constexpr int QB = DKDV_ROWS, NP = DKDV_NP, CW = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  float* const stats = reinterpret_cast<float*>(gbase + L::stats);
  const uint32_t a_full = base + L::bars, a_empty = a_full + 8 * DKDV_STAGES;
  const uint32_t c_full = a_empty + 8 * DKDV_STAGES;
  const uint32_t c_empty = c_full + 8 * DKDV_CSTAGES;
  const int panels = d / PANEL;
  const int n_ch = (panels + CHUNK_PANELS - 1) / CHUNK_PANELS;
  const Cols cols = col_share<NP>(d, cc);

  // Query tiles that see a key of this CTA: under a causal mask, from the
  // first whose last row reaches the CTA's first key (reference:
  // `q_start + block_q - 1 >= k_start`).
  const int n_qt = (sq + QB - 1) / QB;
  int qt0 = 0;
  if (causal) {
    const int need = k0 - QB + 1;
    qt0 = need <= 0 ? 0 : (need + QB - 1) / QB;
  }
  const int n_it = max(0, n_qt - qt0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < DKDV_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, EMPTY_ARRIVALS);
    }
#pragma unroll
    for (int s = 0; s < DKDV_CSTAGES; ++s) {
      mbar_init(c_full + 8 * s, 1 + 32);  // the TMA lane + the warp's stats
      mbar_init(c_empty + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {
    // Producer warp: lane 0 issues the TMA loads (per query tile the
    // chunks of S^T and dP^T, then the column window of q' and dO), and
    // every lane copies lse and delta beside the window.  All lanes wait
    // for the stages to be released.
    const int lane = threadIdx.x % 32;
    const size_t row0 = (size_t)bh * sq;
    int g = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * QB;
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % DKDV_STAGES;
        if (g >= DKDV_STAGES)
          mbar_wait(a_empty + 8 * st, (g / DKDV_STAGES - 1) & 1);
        if (lane == 0) {
          const int np = min(CHUNK_PANELS, panels - ch * CHUNK_PANELS);
          const uint32_t sa = base + L::a + st * L::A_BYTES;
          const uint32_t bar = a_full + 8 * st;
          mbar_expect_tx(bar, np * 2 * (L::K_PANEL + L::Q_PANEL));
          for (int p = 0; p < np; ++p) {
            const int col = (ch * CHUNK_PANELS + p) * PANEL;
            tma_load(sa + L::A_K + p * L::K_PANEL, mk, bar, col, k0, bh);
            tma_load(sa + L::A_V + p * L::K_PANEL, mv, bar, col, k0, bh);
            tma_load(sa + L::A_Q + p * L::Q_PANEL, mq, bar, col, q0, bh);
            tma_load(sa + L::A_DO + p * L::Q_PANEL, mdo, bar, col, q0, bh);
          }
        }
      }
      const int cs = it % DKDV_CSTAGES;
      if (it >= DKDV_CSTAGES)
        mbar_wait(c_empty + 8 * cs, (it / DKDV_CSTAGES - 1) & 1);
      if (lane == 0) {
        const uint32_t sc = base + L::c + cs * L::C_BYTES;
        mbar_expect_tx(c_full + 8 * cs, L::C_BYTES);
        for (int p = 0; p < NP; ++p) {
          const int col = (cols.w0 + p) * PANEL;
          tma_load(sc + p * L::Q_PANEL, mq, c_full + 8 * cs, col, q0, bh);
          tma_load(sc + (NP + p) * L::Q_PANEL, mdo, c_full + 8 * cs, col,
                   q0, bh);
        }
      }
      float* sl = stats + cs * L::STAT_FLOATS;
      for (int r = lane; r < QB; r += 32) {
        const int row = q0 + r;
        sl[r] = row < sq ? lse[row0 + row] : POS_BIG;
        sl[QB + r] = row < sq ? delta[row0 + row] : 0.f;
      }
      mbar_arrive(c_full + 8 * cs);
    }
  } else {
    // Consumers: warpgroup c owns keys [k0 + 64 c, k0 + 64 c + 64) and the
    // CTA's window of dK's and dV's columns.
    const int c = wg, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int key_row0 = c * 64;                  // within the CTA's keys
    const int key_first = k0 + key_row0;
    const float scale_log2 = scale_r * LOG2E;
    constexpr int Q_SLICES = QB / 16;

    float dk_acc[CW / 2], dv_acc[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float s[QB / 2], dp[QB / 2];  // S^T, dP^T: this warpgroup's keys x QB

    // S^T (+)= K q'^T and dP^T (+)= V dO^T over the chunk's panels.
    auto issue_chunk = [&](uint32_t sa, bool first, auto npanel) {
      constexpr int STEPS = decltype(npanel)::value * 2;
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        const uint32_t off = (kk % 2) * 32;
        const uint32_t kp = (kk / 2) * L::K_PANEL + key_row0 * PANEL_ROW + off;
        const uint32_t qp = (kk / 2) * L::Q_PANEL + off;
        const int scale_d = !(first && kk == 0);
        Wgmma<QB, T>::ss(s, desc(sa + L::A_K + kp, 16, 512),
                         desc(sa + L::A_Q + qp, 16, 512), scale_d);
        Wgmma<QB, T>::ss(dp, desc(sa + L::A_V + kp, 16, 512),
                         desc(sa + L::A_DO + qp, 16, 512), scale_d);
      }
      wg_commit();
      wg_wait<0>();
    };
    // p and dS of one query tile in place of S^T and dP^T: rows are this
    // warpgroup's keys r_lo (h = 0) and r_lo + 8, columns the tile's
    // queries.  Rows past sq carry lse POS_BIG, so p is 0 there.
    auto grads = [&](const float* sl, int q0, auto masked) {
#pragma unroll
      for (int i = 0; i < QB / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = 8 * i + cq + j;
          const float lse2 = sl[qc] * LOG2E, dl = sl[QB + qc];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * i + 2 * h + j;
            float p = ex2(fmaf(s[e], scale_log2, -lse2));
            if constexpr (decltype(masked)::value) {
              const int kr = key_first + r_lo + 8 * h;
              if (kr >= sk || (causal && kr > q0 + qc)) p = 0.f;
            }
            dp[e] = p * (dp[e] - dl) * scale_r;
            s[e] = p;
          }
        }
    };
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;
    using One = std::integral_constant<int, 1>;
    using Full = std::integral_constant<int, CHUNK_PANELS>;

    int g = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * QB;
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % DKDV_STAGES;
        mbar_wait(a_full + 8 * st, (g / DKDV_STAGES) & 1);
        const uint32_t sa = base + L::a + st * L::A_BYTES;
        pin(s);
        pin(dp);
        wg_fence();
        if (panels - ch * CHUNK_PANELS < CHUNK_PANELS)
          issue_chunk(sa, ch == 0, One{});
        else
          issue_chunk(sa, ch == 0, Full{});
        pin(s);
        pin(dp);
        release(a_empty + 8 * st);
      }
      const int cs = it % DKDV_CSTAGES;
      mbar_wait(c_full + 8 * cs, (it / DKDV_CSTAGES) & 1);
      const float* sl = stats + cs * L::STAT_FLOATS;
      const bool masked = key_first + 64 > sk ||
                          (causal && key_first + 63 > q0);
      if (masked)
        grads(sl, q0, Masked{});
      else
        grads(sl, q0, Plain{});

      // P^T and dS^T to 16 bits as A operands: query columns 8 i .. 8 i +
      // 7 are k-slice i / 2, registers h and 2 + h.
      uint32_t pa[Q_SLICES][4], dsa[Q_SLICES][4];
#pragma unroll
      for (int i = 0; i < QB / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[i / 2][(i % 2) * 2 + h] =
              pack2<T>(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]);
          dsa[i / 2][(i % 2) * 2 + h] =
              pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);
        }
      // dV += P^T dO and dK += dS^T q' over the window (dO and q' read
      // MN-major, as they arrived).
      const uint32_t sc = base + L::c + cs * L::C_BYTES;
      pin(dk_acc);
      pin(dv_acc);
      wg_fence();
#pragma unroll
      for (int j = 0; j < Q_SLICES; ++j)
        Wgmma<CW, T>::rs(dv_acc, pa[j],
                         desc(sc + NP * L::Q_PANEL + j * 16 * PANEL_ROW,
                              L::Q_PANEL, 512));
#pragma unroll
      for (int j = 0; j < Q_SLICES; ++j)
        Wgmma<CW, T>::rs(dk_acc, dsa[j],
                         desc(sc + j * 16 * PANEL_ROW, L::Q_PANEL, 512));
      wg_commit();
      wg_wait<0>();
      pin(dk_acc);
      pin(dv_acc);
      pin(pa);
      pin(dsa);
      release(c_empty + 8 * cs);
    }

    // dK and dV of this warpgroup's keys, on the own columns.
    const int own0 = (cols.start - cols.w0) * PANEL;
    const int own1 = own0 + cols.own * PANEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_first + r_lo + 8 * h;
      if (key >= sk) continue;
      const size_t at = ((size_t)bh * sk + key) * d + cols.w0 * PANEL + cq;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
        if (8 * i >= own0 && 8 * i < own1) {
          const int e = 4 * i + 2 * h;
          *reinterpret_cast<uint32_t*>(dk + at + 8 * i) =
              pack2<T>(dk_acc[e], dk_acc[e + 1]);
          *reinterpret_cast<uint32_t*>(dv + at + 8 * i) =
              pack2<T>(dv_acc[e], dv_acc[e + 1]);
        }
    }
  }
}

struct DqSmem {
  static constexpr uint32_t Q_PANEL = DQ_ROWS * PANEL_ROW;  // 8 KB
  static constexpr uint32_t K_PANEL = DQ_KEYS * PANEL_ROW;  // 4 KB
  // Stage s of the chunk ring: q', dO, K, V panels of the chunk.
  static constexpr uint32_t A_Q = 0;
  static constexpr uint32_t A_DO = A_Q + CHUNK_PANELS * Q_PANEL;
  static constexpr uint32_t A_K = A_DO + CHUNK_PANELS * Q_PANEL;
  static constexpr uint32_t A_V = A_K + CHUNK_PANELS * K_PANEL;
  static constexpr uint32_t A_BYTES = A_V + CHUNK_PANELS * K_PANEL;
  // Stage s of the window ring: K's panels of the CTA's window.
  static constexpr uint32_t W_BYTES = DQ_NP * K_PANEL;
  static constexpr uint32_t a = 0;
  static constexpr uint32_t w = a + DQ_STAGES * A_BYTES;
  static constexpr uint32_t bars = w + DQ_KSTAGES * W_BYTES;
  // a_full, a_empty [DQ_STAGES], w_full, w_empty [DQ_KSTAGES]
  static constexpr uint32_t N_BARS = 2 * DQ_STAGES + 2 * DQ_KSTAGES;
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K3: dq's own columns of query rows [q0, q0 + DQ_ROWS) of head bh, in q
// units (dQ times dq_scale in f32 before the cast).  mq, mdo: maps of q',
// dO (bh, sq, d), boxes of DQ_ROWS rows; mk, mv: k, v (bh, sk, d), boxes
// of DQ_KEYS rows.  lse, delta: (bh, sq) f32.
template <typename T>
__device__ __forceinline__ void dq_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int bh, int cc,
    int q0, int sq, int sk, int d, float scale_r, float dq_scale,
    int causal) {
  using L = DqSmem;
  constexpr int BN = DQ_KEYS, NP = DQ_NP, CW = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_full = base + L::bars, a_empty = a_full + 8 * DQ_STAGES;
  const uint32_t w_full = a_empty + 8 * DQ_STAGES;
  const uint32_t w_empty = w_full + 8 * DQ_KSTAGES;
  const int panels = d / PANEL;
  const int n_ch = (panels + CHUNK_PANELS - 1) / CHUNK_PANELS;

  int n_kt = (sk + BN - 1) / BN;
  // Causal: key tiles that start past the CTA's last row are wholly
  // masked (reference: `k_start <= q_start + block_q - 1`).
  if (causal) n_kt = min(n_kt, (q0 + DQ_ROWS - 1) / BN + 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, EMPTY_ARRIVALS);
    }
#pragma unroll
    for (int s = 0; s < DQ_KSTAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {
    // Producer: per key tile, the (q', dO, K, V) chunks of S and dP, then
    // the K window of dQ += dS K.
    if (threadIdx.x == 256) {
      const Cols cols = col_share<NP>(d, cc);
      int g = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BN;
        for (int ch = 0; ch < n_ch; ++ch, ++g) {
          const int st = g % DQ_STAGES;
          if (g >= DQ_STAGES)
            mbar_wait(a_empty + 8 * st, (g / DQ_STAGES - 1) & 1);
          const int np = min(CHUNK_PANELS, panels - ch * CHUNK_PANELS);
          const uint32_t sa = base + L::a + st * L::A_BYTES;
          const uint32_t bar = a_full + 8 * st;
          mbar_expect_tx(bar, np * 2 * (L::Q_PANEL + L::K_PANEL));
          for (int p = 0; p < np; ++p) {
            const int col = (ch * CHUNK_PANELS + p) * PANEL;
            tma_load(sa + L::A_Q + p * L::Q_PANEL, mq, bar, col, q0, bh);
            tma_load(sa + L::A_DO + p * L::Q_PANEL, mdo, bar, col, q0, bh);
            tma_load(sa + L::A_K + p * L::K_PANEL, mk, bar, col, k0, bh);
            tma_load(sa + L::A_V + p * L::K_PANEL, mv, bar, col, k0, bh);
          }
        }
        const int ws = kt % DQ_KSTAGES;
        if (kt >= DQ_KSTAGES)
          mbar_wait(w_empty + 8 * ws, (kt / DQ_KSTAGES - 1) & 1);
        mbar_expect_tx(w_full + 8 * ws, L::W_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::w + ws * L::W_BYTES + p * L::K_PANEL, mk,
                   w_full + 8 * ws, (cols.w0 + p) * PANEL, k0, bh);
      }
    }
  } else {
    // Consumers: warpgroup c owns rows [q0 + 64 c, q0 + 64 c + 64) and the
    // CTA's window of dQ's columns.
    const int c = wg, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = c * 64;                      // within the CTA
    const int wg_first = q0 + row0;
    const float scale_log2 = scale_r * LOG2E;
    constexpr int DQ_STEPS = BN / 16;
    // Key tiles with a key some row of this warpgroup sees: the rest (a
    // causal suffix, or all where the rows lie past sq) only pass through
    // the barriers.
    int n_live = wg_first < sq ? n_kt : 0;
    if (causal) n_live = min(n_live, (wg_first + 63) / BN + 1);

    // lse in log2 units and delta of rows r_lo (h = 0) and r_lo + 8; rows
    // past sq carry POS_BIG, so p is 0 there.
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg_first + r_lo + 8 * h;
      const size_t at = (size_t)bh * sq + row;
      lse2[h] = (row < sq ? lse[at] : POS_BIG) * LOG2E;
      dl[h] = row < sq ? delta[at] : 0.f;
    }

    float acc[CW / 2];
    float s[BN / 2], dp[BN / 2];  // S and dP, then p and dS in f32
    uint32_t dsa[DQ_STEPS][4];    // dS as the A operand, per k16 slice
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;

    // S (+)= q' K^T and dP (+)= dO V^T over the chunk's panels.
    auto issue_chunk = [&](uint32_t sa, bool first, auto npanel) {
      constexpr int STEPS = decltype(npanel)::value * 2;
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
        const uint32_t qp = (kk / 2) * L::Q_PANEL + row0 * PANEL_ROW + off;
        const uint32_t kp = (kk / 2) * L::K_PANEL + off;
        const int scale_d = !(first && kk == 0);
        Wgmma<BN, T>::ss(s, desc(sa + L::A_Q + qp, 16, 512),
                         desc(sa + L::A_K + kp, 16, 512), scale_d);
        Wgmma<BN, T>::ss(dp, desc(sa + L::A_DO + qp, 16, 512),
                         desc(sa + L::A_V + kp, 16, 512), scale_d);
      }
      wg_commit();
      wg_wait<0>();
    };
    // p and dS of key tile kt in place of dP, rows r_lo (h = 0) and r_lo +
    // 8, columns the tile's keys.  The mask is compiled in only for tiles
    // that straddle the diagonal or the ragged tail (`masked`).
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

    // Leading tiles need no mask; from the first that straddles the
    // diagonal or the ragged tail on, every live tile does.
    int n_plain = min(n_live, sk / BN);
    if (causal) {
      const int x = wg_first - BN + 1;  // k0 <= x: no key masked
      n_plain = min(n_plain, x < 0 ? 0 : x / BN + 1);
    }
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;
    using One = std::integral_constant<int, 1>;
    using Full = std::integral_constant<int, CHUNK_PANELS>;

    int g = 0;
    for (int kt = 0; kt < n_live; ++kt) {
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % DQ_STAGES;
        mbar_wait(a_full + 8 * st, (g / DQ_STAGES) & 1);
        const uint32_t sa = base + L::a + st * L::A_BYTES;
        pin(s);
        pin(dp);
        wg_fence();
        if (panels - ch * CHUNK_PANELS < CHUNK_PANELS)
          issue_chunk(sa, ch == 0, One{});
        else
          issue_chunk(sa, ch == 0, Full{});
        pin(s);
        pin(dp);
        release(a_empty + 8 * st);
      }
      if (kt < n_plain)
        grads(kt, Plain{});
      else
        grads(kt, Masked{});
      // dS to 16 bits as the A operand: key columns 8 i .. 8 i + 7 are
      // k-slice i / 2, registers h (slice columns 0-7) and 2 + h (8-15).
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dsa[i / 2][(i % 2) * 2 + h] =
              pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);
      // dQ += dS K over the CTA's window (K read MN-major, as it arrived).
      const int ws = kt % DQ_KSTAGES;
      mbar_wait(w_full + 8 * ws, (kt / DQ_KSTAGES) & 1);
      const uint32_t sw = base + L::w + ws * L::W_BYTES;
      pin(acc);
      wg_fence();
#pragma unroll
      for (int j = 0; j < DQ_STEPS; ++j)
        Wgmma<CW, T>::rs(acc, dsa[j],
                         desc(sw + j * 16 * PANEL_ROW, L::K_PANEL, 512));
      wg_commit();
      wg_wait<0>();
      pin(acc);
      pin(dsa);
      release(w_empty + 8 * ws);
    }
    // Tiles no row of this warpgroup sees: wait for each stage to land (so
    // the release cannot complete an earlier use of it), release it.
    for (int kt = n_live; kt < n_kt; ++kt) {
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % DQ_STAGES;
        mbar_wait(a_full + 8 * st, (g / DQ_STAGES) & 1);
        release(a_empty + 8 * st);
      }
      const int ws = kt % DQ_KSTAGES;
      mbar_wait(w_full + 8 * ws, (kt / DQ_KSTAGES) & 1);
      release(w_empty + 8 * ws);
    }

    // dq = dQ * dq_scale in f32 on the own columns, stored from registers
    // (the share computed here, not held through the loop in registers).
    const Cols cols = col_share<NP>(d, cc);
    const int own0 = (cols.start - cols.w0) * PANEL;
    const int own1 = own0 + cols.own * PANEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg_first + r_lo + 8 * h;
      if (row >= sq) continue;
      T* dst = dq + ((size_t)bh * sq + row) * d + cols.w0 * PANEL + cq;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
        if (8 * i >= own0 && 8 * i < own1)
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              pack2<T>(acc[4 * i + 2 * h] * dq_scale,
                       acc[4 * i + 2 * h + 1] * dq_scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, T* __restrict__ o,
               float* __restrict__ lse, int bh_total, int sq, int sk, int d,
               float scale_r, int causal) {
  const int n_cc = col_ctas<FWD_NP>(d);
  const int n_qt = (sq + FWD_ROWS - 1) / FWD_ROWS;
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int qt = n_qt - 1 - rest / n_cc;  // heavy (late) query tiles first
  fwd_tile<T>(&mq, &mk, &mv, o, lse, bh, rest % n_cc, qt * FWD_ROWS, sq, sk,
              d, scale_r, causal);
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int bh_total, int sq, int sk, int d,
                float scale_r, int causal) {
  const int n_cc = col_ctas<DKDV_NP>(d);
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int kt = rest / n_cc;  // heavy (early) key tiles first
  dkdv_tile<T>(&mq, &mdo, &mk, &mv, lse, delta, dk, dv, bh, rest % n_cc,
               kt * DKDV_KEYS, sq, sk, d, scale_r, causal);
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mdo,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int bh_total, int sq, int sk, int d,
              float scale_r, float dq_scale, int causal) {
  const int n_cc = col_ctas<DQ_NP>(d);
  const int n_qt = (sq + DQ_ROWS - 1) / DQ_ROWS;
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int qt = n_qt - 1 - rest / n_cc;  // heavy (late) query tiles first
  dq_tile<T>(&mq, &mdo, &mk, &mv, lse, delta, dq, bh, rest % n_cc,
             qt * DQ_ROWS, sq, sk, d, scale_r, dq_scale, causal);
}

// Set each kernel's shared-memory limit once, before its first launch.
namespace {
bool g_prepared[3][2] = {};
}  // namespace

template <typename T, typename K>
int prepare(int which, K kernel, size_t bytes) {
  bool& ready = g_prepared[which][std::is_same<T, __half>::value ? 0 : 1];
  if (ready) return 0;
  const int e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  ready = e == 0;
  return e;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, int d, float scale_r,
               int causal, cudaStream_t stream) {
  int e = prepare<T>(0, fwd_kernel<T>, FwdSmem::bytes);
  CUtensorMap mq, mk, mv;
  if (e == 0) e = make_map<T>(&mq, q, bh, sq, d, FWD_ROWS);
  if (e == 0) e = make_map<T>(&mk, k, bh, sk, d, FWD_KEYS);
  if (e == 0) e = make_map<T>(&mv, v, bh, sk, d, FWD_KEYS);
  if (e != 0) return e;
  const int blocks =
      bh * ((sq + FWD_ROWS - 1) / FWD_ROWS) * col_ctas<FWD_NP>(d);
  fwd_kernel<T><<<blocks, WIDE_THREADS, FwdSmem::bytes, stream>>>(
      mq, mk, mv, static_cast<T*>(o), lse, bh, sq, sk, d, scale_r, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int bh, int sq, int sk, int d, float scale_r, int causal,
                cudaStream_t stream) {
  int e = prepare<T>(1, dkdv_kernel<T>, DkdvSmem::bytes);
  CUtensorMap mq, mdo, mk, mv;
  if (e == 0) e = make_map<T>(&mq, q, bh, sq, d, DKDV_ROWS);
  if (e == 0) e = make_map<T>(&mdo, dout, bh, sq, d, DKDV_ROWS);
  if (e == 0) e = make_map<T>(&mk, k, bh, sk, d, DKDV_KEYS);
  if (e == 0) e = make_map<T>(&mv, v, bh, sk, d, DKDV_KEYS);
  if (e != 0) return e;
  const int blocks =
      bh * ((sk + DKDV_KEYS - 1) / DKDV_KEYS) * col_ctas<DKDV_NP>(d);
  dkdv_kernel<T><<<blocks, WIDE_THREADS, DkdvSmem::bytes, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      bh, sq, sk, d, scale_r, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, int d, float scale_r, float dq_scale, int causal,
              cudaStream_t stream) {
  int e = prepare<T>(2, dq_kernel<T>, DqSmem::bytes);
  CUtensorMap mq, mdo, mk, mv;
  if (e == 0) e = make_map<T>(&mq, q, bh, sq, d, DQ_ROWS);
  if (e == 0) e = make_map<T>(&mdo, dout, bh, sq, d, DQ_ROWS);
  if (e == 0) e = make_map<T>(&mk, k, bh, sk, d, DQ_KEYS);
  if (e == 0) e = make_map<T>(&mv, v, bh, sk, d, DQ_KEYS);
  if (e != 0) return e;
  const int blocks =
      bh * ((sq + DQ_ROWS - 1) / DQ_ROWS) * col_ctas<DQ_NP>(d);
  dq_kernel<T><<<blocks, WIDE_THREADS, DqSmem::bytes, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<T*>(dq), bh, sq, sk, d,
      scale_r, dq_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace wide90
}  // namespace hvdt
