// The float32 flash kernels on 3xTF32 wgmma and TMA, for Hopper (sm_90a):
// K1 (the forward) and K2 (the split backward's dK/dV half) at every head
// dim, K3 (its dQ half) and B2 (the combined backward) up to the head dims
// their plan gives them.  flash_fwd.cu (flash_fwd) and flash_bwd_split.cu
// (flash_bwd_dkdv, flash_bwd_dq) launch them for f32 at head dims 32, 64,
// 96, 128 and 256, flash_bwd.cu (flash_bwd) at 32 to 128, flash_wide.cu
// (flash_fwd_wide, flash_bwd_dkdv_wide) above 256, where K3 keeps a SIMT
// body (flash_wide.cu).  The ring steps K4 and K5 (ring_flash.cu) run K1's
// and B2's bodies at 32 to 128 with the step's absolute offsets q_off and
// k_off, which every causal decision reads (K1 and B2 pass 0).  Under a
// causal mask dq at query row 0 is a rounding residue of dP - delta;
// kernel_check holds float32 dq to a limit that grows by the rounding
// noise of dP, which that residue is.
//
// They replace the Pallas TPU kernels `_flash_kernel`
// (horovod_tpu/ops/attention.py:356, pallas_call :1047),
// `_flash_bwd_dkdv_kernel` (:429, pallas_call :914), `_flash_bwd_dq_kernel`
// (:465, pallas_call :930) and `_combined_bwd_kernel` with rotate=False (:498,
// pallas_call :706) and rotate=True (K5, through
// horovod_tpu/ops/ring_flash.py's `_bwd_ring_step`), math in `_bwd_block_math`
// :386, and `_step_kernel` (K4, horovod_tpu/ops/ring_flash.py:78, pallas_call
// :272), in float32.  Semantics as flash_wide.cu's note and the reference's:
// masked logits NEG_INF, m_safe and alpha rescaling, l summed over the
// unrounded p, lse = POS_BIG and o = 0 for rows with no key, dK and dV summed
// and stored in f32, a ragged tail zero-filled and masked, any multiple of 32.
// A CTA computes a window of NP output panels (a template parameter,
// window_panels): the whole head dim up to 128 (NP = d / 32, one column CTA,
// so nothing is recomputed), 4 panels above (two column CTAs at 256).
//
// Precision.  One TF32 product keeps 10 mantissa bits of each operand and
// misses the f32 rule (kernel_check, rtol 1e-4) by 30x and more; three
// keep it.  Every operand x is split hi = rna(x), lo = rna(x - hi), both
// TF32 (cvt.rna.tf32.f32: the tensor core's own truncation of raw f32 bits
// is never relied on), and every product is hi.hi + hi.lo + lo.hi, summed
// in f32 registers (lo.lo, ~2^-22 of the product, is dropped).  The
// reference's f32 yardstick on this card, SDPA's memory-efficient kernel,
// splits the same way (CUTLASS's OpMultiplyAddFastF32).
// kernel_check.tf32_split mirrors the split on the CPU, where the split
// alone reads ~0.05 of the rule.  The tensor cores add the products into
// their accumulator with truncation, so a sum chained through one
// accumulator over the whole head dim (3 d / 8 wgmma steps) drifts by
// about a unit in the last place a step: chained so, the scores read up to
// 0.46 (o) and 0.70 (dk) at head dim 1024.  So S (K2: S^T and dP^T) is
// summed per 32-column chunk (12 steps) in fresh accumulators and added
// into its running sum in f32 registers, which reads 0.15-0.18
// (tools/torch_split_variants.py --family wide_f32 A/Bs both).  K1's P V
// takes a fourth product, P's hi against V's rest (split3: V = hi + lo +
// lo2 exactly), so that a row whose p is one key's 1 (a causal first row)
// gets o = v exactly, as f32 does: three products leave o off v by up to
// 2^-22, and the caller's delta = dO . o then misses dP = dO . v at that
// row by more than dq's limit allows (1.1 of the rule at 32 x 1024 x 64,
// CPU emulation; 0.06 with the fourth product).  The sums over the loop
// likewise: K1's O, K2's (B2's) dV and dK and K3's dQ take each key tile's
// (query step's) product in a fresh accumulator, 16 to 64 columns at a
// time in registers the score products leave free, and add it in f32
// registers.  Chained through one accumulator over the loop they drift
// with its length: 0.94-1.15 of the rule at seq 8192 (causal, head dims
// 64-256; tools/torch_split_variants.py --family f32 A/Bs each).
//
// Bound on the card: by operations at every shape the callers use, at the
// TF32 peak over three products (494.7 / 3 TFLOP/s): K1 4 d FLOP per
// causal pair against 8 d bytes per row, K2 8 d, K3 6 d, B2 10 d.  The
// design, the 16-bit wide bodies' skeleton (flash_wide_sm90.cuh) with what
// TF32 changes:
//  1. TF32 wgmma reads K-major operands only (the transpose immediates
//     exist for f16 / bf16 alone).  S = q' K^T (K1), S^T = K q'^T and
//     dP^T = V dO^T (K2) are K-major as they lie in memory; O += P V,
//     dV += P^T dO and dK += dS^T q' are not (V, dO, q' are head-dim
//     contiguous), and TMA cannot transpose.  So per key tile (K1) or
//     query step (K2) the consumers stage V^T (dO^T and q'^T) of the CTA's
//     window from the TMA stage into shared memory, split hi / lo in the
//     same pass.
//  2. The A operands come from registers: q' (K1), K and V (K2) are read
//     from the TMA stage into the k8 A fragment and split there, two k8
//     slices in flight; P and dS are split from the accumulators.  The B
//     operands of the score products (K; q' and dO) are split in shared
//     memory, hi over the raw tile and lo into its twin, behind a named
//     barrier per chunk: of both consumer warpgroups in K1, of the one
//     warpgroup that takes the chunk in K2.
//  3. The A fragment of a k8 TF32 wgmma holds columns t and t + 4 of each
//     8-column slice (t = lane % 4), the accumulator columns 2 t and
//     2 t + 1.  P and dS are passed in the accumulator's order, and the
//     staging pass writes V^T's keys (q'^T's, dO^T's queries) permuted to
//     match: slot p of each 8 holds position 2 p for p < 4 and 2 (p - 4)
//     + 1 above (a contraction is invariant under one permutation of both
//     sides).
//  4. Shared memory: f32 tiles are twice the bytes of 16-bit ones and
//     every B operand needs its lo twin.  Tiles sit as panels of 32
//     columns, 128-byte rows, 128-byte swizzle (TMA's F32 map,
//     sm90_common.cuh).  K1 at NP = 4: 3 stages of (q' 16 KB, K 8 KB, K
//     lo 8 KB) + the raw V window 32 KB + V^T hi, lo and lo2 96 KB = 224
//     KB (144 KB at NP = 2, head dim 64).  K2 at NP = 4: 2 stages of (K
//     8, V 8, q' 4, dO 4, their lo twins 8) KB + the raw (q', dO) window
//     of 32 KB with its lse / delta + q'^T and dO^T hi and lo 64 KB + the
//     two warpgroups' halves of S^T and dP^T 32 KB = 193 KB.
//  5. Registers (ptxas holds 288-thread CTAs to 168 a thread): K1 keeps O
//     (64 rows x 128 columns: 64 a thread) beside S and a chunk's S (32
//     each) and then P's hi and lo fragments two 8-key slices at a time
//     (16); K2 keeps dK and dV (64 keys x 64 columns each: 64) beside S^T
//     and dP^T and a chunk's (32 query rows: 64) and then P^T and dS^T hi
//     and lo (64).  So a K1 warpgroup owns 64 query rows of a 4-panel
//     (128-column) window, and a K2 warpgroup 2 panels of its CTA's
//     4-panel window, for all 64 keys of the CTA: K2's two warpgroups
//     each sum S^T and dP^T over half the head-dim chunks and add the
//     halves through shared memory, so S is computed once per 4-panel
//     window in both.  Below 4 panels everything shrinks with the window
//     (O 16 NP a thread; dK, dV 8 NP each).  S recompute per row
//     ceil(d / 128) times: ceil(d / 128) (6 d + 8 W) TF32 FLOP per pair in
//     K1 (W = 32 NP, the window's columns; 3.5x the caller's 4 d up to
//     128, 7.0x at 288, 8.0x at 512) and 3 ceil(d / 128) (4 d + 4 W) in K2
//     (3x the caller's 8 d up to 128, 6.5x, 7.5x at 288, 512).  ptxas
//     (PERF.md): K1 126 / 141 / 160 / 168 registers at NP 1-4, K2 160 /
//     168 / 168 / 168, only K2 at NP = 4 spilling (76 B).
//  6. K3 (dq_tile) is K1's skeleton with dP beside S: 128 query rows a
//     CTA, 32-key tiles (S, dP and a chunk's of each, 16 registers apiece,
//     beside dQ's 16 NP), (q', dO, K, V) chunks streamed through three
//     stages (1-4% faster than two, tools/torch_split_variants.py), q' and dO split in registers as the A fragments, K and V in
//     shared memory as B.  dS = p (dP - delta) scale_r stays in registers
//     and is split into the A fragment of dQ += dS K, whose B is K^T of the
//     window staged hi / lo from a raw K window, keys permuted as in K1's
//     V^T.  dQ stays in registers across the key loop and is written once,
//     times p2: no atomics.  Shared memory 144 + 12 NP KB (192 KB at
//     NP = 4).  ptxas: 149 / 164 / 168 / 168 registers at NP 1-4, 12 B and
//     72 B spilled at NP 3 and 4.
//  7. B2 (dkdv_tile with WITH_DQ) is K2 with dQ = dS K added per query
//     step.  TF32 takes K-major operands alone, so the product is dQ^T =
//     K^T dS^T with both operands in shared memory (m64n16k8, a warpgroup
//     16 of the step's 32 query rows): K^T of the window, hi and lo, is
//     staged once a CTA from a raw K window (K is the CTA's for the whole
//     loop), and each thread stores its dS^T values, already split for
//     dK, as dS (query rows, keys along K).  Each warpgroup's dQ tile goes
//     through shared memory to the caller's f32 workspace by TMA reduce, as
//     in the 16-bit B2.  K^T at 4 panels would not fit beside K2's tiles,
//     so B2's window is at most 2 panels (F32_BWD_NP): the whole head dim
//     up to 64, two column CTAs recomputing S^T and dP^T at 96 and 128.
//     Shared memory 202 KB at NP = 2.  ptxas: 158 / 160 registers at NP
//     1-2, no spill.
//
// Every CTA of a tile runs the same products in the same chunk order, so
// the column CTAs agree bit for bit on m and l and only the first writes
// lse.  Grids are 1-D, (tiles x column CTAs x bh) blocks, heavy tiles
// first.  Each consumer warp releases a stage after its own wgmma wait, so
// a stage is refilled only when every warp is done with it (a stage
// released after a barrier of both consumer warpgroups is released by one
// thread of each).  Every mbarrier wait traps after 2 s.

#pragma once

#include "flash_wide_sm90.cuh"

namespace hvdt {
namespace wide32 {

using namespace sm90;
using wide90::Cols;
using wide90::col_ctas;
using wide90::col_share;
using wide90::warpgroup;

constexpr int F32_PANEL = 32;           // head-dim columns per 128-B row
constexpr uint32_t ROW_BYTES = 128;     // bytes per row of a panel
constexpr int WIDE_THREADS = 2 * 128 + 32;  // two consumer warpgroups + warp
constexpr int SPLIT_BAR = 1;  // named barrier of the 256 consumer threads
// K1: query rows per CTA (64 per consumer warpgroup), keys per tile.
constexpr int F32_FWD_ROWS = 128;
constexpr int F32_FWD_KEYS = 64;
constexpr int F32_FWD_NP = 4;      // output panels per CTA (128 columns)
constexpr int F32_FWD_STAGES = 3;  // (q', K) chunks in flight
// K2: keys per CTA (both consumer warpgroups), query rows per step.
constexpr int F32_DKDV_KEYS = 64;
constexpr int F32_DKDV_ROWS = 32;
constexpr int F32_DKDV_NP = 4;       // output panels per CTA (2 a warpgroup)
// (K, V, q', dO) chunks in flight.  Two: the warpgroups take alternate
// chunks, so within a query step each stage serves one warpgroup, and a
// stage changes hands only across the step's CTA-wide barriers.  With
// three, where the warpgroups take turns on a stage within a step (handed
// on by the mbarriers alone), a few CTAs in thousands computed wrong dK and
// dV on the card, or trapped; the cause was not found.
constexpr int F32_DKDV_STAGES = 2;
constexpr int F32_DKDV_CSTAGES = 1;  // (q', dO) column windows in flight
static_assert(F32_DKDV_STAGES == 2, "one stage per warpgroup a step");
// B2: K2's body with dQ = dS K (WITH_DQ), in windows of at most 2 panels
// (two column CTAs at 96 and 128): K^T of the window, hi and lo, stays in
// shared memory for the CTA, which 4 panels leave no room for.  dQ^T = K^T
// dS^T per query step, each warpgroup 16 of its 32 query rows.
constexpr int F32_BWD_NP = 2;
constexpr int F32_BWD_DQ_ROWS = F32_DKDV_ROWS / 2;
// K3: query rows per CTA (64 per consumer warpgroup), keys per tile (32:
// S, dP, a chunk's S and dP and dQ's window of up to 4 panels in
// registers), (q', dO, K, V) chunks in flight.
constexpr int F32_DQ_ROWS = 128;
constexpr int F32_DQ_KEYS = 32;
constexpr int F32_DQ_NP = 4;
constexpr int F32_DQ_STAGES = 3;

// x to TF32, to nearest with ties away from zero (low 13 bits zero).
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to ~2^-22 relative, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// x = hi + lo + lo2 exactly, all three TF32 (x - hi - lo has at most 3
// significant bits, so lo2 is exact).
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo,
                                       uint32_t& lo2) {
  split(x, hi, lo);
  lo2 = tf32(x - __uint_as_float(hi) - __uint_as_float(lo));
}

// wgmma descriptor of a K-major operand in 128-byte-swizzle panels: rows
// of 128 B, 8-row groups 1024 B apart (stride), leading offset unused.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (r, c) in a panel of 128-byte rows as TMA writes
// it with 128-byte swizzle: 16-byte chunk c / 4 of row r lands at chunk
// (c / 4) ^ (r % 8), relative to a 1024-byte-aligned panel.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * ROW_BYTES + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// The k8 slice kk of rows r and r + 8 of an f32 panel as a TF32 A fragment,
// split: registers (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4).
__device__ __forceinline__ void load_a(const unsigned char* panel, int r,
                                       int kk, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int c = 8 * kk + threadIdx.x % 4;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float x = *reinterpret_cast<const float*>(
        panel + sw128(r + 8 * (v % 2), c + 4 * (v / 2)));
    split(x, hi[v], lo[v]);
  }
}

// Threads tid = 0 .. NT - 1 split a raw f32 tile of `bytes` bytes: hi in
// place, lo into `lo` (the same layout at another address).
template <int NT>
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo,
                                           uint32_t bytes, int tid) {
  for (uint32_t i = tid * 16; i < bytes; i += NT * 16) {
    const float4 x = *reinterpret_cast<const float4*>(hi + i);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// The 256 consumer threads transpose a raw window of ROWS sequence
// positions and NPW panels into hi and lo tiles of its NPW * 32 columns:
// rows are the columns, positions run along K in panels of 32 (128-byte
// swizzle), slot p of each 8 holding position 2 p (p < 4) or 2 (p - 4) + 1
// (the accumulators' order of P and dS).  A warp takes 32 columns of one
// raw panel and one group of 8 positions.  With `lo2`, the rest x - hi -
// lo too, rounded to TF32: hi + lo + lo2 is x exactly.
template <int ROWS, int NPW>
__device__ __forceinline__ void stage_transposed(const unsigned char* raw,
                                                 unsigned char* hi,
                                                 unsigned char* lo,
                                                 unsigned char* lo2 =
                                                     nullptr) {
  constexpr int COLS = NPW * F32_PANEL;
  constexpr uint32_t RAW_PANEL = ROWS * ROW_BYTES;
  constexpr uint32_t T_PANEL = COLS * ROW_BYTES;
  for (int it = threadIdx.x; it < COLS * (ROWS / 8); it += 256) {
    const int n = it % COLS, grp = it / COLS;
    const unsigned char* src = raw + (n / F32_PANEL) * RAW_PANEL;
    uint32_t h[8], l[8], l2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = *reinterpret_cast<const float*>(
          src + sw128(8 * grp + j, n % F32_PANEL));
      const int slot = (j >> 1) + 4 * (j & 1);
      split3(x, h[slot], l[slot], l2[slot]);
    }
    const uint32_t at = (grp / 4) * T_PANEL + sw128(n, 8 * (grp % 4));
    const uint32_t at4 = (grp / 4) * T_PANEL + sw128(n, 8 * (grp % 4) + 4);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + at4) = make_uint4(h[4], h[5], h[6], h[7]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<uint4*>(lo + at4) = make_uint4(l[4], l[5], l[6], l[7]);
    if (lo2 != nullptr) {
      *reinterpret_cast<uint4*>(lo2 + at) =
          make_uint4(l2[0], l2[1], l2[2], l2[3]);
      *reinterpret_cast<uint4*>(lo2 + at4) =
          make_uint4(l2[4], l2[5], l2[6], l2[7]);
    }
  }
}

// The 256 consumer threads stage K^T of a raw window of F32_DKDV_KEYS keys
// and NPW panels, hi and lo, for B2's dQ^T = K^T dS^T: rows are the
// window's columns (ROWS_T of them; rows past the window are zero), the
// keys run along K in panels of 32 (128-byte swizzle) in their own order.
// A thread takes one column and 4 adjacent keys.
template <int NPW, int ROWS_T>
__device__ __forceinline__ void stage_kt(const unsigned char* raw,
                                         unsigned char* hi,
                                         unsigned char* lo) {
  constexpr uint32_t RAW_PANEL = F32_DKDV_KEYS * ROW_BYTES;
  constexpr uint32_t T_PANEL = ROWS_T * ROW_BYTES;
  for (int it = threadIdx.x; it < ROWS_T * (F32_DKDV_KEYS / 4); it += 256) {
    const int n = it % ROWS_T, j = 4 * (it / ROWS_T);
    uint32_t h[4] = {0u, 0u, 0u, 0u}, l[4] = {0u, 0u, 0u, 0u};
    if (n < NPW * F32_PANEL) {
      const unsigned char* src = raw + (n / F32_PANEL) * RAW_PANEL;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        split(*reinterpret_cast<const float*>(
                  src + sw128(j + v, n % F32_PANEL)),
              h[v], l[v]);
    }
    const uint32_t at = (j / F32_PANEL) * T_PANEL + sw128(n, j % F32_PANEL);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// What the consumers wrote with generic stores, made visible to wgmma's
// reads, and both consumer warpgroups past the same point.
__device__ __forceinline__ void consumers_sync() {
  fence_async_shared();
  bar_sync(SPLIT_BAR, 256);
}

// The accumulator's 8 values of one 8-column slice i (rows r, r + 8 of
// columns 2 t, 2 t + 1), split as the A fragment of that slice in the
// staged order: a[0] (r, 2t), a[1] (r + 8, 2t), a[2] (r, 2t + 1), a[3]
// (r + 8, 2t + 1).
template <int N>
__device__ __forceinline__ void split_acc(const float (&x)[N], int i,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split(x[4 * i], hi[0], lo[0]);
  split(x[4 * i + 2], hi[1], lo[1]);
  split(x[4 * i + 1], hi[2], lo[2]);
  split(x[4 * i + 3], hi[3], lo[3]);
}

// The first M values of an accumulator array: a product narrower than the
// array's summed in registers the array's own product leaves free.
template <int M, int N>
__device__ __forceinline__ float (&lead(float (&x)[N]))[M] {
  static_assert(M <= N, "lead: the array is shorter");
  return *reinterpret_cast<float(*)[M]>(x);
}

template <int NP>
struct FwdSmem {
  static constexpr uint32_t Q_PANEL = F32_FWD_ROWS * ROW_BYTES;  // 16 KB
  static constexpr uint32_t K_PANEL = F32_FWD_KEYS * ROW_BYTES;  // 8 KB
  // Stage s: the chunk's q' panel, K panel (hi once split), K lo.
  static constexpr uint32_t A_Q = 0;
  static constexpr uint32_t A_K = A_Q + Q_PANEL;
  static constexpr uint32_t A_KLO = A_K + K_PANEL;
  static constexpr uint32_t A_BYTES = A_KLO + K_PANEL;
  static constexpr uint32_t V_BYTES = NP * K_PANEL;  // raw window
  // V^T: the window's 32 NP columns x 64 keys in two 32-key panels.
  static constexpr uint32_t VT_PANEL = NP * F32_PANEL * ROW_BYTES;
  static constexpr uint32_t VT_BYTES = (F32_FWD_KEYS / F32_PANEL) * VT_PANEL;
  static constexpr uint32_t a = 0;
  static constexpr uint32_t v = a + F32_FWD_STAGES * A_BYTES;
  static constexpr uint32_t vt_hi = v + V_BYTES;
  static constexpr uint32_t vt_lo = vt_hi + VT_BYTES;
  static constexpr uint32_t vt_lo2 = vt_lo + VT_BYTES;
  static constexpr uint32_t bars = vt_lo2 + VT_BYTES;
  // a_full, a_empty [F32_FWD_STAGES], v_full, v_empty
  static constexpr uint32_t N_BARS = 2 * F32_FWD_STAGES + 2;
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K1 and K4: o's own columns and (column CTA 0) lse of query rows [q0, q0
// + F32_FWD_ROWS) of head bh, over a window of NP panels.  With OFFSETS
// (K4) the query rows sit at absolute position q_off + q0 and the keys at
// k_off, and every causal decision reads them; K1 instantiates the body
// without, so its code is the one without offsets.  mq: map of q' (bh, sq,
// d), boxes of F32_FWD_ROWS rows; mk, mv: k, v (bh, sk, d), boxes of
// F32_FWD_KEYS rows.  A CTA with no key tile (a ring step wholly in its
// future) loads nothing and waits on no barrier: o = 0, lse = POS_BIG.  A
// warpgroup whose rows see no key of a tile takes it masked, which leaves
// its m at NEG_INF and its l and O at 0.
template <int NP, bool OFFSETS = false>
__device__ __forceinline__ void fwd_tile(const CUtensorMap* mq,
                                         const CUtensorMap* mk,
                                         const CUtensorMap* mv, float* o,
                                         float* lse, int bh, int cc, int q0,
                                         int sq, int sk, int d, int q_off,
                                         int k_off, float scale_r,
                                         int causal) {
  using L = FwdSmem<NP>;
  constexpr int BN = F32_FWD_KEYS, CW = NP * F32_PANEL;
  constexpr int STAGES = F32_FWD_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t a_full = base + L::bars, a_empty = a_full + 8 * STAGES;
  const uint32_t v_full = a_empty + 8 * STAGES, v_empty = v_full + 8;
  const int n_ch = d / F32_PANEL;
  const Cols cols = col_share<NP>(d, cc);

  int n_kt = (sk + BN - 1) / BN;
  // Key tiles past the CTA's last row are wholly masked (reference:
  // `k_start <= q_start + block_q - 1`); a ring step wholly in the CTA's
  // future leaves none.
  if constexpr (OFFSETS) {
    const int lim = q_off + q0 + F32_FWD_ROWS - 1 - k_off;
    if (causal) n_kt = lim < 0 ? 0 : min(n_kt, lim / BN + 1);
  } else {
    if (causal) n_kt = min(n_kt, (q0 + F32_FWD_ROWS - 1) / BN + 1);
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {
    // Producer: per key tile, the (q', K) panel of each chunk, then the
    // raw V window (one buffer: the consumers release it once staged).
    if (threadIdx.x == 256) {
      int g = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        for (int ch = 0; ch < n_ch; ++ch, ++g) {
          const int st = g % STAGES;
          if (g >= STAGES) mbar_wait(a_empty + 8 * st, (g / STAGES - 1) & 1);
          const uint32_t sa = base + L::a + st * L::A_BYTES;
          mbar_expect_tx(a_full + 8 * st, L::Q_PANEL + L::K_PANEL);
          tma_load(sa + L::A_Q, mq, a_full + 8 * st, ch * F32_PANEL, q0, bh);
          tma_load(sa + L::A_K, mk, a_full + 8 * st, ch * F32_PANEL,
                   kt * BN, bh);
        }
        if (kt > 0) mbar_wait(v_empty, (kt - 1) & 1);
        mbar_expect_tx(v_full, L::V_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::v + p * L::K_PANEL, mv, v_full,
                   (cols.w0 + p) * F32_PANEL, kt * BN, bh);
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

    float acc[CW / 2];
    float s[BN / 2];   // S summed over the chunks, then P in f32
    float sc[BN / 2];  // one chunk's S
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;

    // S (+)= q' K^T over the chunk in stage `off`: per k8 slice the q'
    // fragment split in registers (two slices in flight) against K hi and
    // lo, into sc, then added into S in registers.
    auto issue_qk = [&](uint32_t off, bool first) {
      uint32_t qh[2][4], ql[2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        load_a(gbase + off + L::A_Q, row0 + r_lo, kk, qh[kk % 2],
               ql[kk % 2]);
        const uint64_t kh = desc128(base + off + L::A_K + kk * 32);
        const uint64_t kl = desc128(base + off + L::A_KLO + kk * 32);
        wg_fence();
        Wgmma<BN, float>::rs(sc, qh[kk % 2], kh, kk != 0);
        Wgmma<BN, float>::rs(sc, qh[kk % 2], kl, 1);
        Wgmma<BN, float>::rs(sc, ql[kk % 2], kh, 1);
        wg_commit();
        wg_wait<1>();  // the slice before is done: its registers are free
      }
      wg_wait<0>();
      pin(sc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = first ? sc[i] : s[i] + sc[i];
      pin(qh);
      pin(ql);
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
              int row = wg_first + r_lo + 8 * h;  // in the keys' positions
              if constexpr (OFFSETS) row += q_off - k_off;
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
      int x = wg_first - BN + 1;  // k0 <= x: no key masked
      if constexpr (OFFSETS) x += q_off - k_off;
      n_plain = min(n_plain, x < 0 ? 0 : x / BN + 1);
    }
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;

    int g = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % STAGES;
        mbar_wait(a_full + 8 * st, (g / STAGES) & 1);
        const uint32_t off = L::a + st * L::A_BYTES;
        split_tile<256>(gbase + off + L::A_K, gbase + off + L::A_KLO,
                        L::K_PANEL, threadIdx.x);
        consumers_sync();
        pin(sc);
        issue_qk(off, ch == 0);
        // Each warp releases the stage after its own wait, so the stage is
        // refilled only when every consumer warp is done with it.
        mbar_arrive_if(a_empty + 8 * st, lane == 0);
      }
      if (kt < n_plain)
        softmax(kt, Plain{});
      else
        softmax(kt, Masked{});
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * i + 2 * h] *= alpha[h];
          acc[4 * i + 2 * h + 1] *= alpha[h];
        }
      // V^T of the window, hi and lo, from the raw V tile.
      mbar_wait(v_full, kt & 1);
      stage_transposed<BN, NP>(gbase + L::v, gbase + L::vt_hi,
                               gbase + L::vt_lo, gbase + L::vt_lo2);
      consumers_sync();
      mbar_arrive_if(v_empty, tid == 0);
      // O += P V over the CTA's window, PW columns at a time: the tile's
      // sum in a fresh accumulator (sc, free until the next chunk), added
      // into O in f32 registers, so no truncating wgmma chain runs across
      // key tiles.  P split into its hi / lo A fragment one 8-key slice at
      // a time, two slices in flight; the fourth product, P's hi against
      // V's second lo, makes o = v exactly where p = 1 (a causal first
      // row), as in f32: else delta = dO . o there misses dP = dO . v by
      // more than dq's limit allows.
      constexpr int PW = CW % 64 == 0 ? 64 : F32_PANEL;
      float(&pv)[PW / 2] = lead<PW / 2>(sc);
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int p = 0; p < CW / PW; ++p) {
        // Split again (tf32() is a plain asm, which the compiler would
        // otherwise keep for every slice across the parts: spills).
        if (p > 0) pin(s);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          split_acc(s, j, ph[j % 2], pl[j % 2]);
          const uint32_t kp =
              p * PW * ROW_BYTES + (j / 4) * L::VT_PANEL + (j % 4) * 32;
          const uint64_t vh = desc128(base + L::vt_hi + kp);
          const uint64_t vl = desc128(base + L::vt_lo + kp);
          const uint64_t vl2 = desc128(base + L::vt_lo2 + kp);
          wg_fence();
          Wgmma<PW, float>::rs(pv, ph[j % 2], vh, j != 0);
          Wgmma<PW, float>::rs(pv, ph[j % 2], vl, 1);
          Wgmma<PW, float>::rs(pv, pl[j % 2], vh, 1);
          Wgmma<PW, float>::rs(pv, ph[j % 2], vl2, 1);
          wg_commit();
          wg_wait<1>();
        }
        wg_wait<0>();
        pin(pv);
#pragma unroll
        for (int e = 0; e < PW / 2; ++e) acc[PW / 2 * p + e] += pv[e];
      }
      pin(ph);
      pin(pl);
    }

    // Finalize: o = O / l on the own columns, lse = m + log l (POS_BIG,
    // o = 0 where l == 0) from column CTA 0.
    const int own0 = (cols.start - cols.w0) * F32_PANEL;
    const int own1 = own0 + cols.own * F32_PANEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = wg_first + r_lo + 8 * h;
      if (row >= sq) continue;
      const float inv = lt == 0.f ? 1.f : 1.f / lt;
      float* dst = o + ((size_t)bh * sq + row) * d + cols.w0 * F32_PANEL + cq;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
        if (8 * i >= own0 && 8 * i < own1)
          *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(
              acc[4 * i + 2 * h] * inv, acc[4 * i + 2 * h + 1] * inv);
      if (lane % 4 == 0 && cc == 0)
        lse[(size_t)bh * sq + row] =
            lt == 0.f ? POS_BIG : m[h] * LN2 + logf(lt);
    }
  }
}

template <int NP, bool WITH_DQ = false>
struct DkdvSmem {
  static constexpr uint32_t K_PANEL = F32_DKDV_KEYS * ROW_BYTES;  // 8 KB
  static constexpr uint32_t Q_PANEL = F32_DKDV_ROWS * ROW_BYTES;  // 4 KB
  // Stage s of the chunk ring: K, V, then q', dO (hi once split) and their
  // lo twins, the same distance further on.
  static constexpr uint32_t A_K = 0;
  static constexpr uint32_t A_V = A_K + K_PANEL;
  static constexpr uint32_t A_Q = A_V + K_PANEL;
  static constexpr uint32_t A_DO = A_Q + Q_PANEL;
  static constexpr uint32_t A_QLO = A_DO + Q_PANEL;
  static constexpr uint32_t A_BYTES = A_QLO + 2 * Q_PANEL;
  // Stage s of the column ring: the window's raw q', then dO panels.
  static constexpr uint32_t C_BYTES = 2 * NP * Q_PANEL;
  static constexpr uint32_t STAT_FLOATS = 2 * F32_DKDV_ROWS;  // lse, delta
  // q'^T, dO^T: the window's 32 NP columns x 32 query rows, one panel
  // each.
  static constexpr uint32_t T_PANEL = NP * F32_PANEL * ROW_BYTES;
  // Each warpgroup's S^T and dP^T of its chunks: 128 threads x 32 floats.
  static constexpr uint32_t X_BYTES = 128 * F32_DKDV_ROWS * 4;
  static constexpr uint32_t a = 0;
  static constexpr uint32_t c = a + F32_DKDV_STAGES * A_BYTES;
  static constexpr uint32_t stats = c + F32_DKDV_CSTAGES * C_BYTES;
  static constexpr uint32_t t_hi =
      (stats + F32_DKDV_CSTAGES * STAT_FLOATS * 4 + 1023u) & ~1023u;
  static constexpr uint32_t t_lo = t_hi + 2 * T_PANEL;  // q'^T, dO^T each
  static constexpr uint32_t x = t_lo + 2 * T_PANEL;
  // B2 (WITH_DQ): K^T of the window, hi and lo, staged once from the raw
  // K window (loaded into t_hi before the loop): rows the window's columns,
  // at least 64 (the product's M), the keys in two 32-key panels; dS, hi
  // and lo (the step's query rows by the keys, two 32-key panels); each
  // warpgroup's dQ tile (its 16 query rows, NP panels).
  static constexpr int KT_ROWS = NP * F32_PANEL < 64 ? 64 : NP * F32_PANEL;
  static constexpr uint32_t KT_PANEL = KT_ROWS * ROW_BYTES;
  static constexpr uint32_t DS_PANEL = F32_DKDV_ROWS * ROW_BYTES;
  static constexpr uint32_t DQ_PANEL = F32_BWD_DQ_ROWS * ROW_BYTES;
  static constexpr uint32_t DQ_BYTES = NP * DQ_PANEL;  // a warpgroup's
  static constexpr uint32_t kt_hi = x + 2 * X_BYTES;
  static constexpr uint32_t kt_lo = kt_hi + (WITH_DQ ? 2 * KT_PANEL : 0);
  static constexpr uint32_t ds_hi = kt_lo + (WITH_DQ ? 2 * KT_PANEL : 0);
  static constexpr uint32_t ds_lo = ds_hi + (WITH_DQ ? 2 * DS_PANEL : 0);
  static constexpr uint32_t dq = ds_lo + (WITH_DQ ? 2 * DS_PANEL : 0);
  static constexpr uint32_t bars = dq + (WITH_DQ ? 2 * DQ_BYTES : 0);
  // a_full, a_empty [F32_DKDV_STAGES], c_full, c_empty [F32_DKDV_CSTAGES],
  // B2's kw_full (the raw K window)
  static constexpr uint32_t N_BARS =
      2 * F32_DKDV_STAGES + 2 * F32_DKDV_CSTAGES + 1;
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
  static_assert(!WITH_DQ || NP * K_PANEL <= 4 * T_PANEL,
                "the raw K window fits where q'^T and dO^T go");
  static_assert(!WITH_DQ || NP <= F32_BWD_NP, "B2's window is 2 panels");
};

// K2: dK's and dV's own columns of keys [k0, k0 + F32_DKDV_KEYS) of head bh,
// over a window of NP panels; B2 and K5 (WITH_DQ) also add each query step's
// dQ on its own columns into the f32 tensor of map mdq (boxes of
// F32_BWD_DQ_ROWS rows) by TMA reduce.  With OFFSETS (K5) the keys sit at
// absolute position k_off + k0 and the query rows at q_off (K2 and B2
// instantiate the body without); a CTA whose keys no query row sees (a ring
// step wholly in the queries' future) runs no query step (B2 and K5 still
// load and stage their K window), stores dK = dV = 0 and adds no dQ.  mq, mdo: maps of q', dO (bh, sq, d), boxes of F32_DKDV_ROWS
// rows; mk, mv: k, v (bh, sk, d), boxes of F32_DKDV_KEYS rows.  lse, delta:
// (bh, sq) f32.  Both consumer warpgroups own the CTA's keys: per query step
// each sums S^T and dP^T over every other head-dim chunk, alone behind its own
// named barrier, the two halves are added through shared memory (a + b == b +
// a, so both hold the same bits), and each then computes dK and dV on its half
// of the window.  So S^T and dP^T are computed once per CTA for its window.
// Where the head dim has one chunk (32) the second warpgroup sums none and
// adds zeros.  B2's dQ: K^T of the window is staged hi / lo once; per query
// step every consumer thread stores its dS^T values, split, as dS (query rows,
// keys along K), and warpgroup c computes dQ^T = K^T dS^T for query rows 16 c
// .. 16 c + 15 of the step (3 TF32 products a k8 slice, both operands from
// shared memory) and adds its own columns into the caller's f32 dq by TMA
// reduce, in an order that changes from run to run.
template <int NP, bool WITH_DQ = false, bool OFFSETS = false>
__device__ __forceinline__ void dkdv_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mdq,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int bh, int cc, int k0,
    int sq, int sk, int d, int q_off, int k_off, float scale_r, int causal) {
  using L = DkdvSmem<NP, WITH_DQ>;
  constexpr int QB = F32_DKDV_ROWS;
  constexpr int CW = NP * F32_PANEL / 2;  // a warpgroup's window columns
  constexpr int STAGES = F32_DKDV_STAGES, CSTAGES = F32_DKDV_CSTAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  float* const stats = reinterpret_cast<float*>(gbase + L::stats);
  const uint32_t a_full = base + L::bars, a_empty = a_full + 8 * STAGES;
  const uint32_t c_full = a_empty + 8 * STAGES;
  const uint32_t c_empty = c_full + 8 * CSTAGES;
  const uint32_t kw_full = c_empty + 8 * CSTAGES;
  const int n_ch = d / F32_PANEL;
  const Cols cols = col_share<NP>(d, cc);

  // Query steps that see a key of this CTA: under a causal mask, from the
  // first whose last (absolute) row reaches the CTA's first (absolute) key
  // (reference: `q_start + block_q - 1 >= k_start`).
  const int n_qt = (sq + QB - 1) / QB;
  int qt0 = 0;
  if (causal) {
    int need = k0 - QB + 1;
    if constexpr (OFFSETS) need += k_off - q_off;
    qt0 = need <= 0 ? 0 : (need + QB - 1) / QB;
  }
  const int n_it = max(0, n_qt - qt0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 4);  // the warps of the chunk's warpgroup
    }
#pragma unroll
    for (int s = 0; s < CSTAGES; ++s) {
      mbar_init(c_full + 8 * s, 1 + 32);  // the TMA lane + the warp's stats
      mbar_init(c_empty + 8 * s, 2);
    }
    mbar_init(kw_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {
    // Producer warp: lane 0 issues the TMA loads (B2: first the raw K
    // window; per query step the chunks of S^T and dP^T, then the raw
    // column window of q' and dO), and every lane copies lse and delta
    // beside the window.  All lanes wait for the stages to be released.
    const int lane = threadIdx.x % 32;
    const size_t row0 = (size_t)bh * sq;
    if constexpr (WITH_DQ) {
      if (lane == 0) {
        mbar_expect_tx(kw_full, NP * L::K_PANEL);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::t_hi + p * L::K_PANEL, mk, kw_full,
                   (cols.w0 + p) * F32_PANEL, k0, bh);
      }
    }
    int g = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * QB;
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % STAGES;
        if (g >= STAGES) mbar_wait(a_empty + 8 * st, (g / STAGES - 1) & 1);
        if (lane == 0) {
          const uint32_t sa = base + L::a + st * L::A_BYTES;
          const uint32_t bar = a_full + 8 * st;
          const int col = ch * F32_PANEL;
          mbar_expect_tx(bar, 2 * (L::K_PANEL + L::Q_PANEL));
          tma_load(sa + L::A_K, mk, bar, col, k0, bh);
          tma_load(sa + L::A_V, mv, bar, col, k0, bh);
          tma_load(sa + L::A_Q, mq, bar, col, q0, bh);
          tma_load(sa + L::A_DO, mdo, bar, col, q0, bh);
        }
      }
      const int cs = it % CSTAGES;
      if (it >= CSTAGES) mbar_wait(c_empty + 8 * cs, (it / CSTAGES - 1) & 1);
      if (lane == 0) {
        const uint32_t sc = base + L::c + cs * L::C_BYTES;
        mbar_expect_tx(c_full + 8 * cs, L::C_BYTES);
        for (int p = 0; p < NP; ++p) {
          const int col = (cols.w0 + p) * F32_PANEL;
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
    // Consumers: warpgroup c sums the chunks ch with ch % 2 == c and owns
    // window columns [CW c, CW c + CW) of the CTA's keys.
    const int c = wg, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const float scale_log2 = scale_r * LOG2E;
    float* const xs = reinterpret_cast<float*>(gbase + L::x);

    float dk_acc[CW / 2], dv_acc[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // B2: this warpgroup's dQ^T of a step (the window's columns by its 16
    // query rows).
    float dq_acc[WITH_DQ ? F32_BWD_DQ_ROWS / 2 : 1];
    if constexpr (WITH_DQ) {
      // K^T of the window, hi and lo, from the raw K window in t_hi.
      mbar_wait(kw_full, 0);
      stage_kt<NP, L::KT_ROWS>(gbase + L::t_hi, gbase + L::kt_hi,
                               gbase + L::kt_lo);
      consumers_sync();
    }
    // S^T, dP^T (the CTA's keys x QB) summed over the chunks, and one
    // chunk's.
    float s[QB / 2], dp[QB / 2], sc[QB / 2], dpc[QB / 2];

    // S^T (+)= K q'^T and dP^T (+)= V dO^T over the chunk in stage `off`:
    // per k8 slice the K and V fragments split in registers (two slices in
    // flight) against q' and dO hi and lo, into sc and dpc, then added in
    // registers.
    auto issue_chunk = [&](uint32_t off, bool first) {
      uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int b = kk % 2;
        load_a(gbase + off + L::A_K, r_lo, kk, kh[b], kl[b]);
        load_a(gbase + off + L::A_V, r_lo, kk, vh[b], vl[b]);
        const uint32_t at = base + off + kk * 32;
        const uint64_t qh = desc128(at + L::A_Q);
        const uint64_t dh = desc128(at + L::A_DO);
        const uint64_t ql = desc128(at + L::A_QLO);
        const uint64_t dl = desc128(at + L::A_QLO + L::Q_PANEL);
        wg_fence();
        Wgmma<QB, float>::rs(sc, kh[b], qh, kk != 0);
        Wgmma<QB, float>::rs(sc, kh[b], ql, 1);
        Wgmma<QB, float>::rs(sc, kl[b], qh, 1);
        Wgmma<QB, float>::rs(dpc, vh[b], dh, kk != 0);
        Wgmma<QB, float>::rs(dpc, vh[b], dl, 1);
        Wgmma<QB, float>::rs(dpc, vl[b], dh, 1);
        wg_commit();
        wg_wait<1>();  // the slice before is done: its registers are free
      }
      wg_wait<0>();
      pin(sc);
      pin(dpc);
#pragma unroll
      for (int i = 0; i < QB / 2; ++i) {
        s[i] = first ? sc[i] : s[i] + sc[i];
        dp[i] = first ? dpc[i] : dp[i] + dpc[i];
      }
      pin(kh);
      pin(kl);
      pin(vh);
      pin(vl);
    };
    // p and dS of one query step in place of S^T and dP^T: rows are the
    // CTA's keys r_lo (h = 0) and r_lo + 8, columns the step's queries.
    // Rows past sq carry lse POS_BIG, so p is 0 there.
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
              const int kr = k0 + r_lo + 8 * h;
              if (kr >= sk || (causal && kr > q0 + qc)) p = 0.f;
            }
            dp[e] = p * (dp[e] - dl) * scale_r;
            s[e] = p;
          }
        }
    };
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;

    int g = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * QB;
      if (c >= n_ch) {
#pragma unroll
        for (int i = 0; i < QB / 2; ++i) s[i] = dp[i] = 0.f;
      }
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        if (ch % 2 != c) continue;
        const int st = g % STAGES;
        mbar_wait(a_full + 8 * st, (g / STAGES) & 1);
        const uint32_t off = L::a + st * L::A_BYTES;
        // q' and dO (adjacent) split together: lo twins 2 panels on.
        split_tile<128>(gbase + off + L::A_Q, gbase + off + L::A_QLO,
                        2 * L::Q_PANEL, tid);
        fence_async_shared();
        bar_sync(SPLIT_BAR + 1 + c, 128);
        pin(sc);
        pin(dpc);
        issue_chunk(off, ch == c);
        // Each warp releases the stage after its own wait, so the stage is
        // refilled only when every consumer warp is done with it.
        mbar_arrive_if(a_empty + 8 * st, lane == 0);
      }
      // The two halves of S^T and dP^T added: each thread's values to
      // shared memory (value i of thread tid at i * 128 + tid), then the
      // other warpgroup's same thread's back.
      float* const mine = xs + c * 128 * QB + tid;
      const float* const theirs = xs + (1 - c) * 128 * QB + tid;
#pragma unroll
      for (int i = 0; i < QB / 2; ++i) {
        mine[i * 128] = s[i];
        mine[(QB / 2 + i) * 128] = dp[i];
      }
      bar_sync(SPLIT_BAR, 256);
#pragma unroll
      for (int i = 0; i < QB / 2; ++i) {
        s[i] += theirs[i * 128];
        dp[i] += theirs[(QB / 2 + i) * 128];
      }
      const int cs = it % CSTAGES;
      mbar_wait(c_full + 8 * cs, (it / CSTAGES) & 1);
      const float* sl = stats + cs * L::STAT_FLOATS;
      // The step's first row in the keys' positions.
      int q_rel = q0;
      if constexpr (OFFSETS) q_rel += q_off - k_off;
      const bool masked = k0 + F32_DKDV_KEYS > sk ||
                          (causal && k0 + F32_DKDV_KEYS - 1 > q_rel);
      if (masked)
        grads(sl, q_rel, Masked{});
      else
        grads(sl, q_rel, Plain{});
      // P^T and dS^T per 8-query slice, hi and lo.
      uint32_t pah[QB / 8][4], pal[QB / 8][4], dah[QB / 8][4], dal[QB / 8][4];
#pragma unroll
      for (int i = 0; i < QB / 8; ++i) {
        split_acc(s, i, pah[i], pal[i]);
        split_acc(dp, i, dah[i], dal[i]);
      }
      if constexpr (WITH_DQ) {
        // dS hi and lo as query rows by keys (keys along K, two 32-key
        // panels): dah[i][v] holds key r_lo + 8 (v % 2), query 8 i + cq +
        // v / 2.  The last step's dQ products (both warpgroups) are done:
        // each waited for them before this step's barrier above.
#pragma unroll
        for (int i = 0; i < QB / 8; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int key = r_lo + 8 * (v % 2), q = 8 * i + cq + v / 2;
            const uint32_t at = (key / F32_PANEL) * L::DS_PANEL +
                                sw128(q, key % F32_PANEL);
            *reinterpret_cast<uint32_t*>(gbase + L::ds_hi + at) = dah[i][v];
            *reinterpret_cast<uint32_t*>(gbase + L::ds_lo + at) = dal[i][v];
          }
      }
      // q'^T and dO^T of the window, hi and lo, from the raw window.
      const unsigned char* win = gbase + L::c + cs * L::C_BYTES;
      stage_transposed<QB, NP>(win, gbase + L::t_hi, gbase + L::t_lo);
      stage_transposed<QB, NP>(win + NP * L::Q_PANEL,
                               gbase + L::t_hi + L::T_PANEL,
                               gbase + L::t_lo + L::T_PANEL);
      consumers_sync();
      mbar_arrive_if(c_empty + 8 * cs, tid == 0);
      // dV += P^T dO and dK += dS^T q' over this warpgroup's half of the
      // window (rows CW c .. of the staged tiles), PW columns at a time:
      // the step's sums in fresh accumulators (sc and dpc, free until the
      // next chunk), added into dV and dK in f32 registers, so no
      // truncating wgmma chain runs across query steps.
      constexpr int PW = CW <= 32 ? CW : CW % 32 == 0 ? 32 : 16;
      float(&pv)[PW / 2] = lead<PW / 2>(sc);
      float(&pk)[PW / 2] = lead<PW / 2>(dpc);
      pin(dk_acc);
      pin(dv_acc);
      if constexpr (WITH_DQ) pin(dq_acc);
      const uint32_t half = c * CW * ROW_BYTES;
#pragma unroll
      for (int p = 0; p < CW / PW; ++p) {
        wg_fence();
#pragma unroll
        for (int j = 0; j < QB / 8; ++j) {
          const uint32_t at = half + p * PW * ROW_BYTES + j * 32;
          const uint64_t qth = desc128(base + L::t_hi + at);
          const uint64_t qtl = desc128(base + L::t_lo + at);
          const uint64_t dth = desc128(base + L::t_hi + L::T_PANEL + at);
          const uint64_t dtl = desc128(base + L::t_lo + L::T_PANEL + at);
          Wgmma<PW, float>::rs(pv, pah[j], dth, j != 0);
          Wgmma<PW, float>::rs(pv, pah[j], dtl, 1);
          Wgmma<PW, float>::rs(pv, pal[j], dth, 1);
          Wgmma<PW, float>::rs(pk, dah[j], qth, j != 0);
          Wgmma<PW, float>::rs(pk, dah[j], qtl, 1);
          Wgmma<PW, float>::rs(pk, dal[j], qth, 1);
        }
        if (p + 1 < CW / PW) {
          wg_commit();
          wg_wait<0>();
          pin(pv);
          pin(pk);
#pragma unroll
          for (int e = 0; e < PW / 2; ++e) {
            dv_acc[PW / 2 * p + e] += pv[e];
            dk_acc[PW / 2 * p + e] += pk[e];
          }
        }
      }
      if constexpr (WITH_DQ) {
        // dQ^T (+)= K^T dS^T over the CTA's 64 keys, this warpgroup's 16
        // query rows: K^T hi . dS hi + hi . lo + lo . hi.
#pragma unroll
        for (int kk = 0; kk < F32_DKDV_KEYS / 8; ++kk) {
          const uint32_t ka = (kk / 4) * L::KT_PANEL + (kk % 4) * 32;
          const uint32_t sb = (kk / 4) * L::DS_PANEL +
                              c * F32_BWD_DQ_ROWS * ROW_BYTES + (kk % 4) * 32;
          const uint64_t kth = desc128(base + L::kt_hi + ka);
          const uint64_t ktl = desc128(base + L::kt_lo + ka);
          const uint64_t dsh = desc128(base + L::ds_hi + sb);
          const uint64_t dsl = desc128(base + L::ds_lo + sb);
          Wgmma<F32_BWD_DQ_ROWS, float>::ss(dq_acc, kth, dsh, kk != 0);
          Wgmma<F32_BWD_DQ_ROWS, float>::ss(dq_acc, kth, dsl, 1);
          Wgmma<F32_BWD_DQ_ROWS, float>::ss(dq_acc, ktl, dsh, 1);
        }
      }
      wg_commit();
      wg_wait<0>();
      pin(pv);
      pin(pk);
#pragma unroll
      for (int e = 0; e < PW / 2; ++e) {
        dv_acc[CW / 2 - PW / 2 + e] += pv[e];
        dk_acc[CW / 2 - PW / 2 + e] += pk[e];
      }
      pin(dk_acc);
      pin(dv_acc);
      pin(pah);
      pin(pal);
      pin(dah);
      pin(dal);
      if constexpr (WITH_DQ) {
        pin(dq_acc);
        // This step's dQ into the caller's f32 tensor: into this
        // warpgroup's tile (query row n, window column m: panel m / 32,
        // 128-byte swizzle), then one TMA reduce-add per own panel (rows
        // past sq are not written).  The last step's reduce must have read
        // the tile first.  dq_acc[4 i + 2 h + j] holds column r_lo + 8 h,
        // query row 8 i + cq + j.
        if (tid == 0) bulk_wait_all<true>();
        bar_sync(SPLIT_BAR + 1 + c, 128);
        unsigned char* const tile = gbase + L::dq + c * L::DQ_BYTES;
#pragma unroll
        for (int i = 0; i < F32_BWD_DQ_ROWS / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = r_lo + 8 * h;
            if (m >= NP * F32_PANEL) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j)
              *reinterpret_cast<float*>(
                  tile + (m / F32_PANEL) * L::DQ_PANEL +
                  sw128(8 * i + cq + j, m % F32_PANEL)) =
                  dq_acc[4 * i + 2 * h + j];
          }
        fence_async_shared();
        bar_sync(SPLIT_BAR + 1 + c, 128);
        if (tid == 0) {
          for (int p = cols.start - cols.w0;
               p < cols.start - cols.w0 + cols.own; ++p)
            tma_reduce_add(mdq, base + L::dq + c * L::DQ_BYTES +
                                    p * L::DQ_PANEL,
                           (cols.w0 + p) * F32_PANEL,
                           q0 + c * F32_BWD_DQ_ROWS, bh);
          bulk_commit();
        }
      }
    }
    // B2: the adds complete before the CTA's shared memory goes away.
    if constexpr (WITH_DQ)
      if (tid == 0) bulk_wait_all<false>();

    // dK and dV of the CTA's keys on this warpgroup's own columns.
    const int own0 = (cols.start - cols.w0) * F32_PANEL;
    const int own1 = own0 + cols.own * F32_PANEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + r_lo + 8 * h;
      if (key >= sk) continue;
      const size_t at = ((size_t)bh * sk + key) * d + cols.w0 * F32_PANEL +
                        c * CW + cq;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i) {
        const int col = c * CW + 8 * i;  // within the window
        if (col >= own0 && col < own1) {
          const int e = 4 * i + 2 * h;
          *reinterpret_cast<float2*>(dk + at + 8 * i) =
              make_float2(dk_acc[e], dk_acc[e + 1]);
          *reinterpret_cast<float2*>(dv + at + 8 * i) =
              make_float2(dv_acc[e], dv_acc[e + 1]);
        }
      }
    }
  }
}

template <int NP>
struct DqSmem {
  static constexpr uint32_t Q_PANEL = F32_DQ_ROWS * ROW_BYTES;  // 16 KB
  static constexpr uint32_t K_PANEL = F32_DQ_KEYS * ROW_BYTES;  // 4 KB
  // Stage s: the chunk's q' and dO panels, K and V panels (hi once split)
  // and their lo twins.
  static constexpr uint32_t A_Q = 0;
  static constexpr uint32_t A_DO = A_Q + Q_PANEL;
  static constexpr uint32_t A_K = A_DO + Q_PANEL;
  static constexpr uint32_t A_V = A_K + K_PANEL;
  static constexpr uint32_t A_KLO = A_V + K_PANEL;
  static constexpr uint32_t A_BYTES = A_KLO + 2 * K_PANEL;
  static constexpr uint32_t KW_BYTES = NP * K_PANEL;  // raw K window
  // K^T: the window's 32 NP columns x the keys, in panels of 32 keys.
  static constexpr uint32_t KT_PANEL = NP * F32_PANEL * ROW_BYTES;
  static constexpr uint32_t KT_BYTES = F32_DQ_KEYS / F32_PANEL * KT_PANEL;
  static constexpr uint32_t a = 0;
  static constexpr uint32_t kw = a + F32_DQ_STAGES * A_BYTES;
  static constexpr uint32_t kt_hi = kw + KW_BYTES;
  static constexpr uint32_t kt_lo = kt_hi + KT_BYTES;
  static constexpr uint32_t bars = kt_lo + KT_BYTES;
  // a_full, a_empty [F32_DQ_STAGES], kw_full, kw_empty
  static constexpr uint32_t N_BARS = 2 * F32_DQ_STAGES + 2;
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// K3: dq's own columns of query rows [q0, q0 + F32_DQ_ROWS) of head bh,
// over a window of NP panels, in registers across the key loop, times
// dq_scale and written once: no atomics, so deterministic.  mq, mdo: maps
// of q', dO (bh, sq, d), boxes of F32_DQ_ROWS rows; mk, mv: k, v (bh, sk,
// d), boxes of F32_DQ_KEYS rows; lse, delta: (bh, sq) f32.  K1's skeleton:
// per key tile, S = q' K^T and dP = dO V^T chunk by chunk (q' and dO split
// in registers as the A fragments, K and V split in shared memory as B),
// each chunk summed in fresh accumulators and added in f32 registers;
// then dS = p (dP - delta) scale_r with the causal and ragged masks, and
// dQ += dS K with dS split from the accumulators and K^T of the window
// staged hi / lo, keys permuted to the accumulator's order: each panel of
// the tile's dS K in a fresh accumulator, added into dQ in f32 registers.
template <int NP>
__device__ __forceinline__ void dq_tile(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int bh, int cc,
    int q0, int sq, int sk, int d, float scale_r, float dq_scale,
    int causal) {
  using L = DqSmem<NP>;
  constexpr int BN = F32_DQ_KEYS, CW = NP * F32_PANEL;
  constexpr int STAGES = F32_DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t a_full = base + L::bars, a_empty = a_full + 8 * STAGES;
  const uint32_t kw_full = a_empty + 8 * STAGES, kw_empty = kw_full + 8;
  const int n_ch = d / F32_PANEL;
  const Cols cols = col_share<NP>(d, cc);

  int n_kt = (sk + BN - 1) / BN;
  // Key tiles past the CTA's last row are wholly masked.
  if (causal) n_kt = min(n_kt, (q0 + F32_DQ_ROWS - 1) / BN + 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(kw_full, 1);
    mbar_init(kw_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {
    // Producer: per key tile, the (q', dO, K, V) panels of each chunk,
    // then the raw K window (one buffer: the consumers release it once
    // staged).
    if (threadIdx.x == 256) {
      int g = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        for (int ch = 0; ch < n_ch; ++ch, ++g) {
          const int st = g % STAGES;
          if (g >= STAGES) mbar_wait(a_empty + 8 * st, (g / STAGES - 1) & 1);
          const uint32_t sa = base + L::a + st * L::A_BYTES;
          const uint32_t bar = a_full + 8 * st;
          const int col = ch * F32_PANEL;
          mbar_expect_tx(bar, 2 * (L::Q_PANEL + L::K_PANEL));
          tma_load(sa + L::A_Q, mq, bar, col, q0, bh);
          tma_load(sa + L::A_DO, mdo, bar, col, q0, bh);
          tma_load(sa + L::A_K, mk, bar, col, kt * BN, bh);
          tma_load(sa + L::A_V, mv, bar, col, kt * BN, bh);
        }
        if (kt > 0) mbar_wait(kw_empty, (kt - 1) & 1);
        mbar_expect_tx(kw_full, L::KW_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load(base + L::kw + p * L::K_PANEL, mk, kw_full,
                   (cols.w0 + p) * F32_PANEL, kt * BN, bh);
      }
    }
  } else {
    // Consumers: warpgroup c owns rows [q0 + 64 c, q0 + 64 c + 64) and the
    // CTA's window of dq's columns.
    const int c = wg, tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
    const int cq = 2 * (lane % 4);                // + 8 i + j: the column
    const int row0 = c * 64;                      // within the CTA
    const int wg_first = q0 + row0;
    const float scale_log2 = scale_r * LOG2E;
    // lse (log2 units) and delta of the thread's two rows; POS_BIG past
    // sq, so p is 0 there.
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg_first + r_lo + 8 * h;
      const size_t at = (size_t)bh * sq + row;
      lse2[h] = (row < sq ? lse[at] : POS_BIG) * LOG2E;
      dl[h] = row < sq ? delta[at] : 0.f;
    }

    float acc[CW / 2];
    float s[BN / 2];    // S summed over the chunks, then p
    float dp[BN / 2];   // dP summed over the chunks, then dS
    float sc[BN / 2];   // one chunk's S
    float dpc[BN / 2];  // one chunk's dP
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;

    // S (+)= q' K^T and dP (+)= dO V^T over the chunk in stage `off`: per
    // k8 slice the q' and dO fragments split in registers (two slices in
    // flight) against K and V hi and lo, into sc and dpc, then added into
    // S and dP in registers.
    auto issue_chunk = [&](uint32_t off, bool first) {
      uint32_t qh[2][4], ql[2][4], oh[2][4], ol[2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int b = kk % 2;
        load_a(gbase + off + L::A_Q, row0 + r_lo, kk, qh[b], ql[b]);
        load_a(gbase + off + L::A_DO, row0 + r_lo, kk, oh[b], ol[b]);
        const uint32_t at = base + off + kk * 32;
        const uint64_t kh = desc128(at + L::A_K);
        const uint64_t vh = desc128(at + L::A_V);
        const uint64_t kl = desc128(at + L::A_KLO);
        const uint64_t vl = desc128(at + L::A_KLO + L::K_PANEL);
        wg_fence();
        Wgmma<BN, float>::rs(sc, qh[b], kh, kk != 0);
        Wgmma<BN, float>::rs(sc, qh[b], kl, 1);
        Wgmma<BN, float>::rs(sc, ql[b], kh, 1);
        Wgmma<BN, float>::rs(dpc, oh[b], vh, kk != 0);
        Wgmma<BN, float>::rs(dpc, oh[b], vl, 1);
        Wgmma<BN, float>::rs(dpc, ol[b], vh, 1);
        wg_commit();
        wg_wait<1>();  // the slice before is done: its registers are free
      }
      wg_wait<0>();
      pin(sc);
      pin(dpc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[i] = first ? sc[i] : s[i] + sc[i];
        dp[i] = first ? dpc[i] : dp[i] + dpc[i];
      }
      pin(qh);
      pin(ql);
      pin(oh);
      pin(ol);
    };
    // dS of key tile kt in place of dP, rows r_lo (h = 0) and r_lo + 8:
    // p = exp(S scale_r - lse), 0 where masked.
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
    // diagonal or the ragged tail on, every tile does.
    int n_plain = min(n_kt, sk / BN);
    if (causal) {
      const int x = wg_first - BN + 1;  // k0 <= x: no key masked
      n_plain = min(n_plain, x < 0 ? 0 : x / BN + 1);
    }
    using Plain = std::integral_constant<bool, false>;
    using Masked = std::integral_constant<bool, true>;

    int g = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      for (int ch = 0; ch < n_ch; ++ch, ++g) {
        const int st = g % STAGES;
        mbar_wait(a_full + 8 * st, (g / STAGES) & 1);
        const uint32_t off = L::a + st * L::A_BYTES;
        // K and V (adjacent) split together: lo twins 2 panels on.
        split_tile<256>(gbase + off + L::A_K, gbase + off + L::A_KLO,
                        2 * L::K_PANEL, threadIdx.x);
        consumers_sync();
        pin(sc);
        pin(dpc);
        issue_chunk(off, ch == 0);
        // Each warp releases the stage after its own wait, so the stage is
        // refilled only when every consumer warp is done with it.
        mbar_arrive_if(a_empty + 8 * st, lane == 0);
      }
      if (kt < n_plain)
        grads(kt, Plain{});
      else
        grads(kt, Masked{});
      // K^T of the window, hi and lo, from the raw K window.
      mbar_wait(kw_full, kt & 1);
      stage_transposed<BN, NP>(gbase + L::kw, gbase + L::kt_hi,
                               gbase + L::kt_lo);
      consumers_sync();
      mbar_arrive_if(kw_empty, tid == 0);
      // dQ += dS K over the CTA's window, one 32-column panel at a time:
      // the panel's sum over the tile's keys goes into a fresh accumulator
      // (sc, free until the next chunk) and is added into acc in f32
      // registers, so no truncating wgmma chain runs across key tiles.  dS
      // split into its hi / lo A fragment one 8-key slice at a time, two
      // slices in flight.
      static_assert(BN == F32_PANEL, "sc holds one panel of dQ");
      uint32_t dh[2][4], dlo[2][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        // Split again (tf32() is a plain asm, which the compiler would
        // otherwise keep for every slice across the parts: spills).
        if (p > 0) pin(dp);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          split_acc(dp, j, dh[j % 2], dlo[j % 2]);
          const uint32_t kp =
              p * F32_PANEL * ROW_BYTES + (j / 4) * L::KT_PANEL + (j % 4) * 32;
          const uint64_t kth = desc128(base + L::kt_hi + kp);
          const uint64_t ktl = desc128(base + L::kt_lo + kp);
          wg_fence();
          Wgmma<F32_PANEL, float>::rs(sc, dh[j % 2], kth, j != 0);
          Wgmma<F32_PANEL, float>::rs(sc, dh[j % 2], ktl, 1);
          Wgmma<F32_PANEL, float>::rs(sc, dlo[j % 2], kth, 1);
          wg_commit();
          wg_wait<1>();
        }
        wg_wait<0>();
        pin(sc);
#pragma unroll
        for (int e = 0; e < F32_PANEL / 2; ++e)
          acc[F32_PANEL / 2 * p + e] += sc[e];
      }
      pin(dh);
      pin(dlo);
    }

    // dq = dQ dq_scale on the own columns.
    const int own0 = (cols.start - cols.w0) * F32_PANEL;
    const int own1 = own0 + cols.own * F32_PANEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg_first + r_lo + 8 * h;
      if (row >= sq) continue;
      float* dst =
          dq + ((size_t)bh * sq + row) * d + cols.w0 * F32_PANEL + cq;
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
        if (8 * i >= own0 && 8 * i < own1)
          *reinterpret_cast<float2*>(dst + 8 * i) =
              make_float2(acc[4 * i + 2 * h] * dq_scale,
                          acc[4 * i + 2 * h + 1] * dq_scale);
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, float* __restrict__ o,
               float* __restrict__ lse, int bh_total, int sq, int sk, int d,
               float scale_r, int causal) {
  const int n_cc = col_ctas<NP>(d);
  const int n_qt = (sq + F32_FWD_ROWS - 1) / F32_FWD_ROWS;
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int qt = n_qt - 1 - rest / n_cc;  // heavy (late) query tiles first
  fwd_tile<NP>(&mq, &mk, &mv, o, lse, bh, rest % n_cc, qt * F32_FWD_ROWS,
               sq, sk, d, 0, 0, scale_r, causal);
}

template <int NP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int bh_total, int sq, int sk, int d,
                float scale_r, int causal) {
  const int n_cc = col_ctas<NP>(d);
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int kt = rest / n_cc;  // heavy (early) key tiles first
  dkdv_tile<NP>(&mq, &mdo, &mk, &mv, nullptr, lse, delta, dk, dv, bh,
                rest % n_cc, kt * F32_DKDV_KEYS, sq, sk, d, 0, 0, scale_r,
                causal);
}

template <int NP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mdo,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mdq,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int bh_total, int sq, int sk, int d,
               float scale_r, int causal) {
  const int n_cc = col_ctas<NP>(d);
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int kt = rest / n_cc;  // heavy (early) key tiles first
  dkdv_tile<NP, true>(&mq, &mdo, &mk, &mv, &mdq, lse, delta, dk, dv, bh,
                      rest % n_cc, kt * F32_DKDV_KEYS, sq, sk, d, 0, 0,
                      scale_r, causal);
}

template <int NP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mdo,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              int bh_total, int sq, int sk, int d, float scale_r,
              float dq_scale, int causal) {
  const int n_cc = col_ctas<NP>(d);
  const int n_qt = (sq + F32_DQ_ROWS - 1) / F32_DQ_ROWS;
  const int bh = blockIdx.x % bh_total, rest = blockIdx.x / bh_total;
  const int qt = n_qt - 1 - rest / n_cc;  // heavy (late) query tiles first
  dq_tile<NP>(&mq, &mdo, &mk, &mv, lse, delta, dq, bh, rest % n_cc,
              qt * F32_DQ_ROWS, sq, sk, d, scale_r, dq_scale, causal);
}

// Set each kernel's shared-memory limit once, before its first launch
// (internal linkage: a mutant build loaded beside this one keeps its own).
namespace {
bool g_prepared[4][F32_FWD_NP + 1] = {};
}  // namespace

template <typename K>
int prepare(int which, int np, K kernel, size_t bytes) {
  if (g_prepared[which][np]) return 0;
  const int e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  g_prepared[which][np] = e == 0;
  return e;
}

// The window of head dim D: all of it up to 128 (one column CTA), 4
// panels above (column CTAs); B2's all of it up to 64, 2 panels above.
static_assert(F32_FWD_NP == F32_DKDV_NP && F32_FWD_NP == F32_DQ_NP,
              "one window for K1, K2 and K3");
template <int D>
__host__ __device__ constexpr int window_panels() {
  return D < F32_FWD_NP * F32_PANEL ? D / F32_PANEL : F32_FWD_NP;
}
template <int D>
__host__ __device__ constexpr int bwd_window_panels() {
  return D < F32_BWD_NP * F32_PANEL ? D / F32_PANEL : F32_BWD_NP;
}

// K1 over windows of NP panels: NP = d / 32 up to 128, 4 above (column
// CTAs of 4 panels).
template <int NP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, int d, float scale_r,
               int causal, cudaStream_t stream) {
  int e = prepare(0, NP, fwd_kernel<NP>, FwdSmem<NP>::bytes);
  CUtensorMap mq, mk, mv;
  if (e == 0) e = make_map<float>(&mq, q, bh, sq, d, F32_FWD_ROWS);
  if (e == 0) e = make_map<float>(&mk, k, bh, sk, d, F32_FWD_KEYS);
  if (e == 0) e = make_map<float>(&mv, v, bh, sk, d, F32_FWD_KEYS);
  if (e != 0) return e;
  const int blocks = bh * ((sq + F32_FWD_ROWS - 1) / F32_FWD_ROWS) *
                     col_ctas<NP>(d);
  fwd_kernel<NP><<<blocks, WIDE_THREADS, FwdSmem<NP>::bytes, stream>>>(
      mq, mk, mv, static_cast<float*>(o), lse, bh, sq, sk, d, scale_r,
      causal);
  return (int)cudaGetLastError();
}

// K2 over windows of NP panels, as launch_fwd.
template <int NP>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int bh, int sq, int sk, int d,
                float scale_r, int causal, cudaStream_t stream) {
  int e = prepare(1, NP, dkdv_kernel<NP>, DkdvSmem<NP>::bytes);
  CUtensorMap mq, mdo, mk, mv;
  if (e == 0) e = make_map<float>(&mq, q, bh, sq, d, F32_DKDV_ROWS);
  if (e == 0) e = make_map<float>(&mdo, dout, bh, sq, d, F32_DKDV_ROWS);
  if (e == 0) e = make_map<float>(&mk, k, bh, sk, d, F32_DKDV_KEYS);
  if (e == 0) e = make_map<float>(&mv, v, bh, sk, d, F32_DKDV_KEYS);
  if (e != 0) return e;
  const int blocks = bh * ((sk + F32_DKDV_KEYS - 1) / F32_DKDV_KEYS) *
                     col_ctas<NP>(d);
  dkdv_kernel<NP><<<blocks, WIDE_THREADS, DkdvSmem<NP>::bytes, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, sq, sk, d, scale_r, causal);
  return (int)cudaGetLastError();
}

// B2 over windows of NP panels (bwd_window_panels): dK and dV stored,
// dQ added into dq32 (zeroed by the caller).
template <int NP>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, float* dq32, int bh, int sq, int sk,
               int d, float scale_r, int causal, cudaStream_t stream) {
  using L = DkdvSmem<NP, true>;
  int e = prepare(2, NP, bwd_kernel<NP>, L::bytes);
  CUtensorMap mq, mdo, mk, mv, mdq;
  if (e == 0) e = make_map<float>(&mq, q, bh, sq, d, F32_DKDV_ROWS);
  if (e == 0) e = make_map<float>(&mdo, dout, bh, sq, d, F32_DKDV_ROWS);
  if (e == 0) e = make_map<float>(&mk, k, bh, sk, d, F32_DKDV_KEYS);
  if (e == 0) e = make_map<float>(&mv, v, bh, sk, d, F32_DKDV_KEYS);
  if (e == 0) e = make_map<float>(&mdq, dq32, bh, sq, d, F32_BWD_DQ_ROWS);
  if (e != 0) return e;
  const int blocks = bh * ((sk + F32_DKDV_KEYS - 1) / F32_DKDV_KEYS) *
                     col_ctas<NP>(d);
  bwd_kernel<NP><<<blocks, WIDE_THREADS, L::bytes, stream>>>(
      mq, mdo, mk, mv, mdq, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, sq, sk, d, scale_r, causal);
  return (int)cudaGetLastError();
}

// K3 over windows of NP panels, as launch_fwd.
template <int NP>
int launch_dq(const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, int bh, int sq, int sk, int d, float scale_r,
              float dq_scale, int causal, cudaStream_t stream) {
  int e = prepare(3, NP, dq_kernel<NP>, DqSmem<NP>::bytes);
  CUtensorMap mq, mdo, mk, mv;
  if (e == 0) e = make_map<float>(&mq, q, bh, sq, d, F32_DQ_ROWS);
  if (e == 0) e = make_map<float>(&mdo, dout, bh, sq, d, F32_DQ_ROWS);
  if (e == 0) e = make_map<float>(&mk, k, bh, sk, d, F32_DQ_KEYS);
  if (e == 0) e = make_map<float>(&mv, v, bh, sk, d, F32_DQ_KEYS);
  if (e != 0) return e;
  const int blocks = bh * ((sq + F32_DQ_ROWS - 1) / F32_DQ_ROWS) *
                     col_ctas<NP>(d);
  dq_kernel<NP><<<blocks, WIDE_THREADS, DqSmem<NP>::bytes, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<float*>(dq), bh, sq, sk, d,
      scale_r, dq_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace wide32
}  // namespace hvdt
