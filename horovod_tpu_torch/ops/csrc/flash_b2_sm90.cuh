// B2's 16-bit body (flash_bwd.cu, hvdt_flash_bwd): the flash-attention
// backward wherever the reference's plan picks the combined mode, the
// main path's backward, for Hopper (sm_90a).  Replaces the Pallas TPU
// kernel `_combined_bwd_kernel` (horovod_tpu/ops/attention.py:498, math in
// `_bwd_block_math` :386) with rotate=False: one recompute of P and dP per
// (query tile, key tile) pair feeds dK, dV and dQ.  The math, the masks
// and the roundings are those of flash_bwd_sm90.cuh's body, which K5 and
// K2 keep (its note gives them): p and dS rounded to 16 bits before the
// products that take them, p exactly 0 where masked and on POS_BIG rows,
// dQ summed in f32 in q' units.  dK and dV come out in the input dtype.
//
// Bound on the card: at the training shape (bh 128, seq 1024, head dim
// 64, bf16, causal) 43.0 GFLOP (five products, 10 d FLOP a causal pair)
// against 118 MB, so 0.0435 ms of tensor-core time at 989 TFLOP/s.  The
// design keeps the tensor cores fed across the query loop:
//
// * CTAs of the two consumer warpgroups alone (B2_THREADS), one per
//   128-key tile of a head (a work item); warpgroup c owns keys [64 c, 64 c
//   + 64) and all columns of their dK and dV in f32 registers.  With no
//   producer warpgroup the launch bound gives a thread up to 255 registers
//   (ptxas allocates to the bound: 168 at 384 threads, sm90_common.cuh),
//   so no head dim spills for want of them.  Thread 0 TMA-loads K and V
//   once and the (q', dO) tiles of 64 query rows into B2_STAGES stages;
//   128 threads each read one of a tile's lse and delta values (POS_BIG
//   and 0 past the end) from global memory a tile ahead into shared
//   memory.  That read is issued right after a tile's barrier:
//   fence.proxy.async compiles to MEMBAR.ALL.CTA, which waits for the
//   thread's loads in flight, and issued before the fence it stalled the
//   CTA every tile.
// * Per query tile: S^T = K q'^T and dP^T = V dO^T (M = keys) land in
//   registers; p and dS in place; P^T and dS^T packed to 16 bits as the A
//   operands of dV += P^T dO and dK += dS^T q'; dS^T also stored to one of
//   two shared buffers, from which dQ = dS K reads it (split between the
//   warpgroups by columns at head dims 64 and 128, by keys at 32 and 96,
//   where half the head dim would start inside a swizzle panel).  One
//   named barrier of both warpgroups a tile: both halves of dS^T are in
//   place and every product of the tile before is done, so once its
//   warpgroup's products are issued thread 0 refills that tile's stage,
//   with no empty barriers.  Each product's descriptor is one add to a
//   word kept per tile (desc_lo).
// * Software pipelining (b2_pipelined: head dims 32 and 64, where the
//   registers allow): S^T and dP^T of tile it + 1 are issued before dV, dK
//   and dQ of tile it, and the exp and dS step of tile it + 1 runs while
//   those three products are in flight (wgmma.wait_group 1); each form
//   issues and retires its own groups, since a product in flight across a
//   branch serializes them (ptxas C7514).  At 96 and 128 the registers
//   would not hold it (C7512): a tile's products follow its own
//   elementwise step.
// * dQ: each warpgroup writes its f32 dQ tile into one of b2_dq_buffers
//   shared buffers (128-byte swizzle) and each warp adds its own 16 rows
//   to the caller's buffer by TMA reduce (`cp.reduce.async.bulk.tensor`),
//   so no barrier gathers the tile.  The reduce of the tile that many back
//   must have read a buffer before it is written again: each warp's
//   issuing lane waits for its own before the tile's named barrier.
// * Work items at head dims 64-128 go in sm90::tile_order: each head's key
//   tiles adjacent, heavy (early, under a causal mask) first, from
//   HEADS_TOGETHER_MIN_CTAS items, so the CTAs that stream one head's
//   (q', dO) run together and read it from L2; below that, and at head
//   dim 32, the head fastest.
//
// Each choice was timed in turns against the others
// (tools/torch_split_variants.py --family b2).  Shared memory, (K, V) +
// 3 stages of (q', dO) + 2 dS^T buffers + dQ buffers of both warpgroups
// (+ 1 KB of stats): D 32: 16 + 24 + 32 + 32 KB; D 64: 32 + 48 + 32 + 32
// KB; D 96: 48 + 72 + 32 + 48 KB; D 128: 64 + 96 + 32 + 32 KB.  Every
// mbarrier wait traps after 2 s (sm90_common.cuh).

#pragma once

#include "flash_bwd_sm90.cuh"

namespace hvdt {
namespace sm90 {

constexpr int B2_THREADS = 256;  // the two consumer warpgroups

// Whether S^T and dP^T of the next query tile are computed while the
// current tile's dV, dK and dQ products run.
template <int D>
__host__ __device__ constexpr bool b2_pipelined() {
  return D <= 64;
}
// (q', dO) stages: a stage is refilled once every product of its tile is
// done, after the next tile's barrier, when (pipelined) the tile after
// that one is already read; three stages keep a refill a whole tile ahead
// of its use.
constexpr int B2_STAGES = 3;
// Whether the work items go in sm90::tile_order (each head's key tiles
// together from HEADS_TOGETHER_MIN_CTAS items) or with the head fastest
// at every grid size: at head dim 32 the head fastest was faster.
template <int D>
__host__ __device__ constexpr bool b2_heads_together() {
  return D >= 64;
}
// Rows of a warp's share of a dQ tile: each warp adds its own rows by TMA
// reduce, so no barrier gathers the warpgroup's tile.
constexpr int B2_DQ_ROWS = 16;
// f32 dQ buffers per warpgroup: two where shared memory holds them beside
// three stages.
template <int D>
__host__ __device__ constexpr int b2_dq_buffers() {
  return D <= 64 ? 2 : 1;
}

template <int D>
struct B2Smem {
  static constexpr int STAGES = B2_STAGES;
  static constexpr int DQ_BUFS = b2_dq_buffers<D>();
  // dQ = dS K split by keys (each warpgroup its own 64 keys, all D
  // columns) where half the head dim is not a whole number of panels.
  static constexpr bool SPLIT_KEYS = (D / 2) % PANEL != 0;
  static constexpr int PANELS = D / PANEL;
  static constexpr uint32_t K_PANEL = BWD_BN * PANEL * 2;
  static constexpr uint32_t Q_PANEL = BWD_BM * PANEL * 2;  // 4 KB
  static constexpr uint32_t K_BYTES = PANELS * K_PANEL;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  // dS^T: BWD_BM / PANEL panels of 128 key rows x 32 query columns.
  static constexpr uint32_t DS_PANEL = BWD_BN * PANEL * 2;
  static constexpr uint32_t DS_BYTES = (BWD_BM / PANEL) * DS_PANEL;
  // A warpgroup's f32 dQ tile: DQ_N / 32 panels of 64 rows x 128 B,
  // 128-byte swizzle, as the TMA reduce reads it.
  static constexpr int DQ_N = SPLIT_KEYS ? D : D / 2;
  static constexpr uint32_t DQ_PANEL = BWD_BM * 32 * 4;
  static constexpr uint32_t DQ_BYTES = (DQ_N / 32) * DQ_PANEL;
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + K_BYTES;
  static constexpr uint32_t q = v + K_BYTES;
  static constexpr uint32_t dout = q + STAGES * Q_BYTES;
  static constexpr uint32_t ds = dout + STAGES * Q_BYTES;  // 2 buffers
  static constexpr uint32_t dq = ds + 2 * DS_BYTES;  // [warpgroup][buffer]
  // lse (log2 units), then delta, of the query rows of two tiles.
  static constexpr uint32_t stats = dq + 2 * DQ_BUFS * DQ_BYTES;
  static constexpr uint32_t STAT_FLOATS = 2 * BWD_BM;
  static constexpr uint32_t bars = stats + 2 * STAT_FLOATS * 4;
  static constexpr uint32_t N_BARS = 1 + STAGES;  // kv_full, full[STAGES]
  // + 1024: the dynamic base is aligned up to the swizzle pattern.
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
  static_assert(D % PANEL == 0 && D <= 128, "head dims 32, 64, 96, 128");
  static_assert(bytes <= 232448, "more shared memory than a CTA gets");
};

// A wgmma shared-memory descriptor (sm90::desc, stride 512 B, 64-byte
// swizzle) in halves: the low word holds the start address and the
// leading byte offset, the high word the stride and the swizzle.  A
// shared-memory address (below 256 KB) moved by a multiple of 16 bytes
// moves the low word by off >> 4, so each product's descriptor is one add
// to a word kept per tile instead of a shift, a mask and an or.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lead) {
  return ((addr >> 4) & 0x3FFF) | (((lead >> 4) & 0x3FFF) << 16);
}
__device__ __forceinline__ uint64_t desc_of(uint32_t lo) {
  return (static_cast<uint64_t>((512 >> 4) | (2u << 30)) << 32) | lo;
}

// Wait until at most N of this thread's bulk groups have yet to read
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// One work item of B2's grid: the 128-key tile at k0 of head bh, and the
// query tiles [qt0, qt0 + n_it) that see one of its keys.
struct B2Item {
  int bh, k0, qt0, n_it;
};

// Work item `item` of bh_total heads' key tiles, heavy (early, under a
// causal mask) tiles first: in sm90::tile_order, or the head fastest.
template <int D>
__device__ __forceinline__ B2Item b2_item(int item, int bh_total, int sq,
                                          int sk, int causal) {
  const int n_kt = (sk + BWD_BN - 1) / BWD_BN;
  const int2 t = b2_heads_together<D>()
                     ? tile_order(item, bh_total, n_kt)
                     : make_int2(item % bh_total, item / bh_total);
  const int k0 = t.y * BWD_BN;
  // Under a causal mask, from the first query tile whose last row reaches
  // the tile's first key (reference: `q_start + block_q - 1 >= k_start`).
  const int n_qt = (sq + BWD_BM - 1) / BWD_BM;
  int qt0 = 0;
  if (causal) {
    const int need = k0 - BWD_BM + 1;
    qt0 = need <= 0 ? 0 : (need + BWD_BM - 1) / BWD_BM;
  }
  const int n_it = max(0, n_qt - qt0);
  return B2Item{t.x, k0, qt0, n_it};
}

// B2's 16-bit body (the file's note gives the design): one CTA of
// B2_THREADS threads computes dK and dV of the keys of work item
// blockIdx.x and adds their share of dQ into the f32 tensor behind `mdq`.
// mq, mdo (boxes of BWD_BM rows), mk, mv (BWD_BN rows), mdq (f32,
// B2_DQ_ROWS rows): tensor maps of q', dO and dq (bh, sq, D) and k, v (bh,
// sk, D) in the kernel's parameter space.  lse, delta (bh, sq) f32; dk, dv
// (bh, sk, D) in T.
template <typename T, int D>
__device__ __forceinline__ void b2_cta(
    const CUtensorMap* mq, const CUtensorMap* mdo, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mdq,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int bh_total, int sq, int sk,
    float scale_r, int causal) {
  using L = B2Smem<D>;
  constexpr int STAGES = L::STAGES, DQ_BUFS = L::DQ_BUFS;
  constexpr bool PIPE = b2_pipelined<D>();
  constexpr bool SPLIT_KEYS = L::SPLIT_KEYS;
  constexpr int DQ_N = L::DQ_N;  // dQ columns per warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base + L::k, v_s = base + L::v, q_s = base + L::q;
  const uint32_t do_s = base + L::dout;
  const uint32_t kv_full = base + L::bars, full = kv_full + 8;
  float* const stats_s = reinterpret_cast<float*>(gbase + L::stats);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_lo = (tid / 32) * 16 + lane / 4;  // + 8 for the second row
  const int cq = 2 * (lane % 4);                // + 8 i + j: the column
  const int key_row0 = c * WG_KEYS;             // within the tile
  const float scale_log2 = scale_r * LOG2E;
  // dQ: k16 slices [j0, j0 + JN) of the keys, columns [col0, + DQ_N).
  constexpr int JN = SPLIT_KEYS ? WG_KEYS / 16 : BWD_BN / 16;
  const int j0 = SPLIT_KEYS ? c * (WG_KEYS / 16) : 0;
  const int col0 = SPLIT_KEYS ? 0 : c * DQ_N;
  constexpr int QK_STEPS = D / 16, Q_SLICES = BWD_BM / 16;
  constexpr int NQ = BWD_BM / 8;  // query column groups of a thread

  const B2Item w = b2_item<D>(blockIdx.x, bh_total, sq, sk, causal);
  const int n_it = w.n_it;
  const int key_first = w.k0 + key_row0;

  // Thread 0 loads query tile `it` into its stage (it % STAGES); called
  // once nothing reads the stage.
  auto load_tile = [&](int it) {
    if (threadIdx.x == 0 && it < n_it) {
      const int st = it % STAGES;
      const int q0 = (w.qt0 + it) * BWD_BM;
      mbar_expect_tx(full + 8 * st, 2 * L::Q_BYTES);
      tma_tile<D>(q_s + st * L::Q_BYTES, mq, full + 8 * st, BWD_BM, q0,
                  w.bh);
      tma_tile<D>(do_s + st * L::Q_BYTES, mdo, full + 8 * st, BWD_BM, q0,
                  w.bh);
    }
  };
  // The first 2 BWD_BM threads each read one value of a tile's stats from
  // global memory a tile before it goes into shared memory: thread t < 64
  // the lse (log2 units) of row t, thread 64 + t its delta; POS_BIG and 0
  // past sq, so p and dS are exactly 0 there.  Tile it's stats sit in
  // buffer it % 2, written before the barrier of tile it - 1 (tile 0's:
  // before the first barrier) and read after it.  The read is issued
  // right after a tile's barrier: a proxy fence (fence.proxy.async, a
  // MEMBAR) waits for the thread's loads in flight, and the tile's next
  // one comes a whole product group later.
  auto stat_of = [&](int it) {
    const int row = (w.qt0 + it) * BWD_BM + threadIdx.x % BWD_BM;
    if (threadIdx.x >= L::STAT_FLOATS || it >= n_it) return 0.f;
    const size_t at = (size_t)w.bh * sq + row;
    if (threadIdx.x < BWD_BM) return (row < sq ? lse[at] : POS_BIG) * LOG2E;
    return row < sq ? delta[at] : 0.f;
  };
  auto put_stat = [&](float x, int it) {
    if (threadIdx.x < L::STAT_FLOATS)
      stats_s[(it % 2) * L::STAT_FLOATS + threadIdx.x] = x;
  };
  // S^T = K q'^T and dP^T = V dO^T of tile `it` (M = this warpgroup's
  // keys), issued as one wgmma group once the tile has arrived.
  const uint32_t k_lo = desc_lo(k_s + key_row0 * 64, 16);
  const uint32_t v_lo = desc_lo(v_s + key_row0 * 64, 16);
  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int it) {
    const int st = it % STAGES;
    const uint32_t q_lo = desc_lo(q_s, 16) + st * (L::Q_BYTES >> 4);
    const uint32_t do_lo = desc_lo(do_s, 16) + st * (L::Q_BYTES >> 4);
    // The products overwrite them; zeros say so to the compiler, which
    // would otherwise keep the last tile's values alive through them.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(full + 8 * st, (it / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QK_STEPS; ++kk) {
      const uint32_t off = (kk % 2) * 32;  // bytes into the 64-B row
      const uint32_t panel = ((kk / 2) * L::K_PANEL + off) >> 4;
      const uint32_t qpanel = ((kk / 2) * L::Q_PANEL + off) >> 4;
      Wgmma<BWD_BM, T>::ss(s, desc_of(k_lo + panel), desc_of(q_lo + qpanel),
                           kk > 0);
      Wgmma<BWD_BM, T>::ss(dp, desc_of(v_lo + panel),
                           desc_of(do_lo + qpanel), kk > 0);
    }
    wg_commit();
  };
  // p and dS of a tile in place of S^T and dP^T: rows are this
  // warpgroup's keys r_lo (h = 0) and r_lo + 8, columns the tile's
  // queries, whose stats are at sl.  The mask is compiled in only for
  // tiles that straddle the diagonal or the ragged key tail (`masked`).
  auto grads = [&](float (&s)[32], float (&dp)[32], const float* sl,
                   int q0, auto masked) {
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = 8 * i + cq + j;
        const float lse2 = sl[qc], dl = sl[BWD_BM + qc];
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
  auto elementwise = [&](float (&s)[32], float (&dp)[32], int it) {
    const int q0 = (w.qt0 + it) * BWD_BM;
    const float* sl = stats_s + (it % 2) * L::STAT_FLOATS;
    if (key_first + WG_KEYS > sk || (causal && key_first + WG_KEYS - 1 > q0))
      grads(s, dp, sl, q0, Masked{});
    else
      grads(s, dp, sl, q0, Plain{});
  };
  // P^T and dS^T of the tile in hand (p and dS in s, dp) to 16 bits as A
  // operands (query columns 8 i .. 8 i + 7: k-slice i / 2, registers h
  // and 2 + h), and dS^T into its buffer: key row kr, 16-byte chunk i % 4
  // of query panel i / 4, swizzled as TMA would have written it.
  auto pack = [&](uint32_t (&pa)[Q_SLICES][4], uint32_t (&dsa)[Q_SLICES][4],
                  const float (&s)[32], const float (&dp)[32], int it) {
    const uint32_t ds_off = L::ds + (it % 2) * L::DS_BYTES;
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[i / 2][(i % 2) * 2 + h] =
            pack2<T>(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]);
        const uint32_t wd = pack2<T>(dp[4 * i + 2 * h], dp[4 * i + 2 * h + 1]);
        dsa[i / 2][(i % 2) * 2 + h] = wd;
        const int kr = key_row0 + r_lo + 8 * h;
        const uint32_t at = ds_off + (i / 4) * L::DS_PANEL + kr * 64 +
                            (((i % 4) ^ ((kr >> 1) & 3)) << 4) + cq * 2;
        *reinterpret_cast<uint32_t*>(gbase + at) = wd;
      }
  };
  // The tile's one barrier of both warpgroups: dS^T of both in place, and
  // every product of tile it - 1 done.  The reduce that read this tile's
  // dQ buffer last has done so before.
  auto meet = [&] {
    if (lane == 0) bulk_wait_read<DQ_BUFS - 1>();
    fence_async_shared();
    bar_sync(1, B2_THREADS);
  };
  // Thread 0 refills the stage of tile it - 1, which no product reads
  // after the barrier of tile it; called once its own warpgroup's products
  // of tile it are issued, so the loads delay none of them.
  auto refill = [&](int it) {
    if (it > 0) load_tile(it - 1 + STAGES);
  };
  // dV += P^T dO, dK += dS^T q' (K = the tile's query rows, B as the tiles
  // arrived, MN-major) and dQ = dS K (dS^T and K both MN-major) of tile
  // it, issued as one group.
  float dk_acc[D / 2], dv_acc[D / 2];
  auto issue_grads = [&](float (&dq_acc)[DQ_N / 2],
                         const uint32_t (&pa)[Q_SLICES][4],
                         const uint32_t (&dsa)[Q_SLICES][4], int it) {
    const int st = it % STAGES;
    const uint32_t q_lo = desc_lo(q_s, L::Q_PANEL) + st * (L::Q_BYTES >> 4);
    const uint32_t do_lo =
        desc_lo(do_s, L::Q_PANEL) + st * (L::Q_BYTES >> 4);
    const uint32_t ds_lo = desc_lo(base + L::ds, L::DS_PANEL) +
                           (it % 2) * (L::DS_BYTES >> 4);
    const uint32_t kq_lo =
        desc_lo(k_s + (col0 / PANEL) * L::K_PANEL, L::K_PANEL);
    pin(dk_acc);
    pin(dv_acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < Q_SLICES; ++j)
      Wgmma<D, T>::rs(dv_acc, pa[j], desc_of(do_lo + j * (16 * 64 >> 4)));
#pragma unroll
    for (int j = 0; j < Q_SLICES; ++j)
      Wgmma<D, T>::rs(dk_acc, dsa[j], desc_of(q_lo + j * (16 * 64 >> 4)));
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) {
      const int j = j0 + jj;
      Wgmma<DQ_N, T>::ss_t(dq_acc, desc_of(ds_lo + j * (16 * 64 >> 4)),
                           desc_of(kq_lo + j * (16 * 64 >> 4)), jj > 0);
    }
    wg_commit();
  };
  // Tile it's dQ into the caller's f32 tensor: into this warpgroup's
  // buffer (row r, column col: panel col / 32, 16-byte chunk (col % 32) /
  // 4 ^ r % 8), then each warp adds its own B2_DQ_ROWS rows, one TMA
  // reduce-add per panel (rows past sq are not written).
  auto dq_out = [&](const float (&dq_acc)[DQ_N / 2], int it) {
    const uint32_t dq_off =
        L::dq + (c * DQ_BUFS + it % DQ_BUFS) * L::DQ_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
#pragma unroll
      for (int i = 0; i < DQ_N / 8; ++i) {
        const int col = 8 * i + cq;
        const uint32_t at = dq_off + (col / 32) * L::DQ_PANEL + r * 128 +
                            ((((col % 32) / 4) ^ (r % 8)) << 4) +
                            (col % 4) * 4;
        *reinterpret_cast<float2*>(gbase + at) =
            make_float2(dq_acc[4 * i + 2 * h], dq_acc[4 * i + 2 * h + 1]);
      }
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      const int wr = (tid / 32) * B2_DQ_ROWS;
#pragma unroll
      for (int p = 0; p < DQ_N / 32; ++p)
        tma_reduce_add(mdq, base + dq_off + p * L::DQ_PANEL + wr * 128,
                       col0 + 32 * p, (w.qt0 + it) * BWD_BM + wr, w.bh);
      bulk_commit();
    }
  };

  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(kv_full, 2 * L::K_BYTES);
    tma_tile<D>(k_s, mk, kv_full, BWD_BN, w.k0, w.bh);
    tma_tile<D>(v_s, mv, kv_full, BWD_BN, w.k0, w.bh);
  }
#pragma unroll
  for (int it = 0; it < STAGES; ++it) load_tile(it);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[32], dp[32];  // S^T, dP^T of the tile in hand, then p, dS
  float stat = stat_of(0);  // this thread's value of the next tile's stats
  if (n_it > 0) {
    put_stat(stat, 0);
    stat = stat_of(1);
    bar_sync(1, B2_THREADS);  // tile 0's stats in place
    mbar_wait(kv_full, 0);
    issue_sdp(s, dp, 0);
    wg_wait<0>();
    pin(s);
    pin(dp);
    elementwise(s, dp, 0);
  }
  int it = 0;
  if constexpr (PIPE) {
    // Every tile but the last: S^T and dP^T of tile it + 1 issued ahead of
    // tile it's products, its exp and dS step run while they do.
    for (; it + 1 < n_it; ++it) {
      uint32_t pa[Q_SLICES][4], dsa[Q_SLICES][4];
      pack(pa, dsa, s, dp, it);
      put_stat(stat, it + 1);
      meet();
      stat = stat_of(it + 2);
      issue_sdp(s, dp, it + 1);
      float dq_acc[DQ_N / 2];
      issue_grads(dq_acc, pa, dsa, it);
      refill(it);
      wg_wait<1>();
      pin(s);
      pin(dp);
      elementwise(s, dp, it + 1);
      pin(s);  // done before this tile's products are waited for
      pin(dp);
      wg_wait<0>();
      pin(dk_acc);
      pin(dv_acc);
      pin(dq_acc);
      pin(pa);
      pin(dsa);
      dq_out(dq_acc, it);
    }
  }
  // Unpipelined, every tile (pipelined, the last): the tile's products,
  // then the next tile's S^T, dP^T and elementwise step.
  for (; it < n_it; ++it) {
    uint32_t pa[Q_SLICES][4], dsa[Q_SLICES][4];
    pack(pa, dsa, s, dp, it);
    put_stat(stat, it + 1);
    meet();
    stat = stat_of(it + 2);
    float dq_acc[DQ_N / 2];
    issue_grads(dq_acc, pa, dsa, it);
    refill(it);
    wg_wait<0>();
    pin(dk_acc);
    pin(dv_acc);
    pin(dq_acc);
    pin(pa);
    pin(dsa);
    dq_out(dq_acc, it);
    if (it + 1 < n_it) {
      issue_sdp(s, dp, it + 1);
      wg_wait<0>();
      pin(s);
      pin(dp);
      elementwise(s, dp, it + 1);
    }
  }

  // dK and dV of this warpgroup's keys (zero where no query sees them).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_first + r_lo + 8 * h;
    if (key >= sk) continue;
    T* dkr = dk + ((size_t)w.bh * sk + key) * D + cq;
    T* dvr = dv + ((size_t)w.bh * sk + key) * D + cq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int e = 4 * i + 2 * h;
      *reinterpret_cast<uint32_t*>(dkr + 8 * i) =
          pack2<T>(dk_acc[e], dk_acc[e + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * i) =
          pack2<T>(dv_acc[e], dv_acc[e + 1]);
    }
  }
  // The adds complete before the CTA's shared memory goes away.
  if (lane == 0) bulk_wait_all<false>();
}

}  // namespace sm90
}  // namespace hvdt
