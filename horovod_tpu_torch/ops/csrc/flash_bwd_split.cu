// The split flash backward for Hopper (sm_90a): K2 (flash_bwd_dkdv) and K3
// (flash_bwd_dq), the backward wherever the reference's plan picks the
// split mode (long sequences, many batch-heads; ops/attention.py
// `bwd_mode`).
//
// They replace the Pallas TPU kernels `_flash_bwd_dkdv_kernel` and
// `_flash_bwd_dq_kernel` (B3, horovod_tpu/ops/attention.py:429, :465,
// launched by `_split_bwd_call` :914, :930; shared math
// `_bwd_block_math`): K2 owns a key tile and loops over query tiles
// (dV += P^T dO, dK += dS^T q'), K3 owns a query tile and loops over key
// tiles (dQ += dS K).  Neither needs atomics; both recompute P and dP.
//
// Bound on the card at the split path's shape (bh 1040, seq 512, head dim
// 64, bf16, causal): K2 69.9 GFLOP (8 d FLOP per causal pair) against 413
// MB, 0.1233 ms by bytes; K3 52.4 GFLOP (6 d) against 345 MB, 0.1030 ms
// by bytes.  Near the ridge: the designs keep the tensor cores fed and
// every intermediate out of device memory.
//
// * 16-bit inputs.  K2 is the backward body of B2 and K5
//   (flash_bwd_sm90.cuh, `bwd_ktile`) with WITH_DQ off: the dS^T stores,
//   their named barrier, the dQ product and its TMA adds are compiled
//   out, and the shared memory they held takes a third (q', dO) stage.
//   dK and dV go out in the input dtype straight from registers; no
//   workspace, no fill, no flush.  One 384-thread CTA per 128-key tile,
//   heavy (early, under a causal mask) key tiles first.  K3 is
//   flash_dq_sm90.cuh's query-stationary body, on the forward's skeleton:
//   one 384-thread CTA per 128-row query tile, heavy (late) query tiles
//   first, dQ in f32 registers, scaled by the pow2 factor and cast once.
//   Their notes give the designs.
// * f32 inputs: K2 and K3 are the 3xTF32 wgmma bodies of
//   flash_wide_f32_sm90.cuh (wide32::dkdv_tile, the one above 256 runs,
//   and wide32::dq_tile; their notes give the designs): K2 64 keys a CTA,
//   32-row query steps; K3 128 query rows a CTA, 32-key tiles, dq in f32
//   registers, no atomics; both a window of the whole head dim up to 128
//   (d / 32 panels) and two column CTAs of 4 panels at 256.
//
// Head dims 32, 64, 96, 128 and 256: at 256 both 16-bit bodies split the
// output's columns between their consumer warpgroups (64-key and 64-row
// CTAs, two stages).
//
// Grids are 1-D, (tiles x bh) blocks, each block decoding its head and
// tile from blockIdx.x, so any batch-head count launches (a grid's y and
// z dimensions stop at 65,535).  q, k, v, do: contiguous (bh, s, D) in
// one dtype; lse, delta: (bh, sq) f32; grads in the input dtype.

#include "flash_bwd_sm90.cuh"
#include "flash_dq_sm90.cuh"
#include "flash_wide_f32_sm90.cuh"

namespace hvdt {

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mdo,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          int bh_total, int sq, int sk, float scale_r,
                          int causal) {
  const int kt = blockIdx.x / bh_total;  // heavy (early) key tiles first
  sm90::bwd_ktile<T, D, T, false>(&mq, &mdo, &mk, &mv, nullptr, lse, delta,
                                  dk, dv, blockIdx.x % bh_total,
                                  kt * sm90::bwd_keys<D>(), sq, sk, 0, 0,
                                  scale_r, causal);
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int bh_total, int sq, int sk, float scale_r,
                        float dq_scale, int causal) {
  constexpr int ROWS = sm90::dq_rows<D>();
  const int n_qt = (sq + ROWS - 1) / ROWS;
  const int qt = n_qt - 1 - blockIdx.x / bh_total;  // heavy (late) first
  sm90::dq_qtile<T, D>(&mq, &mdo, &mk, &mv, lse, delta, dq,
                       blockIdx.x % bh_total, qt * ROWS, sq, sk, scale_r,
                       dq_scale, causal);
}

// Set both 16-bit kernels' shared-memory limits once per (dtype, D),
// before their first launch (internal linkage: a mutant build loaded
// beside this one keeps its own flags; the f32 bodies' are
// wide32::prepare's).
namespace {
bool g_prepared[2][N_HEAD_DIMS] = {};
}  // namespace

template <typename T, int D>
int prepare_split() {
  bool& ready = g_prepared[std::is_same<T, __half>::value ? 0 : 1]
                          [head_dim_slot<D>()];
  if (ready) return 0;
  constexpr auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  int e = (int)cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>, attr,
                                    (int)sm90::BwdSmem<D, false>::bytes);
  if (e == 0)
    e = (int)cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, attr,
                                  (int)sm90::DqSmem<D>::bytes);
  ready = e == 0;
  return e;
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int bh, int sq, int sk, float scale_r,
                int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return wide32::launch_dkdv<wide32::window_panels<D>()>(
        q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, D, scale_r, causal,
        stream);
  } else {
    const int prep = prepare_split<T, D>();
    if (prep != 0) return prep;
    CUtensorMap m[4];
    const int e =
        sm90::make_bwd_maps<T, D>(m, q, dout, k, v, nullptr, bh, sq, sk);
    if (e != 0) return e;
    const int blocks = ((sk + sm90::bwd_keys<D>() - 1) / sm90::bwd_keys<D>()) *
                       bh;
    flash_bwd_dkdv_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::BwdSmem<D, false>::bytes,
           stream>>>(m[0], m[1], m[2], m[3], lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), bh, sq, sk, scale_r, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, float scale_r, float dq_scale, int causal,
              cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return wide32::launch_dq<wide32::window_panels<D>()>(
        q, k, v, dout, lse, delta, dq, bh, sq, sk, D, scale_r, dq_scale,
        causal, stream);
  } else {
    const int prep = prepare_split<T, D>();
    if (prep != 0) return prep;
    CUtensorMap m[4];
    const int e = sm90::make_dq_maps<T, D>(m, q, dout, k, v, bh, sq, sk);
    if (e != 0) return e;
    const int blocks = ((sq + sm90::dq_rows<D>() - 1) / sm90::dq_rows<D>()) *
                       bh;
    flash_bwd_dq_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::DqSmem<D>::bytes, stream>>>(
            m[0], m[1], m[2], m[3], lse, delta, static_cast<T*>(dq), bh, sq,
            sk, scale_r, dq_scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace hvdt

extern "C" int hvdt_flash_bwd_dkdv(int dtype, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int bh, int sq, int sk, float scale_r,
                                   int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH_WIDE(dtype, d, launch_dkdv, q, k, v, dout, lse, delta, dk,
                     dv, bh, sq, sk, scale_r, causal,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_flash_bwd_dq(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int bh,
                                 int sq, int sk, float scale_r,
                                 float dq_scale, int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH_WIDE(dtype, d, launch_dq, q, k, v, dout, lse, delta, dq, bh,
                     sq, sk, scale_r, dq_scale, causal,
                     static_cast<cudaStream_t>(stream));
}
