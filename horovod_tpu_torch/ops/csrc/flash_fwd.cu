// K1: causal/non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (horovod_tpu/ops/attention.py:356, with `_attend_block`, `_init_state`
// and `_finalize_flash`).  16-bit inputs: flash_fwd_sm90.cuh's body,
// shared with K4 (ring_flash.cu), here at zero offsets; its note gives the
// bound and the design; grid (bh, ceil(sq / 128)), 384 threads, heavy
// (late) query tiles first; at head dim 256 256 threads (each consumer
// warpgroup's 64 rows over all 256 columns, S once per pair, the
// consumers loading) on a 1-D grid, each head's tiles adjacent in a grid
// of many waves (sm90::tile_order).  f32 inputs: the 3xTF32 wgmma
// body of flash_wide_f32_sm90.cuh (wide32::fwd_tile, the one above 256
// runs), whose note gives its design: 128 query rows by 64-key tiles, a
// window of the whole head dim up to 128 (d / 32 panels) and two column
// CTAs of 4 panels at 256; a 1-D grid, heavy tiles first (K4's f32 body
// too, at a ring step's offsets).  Head dims 32, 64, 96, 128 and 256.  bh
// rides on x in both, so any batch-head count launches.  q, k, v, o:
// contiguous (bh, s, D); lse: (bh, sq) f32.  Any sequence length: the
// ragged tail is zero-filled on load and masked as NEG_INF logits.

#include "flash_fwd_sm90.cuh"
#include "flash_wide_f32_sm90.cuh"

namespace hvdt {

template <typename T, int D>
__global__ void __launch_bounds__(sm90::fwd_threads<D>(), 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float scale_r,
                     int causal) {
  if constexpr (D == 256) {
    // A 1-D grid ordered by its size (sm90::tile_order).
    const int n_qt = (sq + sm90::BM - 1) / sm90::BM;
    const int2 ht = sm90::tile_order(blockIdx.x, gridDim.x / n_qt, n_qt);
    sm90::fwd_tile<T, D>(&mq, &mk, &mv, o, lse, ht.x,
                         (n_qt - 1 - ht.y) * sm90::BM, sq, sk, 0, 0, scale_r,
                         causal);
  } else {
    const int qt = gridDim.y - 1 - blockIdx.y;
    sm90::fwd_tile<T, D>(&mq, &mk, &mv, o, lse, blockIdx.x,
                         qt * sm90::BM, sq, sk, 0, 0, scale_r, causal);
  }
}

// Set each 16-bit kernel's shared-memory limit once, before its first
// launch (internal linkage: a mutant build loaded beside this one keeps
// its own).
namespace {
bool g_prepared[2][N_HEAD_DIMS] = {};
}  // namespace

template <typename T, int D>
int prepare_fwd() {
  bool& ready = g_prepared[std::is_same<T, __half>::value ? 0 : 1]
                          [head_dim_slot<D>()];
  if (ready) return 0;
  const int e = (int)cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm90::Smem<D>::bytes);
  ready = e == 0;
  return e;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, float scale_r,
               int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return wide32::launch_fwd<wide32::window_panels<D>()>(
        q, k, v, o, lse, bh, sq, sk, D, scale_r, causal, stream);
  } else {
    const int prep = prepare_fwd<T, D>();
    if (prep != 0) return prep;
    CUtensorMap mq, mk, mv;
    const int e = sm90::make_maps<T, D>(&mq, &mk, &mv, q, k, v, bh, sq, sk);
    if (e != 0) return e;
    const int n_qt = (sq + sm90::BM - 1) / sm90::BM;
    const dim3 grid = D == 256 ? dim3(bh * n_qt) : dim3(bh, n_qt);
    flash_fwd_kernel<T, D>
        <<<grid, sm90::fwd_threads<D>(), sm90::Smem<D>::bytes, stream>>>(
            mq, mk, mv, static_cast<T*>(o), lse, sq, sk, scale_r, causal);
    return (int)cudaGetLastError();
  }
}

}  // namespace hvdt

extern "C" int hvdt_flash_fwd(int dtype, int d, const void* q,
                              const void* k, const void* v, void* o,
                              float* lse, int bh, int sq, int sk,
                              float scale_r, int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH_WIDE(dtype, d, launch_fwd, q, k, v, o, lse, bh, sq, sk,
                     scale_r, causal, static_cast<cudaStream_t>(stream));
}
