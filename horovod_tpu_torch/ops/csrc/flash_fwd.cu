// K1: causal/non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (horovod_tpu/ops/attention.py:356, with `_attend_block`, `_init_state`
// and `_finalize_flash`).  The body is flash_fwd_sm90.cuh's, shared with
// K4 (ring_flash.cu), here at zero offsets; its note gives the bound and
// the design.  16-bit inputs: grid (bh, ceil(sq / 128)), 384 threads,
// heavy (late) query tiles first (64-row tiles at head dim 256, where the
// two consumer warpgroups split O's columns).  f32 inputs: a 1-D grid of
// ceil(sq / 64) x bh blocks (32-row tiles at 256), 128 threads, heavy
// tiles first.  Head dims 32, 64, 96, 128 and 256.  bh rides on
// x in both, so any batch-head count launches.  q, k, v, o: contiguous
// (bh, s, D); lse: (bh, sq) f32.  Any sequence length: the ragged tail is
// zero-filled on load and masked as NEG_INF logits.

#include "flash_fwd_sm90.cuh"

namespace hvdt {

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float scale_r,
                     int causal) {
  const int qt = gridDim.y - 1 - blockIdx.y;
  sm90::fwd_tile<T, D>(&mq, &mk, &mv, o, lse, blockIdx.x,
                       qt * sm90::fwd_rows<D>(), sq, sk, 0, 0, scale_r,
                       causal);
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int bh_total, int sq,
                         int sk, float scale_r, int causal) {
  // Heavy (late, under a causal mask) query tiles first.
  constexpr int TM = f32_tile<D>();
  const int qt = (sq + TM - 1) / TM - 1 - (int)(blockIdx.x / bh_total);
  const size_t bh = blockIdx.x % bh_total;
  fwd_tile_f32<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D,
                  o + bh * sq * D, lse + bh * sq, qt * TM, sq, sk, 0, 0,
                  scale_r, causal);
}

// Set each kernel's shared-memory limit once, before its first launch
// (internal linkage: a mutant build loaded beside this one keeps its own).
namespace {
bool g_prepared[3][N_HEAD_DIMS] = {};
}  // namespace

template <typename T, int D>
int prepare_fwd() {
  constexpr bool f32 = std::is_same<T, float>::value;
  bool& ready = g_prepared[f32 ? 0 : std::is_same<T, __half>::value ? 1 : 2]
                          [head_dim_slot<D>()];
  if (ready) return 0;
  int e;
  if constexpr (f32)
    e = (int)cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)F32FwdSmem<D>::bytes);
  else
    e = (int)cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm90::Smem<D>::bytes);
  ready = e == 0;
  return e;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, float scale_r,
               int causal, cudaStream_t stream) {
  const int prep = prepare_fwd<T, D>();
  if (prep != 0) return prep;
  if constexpr (std::is_same<T, float>::value) {
    const int blocks = ((sq + f32_tile<D>() - 1) / f32_tile<D>()) * bh;
    flash_fwd_f32_kernel<D><<<blocks, NT, F32FwdSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, bh, sq,
        sk, scale_r, causal);
  } else {
    CUtensorMap mq, mk, mv;
    const int e = sm90::make_maps<T, D>(&mq, &mk, &mv, q, k, v, bh, sq, sk);
    if (e != 0) return e;
    dim3 grid(bh, (sq + sm90::fwd_rows<D>() - 1) / sm90::fwd_rows<D>());
    flash_fwd_kernel<T, D>
        <<<grid, sm90::NTHREADS, sm90::Smem<D>::bytes, stream>>>(
            mq, mk, mv, static_cast<T*>(o), lse, sq, sk, scale_r, causal);
  }
  return (int)cudaGetLastError();
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
