// B2 (flash_bwd), the flash-attention backward for Hopper (sm_90a)
// wherever the reference's plan picks the combined mode: the main path's
// backward (ops/attention.py `bwd_mode`; the split pair K2 + K3 is
// flash_bwd_split.cu's).
//
// B2 replaces `_combined_bwd_kernel` with rotate=False
// (horovod_tpu/ops/attention.py:498).  16-bit inputs: flash_bwd_sm90.cuh's
// body, the one K5 (ring_flash.cu) runs, at zero offsets and without copy
// blocks, one 384-thread CTA per 128-key tile.  f32 inputs: the 3xTF32
// wgmma/TMA body of flash_wide_f32_sm90.cuh (wide32::dkdv_tile with
// WITH_DQ, K2's f32 body with dQ = dS K added; 288-thread CTAs of 64 keys,
// 32-row query steps, a window of the whole head dim up to 64 and two
// column CTAs of 2 panels at 96 and 128).  dK, dV in the input dtype, dQ
// summed into the caller's zeroed f32 workspace by TMA reduce and flushed
// by scale_cast_kernel: times the pow2 factor p2 in f32, then the cast.
// The bodies' notes give the bound and the designs.
//
// Grids are 1-D, (key tiles x bh) blocks, heavy (early, under a causal
// mask) key tiles first, so any batch-head count launches.  q, k, v, do:
// contiguous (bh, s, D) in one dtype; lse, delta: (bh, sq) f32; grads in
// the input dtype.

#include <algorithm>

#include "flash_bwd_sm90.cuh"
#include "flash_wide_f32_sm90.cuh"

namespace hvdt {

// B2's flush: out = cast(in * scale), the scale applied in f32.
template <typename T>
__global__ void scale_cast_kernel(T* __restrict__ out,
                                  const float* __restrict__ in, size_t n,
                                  float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = from_f<T>(in[i] * scale);
}

template <typename T>
int launch_scale_cast(void* out, const float* in, size_t n, float scale,
                      cudaStream_t stream) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  scale_cast_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<T*>(out), in,
                                                   n, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mdo,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdq,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int bh_total, int sq, int sk,
                     float scale_r, int causal) {
  const int kt = blockIdx.x / bh_total;  // heavy (early) key tiles first
  sm90::bwd_ktile<T, D, T>(&mq, &mdo, &mk, &mv, &mdq, lse, delta, dk, dv,
                           blockIdx.x % bh_total, kt * sm90::BWD_BN, sq, sk,
                           0, 0, scale_r, causal);
}

// Set the 16-bit B2's shared-memory limit once, before its first launch
// (internal linkage: a mutant build loaded beside this one keeps its own
// flags; the f32 body's are wide32::prepare's).
namespace {
bool g_prepared[2][4] = {};
}  // namespace

template <typename T, int D>
int prepare_bwd() {
  bool& ready = g_prepared[std::is_same<T, __half>::value ? 0 : 1]
                          [D / 32 - 1];
  if (ready) return 0;
  const int e = (int)cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm90::BwdSmem<D>::bytes);
  ready = e == 0;
  return e;
}

// B2: dk, dv in T; dq32 (zeroed by the caller) takes the f32 sum, then
// dq_out = cast(dq32 * dq_scale).
template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               float* dq32, void* dq_out, int bh, int sq, int sk,
               float scale_r, float dq_scale, int causal,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const int e = wide32::launch_bwd<wide32::bwd_window_panels<D>()>(
        q, k, v, dout, lse, delta, dk, dv, dq32, bh, sq, sk, D, scale_r,
        causal, stream);
    if (e != 0) return e;
  } else {
    const int prep = prepare_bwd<T, D>();
    if (prep != 0) return prep;
    CUtensorMap m[5];
    const int e =
        sm90::make_bwd_maps<T, D>(m, q, dout, k, v, dq32, bh, sq, sk);
    if (e != 0) return e;
    const int blocks = ((sk + sm90::BWD_BN - 1) / sm90::BWD_BN) * bh;
    flash_bwd_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::BwdSmem<D>::bytes, stream>>>(
            m[0], m[1], m[2], m[3], m[4], lse, delta, static_cast<T*>(dk),
            static_cast<T*>(dv), bh, sq, sk, scale_r, causal);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_scale_cast<T>(dq_out, dq32, (size_t)bh * sq * D, dq_scale,
                              stream);
}

}  // namespace hvdt

extern "C" int hvdt_flash_bwd(int dtype, int d, const void* q,
                              const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk,
                              void* dv, float* dq32, void* dq_out, int bh,
                              int sq, int sk, float scale_r, float dq_scale,
                              int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH(dtype, d, launch_bwd, q, k, v, dout, lse, delta, dk, dv,
                dq32, dq_out, bh, sq, sk, scale_r, dq_scale, causal,
                static_cast<cudaStream_t>(stream));
}
