// K1, K2 and K3 at head dims above 256 for Hopper (sm_90a): the wide
// bodies of the flash forward (flash_fwd_wide) and of the split backward
// (flash_bwd_dkdv_wide, flash_bwd_dq_wide).  This file is their dispatch:
// in fp16 and bf16 all three run the wgmma/TMA bodies of
// flash_wide_sm90.cuh, in f32 the 3xTF32 wgmma/TMA bodies of
// flash_wide_f32_sm90.cuh (each header's note gives its design): K1 and K2
// in column CTAs of 4-panel windows, K3 in column CTAs of 4-panel windows
// that form one thread block cluster per query tile up to head dim 1024
// (F32_DQ_CLUSTER_MAX) and each recompute S and dP above it.
//
// They replace the Pallas TPU kernels `_flash_kernel`
// (horovod_tpu/ops/attention.py:356) and `_flash_bwd_dkdv_kernel` /
// `_flash_bwd_dq_kernel` (:429, :465) at the head dims the reference
// computes above 256: its `_bwd_plan` sends every head dim above 128 to
// the split backward, so these three are the kernels it runs there.
//
// Head dims: any multiple of 32 above 256 (the wrappers zero-pad to one,
// ops/attention.py `padded_head_dim`).  q, k, v, do: contiguous (bh, s, d)
// in one dtype; lse, delta: (bh, sq) f32; outputs in the input dtype.  Any
// sequence length: the ragged tail loads as zeros and is masked.

#include "flash_common.cuh"
#include "flash_wide_f32_sm90.cuh"

namespace hvdt {
namespace wide {

// fp16 and bf16 go to the wgmma bodies (flash_wide_sm90.cuh), f32 to the
// 3xTF32 ones (flash_wide_f32_sm90.cuh).
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, int d, float scale_r,
               int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return wide90::launch_fwd<T>(q, k, v, o, lse, bh, sq, sk, d, scale_r,
                                 causal, stream);
  else
    return wide32::launch_fwd<wide32::F32_FWD_NP>(q, k, v, o, lse, bh, sq,
                                                  sk, d, scale_r, causal,
                                                  stream);
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int bh, int sq, int sk, int d, float scale_r, int causal,
                cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return wide90::launch_dkdv<T>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  sk, d, scale_r, causal, stream);
  else
    return wide32::launch_dkdv<wide32::F32_DKDV_NP>(
        q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale_r, causal,
        stream);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, int d, float scale_r, float dq_scale, int causal,
              cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return wide90::launch_dq<T>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                                scale_r, dq_scale, causal, stream);
  else
    return wide32::launch_dq_wide<wide32::F32_DQ_NP>(
        q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale_r, dq_scale,
        causal, stream);
}

}  // namespace wide
}  // namespace hvdt

// Instantiate FN<T> for the dtype code; a head dim these bodies do not
// take (not above 256, or not a multiple of 32) returns
// cudaErrorInvalidValue: the wrappers check first and never reach it.
#define HVDT_WIDE_DISPATCH(dtype, d, FN, ...)                               \
  do {                                                                      \
    if ((d) <= 256 || (d) % hvdt::wide32::F32_PANEL != 0)                   \
      return (int)cudaErrorInvalidValue;                                    \
    switch (dtype) {                                                        \
      case hvdt::kF32: return hvdt::wide::FN<float>(__VA_ARGS__);           \
      case hvdt::kF16: return hvdt::wide::FN<__half>(__VA_ARGS__);          \
      case hvdt::kBF16: return hvdt::wide::FN<__nv_bfloat16>(__VA_ARGS__);  \
      default: return (int)cudaErrorInvalidValue;                           \
    }                                                                       \
  } while (0)

extern "C" int hvdt_flash_fwd_wide(int dtype, int d, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, int bh, int sq, int sk,
                                   float scale_r, int causal, void* stream) {
  HVDT_WIDE_DISPATCH(dtype, d, launch_fwd, q, k, v, o, lse, bh, sq, sk, d,
                     scale_r, causal, static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_flash_bwd_dkdv_wide(int dtype, int d, const void* q,
                                        const void* k, const void* v,
                                        const void* dout, const float* lse,
                                        const float* delta, void* dk,
                                        void* dv, int bh, int sq, int sk,
                                        float scale_r, int causal,
                                        void* stream) {
  HVDT_WIDE_DISPATCH(dtype, d, launch_dkdv, q, k, v, dout, lse, delta, dk,
                     dv, bh, sq, sk, d, scale_r, causal,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_flash_bwd_dq_wide(int dtype, int d, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dq, int bh,
                                      int sq, int sk, float scale_r,
                                      float dq_scale, int causal,
                                      void* stream) {
  HVDT_WIDE_DISPATCH(dtype, d, launch_dq, q, k, v, dout, lse, delta, dq, bh,
                     sq, sk, d, scale_r, dq_scale, causal,
                     static_cast<cudaStream_t>(stream));
}
