// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_split.cu, flash_wide.cu, ring_flash.cu): the sentinels, the
// dtype codes of the Python wrappers, the once-per-(dtype, head dim)
// tables' slots and the dispatch over dtype and head dim.  The bodies are
// in the *_sm90.cuh headers (16 bits on wgmma and TMA) and
// flash_wide_f32_sm90.cuh (f32 on 3xTF32 wgmma and TMA).
//
// Sentinels follow the reference (horovod_tpu/ops/attention.py): masked
// logits are NEG_INF = -1e30 instead of -inf so exp() never sees
// inf - inf, and a row with no mass gets lse = POS_BIG = 1e30 so the
// backward's exp(s - lse) is exactly 0 there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace hvdt {

// Slot of head dim D in the kernels' once-per-(dtype, D) tables: 0-3 for
// 32, 64, 96, 128; 4 for 256.
template <int D>
constexpr int head_dim_slot() {
  return D <= 128 ? D / 32 - 1 : 4;
}
constexpr int N_HEAD_DIMS = 5;
constexpr float NEG_INF = -1e30f;
constexpr float POS_BIG = 1e30f;

// Dtype codes shared with the Python wrappers (ops/attention.py).
enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace hvdt

// Instantiate `FN<T, D>` for the dtype code and head dim (32, 64, 96,
// 128), or return -1 (unsupported; the wrappers check first and never
// reach it).
#define HVDT_DISPATCH(dtype, d, FN, ...)                                  \
  do {                                                                    \
    switch ((dtype) * 1000 + (d)) {                                       \
      case hvdt::kF32 * 1000 + 32: return FN<float, 32>(__VA_ARGS__);     \
      case hvdt::kF32 * 1000 + 64: return FN<float, 64>(__VA_ARGS__);     \
      case hvdt::kF32 * 1000 + 96: return FN<float, 96>(__VA_ARGS__);     \
      case hvdt::kF32 * 1000 + 128: return FN<float, 128>(__VA_ARGS__);   \
      case hvdt::kF16 * 1000 + 32: return FN<__half, 32>(__VA_ARGS__);    \
      case hvdt::kF16 * 1000 + 64: return FN<__half, 64>(__VA_ARGS__);    \
      case hvdt::kF16 * 1000 + 96: return FN<__half, 96>(__VA_ARGS__);    \
      case hvdt::kF16 * 1000 + 128: return FN<__half, 128>(__VA_ARGS__);  \
      case hvdt::kBF16 * 1000 + 32:                                       \
        return FN<__nv_bfloat16, 32>(__VA_ARGS__);                        \
      case hvdt::kBF16 * 1000 + 64:                                       \
        return FN<__nv_bfloat16, 64>(__VA_ARGS__);                        \
      case hvdt::kBF16 * 1000 + 96:                                       \
        return FN<__nv_bfloat16, 96>(__VA_ARGS__);                        \
      case hvdt::kBF16 * 1000 + 128:                                      \
        return FN<__nv_bfloat16, 128>(__VA_ARGS__);                       \
      default: return -1;                                                 \
    }                                                                     \
  } while (0)

// HVDT_DISPATCH with the wide head dim 256 too: K1, K2 and K3 alone have
// a body there (the reference's plan sends every head dim above 128 to the
// split backward, and its fused ring to the separable ring).
#define HVDT_DISPATCH_WIDE(dtype, d, FN, ...)                             \
  do {                                                                    \
    switch ((dtype) * 1000 + (d)) {                                       \
      case hvdt::kF32 * 1000 + 256: return FN<float, 256>(__VA_ARGS__);   \
      case hvdt::kF16 * 1000 + 256: return FN<__half, 256>(__VA_ARGS__);  \
      case hvdt::kBF16 * 1000 + 256:                                      \
        return FN<__nv_bfloat16, 256>(__VA_ARGS__);                       \
      default: HVDT_DISPATCH(dtype, d, FN, __VA_ARGS__);                  \
    }                                                                     \
  } while (0)
