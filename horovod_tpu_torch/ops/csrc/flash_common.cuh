// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_split.cu, ring_flash.cu).
//
// The SIMT f32 bodies of K4 and K5 (K1's, K2's, K3's and B2's f32 bodies
// are the 3xTF32 ones of flash_wide_f32_sm90.cuh, the 16-bit ones the
// *_sm90.cuh headers'): one thread block of four warps owns one 64-row
// tile of one (batch*head) row and walks its own loop over the other
// sequence axis.  Operand tiles are staged through shared memory; every
// product is a scalar FMA in full f32.
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

constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // key rows per tile
constexpr int NT = 128;  // threads per block: four warps

// Rows per tile (query and key alike) of the SIMT f32 bodies at head dim
// D: 64 (K4 and K5 take head dims up to 128).  The bodies shadow BM and BN
// with it.
template <int D>
__host__ __device__ constexpr int f32_tile() {
  static_assert(D <= 128, "the SIMT f32 bodies take head dims to 128");
  return 64;
}

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

// Row padding of a shared-memory tile, in elements: one, so the scalar
// products, whose lanes walk down a column, hit distinct banks.
constexpr int PAD = 1;

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Copy rows [row0, row0 + ROWS) of a contiguous (rows_total, D) matrix into
// a shared tile with leading dimension ld; rows past rows_total read as 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int row0,
                                          int rows_total) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D, gr = row0 + r;
    dst[r * ld + c] = gr < rows_total ? src[(size_t)gr * D + c] : 0.f;
  }
}

// C[M][N] (shared) = or += sum_k A[m][k] * opB(k, n), where opB(k, n) =
// B[n][k] when TB (the "A B^T" product of the logits) and B[k][n]
// otherwise.  Called by the whole block; the caller syncs after.
template <int M, int N, int K, bool TB, bool ACC>
__device__ __forceinline__ void mm_smem(float* C, int ldc, const float* A,
                                        int lda, const float* B, int ldb) {
  for (int idx = threadIdx.x; idx < M * N; idx += NT) {
    const int m = idx / N, n = idx % N;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      s = fmaf(A[m * lda + k], TB ? B[n * ldb + k] : B[k * ldb + n], s);
    C[m * ldc + n] = ACC ? C[m * ldc + n] + s : s;
  }
}

// An M x N accumulator held in registers across a block's loop (the
// backward's dK, dV and dQ): += opA(A) * B with opA(A)[m][k] = A[k][m] when
// TA (the "P^T dO" and "dS^T Q" products) and A[m][k] otherwise.
template <int M, int N>
struct Acc {
  static constexpr int PER = M * N / NT;
  float c[PER];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = 0.f;
  }
  template <int K, bool TA>
  __device__ __forceinline__ void mma(const float* A, int lda,
                                      const float* B, int ldb) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, m = idx / N, n = idx % N;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        s = fmaf(TA ? A[k * lda + m] : A[m * lda + k], B[k * ldb + n], s);
      c[i] += s;
    }
  }
  __device__ __forceinline__ void store(float* C, int ldc) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT;
      C[(idx / N) * ldc + idx % N] = c[i];
    }
  }
  // Rows [row0, row0 + M) of a (rows_total, N) output in device memory,
  // times `scale`; rows past rows_total are not written.  Neighbouring
  // threads hold neighbouring columns, so the stores coalesce.
  __device__ __forceinline__ void store_rows(float* dst, int row0,
                                             int rows_total,
                                             float scale) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, r = row0 + idx / N;
      if (r < rows_total) dst[(size_t)r * N + idx % N] = c[i] * scale;
    }
  }
};

// Write rows [row0, row0 + ROWS) of a (rows_total, D) output from a shared
// staging tile, times `scale`.
template <int D, int ROWS>
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           int ld, int row0, int rows_total,
                                           float scale) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D;
    if (row0 + r < rows_total)
      dst[(size_t)(row0 + r) * D + c] = src[r * ld + c] * scale;
  }
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
