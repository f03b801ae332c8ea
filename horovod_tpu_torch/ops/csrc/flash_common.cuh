// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// ring_flash.cu).
//
// Design of the backward kernels (K2, K3, K5) and of the forward's f32 body
// (the 16-bit forward is flash_fwd_sm90.cuh's): one thread block of four
// warps owns one 64-row tile of one (batch*head) row and walks its own
// loop over the other sequence axis.  Operand tiles are staged through
// shared memory; every product accumulates in f32.  16-bit inputs (bf16,
// fp16) multiply on the tensor cores through WMMA 16x16x16 fragments;
// f32 inputs multiply with scalar FMAs in full f32 (the card's TF32
// tensor-core path would keep only ~3 decimal digits).
//
// Sentinels follow the reference (horovod_tpu/ops/attention.py): masked
// logits are NEG_INF = -1e30 instead of -inf so exp() never sees
// inf - inf, and a row with no mass gets lse = POS_BIG = 1e30 so the
// backward's exp(s - lse) is exactly 0 there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace hvdt {

namespace wmma = nvcuda::wmma;

constexpr int BM = 64;   // query rows per tile
constexpr int BN = 64;   // key rows per tile
constexpr int NT = 128;  // threads per block: four warps
constexpr float NEG_INF = -1e30f;
constexpr float POS_BIG = 1e30f;

// Dtype codes shared with the Python wrappers (ops/attention.py).
enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Row padding of a shared-memory tile, in elements.  16-bit tiles pad by
// 16 bytes (WMMA wants a leading dimension that is a multiple of 8 and
// 32-byte aligned fragment pointers); f32 tiles pad by one element so the
// scalar products, whose lanes walk down a column, hit distinct banks.
template <typename T> struct Pad { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 1; };

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
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int rows_total) {
  if constexpr (sizeof(T) == 2) {
    constexpr int VPR = D * 2 / 16;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
      const int r = i / VPR, c = i % VPR, gr = row0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < rows_total)
        val = reinterpret_cast<const uint4*>(src + (size_t)gr * D)[c];
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += NT) {
      const int r = i / D, c = i % D, gr = row0 + r;
      dst[r * ld + c] = gr < rows_total ? src[(size_t)gr * D + c] : T(0);
    }
  }
}

// C[M][N] (f32, shared) = or += sum_k A[m][k] * opB(k, n), where
// opB(k, n) = B[n][k] when TB (the "A B^T" product of the logits) and
// B[k][n] otherwise.  Called by the whole block; the caller syncs after.
template <typename T, int M, int N, int K, bool TB, bool ACC>
__device__ __forceinline__ void mm_smem(float* C, int ldc, const T* A,
                                        int lda, const T* B, int ldb) {
  if constexpr (std::is_same<T, float>::value) {
    for (int idx = threadIdx.x; idx < M * N; idx += NT) {
      const int m = idx / N, n = idx % N;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        s = fmaf(A[m * lda + k], TB ? B[n * ldb + k] : B[k * ldb + n], s);
      C[m * ldc + n] = ACC ? C[m * ldc + n] + s : s;
    }
  } else {
    using LB = typename std::conditional<TB, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    constexpr int TN = N / 16;
    for (int t = warp; t < (M / 16) * TN; t += NT / 32) {
      const int tm = t / TN, tn = t % TN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* cp = C + tm * 16 * ldc + tn * 16;
      if (ACC)
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(a, A + tm * 16 * lda + kk, lda);
        wmma::load_matrix_sync(
            b, TB ? B + tn * 16 * ldb + kk : B + kk * ldb + tn * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
}

// An M x N f32 accumulator held in registers across a block's loop (the
// backward's dK, dV and dQ): += opA(A) * B with opA(A)[m][k] = A[k][m] when
// TA (the "P^T dO" and "dS^T Q" products) and A[m][k] otherwise.
template <typename T, int M, int N, bool SCALAR = std::is_same<T, float>::value>
struct Acc;

template <typename T, int M, int N>
struct Acc<T, M, N, true> {
  static constexpr int PER = M * N / NT;
  float c[PER];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = 0.f;
  }
  template <int K, bool TA>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B,
                                      int ldb) {
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
};

template <typename T, int M, int N>
struct Acc<T, M, N, false> {
  static constexpr int TN = N / 16;
  static constexpr int PER = (M / 16) * TN / (NT / 32);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[PER];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) wmma::fill_fragment(c[i], 0.f);
  }
  template <int K, bool TA>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B,
                                      int ldb) {
    using LA = typename std::conditional<TA, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = warp + i * (NT / 32), tm = t / TN, tn = t % TN;
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(
            a, TA ? A + kk * lda + tm * 16 : A + tm * 16 * lda + kk, lda);
        wmma::load_matrix_sync(b, B + kk * ldb + tn * 16, ldb);
        wmma::mma_sync(c[i], a, b, c[i]);
      }
    }
  }
  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = warp + i * (NT / 32), tm = t / TN, tn = t % TN;
      wmma::store_matrix_sync(C + tm * 16 * ldc + tn * 16, c[i], ldc,
                              wmma::mem_row_major);
    }
  }
};

// Write rows [row0, row0 + ROWS) of a (rows_total, D) output from an f32
// shared staging tile, times `scale`, cast to T.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int ld,
                                           int row0, int rows_total,
                                           float scale) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D;
    if (row0 + r < rows_total)
      dst[(size_t)(row0 + r) * D + c] = from_f<T>(src[r * ld + c] * scale);
  }
}

}  // namespace hvdt

// Instantiate `FN<T, D>` for the dtype code and head dim, or return -1
// (unsupported; the wrappers check first and never reach it).
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
