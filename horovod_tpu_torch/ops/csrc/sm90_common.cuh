// Hopper (sm_90a) building blocks shared by the wgmma/TMA bodies of the
// flash forward (flash_fwd_sm90.cuh: K1, K4) and backward
// (flash_bwd_sm90.cuh: B2, K5): mbarriers, TMA loads through 3-D tensor
// maps, wgmma shared-memory descriptors and groups, and the run-time
// fetch of the tensor-map encoder.
//
// Layout convention of both bodies: a tile of R rows of head dim D sits
// in shared memory as D / PANEL panels of R x 64 bytes (32 16-bit
// elements per row), each as TMA writes it with 64-byte swizzle: the
// 16-byte chunk c of row r lands at chunk c ^ ((r >> 1) & 3) of its row,
// relative to a 512-byte-aligned panel.  One CTA is a producer warpgroup
// and two consumer warpgroups.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at
                   // run time, so nothing links against libcuda.

#include "flash_common.cuh"
#include "wgmma_sm90.cuh"

namespace hvdt {
namespace sm90 {

constexpr int NTHREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PANEL = 32;      // head-dim elements per 64-byte swizzle row
// Registers per thread after setmaxnreg: 128 * 40 + 256 * 232 is the
// 384 * 168 the CTA starts with.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// An mbarrier wait that outlives this is a fault: trap, so the launch
// fails instead of holding the card.
constexpr unsigned long long WAIT_TIMEOUT_NS = 2ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive on `bar` from the threads where `pred` holds, predicated in
// place: no branch, so no divergence around wgmma in flight.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - t0 > WAIT_TIMEOUT_NS) __trap();
}

// One TMA box {PANEL, rows, 1} at (c0, c1, c2) into shared `dst`; the
// transfer completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Rows [row0, row0 + rows) of head `bh` as PANELS panels of rows x 64 B.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int row0,
                                         int bh) {
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p)
    tma_load(dst + p * rows * PANEL * 2, map, bar, p * PANEL, row0, bh);
}

// TMA reduce-add of the f32 box at (c0, c1, c2) of `map` from shared
// `src` into global memory, in this thread's bulk group.  Elements past
// the tensor's bounds are not written.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1,
                                               int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Wait until this thread's bulk groups have read their shared memory
// (READ) or have completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// wgmma shared-memory descriptor, 64-byte swizzle: start address, leading
// and stride byte offsets (all >> 4).  K-major operands: rows of 64 B,
// 8-row groups 512 B apart (stride), leading offset unused (1).  MN-major
// operands (V, dO and q' as B of P V, P^T dO, dS^T q'; dS^T and K of the
// backward's dQ = dS K): 32 MN elements contiguous, the next 32 one panel
// away (leading), 8-row groups along K 512 B apart (stride).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread (the generic proxy) made visible to
// the asynchronous proxy that wgmma and TMA read through; a barrier
// follows.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, fetched through the runtime so that nothing
// links against the driver library.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

namespace {
EncodeTiled g_encode = nullptr;
}  // namespace

inline int encode_fn(EncodeTiled* fn) {
  if (g_encode == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    g_encode = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = g_encode;
  return 0;
}

// Map of a contiguous (bh, rows, D) tensor of T, boxes of 64 bytes of
// head dim (PANEL 16-bit elements, 64-byte swizzle) or, for f32, of 128
// bytes (32 elements, 128-byte swizzle) x box_rows x 1; zero fill past
// `rows` on loads, nothing written there by stores.  Returns 0, or a CUDA
// error code (a driver refusal as cudaErrorInvalidValue).
template <typename T, int D>
int make_map(CUtensorMap* map, const void* ptr, int bh, int rows,
             int box_rows) {
  EncodeTiled encode;
  const int e = encode_fn(&encode);
  if (e != 0) return e;
  constexpr bool F32 = std::is_same<T, float>::value;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)rows * D * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)(F32 ? 32 : PANEL),
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __nv_bfloat16>::value
          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace hvdt
