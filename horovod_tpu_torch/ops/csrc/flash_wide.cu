// K1, K2 and K3 at head dims above 256 for Hopper (sm_90a): the wide
// bodies of the flash forward (flash_fwd_wide) and of the split backward
// (flash_bwd_dkdv_wide, flash_bwd_dq_wide).  In fp16 and bf16 all three
// run the wgmma/TMA bodies of flash_wide_sm90.cuh; in f32 K1 and K2 run
// the 3xTF32 wgmma/TMA bodies of flash_wide_f32_sm90.cuh (each header's
// note gives its design), and K3 the SIMT body below.
//
// They replace the Pallas TPU kernels `_flash_kernel`
// (horovod_tpu/ops/attention.py:356) and `_flash_bwd_dkdv_kernel` /
// `_flash_bwd_dq_kernel` (:429, :465) at the head dims the reference
// computes above 256: its `_bwd_plan` sends every head dim above 128 to
// the split backward, so these three are the kernels it runs there.
//
// K3's f32 SIMT body.  The problem at these widths is shared memory, not
// arithmetic: the bodies up to 256 keep a whole query tile and whole key
// and value tiles resident, and at head dim 512 a 128-row query tile with
// one key and one value tile is 256 KB, above the 227 KB a block may hold.
// This body splits dQ's columns across blocks instead.  A block owns one
// 64-row query tile and DV = 128 columns of dQ.  It streams every key
// tile; for each it forms S = q' k^T and dP = dO v^T over the whole head
// dim in DC = 32-column chunks staged through shared memory, and then
// adds that tile's dS K into its own columns.  Every block of a row tile
// recomputes the same S and dP (d / DV times in all): the price of any
// head dim in ~66 KB of shared memory.
//
// Products are scalar f32 FMAs (SIMT) on operands converted from the
// storage dtype: 256 threads, each holding a 4 x 4 tile of S and a 4 x 8
// tile of dQ (rows ty + 16 i, columns tx + 16 j).  ds is rounded to the
// storage dtype before its product, as the other bodies and the
// reference's `_bwd_block_math` round it (a no-op in f32, the only dtype
// it is built for).  Bound on the card: by operations at every shape the
// callers use (6 d FLOP per causal pair against 2 d bytes); this body
// reaches the SIMT f32 rate at best.
//
// Head dims: any multiple of DC above 256 (the wrappers zero-pad to one,
// ops/attention.py `padded_head_dim`); the last column block of a head
// dim that is not a multiple of DV is masked.  Grids are 1-D, (tiles x
// column blocks x bh) blocks, each decoding its head, column block and
// tile from blockIdx.x, heavy tiles first.  q, k, v, do: contiguous
// (bh, s, d) in one dtype; lse, delta: (bh, sq) f32; outputs in the
// input dtype.  Any sequence length: the ragged tail loads as zeros and
// is masked.

#include "flash_common.cuh"
#include "flash_wide_f32_sm90.cuh"

namespace hvdt {
namespace wide {

constexpr int TR = 64;      // rows of the query tile
constexpr int TK = 64;      // keys of the key tile
constexpr int DC = 32;      // head-dim chunk of the S and dP products
constexpr int DV = 128;     // output columns per block
constexpr int NTH = 256;    // 16 x 16 threads
constexpr int LDC = DC + 1; // chunk tiles: lanes walk down a column
constexpr int LDP = TK + 1; // the dS tile
constexpr int LDV = DV;     // column tiles: lanes walk along a row
constexpr int RI = TR / 16; // rows per thread
constexpr int CJ = TK / 16; // keys per thread
constexpr int VJ = DV / 16; // output columns per thread
static_assert(TR == TK, "one micro-tile shape serves S and the outputs");

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the storage dtype, back in f32.
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f<T>(from_f<T>(x));
}

// Rows [row0, row0 + ROWS) and columns [c0, c0 + W) of a contiguous
// (rows_total, d) matrix into an f32 tile with leading dimension ld;
// what lies outside the matrix reads as 0.
template <typename T, int ROWS, int W>
__device__ __forceinline__ void load_cols(float* dst, int ld, const T* src,
                                          int row0, int rows_total, int c0,
                                          int d) {
  for (int i = threadIdx.x; i < ROWS * W; i += NTH) {
    const int r = i / W, c = i % W, gr = row0 + r, gc = c0 + c;
    dst[r * ld + c] = gr < rows_total && gc < d
                          ? to_f<T>(src[(size_t)gr * d + gc])
                          : 0.f;
  }
}

// s[i][j] = sum over the whole head dim of a[a0 + ty + 16 i] . b[b0 + tx
// + 16 j], the two operands streamed through As and Bs in DC-column
// chunks.  Starts with a barrier, so the caller's previous readers of any
// shared tile are done when it returns.
template <typename T>
__device__ __forceinline__ void row_products(float (&s)[RI][CJ], float* As,
                                             float* Bs, const T* a, int a0,
                                             int a_total, const T* b, int b0,
                                             int b_total, int d) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();
    load_cols<T, TR, DC>(As, LDC, a, a0, a_total, c0, d);
    load_cols<T, TK, DC>(Bs, LDC, b, b0, b_total, c0, d);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DC; ++kk) {
      float av[RI], bv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = As[(ty + 16 * i) * LDC + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bv[j] = Bs[(tx + 16 * j) * LDC + kk];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

// acc[i][jj] += sum_t A[row][t] x X[t][tx + 16 jj] over the TK shared
// rows of the tiles: A is the dS tile (LDP), row = ty + 16 i.
__device__ __forceinline__ void add_product(float (&acc)[RI][VJ],
                                            const float* A, const float* X) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int t = 0; t < TK; ++t) {
    float av[RI], xv[VJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(ty + 16 * i) * LDP + t];
#pragma unroll
    for (int jj = 0; jj < VJ; ++jj) xv[jj] = X[t * LDV + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < VJ; ++jj)
        acc[i][jj] = fmaf(av[i], xv[jj], acc[i][jj]);
  }
}

// Rows [row0, ...) and the block's columns [c0, ...) of a (rows_total, d)
// output, times `scale`, in the storage dtype.
template <typename T>
__device__ __forceinline__ void store_cols(T* dst, const float (&acc)[RI][VJ],
                                           int row0, int rows_total, int c0,
                                           int d, float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows_total) continue;
#pragma unroll
    for (int jj = 0; jj < VJ; ++jj) {
      const int c = c0 + tx + 16 * jj;
      if (c < d) dst[(size_t)r * d + c] = from_f<T>(acc[i][jj] * scale);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[RI][VJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < VJ; ++jj) acc[i][jj] = 0.f;
}

constexpr size_t CHUNKS = (size_t)(TR + TK) * LDC;  // As, Bs
constexpr size_t DQ_SMEM = (CHUNKS + TR * LDP + TK * LDV) * sizeof(float);

// ds of one (query tile, key tile) pair (p masked to 0), rounded to the
// storage dtype, into dSs (rows: queries, columns: keys).
template <typename T>
__device__ __forceinline__ void probs(const float (&s)[RI][CJ],
                                      const float (&dp)[RI][CJ], float* dSs,
                                      const float* lse, const float* delta,
                                      int q0, int sq, int k0, int sk,
                                      float scale_r, int causal) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const float L = row < sq ? lse[row] : 0.f;
    const float D = row < sq ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool on = row < sq && col < sk && !(causal && col > row);
      const float p = on ? expf(s[i][j] * scale_r - L) : 0.f;
      const float ds = p * (dp[i][j] - D) * scale_r;
      dSs[(ty + 16 * i) * LDP + tx + 16 * j] = rounded<T>(ds);
    }
  }
}

// K3: dQ's columns [c0, c0 + DV) of one 64-row query tile, in q units
// (times dq_scale in f32 before the cast).
template <typename T>
__global__ void __launch_bounds__(NTH)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int bh_total, int n_cc, int sq, int sk,
              int d, float scale_r, float dq_scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + TR * LDC;
  float* dSs = Bs + TK * LDC;
  float* Ks = dSs + TR * LDP;  // k's columns of the key tile
  const size_t bh = blockIdx.x % bh_total;
  const int rest = blockIdx.x / bh_total;
  const int c0 = (rest % n_cc) * DV;
  const int q0 = ((sq + TR - 1) / TR - 1 - rest / n_cc) * TR;  // late first
  q += bh * sq * d;
  dout += bh * sq * d;
  k += bh * sk * d;
  v += bh * sk * d;
  dq += bh * sq * d;
  lse += bh * sq;
  delta += bh * sq;

  float acc[RI][VJ];
  zero(acc);
  int n_kt = (sk + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + TR - 1) / TK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    float s[RI][CJ], dp[RI][CJ];
    row_products<T>(s, As, Bs, q, q0, sq, k, k0, sk, d);
    row_products<T>(dp, As, Bs, dout, q0, sq, v, k0, sk, d);
    probs<T>(s, dp, dSs, lse, delta, q0, sq, k0, sk, scale_r, causal);
    load_cols<T, TK, DV>(Ks, LDV, k, k0, sk, c0, d);
    __syncthreads();
    add_product(acc, dSs, Ks);
  }
  store_cols<T>(dq, acc, q0, sq, c0, d, dq_scale);
}

// Set the kernel's shared-memory limit once, before its first launch.
namespace {
bool g_dq_prepared = false;
}  // namespace

inline int blocks(int bh, int rows, int tile, int d) {
  return bh * ((rows + tile - 1) / tile) * ((d + DV - 1) / DV);
}

// fp16 and bf16 go to the wgmma bodies (flash_wide_sm90.cuh), f32 K1 and
// K2 to the 3xTF32 ones (flash_wide_f32_sm90.cuh), so dq_kernel above is
// built for f32 alone.
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
  if constexpr (!std::is_same<T, float>::value) {
    return wide90::launch_dq<T>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                                scale_r, dq_scale, causal, stream);
  } else {
    if (!g_dq_prepared) {
      const int e = (int)cudaFuncSetAttribute(
          dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)DQ_SMEM);
      if (e != 0) return e;
      g_dq_prepared = true;
    }
    dq_kernel<T><<<blocks(bh, sq, TR, d), NTH, DQ_SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), bh, (d + DV - 1) / DV, sq, sk, d, scale_r,
        dq_scale, causal);
    return (int)cudaGetLastError();
  }
}

}  // namespace wide
}  // namespace hvdt

// Instantiate FN<T> for the dtype code; a head dim these bodies do not
// take (not above 256, or not a multiple of DC) returns
// cudaErrorInvalidValue: the wrappers check first and never reach it.
#define HVDT_WIDE_DISPATCH(dtype, d, FN, ...)                               \
  do {                                                                      \
    if ((d) <= 256 || (d) % hvdt::wide::DC != 0)                            \
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
