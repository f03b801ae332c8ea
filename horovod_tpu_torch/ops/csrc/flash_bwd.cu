// The flash-attention backward for Hopper (sm_90a): B2 (flash_bwd), the
// main path's backward wherever the reference's plan picks the combined
// mode, and K2 (flash_bwd_dkdv) + K3 (flash_bwd_dq), the split pair, where
// it picks the split mode (long sequences, many heads; ops/attention.py
// `bwd_mode`).
//
// B2 replaces `_combined_bwd_kernel` with rotate=False
// (horovod_tpu/ops/attention.py:498): flash_bwd_sm90.cuh's body, the one
// K5 (ring_flash.cu) runs, at zero offsets and without copy blocks, one
// 384-thread CTA per 128-key tile for 16-bit inputs (the f32 body's
// 64-key tiles otherwise); dK, dV in the input dtype, dQ summed into the
// caller's zeroed f32 workspace and flushed by scale_cast_kernel: times
// the pow2 factor p2 in f32, then the cast.  Its note gives the bound and
// the design.
//
// K2 and K3, below, are the first port's kernels, unchanged.  They replace
// the Pallas TPU kernels `_flash_bwd_dkdv_kernel` and
// `_flash_bwd_dq_kernel` (B3, horovod_tpu/ops/attention.py:429, :465;
// shared math `_bwd_block_math`): K2 owns a key tile and loops over query
// tiles (dV += P^T dO, dK += dS^T Q), K3 owns a query tile and loops over
// key tiles (dQ += dS K).  Neither needs atomics; both recompute P and dP.
// Per block step: s = q' k^T * scale_r (masked to NEG_INF),
// p = exp(s - lse), dp = dO v^T, ds = p * (dp - delta) * scale_r; K3
// multiplies dQ by p2 in f32 before the cast (which keeps fp16 finite).
// Bound at the training shape: 43 GFLOP of useful products (60 GFLOP as
// split) against 118 MB, ~43 us at the published peak.  They stage every
// product through shared memory with WMMA and are far from it; B3's own
// wgmma redesign is later work.
//
// Grids: (ceil(s / 64), bh); 128 threads.  q, k, v, do: contiguous
// (bh, s, D) in one dtype; lse, delta: (bh, sq) f32; grads in the input
// dtype.

#include <algorithm>

#include "flash_bwd_sm90.cuh"

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

template <int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dq, int sq, int sk,
                         float scale_r, int causal) {
  const size_t bh = blockIdx.y;
  bwd_ktile_f32<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D,
                   dout + bh * sq * D, lse + bh * sq, delta + bh * sq,
                   dk + bh * sk * D, dv + bh * sk * D, dq + bh * sq * D,
                   blockIdx.x * BN, sq, sk, 0, 0, scale_r, causal);
}

// Set B2's shared-memory limit once, before its first launch (internal
// linkage: a mutant build loaded beside this one keeps its own flags).
namespace {
bool g_prepared[3][4] = {};
}  // namespace

template <typename T, int D>
int prepare_bwd() {
  constexpr bool f32 = std::is_same<T, float>::value;
  bool& ready = g_prepared[f32 ? 0 : std::is_same<T, __half>::value ? 1 : 2]
                          [D / 32 - 1];
  if (ready) return 0;
  int e;
  if constexpr (f32)
    e = (int)cudaFuncSetAttribute(flash_bwd_f32_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)F32BwdSmem<D>::bytes);
  else
    e = (int)cudaFuncSetAttribute(flash_bwd_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  const int prep = prepare_bwd<T, D>();
  if (prep != 0) return prep;
  if constexpr (std::is_same<T, float>::value) {
    dim3 grid((sk + BN - 1) / BN, bh);
    flash_bwd_f32_kernel<D><<<grid, NT, F32BwdSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), dq32, sq,
        sk, scale_r, causal);
  } else {
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

template <typename T, int D>
struct BwdSmem {
  static constexpr int LDT = D + Pad<T>::v;
  static constexpr int LDP = BN + Pad<T>::v;
  static constexpr int LDS = BN + 4;
  static constexpr int LDO = D + 4;  // f32 staging of an accumulator
  static constexpr size_t a = 0;     // the block's own tiles (K,V or Q,dO)
  static constexpr size_t b = align128(a + BM * LDT * sizeof(T));
  static constexpr size_t c = align128(b + BM * LDT * sizeof(T));  // loop
  static constexpr size_t d = align128(c + BM * LDT * sizeof(T));  // loop
  // S and dP (f32), contiguous: after the loop the same bytes stage the
  // accumulators on their way out (BM * LDO <= 2 * BM * LDS).
  static constexpr size_t s = align128(d + BM * LDT * sizeof(T));
  static constexpr size_t dp = s + BM * LDS * sizeof(float);
  static constexpr size_t p = align128(dp + BM * LDS * sizeof(float));
  static constexpr size_t ds = align128(p + BM * LDP * sizeof(T));
  static constexpr size_t lse = align128(ds + BM * LDP * sizeof(T));
  static constexpr size_t delta = lse + BM * sizeof(float);
  static constexpr size_t bytes = delta + BM * sizeof(float);
  static_assert(BM * LDO <= 2 * BM * LDS, "staging does not fit S and dP");
  static_assert(BM == BN, "tiles are square");
};

// Recompute P and dS for one (query tile q0, key tile k0) pair.  Reads the
// f32 logits in S and dP, writes p (cast to T) into Ps when WANT_P and
// ds (cast to T) into dSs.
template <typename T, int D, bool WANT_P>
__device__ __forceinline__ void softmax_grad(const float* S, const float* dP,
                                             T* Ps, T* dSs,
                                             const float* lse_s,
                                             const float* delta_s, int q0,
                                             int k0, int sk, float scale_r,
                                             int causal) {
  using L = BwdSmem<T, D>;
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN, qpos = q0 + r, kpos = k0 + c;
    float x = S[r * L::LDS + c] * scale_r;
    if (kpos >= sk || (causal && kpos > qpos)) x = NEG_INF;
    const float p = expf(x - lse_s[r]);  // POS_BIG lse zeroes empty rows
    if (WANT_P) Ps[r * L::LDP + c] = from_f<T>(p);
    dSs[r * L::LDP + c] =
        from_f<T>(p * (dP[r * L::LDS + c] - delta_s[r]) * scale_r);
  }
}

template <typename T>
__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s,
                                              const float* lse,
                                              const float* delta, int q0,
                                              int sq) {
  if (threadIdx.x < BM) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < sq ? lse[r] : POS_BIG;
    delta_s[threadIdx.x] = r < sq ? delta[r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int sq,
                          int sk, float scale_r, int causal) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::a);
  T* Vs = reinterpret_cast<T*>(smem + L::b);
  T* Qs = reinterpret_cast<T*>(smem + L::c);
  T* dOs = reinterpret_cast<T*>(smem + L::d);
  float* S = reinterpret_cast<float*>(smem + L::s);
  float* dP = reinterpret_cast<float*>(smem + L::dp);
  T* Ps = reinterpret_cast<T*>(smem + L::p);
  T* dSs = reinterpret_cast<T*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int k0 = blockIdx.x * BN;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  dout += bh * sq * D;
  k += bh * sk * D;
  v += bh * sk * D;
  dk += bh * sk * D;
  dv += bh * sk * D;
  lse += bh * sq;
  delta += bh * sq;

  load_tile<T, D, BN>(Ks, L::LDT, k, k0, sk);
  load_tile<T, D, BN>(Vs, L::LDT, v, k0, sk);
  Acc<T, BN, D> dK, dV;
  dK.zero();
  dV.zero();

  const int n_qt = (sq + BM - 1) / BM;
  // Causal: query tiles that end before this key tile starts see none of
  // it (reference: `q_start + block_q - 1 >= k_start`).
  const int qt0 = causal ? k0 / BM : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_tile<T, D, BM>(Qs, L::LDT, q, q0, sq);
    load_tile<T, D, BM>(dOs, L::LDT, dout, q0, sq);
    load_rowstats<T>(lse_s, delta_s, lse, delta, q0, sq);
    __syncthreads();
    mm_smem<T, BM, BN, D, true, false>(S, L::LDS, Qs, L::LDT, Ks, L::LDT);
    mm_smem<T, BM, BN, D, true, false>(dP, L::LDS, dOs, L::LDT, Vs, L::LDT);
    __syncthreads();
    softmax_grad<T, D, true>(S, dP, Ps, dSs, lse_s, delta_s, q0, k0, sk,
                             scale_r, causal);
    __syncthreads();
    dV.template mma<BM, true>(Ps, L::LDP, dOs, L::LDT);   // P^T dO
    dK.template mma<BM, true>(dSs, L::LDP, Qs, L::LDT);   // dS^T Q
  }
  __syncthreads();
  dK.store(S, L::LDO);
  __syncthreads();
  store_rows<T, D, BN>(dk, S, L::LDO, k0, sk, 1.f);
  __syncthreads();
  dV.store(S, L::LDO);
  __syncthreads();
  store_rows<T, D, BN>(dv, S, L::LDO, k0, sk, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, float scale_r, float dq_scale,
                        int causal) {
  using L = BwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::a);
  T* dOs = reinterpret_cast<T*>(smem + L::b);
  T* Ks = reinterpret_cast<T*>(smem + L::c);
  T* Vs = reinterpret_cast<T*>(smem + L::d);
  float* S = reinterpret_cast<float*>(smem + L::s);
  float* dP = reinterpret_cast<float*>(smem + L::dp);
  T* dSs = reinterpret_cast<T*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int q0 = blockIdx.x * BM;
  const size_t bh = blockIdx.y;
  q += bh * sq * D;
  dout += bh * sq * D;
  dq += bh * sq * D;
  k += bh * sk * D;
  v += bh * sk * D;
  lse += bh * sq;
  delta += bh * sq;

  load_tile<T, D, BM>(Qs, L::LDT, q, q0, sq);
  load_tile<T, D, BM>(dOs, L::LDT, dout, q0, sq);
  load_rowstats<T>(lse_s, delta_s, lse, delta, q0, sq);
  Acc<T, BM, D> dQ;
  dQ.zero();

  int n_kt = (sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, D, BN>(Ks, L::LDT, k, k0, sk);
    load_tile<T, D, BN>(Vs, L::LDT, v, k0, sk);
    __syncthreads();
    mm_smem<T, BM, BN, D, true, false>(S, L::LDS, Qs, L::LDT, Ks, L::LDT);
    mm_smem<T, BM, BN, D, true, false>(dP, L::LDS, dOs, L::LDT, Vs, L::LDT);
    __syncthreads();
    softmax_grad<T, D, false>(S, dP, nullptr, dSs, lse_s, delta_s, q0, k0,
                              sk, scale_r, causal);
    __syncthreads();
    dQ.template mma<BN, false>(dSs, L::LDP, Ks, L::LDT);  // dS K
  }
  __syncthreads();
  dQ.store(S, L::LDO);
  __syncthreads();
  // The pow2 factor of sm_scale, applied in f32 before the cast.
  store_rows<T, D, BM>(dq, S, L::LDO, q0, sq, dq_scale);
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int bh, int sq, int sk, float scale_r,
                int causal, cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<T, D>::bytes;
  cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((sk + BN - 1) / BN, bh);
  flash_bwd_dkdv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, scale_r, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, float scale_r, float dq_scale, int causal,
              cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<T, D>::bytes;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((sq + BM - 1) / BM, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, scale_r, dq_scale, causal);
  return (int)cudaGetLastError();
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

extern "C" int hvdt_flash_bwd_dkdv(int dtype, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int bh, int sq, int sk, float scale_r,
                                   int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH(dtype, d, launch_dkdv, q, k, v, dout, lse, delta, dk, dv, bh,
                sq, sk, scale_r, causal, static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_flash_bwd_dq(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int bh,
                                 int sq, int sk, float scale_r,
                                 float dq_scale, int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH(dtype, d, launch_dq, q, k, v, dout, lse, delta, dq, bh, sq,
                sk, scale_r, dq_scale, causal,
                static_cast<cudaStream_t>(stream));
}
