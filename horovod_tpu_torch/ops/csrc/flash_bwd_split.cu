// The split flash backward for Hopper (sm_90a): K2 (flash_bwd_dkdv) and K3
// (flash_bwd_dq), the backward wherever the reference's plan picks the
// split mode (long sequences, many batch-heads; ops/attention.py
// `bwd_mode`).
//
// They replace the Pallas TPU kernels `_flash_bwd_dkdv_kernel` and
// `_flash_bwd_dq_kernel` (B3, horovod_tpu/ops/attention.py:429, :465,
// launched by `_split_bwd_call` :914, :930; shared math
// `_bwd_block_math`): K2 owns a key tile and loops over query tiles
// (dV += P^T dO, dK += dS^T q'), K3 owns a query tile and loops over key
// tiles (dQ += dS K).  Neither needs atomics; both recompute P and dP.
//
// Bound on the card at the split path's shape (bh 1040, seq 512, head dim
// 64, bf16, causal): K2 69.9 GFLOP (8 d FLOP per causal pair) against 413
// MB, 0.1233 ms by bytes; K3 52.4 GFLOP (6 d) against 345 MB, 0.1030 ms
// by bytes.  Near the ridge: the designs keep the tensor cores fed and
// every intermediate out of device memory.
//
// * 16-bit inputs.  K2 is the backward body of B2 and K5
//   (flash_bwd_sm90.cuh, `bwd_ktile`) with WITH_DQ off: the dS^T stores,
//   their named barrier, the dQ product and its TMA adds are compiled
//   out, and the shared memory they held takes a third (q', dO) stage.
//   dK and dV go out in the input dtype straight from registers; no
//   workspace, no fill, no flush.  One 384-thread CTA per 128-key tile,
//   heavy (early, under a causal mask) key tiles first.  K3 is
//   flash_dq_sm90.cuh's query-stationary body, on the forward's skeleton:
//   one 384-thread CTA per 128-row query tile, heavy (late) query tiles
//   first, dQ in f32 registers, scaled by the pow2 factor and cast once.
//   Their notes give the designs.
// * f32 inputs: K2 is the 3xTF32 wgmma body of flash_wide_f32_sm90.cuh
//   (wide32::dkdv_tile, the one above 256 runs; its note gives the
//   design): 64 keys a CTA, 32-row query steps, a window of the whole
//   head dim up to 128 (d / 32 panels) and two column CTAs of 4 panels at
//   256.  K3 is the SIMT kernel of the first port (scalar FMAs in full
//   f32), one 64-row tile per 128-thread block staged through shared
//   memory (F32BwdSmem's layout): a tensor-core dq meets dP - delta's
//   cancellation at the causal first rows (ROADMAP C).
//
// Head dims 32, 64, 96, 128 and 256: at 256 both 16-bit bodies split the
// output's columns between their consumer warpgroups (64-key and 64-row
// CTAs, two stages), and the f32 K3 takes 32 x 32 tiles.
//
// Grids are 1-D, (tiles x bh) blocks, each block decoding its head and
// tile from blockIdx.x, so any batch-head count launches (a grid's y and
// z dimensions stop at 65,535).  q, k, v, do: contiguous (bh, s, D) in
// one dtype; lse, delta: (bh, sq) f32; grads in the input dtype.

#include "flash_bwd_sm90.cuh"
#include "flash_dq_sm90.cuh"
#include "flash_wide_f32_sm90.cuh"

namespace hvdt {

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mdo,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          int bh_total, int sq, int sk, float scale_r,
                          int causal) {
  const int kt = blockIdx.x / bh_total;  // heavy (early) key tiles first
  sm90::bwd_ktile<T, D, T, false>(&mq, &mdo, &mk, &mv, nullptr, lse, delta,
                                  dk, dv, blockIdx.x % bh_total,
                                  kt * sm90::bwd_keys<D>(), sq, sk, 0, 0,
                                  scale_r, causal);
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int bh_total, int sq, int sk, float scale_r,
                        float dq_scale, int causal) {
  constexpr int ROWS = sm90::dq_rows<D>();
  const int n_qt = (sq + ROWS - 1) / ROWS;
  const int qt = n_qt - 1 - blockIdx.x / bh_total;  // heavy (late) first
  sm90::dq_qtile<T, D>(&mq, &mdo, &mk, &mv, lse, delta, dq,
                       blockIdx.x % bh_total, qt * ROWS, sq, sk, scale_r,
                       dq_scale, causal);
}

// ---------------------------------------------------------------------------
// K3's f32 kernel: 128 threads, square tiles of f32_tile<D>() rows (64; 32
// at head dim 256) through shared memory.
// ---------------------------------------------------------------------------

// Recompute dS for one (query tile q0, key tile k0) pair from the f32
// logits in S and dP into dSs.
template <int D>
__device__ __forceinline__ void softmax_grad(const float* S, const float* dP,
                                             float* dSs,
                                             const float* lse_s,
                                             const float* delta_s, int q0,
                                             int k0, int sk, float scale_r,
                                             int causal) {
  using L = F32BwdSmem<D>;
  constexpr int BM = L::BM, BN = L::BN;
  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN, qpos = q0 + r, kpos = k0 + c;
    float x = S[r * L::LDS + c] * scale_r;
    if (kpos >= sk || (causal && kpos > qpos)) x = NEG_INF;
    const float p = expf(x - lse_s[r]);  // POS_BIG lse zeroes empty rows
    dSs[r * L::LDP + c] = p * (dP[r * L::LDS + c] - delta_s[r]) * scale_r;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s,
                                              const float* lse,
                                              const float* delta, int q0,
                                              int sq) {
  if (threadIdx.x < ROWS) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < sq ? lse[r] : POS_BIG;
    delta_s[threadIdx.x] = r < sq ? delta[r] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int bh_total, int sq,
                            int sk, float scale_r, float dq_scale,
                            int causal) {
  using T = float;
  using L = F32BwdSmem<D>;
  constexpr int BM = L::BM, BN = L::BN;
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

  // Heavy (late, under a causal mask) query tiles first.
  const int n_qt = (sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh_total)) * BM;
  const size_t bh = blockIdx.x % bh_total;
  q += bh * sq * D;
  dout += bh * sq * D;
  dq += bh * sq * D;
  k += bh * sk * D;
  v += bh * sk * D;
  lse += bh * sq;
  delta += bh * sq;

  load_tile<D, BM>(Qs, L::LDT, q, q0, sq);
  load_tile<D, BM>(dOs, L::LDT, dout, q0, sq);
  load_rowstats<BM>(lse_s, delta_s, lse, delta, q0, sq);
  Acc<BM, D> dQ;
  dQ.zero();

  int n_kt = (sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<D, BN>(Ks, L::LDT, k, k0, sk);
    load_tile<D, BN>(Vs, L::LDT, v, k0, sk);
    __syncthreads();
    mm_smem<BM, BN, D, true, false>(S, L::LDS, Qs, L::LDT, Ks, L::LDT);
    mm_smem<BM, BN, D, true, false>(dP, L::LDS, dOs, L::LDT, Vs, L::LDT);
    __syncthreads();
    softmax_grad<D>(S, dP, dSs, lse_s, delta_s, q0, k0, sk, scale_r,
                    causal);
    __syncthreads();
    dQ.template mma<BN, false>(dSs, L::LDP, Ks, L::LDT);  // dS K
  }
  // The pow2 factor of sm_scale, applied in f32 before the cast.
  dQ.store_rows(dq, q0, sq, dq_scale);
}

// Set both kernels' shared-memory limits once per (dtype, D), before
// their first launch (internal linkage: a mutant build loaded beside this
// one keeps its own flags).
namespace {
bool g_prepared[3][N_HEAD_DIMS] = {};
}  // namespace

template <typename T, int D>
int prepare_split() {
  constexpr bool f32 = std::is_same<T, float>::value;
  bool& ready = g_prepared[f32 ? 0 : std::is_same<T, __half>::value ? 1 : 2]
                          [head_dim_slot<D>()];
  if (ready) return 0;
  constexpr auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  int e;
  if constexpr (f32) {
    e = (int)cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>, attr,
                                  (int)F32BwdSmem<D>::bytes);
  } else {
    e = (int)cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>, attr,
                                  (int)sm90::BwdSmem<D, false>::bytes);
    if (e == 0)
      e = (int)cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, attr,
                                    (int)sm90::DqSmem<D>::bytes);
  }
  ready = e == 0;
  return e;
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int bh, int sq, int sk, float scale_r,
                int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return wide32::launch_dkdv<wide32::window_panels<D>()>(
        q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, D, scale_r, causal,
        stream);
  } else {
    const int prep = prepare_split<T, D>();
    if (prep != 0) return prep;
    CUtensorMap m[4];
    const int e =
        sm90::make_bwd_maps<T, D>(m, q, dout, k, v, nullptr, bh, sq, sk);
    if (e != 0) return e;
    const int blocks = ((sk + sm90::bwd_keys<D>() - 1) / sm90::bwd_keys<D>()) *
                       bh;
    flash_bwd_dkdv_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::BwdSmem<D, false>::bytes,
           stream>>>(m[0], m[1], m[2], m[3], lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), bh, sq, sk, scale_r, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, float scale_r, float dq_scale, int causal,
              cudaStream_t stream) {
  const int prep = prepare_split<T, D>();
  if (prep != 0) return prep;
  if constexpr (std::is_same<T, float>::value) {
    const int blocks = ((sq + f32_tile<D>() - 1) / f32_tile<D>()) * bh;
    flash_bwd_dq_f32_kernel<D><<<blocks, NT, F32BwdSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), bh, sq, sk, scale_r, dq_scale,
        causal);
  } else {
    CUtensorMap m[4];
    const int e = sm90::make_dq_maps<T, D>(m, q, dout, k, v, bh, sq, sk);
    if (e != 0) return e;
    const int blocks = ((sq + sm90::dq_rows<D>() - 1) / sm90::dq_rows<D>()) *
                       bh;
    flash_bwd_dq_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::DqSmem<D>::bytes, stream>>>(
            m[0], m[1], m[2], m[3], lse, delta, static_cast<T*>(dq), bh, sq,
            sk, scale_r, dq_scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace hvdt

extern "C" int hvdt_flash_bwd_dkdv(int dtype, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int bh, int sq, int sk, float scale_r,
                                   int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH_WIDE(dtype, d, launch_dkdv, q, k, v, dout, lse, delta, dk,
                     dv, bh, sq, sk, scale_r, causal,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_flash_bwd_dq(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int bh,
                                 int sq, int sk, float scale_r,
                                 float dq_scale, int causal, void* stream) {
  using namespace hvdt;
  HVDT_DISPATCH_WIDE(dtype, d, launch_dq, q, k, v, dout, lse, delta, dq, bh,
                     sq, sk, scale_r, dq_scale, causal,
                     static_cast<cudaStream_t>(stream));
}
