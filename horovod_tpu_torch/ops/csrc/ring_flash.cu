// K4 (ring_flash_fwd) and K5 (ring_flash_bwd): one step of the fused ring
// flash attention, forward and backward, for Hopper (sm_90a).
//
// K4 replaces the Pallas TPU kernel `_step_kernel`
// (horovod_tpu/ops/ring_flash.py): flash attention of the member's query
// shard over the K/V shard it holds, at absolute positions q_off/k_off for
// the causal mask across shards, while the same launch copies the held K/V
// into the right neighbour's receive slot.  K5 replaces
// `_combined_bwd_kernel` with rotate=True (horovod_tpu/ops/attention.py,
// reached through ring_flash.py's `_bwd_ring_step`): one recompute of P and
// dP per tile pair feeds dK, dV and dQ, with the same copy.  With zero
// offsets and no copy, K5 is also B2 (`_combined_bwd_kernel` rotate=False):
// gradients in the input dtype, dQ scaled by the pow2 part of sm_scale in
// f32 before the cast.
//
// One launch holds two kinds of blocks.  Blocks [0, n_copy) are copy
// blocks: after the ready handshake (ring_common.cuh) they copy k and v
// into slot (dst, phase) of the mesh's receive slots, dst = (my + 1) % n,
// where the neighbour's next step reads them.  The other blocks attend,
// one 64-row tile each, as K1 (flash_fwd.cu) and K2 (flash_bwd.cu) do.
// n_copy = 0 is the last, non-rotating ring step.  The copy blocks come
// first in the grid so that they are dispatched first and the copy flies
// under the attention blocks.
//
// dQ: the TPU kernel carries a whole-shard dQ scratch across its sequential
// grid.  Hopper blocks run in no order, so each K5 block owns a key tile
// (dK, dV in registers, as K2) and adds its dS K product for every query
// tile into an f32 dQ buffer with atomicAdd.  The ring passes the member's
// running dQ total, zeroed at the first step, so the per-step partials sum
// in place (in q' units, dq_scale = 1); the B2 use zeroes a scratch and a
// second small kernel applies dq_scale in f32 and casts.  atomicAdd makes
// the f32 summation order vary from run to run.
//
// Sentinels as in flash_common.cuh: a query row that sees no key of the
// held shard (a step wholly in its future) gets o = 0 and lse = POS_BIG,
// as the TPU kernel's init-then-finalize does; whole key tiles above the
// diagonal are skipped (`k_start <= q_start + block_q - 1`).
//
// Bound on the card: at the ring path's shape (bh 32 per member, shard
// 1024, head_dim 64, bf16) a wholly visible step does 8.6 GFLOP (K4) and
// 21.5 GFLOP (K5) against 17-30 MB of traffic plus the 8.4 MB copy, so
// both are bound by the tensor cores (9-22 us at the published peak).
// The blocks stage every product through shared memory with WMMA, as
// K1-K3 do, and sit far from that bound; a wgmma/TMA pipeline is later
// work.

#include <algorithm>

#include "ring_common.cuh"

namespace hvdt {

template <typename T, int D>
struct RingFwdSmem {  // flash_fwd.cu's FwdSmem
  static constexpr int LDT = D + Pad<T>::v;
  static constexpr int LDP = BN + Pad<T>::v;
  static constexpr int LDS = BN + 4;
  static constexpr int LDA = D + 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + BM * LDT * sizeof(T));
  static constexpr size_t v = align128(k + BN * LDT * sizeof(T));
  static constexpr size_t p = align128(v + BN * LDT * sizeof(T));
  static constexpr size_t s = align128(p + BM * LDP * sizeof(T));
  static constexpr size_t acc = align128(s + BM * LDS * sizeof(float));
  static constexpr size_t m = align128(acc + BM * LDA * sizeof(float));
  static constexpr size_t l = m + BM * sizeof(float);
  static constexpr size_t alpha = l + BM * sizeof(float);
  static constexpr size_t bytes = alpha + BM * sizeof(float);
};

template <typename T, int D>
struct RingBwdSmem {  // flash_bwd.cu's BwdSmem
  static constexpr int LDT = D + Pad<T>::v;
  static constexpr int LDP = BN + Pad<T>::v;
  static constexpr int LDS = BN + 4;
  static constexpr int LDO = D + 4;  // f32 staging of a dQ tile / dK, dV
  static constexpr size_t a = 0;     // K tile
  static constexpr size_t b = align128(a + BM * LDT * sizeof(T));  // V
  static constexpr size_t c = align128(b + BM * LDT * sizeof(T));  // Q
  static constexpr size_t d = align128(c + BM * LDT * sizeof(T));  // dO
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

// The copy role of a rotating step: k and v (bh * sk * D each) into the
// right neighbour's slot of this phase.  Slots: (n, 2, bh, sk, D).
template <typename T, int D>
__device__ void copy_role(const T* k, const T* v, T* k_slots, T* v_slots,
                          int bh, int sk, int phase, int n_copy,
                          const Ring& ring) {
  if (!copy_gate(ring, 1, blockIdx.x)) return;
  const size_t elems = (size_t)bh * sk * D;
  const size_t off = ((size_t)((ring.my + 1) % ring.n) * 2 + phase) * elems;
  copy_chunks(k_slots + off, k, elems * sizeof(T), blockIdx.x, n_copy);
  copy_chunks(v_slots + off, v, elems * sizeof(T), blockIdx.x, n_copy);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    ring_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int bh_total, int sq, int sk,
                    int q_off, int k_off, float scale_r, int causal,
                    T* k_slots, T* v_slots, int n_copy, int phase,
                    Ring ring) {
  if ((int)blockIdx.x < n_copy) {
    copy_role<T, D>(k, v, k_slots, v_slots, bh_total, sk, phase, n_copy,
                    ring);
    return;
  }
  using L = RingFwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  T* Ps = reinterpret_cast<T*>(smem + L::p);
  float* S = reinterpret_cast<float*>(smem + L::s);
  float* Acc = reinterpret_cast<float*>(smem + L::acc);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);
  float* a_s = reinterpret_cast<float*>(smem + L::alpha);

  const int a = blockIdx.x - n_copy;
  const int n_qt = (sq + BM - 1) / BM;
  const int q0 = (a % n_qt) * BM;
  const size_t bh = a / n_qt;
  q += bh * sq * D;
  k += bh * sk * D;
  v += bh * sk * D;
  o += bh * sq * D;
  lse += bh * sq;

  load_tile<T, D, BM>(Qs, L::LDT, q, q0, sq);
  for (int i = threadIdx.x; i < BM * L::LDA; i += NT) Acc[i] = 0.f;
  if (threadIdx.x < BM) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }

  int n_kt = (sk + BN - 1) / BN;
  if (causal) {
    // Key tiles whose first absolute position lies past this query tile's
    // last one are wholly masked; a held shard wholly in the future leaves
    // no tile at all (o = 0, lse = POS_BIG below).
    const int lim = q_off + q0 + BM - 1 - k_off;
    n_kt = lim < 0 ? 0 : min(n_kt, lim / BN + 1);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, D, BN>(Ks, L::LDT, k, k0, sk);
    load_tile<T, D, BN>(Vs, L::LDT, v, k0, sk);
    __syncthreads();
    mm_smem<T, BM, BN, D, true, false>(S, L::LDS, Qs, L::LDT, Ks, L::LDT);
    __syncthreads();
    for (int r = warp * (BM / 4); r < (warp + 1) * (BM / 4); ++r) {
      const int qpos = q_off + q0 + r;
      float sv[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        float x = S[r * L::LDS + c] * scale_r;
        if (k0 + c >= sk || (causal && k_off + k0 + c > qpos)) x = NEG_INF;
        sv[j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(sv[j] - m_safe);
        Ps[r * L::LDP + lane + 32 * j] = from_f<T>(p);
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * D; i += NT) {
      const int r = i / D, c = i % D;
      Acc[r * L::LDA + c] *= a_s[r];
    }
    __syncthreads();
    mm_smem<T, BM, D, BN, false, true>(Acc, L::LDA, Ps, L::LDP, Vs, L::LDT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq) {
      const float l = l_s[r];
      o[(size_t)(q0 + r) * D + c] =
          from_f<T>(Acc[r * L::LDA + c] / (l == 0.f ? 1.f : l));
    }
  }
  if (threadIdx.x < BM && q0 + threadIdx.x < sq) {
    const float l = l_s[threadIdx.x];
    lse[q0 + threadIdx.x] =
        l == 0.f ? POS_BIG : m_s[threadIdx.x] + logf(fmaxf(l, 1e-37f));
  }
}

template <typename T, int D, typename OT>
__global__ void __launch_bounds__(NT)
    ring_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, OT* __restrict__ dk,
                    OT* __restrict__ dv, float* __restrict__ dq,
                    int bh_total, int sq, int sk, int q_off, int k_off,
                    float scale_r, int causal, T* k_slots, T* v_slots,
                    int n_copy, int phase, Ring ring) {
  if ((int)blockIdx.x < n_copy) {
    copy_role<T, D>(k, v, k_slots, v_slots, bh_total, sk, phase, n_copy,
                    ring);
    return;
  }
  using L = RingBwdSmem<T, D>;
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

  const int a = blockIdx.x - n_copy;
  const int n_kt = (sk + BN - 1) / BN;
  const int k0 = (a % n_kt) * BN;
  const size_t bh = a / n_kt;
  q += bh * sq * D;
  dout += bh * sq * D;
  dq += bh * sq * D;
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
  int qt0 = 0;
  if (causal) {
    // First query tile whose last absolute row reaches this key tile
    // (reference: `q_start + block_q - 1 >= k_start`).
    const int need = k_off + k0 - q_off - BM + 1;
    qt0 = need <= 0 ? 0 : (need + BM - 1) / BM;
  }
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_tile<T, D, BM>(Qs, L::LDT, q, q0, sq);
    load_tile<T, D, BM>(dOs, L::LDT, dout, q0, sq);
    if (threadIdx.x < BM) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < sq ? lse[r] : POS_BIG;
      delta_s[threadIdx.x] = r < sq ? delta[r] : 0.f;
    }
    __syncthreads();
    mm_smem<T, BM, BN, D, true, false>(S, L::LDS, Qs, L::LDT, Ks, L::LDT);
    mm_smem<T, BM, BN, D, true, false>(dP, L::LDS, dOs, L::LDT, Vs, L::LDT);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      float x = S[r * L::LDS + c] * scale_r;
      if (k0 + c >= sk || (causal && k_off + k0 + c > q_off + q0 + r))
        x = NEG_INF;
      const float p = expf(x - lse_s[r]);  // POS_BIG lse zeroes empty rows
      Ps[r * L::LDP + c] = from_f<T>(p);
      dSs[r * L::LDP + c] =
          from_f<T>(p * (dP[r * L::LDS + c] - delta_s[r]) * scale_r);
    }
    __syncthreads();
    dV.template mma<BM, true>(Ps, L::LDP, dOs, L::LDT);   // P^T dO
    dK.template mma<BM, true>(dSs, L::LDP, Qs, L::LDT);   // dS^T Q
    // dQ tile = dS K, staged in the S/dP bytes (free until the next tile).
    mm_smem<T, BM, D, BN, false, false>(S, L::LDO, dSs, L::LDP, Ks, L::LDT);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * D; i += NT) {
      const int r = i / D, c = i % D;
      if (q0 + r < sq) atomicAdd(dq + (size_t)(q0 + r) * D + c,
                                 S[r * L::LDO + c]);
    }
  }
  __syncthreads();
  dK.store(S, L::LDO);
  __syncthreads();
  store_rows<OT, D, BN>(dk, S, L::LDO, k0, sk, 1.f);
  __syncthreads();
  dV.store(S, L::LDO);
  __syncthreads();
  store_rows<OT, D, BN>(dv, S, L::LDO, k0, sk, 1.f);
}

// B2's flush: dq_out = cast(dq * dq_scale), the scale applied in f32.
template <typename T>
__global__ void scale_cast_kernel(T* __restrict__ out,
                                  const float* __restrict__ in, size_t n,
                                  float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = from_f<T>(in[i] * scale);
}

// Set each kernel's shared-memory limit once, before its first launch.
// This also loads the kernels (CUDA loads a module's functions lazily, and
// a lazy load may wait for the card to go idle, which a ring kernel
// waiting for its neighbour's launch must never meet: RingMesh prepares
// every kernel when it is built).  The flags have internal linkage: a
// static local of a template instantiation would be one object shared by
// every library loaded into the process (a mutant build beside the sound
// one, tools/torch_kernel_control.py).
namespace {
bool g_prepared[3][4] = {};
template <typename T>
constexpr int dtype_slot() {
  return std::is_same<T, float>::value ? 0
         : std::is_same<T, __half>::value ? 1 : 2;
}
}  // namespace

template <typename T, int D>
int prepare_ring() {
  bool& ready = g_prepared[dtype_slot<T>()][D / 32 - 1];
  if (ready) return 0;
  cudaFuncAttributes attr;
  int e = (int)cudaFuncSetAttribute(
      ring_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)RingFwdSmem<T, D>::bytes);
  e |= (int)cudaFuncSetAttribute(
      ring_bwd_kernel<T, D, float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)RingBwdSmem<T, D>::bytes);
  e |= (int)cudaFuncSetAttribute(
      ring_bwd_kernel<T, D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)RingBwdSmem<T, D>::bytes);
  e |= (int)cudaFuncGetAttributes(&attr, scale_cast_kernel<T>);
  e |= (int)cudaFuncGetAttributes(&attr, scale_cast_kernel<float>);
  ready = e == 0;
  return e;
}

template <typename T, int D>
int launch_ring_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int bh, int sq, int sk, int q_off, int k_off,
                    float scale_r, int causal, void* k_slots, void* v_slots,
                    int n_copy, int phase, Ring ring, cudaStream_t stream) {
  const int prep = prepare_ring<T, D>();
  if (prep != 0) return prep;
  constexpr size_t smem = RingFwdSmem<T, D>::bytes;
  const int blocks = n_copy + ((sq + BM - 1) / BM) * bh;
  ring_fwd_kernel<T, D><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, bh, sq, sk, q_off,
      k_off, scale_r, causal, static_cast<T*>(k_slots),
      static_cast<T*>(v_slots), n_copy, phase, ring);
  return (int)cudaGetLastError();
}

template <typename T, int D, typename OT>
int launch_ring_bwd_as(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, float* dq, int bh, int sq, int sk,
                       int q_off, int k_off, float scale_r, int causal,
                       void* k_slots, void* v_slots, int n_copy, int phase,
                       Ring ring, cudaStream_t stream) {
  const int prep = prepare_ring<T, D>();
  if (prep != 0) return prep;
  constexpr size_t smem = RingBwdSmem<T, D>::bytes;
  const int blocks = n_copy + ((sk + BN - 1) / BN) * bh;
  ring_bwd_kernel<T, D, OT><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<OT*>(dk), static_cast<OT*>(dv), dq, bh, sq, sk, q_off,
      k_off, scale_r, causal, static_cast<T*>(k_slots),
      static_cast<T*>(v_slots), n_copy, phase, ring);
  return (int)cudaGetLastError();
}

// dk, dv in f32 when f32_out (the ring's partials), else in T.  dQ sums
// into the f32 buffer dq32 (zeroed first when zero_dq); when dq_out is
// given, dq_out = cast(dq32 * dq_scale) follows (B2's flush), in f32 when
// f32_out, else in T.
template <typename T, int D>
int launch_ring_bwd(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, float* dq32, void* dq_out,
                    int f32_out, float dq_scale, int zero_dq, int bh, int sq,
                    int sk, int q_off, int k_off, float scale_r, int causal,
                    void* k_slots, void* v_slots, int n_copy, int phase,
                    Ring ring, cudaStream_t stream) {
  const size_t nq = (size_t)bh * sq * D;
  if (zero_dq) {
    const cudaError_t e = cudaMemsetAsync(dq32, 0, nq * sizeof(float),
                                          stream);
    if (e != cudaSuccess) return (int)e;
  }
  int rc;
  if (f32_out)
    rc = launch_ring_bwd_as<T, D, float>(
        q, k, v, dout, lse, delta, dk, dv, dq32, bh, sq, sk, q_off, k_off,
        scale_r, causal, k_slots, v_slots, n_copy, phase, ring, stream);
  else
    rc = launch_ring_bwd_as<T, D, T>(
        q, k, v, dout, lse, delta, dk, dv, dq32, bh, sq, sk, q_off, k_off,
        scale_r, causal, k_slots, v_slots, n_copy, phase, ring, stream);
  if (rc != 0 || dq_out == nullptr) return rc;
  const int blocks = (int)std::min<size_t>((nq + 255) / 256, 4096);
  if (f32_out)
    scale_cast_kernel<float><<<blocks, 256, 0, stream>>>(
        static_cast<float*>(dq_out), dq32, nq, dq_scale);
  else
    scale_cast_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<T*>(dq_out), dq32, nq, dq_scale);
  return (int)cudaGetLastError();
}

}  // namespace hvdt

extern "C" int hvdt_ring_flash_fwd(
    int dtype, int d, const void* q, const void* k, const void* v, void* o,
    float* lse, int bh, int sq, int sk, int q_off, int k_off, float scale_r,
    int causal, void* k_slots, void* v_slots, int n_copy, int phase,
    int* flags, int* go, int* err, int my, int n, int ns, int epoch,
    void* stream) {
  using namespace hvdt;
  const Ring ring{flags, go, err, my, n, ns, epoch};
  HVDT_DISPATCH(dtype, d, launch_ring_fwd, q, k, v, o, lse, bh, sq, sk,
                q_off, k_off, scale_r, causal, k_slots, v_slots, n_copy,
                phase, ring, static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_ring_flash_bwd(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, float* dq32, void* dq_out, int f32_out, float dq_scale,
    int zero_dq, int bh, int sq, int sk, int q_off, int k_off, float scale_r,
    int causal, void* k_slots, void* v_slots, int n_copy, int phase,
    int* flags, int* go, int* err, int my, int n, int ns, int epoch,
    void* stream) {
  using namespace hvdt;
  const Ring ring{flags, go, err, my, n, ns, epoch};
  HVDT_DISPATCH(dtype, d, launch_ring_bwd, q, k, v, dout, lse, delta, dk, dv,
                dq32, dq_out, f32_out, dq_scale, zero_dq, bh, sq, sk, q_off,
                k_off, scale_r, causal, k_slots, v_slots, n_copy, phase, ring,
                static_cast<cudaStream_t>(stream));
}

extern "C" int hvdt_ring_flash_prepare() {
  using namespace hvdt;
  int e = 0;
#define HVDT_PREPARE(T) \
  e |= prepare_ring<T, 32>() | prepare_ring<T, 64>() | \
       prepare_ring<T, 96>() | prepare_ring<T, 128>();
  HVDT_PREPARE(float)
  HVDT_PREPARE(__half)
  HVDT_PREPARE(__nv_bfloat16)
#undef HVDT_PREPARE
  return e;
}
