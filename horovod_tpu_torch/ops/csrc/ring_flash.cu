// K4 (ring_flash_fwd) and K5 (ring_flash_bwd): one step of the fused ring
// flash attention, forward and backward, for Hopper (sm_90a).
//
// K4 replaces the Pallas TPU kernel `_step_kernel`
// (horovod_tpu/ops/ring_flash.py:78): flash attention of the member's query
// shard over the K/V shard it holds, at absolute positions q_off/k_off for
// the causal mask across shards, while the same launch copies the held K/V
// into the right neighbour's receive slot.  K5 replaces
// `_combined_bwd_kernel` with rotate=True (horovod_tpu/ops/attention.py:498,
// reached through ring_flash.py's `_bwd_ring_step`): one recompute of P and
// dP per tile pair feeds dK, dV and dQ, with the same copy.
//
// One launch holds two kinds of blocks.  Blocks [0, n_copy) are copy
// blocks: after the ready handshake (ring_common.cuh) they copy k and v
// into slot (dst, phase) of the mesh's receive slots, dst = (my + 1) % n,
// where the neighbour's next step reads them.  The other blocks attend:
// K4's run flash_fwd_sm90.cuh's forward body, the one K1 runs, at the
// step's offsets (a 128-row query tile per 384-thread block for 16-bit
// inputs, heavy tiles first; the f32 body's 64-row tiles otherwise); K5's
// run flash_bwd_sm90.cuh's backward body, the one B2 (flash_bwd.cu) runs,
// at the step's offsets (a 128-key tile per 384-thread block for 16-bit
// inputs, heavy tiles first; the f32 body's 64-key tiles otherwise).
// n_copy = 0 is the last, non-rotating ring step.  The copy blocks come
// first in the grid so that they are dispatched first and the copy flies
// under the attention blocks; they take the kernel's block shape, and so
// its shared memory, while they wait.
//
// dQ: the TPU kernel carries a whole-shard dQ scratch across its sequential
// grid.  Hopper blocks run in no order, so each K5 block owns a key tile
// and adds its dS K product for every query tile into an f32 dQ buffer
// (a TMA reduce-add for 16-bit inputs, atomicAdd in the f32 body; the
// summation order varies from run to run).  The ring passes the
// member's running dQ total, zeroed at the first step, so the per-step
// partials sum in place (in q' units); dK and dV come out as f32
// partials.
//
// Sentinels as in flash_common.cuh: a query row that sees no key of the
// held shard (a step wholly in its future) gets o = 0 and lse = POS_BIG,
// as the TPU kernel's init-then-finalize does; whole key tiles above the
// diagonal are skipped (`k_start <= q_start + block_q - 1`).
//
// Bound on the card: at the ring path's shape (bh 32 per member, shard
// 1024, head_dim 64, bf16) a wholly visible step does 8.6 GFLOP (K4) and
// 21.5 GFLOP (K5) against 17-30 MB of traffic plus the 8.4 MB copy, so
// both are bound by the tensor cores (9-22 us at the published peak); the
// bodies' notes give their designs.

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"
#include "ring_common.cuh"

namespace hvdt {

// The copy role of a rotating step: k and v (bh * sk * D each) into the
// right neighbour's slot of this phase.  Slots: (n, 2, bh, sk, D).
template <typename T, int D>
__device__ void copy_role(const T* k, const T* v, T* k_slots, T* v_slots,
                          int bh, int sk, int phase, int n_copy,
                          const Ring& ring) {
  if (!copy_gate(ring, 1)) return;
  const size_t elems = (size_t)bh * sk * D;
  const size_t off = ((size_t)((ring.my + 1) % ring.n) * 2 + phase) * elems;
  copy_chunks(k_slots + off, k, elems * sizeof(T), blockIdx.x, n_copy);
  copy_chunks(v_slots + off, v, elems * sizeof(T), blockIdx.x, n_copy);
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    ring_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    T* __restrict__ o, float* __restrict__ lse, int bh_total,
                    int sq, int sk, int q_off, int k_off, float scale_r,
                    int causal, const T* k, const T* v, T* k_slots,
                    T* v_slots, int n_copy, int phase, Ring ring) {
  if ((int)blockIdx.x < n_copy) {
    copy_role<T, D>(k, v, k_slots, v_slots, bh_total, sk, phase, n_copy,
                    ring);
    return;
  }
  const int a = blockIdx.x - n_copy;
  const int n_qt = (sq + sm90::BM - 1) / sm90::BM;
  const int qt = n_qt - 1 - a / bh_total;  // heavy query tiles first
  sm90::fwd_tile<T, D>(&mq, &mk, &mv, o, lse, a % bh_total, qt * sm90::BM,
                       sq, sk, q_off, k_off, scale_r, causal);
}

template <int D>
__global__ void __launch_bounds__(NT)
    ring_fwd_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int bh_total, int sq, int sk,
                        int q_off, int k_off, float scale_r, int causal,
                        float* k_slots, float* v_slots, int n_copy, int phase,
                        Ring ring) {
  if ((int)blockIdx.x < n_copy) {
    copy_role<float, D>(k, v, k_slots, v_slots, bh_total, sk, phase, n_copy,
                        ring);
    return;
  }
  const int a = blockIdx.x - n_copy;
  const int n_qt = (sq + BM - 1) / BM;
  const size_t bh = a % bh_total;
  const int qt = n_qt - 1 - a / bh_total;
  fwd_tile_f32<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D,
                  o + bh * sq * D, lse + bh * sq, qt * BM, sq, sk, q_off,
                  k_off, scale_r, causal);
}

// K5's 16-bit body: dK, dV and dQ as f32 partials.
template <typename T, int D>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
    ring_bwd_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mdq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int bh_total, int sq, int sk,
                    int q_off, int k_off, float scale_r, int causal,
                    const T* k, const T* v, T* k_slots, T* v_slots,
                    int n_copy, int phase, Ring ring) {
  if ((int)blockIdx.x < n_copy) {
    copy_role<T, D>(k, v, k_slots, v_slots, bh_total, sk, phase, n_copy,
                    ring);
    return;
  }
  const int a = blockIdx.x - n_copy;
  const int kt = a / bh_total;  // heavy (early) key tiles first
  sm90::bwd_ktile<T, D, float>(&mq, &mdo, &mk, &mv, &mdq, lse, delta, dk,
                               dv, a % bh_total, kt * sm90::BWD_BN, sq, sk,
                               q_off, k_off, scale_r, causal);
}

template <int D>
__global__ void __launch_bounds__(NT)
    ring_bwd_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dq, int bh_total, int sq, int sk,
                        int q_off, int k_off, float scale_r, int causal,
                        float* k_slots, float* v_slots, int n_copy,
                        int phase, Ring ring) {
  if ((int)blockIdx.x < n_copy) {
    copy_role<float, D>(k, v, k_slots, v_slots, bh_total, sk, phase, n_copy,
                        ring);
    return;
  }
  const int a = blockIdx.x - n_copy;
  const int n_kt = (sk + BN - 1) / BN;
  const size_t bh = a / n_kt;
  bwd_ktile_f32<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D,
                   dout + bh * sq * D, lse + bh * sq, delta + bh * sq,
                   dk + bh * sk * D, dv + bh * sk * D, dq + bh * sq * D,
                   (a % n_kt) * BN, sq, sk, q_off, k_off, scale_r, causal);
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
  int e;
  if constexpr (std::is_same<T, float>::value)
    e = (int)cudaFuncSetAttribute(ring_fwd_f32_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)F32FwdSmem<D>::bytes);
  else
    e = (int)cudaFuncSetAttribute(ring_fwd_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm90::Smem<D>::bytes);
  if constexpr (std::is_same<T, float>::value)
    e |= (int)cudaFuncSetAttribute(
        ring_bwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)F32BwdSmem<D>::bytes);
  else
    e |= (int)cudaFuncSetAttribute(
        ring_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm90::BwdSmem<D>::bytes);
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
  if constexpr (std::is_same<T, float>::value) {
    const int blocks = n_copy + ((sq + BM - 1) / BM) * bh;
    ring_fwd_f32_kernel<D><<<blocks, NT, F32FwdSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, bh, sq,
        sk, q_off, k_off, scale_r, causal, static_cast<float*>(k_slots),
        static_cast<float*>(v_slots), n_copy, phase, ring);
  } else {
    CUtensorMap mq, mk, mv;
    const int e = sm90::make_maps<T, D>(&mq, &mk, &mv, q, k, v, bh, sq, sk);
    if (e != 0) return e;
    const int blocks = n_copy + ((sq + sm90::BM - 1) / sm90::BM) * bh;
    ring_fwd_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::Smem<D>::bytes, stream>>>(
            mq, mk, mv, static_cast<T*>(o), lse, bh, sq, sk, q_off, k_off,
            scale_r, causal, static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(k_slots),
            static_cast<T*>(v_slots), n_copy, phase, ring);
  }
  return (int)cudaGetLastError();
}

// dk, dv: f32 partials.  dQ sums into the f32 buffer dq32, zeroed first
// when zero_dq.
template <typename T, int D>
int launch_ring_bwd(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dk, float* dv, float* dq32, int zero_dq, int bh,
                    int sq, int sk, int q_off, int k_off, float scale_r,
                    int causal, void* k_slots, void* v_slots, int n_copy,
                    int phase, Ring ring, cudaStream_t stream) {
  const int prep = prepare_ring<T, D>();
  if (prep != 0) return prep;
  if (zero_dq) {
    const cudaError_t e = cudaMemsetAsync(
        dq32, 0, (size_t)bh * sq * D * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if constexpr (std::is_same<T, float>::value) {
    const int blocks = n_copy + ((sk + BN - 1) / BN) * bh;
    ring_bwd_f32_kernel<D><<<blocks, NT, F32BwdSmem<D>::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, dk, dv, dq32, bh, sq, sk, q_off, k_off, scale_r, causal,
        static_cast<float*>(k_slots), static_cast<float*>(v_slots), n_copy,
        phase, ring);
  } else {
    CUtensorMap m[5];
    const int e =
        sm90::make_bwd_maps<T, D>(m, q, dout, k, v, dq32, bh, sq, sk);
    if (e != 0) return e;
    const int blocks =
        n_copy + ((sk + sm90::BWD_BN - 1) / sm90::BWD_BN) * bh;
    ring_bwd_kernel<T, D>
        <<<blocks, sm90::NTHREADS, sm90::BwdSmem<D>::bytes, stream>>>(
            m[0], m[1], m[2], m[3], m[4], lse, delta, dk, dv, bh, sq, sk,
            q_off, k_off, scale_r, causal, static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(k_slots),
            static_cast<T*>(v_slots), n_copy, phase, ring);
  }
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
    const void* dout, const float* lse, const float* delta, float* dk,
    float* dv, float* dq32, int zero_dq, int bh, int sq, int sk, int q_off,
    int k_off, float scale_r, int causal, void* k_slots, void* v_slots,
    int n_copy, int phase, int* flags, int* go, int* err, int my, int n,
    int ns, int epoch, void* stream) {
  using namespace hvdt;
  const Ring ring{flags, go, err, my, n, ns, epoch};
  HVDT_DISPATCH(dtype, d, launch_ring_bwd, q, k, v, dout, lse, delta, dk, dv,
                dq32, zero_dq, bh, sq, sk, q_off, k_off, scale_r, causal,
                k_slots, v_slots, n_copy, phase, ring,
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
