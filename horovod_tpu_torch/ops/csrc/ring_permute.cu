// K6 (ring_permute) and K7 (phase_closer): the ring's rotation and its
// barrier-only closer, for Hopper (sm_90a).
//
// K6 replaces the Pallas TPU kernel `_permute_kernel`
// (horovod_tpu/ops/rdma.py): after the ready handshake (signal the
// source, wait for the destination; ring_common.cuh), member `my` copies
// its shard, bit for bit, into the receive slot of member
// (my + shift) mod n.  The receive slots of one call are the output
// tensors the wrapper allocates for every member, passed as a table; the
// kernel picks its destination from it.  All blocks are copy blocks.
//
// K7 replaces `_phase_closer_kernel` (horovod_tpu/ops/ring_flash.py): the
// handshake alone (shift 1, the fused ring's namespace on phase 1), then an
// (8, 128) f32 zero block.  It closes a fused pass whose number of
// rotating steps is odd, so every pass's namespace stream starts on phase
// 0 and ends on phase 1 and reruns alternate.
//
// Bound on the card: K6 moves the shard once (read + write); at the ring
// path's shape (bh 32, shard 1024, head_dim 64, bf16: 4.2 MB) that is
// 2.5 us of HBM time.  K7 moves 4 KB; its time is the handshake's.

#include "ring_common.cuh"

namespace hvdt {

struct SlotTable {
  void* p[MAX_MEMBERS];
};

__global__ void permute_kernel(const void* __restrict__ src, SlotTable dst,
                               size_t bytes, int shift, Ring ring) {
  if (!copy_gate(ring, shift, blockIdx.x)) return;
  const int to = ((ring.my + shift) % ring.n + ring.n) % ring.n;
  copy_chunks(dst.p[to], src, bytes, blockIdx.x, gridDim.x);
}

__global__ void phase_closer_kernel(float* __restrict__ out, Ring ring) {
  __shared__ int ok;
  if (threadIdx.x == 0) ok = handshake(ring, 1);
  __syncthreads();
  if (!ok) return;
  for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) out[i] = 0.f;
}

}  // namespace hvdt

extern "C" int hvdt_ring_permute(const void* src, void* const* dst_table,
                                 size_t bytes, int blocks, int shift,
                                 int* flags, int* go, int* err, int my, int n,
                                 int ns, int epoch, void* stream) {
  using namespace hvdt;
  if (n < 1 || n > MAX_MEMBERS || bytes % 16 != 0) return -1;
  SlotTable table{};
  for (int i = 0; i < n; ++i) table.p[i] = dst_table[i];
  const Ring ring{flags, go, err, my, n, ns, epoch};
  permute_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      src, table, bytes, shift, ring);
  return (int)cudaGetLastError();
}

extern "C" int hvdt_phase_closer(float* out, int* flags, int* err, int my,
                                 int n, int ns, void* stream) {
  using namespace hvdt;
  const Ring ring{flags, nullptr, err, my, n, ns, 0};
  phase_closer_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      out, ring);
  return (int)cudaGetLastError();
}

// Load both kernels before any ring launch (see ring_flash.cu's
// prepare_ring: a lazy load may wait for the card to go idle).
extern "C" int hvdt_ring_permute_prepare() {
  using namespace hvdt;
  cudaFuncAttributes attr;
  int e = (int)cudaFuncGetAttributes(&attr, permute_kernel);
  e |= (int)cudaFuncGetAttributes(&attr, phase_closer_kernel);
  return e;
}
