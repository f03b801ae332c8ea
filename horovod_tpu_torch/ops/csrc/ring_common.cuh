// Shared pieces of the ring kernels (ring_flash.cu: K4, K5; ring_permute.cu:
// K6, K7): the ready handshake on flag words, the gate that opens a
// launch's copy, the chunked shard copy of K4's and K5's copy blocks, and
// the bulk copies K6 moves its shard with.
//
// The members of a ring live on one card, each with its own stream (see
// horovod_tpu_torch/parallel/mesh.py).  A member copies its shard into a
// buffer that its destination member reads, so, as in the reference
// (horovod_tpu/ops/rdma.py, `_permute_kernel`), it writes only after a
// ready handshake: it signals its SOURCE ("you may write into my slot") and
// waits for the signal of its DESTINATION.  A destination that has entered
// its kernel has finished, in its stream's order, every earlier kernel that
// read the slot.  Reading the member's own shard needs no handshake.
//
// Flag words are int32 counters in device memory, one per member and
// namespace: (n, N_NS).  Signal = a release add of +1 on the source's word;
// wait = spin with acquire loads until the own word is >= 1, then an atomic
// -1 (the reference's `semaphore_wait(bar, 1)`), so after a balanced pass
// every word is back at 0.  The acquire orders every later access of the
// waiting thread after the destination's signal, with no fence around it.
// Consecutive invocations of one chain alternate between two namespaces,
// so a stale signal cannot satisfy a wait.
//
// Every spin polls a short while, then backs off with __nanosleep, and is
// bounded: past SPIN_TIMEOUT_NS, or as soon as another spin has failed,
// the block writes the error word and stores nothing.  The Python side
// reads the word (RingMesh.check) and raises.

#pragma once

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace hvdt {

constexpr int N_NS = 6;  // namespaces: rdma K 0/1, rdma V 2/3, fused 4/5
constexpr int MAX_MEMBERS = 8;
constexpr int COPY_CHUNKS_PER_BLOCK = 4;
constexpr unsigned long long SPIN_TIMEOUT_NS = 10ull * 1000 * 1000 * 1000;
// Polls of a spin before it backs off; then sleeps of 32 ns doubling to
// MAX_NAP_NS between polls.
constexpr int SPIN_POLLS = 64;
constexpr unsigned MAX_NAP_NS = 256;
enum RingError { kHandshakeTimeout = 1, kGateTimeout = 2 };

// One member's view of the ring for one launch.
struct Ring {
  int* flags;  // (n, N_NS) ready counters
  int* go;     // (n, N_NS) go words of the gate
  int* err;    // the mesh's error word
  int my, n, ns, epoch;
};

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Bounded wait for `*word` to satisfy `ok(value)`.  Returns false (and sets
// the error word to `code` on a timeout) when it gives up.
template <typename Pred>
__device__ bool bounded_spin(const int* word, const Ring& r, int code,
                             Pred ok) {
  for (int i = 0; i < SPIN_POLLS; ++i)
    if (ok(ld_acquire(word))) return true;
  const unsigned long long t0 = globaltimer_ns();
  unsigned nap = 32;
  while (!ok(ld_acquire(word))) {
    if (ld_volatile(r.err) != 0) return false;
    if (globaltimer_ns() - t0 > SPIN_TIMEOUT_NS) {
      atomicCAS(r.err, 0, code);
      return false;
    }
    __nanosleep(nap);
    nap = nap < MAX_NAP_NS ? 2 * nap : MAX_NAP_NS;
  }
  return true;
}

// The ready handshake of member r.my for a copy by `shift` (one thread).
__device__ bool handshake(const Ring& r, int shift) {
  const int src = ((r.my - shift) % r.n + r.n) % r.n;
  red_release_add(r.flags + src * N_NS + r.ns, 1);
  int* mine = r.flags + r.my * N_NS + r.ns;
  if (!bounded_spin(mine, r, kHandshakeTimeout,
                    [](int v) { return v >= 1; }))
    return false;
  atomicSub(mine, 1);
  return true;
}

// The gate of one block of a launch that stores into a neighbour's slot
// (one thread): block 0 runs the handshake and publishes the launch's
// epoch in the member's go word with a release store; any other block
// waits for that word with acquire loads, if it has anything to store
// (`need`).  Returns whether the block may store.
__device__ bool gate(const Ring& r, int shift, bool need) {
  int* go = r.go + r.my * N_NS + r.ns;
  if (blockIdx.x == 0) {
    if (!handshake(r, shift)) return false;
    st_release(go, r.epoch);
    return true;
  }
  if (!need) return true;
  const int epoch = r.epoch;
  return bounded_spin(go, r, kGateTimeout,
                      [epoch](int v) { return v == epoch; });
}

// The gate of K4's and K5's copy blocks (blocks [0, n_copy) of the
// launch): thread 0 passes it for the whole block.
__device__ bool copy_gate(const Ring& r, int shift) {
  __shared__ int ok;
  if (threadIdx.x == 0) ok = gate(r, shift, true);
  __syncthreads();
  return ok != 0;
}

// Copy `bytes` (a multiple of 16) from src to dst in 16-byte vectors: the
// copy is cut into n_copy * COPY_CHUNKS_PER_BLOCK equal chunks and copy
// block `cta` takes chunks cta, cta + n_copy, ...
__device__ __forceinline__ void copy_chunks(void* dst, const void* src,
                                            size_t bytes, int cta,
                                            int n_copy) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const size_t nvec = bytes / 16;
  const int n_chunks = n_copy * COPY_CHUNKS_PER_BLOCK;
  const size_t per = (nvec + n_chunks - 1) / n_chunks;
  for (int c = cta; c < n_chunks; c += n_copy) {
    const size_t lo = (size_t)c * per;
    const size_t hi = lo + per < nvec ? lo + per : nvec;
    for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) d[i] = s[i];
  }
}

// Bulk copies of K6 (one thread; 16-byte aligned addresses, sizes a
// multiple of 16): device memory into shared memory, completing on the
// mbarrier `bar`, and shared memory out to device memory in this thread's
// bulk group.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}
// Order this thread's generic-proxy accesses so far (the gate's acquire)
// before its later async-proxy ones (the bulk stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

}  // namespace hvdt
