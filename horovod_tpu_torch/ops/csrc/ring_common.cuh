// Shared pieces of the ring kernels (ring_flash.cu: K4, K5; ring_permute.cu:
// K6, K7): the ready handshake on flag words, the copy gate, and the
// chunked shard copy into a neighbour's receive slot.
//
// The members of a ring live on one card, each with its own stream (see
// horovod_tpu_torch/parallel/mesh.py).  A member copies its shard into a
// buffer that its destination member reads, so, as in the reference
// (horovod_tpu/ops/rdma.py, `_permute_kernel`), it writes only after a
// ready handshake: it signals its SOURCE ("you may write into my slot") and
// waits for the signal of its DESTINATION.  A destination that has entered
// its kernel has finished, in its stream's order, every earlier kernel that
// read the slot.
//
// Flag words are int32 counters in device memory, one per member and
// namespace: (n, N_NS).  Signal = atomicAdd +1 on the source's word; wait =
// spin until the own word is >= 1, then atomicSub 1 (the reference's
// `semaphore_wait(bar, 1)`), so after a balanced pass every word is back at
// 0.  Consecutive invocations of one chain alternate between two
// namespaces, so a stale signal cannot satisfy a wait.
//
// Every spin is bounded: past SPIN_TIMEOUT_NS, or as soon as another spin
// has failed, the block writes the error word and returns without copying.
// The Python side reads the word (RingMesh.check) and raises.

#pragma once

#include "flash_common.cuh"

namespace hvdt {

constexpr int N_NS = 6;  // namespaces: rdma K 0/1, rdma V 2/3, fused 4/5
constexpr int MAX_MEMBERS = 8;
constexpr int COPY_CHUNKS_PER_BLOCK = 4;
constexpr unsigned long long SPIN_TIMEOUT_NS = 10ull * 1000 * 1000 * 1000;
enum RingError { kHandshakeTimeout = 1, kGateTimeout = 2 };

// One member's view of the ring for one launch.
struct Ring {
  int* flags;  // (n, N_NS) ready counters
  int* go;     // (n, N_NS) go words of the copy gate
  int* err;    // the mesh's error word
  int my, n, ns, epoch;
};

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// Bounded wait for `*word` to satisfy `ok(value)`.  Returns false (and sets
// the error word to `code` on a timeout) when it gives up.
template <typename Pred>
__device__ bool bounded_spin(const int* word, const Ring& r, int code,
                             Pred ok) {
  const unsigned long long t0 = globaltimer_ns();
  while (!ok(ld_volatile(word))) {
    if (ld_volatile(r.err) != 0) return false;
    if (globaltimer_ns() - t0 > SPIN_TIMEOUT_NS) {
      atomicCAS(r.err, 0, code);
      return false;
    }
    __nanosleep(256);
  }
  return true;
}

// The ready handshake of member r.my for a copy by `shift` (one thread).
__device__ bool handshake(const Ring& r, int shift) {
  const int src = ((r.my - shift) % r.n + r.n) % r.n;
  __threadfence();
  atomicAdd(r.flags + src * N_NS + r.ns, 1);
  int* mine = r.flags + r.my * N_NS + r.ns;
  if (!bounded_spin(mine, r, kHandshakeTimeout,
                    [](int v) { return v >= 1; }))
    return false;
  atomicSub(mine, 1);
  __threadfence();
  return true;
}

// Gate of the copy blocks of one launch: copy block 0 runs the handshake
// and publishes the launch's epoch in the member's go word; the other copy
// blocks wait for that word.  Returns whether this block may copy.
__device__ bool copy_gate(const Ring& r, int shift, int cta) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    int* go = r.go + r.my * N_NS + r.ns;
    bool good;
    if (cta == 0) {
      good = handshake(r, shift);
      if (good) {
        __threadfence();
        atomicExch(go, r.epoch);
      }
    } else {
      const int epoch = r.epoch;
      good = bounded_spin(go, r, kGateTimeout,
                          [epoch](int v) { return v == epoch; });
      __threadfence();
    }
    ok = good;
  }
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

}  // namespace hvdt
