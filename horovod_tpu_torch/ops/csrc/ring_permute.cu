// K6 (ring_permute) and K7 (phase_closer): the ring's rotation and its
// barrier-only closer, for Hopper (sm_90a).
//
// K6 replaces the Pallas TPU kernel `_permute_kernel`
// (horovod_tpu/ops/rdma.py): after the ready handshake (signal the
// source, wait for the destination; ring_common.cuh), member `my` copies
// its shard, bit for bit, into the receive slot of member
// (my + shift) mod n.  The receive slots of one call are the output
// tensors the wrapper allocates for every member, passed as a table; the
// kernel picks its destination from it.
//
// K7 replaces `_phase_closer_kernel` (horovod_tpu/ops/ring_flash.py): the
// handshake alone (shift 1, the fused ring's namespace on phase 1), and an
// (8, 128) f32 zero block.  It closes a fused pass whose number of
// rotating steps is odd, so every pass's namespace stream starts on phase
// 0 and ends on phase 1 and reruns alternate.
//
// Bound on the card: K6 moves the shard once (read + write); at the ring
// path's shape (bh 32, shard 1024, head_dim 64, bf16: 4.2 MB) that is
// 2.5 us of HBM time per member, 10.0 us for the four members' launches
// together.  K7 writes 4 KB; its time is the handshake's.
//
// Design of K6.  The members' launches run together, so each takes its
// share of the SMs (the wrapper passes blocks = SMs / n: 33 of the H100's
// 132 for a ring of 4), one warp per block, of which one thread issues
// every copy.  Block b owns a contiguous 1/blocks of the shard, in 16-byte
// units (any shard whose bytes are a multiple of 16).  The shard is the
// member's own, so the block reads it before the gate: bulk asynchronous
// copies (cp.async.bulk, TMA's one-dimensional form) bring its first two
// rounds of K6_HALF bytes into shared memory on two mbarriers while block
// 0 runs the handshake.  Once the gate opens, each round goes out to the
// destination's slot by a bulk store, and a half whose store has read it
// takes the round after next, so a share above 2 K6_HALF (a shard above
// 8.6 MB at 33 blocks) streams through both halves.  No thread touches a
// byte of the shard.  The gate is ring_common.cuh's: block 0 runs the
// handshake and publishes the go word with a release store, the other
// blocks with bytes to store poll it with acquire loads.
//
// Design of K7.  The zero block is the closer's own output, not a
// neighbour's slot, so its 256 threads store it first, one 16-byte vector
// each, and thread 0 then runs the handshake.

#include "ring_common.cuh"

namespace hvdt {

struct SlotTable {
  void* p[MAX_MEMBERS];
};

constexpr int K6_THREADS = 32;
constexpr uint32_t K6_HALF = 64 * 1024;   // bytes of one round
constexpr uint32_t K6_PIECE = 16 * 1024;  // bytes of one bulk copy
constexpr int K7_THREADS = 8 * 128 / 4;   // one float4 of the block each

__global__ void __launch_bounds__(K6_THREADS)
    permute_kernel(const unsigned char* __restrict__ src, SlotTable dst,
                   size_t bytes, int shift, Ring ring) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bars[2];
  if (threadIdx.x != 0) return;
  // This block's share: 16-byte units [lo16, hi16) of the shard.
  const size_t n16 = bytes / 16;
  const size_t per = (n16 + gridDim.x - 1) / gridDim.x;
  const size_t lo16 = blockIdx.x * per < n16 ? blockIdx.x * per : n16;
  const size_t hi16 = lo16 + per < n16 ? lo16 + per : n16;
  const size_t lo = lo16 * 16, len = (hi16 - lo16) * 16;
  const int rounds = (int)((len + K6_HALF - 1) / K6_HALF);
  const uint32_t smem = sm90::smem_u32(buf), bar = sm90::smem_u32(bars);
  sm90::mbar_init(bar, 1);
  sm90::mbar_init(bar + 8, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  // Round r: bytes [r K6_HALF, ...) of the share, through half r % 2.
  auto round_bytes = [&](int r) {
    const size_t left = len - (size_t)r * K6_HALF;
    return (uint32_t)(left < K6_HALF ? left : K6_HALF);
  };
  auto load = [&](int r) {
    const uint32_t n = round_bytes(r), half = bar + 8 * (r % 2);
    sm90::mbar_expect_tx(half, n);
    for (uint32_t p = 0; p < n; p += K6_PIECE)
      bulk_load(smem + (r % 2) * K6_HALF + p,
                src + lo + (size_t)r * K6_HALF + p,
                n - p < K6_PIECE ? n - p : K6_PIECE, half);
  };
  // The reads fly while block 0 runs the handshake.
  for (int r = 0; r < rounds && r < 2; ++r) load(r);
  const bool open = gate(ring, shift, rounds > 0);
  if (!open) {
    // A spin gave up (the error word is set): store nothing, but let the
    // reads land before the block's shared memory goes away.
    for (int r = 0; r < rounds && r < 2; ++r) sm90::mbar_wait(bar + 8 * r, 0);
    return;
  }
  const int to = ((ring.my + shift) % ring.n + ring.n) % ring.n;
  unsigned char* out = static_cast<unsigned char*>(dst.p[to]) + lo;
  fence_proxy_async();
  for (int r = 0; r < rounds; ++r) {
    sm90::mbar_wait(bar + 8 * (r % 2), (r / 2) & 1);
    const uint32_t n = round_bytes(r);
    for (uint32_t p = 0; p < n; p += K6_PIECE)
      bulk_store(out + (size_t)r * K6_HALF + p,
                 smem + (r % 2) * K6_HALF + p,
                 n - p < K6_PIECE ? n - p : K6_PIECE);
    sm90::bulk_commit();
    if (r + 2 < rounds) {
      sm90::bulk_wait_all<true>();  // this half's store has read it
      load(r + 2);
    }
  }
  sm90::bulk_wait_all<false>();
}

__global__ void __launch_bounds__(K7_THREADS)
    phase_closer_kernel(float* __restrict__ out, Ring ring) {
  reinterpret_cast<float4*>(out)[threadIdx.x] = make_float4(0.f, 0.f, 0.f,
                                                            0.f);
  if (threadIdx.x == 0) handshake(ring, 1);
}

// Shared memory of a K6 launch whose blocks each own `share` bytes: one
// round, or both halves.
inline uint32_t k6_smem(size_t share) {
  return share > K6_HALF ? 2 * K6_HALF : (uint32_t)(share < 16 ? 16 : share);
}

// Set K6's shared-memory limit once (internal linkage: a mutant build
// loaded beside this one keeps its own flag).
namespace {
bool g_k6_ready = false;
}  // namespace

int prepare_k6() {
  if (g_k6_ready) return 0;
  const int e = (int)cudaFuncSetAttribute(
      permute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * K6_HALF));
  g_k6_ready = e == 0;
  return e;
}

}  // namespace hvdt

extern "C" int hvdt_ring_permute(const void* src, void* const* dst_table,
                                 size_t bytes, int blocks, int shift,
                                 int* flags, int* go, int* err, int my, int n,
                                 int ns, int epoch, void* stream) {
  using namespace hvdt;
  if (n < 1 || n > MAX_MEMBERS || blocks < 1 || bytes % 16 != 0) return -1;
  const int prep = prepare_k6();
  if (prep != 0) return prep;
  SlotTable table{};
  for (int i = 0; i < n; ++i) table.p[i] = dst_table[i];
  const Ring ring{flags, go, err, my, n, ns, epoch};
  const size_t share = (bytes / 16 + blocks - 1) / blocks * 16;
  permute_kernel<<<blocks, K6_THREADS, k6_smem(share),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), table, bytes, shift, ring);
  return (int)cudaGetLastError();
}

extern "C" int hvdt_phase_closer(float* out, int* flags, int* err, int my,
                                 int n, int ns, void* stream) {
  using namespace hvdt;
  const Ring ring{flags, nullptr, err, my, n, ns, 0};
  phase_closer_kernel<<<1, K7_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(out, ring);
  return (int)cudaGetLastError();
}

// Load both kernels, and set K6's shared-memory limit, before any ring
// launch (see ring_flash.cu's prepare_ring: a lazy load may wait for the
// card to go idle).
extern "C" int hvdt_ring_permute_prepare() {
  using namespace hvdt;
  cudaFuncAttributes attr;
  int e = prepare_k6();
  e |= (int)cudaFuncGetAttributes(&attr, permute_kernel);
  e |= (int)cudaFuncGetAttributes(&attr, phase_closer_kernel);
  return e;
}
