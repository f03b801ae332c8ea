// Pluggable data-plane transport seam (docs/performance.md#transport).
//
// Every ring hop in the engine moves bytes through a Channel: a TCP
// socket plus, when the shared-memory transport is armed, a pair of
// SPSC byte rings inside one mmap'd per-node segment.  The TCP fd is
// ALWAYS dialed and kept — it carries the rendezvous token relay, the
// heartbeat wake registry, and PeerClosed probes, and it is the
// fallback when shm cannot arm — so the socket path is simply the
// Channel with no rings attached.  ChannelExchange/ChannelExchangeBi/
// ChannelSendAll/ChannelRecvAll delegate to net.h when no ring is
// present; with rings they hand off fused-bucket bytes by offset with
// no serialization and no syscall per segment, polling with a
// spin-then-yield loop paced off the engine tick (no futex: the reader
// and writer are pinned engine threads that poll every few µs anyway).
//
// Segment lifecycle (crash-proof /dev/shm hygiene): local-rank 0
// unlinks any stale name, creates the segment O_CREAT|O_EXCL, then
// relays an attach token around the node-local ring over the already-
// connected TCP sockets; when the token returns, every local rank has
// the segment mapped and the creator unlinks it IMMEDIATELY, so no
// later abort, typed death, or SIGKILL can leak a /dev/shm entry — the
// kernel reclaims the memory on the last munmap/exit.  Names embed the
// job tag and membership epoch so elastic reshapes and rejoining
// standbys can never attach a stale generation's segment.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <string>

namespace hvdtpu {

// ---------------------------------------------------------------------------
// HVD_TPU_SHM policy knob: off pins every hop to TCP (kill switch,
// bit-identical data path), auto arms shm for the node-local ring when
// the job shape allows it and demotes to TCP otherwise, force fails
// init with a typed error when shm cannot arm.
// ---------------------------------------------------------------------------

enum class ShmMode { kOff = 0, kAuto = 1, kForce = 2 };

// nullptr/""/"auto" -> kAuto; "0"/"off" -> kOff; "1"/"force" -> kForce.
// Unrecognized values -> kAuto (the safe default; lint keeps the doc row
// canonical).
ShmMode ParseShmMode(const char* value);
const char* ShmModeName(ShmMode m);

// ---------------------------------------------------------------------------
// SPSC byte ring living inside the shared segment.  One writer (the
// source local rank) and one reader; head/tail are monotonically
// increasing byte cursors so empty == (head == tail) with no wasted
// slot.  `closed` is the abort wake: either side (or the heartbeat
// monitor) sets it and every blocked drive loop returns false within
// one poll iteration — the shm analogue of ShutdownFd.
// ---------------------------------------------------------------------------

struct ShmRing {
  alignas(64) std::atomic<uint64_t> head;    // bytes produced (writer-owned)
  alignas(64) std::atomic<uint64_t> tail;    // bytes consumed (reader-owned)
  alignas(64) std::atomic<uint32_t> closed;  // abort flag (either side)
  uint32_t capacity;                         // payload bytes (power of two)

  char* Data() { return reinterpret_cast<char*>(this) + sizeof(ShmRing); }
  // Copy up to len bytes in/out without blocking; returns bytes moved
  // (0 when the ring is full/empty).  Release/acquire pairing on the
  // cursors orders the payload copies across processes.
  size_t WriteSome(const void* buf, size_t len);
  size_t ReadSome(void* buf, size_t len);
};

static_assert(sizeof(ShmRing) == 192, "ring header layout is part of the ABI");

// ---------------------------------------------------------------------------
// Per-node segment: header + 2*local_size rings.  Ring (r, dir) is
// written by local rank r: dir 0 flows rightward (read by (r+1) % L as
// its leftward-receive), dir 1 flows leftward (read by (r-1+L) % L).
// ---------------------------------------------------------------------------

// "/hvdtpu_<fnv32(job_tag)>_n<node>_e<epoch>" — job_tag folds in the
// coordinator endpoint (unique per job on a host) and the launcher's
// restart epoch; the membership epoch suffix keeps elastic generations
// apart even if a segment were ever observable across them.
std::string ShmSegmentName(const std::string& job_tag, int node_id,
                           long long epoch);

class ShmSegment {
 public:
  ShmSegment() = default;
  ~ShmSegment() { Unmap(); }
  ShmSegment(const ShmSegment&) = delete;
  ShmSegment& operator=(const ShmSegment&) = delete;

  // Creator side (local rank 0): unlink any stale name, then
  // O_CREAT|O_EXCL + ftruncate + mmap + initialize every ring header.
  bool Create(const std::string& name, int local_size, size_t ring_bytes,
              std::string* err);
  // Worker side: shm_open an existing name and validate its header
  // against this job's shape (magic/version/local_size/ring_bytes).
  bool Attach(const std::string& name, int local_size, size_t ring_bytes,
              std::string* err);
  // Remove the name from /dev/shm (creator calls this the moment the
  // attach token round-trips; teardown calls it again defensively for
  // the create-to-attach window).  Idempotent; safe on non-creators.
  void Unlink();
  // Abort wake: set closed on every ring so any drive loop blocked on a
  // full/empty ring returns within one poll iteration.
  void CloseRings();
  void Unmap();

  bool mapped() const { return base_ != nullptr; }
  bool creator() const { return creator_; }
  const std::string& name() const { return name_; }
  size_t ring_bytes() const { return ring_bytes_; }
  ShmRing* Ring(int src_local_rank, int dir);

 private:
  void* base_ = nullptr;
  size_t bytes_ = 0;
  std::string name_;
  bool creator_ = false;
  bool unlinked_ = false;
  int local_size_ = 0;
  size_t ring_bytes_ = 0;
};

// ---------------------------------------------------------------------------
// Channel: the seam.  fd is always valid once the topology is wired;
// tx/rx point into the node segment only when the shm transport armed
// for this hop.  peer is the global rank at the far end (telemetry and
// chaos-clause key).
// ---------------------------------------------------------------------------

struct Channel {
  int fd = -1;
  ShmRing* tx = nullptr;  // ring this rank writes toward peer
  ShmRing* rx = nullptr;  // ring peer writes toward this rank
  int peer = -1;
  bool shm() const { return tx != nullptr && rx != nullptr; }
};

// Blocking full-buffer ops over a channel; TCP channels delegate to
// SendAll/RecvAll/Exchange/ExchangeBi, shm channels drive the rings
// (and mixed legs drive both nonblockingly in one loop).  All return
// false on peer death, a closed ring, or 30s of zero progress — the
// same contract as the net.h calls they stand in for.  Chaos delay/
// jitter clauses naming the link apply per handoff on the shm path
// (NetFaultDelayPeer); drop/flaky clauses never reach here — init
// refuses to arm shm under them (see Engine::SetupShmTransport).
bool ChannelSendAll(const Channel& ch, const void* buf, size_t len);
bool ChannelRecvAll(const Channel& ch, void* buf, size_t len);
bool ChannelExchange(const Channel& send_ch, const void* sbuf, size_t slen,
                     const Channel& recv_ch, void* rbuf, size_t rlen);
bool ChannelExchangeBi(const Channel& right, const void* send_r,
                       size_t send_r_len, void* recv_r, size_t recv_r_len,
                       const Channel& left, const void* send_l,
                       size_t send_l_len, void* recv_l, size_t recv_l_len);

}  // namespace hvdtpu
