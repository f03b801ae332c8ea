// TCP transport for the collective engine: control plane (rank-0 coordinator
// star) and data plane (ring).  TPU-native replacement for the reference's
// use of MPI as both planes (Horovod's horovod/common/operations.cc:
// 1541-1678 control, :1144/:828/:1211 data) -- on TPU pods the cross-host
// fabric is plain IP (DCN), so the engine speaks TCP directly and needs no
// MPI launcher.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

struct iovec;  // <sys/uio.h>; kept out of this header on purpose

namespace hvdtpu {

// Parse "host:port".  Returns false on malformed input.
bool ParseEndpoint(const std::string& ep, std::string* host, int* port);

// Create a listening socket bound to host:port.  Returns fd or -1.
int Listen(const std::string& host, int port, std::string* err);

// Accept one connection (blocking, with timeout_sec).  Returns fd or -1.
int AcceptOne(int listen_fd, double timeout_sec, std::string* err);

// Connect to host:port, retrying until timeout_sec elapses (peers may not be
// up yet -- the analogue of MPI_Init's implicit rendezvous).  fd or -1.
int ConnectRetry(const std::string& host, int port, double timeout_sec,
                 std::string* err);

// Blocking full-buffer send/recv.  Return false on error/EOF.
bool SendAll(int fd, const void* buf, size_t len);
bool RecvAll(int fd, void* buf, size_t len);

// Scatter-gather blocking send: the iovec array goes out in one
// sendmsg(2) per kernel acceptance (header + payload straight from
// their source buffers, no stage copy), with the same fault hooks and
// timed-send telemetry as SendAll.  The iovecs are copied internally;
// the caller's array is never mutated.
bool SendVec(int fd, const struct iovec* iov, int iovcnt);

// Wait until fd is readable (or in error/EOF, which a subsequent recv will
// surface).  False on timeout — the liveness probe for the coordinator's
// per-rank tick recv: a healthy engine thread sends a frame every cycle
// (~5ms), so a deadline's worth of silence means the peer PROCESS is
// frozen or the network is partitioned, which socket EOF never reports.
bool WaitReadable(int fd, double timeout_sec);

// Non-blocking liveness probe: true when the peer has closed (EOF) or the
// socket is in error — i.e. sending to it can no longer succeed.  Pending
// unread data does NOT count as closed.
bool PeerClosed(int fd);

// Length-prefixed message framing ([u32 little-endian length][payload]).
bool SendFrame(int fd, const std::vector<uint8_t>& payload);
bool RecvFrame(int fd, std::vector<uint8_t>* payload);

// Append whatever bytes fd has ready RIGHT NOW to *buf without ever
// blocking (MSG_DONTWAIT), so a caller can assemble a message across
// ticks from a peer that trickles it.  False on error or EOF; true
// otherwise, including when zero new bytes were available.
bool RecvAvailable(int fd, std::vector<uint8_t>* buf);

// Full-duplex exchange: send `slen` bytes on send_fd while receiving `rlen`
// bytes from recv_fd, multiplexed with poll(2) so neighbouring ranks can
// stream large ring segments to each other without deadlocking on full
// kernel socket buffers.
bool Exchange(int send_fd, const void* sbuf, size_t slen,
              int recv_fd, void* rbuf, size_t rlen);

// Bidirectional neighbour exchange: stream A is sent rightward on
// right_fd while stream A' arrives on left_fd (recv_l); stream B is sent
// leftward on left_fd while B' arrives on right_fd (recv_r).  All four
// legs run in one poll loop, saturating both directions of both links.
bool ExchangeBi(int right_fd, const void* send_r, size_t send_r_len,
                void* recv_r, size_t recv_r_len, int left_fd,
                const void* send_l, size_t send_l_len, void* recv_l,
                size_t recv_l_len);

void CloseFd(int fd);

// ---------------------------------------------------------------------------
// Deterministic link-fault injection (HVD_TPU_NET_FAULT_SPEC, the chaos
// harness of docs/fault-tolerance.md#failure-detection).  Semicolon-
// separated clauses, each optionally suffixed `@after=S` (seconds after
// NetFaultInit before the clause activates — stage faults past init
// rendezvous):
//   link=A-B:drop            blackhole the A<->B link (both endpoints
//                            swallow their outbound bytes; receivers see
//                            silence, never EOF — the partition shape
//                            only the heartbeat detector can see)
//   link=A-B:delay=MS        synchronous per-send delay on the link
//   link=A-B:delay=MS|jitter=MS   + deterministic per-send jitter
//   link=A-B:flaky=P         probability P per send of a chopped,
//                            throttled partial write (absorbed by the
//                            retry loops: degradation, not failure)
//   partition=0,1/2,3        drop on EVERY link crossing the two groups
// Every rank parses the same spec and applies the clauses whose link
// touches it, so a dropped link is dark in BOTH directions without any
// cross-rank coordination.  Faults key off the fd -> peer-rank registry
// below; unregistered fds always pass through untouched.
//
// Parse + arm the table (idempotent per Init; empty spec disarms).
// Returns false with *err set on a malformed spec.
bool NetFaultInit(const std::string& spec, int my_rank, std::string* err);
// Whether any clause is armed (cheap; callers may skip lookups).
bool NetFaultActive();
// Associate fd with the CURRENT-membership rank at the far end.
void NetFaultRegister(int fd, int peer_rank);
void NetFaultForget(int fd);
// True when outbound bytes on fd must be swallowed right now (drop /
// partition clause active for its link).
bool NetFaultDrops(int fd);
// Apply pre-send latency (delay/jitter clause) for fd; no-op otherwise.
void NetFaultDelay(int fd);
// Flaky-link verdict for one send on fd: returns a byte cap (> 0) for a
// deliberately chopped write plus a tiny stall, or 0 for an untouched
// send.  Deterministic per (spec, rank, link, send index).
size_t NetFaultChop(int fd);

// Shm-seam interrogation (Engine::SetupShmTransport): the strongest
// clause naming the rank_a<->rank_b link, independent of @after arming
// (a clause that would arm later still decides transport choice at
// init).  Returns 0 = no clause, 1 = delay/jitter only (appliable at
// the shm seam), 2 = drop/flaky/partition (shm cannot express it — the
// caller must fall back to TCP or fail init with a typed error).  *text
// gets the deciding clause's source text for those messages.
int NetFaultQueryLink(int rank_a, int rank_b, std::string* text);

// Apply a delay/jitter clause keyed by PEER RANK rather than fd — the
// shm transport's per-handoff hook (rings have no fd).  Deterministic
// jitter stream per (spec, link), independent of the fd-keyed stream.
void NetFaultDelayPeer(int peer_rank);

// shutdown(2) both directions WITHOUT closing: any thread blocked in
// poll/send/recv on the fd wakes with an error immediately, and the fd
// number stays allocated — no close-vs-concurrent-use reuse race.  The
// owner still calls CloseFd afterwards (after joining helpers).
void ShutdownFd(int fd);

// ---------------------------------------------------------------------------
// Per-peer link telemetry (docs/metrics.md#links): byte / send / stall
// counters and a fixed-bucket send-latency histogram per PEER RANK,
// aggregated across every registered fd to that peer (control star, ring,
// beat lane).  Accounting rides the same fd -> peer registry the fault
// layer keys off — NetFaultRegister is the single registration point —
// and costs one mutex hold per SendAll/RecvAll/Exchange call (never per
// byte), so the chaos layer's injected delays land INSIDE the measured
// send latency: a `link=A-B:delay=MS` clause is directly observable as a
// latency excursion on exactly that link.  Counters are process-
// cumulative (the engine.h StallEvents contract: they survive re-init).
// HVD_TPU_LINK_STATS=0 disarms everything but the relaxed-atomic gate.

// Arm/disarm the accounting (called from Engine::Init with the parsed
// HVD_TPU_LINK_STATS gate; stats persist across re-inits).
void NetLinkInit(bool enabled);
bool NetLinkEnabled();

// Serialized per-peer snapshot for the c_api:
//   "enabled|peer:bytes_out:bytes_in:sends:recvs:stalls:short_writes:
//    send_us_sum:send_us_count:b0,b1,...,b9:rtt_last_us:rtt_ewma_us:
//    rtt_samples:shm_bytes_out:shm_bytes_in:shm_handoffs:shm_us_sum:
//    shm_us_count:s0,...,s9:transport;peer:..." (peers sorted; empty
// list when nothing flowed).  `transport` labels what carries this
// peer's data-plane bytes: "shm" once any ring handoff flowed (the
// remaining TCP bytes are rendezvous/heartbeat control), else "tcp".
std::string NetLinkInfo();

// Fold one shm-ring handoff into peer's stats: bytes in each direction
// plus — when handoff_us >= 0 — one segment-handoff latency histogram
// sample (time for a send leg to fully enter the peer's ring,
// including injected chaos delay, mirroring the SendAll clock).
void NetLinkRecordShm(int peer_rank, long long bytes_out, long long bytes_in,
                      long long handoff_us);

// Histogram bucket upper bounds (µs); the last bucket is +inf.  Exposed
// so the Python registry renders `le` labels that match the C++ counts.
extern const long long kNetLinkBucketUs[];
extern const int kNetLinkBuckets;

// Fold one heartbeat-echo round-trip sample into peer's RTT estimate
// (last + EWMA).  Called from the heartbeat monitor thread.
void NetLinkRecordRtt(int peer_rank, long long rtt_us);

// Cumulative timed-send count across all peers (simscale report surface:
// proves which regime an overhead-bench cell actually ran in).
long long NetLinkSendsTotal();

// Detector-side accessor (anomaly monitor): per-peer cumulative send-
// latency totals, cheap enough to poll every sweep.
struct NetLinkLatencyTotal {
  int peer;
  long long sum_us;
  long long count;
  long long rtt_last_us;
};
std::vector<NetLinkLatencyTotal> NetLinkLatencyTotals();

}  // namespace hvdtpu
