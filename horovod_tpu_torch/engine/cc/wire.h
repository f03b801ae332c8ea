// Compact binary wire format for the coordinator protocol.  Plays the role of
// the reference's FlatBuffers MPIRequest/MPIResponse schema
// (Horovod's horovod/common/wire/mpi_message.fbs:36-100,
//  Horovod's horovod/common/mpi_message.{h,cc}) but hand-rolled:
// little-endian scalars + length-prefixed strings, no external codegen.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvdtpu {

// Dtype codes -- shared with Python (horovod_tpu/common/dtypes.py).
enum DataType : uint8_t {
  HVD_UINT8 = 0,
  HVD_INT8 = 1,
  HVD_INT32 = 2,
  HVD_INT64 = 3,
  HVD_FLOAT16 = 4,
  HVD_FLOAT32 = 5,
  HVD_FLOAT64 = 6,
  HVD_BFLOAT16 = 7,
  HVD_BOOL = 8,
  HVD_UINT16 = 9,
};

enum OpType : uint8_t {
  OP_ALLREDUCE = 0,
  OP_ALLGATHER = 1,
  OP_BROADCAST = 2,
  // Negotiation-only: agree on order + stamp completion, move no data.
  // The XLA plane's metadata-cache fast path (jax/eager_mesh.py) submits
  // these instead of repeating the "__xp.*" metadata allreduce once every
  // rank holds the cached agreement (docs/performance.md).
  OP_NOOP = 3,
  // Point-to-point plane (docs/pipeline.md): a send/recv pair announces
  // the SAME tensor name from exactly two ranks, each naming the other in
  // Request.p2p_peer; the coordinator matches them into one RESP_SENDRECV
  // — the readiness contract collectives enforce across the world,
  // narrowed to a pair.
  OP_SEND = 4,
  OP_RECV = 5,
};

// Status codes -- shared with Python.
enum StatusCode : int32_t {
  ST_OK = 0,
  ST_UNKNOWN = 1,
  ST_PRECONDITION = 2,
  ST_ABORTED = 3,
  ST_INVALID = 4,
  ST_PENDING = 5,
  // Coordinated-abort statuses (fault tolerance, docs/fault-tolerance.md):
  // a peer rank died (control-socket EOF) or a collective stalled past
  // HVD_TPU_COLLECTIVE_TIMEOUT_SEC.  Both carry a message naming the
  // missing ranks / stalled tensors; Python maps them to
  // RanksDownError / CollectiveTimeoutError.
  ST_RANKS_DOWN = 6,
  ST_TIMEOUT = 7,
  // Elastic membership (docs/fault-tolerance.md#elastic-membership): the
  // job reshaped (a rank died and the survivors continued, or a standby
  // joined) and the collective carrying this status was cancelled at the
  // reshape barrier.  RETRYABLE: Python maps it to MembershipChangedError;
  // hvd.run_elastic re-enters agreement and resyncs state by root
  // broadcast instead of killing the job.
  ST_RESHAPE = 8,
};

// Wire-compression modes (docs/performance.md#wire-compression): what an
// fp32 allreduce bucket's payload is narrowed to on the wire.  Negotiated
// per bucket by the rank-0 coordinator (a `compression` field on the
// Response) from the job-wide HVD_TPU_COMPRESSION agreement, so every
// rank compresses/decompresses the same buckets the same way.  Shared
// with Python (horovod_tpu/common/config.py).
enum CompressionMode : uint8_t {
  COMP_NONE = 0,
  COMP_BF16 = 1,      // fp32 -> bfloat16 on the wire (2x fewer bytes)
  COMP_FP8 = 2,       // fp32 -> fp8-e4m3fn, saturating (4x fewer bytes)
};

size_t DataTypeSize(uint8_t dtype);
const char* DataTypeName(uint8_t dtype);
const char* OpName(uint8_t op);
const char* CompressionName(uint8_t mode);

// One rank's readiness announcement for one named tensor.
struct Request {
  int32_t rank = 0;
  uint8_t op = OP_ALLREDUCE;
  uint8_t dtype = HVD_FLOAT32;
  int32_t root_rank = -1;  // broadcast only
  std::string name;
  std::vector<int64_t> dims;
  // Point-to-point plane (OP_SEND/OP_RECV only): the counterpart rank this
  // announcement must pair with, and the sender/receiver-agreed channel
  // tag disambiguating concurrent transfers between the same pair.  -1 /
  // 0 on collectives.
  int32_t p2p_peer = -1;
  int32_t p2p_tag = 0;
  // Stage-group scoping (docs/pipeline.md#stage-groups): the sorted dense
  // ranks this collective is restricted to (the DP dimension within a
  // pipeline stage).  Empty = whole world (every pre-existing op).
  // Carried per-request rather than as persistent engine state so a
  // reshape barrier — which clears caches and renumbers ranks — can never
  // leave a stale membership armed anywhere.
  std::vector<int32_t> stage_ranks;
};

// One cache slot's announcements folded across a node by its
// sub-coordinator (docs/performance.md#control-plane-scaling): the ranks
// that announced the slot this tick, each with its announce timestamp
// (µs, mapped onto rank 0's clock by the sub-coordinator's clock
// offset) so rank 0's last-to-announce straggler verdicts still name the
// true rank behind the aggregation, not the sub-coordinator.
struct BitGroup {
  uint32_t slot = 0;
  std::vector<int32_t> ranks;
  std::vector<int64_t> announce_us;  // parallel to ranks
};

struct RequestList {
  bool shutdown = false;
  std::vector<Request> requests;
  // Response-cache announcements (docs/performance.md): slot indices of
  // already-negotiated collectives this rank re-submitted unchanged.  A
  // few bytes per op instead of a string-named Request — the steady-state
  // fast path.  Caches mutate in broadcast response-list order on every
  // rank, so a slot index names the same collective everywhere.
  std::vector<uint32_t> cache_bits;
  // --- Coordinator-tree aggregate extensions (docs/performance.md
  // #control-plane-scaling).  A sub-coordinator (each host's
  // local-rank-0) folds its node's per-rank frames into ONE aggregate
  // frame per tick; rank 0 therefore holds O(hosts) control sockets and
  // processes O(hosts) frames per tick instead of O(ranks).  Leaf frames
  // leave all of these empty.
  // Announce timestamps parallel to `requests` (rank-0 clock µs); empty
  // = stamp on arrival (the direct/star behavior).
  std::vector<int64_t> announce_us;
  // Cache-bit announcements folded per slot across the node.
  std::vector<BitGroup> bit_groups;
  // Ranks whose frame this aggregate folds in (liveness accounting: rank
  // 0's last-frame-tick postmortem bookkeeping stays per TRUE rank).
  std::vector<int32_t> frames_from;
  // Worker deaths observed at the sub-coordinator (control-socket EOF):
  // forwarded so rank 0's coordinated abort names the true dead rank.
  std::vector<int32_t> dead_ranks;
  // Ranks of this node that left the decentralized steady state this
  // frame (miss fallback) — rank 0 resumes broadcasting only once every
  // rank has exited.
  std::vector<int32_t> steady_exits;
  // THIS sender left steady state with this frame (leaf form of
  // steady_exits); epoch/pos locate the miss for postmortem dumps.
  uint8_t steady_exit = 0;
  int64_t steady_epoch = 0;
  int64_t steady_pos = 0;
  // Elastic membership epoch this frame was built against
  // (docs/fault-tolerance.md#elastic-membership).  A mid-steady reshape
  // revocation breaks the strict send-one-wait-one alternation, so a
  // fallback frame built before the barrier can arrive after it; the
  // coordinator drops any frame whose epoch is older than its own
  // (cache bits would name cleared slots, announces would double-count
  // into the new membership's table).  Static jobs stay at 0 == 0.
  int64_t membership_epoch = 0;
  // Out-of-band heartbeat report (docs/fault-tolerance.md
  // #failure-detection): this frame exists ONLY to deliver `dead_ranks`
  // observed by the data-plane heartbeat detector and carries no
  // announcements.  It rides the control socket BETWEEN regular tick
  // frames, so the coordinator (and every sub-coordinator relay)
  // processes it and keeps waiting for the sender's real frame — the
  // send-one-wait-one alternation is preserved.
  bool hb_report = false;
};

enum ResponseType : uint8_t {
  RESP_ALLREDUCE = 0,
  RESP_ALLGATHER = 1,
  RESP_BROADCAST = 2,
  RESP_ERROR = 3,
  RESP_NOOP = 4,  // negotiation-only (OP_NOOP): stamp completion, no data
  // Matched send/recv pair (docs/pipeline.md): broadcast to EVERY rank so
  // response caches mutate in lockstep, executed only by the two ranks
  // named in p2p_src/p2p_dst.
  RESP_SENDRECV = 5,
};

// Coordinator verdict: either an (optionally fused) operation every rank must
// now execute in lockstep, or a typed error for one tensor.
struct Response {
  uint8_t type = RESP_ALLREDUCE;
  std::vector<std::string> names;  // >1 => fused allreduce
  std::string error_message;
  // Allgather only: dim-0 size contributed by each rank, indexed by rank.
  std::vector<int64_t> rank_dim0;
  // Allreduce only: the wire-compression verdict for this bucket
  // (CompressionMode), chosen by the rank-0 coordinator per bucket-size
  // class (bucket payload bytes >= HVD_TPU_COMPRESSION_MIN_BYTES) and
  // broadcast so every rank packs/unpacks the same wire format.  Cache
  // replays recompute it locally from the same lockstep-mutated state
  // (engine.cc ProcessCacheHits), so fresh and replayed buckets agree.
  uint8_t compression = COMP_NONE;
  // Point-to-point plane (RESP_SENDRECV only): the matched pair and tag.
  // Compression (above) applies to the inter-stage hop exactly as to an
  // allreduce bucket: the coordinator stamps the verdict, the sender
  // narrows, the receiver widens.
  int32_t p2p_src = -1;
  int32_t p2p_dst = -1;
  int32_t p2p_tag = 0;
  // Slot metadata for partial-participation ops (RESP_SENDRECV and
  // stage-scoped RESP_ALLREDUCE): dtype + dims of the negotiated tensor,
  // so ranks OUTSIDE the pair/group — which hold no table entry — can
  // still Put an identical response-cache slot at the same index
  // (docs/performance.md's lockstep-mutation contract; without this the
  // bit protocol would desynchronize on the first p2p op).
  uint8_t p2p_dtype = 0;
  std::vector<int64_t> p2p_dims;
  // Stage-group scoping for RESP_ALLREDUCE (empty = whole world); echoes
  // the agreed Request.stage_ranks so replays and non-members see the
  // membership without holding a request.
  std::vector<int32_t> stage_ranks;
};

struct ResponseList {
  bool shutdown = false;
  // Coordinated abort (distinct from a clean shutdown): non-zero when the
  // coordinator detected a dead rank (ST_RANKS_DOWN) or a collective
  // stalled past the hard deadline (ST_TIMEOUT).  Every rank poisons its
  // pending ops with this status + message and exits its loop.
  int32_t abort_code = 0;
  std::string abort_message;
  std::vector<Response> responses;
  // Cache slots every rank announced: replay the stored response for each,
  // in order, before executing `responses` (identical order everywhere).
  std::vector<uint32_t> cache_hits;
  // Online autotuning (docs/performance.md#autotuning): when present, the
  // coordinator's ParameterManager proposed new engine parameters this
  // tick.  Every rank applies them BEFORE replaying this list's cache
  // hits, so fusion-plan changes land at the same tick boundary
  // everywhere — the lockstep-mutation contract the response cache
  // established.  `tuned_frozen` marks the search's final verdict;
  // `tuned_window` is the coordinator's completed-window count.
  bool tuned_present = false;
  bool tuned_frozen = false;
  int64_t tuned_fusion_threshold = 0;
  int64_t tuned_cycle_time_us = 0;
  int64_t tuned_window = 0;
  // Wire-compression mode proposed with the tuned params (the third
  // autotune axis): applied in the same lockstep as fusion/cycle, so the
  // compression decision function mutates at one tick boundary everywhere.
  uint8_t tuned_compression = COMP_NONE;
  // Two-level cross-node algorithm boundary (the fourth autotune axis,
  // HVD_TPU_CROSS_ALGO_THRESHOLD): hierarchical allreduce buckets whose
  // payload is under this many bytes take the latency-bound
  // recursive-doubling (tree) cross-node exchange instead of the
  // bandwidth-optimal ring.  Broadcast with the tuned params so every
  // rank's per-bucket ring-vs-tree decision flips at one tick boundary.
  int64_t tuned_cross_algo_threshold = 0;
  // Elastic membership reshape (docs/fault-tolerance.md): when present,
  // this tick IS the reshape barrier.  The list carries the complete new
  // membership — for each new dense rank its previous rank (-1 for a
  // freshly admitted standby) and its data endpoint — so every receiver
  // derives its own new rank by finding itself (survivors by old rank,
  // joiners by endpoint), plus the engine parameters the new membership
  // must agree on from tick one: the job-wide cache capacity and the
  // currently applied tuned params (caches and the autotune search are
  // reset at the barrier, so these are the fresh baseline everywhere,
  // joiners included).  `reshape_lost` names the ranks (previous-epoch
  // numbering) that died and triggered a shrink; empty on pure grows.
  bool reshape_present = false;
  int64_t membership_epoch = 0;
  int64_t reshape_cache_capacity = 0;
  int64_t reshape_fusion_threshold = 0;
  int64_t reshape_cycle_time_us = 0;
  // Wire-compression re-agreement across the barrier: the new membership
  // (admitted standbys included) adopts the currently applied mode and
  // min-bytes floor, the same way it adopts cache capacity — a joiner's
  // own env must not make it pack buckets differently from survivors.
  uint8_t reshape_compression = COMP_NONE;
  int64_t reshape_compression_min_bytes = 0;
  // The currently applied ring-vs-tree boundary (the fourth autotune
  // axis) crosses the barrier with the other tuned params: a joiner's
  // env must not give it a different cross-algo verdict than survivors,
  // even though reshapes force the flat ring today — the re-agreement
  // keeps hvd_tpu_autotune_cross_algo_threshold identical everywhere.
  int64_t reshape_cross_algo_threshold = 0;
  std::vector<int32_t> member_old_ranks;      // index = new dense rank
  std::vector<std::string> member_endpoints;  // index = new dense rank
  std::vector<int32_t> reshape_lost;
  // Decentralized steady state (docs/performance.md
  // #control-plane-scaling): when present, the coordinator observed the
  // cache-hit slot stream repeat `steady_pattern` identically
  // HVD_TPU_STEADY_THRESHOLD times at quiesced cycle boundaries.  Every
  // rank arms self-clocked replay after processing this list: it replays
  // the pattern's stored responses locally, epoch by epoch, with ZERO
  // control-plane frames per cycle, falling back to full negotiation on
  // any miss.  `steady_groups` carries the observed per-tick grouping of
  // the last cycle (sizes summing to the pattern length) so replayed
  // buckets fuse identically on every rank regardless of local drain
  // timing.
  bool steady_present = false;
  std::vector<uint32_t> steady_pattern;
  std::vector<uint32_t> steady_groups;
  // The first broadcast after a steady window closed (all ranks fell
  // back): informational marker for flight/timeline symmetry — the
  // coordinator's pattern detector restarts at this list.
  bool steady_revoke = false;
};

// Data-plane heartbeat frame (docs/fault-tolerance.md#failure-detection):
// a fixed 16-byte liveness beacon exchanged between ring neighbours over
// dedicated sockets on the data listeners, off the engine tick, so a busy
// local ring never starves liveness.  A whole-process freeze (SIGSTOP, GC
// pause, kernel wedge) stops the beacons without closing the socket —
// the silence socket EOF can never report.  `epoch` pins the membership
// the beacon was sent under; a beacon from a previous epoch is dropped
// like a stale control frame.
struct HeartbeatFrame {
  uint32_t magic = 0x48564254;  // "HVBT"
  uint32_t sender_rank = 0;
  uint32_t epoch = 0;
  uint32_t seq = 0;
};

// Suspect-gossip variant of the beacon (same 16-byte layout, this magic,
// and `seq` reinterpreted as the SUSPECT rank): a rank that has flagged a
// silent peer repeats the accusation to its live neighbours every beat
// interval, and receivers re-gossip, so a suspicion hops around the ring
// to rank 0 even when the frozen rank sits between them — the data-plane
// analogue of the control plane's dead_ranks relay, needed mid-steady
// when zero control frames flow.
constexpr uint32_t kSuspectMagic = 0x48564253;  // "HVBS"

// Echo variant (same 16-byte layout, this magic): a rank that receives a
// beacon bounces it straight back on the same full-duplex beat socket
// with the magic swapped, preserving sender_rank / epoch / seq.  The
// original sender matches `seq` against its send-timestamp ring and folds
// the round trip into the per-link RTT estimate (net.h NetLinkRecordRtt)
// — continuous link telemetry riding the existing beacons, no extra
// frames on the data or control planes and no wire-format growth.
constexpr uint32_t kEchoMagic = 0x48564245;  // "HVBE"

constexpr size_t kHeartbeatFrameBytes = 16;

// Fixed-size little-endian encode/decode (no length prefix: the frame is
// its own framing, consumed in 16-byte chunks off a byte stream).
// ParseHeartbeat accepts all three magics (beacon, suspect gossip, echo);
// the caller dispatches on hb->magic.
void SerializeHeartbeat(const HeartbeatFrame& hb, uint8_t out[16]);
bool ParseHeartbeat(const uint8_t in[16], HeartbeatFrame* hb);

std::vector<uint8_t> SerializeRequestList(const RequestList& rl);
bool ParseRequestList(const std::vector<uint8_t>& buf, RequestList* rl);
std::vector<uint8_t> SerializeResponseList(const ResponseList& rl);
bool ParseResponseList(const std::vector<uint8_t>& buf, ResponseList* rl);

}  // namespace hvdtpu
