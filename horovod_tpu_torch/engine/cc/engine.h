// Core collective engine: enqueue -> negotiate -> fuse -> execute -> complete.
//
// TPU-native redesign of the reference engine
// (Horovod's horovod/common/operations.cc):
//   * rank/size come from the launcher / pod-slice metadata, not MPI_Init
//   * control plane: rank-0 TCP coordinator (star), replacing
//     MPI_Gather/MPI_Bcast negotiation (operations.cc:1541-1678)
//   * data plane: bandwidth-optimal ring allreduce / allgather / pipelined
//     broadcast over direct TCP between ring neighbours, replacing
//     MPI_Allreduce/MPI_Allgatherv/MPI_Bcast (operations.cc:1144,828,1211);
//     on a TPU pod these host-side collectives ride DCN while the compiled
//     JAX path (horovod_tpu/jax) rides ICI via XLA collectives.
//   * completion: polling handle table (the reference's torch handle manager,
//     Horovod's horovod/torch/handle_manager.cc, promoted to the core
//     so every framework binding shares it) -- no CUDA events.
// Tensor fusion, the coordinator's consistency checks, stall detection and
// the timeline keep the reference's semantics (operations.cc:1607-1642,
// :301-503, :1231-1276).
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "autotune.h"
#include "flight.h"
#include "timeline.h"
#include "transport.h"
#include "wire.h"

namespace hvdtpu {

struct EngineOptions {
  int rank = 0;
  int size = 1;
  int local_rank = 0;
  int local_size = 1;
  std::string coord_endpoint;               // "host:port" (rank 0 listens)
  std::vector<std::string> data_endpoints;  // one per rank
  double cycle_time_ms = 5.0;
  int64_t fusion_threshold = 64 * 1024 * 1024;
  double stall_warning_sec = 60.0;
  // Hard deadline for a collective stuck in negotiation (a subset of ranks
  // never announced it): past this, the coordinator escalates from the
  // stall *warning* to a coordinated ABORT (ST_TIMEOUT) naming the stalled
  // tensors and missing ranks, so the job fails fast instead of hanging
  // until an outer launcher timeout.  <= 0 disables (warning-only, the
  // pre-fault-tolerance behavior).  HVD_TPU_COLLECTIVE_TIMEOUT_SEC.
  double collective_timeout_sec = 0.0;
  // Negotiation response cache (docs/performance.md): number of negotiated
  // collectives each rank remembers so repeats announce a compact slot
  // index instead of a full string request.  HVD_TPU_CACHE_CAPACITY
  // (default 1024); 0 disables (HVD_TPU_RESPONSE_CACHE=0 kill switch).
  int64_t cache_capacity = 1024;
  std::string timeline_path;
  // Online autotuning (docs/performance.md#autotuning): rank 0 scores
  // tuning windows of `autotune_window` negotiated collectives from the
  // throughput the coordinator already observes and broadcasts the next
  // (fusion_threshold, cycle_time_ms) candidate in the response list so
  // every rank applies it at the same tick boundary.  HVD_TPU_AUTOTUNE=1
  // opts in; the first `autotune_warmup` windows are discarded; a fix
  // value >= 0 pins that knob (HVD_TPU_AUTOTUNE_FIX=k=v,...).
  bool autotune = false;
  int64_t autotune_warmup = 2;
  int64_t autotune_window = 32;
  int64_t autotune_fix_fusion = -1;
  double autotune_fix_cycle_ms = -1.0;
  int64_t autotune_fix_compression = -1;
  int64_t autotune_fix_cross_algo = -1;
  // Wire-level gradient compression (docs/performance.md#wire-compression,
  // HVD_TPU_COMPRESSION off|bf16|fp8): fp32 allreduce buckets at least
  // `compression_min_bytes` big transfer as bf16 / fp8-e4m3 with fp32
  // master copies and per-tensor error-feedback residuals; reduction
  // still accumulates in f32 at every ring hop.  Agreed JOB-WIDE at init
  // (a mixed-env launch is a typed init error, not a silent split into
  // ranks that pack buckets differently), mutated only by the lockstep
  // tuned-parameter broadcasts, and re-agreed across elastic reshapes.
  uint8_t compression_mode = COMP_NONE;
  int64_t compression_min_bytes = 1024;
  // Two-level allreduce (docs/performance.md#two-level-topology):
  // node-local reduce-scatter -> one cross-node exchange PER LOCAL RANK
  // over its 1/local_size shard (local_size parallel DCN streams) ->
  // node-local allgather, chunk-pipelined so the local and cross phases
  // overlap.  The bandwidth-optimal successor of the reference's
  // ncclReduce -> MPI_Allreduce -> ncclBcast star
  // (HOROVOD_HIERARCHICAL_ALLREDUCE, operations.cc:1003-1048).  Requires
  // ranks grouped in contiguous blocks of local_size (the hvdrun layout).
  bool hierarchical_allreduce = false;
  // Ring-vs-tree boundary for the cross-node hop: hierarchical buckets
  // with payload under this many bytes take the recursive-doubling
  // (tree) exchange — log2(nodes) latency steps instead of
  // 2*(nodes-1) — and everything else takes the bandwidth-optimal ring.
  // HVD_TPU_CROSS_ALGO_THRESHOLD; autotuned as the fourth ParameterManager
  // axis; 0 = ring always.
  int64_t cross_algo_threshold = 64 * 1024;
  // Elastic membership (docs/fault-tolerance.md#elastic-membership,
  // HVD_TPU_ELASTIC): when a worker dies, the coordinator reshapes the
  // job around the survivors (new dense ranks, rebuilt ring, membership
  // epoch bump) instead of cascading a fatal abort, as long as at least
  // `min_size` ranks survive — below that the abort path (and with it
  // the hvdrun checkpoint-restart fallback) still fires.  Requires the
  // rank-0 coordinator to survive; forces the flat ring (hierarchical
  // topologies are not rebuilt).
  bool elastic = false;
  int64_t min_size = 1;
  // This process is a standby REJOINING a live elastic job
  // (HVD_TPU_REJOIN, spawned by hvdrun --min-np/--max-np): Init connects
  // to the coordinator, announces its data endpoint, and blocks until
  // admitted at the next reshape barrier, learning its dense rank and
  // the membership from the reshape broadcast.  rank/size/data_endpoints
  // in these options are placeholders until then.
  bool rejoin = false;
  // Control-plane coordinator tree (docs/performance.md
  // #control-plane-scaling, HVD_TPU_COORD_TREE): each host's
  // local-rank-0 becomes a sub-coordinator that accepts its node's
  // control sockets, folds announce bitsets / request lists into ONE
  // aggregate frame per tick, and relays rank 0's broadcasts back down —
  // rank 0 holds O(hosts) steady-state sockets and processes O(hosts)
  // frames per tick instead of O(ranks).  AUTO: the tree is built only
  // for multi-node contiguous layouts (the same job-wide agreement the
  // two-level data topology validates); single-host jobs keep the
  // degenerate one-level star, and elastic jobs force it (membership
  // reshapes rebuild the star only).
  bool coord_tree = true;
  // Decentralized steady state (HVD_TPU_STEADY_THRESHOLD): once the
  // coordinator sees the cache-hit slot stream repeat an identical cycle
  // this many times at quiesced boundaries, it broadcasts the pattern
  // and every rank self-clocks on an epoch counter, replaying the cached
  // responses with ZERO control-plane frames per cycle; any miss falls
  // back to full negotiation.  0 disables.  `steady_max_period` bounds
  // the detectable cycle length (slots per cycle).
  int64_t steady_threshold = 32;
  int64_t steady_max_period = 256;
};

struct HandleStatus {
  std::atomic<int32_t> code{ST_PENDING};
  std::string error;
  // Per-handle completion signalling: Wait() sleeps on THIS handle's cv,
  // and CompleteEntry wakes only this handle's waiters.  A single global
  // cv would make every completion wake every waiter — O(waiters x
  // completions) wakeups for the 100-collective broadcast groups the TF
  // binding enqueues (the scale the reference's per-handle
  // std::promise/future avoided by construction, torch handle manager).
  std::mutex mu;
  std::condition_variable cv;
  // Allgather result storage (engine-owned; exposed to the caller as a
  // zero-copy view via ResultPtr — the handle stays alive until the view
  // is dropped).
  std::vector<char> gathered;
  int64_t out_dim0 = 0;
  // Completion order stamps, written by the engine thread before `code`
  // flips.  Responses are built by rank 0 and broadcast, so both values are
  // identical on every rank for the same op — the property the XLA data
  // plane uses to agree on a cross-rank dispatch order without extra
  // round-trips (the role MPIResponseList ordering plays in the reference,
  // Horovod's horovod/common/operations.cc:1644-1650).
  int64_t completion_seq = -1;   // per-engine monotonic completion index
  int64_t completion_tick = -1;  // index of the response list that carried it
  int64_t negotiation_us = -1;   // enqueue -> response arrival; -1 on errors
};

// One slot of the negotiation response cache: the request signature this
// rank last negotiated under `name` plus the agreed response to replay on
// a hit.  `dims` are THIS rank's dims (they differ per rank for ragged
// allgather; the stored response's rank_dim0 carries the full geometry).
struct CacheSlot {
  bool valid = false;
  uint64_t last_touch = 0;  // LRU stamp (monotonic counter, not time)
  std::string name;
  uint8_t op = OP_ALLREDUCE;
  uint8_t dtype = HVD_FLOAT32;
  int32_t root_rank = -1;
  std::vector<int64_t> dims;
  Response response;  // single-name response replayed on a hit
};

// Negotiation response cache (the role Horovod's response cache plays in
// the reference's successors): once a named collective has been fully
// negotiated, every rank stores the agreed response under a compact slot
// index.  Subsequent steps announce slot indices (RequestList.cache_bits)
// instead of string requests; the coordinator intersects and broadcasts
// hit indices; every rank replays the stored response.
//
// Determinism contract: Put/Touch/Erase happen ONLY while processing the
// broadcast response lists, in list order — identical on every rank — so
// slot numbering and LRU order stay in lockstep and a slot index means
// the same collective everywhere.  Lookup (rank-local, at queue drain)
// never mutates.
class ResponseCache {
 public:
  bool enabled() const { return capacity_ > 0; }
  void set_capacity(int64_t capacity) { capacity_ = capacity; }
  int64_t size() const { return static_cast<int64_t>(by_name_.size()); }
  // Exact-signature match (name, op, dtype, dims, root); -1 on miss.
  int Lookup(const Request& req) const;
  int SlotByName(const std::string& name) const;
  const CacheSlot* Get(int slot) const;
  // Insert or update `name` (touching it); returns the slot used.  When a
  // full cache forced an eviction, *evicted holds the victim's old
  // contents (evicted->valid true) and the victim's slot is reused.
  int Put(const std::string& name, uint8_t op, uint8_t dtype,
          const std::vector<int64_t>& dims, int32_t root_rank,
          const Response& response, CacheSlot* evicted);
  void Touch(int slot);
  void Erase(const std::string& name);
  void Clear();

 private:
  int64_t capacity_ = 0;
  uint64_t touch_counter_ = 0;
  std::vector<CacheSlot> slots_;
  std::unordered_map<std::string, int> by_name_;
};

// One enqueued tensor awaiting negotiation + execution.
struct TableEntry {
  std::string name;
  uint8_t op = OP_ALLREDUCE;
  uint8_t dtype = HVD_FLOAT32;
  std::vector<int64_t> dims;
  const void* in = nullptr;
  void* out = nullptr;
  int root_rank = -1;
  bool average = false;
  // Point-to-point plane (docs/pipeline.md): the counterpart rank and
  // disambiguation tag for OP_SEND/OP_RECV entries (-1/0 otherwise).
  int32_t p2p_peer = -1;
  int32_t p2p_tag = 0;
  // Stage-group scoping for allreduce: the sorted member ranks this op is
  // restricted to (empty = whole world).  Carried per-entry, never as
  // persistent engine state — see wire.h Request.stage_ranks.
  std::vector<int32_t> stage_ranks;
  int64_t handle = -1;
  std::chrono::steady_clock::time_point enqueued_at;
  // Negotiation latency (enqueue -> response arrival), stamped when the
  // response pops this entry; -1 on error/drain paths.  Surfaced per
  // handle so Python can feed the negotiation_sec histogram for the
  // engine data plane too (the XLA plane times its own metadata ops).
  int64_t negotiation_us = -1;
};

class Engine {
 public:
  // Out-of-line so translation units that instantiate an Engine (the
  // simscale harness) never need the private Coordinator definition.
  Engine();
  ~Engine();

  // Starts the background thread and blocks until sockets are connected (or
  // failed).  Returns 0 on success; on failure err holds the reason.
  int Init(const EngineOptions& opts, std::string* err);
  void Shutdown();

  bool Initialized() const { return initialized_.load(); }
  // rank/size mirror opts_ through atomics: elastic reshapes mutate the
  // membership on the engine thread mid-run, and Python API threads read
  // hvd.rank()/hvd.size() live (they must re-resolve after a reshape).
  int rank() const { return cur_rank_.load(); }
  int size() const { return cur_size_.load(); }
  // Elastic reshapes re-resolve the local identity too (elastic is
  // single-host only, so post-reshape local == global); static jobs keep
  // their launch-time values.
  int local_rank() const { return cur_local_rank_.load(); }
  int local_size() const { return cur_local_size_.load(); }

  // Returns a handle (>=0) or -1 if the engine is not initialized / shut
  // down.  For allgather, `out` may be null; the result is kept engine-side
  // until CopyResult.  `average` divides the allreduce result by size.
  // `peer`/`tag` scope OP_SEND/OP_RECV entries to their counterpart rank
  // (docs/pipeline.md); `stage_ranks` scopes an allreduce to a stage
  // group's sorted member ranks (empty = whole world).
  int64_t Enqueue(uint8_t op, const std::string& name, const void* in,
                  void* out, const std::vector<int64_t>& dims, uint8_t dtype,
                  int root_rank, bool average, int peer = -1, int tag = 0,
                  const std::vector<int32_t>& stage_ranks = {});

  // 1 = done, 0 = pending, -1 = unknown handle.
  int Poll(int64_t handle);
  // Blocks until done; returns status code.
  int32_t Wait(int64_t handle);
  int32_t StatusOf(int64_t handle, std::string* error);
  // Completion stamps for a finished handle (-1 while pending / unknown).
  int64_t CompletionSeq(int64_t handle);
  int64_t CompletionTick(int64_t handle);
  // Negotiation latency (µs, enqueue -> response arrival) for a finished
  // handle; -1 while pending, unknown, or failed before negotiation.
  int64_t NegotiationUs(int64_t handle);
  // Number of fully processed response lists; a tick t is "closed" (all its
  // completions are visible, on every rank) once TicksDone() > t.
  int64_t TicksDone() const { return ticks_done_.load(); }
  int64_t ResultBytes(int64_t handle);
  int64_t ResultDim0(int64_t handle);
  bool CopyResult(int64_t handle, void* dst, int64_t nbytes);
  // Zero-copy view of a completed allgather's engine-owned result buffer;
  // valid until Release(handle).  nullptr while pending/absent.
  void* ResultPtr(int64_t handle);
  void Release(int64_t handle);

  // Stall observability (Python metrics registry, common/metrics.py):
  // cumulative count of stalled-tensor warnings emitted by the rank-0
  // sweep, and a bounded log of the most recent ones serialized as
  // "name|seconds;name|seconds" (names sanitized of the separators).
  int64_t StallEvents();
  std::string StallInfo();

  // Coordinated-abort observability: the latched abort status (0 = never
  // aborted; ST_RANKS_DOWN / ST_TIMEOUT otherwise) with its structured
  // message, and a process-cumulative abort-event count for the metrics
  // registry (survives engine re-init, like StallEvents).
  int32_t AbortCode() const { return abort_code_.load(); }
  std::string AbortMessage();
  int64_t AbortEvents() const { return abort_events_.load(); }

  // Cross-rank clock alignment (docs/timeline.md): this rank's estimated
  // clock offset relative to rank 0's engine epoch (µs; subtract from
  // local timeline ts to land on rank 0's clock) and the RTT of the
  // winning NTP-style probe (the error bound).  0 on rank 0 and at size 1.
  int64_t ClockOffsetUs() const { return clock_offset_us_.load(); }
  int64_t ClockRttUs() const { return clock_rtt_us_.load(); }

  // Announce-order observability (rank-0 coordinator; straggler
  // attribution, docs/troubleshooting.md): cumulative count of fully
  // negotiated collectives, per-rank last-to-announce counts serialized
  // as "n0,n1,...", and a bounded log of the most recent negotiations as
  // "cumulative_count:last_rank|skew_us;..." (skew = first -> last
  // announce; count and entries under one lock hold).  All counts
  // are process-cumulative (survive re-init, like StallEvents); the XLA
  // plane's __xp.* metadata negotiations feed them too, since they ride
  // this same coordinator.
  int64_t AnnounceEvents();
  std::string AnnounceLog();
  std::string LastAnnounceCounts();

  // Response-cache observability (docs/performance.md): hit = a drained
  // request announced as a cache bit, miss = a full string request sent
  // while the cache was enabled, eviction = a capacity-forced slot reuse.
  // Process-cumulative (survive re-init, like StallEvents); size is the
  // current entry count of this engine's cache.
  int64_t CacheHits() const { return cache_hits_.load(); }
  int64_t CacheMisses() const { return cache_misses_.load(); }
  int64_t CacheEvictions() const { return cache_evictions_.load(); }
  int64_t CacheSize() const { return cache_size_.load(); }

  // Online-autotuning observability (docs/performance.md#autotuning).
  // Current applied parameters come from the lockstep broadcasts, so
  // they are identical on every rank of a healthy job; the per-window
  // search history and best score live at the coordinator (rank 0).
  bool AutotuneEnabled() const { return opts_.autotune; }
  bool AutotuneFrozen() const { return autotune_frozen_.load(); }
  // Rank 0: completed tuning windows; workers: the window count carried
  // by the last applied broadcast (equal once the search freezes).
  int64_t AutotuneWindows();
  int64_t CurrentFusionThreshold() const { return cur_fusion_.load(); }
  int64_t CurrentCycleTimeUs() const { return cur_cycle_us_.load(); }
  int64_t CurrentCrossAlgoThreshold() const {
    return cur_cross_algo_.load();
  }
  double AutotuneBestScore() { return tuner_.best_score(); }
  // Rank 0 search history: "window|fusion|cycle_us|score;...".
  std::string AutotuneHistory() { return tuner_.History(); }
  // Per-rank applied-parameter log, "tick|fusion|cycle_us|frozen;..." —
  // identical on every rank (the lockstep determinism contract; tests
  // allgather and compare it).
  std::string AutotuneApplied();
  // Manual parameter injection (hvd.autotune_set, rank 0 only): broadcast
  // `fusion` / `cycle_ms` / `compression` / `cross_algo` (< 0 keeps the
  // current value) next tick.  Returns 0 ok, 1 off the coordinator, 2
  // uninitialized.
  int AutotuneInject(int64_t fusion, double cycle_ms, int64_t compression,
                     int64_t cross_algo);
  // Fusion threshold in force at engine tick `tick` (the XLA plane's
  // bucket boundaries must follow autotuned thresholds in lockstep;
  // jax/eager_mesh.py).  Past ticks are stable: the history is
  // append-only with increasing tick stamps.
  int64_t FusionThresholdAt(int64_t tick);

  // Wire-compression observability (docs/performance.md#wire-compression).
  // The applied mode mirrors opts_ through an atomic (lockstep broadcasts
  // mutate it on the engine thread; Python API threads read it live);
  // CompressionModeAt serves the XLA plane's per-tick lockstep lookup the
  // way FusionThresholdAt does for bucket boundaries.  The byte/op
  // counters are process-cumulative (survive re-init, like StallEvents);
  // wire bytes count every allreduce bucket at its wire width and payload
  // bytes at the caller dtype's width, so the pair exposes both the
  // compression win and the legacy half-staging inflation.
  uint8_t CompressionModeNow() const {
    return static_cast<uint8_t>(cur_compression_.load());
  }
  int64_t CompressionModeAt(int64_t tick);
  // "wire|payload|ops_none|ops_bf16|ops_fp8|residual_bytes|
  //  residual_tensors|min_bytes" for the Python metrics sync.
  std::string CompressionInfo();
  // Bounded per-bucket decision log, "first_name|mode;..." in execution
  // order — identical on every rank of a healthy job (tests allgather
  // and compare it across cache replay and reshapes).
  std::string CompressionLog();

  // Two-level topology observability (docs/performance.md
  // #two-level-topology).  TopologyInfo serializes
  // "hier|nodes|local_size|threshold|ops_ring|ops_tree|local_bytes|
  //  cross_bytes|log_total" for the Python metrics sync: the cumulative
  // per-phase byte counters split by hop (local = intra-node ring, cross
  // = the DCN hop — the bytes the compression satellite claims shrink),
  // ring/tree bucket counts, and the cumulative per-bucket log count so
  // the Python side can delta-consume TopologyLog.  TopologyLog is the
  // bounded per-bucket phase record
  // "name|algo|local_rs_us|cross_us|local_ag_us;..." feeding the phase
  // histograms.
  std::string TopologyInfo();
  std::string TopologyLog();

  // Control-plane observability (docs/performance.md
  // #control-plane-scaling).  ControlInfo serializes
  // "tree|children|hosts|steady_active|pattern_len|steady_threshold|
  //  entries|exits|replays|steady_cycles|negotiated_ticks|frames_sent|
  //  frames_recv" for the Python metrics sync: the tree shape this rank
  // sees (children = control sockets it reads each tick), the
  // decentralized-steady-state counters (process-cumulative, like
  // StallEvents), and the control-frame counters the zero-frames-per-
  // steady-cycle contract is asserted against.
  std::string ControlInfo();
  bool SteadyActive() const { return steady_active_.load(); }
  int64_t CtrlFramesSent() const { return ctrl_frames_sent_.load(); }

  // Liveness observability (docs/fault-tolerance.md#failure-detection).
  // Serializes
  // "hb_ms|hb_miss|sent|recv|miss_events|evictions|clock_fanin|
  //  peer:age_us:misses peer:age_us:misses" — the detector config, the
  // process-cumulative heartbeat counters (StallEvents contract), rank
  // 0's init clock-sync probe fan-in (O(direct children), the tree-relay
  // satellite's assert surface), and the per-monitored-peer last-seen
  // age + consecutive-miss count at snapshot time.  Empty peer tail when
  // the detector is off (HVD_TPU_HEARTBEAT_MS=0 or size 1).
  std::string LivenessInfo();

  // Point-to-point plane observability (docs/pipeline.md,
  // docs/metrics.md#p2p).  Serializes
  // "sends|recvs|bytes_out|bytes_in|matched|unmatched|group_ops|channels"
  // — process-cumulative send/recv completions and payload bytes
  // (StallEvents contract), the matched-pair count, the live
  // unmatched gauge (this rank's announced-but-unpaired p2p entries),
  // stage-group allreduce count, and the number of dedicated lazy p2p
  // channels currently dialed.
  std::string P2pInfo();

  // Perf-introspection plane (docs/metrics.md#links / #anomalies).
  // LinkInfo passes through the transport layer's per-peer telemetry
  // (net.h NetLinkInfo: bytes, timed-send latency histogram, stall /
  // short-write counts, heartbeat-echo RTT).  AnomalyInfo serializes the
  // online detector's config + process-cumulative verdict counts as
  // "sigma|interval_ms|slow_link|straggler|cache_degraded|slow_phase";
  // AnomalyLog the bounded verdict log as
  // "kind|subject|detail|age_us;..." (newest last, separators sanitized
  // out of details) — the registry mirrors it whole, it is small.
  std::string LinkInfo();
  std::string AnomalyInfo();
  std::string AnomalyLog();

  // Elastic-membership observability (docs/fault-tolerance.md).  The
  // epoch counts reshapes survived by THIS engine lifetime (0 until the
  // first); reshape/lost/joined totals are process-cumulative like
  // StallEvents.  MembershipInfo serializes
  // "epoch|size|lost_csv|joined_csv" (cumulative rank lists, each in the
  // numbering of the epoch the change happened in).
  bool ElasticEnabled() const { return opts_.elastic; }
  int64_t MembershipEpoch() const { return membership_epoch_.load(); }
  int64_t ReshapeEvents() const { return reshapes_total_.load(); }
  std::string MembershipInfo();
  // Python acknowledges a reshape after resyncing state (hvd.run_elastic):
  // until then every fresh Enqueue fails fast with the retryable
  // ST_RESHAPE status, so no rank can stall waiting for peers that are
  // re-entering agreement.
  void MembershipAck() { reshape_ack_pending_.store(false); }
  bool ReshapeAckPending() const { return reshape_ack_pending_.load(); }

  // Flight recorder (postmortem plane, flight.h): the always-on bounded
  // ring of recent control-plane events this rank recorded.  Exposed so
  // c_api can serve the ring snapshot and cumulative event count to the
  // Python postmortem writer and the metrics registry.
  FlightRecorder& flight() { return flight_; }

  // Pending-tensor observability (postmortem dumps).  PendingInfo: THIS
  // rank's in-flight collectives as "name|op|age_us;..." (what was
  // enqueued but not completed when the dump was taken).  CoordPendingInfo
  // (rank 0): the coordinator's waiting-on view as
  // "name|age_us|missing_rank missing_rank ...;..." — which ranks each
  // stalled negotiation is still waiting for.  Both bounded and
  // separator-sanitized; CoordPendingInfo is a snapshot the engine thread
  // refreshes each tick (the coordinator tables are engine-thread-only).
  std::string PendingInfo();
  std::string CoordPendingInfo();

  // Cross-rank stall diagnosis: on the ST_TIMEOUT / ST_RANKS_DOWN abort
  // paths the coordinator aggregates its per-rank waiting-on knowledge
  // (last announce, last control frame) into a one-paragraph story that
  // rides the broadcast abort message — Diagnosis() returns that
  // paragraph (empty when no abort, or the abort carried none).
  std::string Diagnosis();

  // The engine-owned Chrome-tracing timeline.  Exposed so the XLA data
  // plane (Python, jax/eager_mesh.py) can emit its BUCKET_BUILD /
  // XLA_DISPATCH / DEVICE_WAIT activities into the SAME trace file as the
  // engine's NEGOTIATE/op events (the reference wraps every execution
  // phase, operations.cc:680-692).  Timeline methods are internally
  // mutex-guarded and no-ops when the timeline is disabled.
  Timeline& timeline() { return timeline_; }

 private:
  struct Coordinator;  // rank-0 only state

  void BackgroundLoop();
  bool RunLoopOnce();
  bool SetupSockets(std::string* err);
  // Transport seam bring-up (end of SetupSockets): wrap every topology
  // fd in a Channel, and — when the job-wide HVD_TPU_SHM agreement armed
  // shm — create/attach the per-node segment via a token relay over the
  // node-local ring sockets and point the local-ring channels at its
  // rings.  Chaos clauses naming an in-node link demote to TCP (auto) or
  // fail init with a typed error naming the clause (force / unsupported
  // drop-flaky shapes).
  bool SetupShmTransport(std::string* err);
  // Standby path (opts_.rejoin): connect to the coordinator, announce the
  // data endpoint, block until the admitting reshape broadcast arrives,
  // adopt the new membership, and build the ring.
  bool SetupRejoinSockets(std::string* err);
  void TeardownSockets();
  // Elastic membership (docs/fault-tolerance.md#elastic-membership).
  // Rank 0: drain pending joiner connects off the control listen socket
  // (non-blocking; a standby announces itself with a JOIN hello + an
  // endpoint frame).
  void CoordinatorAcceptJoiners();
  // Rank 0: finish a joiner's registration by assembling the rest of its
  // JOIN handshake (hello word already consumed) with bounded,
  // non-blocking reads — a partial frame can stall this at most
  // timeout_sec, never indefinitely.  False (fd NOT adopted; caller
  // closes) on a short/duplicate handshake.
  bool RegisterJoiner(int fd, double timeout_sec);
  // Rank 0: park a fully-handshaken joiner (endpoint already parsed) for
  // the next reshape barrier.  False (fd NOT adopted; caller closes) on
  // a duplicate endpoint.
  bool RegisterJoinerEndpoint(int fd, const std::string& ep);
  // Rank 0: whether this tick can be the reshape barrier (a death is
  // pending, or quiesced joiners await admission) and, if so, fill `out`
  // with the reshape verdict + new membership.
  bool CoordinatorMaybeReshape(ResponseList* out);
  // Every rank: adopt the broadcast membership — fail in-flight
  // collectives with the retryable ST_RESHAPE status, clear the response
  // cache and autotune search, update rank/size/endpoints, and rebuild
  // the data-plane ring.  On rebuild failure the engine falls back to a
  // fatal local abort (the launcher's restart path takes over).
  bool ApplyReshape(const ResponseList& rl);
  // Tear down and reconnect the flat ring for the current membership,
  // with epoch-tagged hellos so stale pre-reshape connects are rejected.
  bool RebuildRing(std::string* err);
  // NTP-style clock sync over the coordinator star (end of SetupSockets):
  // rank 0 probes each worker K times; the minimum-RTT round trip gives
  // the best offset estimate (worker_ts - probe midpoint), which rank 0
  // sends back so every rank knows its own offset.  Runs at every Init,
  // so restart epochs re-align too.
  bool ClockSync(std::string* err);
  int64_t EpochNowUs() const;
  // Rank 0: one negotiation reached full count; `last_rank` announced
  // last, `skew_us` first -> last announce (tree aggregates forward the
  // true per-rank announce timestamps, so the verdict names the true
  // straggler, not the sub-coordinator whose frame closed the count).
  void RecordAnnounce(int last_rank, int64_t skew_us);

  // Coordinator (rank 0) helpers.
  void CoordinatorHandle(const RequestList& rl, int from_rank);
  // One full string request (shared by wire requests and the synthesized
  // ones below).  `announce_ts` is the announce time on rank 0's clock
  // (µs since epoch); < 0 stamps on arrival (the direct-star form).
  void HandleOneRequest(const Request& req, int from_rank,
                        int64_t announce_ts = -1);
  // Response-cache coordination: count one rank's cache-bit announcements
  // (full count -> a broadcast hit); convert any bits still pending for
  // `name`'s slot back into full synthesized requests (a peer fell back
  // to string negotiation — renegotiation or cross-transport split — so
  // validation must see every rank); drain a capacity-evicted slot's
  // orphaned bits the same way.
  void CoordinatorHandleBits(const std::vector<uint32_t>& bits,
                             int from_rank);
  // One cache-bit announcement from one rank (the per-rank granule the
  // wire bits and the tree's aggregated BitGroups both decompose into).
  void HandleOneBit(uint32_t bit, int from_rank, int64_t announce_ts);
  void CoordinatorDrainBitsFor(const std::string& name);
  void CoordinatorDrainSlot(int slot, const CacheSlot& contents);
  // The request rank `rank` would have sent for the cached collective
  // (per-rank dim0 restored from the stored allgather geometry).
  Request SynthesizeFromSlot(const CacheSlot& slot, int rank) const;
  // Replay broadcast cache hits in order, re-fusing consecutive
  // same-dtype allreduces like the coordinator does for fresh responses.
  void ProcessCacheHits(const std::vector<uint32_t>& hits);
  ResponseList CoordinatorTick();
  Response BuildResponse(const std::string& name);
  // Decentralized steady state (docs/performance.md
  // #control-plane-scaling).  CoordinatorMaybeSteady runs after the tick
  // built its outgoing list: it feeds the cache-hit slot stream into the
  // pattern detector and, at a quiesced cycle boundary with the pattern
  // repeated `steady_threshold` times, stamps the STEADY verdict onto
  // the list.  ApplySteady arms self-clocked replay on every rank while
  // processing that (identical) list.
  void CoordinatorMaybeSteady(ResponseList* out);
  void ApplySteady(const ResponseList& rl);
  // One self-clocked pass of the engine loop while steady state is
  // armed: replay pattern-matching queue entries group by group with
  // zero control-plane frames, poll the parent socket for abort/shutdown
  // frames, and fall back to full negotiation on any miss.  Returns
  // false when the loop must exit (abort/shutdown).
  bool SteadyLoopOnce();
  // Leave steady state locally (miss, shutdown, defensive broadcast):
  // requeue un-replayed requests and resume per-tick frames.
  void ExitSteadyLocal(const std::string& reason);
  // Rank 0: note a rank's steady exit (frames resume only once ALL ranks
  // exited — broadcasting earlier would double-execute replays on ranks
  // still self-clocking).
  void NoteSteadyExit(int r);
  // Flight-record a steady-exit marker's miss coordinates (epoch/pos) as
  // the frame passes this node — the per-rank postmortem rings locate
  // the miss even though the aggregate's exit list carries only ranks.
  void NoteChildSteadyExit(const RequestList& frame, int child_rank);
  // Bounded wait for the parent's next broadcast, cascaded by tree
  // depth: rank 0 may legitimately block ~2T+5 probing a frozen
  // sub-coordinator before its verdict goes out, a sub must outwait
  // that, and a leaf must outwait its sub — equal bounds at every level
  // would expire downstream just before the true verdict arrives and
  // misblame the parent.
  double ParentWaitSec() const;
  bool AllSteadyExited() const;
  // Rank 0, steady/holding mode: drain whatever control frames arrived
  // without blocking (fallback announcements, steady exits, EOFs),
  // escalate deadline breaches, and broadcast an armed abort
  // immediately.  Returns false when the loop must exit.
  bool CoordinatorSteadyPoll();
  // Rank 0, steady/holding mode, elastic only: when a death armed the
  // reshape barrier (or a standby is waiting) while ranks self-clock
  // with the control plane dark, broadcast an empty revocation list —
  // self-clocking ranks treat any payload broadcast as a revocation —
  // and fall back to the normal loop so the barrier fires on the next
  // regular tick through the tested CoordinatorMaybeReshape path.
  // Returns 0 (nothing to do), 1 (revoked; end this steady pass), or
  // -1 (fatal; exit the loop).
  int MaybeRevokeSteadyForReshape();
  // Sub-coordinator, steady/holding mode: forward children's fallback
  // frames upward as aggregates and relay any parent broadcast down.
  // Returns false when the loop must exit.
  bool SubRelayPass();
  // Common tail every rank runs on a received/built broadcast list.
  bool ProcessResponseList(ResponseList& responses,
                           const RequestList& my_requests,
                           std::chrono::steady_clock::time_point tick_start);
  void CheckForStalledTensors();
  // Every-tick deadline sweep (rank 0): escalates a stall beyond
  // opts_.collective_timeout_sec to a coordinated abort.
  void CheckCollectiveTimeout();
  // Latch the abort status locally (any rank).  The BackgroundLoop exit
  // drain then fails everything pending with this status instead of the
  // generic shutdown message.
  void AbortLocal(int32_t code, const std::string& message);
  // Rank 0: record a dead/unresponsive worker (`reason` says which) and,
  // on the first death, arm the coordinated abort naming the missing
  // ranks and the tensors they left pending.
  void MarkRankDead(int r, const std::string& reason);

  // Data-plane heartbeat failure detector (docs/fault-tolerance.md
  // #failure-detection).  A dedicated monitor thread exchanges 16-byte
  // typed beacons with BOTH ring neighbours over dedicated data-listener
  // connections on the HVD_TPU_HEARTBEAT_MS cadence, entirely off the
  // engine tick — a busy local ring cannot starve them, and a frozen
  // peer's silence is observed in O(heartbeat) instead of
  // O(collective-timeout).  The monitor NEVER touches control sockets or
  // engine state: past HVD_TPU_HEARTBEAT_MISS silent intervals it
  // records the miss, wakes the engine thread (ShutdownFd on the shared
  // data fds), and queues the verdict for the engine thread to escalate
  // through the existing machinery (MarkRankDead on rank 0; an
  // out-of-band hb_report control frame on workers; a local typed abort
  // when the report path itself is dark — the partition case).
  void HeartbeatLoop();
  // Stop + join the monitor and close the beat sockets (Teardown).
  void StopHeartbeatMonitor();
  // Engine thread, rank 0: drain monitor-flagged peers into MarkRankDead.
  void CoordinatorDrainHeartbeatDeaths();
  // Engine thread, workers: flush monitor-flagged peers upward as an
  // out-of-band hb_report RequestList on `fd` (the parent control
  // socket).  The frame carries ONLY dead_ranks — the receiver processes
  // it and keeps waiting for this rank's real tick frame, preserving the
  // send-one-wait-one alternation.  False on send failure.
  bool SendHeartbeatReports(int fd);
  // Sliced replacement for the blocking parent WaitReadable: flushes
  // pending heartbeat reports between ~50ms slices and returns false
  // early when the monitor latched a local abort.  Plain WaitReadable
  // when the detector is off.
  bool WaitParentSliced(int fd, double total_sec);
  // Engine thread: when the monitor armed the local-abort verdict (its
  // report window expired with the control plane equally dark), latch
  // the typed abort here — AbortLocal clears the response cache, which
  // is not safe from the monitor thread.  True when it aborted.
  bool CheckHeartbeatLocalAbort();

  // Online anomaly detector (docs/metrics.md#anomalies).  A second
  // off-the-tick monitor thread (the HeartbeatLoop pattern) sweeps the
  // observability counters every HVD_TPU_ANOMALY_INTERVAL_MS: per-link
  // timed-send latency (cross-sectional robust baseline — each link's
  // level against the median + MAD of ALL links, so a link that is slow
  // FROM INIT still stands out), per-rank last-to-announce shares
  // (rank 0), response-cache hit rate, and per-phase topology timing
  // (temporal self-baselines).  A sustained excursion past
  // HVD_TPU_ANOMALY_SIGMA robust deviations emits one typed verdict per
  // episode through EmitAnomaly.  Reads only atomics, the net.h link
  // accessor, and mutex-guarded logs — never engine-thread state.
  void AnomalyLoop();
  void StopAnomalyMonitor();
  // Append a verdict: bounded log + cumulative count (anomaly_mu_), an
  // FL_ANOMALY flight event, and an ANOMALY timeline instant.
  void EmitAnomaly(int kind, const std::string& subject,
                   const std::string& detail);

  // Online autotuning (docs/performance.md#autotuning).  AttachTunedParams
  // runs at the coordinator after CoordinatorTick: it gives the
  // ParameterManager its per-tick chance to close a window / flush a
  // manual injection, and folds the proposal into the outgoing response
  // list.  ApplyTunedParams runs on EVERY rank while processing that
  // (identical) list, before cache-hit replay, so fusion-plan changes
  // take effect at the same tick boundary everywhere.
  void AttachTunedParams(ResponseList* out);
  void ApplyTunedParams(const ResponseList& rl);

  // Execution.  `from_cache` marks a replayed response: its cache slot was
  // already touched by ProcessCacheHits, so skip the (re-)insert.
  void PerformOperation(const Response& resp, bool from_cache = false);
  void ExecuteAllreduce(const Response& resp,
                        std::vector<TableEntry>& entries);
  void ExecuteAllgather(const Response& resp, TableEntry& e);
  void ExecuteBroadcast(const Response& resp, TableEntry& e);
  // Point-to-point plane (docs/pipeline.md).  ExecuteSendRecv moves one
  // matched pair's payload over the p2p channel toward the counterpart:
  // fp32 payloads honour the response's negotiated wire compression with
  // per-name error feedback (the allreduce residual contract), so
  // repeated micro-batch sends never accumulate rounding drift.
  void ExecuteSendRecv(const Response& resp, TableEntry& e);
  // Stage-scoped allreduce (DP inside one pipeline stage): leader
  // gather-reduce-broadcast over p2p channels among resp.stage_ranks.
  // O(G * bytes) at the leader — fine for the small per-stage DP groups
  // pipeline parallelism produces; the global ring stays untouched.
  void ExecuteGroupAllreduce(const Response& resp,
                             std::vector<TableEntry>& entries);
  // The channel to `peer`, picked identically on both ends: an existing
  // topology channel when the peer is a fabric neighbour (node-local shm
  // ring / cross ring / global ring), else a dedicated TCP connection
  // dialed lazily at first use (lower rank connects with a kHelloP2P
  // hello, higher rank accepts on the data listener — deterministic,
  // because both ends execute the same broadcast response at the same
  // list position).  nullptr + *err on dial failure.
  const Channel* GetP2pChannel(int peer, std::string* err);
  // Drop every dedicated p2p channel (Teardown + reshape: the membership
  // renumbered, so cached peer fds are stale).
  void CloseP2pChannels();
  void CompleteEntry(const TableEntry& e, int32_t code,
                     const std::string& error);

  // Wire compression (docs/performance.md#wire-compression).  The
  // coordinator (and the lockstep cache replay) choose a bucket's wire
  // format from the applied mode, the payload dtype, and the bucket's
  // payload byte size; engine thread only.
  uint8_t ChooseCompression(uint8_t dtype, int64_t bytes) const;
  // Record one executed allreduce bucket for the compression metrics and
  // the per-bucket decision log.
  void RecordCompressedOp(const std::string& name, uint8_t mode,
                          int64_t payload_bytes, int64_t wire_bytes);

  // Data plane primitives (ring over TCP).
  bool RingAllreduce(void* buf, int64_t count, uint8_t dtype,
                     std::string* err);
  // Compressed ring allreduce: the local buffer stays f32 (reduction
  // accumulates in f32 at every hop) while segments cross the wire in
  // `wire` format (f16/bf16/fp8) — compress on send, decompress on
  // receive.  Recompression of already-quantized values is exact, so the
  // allgather phase loses nothing beyond the per-hop quantization the
  // format implies.
  bool RingAllreduceWire(float* buf, int64_t count, uint8_t wire,
                         int N, int index, const Channel& left,
                         const Channel& right, std::string* err);
  // Ring allreduce over an arbitrary participant ring (used for both the
  // global ring and the per-shard cross-node rings).
  bool RingAllreduceOn(void* buf, int64_t count, uint8_t dtype, int n,
                       int index, const Channel& left, const Channel& right,
                       std::string* err);
  // Two-level allreduce (docs/performance.md#two-level-topology): local
  // reduce-scatter over the node ring -> every local rank drives a
  // cross-node exchange (ring or recursive-doubling tree) over its own
  // 1/local_size shard -> local allgather, with the chunks of one bucket
  // pipelined through the three phases (a helper thread drives the cross
  // hop while the engine thread keeps the local ring busy).  `dtype` is
  // the REDUCTION buffer's element type (f32 master for the wire-staged
  // path; the native dtype for int/f64 payloads); `local_wire` /
  // `cross_wire` narrow the respective hop's bytes (255 = raw dtype;
  // != 255 requires an f32 buffer): halves ship native-width on BOTH
  // hops, lossy compression applies to the cross (DCN) hop only.
  bool TwoLevelAllreduce(void* buf, int64_t count, uint8_t dtype,
                         uint8_t local_wire, uint8_t cross_wire,
                         bool use_tree, const std::string& name,
                         std::string* err);
  // One chunk's node-local ring steps (engine thread).  After
  // LocalReduceScatter local rank r owns fully reduced segment
  // (r+1) % local_size; LocalAllgather redistributes the reduced
  // segments.  `bytes_moved` accumulates this rank's sent wire bytes.
  bool LocalReduceScatter(char* data, int64_t n, uint8_t dtype,
                          uint8_t wire, int64_t* bytes_moved,
                          std::string* err);
  bool LocalAllgather(char* data, int64_t n, uint8_t dtype, uint8_t wire,
                      int64_t* bytes_moved, std::string* err);
  // One chunk's cross-node hop over this rank's shard (helper thread):
  // ring (RingAllreduceOn / RingAllreduceWire over the cross fds) or
  // recursive-doubling tree over the XOR-partner fds.
  bool CrossShardAllreduce(char* seg, int64_t n, uint8_t dtype,
                           uint8_t wire, bool use_tree,
                           int64_t* bytes_moved, std::string* err);
  bool CrossTreeAllreduce(char* seg, int64_t n, uint8_t dtype,
                          uint8_t wire, std::string* err);
  // Wake every peer blocked on this rank's topology sockets (local ring,
  // cross ring, tree partners) and mark them unusable: a mid-collective
  // failure must fail fast everywhere instead of stalling peers to the
  // 30s exchange timeout.  Close happens after helper threads joined.
  void ShutdownTopologyFds();
  void CloseTopologyFds();
  bool RingAllgather(char* buf, const std::vector<int64_t>& block_bytes,
                     std::string* err);
  bool RingBroadcast(void* buf, int64_t nbytes, int root, std::string* err);

  EngineOptions opts_;
  std::atomic<bool> initialized_{false};
  std::atomic<bool> shut_down_{false};
  // Latched on the first data-plane transport failure (ring or
  // hierarchical): a broken fabric must fail *every* subsequent
  // collective uniformly, not leave a half-functional job where
  // allreduce errors but broadcast/allgather still succeed.
  std::atomic<bool> data_plane_failed_{false};
  std::atomic<bool> loop_exited_{false};
  std::thread background_;

  std::mutex mu_;  // guards queue_, table_, handles_ map shape
  std::deque<Request> queue_;
  // Wakes the engine thread's steady-state idle wait the moment work
  // arrives: with the control plane dark there is no frame round trip
  // pacing the loop, and a blind poll cadence would either burn CPU
  // (hundreds of simulated ranks in one process) or add its period to
  // every replay cycle's latency.
  std::condition_variable queue_cv_;
  std::unordered_map<std::string, TableEntry> table_;

  std::mutex handles_mu_;
  std::unordered_map<int64_t, std::shared_ptr<HandleStatus>> handles_;
  std::atomic<int64_t> next_handle_{0};
  std::atomic<int64_t> completions_{0};  // CompleteEntry stamp counter
  std::atomic<int64_t> ticks_done_{0};   // processed response lists

  // Sockets.
  int coord_listen_fd_ = -1;                 // rank 0
  std::vector<int> coord_fds_;               // rank 0: fd per worker rank
  int coord_fd_ = -1;                        // workers: fd to rank 0
  // Control-plane coordinator tree (docs/performance.md
  // #control-plane-scaling).  Built by SetupSockets after the job-wide
  // layout agreement: non-lead workers of nodes >= 1 re-home their
  // control socket from rank 0 to their node's local-rank-0
  // (sub-coordinator), which accepted them over its DATA listener with a
  // typed hello — no extra endpoints.  Rank 0 keeps sockets only for its
  // own node's workers plus one per sub-coordinator.
  bool tree_enabled_ = false;   // this job agreed on the two-level tree
  bool is_sub_coord_ = false;   // local_rank 0 of a node >= 1
  std::vector<int> tree_child_fds_;    // sub: fd per local worker (1..L-1)
  std::vector<int> tree_child_ranks_;  // global rank per child fd
  std::vector<bool> tree_child_dead_;
  std::vector<int> coord_children_;    // rank 0: global ranks it reads
  // Sub-coordinator relay bookkeeping: deaths observed but not yet
  // forwarded, and whether this sub is in the steady/holding relay mode
  // (between its own steady exit and the next parent broadcast).
  std::vector<int32_t> pending_dead_reports_;
  bool sub_holding_ = false;

  // Decentralized steady state (engine-thread state unless atomic).
  std::atomic<bool> steady_active_{false};
  std::vector<uint32_t> steady_pattern_;
  std::vector<uint32_t> steady_groups_;   // per-replay-group sizes
  size_t steady_pos_ = 0;                 // next expected pattern index
  size_t steady_group_idx_ = 0;           // current group
  int64_t steady_epoch_ = 0;              // completed cycles this window
  std::vector<uint32_t> steady_pending_group_;  // drained, not yet replayed
  std::vector<Request> steady_pending_reqs_;    // their Requests (for requeue)
  std::chrono::steady_clock::time_point steady_group_wait_{};
  bool steady_exit_pending_ = false;  // next frame carries the exit flag
  int steady_idle_passes_ = 0;        // backoff state for the idle wait
  // Last control-socket duty pass: the duty rides the idle cadence, but
  // a pipeline that keeps the queue non-empty on every pass must still
  // see abort/shutdown frames within a bounded interval.
  std::chrono::steady_clock::time_point steady_last_poll_{};
  int64_t steady_exit_epoch_ = 0;
  int64_t steady_exit_pos_ = 0;
  // Control-plane metrics (process-cumulative, like StallEvents; the
  // atomics are read live by Python API threads).
  std::atomic<int> ctrl_children_{0};
  std::atomic<int> ctrl_hosts_{1};
  std::atomic<int64_t> ctrl_frames_sent_{0};
  std::atomic<int64_t> ctrl_frames_recv_{0};
  std::atomic<int64_t> steady_entries_{0};
  std::atomic<int64_t> steady_exits_{0};
  std::atomic<int64_t> steady_replays_{0};
  std::atomic<int64_t> steady_cycles_{0};
  std::atomic<int64_t> steady_pattern_len_{0};
  std::atomic<int64_t> negotiated_ticks_{0};
  int data_listen_fd_ = -1;
  int left_fd_ = -1, right_fd_ = -1;         // ring neighbours
  // Two-level topology (only when opts_.hierarchical_allreduce):
  int node_id_ = 0;                          // rank / local_size
  int n_nodes_ = 1;                          // size / local_size
  int local_left_fd_ = -1, local_right_fd_ = -1;  // node-local ring
  // EVERY local rank's own cross-node ring over its same-local-rank
  // peers (node±1, same local_rank) — local_size parallel DCN streams
  // instead of one leader NIC.
  int cross_left_fd_ = -1, cross_right_fd_ = -1;
  // Recursive-doubling partners for the tree exchange: fd per XOR level
  // (peer node = node_id ^ (1 << k)).  Built only when n_nodes is a
  // power of two; empty otherwise (tree requests fall back to the ring).
  std::vector<int> cross_tree_fds_;

  // Pluggable transport seam (docs/performance.md#transport).  Channels
  // wrap the fds above; the node-local pair additionally carries shm
  // rings when the segment armed.  shm_mode_/shm_ring_bytes_ come from
  // HVD_TPU_SHM / HVD_TPU_SHM_RING_BYTES; shm_agreed_ is the job-wide
  // init-agreement verdict (every rank must request the same mode, and
  // the topology must be two-level + non-elastic); shm_active_ is the
  // post-rendezvous truth for THIS node's ring.  topo_shm_ mirrors it
  // for lock-free TopologyInfo reads.
  ShmMode shm_mode_ = ShmMode::kAuto;
  int64_t shm_ring_bytes_ = 1 << 20;
  bool shm_agreed_ = false;
  bool shm_active_ = false;
  std::atomic<bool> topo_shm_{false};
  ShmSegment shm_seg_;
  Channel left_ch_, right_ch_;              // flat/global ring
  Channel local_left_ch_, local_right_ch_;  // node-local ring (shm-capable)
  Channel cross_left_ch_, cross_right_ch_;  // cross-node shard ring

  // Point-to-point plane (docs/pipeline.md).  Dedicated lazy channels to
  // non-neighbour peers, keyed by peer rank; engine thread only.  The
  // counters are process-cumulative (StallEvents contract) except the
  // matched/unmatched gauges, which Python reads live.
  std::unordered_map<int, Channel> p2p_chans_;
  std::atomic<int64_t> p2p_sends_{0};
  std::atomic<int64_t> p2p_recvs_{0};
  std::atomic<int64_t> p2p_bytes_out_{0};
  std::atomic<int64_t> p2p_bytes_in_{0};
  std::atomic<int64_t> p2p_matched_{0};
  std::atomic<int64_t> p2p_group_ops_{0};
  // Open dedicated-channel gauge (p2p_chans_ is engine-thread-only; the
  // Python metrics reader sees this atomic mirror instead).
  std::atomic<int64_t> p2p_channels_{0};

  // Data-plane heartbeat detector state.  The beat fds ride the data
  // listener (typed hello kind 6) to this rank's ring neighbours: rank r
  // dials (r+1)%size (beat_out_fd_) and accepts (r-1+size)%size
  // (beat_in_fd_); both sockets are full-duplex, so the monitor beats on
  // and watches BOTH.  hb_mu_ guards every non-atomic field below — the
  // monitor thread copies the fds/epoch under it each pass, the engine
  // thread swaps them there at a reshape (old fds are shut down, parked
  // in hb_graveyard_, and closed by the MONITOR on its next pass: the
  // fd numbers stay allocated until the only thread that might still
  // poll them has moved on).
  std::mutex hb_mu_;
  int beat_in_fd_ = -1, beat_out_fd_ = -1;
  int beat_in_peer_ = -1, beat_out_peer_ = -1;
  int64_t hb_epoch_ = 0;  // beats carry it; stale-epoch beats are ignored
  std::vector<int> hb_graveyard_;
  // Monitor-observed liveness per monitored peer rank: last-seen stamp
  // (µs on the engine epoch clock; 0 = never) and consecutive misses.
  std::unordered_map<int, int64_t> hb_last_seen_us_;
  std::unordered_map<int, int> hb_miss_counts_;
  // Monitor -> engine-thread escalation queues (hb_mu_):
  std::vector<int> pending_hb_dead_;    // rank 0: MarkRankDead these
  std::vector<int> pending_hb_report_;  // workers: hb_report these up
  // Data-plane fds the monitor may ShutdownFd when it flags a peer, so a
  // survivor blocked in a ring Exchange with the frozen rank wakes in
  // O(heartbeat) instead of hanging.  Engine-maintained under hb_mu_ and
  // CLEARED there before any CloseFd of a listed fd, so the monitor can
  // never shut down a recycled fd number.  hb_ctrl_wake_fd_ is this
  // rank's coordinator/parent control fd, shut down only at the
  // local-abort escalation (the engine is then parked in a parent wait
  // that must break before it can surface the typed verdict).
  std::vector<int> hb_wake_fds_;
  // Shm analogue of the wake registry: when the node segment is armed
  // the monitor also closes its rings (CloseRings) so a survivor blocked
  // in a shm drive loop wakes as fast as one blocked in a socket.
  // Cleared (under hb_mu_) before the segment is unmapped.
  ShmSegment* hb_wake_shm_ = nullptr;
  int hb_ctrl_wake_fd_ = -1;
  std::string hb_local_abort_msg_;
  std::atomic<bool> hb_local_abort_{false};
  std::atomic<bool> hb_stop_{false};
  std::thread hb_thread_;
  int hb_interval_ms_ = 0;  // 0 = detector off (env HVD_TPU_HEARTBEAT_MS)
  int hb_miss_limit_ = 10;  // env HVD_TPU_HEARTBEAT_MISS
  // Process-cumulative liveness counters (StallEvents contract).
  std::atomic<int64_t> hb_sent_{0};
  std::atomic<int64_t> hb_recv_{0};
  std::atomic<int64_t> hb_miss_events_{0};
  std::atomic<int64_t> hb_evictions_{0};
  // Rank 0: clock-sync probe fan-in of the last Init (number of peers
  // rank 0 probed directly — O(hosts) under the tree relay, O(ranks)
  // in the flat star).
  std::atomic<int64_t> clock_fanin_{0};

  // Online anomaly detector (docs/metrics.md#anomalies).  Sweep state
  // (windows, baselines) lives as AnomalyLoop locals — single-threaded,
  // no locking; only the verdict surface below is shared.  Verdict
  // counts are process-cumulative (StallEvents contract); the log is
  // bounded at 64 entries so an unread registry cannot grow it.
  std::thread anomaly_thread_;
  std::atomic<bool> anomaly_stop_{false};
  int anomaly_sigma_ = 5;         // env HVD_TPU_ANOMALY_SIGMA; 0 = off
  int anomaly_interval_ms_ = 500; // env HVD_TPU_ANOMALY_INTERVAL_MS
  struct AnomalyVerdict {
    int64_t ts_us;
    int kind;  // index into kAnomalyKinds
    std::string subject;
    std::string detail;
  };
  mutable std::mutex anomaly_mu_;
  std::deque<AnomalyVerdict> anomaly_log_;
  int64_t anomaly_counts_[4] = {0, 0, 0, 0};

  // Fusion buffer (lazily grown; analogue of the reference's persistent
  // fusion buffer, operations.cc:696-749).
  std::vector<char> fusion_buffer_;

  std::unique_ptr<Coordinator> coord_;
  uint8_t last_fused_dtype_ = 255;  // dtype of the current fusion group
  Timeline timeline_;
  FlightRecorder flight_;
  std::chrono::steady_clock::time_point last_stall_check_;

  // Coordinator waiting-on snapshot for CoordPendingInfo: rebuilt by the
  // engine thread each tick the coordinator tables are non-empty (the
  // tables themselves are engine-thread-only), read by API threads.
  std::mutex coord_info_mu_;
  std::string coord_pending_info_;
  // Rank 0: refresh coord_pending_info_ from message_table/cache_pending
  // (engine thread only; cheap — negotiations normally resolve within a
  // tick, so the tables are almost always empty).
  void UpdateCoordPendingInfo();
  // Rank 0, engine thread: the cross-rank diagnosis paragraph for the
  // stalled/dead ranks in `missing`, built from the coordinator's
  // per-rank last-announce / last-frame accounting.
  std::string BuildDiagnosis(const std::vector<int>& missing);

  // Negotiation response cache.  Engine-thread only: mutated while
  // processing response lists, read at queue drain; contents reset at
  // Init (restart epochs start cold) and cleared on coordinated abort.
  // The hit/miss/eviction counters are process-cumulative for metrics.
  ResponseCache cache_;
  std::atomic<int64_t> cache_hits_{0};
  std::atomic<int64_t> cache_misses_{0};
  std::atomic<int64_t> cache_evictions_{0};
  std::atomic<int64_t> cache_size_{0};

  // Adaptive tick (docs/performance.md): consecutive progress-less ticks
  // with work still outstanding — bounds how long the loop runs at full
  // speed before falling back to the HVD_TPU_CYCLE_TIME_MS idle cadence.
  int fast_ticks_ = 0;
  // Fusion-buffer reclamation: last time ExecuteAllreduce staged through
  // fusion_buffer_; after a sustained idle stretch the buffer (which only
  // ever grew before) is released back to the allocator.
  std::chrono::steady_clock::time_point last_fusion_use_{};

  // Stall log: one entry per (stalled tensor, sweep) warning, bounded so a
  // permanently wedged job cannot grow it; the counter is cumulative for
  // the process (survives engine re-init, matching the Python side's
  // consumed-events bookkeeping).
  std::mutex stall_mu_;
  int64_t stall_events_ = 0;
  std::deque<std::pair<std::string, double>> stall_log_;

  // Coordinated-abort state.  code is latched once per engine lifetime
  // (first abort wins); events_ is process-cumulative for metrics.
  std::atomic<int32_t> abort_code_{0};
  std::atomic<int64_t> abort_events_{0};
  std::mutex abort_mu_;  // guards abort_message_, abort_pending_info_
  std::string abort_message_;
  // Pending table frozen at the abort (the BackgroundLoop drain clears
  // table_ right after, but the postmortem dump must still say which
  // collectives were in flight when the job died).
  std::string abort_pending_info_;
  // The live table_ serialization PendingInfo() falls back from.
  std::string LivePendingInfo();

  // Clock alignment: the engine's ts epoch (set at Init, shared with the
  // timeline) and this rank's measured offset/RTT against rank 0.
  std::chrono::steady_clock::time_point epoch_{};
  std::atomic<int64_t> clock_offset_us_{0};
  std::atomic<int64_t> clock_rtt_us_{0};

  // Elastic membership (docs/fault-tolerance.md#elastic-membership).
  // cur_rank_/cur_size_ mirror opts_ for lock-free reads from Python API
  // threads (rank()/size() must re-resolve after a reshape).  The epoch
  // counts reshapes this engine lifetime; reshape/lost/joined totals are
  // process-cumulative for metrics.  reshape_ack_pending_ poisons fresh
  // enqueues with the retryable status until Python acknowledges the new
  // membership (hvd.run_elastic's resync calls MembershipAck first).
  std::atomic<int> cur_rank_{0};
  std::atomic<int> cur_size_{1};
  std::atomic<int> cur_local_rank_{0};
  std::atomic<int> cur_local_size_{1};
  std::atomic<int64_t> membership_epoch_{0};
  std::atomic<int64_t> reshapes_total_{0};
  std::atomic<bool> reshape_ack_pending_{false};
  std::mutex membership_mu_;  // guards the lists + reshape_message_
  std::vector<int32_t> ranks_lost_;    // cumulative, epoch-local numbering
  std::vector<int32_t> ranks_joined_;  // cumulative, new dense ranks
  std::string reshape_message_;    // the retryable status message

  // Online autotuning.  The tuner lives at the coordinator (rank 0 /
  // single-process); the applied-parameter state below is per-rank,
  // driven by the lockstep broadcasts.  cur_* mirror opts_ values for
  // lock-free reads from Python API threads (opts_ itself is engine-
  // thread-only once the loop runs).
  ParameterManager tuner_;
  std::atomic<int64_t> cur_fusion_{0};
  std::atomic<int64_t> cur_cycle_us_{0};
  std::atomic<int64_t> cur_cross_algo_{0};
  std::atomic<bool> autotune_frozen_{false};
  std::atomic<int64_t> applied_window_{0};
  std::mutex autotune_mu_;  // guards applied_log_, *_history_
  std::deque<std::string> applied_log_;  // "tick|fusion|cycle_us|comp|frozen"
  // (first_effective_tick, fusion_threshold) change points, appended in
  // tick order and BOUNDED (oldest change points collapse into the
  // floor entry — the plane only ever queries recently closed ticks);
  // FusionThresholdAt walks this short log linearly.
  std::deque<std::pair<int64_t, int64_t>> fusion_history_;
  // Same change-point log for the wire-compression mode, serving the XLA
  // plane's per-tick lockstep lookup (CompressionModeAt).
  std::deque<std::pair<int64_t, int64_t>> compression_history_;

  // Wire compression (docs/performance.md#wire-compression).
  // cur_compression_ mirrors opts_.compression_mode for lock-free reads
  // from Python API threads; residuals_ holds the per-tensor fp32
  // error-feedback buffers (engine thread only; the quantization error of
  // each step feeds the next step's pre-compression add).  Cleared at
  // Init, on reshape (the membership — and with it every sum — changed),
  // and bounded so a stream of never-repeating auto-named tensors cannot
  // grow it forever.  Byte/op counters are process-cumulative; the
  // residual gauges mirror the map for the metrics registry.
  std::atomic<int64_t> cur_compression_{COMP_NONE};
  // Mirrors opts_.compression_min_bytes for lock-free reads from Python
  // API threads (CompressionInfo): reshape/rejoin mutate opts_ on the
  // engine thread mid-run.
  std::atomic<int64_t> cur_comp_min_bytes_{0};
  std::unordered_map<std::string, std::vector<float>> residuals_;
  std::atomic<int64_t> comp_wire_bytes_{0};
  std::atomic<int64_t> comp_payload_bytes_{0};
  std::atomic<int64_t> comp_ops_none_{0};
  std::atomic<int64_t> comp_ops_bf16_{0};
  std::atomic<int64_t> comp_ops_fp8_{0};
  std::atomic<int64_t> residual_bytes_{0};
  std::atomic<int64_t> residual_tensors_{0};
  std::mutex comp_mu_;  // guards comp_log_
  std::deque<std::string> comp_log_;  // "first_name|mode", bounded

  // Two-level topology accounting (docs/performance.md
  // #two-level-topology).  Byte/op counters are process-cumulative (the
  // metrics contract StallEvents set); the per-bucket phase log is
  // bounded, with topo_log_total_ letting the Python sync delta-consume
  // it into the phase histograms.  topo_last_algo_ (-1 = none yet)
  // detects ring<->tree switches for the flight recorder.
  // Atomic mirrors of the topology shape for lock-free API-thread reads
  // (TopologyInfo): node_id_/n_nodes_/opts_.hierarchical_allreduce are
  // engine-thread state that RebuildRing resets at a reshape while
  // Python metric pollers snapshot concurrently (the opts_ mirror
  // pattern; a TSan-confirmed race before these existed).
  std::atomic<bool> topo_hier_{false};
  std::atomic<int> topo_nodes_{1};
  std::atomic<int64_t> topo_ops_ring_{0};
  std::atomic<int64_t> topo_ops_tree_{0};
  std::atomic<int64_t> topo_local_bytes_{0};
  std::atomic<int64_t> topo_cross_bytes_{0};
  std::atomic<int> topo_last_algo_{-1};
  // Cumulative per-phase time sums + timed-op count (process-cumulative):
  // the anomaly detector's per-phase input — sweep deltas give a mean
  // phase time per interval without parsing the bounded log.
  std::atomic<int64_t> topo_rs_us_{0};
  std::atomic<int64_t> topo_cross_us_{0};
  std::atomic<int64_t> topo_ag_us_{0};
  std::atomic<int64_t> topo_timed_ops_{0};
  std::mutex topo_mu_;  // guards topo_log_, topo_log_total_
  std::deque<std::string> topo_log_;  // "name|algo|rs_us|cross_us|ag_us"
  int64_t topo_log_total_ = 0;
  // One per-bucket record for log + histograms (any thread).
  void RecordTopologyOp(const std::string& name, bool tree,
                        int64_t local_rs_us, int64_t cross_us,
                        int64_t local_ag_us);

  // Announce-order accounting (rank 0).  Counts are process-cumulative;
  // the log is bounded so an unconsumed Python side cannot grow it.
  std::mutex announce_mu_;
  int64_t announce_events_ = 0;
  std::vector<int64_t> last_announce_counts_;
  std::deque<std::pair<int, int64_t>> announce_log_;
};

Engine* GlobalEngine();

}  // namespace hvdtpu
