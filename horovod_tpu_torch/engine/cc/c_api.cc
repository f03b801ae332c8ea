// C API exported to Python over ctypes.  Counterpart of the reference's
// extern "C" block (Horovod's horovod/common/operations.cc:1731-1813)
// plus the torch handle API (Horovod's horovod/torch/interface.h:16-75),
// unified: every framework binding (numpy/jax-eager/tf-eager/torch) talks to
// the engine through these same dozen functions.
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "engine.h"
#include "simscale.h"

using hvdtpu::Engine;
using hvdtpu::EngineOptions;
using hvdtpu::GlobalEngine;

namespace {
std::mutex g_err_mu;
std::string g_init_error;
thread_local std::string tl_error;

std::vector<std::string> SplitCommas(const char* s) {
  std::vector<std::string> out;
  if (!s) return out;
  std::string cur;
  for (const char* p = s; *p; ++p) {
    if (*p == ',') {
      if (!cur.empty()) out.push_back(cur);
      cur.clear();
    } else {
      cur += *p;
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return out;
}
}  // namespace

extern "C" {

int hvd_tpu_init(int rank, int size, int local_rank, int local_size,
                 const char* coord_endpoint, const char* data_endpoints,
                 double cycle_time_ms, long long fusion_threshold,
                 double stall_warning_sec, const char* timeline_path,
                 int hierarchical_allreduce, double collective_timeout_sec,
                 long long cache_capacity, int autotune,
                 long long autotune_warmup, long long autotune_window,
                 long long autotune_fix_fusion,
                 double autotune_fix_cycle_ms, int elastic,
                 long long min_size, int rejoin, int compression_mode,
                 long long compression_min_bytes,
                 long long autotune_fix_compression,
                 long long cross_algo_threshold,
                 long long autotune_fix_cross_algo, int coord_tree,
                 long long steady_threshold, long long steady_max_period) {
  EngineOptions opts;
  opts.rank = rank;
  opts.size = size;
  opts.local_rank = local_rank;
  opts.local_size = local_size;
  opts.coord_endpoint = coord_endpoint ? coord_endpoint : "";
  opts.data_endpoints = SplitCommas(data_endpoints);
  opts.cycle_time_ms = cycle_time_ms;
  opts.fusion_threshold = fusion_threshold;
  opts.stall_warning_sec = stall_warning_sec;
  opts.timeline_path = timeline_path ? timeline_path : "";
  opts.hierarchical_allreduce = hierarchical_allreduce != 0;
  opts.collective_timeout_sec = collective_timeout_sec;
  opts.cache_capacity = cache_capacity;
  opts.autotune = autotune != 0;
  opts.autotune_warmup = autotune_warmup;
  opts.autotune_window = autotune_window;
  opts.autotune_fix_fusion = autotune_fix_fusion;
  opts.autotune_fix_cycle_ms = autotune_fix_cycle_ms;
  opts.elastic = elastic != 0;
  opts.min_size = min_size > 0 ? min_size : 1;
  opts.rejoin = rejoin != 0;
  opts.compression_mode = static_cast<uint8_t>(compression_mode);
  opts.compression_min_bytes =
      compression_min_bytes >= 0 ? compression_min_bytes : 0;
  opts.autotune_fix_compression = autotune_fix_compression;
  opts.cross_algo_threshold =
      cross_algo_threshold >= 0 ? cross_algo_threshold : 64 * 1024;
  opts.autotune_fix_cross_algo = autotune_fix_cross_algo;
  opts.coord_tree = coord_tree != 0;
  opts.steady_threshold = steady_threshold >= 0 ? steady_threshold : 0;
  opts.steady_max_period =
      steady_max_period > 0 ? steady_max_period : 256;
  std::string err;
  int rc = GlobalEngine()->Init(opts, &err);
  if (rc != 0) {
    std::lock_guard<std::mutex> lk(g_err_mu);
    g_init_error = err;
  }
  return rc;
}

const char* hvd_tpu_init_error() {
  std::lock_guard<std::mutex> lk(g_err_mu);
  return g_init_error.c_str();
}

void hvd_tpu_shutdown() { GlobalEngine()->Shutdown(); }

int hvd_tpu_initialized() { return GlobalEngine()->Initialized() ? 1 : 0; }
int hvd_tpu_rank() {
  return GlobalEngine()->Initialized() ? GlobalEngine()->rank() : -1;
}
int hvd_tpu_size() {
  return GlobalEngine()->Initialized() ? GlobalEngine()->size() : -1;
}
int hvd_tpu_local_rank() {
  return GlobalEngine()->Initialized() ? GlobalEngine()->local_rank() : -1;
}
int hvd_tpu_local_size() {
  return GlobalEngine()->Initialized() ? GlobalEngine()->local_size() : -1;
}

// op: 0=allreduce 1=allgather 2=broadcast; dtype: see wire.h DataType.
// Returns handle >= 0, or -1 if the engine is not running.
long long hvd_tpu_enqueue(int op, const char* name, const void* in, void* out,
                          const long long* dims, int ndim, int dtype,
                          int root_rank, int average) {
  std::vector<int64_t> d(dims, dims + ndim);
  return GlobalEngine()->Enqueue(static_cast<uint8_t>(op), name ? name : "",
                                 in, out, d, static_cast<uint8_t>(dtype),
                                 root_rank, average != 0);
}

// Point-to-point plane (docs/pipeline.md).  op: 4=send 5=recv; `peer` is
// the counterpart rank, `tag` disambiguates concurrent transfers between
// the same pair (it suffixes the negotiated name on the Python side).
// Precondition failures (self-send, peer out of range) ride the returned
// handle as a typed ST_PRECONDITION error.
long long hvd_tpu_enqueue_p2p(int op, const char* name, const void* in,
                              void* out, const long long* dims, int ndim,
                              int dtype, int peer, int tag) {
  std::vector<int64_t> d(dims, dims + ndim);
  return GlobalEngine()->Enqueue(static_cast<uint8_t>(op), name ? name : "",
                                 in, out, d, static_cast<uint8_t>(dtype), -1,
                                 false, peer, tag);
}

// Stage-scoped allreduce: `ranks` (ascending, nranks of them, this rank
// among them) restricts the reduction to a stage group's membership —
// the data-parallel reduction inside one pipeline stage.
long long hvd_tpu_enqueue_group(const char* name, const void* in, void* out,
                                const long long* dims, int ndim, int dtype,
                                int average, const long long* ranks,
                                int nranks) {
  std::vector<int64_t> d(dims, dims + ndim);
  std::vector<int32_t> members;
  members.reserve(nranks > 0 ? nranks : 0);
  for (int i = 0; i < nranks; ++i)
    members.push_back(static_cast<int32_t>(ranks[i]));
  return GlobalEngine()->Enqueue(hvdtpu::OP_ALLREDUCE, name ? name : "", in,
                                 out, d, static_cast<uint8_t>(dtype), -1,
                                 average != 0, -1, 0, members);
}

// "sends|recvs|bytes_out|bytes_in|matched|unmatched|group_ops|channels"
// (docs/metrics.md#p2p).
const char* hvd_tpu_p2p_info() {
  static thread_local std::string tl_p2p_info;
  tl_p2p_info = GlobalEngine()->P2pInfo();
  return tl_p2p_info.c_str();
}

int hvd_tpu_poll(long long handle) {
  return GlobalEngine()->Poll(handle);
}

int hvd_tpu_wait(long long handle) {
  return GlobalEngine()->Wait(handle);
}

int hvd_tpu_status(long long handle) {
  return GlobalEngine()->StatusOf(handle, nullptr);
}

const char* hvd_tpu_error(long long handle) {
  GlobalEngine()->StatusOf(handle, &tl_error);
  return tl_error.c_str();
}

// Completion-order stamps for the XLA data plane's dispatch agreement.
// -1 while the handle is pending or unknown.
long long hvd_tpu_completion_seq(long long handle) {
  return GlobalEngine()->CompletionSeq(handle);
}

long long hvd_tpu_completion_tick(long long handle) {
  return GlobalEngine()->CompletionTick(handle);
}

// Negotiation latency (µs, enqueue -> agreed response arriving at this
// rank) for a finished handle; -1 while pending / unknown / failed before
// negotiation.  Feeds the negotiation_sec histogram for the engine data
// plane (docs/metrics.md).
long long hvd_tpu_negotiation_us(long long handle) {
  return GlobalEngine()->NegotiationUs(handle);
}

long long hvd_tpu_ticks_done() { return GlobalEngine()->TicksDone(); }

long long hvd_tpu_result_nbytes(long long handle) {
  return GlobalEngine()->ResultBytes(handle);
}

long long hvd_tpu_result_dim0(long long handle) {
  return GlobalEngine()->ResultDim0(handle);
}

int hvd_tpu_copy_result(long long handle, void* dst, long long nbytes) {
  return GlobalEngine()->CopyResult(handle, dst, nbytes) ? 0 : 1;
}

// Zero-copy view of a completed allgather's engine-owned result; valid
// until hvd_tpu_release(handle).  NULL while pending or for empty results.
void* hvd_tpu_result_ptr(long long handle) {
  return GlobalEngine()->ResultPtr(handle);
}

void hvd_tpu_release(long long handle) { GlobalEngine()->Release(handle); }

// Stall observability for the Python metrics registry: cumulative count
// of (tensor, sweep) stall warnings from the rank-0 coordinator sweep,
// plus a bounded "name|seconds;..." log of the most recent ones.
long long hvd_tpu_stall_count() { return GlobalEngine()->StallEvents(); }

const char* hvd_tpu_stall_info() {
  static thread_local std::string tl_stall_info;
  tl_stall_info = GlobalEngine()->StallInfo();
  return tl_stall_info.c_str();
}

// Coordinated-abort observability (docs/fault-tolerance.md): the latched
// abort status of this engine (0 = never aborted; ST_RANKS_DOWN=6 /
// ST_TIMEOUT=7 otherwise) with its structured message, and the
// process-cumulative abort-event count for the metrics registry.
int hvd_tpu_abort_code() { return GlobalEngine()->AbortCode(); }

const char* hvd_tpu_abort_message() {
  static thread_local std::string tl_abort_message;
  tl_abort_message = GlobalEngine()->AbortMessage();
  return tl_abort_message.c_str();
}

long long hvd_tpu_abort_count() { return GlobalEngine()->AbortEvents(); }

// Response-cache observability (docs/performance.md): process-cumulative
// hit/miss/eviction counts (survive re-init, like stalls) plus the
// current entry count of this engine's cache.
long long hvd_tpu_cache_hit_count() { return GlobalEngine()->CacheHits(); }

long long hvd_tpu_cache_miss_count() {
  return GlobalEngine()->CacheMisses();
}

long long hvd_tpu_cache_eviction_count() {
  return GlobalEngine()->CacheEvictions();
}

long long hvd_tpu_cache_size() { return GlobalEngine()->CacheSize(); }

// Postmortem plane (docs/troubleshooting.md#reading-a-postmortem).
// Flight recorder: process-cumulative event count for the metrics
// registry, and a non-destructive ring snapshot
// ("seq|ts_us|event|name|arg;...", oldest first) for the dump writer.
long long hvd_tpu_flight_count() {
  return GlobalEngine()->flight().Events();
}

const char* hvd_tpu_flight_dump() {
  static thread_local std::string tl_flight_dump;
  tl_flight_dump = GlobalEngine()->flight().Dump();
  return tl_flight_dump.c_str();
}

// Pending-tensor tables: this rank's in-flight collectives
// ("name|op|age_us;...") and — on rank 0 — the coordinator's waiting-on
// snapshot ("name|age_us|missing_rank missing_rank;...").
const char* hvd_tpu_pending_info() {
  static thread_local std::string tl_pending_info;
  tl_pending_info = GlobalEngine()->PendingInfo();
  return tl_pending_info.c_str();
}

const char* hvd_tpu_coord_pending_info() {
  static thread_local std::string tl_coord_pending;
  tl_coord_pending = GlobalEngine()->CoordPendingInfo();
  return tl_coord_pending.c_str();
}

// The cross-rank diagnosis paragraph the coordinator folded into the
// broadcast abort message (empty before an abort, or when the abort
// carried none).
const char* hvd_tpu_diagnosis() {
  static thread_local std::string tl_diagnosis;
  tl_diagnosis = GlobalEngine()->Diagnosis();
  return tl_diagnosis.c_str();
}

// Cross-rank clock alignment (docs/timeline.md): this rank's estimated
// clock offset against rank 0 (µs) and the RTT error bound of the winning
// NTP-style probe.  0 on rank 0 / single-process jobs.
long long hvd_tpu_clock_offset_us() {
  return GlobalEngine()->ClockOffsetUs();
}

long long hvd_tpu_clock_rtt_us() { return GlobalEngine()->ClockRttUs(); }

// Data-plane liveness (docs/fault-tolerance.md#failure-detection):
// "interval_ms|miss_limit|sent|recv|miss_events|evictions|clock_fanin|"
// followed by space-separated "peer:last_seen_age_us:misses" entries for
// the directly monitored beacon neighbours.  interval_ms 0 = detector
// disabled.
const char* hvd_tpu_liveness_info() {
  static thread_local std::string tl_liveness;
  tl_liveness = GlobalEngine()->LivenessInfo();
  return tl_liveness.c_str();
}

// Per-peer link telemetry (docs/metrics.md#links): "enabled|" then
// semicolon-separated
// "peer:bytes_out:bytes_in:sends:recvs:stalls:short_writes:send_us_sum:
//  send_us_count:b0,..,b9:rtt_last_us:rtt_ewma_us:rtt_samples" entries.
// rtt_last_us is -1 until the first heartbeat echo lands.
const char* hvd_tpu_link_info() {
  static thread_local std::string tl_link;
  tl_link = GlobalEngine()->LinkInfo();
  return tl_link.c_str();
}

// Anomaly detector config + cumulative verdict counts:
// "sigma|interval_ms|slow_link|straggler|cache_degraded|slow_phase".
// sigma 0 = detector disabled.
const char* hvd_tpu_anomaly_info() {
  static thread_local std::string tl_anomaly;
  tl_anomaly = GlobalEngine()->AnomalyInfo();
  return tl_anomaly.c_str();
}

// Bounded verdict log, oldest first: "kind|subject|detail|age_us;..."
// (separators sanitized out of subject/detail).
const char* hvd_tpu_anomaly_log() {
  static thread_local std::string tl_anomaly_log;
  tl_anomaly_log = GlobalEngine()->AnomalyLog();
  return tl_anomaly_log.c_str();
}

// Announce-order observability for the Python metrics registry (straggler
// attribution, rank-0 coordinator view): cumulative negotiation count, a
// bounded log of the most recent ones as
// "cumulative_count:last_rank|skew_us;..." (count and entries serialized
// atomically), and exact per-rank last-to-announce counts as "n0,n1,...".
long long hvd_tpu_announce_count() { return GlobalEngine()->AnnounceEvents(); }

const char* hvd_tpu_announce_log() {
  static thread_local std::string tl_announce_log;
  tl_announce_log = GlobalEngine()->AnnounceLog();
  return tl_announce_log.c_str();
}

const char* hvd_tpu_last_announce_counts() {
  static thread_local std::string tl_last_announce;
  tl_last_announce = GlobalEngine()->LastAnnounceCounts();
  return tl_last_announce.c_str();
}

// Online-autotuning observability and control (docs/performance.md
// #autotuning).  The applied parameters come from lockstep broadcasts, so
// they agree across the ranks of a healthy job; history/best-score are
// coordinator-side (rank 0).
int hvd_tpu_autotune_enabled() {
  return GlobalEngine()->AutotuneEnabled() ? 1 : 0;
}

int hvd_tpu_autotune_frozen() {
  return GlobalEngine()->AutotuneFrozen() ? 1 : 0;
}

long long hvd_tpu_autotune_windows() {
  return GlobalEngine()->AutotuneWindows();
}

long long hvd_tpu_autotune_fusion_threshold() {
  return GlobalEngine()->CurrentFusionThreshold();
}

long long hvd_tpu_autotune_cycle_time_us() {
  return GlobalEngine()->CurrentCycleTimeUs();
}

double hvd_tpu_autotune_best_score() {
  return GlobalEngine()->AutotuneBestScore();
}

// Rank-0 per-window search history, "window|fusion|cycle_us|score;...".
const char* hvd_tpu_autotune_history() {
  static thread_local std::string tl_autotune_history;
  tl_autotune_history = GlobalEngine()->AutotuneHistory();
  return tl_autotune_history.c_str();
}

// Per-rank applied-parameter log, "tick|fusion|cycle_us|frozen;..." —
// identical on every rank (the lockstep determinism contract).
const char* hvd_tpu_autotune_applied() {
  static thread_local std::string tl_autotune_applied;
  tl_autotune_applied = GlobalEngine()->AutotuneApplied();
  return tl_autotune_applied.c_str();
}

// Manual parameter injection (hvd.autotune_set; the pluggable-policy
// seam): broadcast fusion/cycle/compression/cross-algo (< 0 keeps the
// current value) at the next tick.  0 ok, 1 not-the-coordinator, 2
// uninitialized.
int hvd_tpu_autotune_set(long long fusion_threshold, double cycle_time_ms,
                         long long compression,
                         long long cross_algo_threshold) {
  return GlobalEngine()->AutotuneInject(fusion_threshold, cycle_time_ms,
                                        compression, cross_algo_threshold);
}

// Two-level cross-node ring-vs-tree boundary currently applied (bytes;
// lockstep-broadcast state, identical on every rank of a healthy job).
long long hvd_tpu_autotune_cross_algo_threshold() {
  return GlobalEngine()->CurrentCrossAlgoThreshold();
}

// Fusion threshold in force at engine tick `tick` (the XLA plane keys its
// bucket boundaries off this so autotuned thresholds move them in
// lockstep across ranks).
long long hvd_tpu_fusion_threshold_at(long long tick) {
  return GlobalEngine()->FusionThresholdAt(tick);
}

// Wire compression (docs/performance.md#wire-compression).  The applied
// mode is lockstep-broadcast state, identical on every rank of a healthy
// job; the _at(tick) form serves the XLA plane's per-tick lookup the way
// hvd_tpu_fusion_threshold_at does for bucket boundaries.
int hvd_tpu_compression_mode() {
  return GlobalEngine()->CompressionModeNow();
}

long long hvd_tpu_compression_mode_at(long long tick) {
  return GlobalEngine()->CompressionModeAt(tick);
}

// "wire|payload|ops_none|ops_bf16|ops_fp8|residual_bytes|
//  residual_tensors|min_bytes" — process-cumulative byte/op counters for
// the Python metrics sync, plus the residual-buffer gauges.
const char* hvd_tpu_compression_info() {
  static thread_local std::string tl_compression_info;
  tl_compression_info = GlobalEngine()->CompressionInfo();
  return tl_compression_info.c_str();
}

// Bounded per-bucket decision log, "first_name|mode;..." in execution
// order — identical across the ranks of a healthy job (the lockstep
// contract tests allgather-compare).
const char* hvd_tpu_compression_log() {
  static thread_local std::string tl_compression_log;
  tl_compression_log = GlobalEngine()->CompressionLog();
  return tl_compression_log.c_str();
}

// Two-level topology observability (docs/performance.md
// #two-level-topology).  Info serializes "hier|nodes|local_size|
// threshold|ops_ring|ops_tree|local_bytes|cross_bytes|log_total";
// the log is the bounded per-bucket phase record
// "name|algo|local_rs_us|cross_us|local_ag_us;..." the Python sync
// delta-consumes into the topology phase histograms.
const char* hvd_tpu_topology_info() {
  static thread_local std::string tl_topology_info;
  tl_topology_info = GlobalEngine()->TopologyInfo();
  return tl_topology_info.c_str();
}

const char* hvd_tpu_topology_log() {
  static thread_local std::string tl_topology_log;
  tl_topology_log = GlobalEngine()->TopologyLog();
  return tl_topology_log.c_str();
}

// Elastic-membership observability and control
// (docs/fault-tolerance.md#elastic-membership).  The epoch counts
// reshapes survived by this engine lifetime; the reshape total is
// process-cumulative.  Info serializes "epoch|size|lost_csv|joined_csv".
// Ack clears the post-reshape enqueue poison after Python has resynced
// state in the new membership (hvd.run_elastic calls it).
int hvd_tpu_elastic_enabled() {
  return GlobalEngine()->ElasticEnabled() ? 1 : 0;
}

long long hvd_tpu_membership_epoch() {
  return GlobalEngine()->MembershipEpoch();
}

long long hvd_tpu_membership_reshapes() {
  return GlobalEngine()->ReshapeEvents();
}

const char* hvd_tpu_membership_info() {
  static thread_local std::string tl_membership_info;
  tl_membership_info = GlobalEngine()->MembershipInfo();
  return tl_membership_info.c_str();
}

int hvd_tpu_membership_ack_pending() {
  return GlobalEngine()->ReshapeAckPending() ? 1 : 0;
}

void hvd_tpu_membership_ack() { GlobalEngine()->MembershipAck(); }

// Control-plane observability (docs/performance.md
// #control-plane-scaling): "tree|children|hosts|steady_active|
// pattern_len|steady_threshold|entries|exits|replays|steady_cycles|
// negotiated_ticks|frames_sent|frames_recv" — the tree shape this rank
// sees, the decentralized-steady-state counters (process-cumulative),
// and the control-frame counters the zero-frames-per-steady-cycle
// contract is asserted against.
const char* hvd_tpu_control_info() {
  static thread_local std::string tl_control_info;
  tl_control_info = GlobalEngine()->ControlInfo();
  return tl_control_info.c_str();
}

// Whether this rank is currently self-clocking in the decentralized
// steady state (zero control-plane frames per replay cycle).
int hvd_tpu_steady_active() {
  return GlobalEngine()->SteadyActive() ? 1 : 0;
}

// Simulated-scale negotiation harness (bench.py
// BENCH_MODEL=negotiation_scale): run `size` in-process engine ranks
// over loopback and measure per-cycle negotiation latency star-vs-tree
// and negotiated-vs-steady.  Writes a one-line JSON report into `out`
// (truncated to out_len); returns 0 on success, 1 when the report
// signals a setup/driver failure.
int hvd_tpu_simscale_run(int size, int local_size, int ops_per_cycle,
                         int warm_cycles, int steady_cycles,
                         long long steady_threshold, int coord_tree,
                         int base_port, double timeout_sec, char* out,
                         long long out_len) {
  std::string rep = hvdtpu::SimScaleRun(
      size, local_size, ops_per_cycle, warm_cycles, steady_cycles,
      steady_threshold, coord_tree, base_port, timeout_sec);
  if (out && out_len > 0) {
    size_t n = std::min(static_cast<size_t>(out_len - 1), rep.size());
    memcpy(out, rep.data(), n);
    out[n] = '\0';
  }
  return rep.compare(0, 8, "{\"ok\":1,") == 0 ? 0 : 1;
}

// Timeline hooks for the XLA data plane (jax/eager_mesh.py): plane-side
// execution phases land in the same Chrome-tracing file as the engine's
// events.  All are no-ops when HOROVOD_TIMELINE is unset.
int hvd_tpu_timeline_enabled() {
  return GlobalEngine()->timeline().Enabled() ? 1 : 0;
}

void hvd_tpu_timeline_op_start(const char* name, const char* op) {
  GlobalEngine()->timeline().Start(name ? name : "", op ? op : "");
}

void hvd_tpu_timeline_activity_start(const char* name, const char* activity) {
  GlobalEngine()->timeline().ActivityStart(name ? name : "",
                                           activity ? activity : "");
}

void hvd_tpu_timeline_activity_end(const char* name) {
  GlobalEngine()->timeline().ActivityEnd(name ? name : "");
}

void hvd_tpu_timeline_op_end(const char* name, long long bytes) {
  GlobalEngine()->timeline().End(name ? name : "", bytes);
}

// Instant event on `name`'s row — the Python span API's trace_marker.
void hvd_tpu_timeline_instant(const char* name, const char* label) {
  GlobalEngine()->timeline().Instant(name ? name : "", label ? label : "");
}

// Flush buffered trace events to disk without closing the file: the
// fault injector calls this before an injected crash so the post-mortem
// trace parses (docs/timeline.md).
void hvd_tpu_timeline_flush() { GlobalEngine()->timeline().Flush(); }

}  // extern "C"
