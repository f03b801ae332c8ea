"""The port's metrics registry: live aggregates of the collective layer,
the Prometheus and JSON monitor, and the job view.

Own copy of ``horovod_tpu/common/metrics.py``, with its key names, nesting
and Prometheus families, so that a snapshot of the port and one of the
reference have the same shape and the same text (``tools/metrics_dump.py``,
``tools/hvdtop.py`` and ``tools/hvdlint``'s metrics check read both).  The
timeline answers "what did tensor X do at time T"; this registry answers
how many collectives ran, how many bytes moved, where a collective's time
went (negotiation, wait), which tensors stall and which rank announces
last, live, while the job runs.

Three consumers sit on one process-local registry:

* ``common.metrics_snapshot()`` / ``common.metrics_reset()``: a plain
  nested dict, with the engine's sections mirrored in first.
* ``HVD_TPU_METRICS_FILE=<path>``: a JSON dump per rank
  (``<path>.<rank>``) at ``shutdown()``, on an injected crash and with a
  postmortem dump (``tools/metrics_dump.py`` renders and diffs them).
* ``HVD_TPU_MONITOR_PORT=<port>``: an HTTP server on a daemon thread at
  ``port + local_rank`` serving ``/metrics`` (Prometheus text),
  ``/metrics.json``, ``/health`` and, on rank 0, ``/cluster`` and
  ``/cluster.prom`` (every rank's ``/health`` merged; ``tools/hvdtop.py``
  reads it).

The hot path pays one branch: the collective-layer records (ops, bytes,
``negotiation_sec``, ``wait_sec``, ``step_sec``) are gated on
``registry.enabled`` (``HVD_TPU_METRICS=1``, a metrics file or a monitor
port); the rare records (stalls, aborts, faults, the announce order) and
the engine's mirrored state are recorded whatever the gate.

Sections whose plane the port lacks keep the reference's shape at their
"off" values: the ``xla`` plane of ``ops``, ``bytes``, ``cache``,
``compression`` and ``flight`` reads zeros (no device data plane),
``batches`` and the ``residency_sec``, ``dispatch_sec`` and
``bucket_fill`` histograms stay empty (they are that plane's), and
``topology`` reads the flat ring (no hierarchical allreduce), the
``control`` section one level (no coordinator tree).
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch.common.autotune import empty_report

PLANES = ("engine", "xla")
OPS = ("allreduce", "allgather", "broadcast")

# Fixed bucket upper bounds.  Latencies: pseudo-log seconds covering 100us
# (one engine cycle is 5ms) out to the 60s stall horizon; fills: linear
# tenths of the fusion threshold.
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
FILL_BUCKETS: Tuple[float, ...] = tuple((i + 1) / 10 for i in range(10))

# name -> (bucket bounds, what it measures).  All durations in seconds.
HISTOGRAMS = {
    "negotiation_sec": (LATENCY_BUCKETS,
                        "control-plane negotiation wait "
                        "(enqueue -> agreed response), both planes"),
    "residency_sec": (LATENCY_BUCKETS,
                      "XLA-plane queue/bucket residency "
                      "(negotiated -> dispatched)"),
    "dispatch_sec": (LATENCY_BUCKETS,
                     "XLA-plane dispatch+execute "
                     "(program launch -> host result)"),
    "wait_sec": (LATENCY_BUCKETS,
                 "end-to-end Handle.wait() latency, both planes"),
    "bucket_fill": (FILL_BUCKETS,
                    "fusion-bucket fill fraction of the fusion threshold"),
    "step_sec": (LATENCY_BUCKETS,
                 "one call of build_train_step's step, or one executed "
                 "serving decode step"),
    "announce_skew_sec": (LATENCY_BUCKETS,
                          "first-to-last announce skew per negotiated "
                          "collective (rank-0 coordinator view)"),
    "serving_ttft_sec": (LATENCY_BUCKETS,
                         "serving plane: submit to first generated token "
                         "(rank-0 scheduler view)"),
    "serving_token_sec": (LATENCY_BUCKETS,
                          "serving plane: mean per-token latency of "
                          "retired requests (end-to-end / tokens)"),
    "topology_local_rs_sec": (LATENCY_BUCKETS,
                              "two-level allreduce: node-local "
                              "reduce-scatter phase per bucket"),
    "topology_cross_sec": (LATENCY_BUCKETS,
                           "two-level allreduce: cross-node (DCN) "
                           "exchange per bucket, ring or tree"),
    "topology_local_ag_sec": (LATENCY_BUCKETS,
                              "two-level allreduce: node-local "
                              "allgather phase per bucket"),
    "state_snapshot_sec": (LATENCY_BUCKETS,
                           "state plane: background serialize + spill + "
                           "peer push per committed shard snapshot"),
    "state_restore_sec": (LATENCY_BUCKETS,
                          "state plane: sharded restore after an elastic "
                          "reshape (plan + per-shard broadcasts)"),
}

# State-plane restore outcomes — the `source` label values of
# hvd_tpu_state_restores_total and the keys the elastic acceptance tests
# assert on (docs/fault-tolerance.md#state-plane).
STATE_RESTORE_SOURCES = ("peer", "local", "root_broadcast")
# Checkpoint lifecycle events — the `event` label values of
# hvd_tpu_state_checkpoint_events_total.
STATE_CKPT_EVENTS = ("sharded_saves", "legacy_saves", "loads", "pruned")

# Cap on distinct stalled-tensor entries kept by name; beyond it new names
# fold into a single overflow key so a pathological job (auto-named tensors
# stalling forever) cannot grow the registry unboundedly.
_MAX_STALL_TENSORS = 256
_STALL_OVERFLOW_KEY = "<other>"
# Same cap for per-tenant serving counters: tenant names arrive from the
# network, so an adversarial client must not be able to grow the registry
# (or the Prometheus exposition) without bound.
_MAX_TENANTS = 256

# Serving-plane event counters (requests lifecycle) — the keys of the
# "serving" snapshot section and the `event` label values of
# hvd_tpu_serving_requests_total.
SERVING_EVENTS = ("requests", "admitted", "rejected", "retired", "failed",
                  "preempted", "reformed")

# Anomaly-verdict kinds — the keys of the "anomalies" snapshot section's
# verdict counts and the `kind` label values of
# hvd_tpu_anomaly_verdicts_total.  Order matches the engine's verdict-kind
# indices (engine/cc/flight.h FL_ANOMALY).
ANOMALY_KINDS = ("slow_link", "straggler", "cache_degraded", "slow_phase")

# Per-link timed-send latency bucket upper bounds (µs) — must match
# kNetLinkBucketUs in engine/cc/net.cc; the engine serializes one extra
# +Inf overflow bucket after these.
LINK_SEND_BUCKETS_US = (50, 100, 250, 500, 1000, 2500, 5000, 10000, 50000)


class Histogram:
    """Fixed-bucket histogram; Prometheus-compatible (le upper bounds plus
    an implicit +Inf overflow bucket, sum, count).  Not self-locking: the
    registry's lock covers every mutation."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def to_dict(self) -> dict:
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Process-local counters + histograms for the collective layer.

    ``enabled`` is the single hot-path gate: instrumentation sites read it
    once and skip everything when False.  All mutation happens under one
    lock; both data planes touch the registry from background/waiter
    threads (the engine's per-handle waits, the plane's flush-from-wait).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self._init_state()

    def _init_state(self) -> None:
        self._ops = {p: {o: 0 for o in OPS} for p in PLANES}
        self._bytes = {p: {"in": 0, "out": 0} for p in PLANES}
        self._batches = {"dispatched": 0, "fused_tensors": 0}
        self._stall_count = 0
        self._stall_tensors: Dict[str, dict] = {}
        # Fault tolerance (docs/fault-tolerance.md): injected faults by
        # action (crash/hang/delay), coordinated aborts by kind
        # (ranks_down/timeout), and the hvdrun restart epoch.  Recorded
        # ungated, like stalls: rare by construction, and fault tests must
        # assert on them without opting into full metrics.
        self._faults = {"injected": {}, "aborts": {}, "restart_epoch": 0}
        # Straggler attribution (rank-0 coordinator view): how often each
        # rank announced a collective LAST.  Ungated, like stalls: the
        # acceptance path asserts on it without enabling full metrics; the
        # matching skew distribution is the announce_skew_sec histogram.
        self._skew = {"count": 0, "last_to_announce": {}}
        # Negotiation response cache (docs/performance.md): hit/miss/
        # eviction events per plane ("engine" = the TCP engine's response
        # cache, "xla" = the plane's metadata cache) plus the current
        # entry-count gauge.  Ungated, like stalls: the acceptance path
        # asserts a hit rate without enabling full metrics.
        self._cache = {p: {"hits": 0, "misses": 0, "evictions": 0,
                           "size": 0} for p in PLANES}
        # Online autotuning (docs/performance.md#autotuning): a mirror of
        # the engine's state (applied params, freeze verdict, per-window
        # search history), refreshed on every snapshot by
        # hvd.metrics_snapshot().  Ungated, like stalls: the acceptance
        # path asserts frozen params without enabling full metrics.
        self._autotune = empty_report()
        # Elastic membership (docs/fault-tolerance.md#elastic-membership):
        # a mirror of the engine's membership state (epoch, current size,
        # reshape count, ranks lost/joined), refreshed on every snapshot.
        # Ungated, like stalls: reshape tests assert on it without
        # enabling full metrics.
        self._membership = {"epoch": 0, "size": 0, "reshapes": 0,
                            "ranks_lost": [], "ranks_joined": []}
        # Serving plane (docs/inference.md): request-lifecycle counters,
        # decode-step occupancy accounting, KV-pool gauges, and per-tenant
        # request/token counters.  Ungated, like stalls: the serve smoke
        # and acceptance tests assert on them without enabling full
        # metrics.  Meaningful on rank 0 (the scheduler) only.
        self._serving = {
            **{e: 0 for e in SERVING_EVENTS},
            "steps": 0, "slot_steps": 0,
            "queue_depth": 0, "active": 0, "batch_slots": 0,
            "kv_blocks_in_use": 0, "kv_blocks_total": 0,
            "tenants": {},
        }
        # Flight recorder (docs/troubleshooting.md#reading-a-postmortem):
        # cumulative event counts per plane plus the configured ring
        # capacity, mirrored from the recorders on every snapshot.
        # Ungated, like stalls: postmortem tests assert on it without
        # enabling full metrics.
        self._flight = {"events": {p: 0 for p in PLANES}, "capacity": 0}
        # Wire compression (docs/performance.md#wire-compression): the
        # applied mode, per-plane wire-vs-payload byte totals with
        # per-mode bucket counts, and the error-feedback residual gauges,
        # mirrored from both data planes on every snapshot.  Ungated,
        # like stalls: compression tests assert bytes ratios without
        # enabling full metrics.  Wire bytes count each allreduce bucket
        # at its on-wire width, payload bytes at the caller dtype's
        # width — the pair is what "2x fewer bytes" claims are made of.
        self._compression = {
            "mode": "off", "min_bytes": 0,
            "planes": {p: {"wire_bytes": 0, "payload_bytes": 0,
                           "ops": {"none": 0, "bf16": 0, "fp8": 0}}
                       for p in PLANES},
            "residual_bytes": 0, "residual_tensors": 0,
        }
        # Two-level topology (docs/performance.md#two-level-topology):
        # the engine's topology shape, ring/tree bucket counts, and
        # per-hop byte totals, mirrored on every snapshot; the matching
        # per-bucket phase timings land in the topology_*_sec
        # histograms.  Ungated, like stalls: topology tests assert byte
        # splits without enabling full metrics.
        self._topology = {
            "hierarchical": False, "nodes": 1, "local_size": 1,
            "cross_algo_threshold": 0,
            "cross_ops": {"ring": 0, "tree": 0},
            "bytes": {"local": 0, "cross": 0},
            "local_transport": "tcp",
        }
        # Control plane (docs/performance.md#control-plane-scaling): the
        # coordinator-tree shape this rank sees, the decentralized
        # steady-state counters, and the control-frame totals the
        # zero-frames-per-steady-cycle contract is asserted against.
        # Ungated, like stalls: the scale harness and control tests
        # assert frame deltas without enabling full metrics.
        self._control = {
            "tree": False, "depth": 1, "children": 0, "hosts": 1,
            "steady": {"active": False, "pattern_len": 0, "threshold": 0,
                       "entries": 0, "exits": 0, "replays": 0,
                       "cycles": 0},
            "negotiated_ticks": 0,
            "frames": {"sent": 0, "received": 0},
        }
        # Data-plane liveness (docs/fault-tolerance.md#failure-detection):
        # the heartbeat detector's configuration, beacon frame totals,
        # miss/eviction events, per-peer last-seen ages for the directly
        # monitored beacon neighbours, and the init clock-sync fan-in
        # (rank 0: peers probed directly — O(hosts) under the tree
        # relay).  Ungated, like stalls: fault tests assert eviction
        # counts without enabling full metrics.
        self._liveness = {
            "interval_ms": 0, "miss_limit": 0,
            "frames": {"sent": 0, "received": 0},
            "miss_events": 0, "evictions": 0, "clock_fanin": 0,
            "peers": {},
        }
        # Per-peer link telemetry (docs/metrics.md#links): transport
        # counters and latency/RTT estimates for every TCP link this rank
        # holds, mirrored from the engine's net-layer accounting.
        # Ungated, like stalls: the chaos-localization test asserts
        # per-link latency without enabling full metrics.
        self._links = {"enabled": False, "peers": {}}
        # Point-to-point plane (docs/metrics.md#p2p): send/recv transfer
        # and byte totals, the matched counter against the unmatched
        # gauge (enqueued transfers still waiting for their counterpart
        # to announce), stage-group ops, and the open dedicated-channel
        # gauge.  Ungated, like stalls: the pipeline fault tests assert
        # unmatched counts without enabling full metrics.
        self._p2p = {
            "sends": 0, "recvs": 0,
            "bytes": {"out": 0, "in": 0},
            "matched": 0, "unmatched": 0,
            "group_ops": 0, "channels": 0,
        }
        # Anomaly detector (docs/metrics.md#anomalies): configuration,
        # cumulative typed-verdict counts, and the bounded verdict log.
        # Ungated — verdicts exist to be seen.
        self._anomalies = {
            "sigma": 0, "interval_ms": 0,
            "verdicts": {k: 0 for k in ANOMALY_KINDS},
            "log": [],
        }
        # State plane (docs/fault-tolerance.md#state-plane): snapshot /
        # peer-copy / restore counters and the checkpoint lifecycle.
        # Ungated, like stalls: the elastic acceptance path asserts
        # peer_restores (and ZERO root-broadcast fallbacks) without
        # enabling full metrics, and the bench reads the overlap gauges.
        self._state = {
            "armed": False,
            "snapshots": 0, "snapshot_bytes": 0,
            "last_snapshot_step": -1,
            "blocked_sec": 0.0, "async_sec": 0.0,
            "peer_copies_sent": 0, "peer_bytes_sent": 0,
            "peer_copies_received": 0, "peer_last_step": -1,
            "restores": 0, "peer_restores": 0,
            "root_broadcast_fallbacks": 0,
            "ckpt": {**{e: 0 for e in STATE_CKPT_EVENTS},
                     "shard_bytes": 0},
        }
        self._hists = {name: Histogram(bounds)
                       for name, (bounds, _) in HISTOGRAMS.items()}

    # -- lifecycle --------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            epoch = self._faults["restart_epoch"]
            self._init_state()
            # The restart epoch is job identity, not a counter; a mid-run
            # metrics_reset() must not make the job look like a first run.
            self._faults["restart_epoch"] = epoch

    # -- recording (call sites guard on `enabled`; stalls are ungated) ----

    def record_enqueue(self, plane: str, op: str, nbytes: int) -> None:
        with self._lock:
            self._ops[plane][op] += 1
            self._bytes[plane]["in"] += int(nbytes)

    def record_bytes_out(self, plane: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[plane]["out"] += int(nbytes)

    def record_batch(self, n_ops: int) -> None:
        with self._lock:
            self._batches["dispatched"] += 1
            self._batches["fused_tensors"] += int(n_ops)

    def observe(self, hist: str, value: float) -> None:
        with self._lock:
            self._hists[hist].observe(float(value))

    def record_stall_count(self, n: int) -> None:
        """Bump the stall-event total without per-tensor detail (engine
        events whose names fell off the bounded C-side log)."""
        with self._lock:
            self._stall_count += int(n)

    def record_fault(self, action: str) -> None:
        """One injected fault fired (common/faults.py)."""
        with self._lock:
            self._faults["injected"][action] = (
                self._faults["injected"].get(action, 0) + 1)

    def record_abort(self, kind: str, n: int = 1) -> None:
        """Coordinated abort events: ``ranks_down`` (peer EOF) or
        ``timeout`` (collective deadline), folded in from the engine."""
        with self._lock:
            self._faults["aborts"][kind] = (
                self._faults["aborts"].get(kind, 0) + int(n))

    def set_restart_epoch(self, epoch: int) -> None:
        with self._lock:
            self._faults["restart_epoch"] = int(epoch)

    def record_cache(self, plane: str, kind: str, n: int = 1) -> None:
        """`n` response-cache events of `kind` ("hits" / "misses" /
        "evictions") on `plane`.  Ungated."""
        with self._lock:
            self._cache[plane][kind] += int(n)

    def set_cache_size(self, plane: str, size: int) -> None:
        """Current entry count of `plane`'s response cache (a gauge)."""
        with self._lock:
            self._cache[plane]["size"] = int(size)

    def set_membership(self, state: dict) -> None:
        """Mirror the engine's elastic-membership state (a state copy —
        idempotent overwrite, like the autotune mirror).  Ungated."""
        with self._lock:
            self._membership = dict(state)

    def set_flight(self, state: dict) -> None:
        """Mirror the flight recorders' state (a state copy — idempotent
        overwrite, like the membership mirror).  Ungated."""
        with self._lock:
            self._flight = {"events": dict(state.get("events", {})),
                            "capacity": int(state.get("capacity", 0))}

    def set_compression(self, state: dict) -> None:
        """Mirror the wire-compression state of both data planes (a state
        copy — the underlying counters are cumulative, so overwriting is
        idempotent, like the membership mirror).  Ungated."""
        with self._lock:
            planes = {}
            for plane in PLANES:
                entry = dict(state.get("planes", {}).get(plane, {}))
                planes[plane] = {
                    "wire_bytes": int(entry.get("wire_bytes", 0)),
                    "payload_bytes": int(entry.get("payload_bytes", 0)),
                    "ops": {m: int(entry.get("ops", {}).get(m, 0))
                            for m in ("none", "bf16", "fp8")},
                }
            self._compression = {
                "mode": str(state.get("mode", "off")),
                "min_bytes": int(state.get("min_bytes", 0)),
                "planes": planes,
                "residual_bytes": int(state.get("residual_bytes", 0)),
                "residual_tensors": int(state.get("residual_tensors", 0)),
            }

    def set_topology(self, state: dict) -> None:
        """Mirror the engine's two-level topology state (a state copy —
        the underlying counters are cumulative, so overwriting is
        idempotent, like the compression mirror).  Ungated."""
        with self._lock:
            self._topology = {
                "hierarchical": bool(state.get("hierarchical", False)),
                "nodes": int(state.get("nodes", 1)),
                "local_size": int(state.get("local_size", 1)),
                "cross_algo_threshold": int(
                    state.get("cross_algo_threshold", 0)),
                "cross_ops": {a: int(state.get("cross_ops", {}).get(a, 0))
                              for a in ("ring", "tree")},
                "bytes": {h: int(state.get("bytes", {}).get(h, 0))
                          for h in ("local", "cross")},
                "local_transport": str(
                    state.get("local_transport", "tcp")),
            }

    def set_control(self, state: dict) -> None:
        """Mirror the engine's control-plane state (a state copy — the
        underlying counters are cumulative, so overwriting is idempotent,
        like the topology mirror).  Ungated."""
        with self._lock:
            steady = state.get("steady", {})
            self._control = {
                "tree": bool(state.get("tree", False)),
                "depth": int(state.get("depth", 1)),
                "children": int(state.get("children", 0)),
                "hosts": int(state.get("hosts", 1)),
                "steady": {
                    "active": bool(steady.get("active", False)),
                    "pattern_len": int(steady.get("pattern_len", 0)),
                    "threshold": int(steady.get("threshold", 0)),
                    "entries": int(steady.get("entries", 0)),
                    "exits": int(steady.get("exits", 0)),
                    "replays": int(steady.get("replays", 0)),
                    "cycles": int(steady.get("cycles", 0)),
                },
                "negotiated_ticks": int(state.get("negotiated_ticks", 0)),
                "frames": {d: int(state.get("frames", {}).get(d, 0))
                           for d in ("sent", "received")},
            }

    def set_liveness(self, state: dict) -> None:
        """Mirror the engine's heartbeat-detector state (a state copy —
        the underlying counters are cumulative, so overwriting is
        idempotent, like the control mirror).  Ungated."""
        with self._lock:
            self._liveness = {
                "interval_ms": int(state.get("interval_ms", 0)),
                "miss_limit": int(state.get("miss_limit", 0)),
                "frames": {d: int(state.get("frames", {}).get(d, 0))
                           for d in ("sent", "received")},
                "miss_events": int(state.get("miss_events", 0)),
                "evictions": int(state.get("evictions", 0)),
                "clock_fanin": int(state.get("clock_fanin", 0)),
                "peers": {int(r): {"age_us": int(v.get("age_us", 0)),
                                   "misses": int(v.get("misses", 0))}
                          for r, v in state.get("peers", {}).items()},
            }

    def set_links(self, state: dict) -> None:
        """Mirror the engine's per-peer link telemetry (a state copy —
        the net-layer counters are cumulative, so overwriting is
        idempotent, like the liveness mirror).  Ungated."""
        with self._lock:
            self._links = {
                "enabled": bool(state.get("enabled", False)),
                "peers": {
                    str(r): {
                        "bytes_out": int(v.get("bytes_out", 0)),
                        "bytes_in": int(v.get("bytes_in", 0)),
                        "sends": int(v.get("sends", 0)),
                        "recvs": int(v.get("recvs", 0)),
                        "stalls": int(v.get("stalls", 0)),
                        "short_writes": int(v.get("short_writes", 0)),
                        "send_us_sum": int(v.get("send_us_sum", 0)),
                        "send_us_count": int(v.get("send_us_count", 0)),
                        "send_us_buckets": [
                            int(b) for b in v.get("send_us_buckets", [])],
                        "rtt_last_us": int(v.get("rtt_last_us", -1)),
                        "rtt_ewma_us": int(v.get("rtt_ewma_us", 0)),
                        "rtt_samples": int(v.get("rtt_samples", 0)),
                        "shm_bytes_out": int(v.get("shm_bytes_out", 0)),
                        "shm_bytes_in": int(v.get("shm_bytes_in", 0)),
                        "shm_handoffs": int(v.get("shm_handoffs", 0)),
                        "shm_us_sum": int(v.get("shm_us_sum", 0)),
                        "shm_us_count": int(v.get("shm_us_count", 0)),
                        "shm_us_buckets": [
                            int(b) for b in v.get("shm_us_buckets", [])],
                        "transport": str(v.get("transport", "tcp")),
                    }
                    for r, v in state.get("peers", {}).items()
                },
            }

    def set_p2p(self, state: dict) -> None:
        """Mirror the engine's point-to-point plane state (a state copy —
        the engine counters are cumulative, so overwriting is idempotent,
        like the links mirror).  Ungated."""
        with self._lock:
            self._p2p = {
                "sends": int(state.get("sends", 0)),
                "recvs": int(state.get("recvs", 0)),
                "bytes": {d: int(state.get("bytes", {}).get(d, 0))
                          for d in ("out", "in")},
                "matched": int(state.get("matched", 0)),
                "unmatched": int(state.get("unmatched", 0)),
                "group_ops": int(state.get("group_ops", 0)),
                "channels": int(state.get("channels", 0)),
            }

    def set_anomalies(self, state: dict) -> None:
        """Mirror the engine's anomaly-detector state: config, cumulative
        verdict counts, bounded verdict log (a state copy — idempotent).
        Ungated."""
        with self._lock:
            self._anomalies = {
                "sigma": int(state.get("sigma", 0)),
                "interval_ms": int(state.get("interval_ms", 0)),
                "verdicts": {k: int(state.get("verdicts", {}).get(k, 0))
                             for k in ANOMALY_KINDS},
                "log": [{"kind": str(e.get("kind", "")),
                         "subject": str(e.get("subject", "")),
                         "detail": str(e.get("detail", "")),
                         "age_us": int(e.get("age_us", 0))}
                        for e in state.get("log", [])][-64:],
            }

    def set_autotune(self, report: dict) -> None:
        """Mirror the engine's autotuning report (a state copy — the
        report carries current values plus bounded logs, so overwriting
        is idempotent).  Ungated."""
        with self._lock:
            self._autotune = dict(report)

    def record_last_announce(self, rank: int, n: int = 1) -> None:
        """`rank` announced a negotiated collective last, `n` times
        (coordinator view, folded in from the engine).  Ungated."""
        with self._lock:
            self._skew["count"] += int(n)
            key = str(rank)
            self._skew["last_to_announce"][key] = (
                self._skew["last_to_announce"].get(key, 0) + int(n))

    def _tenant_locked(self, tenant: str) -> dict:
        tenants = self._serving["tenants"]
        if tenant not in tenants and len(tenants) >= _MAX_TENANTS:
            tenant = _STALL_OVERFLOW_KEY
        return tenants.setdefault(tenant, {
            **{e: 0 for e in SERVING_EVENTS},
            "prompt_tokens": 0, "generated_tokens": 0,
        })

    def record_serving(self, event: str, tenant: Optional[str] = None,
                       n: int = 1) -> None:
        """`n` serving request-lifecycle events (one of
        :data:`SERVING_EVENTS`), optionally attributed to a tenant.
        Ungated."""
        with self._lock:
            self._serving[event] += int(n)
            if tenant is not None:
                self._tenant_locked(tenant)[event] += int(n)

    def record_serving_tokens(self, tenant: str, kind: str,
                              n: int) -> None:
        """`n` `kind` ("prompt" / "generated") tokens for a tenant."""
        with self._lock:
            self._tenant_locked(tenant)[f"{kind}_tokens"] += int(n)

    def record_serving_step(self, active_slots: int,
                            batch_slots: int) -> None:
        """One decode step carrying `active_slots` live requests: the
        running occupancy numerator/denominator."""
        with self._lock:
            self._serving["steps"] += 1
            self._serving["slot_steps"] += int(active_slots)
            self._serving["batch_slots"] = int(batch_slots)

    def set_serving_gauges(self, **gauges) -> None:
        """Overwrite serving gauges (queue_depth / active / batch_slots /
        kv_blocks_in_use / kv_blocks_total)."""
        with self._lock:
            for key, value in gauges.items():
                if key not in self._serving or key == "tenants":
                    raise KeyError(f"unknown serving gauge {key!r}")
                self._serving[key] = int(value)

    def set_state_armed(self, armed: bool) -> None:
        """The state plane armed/closed on this rank.  Ungated."""
        with self._lock:
            self._state["armed"] = bool(armed)

    def record_state_snapshot(self, step: int, nbytes: int) -> None:
        """One shard snapshot committed (background worker).  Ungated."""
        with self._lock:
            self._state["snapshots"] += 1
            self._state["snapshot_bytes"] += int(nbytes)
            self._state["last_snapshot_step"] = int(step)

    def set_state_overlap(self, blocked_sec: float,
                          async_sec: float) -> None:
        """Cumulative step-path blocked vs background overlapped seconds
        (gauges — the snapshotter owns the totals).  Ungated."""
        with self._lock:
            self._state["blocked_sec"] = float(blocked_sec)
            self._state["async_sec"] = float(async_sec)

    def record_state_peer(self, sent_bytes: Optional[int] = None,
                          received_step: Optional[int] = None) -> None:
        """A peer-mirror push sent (``sent_bytes``) or a full copy
        received (``received_step`` — the freshness gauge).  Ungated."""
        with self._lock:
            if sent_bytes is not None:
                self._state["peer_copies_sent"] += 1
                self._state["peer_bytes_sent"] += int(sent_bytes)
            if received_step is not None:
                self._state["peer_copies_received"] += 1
                self._state["peer_last_step"] = int(received_step)

    def record_state_restore(self, source: str) -> None:
        """One elastic resync routed by its source: ``"peer"`` (at least
        one shard came from a peer copy), ``"local"`` (own/survivor
        snapshots covered everything), or ``"root_broadcast"`` (the plane
        fell back to the classic O(model) sync).  Ungated."""
        if source not in STATE_RESTORE_SOURCES:
            raise ValueError(f"unknown state restore source {source!r}")
        with self._lock:
            if source == "root_broadcast":
                self._state["root_broadcast_fallbacks"] += 1
            else:
                self._state["restores"] += 1
                if source == "peer":
                    self._state["peer_restores"] += 1

    def record_state_ckpt(self, event: str, n: int = 1,
                          nbytes: int = 0) -> None:
        """Checkpoint lifecycle events (:data:`STATE_CKPT_EVENTS`).
        Ungated."""
        if event not in STATE_CKPT_EVENTS:
            raise ValueError(f"unknown state checkpoint event {event!r}")
        with self._lock:
            self._state["ckpt"][event] += int(n)
            self._state["ckpt"]["shard_bytes"] += int(nbytes)

    def record_stall(self, name: str, duration_sec: float) -> None:
        with self._lock:
            self._stall_count += 1
            if (name not in self._stall_tensors
                    and len(self._stall_tensors) >= _MAX_STALL_TENSORS):
                name = _STALL_OVERFLOW_KEY
            entry = self._stall_tensors.setdefault(
                name, {"count": 0, "last_duration_sec": 0.0})
            entry["count"] += 1
            entry["last_duration_sec"] = float(duration_sec)

    # -- reading ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "ops": {p: dict(v) for p, v in self._ops.items()},
                "bytes": {p: dict(v) for p, v in self._bytes.items()},
                "batches": dict(self._batches),
                "stalls": {
                    "count": self._stall_count,
                    "tensors": {k: dict(v)
                                for k, v in self._stall_tensors.items()},
                },
                "faults": {
                    "injected": dict(self._faults["injected"]),
                    "aborts": dict(self._faults["aborts"]),
                    "restart_epoch": self._faults["restart_epoch"],
                },
                "skew": {
                    "count": self._skew["count"],
                    "last_to_announce": dict(self._skew["last_to_announce"]),
                },
                "cache": {p: dict(v) for p, v in self._cache.items()},
                "membership": {
                    **self._membership,
                    "ranks_lost": list(
                        self._membership.get("ranks_lost", [])),
                    "ranks_joined": list(
                        self._membership.get("ranks_joined", [])),
                },
                "autotune": {
                    **self._autotune,
                    "history": [dict(h) for h in
                                self._autotune.get("history", [])],
                    "applied": [dict(a) for a in
                                self._autotune.get("applied", [])],
                },
                "serving": {
                    **{k: v for k, v in self._serving.items()
                       if k != "tenants"},
                    "occupancy": (
                        self._serving["slot_steps"]
                        / (self._serving["steps"]
                           * self._serving["batch_slots"])
                        if self._serving["steps"]
                        and self._serving["batch_slots"] else 0.0),
                    "tenants": {t: dict(v) for t, v in
                                self._serving["tenants"].items()},
                },
                "flight": {
                    "events": dict(self._flight["events"]),
                    "capacity": self._flight["capacity"],
                },
                "compression": {
                    "mode": self._compression["mode"],
                    "min_bytes": self._compression["min_bytes"],
                    "planes": {p: {"wire_bytes": v["wire_bytes"],
                                   "payload_bytes": v["payload_bytes"],
                                   "ops": dict(v["ops"])}
                               for p, v in
                               self._compression["planes"].items()},
                    "residual_bytes": self._compression["residual_bytes"],
                    "residual_tensors":
                        self._compression["residual_tensors"],
                },
                "topology": {
                    **{k: v for k, v in self._topology.items()
                       if k not in ("cross_ops", "bytes")},
                    "cross_ops": dict(self._topology["cross_ops"]),
                    "bytes": dict(self._topology["bytes"]),
                },
                "control": {
                    **{k: v for k, v in self._control.items()
                       if k not in ("steady", "frames")},
                    "steady": dict(self._control["steady"]),
                    "frames": dict(self._control["frames"]),
                },
                "liveness": {
                    **{k: v for k, v in self._liveness.items()
                       if k not in ("frames", "peers")},
                    "frames": dict(self._liveness["frames"]),
                    "peers": {r: dict(v) for r, v in
                              self._liveness["peers"].items()},
                },
                "links": {
                    "enabled": self._links["enabled"],
                    "peers": {r: {**v,
                                  "send_us_buckets":
                                  list(v["send_us_buckets"]),
                                  "shm_us_buckets":
                                  list(v.get("shm_us_buckets", []))}
                              for r, v in self._links["peers"].items()},
                },
                "p2p": {
                    **{k: v for k, v in self._p2p.items() if k != "bytes"},
                    "bytes": dict(self._p2p["bytes"]),
                },
                "anomalies": {
                    "sigma": self._anomalies["sigma"],
                    "interval_ms": self._anomalies["interval_ms"],
                    "verdicts": dict(self._anomalies["verdicts"]),
                    "log": [dict(e) for e in self._anomalies["log"]],
                },
                "state": {
                    **{k: v for k, v in self._state.items()
                       if k != "ckpt"},
                    "overlap_ratio": (
                        self._state["async_sec"]
                        / (self._state["async_sec"]
                           + self._state["blocked_sec"])
                        if self._state["async_sec"]
                        + self._state["blocked_sec"] > 0 else 1.0),
                    "ckpt": dict(self._state["ckpt"]),
                },
                "histograms": {name: h.to_dict()
                               for name, h in self._hists.items()},
            }


registry = MetricsRegistry()


# ---------------------------------------------------------------------------
# Prometheus text exposition (format v0.0.4).
# ---------------------------------------------------------------------------


def _label_escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    return repr(int(value)) if float(value).is_integer() else repr(value)


def _prom_hist_name(name: str) -> str:
    if name.endswith("_sec"):
        return f"hvd_tpu_{name[:-4]}_seconds"
    return f"hvd_tpu_{name}_ratio"


def prometheus_text(snapshot: dict) -> str:
    """Render a metrics snapshot as Prometheus text exposition."""
    out: List[str] = []

    out.append("# HELP hvd_tpu_ops_total collective operations enqueued")
    out.append("# TYPE hvd_tpu_ops_total counter")
    for plane, per_op in snapshot["ops"].items():
        for op, n in per_op.items():
            out.append(f'hvd_tpu_ops_total{{plane="{plane}",op="{op}"}} {n}')

    out.append("# HELP hvd_tpu_bytes_total collective payload bytes")
    out.append("# TYPE hvd_tpu_bytes_total counter")
    for plane, per_dir in snapshot["bytes"].items():
        for direction, n in per_dir.items():
            out.append(f'hvd_tpu_bytes_total{{plane="{plane}",'
                       f'direction="{direction}"}} {n}')

    out.append("# HELP hvd_tpu_batches_dispatched_total "
               "fused batches dispatched (XLA plane)")
    out.append("# TYPE hvd_tpu_batches_dispatched_total counter")
    out.append("hvd_tpu_batches_dispatched_total "
               f"{snapshot['batches']['dispatched']}")
    out.append("# HELP hvd_tpu_fused_tensors_total "
               "tensors carried by dispatched batches")
    out.append("# TYPE hvd_tpu_fused_tensors_total counter")
    out.append("hvd_tpu_fused_tensors_total "
               f"{snapshot['batches']['fused_tensors']}")

    out.append("# HELP hvd_tpu_stall_events_total "
               "stall warnings (engine sweep + XLA-plane wait)")
    out.append("# TYPE hvd_tpu_stall_events_total counter")
    out.append(f"hvd_tpu_stall_events_total {snapshot['stalls']['count']}")
    out.append("# HELP hvd_tpu_stalled_tensor_total "
               "stall warnings per tensor name")
    out.append("# TYPE hvd_tpu_stalled_tensor_total counter")
    for name, entry in snapshot["stalls"]["tensors"].items():
        out.append(f'hvd_tpu_stalled_tensor_total{{tensor='
                   f'"{_label_escape(name)}"}} {entry["count"]}')

    faults = snapshot.get("faults", {})
    out.append("# HELP hvd_tpu_faults_injected_total "
               "injected faults fired (HVD_TPU_FAULT_SPEC)")
    out.append("# TYPE hvd_tpu_faults_injected_total counter")
    for action, n in faults.get("injected", {}).items():
        out.append(f'hvd_tpu_faults_injected_total{{action='
                   f'"{_label_escape(action)}"}} {n}')
    out.append("# HELP hvd_tpu_aborts_total "
               "coordinated aborts (ranks_down / timeout)")
    out.append("# TYPE hvd_tpu_aborts_total counter")
    for kind, n in faults.get("aborts", {}).items():
        out.append(f'hvd_tpu_aborts_total{{kind='
                   f'"{_label_escape(kind)}"}} {n}')
    out.append("# HELP hvd_tpu_restart_epoch "
               "hvdrun restart counter (0 = first run)")
    out.append("# TYPE hvd_tpu_restart_epoch gauge")
    out.append(f"hvd_tpu_restart_epoch {faults.get('restart_epoch', 0)}")

    cache = snapshot.get("cache", {})
    out.append("# HELP hvd_tpu_response_cache_events_total "
               "negotiation response cache events (docs/performance.md)")
    out.append("# TYPE hvd_tpu_response_cache_events_total counter")
    for plane, per_kind in cache.items():
        for kind in ("hits", "misses", "evictions"):
            out.append(f'hvd_tpu_response_cache_events_total{{plane='
                       f'"{plane}",event="{kind}"}} '
                       f'{per_kind.get(kind, 0)}')
    out.append("# HELP hvd_tpu_response_cache_size "
               "current response-cache entry count")
    out.append("# TYPE hvd_tpu_response_cache_size gauge")
    for plane, per_kind in cache.items():
        out.append(f'hvd_tpu_response_cache_size{{plane="{plane}"}} '
                   f'{per_kind.get("size", 0)}')

    tune = snapshot.get("autotune", {})
    out.append("# HELP hvd_tpu_autotune_enabled "
               "online autotuning opted in (HVD_TPU_AUTOTUNE)")
    out.append("# TYPE hvd_tpu_autotune_enabled gauge")
    out.append(f"hvd_tpu_autotune_enabled {int(tune.get('enabled', False))}")
    out.append("# HELP hvd_tpu_autotune_frozen "
               "autotuning search converged and froze")
    out.append("# TYPE hvd_tpu_autotune_frozen gauge")
    out.append(f"hvd_tpu_autotune_frozen {int(tune.get('frozen', False))}")
    out.append("# HELP hvd_tpu_autotune_windows_total "
               "tuning windows scored (coordinator view)")
    out.append("# TYPE hvd_tpu_autotune_windows_total counter")
    out.append(f"hvd_tpu_autotune_windows_total {tune.get('windows', 0)}")
    out.append("# HELP hvd_tpu_autotune_fusion_threshold_bytes "
               "currently applied tensor-fusion threshold")
    out.append("# TYPE hvd_tpu_autotune_fusion_threshold_bytes gauge")
    out.append("hvd_tpu_autotune_fusion_threshold_bytes "
               f"{tune.get('fusion_threshold', 0)}")
    out.append("# HELP hvd_tpu_autotune_cycle_time_seconds "
               "currently applied negotiation cycle time")
    out.append("# TYPE hvd_tpu_autotune_cycle_time_seconds gauge")
    out.append("hvd_tpu_autotune_cycle_time_seconds "
               f"{repr(float(tune.get('cycle_time_ms', 0.0)) / 1000.0)}")
    out.append("# HELP hvd_tpu_autotune_best_score "
               "best window score seen (payload bytes+ops per second)")
    out.append("# TYPE hvd_tpu_autotune_best_score gauge")
    out.append(f"hvd_tpu_autotune_best_score "
               f"{repr(float(tune.get('best_score', 0.0)))}")

    member = snapshot.get("membership", {})
    out.append("# HELP hvd_tpu_membership_epoch "
               "elastic membership epoch (reshapes survived this job)")
    out.append("# TYPE hvd_tpu_membership_epoch gauge")
    out.append(f"hvd_tpu_membership_epoch {member.get('epoch', 0)}")
    out.append("# HELP hvd_tpu_membership_size "
               "current job size after elastic reshapes")
    out.append("# TYPE hvd_tpu_membership_size gauge")
    out.append(f"hvd_tpu_membership_size {member.get('size', 0)}")
    out.append("# HELP hvd_tpu_membership_reshapes_total "
               "elastic membership reshape barriers applied")
    out.append("# TYPE hvd_tpu_membership_reshapes_total counter")
    out.append("hvd_tpu_membership_reshapes_total "
               f"{member.get('reshapes', 0)}")
    out.append("# HELP hvd_tpu_membership_ranks_lost_total "
               "ranks lost to elastic shrinks")
    out.append("# TYPE hvd_tpu_membership_ranks_lost_total counter")
    out.append("hvd_tpu_membership_ranks_lost_total "
               f"{len(member.get('ranks_lost', []))}")
    out.append("# HELP hvd_tpu_membership_ranks_joined_total "
               "standby ranks admitted by elastic grows")
    out.append("# TYPE hvd_tpu_membership_ranks_joined_total counter")
    out.append("hvd_tpu_membership_ranks_joined_total "
               f"{len(member.get('ranks_joined', []))}")

    serving = snapshot.get("serving", {})
    out.append("# HELP hvd_tpu_serving_requests_total "
               "serving request lifecycle events (docs/inference.md)")
    out.append("# TYPE hvd_tpu_serving_requests_total counter")
    for event in SERVING_EVENTS:
        out.append(f'hvd_tpu_serving_requests_total{{event="{event}"}} '
                   f'{serving.get(event, 0)}')
    out.append("# HELP hvd_tpu_serving_steps_total "
               "decode steps executed (rank-0 scheduler view)")
    out.append("# TYPE hvd_tpu_serving_steps_total counter")
    out.append(f"hvd_tpu_serving_steps_total {serving.get('steps', 0)}")
    out.append("# HELP hvd_tpu_serving_queue_depth "
               "requests waiting for a batch slot")
    out.append("# TYPE hvd_tpu_serving_queue_depth gauge")
    out.append("hvd_tpu_serving_queue_depth "
               f"{serving.get('queue_depth', 0)}")
    out.append("# HELP hvd_tpu_serving_active_requests "
               "requests currently holding a decode-batch slot")
    out.append("# TYPE hvd_tpu_serving_active_requests gauge")
    out.append(f"hvd_tpu_serving_active_requests {serving.get('active', 0)}")
    out.append("# HELP hvd_tpu_serving_batch_occupancy "
               "mean fraction of decode-batch slots carrying a request")
    out.append("# TYPE hvd_tpu_serving_batch_occupancy gauge")
    out.append("hvd_tpu_serving_batch_occupancy "
               f"{repr(float(serving.get('occupancy', 0.0)))}")
    out.append("# HELP hvd_tpu_serving_kv_blocks_in_use "
               "KV cache blocks currently allocated")
    out.append("# TYPE hvd_tpu_serving_kv_blocks_in_use gauge")
    out.append("hvd_tpu_serving_kv_blocks_in_use "
               f"{serving.get('kv_blocks_in_use', 0)}")
    out.append("# HELP hvd_tpu_serving_kv_blocks_total "
               "KV cache block pool size")
    out.append("# TYPE hvd_tpu_serving_kv_blocks_total gauge")
    out.append("hvd_tpu_serving_kv_blocks_total "
               f"{serving.get('kv_blocks_total', 0)}")
    out.append("# HELP hvd_tpu_serving_tenant_requests_total "
               "serving request events per tenant")
    out.append("# TYPE hvd_tpu_serving_tenant_requests_total counter")
    out.append("# HELP hvd_tpu_serving_tenant_tokens_total "
               "prompt/generated tokens per tenant")
    out.append("# TYPE hvd_tpu_serving_tenant_tokens_total counter")
    for tenant, entry in serving.get("tenants", {}).items():
        label = _label_escape(tenant)
        for event in SERVING_EVENTS:
            if entry.get(event):
                out.append(
                    f'hvd_tpu_serving_tenant_requests_total{{tenant='
                    f'"{label}",event="{event}"}} {entry[event]}')
        for kind in ("prompt", "generated"):
            out.append(f'hvd_tpu_serving_tenant_tokens_total{{tenant='
                       f'"{label}",kind="{kind}"}} '
                       f'{entry.get(f"{kind}_tokens", 0)}')

    flight = snapshot.get("flight", {})
    out.append("# HELP hvd_tpu_flight_events_total "
               "flight-recorder events recorded "
               "(docs/troubleshooting.md#reading-a-postmortem)")
    out.append("# TYPE hvd_tpu_flight_events_total counter")
    for plane in PLANES:
        out.append(f'hvd_tpu_flight_events_total{{plane="{plane}"}} '
                   f'{flight.get("events", {}).get(plane, 0)}')
    out.append("# HELP hvd_tpu_flight_ring_capacity "
               "configured flight-recorder ring size "
               "(HVD_TPU_FLIGHT_EVENTS; 0 = disabled)")
    out.append("# TYPE hvd_tpu_flight_ring_capacity gauge")
    out.append(f"hvd_tpu_flight_ring_capacity {flight.get('capacity', 0)}")

    comp = snapshot.get("compression", {})
    out.append("# HELP hvd_tpu_compression_mode "
               "applied wire-compression mode (0=off 1=bf16 2=fp8; "
               "docs/performance.md#wire-compression)")
    out.append("# TYPE hvd_tpu_compression_mode gauge")
    out.append("hvd_tpu_compression_mode "
               f"{ {'off': 0, 'bf16': 1, 'fp8': 2}.get(comp.get('mode'), 0) }")
    out.append("# HELP hvd_tpu_compression_wire_bytes_total "
               "allreduce bucket bytes at on-wire width")
    out.append("# TYPE hvd_tpu_compression_wire_bytes_total counter")
    for plane, entry in comp.get("planes", {}).items():
        out.append(f'hvd_tpu_compression_wire_bytes_total{{plane='
                   f'"{plane}"}} {entry.get("wire_bytes", 0)}')
    out.append("# HELP hvd_tpu_compression_payload_bytes_total "
               "allreduce bucket bytes at caller-dtype width")
    out.append("# TYPE hvd_tpu_compression_payload_bytes_total counter")
    for plane, entry in comp.get("planes", {}).items():
        out.append(f'hvd_tpu_compression_payload_bytes_total{{plane='
                   f'"{plane}"}} {entry.get("payload_bytes", 0)}')
    out.append("# HELP hvd_tpu_compression_ops_total "
               "allreduce buckets executed per wire mode")
    out.append("# TYPE hvd_tpu_compression_ops_total counter")
    for plane, entry in comp.get("planes", {}).items():
        for mode, n in entry.get("ops", {}).items():
            out.append(f'hvd_tpu_compression_ops_total{{plane="{plane}",'
                       f'mode="{mode}"}} {n}')
    out.append("# HELP hvd_tpu_compression_residual_bytes "
               "error-feedback residual buffer bytes held")
    out.append("# TYPE hvd_tpu_compression_residual_bytes gauge")
    out.append("hvd_tpu_compression_residual_bytes "
               f"{comp.get('residual_bytes', 0)}")

    topo = snapshot.get("topology", {})
    out.append("# HELP hvd_tpu_topology_hierarchical "
               "two-level allreduce topology active "
               "(docs/performance.md#two-level-topology)")
    out.append("# TYPE hvd_tpu_topology_hierarchical gauge")
    out.append("hvd_tpu_topology_hierarchical "
               f"{int(topo.get('hierarchical', False))}")
    out.append("# HELP hvd_tpu_topology_nodes "
               "node count of the two-level topology (1 = flat)")
    out.append("# TYPE hvd_tpu_topology_nodes gauge")
    out.append(f"hvd_tpu_topology_nodes {topo.get('nodes', 1)}")
    out.append("# HELP hvd_tpu_topology_local_size "
               "ranks per node in the two-level topology")
    out.append("# TYPE hvd_tpu_topology_local_size gauge")
    out.append(f"hvd_tpu_topology_local_size {topo.get('local_size', 1)}")
    out.append("# HELP hvd_tpu_topology_local_transport transport carrying "
               "the node-local hops (docs/performance.md#transport)")
    out.append("# TYPE hvd_tpu_topology_local_transport gauge")
    out.append("hvd_tpu_topology_local_transport{transport="
               f"\"{topo.get('local_transport', 'tcp')}\"}} 1")
    out.append("# HELP hvd_tpu_topology_cross_algo_threshold_bytes "
               "ring-vs-tree boundary for the cross-node hop "
               "(buckets under it take the tree)")
    out.append("# TYPE hvd_tpu_topology_cross_algo_threshold_bytes gauge")
    out.append("hvd_tpu_topology_cross_algo_threshold_bytes "
               f"{topo.get('cross_algo_threshold', 0)}")
    out.append("# HELP hvd_tpu_topology_cross_ops_total "
               "two-level buckets executed per cross-node algorithm")
    out.append("# TYPE hvd_tpu_topology_cross_ops_total counter")
    for algo, n in topo.get("cross_ops", {}).items():
        out.append(f'hvd_tpu_topology_cross_ops_total{{algo="{algo}"}} {n}')
    out.append("# HELP hvd_tpu_topology_bytes_total "
               "two-level allreduce wire bytes sent per hop "
               "(local = intra-node ring, cross = DCN)")
    out.append("# TYPE hvd_tpu_topology_bytes_total counter")
    for hop, n in topo.get("bytes", {}).items():
        out.append(f'hvd_tpu_topology_bytes_total{{hop="{hop}"}} {n}')

    ctrl = snapshot.get("control", {})
    steady = ctrl.get("steady", {})
    out.append("# HELP hvd_tpu_control_tree_depth coordinator levels in "
               "the control plane (1 = star, 2 = per-host "
               "sub-coordinator tree; docs/performance.md"
               "#control-plane-scaling)")
    out.append("# TYPE hvd_tpu_control_tree_depth gauge")
    out.append(f"hvd_tpu_control_tree_depth {ctrl.get('depth', 1)}")
    out.append("# HELP hvd_tpu_control_children control sockets this "
               "rank reads each negotiation tick (fan-in at its tree "
               "level)")
    out.append("# TYPE hvd_tpu_control_children gauge")
    out.append(f"hvd_tpu_control_children {ctrl.get('children', 0)}")
    out.append("# HELP hvd_tpu_control_steady_active this rank is "
               "self-clocking in the decentralized steady state (zero "
               "control-plane frames per cycle)")
    out.append("# TYPE hvd_tpu_control_steady_active gauge")
    out.append("hvd_tpu_control_steady_active "
               f"{int(steady.get('active', False))}")
    out.append("# HELP hvd_tpu_control_steady_cycles_total negotiation "
               "cycles replayed self-clocked (no coordinator traffic)")
    out.append("# TYPE hvd_tpu_control_steady_cycles_total counter")
    out.append("hvd_tpu_control_steady_cycles_total "
               f"{steady.get('cycles', 0)}")
    out.append("# HELP hvd_tpu_control_steady_transitions_total steady-"
               "state entries and exits on this rank")
    out.append("# TYPE hvd_tpu_control_steady_transitions_total counter")
    for kind in ("entries", "exits"):
        out.append("hvd_tpu_control_steady_transitions_total"
                   f'{{kind="{kind}"}} {steady.get(kind, 0)}')
    out.append("# HELP hvd_tpu_control_negotiated_ticks_total broadcast "
               "response lists processed that carried negotiated work")
    out.append("# TYPE hvd_tpu_control_negotiated_ticks_total counter")
    out.append("hvd_tpu_control_negotiated_ticks_total "
               f"{ctrl.get('negotiated_ticks', 0)}")
    out.append("# HELP hvd_tpu_control_frames_total control-plane frames "
               "this rank sent/received (flat during steady-state "
               "cycles)")
    out.append("# TYPE hvd_tpu_control_frames_total counter")
    for d, n in ctrl.get("frames", {}).items():
        out.append(f'hvd_tpu_control_frames_total{{dir="{d}"}} {n}')

    live = snapshot.get("liveness", {})
    out.append("# HELP hvd_tpu_liveness_interval_ms data-plane heartbeat "
               "interval (0 = detector disabled; docs/fault-tolerance.md"
               "#failure-detection)")
    out.append("# TYPE hvd_tpu_liveness_interval_ms gauge")
    out.append(f"hvd_tpu_liveness_interval_ms {live.get('interval_ms', 0)}")
    out.append("# HELP hvd_tpu_liveness_miss_limit consecutive missed "
               "beacon intervals before a peer is flagged")
    out.append("# TYPE hvd_tpu_liveness_miss_limit gauge")
    out.append(f"hvd_tpu_liveness_miss_limit {live.get('miss_limit', 0)}")
    out.append("# HELP hvd_tpu_liveness_frames_total heartbeat beacons "
               "this rank sent/received on the data plane")
    out.append("# TYPE hvd_tpu_liveness_frames_total counter")
    for d, n in live.get("frames", {}).items():
        out.append(f'hvd_tpu_liveness_frames_total{{dir="{d}"}} {n}')
    out.append("# HELP hvd_tpu_liveness_miss_events_total peers flagged "
               "silent past the miss window by this rank's detector")
    out.append("# TYPE hvd_tpu_liveness_miss_events_total counter")
    out.append("hvd_tpu_liveness_miss_events_total "
               f"{live.get('miss_events', 0)}")
    out.append("# HELP hvd_tpu_liveness_evictions_total ranks the "
               "coordinator marked down from heartbeat evidence")
    out.append("# TYPE hvd_tpu_liveness_evictions_total counter")
    out.append(f"hvd_tpu_liveness_evictions_total {live.get('evictions', 0)}")
    out.append("# HELP hvd_tpu_liveness_clock_fanin peers this rank "
               "probed directly during init clock sync (rank 0 under the "
               "sub-coordinator tree: O(hosts), not O(ranks))")
    out.append("# TYPE hvd_tpu_liveness_clock_fanin gauge")
    out.append(f"hvd_tpu_liveness_clock_fanin {live.get('clock_fanin', 0)}")
    out.append("# HELP hvd_tpu_liveness_peer_age_us microseconds since "
               "the last beacon from a directly monitored neighbour")
    out.append("# TYPE hvd_tpu_liveness_peer_age_us gauge")
    for r, v in live.get("peers", {}).items():
        out.append(f'hvd_tpu_liveness_peer_age_us{{peer="{r}"}} '
                   f'{v.get("age_us", 0)}')

    links = snapshot.get("links", {})
    link_peers = links.get("peers", {})
    out.append("# HELP hvd_tpu_link_stats_enabled per-peer link telemetry "
               "armed on this rank (HVD_TPU_LINK_STATS)")
    out.append("# TYPE hvd_tpu_link_stats_enabled gauge")
    out.append("hvd_tpu_link_stats_enabled "
               f"{int(links.get('enabled', False))}")
    out.append("# HELP hvd_tpu_link_bytes_total bytes moved over each "
               "peer link by direction (docs/metrics.md#links)")
    out.append("# TYPE hvd_tpu_link_bytes_total counter")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_bytes_total{{peer="{r}",dir="out"}} '
                   f'{v.get("bytes_out", 0)}')
        out.append(f'hvd_tpu_link_bytes_total{{peer="{r}",dir="in"}} '
                   f'{v.get("bytes_in", 0)}')
    out.append("# HELP hvd_tpu_link_sends_total timed whole-frame sends "
               "completed on each peer link")
    out.append("# TYPE hvd_tpu_link_sends_total counter")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_sends_total{{peer="{r}"}} '
                   f'{v.get("sends", 0)}')
    out.append("# HELP hvd_tpu_link_stall_events_total transport "
               "backpressure on each peer link (write stalls, short "
               "writes)")
    out.append("# TYPE hvd_tpu_link_stall_events_total counter")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_stall_events_total{{peer="{r}",'
                   f'kind="stall"}} {v.get("stalls", 0)}')
        out.append(f'hvd_tpu_link_stall_events_total{{peer="{r}",'
                   f'kind="short_write"}} {v.get("short_writes", 0)}')
    out.append("# HELP hvd_tpu_link_send_latency_us whole-frame send "
               "latency per peer link (includes any injected chaos "
               "delay)")
    out.append("# TYPE hvd_tpu_link_send_latency_us histogram")
    for r, v in link_peers.items():
        buckets = v.get("send_us_buckets", [])
        cumulative = 0
        for bound, n in zip(LINK_SEND_BUCKETS_US, buckets):
            cumulative += n
            out.append(f'hvd_tpu_link_send_latency_us_bucket{{peer="{r}",'
                       f'le="{_fmt(bound)}"}} {cumulative}')
        out.append(f'hvd_tpu_link_send_latency_us_bucket{{peer="{r}",'
                   f'le="+Inf"}} {v.get("send_us_count", 0)}')
        out.append(f'hvd_tpu_link_send_latency_us_sum{{peer="{r}"}} '
                   f'{v.get("send_us_sum", 0)}')
        out.append(f'hvd_tpu_link_send_latency_us_count{{peer="{r}"}} '
                   f'{v.get("send_us_count", 0)}')
    out.append("# HELP hvd_tpu_link_rtt_us heartbeat-echo round-trip "
               "estimate per peer link (last sample and EWMA)")
    out.append("# TYPE hvd_tpu_link_rtt_us gauge")
    for r, v in link_peers.items():
        if v.get("rtt_samples", 0) > 0:
            out.append(f'hvd_tpu_link_rtt_us{{peer="{r}",stat="last"}} '
                       f'{v.get("rtt_last_us", -1)}')
            out.append(f'hvd_tpu_link_rtt_us{{peer="{r}",stat="ewma"}} '
                       f'{v.get("rtt_ewma_us", 0)}')
    out.append("# HELP hvd_tpu_link_rtt_samples_total heartbeat-echo "
               "round trips measured per peer link")
    out.append("# TYPE hvd_tpu_link_rtt_samples_total counter")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_rtt_samples_total{{peer="{r}"}} '
                   f'{v.get("rtt_samples", 0)}')
    out.append("# HELP hvd_tpu_link_transport data-plane transport "
               "carrying each peer link (1 for the labeled transport; "
               "docs/performance.md#transport)")
    out.append("# TYPE hvd_tpu_link_transport gauge")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_transport{{peer="{r}",'
                   f'transport="{v.get("transport", "tcp")}"}} 1')
    out.append("# HELP hvd_tpu_link_shm_bytes_total bytes handed off "
               "through the shared-memory rings per peer by direction")
    out.append("# TYPE hvd_tpu_link_shm_bytes_total counter")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_shm_bytes_total{{peer="{r}",dir="out"}} '
                   f'{v.get("shm_bytes_out", 0)}')
        out.append(f'hvd_tpu_link_shm_bytes_total{{peer="{r}",dir="in"}} '
                   f'{v.get("shm_bytes_in", 0)}')
    out.append("# HELP hvd_tpu_link_shm_handoffs_total segment handoffs "
               "completed through the shared-memory rings per peer")
    out.append("# TYPE hvd_tpu_link_shm_handoffs_total counter")
    for r, v in link_peers.items():
        out.append(f'hvd_tpu_link_shm_handoffs_total{{peer="{r}"}} '
                   f'{v.get("shm_handoffs", 0)}')
    out.append("# HELP hvd_tpu_link_shm_handoff_latency_us time for one "
               "send leg to fully enter the peer's ring (includes any "
               "injected chaos delay)")
    out.append("# TYPE hvd_tpu_link_shm_handoff_latency_us histogram")
    for r, v in link_peers.items():
        buckets = v.get("shm_us_buckets", [])
        cumulative = 0
        for bound, n in zip(LINK_SEND_BUCKETS_US, buckets):
            cumulative += n
            out.append(
                f'hvd_tpu_link_shm_handoff_latency_us_bucket{{peer="{r}",'
                f'le="{_fmt(bound)}"}} {cumulative}')
        out.append(
            f'hvd_tpu_link_shm_handoff_latency_us_bucket{{peer="{r}",'
            f'le="+Inf"}} {v.get("shm_us_count", 0)}')
        out.append(f'hvd_tpu_link_shm_handoff_latency_us_sum{{peer="{r}"}} '
                   f'{v.get("shm_us_sum", 0)}')
        out.append(
            f'hvd_tpu_link_shm_handoff_latency_us_count{{peer="{r}"}} '
            f'{v.get("shm_us_count", 0)}')

    p2p = snapshot.get("p2p", {})
    out.append("# HELP hvd_tpu_p2p_transfers_total point-to-point "
               "transfers executed by direction (docs/pipeline.md)")
    out.append("# TYPE hvd_tpu_p2p_transfers_total counter")
    out.append(f'hvd_tpu_p2p_transfers_total{{dir="send"}} '
               f'{p2p.get("sends", 0)}')
    out.append(f'hvd_tpu_p2p_transfers_total{{dir="recv"}} '
               f'{p2p.get("recvs", 0)}')
    out.append("# HELP hvd_tpu_p2p_bytes_total point-to-point wire bytes "
               "moved by direction (inter-stage activation/grad traffic)")
    out.append("# TYPE hvd_tpu_p2p_bytes_total counter")
    for d, n in p2p.get("bytes", {}).items():
        out.append(f'hvd_tpu_p2p_bytes_total{{dir="{d}"}} {n}')
    out.append("# HELP hvd_tpu_p2p_matched_total send/recv pairs this "
               "rank completed after paired-readiness negotiation")
    out.append("# TYPE hvd_tpu_p2p_matched_total counter")
    out.append(f"hvd_tpu_p2p_matched_total {p2p.get('matched', 0)}")
    out.append("# HELP hvd_tpu_p2p_unmatched enqueued transfers still "
               "waiting for the counterpart rank to announce (a stuck "
               "nonzero value names a pipeline schedule bug)")
    out.append("# TYPE hvd_tpu_p2p_unmatched gauge")
    out.append(f"hvd_tpu_p2p_unmatched {p2p.get('unmatched', 0)}")
    out.append("# HELP hvd_tpu_p2p_group_ops_total stage-scoped "
               "allreduce operations executed (DP inside one stage)")
    out.append("# TYPE hvd_tpu_p2p_group_ops_total counter")
    out.append(f"hvd_tpu_p2p_group_ops_total {p2p.get('group_ops', 0)}")
    out.append("# HELP hvd_tpu_p2p_channels dedicated non-neighbour "
               "p2p connections currently open")
    out.append("# TYPE hvd_tpu_p2p_channels gauge")
    out.append(f"hvd_tpu_p2p_channels {p2p.get('channels', 0)}")

    anomalies = snapshot.get("anomalies", {})
    out.append("# HELP hvd_tpu_anomaly_sigma robust-excursion threshold "
               "of the online anomaly detector (0 = disabled)")
    out.append("# TYPE hvd_tpu_anomaly_sigma gauge")
    out.append(f"hvd_tpu_anomaly_sigma {anomalies.get('sigma', 0)}")
    out.append("# HELP hvd_tpu_anomaly_verdicts_total typed anomaly "
               "verdicts emitted by the online detector "
               "(docs/metrics.md#anomalies)")
    out.append("# TYPE hvd_tpu_anomaly_verdicts_total counter")
    for kind in ANOMALY_KINDS:
        out.append(f'hvd_tpu_anomaly_verdicts_total{{kind="{kind}"}} '
                   f'{anomalies.get("verdicts", {}).get(kind, 0)}')

    state = snapshot.get("state", {})
    out.append("# HELP hvd_tpu_state_armed state plane armed on this "
               "rank (docs/fault-tolerance.md#state-plane)")
    out.append("# TYPE hvd_tpu_state_armed gauge")
    out.append(f"hvd_tpu_state_armed {int(state.get('armed', False))}")
    out.append("# HELP hvd_tpu_state_snapshots_total shard snapshots "
               "committed by the state plane")
    out.append("# TYPE hvd_tpu_state_snapshots_total counter")
    out.append(f"hvd_tpu_state_snapshots_total {state.get('snapshots', 0)}")
    out.append("# HELP hvd_tpu_state_snapshot_bytes_total bytes captured "
               "into committed shard snapshots")
    out.append("# TYPE hvd_tpu_state_snapshot_bytes_total counter")
    out.append("hvd_tpu_state_snapshot_bytes_total "
               f"{state.get('snapshot_bytes', 0)}")
    out.append("# HELP hvd_tpu_state_last_snapshot_step step of the "
               "newest committed shard snapshot (-1 = none)")
    out.append("# TYPE hvd_tpu_state_last_snapshot_step gauge")
    out.append("hvd_tpu_state_last_snapshot_step "
               f"{state.get('last_snapshot_step', -1)}")
    out.append("# HELP hvd_tpu_state_overlap_ratio fraction of snapshot "
               "work overlapped with compute (1.0 = fully async)")
    out.append("# TYPE hvd_tpu_state_overlap_ratio gauge")
    out.append("hvd_tpu_state_overlap_ratio "
               f"{repr(float(state.get('overlap_ratio', 1.0)))}")
    out.append("# HELP hvd_tpu_state_peer_copies_total peer-mirror shard "
               "copies moved over the state plane")
    out.append("# TYPE hvd_tpu_state_peer_copies_total counter")
    out.append('hvd_tpu_state_peer_copies_total{direction="sent"} '
               f"{state.get('peer_copies_sent', 0)}")
    out.append('hvd_tpu_state_peer_copies_total{direction="received"} '
               f"{state.get('peer_copies_received', 0)}")
    out.append("# HELP hvd_tpu_state_peer_last_step step of the newest "
               "fully received peer copy (freshness; -1 = none)")
    out.append("# TYPE hvd_tpu_state_peer_last_step gauge")
    out.append("hvd_tpu_state_peer_last_step "
               f"{state.get('peer_last_step', -1)}")
    out.append("# HELP hvd_tpu_state_restores_total elastic resyncs by "
               "source (peer / local snapshots / root-broadcast fallback)")
    out.append("# TYPE hvd_tpu_state_restores_total counter")
    out.append('hvd_tpu_state_restores_total{source="peer"} '
               f"{state.get('peer_restores', 0)}")
    local_restores = max(state.get("restores", 0)
                         - state.get("peer_restores", 0), 0)
    out.append('hvd_tpu_state_restores_total{source="local"} '
               f"{local_restores}")
    out.append('hvd_tpu_state_restores_total{source="root_broadcast"} '
               f"{state.get('root_broadcast_fallbacks', 0)}")
    out.append("# HELP hvd_tpu_state_checkpoint_events_total durable "
               "checkpoint lifecycle (sharded/legacy saves, loads, prunes)")
    out.append("# TYPE hvd_tpu_state_checkpoint_events_total counter")
    for event in STATE_CKPT_EVENTS:
        out.append(f'hvd_tpu_state_checkpoint_events_total{{event='
                   f'"{event}"}} {state.get("ckpt", {}).get(event, 0)}')
    out.append("# HELP hvd_tpu_state_checkpoint_shard_bytes_total bytes "
               "this rank wrote into checkpoint shards")
    out.append("# TYPE hvd_tpu_state_checkpoint_shard_bytes_total counter")
    out.append("hvd_tpu_state_checkpoint_shard_bytes_total "
               f"{state.get('ckpt', {}).get('shard_bytes', 0)}")

    skew = snapshot.get("skew", {})
    out.append("# HELP hvd_tpu_announce_total "
               "negotiations reaching full count (coordinator view)")
    out.append("# TYPE hvd_tpu_announce_total counter")
    out.append(f"hvd_tpu_announce_total {skew.get('count', 0)}")
    out.append("# HELP hvd_tpu_last_to_announce_total "
               "negotiations this rank announced last (straggler "
               "attribution, coordinator view)")
    out.append("# TYPE hvd_tpu_last_to_announce_total counter")
    for rank, n in skew.get("last_to_announce", {}).items():
        out.append(f'hvd_tpu_last_to_announce_total{{rank='
                   f'"{_label_escape(rank)}"}} {n}')

    for name, hist in snapshot["histograms"].items():
        prom = _prom_hist_name(name)
        out.append(f"# HELP {prom} {HISTOGRAMS[name][1]}")
        out.append(f"# TYPE {prom} histogram")
        cumulative = 0
        for bound, n in zip(hist["buckets"], hist["counts"]):
            cumulative += n
            out.append(f'{prom}_bucket{{le="{_fmt(bound)}"}} {cumulative}')
        out.append(f'{prom}_bucket{{le="+Inf"}} {hist["count"]}')
        out.append(f"{prom}_sum {repr(float(hist['sum']))}")
        out.append(f"{prom}_count {hist['count']}")

    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Job-level aggregation (docs/metrics.md#cluster): rank 0's monitor serves
# /cluster — one merged health view of every live rank — so a single scrape
# target covers the fleet.  Each rank's monitor serves the compact /health
# summary the aggregation is built from.
# ---------------------------------------------------------------------------

_monitor_lock = threading.Lock()
_monitor = None  # (server, bound_port)
# /cluster scrape targets [(rank, host, port)], set on rank 0 by
# configure_cluster at init.  Torn down by stop_monitor (and thus re-init
# and hvdrun relaunches) so elastic reshapes / --max-restarts cannot serve
# stale per-rank entries.
_cluster_cfg = None


def configure_cluster(targets) -> None:
    """Arm rank 0's /cluster aggregation with the per-rank monitor
    endpoints ([(rank, host, port)]; rank 0's own entry included)."""
    global _cluster_cfg
    with _monitor_lock:
        _cluster_cfg = list(targets)


def cluster_configured() -> bool:
    with _monitor_lock:
        return _cluster_cfg is not None


def health_summary(snap: dict) -> dict:
    """The compact per-rank health record /cluster merges: liveness,
    membership epoch, cache hit rate, stall/abort counts, serving
    occupancy, flight-recorder activity."""
    member = snap.get("membership", {})
    # Both planes' negotiation caches count (an XLA-plane job records its
    # hits under "xla"; engine-only would read 0.0 there).
    hits = sum(c.get("hits", 0) for c in snap.get("cache", {}).values())
    misses = sum(c.get("misses", 0)
                 for c in snap.get("cache", {}).values())
    serving = snap.get("serving", {})
    links = snap.get("links", {})
    anomalies = snap.get("anomalies", {})
    return {
        "live": True,
        "membership_epoch": member.get("epoch", 0),
        "size": member.get("size", 0),
        "restart_epoch": snap.get("faults", {}).get("restart_epoch", 0),
        "stalls": snap.get("stalls", {}).get("count", 0),
        "aborts": sum(snap.get("faults", {}).get("aborts", {}).values()),
        "cache_hit_rate": (hits / (hits + misses)
                           if hits + misses else 0.0),
        "serving_occupancy": serving.get("occupancy", 0.0),
        "serving_active": serving.get("active", 0),
        "flight_events": sum(
            snap.get("flight", {}).get("events", {}).values()),
        # Compact per-link heat record (one row per peer this rank talks
        # to) — what hvdtop's link table renders.  send_mean_us covers
        # timed whole-frame sends; rtt_ewma_us is -1 until the first
        # heartbeat echo lands.
        "links": {
            str(r): {
                "send_mean_us": (v.get("send_us_sum", 0)
                                 // max(v.get("send_us_count", 0), 1)
                                 if v.get("send_us_count", 0) else -1),
                "rtt_ewma_us": (v.get("rtt_ewma_us", 0)
                                if v.get("rtt_samples", 0) else -1),
                "stalls": (v.get("stalls", 0)
                           + v.get("short_writes", 0)),
                "bytes": (v.get("bytes_out", 0) + v.get("bytes_in", 0)
                          + v.get("shm_bytes_out", 0)
                          + v.get("shm_bytes_in", 0)),
                "transport": v.get("transport", "tcp"),
                "shm_handoff_mean_us": (
                    v.get("shm_us_sum", 0)
                    // max(v.get("shm_us_count", 0), 1)
                    if v.get("shm_us_count", 0) else -1),
            }
            for r, v in links.get("peers", {}).items()
        },
        # Typed anomaly verdicts (docs/metrics.md#anomalies): cumulative
        # counts plus the tail of the verdict log, so /cluster can merge
        # a job-wide anomaly feed.
        "anomalies": {
            "verdicts": dict(anomalies.get("verdicts", {})),
            "log": [dict(e) for e in anomalies.get("log", [])[-8:]],
        },
    }


def _scrape_health(host: str, port: int, timeout: float = 1.0) -> dict:
    import urllib.request

    try:
        with urllib.request.urlopen(
                f"http://{host}:{port}/health", timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception as exc:
        return {"live": False, "error": f"{type(exc).__name__}: {exc}"}


def cluster_document(snapshot_fn: Callable[[], dict]) -> dict:
    """Scrape every rank's /health (rank 0's own summary is computed
    locally — no loopback HTTP round trip) and merge one job view."""
    with _monitor_lock:
        targets = list(_cluster_cfg or [])
    ranks: Dict[str, dict] = {}
    threads = []

    def scrape(rank, host, port):
        ranks[str(rank)] = _scrape_health(host, port)

    own_rank = targets[0][0] if targets else 0
    for rank, host, port in targets:
        if rank == own_rank:
            ranks[str(rank)] = health_summary(snapshot_fn())
            continue
        # Pre-claim the entry as dead: a scrape thread that outlives the
        # join below (e.g. DNS resolution blocking past urllib's timeout)
        # must leave the rank visible as live:false, not silently missing
        # — liveness is the point, a dead rank must not hide.
        ranks[str(rank)] = {"live": False,
                            "error": "scrape did not respond in time"}
        t = threading.Thread(target=scrape, args=(rank, host, port),
                             daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=2.0)
    live = [r for r in ranks.values() if r.get("live")]
    epochs = {r.get("membership_epoch") for r in live}
    # Job-wide anomaly rollup: total verdicts per kind plus a merged,
    # rank-attributed tail of every rank's verdict log (newest-by-age
    # first) — the scrolling feed hvdtop renders.
    verdict_totals: Dict[str, int] = {}
    feed = []
    for rank, entry in ranks.items():
        anomalies = entry.get("anomalies", {}) or {}
        for kind, n in anomalies.get("verdicts", {}).items():
            verdict_totals[kind] = verdict_totals.get(kind, 0) + int(n)
        for e in anomalies.get("log", []):
            feed.append({"rank": rank, **e})
    feed.sort(key=lambda e: e.get("age_us", 0))
    return {
        "ranks": ranks,
        "launched": len(targets),
        "live": len(live),
        "membership_epochs_agree": len(epochs) <= 1,
        "anomalies": {
            "total": sum(verdict_totals.values()),
            "verdicts": verdict_totals,
            "recent": feed[:32],
        },
    }


def cluster_prometheus_text(doc: dict) -> str:
    """Prometheus form of the merged /cluster document, so one scrape
    target covers the fleet's liveness and epoch agreement."""
    out: List[str] = []
    out.append("# HELP hvd_tpu_cluster_rank_up rank responded to the "
               "cluster health scrape")
    out.append("# TYPE hvd_tpu_cluster_rank_up gauge")
    for rank, entry in sorted(doc["ranks"].items(), key=lambda kv: kv[0]):
        out.append(f'hvd_tpu_cluster_rank_up{{rank="{rank}"}} '
                   f'{1 if entry.get("live") else 0}')
    out.append("# HELP hvd_tpu_cluster_rank_membership_epoch per-rank "
               "elastic membership epoch")
    out.append("# TYPE hvd_tpu_cluster_rank_membership_epoch gauge")
    for rank, entry in sorted(doc["ranks"].items(), key=lambda kv: kv[0]):
        if entry.get("live"):
            out.append(
                f'hvd_tpu_cluster_rank_membership_epoch{{rank="{rank}"}} '
                f'{entry.get("membership_epoch", 0)}')
    out.append("# HELP hvd_tpu_cluster_ranks_live ranks responding to the "
               "cluster health scrape")
    out.append("# TYPE hvd_tpu_cluster_ranks_live gauge")
    out.append(f"hvd_tpu_cluster_ranks_live {doc['live']}")
    return "\n".join(out) + "\n"


def start_monitor(port: int,
                  snapshot_fn: Optional[Callable[[], dict]] = None,
                  host: str = "") -> int:
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` from a
    daemon thread; returns the bound port (useful with ``port=0``).
    Idempotent: a second call returns the running monitor's port.
    Starting the monitor enables the registry — a scrape target with all
    counters frozen at zero would be worse than no target."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    global _monitor
    with _monitor_lock:
        if _monitor is not None:
            return _monitor[1]
        fn = snapshot_fn or registry.snapshot

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/metrics":
                    body = prometheus_text(fn()).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = json.dumps(fn()).encode()
                    ctype = "application/json"
                elif path == "/health":
                    # Compact per-rank summary, the /cluster scrape unit.
                    body = json.dumps(health_summary(fn())).encode()
                    ctype = "application/json"
                elif path in ("/cluster", "/cluster.prom") \
                        and cluster_configured():
                    doc = cluster_document(fn)
                    if path == "/cluster":
                        body = json.dumps(doc).encode()
                        ctype = "application/json"
                    else:
                        body = cluster_prometheus_text(doc).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep scrapes off stderr
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="hvd-tpu-monitor", daemon=True)
        thread.start()
        registry.enable()
        _monitor = (server, server.server_address[1])
        return _monitor[1]


def stop_monitor() -> None:
    global _monitor, _cluster_cfg
    with _monitor_lock:
        # The /cluster aggregation dies with the monitor: a re-init (or
        # an hvdrun --max-restarts relaunch) reconfigures fresh targets,
        # so stale per-rank entries from a previous membership cannot be
        # served.
        _cluster_cfg = None
        if _monitor is None:
            return
        server, _ = _monitor
        _monitor = None
    server.shutdown()
    server.server_close()


def monitor_port() -> Optional[int]:
    with _monitor_lock:
        return _monitor[1] if _monitor else None
