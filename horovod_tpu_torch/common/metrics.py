"""The port's metrics registry, trimmed to what the serving plane, the
point-to-point plane, the checkpoints, elastic membership and the state
plane record.

Own copy of the serving half of ``horovod_tpu/common/metrics.py``: the
request-lifecycle counters, decode-step occupancy, KV-pool gauges and
per-tenant counters (tenant names come from the network, so their number
is bounded), the serving latency histograms, and the engine's response
cache and point-to-point counters that ``hvd.metrics_snapshot()`` folds
in, the checkpoint lifecycle (``state.ckpt``: saves of each format,
loads, pruned checkpoints and shard bytes written), the injected faults
and the restart epoch (``faults``), the engine's membership mirror
(``membership``: epoch, size, reshapes, ranks lost and joined) and the
state plane's counters (``state``: armed, snapshots, peer copies,
restores by source, the step path's blocked and the background's
overlapped seconds), the wire-compression mirror (``compression``: mode,
floor, wire and payload bytes and buckets per mode of each data plane,
the error-feedback residuals; the ``xla`` plane stays at zeros, the
device data plane is not ported) and the autotuning mirror
(``autotune``, ``common/autotune.py``'s report).  Everything is
recorded whether or not metrics are enabled, as in the reference, except
the engine's ``step_sec``, which it observes only while ``enabled``
(``HVD_TPU_METRICS=1``).  The metrics file dump, the Prometheus monitor
(the compression and autotune families among them) and the
collective-layer counters are not ported (``config.UNPORTED``).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Tuple

from horovod_tpu_torch.common.autotune import empty_report

# The data planes of the compression section, as the reference's.
PLANES = ("engine", "xla")
COMPRESSION_MODES = ("none", "bf16", "fp8")

# Latency bucket upper bounds in seconds: pseudo-log from 100 us (one
# engine cycle is 5 ms) to the 60 s stall horizon.
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# name -> (bucket bounds, what it measures).
HISTOGRAMS = {
    "step_sec": (LATENCY_BUCKETS, "serving plane: one executed decode step"),
    "serving_ttft_sec": (LATENCY_BUCKETS,
                         "serving plane: submit to first generated token "
                         "(rank-0 scheduler view)"),
    "serving_token_sec": (LATENCY_BUCKETS,
                          "serving plane: mean per-token latency of "
                          "retired requests (end-to-end / tokens)"),
    "state_snapshot_sec": (LATENCY_BUCKETS,
                           "state plane: background serialize + spill + "
                           "peer push per committed shard snapshot"),
    "state_restore_sec": (LATENCY_BUCKETS,
                          "state plane: sharded restore after an elastic "
                          "reshape (plan + per-shard broadcasts)"),
}

# Request-lifecycle events: the keys of the snapshot's "serving" section.
SERVING_EVENTS = ("requests", "admitted", "rejected", "retired", "failed",
                  "preempted", "reformed")

# Where an elastic resync got the state from (``record_state_restore``).
STATE_RESTORE_SOURCES = ("peer", "local", "root_broadcast")

# Checkpoint lifecycle events: the keys of the snapshot's "state.ckpt".
STATE_CKPT_EVENTS = ("sharded_saves", "legacy_saves", "loads", "pruned")

# Past this many tenants new names fold into one overflow key.
_MAX_TENANTS = 256
_OVERFLOW_KEY = "<other>"


class Histogram:
    """Fixed-bucket histogram (upper bounds plus an overflow bucket, sum,
    count).  The registry's lock covers every mutation."""

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
    """Process-local counters and histograms under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self._init_state()

    def _init_state(self) -> None:
        self._cache = {"engine": {"hits": 0, "misses": 0, "evictions": 0,
                                  "size": 0}}
        self._p2p = {"sends": 0, "recvs": 0, "bytes": {"out": 0, "in": 0},
                     "matched": 0, "unmatched": 0, "group_ops": 0,
                     "channels": 0}
        self._serving = {
            **{e: 0 for e in SERVING_EVENTS},
            "steps": 0, "slot_steps": 0,
            "queue_depth": 0, "active": 0, "batch_slots": 0,
            "kv_blocks_in_use": 0, "kv_blocks_total": 0,
            "tenants": {},
        }
        self._ckpt = {**{e: 0 for e in STATE_CKPT_EVENTS},
                      "shard_bytes": 0}
        self._faults = {"injected": {}, "restart_epoch": 0}
        self._membership = {"epoch": 0, "size": 0, "reshapes": 0,
                            "ranks_lost": [], "ranks_joined": []}
        self._state = {
            "armed": False,
            "snapshots": 0, "snapshot_bytes": 0,
            "last_snapshot_step": -1,
            "blocked_sec": 0.0, "async_sec": 0.0,
            "peer_copies_sent": 0, "peer_bytes_sent": 0,
            "peer_copies_received": 0, "peer_last_step": -1,
            "restores": 0, "peer_restores": 0,
            "root_broadcast_fallbacks": 0,
        }
        self._compression = {
            "mode": "off", "min_bytes": 0,
            "planes": {p: {"wire_bytes": 0, "payload_bytes": 0,
                           "ops": {m: 0 for m in COMPRESSION_MODES}}
                       for p in PLANES},
            "residual_bytes": 0, "residual_tensors": 0,
        }
        self._autotune = empty_report()
        self._hists = {name: Histogram(bounds)
                       for name, (bounds, _) in HISTOGRAMS.items()}

    def enable(self) -> None:
        self.enabled = True

    def reset(self) -> None:
        with self._lock:
            epoch = self._faults["restart_epoch"]
            self._init_state()
            # The restart epoch is the job's identity, not a counter.
            self._faults["restart_epoch"] = epoch

    def observe(self, hist: str, value: float) -> None:
        with self._lock:
            self._hists[hist].observe(float(value))

    def record_cache(self, plane: str, kind: str, n: int = 1) -> None:
        with self._lock:
            self._cache[plane][kind] += int(n)

    def set_cache_size(self, plane: str, size: int) -> None:
        with self._lock:
            self._cache[plane]["size"] = int(size)

    def set_p2p(self, state: dict) -> None:
        """Mirror the engine's point-to-point state (its counters are
        cumulative, so this is a copy, idempotent)."""
        with self._lock:
            self._p2p = {
                **{k: int(state.get(k, 0)) for k in (
                    "sends", "recvs", "matched", "unmatched", "group_ops",
                    "channels")},
                "bytes": {d: int(state.get("bytes", {}).get(d, 0))
                          for d in ("out", "in")},
            }

    def _tenant_locked(self, tenant: str) -> dict:
        tenants = self._serving["tenants"]
        if tenant not in tenants and len(tenants) >= _MAX_TENANTS:
            tenant = _OVERFLOW_KEY
        return tenants.setdefault(tenant, {
            **{e: 0 for e in SERVING_EVENTS},
            "prompt_tokens": 0, "generated_tokens": 0,
        })

    def record_serving(self, event: str, tenant: Optional[str] = None,
                       n: int = 1) -> None:
        """``n`` request-lifecycle events (one of :data:`SERVING_EVENTS`),
        optionally attributed to a tenant."""
        with self._lock:
            self._serving[event] += int(n)
            if tenant is not None:
                self._tenant_locked(tenant)[event] += int(n)

    def record_serving_tokens(self, tenant: str, kind: str,
                              n: int) -> None:
        """``n`` ``kind`` ("prompt" / "generated") tokens for a tenant."""
        with self._lock:
            self._tenant_locked(tenant)[f"{kind}_tokens"] += int(n)

    def record_serving_step(self, active_slots: int,
                            batch_slots: int) -> None:
        """One executed decode step carrying ``active_slots`` requests."""
        with self._lock:
            self._serving["steps"] += 1
            self._serving["slot_steps"] += int(active_slots)
            self._serving["batch_slots"] = int(batch_slots)

    def set_serving_gauges(self, **gauges) -> None:
        """Overwrite serving gauges (queue_depth, active, batch_slots,
        kv_blocks_in_use, kv_blocks_total)."""
        with self._lock:
            for key, value in gauges.items():
                if key not in self._serving or key == "tenants":
                    raise KeyError(f"unknown serving gauge {key!r}")
                self._serving[key] = int(value)

    def record_state_ckpt(self, event: str, n: int = 1,
                          nbytes: int = 0) -> None:
        """``n`` checkpoint lifecycle events (one of
        :data:`STATE_CKPT_EVENTS`) and ``nbytes`` written."""
        if event not in STATE_CKPT_EVENTS:
            raise ValueError(f"unknown state checkpoint event {event!r}")
        with self._lock:
            self._ckpt[event] += int(n)
            self._ckpt["shard_bytes"] += int(nbytes)

    def record_fault(self, action: str) -> None:
        """One injected fault fired (``common/faults.py``)."""
        with self._lock:
            self._faults["injected"][action] = (
                self._faults["injected"].get(action, 0) + 1)

    def set_restart_epoch(self, epoch: int) -> None:
        with self._lock:
            self._faults["restart_epoch"] = int(epoch)

    def set_membership(self, state: dict) -> None:
        """Mirror the engine's elastic membership (a copy, idempotent)."""
        with self._lock:
            self._membership = dict(state)

    def set_compression(self, state: dict) -> None:
        """Mirror the wire-compression state of the data planes (a copy:
        the engine's counters are cumulative, so idempotent).  A plane
        missing from ``state`` reads zeros."""
        with self._lock:
            planes = {}
            for plane in PLANES:
                entry = dict(state.get("planes", {}).get(plane, {}))
                planes[plane] = {
                    "wire_bytes": int(entry.get("wire_bytes", 0)),
                    "payload_bytes": int(entry.get("payload_bytes", 0)),
                    "ops": {m: int(entry.get("ops", {}).get(m, 0))
                            for m in COMPRESSION_MODES},
                }
            self._compression = {
                "mode": str(state.get("mode", "off")),
                "min_bytes": int(state.get("min_bytes", 0)),
                "planes": planes,
                "residual_bytes": int(state.get("residual_bytes", 0)),
                "residual_tensors": int(state.get("residual_tensors", 0)),
            }

    def set_autotune(self, report: dict) -> None:
        """Mirror the engine's autotuning report (current values and
        bounded logs: a copy, idempotent)."""
        with self._lock:
            self._autotune = dict(report)

    def set_state_armed(self, armed: bool) -> None:
        with self._lock:
            self._state["armed"] = bool(armed)

    def record_state_snapshot(self, step: int, nbytes: int) -> None:
        """One shard snapshot committed (the background writer)."""
        with self._lock:
            self._state["snapshots"] += 1
            self._state["snapshot_bytes"] += int(nbytes)
            self._state["last_snapshot_step"] = int(step)

    def set_state_overlap(self, blocked_sec: float,
                          async_sec: float) -> None:
        """The snapshotter's totals: seconds the step path waited on the
        double buffer, seconds the background overlapped with it."""
        with self._lock:
            self._state["blocked_sec"] = float(blocked_sec)
            self._state["async_sec"] = float(async_sec)

    def record_state_peer(self, sent_bytes: Optional[int] = None,
                          received_step: Optional[int] = None) -> None:
        """A push to the ring neighbour sent (``sent_bytes``) or a whole
        copy received from it (``received_step``)."""
        with self._lock:
            if sent_bytes is not None:
                self._state["peer_copies_sent"] += 1
                self._state["peer_bytes_sent"] += int(sent_bytes)
            if received_step is not None:
                self._state["peer_copies_received"] += 1
                self._state["peer_last_step"] = int(received_step)

    def record_state_restore(self, source: str) -> None:
        """One elastic resync by its source (:data:`STATE_RESTORE_SOURCES`):
        ``peer`` (a shard came from a peer copy), ``local`` (the
        survivors' own snapshots covered every shard), ``root_broadcast``
        (the plane fell back to the whole state from rank 0)."""
        if source not in STATE_RESTORE_SOURCES:
            raise ValueError(f"unknown state restore source {source!r}")
        with self._lock:
            if source == "root_broadcast":
                self._state["root_broadcast_fallbacks"] += 1
            else:
                self._state["restores"] += 1
                if source == "peer":
                    self._state["peer_restores"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            serving = self._serving
            steps, slots = serving["steps"], serving["batch_slots"]
            return {
                "enabled": self.enabled,
                "cache": {p: dict(v) for p, v in self._cache.items()},
                "p2p": {**self._p2p, "bytes": dict(self._p2p["bytes"])},
                "serving": {
                    **{k: v for k, v in serving.items() if k != "tenants"},
                    "occupancy": (serving["slot_steps"] / (steps * slots)
                                  if steps and slots else 0.0),
                    "tenants": {t: dict(v) for t, v in
                                serving["tenants"].items()},
                },
                "faults": {"injected": dict(self._faults["injected"]),
                           "restart_epoch": self._faults["restart_epoch"]},
                "membership": {
                    **self._membership,
                    "ranks_lost": list(
                        self._membership.get("ranks_lost", [])),
                    "ranks_joined": list(
                        self._membership.get("ranks_joined", [])),
                },
                "state": {
                    **self._state,
                    "overlap_ratio": (
                        self._state["async_sec"]
                        / (self._state["async_sec"]
                           + self._state["blocked_sec"])
                        if self._state["async_sec"]
                        + self._state["blocked_sec"] > 0 else 1.0),
                    "ckpt": dict(self._ckpt),
                },
                "compression": {
                    **{k: v for k, v in self._compression.items()
                       if k != "planes"},
                    "planes": {p: {**v, "ops": dict(v["ops"])}
                               for p, v in
                               self._compression["planes"].items()},
                },
                "autotune": {
                    **self._autotune,
                    "history": [dict(h) for h in
                                self._autotune.get("history", [])],
                    "applied": [dict(a) for a in
                                self._autotune.get("applied", [])],
                },
                "histograms": {name: h.to_dict()
                               for name, h in self._hists.items()},
            }


registry = MetricsRegistry()
