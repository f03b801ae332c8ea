"""The port's metrics registry, trimmed to what the serving plane and the
point-to-point plane record.

Own copy of the serving half of ``horovod_tpu/common/metrics.py``: the
request-lifecycle counters, decode-step occupancy, KV-pool gauges and
per-tenant counters (tenant names come from the network, so their number
is bounded), the serving latency histograms, and the engine's response
cache and point-to-point counters that ``hvd.metrics_snapshot()`` folds
in.  Everything is
recorded whether or not metrics are enabled, as in the reference, except
the engine's ``step_sec``, which it observes only while ``enabled``
(``HVD_TPU_METRICS=1``).  The metrics file dump, the Prometheus monitor
and the collective-layer counters are not ported (``config.UNPORTED``).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Tuple

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
}

# Request-lifecycle events: the keys of the snapshot's "serving" section.
SERVING_EVENTS = ("requests", "admitted", "rejected", "retired", "failed",
                  "preempted")

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
        self._hists = {name: Histogram(bounds)
                       for name, (bounds, _) in HISTOGRAMS.items()}

    def enable(self) -> None:
        self.enabled = True

    def reset(self) -> None:
        with self._lock:
            self._init_state()

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
                "histograms": {name: h.to_dict()
                               for name, h in self._hists.items()},
            }


registry = MetricsRegistry()
