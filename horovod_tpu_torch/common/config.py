"""The engine's runtime knobs, read from the environment.

Own copy of ``horovod_tpu/common/config.py`` (``Config.from_env``),
trimmed to the knobs the port passes to ``hvd_tpu_init``: the cycle time,
the fusion threshold, the stall warning, the collective timeout, the
response cache and the steady state.  The reference's ``HOROVOD_*``
spellings are honoured beside the ``HVD_TPU_*`` ones, the new names
winning.

The engine's other planes have no port yet: elastic membership, wire
compression, autotuning, the hierarchical allreduce (and the
shared-memory transport that rides on it), the coordinator tree, the
timeline, metrics, postmortem dumps, fault injection and the
XLA data plane.  The port passes each one's "off" value to the engine,
and :meth:`Config.unported_requests` names every variable of the
environment that asks for one of them, which ``init()`` refuses rather
than ignore.  The engine reads a few variables itself: those of unported
planes are in ``UNPORTED`` too (their "off" value, such as
``HVD_TPU_LINK_STATS=0``, is accepted; unset, the engine keeps its own
defaults, as in the reference), the rest in ``ENGINE_SUPPORTED``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes, as the reference
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_STALL_WARNING_SEC = 60.0

# (plane, the variables that ask for it).  The engine reads some of them
# itself (``getenv`` in ``engine/cc/engine.cc``): the restart epoch, the
# shared-memory transport, the flight recorder, link statistics, the
# anomaly detector and the network fault injector.
UNPORTED = (
    ("elastic membership", ("HVD_TPU_ELASTIC", "HVD_TPU_REJOIN",
                            "HVD_TPU_RESTART_EPOCH")),
    ("wire compression", ("HVD_TPU_COMPRESSION",)),
    ("autotuning", ("HVD_TPU_AUTOTUNE", "HVD_TPU_AUTOTUNE_FIX")),
    ("hierarchical allreduce", ("HVD_TPU_HIERARCHICAL_ALLREDUCE",
                                "HOROVOD_HIERARCHICAL_ALLREDUCE")),
    ("coordinator tree", ("HVD_TPU_COORD_TREE",)),
    # The engine arms it only on the two-level topology of the
    # hierarchical allreduce; the port's ranks talk TCP.
    ("shared-memory transport", ("HVD_TPU_SHM", "HVD_TPU_SHM_RING_BYTES")),
    ("timeline", ("HVD_TPU_TIMELINE", "HOROVOD_TIMELINE")),
    ("metrics", ("HVD_TPU_METRICS", "HVD_TPU_METRICS_FILE",
                 "HVD_TPU_MONITOR_PORT", "HVD_TPU_LINK_STATS",
                 "HVD_TPU_ANOMALY_SIGMA", "HVD_TPU_ANOMALY_INTERVAL_MS")),
    ("postmortem dumps", ("HVD_TPU_POSTMORTEM_DIR", "HVD_TPU_FLIGHT_EVENTS")),
    ("fault injection", ("HVD_TPU_FAULT_SPEC", "HVD_TPU_NET_FAULT_SPEC")),
    ("XLA data plane", ("HVD_TPU_XLA_DATA_PLANE", "HOROVOD_XLA_DATA_PLANE")),
)
# The other variables the engine reads itself, which the port supports as
# the reference does: the data plane's heartbeat failure detector
# (``HVD_TPU_HEARTBEAT_MS``, 0 turns it off; ``HVD_TPU_HEARTBEAT_MISS``).
ENGINE_SUPPORTED = ("HVD_TPU_HEARTBEAT_MS", "HVD_TPU_HEARTBEAT_MISS")
_OFF = ("", "0", "false", "no", "off", "none")


def _get(new: str, old: str) -> Optional[str]:
    return os.environ.get(new, os.environ.get(old))


def _flag(value: Optional[str]) -> bool:
    return value is not None and value.strip().lower() not in _OFF


@dataclasses.dataclass(frozen=True)
class Config:
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD
    # The idle-tick floor of the engine loop: the fusion window.
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    stall_warning_sec: float = DEFAULT_STALL_WARNING_SEC
    # Past it a collective stuck in negotiation aborts the job with
    # CollectiveTimeoutError on every rank; <= 0 disables.
    collective_timeout_sec: float = 0.0
    # Negotiation response cache: repeats replay a slot index instead of
    # the string request; HVD_TPU_RESPONSE_CACHE=0 is the kill switch.
    response_cache: bool = True
    cache_capacity: int = 1024
    # Once a cycle's cache-hit pattern repeats this many times every rank
    # self-clocks it with no control message; 0 disables.
    steady_threshold: int = 32
    steady_max_period: int = 256

    @property
    def effective_cache_capacity(self) -> int:
        """Slots the engine is told to keep: 0 when the cache is off."""
        return self.cache_capacity if self.response_cache else 0

    @staticmethod
    def unported_requests() -> List[str]:
        """``"plane (VAR=value)"`` for every variable of the environment
        that asks for a plane the port does not have."""
        asked = []
        for plane, names in UNPORTED:
            for name in names:
                if _flag(os.environ.get(name)):
                    asked.append(f"{plane} ({name}={os.environ[name]})")
        return asked

    @staticmethod
    def from_env() -> "Config":
        fusion = _get("HVD_TPU_FUSION_THRESHOLD", "HOROVOD_FUSION_THRESHOLD")
        cycle = os.environ.get(
            "HVD_TPU_CYCLE_TIME_MS",
            _get("HVD_TPU_CYCLE_TIME", "HOROVOD_CYCLE_TIME"))
        stall = _get("HVD_TPU_STALL_WARNING_SEC", "HOROVOD_STALL_WARNING_SEC")
        return Config(
            fusion_threshold=(int(fusion) if fusion
                              else DEFAULT_FUSION_THRESHOLD),
            cycle_time_ms=float(cycle) if cycle else DEFAULT_CYCLE_TIME_MS,
            stall_warning_sec=(float(stall) if stall
                               else DEFAULT_STALL_WARNING_SEC),
            collective_timeout_sec=float(os.environ.get(
                "HVD_TPU_COLLECTIVE_TIMEOUT_SEC") or 0.0),
            response_cache=_flag(os.environ.get(
                "HVD_TPU_RESPONSE_CACHE", "1")),
            cache_capacity=int(os.environ.get(
                "HVD_TPU_CACHE_CAPACITY") or 1024),
            steady_threshold=int(os.environ.get(
                "HVD_TPU_STEADY_THRESHOLD") or 32),
            steady_max_period=int(os.environ.get(
                "HVD_TPU_STEADY_MAX_PERIOD") or 256),
        )
