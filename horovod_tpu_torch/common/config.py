"""The engine's runtime knobs, read from the environment.

Own copy of ``horovod_tpu/common/config.py`` (``Config.from_env``,
``parse_compression``), trimmed to the knobs the port passes to
``hvd_tpu_init``: the cycle time, the fusion threshold, the stall warning,
the timeline path (``HVD_TPU_TIMELINE``, resolved per rank by
``common._resolve_timeline_path``), the collective timeout, the response
cache and the steady state, online autotuning (``HVD_TPU_AUTOTUNE``,
``HVD_TPU_AUTOTUNE_WARMUP``, ``HVD_TPU_AUTOTUNE_WINDOW``,
``HVD_TPU_AUTOTUNE_FIX``: ``common/autotune.py``), wire compression
(``HVD_TPU_COMPRESSION``, ``HVD_TPU_COMPRESSION_MIN_BYTES``), elastic
membership (``HVD_TPU_ELASTIC``, ``HVD_TPU_MIN_NP``, ``HVD_TPU_REJOIN``,
and ``HVD_TPU_RESTART_EPOCH``, which the engine also reads itself) and
the process fault injector (``HVD_TPU_FAULT_SPEC``, ``common/faults.py``).
The reference's ``HOROVOD_*`` spellings are honoured beside the
``HVD_TPU_*`` ones, the new names winning.

The engine's other planes have no port yet: the hierarchical allreduce
(and the shared-memory transport that rides on it), the coordinator
tree, the metrics file and monitor, postmortem dumps, the network fault
injector and the XLA data plane (``HVD_TPU_METRICS`` is honoured as far
as the port's registry goes: ``common/metrics.py``).  The port passes
each one's "off" value to the engine,
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
# itself (``getenv`` in ``engine/cc/engine.cc``): the shared-memory
# transport, the flight recorder, link statistics, the anomaly detector
# and the network fault injector.
UNPORTED = (
    ("hierarchical allreduce", ("HVD_TPU_HIERARCHICAL_ALLREDUCE",
                                "HOROVOD_HIERARCHICAL_ALLREDUCE")),
    ("coordinator tree", ("HVD_TPU_COORD_TREE",)),
    # The engine arms it only on the two-level topology of the
    # hierarchical allreduce; the port's ranks talk TCP.
    ("shared-memory transport", ("HVD_TPU_SHM", "HVD_TPU_SHM_RING_BYTES")),
    ("metrics", ("HVD_TPU_METRICS_FILE",
                 "HVD_TPU_MONITOR_PORT", "HVD_TPU_LINK_STATS",
                 "HVD_TPU_ANOMALY_SIGMA", "HVD_TPU_ANOMALY_INTERVAL_MS")),
    ("postmortem dumps", ("HVD_TPU_POSTMORTEM_DIR", "HVD_TPU_FLIGHT_EVENTS")),
    ("fault injection", ("HVD_TPU_NET_FAULT_SPEC",)),
    ("XLA data plane", ("HVD_TPU_XLA_DATA_PLANE", "HOROVOD_XLA_DATA_PLANE")),
)
# The other variables the engine reads itself, which the port supports as
# the reference does: the data plane's heartbeat failure detector
# (``HVD_TPU_HEARTBEAT_MS``, 0 turns it off; ``HVD_TPU_HEARTBEAT_MISS``)
# and the restart epoch (which names the shared-memory segment of a
# relaunched job: read, harmless while that transport is unported).
ENGINE_SUPPORTED = ("HVD_TPU_HEARTBEAT_MS", "HVD_TPU_HEARTBEAT_MISS",
                    "HVD_TPU_RESTART_EPOCH")
_OFF = ("", "0", "false", "no", "off", "none")

# Wire-compression spellings -> the engine's CompressionMode codes
# (``engine/cc/wire.h``), as the reference's.
COMPRESSION_CODES = {"off": 0, "none": 0, "0": 0, "": 0,
                     "bf16": 1, "bfloat16": 1,
                     "fp8": 2, "fp8_e4m3": 2, "float8_e4m3fn": 2}
COMPRESSION_NAMES = {0: "off", 1: "bf16", 2: "fp8"}


def parse_compression(value: Optional[str]) -> int:
    """``HVD_TPU_COMPRESSION`` spelling -> CompressionMode code; raises
    ``ValueError`` on an unknown mode."""
    key = (value or "off").strip().lower()
    if key not in COMPRESSION_CODES:
        raise ValueError(
            f"HVD_TPU_COMPRESSION: unknown wire-compression mode {value!r} "
            f"(want off, bf16, or fp8)")
    return COMPRESSION_CODES[key]


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
    # Chrome-trace output: a file (rank 0 only), a ``%d`` template or a
    # directory (one file per rank); empty is no timeline.
    timeline_path: str = ""
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
    # HVD_TPU_METRICS: the registry's gated histogram (common/metrics.py).
    metrics: bool = False
    # The process fault injector's spec (common/faults.py), e.g.
    # "rank=1:crash@op=12; rank=2:hang@op=5".
    fault_spec: str = ""
    # The launcher's relaunch counter (--max-restarts): 0 on the first
    # run.  Gates fault clauses without epoch= to the first run.
    restart_epoch: int = 0
    # Elastic membership (HVD_TPU_ELASTIC=1 from the launcher's
    # --min-np/--max-np): a rank's death reshapes the job around the
    # survivors while at least min_np remain; HVD_TPU_REJOIN=1 marks a
    # standby that the coordinator admits at the next reshape barrier.
    elastic: bool = False
    min_np: int = 1
    rejoin: bool = False
    # Online autotuning (common/autotune.py): the coordinator tunes the
    # fusion threshold and the cycle time (and the compression mode, when
    # compression is on) and broadcasts each candidate so every rank
    # applies it at the same tick.  The first ``autotune_warmup`` windows
    # of ``autotune_window`` negotiated collectives are discarded;
    # ``autotune_fix`` pins knobs ("fusion_threshold=67108864,...").
    autotune: bool = False
    autotune_warmup: int = 2
    autotune_window: int = 32
    autotune_fix: str = ""
    # Wire compression: float32 allreduce buckets of at least
    # ``compression_min_bytes`` cross the wire as bf16 or fp8-e4m3, with
    # float32 sums at every hop and an error-feedback residual per tensor
    # name.  Agreed job-wide at init (a mixed environment is a typed
    # error); "off", the default, keeps the float32 wire bit-identical.
    # f16/bf16 payloads ship at their own width either way.
    compression: str = "off"
    compression_min_bytes: int = 1024

    @property
    def compression_code(self) -> int:
        """The engine's CompressionMode code for ``compression``; raises
        ``ValueError`` on an unknown spelling."""
        return parse_compression(self.compression)

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
        timeline = _get("HVD_TPU_TIMELINE", "HOROVOD_TIMELINE")
        return Config(
            fusion_threshold=(int(fusion) if fusion
                              else DEFAULT_FUSION_THRESHOLD),
            cycle_time_ms=float(cycle) if cycle else DEFAULT_CYCLE_TIME_MS,
            stall_warning_sec=(float(stall) if stall
                               else DEFAULT_STALL_WARNING_SEC),
            timeline_path=timeline or "",
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
            metrics=_flag(os.environ.get("HVD_TPU_METRICS")),
            fault_spec=os.environ.get("HVD_TPU_FAULT_SPEC", ""),
            restart_epoch=int(os.environ.get(
                "HVD_TPU_RESTART_EPOCH") or 0),
            elastic=_flag(os.environ.get("HVD_TPU_ELASTIC")),
            min_np=int(os.environ.get("HVD_TPU_MIN_NP") or 1),
            rejoin=_flag(os.environ.get("HVD_TPU_REJOIN")),
            autotune=_flag(os.environ.get("HVD_TPU_AUTOTUNE")),
            autotune_warmup=int(os.environ.get(
                "HVD_TPU_AUTOTUNE_WARMUP") or 2),
            autotune_window=int(os.environ.get(
                "HVD_TPU_AUTOTUNE_WINDOW") or 32),
            autotune_fix=os.environ.get("HVD_TPU_AUTOTUNE_FIX", ""),
            compression=os.environ.get("HVD_TPU_COMPRESSION", "off"),
            compression_min_bytes=int(os.environ.get(
                "HVD_TPU_COMPRESSION_MIN_BYTES") or 1024),
        )
