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
the process fault injector (``HVD_TPU_FAULT_SPEC``, ``common/faults.py``);
and the knobs the Python side reads: the metrics registry
(``HVD_TPU_METRICS``, the per-rank dump ``HVD_TPU_METRICS_FILE``, the
HTTP monitor ``HVD_TPU_MONITOR_PORT``: ``common/metrics.py``) and the
postmortem plane (``HVD_TPU_POSTMORTEM_DIR``: ``common/postmortem.py``).
The reference's ``HOROVOD_*`` spellings are honoured beside the
``HVD_TPU_*`` ones, the new names winning.

The engine's topology and transport: the two-level allreduce
(``HVD_TPU_HIERARCHICAL_ALLREDUCE`` / ``HOROVOD_HIERARCHICAL_ALLREDUCE``:
a node-local reduce-scatter, one cross-node exchange per local rank, a
node-local allgather, on the launcher's contiguous-block layout) with its
ring-vs-tree boundary on the cross hop (``HVD_TPU_CROSS_ALGO_THRESHOLD``),
and the coordinator tree (``HVD_TPU_COORD_TREE``, on by default: a
multi-node layout's local-rank-0s aggregate their node's control frames;
one-host jobs keep the star).

The engine reads a few variables itself with ``getenv``
(``ENGINE_SUPPORTED``): the heartbeat detector, the restart epoch, the
flight recorder's ring size (``HVD_TPU_FLIGHT_EVENTS``, which the
postmortem plane's Python ring reads too), link statistics
(``HVD_TPU_LINK_STATS``), the anomaly detector
(``HVD_TPU_ANOMALY_SIGMA``, ``HVD_TPU_ANOMALY_INTERVAL_MS``), the network
fault injector (``HVD_TPU_NET_FAULT_SPEC``: the engine parses the spec at
init and a bad clause fails ``init()`` with ``bad
HVD_TPU_NET_FAULT_SPEC``) and the shared-memory transport of the
two-level allreduce's node-local hops (``HVD_TPU_SHM=auto|off|force``,
``HVD_TPU_SHM_RING_BYTES``).  ``Config`` parses them as well, so a bad
value fails ``init()`` before the engine starts.

The XLA data plane has no port yet (``UNPORTED``):
:meth:`Config.unported_requests` names every variable of the environment
that asks for it, which ``init()`` refuses rather than ignore.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes, as the reference
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_STALL_WARNING_SEC = 60.0

# (plane, the variables that ask for it): the one engine plane the port
# does not have, the device data plane, which needs a card per rank.
UNPORTED = (
    ("XLA data plane", ("HVD_TPU_XLA_DATA_PLANE", "HOROVOD_XLA_DATA_PLANE")),
)
# The variables the engine reads itself, which the port supports as the
# reference does: the data plane's heartbeat failure detector
# (``HVD_TPU_HEARTBEAT_MS``, 0 turns it off; ``HVD_TPU_HEARTBEAT_MISS``),
# the restart epoch (which also names a relaunched job's shared-memory
# segment), the flight recorder's ring size, link statistics, the anomaly
# detector, the network fault injector and the shared-memory transport.
ENGINE_SUPPORTED = ("HVD_TPU_HEARTBEAT_MS", "HVD_TPU_HEARTBEAT_MISS",
                    "HVD_TPU_RESTART_EPOCH", "HVD_TPU_FLIGHT_EVENTS",
                    "HVD_TPU_LINK_STATS", "HVD_TPU_ANOMALY_SIGMA",
                    "HVD_TPU_ANOMALY_INTERVAL_MS", "HVD_TPU_NET_FAULT_SPEC",
                    "HVD_TPU_SHM", "HVD_TPU_SHM_RING_BYTES")
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
    # The two-level allreduce: a node-local reduce-scatter, one cross-node
    # exchange per local rank over its 1/local_size shard, a node-local
    # allgather.  Needs the launcher's contiguous-block layout (equal
    # local_size on every node); the engine agrees it job-wide at init and
    # keeps the flat ring otherwise.  Buckets under
    # ``cross_algo_threshold`` bytes take the recursive-doubling tree on
    # the cross hop, the rest the ring; 0 is the ring always (the
    # autotuner's fourth axis).
    hierarchical_allreduce: bool = False
    cross_algo_threshold: int = 64 * 1024
    # The coordinator tree (default on): on a multi-node layout each
    # node's local rank 0 aggregates its node's announces into one frame a
    # tick and relays the broadcasts down, so rank 0 holds O(nodes)
    # control sockets.  A one-host layout keeps the star either way.
    coord_tree: bool = True
    # The network fault injector's spec, e.g. "link=0-1:drop@after=2",
    # "partition=0,1/2,3@after=1", "link=1-2:delay=5|jitter=3",
    # "link=0-3:flaky=0.05".  The engine parses it at init (a bad clause
    # is a typed init error); it composes with ``fault_spec``.
    net_fault_spec: str = ""
    # The node-local hops' transport (auto|off|force, default auto): with
    # the two-level allreduce, every rank of a node sharing a host hands
    # its segments through mmap'd shared-memory rings; "off" keeps TCP
    # (the data are bit-identical either way), "force" makes an init that
    # cannot arm the rings a typed error.  Agreed job-wide at init.  Each
    # direction's ring holds ``shm_ring_bytes`` (the engine floors it at
    # 64 KiB and rounds it up to a power of two).
    shm: str = "auto"
    shm_ring_bytes: int = 1 << 20
    # The metrics registry (common/metrics.py): ``metrics`` turns on the
    # gated records (the collective-layer counters and histograms);
    # a metrics file (a JSON dump per rank at shutdown, ``<file>.<rank>``)
    # or a monitor port (HTTP /metrics at port + local_rank) implies it.
    metrics: bool = False
    metrics_file: str = ""
    monitor_port: Optional[int] = None
    # The postmortem plane (common/postmortem.py): the directory every
    # rank writes its rank-<N>.json dump into on a typed abort, an
    # injected crash or a fatal exception; empty disables.  The flight
    # recorder's ring size (the engine's and the Python ring's); 0
    # disables recording.
    postmortem_dir: str = ""
    flight_events: int = 512
    # Per-peer link statistics at the engine's net layer; the anomaly
    # detector's threshold (median + sigma * MAD; 0 disables it) and its
    # sweep period (floored at 10 ms by the engine).
    link_stats: bool = True
    anomaly_sigma: int = 5
    anomaly_interval_ms: int = 500
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

    @property
    def metrics_enabled(self) -> bool:
        return bool(self.metrics or self.metrics_file
                    or self.monitor_port is not None)

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
            metrics_file=os.environ.get("HVD_TPU_METRICS_FILE", ""),
            monitor_port=(int(port) if (port := os.environ.get(
                "HVD_TPU_MONITOR_PORT")) else None),
            postmortem_dir=os.environ.get("HVD_TPU_POSTMORTEM_DIR", ""),
            flight_events=int(os.environ.get(
                "HVD_TPU_FLIGHT_EVENTS") or 512),
            link_stats=_flag(os.environ.get("HVD_TPU_LINK_STATS", "1")),
            anomaly_sigma=int(os.environ.get("HVD_TPU_ANOMALY_SIGMA")
                              if os.environ.get("HVD_TPU_ANOMALY_SIGMA")
                              not in (None, "") else 5),
            anomaly_interval_ms=int(os.environ.get(
                "HVD_TPU_ANOMALY_INTERVAL_MS") or 500),
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
            hierarchical_allreduce=_flag(
                _get("HVD_TPU_HIERARCHICAL_ALLREDUCE",
                     "HOROVOD_HIERARCHICAL_ALLREDUCE")),
            cross_algo_threshold=int(os.environ.get(
                "HVD_TPU_CROSS_ALGO_THRESHOLD") or 64 * 1024),
            coord_tree=_flag(os.environ.get("HVD_TPU_COORD_TREE", "1")),
            net_fault_spec=os.environ.get("HVD_TPU_NET_FAULT_SPEC", ""),
            shm=os.environ.get("HVD_TPU_SHM", "auto") or "auto",
            shm_ring_bytes=int(os.environ.get(
                "HVD_TPU_SHM_RING_BYTES") or (1 << 20)),
        )
