"""Process API of the PyTorch port and its seam to the collective engine.

Counterpart of ``horovod_tpu/common/__init__.py``: the engine library
(``engine/cc``, the port's own copy, built at first use by
``engine/build.py``) is loaded with ``ctypes``; ``init``/``shutdown`` start
and stop it (``init(comm=...)`` on a subset of the launcher's ranks);
``rank``/``size``/``local_rank``/``local_size`` come from it;
``allreduce_async``/``allgather_async``/``broadcast_async`` enqueue
named collectives on contiguous CPU tensors through their ``data_ptr()``
and return a :class:`Handle`; ``allreduce_async(..., group=)`` scopes a
reduction to a :class:`StageGroup`, and ``send_async``/``recv_async`` are
the point-to-point plane a pipeline moves its activations on
(``docs/pipeline.md``).  The engine negotiates the names across
ranks, fuses what is ready in one cycle, and runs a ring over TCP on the
host.  CUDA tensors reach it only through ``horovod_tpu_torch.torch``,
which stages them in pinned host memory: the engine never sees a device
pointer.

:func:`metrics_snapshot` reads the metrics registry
(``common/metrics.py``) with the engine's sections mirrored in first:
stalls, aborts, the coordinator's announce order, the response cache,
autotuning, membership, the flight recorder, compression, topology, the
control plane, liveness, per-peer links, anomaly verdicts and the
point-to-point plane.  ``HVD_TPU_METRICS=1`` (or a metrics file or a
monitor port) turns on the collective-layer records: ops and bytes at
enqueue, ``negotiation_sec``, ``wait_sec`` and bytes out in
:meth:`Handle.wait`, ``step_sec`` in ``build_train_step``.
``HVD_TPU_METRICS_FILE`` writes a JSON dump per rank at :func:`shutdown`;
``HVD_TPU_MONITOR_PORT`` serves ``/metrics``, ``/metrics.json`` and
``/health`` at ``port + local_rank``, and ``/cluster`` on rank 0.
``HVD_TPU_POSTMORTEM_DIR`` turns on the postmortem plane
(``common/postmortem.py``): a typed abort, an injected crash, a fatal
uncaught exception or an abort that nobody consumed leaves this rank's
``rank-<N>.json``.  ``HVD_TPU_TIMELINE`` (or ``HOROVOD_TIMELINE``; the
launcher's ``--timeline DIR``) turns on the engine's Chrome-trace timeline
(``docs/timeline.md``): each collective's ``NEGOTIATE`` and op spans on a
row of its name, and the application's spans through
:func:`trace_span` and :func:`trace_marker`.

Elastic membership (``HVD_TPU_ELASTIC``, set by the launcher's
``--min-np``/``--max-np``): when a rank dies the engine reshapes the job
around the survivors at a tick boundary, the collectives in flight fail
with the retryable :class:`MembershipChangedError`, ``rank()``/``size()``
(and ``local_rank()``/``local_size()``: elastic jobs are single-host)
follow the new dense membership, and :func:`membership_epoch` counts the
reshapes; ``common/elastic.py``'s ``run_elastic`` acknowledges them
(:func:`membership_ack`) and resyncs the state.  ``HVD_TPU_FAULT_SPEC``
arms the process fault injector (``common/faults.py``) at the end of
``init()``, at the collective entry points below.

Wire compression (``HVD_TPU_COMPRESSION=bf16|fp8``): float32 allreduce
buckets at or above ``HVD_TPU_COMPRESSION_MIN_BYTES`` cross the engine's
ring narrowed, with an error-feedback residual per tensor name;
:func:`compression_report` reads the mode, the wire and payload bytes,
the buckets per mode, the residuals and the per-bucket decision log.
Online autotuning (``HVD_TPU_AUTOTUNE=1``, ``common/autotune.py``): the
coordinator tunes the fusion threshold, the cycle time and (with
compression on) the wire mode, and every rank applies each candidate at
the same tick; :func:`autotune_report` reads it, :func:`autotune_set`
injects parameters from rank 0.

Topology (``common/config.py``): ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``
runs each allreduce in two levels over the launcher's contiguous-block
layout (``HVD_TPU_LOCAL_SIZE`` ranks a node: a node-local
reduce-scatter, one cross-node exchange per local rank, ring or tree by
``HVD_TPU_CROSS_ALGO_THRESHOLD``, a node-local allgather); the node-local
hops go through shared-memory rings (``HVD_TPU_SHM``, default ``auto``)
when the node's ranks share a host.  A multi-node layout builds the
coordinator tree (``HVD_TPU_COORD_TREE``, default on).
``HVD_TPU_NET_FAULT_SPEC`` (the launcher's ``--net-fault-spec``) arms the
engine's network fault injector: dropped, delayed or chopped sends on
named links, partitions.  The library's ``hvd_tpu_simscale_run`` runs
a fleet of simulated ranks in one process (the control plane at scale).
Not ported: the XLA data plane (``config.UNPORTED``).
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import json
import os
import re
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Union

from horovod_tpu_torch.common import dtypes, metrics
from horovod_tpu_torch.common.basics import (ProcessSet, comm_ranks,
                                             resolve_process_set)
from horovod_tpu_torch.common.config import Config

__all__ = [
    "HorovodInternalError", "RanksDownError", "CollectiveTimeoutError",
    "HorovodNotInitializedError", "MembershipChangedError", "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "resolve_device",
    "Handle", "allreduce_async", "allgather_async", "broadcast_async",
    "allreduce", "allgather", "broadcast", "StageGroup", "stage_group",
    "send_async", "recv_async", "send", "recv", "metrics_snapshot",
    "metrics_reset", "timeline_enabled", "trace_span", "trace_marker",
    "restart_epoch", "membership_epoch", "membership_ack",
    "compression_report", "autotune_report", "autotune_set",
    "mpi_threads_supported",
]

# Op codes shared with the engine (engine/cc/wire.h OpType).
OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_SEND = 4
OP_RECV = 5

# Status codes (engine/cc/wire.h StatusCode).
ST_OK = 0
ST_UNKNOWN = 1
ST_PRECONDITION = 2
ST_ABORTED = 3
ST_INVALID = 4
ST_PENDING = 5
ST_RANKS_DOWN = 6
ST_TIMEOUT = 7
ST_RESHAPE = 8


class HorovodInternalError(RuntimeError):
    """An unrecoverable engine error, or a job the engine cannot run."""


class RanksDownError(HorovodInternalError):
    """A coordinated abort because one or more ranks died; ``ranks``
    names them (empty when the message does not parse)."""

    def __init__(self, message: str, ranks=()):  # noqa: D107
        super().__init__(message)
        self.ranks = list(ranks)


class CollectiveTimeoutError(HorovodInternalError):
    """A coordinated abort because a collective stalled past
    ``HVD_TPU_COLLECTIVE_TIMEOUT_SEC``."""


class MembershipChangedError(HorovodInternalError):
    """Retryable: the elastic job reshaped (ranks died and the survivors
    agreed on a new size and ranks at a tick boundary, or a standby was
    admitted) and this collective was cancelled at the barrier.  No
    relaunch or checkpoint load is needed: acknowledge the membership and
    resync the state (``run_elastic`` does both).  ``lost_ranks`` names
    the dead ranks in the previous membership's numbering (empty when
    the job only grew)."""

    def __init__(self, message: str, lost_ranks=()):  # noqa: D107
        super().__init__(message)
        self.lost_ranks = list(lost_ranks)


class HorovodNotInitializedError(HorovodInternalError, ValueError):
    """A call that needs a running engine came before ``hvd.init()`` (or
    after ``hvd.shutdown()``)."""


_lib = None
_lib_lock = threading.Lock()
# Called (no arguments) by shutdown() before the engine stops: the torch
# binding drains its staging thread and drops its pinned buffers there.
_shutdown_hooks: List[Callable[[], None]] = []
# The process fault injector (common/faults.py) of this rank and restart
# epoch, or None, and the index of the next collective it counts.
_fault_injector = None
_collective_seq = 0
_fault_lock = threading.Lock()
# This rank's HVD_TPU_METRICS_FILE dump path (``<file>.<rank>``), or None.
_metrics_file: Optional[str] = None


def _declare(lib, name, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)


def _load_lib():
    """The engine library, built first if needed, loaded ``RTLD_LOCAL``
    with only the C functions the port calls declared."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from horovod_tpu_torch.engine.build import build

        lib = ctypes.CDLL(build(), mode=ctypes.RTLD_LOCAL)
        c_int, c_ll, c_dbl, c_str, c_ptr = (
            ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
            ctypes.c_char_p, ctypes.c_void_p)
        _declare(lib, "hvd_tpu_init", c_int,
                 c_int, c_int, c_int, c_int, c_str, c_str, c_dbl, c_ll,
                 c_dbl, c_str, c_int, c_dbl, c_ll, c_int, c_ll, c_ll, c_ll,
                 c_dbl, c_int, c_ll, c_int, c_int, c_ll, c_ll, c_ll, c_ll,
                 c_int, c_ll, c_ll)
        _declare(lib, "hvd_tpu_init_error", c_str)
        # The engine's in-process fleet of simulated ranks (the control
        # plane at scale; the reference's signature): size, local size,
        # ops a cycle, warm and steady cycles, the steady threshold, the
        # tree, a base port, a timeout, and a buffer for its JSON report.
        _declare(lib, "hvd_tpu_simscale_run", c_int, c_int, c_int, c_int,
                 c_int, c_int, c_ll, c_int, c_int, c_dbl, c_str, c_ll)
        _declare(lib, "hvd_tpu_shutdown", None)
        for name in ("hvd_tpu_initialized", "hvd_tpu_rank", "hvd_tpu_size",
                     "hvd_tpu_local_rank", "hvd_tpu_local_size",
                     "hvd_tpu_abort_code"):
            _declare(lib, name, c_int)
        _declare(lib, "hvd_tpu_abort_message", c_str)
        _declare(lib, "hvd_tpu_enqueue", c_ll, c_int, c_str, c_ptr, c_ptr,
                 ctypes.POINTER(c_ll), c_int, c_int, c_int, c_int)
        _declare(lib, "hvd_tpu_enqueue_p2p", c_ll, c_int, c_str, c_ptr,
                 c_ptr, ctypes.POINTER(c_ll), c_int, c_int, c_int, c_int)
        _declare(lib, "hvd_tpu_enqueue_group", c_ll, c_str, c_ptr, c_ptr,
                 ctypes.POINTER(c_ll), c_int, c_int, c_int,
                 ctypes.POINTER(c_ll), c_int)
        _declare(lib, "hvd_tpu_p2p_info", c_str)
        for name in ("hvd_tpu_poll", "hvd_tpu_wait", "hvd_tpu_status"):
            _declare(lib, name, c_int, c_ll)
        _declare(lib, "hvd_tpu_error", c_str, c_ll)
        for name in ("hvd_tpu_completion_tick", "hvd_tpu_result_nbytes",
                     "hvd_tpu_result_dim0"):
            _declare(lib, name, c_ll, c_ll)
        _declare(lib, "hvd_tpu_result_ptr", c_ptr, c_ll)
        _declare(lib, "hvd_tpu_release", None, c_ll)
        for name in ("hvd_tpu_cache_hit_count", "hvd_tpu_cache_miss_count",
                     "hvd_tpu_cache_eviction_count", "hvd_tpu_cache_size"):
            _declare(lib, name, c_ll)
        _declare(lib, "hvd_tpu_timeline_enabled", c_int)
        _declare(lib, "hvd_tpu_timeline_op_start", None, c_str, c_str)
        _declare(lib, "hvd_tpu_timeline_op_end", None, c_str, c_ll)
        _declare(lib, "hvd_tpu_timeline_instant", None, c_str, c_str)
        _declare(lib, "hvd_tpu_timeline_flush", None)
        for name in ("hvd_tpu_membership_epoch",
                     "hvd_tpu_membership_reshapes"):
            _declare(lib, name, c_ll)
        _declare(lib, "hvd_tpu_membership_info", c_str)
        _declare(lib, "hvd_tpu_membership_ack", None)
        for name in ("hvd_tpu_autotune_enabled", "hvd_tpu_autotune_frozen",
                     "hvd_tpu_compression_mode"):
            _declare(lib, name, c_int)
        for name in ("hvd_tpu_autotune_windows",
                     "hvd_tpu_autotune_fusion_threshold",
                     "hvd_tpu_autotune_cycle_time_us",
                     "hvd_tpu_autotune_cross_algo_threshold"):
            _declare(lib, name, c_ll)
        _declare(lib, "hvd_tpu_autotune_best_score", c_dbl)
        for name in ("hvd_tpu_autotune_history", "hvd_tpu_autotune_applied",
                     "hvd_tpu_compression_info", "hvd_tpu_compression_log"):
            _declare(lib, name, c_str)
        _declare(lib, "hvd_tpu_autotune_set", c_int, c_ll, c_dbl, c_ll,
                 c_ll)
        _declare(lib, "hvd_tpu_compression_mode_at", c_ll, c_ll)
        _declare(lib, "hvd_tpu_negotiation_us", c_ll, c_ll)
        for name in ("hvd_tpu_stall_count", "hvd_tpu_abort_count",
                     "hvd_tpu_flight_count"):
            _declare(lib, name, c_ll)
        for name in ("hvd_tpu_stall_info", "hvd_tpu_announce_log",
                     "hvd_tpu_last_announce_counts", "hvd_tpu_anomaly_info",
                     "hvd_tpu_anomaly_log", "hvd_tpu_control_info",
                     "hvd_tpu_liveness_info", "hvd_tpu_link_info",
                     "hvd_tpu_topology_info", "hvd_tpu_topology_log",
                     "hvd_tpu_flight_dump", "hvd_tpu_pending_info",
                     "hvd_tpu_coord_pending_info", "hvd_tpu_diagnosis"):
            _declare(lib, name, c_str)
        _lib = lib
        return lib


def _pin_device(device, ps: ProcessSet) -> None:
    """Make the device this process computes on current, once, at
    ``init()``: ``cuda:local_rank()`` by default, ``device`` where the
    caller names one (``"cpu"`` for the CPU tests, ``"cuda:N"`` to put
    several ranks on one card).

    Under elastic membership the launcher gives every process a device
    slot (``HVD_TPU_DEVICE_SLOT``): a first-launch rank's is its rank, a
    standby's the lowest slot no running process holds (its own
    ``local_rank`` is a placeholder until the coordinator admits it), and
    the default device is ``cuda:<slot>``.  A reshape renumbers the
    survivors' ranks but never moves their device: their tensors live
    there."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: horovod_tpu_torch runs on a GPU; pass "
                "device='cpu' to run on the CPU explicitly")
        count = torch.cuda.device_count()
        slot = int(os.environ.get("HVD_TPU_DEVICE_SLOT") or ps.local_rank)
        if slot >= count:
            raise HorovodInternalError(
                f"device slot {slot} has no CUDA device of its own "
                f"({count} visible); name one with "
                "hvd.init(device='cuda:N') (ranks may share a device)")
        dev = torch.device("cuda", slot)
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"no CUDA device for {device!r}")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev.index >= torch.cuda.device_count():
                raise HorovodInternalError(
                    f"{device!r}: only {torch.cuda.device_count()} CUDA "
                    "devices visible")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def _resolve_timeline_path(path: str, rank: int, epoch: int = 0) -> str:
    """This rank's trace file for ``HVD_TPU_TIMELINE``'s forms
    (``docs/timeline.md``): a ``%d`` template or a directory (existing,
    or a path ending in the separator, created here) give one file per
    rank (``rank<N>.json`` in a directory); a plain file path is rank 0's
    alone.  A non-zero restart epoch (``--max-restarts``) lands in the
    name (``rank<N>.e<E>.json``), so a relaunch cannot truncate the
    crashed attempt's traces.  Own copy of the reference's."""
    if not path:
        return ""
    suffix = f".e{epoch}" if epoch else ""
    if "%d" in path:
        resolved = path.replace("%d", str(rank)) + suffix
        parent = os.path.dirname(resolved)
        if parent:
            os.makedirs(parent, exist_ok=True)
        return resolved
    if path.endswith(os.sep) or os.path.isdir(path):
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, f"rank{rank}{suffix}.json")
    return path if rank == 0 else ""


def init(comm: Union[Sequence[int], Any, None] = None,
         device: Optional[str] = None) -> None:
    """Start the engine and pin this process's device.

    Identity comes from the launcher's environment (rank 0 of 1 without
    one).  ``comm`` restricts the job to a subset of the launcher's
    ranks, in either form the reference's ``hvd.init(comm=...)`` takes:
    a rank list, or an mpi4py-style communicator (duck-typed through
    ``Get_size`` and ``allgather``, :func:`~.basics.comm_ranks`; no MPI).
    The subset is numbered by list position, its coordinator listens on
    its first member's host, and the engine starts on the members'
    endpoints only; a launched rank outside it must not call ``init()``
    (it may simply exit).  ``device=None`` pins ``cuda:local_rank()`` (of
    the subset), which must exist;
    ``device="cuda:N"`` pins N (several ranks may share it);
    ``device="cpu"`` pins nothing: the CPU tests, on CPU tensors.  A knob
    of an unported engine plane in the environment raises
    :class:`HorovodInternalError`; an unknown ``HVD_TPU_COMPRESSION``
    mode, a bad ``HVD_TPU_AUTOTUNE_FIX``, a lossy compression pin while
    compression is off, and a ``cross_algo_threshold`` pin on the flat
    ring (no ``HOROVOD_HIERARCHICAL_ALLREDUCE``: the knob is dead there)
    raise ``ValueError``, as in the reference; a bad
    ``HVD_TPU_NET_FAULT_SPEC`` clause, or ``HVD_TPU_SHM=force`` where the
    shared-memory rings cannot arm, fails the engine's init
    (:class:`HorovodInternalError`).  The hierarchical allreduce, its
    cross-algo threshold and the coordinator tree reach the engine as
    ``Config`` reads them.  With
    ``HVD_TPU_TIMELINE`` set the engine writes this rank's Chrome trace
    (:func:`_resolve_timeline_path`; a standby, ``HVD_TPU_REJOIN``,
    writes none: its rank is a placeholder until it is admitted).  With
    ``HVD_TPU_ELASTIC`` the engine reshapes the job when a rank dies
    (:class:`MembershipChangedError`).  ``HVD_TPU_METRICS_FILE`` names
    this rank's dump (``<file>.<rank>``, written at :func:`shutdown`);
    ``HVD_TPU_MONITOR_PORT`` starts the HTTP monitor at ``port +
    local_rank`` (0: a free port; a port already taken warns and the job
    goes on without it), and rank 0's monitor serves ``/cluster`` over
    every rank's; ``HVD_TPU_POSTMORTEM_DIR`` chains an excepthook that
    dumps on a fatal uncaught exception.  ``HVD_TPU_FAULT_SPEC`` arms the
    fault injector last, so ``op=N`` counts the caller's collectives
    from 0.  Idempotent.
    """
    global _fault_injector, _collective_seq, _metrics_file
    if is_initialized():
        return
    if comm is not None and hasattr(comm, "Get_size"):
        comm = comm_ranks(comm, resolve_process_set().rank)
    ps = resolve_process_set(comm)
    asked = Config.unported_requests()
    if asked:
        raise HorovodInternalError(
            "the environment asks for engine planes horovod_tpu_torch does "
            "not have: " + "; ".join(asked))
    cfg = Config.from_env()
    from horovod_tpu_torch.common import autotune as _autotune

    fix_fusion, fix_cycle, fix_comp, fix_algo = _autotune.parse_fix(
        cfg.autotune_fix)
    compression_code = cfg.compression_code  # ValueError on a bad mode
    if fix_comp > 0 and compression_code == 0:
        # The engine pins the compression axis at "none" for a job that
        # did not opt in: the pin would be dropped silently.
        raise ValueError(
            "HVD_TPU_AUTOTUNE_FIX pins a lossy wire-compression mode but "
            "HVD_TPU_COMPRESSION is off; set HVD_TPU_COMPRESSION=bf16|fp8 "
            "(or drop the compression pin).")
    if fix_algo >= 0 and not cfg.hierarchical_allreduce:
        # The flat ring pins the axis at the environment's value: the pin
        # would be dropped silently.
        raise ValueError(
            "HVD_TPU_AUTOTUNE_FIX pins cross_algo_threshold but the flat "
            "ring has no cross-node hop; set "
            "HVD_TPU_HIERARCHICAL_ALLREDUCE=1 (or drop the pin).")
    if cfg.metrics_enabled:
        metrics.registry.enable()
    _pin_device(device, ps)
    lib = _load_lib()
    data = ",".join(ps.data_endpoints) if ps.data_endpoints else ""
    timeline = ("" if cfg.rejoin else
                _resolve_timeline_path(cfg.timeline_path, ps.rank,
                                       cfg.restart_epoch))
    rc = lib.hvd_tpu_init(
        ps.rank, ps.size, ps.local_rank, ps.local_size,
        (ps.coord_endpoint or "").encode(), data.encode(),
        cfg.cycle_time_ms, cfg.fusion_threshold, cfg.stall_warning_sec,
        timeline.encode(), int(cfg.hierarchical_allreduce),
        cfg.collective_timeout_sec, cfg.effective_cache_capacity,
        int(cfg.autotune), cfg.autotune_warmup, cfg.autotune_window,
        fix_fusion, fix_cycle, int(cfg.elastic or cfg.rejoin), cfg.min_np,
        int(cfg.rejoin), compression_code, cfg.compression_min_bytes,
        fix_comp, cfg.cross_algo_threshold, fix_algo, int(cfg.coord_tree),
        cfg.steady_threshold, cfg.steady_max_period)
    if rc != 0:
        raise HorovodInternalError(
            "engine initialization failed: "
            + lib.hvd_tpu_init_error().decode())
    if cfg.restart_epoch:
        metrics.registry.set_restart_epoch(cfg.restart_epoch)
    _metrics_file = (f"{cfg.metrics_file}.{ps.rank}"
                     if cfg.metrics_file else None)
    if cfg.postmortem_dir:
        from horovod_tpu_torch.common import postmortem as _postmortem

        _postmortem.install_excepthook()
    if cfg.monitor_port is not None:
        port = cfg.monitor_port + ps.local_rank if cfg.monitor_port else 0
        try:
            metrics.start_monitor(port, snapshot_fn=metrics_snapshot)
            # /cluster needs a fixed base port: at 0 the other ranks'
            # monitors bind ports nobody knows.
            if ps.rank == 0 and cfg.monitor_port:
                metrics.configure_cluster(
                    _cluster_targets(ps, cfg.monitor_port))
        except OSError as exc:
            import warnings

            # A busy port must not take the training job down: the
            # registry stays readable through the API and the dump.
            warnings.warn(f"metrics monitor could not bind port {port}: "
                          f"{exc}; continuing without the HTTP endpoint.")
    from horovod_tpu_torch.common import faults as _faults

    with _fault_lock:
        _collective_seq = 0  # a re-init after shutdown counts from 0
    _fault_injector = _faults.from_env(ps.rank)
    atexit.register(shutdown)


def _cluster_targets(ps: ProcessSet, base_port: int) -> list:
    """``(rank, host, port)`` of every rank's monitor for rank 0's
    ``/cluster``: each binds ``base_port + local_rank``, and the launcher
    places ranks in contiguous blocks per host, so a rank's local index is
    the count of ranks on its host before it (localhost without data
    endpoints)."""
    targets = []
    seen: dict = {}
    for r in range(ps.size):
        if ps.data_endpoints and r < len(ps.data_endpoints):
            host = ps.data_endpoints[r].rsplit(":", 1)[0]
        else:
            host = "127.0.0.1"
        local_idx = seen.get(host, 0)
        seen[host] = local_idx + 1
        targets.append((r, host, base_port + local_idx))
    return targets


def _flush_metrics_file(clear: bool = True) -> None:
    """Write this rank's ``HVD_TPU_METRICS_FILE`` dump now.  A clean
    :func:`shutdown` clears the path after it; the crash and postmortem
    paths flush without clearing (a crashed rank leaves its metrics, and
    a later clean shutdown overwrites them with fresher totals)."""
    global _metrics_file
    if _metrics_file is None:
        return
    path = _metrics_file
    if clear:
        _metrics_file = None
    try:
        with open(path, "w") as f:
            json.dump(metrics_snapshot(), f, indent=2)
            f.write("\n")
    except OSError as exc:
        import warnings

        warnings.warn(f"could not write metrics file {path}: {exc}")


def shutdown() -> None:
    """Stop the engine.  Idempotent, and a no-op before ``init()``.  The
    armed state plane (``horovod_tpu_torch.state.arm``) lives as long as
    the engine: it is disarmed first.  A typed abort the engine latched
    that no :meth:`Handle.wait` consumed leaves its postmortem dump here;
    then the metrics file is written and the monitor stopped."""
    global _fault_injector
    _fault_injector = None
    from horovod_tpu_torch import state as _state

    _state.disarm()
    for hook in list(_shutdown_hooks):
        hook()
    if _lib is not None and int(_lib.hvd_tpu_abort_code()) != 0:
        from horovod_tpu_torch.common import postmortem as _postmortem

        _postmortem.write_postmortem(
            _postmortem.reason_for_code(int(_lib.hvd_tpu_abort_code())))
    _flush_metrics_file(clear=True)
    metrics.stop_monitor()
    if _lib is not None and _lib.hvd_tpu_initialized():
        _lib.hvd_tpu_shutdown()


def is_initialized() -> bool:
    """True between a successful ``init()`` and ``shutdown()``.  Never
    builds or loads the engine."""
    return _lib is not None and bool(_lib.hvd_tpu_initialized())


def _checked_lib():
    if not is_initialized():
        raise HorovodNotInitializedError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _lib


def restart_epoch() -> int:
    """The launcher's relaunch counter (``--max-restarts``): 0 on the
    first run, +1 per restart (``HVD_TPU_RESTART_EPOCH``).  Usable before
    ``init()``."""
    return int(os.environ.get("HVD_TPU_RESTART_EPOCH") or 0)


def membership_epoch() -> int:
    """The elastic membership's epoch in this engine's lifetime: 0 until
    the first reshape, +1 per reshape (shrink or grow); 0 before
    ``init()``."""
    if _lib is None:
        return 0
    return int(_lib.hvd_tpu_membership_epoch())


def membership_ack() -> None:
    """Acknowledge the latest reshape: the engine refuses new collectives
    after one until every rank is about to re-enter agreement from a
    synchronized point, which this call says.  ``run_elastic`` calls it
    (then resyncs the state)."""
    if _lib is not None:
        _lib.hvd_tpu_membership_ack()


def mpi_threads_supported() -> bool:
    """The reference's compatibility query: there is no MPI, and the
    engine takes collectives from any thread, so True once initialized;
    :class:`HorovodNotInitializedError` before ``init()``."""
    _checked_lib()
    return True


def rank() -> int:
    return _checked_lib().hvd_tpu_rank()


def size() -> int:
    return _checked_lib().hvd_tpu_size()


def local_rank() -> int:
    return _checked_lib().hvd_tpu_local_rank()


def local_size() -> int:
    return _checked_lib().hvd_tpu_local_size()


# Engine events already folded into the registry: the engine's counts are
# cumulative over the process, its logs bounded, so each sync consumes
# only what it has not seen (repeated snapshots never count twice, and
# metrics_reset() keeps its clear-everything meaning).
_engine_stalls_seen = 0
_engine_aborts_seen = 0
_engine_announces_seen = 0
_engine_last_announce_seen: List[int] = []
_engine_cache_seen = [0, 0, 0]
_engine_topo_seen = 0
# Serializes the syncs: the monitor's thread and the API may snapshot at
# once, and the ctypes reads release the GIL.
_stall_sync_lock = threading.Lock()


def _sync_engine_stalls() -> None:
    """Fold the coordinator's stall warnings into the registry: a
    cumulative count and a bounded log of the newest ``name|seconds``
    records; events past the log keep the total without a name."""
    global _engine_stalls_seen
    if _lib is None:
        return
    with _stall_sync_lock:
        count = int(_lib.hvd_tpu_stall_count())
        new = count - _engine_stalls_seen
        if new <= 0:
            return
        _engine_stalls_seen = count
        entries = [e for e in
                   _lib.hvd_tpu_stall_info().decode().split(";") if e]
        taken = entries[-new:]
        for entry in taken:
            name, _, sec = entry.partition("|")
            try:
                duration = float(sec)
            except ValueError:
                duration = 0.0
            metrics.registry.record_stall(name, duration)
        if new > len(taken):
            metrics.registry.record_stall_count(new - len(taken))


def _sync_engine_aborts() -> None:
    """Fold the engine's coordinated aborts into the registry, by the
    latched status code's kind (``ranks_down`` or ``timeout``)."""
    global _engine_aborts_seen
    if _lib is None:
        return
    with _stall_sync_lock:
        count = int(_lib.hvd_tpu_abort_count())
        new = count - _engine_aborts_seen
        if new <= 0:
            return
        _engine_aborts_seen = count
        code = int(_lib.hvd_tpu_abort_code())
        kind = "timeout" if code == ST_TIMEOUT else "ranks_down"
        metrics.registry.record_abort(kind, new)


def _sync_engine_announces() -> None:
    """Fold the coordinator's announce order into the registry (rank 0
    only has it): per rank, how often it announced a collective last
    (an exact cumulative vector), and the first-to-last skew of each
    negotiation into ``announce_skew_sec`` (a bounded log: events past
    it keep the per-rank totals but give no skew sample)."""
    global _engine_announces_seen, _engine_last_announce_seen
    if _lib is None:
        return
    with _stall_sync_lock:
        counts_raw = _lib.hvd_tpu_last_announce_counts().decode()
        counts = [int(tok) for tok in counts_raw.split(",") if tok]
        for r, c in enumerate(counts):
            prev = (_engine_last_announce_seen[r]
                    if r < len(_engine_last_announce_seen) else 0)
            if c > prev:
                metrics.registry.record_last_announce(r, c - prev)
        _engine_last_announce_seen = counts
        # One call carries "count:entries" under the engine's lock, so
        # the count and the log cannot disagree.
        head, _, tail = _lib.hvd_tpu_announce_log().decode().partition(":")
        try:
            count = int(head)
        except ValueError:
            return
        new = count - _engine_announces_seen
        if new <= 0:
            return
        _engine_announces_seen = count
        entries = [e for e in tail.split(";") if e]
        for entry in entries[-new:]:
            _, _, us = entry.partition("|")
            try:
                skew_sec = float(us) / 1e6
            except ValueError:
                continue
            metrics.registry.observe("announce_skew_sec", skew_sec)


def _sync_engine_cache() -> None:
    """Fold the engine's response-cache events not yet seen into the
    registry's ``cache.engine`` section, and mirror its entry count."""
    if _lib is None:
        return
    with _stall_sync_lock:
        counts = (_lib.hvd_tpu_cache_hit_count(),
                  _lib.hvd_tpu_cache_miss_count(),
                  _lib.hvd_tpu_cache_eviction_count())
        for i, kind in enumerate(("hits", "misses", "evictions")):
            new = int(counts[i]) - _engine_cache_seen[i]
            if new > 0:
                metrics.registry.record_cache("engine", kind, new)
            _engine_cache_seen[i] = int(counts[i])
        metrics.registry.set_cache_size("engine",
                                        int(_lib.hvd_tpu_cache_size()))


def _sync_engine_p2p() -> None:
    """Mirror the engine's point-to-point counters into the registry's
    ``p2p`` section: transfers and bytes per direction, matched against
    the unmatched gauge, stage-group ops and open channels.  A state
    copy, so idempotent."""
    if _lib is None:
        return
    with _stall_sync_lock:
        parts = _lib.hvd_tpu_p2p_info().decode().split("|")
        if len(parts) != 8:
            return
        try:
            (sends, recvs, bytes_out, bytes_in, matched, unmatched,
             group_ops, channels) = (int(p) for p in parts)
        except ValueError:
            return
        metrics.registry.set_p2p({
            "sends": sends, "recvs": recvs,
            "bytes": {"out": bytes_out, "in": bytes_in},
            "matched": matched, "unmatched": unmatched,
            "group_ops": group_ops, "channels": channels})


def _sync_engine_membership() -> None:
    """Mirror the engine's elastic membership into the registry's
    ``membership`` section (epoch, size, reshapes, ranks lost and
    joined).  A state copy, so idempotent."""
    if _lib is None:
        return
    with _stall_sync_lock:
        info = _lib.hvd_tpu_membership_info().decode()
        parts = (info.split("|") + ["", "", "", ""])[:4]
        try:
            epoch, size_now = int(parts[0]), int(parts[1])
        except ValueError:
            return
        metrics.registry.set_membership({
            "epoch": epoch,
            "size": size_now,
            "reshapes": int(_lib.hvd_tpu_membership_reshapes()),
            "ranks_lost": [int(tok) for tok in parts[2].split(",") if tok],
            "ranks_joined": [int(tok) for tok in parts[3].split(",")
                             if tok],
        })


def _sync_engine_flight() -> None:
    """Mirror the flight recorders' cumulative event counts (the engine's
    ring; the Python ring, empty in the port) and the ring's capacity
    into the registry's ``flight`` section.  A state copy."""
    from horovod_tpu_torch.common import postmortem as _postmortem

    with _stall_sync_lock:
        engine_events = (int(_lib.hvd_tpu_flight_count())
                         if _lib is not None else 0)
        metrics.registry.set_flight({
            "events": {"engine": engine_events,
                       "xla": _postmortem.plane_ring.total},
            "capacity": _postmortem.ring_capacity(),
        })


def _sync_engine_compression() -> None:
    """Mirror :func:`compression_report` (its log aside) into the
    registry's ``compression`` section.  A state copy (the engine's
    counters are cumulative), so idempotent."""
    if _lib is None:
        return
    rep = compression_report()
    metrics.registry.set_compression({
        "mode": rep["mode"], "min_bytes": rep["min_bytes"],
        "planes": {plane: rep[plane] for plane in metrics.PLANES},
        "residual_bytes": rep["residual_bytes"],
        "residual_tensors": rep["residual_tensors"],
    })


def _sync_engine_topology() -> None:
    """Mirror the engine's topology into the registry's ``topology``
    section (two-level or flat, nodes, local size, the cross-algo
    threshold, cross-hop ring and tree buckets, local and cross bytes,
    the node-local hops' transport: ``shm`` once the rings armed, else
    ``tcp``) and fold its per-bucket phase log (local reduce-scatter,
    cross exchange, local allgather) into the ``topology_*_sec``
    histograms.  A state copy; the log is consumed by delta, so repeated
    snapshots never observe a bucket twice."""
    global _engine_topo_seen
    if _lib is None:
        return
    with _stall_sync_lock:
        parts = _lib.hvd_tpu_topology_info().decode().split("|")
        try:
            (hier, nodes, local_size_, threshold, ops_ring, ops_tree,
             local_bytes, cross_bytes, log_total) = (
                int(p) for p in parts[:9])
        except ValueError:
            return
        metrics.registry.set_topology({
            "hierarchical": bool(hier),
            "nodes": nodes,
            "local_size": local_size_,
            "cross_algo_threshold": threshold,
            "cross_ops": {"ring": ops_ring, "tree": ops_tree},
            "bytes": {"local": local_bytes, "cross": cross_bytes},
            "local_transport": parts[9] if len(parts) > 9 else "tcp",
        })
        new = log_total - _engine_topo_seen
        if new <= 0:
            return
        _engine_topo_seen = log_total
        entries = [e for e in
                   _lib.hvd_tpu_topology_log().decode().split(";") if e]
        for entry in entries[-new:]:
            fields = entry.split("|")
            if len(fields) != 5:
                continue
            try:
                rs_us, cross_us, ag_us = (int(f) for f in fields[2:5])
            except ValueError:
                continue
            metrics.registry.observe("topology_local_rs_sec", rs_us / 1e6)
            if cross_us:
                metrics.registry.observe("topology_cross_sec",
                                         cross_us / 1e6)
            metrics.registry.observe("topology_local_ag_sec", ag_us / 1e6)


def _sync_engine_control() -> None:
    """Mirror the engine's control plane into the registry's ``control``
    section: the coordinator tree's shape (two levels on a multi-node
    layout with ``HVD_TPU_COORD_TREE``, else the star), the steady
    state's counters and the control frames sent and received.
    A state copy, so idempotent."""
    if _lib is None:
        return
    with _stall_sync_lock:
        parts = _lib.hvd_tpu_control_info().decode().split("|")
        try:
            (tree, children, hosts, active, pattern_len, threshold,
             entries, exits, replays, cycles, negotiated, sent,
             received) = (int(p) for p in parts[:13])
        except ValueError:
            return
        metrics.registry.set_control({
            "tree": bool(tree),
            "depth": 2 if tree else 1,
            "children": children,
            "hosts": hosts,
            "steady": {"active": bool(active), "pattern_len": pattern_len,
                       "threshold": threshold, "entries": entries,
                       "exits": exits, "replays": replays,
                       "cycles": cycles},
            "negotiated_ticks": negotiated,
            "frames": {"sent": sent, "received": received},
        })


def _sync_engine_liveness() -> None:
    """Mirror the heartbeat detector into the registry's ``liveness``
    section: its cadence and miss limit, beacons sent and received, miss
    and eviction events, the monitored neighbours' ages and the init
    clock sync's fan-in.  A state copy, so idempotent."""
    if _lib is None:
        return
    with _stall_sync_lock:
        parts = _lib.hvd_tpu_liveness_info().decode().split("|")
        if len(parts) < 8:
            return
        try:
            (interval_ms, miss_limit, sent, recv_, miss_events, evictions,
             fanin) = (int(p) for p in parts[:7])
        except ValueError:
            return
        peers = {}
        for tok in parts[7].split():
            fields = tok.split(":")
            if len(fields) != 3:
                continue
            try:
                peers[int(fields[0])] = {"age_us": int(fields[1]),
                                         "misses": int(fields[2])}
            except ValueError:
                continue
        metrics.registry.set_liveness({
            "interval_ms": interval_ms,
            "miss_limit": miss_limit,
            "frames": {"sent": sent, "received": recv_},
            "miss_events": miss_events,
            "evictions": evictions,
            "clock_fanin": fanin,
            "peers": peers,
        })


_LINK_INT_FIELDS = ("bytes_out", "bytes_in", "sends", "recvs", "stalls",
                    "short_writes", "send_us_sum", "send_us_count")
_LINK_RTT_SHM_FIELDS = ("rtt_last_us", "rtt_ewma_us", "rtt_samples",
                    "shm_bytes_out", "shm_bytes_in", "shm_handoffs",
                    "shm_us_sum", "shm_us_count")


def _sync_engine_links() -> None:
    """Mirror the engine's per-peer link statistics into the registry's
    ``links`` section (``HVD_TPU_LINK_STATS``): bytes each way, sends and
    receives, write stalls, the timed-send histogram and the
    heartbeat-echo round trip of every TCP link this rank holds.  A
    state copy, so idempotent."""
    if _lib is None:
        return
    with _stall_sync_lock:
        parts = _lib.hvd_tpu_link_info().decode().split("|")
        if len(parts) < 2:
            return
        peers = {}
        for tok in parts[1].split(";"):
            fields = tok.split(":")
            if len(fields) != 20:
                continue
            try:
                peers[int(fields[0])] = {
                    **dict(zip(_LINK_INT_FIELDS,
                               (int(f) for f in fields[1:9]))),
                    "send_us_buckets": [int(b) for b in
                                        fields[9].split(",") if b],
                    **dict(zip(_LINK_RTT_SHM_FIELDS,
                               (int(f) for f in fields[10:18]))),
                    "shm_us_buckets": [int(b) for b in
                                       fields[18].split(",") if b],
                    "transport": fields[19],
                }
            except ValueError:
                continue
        metrics.registry.set_links({"enabled": parts[0] == "1",
                                    "peers": peers})


def _sync_engine_anomalies() -> None:
    """Mirror the engine's anomaly detector into the registry's
    ``anomalies`` section: its sigma and period, the verdicts per kind
    and the bounded verdict log.  A state copy, so idempotent."""
    if _lib is None:
        return
    with _stall_sync_lock:
        parts = _lib.hvd_tpu_anomaly_info().decode().split("|")
        if len(parts) < 6:
            return
        try:
            sigma, interval_ms = int(parts[0]), int(parts[1])
            counts = [int(p) for p in parts[2:6]]
        except ValueError:
            return
        log = []
        for tok in _lib.hvd_tpu_anomaly_log().decode().split(";"):
            fields = tok.split("|")
            if len(fields) != 4:
                continue
            try:
                age_us = int(fields[3])
            except ValueError:
                continue
            log.append({"kind": fields[0], "subject": fields[1],
                        "detail": fields[2], "age_us": age_us})
        metrics.registry.set_anomalies({
            "sigma": sigma,
            "interval_ms": interval_ms,
            "verdicts": dict(zip(metrics.ANOMALY_KINDS, counts)),
            "log": log,
        })


def _sync_engine_autotune() -> None:
    """Mirror the engine's autotuning report into the registry's
    ``autotune`` section (a state copy, so idempotent)."""
    if _lib is None:
        return
    from horovod_tpu_torch.common import autotune as _autotune

    with _stall_sync_lock:
        metrics.registry.set_autotune(_autotune.report(_lib))


def metrics_snapshot() -> dict:
    """The registry as a plain nested dict, in the reference's shape:
    ``ops``, ``bytes`` and ``batches`` (the collective layer, while
    enabled), ``stalls``, ``faults`` (injected faults, coordinated
    aborts, the restart epoch), ``skew`` (the coordinator's announce
    order), ``cache``, ``membership``, ``autotune``, ``serving``,
    ``flight``, ``compression``, ``topology``, ``control``,
    ``liveness``, ``links``, ``p2p``, ``anomalies``, ``state`` and
    ``histograms``; the engine's sections are mirrored in first.  The
    ``xla`` plane's entries read zeros (the port has no device data
    plane).  Callable before ``init()``."""
    _sync_engine_stalls()
    _sync_engine_aborts()
    _sync_engine_announces()
    _sync_engine_cache()
    _sync_engine_autotune()
    _sync_engine_membership()
    _sync_engine_flight()
    _sync_engine_compression()
    _sync_engine_topology()
    _sync_engine_control()
    _sync_engine_liveness()
    _sync_engine_links()
    _sync_engine_anomalies()
    _sync_engine_p2p()
    return metrics.registry.snapshot()


def metrics_reset() -> None:
    """Zero every counter, histogram and stall record (the gate stays as
    it is); engine events seen so far do not come back."""
    _sync_engine_stalls()
    _sync_engine_aborts()
    _sync_engine_announces()
    _sync_engine_cache()
    _sync_engine_topology()
    metrics.registry.reset()


def autotune_report() -> dict:
    """The online-autotuning report: enabled and frozen, the windows
    scored, the applied ``fusion_threshold``/``cycle_time_ms``/
    ``compression``/``cross_algo_threshold`` (set in lockstep: equal on
    every rank of a healthy job), ``best_score``, the per-rank ``applied``
    log and, on rank 0 (the coordinator, which runs the search), the
    per-window ``history``.  The empty shape before the engine is
    loaded."""
    from horovod_tpu_torch.common import autotune as _autotune

    if _lib is None:
        return _autotune.empty_report()
    return _autotune.report(_lib)


def autotune_set(fusion_threshold: Optional[int] = None,
                 cycle_time_ms: Optional[float] = None,
                 compression: Optional[str] = None,
                 cross_algo_threshold: Optional[int] = None) -> None:
    """Inject parameters that every rank applies at the same negotiation
    tick (the seam for a tuning policy of one's own, built-in tuner on or
    off; a live search resumes from the nearest grid point).  Rank 0 only
    (``ValueError`` elsewhere)."""
    from horovod_tpu_torch.common import autotune as _autotune

    _autotune.set_params(_checked_lib(), fusion_threshold, cycle_time_ms,
                         compression, cross_algo_threshold)


def compression_report() -> dict:
    """The wire-compression report: the applied mode and floor (equal on
    every rank), per plane the wire and payload bytes and the buckets per
    mode, the error-feedback residual gauges, and the engine's bounded
    per-bucket decision ``log`` (``[{"name", "mode"}, ...]`` in execution
    order, equal on every rank).  The ``xla`` plane reads zeros until the
    port has a device data plane.  The empty shape before ``init()``."""
    from horovod_tpu_torch.common.config import COMPRESSION_NAMES

    empty_ops = {"none": 0, "bf16": 0, "fp8": 0}
    rep = {
        "mode": "off", "min_bytes": 0,
        "engine": {"wire_bytes": 0, "payload_bytes": 0,
                   "ops": dict(empty_ops)},
        "xla": {"wire_bytes": 0, "payload_bytes": 0, "ops": dict(empty_ops)},
        "residual_bytes": 0, "residual_tensors": 0,
        "log": [],
    }
    if _lib is None:
        return rep
    parts = _lib.hvd_tpu_compression_info().decode().split("|")
    try:
        (wire, payload, n_none, n_bf16, n_fp8, res_bytes, res_tensors,
         min_bytes) = (int(p) for p in parts[:8])
    except ValueError:
        return rep
    rep.update({
        "mode": COMPRESSION_NAMES.get(
            int(_lib.hvd_tpu_compression_mode()), "off"),
        "min_bytes": min_bytes,
        "engine": {"wire_bytes": wire, "payload_bytes": payload,
                   "ops": {"none": n_none, "bf16": n_bf16, "fp8": n_fp8}},
        "residual_bytes": res_bytes,
        "residual_tensors": res_tensors,
    })
    for entry in _lib.hvd_tpu_compression_log().decode().split(";"):
        if entry:
            name, _, mode = entry.rpartition("|")
            rep["log"].append({"name": name, "mode": mode})
    return rep


def resolve_device(device=None):
    """The port's device rule: ``None`` means the current CUDA device,
    which must exist; anything else is taken as given (``"cpu"`` for
    tests)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: horovod_tpu_torch runs on a GPU; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


# ---------------------------------------------------------------------------
# Collectives on host memory.
# ---------------------------------------------------------------------------


class Handle:
    """An outstanding engine collective.  Holds its input and output
    tensors while the engine may touch their memory.  ``completion_tick``
    (set by :meth:`wait`) is the engine cycle that completed it: ops fused
    in one cycle share it."""

    def __init__(self, raw: int, op: int, inp, out, name: str):
        self._raw = raw
        self._op = op
        self._in = inp
        self._out = out
        self.name = name
        self._finished = False
        self._finish_lock = threading.Lock()
        # wait_sec's start, taken at the enqueue; 0.0 while metrics are
        # off (the one check the hot path pays).
        self._t0 = time.perf_counter() if metrics.registry.enabled else 0.0
        self.completion_tick: Optional[int] = None

    def poll(self) -> bool:
        """True once the collective has completed (or failed)."""
        return self._finished or _lib.hvd_tpu_poll(self._raw) != 0

    def status(self) -> int:
        """The engine's status code (``ST_PENDING`` while in flight)."""
        return _lib.hvd_tpu_status(self._raw)

    def result_nbytes(self) -> int:
        return int(_lib.hvd_tpu_result_nbytes(self._raw))

    def result_ptr(self) -> Optional[int]:
        """Host address of a completed allgather's engine-owned result
        (None while pending or when empty); valid until release."""
        return _lib.hvd_tpu_result_ptr(self._raw)

    def release(self) -> None:
        _lib.hvd_tpu_release(self._raw)

    def wait(self, alloc: Optional[Callable] = None):
        """Block until done and return the output tensor; raise the typed
        error of a failed collective.  An allgather's result is copied into
        ``alloc(shape, dtype)`` (a fresh CPU tensor by default).

        While metrics are enabled it records, as the reference's does, the
        engine's negotiation time (``negotiation_sec``: enqueue to the
        agreed response, stamped by the engine), the bytes out and
        ``wait_sec``: from the enqueue to the engine's result, the
        allgather's copy out of the engine included.  For a CUDA tensor
        the enqueue comes after its copy to the pinned host buffer has
        landed (``torch/mpi_ops.py``'s staging thread), and the copy back
        to the card follows this call: ``wait_sec`` holds neither."""
        import torch

        with self._finish_lock:
            if self._finished:
                raise ValueError(
                    f"handle for '{self.name}' already waited on")
            self._finished = True
        try:
            code = _lib.hvd_tpu_wait(self._raw)
            if code != ST_OK:
                msg = _lib.hvd_tpu_error(self._raw).decode()
                code, msg = _promote_transport_failure(code, msg)
                raise _status_error(code, msg, self.name)
            self.completion_tick = int(
                _lib.hvd_tpu_completion_tick(self._raw))
            if self._t0:
                neg_us = int(_lib.hvd_tpu_negotiation_us(self._raw))
                if neg_us >= 0:
                    metrics.registry.observe("negotiation_sec",
                                             neg_us / 1e6)
            if self._op != OP_ALLGATHER:
                self._record_done(self._out.numel()
                                  * self._out.element_size())
                return self._out
            nbytes = self.result_nbytes()
            shape = ((int(_lib.hvd_tpu_result_dim0(self._raw)),)
                     + tuple(self._in.shape[1:]))
            out = (alloc or torch.empty)(shape, dtype=self._in.dtype)
            if out.numel() * out.element_size() != nbytes:
                raise HorovodInternalError(
                    f"allgather '{self.name}': {nbytes} result bytes for "
                    f"shape {shape} of {self._in.dtype}")
            if nbytes:
                ctypes.memmove(out.data_ptr(), self.result_ptr(), nbytes)
            self._record_done(nbytes)
            return out
        finally:
            self.release()

    def _record_done(self, nbytes: int) -> None:
        if self._t0:
            metrics.registry.record_bytes_out("engine", nbytes)
            metrics.registry.observe("wait_sec",
                                     time.perf_counter() - self._t0)


def _parse_down_ranks(msg: str) -> list:
    m = re.search(r"ranks down: ([0-9, ]+)", msg)
    if not m:
        return []
    return [int(tok) for tok in m.group(1).split(",") if tok.strip()]


def _promote_transport_failure(code: int, msg: str):
    """A broken ring racing a coordinated abort: wait up to 2 s for the
    control plane's typed verdict, as the reference does, so the caller
    gets the error that names the dead rank."""
    transport = code == ST_UNKNOWN and "failed" in msg
    deadline = time.monotonic() + (2.0 if transport else 0.0)
    while True:
        ac = int(_lib.hvd_tpu_abort_code())
        if ac in (ST_RANKS_DOWN, ST_TIMEOUT):
            return ac, _lib.hvd_tpu_abort_message().decode()
        if not transport or time.monotonic() >= deadline:
            return code, msg
        time.sleep(0.01)


def _status_error(code: int, msg: str, name: str) -> Exception:
    prefix = f"collective '{name}' failed: "
    if code == ST_PRECONDITION:
        return ValueError(prefix + msg)
    if code in (ST_RANKS_DOWN, ST_TIMEOUT):
        # A typed abort: write the postmortem now, while the engine's
        # flight ring and pending tables still describe the moment of
        # death (write-once, and it never raises).
        from horovod_tpu_torch.common import postmortem as _postmortem

        _postmortem.write_postmortem(_postmortem.reason_for_code(code))
    if code == ST_RANKS_DOWN:
        return RanksDownError(prefix + msg, ranks=_parse_down_ranks(msg))
    if code == ST_TIMEOUT:
        return CollectiveTimeoutError(prefix + msg)
    if code == ST_RESHAPE:
        return MembershipChangedError(prefix + msg,
                                      lost_ranks=_parse_down_ranks(msg))
    return HorovodInternalError(prefix + (msg or f"status {code}"))


_name_counter = [0]
_name_lock = threading.Lock()


def _auto_name(prefix: str) -> str:
    with _name_lock:
        _name_counter[0] += 1
        return f"{prefix}.noname.{_name_counter[0]}"


def _check_host(tensor, what: str = "input"):
    if tensor.device.type != "cpu":
        raise ValueError(
            f"the engine takes host memory; got a {what} on "
            f"{tensor.device} (CUDA tensors go through "
            "horovod_tpu_torch.torch, which stages them in pinned memory)")
    if not tensor.is_contiguous():
        raise ValueError(f"the engine takes a contiguous {what}")


def _check_out(out, tensor) -> None:
    _check_host(out, "output")
    if out.shape != tensor.shape or out.dtype != tensor.dtype:
        raise ValueError(
            f"output buffer mismatch: expected shape {tuple(tensor.shape)} "
            f"dtype {tensor.dtype}, got shape {tuple(out.shape)} dtype "
            f"{out.dtype}")


def _enqueue(op: int, tensor, out, name: str, root_rank: int,
             average: bool) -> Handle:
    lib = _checked_lib()
    raw = lib.hvd_tpu_enqueue(
        op, name.encode(), tensor.data_ptr(),
        out.data_ptr() if out is not None else None,
        _dims(tuple(tensor.shape)), tensor.dim(),
        dtypes.torch_to_code(tensor.dtype), root_rank, int(average))
    if raw < 0:
        raise HorovodInternalError("engine is shut down")
    _record_enqueue(op, tensor)
    return Handle(raw, op, tensor, out, name)


_OP_NAMES = {OP_ALLREDUCE: "allreduce", OP_ALLGATHER: "allgather",
             OP_BROADCAST: "broadcast"}


def _record_enqueue(op: int, tensor) -> None:
    """The collective layer's op and bytes-in counters (not p2p: the
    ``ops`` section counts collectives only, as the reference's)."""
    if metrics.registry.enabled:
        metrics.registry.record_enqueue(
            "engine", _OP_NAMES[op], tensor.numel() * tensor.element_size())


def _dims(shape):
    return (ctypes.c_longlong * len(shape))(*shape)


def _fault_hook(name: str) -> None:
    """The fault injector's collective boundary (``common/faults.py``):
    called on the caller's thread for every submitted collective, in
    program order; one ``None`` check when no spec is armed, and the
    index advances only while one is."""
    global _collective_seq
    if _fault_injector is None:
        return
    with _fault_lock:
        idx = _collective_seq
        _collective_seq += 1
    _fault_injector.on_collective(idx, name)


def allreduce_async(tensor, average: bool = True, name: Optional[str] = None,
                    out=None, group: Optional["StageGroup"] = None) -> Handle:
    """Sum (or mean) across ranks of a contiguous CPU tensor into ``out``
    (a new tensor by default; ``out`` may be ``tensor`` itself).  With
    ``group`` the reduction runs over the group's ranks only: the
    data-parallel reduction inside one pipeline stage.  The coordinator
    checks that every announcing rank lists the same group and fails a
    mismatch with a typed ``ValueError``."""
    _check_host(tensor)
    if out is not None:
        _check_out(out, tensor)
    name = name or _auto_name("allreduce" if group is None
                              else "group_allreduce")
    _fault_hook(name)
    return _allreduce_async(tensor, average, name, out, group)


def _allreduce_async(tensor, average: bool, name: str, out,
                     group: Optional["StageGroup"]) -> Handle:
    """:func:`allreduce_async` past its checks and the fault hook (the
    CUDA route's staging thread enqueues here: its hook fired on the
    caller's thread)."""
    import torch

    if out is None:
        out = torch.empty_like(tensor)
    if group is None:
        return _enqueue(OP_ALLREDUCE, tensor, out, name, -1, average)
    lib = _checked_lib()
    members = (ctypes.c_longlong * group.size)(*group.ranks)
    raw = lib.hvd_tpu_enqueue_group(
        name.encode(), tensor.data_ptr(), out.data_ptr(),
        _dims(tuple(tensor.shape)), tensor.dim(),
        dtypes.torch_to_code(tensor.dtype), int(average), members,
        group.size)
    if raw < 0:
        raise HorovodInternalError("engine is shut down")
    _record_enqueue(OP_ALLREDUCE, tensor)
    return Handle(raw, OP_ALLREDUCE, tensor, out, name)


def allgather_async(tensor, name: Optional[str] = None) -> Handle:
    """Concatenation along dim 0 of every rank's contiguous CPU tensor
    (dim 0 may differ across ranks, the other dims may not)."""
    _check_host(tensor)
    if tensor.dim() == 0:
        raise ValueError("allgather requires tensors of rank >= 1")
    name = name or _auto_name("allgather")
    _fault_hook(name)
    return _allgather_async(tensor, name)


def _allgather_async(tensor, name: str) -> Handle:
    """:func:`allgather_async` past its checks and the fault hook."""
    return _enqueue(OP_ALLGATHER, tensor, None, name, -1, False)


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    out=None) -> Handle:
    """``root_rank``'s contiguous CPU tensor on every rank, into ``out``
    (a new tensor by default; ``out`` may be ``tensor`` itself)."""
    _check_host(tensor)
    if out is not None:
        _check_out(out, tensor)
    name = name or _auto_name("broadcast")
    _fault_hook(name)
    return _broadcast_async(tensor, root_rank, name, out)


def _broadcast_async(tensor, root_rank: int, name: str, out) -> Handle:
    """:func:`broadcast_async` past its checks and the fault hook."""
    import torch

    if out is None:
        out = torch.empty_like(tensor)
    return _enqueue(OP_BROADCAST, tensor, out, name, root_rank, False)


def allgather(tensor, name: Optional[str] = None):
    return allgather_async(tensor, name).wait()


def broadcast(tensor, root_rank: int, name: Optional[str] = None, out=None):
    return broadcast_async(tensor, root_rank, name, out=out).wait()



def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              group: Optional["StageGroup"] = None):
    return allreduce_async(tensor, average, name, group=group).wait()



# ---------------------------------------------------------------------------
# Stage groups and the point-to-point plane (docs/pipeline.md).
# ---------------------------------------------------------------------------


class StageGroup:
    """An immutable subset of ranks for scoped collectives.  A pipeline
    job is a stages x data-parallel grid: a collective scoped to one
    stage's group reduces along the DP axis, while ``send``/``recv`` cross
    groups along the pipeline axis."""

    def __init__(self, ranks):
        members = sorted({int(r) for r in ranks})
        if not members:
            raise ValueError("stage group must contain at least one rank")
        if members[0] < 0:
            raise ValueError(f"stage group rank {members[0]} is negative")
        self.ranks = tuple(members)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __contains__(self, r) -> bool:
        return int(r) in self.ranks

    def __eq__(self, other) -> bool:
        return isinstance(other, StageGroup) and self.ranks == other.ranks

    def __hash__(self) -> int:
        return hash(self.ranks)

    def __repr__(self) -> str:
        return f"StageGroup(ranks={list(self.ranks)})"


def stage_group(ranks) -> StageGroup:
    """A :class:`StageGroup` of the given global ranks."""
    return StageGroup(ranks)


def _p2p_wire_name(name: Optional[str], src: int, dst: int,
                   tag: int) -> str:
    """The name a send and its receive negotiate under: the sender stamps
    (rank -> peer), the receiver (peer -> rank), and both arrive at
    ``<base>.p2p.<src>-<dst>.t<tag>``."""
    return f"{name or 'p2p'}.p2p.{src}-{dst}.t{tag}"


def _enqueue_p2p(op: int, tensor, peer: int, tag: int,
                 wire_name: str) -> Handle:
    lib = _checked_lib()
    n = size()
    if not 0 <= peer < n:
        raise ValueError(f"p2p peer rank {peer} out of range for world "
                         f"size {n}")
    if peer == rank():
        raise ValueError("p2p peer must be a different rank")
    if tag < 0:
        raise ValueError(f"p2p tag {tag} must be non-negative")
    _fault_hook(wire_name)
    ptr = tensor.data_ptr()
    raw = lib.hvd_tpu_enqueue_p2p(
        op, wire_name.encode(), ptr if op == OP_SEND else None,
        ptr if op == OP_RECV else None, _dims(tuple(tensor.shape)),
        tensor.dim(), dtypes.torch_to_code(tensor.dtype), peer, tag)
    if raw < 0:
        raise HorovodInternalError("engine is shut down")
    return Handle(raw, op, tensor, tensor, wire_name)


def send_async(tensor, dest: int, tag: int = 0,
               name: Optional[str] = None) -> Handle:
    """Send a contiguous CPU tensor to global rank ``dest``.  Completes
    once the matching :func:`recv` has announced; an unmatched send
    raises ``CollectiveTimeoutError`` naming the tensor and the peer
    after ``HVD_TPU_COLLECTIVE_TIMEOUT_SEC``.  The engine reads the
    tensor when the transfer runs: keep it unchanged until the handle
    completes."""
    _check_host(tensor)
    return _enqueue_p2p(OP_SEND, tensor, dest, tag,
                        _p2p_wire_name(name, rank(), dest, tag))


def recv_async(out, source: int, tag: int = 0,
               name: Optional[str] = None) -> Handle:
    """Receive from global rank ``source`` into ``out``, a contiguous CPU
    tensor that autograd does not track: its shape and dtype are the
    contract, which the coordinator checks against the sender's and fails
    on a mismatch with a typed ``ValueError``."""
    if out.device.type == "cpu" and (not out.is_contiguous()
                                     or out.requires_grad):
        # A tensor autograd tracks is not the engine's to write.
        raise ValueError("recv buffer must be C-contiguous and writeable")
    _check_host(out, "receive buffer")
    return _enqueue_p2p(OP_RECV, out, source, tag,
                        _p2p_wire_name(name, source, rank(), tag))


def send(tensor, dest: int, tag: int = 0, name: Optional[str] = None):
    send_async(tensor, dest, tag, name).wait()


def recv(out, source: int, tag: int = 0, name: Optional[str] = None):
    return recv_async(out, source, tag, name).wait()


# ---------------------------------------------------------------------------
# Application spans (docs/timeline.md): the application's events in this
# rank's trace beside the engine's collective rows.
# ---------------------------------------------------------------------------


def timeline_enabled() -> bool:
    """True when this rank writes a timeline (``HVD_TPU_TIMELINE`` or the
    launcher's ``--timeline``); spans and markers are no-ops otherwise."""
    return _lib is not None and bool(_lib.hvd_tpu_timeline_enabled())


def _trace_begin(row: str, label: str) -> None:
    """Open a span labelled ``label`` on trace row ``row`` (the train
    step's hook shares it with :func:`trace_span`)."""
    if timeline_enabled():
        _lib.hvd_tpu_timeline_op_start(row.encode(), label.encode())


def _trace_end(row: str) -> None:
    if timeline_enabled():
        _lib.hvd_tpu_timeline_op_end(row.encode(), 0)


@contextlib.contextmanager
def trace_span(name: str, label: Optional[str] = None):
    """A span on this rank's trace row ``name`` (spans on one row nest),
    labelled ``label`` (default ``name``)::

        with hvd.trace_span("data_loading"):
            batch = next(loader)

    A no-op when the timeline is off."""
    if not timeline_enabled():
        yield
        return
    _lib.hvd_tpu_timeline_op_start(name.encode(), (label or name).encode())
    try:
        yield
    finally:
        _lib.hvd_tpu_timeline_op_end(name.encode(), 0)


def trace_marker(name: str, row: str = "app.markers") -> None:
    """An instant event ``name`` on the trace row ``row``; a no-op when
    the timeline is off."""
    if timeline_enabled():
        _lib.hvd_tpu_timeline_instant(row.encode(), name.encode())
