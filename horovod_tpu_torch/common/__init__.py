"""Process API of the PyTorch port and its seam to the collective engine.

Counterpart of ``horovod_tpu/common/__init__.py``: the engine library
(``engine/cc``, the port's own copy, built at first use by
``engine/build.py``) is loaded with ``ctypes``; ``init``/``shutdown`` start
and stop it; ``rank``/``size``/``local_rank``/``local_size`` come from it;
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

:func:`metrics_snapshot` reads the port's trimmed registry
(``common/metrics.py``, the serving plane's counters) with the engine's
response-cache and point-to-point counters folded in.  Not ported: the
XLA data plane, the fault injector, and the timeline, postmortem and the
rest of the metrics glue (``config.UNPORTED``).
"""

from __future__ import annotations

import atexit
import ctypes
import re
import threading
import time
from typing import Callable, List, Optional

from horovod_tpu_torch.common import dtypes, metrics
from horovod_tpu_torch.common.basics import ProcessSet, resolve_process_set
from horovod_tpu_torch.common.config import Config

__all__ = [
    "HorovodInternalError", "RanksDownError", "CollectiveTimeoutError",
    "HorovodNotInitializedError", "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "resolve_device",
    "Handle", "allreduce_async", "allgather_async", "broadcast_async",
    "allreduce", "StageGroup", "stage_group",
    "send_async", "recv_async", "send", "recv", "metrics_snapshot",
    "metrics_reset",
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


class HorovodNotInitializedError(HorovodInternalError, ValueError):
    """A call that needs a running engine came before ``hvd.init()`` (or
    after ``hvd.shutdown()``)."""


_lib = None
_lib_lock = threading.Lock()
# Called (no arguments) by shutdown() before the engine stops: the torch
# binding drains its staging thread and drops its pinned buffers there.
_shutdown_hooks: List[Callable[[], None]] = []


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
        _lib = lib
        return lib


def _pin_device(device, ps: ProcessSet) -> None:
    """Make the device this process computes on current:
    ``cuda:local_rank()`` by default, ``device`` where the caller names
    one (``"cpu"`` for the CPU tests, ``"cuda:N"`` to put several ranks on
    one card)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: horovod_tpu_torch runs on a GPU; pass "
                "device='cpu' to run on the CPU explicitly")
        count = torch.cuda.device_count()
        if ps.local_rank >= count:
            raise HorovodInternalError(
                f"local_rank {ps.local_rank} has no CUDA device of its own "
                f"({count} visible); name one with "
                "hvd.init(device='cuda:N') (ranks may share a device)")
        dev = torch.device("cuda", ps.local_rank)
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


def init(device: Optional[str] = None) -> None:
    """Start the engine and pin this process's device.

    Identity comes from the launcher's environment (rank 0 of 1 without
    one).  ``device=None`` pins ``cuda:local_rank()``, which must exist;
    ``device="cuda:N"`` pins N (several ranks may share it);
    ``device="cpu"`` pins nothing: the CPU tests, on CPU tensors.  A knob
    of an unported engine plane in the environment raises.  Idempotent.
    """
    if is_initialized():
        return
    ps = resolve_process_set()
    asked = Config.unported_requests()
    if asked:
        raise HorovodInternalError(
            "the environment asks for engine planes horovod_tpu_torch does "
            "not have: " + "; ".join(asked))
    cfg = Config.from_env()
    if cfg.metrics:
        metrics.registry.enable()
    _pin_device(device, ps)
    lib = _load_lib()
    data = ",".join(ps.data_endpoints) if ps.data_endpoints else ""
    # Every unported plane at its "off" value: no timeline, flat ring, no
    # autotuning (fix values -1), not elastic, no compression, no
    # coordinator tree.
    rc = lib.hvd_tpu_init(
        ps.rank, ps.size, ps.local_rank, ps.local_size,
        (ps.coord_endpoint or "").encode(), data.encode(),
        cfg.cycle_time_ms, cfg.fusion_threshold, cfg.stall_warning_sec,
        b"", 0, cfg.collective_timeout_sec, cfg.effective_cache_capacity,
        0, 2, 32, -1, -1.0, 0, 1, 0, 0, 1024, -1, 64 * 1024, -1, 0,
        cfg.steady_threshold, cfg.steady_max_period)
    if rc != 0:
        raise HorovodInternalError(
            "engine initialization failed: "
            + lib.hvd_tpu_init_error().decode())
    atexit.register(shutdown)


def shutdown() -> None:
    """Stop the engine.  Idempotent, and a no-op before ``init()``."""
    for hook in list(_shutdown_hooks):
        hook()
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


def rank() -> int:
    return _checked_lib().hvd_tpu_rank()


def size() -> int:
    return _checked_lib().hvd_tpu_size()


def local_rank() -> int:
    return _checked_lib().hvd_tpu_local_rank()


def local_size() -> int:
    return _checked_lib().hvd_tpu_local_size()


# Engine cache events already folded into the registry (hits, misses,
# evictions): the engine's counts are cumulative over the process.
_cache_seen = [0, 0, 0]
_cache_lock = threading.Lock()


def _sync_engine_cache() -> None:
    """Fold the engine's response-cache events not yet seen into the
    registry's ``cache.engine`` section, and mirror its entry count."""
    if _lib is None:
        return
    with _cache_lock:
        counts = (_lib.hvd_tpu_cache_hit_count(),
                  _lib.hvd_tpu_cache_miss_count(),
                  _lib.hvd_tpu_cache_eviction_count())
        for i, kind in enumerate(("hits", "misses", "evictions")):
            new = int(counts[i]) - _cache_seen[i]
            if new > 0:
                metrics.registry.record_cache("engine", kind, new)
            _cache_seen[i] = int(counts[i])
        metrics.registry.set_cache_size("engine",
                                        int(_lib.hvd_tpu_cache_size()))


def _sync_engine_p2p() -> None:
    """Mirror the engine's point-to-point counters into the registry's
    ``p2p`` section: transfers and bytes per direction, matched against
    the unmatched gauge, stage-group ops and open channels.  A state
    copy, so idempotent."""
    if _lib is None:
        return
    parts = _lib.hvd_tpu_p2p_info().decode().split("|")
    if len(parts) != 8:
        return
    try:
        (sends, recvs, bytes_out, bytes_in, matched, unmatched, group_ops,
         channels) = (int(p) for p in parts)
    except ValueError:
        return
    metrics.registry.set_p2p({
        "sends": sends, "recvs": recvs,
        "bytes": {"out": bytes_out, "in": bytes_in},
        "matched": matched, "unmatched": unmatched,
        "group_ops": group_ops, "channels": channels})


def metrics_snapshot() -> dict:
    """The registry as a plain nested dict: ``cache`` (the engine's
    negotiation response cache: hits, misses, evictions, size), ``p2p``
    (the point-to-point plane: sends, recvs, bytes out and in, matched,
    unmatched, group ops, channels), ``serving`` (request lifecycle,
    occupancy, KV pool, tenants) and ``histograms``.  Callable before
    ``init()``."""
    _sync_engine_cache()
    _sync_engine_p2p()
    return metrics.registry.snapshot()


def metrics_reset() -> None:
    """Zero every counter and histogram; engine cache events seen so far
    do not come back."""
    _sync_engine_cache()
    metrics.registry.reset()


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
        ``alloc(shape, dtype)`` (a fresh CPU tensor by default)."""
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
            if self._op != OP_ALLGATHER:
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
            return out
        finally:
            self.release()


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
    if code == ST_RANKS_DOWN:
        return RanksDownError(prefix + msg, ranks=_parse_down_ranks(msg))
    if code == ST_TIMEOUT:
        return CollectiveTimeoutError(prefix + msg)
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
    return Handle(raw, op, tensor, out, name)


def _dims(shape):
    return (ctypes.c_longlong * len(shape))(*shape)


def allreduce_async(tensor, average: bool = True, name: Optional[str] = None,
                    out=None, group: Optional["StageGroup"] = None) -> Handle:
    """Sum (or mean) across ranks of a contiguous CPU tensor into ``out``
    (a new tensor by default; ``out`` may be ``tensor`` itself).  With
    ``group`` the reduction runs over the group's ranks only: the
    data-parallel reduction inside one pipeline stage.  The coordinator
    checks that every announcing rank lists the same group and fails a
    mismatch with a typed ``ValueError``."""
    import torch

    _check_host(tensor)
    if out is None:
        out = torch.empty_like(tensor)
    else:
        _check_out(out, tensor)
    if group is None:
        return _enqueue(OP_ALLREDUCE, tensor, out,
                        name or _auto_name("allreduce"), -1, average)
    lib = _checked_lib()
    name = name or _auto_name("group_allreduce")
    members = (ctypes.c_longlong * group.size)(*group.ranks)
    raw = lib.hvd_tpu_enqueue_group(
        name.encode(), tensor.data_ptr(), out.data_ptr(),
        _dims(tuple(tensor.shape)), tensor.dim(),
        dtypes.torch_to_code(tensor.dtype), int(average), members,
        group.size)
    if raw < 0:
        raise HorovodInternalError("engine is shut down")
    return Handle(raw, OP_ALLREDUCE, tensor, out, name)


def allgather_async(tensor, name: Optional[str] = None) -> Handle:
    """Concatenation along dim 0 of every rank's contiguous CPU tensor
    (dim 0 may differ across ranks, the other dims may not)."""
    _check_host(tensor)
    if tensor.dim() == 0:
        raise ValueError("allgather requires tensors of rank >= 1")
    return _enqueue(OP_ALLGATHER, tensor, None,
                    name or _auto_name("allgather"), -1, False)


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    out=None) -> Handle:
    """``root_rank``'s contiguous CPU tensor on every rank, into ``out``
    (a new tensor by default; ``out`` may be ``tensor`` itself)."""
    import torch

    _check_host(tensor)
    if out is None:
        out = torch.empty_like(tensor)
    else:
        _check_out(out, tensor)
    return _enqueue(OP_BROADCAST, tensor, out, name or _auto_name("broadcast"),
                    root_rank, False)



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
