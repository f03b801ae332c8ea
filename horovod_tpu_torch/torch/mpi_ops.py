"""PyTorch collectives of the port: async handles, in-place variants,
autograd, on CPU and on CUDA tensors.

Counterpart of ``horovod_tpu/torch/mpi_ops.py``
(``allreduce{,_async}{,_}``, ``allgather{,_async}``,
``broadcast{,_async}{,_}``, ``poll``, ``synchronize``), over the port's
own engine (``horovod_tpu_torch.common``).

CPU tensors go to the engine as they are, through ``data_ptr()``.

CUDA tensors take the reference Horovod's route for device tensors without
NCCL (its CudaOnCPU path): the engine is host code and never receives a
device pointer.

1. The tensor is copied into a pinned host buffer, cached per collective
   name and reused across steps (auto-named collectives take a fresh one
   from PyTorch's pinned-memory cache), with ``non_blocking=True`` on the
   caller's current stream, and a CUDA event is recorded after the copy.
2. One staging thread per process waits on that event and only then
   enqueues the host buffer: the engine reads its input as soon as every
   rank has announced, which may be before a non-blocking copy has
   landed.  Enqueues keep their submission order.
3. ``synchronize()`` waits for the engine, then copies the result back with
   ``non_blocking=True`` on the caller's current stream into the output
   (the input itself for the in-place variants), and records the event
   after which the buffer may be reused.

A failure in any step raises from ``synchronize()``; nothing is computed
on the CPU in place of the engine.  At size 1 a CUDA tensor skips the
staging: one rank's result is its input, so the out-of-place variants
return a copy and the in-place ones the tensor itself.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

import torch

from horovod_tpu_torch import common as _common

__all__ = [
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "poll", "synchronize",
    "TorchHandle",
]

# Handles still outstanding: pins their tensors and buffers against GC
# while the engine or a copy may touch their memory.
_outstanding: Dict[int, "TorchHandle"] = {}


class TorchHandle:
    """An outstanding collective; :meth:`synchronize` returns its result.

    ``inner`` is the engine's :class:`~horovod_tpu_torch.common.Handle`
    once enqueued (for a CUDA tensor, once the staging thread has seen its
    copy land); ``finish(inner_result)`` turns the engine's result into
    the caller's tensor.
    """

    def __init__(self, name: Optional[str], finish: Callable,
                 keep=()):
        self.name = name
        self._finish = finish
        self._keep = keep
        self._inner = None
        self._error: Optional[BaseException] = None
        self._ready = threading.Event()
        self._result = None
        self._done = False
        _outstanding[id(self)] = self

    def _set(self, inner=None, error=None, result=None) -> None:
        self._inner, self._error, self._result = inner, error, result
        self._ready.set()

    @property
    def completion_tick(self) -> Optional[int]:
        """The engine cycle that completed the collective (after
        :meth:`synchronize`; None where the engine did not run it)."""
        return None if self._inner is None else self._inner.completion_tick

    def poll(self) -> bool:
        if not self._ready.is_set():
            return False
        return self._inner is None or self._inner.poll()

    def synchronize(self) -> torch.Tensor:
        if self._done:
            raise ValueError(f"handle for '{self.name}' already synchronized")
        self._done = True
        try:
            self._ready.wait()
            if self._error is not None:
                raise self._error
            if self._inner is None:
                return self._result
            return self._finish(self._inner)
        finally:
            _outstanding.pop(id(self), None)
            self._keep = ()


def poll(handle: TorchHandle) -> bool:
    return handle.poll()


def synchronize(handle: TorchHandle) -> torch.Tensor:
    return handle.synchronize()


# --- the CUDA route ---------------------------------------------------------


class _Staging:
    """The thread that enqueues staged buffers once their copies land."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-torch-staging")
        self._thread.start()

    def submit(self, event, enqueue: Callable, handle: TorchHandle) -> None:
        self._queue.put((event, enqueue, handle))

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            event, enqueue, handle = item
            try:
                event.synchronize()  # the copy to host has landed
                handle._set(inner=enqueue())
            except BaseException as exc:  # raised by synchronize()
                handle._set(error=exc)

    def stop(self) -> None:
        self._queue.put(None)
        self._thread.join()


class _HostBuffer:
    """A pinned host buffer and the event after which it is free again."""

    def __init__(self, nbytes: int):
        self.host = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                pin_memory=True)
        self.free = None

    def view(self, dtype, shape) -> torch.Tensor:
        nbytes = int(torch.Size(shape).numel()) * dtype.itemsize
        return self.host[:nbytes].view(dtype).view(shape)


_staging: Optional[_Staging] = None
_staging_lock = threading.Lock()
# name -> _HostBuffer; cleared by hvd.shutdown().
_buffers: Dict[str, _HostBuffer] = {}
# Pinned buffers allocated by the staging route (the size-1 route
# allocates none), for tests and the chip smoke test.
pinned_allocs = [0]


def _stager() -> _Staging:
    global _staging
    with _staging_lock:
        if _staging is None:
            _staging = _Staging()
        return _staging


def _reset() -> None:
    global _staging
    with _staging_lock:
        if _staging is not None:
            _staging.stop()
            _staging = None
    _buffers.clear()


_common._shutdown_hooks.append(_reset)


def _buffer(name: Optional[str], nbytes: int) -> _HostBuffer:
    """The pinned buffer of collective ``name`` (a fresh one for auto
    names, whose names never repeat)."""
    buf = _buffers.get(name) if name is not None else None
    if buf is None or buf.host.numel() < nbytes:
        buf = _HostBuffer(nbytes)
        pinned_allocs[0] += 1
        if name is not None:
            _buffers[name] = buf
    return buf


def _to_host(tensor: torch.Tensor, buf: _HostBuffer) -> tuple:
    """Copy ``tensor`` into ``buf`` on the current stream: ``(host view,
    event recorded after the copy)``."""
    stream = torch.cuda.current_stream(tensor.device)
    if buf.free is not None:
        stream.wait_event(buf.free)  # the last copy back has read it
    host = buf.view(tensor.dtype, tensor.shape)
    host.copy_(tensor, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return host, event


def _to_device(host: torch.Tensor, out: torch.Tensor,
               buf: _HostBuffer) -> torch.Tensor:
    """Copy the engine's result back on the current stream; ``buf`` is
    free once the copy has read it."""
    stream = torch.cuda.current_stream(out.device)
    out.copy_(host, non_blocking=True)
    out.record_stream(stream)
    buf.free = torch.cuda.Event()
    buf.free.record(stream)
    return out


def _staged(op: int, tensor: torch.Tensor, name: Optional[str],
            out: Optional[torch.Tensor], root_rank: int,
            average: bool, group=None) -> TorchHandle:
    wire = name or _common._auto_name(
        ("allreduce", "allgather", "broadcast")[op])
    nbytes = tensor.numel() * tensor.element_size()
    buf = _buffer(name, nbytes)
    host, event = _to_host(tensor, buf)

    if op == _common.OP_ALLGATHER:
        def finish(inner):
            res = _buffer(None if name is None else name + ".result", 0)
            got = inner.wait(alloc=lambda shape, dtype: _fit(res, shape,
                                                             dtype))
            result = torch.empty(got.shape, dtype=got.dtype,
                                 device=tensor.device)
            return _to_device(got, result, res)

        def enqueue():
            return _common.allgather_async(host, name=wire)
    else:
        def finish(inner):
            return _to_device(inner.wait(), out, buf)

        def enqueue():
            if op == _common.OP_ALLREDUCE:
                return _common.allreduce_async(host, average, wire, out=host,
                                               group=group)
            return _common.broadcast_async(host, root_rank, wire, out=host)

    handle = TorchHandle(wire, finish, keep=(tensor, out, buf))
    _stager().submit(event, enqueue, handle)
    return handle


def _fit(buf: _HostBuffer, shape, dtype) -> torch.Tensor:
    """``buf`` as the host side of an allgather's result; the engine's
    copy into it waits for the last copy back to have read it."""
    if buf.free is not None:
        buf.free.synchronize()
    nbytes = int(torch.Size(shape).numel()) * dtype.itemsize
    if buf.host.numel() < nbytes:
        buf.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        pinned_allocs[0] += 1
    return buf.view(dtype, shape)


# --- dispatch ----------------------------------------------------------------


def _prepare(tensor: torch.Tensor, inplace: bool) -> torch.Tensor:
    if not torch.is_tensor(tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(tensor)}")
    if not tensor.is_contiguous():
        if inplace:
            raise ValueError(
                "in-place collectives require a contiguous tensor")
        tensor = tensor.contiguous()
    if tensor.device.type not in ("cpu", "cuda"):
        raise ValueError(f"collectives take CPU or CUDA tensors, not "
                         f"{tensor.device}")
    return tensor


def _submit(op: int, tensor: torch.Tensor, name: Optional[str],
            inplace: bool, root_rank: int = -1,
            average: bool = False, group=None) -> TorchHandle:
    tensor = _prepare(tensor, inplace)
    n = _common.size()  # raises before init()
    if tensor.device.type == "cuda" and n == 1:
        if op == _common.OP_BROADCAST and root_rank != 0:
            raise ValueError(
                f"broadcast root rank {root_rank} out of range for size 1")
        handle = TorchHandle(name, None)
        handle._set(result=tensor if inplace else tensor.clone())
        return handle
    if tensor.device.type == "cuda":
        out = tensor if inplace or op == _common.OP_ALLGATHER else \
            torch.empty_like(tensor)
        return _staged(op, tensor, name, out, root_rank, average, group)
    if op == _common.OP_ALLGATHER:
        inner = _common.allgather_async(tensor, name=name)
    else:
        out = tensor if inplace else torch.empty_like(tensor)
        if op == _common.OP_ALLREDUCE:
            inner = _common.allreduce_async(tensor, average, name, out=out,
                                            group=group)
        else:
            inner = _common.broadcast_async(tensor, root_rank, name, out=out)
    handle = TorchHandle(inner.name, lambda h: h.wait(), keep=(tensor,))
    handle._set(inner=inner)
    return handle


# --- allreduce ---------------------------------------------------------------


def allreduce_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None) -> TorchHandle:
    return _submit(_common.OP_ALLREDUCE, tensor, name, False,
                   average=average)


def allreduce_async_(tensor: torch.Tensor, average: bool = True,
                     name: Optional[str] = None, group=None) -> TorchHandle:
    """In place; with ``group`` (a
    :class:`~horovod_tpu_torch.common.StageGroup`) the reduction runs over
    the group's ranks only."""
    return _submit(_common.OP_ALLREDUCE, tensor, name, True, average=average,
                   group=group)


class _AllreduceFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name):
        ctx.average = average
        return allreduce_async(tensor, average, name).synchronize()

    @staticmethod
    def backward(ctx, grad_output):
        return (allreduce_async(grad_output.contiguous(),
                                ctx.average).synchronize(), None, None)


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None) -> torch.Tensor:
    """Differentiable allreduce: its gradient is itself allreduced."""
    return _AllreduceFunction.apply(tensor, average, name)


def allreduce_(tensor: torch.Tensor, average: bool = True,
               name: Optional[str] = None) -> torch.Tensor:
    return allreduce_async_(tensor, average, name).synchronize()


# --- allgather ---------------------------------------------------------------


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> TorchHandle:
    if tensor.dim() == 0:
        raise ValueError("allgather requires tensors of rank >= 1")
    return _submit(_common.OP_ALLGATHER, tensor, name, False)


class _AllgatherFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0 = tensor.shape[0] if tensor.dim() else 0
        return allgather_async(tensor, name).synchronize()

    @staticmethod
    def backward(ctx, grad_output):
        # d(concat_r x_r)/dx_me: every rank's grad_output summed, then this
        # rank's rows; the row offsets come from an allgather of dim 0.
        grad_sum = allreduce_async(grad_output.contiguous(),
                                   average=False).synchronize()
        sizes = allgather_async(
            torch.tensor([ctx.dim0], dtype=torch.int64)).synchronize()
        offset = int(sizes[:_common.rank()].sum())
        return grad_sum.narrow(0, offset, ctx.dim0), None


def allgather(tensor: torch.Tensor,
              name: Optional[str] = None) -> torch.Tensor:
    """Differentiable concatenation of every rank's tensor along dim 0."""
    return _AllgatherFunction.apply(tensor, name)


# --- broadcast ---------------------------------------------------------------


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> TorchHandle:
    return _submit(_common.OP_BROADCAST, tensor, name, False,
                   root_rank=root_rank)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> TorchHandle:
    return _submit(_common.OP_BROADCAST, tensor, name, True,
                   root_rank=root_rank)


class _BroadcastFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return broadcast_async(tensor, root_rank, name).synchronize()

    @staticmethod
    def backward(ctx, grad_output):
        grad = allreduce_async(grad_output.contiguous(),
                               average=False).synchronize()
        if _common.rank() != ctx.root_rank:
            grad = grad * 0
        return grad, None, None


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    """Differentiable broadcast; the ranks other than the root get a zero
    gradient."""
    return _BroadcastFunction.apply(tensor, root_rank, name)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank, name).synchronize()
