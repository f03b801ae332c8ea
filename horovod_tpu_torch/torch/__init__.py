"""PyTorch binding of the port: the collectives, ``DistributedOptimizer``
and the broadcasts of parameters and optimizer state.

Counterpart of ``horovod_tpu/torch/__init__.py``: the optimizer wrapper
overlaps the gradient allreduce with the backward through one
post-accumulate-grad hook per parameter, ``step()`` drains the
outstanding handles first, and ``broadcast_parameters`` /
``broadcast_optimizer_state`` replicate a root rank's state.  The
collectives (``mpi_ops``) take CPU tensors and, through pinned host
buffers, CUDA tensors.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Optional, Tuple

import torch

from horovod_tpu_torch import common as _common
from horovod_tpu_torch import state  # noqa: F401  (re-exported)
from horovod_tpu_torch.common import (  # noqa: F401  (re-exported)
    CollectiveTimeoutError,
    HorovodInternalError,
    HorovodNotInitializedError,
    MembershipChangedError,
    RanksDownError,
    autotune_report,
    autotune_set,
    compression_report,
    init,
    is_initialized,
    local_rank,
    local_size,
    membership_ack,
    membership_epoch,
    rank,
    restart_epoch,
    shutdown,
    size,
    timeline_enabled,
    trace_marker,
    trace_span,
)
from horovod_tpu_torch.common.elastic import (  # noqa: F401
    ElasticState,
    run_elastic,
)
from horovod_tpu_torch.torch import mpi_ops as _mpi_ops
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    poll,
    synchronize,
)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "HorovodInternalError", "RanksDownError",
    "CollectiveTimeoutError", "HorovodNotInitializedError", "allreduce",
    "allreduce_", "allreduce_async", "allreduce_async_", "allgather",
    "allgather_async", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "poll", "synchronize", "broadcast_parameters",
    "broadcast_optimizer_state", "DistributedOptimizer",
    "timeline_enabled", "trace_span", "trace_marker",
    "MembershipChangedError", "ElasticState", "run_elastic",
    "membership_epoch", "membership_ack", "restart_epoch", "state",
    "compression_report", "autotune_report", "autotune_set",
]


class DistributedOptimizer(torch.optim.Optimizer):
    """Wrap ``optimizer`` so its ``step()`` sees every gradient averaged
    across workers, each allreduced under its parameter's name.

    As backward produces a parameter's gradient, its hook enqueues an
    async in-place average of it, so the copies and the engine overlap the
    rest of the backward.  With ``backward_passes_per_step=N`` the
    average waits for the N-th backward since the last step, so ``.grad``
    first sums the N micro-batches locally.  :meth:`synchronize` enqueues
    what never fired and drains every handle; ``step()`` calls it unless
    it already ran since the last gradient.  ``sync_sec`` collects the
    seconds of each :meth:`synchronize`, and ``last_ticks`` holds the
    engine cycles that completed the last one's handles (fused
    allreduces share a cycle).

    The wrapper shares the inner optimizer's ``param_groups`` and
    ``state`` (a learning-rate scheduler on either moves both), and
    ``zero_grad``/``state_dict`` act on the same objects.
    ``named_parameters`` names the collectives; without it they are
    numbered in ``param_groups`` order.

    A collective that fails (an elastic reshape's
    ``MembershipChangedError``, a dead rank's ``RanksDownError``) fails
    :meth:`synchronize` only once every handle of the step has been
    drained: the step is abandoned whole, every ``.grad`` is dropped (a
    partial average is no gradient), the pinned buffers of the
    optimizer's names are released, and the error raised is a
    ``MembershipChangedError`` where any handle saw one (it is the one
    ``run_elastic`` retries), else the first.  A re-entered training
    function then starts with no stale handle, gradient or buffer.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.Tensor]]] = None,
                 average: bool = True,
                 name_prefix: str = "DistributedOptimizer",
                 backward_passes_per_step: int = 1):
        # Optimizer.__init__ re-appends the given group dicts themselves,
        # so both optimizers hold the same group objects.
        super().__init__(optimizer.param_groups, optimizer.defaults)
        self.state = optimizer.state
        self._inner = optimizer
        self._average = average
        self._prefix = f"{name_prefix}."
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._backward_passes_per_step = backward_passes_per_step
        names = {id(p): n for n, p in (named_parameters or ())}
        self._names = {}
        for g, group in enumerate(self.param_groups):
            for j, p in enumerate(group["params"]):
                self._names[id(p)] = (f"{name_prefix}."
                                      f"{names.get(id(p), f'{g}.{j}')}")
        self._handles = {}
        self._passes = collections.Counter()
        self._synchronized = False
        self.sync_sec = []
        self.last_ticks = []
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._hook)

    def _hook(self, p: torch.Tensor) -> None:
        if p in self._handles:
            # The allreduce in flight still reads p.grad; a second backward
            # would race its accumulation into the same memory.
            raise RuntimeError(
                f"gradient for '{self._names[id(p)]}' was produced again "
                "while its allreduce is still in flight. For gradient "
                "accumulation over N micro-batches, construct "
                "DistributedOptimizer(..., backward_passes_per_step=N); "
                "otherwise call step()/synchronize() between backward "
                "passes.")
        self._synchronized = False
        self._passes[id(p)] += 1
        if self._passes[id(p)] >= self._backward_passes_per_step:
            self._handles[p] = allreduce_async_(
                p.grad.data, average=self._average, name=self._names[id(p)])

    def synchronize(self) -> None:
        """Average every ``.grad`` across workers, in place: enqueue the
        gradients whose hooks did not fire, then wait for all."""
        t0 = time.perf_counter()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None and p not in self._handles:
                    self._handles[p] = allreduce_async_(
                        p.grad.data, average=self._average,
                        name=self._names[id(p)])
        errors = []
        try:
            for handle in self._handles.values():
                try:
                    handle.synchronize()
                except Exception as exc:  # drain the rest first
                    errors.append(exc)
            self.last_ticks = [h.completion_tick
                               for h in self._handles.values()]
        finally:
            self._handles.clear()
            self._passes.clear()
        if errors:
            for group in self.param_groups:
                for p in group["params"]:
                    p.grad = None
            _mpi_ops.release_buffers(self._prefix)
            raise next((e for e in errors
                        if isinstance(e, _common.MembershipChangedError)),
                       errors[0])
        self._synchronized = True
        self.sync_sec.append(time.perf_counter() - t0)

    def step(self, closure=None):
        if not self._synchronized:
            self.synchronize()
        self._synchronized = False
        return self._inner.step(closure)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state_dict):
        # The inner optimizer rebuilds its group dicts: share the new ones.
        self._inner.load_state_dict(state_dict)
        self.state = self._inner.state
        self.param_groups = self._inner.param_groups


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Replicate ``root_rank``'s parameters in place; ``params`` is a
    ``state_dict`` or an iterable of ``(name, tensor)``."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = []
    for name, p in items:
        if p is None:
            continue
        if not torch.is_tensor(p):
            raise ValueError(
                f"broadcast_parameters got non-tensor for '{name}'; use "
                "broadcast_optimizer_state for mixed state")
        handles.append(broadcast_async_(p.data, root_rank,
                                        name=f"broadcast_parameters.{name}"))
    for h in handles:
        h.synchronize()


_SCALAR_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float64}


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Replicate ``root_rank``'s optimizer state on every worker, scalar
    hyperparameters round-tripped through tensors.

    An optimizer without state first takes one local step of its own
    with zero gradients, learning rate and weight decay, so every rank
    has the same structure to fill and no parameter moves (a
    ``DistributedOptimizer`` steps its inner optimizer: the root may hold
    loaded state and would never join the gradient allreduce).  LBFGS
    keeps state that cannot be broadcast and is refused.
    """
    inner = optimizer._inner if isinstance(
        optimizer, DistributedOptimizer) else optimizer
    if isinstance(inner, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()
    if not state_dict["state"]:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        saved = [{key: group[key] for key in ("lr", "weight_decay")
                  if key in group} for group in optimizer.param_groups]
        for group in optimizer.param_groups:
            for key in ("lr", "weight_decay"):
                if key in group:
                    group[key] = 0.0
        try:
            inner.step()
        finally:
            for group, vals in zip(optimizer.param_groups, saved):
                group.update(vals)
        state_dict = optimizer.state_dict()

    handles = []

    def visit(prefix: str, container, key) -> None:
        value = container[key]
        name = f"broadcast_opt_state.{prefix}"
        if torch.is_tensor(value):
            handles.append(broadcast_async_(value, root_rank, name=name))
        elif isinstance(value, (bool, int, float)):
            t = torch.tensor(value, dtype=_SCALAR_DTYPES[type(value)])
            out = _common.broadcast_async(t, root_rank, name).wait()
            container[key] = type(value)(out.item())

    for pid, pstate in sorted(state_dict["state"].items(),
                              key=lambda kv: str(kv[0])):
        for key in sorted(pstate, key=str):
            visit(f"state.{pid}.{key}", pstate, key)
    for gi, group in enumerate(state_dict["param_groups"]):
        for key in sorted(group, key=str):
            if key != "params":
                visit(f"group.{gi}.{key}", group, key)
    for h in handles:
        h.synchronize()
    optimizer.load_state_dict(state_dict)
