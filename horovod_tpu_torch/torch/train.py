"""The data-parallel training step: the Horovod recipe in one call.

Counterpart of ``horovod_tpu/jax/train.py::build_train_step``, at any
number of processes and, optionally, with a sequence-parallel ring on one
card.  Each worker computes gradients on its own batch,
``DistributedOptimizer`` averages them through the engine before the
update, and the returned loss is averaged across workers as ``lax.pmean``
does in the reference; with ``has_aux`` so are the loss function's aux
tensors (the reference's ``has_aux=True``: updated batch-norm statistics,
say).  Checkpoint glue is not part of this module yet.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from horovod_tpu_torch.torch import (DistributedOptimizer, allreduce,
                                     allreduce_async, size, synchronize)


def _average_aux(aux):
    """``aux`` (a tensor, or a list, tuple or dict of them) with every
    tensor detached and averaged across workers: one named allreduce
    each, all in flight together so the engine can fuse them; a mean over
    one worker is the tensor itself."""
    if torch.is_tensor(aux):
        return _average_aux([aux])[0]
    items = list(aux.items()) if isinstance(aux, dict) else list(
        enumerate(aux))
    if size() == 1:
        out = {k: t.detach() for k, t in items}
    else:
        handles = [(k, allreduce_async(t.detach(), average=True,
                                       name=f"train_step.aux.{k}"))
                   for k, t in items]
        out = {k: synchronize(h) for k, h in handles}
    if isinstance(aux, dict):
        return out
    return type(aux)(out[k] for k, _ in items)


def build_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module, has_aux: bool = False):
    """Build ``step(batch) -> loss`` (``-> (loss, aux)`` with ``has_aux``).

    ``loss_fn(model, batch)`` returns this worker's mean loss, or with
    ``has_aux`` ``(loss, aux)``: ``aux`` a tensor or a list, tuple or dict
    of tensors, which the step returns detached and averaged across
    workers, as the reference's step ``lax.pmean``s its aux tree.  For a
    sequence-parallel model (built with ``seq_axis``, a
    :class:`~horovod_tpu_torch.parallel.RingMesh`) the loss is the mean
    over all tokens of the ring and the gradients are the sum of the
    members' contributions (one parameter set, so autograd sums them); a
    ring kernel that gave up makes its ring op raise in the forward or
    the backward, so it never reaches the update.
    ``optimizer`` is wrapped in :class:`DistributedOptimizer` unless it
    already is one.  One step runs forward, backward (whose gradient hooks
    enqueue the averages), ``DistributedOptimizer.synchronize``, the
    optimizer step and ``zero_grad``, and returns the cross-worker mean
    loss (detached).  ``step.step_sec`` collects the host seconds of each
    call and ``step.sync_sec`` those spent in ``synchronize`` (the wait on
    the engine and the copies back); work still queued on the GPU when the
    call returns is in neither.  ``step.optimizer`` is the
    ``DistributedOptimizer``.
    """
    if not isinstance(optimizer, DistributedOptimizer):
        optimizer = DistributedOptimizer(
            optimizer, named_parameters=model.named_parameters())

    def step(batch):
        t0 = time.perf_counter()
        loss = loss_fn(model, batch)
        if has_aux:
            loss, aux = loss
        loss.backward()
        optimizer.synchronize()
        step.sync_sec.append(optimizer.sync_sec[-1])
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        loss = allreduce(loss.detach(), average=True, name="train_step.loss")
        if has_aux:
            aux = _average_aux(aux)
        step.step_sec.append(time.perf_counter() - t0)
        return (loss, aux) if has_aux else loss

    step.step_sec = []
    step.sync_sec = []
    step.optimizer = optimizer
    return step
