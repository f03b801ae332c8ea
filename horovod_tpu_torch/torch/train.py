"""The data-parallel training step: the Horovod recipe in one call.

Counterpart of ``horovod_tpu/jax/train.py::build_train_step``, at any
number of processes and, optionally, with a sequence-parallel ring on one
card.  Each worker computes gradients on its own batch,
``DistributedOptimizer`` averages them through the engine before the
update, and the returned loss is averaged across workers as ``lax.pmean``
does in the reference.  Checkpoint glue is not part of this module yet.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from horovod_tpu_torch.torch import DistributedOptimizer, allreduce


def build_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module):
    """Build ``step(batch) -> loss``.

    ``loss_fn(model, batch)`` returns this worker's mean loss.  For a
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
        loss.backward()
        optimizer.synchronize()
        step.sync_sec.append(optimizer.sync_sec[-1])
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        loss = allreduce(loss.detach(), average=True, name="train_step.loss")
        step.step_sec.append(time.perf_counter() - t0)
        return loss

    step.step_sec = []
    step.sync_sec = []
    step.optimizer = optimizer
    return step
