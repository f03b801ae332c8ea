"""The data-parallel training step: the Horovod recipe in one call.

Counterpart of ``horovod_tpu/jax/train.py::build_train_step``, at any
number of processes and, optionally, with a sequence-parallel ring on one
card.  Each worker computes gradients on its own batch,
``DistributedOptimizer`` averages them through the engine before the
update, and the returned loss is averaged across workers as ``lax.pmean``
does in the reference; with ``has_aux`` so are the loss function's aux
tensors (the reference's ``has_aux=True``: updated batch-norm statistics,
say).  :func:`run_pipeline` is the counterpart of
``horovod_tpu/jax/train.py::run_pipeline``: pipeline-parallel training
over the engine's point-to-point plane.  Checkpoint glue is not part of
this module yet.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

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


def run_pipeline(stage_modules, optimizer: Callable, batches,
                 n_stages: Optional[int] = None,
                 n_microbatches: Optional[int] = None,
                 loss_fn=None, prefix: str = "pipe",
                 tag: Optional[int] = None, stats: Optional[dict] = None):
    """Pipelined training loop: 1F1B over the engine's p2p plane.

    The world is a ``stages x data-parallel`` grid, stage-major
    (:class:`~horovod_tpu_torch.parallel.PipelineGrid`).  Each step runs
    this rank's 1F1B schedule (interleaved when ``stage_modules`` holds
    several chunks) through a
    :class:`~horovod_tpu_torch.parallel.PipelineRunner`, averages each
    chunk's accumulated gradients over this stage's ``stage_group``
    (never the whole world; one named allreduce per parameter,
    ``{prefix}.s{stage}.grad.c{chunk}.l{i}``, all in flight together,
    CUDA gradients staged through pinned host memory) and steps each
    chunk's optimizer.

    ``stage_modules`` are this rank's chunks (``partition_transformer``
    with a slice of ``partition_params`` loaded).  ``optimizer`` is a
    factory, ``optimizer(params) -> torch.optim.Optimizer``, called once
    per chunk with that chunk's parameters (the reference's
    ``optimizer.init`` per chunk): say ``lambda ps: torch.optim.AdamW(ps,
    lr=1e-3, weight_decay=1e-4)`` for optax's ``adamw(1e-3)``, whose
    weight decay differs from PyTorch's default.  ``batches`` iterates
    ``(inputs, targets)``, this DP rank's whole batches (numpy or torch):
    the first stage reads the inputs, the last the targets, and every
    stage the activation buckets' shape.  ``loss_fn(logits, targets)``
    runs on the last stage (default ``models.next_token_loss``).

    Knobs, where the argument is None: ``HVD_TPU_PIPELINE_STAGES``,
    ``HVD_TPU_PIPELINE_MICROBATCHES`` (default 4) and
    ``HVD_TPU_PIPELINE_TAG`` (the p2p tag, default 0: another tag keeps
    a concurrent pipeline's transfers apart).  With ``stats`` (a dict),
    the host seconds of each step (``step_sec``) and of its gradient
    average (``grad_sync_sec``) are appended under those keys.

    Returns ``(stage_modules, optimizers, losses)``: ``losses`` holds one
    mean micro-batch loss per step on the last stage, None elsewhere.  A
    dead rank raises :class:`~horovod_tpu_torch.common.RanksDownError`
    naming its pipeline stage, wherever the survivors meet it.
    """
    import torch

    from horovod_tpu_torch import common as hvd
    from horovod_tpu_torch.models import next_token_loss
    from horovod_tpu_torch.parallel.pipeline import (EngineTransport,
                                                     PipelineGrid,
                                                     PipelineRunner,
                                                     _dead_stages)
    from horovod_tpu_torch.torch.mpi_ops import allreduce_async_

    if n_stages is None:
        n_stages = int(os.environ.get("HVD_TPU_PIPELINE_STAGES", "0"))
    if n_stages < 1:
        raise ValueError(
            "pass n_stages= or set HVD_TPU_PIPELINE_STAGES (>= 1)")
    if n_microbatches is None:
        n_microbatches = int(
            os.environ.get("HVD_TPU_PIPELINE_MICROBATCHES", "4"))
    if tag is None:
        tag = int(os.environ.get("HVD_TPU_PIPELINE_TAG", "0"))

    grid = PipelineGrid(n_stages, hvd.size(), hvd.rank())
    last = grid.stage == n_stages - 1
    if loss_fn is None and last:
        loss_fn = next_token_loss
    runner = PipelineRunner(stage_modules, grid, n_microbatches,
                            EngineTransport(tag), loss_fn=loss_fn,
                            prefix=prefix)
    group = hvd.stage_group(grid.stage_ranks()) if grid.dp > 1 else None
    optimizers = [optimizer(list(m.parameters())) for m in runner.stages]
    losses = []
    try:
        for inputs, targets in batches:
            t0 = time.perf_counter()
            runner.set_bucket_shape(inputs.shape[0] // n_microbatches,
                                    inputs.shape[1])
            loss, grads = runner.step(inputs if grid.stage == 0 else None,
                                      targets if last else None)
            t1 = time.perf_counter()
            if group is not None:
                # The stage id is in the name: the groups are disjoint, so
                # every stage negotiates the same leaf index at once.
                handles = [
                    allreduce_async_(g, average=True, group=group,
                                     name=f"{prefix}.s{grid.stage}.grad"
                                          f".c{chunk}.l{i}")
                    for chunk, tree in enumerate(grads)
                    for i, g in enumerate(tree.values()) if g is not None]
                for h in handles:
                    h.synchronize()
            t2 = time.perf_counter()
            for opt in optimizers:
                opt.step()
            losses.append(loss)
            if stats is not None:
                stats.setdefault("grad_sync_sec", []).append(t2 - t1)
                stats.setdefault("step_sec", []).append(
                    time.perf_counter() - t0)
        # A closing world barrier: the stage groups are disjoint, so a
        # fast stage could otherwise shut the engine down while another
        # stage's group average is still in flight.
        hvd.allreduce(torch.zeros(1), name=f"{prefix}.barrier")
    except hvd.RanksDownError as exc:
        # The runner names the stage of an abort it meets; one met in the
        # gradient average or the barrier is named here.
        if str(exc).startswith("pipeline aborted"):
            raise
        raise hvd.RanksDownError(
            f"pipeline aborted: {_dead_stages(grid, exc.ranks)} died: "
            f"{exc}", exc.ranks) from exc
    return runner.stages, optimizers, losses
