"""The data-parallel training step: the Horovod recipe in one call.

Counterpart of ``horovod_tpu/jax/train.py::build_train_step``, at any
number of processes and, optionally, with a sequence-parallel ring on one
card.  Each worker computes gradients on its own batch,
``DistributedOptimizer`` averages them through the engine before the
update, and the returned loss is averaged across workers as ``lax.pmean``
does in the reference; with ``has_aux`` so are the loss function's aux
tensors (the reference's ``has_aux=True``: updated batch-norm statistics,
say).  With a timeline on (``HVD_TPU_TIMELINE``), each step is a
``TRAIN_STEP`` span on the trace row ``torch.train_step``, as the
reference's ``jax.train_step``.  :func:`run_pipeline` is the counterpart
of ``horovod_tpu/jax/train.py::run_pipeline``: pipeline-parallel training
over the engine's point-to-point plane.

The checkpoint glue (:func:`save_checkpoint`, :func:`latest_checkpoint`,
:func:`load_checkpoint`, :func:`load_latest_checkpoint`) has the
contracts of ``horovod_tpu/jax/train.py``'s and its formats, the legacy
``ckpt-<step>.pkl`` and the sharded ``ckpt-<step>/`` (``state/checkpoint.py``),
so a job resumes from either package's checkpoints.  The tree users save
is ``{"model": model.state_dict(), "optimizer": opt.state_dict(),
"step": n}``; tensors are written as numpy arrays and read back as
tensors.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from horovod_tpu_torch import common as _common
from horovod_tpu_torch.common import metrics as _metrics
from horovod_tpu_torch.state import checkpoint as _ckpt
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
    the backward, so it never reaches the update.  Across processes
    (dp x sp: every rank a ring of its own) each rank's gradient is that
    sum for its own rows and the step averages it over the ranks, so the
    update follows the mean over ranks of the members' summed
    contributions to the mean loss: the reference's ``pmean`` over
    ``("dp", "sp")``.  A masked loss must normalise over both axes
    (``next_token_loss(..., axis_name=("dp", mesh))``) for that mean to
    be the job's weighted mean.  A parameter's gradient hook fires once
    per backward, after the ring op that fed it has joined its member
    streams into the caller's stream (each ring op is one autograd node
    and its join synchronizes), so the gradient's copy to the host is
    ordered after every member's kernels and no host call of the staging
    lands between two members' launches.
    ``optimizer`` is wrapped in :class:`DistributedOptimizer` unless it
    already is one.  One step runs forward, backward (whose gradient hooks
    enqueue the averages), ``DistributedOptimizer.synchronize``, the
    optimizer step and ``zero_grad``, and returns the cross-worker mean
    loss (detached).  ``step.step_sec`` collects the host seconds of each
    call and ``step.sync_sec`` those spent in ``synchronize`` (the wait on
    the engine and the copies back); work still queued on the GPU when the
    call returns is in neither.  ``step.optimizer`` is the
    ``DistributedOptimizer``.  With a timeline on, each call is a
    ``TRAIN_STEP`` span on the row ``torch.train_step``.
    """
    if not isinstance(optimizer, DistributedOptimizer):
        optimizer = DistributedOptimizer(
            optimizer, named_parameters=model.named_parameters())

    def step(batch):
        if not _common.timeline_enabled():
            return run(batch)
        _common._trace_begin("torch.train_step", "TRAIN_STEP")
        try:
            return run(batch)
        finally:
            _common._trace_end("torch.train_step")

    def run(batch):
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


# ---------------------------------------------------------------------------
# Checkpoints (docs/fault-tolerance.md): the reference's resume glue.
# ---------------------------------------------------------------------------


def _ckpt_barrier(name: str) -> None:
    """The sharded commit's named barrier: an allreduce of one int."""
    _common.allreduce(torch.ones(1, dtype=torch.int32), average=False,
                      name=name)


def save_checkpoint(directory: str, step: int, tree,
                    sharded: bool = False,
                    keep: Optional[int] = None) -> str:
    """Write ``tree`` (tensors, numpy arrays and picklable python values
    in dicts, lists, tuples and namedtuples) as a checkpoint under
    ``directory``; returns the committed path.

    Legacy (``sharded=False``): one atomic ``ckpt-<step>.pkl`` of
    ``{"step", "tree"}`` with numpy leaves; call on one rank
    (conventionally 0).  Sharded (``sharded=True``): call on every rank;
    each writes the leaves it owns to ``ckpt-<step>/rank-N.pkl``, a named
    barrier confirms every shard, rank 0 commits ``manifest.json``, and a
    second barrier holds every rank until the commit.  Then the oldest
    committed checkpoints past ``keep`` (default ``HVD_TPU_CKPT_KEEP``;
    unset keeps all) are pruned, never the new one nor a torn directory.
    """
    if keep is None:
        keep = _ckpt.retention_keep()
    os.makedirs(directory, exist_ok=True)
    if sharded:
        if _common.is_initialized():
            rank, n = _common.rank(), _common.size()
            barrier = _ckpt_barrier if n > 1 else None
        else:
            rank, n, barrier = 0, 1, None
        path = _ckpt.save_sharded(directory, step, tree, rank, n,
                                  barrier=barrier)
        if rank == 0:
            _ckpt.prune_checkpoints(directory, keep, protect_step=step)
        return path
    import pickle

    path = os.path.join(directory, f"{_ckpt.CKPT_PREFIX}{int(step):08d}"
                                   f"{_ckpt.CKPT_SUFFIX}")
    host = _ckpt.host_tree(tree)
    _ckpt.atomic_write(path, lambda f: pickle.dump(
        {"step": int(step), "tree": host}, f))
    _metrics.registry.record_state_ckpt("legacy_saves",
                                        nbytes=os.path.getsize(path))
    _ckpt.prune_checkpoints(directory, keep, protect_step=step)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest committed checkpoint in ``directory``, a legacy file or
    a sharded directory with its manifest; None when there is none."""
    entries = _ckpt.scan_checkpoints(directory)
    return entries[-1][1] if entries else None


def load_checkpoint(path: str, collective: bool = True, device=None):
    """``(step, tree)`` from the checkpoint ``path`` (a legacy file or a
    sharded directory), array leaves as tensors on ``device`` (the CPU by
    default).  A sharded one with ``collective=True`` and the engine up
    at its world size reads this rank's shard and receives the rest by
    broadcast (every rank must call); ``collective=False`` reads every
    shard here."""
    if os.path.isdir(path):
        return _ckpt.load_sharded(path, collective=collective,
                                  device=device)
    with open(path, "rb") as f:
        payload = _ckpt.load_pickle(f)
    _metrics.registry.record_state_ckpt("loads")
    return int(payload["step"]), _ckpt.tensors(payload["tree"], device)


def load_latest_checkpoint(directory: str, collective: bool = True,
                           device=None):
    """``(step, tree)`` from the newest committed checkpoint in
    ``directory``, or ``(0, None)`` when there is none, so resume code can
    be unconditional."""
    path = latest_checkpoint(directory)
    if path is None:
        return 0, None
    return load_checkpoint(path, collective=collective, device=device)
