"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The five-line recipe, one process per NVIDIA H100 (``python -m
horovod_tpu_torch.runner -np N -- python train.py``)::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch import DistributedOptimizer
    from horovod_tpu_torch.torch.train import build_train_step
    hvd.init()                                   # pins cuda:local_rank()
    opt = DistributedOptimizer(torch.optim.AdamW(model.parameters(), ...))
    step = build_train_step(loss_fn, opt, model)

Gradients are averaged across processes by the collective engine
(``engine/``, host C++ built at first use), CUDA tensors staged through
pinned host memory.  The attention of ``models.TransformerLM`` runs
through hand-written CUDA flash-attention kernels (``ops/csrc``); with
``seq_axis=`` a ``parallel.RingMesh`` it is ring attention over members
co-located on the card, through the ring kernels in the same directory.
The package imports nothing of ``horovod_tpu`` and no JAX.

``hvd.metrics_snapshot()`` reads the collective metrics registry
(``HVD_TPU_METRICS=1``; ``HVD_TPU_METRICS_FILE`` dumps it per rank,
``HVD_TPU_MONITOR_PORT`` serves it over HTTP), and
``HVD_TPU_POSTMORTEM_DIR`` makes a rank that dies leave its flight
recorder and pending collectives in ``rank-<N>.json``.

The top level also carries the reference's host collectives
(``allreduce``, ``allgather``, ``broadcast``, their ``_async`` forms),
the point-to-point plane (``send``, ``recv``, ``stage_group``) and
``mpi_threads_supported``, under the reference's names.  They take
contiguous CPU tensors: a numpy array goes in as ``torch.from_numpy(a)``.
CUDA tensors go through ``horovod_tpu_torch.torch``'s collectives.

Importing it sets the float32 numerics of the card to what the float32
reference computes: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` both False, so float32 matmuls and
convolutions (the image models') keep full float32 and never run in TF32
(about three decimal digits).  PyTorch's own defaults leave the matmul
flag False and the cuDNN flag True.  bf16 and fp16 work is unaffected.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from horovod_tpu_torch import state  # noqa: F401
from horovod_tpu_torch.common import (  # noqa: F401
    CollectiveTimeoutError,
    HorovodInternalError,
    HorovodNotInitializedError,
    MembershipChangedError,
    RanksDownError,
    StageGroup,
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    autotune_report,
    autotune_set,
    broadcast,
    broadcast_async,
    compression_report,
    init,
    is_initialized,
    local_rank,
    local_size,
    membership_ack,
    membership_epoch,
    metrics_reset,
    metrics_snapshot,
    mpi_threads_supported,
    rank,
    recv,
    recv_async,
    restart_epoch,
    send,
    send_async,
    shutdown,
    size,
    stage_group,
    timeline_enabled,
    trace_marker,
    trace_span,
)
from horovod_tpu_torch.common.elastic import (  # noqa: F401
    ElasticState,
    run_elastic,
)

__all__ = ["HorovodInternalError", "MembershipChangedError", "init",
           "shutdown", "is_initialized", "rank", "size", "local_rank",
           "local_size", "timeline_enabled", "trace_span", "trace_marker",
           "ElasticState", "run_elastic", "membership_epoch",
           "membership_ack", "restart_epoch", "state",
           "compression_report", "autotune_report", "autotune_set",
           "metrics_snapshot", "metrics_reset", "RanksDownError",
           "CollectiveTimeoutError", "HorovodNotInitializedError",
           "allreduce", "allreduce_async", "allgather", "allgather_async",
           "broadcast", "broadcast_async", "send", "send_async", "recv",
           "recv_async", "stage_group", "StageGroup",
           "mpi_threads_supported"]

__version__ = "0.1.0"
