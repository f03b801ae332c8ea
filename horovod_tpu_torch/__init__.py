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
    HorovodInternalError,
    MembershipChangedError,
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

__all__ = ["HorovodInternalError", "MembershipChangedError", "init",
           "shutdown", "is_initialized", "rank", "size", "local_rank",
           "local_size", "timeline_enabled", "trace_span", "trace_marker",
           "ElasticState", "run_elastic", "membership_epoch",
           "membership_ack", "restart_epoch", "state",
           "compression_report", "autotune_report", "autotune_set"]
