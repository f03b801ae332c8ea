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
"""

from horovod_tpu_torch.common import (  # noqa: F401
    HorovodInternalError,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)

__all__ = ["HorovodInternalError", "init", "shutdown", "is_initialized",
           "rank", "size", "local_rank", "local_size"]
