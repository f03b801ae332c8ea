"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The five-line recipe on one NVIDIA H100::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch import DistributedOptimizer
    from horovod_tpu_torch.torch.train import build_train_step
    hvd.init()                                   # pins cuda:local_rank()
    opt = DistributedOptimizer(torch.optim.AdamW(model.parameters(), ...))
    step = build_train_step(loss_fn, opt, model)

The attention of ``models.TransformerLM`` runs through hand-written CUDA
flash-attention kernels (``ops/csrc``); with ``seq_axis=`` a
``parallel.RingMesh`` it is ring attention over members co-located on the
card, through the ring kernels in the same directory.  The package imports nothing of
``horovod_tpu`` and no JAX.
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
