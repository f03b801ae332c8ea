"""Device ops of the port: attention (CUDA flash kernels + plain versions),
the ring rotation and ring attention over a ring mesh."""

from horovod_tpu_torch.ops.attention import (  # noqa: F401
    blockwise_attention,
    flash_attention,
    mha_reference,
)
from horovod_tpu_torch.ops.rdma import ring_permute  # noqa: F401
from horovod_tpu_torch.ops.ring_attention import ring_attention  # noqa: F401
from horovod_tpu_torch.ops.ring_flash import (  # noqa: F401
    fused_ring_attention,
)

__all__ = ["flash_attention", "blockwise_attention", "mha_reference",
           "ring_attention", "ring_permute", "fused_ring_attention"]
