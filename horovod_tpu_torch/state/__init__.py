"""State plane of the port, part 1: the partition contract and the
sharded durable checkpoints.

Own copy of ``horovod_tpu/state``'s ``partition.py`` (leaf ``i`` of the
flattened state belongs to rank ``i % size``) and ``checkpoint.py``
(``ckpt-<step>/rank-N.pkl`` and an atomically committed manifest, in the
JAX package's format), surfaced through
``horovod_tpu_torch.torch.train.save_checkpoint(..., sharded=True)``.
The snapshots, the peer copies and the armed plane (``arm``,
``current``) come with elastic membership.
"""

from __future__ import annotations

from horovod_tpu_torch.state import checkpoint  # noqa: F401
from horovod_tpu_torch.state.partition import (  # noqa: F401
    flatten_tree,
    owner,
    shard_indices,
)
