"""The state plane's partition contract: who owns which leaf.

Own copy of ``horovod_tpu/state/partition.py``.  A flattened state tree
of ``n`` leaves in a job of ``size`` ranks gives leaf ``i`` to rank
``i % size``: a pure function of ``(i, size)``, so a reader at another
world size, or with no engine at all, rebuilds the writer's layout from
the manifest alone.  The leaf order is :mod:`._tree`'s walk, the one the
JAX package's checkpoints use.  ``flatten_state`` (over an
``ElasticState``) waits for elastic membership.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

from horovod_tpu_torch.state import _tree


def owner(leaf_index: int, size: int) -> int:
    """The rank owning leaf ``leaf_index`` in a ``size``-rank job."""
    if size <= 0:
        raise ValueError(f"need size >= 1, got {size}")
    return leaf_index % size


def shard_indices(rank: int, size: int, n_leaves: int) -> List[int]:
    """The leaf indices rank ``rank`` owns out of ``n_leaves``."""
    if not 0 <= rank < size:
        raise ValueError(f"need 0 <= rank ({rank}) < size ({size})")
    return list(range(rank, n_leaves, size))


def flatten_tree(tree: Any) -> Tuple[list, Callable[[list], Any]]:
    """``(leaves, rebuild)`` in the state plane's canonical order."""
    return _tree.flatten(tree)
