"""The state plane's partition contract: who owns which leaf.

Own copy of ``horovod_tpu/state/partition.py``.  A flattened state tree
of ``n`` leaves in a job of ``size`` ranks gives leaf ``i`` to rank
``i % size``: a pure function of ``(i, size)``, so a reader at another
world size, or with no engine at all, rebuilds the writer's layout from
the manifest alone.  The leaf order is :mod:`._tree`'s walk, the one the
JAX package's checkpoints use, and :func:`flatten_state` names an
``ElasticState``'s leaves in the order its ``sync`` broadcasts them: one
walk for the snapshots, the checkpoints and the resync.
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


def flatten_state(state) -> Tuple[List[Tuple[str, Any]],
                                  Callable[[list], None]]:
    """An :class:`~horovod_tpu_torch.common.elastic.ElasticState` as the
    canonical named leaf list (``<key>`` for a leaf attribute,
    ``<key>.<i>`` for the leaves of a tree, the ``sync`` broadcasts'
    names), and ``assign(new_leaves)``, which writes values back into the
    state: tensor leaves in place (``copy_`` on their own device: a
    ``state_dict`` aliases the live module), scalars with their Python
    types (step counters stay ints), as ``sync`` does."""
    from horovod_tpu_torch.common.elastic import _assign, _named_leaves

    named, writers = _named_leaves(state)

    def assign(new_leaves: list) -> None:
        _assign(state, named, writers, list(new_leaves))

    return named, assign
