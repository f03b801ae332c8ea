"""The state plane's tree walk: leaves in one deterministic order.

Own copy of the pure-python walk of ``horovod_tpu/common/elastic.py``
(``_tree_flatten``): dicts by sorted key (an ``OrderedDict``, such as a
``state_dict``, comes back a plain dict), lists, tuples and namedtuples;
anything else is a leaf.  ``None`` is an empty node, as in
``jax.tree_util``, which the JAX package walks with: it holds no leaf and
rebuilds as ``None``, so both packages count the same leaves in a tree
with ``None`` in it (an optimizer ``state_dict``'s ``foreach``, say) and
each reads the other's checkpoint skeletons.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree: Any, names: Optional[List[str]] = None
            ) -> Tuple[list, Callable[[list], Any]]:
    """``(leaves, rebuild)``: ``rebuild(values)`` puts ``values`` in the
    leaves' places, in the same order.  With ``names`` (a list), each
    leaf's name is appended to it as ``jax.tree_util.keystr`` spells its
    key path: ``['model']`` for a dict key (its ``repr``), ``[0]`` for a
    list or tuple index, ``.field`` for a namedtuple field; ``""`` for a
    tree that is one leaf."""
    leaves: list = []

    def walk(node, path):
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [walk(node[k], f"{path}[{k!r}]") for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(node, (list, tuple)):
            if _is_namedtuple(node):
                subs = [walk(v, f"{path}.{f}")
                        for f, v in zip(node._fields, node)]
                return lambda it: type(node)(*(s(it) for s in subs))
            subs = [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
            if isinstance(node, tuple):
                return lambda it: tuple(s(it) for s in subs)
            return lambda it: [s(it) for s in subs]
        idx = len(leaves)
        leaves.append(node)
        if names is not None:
            names.append(path)
        return lambda it: it[idx]

    rebuild = walk(tree, "")
    return leaves, rebuild
