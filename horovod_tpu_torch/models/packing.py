"""TreePacker: carry a tree's many tiny leaves as one flat vector.

Own copy of ``horovod_tpu/models/packing.py`` over the port's trees, nested
dicts (lists, tuples) of tensors walked as ``state/_tree.py`` walks them:
dicts by sorted key, as ``jax.tree_util`` flattens a flax tree.  A ResNet
holds two tiny 1-D float32 tensors per BatchNorm as parameters (scale,
bias) and two as running statistics; packed, each of those sets is one
vector, so the optimizer, its hooks and the allreduce of the statistics
each see one tensor where they saw a hundred.

The layout is the reference's: a leaf is small when it has at most one
dimension and is already in the packed dtype (float32), so packing is
value-exact; int and float64 leaves stay big.  :meth:`TreePacker.pack`
concatenates the small leaves in leaf order (``torch.cat``);
:meth:`TreePacker.unpack` splits the vector back (``torch.split``, then
``view``), so the pieces are views of it and the gradients of the pieces
flow back into one gradient of the vector.

:class:`PackedModule` holds a module's small parameters as one
``nn.Parameter`` (``small``) and its small buffers as one buffer
(``stats``), and runs the module through ``torch.func.functional_call``
on their unpacked views.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from horovod_tpu_torch.state import _tree


def _default_small(leaf) -> bool:
    """1-D (or 0-D) float32 tensors: BN scale, bias, mean and var, dense
    biases.  Kernels stay unpacked."""
    return leaf.dim() <= 1 and leaf.dtype == torch.float32


class TreePacker:
    """Reversible tree <-> ``{"big": tuple, "small": vector}``.

    The layout (which leaves are small, their shapes and the vector's
    split points) comes from an example tree, once.  Only leaves whose
    dtype already is ``dtype`` are packed, whatever ``small`` says: a
    cast through the packed dtype would round int and float64 leaves.
    """

    def __init__(self, example_tree, small: Callable = _default_small,
                 dtype=torch.float32):
        leaves, self._rebuild = _tree.flatten(example_tree)
        self._is_small = [bool(small(l)) and l.dtype == dtype
                          for l in leaves]
        self._shapes = [tuple(l.shape) for l in leaves]
        self._small_shapes = [s for s, f in zip(self._shapes, self._is_small)
                              if f]
        sizes = [l.numel() if f else 0
                 for l, f in zip(leaves, self._is_small)]
        self._sizes = [n for n, f in zip(sizes, self._is_small) if f]
        bounds, total = [], 0
        for n in self._sizes[:-1]:
            total += n
            bounds.append(total)
        self._bounds = bounds
        self.packed_size = sum(sizes)
        if not any(self._is_small):
            raise ValueError("no leaves matched the small() predicate; "
                             "packing would be an identity with overhead")

    def _leaves(self, tree) -> list:
        leaves, _ = _tree.flatten(tree)
        if len(leaves) != len(self._is_small):
            raise ValueError(f"tree has {len(leaves)} leaves, the layout "
                             f"{len(self._is_small)}")
        return leaves

    def pack(self, tree) -> dict:
        """tree -> ``{"big": tuple(big leaves), "small": 1-D vector}``."""
        leaves = self._leaves(tree)
        small = [l.reshape(-1) for l, f in zip(leaves, self._is_small) if f]
        big = tuple(l for l, f in zip(leaves, self._is_small) if not f)
        return {"big": big, "small": torch.cat(small)}

    def split_small(self, vector) -> list:
        """The small leaves in leaf order, as views of ``vector``
        (``torch.split``, then ``view`` where a leaf is not 1-D)."""
        return [p if p.shape == s else p.view(s)
                for p, s in zip(torch.split(vector, self._sizes),
                                self._small_shapes)]

    def unpack(self, packed):
        """Inverse of :meth:`pack`: the small leaves are views of
        ``packed["small"]``."""
        pieces = iter(self.split_small(packed["small"]))
        big = iter(packed["big"])
        return self._rebuild([next(pieces) if f else next(big)
                              for f in self._is_small])


def _owner(module: nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


class PackedModule(nn.Module):
    """``module`` with its small parameters held as one ``nn.Parameter``,
    ``small``, and its small buffers as one buffer, ``stats`` (a
    :class:`TreePacker` layout each, over the dicts of parameters and
    buffers by name).  The small leaves are removed from ``module``; the
    forward runs ``torch.func.functional_call(module, views, ...)`` with
    the unpacked views of ``small`` and ``stats`` in their places, so a
    module that writes a buffer in place (flax-style BN running stats)
    writes into ``stats``, and the gradient of every small parameter
    lands in one ``small.grad``.  :meth:`unpacked_state_dict` speaks
    ``module``'s own names."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        params = {k: v.detach() for k, v in module.named_parameters()}
        self.param_packer = TreePacker(params)
        self._small_params = self._names(params, self.param_packer)
        small = self.param_packer.pack(params)["small"]
        buffers = dict(module.named_buffers())
        self.buffer_packer = None
        self._small_buffers: List[str] = []
        stats = None
        if buffers:
            try:
                self.buffer_packer = TreePacker(buffers)
            except ValueError:
                pass
        if self.buffer_packer is not None:
            self._small_buffers = self._names(buffers, self.buffer_packer)
            stats = self.buffer_packer.pack(buffers)["small"]
        for name in self._small_params + self._small_buffers:
            owner, leaf = _owner(module, name)
            owner._parameters.pop(leaf, None)
            owner._buffers.pop(leaf, None)
        self.small = nn.Parameter(small.clone())
        if stats is not None:
            self.register_buffer("stats", stats.clone())
        else:
            self.stats = None

    @staticmethod
    def _names(tree: Dict[str, torch.Tensor], packer: TreePacker) -> list:
        """The small leaves' names: a flat dict's leaves come in sorted
        key order."""
        return [n for n, f in zip(sorted(tree), packer._is_small) if f]

    def views(self) -> Dict[str, torch.Tensor]:
        """Every small parameter and buffer by name, as a view of
        ``small`` or ``stats``."""
        out = dict(zip(self._small_params,
                       self.param_packer.split_small(self.small)))
        if self.stats is not None:
            out.update(zip(self._small_buffers,
                           self.buffer_packer.split_small(self.stats)))
        return out

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.views(), args,
                                          kwargs)

    def pack_buffers(self, tensors: Dict[str, torch.Tensor]):
        """``tensors``, one per small buffer name, as one vector in the
        layout of ``stats``."""
        return torch.cat([tensors[n].reshape(-1)
                          for n in self._small_buffers])

    def unpacked_state_dict(self) -> Dict[str, torch.Tensor]:
        """``module.state_dict()`` as it was before packing: the small
        leaves copied out of ``small`` and ``stats``."""
        sd = {k: v.detach().clone()
              for k, v in self.module.state_dict().items()}
        sd.update({k: v.detach().clone() for k, v in self.views().items()})
        return sd
