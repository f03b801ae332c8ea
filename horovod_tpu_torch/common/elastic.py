"""Elastic training loop: shrink and continue without a relaunch or a
checkpoint load.

Own copy of ``horovod_tpu/common/elastic.py`` for PyTorch state.  With
elastic membership (the launcher's ``--min-np``/``--max-np``) the engine
reshapes the job in place when a rank dies: the survivors agree on a new
``size()`` and dense ranks at a tick boundary, the collectives in flight
fail with the retryable :class:`~horovod_tpu_torch.common.MembershipChangedError`,
and the state is resynced, from the armed state plane's snapshots
(``horovod_tpu_torch.state.arm``) or else by a broadcast from rank 0::

    model = ...; opt = DistributedOptimizer(torch.optim.AdamW(...))
    state = hvd.ElasticState(model=model.state_dict(),
                             opt=opt.state_dict(), step=0)

    def train(state):
        while state.step < TOTAL:
            step(batch)                  # forward, backward, opt.step()
            state.step += 1
        return model

    hvd.run_elastic(train, state)

``train_fn`` must be re-enterable from ``state``: after a reshape the
loop resyncs every leaf and calls it again, so any progress marker (the
step above) lives in the state.

Leaves are tensors (on the CPU or the card), Python scalars (``bool``,
``int``, ``float``), or nested dicts, lists and tuples of them, in the
state plane's walk (``state/_tree.py``: dicts by sorted key; ``None`` is
an empty node).  A ``state_dict`` aliases its module's parameters and
its optimizer's buffers, so a resync writes every tensor leaf in place
(``copy_``, on the leaf's own device): rebinding it, as the JAX package
does with its immutable arrays, would leave the live model on its old
weights.  Scalars come back with their Python types; an optimizer's
hyperparameters in ``param_groups`` are copies in a ``state_dict``, so
only the state object sees theirs.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

# Scalar leaves travel as 0-d tensors of these dtypes (exact).
_SCALAR_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float64}


def _scalar_kind(value):
    """The Python type a scalar leaf round-trips as, or None."""
    for kind in (bool, int, float):  # bool before int: bool is an int
        if isinstance(value, kind):
            return kind
    return None


def _as_tensor(value, name: str):
    """A leaf as a tensor to send: tensors as they are, scalars as 0-d
    CPU tensors (``bool``, ``int64``, ``float64``: exact)."""
    if torch.is_tensor(value):
        return value
    kind = _scalar_kind(value)
    if kind is None:
        raise TypeError(
            f"elastic state leaf '{name}' is a {type(value).__name__}: "
            "leaves are tensors, bools, ints or floats")
    return torch.tensor(value, dtype=_SCALAR_DTYPES[kind])


def _coerce_like(old: Any, new) -> Any:
    """A synced or restored leaf with the original leaf's kind: a tensor
    leaf is written in place (``copy_`` on its own device) and returned,
    a scalar comes back as its Python type.  Shared by the root-broadcast
    sync and the state plane's restore (``state/partition.py``), so the
    two cannot drift."""
    if torch.is_tensor(old):
        with torch.no_grad():
            old.copy_(new)
        return old
    kind = _scalar_kind(old)
    if kind is None:
        raise TypeError(f"cannot restore a leaf of type {type(old)}")
    value = new.item() if torch.is_tensor(new) else new
    return kind(value)


def _named_leaves(state):
    """``[(name, leaf)]`` of an :class:`ElasticState` in the canonical
    order, and ``writers`` to put new leaves back: ``(key, rebuild or
    None, (start, stop))`` per attribute.  Names match the sync
    broadcasts': ``<key>`` for a leaf attribute, ``<key>.<i>`` for the
    leaves of a tree."""
    from horovod_tpu_torch.state import _tree

    named, writers = [], []
    for key in state.keys():
        value = getattr(state, key)
        start = len(named)
        if isinstance(value, (dict, list, tuple)):
            flat, rebuild = _tree.flatten(value)
            named.extend((f"{key}.{i}", leaf) for i, leaf in enumerate(flat))
            writers.append((key, rebuild, (start, len(named))))
        else:
            named.append((key, value))
            writers.append((key, None, (start, start + 1)))
    return named, writers


def _assign(state, named, writers, new_leaves) -> None:
    """Write ``new_leaves`` (in ``named``'s order) into ``state``: tensor
    leaves in place, scalars with their types, trees rebuilt around the
    same tensor objects."""
    if len(new_leaves) != len(named):
        raise ValueError(
            f"state shape changed: {len(named)} leaves flattened, "
            f"{len(new_leaves)} supplied")
    done = [_coerce_like(old, new)
            for (_, old), new in zip(named, new_leaves)]
    for key, rebuild, (start, stop) in writers:
        setattr(state, key, rebuild(done[start:stop]) if rebuild is not None
                else done[start])


class ElasticState:
    """Named training state kept equal across membership changes.

    Keyword arguments become attributes: tensors, Python scalars, or
    trees of them (``model.state_dict()``, ``optimizer.state_dict()``).
    :meth:`sync` gives every leaf the root rank's value, in place, by one
    broadcast per leaf named after the membership epoch, so a resync in
    the new membership is never mistaken for a negotiation from before
    the reshape.
    """

    def __init__(self, **leaves: Any):
        if not leaves:
            raise ValueError("ElasticState needs at least one named leaf")
        self._keys = sorted(leaves)
        for key, value in leaves.items():
            setattr(self, key, value)

    def keys(self):
        return list(self._keys)

    def sync(self, root: int = 0, key: int = 0) -> None:
        """Give every leaf the root's value (one broadcast per leaf, all
        in flight together, submitted in the canonical order)."""
        from horovod_tpu_torch.torch import mpi_ops

        named, writers = _named_leaves(self)
        handles, sends = [], []
        for name, leaf in named:
            wire = f"__elastic.sync.{key}.{name}"  # the reference's names
            send = _as_tensor(leaf, name)
            if not send.is_contiguous():
                send = send.contiguous()
            sends.append(send)
            handles.append(mpi_ops.broadcast_async_(send.detach(), root,
                                                    name=wire))
        try:
            for h in handles:
                h.synchronize()
        finally:
            mpi_ops.release_buffers(f"__elastic.sync.{key}.")
        _assign(self, named, writers, sends)


def run_elastic(train_fn: Callable[[ElasticState], Any],
                state: ElasticState,
                reshape_timeout: Optional[float] = None,
                state_plane=None) -> Any:
    """Run ``train_fn(state)`` under elastic membership; its result.

    On entry, and after every reshape, the loop acknowledges the
    membership (before the resync's collectives, which are the new
    membership's first) and resyncs ``state``: through the armed state
    plane (``horovod_tpu_torch.state.arm()``, or ``state_plane=``) when
    one is armed and its snapshots cover every shard, else by
    ``state.sync(root=0, key=epoch)``, which on entry is the usual
    broadcast of the initial state.  A retryable engine error
    (:class:`MembershipChangedError`, or the transport error a rank's
    death gives the ring just before the reshape lands) waits for the
    membership epoch to advance and calls ``train_fn`` again.

    Fatal errors re-raise unchanged: ``RanksDownError`` (the coordinator
    died, or the survivors fell below ``--min-np``: the launcher's
    ``--max-restarts`` fallback), ``CollectiveTimeoutError``
    (rank-divergent code, which shrinking cannot fix),
    ``HorovodNotInitializedError``, and any exception of ``train_fn``
    that is not the engine's.  ``reshape_timeout`` bounds the wait for a
    reshape after a retryable failure (default: twice
    ``HVD_TPU_COLLECTIVE_TIMEOUT_SEC`` plus 10 s, at least 30 s); without
    one in time the original error re-raises.
    """
    from horovod_tpu_torch import common as _common
    from horovod_tpu_torch.common import (CollectiveTimeoutError,
                                          HorovodInternalError,
                                          HorovodNotInitializedError,
                                          RanksDownError)
    from horovod_tpu_torch.common.config import Config

    lib = _common._checked_lib()
    if reshape_timeout is None:
        deadline_sec = Config.from_env().collective_timeout_sec
        reshape_timeout = max(2.0 * deadline_sec + 10.0, 30.0)
    synced = -1
    while True:
        try:
            epoch = int(lib.hvd_tpu_membership_epoch())
            if epoch != synced:
                lib.hvd_tpu_membership_ack()
                plane = state_plane
                if plane is None:
                    from horovod_tpu_torch import state as _state

                    plane = _state.current()
                # The plane's restore is collective (an allgather of the
                # holdings, then one broadcast per shard): arming is an
                # every-rank act, so this choice is the same everywhere.
                if plane is None or not plane.restore(state, epoch):
                    state.sync(root=0, key=epoch)
                synced = epoch
            return train_fn(state)
        except (RanksDownError, CollectiveTimeoutError,
                HorovodNotInitializedError):
            raise
        except HorovodInternalError:
            # Retryable if a reshape explains the failure: the epoch may
            # have advanced already, else wait for the barrier.
            deadline = time.monotonic() + reshape_timeout
            while int(lib.hvd_tpu_membership_epoch()) == synced:
                if (time.monotonic() >= deadline
                        or not lib.hvd_tpu_initialized()):
                    raise
                time.sleep(0.02)
