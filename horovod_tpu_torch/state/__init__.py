"""State plane of the port: the partition contract, the sharded durable
checkpoints, async shard snapshots and peer-replicated restore.

Own copy of ``horovod_tpu/state``, in four pieces over one partition
contract (``partition.py``: leaf ``i`` of the flattened state belongs to
rank ``i % size``):

* async shard **snapshots** (``snapshot.py``): the step path copies this
  rank's owned leaves into pinned host buffers on a side stream; the
  serialization, the disk spill and the push to a peer run on a
  background thread;
* **sharded durable checkpoints** (``checkpoint.py``:
  ``ckpt-<step>/rank-N.pkl`` and an atomically committed manifest, in
  the JAX package's format), surfaced through
  ``horovod_tpu_torch.torch.train.save_checkpoint(..., sharded=True)``;
* **peer copies** (``peers.py``): every committed snapshot goes to the
  ring neighbour ``rank+1 mod size`` over TCP;
* the **plane** (``plane.py``): after an elastic reshape the survivors
  restore the lost shards from the peer copies into the live tensors, in
  O(model/size) per rank, and ``run_elastic`` falls back to the root
  broadcast only where no snapshot covers every shard.

Usage::

    hvd.init()
    plane = hvd.state.arm()            # every rank, same program point
    state = hvd.ElasticState(model=model.state_dict(),
                             opt=opt.state_dict(), step=0)

    def train(state):
        while state.step < TOTAL:
            step(batch)
            state.step += 1
            plane.snapshot(state)      # async; the copy is the step's cost
        return model

    hvd.run_elastic(train, state)      # reshapes restore through the plane
"""

from __future__ import annotations

import threading
from typing import Optional

from horovod_tpu_torch.state import checkpoint  # noqa: F401
from horovod_tpu_torch.state.partition import (  # noqa: F401
    flatten_state,
    flatten_tree,
    owner,
    shard_indices,
)
from horovod_tpu_torch.state.plane import StatePlane  # noqa: F401

_armed_lock = threading.Lock()
_armed: Optional[StatePlane] = None


def arm(state_dir: Optional[str] = None) -> StatePlane:
    """Arm the process's state plane (re-arming returns the live one).
    Call on every rank at the same program point, after ``hvd.init()``;
    ``run_elastic`` picks the armed plane up.  ``state_dir`` (default
    ``HVD_TPU_STATE_DIR``, the launcher's ``--state-dir``) adds the spill
    of each snapshot to disk."""
    global _armed
    with _armed_lock:
        if _armed is None:
            _armed = StatePlane(state_dir=state_dir)
        elif state_dir and _armed._state_dir != state_dir:
            import warnings

            # The live worker holds the old directory; a silently
            # ignored request would leave an empty directory behind.
            warnings.warn(
                f"state plane already armed with state_dir="
                f"{_armed._state_dir!r}; ignoring new state_dir="
                f"{state_dir!r} (disarm first to change it)")
        return _armed


def current() -> Optional[StatePlane]:
    """The armed plane, or None (``run_elastic`` routes through it)."""
    with _armed_lock:
        return _armed


def disarm() -> None:
    """Close and forget the armed plane (``shutdown()`` calls it)."""
    global _armed
    with _armed_lock:
        plane, _armed = _armed, None
    if plane is not None:
        plane.close()
