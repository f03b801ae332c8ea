"""The state plane: async shard snapshots and restore from peer copies.

Own copy of ``horovod_tpu/state/plane.py`` for PyTorch state.  One object
per rank (``horovod_tpu_torch.state.arm()``), three duties:

* **snapshot** (:meth:`StatePlane.snapshot`): capture this rank's owned
  1/size of the flattened state (``partition.py``) as a private host
  copy and write it in the background (``snapshot.py``).  A CUDA leaf is
  copied into a pinned host buffer kept per leaf, ``non_blocking`` on a
  side stream that first waits on an event recorded on the caller's
  stream; the worker waits on the event recorded after the copies, never
  on the step's stream, and the caller's stream waits on it too before
  its next kernels, so no later step overwrites a parameter before it
  has been read.  A buffer is reused only after its snapshot has left
  the kept window (``ShardSnapshotter.on_release``): a snapshot in
  flight or kept is never overwritten.
* **mirror**: the worker pushes every committed snapshot to the ring
  neighbour ``rank+1 mod size`` (``peers.py``), so each shard lives on
  two ranks.
* **restore** (:meth:`StatePlane.restore`): after an elastic reshape the
  survivors agree on a fence step that every shard can serve (own
  snapshots or peer copies), then each shard's holder broadcasts it and
  every rank writes it into the live tensors in place: O(model/size) a
  rank instead of the O(model) root broadcast.  A rank lost together
  with its neighbour, a membership that never snapshotted, or a change
  of the state's shape fall back to the root broadcast
  (``run_elastic``).

The restore decision is collective: every rank allgathers its holdings
(``__state.plan.<epoch>``) and computes the same verdict from the same
table.  A restore rolls the state back to the fence step; the
re-enterable training function recomputes the (at most
``SNAPSHOT_KEEP``) steps since.
"""

from __future__ import annotations

import collections
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.common import metrics as _metrics
from horovod_tpu_torch.common.elastic import _as_tensor
from horovod_tpu_torch.state import partition
from horovod_tpu_torch.state.peers import PeerMirror
from horovod_tpu_torch.state.snapshot import SNAPSHOT_KEEP, ShardSnapshotter

_ENDPOINT_BYTES = 64


def _state_signature(named) -> int:
    """A stable 63-bit digest of the flattened state's shape (leaf names,
    shapes, dtypes), equal on every rank of one SPMD program (Python's
    ``hash()`` is salted per process).  A restore only trusts snapshots
    and peer copies cut under the current signature."""
    import hashlib

    h = hashlib.blake2s(digest_size=8)
    for name, leaf in named:
        t = _as_tensor(leaf, name)
        h.update(f"{name}|{tuple(t.shape)}|{t.dtype};".encode())
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class StatePlane:
    """One rank's side of the state plane.  Arm it on every rank at the
    same program point (the restore's collectives are symmetric); one
    plane per engine lifetime.  ``capture_sec`` holds the step path's
    seconds of each recent :meth:`snapshot`, ``restore_sec`` those of
    each restore, and ``last_restore`` the last one's fence step and
    source."""

    def __init__(self, state_dir: Optional[str] = None):
        from horovod_tpu_torch import common as _common

        if not _common.is_initialized():
            raise ValueError("arm the state plane after hvd.init()")
        self._rank = _common.rank()
        self._size = _common.size()
        self._state_dir = (state_dir
                           or os.environ.get("HVD_TPU_STATE_DIR") or "")
        if self._state_dir:
            os.makedirs(self._state_dir, exist_ok=True)
        self._mirror = PeerMirror()
        self._neighbor: Optional[str] = None  # set by the peer exchange
        # Free pinned host buffers per leaf index (the CUDA captures').
        self._pool: Dict[int, list] = collections.defaultdict(list)
        self._side: Dict[torch.device, torch.cuda.Stream] = {}
        self._snapshotter = ShardSnapshotter(writer=self._background_write,
                                             on_release=self._release)
        self._ever_snapshotted = False
        # step -> the state's signature at capture (recent steps only).
        self._sig_by_step: dict = {}
        self.capture_sec = collections.deque(maxlen=64)
        self.restore_sec: List[float] = []
        self.last_restore: Optional[dict] = None
        self._closed = False
        _metrics.registry.set_state_armed(True)

    # -- snapshot (step path) ---------------------------------------------

    def snapshot(self, state, step: Optional[int] = None) -> int:
        """Snapshot this rank's shard of ``state`` (an ``ElasticState``)
        at ``step`` (default ``state.step``), which it returns.  The call
        captures and hands over; it blocks only on the double buffer."""
        from horovod_tpu_torch import common as _common

        if step is None:
            step = getattr(state, "step", None)
            if step is None:
                raise ValueError(
                    "snapshot(state) needs a step: pass step= or give the "
                    "ElasticState a 'step' leaf")
        step = int(step)
        t0 = time.perf_counter()
        _common._trace_begin("state.snapshot", "STATE_SNAPSHOT")
        try:
            named, _ = partition.flatten_state(state)
            own, ready = self._capture(named)
            sig = _state_signature(named)
            self._sig_by_step[step] = sig
            for old in sorted(self._sig_by_step)[:-8]:
                del self._sig_by_step[old]
            self._snapshotter.submit(step, own, ready)
            self._ever_snapshotted = True
        finally:
            _common._trace_end("state.snapshot")
        self.capture_sec.append(time.perf_counter() - t0)
        return step

    def _capture(self, named) -> tuple:
        """This rank's owned leaves as private host tensors, and the event
        after which the CUDA ones hold their bytes (None without any)."""
        own, on_card = {}, collections.defaultdict(list)
        for i in partition.shard_indices(self._rank, self._size,
                                         len(named)):
            leaf = named[i][1]
            if torch.is_tensor(leaf) and leaf.is_cuda:
                on_card[leaf.device].append(i)
            elif torch.is_tensor(leaf):
                own[i] = leaf.detach().clone()
            else:
                own[i] = _as_tensor(leaf, named[i][0])
        ready = None
        for device, idx in on_card.items():
            caller = torch.cuda.current_stream(device)
            side = self._side.get(device)
            if side is None:
                side = self._side[device] = torch.cuda.Stream(device)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                for i in idx:
                    leaf = named[i][1].detach()
                    buf = self._take(i, leaf)
                    buf.copy_(leaf, non_blocking=True)
                    own[i] = buf
            ready = torch.cuda.Event()
            ready.record(side)
            # The step's next kernels may overwrite these leaves (the
            # optimizer's update): not before the copies have read them.
            caller.wait_event(ready)
        return own, ready

    def _take(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        free = self._pool[i]
        while free:
            buf = free.pop()
            if buf.shape == leaf.shape and buf.dtype == leaf.dtype:
                return buf
        return torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)

    def _release(self, leaves: dict) -> None:
        """A snapshot left the kept window: its pinned buffers may be
        reused by a later capture (bounded per leaf)."""
        for i, t in leaves.items():
            if t.is_pinned() and len(self._pool[i]) < SNAPSHOT_KEEP + 1:
                self._pool[i].append(t)

    def _background_write(self, step: int, leaves: dict,
                          nbytes: int) -> None:
        """The worker's half: the disk spill (``HVD_TPU_STATE_DIR``, in
        the JAX package's snapshot format) and the push to the
        neighbour, both overlapped with the steps."""
        if self._state_dir:
            from horovod_tpu_torch.state.checkpoint import (_to_host,
                                                            atomic_write)

            doc = {"format": "hvd-tpu-snap-v1", "step": step,
                   "rank": self._rank, "size": self._size,
                   "leaves": {i: _to_host(t) for i, t in leaves.items()}}
            path = os.path.join(self._state_dir,
                                f"snap-rank{self._rank}.pkl")
            atomic_write(path, lambda f: pickle.dump(
                doc, f, protocol=pickle.HIGHEST_PROTOCOL))
        if self._neighbor is not None and self._size > 1:
            PeerMirror.push(self._neighbor, self._rank, self._size, step,
                            leaves, sig=self._sig_by_step.get(step, 0))
        _metrics.registry.set_state_overlap(self._snapshotter.blocked_sec,
                                            self._snapshotter.async_sec)

    # -- peer wiring ------------------------------------------------------

    def exchange_peers(self, key: str = "arm") -> None:
        """Allgather every rank's mirror endpoint and take this rank's
        ring neighbour.  Collective; :meth:`restore` does it per epoch,
        so call it only in a job that snapshots and never enters
        ``run_elastic``."""
        from horovod_tpu_torch import common as _common

        if _common.size() == 1:
            self._neighbor = None
            return
        endpoints = self._allgather_endpoints(key)
        self._neighbor = endpoints[(_common.rank() + 1) % _common.size()]

    def _allgather_endpoints(self, key: str) -> List[str]:
        from horovod_tpu_torch import common as _common

        row = torch.zeros((1, _ENDPOINT_BYTES), dtype=torch.uint8)
        enc = self._mirror.endpoint.encode()
        if len(enc) > _ENDPOINT_BYTES:
            raise ValueError(f"state endpoint too long: "
                             f"{self._mirror.endpoint!r}")
        row[0, :len(enc)] = torch.frombuffer(bytearray(enc),
                                             dtype=torch.uint8)
        rows = _common.allgather(row, name=f"__state.peers.{key}")
        return [bytes(r.tolist()).rstrip(b"\0").decode() for r in rows]

    # -- restore (reshape path) -------------------------------------------

    def restore(self, state, epoch: int) -> bool:
        """Collective restore for membership ``epoch`` (after
        ``membership_ack``, on every rank).  True: ``state`` holds the
        fence step's snapshot, written into its tensors in place.  False:
        no fence step covers every shard; the caller root-broadcasts
        (``ElasticState.sync``)."""
        from horovod_tpu_torch import common as _common

        t0 = time.perf_counter()
        _common._trace_begin("state.restore", "STATE_RESTORE")
        try:
            ok, peer_used, fence = self._restore_inner(state, epoch)
        finally:
            _common._trace_end("state.restore")
        if ok:
            dt = time.perf_counter() - t0
            source = "peer" if peer_used else "local"
            _metrics.registry.record_state_restore(source)
            _metrics.registry.observe("state_restore_sec", dt)
            self.restore_sec.append(dt)
            self.last_restore = {"epoch": epoch, "fence_step": fence,
                                 "source": source}
        return ok

    def _restore_inner(self, state, epoch: int) -> tuple:
        from horovod_tpu_torch import common as _common

        self._snapshotter.wait(timeout=30.0)  # settle in-flight commits
        new_rank, new_size = _common.rank(), _common.size()
        named, assign = partition.flatten_state(state)
        n = len(named)
        live_sig = _state_signature(named)

        # Advertise only holdings cut under the current shape, and pin
        # them now: a late commit could evict an advertised step from
        # the kept window after the plan is agreed.
        own_steps = [s for s in self._snapshotter.committed_steps()
                     if self._sig_by_step.get(s) == live_sig]
        own_map = {s: self._snapshotter.get(s) for s in own_steps}
        own_steps = [s for s in own_steps if own_map[s] is not None]
        peer = self._mirror.latest()
        if peer is not None and peer.get("sig") != live_sig:
            peer = None
        row = torch.full((1, 10), -1, dtype=torch.int64)
        row[0, 0] = self._rank          # the rank in the OLD membership
        row[0, 1] = self._size if own_steps else -1
        if own_steps:
            row[0, 2] = own_steps[-1]
            row[0, 3] = own_steps[0] if len(own_steps) > 1 else -1
        if peer is not None:
            row[0, 4] = peer["src"]
            row[0, 5] = peer["size"]
            row[0, 6] = peer["step"]
        row[0, 7] = n
        row[0, 8] = int(self._ever_snapshotted)
        row[0, 9] = live_sig
        table = _common.allgather(row, name=f"__state.plan.{epoch}").numpy()
        endpoints = (self._allgather_endpoints(str(epoch))
                     if new_size > 1 else [])

        plan = _plan_restore(table, n)
        if plan is None:
            # No covering fence step: adopt the new membership and let
            # the caller root-broadcast.
            self._refresh(new_rank, new_size, endpoints)
            if bool(table[:, 8].any()):
                _metrics.registry.record_state_restore("root_broadcast")
            return False, False, None

        fence_step, old_size, holders = plan
        peer_used = any(src == "peer" for _, src in holders.values())
        handles = []
        for i in range(n):
            root, source = holders[i % old_size]
            if root == new_rank:
                # The copies the plan was built from (re-reading the
                # snapshotter or the mirror could tear the fence).
                leaves = (own_map[fence_step] if source == "own"
                          else peer["leaves"])
                src = leaves[i].contiguous()
            else:
                # Only the shape and dtype of the live leaf: reading its
                # bytes back from the card would undo O(model/size).
                name, leaf = named[i]
                like = _as_tensor(leaf, name)
                src = torch.empty(like.shape, dtype=like.dtype)
            handles.append(_common.broadcast_async(
                src, root, name=f"__state.restore.{epoch}.{i}"))
        assign([h.wait() for h in handles])
        self._refresh(new_rank, new_size, endpoints)
        return True, peer_used, fence_step

    def _refresh(self, rank: int, size: int,
                 endpoints: List[str]) -> None:
        """Adopt a new membership: the old partition's snapshots and peer
        copies mean nothing under the new leaf ownership."""
        self._rank, self._size = rank, size
        self._snapshotter.clear()
        self._sig_by_step.clear()
        self._mirror.clear()
        self._neighbor = (endpoints[(rank + 1) % size]
                          if size > 1 and endpoints else None)

    # -- reading / lifecycle ----------------------------------------------

    def wait(self, timeout: float = 30.0) -> bool:
        """Drain the background snapshot slot."""
        return self._snapshotter.wait(timeout)

    def status(self) -> dict:
        """A compact view for tests and the chip phase."""
        steps = self._snapshotter.committed_steps()
        peer = self._mirror.latest()
        return {
            "rank": self._rank, "size": self._size,
            "last_snapshot_step": steps[-1] if steps else -1,
            "committed_steps": steps,
            "peer_src": peer["src"] if peer else -1,
            "peer_step": peer["step"] if peer else -1,
            "overlap_ratio": self._snapshotter.overlap_ratio(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._snapshotter.close()
        self._mirror.close()
        self._pool.clear()
        _metrics.registry.set_state_armed(False)


def _plan_restore(table: np.ndarray, n_leaves: int):
    """The restore plan every rank computes from the allgathered table
    (rows by NEW rank): ``(fence_step, old_size, {shard: (new_root_rank,
    "own"|"peer")})``, or None when no one step covers every old shard.
    Own copy of the reference's."""
    old_sizes = {int(r[1]) for r in table if r[1] > 0}
    peer_sizes = {int(r[5]) for r in table if r[5] > 0}
    if len(old_sizes | peer_sizes) != 1:
        return None  # nobody has state, or mixed-generation holdings
    old_size = (old_sizes | peer_sizes).pop()
    if any(int(r[7]) != n_leaves for r in table):
        return None  # the state tree changed shape across the reshape
    if len({int(r[9]) for r in table}) != 1:
        return None  # per-leaf shape/dtype signatures diverged
    # avail[shard] = {step: [(priority, new_rank, source), ...]}
    avail: Dict[int, Dict[int, list]] = {}
    for new_rank, r in enumerate(table):
        if r[1] > 0 and r[0] >= 0:
            for step in (int(r[2]), int(r[3])):
                if step >= 0:
                    avail.setdefault(int(r[0]), {}).setdefault(
                        step, []).append((0, new_rank, "own"))
        if r[4] >= 0 and r[6] >= 0:
            avail.setdefault(int(r[4]), {}).setdefault(
                int(r[6]), []).append((1, new_rank, "peer"))
    candidate_steps = sorted(
        {s for per in avail.values() for s in per}, reverse=True)
    for step in candidate_steps:
        if all(step in avail.get(shard, {}) for shard in range(old_size)):
            holders = {}
            for shard in range(old_size):
                _, root, source = min(avail[shard][step])
                holders[shard] = (root, source)
            return step, old_size, holders
    return None
