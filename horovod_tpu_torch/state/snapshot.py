"""Async shard snapshots: a double-buffered capture to host memory, with
the serialization and the writes overlapped with the steps that follow.

Own copy of ``horovod_tpu/state/snapshot.py``.  The CheckFreq shape
(PAPERS.md): the step path pays only the **capture** of this rank's owned
leaves, O(model/size) (``plane.py`` copies CUDA leaves into pinned host
buffers on a side stream and hands over the event recorded after the
copies), plus at most a bounded wait for the previous snapshot to clear
the single background slot (the double buffer: one snapshot being
written while the next is captured).  The worker thread waits on the
capture's event, never on the step's stream, then runs the writer (the
disk spill and the push to the ring neighbour).

The epoch fence: a snapshot is **committed**, visible to
:meth:`committed_steps` and :meth:`get` and so to a restore, only after
the worker has finished every byte of it; the capture is a private copy,
so a torn snapshot never commits and later steps cannot reach it.  The
last two committed snapshots are kept: the neighbour's copy of step
``s`` may still be on its way when ``s+1`` commits here, and a restore
needs one step that every shard can serve.  A snapshot's leaves go back
to their owner (``on_release``) when it leaves that window or is
abandoned, so buffers are reused only once nothing can read them.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.common import metrics as _metrics

# Committed snapshots kept per rank (see the module docstring).
SNAPSHOT_KEEP = 2


def _nbytes(leaf) -> int:
    return int(leaf.numel() * leaf.element_size())


class ShardSnapshotter:
    """Background writer of one rank's shard snapshots.

    ``submit(step, leaves, ready)`` takes already captured host tensors
    (``ready``, when given, is the event after which they hold their
    bytes) and blocks only while the single background slot is busy.
    ``writer(step, leaves, nbytes)`` runs on the worker before the
    commit; ``on_release(leaves)`` when a snapshot's leaves can be
    reused.  ``blocked_sec`` is the step path's wait on the slot,
    ``async_sec`` the worker's time, ``write_sec`` the worker's seconds
    of each recent snapshot (the wait on its copies included).
    """

    def __init__(self, writer: Optional[Callable[[int, dict, int], None]]
                 = None, on_release: Optional[Callable[[dict], None]]
                 = None):
        self._writer = writer
        self._on_release = on_release
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._committed: List[dict] = []  # [{"step", "leaves", "nbytes"}]
        self._lock = threading.Lock()
        # Submitted and not yet committed or abandoned: the exact idle
        # predicate for wait().
        self._outstanding = 0
        # Bumped by clear(): a snapshot submitted under an older
        # generation never commits (its partition died with the
        # membership).
        self._generation = 0
        self._closed = False
        self.blocked_sec = 0.0
        self.async_sec = 0.0
        self.write_sec = collections.deque(maxlen=64)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-torch-state-snapshot")
        self._thread.start()

    # -- step path --------------------------------------------------------

    def submit(self, step: int, leaves: Dict[int, object],
               ready=None) -> None:
        """Hand one captured shard to the worker; blocks only while the
        previous snapshot still occupies the slot."""
        if self._closed:
            raise RuntimeError("snapshotter is closed")
        t0 = time.perf_counter()
        with self._lock:
            self._outstanding += 1
            gen = self._generation
        self._queue.put({"step": int(step), "leaves": leaves,
                         "ready": ready, "gen": gen})
        self.blocked_sec += time.perf_counter() - t0

    def wait(self, timeout: float = 30.0) -> bool:
        """Drain the background slot: True when every submitted snapshot
        committed (or was abandoned) within ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._outstanding == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    # -- worker -----------------------------------------------------------

    def _release(self, leaves) -> None:
        if self._on_release is not None:
            self._on_release(leaves)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            t0 = time.perf_counter()
            try:
                if item["ready"] is not None:
                    item["ready"].synchronize()  # the copies have landed
                nbytes = sum(_nbytes(x) for x in item["leaves"].values())
                entry = {"step": item["step"], "leaves": item["leaves"],
                         "nbytes": nbytes}
                if self._writer is not None:
                    try:
                        self._writer(entry["step"], entry["leaves"], nbytes)
                    except Exception as exc:  # never kill the worker
                        import warnings

                        warnings.warn(
                            f"state snapshot writer failed at step "
                            f"{entry['step']}: {exc}")
                # Commit last: visible only once written (the fence).  A
                # failed writer still commits (the local copy is whole);
                # a snapshot of an older generation is abandoned.
                evicted = []
                with self._lock:
                    if item["gen"] == self._generation:
                        kept = ([e for e in self._committed
                                 if e["step"] != entry["step"]] + [entry])
                        evicted = [e for e in self._committed
                                   if e not in kept[-SNAPSHOT_KEEP:]]
                        self._committed = kept[-SNAPSHOT_KEEP:]
                        committed = True
                    else:
                        committed = False
                for e in evicted:
                    self._release(e["leaves"])
                if not committed:
                    self._release(entry["leaves"])
                dt = time.perf_counter() - t0
                self.async_sec += dt
                if committed:
                    self.write_sec.append(dt)
                    _metrics.registry.record_state_snapshot(
                        entry["step"], nbytes)
                    _metrics.registry.observe("state_snapshot_sec", dt)
            finally:
                with self._lock:
                    self._outstanding -= 1
                self._queue.task_done()

    # -- reading ----------------------------------------------------------

    def committed_steps(self) -> List[int]:
        """Steps of the committed snapshots, oldest first."""
        with self._lock:
            return [e["step"] for e in self._committed]

    def get(self, step: int) -> Optional[Dict[int, object]]:
        with self._lock:
            for entry in self._committed:
                if entry["step"] == step:
                    return entry["leaves"]
        return None

    def clear(self) -> None:
        """Drop every committed snapshot and abandon those in flight: a
        reshape invalidates the partition they were cut under."""
        with self._lock:
            dropped, self._committed = self._committed, []
            self._generation += 1
        for e in dropped:
            self._release(e["leaves"])

    def overlap_ratio(self) -> float:
        total = self.async_sec + self.blocked_sec
        return self.async_sec / total if total > 0 else 1.0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5.0)
