"""The ring of sequence-parallel members.

Counterpart of ``Mesh(devices, ("sp",))`` (``horovod_tpu/parallel/mesh.py``)
together with the ``shard_map`` body that runs on each of its devices.  The
JAX package is single-controller: one process maps a body over the mesh and
each device runs it on its own shard.  The port keeps that model: one
process holds a :class:`RingMesh` of ``size`` members, each a
``torch.device``, and the ring ops take per-member lists of shards.

On the card every member is the same ``cuda`` device, with its own CUDA
stream; a member's kernels launch on its stream, one launch per member per
ring step, as each TPU device runs its own program.  A ring op forks the
member streams off the caller's stream (:meth:`fork`) and joins them back
(:meth:`join`), holding every tensor it touches until the join, so the
caching allocator, which knows only the caller's stream, never hands out
memory a member stream still reads.  All members share one card here: the
members' memory does not fall as O(seq/n), and a rotation is a copy within
the card, not an NVLink transfer.

The mesh also owns what the ring kernels signal on (see
``ops/csrc/ring_common.cuh``):

* ``flags`` — int32 ready counters, one per member and namespace.  The
  rdma chains use namespaces 0/1 (K) and 2/3 (V), ``phase % 4``; the fused
  ring uses 4/5, ``4 + phase % 2``.  A balanced pass leaves every word 0.
* ``go`` and ``epochs`` — the copy gate's go words and the per-launch
  values they take.
* ``err`` — the error word a timed-out spin writes; :meth:`check` raises
  on it, and every ring op checks it at its :meth:`join`, so no op
  returns outputs of a kernel that gave up.  A mesh whose word is set is
  spent: build a new one.
* the fused ring's receive slots, ``(size, 2, *shard)`` for K and for V,
  double-buffered by phase.

On the CPU (the tests) the members are ``cpu`` devices, there are no
streams and the kernels' plain versions run: they skip the wait, as the
reference's interpret mode does, but keep the flag bookkeeping.

Launch discipline.  A ring kernel's copy blocks wait for the neighbour's
kernel of the same step to start, so the members' kernels must be on the
card together, and the host must make no call that may wait for the card
(a first kernel load, a ``cudaMalloc``) while a launched kernel waits for
a launch still to come.  The ring ops therefore allocate every member's
outputs of a step first, then launch the members' kernels back to back,
and only then issue the plain PyTorch work of the step; the mesh loads
every ring kernel when it is built.  The member streams must not share a
hardware queue either: keep ``size`` + 1 within
``CUDA_DEVICE_MAX_CONNECTIONS`` (default 8).  Where any of this fails,
the spin times out and the op raises at its join; nothing hangs.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import torch

N_NS = 6          # flag namespaces per member (see the module docstring)
NS_RDMA = 0       # rdma chains: K on 0/1, V on 2/3
NS_FUSED = 4      # the fused ring: 4/5
MAX_MEMBERS = 8   # ring_common.cuh
_ERRORS = {1: "a ready handshake", 2: "a copy gate"}


class RingMesh:
    """``size`` members of one sequence-parallel ring.

    ``device=None`` means the CUDA device, which must exist; pass
    ``device="cpu"`` for the plain versions on the CPU."""

    def __init__(self, size: int, device=None):
        from horovod_tpu_torch.common import resolve_device

        if not 1 <= size <= MAX_MEMBERS:
            raise ValueError(f"ring size {size} outside 1..{MAX_MEMBERS}")
        self.size = size
        self.device = resolve_device(device)
        self.members: List[torch.device] = [self.device] * size
        self.on_cuda = self.device.type == "cuda"
        self.streams = ([torch.cuda.Stream(self.device) for _ in range(size)]
                        if self.on_cuda else [None] * size)
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa
                                       device=self.device)
        self.flags = z(size, N_NS)
        self.go = z(size, N_NS)
        self.err = z(1)
        self.epochs = [[0] * N_NS for _ in range(size)]
        self._slots: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        if self.on_cuda:
            self._prepare_kernels()

    def _prepare_kernels(self) -> None:
        """Load every ring kernel now: a kernel loaded at its first launch
        may wait for the card to go idle, which a ring kernel waiting for
        its neighbour's launch must never meet."""
        from horovod_tpu_torch.ops import _build

        with torch.cuda.device(self.device):
            for stem in ("ring_flash", "ring_permute"):
                fn = getattr(_build.load(stem), f"hvdt_{stem}_prepare")
                fn.argtypes, fn.restype = [], ctypes.c_int
                rc = fn()
                if rc:
                    raise RuntimeError(f"{stem}: preparing the kernels "
                                       f"failed (cudaError {rc})")

    def next_epoch(self, member: int, ns: int) -> int:
        """The go-word value of ``member``'s next copy launch on ``ns``."""
        self.epochs[member][ns] += 1
        return self.epochs[member][ns]

    def slots(self, shape, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused ring's K and V receive slots for shards of ``shape``:
        ``(size, 2, *shape)`` each, kept for the mesh's life."""
        key = (tuple(shape), dtype)
        if key not in self._slots:
            full = (self.size, 2) + tuple(shape)
            self._slots[key] = (
                torch.empty(full, dtype=dtype, device=self.device),
                torch.empty(full, dtype=dtype, device=self.device))
        return self._slots[key]

    def on(self, member: int):
        """Context in which ``member``'s work is issued (its stream)."""
        if not self.on_cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[member])

    def fork(self) -> Optional[torch.cuda.Stream]:
        """Let every member stream start after the caller's work so far;
        returns the caller's stream (None on the CPU)."""
        if not self.on_cuda:
            return None
        caller = torch.cuda.current_stream(self.device)
        for s in self.streams:
            s.wait_stream(caller)
        return caller

    def join(self, caller, outputs=()) -> None:
        """Make the caller's stream wait for every member stream; the
        tensors in ``outputs``, made on member streams, become the
        caller's.  Then :meth:`check`: a ring op raises here rather than
        hand back what a kernel that gave up left behind (one
        synchronization per op on the card)."""
        if caller is not None:
            for s in self.streams:
                caller.wait_stream(s)
            for t in outputs:
                t.record_stream(caller)
        self.check()

    def record(self, member: int):
        """An event marking ``member``'s work so far (None on the CPU)."""
        return self.streams[member].record_event() if self.on_cuda else None

    def wait(self, member: int, event) -> None:
        """``member``'s later work waits for ``event`` (another member's
        step): the data order that a rotated shard needs."""
        if event is not None:
            self.streams[member].wait_event(event)

    def plain_handshake(self, member: int, shift: int, ns: int) -> None:
        """The plain versions' flag bookkeeping of one handshake: signal
        the source, consume the own signal, without waiting."""
        src = (member - shift) % self.size
        self.flags[src, ns] += 1
        self.flags[member, ns] -= 1

    def check(self) -> None:
        """Raise if a ring kernel's bounded spin gave up (synchronizes)."""
        code = int(self.err.item())
        if code:
            raise RuntimeError(
                f"ring mesh: {_ERRORS.get(code, f'error {code}')} timed out "
                "on the card; the ring's members did not all reach their "
                "kernels (this mesh is spent: build a new one)")

    def flags_balanced(self) -> bool:
        """Whether every ready counter is back at 0 (every signal waited)."""
        return bool((self.flags == 0).all())

    def __repr__(self):
        return f"RingMesh(size={self.size}, device={self.device})"
