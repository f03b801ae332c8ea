"""Process-model bootstrap: rank/size/local_rank and the engine endpoints.

Own copy of the launcher-environment part of
``horovod_tpu/common/basics.py`` (the port imports nothing of that
package).  Identity resolves, in priority order, from:

  1. ``HVD_TPU_RANK`` / ``HVD_TPU_SIZE`` / ``HVD_TPU_LOCAL_RANK`` /
     ``HVD_TPU_LOCAL_SIZE``, with the engine's control-plane endpoint
     ``HVD_TPU_COORD`` (rank 0's coordinator, ``host:port``) and data-plane
     endpoints ``HVD_TPU_DATA`` (one ``host:port`` per rank, comma
     separated) — set by the launcher (``python -m
     horovod_tpu_torch.runner``).
  2. Single-process defaults (rank 0 of 1).

``resolve_process_set(ranks)`` then restricts the job to a subset of the
launcher's ranks (``hvd.init(comm=[...])``), and :func:`comm_ranks` turns
an mpi4py-style communicator into that rank list.  The TPU pod-slice
metadata sources and the ``jax.distributed`` source of the JAX package
have no counterpart on a GPU host and are not copied.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ProcessSet:
    """Resolved identity of this process within the job."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    # Control-plane (rank-0 coordinator) endpoint, "host:port".
    coord_endpoint: Optional[str] = None
    # Data-plane endpoints for every rank, ["host:port", ...] (len == size).
    data_endpoints: Optional[Sequence[str]] = None

    def validate(self) -> "ProcessSet":
        if not (0 <= self.rank < self.size):
            raise ValueError(
                f"rank {self.rank} out of range for size {self.size}")
        if not (0 <= self.local_rank < self.local_size):
            raise ValueError(
                f"local_rank {self.local_rank} out of range for "
                f"local_size {self.local_size}")
        if self.size > 1:
            if not self.coord_endpoint:
                raise ValueError(
                    "size > 1 requires a coordinator endpoint (set "
                    "HVD_TPU_COORD or launch via python -m "
                    "horovod_tpu_torch.runner)")
            if (not self.data_endpoints
                    or len(self.data_endpoints) != self.size):
                raise ValueError(
                    "size > 1 requires one data endpoint per rank (set "
                    "HVD_TPU_DATA or launch via python -m "
                    "horovod_tpu_torch.runner)")
        return self


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    val = os.environ.get(name)
    if val is None or val == "":
        return default
    try:
        return int(val)
    except ValueError as exc:
        raise ValueError(
            f"environment variable {name}={val!r} is not an int") from exc


def _from_launcher_env() -> Optional[ProcessSet]:
    rank = _env_int("HVD_TPU_RANK")
    size = _env_int("HVD_TPU_SIZE")
    if rank is None or size is None:
        return None
    local_rank = _env_int("HVD_TPU_LOCAL_RANK", rank)
    local_size = _env_int("HVD_TPU_LOCAL_SIZE", size)
    coord = os.environ.get("HVD_TPU_COORD")
    data = os.environ.get("HVD_TPU_DATA")
    endpoints = data.split(",") if data else None
    return ProcessSet(rank, size, local_rank, local_size, coord, endpoints)


def comm_ranks(comm, launcher_rank: int) -> list:
    """The launcher ranks of an mpi4py-style communicator's members, in
    the communicator's rank order: the rank list ``init(comm=...)``
    restricts the job to.  Duck-typed, without mpi4py: any object with
    ``Get_size`` and a pickle-based ``allgather`` works, each member
    contributing its own launcher rank.  Since
    :func:`resolve_process_set` numbers the subset by list position,
    ``hvd.rank() == comm.Get_rank()`` also for a reordered
    subcommunicator."""
    ranks = list(comm.allgather(launcher_rank))
    if len(ranks) != comm.Get_size():
        raise ValueError(
            f"communicator allgather returned {len(ranks)} ranks but "
            f"Get_size() says {comm.Get_size()}")
    return ranks


def _subset(ps: ProcessSet, ranks: Sequence[int]) -> ProcessSet:
    """``ps`` restricted to the launcher ranks ``ranks``: subset rank i is
    launcher rank ``ranks[i]`` (MPI ``Group.Incl`` order), the
    coordinator listens on the first member's data host at the configured
    coordinator port, and ``local_rank``/``local_size`` count the members
    on this process's host (by the data endpoints' hosts; without
    endpoints the subset is one host)."""
    ranks = list(ranks)
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"duplicate ranks in subset {ranks}")
    if ps.rank not in ranks:
        raise ValueError(
            f"process rank {ps.rank} not in requested subset {ranks}")
    new_rank = ranks.index(ps.rank)
    endpoints = coord = None
    if ps.data_endpoints:
        endpoints = [ps.data_endpoints[r] for r in ranks]
        port = _env_int("HVD_TPU_COORD_PORT")
        if port is None and ps.coord_endpoint:
            port = int(ps.coord_endpoint.rsplit(":", 1)[1])
        host = endpoints[0].rsplit(":", 1)[0]
        coord = f"{host}:{port}" if port else ps.coord_endpoint
        hosts = [e.rsplit(":", 1)[0] for e in endpoints]
        peers = [i for i, h in enumerate(hosts) if h == hosts[new_rank]]
        local_rank, local_size = peers.index(new_rank), len(peers)
    else:
        local_rank, local_size = new_rank, len(ranks)
    return ProcessSet(new_rank, len(ranks), local_rank, local_size, coord,
                      endpoints)


def resolve_process_set(ranks: Optional[Sequence[int]] = None
                        ) -> ProcessSet:
    """This process's identity: the launcher environment, else rank 0 of
    1; with ``ranks``, restricted to that subset of launcher ranks, which
    must hold this process's once (``init(comm=[...])``)."""
    ps = _from_launcher_env() or ProcessSet(0, 1, 0, 1)
    if ranks is not None:
        ps = _subset(ps, ranks)
    return ps.validate()


def pick_free_port(host: str = "127.0.0.1") -> int:
    """Ask the OS for a currently-free TCP port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def pick_free_ports(n: int, host: str = "127.0.0.1") -> list:
    """``n`` distinct currently-free TCP ports, every socket held open
    until all are picked, so one launch is never handed a port twice."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind((host, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
