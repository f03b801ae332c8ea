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
import random
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


# Linux's ephemeral port range, where /proc does not give the host's.
_DEFAULT_LOCAL_PORTS = (32768, 60999)
# The lowest port handed out: below it lie well-known and registered
# services' ports.
_LOWEST_PORT = 10000


def local_port_range() -> tuple:
    """The host's ephemeral port range ``(low, high)``, both inclusive:
    ``/proc/sys/net/ipv4/ip_local_port_range``, else Linux's default."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low, high = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        return _DEFAULT_LOCAL_PORTS
    return low, high


def pick_free_port(host: str = "127.0.0.1") -> int:
    """One TCP port that is free now, as :func:`pick_free_ports` picks."""
    return pick_free_ports(1, host)[0]


def pick_free_ports(n: int, host: str = "127.0.0.1") -> list:
    """``n`` distinct TCP ports that are free now, drawn at random from
    outside the host's ephemeral range (:func:`local_port_range`).  The
    kernel takes the source port of every outgoing connection from that
    range, and port 0's binds too, so a port picked there can be taken by
    any ``connect()`` on the host between the pick and the bind of the
    rank it was handed to; outside it only an explicit bind takes one.
    Each port is checked by binding it, and all stay bound until the batch
    is picked, so one launch is never handed a port twice.  Where the
    range leaves fewer than 64 ports outside it, the kernel picks them
    (port 0) as before."""
    low, high = local_port_range()
    spans = [r for r in (range(_LOWEST_PORT, low), range(high + 1, 65536))
             if len(r)]
    total = sum(len(r) for r in spans)
    socks = []
    try:
        if total < 64:
            for _ in range(n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(s)
                s.bind((host, 0))
            return [s.getsockname()[1] for s in socks]
        # A generator of its own: a test or a rank that seeds `random`
        # must not hand two launches the same sequence.
        rng = random.SystemRandom()
        tried = set()
        while len(socks) < n:
            if len(tried) >= min(total, 64 * n + 256):
                raise OSError(f"no {n} free TCP ports on {host} outside "
                              f"the local port range {low}-{high}")
            i = rng.randrange(total)
            for r in spans:
                if i < len(r):
                    port = r[i]
                    break
                i -= len(r)
            if port in tried:
                continue
            tried.add(port)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind((host, port))
            except OSError:
                s.close()
                continue
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
