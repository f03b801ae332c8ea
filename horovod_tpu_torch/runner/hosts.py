"""Multi-host job planning for the port's launcher (``-H host1:2,host2:2``).

Own copy of ``horovod_tpu/runner/hosts.py`` without its TPU pinning (the
port pins ``cuda:local_rank()`` in ``init()``) and without the XLA data
plane's coordinator (the port has no device data plane).

A host spec places ranks on hosts in contiguous blocks (host order, then
slot order), which defines ``local_rank``/``local_size`` and meets both
engine layouts that key off it: the two-level allreduce (every local
rank drives its own cross-node stream to its same-local-rank peers, rank
``node*L + r`` to ``(node±1)*L + r`` and, for the tree exchange, to
``(node^2^k)*L + r``: equal ``local_size`` on every host and contiguous
blocks, which the engine checks job-wide at init, keeping the flat ring
otherwise) and the coordinator tree (each host's local rank 0 is its
block's sub-coordinator; its node's control sockets share the per-rank
data port through a typed hello, so no extra port is planned).

Endpoints use fixed ports (a free port cannot be probed on a remote
host): the coordinator listens on the first host at ``port_base``, each
rank's data endpoint is ``host:port_base + 1 + local_rank``, and the
node-local ring, the cross-node rings and the tree partners all share a
rank's one data port.  Remote ranks start over ``ssh`` with the rank
environment inlined into the remote command; local ranks spawn directly.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import socket
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_PORT_BASE = 58930


@dataclasses.dataclass(frozen=True)
class RankPlacement:
    rank: int
    host: str
    local_rank: int
    local_size: int
    env: Dict[str, str]  # this rank's HVD_TPU_* identity and endpoints

    @property
    def is_local(self) -> bool:
        return is_local_host(self.host)


def is_local_host(host: str) -> bool:
    """Whether ``host`` names this machine (loopback, or its host name)."""
    if host in ("localhost", "127.0.0.1", "::1"):
        return True
    try:
        names = {socket.gethostname(), socket.getfqdn()}
    except OSError:  # pragma: no cover
        names = set()
    return host in names


def parse_hosts(spec: str) -> List[Tuple[str, int]]:
    """``"host1:2,host2:4"`` -> ``[("host1", 2), ("host2", 4)]``.  A bare
    host has 1 slot; a repeated host merges its slots (as ``mpirun -H``
    does) at its first place, so duplicates never give colliding local
    ranks or data ports.  Bracketed IPv6 (``[::1]:2``) is accepted."""
    order: List[str] = []
    slots_by_host: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("["):
            host, rest = part[1:].split("]", 1)
            n = int(rest[1:]) if rest.startswith(":") else 1
        elif part.count(":") == 1:
            host, slots = part.split(":")
            n = int(slots)
        else:  # a bare host, unbracketed IPv6 literals included
            host, n = part, 1
        if n < 1:
            raise ValueError(f"bad slot count in host spec: {part!r}")
        if host not in slots_by_host:
            order.append(host)
            slots_by_host[host] = 0
        slots_by_host[host] += n
    if not order:
        raise ValueError(f"empty host spec: {spec!r}")
    return [(h, slots_by_host[h]) for h in order]


def plan(np_: int, hosts_spec: str,
         port_base: int = DEFAULT_PORT_BASE) -> List[RankPlacement]:
    """``np_`` ranks over the host spec in contiguous blocks; a host's
    ``local_size`` is the ranks actually placed on it (the last host may
    be partly filled)."""
    hosts = parse_hosts(hosts_spec)
    capacity = sum(n for _, n in hosts)
    if np_ > capacity:
        raise ValueError(
            f"-np {np_} exceeds the {capacity} slots in the host spec")
    placements: List[Tuple[str, int]] = []  # (host, local_rank)
    for host, slots in hosts:
        for s in range(slots):
            if len(placements) < np_:
                placements.append((host, s))
    per_host: Dict[str, int] = {}
    for host, _ in placements:
        per_host[host] = per_host.get(host, 0) + 1
    coord = f"{placements[0][0]}:{port_base}"
    data = [f"{host}:{port_base + 1 + lr}" for host, lr in placements]
    out = []
    for rank, (host, lr) in enumerate(placements):
        env = {
            "HVD_TPU_RANK": str(rank),
            "HVD_TPU_SIZE": str(np_),
            "HVD_TPU_LOCAL_RANK": str(lr),
            "HVD_TPU_LOCAL_SIZE": str(per_host[host]),
            "HVD_TPU_COORD": coord,
            "HVD_TPU_DATA": ",".join(data),
        }
        out.append(RankPlacement(rank, host, lr, per_host[host], env))
    return out


def ssh_command(placement: RankPlacement, cmd: Sequence[str],
                ssh_args: Sequence[str] = (),
                extra_env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None) -> List[str]:
    """The ``ssh`` argv that runs ``cmd`` on the placement's host: the
    rank environment (over ``extra_env``) inlined into the remote
    command, which first ``cd``s into ``cwd`` (default: this working
    directory) where that path exists there, so relative script paths
    work as under ``mpirun``."""
    env = dict(extra_env or {})
    env.update(placement.env)
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
    cwd = cwd if cwd is not None else os.getcwd()
    remote = (f"cd {shlex.quote(cwd)} 2>/dev/null; env {exports} "
              + " ".join(shlex.quote(c) for c in cmd))
    return ["ssh", *ssh_args, placement.host, remote]
