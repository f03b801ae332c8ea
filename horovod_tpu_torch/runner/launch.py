"""The port's launcher: ``np`` fresh rank processes, on this host or over
``-H``'s hosts.

Own copy of ``horovod_tpu/runner/launch.py`` without TPU pinning.  On one
host it
allocates the engine's endpoints (rank 0's coordinator and one data port
per rank) as one held batch, exports the ``HVD_TPU_*`` environment that
``horovod_tpu_torch.common.basics`` reads, starts every rank as a new
process (``subprocess``: never a fork of a process whose CUDA is up), and
tears the job down when a rank fails: the others get a grace period to
exit on the engine's coordinated abort, then are killed with their
process groups; ranks still running long after one exited 0 are killed
too (the straggler bound).  Under ``HVD_TPU_SANITIZE`` every rank's
``LD_PRELOAD`` starts with the sanitizer's runtime
(:func:`make_rank_env`); the launcher's own process is not preloaded.

Elastic membership (:func:`run_membership`, ``--min-np``/``--max-np``):
a dying rank does not bring the job down; the engine reshapes it around
the survivors while at least ``min_np`` run, and below ``max_np`` the
launcher spawns standbys (``HVD_TPU_REJOIN=1``) that the coordinator
admits at the next reshape barrier.  Elastic jobs are single-host, as in
the reference.  Every elastic process gets a device slot
(``HVD_TPU_DEVICE_SLOT``), which ``init()`` pins as ``cuda:<slot>``
unless the script names a device: a first-launch rank's slot is its
rank, a standby's the lowest slot in ``[0, max_np)`` that no running
process holds, so a standby takes a dead rank's card and a survivor
never moves off its own (a reshape renumbers ranks, not devices).
Several ranks may name one card (``init(device="cuda:0")``).
:func:`run_elastic` (``--max-restarts``) relaunches the whole job with
``HVD_TPU_RESTART_EPOCH`` incremented when it fails, elastic or not.

Multi-host launches (:func:`run_hosts`, ``-H host1:2,host2:2``,
``--port-base``): ``hosts.plan`` places the ranks in contiguous blocks
per host on fixed ports; local ranks spawn directly, remote ones over
``ssh`` with the rank environment inlined.  Each host's ranks pin
``cuda:local_rank``.  Elastic jobs stay on one host
(:func:`_check_elastic_support`).  ``--net-fault-spec`` exports
``HVD_TPU_NET_FAULT_SPEC`` (the engine's network fault injector) to
every rank.  After every attempt, success included, the launcher unlinks
the shared-memory segments a job keyed on its coordinator could have
left under ``/dev/shm`` (:func:`sweep_shm_segments`; the engine unlinks
its own once every local rank has attached, so only a death inside that
window leaves one).

CLI::

    python -m horovod_tpu_torch.runner -np 2 -- python train.py
    python -m horovod_tpu_torch.runner -np 2 --serve [--serve-port P]
    python -m horovod_tpu_torch.runner -np 2 --timeline DIR -- python train.py
    python -m horovod_tpu_torch.runner -np 2 --postmortem-dir DIR -- python train.py
    python -m horovod_tpu_torch.runner -np 4 --min-np 2 [--max-np 4] \
        [--max-restarts N] [--state-dir DIR] -- python train.py
    python -m horovod_tpu_torch.runner -np 4 -H host1:2,host2:2 \
        [--port-base P] -- python train.py
    python -m horovod_tpu_torch.runner -np 4 \
        --net-fault-spec 'link=0-1:flaky=0.05' -- python train.py

``--timeline DIR`` sets ``HVD_TPU_TIMELINE=DIR/`` for every rank, so each
writes ``DIR/rank<N>.json`` (``tools/timeline_merge.py DIR`` merges them).
``--postmortem-dir DIR`` creates DIR and sets ``HVD_TPU_POSTMORTEM_DIR``
for every rank: a rank that dies a typed death writes ``DIR/rank-<N>.json``
(``tools/postmortem_dump.py DIR`` renders them), and the failure report
points at the first-failing rank's dump and repeats the coordinator's
cross-rank diagnosis.
``--serve`` defaults the command to the serving entry point (``python -m
horovod_tpu_torch.serving``); ``--serve-port`` sets the front door's
``HVD_TPU_SERVE_PORT``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.basics import pick_free_port, pick_free_ports


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str
    # True on the rank the launcher saw fail first: its error is the real
    # one, later nonzero exits are usually the kill cascade.
    first_failure: bool = False


def signal_name(returncode: int) -> str:
    """``'SIGKILL (signal 9)'`` for a signal death (negative return code),
    else the code."""
    if returncode >= 0:
        return str(returncode)
    try:
        name = signal.Signals(-returncode).name
    except ValueError:
        name = f"signal {-returncode}"
    return f"{name} (signal {-returncode})"


def failure_report(results: List[RankResult], tail_lines: int = 30,
                   postmortem_dir: Optional[str] = None) -> str:
    """Every failing rank, then the first-failing rank's stderr tail.
    With a postmortem dir (``postmortem_dir``, else
    ``HVD_TPU_POSTMORTEM_DIR``), the first-failing rank's dump and the
    coordinator's cross-rank diagnosis follow."""
    lines = []
    first = None
    for r in results:
        if r.returncode == 0:
            continue
        marker = "  <- first failure" if r.first_failure else ""
        lines.append(
            f"rank {r.rank} exited with {signal_name(r.returncode)}{marker}")
        if r.first_failure:
            first = r
    if first is None:
        first = next((r for r in results if r.returncode != 0), None)
    if first is not None and first.stderr:
        tail = first.stderr.strip().splitlines()[-tail_lines:]
        lines.append(f"--- rank {first.rank} stderr (last {len(tail)} "
                     f"lines) ---")
        lines.extend(tail)
    directory = (postmortem_dir
                 or os.environ.get("HVD_TPU_POSTMORTEM_DIR") or "")
    if first is not None and directory:
        lines.extend(_postmortem_lines(directory, first.rank))
    return "\n".join(lines)


def _postmortem_lines(directory: str, first_rank: int) -> List[str]:
    """The failure report's pointers: the first-failing rank's dump (any
    rank's when it left none: it may have died before ``init()``), the
    cross-rank diagnosis and the transports, read from whichever dump
    carries them (the coordinator broadcast the diagnosis to every
    survivor)."""
    import glob
    import json

    from horovod_tpu_torch.common import postmortem as _postmortem

    lines: List[str] = []
    path = _postmortem.dump_path_for(directory, first_rank)
    all_dumps = sorted(glob.glob(os.path.join(directory, "rank-*.json")))
    if path is None and all_dumps:
        path = all_dumps[0]
    if path is None:
        return lines
    lines.append(f"postmortem: {path}"
                 + (f" (+{len(all_dumps) - 1} more rank dump(s); render "
                    f"with tools/postmortem_dump.py {directory})"
                    if len(all_dumps) > 1 else ""))
    diagnosis = None
    transport = None
    for candidate in ([path] + [p for p in all_dumps if p != path]):
        try:
            with open(candidate) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if transport is None:
            transport = doc.get("transport")
        if diagnosis is None:
            diagnosis = doc.get("diagnosis")
        if diagnosis and transport:
            break
    if diagnosis:
        lines.append(f"cross-rank diagnosis: {diagnosis}")
    if transport:
        peers = transport.get("peers") or {}
        peer_part = ("  peers: " + "  ".join(
            f"{p}={peers[p]}" for p in sorted(
                peers, key=lambda x: int(x) if x.isdigit() else 0))
            if peers else "")
        lines.append(f"transport: local hops on "
                     f"{transport.get('local', 'tcp')}{peer_part}")
    return lines


def _shm_job_prefix(coord: str) -> str:
    """FNV-1a-32 of the coordinator endpoint, as the engine's
    ``ShmSegmentName`` (``engine/cc/transport.cc``): every shared-memory
    segment of the job keyed on ``coord`` is named
    ``hvdtpu_<hash>_n<node>_e<epoch>`` under ``/dev/shm``."""
    h = 2166136261
    for b in coord.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return f"hvdtpu_{h:08x}_"


def sweep_shm_segments(coord: str) -> List[str]:
    """Unlink every ``/dev/shm`` segment of the job keyed on ``coord``;
    the names removed.  The engine unlinks its segment once all local
    ranks have attached, and again on every typed death, so a segment
    is left only by a rank killed between the create and the attach (a
    SIGKILL from an injected crash).  The launcher sweeps after every
    attempt, success included (then a no-op), so none outlives a
    ``--max-restarts`` relaunch or the job.  This host only: remote
    ranks rely on the engine's own unlinks."""
    removed: List[str] = []
    prefix = _shm_job_prefix(coord)
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return removed
    for name in names:
        if name.startswith(prefix):
            try:
                os.unlink(os.path.join("/dev/shm", name))
                removed.append(name)
            except OSError:
                pass
    return removed


def make_rank_env(rank: int, size: int, coord: str, data: Sequence[str],
                  base_env: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    env = dict(base_env if base_env is not None else os.environ)
    env["HVD_TPU_RANK"] = str(rank)
    env["HVD_TPU_SIZE"] = str(size)
    env["HVD_TPU_LOCAL_RANK"] = str(rank)
    env["HVD_TPU_LOCAL_SIZE"] = str(size)
    env["HVD_TPU_COORD"] = coord
    env["HVD_TPU_DATA"] = ",".join(data)
    if env.get("HVD_TPU_SANITIZE"):
        _preload_sanitizer(env)
    return env


def _preload_sanitizer(env: Dict[str, str]) -> None:
    """A sanitized engine (``HVD_TPU_SANITIZE``, ``engine/build.py``) needs
    its sanitizer's runtime preloaded into the rank: put it first in the
    rank's ``LD_PRELOAD``, before what is there already (a runtime after
    another preload, or none, and the rank dies loading the engine).  The
    launcher's own process is never preloaded.  A bad mode, or a runtime
    the compiler cannot name while ``LD_PRELOAD`` names no sanitizer of
    its own, warns once a job; the rank's ``build()`` then raises or its
    load fails."""
    from horovod_tpu_torch.engine.build import sanitizer_preload

    mode = env["HVD_TPU_SANITIZE"]
    preload = None  # a bad mode
    try:
        preload = sanitizer_preload(mode.strip().lower())
    except ValueError as exc:
        _warn_sanitize_once(str(exc))
    existing = env.get("LD_PRELOAD", "")
    if preload:
        if preload not in existing.split(":"):
            env["LD_PRELOAD"] = (f"{preload}:{existing}" if existing
                                 else preload)
    elif preload == "" and not any(runtime in existing for runtime in
                                   ("tsan", "asan", "ubsan")):
        _warn_sanitize_once(
            f"HVD_TPU_SANITIZE={mode} is set but the sanitizer runtime "
            "could not be resolved (g++ -print-file-name); ranks will "
            "likely fail to load the instrumented engine. Install the "
            "libsanitizer runtime or set LD_PRELOAD yourself.")


# Sanitizer warnings already printed: make_rank_env runs once a rank, the
# job needs each warning once.
_sanitize_warned: set = set()


def _warn_sanitize_once(msg: str) -> None:
    if msg not in _sanitize_warned:
        _sanitize_warned.add(msg)
        print(f"horovod_tpu_torch.runner: WARNING: {msg}", file=sys.stderr)


def allocate_endpoints(size: int, host: str = "127.0.0.1"):
    """The coordinator endpoint and one data endpoint per rank, picked as
    one held batch so no port is handed out twice."""
    ports = pick_free_ports(size + 1, host)
    return f"{host}:{ports[0]}", [f"{host}:{p}" for p in ports[1:]]


def _env_seconds(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


class _PipeReader:
    """Drain one rank's pipe on a thread while the rank runs, so a rank
    that writes more than a pipe holds never blocks on it.  ``echo``
    copies each line to that stream; ``tail_lines`` keeps only the last
    lines (else all)."""

    def __init__(self, pipe, echo=None, tail_lines: Optional[int] = None):
        self._pipe = pipe
        self._echo = echo
        self._lines = collections.deque(maxlen=tail_lines)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for line in self._pipe:
                if self._echo is not None:
                    self._echo.write(line)
                self._lines.append(line)
        except (ValueError, OSError):
            pass  # pipe torn down mid-read (kill cascade)
        finally:
            try:
                self._pipe.close()
            except OSError:
                pass

    def text(self, timeout: float = 5.0) -> str:
        """What was read, once the pipe has closed (or ``timeout``)."""
        self._thread.join(timeout)
        return "".join(self._lines)


def run_command(cmd: Sequence[str], np: int,
                env: Optional[Dict[str, str]] = None,
                timeout: float = 300.0, capture: bool = False,
                host: str = "127.0.0.1") -> List[RankResult]:
    """Launch ``cmd`` as ``np`` local ranks, wait for all, kill all on a
    failure; per-rank results (stdout only with ``capture``).  Raises
    ``subprocess.TimeoutExpired`` past ``timeout`` seconds."""
    coord, data = allocate_endpoints(np, host)
    return _spawn_and_wait(
        cmd, [(list(cmd), make_rank_env(r, np, coord, data, env))
              for r in range(np)], coord, timeout, capture)


def _spawn_and_wait(cmd, argv_envs, coord: str, timeout: float,
                    capture: bool) -> List[RankResult]:
    """Start one process per ``(argv, env)``, wait for all (killing all
    on a failure), then sweep the job's ``/dev/shm`` segments: after a
    typed abort, an injected crash, a timeout or a clean exit alike."""
    procs, readers = [], []
    try:
        try:
            for argv, rank_env in argv_envs:
                p = subprocess.Popen(
                    argv, env=rank_env,
                    stdout=subprocess.PIPE if capture else None,
                    stderr=subprocess.PIPE, text=True,
                    start_new_session=True)
                procs.append(p)
                if capture:
                    readers.append((_PipeReader(p.stdout),
                                    _PipeReader(p.stderr)))
                else:
                    readers.append((None,
                                    _PipeReader(p.stderr, sys.stderr, 80)))
        except BaseException:
            for p in procs:
                _kill_rank(p)
            raise
        return _wait_all(cmd, procs, timeout, readers)
    finally:
        sweep_shm_segments(coord)


def run_hosts(cmd: Sequence[str], np: int, hosts_spec: str,
              port_base: Optional[int] = None,
              env: Optional[Dict[str, str]] = None,
              timeout: float = 3e7, capture: bool = False
              ) -> List[RankResult]:
    """Launch ``cmd`` over a host spec (``"host1:2,host2:2"``): local
    ranks spawn directly, remote ones over ``ssh`` (``hosts.ssh_command``).
    The keys of ``env`` that differ from this process's environment, and
    ``PYTHONPATH`` and ``CUDA_VISIBLE_DEVICES``, are inlined into every
    remote command: ``ssh`` gives a fresh login environment."""
    from horovod_tpu_torch.runner.hosts import (DEFAULT_PORT_BASE, plan,
                                                ssh_command)

    placements = plan(np, hosts_spec, port_base or DEFAULT_PORT_BASE)
    base_env = dict(env if env is not None else os.environ)
    overrides = {k: v for k, v in base_env.items()
                 if os.environ.get(k) != v}
    for key in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES"):
        if key in base_env:
            overrides.setdefault(key, base_env[key])
    argv_envs = []
    for p in placements:
        argv = list(cmd) if p.is_local else ssh_command(
            p, cmd, extra_env=overrides)
        argv_envs.append((argv, dict(base_env, **p.env)))
    # This host's segments only: remote hosts clean their own through the
    # engine's unlinks.
    return _spawn_and_wait(cmd, argv_envs,
                           placements[0].env["HVD_TPU_COORD"], timeout,
                           capture)


def _kill_rank(p) -> None:
    """Kill a rank and everything it started (its own session)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except OSError:
        p.kill()


def _wait_all(cmd, procs, timeout: float, readers) -> List[RankResult]:
    # When a rank fails, the rest get a grace period (the engine aborts
    # every rank in a coordinated way) and are then killed.  A rank that
    # exits 0 while the others run on for minutes means the job can never
    # finish (synchronous SPMD ends in lockstep): the stragglers are
    # killed after HVD_TPU_EXIT_STRAGGLER_SEC.
    grace_sec = _env_seconds("HVD_TPU_KILL_GRACE_SEC", 15.0)
    straggler_sec = _env_seconds("HVD_TPU_EXIT_STRAGGLER_SEC", 300.0)
    deadline = time.monotonic() + timeout
    grace_deadline = zero_exit_deadline = None
    first_failed = None
    timed_out = False
    try:
        while sum(1 for p in procs if p.poll() is None):
            now = time.monotonic()
            if grace_deadline is None:
                failed = [i for i, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed:
                    first_failed = failed[0]
                    grace_deadline = now + grace_sec
            if (straggler_sec > 0 and zero_exit_deadline is None
                    and any(p.returncode == 0 for p in procs)):
                zero_exit_deadline = now + straggler_sec
            if (now >= deadline or (grace_deadline and now >= grace_deadline)
                    or (zero_exit_deadline and now >= zero_exit_deadline)):
                timed_out = now >= deadline
                for p in procs:
                    if p.poll() is None:
                        _kill_rank(p)
                break
            time.sleep(0.05)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                _kill_rank(p)
        raise
    results = _collect_results(procs, readers, first_failed)
    if timed_out:
        raise subprocess.TimeoutExpired(cmd, timeout)
    return results


def _collect_results(procs, readers, first_failed) -> List[RankResult]:
    results = []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            _kill_rank(p)
            p.wait(timeout=5.0)
        out, err = readers[r]
        rc = p.returncode if p.returncode is not None else -9
        results.append(RankResult(r, rc, out.text() if out else "",
                                  err.text(),
                                  first_failure=(r == first_failed)))
    return results


def _elastic_bounds(np: int, min_np: Optional[int],
                    max_np: Optional[int]) -> Tuple[int, int]:
    """Normalize and check the elastic bounds, the one place their rules
    live.  An unset ``min_np`` means every launched rank must finish, not
    one survivor; an unset ``max_np`` means no growth."""
    # `is not None`: an explicit 0 must reach the check, not read as unset.
    min_np = min_np if min_np is not None else np
    max_np = max_np if max_np is not None else np
    if not (1 <= min_np <= np <= max_np):
        raise ValueError(
            f"need 1 <= min-np ({min_np}) <= np ({np}) <= max-np ({max_np})")
    return min_np, max_np


def _check_elastic_support(hosts_spec: Optional[str]) -> None:
    """Refuse what elastic membership cannot compose with yet, rather
    than drop it silently: a multi-host launch."""
    if hosts_spec:
        raise ValueError(
            "elastic membership (min_np/max_np) supports single-host "
            "launches only")


def run_elastic(cmd: Sequence[str], np: int, max_restarts: int = 0,
                env: Optional[Dict[str, str]] = None,
                timeout: float = 300.0, capture: bool = False,
                host: str = "127.0.0.1", hosts_spec: Optional[str] = None,
                port_base: Optional[int] = None,
                min_np: Optional[int] = None,
                max_np: Optional[int] = None,
                max_rejoins: Optional[int] = None,
                report: Callable[[str], None] = None):
    """Job-level restart: run the job, and when it fails (a rank exits
    non-zero, or it times out) relaunch every rank with
    ``HVD_TPU_RESTART_EPOCH`` incremented, up to ``max_restarts`` times,
    on fresh endpoints.  ``timeout`` is the budget of all attempts
    together.  Returns ``(results, restarts_used)``; the script resumes
    from its latest checkpoint.

    With ``min_np`` or ``max_np`` set each attempt runs under
    :func:`run_membership`: deaths shrink the job in place and standbys
    rejoin, with no relaunch while at least ``min_np`` members survive.
    Only when that fails (rank 0 died, or the survivors fell below
    ``min_np``) does the attempt count as failed.  With ``hosts_spec``
    each attempt runs under :func:`run_hosts` (not with elastic
    membership: ``ValueError``)."""
    if report is None:
        def report(msg):
            print(msg, file=sys.stderr, flush=True)
    elastic = min_np is not None or max_np is not None
    if elastic:
        min_np, max_np = _elastic_bounds(np, min_np, max_np)
        _check_elastic_support(hosts_spec)
    base_env = dict(env if env is not None else os.environ)
    results: List[RankResult] = []
    deadline = time.monotonic() + timeout
    for epoch in range(max_restarts + 1):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise subprocess.TimeoutExpired(list(cmd), timeout)
        run_env = dict(base_env, HVD_TPU_RESTART_EPOCH=str(epoch))
        try:
            if elastic:
                results = run_membership(cmd, np, min_np=min_np,
                                         max_np=max_np, env=run_env,
                                         timeout=remaining, capture=capture,
                                         host=host, max_rejoins=max_rejoins,
                                         report=report)
            elif hosts_spec:
                results = run_hosts(cmd, np, hosts_spec,
                                    port_base=port_base, env=run_env,
                                    timeout=remaining, capture=capture)
            else:
                results = run_command(cmd, np, env=run_env,
                                      timeout=remaining, capture=capture,
                                      host=host)
        except subprocess.TimeoutExpired:
            if epoch == max_restarts:
                raise
            report(f"horovod_tpu_torch.runner: job timed out (restart "
                   f"epoch {epoch}); restarting ({epoch + 1}/"
                   f"{max_restarts})")
            continue
        ok = (membership_succeeded(results, min_np) if elastic
              else all(r.returncode == 0 for r in results))
        if ok:
            return results, epoch
        if epoch < max_restarts:
            rpt = failure_report(results)
            report(f"horovod_tpu_torch.runner: job failed (restart epoch "
                   f"{epoch}):" + (f"\n{rpt}" if rpt else "")
                   + f"\nhorovod_tpu_torch.runner: restarting "
                   f"({epoch + 1}/{max_restarts})")
    return results, max_restarts


def run_membership(cmd: Sequence[str], np: int,
                   min_np: Optional[int] = None,
                   max_np: Optional[int] = None,
                   env: Optional[Dict[str, str]] = None,
                   timeout: float = 300.0, capture: bool = False,
                   host: str = "127.0.0.1", rejoin_delay: float = 1.0,
                   max_rejoins: Optional[int] = None,
                   report: Callable[[str], None] = None
                   ) -> List[RankResult]:
    """The elastic membership launcher (``--min-np``/``--max-np``).

    Starts ``np`` ranks with ``HVD_TPU_ELASTIC=1`` and
    ``HVD_TPU_MIN_NP``.  A dying rank does not start the kill cascade:
    the engine reshapes the job, and the launcher keeps it going while at
    least ``min_np`` processes (rank 0 among them) run.  Below ``max_np``
    it spawns standbys (``HVD_TPU_REJOIN=1``, a fresh data endpoint, at
    most ``max_rejoins``, default ``2 * max_np``) that register with the
    live coordinator.  Rank 0 dying, or fewer than ``min_np`` running,
    is fatal: everything is killed, for :func:`run_elastic`'s relaunch.
    Once one member exits 0 the rest get the kill grace to follow.

    Returns one :class:`RankResult` per process ever started: the first
    ranks keep their launch indices, standbys are numbered from ``np``
    up.  Every process's ``HVD_TPU_DEVICE_SLOT`` is set as the module
    docstring says."""
    if report is None:
        def report(msg):
            print(msg, file=sys.stderr, flush=True)
    min_np, max_np = _elastic_bounds(np, min_np, max_np)
    if max_rejoins is None:
        # Room for the planned growth toward max_np and for replacements.
        max_rejoins = 2 * max_np
    coord, data = allocate_endpoints(np, host)
    base_env = dict(env if env is not None else os.environ)
    base_env["HVD_TPU_ELASTIC"] = "1"
    base_env["HVD_TPU_MIN_NP"] = str(min_np)
    procs, readers, slots = [], [], []

    def spawn(rank_env, slot):
        rank_env["HVD_TPU_DEVICE_SLOT"] = str(slot)
        p = subprocess.Popen(
            list(cmd), env=rank_env,
            stdout=subprocess.PIPE if capture else None,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        procs.append(p)
        slots.append(slot)
        readers.append((_PipeReader(p.stdout), _PipeReader(p.stderr))
                       if capture else
                       (None, _PipeReader(p.stderr, sys.stderr, 80)))

    grace_sec = _env_seconds("HVD_TPU_KILL_GRACE_SEC", 15.0)
    deadline = time.monotonic() + timeout
    completion_deadline = rejoin_at = None
    rejoins_used = 0
    fatal = False
    reported_dead: set = set()
    first_dead = None  # the first death in time, not in slot order
    try:
        for r in range(np):
            spawn(make_rank_env(r, np, coord, data, base_env), r)
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            running = sum(1 for p in procs if p.poll() is None)
            completed = sum(1 for p in procs if p.returncode == 0)
            for i, p in enumerate(procs):
                if p.returncode not in (None, 0) and i not in reported_dead:
                    if first_dead is None:
                        first_dead = i
                    reported_dead.add(i)
                    label = (f"rank {i}" if i < np
                             else f"standby {i - np + 1} (slot {i})")
                    report(f"horovod_tpu_torch.runner: {label} exited with "
                           f"{signal_name(p.returncode)}; {running} "
                           f"member(s) still running (elastic min-np "
                           f"{min_np})")
            if procs[0].poll() is not None and procs[0].returncode != 0:
                # The coordinator owns the membership: nothing reshapes
                # without it.
                report("horovod_tpu_torch.runner: coordinator (rank 0) "
                       "died; elastic continuation impossible")
                fatal = True
                break
            if completed:
                # SPMD finishes in lockstep: the rest follow within the
                # grace, or are wedged (or standbys never admitted).
                if completion_deadline is None:
                    completion_deadline = now + max(grace_sec, 5.0)
                if now >= completion_deadline:
                    for p in procs:
                        if p.poll() is None:
                            _kill_rank(p)
                    break
            elif running < min_np:
                report(f"horovod_tpu_torch.runner: only {running} "
                       f"member(s) running (< min-np {min_np}); giving up "
                       "on elastic continuation")
                fatal = True
                break
            elif running < max_np and rejoins_used < max_rejoins:
                # A delay keeps a crash-looping command from hot-spawning;
                # a fresh endpoint keeps a dead rank's socket out.
                if rejoin_at is None:
                    rejoin_at = now + rejoin_delay
                elif now >= rejoin_at:
                    rejoin_at = None
                    rejoins_used += 1
                    ep = f"{host}:{pick_free_port(host)}"
                    held = {s for s, p in zip(slots, procs)
                            if p.poll() is None}
                    slot = min(set(range(max_np)) - held)
                    standby_env = dict(base_env)
                    standby_env.update({
                        "HVD_TPU_REJOIN": "1",
                        "HVD_TPU_RANK": "0", "HVD_TPU_SIZE": "1",
                        "HVD_TPU_LOCAL_RANK": "0", "HVD_TPU_LOCAL_SIZE": "1",
                        "HVD_TPU_COORD": coord, "HVD_TPU_DATA": ep,
                    })
                    report(f"horovod_tpu_torch.runner: spawning standby "
                           f"{rejoins_used} at {ep} on device slot {slot} "
                           f"({running}/{max_np} members running)")
                    spawn(standby_env, slot)
            else:
                rejoin_at = None
            if now >= deadline:
                for p in procs:
                    if p.poll() is None:
                        _kill_rank(p)
                raise subprocess.TimeoutExpired(list(cmd), timeout)
            time.sleep(0.05)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                _kill_rank(p)
        sweep_shm_segments(coord)
        raise
    if fatal:
        for p in procs:
            if p.poll() is None:
                _kill_rank(p)
    results = _collect_results(procs, readers, first_dead)
    sweep_shm_segments(coord)
    if first_dead is None:
        for r in results:
            if r.returncode != 0:
                r.first_failure = True
                break
    return results


def membership_succeeded(results: List[RankResult], min_np: int) -> bool:
    """Whether an elastic run succeeded: rank 0 (slot 0) exited 0 and at
    least ``min_np`` members finished cleanly (the deaths the job
    reshaped around do not fail it)."""
    if not results or results[0].returncode != 0:
        return False
    return sum(1 for r in results if r.returncode == 0) >= min_np


_FN_RUNNER = """\
import pickle, sys
with open(sys.argv[1], 'rb') as f:
    fn = pickle.load(f)
fn()
"""


def launch_fn(fn: Callable[[], None], np: int,
              env: Optional[Dict[str, str]] = None,
              timeout: float = 300.0) -> List[RankResult]:
    """Run a picklable zero-argument callable on every rank; stdout and
    stderr captured."""
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump(fn, f)
        pkl = f.name
    try:
        return run_command([sys.executable, "-c", _FN_RUNNER, pkl], np,
                           env=env, timeout=timeout, capture=True)
    finally:
        os.unlink(pkl)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch a horovod_tpu_torch job.")
    parser.add_argument("-np", "--num-proc", type=int, required=True,
                        help="number of ranks to launch")
    parser.add_argument("-H", "--hosts", default=None,
                        help="host spec 'host1:slots,host2:slots': ranks "
                             "fill the hosts in contiguous blocks; remote "
                             "hosts are reached over ssh (default: every "
                             "rank on this host)")
    parser.add_argument("--port-base", type=int, default=None,
                        help="with -H: the coordinator's port (the data "
                             "ports follow it)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address of the engine's endpoints (one "
                             "host)")
    parser.add_argument("--timeout", type=float, default=0.0,
                        help="kill the job after this many seconds (0: "
                             "none)")
    parser.add_argument("--timeline", default=None, metavar="DIR",
                        help="write one Chrome-trace file per rank under "
                             "DIR (rank0.json, rank1.json, ...; sets "
                             "HVD_TPU_TIMELINE=DIR/); merge them with "
                             "tools/timeline_merge.py")
    parser.add_argument("--postmortem-dir", default=None, metavar="DIR",
                        help="every rank writes a rank-<N>.json dump under "
                             "DIR when it dies a typed death (a "
                             "coordinated abort, an injected crash, a "
                             "fatal exception; sets "
                             "HVD_TPU_POSTMORTEM_DIR); the failure report "
                             "points at the first-failing rank's.  Render "
                             "with tools/postmortem_dump.py DIR")
    parser.add_argument("--serve", action="store_true",
                        help="serving mode: the command defaults to python "
                             "-m horovod_tpu_torch.serving; rank 0 opens "
                             "the HTTP front door on HVD_TPU_SERVE_PORT / "
                             "--serve-port (standby rejoin is refused: a "
                             "fresh rank cannot recover the in-flight KV "
                             "state)")
    parser.add_argument("--serve-port", type=int, default=None,
                        help="with --serve: the front door's port (sets "
                             "HVD_TPU_SERVE_PORT)")
    parser.add_argument("--min-np", type=int, default=None,
                        help="elastic membership: keep the job going while "
                             "at least this many ranks survive; a dying "
                             "rank shrinks it in place (the survivors agree "
                             "on a new size and ranks and resync their "
                             "state, no relaunch or checkpoint load); below "
                             "it the --max-restarts fallback fires")
    parser.add_argument("--max-np", type=int, default=None,
                        help="with --min-np: while fewer members run, spawn "
                             "standby ranks that the job admits at its next "
                             "reshape barrier (default: -np; never with "
                             "--serve)")
    parser.add_argument("--net-fault-spec", default=None, metavar="SPEC",
                        help="the engine's network fault injector on every "
                             "rank (sets HVD_TPU_NET_FAULT_SPEC), e.g. "
                             "'link=0-1:drop@after=2', "
                             "'partition=0,1/2,3@after=1', "
                             "'link=1-2:delay=5|jitter=3', "
                             "'link=0-3:flaky=0.05'; composes with "
                             "HVD_TPU_FAULT_SPEC's process faults")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="when the job fails, kill the survivors and "
                             "relaunch every rank up to N times with "
                             "HVD_TPU_RESTART_EPOCH incremented; the script "
                             "resumes from its latest checkpoint")
    parser.add_argument("--state-dir", default=None, metavar="DIR",
                        help="state plane: spill each rank's async shard "
                             "snapshots under DIR (sets HVD_TPU_STATE_DIR "
                             "for every rank and relaunch); scripts arm the "
                             "plane with horovod_tpu_torch.state.arm()")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command, e.g. python train.py")
    args = parser.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        if not args.serve:
            parser.error("no command given")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.serving"]
    if args.serve_port is not None and not args.serve:
        parser.error("--serve-port requires --serve")
    env = None
    if args.serve_port is not None:
        env = dict(os.environ, HVD_TPU_SERVE_PORT=str(args.serve_port))
    if args.timeline:
        os.makedirs(args.timeline, exist_ok=True)
        env = dict(env if env is not None else os.environ)
        # The trailing separator asks every rank for the directory form.
        env["HVD_TPU_TIMELINE"] = args.timeline.rstrip(os.sep) + os.sep
    if args.state_dir:
        os.makedirs(args.state_dir, exist_ok=True)
        env = dict(env if env is not None else os.environ)
        env["HVD_TPU_STATE_DIR"] = args.state_dir
    if args.net_fault_spec is not None:
        env = dict(env if env is not None else os.environ)
        env["HVD_TPU_NET_FAULT_SPEC"] = args.net_fault_spec
    if args.postmortem_dir:
        os.makedirs(args.postmortem_dir, exist_ok=True)
        env = dict(env if env is not None else os.environ)
        env["HVD_TPU_POSTMORTEM_DIR"] = args.postmortem_dir
        # The launcher's own failure reports read it too.
        os.environ["HVD_TPU_POSTMORTEM_DIR"] = args.postmortem_dir
    elastic = args.min_np is not None or args.max_np is not None
    if elastic:
        try:
            _elastic_bounds(args.num_proc, args.min_np, args.max_np)
            _check_elastic_support(args.hosts)
        except ValueError as e:
            parser.error(str(e))
    try:
        if elastic or args.max_restarts:
            results, restarts = run_elastic(
                cmd, args.num_proc, max_restarts=args.max_restarts, env=env,
                timeout=args.timeout or 3e7, host=args.host,
                hosts_spec=args.hosts, port_base=args.port_base,
                min_np=args.min_np, max_np=args.max_np,
                # Serving shrinks but never grows: a standby would join
                # with empty KV pages.
                max_rejoins=0 if args.serve else None)
        elif args.hosts:
            results, restarts = run_hosts(
                cmd, args.num_proc, args.hosts, port_base=args.port_base,
                env=env, timeout=args.timeout or 3e7), 0
        else:
            results, restarts = run_command(
                cmd, args.num_proc, env=env, timeout=args.timeout or 3e7,
                host=args.host), 0
    except subprocess.TimeoutExpired:
        print("horovod_tpu_torch.runner: job timed out", file=sys.stderr)
        return 124
    # An unset --min-np with --max-np: may grow, must not shrink.
    ok = (membership_succeeded(
        results, args.min_np if args.min_np is not None else args.num_proc)
        if elastic else all(r.returncode == 0 for r in results))
    if restarts and ok:
        print(f"horovod_tpu_torch.runner: job succeeded after {restarts} "
              "restart(s)", file=sys.stderr)
    if elastic and ok:
        # First-launch ranks only: a standby reaped unadmitted at the end
        # was never a member.
        lost = sum(1 for r in results
                   if r.returncode != 0 and r.rank < args.num_proc)
        if lost:
            print(f"horovod_tpu_torch.runner: job completed elastically "
                  f"({lost} member(s) lost and reshaped around)",
                  file=sys.stderr)
        return 0
    report = failure_report(results)
    if report:
        print(f"horovod_tpu_torch.runner: {report}", file=sys.stderr)
    for r in results:
        if r.returncode != 0:
            # A signal death reports 128 + signal, as a shell would.
            return r.returncode if r.returncode > 0 else 128 - r.returncode
    return 0
