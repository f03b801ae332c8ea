"""The port's launcher: one host, ``np`` fresh rank processes.

Own copy of ``horovod_tpu/runner/launch.py``, trimmed to one host: it
allocates the engine's endpoints (rank 0's coordinator and one data port
per rank) as one held batch, exports the ``HVD_TPU_*`` environment that
``horovod_tpu_torch.common.basics`` reads, starts every rank as a new
process (``subprocess``: never a fork of a process whose CUDA is up), and
tears the job down when a rank fails: the others get a grace period to
exit on the engine's coordinated abort, then are killed with their
process groups; ranks still running long after one exited 0 are killed
too (the straggler bound).

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
Multi-host launches (``hosts.py``) and TPU pinning are not ported.

CLI::

    python -m horovod_tpu_torch.runner -np 2 -- python train.py
    python -m horovod_tpu_torch.runner -np 2 --serve [--serve-port P]
    python -m horovod_tpu_torch.runner -np 2 --timeline DIR -- python train.py
    python -m horovod_tpu_torch.runner -np 4 --min-np 2 [--max-np 4] \
        [--max-restarts N] [--state-dir DIR] -- python train.py

``--timeline DIR`` sets ``HVD_TPU_TIMELINE=DIR/`` for every rank, so each
writes ``DIR/rank<N>.json`` (``tools/timeline_merge.py DIR`` merges them).
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


def failure_report(results: List[RankResult], tail_lines: int = 30) -> str:
    """Every failing rank, then the first-failing rank's stderr tail."""
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
    return "\n".join(lines)


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
    return env


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
    procs, readers = [], []
    try:
        for r in range(np):
            p = subprocess.Popen(
                list(cmd), env=make_rank_env(r, np, coord, data, env),
                stdout=subprocess.PIPE if capture else None,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
            procs.append(p)
            if capture:
                readers.append((_PipeReader(p.stdout),
                                _PipeReader(p.stderr)))
            else:
                readers.append((None, _PipeReader(p.stderr, sys.stderr, 80)))
    except BaseException:
        for p in procs:
            _kill_rank(p)
        raise
    return _wait_all(cmd, procs, timeout, readers)


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


def run_elastic(cmd: Sequence[str], np: int, max_restarts: int = 0,
                env: Optional[Dict[str, str]] = None,
                timeout: float = 300.0, capture: bool = False,
                host: str = "127.0.0.1", min_np: Optional[int] = None,
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
    ``min_np``) does the attempt count as failed."""
    if report is None:
        def report(msg):
            print(msg, file=sys.stderr, flush=True)
    elastic = min_np is not None or max_np is not None
    if elastic:
        min_np, max_np = _elastic_bounds(np, min_np, max_np)
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
        raise
    if fatal:
        for p in procs:
            if p.poll() is None:
                _kill_rank(p)
    results = _collect_results(procs, readers, first_dead)
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
        description="Launch a horovod_tpu_torch job on this host.")
    parser.add_argument("-np", "--num-proc", type=int, required=True,
                        help="number of ranks to launch")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address of the engine's endpoints")
    parser.add_argument("--timeout", type=float, default=0.0,
                        help="kill the job after this many seconds (0: "
                             "none)")
    parser.add_argument("--timeline", default=None, metavar="DIR",
                        help="write one Chrome-trace file per rank under "
                             "DIR (rank0.json, rank1.json, ...; sets "
                             "HVD_TPU_TIMELINE=DIR/); merge them with "
                             "tools/timeline_merge.py")
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
    elastic = args.min_np is not None or args.max_np is not None
    if elastic:
        try:
            _elastic_bounds(args.num_proc, args.min_np, args.max_np)
        except ValueError as e:
            parser.error(str(e))
    try:
        if elastic or args.max_restarts:
            results, restarts = run_elastic(
                cmd, args.num_proc, max_restarts=args.max_restarts, env=env,
                timeout=args.timeout or 3e7, host=args.host,
                min_np=args.min_np, max_np=args.max_np,
                # Serving shrinks but never grows: a standby would join
                # with empty KV pages.
                max_rejoins=0 if args.serve else None)
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
