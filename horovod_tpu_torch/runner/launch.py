"""The port's launcher: one host, ``np`` fresh rank processes.

Own copy of ``horovod_tpu/runner/launch.py``, trimmed to one host: it
allocates the engine's endpoints (rank 0's coordinator and one data port
per rank) as one held batch, exports the ``HVD_TPU_*`` environment that
``horovod_tpu_torch.common.basics`` reads, starts every rank as a new
process (``subprocess``: never a fork of a process whose CUDA is up), and
tears the job down when a rank fails: the others get a grace period to
exit on the engine's coordinated abort, then are killed with their
process groups; ranks still running long after one exited 0 are killed
too (the straggler bound).  Multi-host launches (``hosts.py``), elastic
membership and TPU pinning are not ported.

CLI::

    python -m horovod_tpu_torch.runner -np 2 -- python train.py
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
from typing import Callable, Dict, List, Optional, Sequence

from horovod_tpu_torch.common.basics import pick_free_ports


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
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command, e.g. python train.py")
    args = parser.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        parser.error("no command given")
    try:
        results = run_command(cmd, args.num_proc,
                              timeout=args.timeout or 3e7, host=args.host)
    except subprocess.TimeoutExpired:
        print("horovod_tpu_torch.runner: job timed out", file=sys.stderr)
        return 124
    report = failure_report(results)
    if report:
        print(f"horovod_tpu_torch.runner: {report}", file=sys.stderr)
    for r in results:
        if r.returncode != 0:
            # A signal death reports 128 + signal, as a shell would.
            return r.returncode if r.returncode > 0 else 128 - r.returncode
    return 0
