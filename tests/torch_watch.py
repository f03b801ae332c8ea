"""A watchdog for the port tests' multi-rank launches.

A launch that hangs under a loaded machine (six pytest workers, each
starting rank processes) used to fail with a bare timeout, or with a rank's
last lines, and say nothing of where the ranks were.  :func:`watched`
runs a launch; past its ``seconds`` it sends SIGABRT to every process the
test's process started, so each rank that runs Python with
``PYTHONFAULTHANDLER`` set (:data:`ENV`) dumps its threads' stacks into
its stderr and dies.  The launcher then reports the ranks as failed, with
that stderr, instead of timing out.  Whatever still runs after the launch
is killed, and an error raised inside gains a note of the launch's
seconds and whether the watchdog fired.
"""

import contextlib
import os
import signal
import threading
import time

ENV = {"PYTHONFAULTHANDLER": "1"}


def descendants(pid):
    """Every live process under ``pid`` (the launchers start each rank in
    a session of its own, so a process group misses them)."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def signal_all(pids, sig):
    for pid in pids:
        try:
            os.kill(pid, sig)
        except OSError:
            pass


@contextlib.contextmanager
def watched(seconds, what):
    """Run the block, a launch named ``what``; past ``seconds`` dump the
    stacks of every process this one started (see the module's
    docstring)."""
    start = time.monotonic()
    fired = threading.Event()

    def fire():
        fired.set()
        signal_all(descendants(os.getpid()), signal.SIGABRT)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    except BaseException as exc:
        exc.add_note(
            f"{what}: {time.monotonic() - start:.1f} s"
            + (f"; past {seconds} s every rank's stacks were dumped "
               "(SIGABRT) into its stderr" if fired.is_set() else ""))
        raise
    finally:
        timer.cancel()
        signal_all(descendants(os.getpid()), signal.SIGKILL)
