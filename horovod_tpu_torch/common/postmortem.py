"""The postmortem plane: flight-recorder drains and crash and hang dumps.

Own copy of ``horovod_tpu/common/postmortem.py``, over the port's engine.
With ``HVD_TPU_POSTMORTEM_DIR`` set, each rank writes ONE
``rank-<N>.json`` (``rank-<N>.e<E>.json`` on restart epochs) the first
time it dies a typed death: a coordinated abort
(``RanksDownError``/``CollectiveTimeoutError``, from
``common._status_error``), a fatal uncaught Python exception (the
excepthook ``init()`` installs), an injected crash (``common/faults.py``),
or an abort the engine latched that no ``Handle.wait`` consumed (at
``shutdown()``).  The dump carries:

* the drained **flight recorder** rings: the engine's C++ ring
  (``engine/cc/flight.{h,cc}``, the last ``HVD_TPU_FLIGHT_EVENTS``
  control-plane events with epoch-anchored timestamps) and the Python
  ring :data:`plane_ring`, which stays empty in the port (the reference's
  XLA plane records into it; the port has no device data plane);
* the **pending tables**: which collectives were in flight on this rank
  and, on rank 0, which ranks each stalled negotiation was waiting on;
* the coordinator's **cross-rank diagnosis** ("rank 2 stopped announcing
  after tick 1841"), broadcast to every rank in the abort message;
* the membership epoch, the applied **autotune** parameters, the state
  plane's status and a full **metrics snapshot**.

The document's keys and nesting are the reference's, so
``tools/postmortem_dump.py`` renders a directory of the port's dumps
unchanged, and the launcher's ``--postmortem-dir`` points at the
first-failing rank's dump in its failure report.  A dump is written once
per process (the first death wins: later failure paths are the kill
cascade, not the cause) and renamed into place, so a SIGKILL mid-write
cannot leave a half-written file.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import List, Optional

# Flight-recorder event names, shared with engine/cc/flight.cc
# (FlightEventName) — the engine serializes names, so Python only needs
# this list for tools/docs, not for parsing.
EVENTS = ("enqueue", "announce", "cache_hit", "execute", "error", "tick",
          "stall", "abort", "reshape", "tune", "compress", "topology",
          "steady", "heartbeat_miss", "anomaly", "transport")

DEFAULT_RING_EVENTS = 512

_write_lock = threading.Lock()
_written_path: Optional[str] = None


def postmortem_dir() -> str:
    """The dump directory (``HVD_TPU_POSTMORTEM_DIR``); empty = disabled."""
    return os.environ.get("HVD_TPU_POSTMORTEM_DIR", "")


def ring_capacity() -> int:
    """``HVD_TPU_FLIGHT_EVENTS`` (shared with the C++ ring); 0 disables.
    Read through Config so the Python ring and the documented knob cannot
    drift (the engine's own getenv parse runs only after Config.from_env
    validated the value at init)."""
    from horovod_tpu_torch.common.config import Config

    try:
        cap = Config.from_env().flight_events
    except ValueError:
        cap = DEFAULT_RING_EVENTS
    return max(0, min(cap, 65536))


class FlightRing:
    """Python-side flight recorder (XLA plane / app events): the same
    bounded always-on ring the engine keeps in C++, for the code paths
    that never enter it.  Lock-cheap by the same argument — a handful of
    control-plane events per collective."""

    def __init__(self, capacity: Optional[int] = None):
        cap = ring_capacity() if capacity is None else capacity
        self.enabled = cap > 0
        self._ring = collections.deque(maxlen=max(cap, 1))
        self._lock = threading.Lock()
        self._epoch = time.monotonic()
        self._seq = 0
        self.total = 0  # cumulative, survives drain (metrics contract)

    def record(self, event: str, name: str = "", arg: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._ring.append({
                "seq": self._seq,
                "ts_us": int((time.monotonic() - self._epoch) * 1e6),
                "event": event, "name": name, "arg": int(arg),
            })
            self._seq += 1
            self.total += 1

    def drain(self) -> List[dict]:
        """Oldest-first snapshot (non-destructive, like the C++ Dump)."""
        with self._lock:
            return [dict(e) for e in self._ring]


# The Python-side ring of the reference's XLA plane: the dump's
# ``ring.xla`` and the ``flight`` section's ``xla`` count.  Nothing in the
# port records into it (no device data plane), so it reads empty.
plane_ring = FlightRing()


def parse_engine_ring(raw: str) -> List[dict]:
    """Decode the engine's ``seq|ts_us|event|name|arg;...`` ring dump."""
    events = []
    for entry in raw.split(";"):
        if not entry:
            continue
        parts = entry.split("|")
        if len(parts) != 5:
            continue
        try:
            events.append({"seq": int(parts[0]), "ts_us": int(parts[1]),
                           "event": parts[2], "name": parts[3],
                           "arg": int(parts[4])})
        except ValueError:
            continue
    return events


def _parse_pending_local(raw: str) -> List[dict]:
    out = []
    for entry in raw.split(";"):
        parts = entry.split("|")
        if len(parts) != 3:
            continue
        try:
            out.append({"name": parts[0], "op": parts[1],
                        "age_sec": int(parts[2]) / 1e6})
        except ValueError:
            continue
    return out


def _parse_pending_coord(raw: str) -> List[dict]:
    out = []
    for entry in raw.split(";"):
        parts = entry.split("|")
        if len(parts) != 3:
            continue
        try:
            out.append({"name": parts[0], "age_sec": int(parts[1]) / 1e6,
                        "missing_ranks": [int(r) for r in parts[2].split()
                                          if r]})
        except ValueError:
            continue
    return out


def written_path() -> Optional[str]:
    """Path of the dump this process wrote, if any (tests, reports).
    None while no dump exists — including mid-write, when the slot is
    claimed but the file is not on disk yet."""
    return _written_path or None


def _resolve_rank() -> int:
    from horovod_tpu_torch import common

    lib = common._lib
    if lib is not None and lib.hvd_tpu_initialized():
        return int(lib.hvd_tpu_rank())
    try:
        return int(os.environ.get("HVD_TPU_RANK") or 0)
    except ValueError:
        return 0


def write_postmortem(reason: str,
                     exc: Optional[BaseException] = None) -> Optional[str]:
    """Write this rank's postmortem dump; returns its path, or None when
    the dir is unset or a dump was already written (first death wins).
    Never raises: a failing dump writer must not mask the real error."""
    global _written_path
    directory = postmortem_dir()
    if not directory:
        return None
    with _write_lock:
        if _written_path is not None:
            return None
        _written_path = ""  # claim before the slow work below
    try:
        path = _write(directory, reason, exc)
        with _write_lock:
            _written_path = path
        return path
    except Exception as write_exc:  # pragma: no cover - best effort
        import warnings

        # Release the claim: a transient failure (dir briefly unwritable)
        # must not stop a later death path from leaving the artifact.
        with _write_lock:
            _written_path = None
        warnings.warn(f"could not write postmortem dump: {write_exc}")
        return None


def _write(directory: str, reason: str,
           exc: Optional[BaseException]) -> str:
    from horovod_tpu_torch import common

    lib = common._lib
    rank = _resolve_rank()
    engine_up = lib is not None and bool(lib.hvd_tpu_initialized())
    doc = {
        "schema": 1,
        "rank": rank,
        "size": int(lib.hvd_tpu_size()) if engine_up else 0,
        "restart_epoch": common.restart_epoch(),
        "membership_epoch": common.membership_epoch(),
        "reason": reason,
        "written_unix": time.time(),
    }
    if exc is not None:
        doc["exception"] = {"type": type(exc).__name__,
                            "message": str(exc)[:4000]}
    if lib is not None:
        doc["abort"] = {"code": int(lib.hvd_tpu_abort_code()),
                        "message": lib.hvd_tpu_abort_message().decode()}
        diag = lib.hvd_tpu_diagnosis().decode()
        # Workers receive the diagnosis inside the broadcast abort
        # message; Diagnosis() extracts the paragraph on every rank.
        doc["diagnosis"] = diag or None
        doc["ring"] = {
            "engine": parse_engine_ring(lib.hvd_tpu_flight_dump().decode()),
            "xla": plane_ring.drain(),
        }
        doc["pending"] = {
            "local": _parse_pending_local(
                lib.hvd_tpu_pending_info().decode()),
            "coordinator": _parse_pending_coord(
                lib.hvd_tpu_coord_pending_info().decode()),
        }
    else:
        doc["abort"] = {"code": 0, "message": ""}
        doc["diagnosis"] = None
        doc["ring"] = {"engine": [], "xla": plane_ring.drain()}
        doc["pending"] = {"local": [], "coordinator": []}
    try:
        doc["autotune"] = common.autotune_report()
    except Exception:
        doc["autotune"] = {}
    # The state plane: the last committed snapshot step and the peer
    # copy's freshness say how much work this death cost.
    try:
        from horovod_tpu_torch import state as _state

        plane = _state.current()
        doc["state"] = plane.status() if plane is not None else None
    except Exception:
        doc["state"] = None
    try:
        doc["metrics"] = common.metrics_snapshot()
    except Exception:
        doc["metrics"] = {}
    # Active data-plane transport, top-level: which path (shm rings vs TCP
    # sockets) the node-local hops ran on, and per peer — so the failure
    # report and renderer answer "was shared memory in play?" without
    # digging through the embedded metrics snapshot.
    metrics = doc["metrics"] if isinstance(doc["metrics"], dict) else {}
    doc["transport"] = {
        "local": str(metrics.get("topology", {})
                     .get("local_transport", "tcp")),
        "peers": {str(r): str(v.get("transport", "tcp"))
                  for r, v in metrics.get("links", {})
                                     .get("peers", {}).items()},
    }
    os.makedirs(directory, exist_ok=True)
    epoch = common.restart_epoch()
    suffix = f".e{epoch}" if epoch else ""
    path = os.path.join(directory, f"rank-{rank}{suffix}.json")
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    # Crashed ranks must leave their metrics too (the timeline already
    # flushes on these paths; the metrics file rides the same hook).
    common._flush_metrics_file(clear=False)
    print(f"[horovod_tpu_torch] postmortem dump written: {path}",
          file=sys.stderr, flush=True)
    return path


_REASON_BY_CODE = {6: "ranks_down", 7: "timeout"}


def reason_for_code(code: int) -> str:
    return _REASON_BY_CODE.get(int(code), f"abort_{int(code)}")


_excepthook_installed = False


def install_excepthook() -> None:
    """Chain a ``sys.excepthook`` that writes a postmortem for fatal
    uncaught exceptions (KeyboardInterrupt/SystemExit excluded: an
    operator ^C or a deliberate exit is not a postmortem)."""
    global _excepthook_installed
    if _excepthook_installed:
        return
    _excepthook_installed = True
    previous = sys.excepthook

    def hook(exc_type, exc, tb):
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            write_postmortem("exception", exc)
        previous(exc_type, exc, tb)

    sys.excepthook = hook


def dump_path_for(directory: str, rank: int) -> Optional[str]:
    """Newest existing dump for `rank` in `directory` (restart-epoch
    suffixed files included), or None."""
    import glob

    candidates = [os.path.join(directory, f"rank-{rank}.json")]
    candidates += sorted(
        glob.glob(os.path.join(directory, f"rank-{rank}.e*.json")))
    existing = [p for p in candidates if os.path.exists(p)]
    if not existing:
        return None
    return max(existing, key=os.path.getmtime)
