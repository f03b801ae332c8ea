"""Deterministic fault injection at collective boundaries.

Own copy of ``horovod_tpu/common/faults.py``.  ``HVD_TPU_FAULT_SPEC``
says which rank misbehaves, how, and at which of its collectives; the
injector fires when that collective is submitted, on the caller's thread
(``common._fault_hook``, called by the collective entry points of
``common`` and, for CUDA tensors, by ``torch/mpi_ops.py`` before the
tensor is staged: never on the staging thread).

Spec grammar (clauses separated by ``;`` or ``,``)::

    rank=<r>:<action>@op=<n>[@epoch=<e>]

    rank=1:crash@op=12          # rank 1 exits hard (no shutdown handshake)
                                # instead of submitting its 12th collective
    rank=2:hang@op=5            # rank 2's Python wedges forever at its 5th
                                # (the engine thread keeps ticking)
    rank=1:delay=3.0@op=7       # rank 1 sleeps 3 s, then proceeds
    rank=2:freeze@op=5          # SIGSTOPs the whole process: engine thread
                                # included, so sockets stay open but go
                                # silent (the liveness-probe case)

``op`` counts the rank's submitted collectives from 0, in program order:
allreduce, allgather, broadcast, send and recv alike, named or not,
internal ones (the elastic resync's ``__elastic.sync.*``, the state
plane's ``__state.*``) included, as the reference counts them.  A clause
without ``epoch=`` fires only on the first run (``HVD_TPU_RESTART_EPOCH``
0), so a job under ``--max-restarts`` crashes once, restarts and trains
through.

Every firing is recorded in the metrics registry
(``metrics_snapshot()["faults"]["injected"]``), whether or not metrics
are enabled.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

from horovod_tpu_torch.common import metrics

_ACTIONS = ("crash", "hang", "delay", "freeze")

# Exit code of an injected crash: distinctive in launcher reports, and
# outside the shell's 126/127/128+signal conventions.
CRASH_EXIT_CODE = 43


@dataclasses.dataclass(frozen=True)
class Fault:
    rank: int
    action: str  # "crash" | "hang" | "delay" | "freeze"
    op: int      # 0-based index of the rank's submitted collectives
    delay_sec: float = 0.0
    epoch: int = 0  # the HVD_TPU_RESTART_EPOCH this clause fires on


def parse_spec(spec: str) -> List[Fault]:
    """Parse ``HVD_TPU_FAULT_SPEC``; a syntax error raises ``ValueError``
    naming the clause (a fault spec silently ignored would make a red
    test green)."""
    faults: List[Fault] = []
    for raw in spec.replace(",", ";").split(";"):
        clause = raw.strip()
        if not clause:
            continue
        try:
            head, _, tail = clause.partition(":")
            key, _, rank_s = head.partition("=")
            if key.strip() != "rank":
                raise ValueError("expected 'rank=<r>:'")
            rank = int(rank_s)
            parts = tail.split("@")
            action, _, delay_s = parts[0].strip().partition("=")
            action = action.strip()
            if action not in _ACTIONS:
                raise ValueError(f"unknown action '{action}'")
            delay = float(delay_s) if delay_s else 0.0
            if action == "delay" and not delay_s:
                raise ValueError("delay needs a duration: delay=<sec>")
            op: Optional[int] = None
            epoch = 0
            for term in parts[1:]:
                tkey, _, tval = term.partition("=")
                tkey = tkey.strip()
                if tkey == "op":
                    op = int(tval)
                elif tkey == "epoch":
                    epoch = int(tval)
                else:
                    raise ValueError(f"unknown term '@{tkey}'")
            if op is None:
                raise ValueError("missing '@op=<n>'")
            faults.append(Fault(rank=rank, action=action, op=op,
                                delay_sec=delay, epoch=epoch))
        except ValueError as exc:
            raise ValueError(
                f"bad HVD_TPU_FAULT_SPEC clause '{clause}': {exc}") from None
    return faults


class FaultInjector:
    """The faults of one (rank, restart epoch), keyed by op index.
    ``on_collective`` returns at once (one dict lookup) or fires.  The
    op counter that drives it is serialized by the caller."""

    def __init__(self, faults: List[Fault], rank: int, epoch: int):
        self._by_op = {f.op: f for f in faults
                       if f.rank == rank and f.epoch == epoch}
        self._rank = rank

    def __bool__(self) -> bool:
        return bool(self._by_op)

    def on_collective(self, op_index: int, name: str) -> None:
        fault = self._by_op.get(op_index)
        if fault is None:
            return
        metrics.registry.record_fault(fault.action)
        print(f"[horovod_tpu_torch] FAULT INJECTION: rank {self._rank} "
              f"{fault.action} at op {op_index} ('{name}')",
              file=sys.stderr, flush=True)
        if fault.action == "crash":
            # The trace must still parse after an injected crash: flush
            # this rank's timeline before dying.
            try:
                from horovod_tpu_torch import common as _common

                if _common._lib is not None:
                    _common._lib.hvd_tpu_timeline_flush()
            except Exception:
                pass
            # Hard death: no shutdown handshake, the sockets drop and the
            # coordinator sees EOF, as for a SIGKILLed rank.
            os._exit(CRASH_EXIT_CODE)
        elif fault.action == "freeze":
            import signal

            os.kill(os.getpid(), signal.SIGSTOP)
        elif fault.action == "hang":
            while True:
                time.sleep(3600.0)
        else:  # delay
            time.sleep(fault.delay_sec)


def from_env(rank: int) -> Optional[FaultInjector]:
    """This rank's injector from the environment; None when no clause
    applies (the hot path then pays one ``is not None``)."""
    from horovod_tpu_torch.common.config import Config

    cfg = Config.from_env()
    if not cfg.fault_spec:
        return None
    injector = FaultInjector(parse_spec(cfg.fault_spec), rank,
                             cfg.restart_epoch)
    return injector if injector else None
