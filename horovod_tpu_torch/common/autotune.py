"""Online autotuning: Python seam over the engine's ParameterManager.

Own copy of ``horovod_tpu/common/autotune.py``, over the port's engine.

The engine's two dominant performance knobs — the tensor-fusion threshold
and the negotiation cycle time — defaulted to static env values no single
workload agrees on.  With ``HVD_TPU_AUTOTUNE=1`` the rank-0 coordinator
scores each tuning window from the throughput it already observes (payload
bytes of every negotiated collective / wall time over the window), walks a
coordinate-descent hill-climb over log-spaced candidate grids
(warmup -> climb -> freeze at the best point seen; engine/cc/autotune.cc),
and broadcasts each candidate inside the coordinator response list so
EVERY rank applies it at the same tick boundary — the lockstep-mutation
contract the negotiation response cache established.  See
``docs/performance.md`` ("Autotuning").

This module holds the Python half: the env-spec parsing ``hvd.init()``
feeds the engine, and the report/control helpers behind
``hvd.autotune_report()`` / ``hvd.autotune_set()``.  ``autotune_set`` is
the pluggable-policy seam: a custom policy runs wherever you like (rank
0), reads ``hvd.metrics_snapshot()``, and injects its own candidates —
the engine still does the lockstep broadcast, so every rank stays in
step no matter who proposes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# Candidate grids, mirrored from engine/cc/autotune.cc (keep in sync):
# log-spaced, spanning the negotiation-bound 32 B-allreduce regime to
# 100 MB CNN gradient buckets.  The compression axis is the CompressionMode
# codes by wire aggressiveness; it is searchable only when the job opted
# into compression (HVD_TPU_COMPRESSION != off) — the tuner must never
# turn a lossy wire format on for a job that asked for exact fp32.
FUSION_GRID: Tuple[int, ...] = tuple(
    v << 10 for v in (64, 256, 1024, 4096, 16384, 65536, 262144))
CYCLE_GRID_MS: Tuple[float, ...] = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0)
COMPRESSION_GRID: Tuple[str, ...] = ("off", "bf16", "fp8")
# The fourth axis (docs/performance.md#two-level-topology): the byte
# boundary under which a two-level bucket's cross-node hop takes the
# recursive-doubling tree instead of the ring.  Searchable only on the
# hierarchical topology — the flat ring pins it (dead knob).  The port's
# ring is always flat (the hierarchical allreduce is not ported), so
# ``init()`` refuses a pin of it.
CROSS_ALGO_GRID: Tuple[int, ...] = (0, 16 << 10, 64 << 10, 256 << 10,
                                    1 << 20)

# Knob names accepted by HVD_TPU_AUTOTUNE_FIX (and their report keys).
KNOBS = ("fusion_threshold", "cycle_time_ms", "compression",
         "cross_algo_threshold")


def parse_fix(spec: str) -> Tuple[int, float, int, int]:
    """Parse ``HVD_TPU_AUTOTUNE_FIX`` ("k=v,..." with knobs from
    :data:`KNOBS`) into the engine's pin values ``(fix_fusion_bytes,
    fix_cycle_ms, fix_compression_code, fix_cross_algo_bytes)``; -1 means
    "tune this knob".  Raises ``ValueError`` on unknown knobs or
    unparsable/negative values — a silently dropped pin would tune a knob
    the user asked to hold."""
    from horovod_tpu_torch.common.config import parse_compression

    fix_fusion, fix_cycle, fix_comp, fix_algo = -1, -1.0, -1, -1
    for clause in (spec or "").split(","):
        clause = clause.strip()
        if not clause:
            continue
        key, sep, value = clause.partition("=")
        key = key.strip()
        if not sep or key not in KNOBS:
            raise ValueError(
                f"HVD_TPU_AUTOTUNE_FIX: bad clause {clause!r} (want "
                f"k=v with k in {KNOBS})")
        if key == "compression":
            try:
                fix_comp = parse_compression(value)
            except ValueError:
                raise ValueError(
                    f"HVD_TPU_AUTOTUNE_FIX: bad value in {clause!r} "
                    f"(want compression=off|bf16|fp8)") from None
            continue
        try:
            num = float(value)
        except ValueError:
            raise ValueError(
                f"HVD_TPU_AUTOTUNE_FIX: bad value in {clause!r}") from None
        if num < 0:
            raise ValueError(
                f"HVD_TPU_AUTOTUNE_FIX: negative value in {clause!r}")
        if key == "fusion_threshold":
            fix_fusion = int(num)
        elif key == "cross_algo_threshold":
            fix_algo = int(num)
        else:
            fix_cycle = num
    return fix_fusion, fix_cycle, fix_comp, fix_algo


@dataclasses.dataclass(frozen=True)
class WindowRecord:
    """One scored tuning window (coordinator side): the parameters it ran
    under and the throughput score it measured (bytes+ops per second)."""
    window: int
    fusion_threshold: int
    cycle_time_ms: float
    score: float


def _parse_log(raw: str, fields) -> List[dict]:
    """Parse an engine "a|b|c|...;..." log into dicts; `fields` pairs each
    position with (name, converter).  Malformed entries are skipped — the
    C side writes them, so a mismatch means version skew, not user input."""
    out = []
    for entry in raw.split(";"):
        if not entry:
            continue
        parts = entry.split("|")
        if len(parts) != len(fields):
            continue
        try:
            out.append({name: conv(part)
                        for part, (name, conv) in zip(parts, fields)})
        except ValueError:
            continue
    return out


def _cycle_ms(us: str) -> float:
    return int(us) / 1000.0


def _comp_name(code: str) -> str:
    from horovod_tpu_torch.common.config import COMPRESSION_NAMES

    return COMPRESSION_NAMES.get(int(code), code)


_HISTORY_FIELDS = (("window", int), ("fusion_threshold", int),
                   ("cycle_time_ms", _cycle_ms),
                   ("compression", _comp_name),
                   ("cross_algo_threshold", int), ("score", float))
_APPLIED_FIELDS = (("tick", int), ("fusion_threshold", int),
                   ("cycle_time_ms", _cycle_ms),
                   ("compression", _comp_name),
                   ("cross_algo_threshold", int),
                   ("frozen", lambda v: v == "1"))


def report(lib) -> dict:
    """The autotuning report read from the (loaded) engine library:
    current applied parameters (lockstep — identical on every rank of a
    healthy job), freeze state, and the coordinator's per-window search
    history.  Workers see an empty ``history`` (the search runs at rank
    0) but a full ``applied`` log."""
    from horovod_tpu_torch.common.config import COMPRESSION_NAMES

    return {
        "enabled": bool(lib.hvd_tpu_autotune_enabled()),
        "frozen": bool(lib.hvd_tpu_autotune_frozen()),
        "windows": int(lib.hvd_tpu_autotune_windows()),
        "fusion_threshold": int(lib.hvd_tpu_autotune_fusion_threshold()),
        "cycle_time_ms": int(lib.hvd_tpu_autotune_cycle_time_us()) / 1000.0,
        "compression": COMPRESSION_NAMES.get(
            int(lib.hvd_tpu_compression_mode()), "off"),
        "cross_algo_threshold": int(
            lib.hvd_tpu_autotune_cross_algo_threshold()),
        "best_score": float(lib.hvd_tpu_autotune_best_score()),
        "history": _parse_log(
            lib.hvd_tpu_autotune_history().decode(), _HISTORY_FIELDS),
        "applied": _parse_log(
            lib.hvd_tpu_autotune_applied().decode(), _APPLIED_FIELDS),
    }


def empty_report() -> dict:
    """The report shape before any engine exists — keeps
    ``metrics_snapshot()["autotune"]`` structurally stable (ungated)."""
    return {"enabled": False, "frozen": False, "windows": 0,
            "fusion_threshold": 0, "cycle_time_ms": 0.0,
            "compression": "off", "cross_algo_threshold": 0,
            "best_score": 0.0, "history": [], "applied": []}


def set_params(lib, fusion_threshold: Optional[int] = None,
               cycle_time_ms: Optional[float] = None,
               compression: Optional[str] = None,
               cross_algo_threshold: Optional[int] = None) -> None:
    """Inject parameters for lockstep broadcast at the next tick (rank 0
    only — the coordinator owns the broadcast).  The engine applies them
    on every rank at the same tick boundary, exactly like search
    candidates; a live search resumes from the nearest grid point."""
    from horovod_tpu_torch.common.config import parse_compression

    if (fusion_threshold is None and cycle_time_ms is None
            and compression is None and cross_algo_threshold is None):
        raise ValueError(
            "autotune_set: provide fusion_threshold, cycle_time_ms, "
            "compression, and/or cross_algo_threshold")
    if fusion_threshold is not None and int(fusion_threshold) < 0:
        raise ValueError("autotune_set: fusion_threshold must be >= 0")
    if cycle_time_ms is not None and float(cycle_time_ms) < 0:
        raise ValueError("autotune_set: cycle_time_ms must be >= 0")
    if cross_algo_threshold is not None and int(cross_algo_threshold) < 0:
        raise ValueError("autotune_set: cross_algo_threshold must be >= 0")
    comp_code = -1
    if compression is not None:
        try:
            comp_code = parse_compression(compression)
        except ValueError:
            raise ValueError(
                f"autotune_set: unknown compression mode {compression!r} "
                f"(want off, bf16, or fp8)") from None
    rc = lib.hvd_tpu_autotune_set(
        -1 if fusion_threshold is None else int(fusion_threshold),
        -1.0 if cycle_time_ms is None else float(cycle_time_ms),
        comp_code,
        -1 if cross_algo_threshold is None else int(cross_algo_threshold))
    if rc == 1:
        raise ValueError(
            "autotune_set: only rank 0 (the coordinator) can inject "
            "parameters; run your tuning policy there.")
    if rc != 0:
        from horovod_tpu_torch.common import HorovodNotInitializedError

        raise HorovodNotInitializedError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
