"""horovod_tpu_torch's online autotuning against horovod_tpu's
(``common/autotune.py``; the tuner itself is the engine's
``autotune.cc``, the same C++ in both packages).

- ``parse_fix`` on a table of spellings, errors and their messages
  included; ``KNOBS`` and the four grids equal the reference's and the
  engine's (``engine/cc/autotune.cc``);
- ``empty_report`` and the registry's ungated ``autotune`` and
  ``compression`` sections equal the reference's, before and after the
  same mirror, and after ``reset()``;
- at np 4 from deliberately bad parameters (1 KiB threshold, 50 ms
  cycle, windows of 8): the tuner freezes, every rank applied the same
  sequence (tick, threshold, cycle, frozen) and holds the same frozen
  point, the threshold left the 1 KiB start.  Scores are wall-clock
  throughput, so the sequence is not compared with the reference's;
- ``HVD_TPU_AUTOTUNE_FIX``: a pinned cycle never moves while the
  threshold walks the grid; with every knob pinned (the compression axis
  too, under ``HVD_TPU_COMPRESSION=bf16``) the first broadcast carries
  the pins and freezes, as in the reference, whose applied values are
  compared;
- the tuner off: the default report, a manual ``autotune_set`` applied,
  its argument errors equal to the reference's; ``autotune_set`` is rank
  0's alone (np 2);
- the response cache across a threshold change at np 3
  (``tests/test_autotune.py``'s contract): the six steps after the warm-up
  are pure cache hits, completion ticks stay rank-identical, both
  applications logged identically on every rank.
"""

import functools
import json
import os
import re

import pytest
import torch

from tests.distributed import run_ranks
from tests.test_torch_engine import OUT_ENV, _launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _write(out_dir, tag, rank, obj):
    with open(os.path.join(out_dir, f"{tag}{rank}.json"), "w") as f:
        json.dump(obj, f)


def _read(out_dir, tag, np_):
    out = []
    for r in range(np_):
        with open(os.path.join(out_dir, f"{tag}{r}.json")) as f:
            out.append(json.load(f))
    return out


def _applied(rep, keys=("tick", "fusion_threshold", "cycle_time_ms",
                        "frozen")):
    return [[a[k] for k in keys] for a in rep["applied"]]


# --- units -----------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "", " ", "fusion_threshold=1024", "cycle_time_ms=2.5",
    "fusion_threshold=8192, cycle_time_ms=5", "compression=bf16",
    "compression=fp8", "compression=off, cycle_time_ms=5",
    "compression=BFLOAT16", "cross_algo_threshold=65536",
    "cross_algo_threshold=0", "fusion_threshold=1e6", "warmup=3",
    "cycle_time_ms", "cycle_time_ms=fast", "compression=int4",
    "fusion_threshold=-1", "cross_algo_threshold=-1", ",,cycle_time_ms=1,"])
def test_parse_fix_matches_the_reference(spec):
    from horovod_tpu.common import autotune as ref
    from horovod_tpu_torch.common import autotune as port

    def outcome(mod):
        try:
            return mod.parse_fix(spec)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert outcome(port) == outcome(ref)


def test_grids_match_the_reference_and_the_engine():
    from horovod_tpu.common import autotune as ref
    from horovod_tpu_torch.common import autotune as port

    for name in ("KNOBS", "FUSION_GRID", "CYCLE_GRID_MS",
                 "COMPRESSION_GRID", "CROSS_ALGO_GRID"):
        assert getattr(port, name) == getattr(ref, name), name
    with open(os.path.join(REPO, "horovod_tpu_torch", "engine", "cc",
                           "autotune.cc")) as f:
        cc = f.read()

    def grid(var):
        body = re.search(var + r"\s*=\s*\{([^}]*)\}", cc).group(1)
        return [eval(tok.strip()) for tok in body.split(",") if tok.strip()]

    assert tuple(grid("kFusionGrid")) == port.FUSION_GRID
    assert tuple(grid("kCycleGridMs")) == port.CYCLE_GRID_MS
    assert tuple(grid("kCrossAlgoGrid")) == port.CROSS_ALGO_GRID
    from horovod_tpu_torch.common.config import COMPRESSION_NAMES

    assert tuple(COMPRESSION_NAMES[c] for c in grid("kCompressionGrid")) \
        == port.COMPRESSION_GRID


def test_report_and_snapshot_sections_match_the_reference():
    from horovod_tpu.common import autotune as ref_at
    from horovod_tpu.common import metrics as ref_m
    from horovod_tpu_torch.common import autotune as port_at
    from horovod_tpu_torch.common import metrics as port_m

    assert port_at.empty_report() == ref_at.empty_report()
    regs = (port_m.MetricsRegistry(), ref_m.MetricsRegistry())

    def sections():
        return [{k: reg.snapshot()[k] for k in ("autotune", "compression")}
                for reg in regs]

    got, want = sections()
    assert got == want
    report = dict(port_at.empty_report(), enabled=True, windows=2,
                  fusion_threshold=4096, cycle_time_ms=2.5,
                  history=[{"window": 1, "fusion_threshold": 4096,
                            "cycle_time_ms": 2.5, "compression": "off",
                            "cross_algo_threshold": 65536, "score": 10.0}])
    comp = {"mode": "bf16", "min_bytes": 1024,
            "planes": {"engine": {"wire_bytes": 512, "payload_bytes": 1024,
                                  "ops": {"none": 1, "bf16": 3, "fp8": 0}}},
            "residual_bytes": 4096, "residual_tensors": 2}
    for reg in regs:
        reg.set_autotune(report)
        reg.set_compression(comp)
    got, want = sections()
    assert got == want and got["autotune"]["windows"] == 2
    assert json.loads(json.dumps(got)) == got
    for reg in regs:
        reg.reset()
    got, want = sections()
    assert got == want and got["autotune"] == port_at.empty_report()


# --- lockstep convergence at np 4 ------------------------------------------


def _convergence_rank(out_dir):
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    frozen_at = None
    for s in range(400):
        for k in range(6):
            out = hvd.allreduce(torch.full((256,), float(r + k + s)),
                                average=False, name=f"grad.{k}")
            want = sum(float(i + k + s) for i in range(n))
            assert torch.equal(out, torch.full((256,), want)), (r, s, k)
        # A collective poll: the ranks see the freeze at different times.
        f = torch.tensor([int(hvd.autotune_report()["frozen"])],
                         dtype=torch.int32)
        if int(hvd.allreduce(f, average=False, name="at.poll")[0]) == n:
            frozen_at = s
            break
    from horovod_tpu_torch import common

    rep = hvd.autotune_report()
    snap = common.metrics_snapshot()["autotune"]
    _write(out_dir, "conv", r, {
        "frozen_at": frozen_at, "report": rep,
        "final": [snap["fusion_threshold"], snap["cycle_time_ms"],
                  snap["frozen"]]})
    hvd.shutdown()


def test_lockstep_convergence_from_bad_parameters(tmp_path):
    _launch(functools.partial(_convergence_rank, str(tmp_path)), 4,
            timeout=150, HVD_TPU_AUTOTUNE="1", HVD_TPU_AUTOTUNE_WINDOW="8",
            HVD_TPU_AUTOTUNE_WARMUP="1", HVD_TPU_FUSION_THRESHOLD="1024",
            HVD_TPU_CYCLE_TIME_MS="50")
    runs = _read(tmp_path, "conv", 4)
    rep = runs[0]["report"]
    assert runs[0]["frozen_at"] is not None
    assert rep["enabled"] and rep["frozen"], rep["windows"]
    assert rep["fusion_threshold"] >= 64 * 1024, rep["fusion_threshold"]
    assert 0 < rep["cycle_time_ms"] <= 50.0
    assert rep["applied"] and rep["compression"] == "off"
    for run in runs:
        assert _applied(run["report"]) == _applied(rep)
        assert run["final"] == runs[0]["final"] == [
            rep["fusion_threshold"], rep["cycle_time_ms"], True]
    # The coordinator alone carries the search's history.
    assert len(rep["history"]) == rep["windows"] > 0
    assert rep["best_score"] > 0
    assert all(run["report"]["history"] == [] for run in runs[1:])


# --- pins, the tuner off, manual injection ---------------------------------


def _pins(hvd, top, init, out_dir, tag):
    """Steps until every rank sees the tuner frozen (or 600); the report,
    and the wire mode of a float32 allreduce after it."""
    init()
    n = top.size()
    for s in range(600):
        for k in range(4):
            hvd.allreduce(torch.ones(128), average=False, name=f"p{k}")
        f = torch.tensor([int(top.autotune_report()["frozen"])],
                         dtype=torch.int32)
        if int(hvd.allreduce(f, average=False, name="at.poll")[0]) == n:
            break
    hvd.allreduce(torch.ones(4096), average=False, name="after")
    log = top.compression_report()["log"]
    _write(out_dir, tag, top.rank(), {"report": top.autotune_report(),
                                      "after": log[-1]})
    top.shutdown()


def _port_pins(out_dir):
    import horovod_tpu_torch as top
    import horovod_tpu_torch.torch as hvd

    _pins(hvd, top, lambda: top.init(device="cpu"), out_dir, "port")


def _ref_pins():
    import horovod_tpu as top
    import horovod_tpu.torch as hvd

    _pins(hvd, top, top.init, os.environ[OUT_ENV], "ref")


_PINS = {
    "cycle": dict(HVD_TPU_AUTOTUNE_WARMUP="1",
                  HVD_TPU_AUTOTUNE_FIX="cycle_time_ms=5"),
    "all": dict(HVD_TPU_AUTOTUNE_WARMUP="0", HVD_TPU_COMPRESSION="bf16",
                HVD_TPU_COMPRESSION_MIN_BYTES="64",
                HVD_TPU_AUTOTUNE_FIX="fusion_threshold=123456,"
                                     "cycle_time_ms=2,compression=fp8"),
}


@pytest.mark.parametrize("case,np_", [("all", 2), ("cycle", 1)])
def test_pins_hold_as_in_the_reference(case, np_, tmp_path, monkeypatch):
    from horovod_tpu_torch.common.autotune import FUSION_GRID

    env = dict(_PINS[case], HVD_TPU_AUTOTUNE="1", HVD_TPU_AUTOTUNE_WINDOW="4")
    _launch(functools.partial(_port_pins, str(tmp_path)), np_, timeout=90,
            **env)
    runs = _read(tmp_path, "port", np_)
    got = runs[0]
    rep = got["report"]
    for run in runs[1:]:
        assert _applied(run["report"]) == _applied(rep)
    assert rep["frozen"], rep["windows"]
    if case == "cycle":
        # The pinned knob never moved; the free one walked the grid.
        for a in rep["applied"]:
            assert a["cycle_time_ms"] == 5.0, a
            assert a["fusion_threshold"] in FUSION_GRID, a
        assert rep["cycle_time_ms"] == 5.0
        return
    # Every knob pinned: one broadcast, carrying the pins, frozen; the
    # compression axis moved the wire to fp8.  The reference's run of the
    # same program applies the same values.
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_pins, np_, timeout=90)
    want = _read(tmp_path, "ref", np_)[0]
    keys = ("fusion_threshold", "cycle_time_ms", "compression", "frozen")
    assert _applied(rep, keys) == _applied(want["report"], keys) == [
        [123456, 2.0, "fp8", True]]
    for k in keys:
        assert rep[k] == want["report"][k], k
    assert got["after"] == want["after"] == {"name": "after", "mode": "fp8"}


def _default_off(hvd, top, init, out_path):
    from horovod_tpu_torch.common.config import DEFAULT_FUSION_THRESHOLD

    init()
    for k in range(3):
        hvd.allreduce(torch.ones(16), average=False, name=f"d{k}")
    rep = top.autotune_report()
    assert not rep["enabled"] and not rep["frozen"], rep
    assert rep["applied"] == [] and rep["history"] == [], rep
    assert rep["fusion_threshold"] == DEFAULT_FUSION_THRESHOLD, rep
    top.autotune_set(cycle_time_ms=2.0)
    for s in range(50):
        hvd.allreduce(torch.ones(16), average=False, name="d0")
        rep = top.autotune_report()
        if rep["applied"]:
            break
    errors = []
    for kwargs in ({}, {"fusion_threshold": -5}, {"cycle_time_ms": -1.0},
                   {"cross_algo_threshold": -1}, {"compression": "int4"}):
        try:
            top.autotune_set(**kwargs)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    with open(out_path, "w") as f:
        json.dump({"report": rep, "errors": errors}, f)
    top.shutdown()


def _port_default_off(out_path):
    import horovod_tpu_torch as top
    import horovod_tpu_torch.torch as hvd

    _default_off(hvd, top, lambda: top.init(device="cpu"), out_path)


def _ref_default_off():
    import horovod_tpu as top
    import horovod_tpu.torch as hvd

    _default_off(hvd, top, top.init, os.environ[OUT_ENV])


def test_default_off_and_manual_set_match_the_reference(tmp_path,
                                                        monkeypatch):
    from horovod_tpu_torch.common.config import DEFAULT_FUSION_THRESHOLD

    port_out, ref_out = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    _launch(functools.partial(_port_default_off, port_out), 1, timeout=60)
    monkeypatch.setenv(OUT_ENV, ref_out)
    run_ranks(_ref_default_off, 1, timeout=60)
    with open(port_out) as f:
        got = json.load(f)
    with open(ref_out) as f:
        want = json.load(f)
    rep = got["report"]
    assert rep["applied"], "injection never applied"
    keys = ("fusion_threshold", "cycle_time_ms", "compression", "frozen")
    assert _applied(rep, keys) == _applied(want["report"], keys) == [
        [DEFAULT_FUSION_THRESHOLD, 2.0, "off", False]]
    assert rep["cycle_time_ms"] == 2.0 and not rep["frozen"]
    assert got["errors"] == want["errors"] and None not in got["errors"]


def _rank0_only_rank():
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    if hvd.rank() == 0:
        hvd.autotune_set(cycle_time_ms=5.0)
    else:
        with pytest.raises(ValueError, match="rank 0"):
            hvd.autotune_set(cycle_time_ms=5.0)
    hvd.allreduce(torch.ones(4), average=False, name="sync")
    hvd.shutdown()


def test_autotune_set_is_rank0_only():
    _launch(_rank0_only_rank, 2, timeout=60)


def test_autotune_set_before_init_raises(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    with pytest.raises(hvd.common.HorovodNotInitializedError):
        hvd.autotune_set(cycle_time_ms=5.0)


# --- the response cache across a threshold change --------------------------


def _cache_rank(out_dir):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import common

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()

    def step(s):
        hs = [hvd.allreduce_async(torch.full((64,), float(r + i + s)),
                                  average=False, name=f"cw.{i}")
              for i in range(16)]
        ticks = []
        for i, h in enumerate(hs):
            out = hvd.synchronize(h)
            want = sum(float(j + i + s) for j in range(n))
            assert torch.equal(out, torch.full((64,), want)), (r, s, i)
            ticks.append(h.completion_tick)
        return ticks

    for s in range(3):  # warm: the cache holds every name
        step(s)
    warm = common.metrics_snapshot()["cache"]["engine"]
    ticks = {}
    if r == 0:  # below one tensor (256 B): every replay splits
        hvd.autotune_set(fusion_threshold=64)
    for s in range(3, 6):
        ticks[s] = step(s)
    if r == 0:  # and back up: replays re-fuse
        hvd.autotune_set(fusion_threshold=64 * 1024 * 1024)
    for s in range(6, 9):
        ticks[s] = step(s)
    c = common.metrics_snapshot()["cache"]["engine"]
    _write(out_dir, "cache", r, {
        "hits": c["hits"] - warm["hits"],
        "misses": c["misses"] - warm["misses"], "ticks": ticks,
        "applied": _applied(hvd.autotune_report(),
                            ("tick", "fusion_threshold"))})
    hvd.shutdown()


def test_cache_stays_in_lockstep_across_a_threshold_change(tmp_path):
    _launch(functools.partial(_cache_rank, str(tmp_path)), 3, timeout=90)
    runs = _read(tmp_path, "cache", 3)
    for run in runs:
        # The six steps after the warm-up are pure hits (16 names x 6):
        # the threshold changes invalidated nothing.
        assert (run["hits"], run["misses"]) == (96, 0), run
        assert run["ticks"] == runs[0]["ticks"]
        assert run["applied"] == runs[0]["applied"]
    thresholds = [t for _, t in runs[0]["applied"]]
    assert thresholds == [64, 64 * 1024 * 1024], runs[0]["applied"]
