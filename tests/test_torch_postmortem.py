"""horovod_tpu_torch's postmortem plane against horovod_tpu's.

- The Python flight ring and the engine ring's parser: the reference's
  cases on the port's, and both packages fed the same events.
- The engine's flight recorder in a size-1 port job, mirrored into the
  snapshot's ``flight`` section.
- An injected crash at np 2 (``HVD_TPU_FAULT_SPEC``) under both packages'
  launchers: every rank leaves ``rank-<N>.json`` and its metrics file;
  the reasons, abort codes, pending tables and the engine rings' events
  on the job's collectives equal the reference's; rank 0's diagnosis
  names the dead rank; ``tools/postmortem_dump.py`` renders the port's
  directory, and the port's ``failure_report`` points at the crashed
  rank's dump.
- A hang at np 2 under a 2 s collective timeout: the survivor's dump
  carries the coordinator's cross-rank diagnosis, as the reference's
  (whose own case at np 4 is marked slow).
- ``failure_report``'s pointers on the reference's fake dumps, equal to
  the reference's report; the dump on a fatal uncaught exception.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.torch_watch import ENV, watched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    """Both engines built before any timed launch."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _env(**overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **ENV,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.setdefault("HVD_TPU_KILL_GRACE_SEC", "3")
    # One intra-op thread a rank: the CPU is shared with other workers.
    env.setdefault("OMP_NUM_THREADS", "1")
    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_FAULT_SPEC", "HVD_TPU_METRICS",
                "HVD_TPU_RESTART_EPOCH", "HVD_TPU_POSTMORTEM_DIR",
                "HVD_TPU_MONITOR_PORT", "HVD_TPU_METRICS_FILE"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in overrides.items()})
    return env


# The same program in both packages: six named allreduces, the survivors
# catching the typed abort; ``coord_pending()`` lists the names in the
# coordinator's pending table (on rank 0).
_PROGRAM = {
    "ref": ("import numpy as np, horovod_tpu as hvd\n"
            "from horovod_tpu.common import {error}, _load_lib\n"
            "from horovod_tpu.common.postmortem import "
            "_parse_pending_coord\n"
            "hvd.init()\n"
            "def op(i):\n"
            "    hvd.allreduce(np.ones(8, np.float32), name=f'step.{{i}}')\n"),
    "port": ("import torch, horovod_tpu_torch as hvd\n"
             "from horovod_tpu_torch.common import {error}, allreduce, "
             "_load_lib\n"
             "from horovod_tpu_torch.common.postmortem import "
             "_parse_pending_coord\n"
             "hvd.init(device='cpu')\n"
             "def op(i):\n"
             "    allreduce(torch.ones(8), name=f'step.{{i}}')\n"),
}
_PROGRAM = {pkg: prog + (
    "def coord_pending():\n"
    "    raw = _load_lib().hvd_tpu_coord_pending_info().decode()\n"
    "    return [p['name'] for p in _parse_pending_coord(raw)]\n")
    for pkg, prog in _PROGRAM.items()}


def _run(pkg, body, np_, error, timeout=90.0, **env):
    if pkg == "ref":
        from horovod_tpu.runner import run_command
    else:
        from horovod_tpu_torch.runner import run_command
    code = _PROGRAM[pkg].format(error=error) + body
    with watched(timeout + 10, f"{pkg} job at np {np_}"):
        return run_command([sys.executable, "-c", code], np_,
                           env=_env(**env), timeout=timeout, capture=True)


def _job_events(dump):
    """The engine ring's events on the job's own collectives, and its
    aborts: what both packages record alike (idle ticks and the
    reference's init-time plane agreement aside)."""
    return [(e["event"], e["name"]) for e in dump["ring"]["engine"]
            if e["name"].startswith("step.") or e["event"] == "abort"]


# ---------------------------------------------------------------------------
# Flight rings.
# ---------------------------------------------------------------------------


def test_flight_ring_bounded_and_ordered():
    from horovod_tpu.common.postmortem import FlightRing as Ref
    from horovod_tpu_torch.common.postmortem import FlightRing

    rings = (FlightRing(capacity=4), Ref(capacity=4))
    for ring in rings:
        for i in range(10):
            ring.record("enqueue", f"t{i}", i)
    events = rings[0].drain()
    assert len(events) == 4
    assert rings[0].total == 10
    assert [e["name"] for e in events] == ["t6", "t7", "t8", "t9"]
    assert [e["seq"] for e in events] == [6, 7, 8, 9]
    ts = [e["ts_us"] for e in events]
    assert ts == sorted(ts)
    strip = [[{k: v for k, v in e.items() if k != "ts_us"}
              for e in ring.drain()] for ring in rings]
    assert strip[0] == strip[1]
    disabled = FlightRing(capacity=0)
    disabled.record("enqueue", "x")
    assert not disabled.enabled and disabled.drain() == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_engine_ring(seed):
    from horovod_tpu.common import postmortem as ref
    from horovod_tpu_torch.common import postmortem

    raw = "0|100|enqueue|grad_37|5;1|200|execute|grad_37|2;bad;x|y"
    assert postmortem.parse_engine_ring(raw) == [
        {"seq": 0, "ts_us": 100, "event": "enqueue", "name": "grad_37",
         "arg": 5},
        {"seq": 1, "ts_us": 200, "event": "execute", "name": "grad_37",
         "arg": 2},
    ]
    assert postmortem.parse_engine_ring("") == []
    # Random rings, malformed entries among them, and the pending tables.
    rng = np.random.RandomState(seed)
    entries = []
    for i in range(40):
        kind = rng.randint(4)
        if kind == 0:
            entries.append(f"{i}|{rng.randint(1e6)}|"
                           f"{rng.choice(postmortem.EVENTS)}|"
                           f"g{rng.randint(9)}|{rng.randint(-3, 9)}")
        elif kind == 1:
            entries.append(f"{i}|x|tick||0")
        elif kind == 2:
            entries.append(f"g{i}|allreduce|{rng.randint(1e7)}")
        else:
            entries.append(f"g{i}|{rng.randint(1e7)}|"
                           + " ".join(str(r) for r in rng.randint(8, size=2)))
    raw = ";".join(entries)
    assert postmortem.parse_engine_ring(raw) == ref.parse_engine_ring(raw)
    assert (postmortem._parse_pending_local(raw)
            == ref._parse_pending_local(raw))
    assert (postmortem._parse_pending_coord(raw)
            == ref._parse_pending_coord(raw))
    for code in (6, 7, 3):
        assert postmortem.reason_for_code(code) == ref.reason_for_code(code)
    assert postmortem.EVENTS == ref.EVENTS


def test_engine_flight_recorder_records(monkeypatch):
    """The engine's ring records a collective's story (enqueue, announce,
    execute, tick) in a size-1 port job, and the snapshot's ``flight``
    section mirrors its count."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import common
    from horovod_tpu_torch.common import postmortem

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_FLIGHT_EVENTS"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        for i in range(3):
            common.allreduce(torch.ones(4), name=f"fl.{i}")
        events = postmortem.parse_engine_ring(
            common._lib.hvd_tpu_flight_dump().decode())
        snap = hvd.metrics_snapshot()
    finally:
        hvd.shutdown()
    kinds = [e["event"] for e in events]
    for expected in ("enqueue", "announce", "execute", "tick"):
        assert expected in kinds, kinds
    names = {e["name"] for e in events if e["event"] == "enqueue"}
    assert {"fl.0", "fl.1", "fl.2"} <= names, names
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs)
    assert snap["flight"]["events"]["engine"] >= len(events)
    assert snap["flight"]["events"]["xla"] == 0
    assert snap["flight"]["capacity"] == 512


# ---------------------------------------------------------------------------
# Crash and hang postmortems at np 2, against the reference's.
# ---------------------------------------------------------------------------

# Rank 1 crashes at its op 3 only once the coordinator (rank 0) lists
# rank 0's step.3 as pending: a thread of rank 0 touches the mark file
# then.  Without that order, rank 1's death can reach rank 0's engine
# before rank 0 announces step.3, and rank 0's dump then holds no pending
# step.3 (seen under six busy pytest workers).
_CRASH_BODY = ("import os, threading, time\n"
               "mark = os.environ['PM_TEST_MARK']\n"
               "def announced(name):\n"
               "    while name not in coord_pending():\n"
               "        time.sleep(0.001)\n"
               "    open(mark, 'w').close()\n"
               "def wait_for_mark():\n"
               "    deadline = time.monotonic() + 60\n"
               "    while not os.path.exists(mark):\n"
               "        if time.monotonic() > deadline:\n"
               "            raise SystemExit(8)\n"
               "        time.sleep(0.005)\n"
               "try:\n"
               "    for i in range(6):\n"
               "        if i == 3 and hvd.rank() == 0:\n"
               "            threading.Thread(target=announced,\n"
               "                             args=('step.3',),\n"
               "                             daemon=True).start()\n"
               "        elif i == 3:\n"
               "            wait_for_mark()\n"
               "        op(i)\n"
               "    raise SystemExit(9)\n"
               "except RanksDownError:\n"
               "    raise SystemExit(0)\n")


def _crash_run(pkg, tmp_path):
    pm = str(tmp_path / f"pm_{pkg}")
    metrics_file = str(tmp_path / f"m_{pkg}.json")
    results = _run(pkg, _CRASH_BODY, 2, "RanksDownError",
                   HVD_TPU_FAULT_SPEC="rank=1:crash@op=3",
                   HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20",
                   HVD_TPU_POSTMORTEM_DIR=pm,
                   HVD_TPU_METRICS_FILE=metrics_file,
                   PM_TEST_MARK=str(tmp_path / f"announced_{pkg}"))
    codes = {r.rank: r.returncode for r in results}
    assert codes == {0: 0, 1: 43}, [(r.rank, r.returncode, r.stderr[-800:])
                                    for r in results]
    dumps = {}
    for r in range(2):
        with open(os.path.join(pm, f"rank-{r}.json")) as f:
            dumps[r] = json.load(f)
        # The crashed rank's metrics file too: os._exit skips atexit.
        with open(f"{metrics_file}.{r}") as f:
            snap = json.load(f)
        assert "flight" in snap and "ops" in snap
    return results, pm, dumps


def test_crash_postmortem_dumps(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import postmortem_dump

    from horovod_tpu_torch.runner import failure_report

    results, pm, dumps = _crash_run("port", tmp_path)
    _, _, refs = _crash_run("ref", tmp_path)
    assert sorted(dumps[0]) == sorted(refs[0])
    for r in range(2):
        d, ref = dumps[r], refs[r]
        assert (d["reason"], d["rank"], d["size"], d["membership_epoch"]) \
            == (ref["reason"], ref["rank"], ref["size"],
                ref["membership_epoch"])
        assert d["abort"]["code"] == ref["abort"]["code"]
        assert [p["name"] for p in d["pending"]["local"]] == \
            [p["name"] for p in ref["pending"]["local"]]
        assert [(p["name"], p["missing_ranks"])
                for p in d["pending"]["coordinator"]] == \
            [(p["name"], p["missing_ranks"])
             for p in ref["pending"]["coordinator"]]
        assert _job_events(d) == _job_events(ref), (r, _job_events(d))
        assert d["transport"] == ref["transport"]
    assert dumps[1]["reason"] == "fault_crash"
    assert [e["name"] for e in dumps[1]["ring"]["engine"]
            if e["event"] == "enqueue"][-1] == "step.2"
    assert dumps[0]["reason"] == "ranks_down"
    assert dumps[0]["abort"]["code"] == 6  # ST_RANKS_DOWN
    assert "rank 1" in dumps[0]["diagnosis"], dumps[0]["diagnosis"]
    assert any(p["name"] == "step.3" and p["missing_ranks"] == [1]
               for p in dumps[0]["pending"]["coordinator"])
    # The renderer reads the port's directory as it reads the reference's.
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "postmortem_dump.py"),
         pm], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "2 dump(s)" in proc.stdout, proc.stdout
    assert "cross-rank diagnosis:" in proc.stdout and "rank 1" in proc.stdout
    assert postmortem_dump.main([pm, "--json"]) == 0
    # The launcher's report points at the first-failing rank's dump.
    report = failure_report(results, postmortem_dir=pm)
    assert f"postmortem: {os.path.join(pm, 'rank-1.json')}" in report, report
    assert "cross-rank diagnosis: " in report, report


_HANG_BODY = ("import os\n"
              "try:\n"
              "    for i in range(6):\n"
              "        op(i)\n"
              "    os._exit(9)\n"
              "except CollectiveTimeoutError as e:\n"
              "    assert 'step.3' in str(e), str(e)\n"
              "    os._exit(7)\n")


def test_hang_postmortem_cross_rank_diagnosis(tmp_path):
    """rank=1:hang@op=3 at np 2 under a 2 s collective timeout: the
    survivor's dump names the stalled tensor and the wedged rank, and
    holds the coordinator's waiting-on view, as the reference's."""
    from horovod_tpu_torch.runner import failure_report

    docs = {}
    for pkg in ("port", "ref"):
        pm = str(tmp_path / f"pm_{pkg}")
        results = _run(pkg, _HANG_BODY, 2, "CollectiveTimeoutError",
                       HVD_TPU_FAULT_SPEC="rank=1:hang@op=3",
                       HVD_TPU_COLLECTIVE_TIMEOUT_SEC="2",
                       HVD_TPU_POSTMORTEM_DIR=pm)
        codes = {r.rank: r.returncode for r in results}
        assert codes == {0: 7, 1: -9}, [(r.rank, r.returncode,
                                         r.stderr[-800:]) for r in results]
        assert not os.path.exists(os.path.join(pm, "rank-1.json"))
        with open(os.path.join(pm, "rank-0.json")) as f:
            docs[pkg] = json.load(f)
        if pkg == "port":
            report = failure_report(results, postmortem_dir=pm)
            assert "postmortem: " in report and "rank-0.json" in report
            assert "cross-rank diagnosis: " in report, report
    d, ref = docs["port"], docs["ref"]
    assert d["reason"] == ref["reason"] == "timeout"
    assert d["abort"]["code"] == ref["abort"]["code"] == 7  # ST_TIMEOUT
    assert "rank 1" in d["diagnosis"] and "last announced" in d["diagnosis"]
    assert "step.3" in d["abort"]["message"]
    assert [(p["name"], p["missing_ranks"])
            for p in d["pending"]["coordinator"]] == \
        [(p["name"], p["missing_ranks"])
         for p in ref["pending"]["coordinator"]] == [("step.3", [1])]
    assert _job_events(d) == _job_events(ref)


# ---------------------------------------------------------------------------
# The failure report and the excepthook.
# ---------------------------------------------------------------------------


def _fake_dump(rank, reason, diagnosis=None):
    return {
        "schema": 1, "rank": rank, "size": 3, "restart_epoch": 0,
        "membership_epoch": 0, "reason": reason,
        "abort": {"code": 7, "message": "collective timeout ..."},
        "diagnosis": diagnosis,
        "ring": {"engine": [
            {"seq": 0, "ts_us": 1000, "event": "enqueue",
             "name": "grad_37", "arg": 0}], "xla": []},
        "pending": {"local": [], "coordinator": []},
        "transport": {"local": "tcp", "peers": {"1": "tcp", "2": "tcp"}},
        "autotune": {}, "metrics": {}, "written_unix": time.time(),
    }


@pytest.mark.parametrize("dumped", [(0,), (0, 1), ()])
def test_failure_report_postmortem_pointers(dumped, tmp_path):
    from horovod_tpu.runner.launch import RankResult as RefResult
    from horovod_tpu.runner.launch import failure_report as ref_report
    from horovod_tpu_torch.runner import RankResult, failure_report

    d = str(tmp_path)
    diag = "rank 1 never announced any collective"
    for rank in dumped:
        with open(os.path.join(d, f"rank-{rank}.json"), "w") as f:
            json.dump(_fake_dump(rank, "ranks_down", diagnosis=diag), f)
    port = [RankResult(0, 1, "", "boom", first_failure=True),
            RankResult(1, -9, "", "")]
    ref = [RefResult(0, 1, "", "boom", first_failure=True),
           RefResult(1, -9, "", "")]
    report = failure_report(port, postmortem_dir=d)
    assert report == ref_report(ref, postmortem_dir=d)
    if dumped:
        assert os.path.join(d, "rank-0.json") in report, report
        assert f"cross-rank diagnosis: {diag}" in report, report
    else:
        assert "postmortem" not in report
    if "HVD_TPU_POSTMORTEM_DIR" not in os.environ:
        assert "postmortem" not in failure_report(port, postmortem_dir="")


def test_launcher_postmortem_dir_flag(tmp_path):
    """``--postmortem-dir`` creates the directory and hands it to every
    rank; the launcher's report of the failed job points at the dump."""
    pm = str(tmp_path / "pm")
    code = ("import os, horovod_tpu_torch as hvd\n"
            "hvd.init(device='cpu')\n"
            "assert os.environ['HVD_TPU_POSTMORTEM_DIR'] == " + repr(pm)
            + "\n"
            "if hvd.rank() == 1:\n"
            "    raise RuntimeError('rank 1 blew up')\n"
            "hvd.shutdown()\n")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--postmortem-dir", pm, "--", sys.executable, "-c", code],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    with open(os.path.join(pm, "rank-1.json")) as f:
        assert json.load(f)["reason"] == "exception"
    assert f"postmortem: {os.path.join(pm, 'rank-1.json')}" in proc.stderr, \
        proc.stderr[-2000:]


def test_postmortem_written_on_fatal_exception(tmp_path):
    """A fatal uncaught exception on an initialized rank leaves a dump
    with reason 'exception'."""
    pm = str(tmp_path / "pm")
    code = ("import horovod_tpu_torch as hvd\n"
            "hvd.init(device='cpu')\n"
            "raise RuntimeError('training script blew up')\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=_env(HVD_TPU_POSTMORTEM_DIR=pm),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    path = os.path.join(pm, "rank-0.json")
    assert os.path.exists(path), proc.stderr[-800:]
    with open(path) as f:
        d = json.load(f)
    assert d["reason"] == "exception"
    assert d["exception"]["type"] == "RuntimeError"
    assert "training script blew up" in d["exception"]["message"]
    assert d["size"] == 1
