"""horovod_tpu_torch's timeline against horovod_tpu's (docs/timeline.md).

One program, allreduce x 3, an allgather, a broadcast, a point-to-point
send/recv pair and an application span with a collective inside, runs at
np 2 under each package's launcher with ``--timeline DIR``.  Each rank's
trace must parse as Chrome trace JSON with the rank and clock-sync
metadata, and carry the same rows, event names and phases as the
reference's trace of the same program: the engine is the same C++, so
only the reference's ``__xla_plane_agreement__`` row (its XLA data plane's
agreement at ``init``, a plane the port does not have) is left out.  Rank
0, the coordinator, records each collective's ``NEGOTIATE`` before its
op.  Also: ``_resolve_timeline_path``'s forms against the reference's,
the environment spellings, no file and no-op spans with the timeline off,
the train step's ``TRAIN_STEP`` spans, and ``tools/timeline_merge.py`` on
the port's files.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from tests.torch_watch import descendants, signal_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("t0", "t1", "t2", "g0", "b0", "p.p2p.0-1.t0", "data_loading",
        "s0", "app.markers")
# The reference's XLA data plane agrees on itself at init: not ported.
REF_ONLY_ROWS = ("__xla_plane_agreement__",)

_PORT = """\
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import common as C
hvd.init(device="cpu")
for i in range(3):
    C.allreduce(torch.ones(64), name=f"t{i}")
C.allgather_async(torch.ones(2, 2), name="g0").wait()
C.broadcast_async(torch.arange(5, dtype=torch.float32), 0, name="b0").wait()
if hvd.rank() == 0:
    C.send(torch.ones(3), 1, name="p")
else:
    C.recv(torch.empty(3), 0, name="p")
assert hvd.timeline_enabled()
with hvd.trace_span("data_loading"):
    C.allreduce(torch.ones(8), name="s0")
hvd.trace_marker("epoch_boundary")
hvd.shutdown()
"""

_REF = """\
import numpy as np
import horovod_tpu as hvd
from horovod_tpu import common as C
hvd.init()
for i in range(3):
    C.allreduce(np.ones(64, np.float32), name=f"t{i}")
C.allgather(np.ones((2, 2), np.float32), name="g0")
C.broadcast(np.arange(5, dtype=np.float32), 0, name="b0")
if hvd.rank() == 0:
    C.send(np.ones(3, np.float32), 1, name="p")
else:
    C.recv(np.empty(3, np.float32), 0, name="p")
with hvd.trace_span("data_loading"):
    C.allreduce(np.ones(8, np.float32), name="s0")
hvd.trace_marker("epoch_boundary")
hvd.shutdown()
"""

_ENGINE_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
               "HVD_TPU_DATA", "HVD_TPU_TIMELINE", "HOROVOD_TIMELINE",
               "HVD_TPU_FAULT_SPEC", "HVD_TPU_XLA_DATA_PLANE")


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONFAULTHANDLER="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    for var in _ENGINE_ENV:
        env.pop(var, None)
    return env


def _launch(package, tl_dir, code, np_=2, timeout=120):
    """Run ``code`` at ``np_`` ranks under ``package``'s launcher.  A launch
    that outlives ``timeout`` has its ranks' Python stacks dumped
    (SIGABRT, with ``PYTHONFAULTHANDLER`` set) into the launcher's stderr
    before everything it started is killed; the error names the launch,
    its return code, its run time and its output's tails."""
    start = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.runner", "-np", str(np_),
         "--timeline", str(tl_dir), "--", sys.executable, "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=REPO, start_new_session=True)
    timed_out = False
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        timed_out = True
        signal_all(descendants(proc.pid), signal.SIGABRT)
        try:
            out, err = proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            signal_all(descendants(proc.pid) + [proc.pid], signal.SIGKILL)
            out, err = proc.communicate()
    finally:
        signal_all(descendants(proc.pid), signal.SIGKILL)
    seconds = time.monotonic() - start
    assert not timed_out and proc.returncode == 0, (
        f"{package} launch at np {np_} "
        f"{'timed out after %ds' % timeout if timed_out else 'failed'}: "
        f"rc {proc.returncode} after {seconds:.1f} s\n"
        f"--- stderr ---\n{err[-6000:]}\n--- stdout ---\n{out[-1500:]}")
    return proc


def _load(path):
    # The writer streams events with trailing commas and no closing "]".
    raw = open(path).read().rstrip().rstrip(",")
    return json.loads(raw + "]")


def _row_names(events):
    return {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}


def _rows(events):
    """Row name -> [(phase, event name)] in file order, metadata aside."""
    names = _row_names(events)
    out = {}
    for e in events:
        if e.get("ph") != "M":
            out.setdefault(names[e["pid"]], []).append((e["ph"], e["name"]))
    return out


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """``{package: [rank 0's events, rank 1's events]}`` of the program,
    and under ``"port_dir"`` the port's trace directory."""
    out = {}
    for package, code in (("horovod_tpu_torch", _PORT),
                          ("horovod_tpu", _REF)):
        tl = tmp_path_factory.mktemp(package)
        _launch(package, tl, code)
        assert sorted(os.listdir(tl)) == ["rank0.json", "rank1.json"]
        out[package] = [_load(os.path.join(tl, f"rank{r}.json"))
                        for r in range(2)]
        out.setdefault("port_dir", tl)
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_port_trace_is_valid_chrome_json_with_metadata(traces, rank):
    events = traces["horovod_tpu_torch"][rank]
    for e in events:
        for key in ("ph", "ts", "pid", "name"):
            assert key in e, (key, e)
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)  # one writer, one clock
    metas = {e["name"]: e for e in events if e.get("ph") == "M"}
    assert metas["hvd_rank"]["args"]["rank"] == rank
    assert "offset_us" in metas["hvd_clock_sync"]["args"]
    assert set(_row_names(events).values()) == set(ROWS)


@pytest.mark.parametrize("rank", [0, 1])
def test_rows_events_and_phases_match_the_reference(traces, rank):
    port = _rows(traces["horovod_tpu_torch"][rank])
    ref = _rows(traces["horovod_tpu"][rank])
    for row in REF_ONLY_ROWS:
        ref.pop(row, None)
    assert port == ref


@pytest.mark.parametrize("row,op", [("t0", "ALLREDUCE"), ("t1", "ALLREDUCE"),
                                    ("t2", "ALLREDUCE"), ("g0", "ALLGATHER"),
                                    ("b0", "BROADCAST"), ("s0", "ALLREDUCE")])
def test_coordinator_negotiates_before_the_op(traces, row, op):
    names = _row_names(traces["horovod_tpu_torch"][0])
    evs = [e for e in traces["horovod_tpu_torch"][0]
           if e.get("ph") in ("B", "E") and names[e["pid"]] == row]
    cats = [e["name"] for e in evs]
    assert cats[0] == "NEGOTIATE" and op in cats, cats
    neg_end = next(i for i, e in enumerate(evs) if e["ph"] == "E")
    assert neg_end < cats.index(op), cats
    depth = 0
    for e in evs:
        depth += 1 if e["ph"] == "B" else -1
        assert depth >= 0, cats
    assert depth == 0, cats
    assert evs[-1]["ph"] == "E" and evs[-1]["args"]["bytes"] > 0


@pytest.mark.parametrize("rank,op", [(0, "SEND"), (1, "RECV")])
def test_p2p_pair_rows(traces, rank, op):
    rows = _rows(traces["horovod_tpu_torch"][rank])
    assert ("B", op) in rows["p.p2p.0-1.t0"]
    assert rows["p.p2p.0-1.t0"][-1] == ("E", op)


@pytest.mark.parametrize("rank", [0, 1])
def test_span_holds_its_collective_and_the_marker_lands(traces, rank):
    events = traces["horovod_tpu_torch"][rank]
    names = _row_names(events)
    span = [e for e in events if names.get(e["pid"]) == "data_loading"
            and e["ph"] in ("B", "E")]
    assert [e["ph"] for e in span] == ["B", "E"]
    inner = [e["ts"] for e in events if names.get(e["pid"]) == "s0"
             and e["ph"] in ("B", "E")]
    assert span[0]["ts"] <= min(inner) <= max(inner) <= span[1]["ts"]
    assert any(e["ph"] == "i" and e["name"] == "epoch_boundary"
               and names[e["pid"]] == "app.markers" for e in events)


def test_timeline_merge_merges_the_port_files(traces, tmp_path):
    tl = traces["port_dir"]
    merged = tmp_path / "merged.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "timeline_merge.py"),
         str(tl), "-o", str(merged)], capture_output=True, text=True,
        env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    events = json.load(open(merged))["traceEvents"]
    procs = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert procs >= {"rank 0", "rank 1"}
    assert {e["pid"] for e in events if e.get("ph") != "M"} >= {0, 1}


@pytest.mark.parametrize("form", ["empty", "template", "trailing_sep",
                                  "existing_dir", "plain_rank0",
                                  "plain_rank1"])
def test_resolve_timeline_path_forms_match_the_reference(form, tmp_path):
    from horovod_tpu.common import _resolve_timeline_path as ref
    from horovod_tpu_torch.common import _resolve_timeline_path as port

    d = str(tmp_path / "tl")
    path, rank = {
        "empty": ("", 1),
        "template": (str(tmp_path / "sub" / "t-%d.json"), 2),
        "trailing_sep": (d + os.sep, 1),
        "existing_dir": (d, 3),
        "plain_rank0": (str(tmp_path / "single.json"), 0),
        "plain_rank1": (str(tmp_path / "single.json"), 1),
    }[form]
    if form == "existing_dir":
        os.makedirs(d)
    got = port(path, rank)
    assert got == ref(path, rank)
    if form in ("template", "trailing_sep"):
        assert os.path.isdir(os.path.dirname(got))


@pytest.mark.parametrize("names,want", [
    ({"HVD_TPU_TIMELINE": "/a/"}, "/a/"),
    ({"HOROVOD_TIMELINE": "/b/"}, "/b/"),
    ({"HVD_TPU_TIMELINE": "/a/", "HOROVOD_TIMELINE": "/b/"}, "/a/"),
    ({}, ""),
])
def test_config_reads_both_spellings_and_refuses_neither(names, want,
                                                         monkeypatch):
    from horovod_tpu_torch.common.config import Config

    for var in ("HVD_TPU_TIMELINE", "HOROVOD_TIMELINE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in names.items():
        monkeypatch.setenv(var, value)
    assert Config.from_env().timeline_path == want
    assert Config.unported_requests() == []


def test_timeline_off_writes_nothing_and_spans_are_noops(tmp_path):
    code = ("import torch, horovod_tpu_torch as hvd\n"
            "from horovod_tpu_torch import common\n"
            "hvd.init(device='cpu')\n"
            "assert not hvd.timeline_enabled()\n"
            "with hvd.trace_span('x'):\n"
            "    common.allreduce(torch.ones(2), name='x')\n"
            "hvd.trace_marker('y')\n"
            "hvd.shutdown()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.listdir(tmp_path) == []


def test_spans_are_noops_before_init():
    import horovod_tpu_torch as hvd

    if hvd.is_initialized():
        pytest.skip("an engine is up in this process")
    assert hvd.timeline_enabled() is False
    with hvd.trace_span("x", label="y"):
        pass
    hvd.trace_marker("z")


_STEP = """\
import torch, horovod_tpu_torch as hvd
from horovod_tpu_torch.torch.train import build_train_step
hvd.init(device="cpu")
torch.manual_seed(0)
model = torch.nn.Linear(4, 2)
step = build_train_step(lambda m, b: m(b).square().mean(),
                        torch.optim.SGD(model.parameters(), lr=0.1), model)
for _ in range(3):
    step(torch.ones(8, 4))
hvd.shutdown()
"""


def test_train_step_spans(tmp_path):
    path = tmp_path / "step.json"
    env = dict(_env(), HVD_TPU_TIMELINE=str(path))
    proc = subprocess.run([sys.executable, "-c", _STEP], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = _rows(_load(path))
    assert rows["torch.train_step"] == [("B", "TRAIN_STEP"),
                                        ("E", "TRAIN_STEP")] * 3
