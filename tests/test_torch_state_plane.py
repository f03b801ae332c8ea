"""horovod_tpu_torch's state plane, part 2, against horovod_tpu's
(``state/snapshot.py``, ``peers.py``, ``plane.py``).

The job of ``tests/test_state.py``'s ``STATE`` script (elastic training
with the plane armed and a snapshot every step), each step's snapshot
drained before the next step, in torch for the port and in numpy on the
JAX package's public API for the reference, runs under each package's
``run_membership`` at
4 -> 3 (``rank=2:crash@op=12``) and 2 -> 1: the survivors restore the
lost shard from its ring neighbour's peer copy (``peer_restores`` >= 1,
no root-broadcast fallback) and the two packages' lines are equal field
by field (the count of committed snapshots aside: a snapshot in flight
at the reshape is abandoned or not by timing, in both).  Also:
``_plan_restore`` against the reference's on the same holdings tables;
the snapshot fence; a private capture; ``flatten_state``'s in-place
``assign``; ``--state-dir``; the ``state`` metrics section; and a tiny LM
under ``DistributedOptimizer`` at np 3 -> 2, crashed mid-backward, whose
restored state is bit-equal to its state at the fence step.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_watch import ENV, watched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The job both packages run, ordered: each step waits for its snapshot
# to be committed and pushed to the ring neighbour (``plane.wait()``)
# before the next step's collective, so when a rank crashes entering a
# collective its last snapshot is already on its neighbour's socket and
# every survivor holds its own last two.  The fence step is then one
# that both the survivors and the lost rank's copy cover in both
# packages: one peer restore, no root-broadcast fallback.  Unordered, the
# lost rank's snapshot worker can lag two steps behind its crash (the
# submit does not wait for the push), the peer copy then covers no step
# the survivors hold, and the plane falls back to a root broadcast, as
# designed, in either package.
_STATE_PORT = """\
import os, sys, time
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import common

TOTAL = int(sys.argv[1])
hvd.init(device="cpu")
plane = hvd.state.arm()
state = hvd.ElasticState(weights=torch.zeros(8), step=0)

def train(state):
    while state.step < TOTAL:
        s = state.step
        g = torch.ones(8)
        state.weights = state.weights + hvd.allreduce(
            g, average=True, name=f"grad.{s}")
        state.step = s + 1
        plane.snapshot(state)
        assert plane.wait(30.0), ("snapshot not drained", s + 1)
    return state.weights

w = hvd.run_elastic(train, state)
assert torch.allclose(w, torch.full((8,), float(TOTAL))), (hvd.rank(), w)
flat = hvd.allgather(w.reshape(1, -1), name="final.identity")
assert torch.equal(flat, flat[:1].expand_as(flat)), flat
snap = common.metrics_snapshot()
m, st = snap["membership"], snap["state"]
print("STATE", hvd.rank(), hvd.size(), m["epoch"],
      st["peer_restores"], st["restores"],
      st["root_broadcast_fallbacks"], st["snapshots"],
      ",".join(map(str, m["ranks_lost"])) or "-", int(w[0]), flush=True)
"""
# The same job on the JAX package's public API (numpy state).
_STATE_REFERENCE = """\
import os, sys, time
import numpy as np
import horovod_tpu as hvd

TOTAL = int(sys.argv[1])
hvd.init()
plane = hvd.state.arm()
state = hvd.ElasticState(weights=np.zeros(8, np.float32), step=0)

def train(state):
    while state.step < TOTAL:
        s = state.step
        g = np.ones(8, np.float32)
        state.weights = state.weights + hvd.allreduce(
            g, average=True, name=f"grad.{s}")
        state.step = s + 1
        plane.snapshot(state)
        assert plane.wait(30.0), ("snapshot not drained", s + 1)
    return state.weights

w = hvd.run_elastic(train, state)
assert np.allclose(w, float(TOTAL)), (hvd.rank(), w)
flat = hvd.allgather(w.reshape(1, -1), name="final.identity")
assert np.allclose(flat, flat[0]), flat
snap = hvd.metrics_snapshot()
m, st = snap["membership"], snap["state"]
print("STATE", hvd.rank(), hvd.size(), m["epoch"],
      st["peer_restores"], st["restores"],
      st["root_broadcast_fallbacks"], st["snapshots"],
      ",".join(map(str, m["ranks_lost"])) or "-", int(w[0]), flush=True)
"""

_ENGINE_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
               "HVD_TPU_DATA", "HVD_TPU_FAULT_SPEC", "HVD_TPU_RESTART_EPOCH",
               "HVD_TPU_ELASTIC", "HVD_TPU_MIN_NP", "HVD_TPU_REJOIN",
               "HVD_TPU_STATE_DIR", "HVD_TPU_CKPT_KEEP", "HVD_TPU_TIMELINE",
               "HVD_TPU_XLA_DATA_PLANE")


def _env(**overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.setdefault("HVD_TPU_KILL_GRACE_SEC", "3")
    for var in _ENGINE_ENV:
        env.pop(var, None)
    env.update({k: str(v) for k, v in overrides.items()})
    return env


def _state_lines(results):
    """(rank, size, epoch, peer_restores, restores, fallbacks, lost, w0)
    of every clean rank, sorted, and each one's snapshot count."""
    out, snaps = [], []
    for r in results:
        if r.returncode != 0:
            continue
        for line in r.stdout.splitlines():
            if line.startswith("STATE "):
                tok = line.split()
                out.append((int(tok[1]), int(tok[2]), int(tok[3]),
                            int(tok[4]), int(tok[5]), int(tok[6]), tok[8],
                            int(tok[9])))
                snaps.append(int(tok[7]))
    return sorted(out), snaps


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    """Both engines built before any timed launch (in a fresh checkout
    the first ranks would build them inside the launch's limit)."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build

    ref_build()
    build.build()


def _membership(package, script, args, np_, min_np, spec, timeout=90.0):
    import importlib

    runner = importlib.import_module(f"{package}.runner")
    return runner.run_membership(
        [sys.executable, str(script)] + args, np_, min_np=min_np,
        max_np=np_, max_rejoins=0,
        env=_env(HVD_TPU_FAULT_SPEC=spec,
                 HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20", **ENV),
        timeout=timeout, capture=True, report=lambda msg: None)


_FIELDS = ("rank", "size", "epoch", "peer_restores", "restores",
           "fallbacks", "lost", "w0")


def _ranks(package, results):
    """The evidence of one package's run: every rank's exit code and
    ``STATE`` line, and the stderr tails of the ranks that failed."""
    out = []
    for r in results:
        state = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("STATE ")]
        out.append({"rank": r.rank, "rc": r.returncode,
                    "state": state[-1] if state else None,
                    **({"stderr": r.stderr[-3000:]} if r.returncode
                       else {})})
    return {"package": package, "ranks": out}


def _off_fields(line, want):
    """``[(field, got, want)]`` where a ``STATE`` tuple differs from the
    expected ``(size, epoch, peer_restores, restores, fallbacks, lost,
    w0)``."""
    return [(name, got, exp) for name, got, exp in zip(_FIELDS[1:], line[1:],
                                                       want) if got != exp]


@pytest.mark.parametrize("np_,min_np,steps,spec,lost", [
    (4, 2, 30, "rank=2:crash@op=12", 2),
    (2, 1, 12, "rank=1:crash@op=10", 1),
])
def test_state_lines_match_the_reference(np_, min_np, steps, spec, lost,
                                         tmp_path):
    """Each package's job, ordered so that the lost rank's last snapshot
    has reached its neighbour before the crash (``_STATE_PORT``'s note):
    every survivor's line is the expected one, field by field, in both
    packages, and the two packages' lines are equal.  Every assertion
    names its package first and carries each rank's exit code, ``STATE``
    line and, where it failed, its stderr tail."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE
    from horovod_tpu_torch.runner import membership_succeeded

    lines = {}
    for package, code in (("horovod_tpu_torch", _STATE_PORT),
                          ("horovod_tpu", _STATE_REFERENCE)):
        script = tmp_path / f"{package}_state.py"
        script.write_text(code)
        with watched(85, f"{package}'s membership at np {np_}"):
            results = _membership(package, script, [str(steps)], np_,
                                  min_np, spec)
        evidence = _ranks(package, results)
        by_slot = {r.rank: r for r in results}
        assert by_slot[lost].returncode == CRASH_EXIT_CODE, \
            (package, "the lost rank did not crash", evidence)
        assert membership_succeeded(results, min_np), \
            (package, "the membership failed", evidence)
        lines[package], snaps = _state_lines(results)
        assert len(snaps) == np_ - 1 and min(snaps) > 0, \
            (package, "snapshot counts", snaps, evidence)
        assert [m[0] for m in lines[package]] == list(range(np_ - 1)), \
            (package, "survivors' ranks", lines[package], evidence)
        # size, epoch, one peer restore, no fallback, the lost rank, steps
        want = (np_ - 1, 1, 1, 1, 0, str(lost), steps)
        off = {m[0]: _off_fields(m, want) for m in lines[package]}
        assert not any(off.values()), \
            (package, "fields off the expected line (field, got, want) "
             "by rank", off, evidence)
    assert lines["horovod_tpu_torch"] == lines["horovod_tpu"], lines


def _row(old_rank=-1, old_size=-1, last=-1, prev=-1, peer_src=-1,
         peer_size=-1, peer_step=-1, n=4, ever=0, sig=1):
    return [old_rank, old_size, last, prev, peer_src, peer_size,
            peer_step, n, ever, sig]


_TABLES = {
    "own_and_peer": [
        _row(0, 3, 7, 6, peer_src=2, peer_size=3, peer_step=7, ever=1),
        _row(1, 3, 7, 6, peer_src=0, peer_size=3, peer_step=7, ever=1)],
    "lagging_peer": [
        _row(0, 2, 7, 6, peer_src=1, peer_size=2, peer_step=6, ever=1)],
    "gap": [_row(0, 2, 7, 6, ever=1)],
    "mixed_sizes": [_row(0, 2, 7, -1, ever=1), _row(1, 3, 7, -1, ever=1)],
    "leaf_count": [_row(0, 1, 7, -1, n=5, ever=1)],
    "signatures": [_row(0, 2, 7, -1, ever=1, sig=1),
                   _row(1, 2, 7, -1, ever=1, sig=2)],
    "nothing": [_row(), _row()],
    "standby_row": [
        _row(0, 2, 9, 8, peer_src=1, peer_size=2, peer_step=9, ever=1),
        _row(1, 2, 9, 8, peer_src=0, peer_size=2, peer_step=8, ever=1),
        _row()],
    "own_beats_peer": [
        _row(0, 2, 5, 4, peer_src=1, peer_size=2, peer_step=5, ever=1),
        _row(1, 2, 5, 4, peer_src=0, peer_size=2, peer_step=5, ever=1)],
}


@pytest.mark.parametrize("case", sorted(_TABLES))
def test_plan_restore_matches_the_reference(case):
    from horovod_tpu.state.plane import _plan_restore as ref
    from horovod_tpu_torch.state.plane import _plan_restore as port

    table = np.asarray(_TABLES[case], np.int64)
    assert port(table, 4) == ref(table, 4)


def test_plan_restore_matches_the_reference_on_random_tables():
    from horovod_tpu.state.plane import _plan_restore as ref
    from horovod_tpu_torch.state.plane import _plan_restore as port

    rng = np.random.RandomState(0)
    planned = 0
    for _ in range(300):
        old = int(rng.randint(2, 5))
        rows = []
        for new_rank in range(int(rng.randint(1, old + 1))):
            last = int(rng.randint(3, 6))
            rows.append(_row(
                int(rng.randint(0, old)), old, last,
                last - 1 if rng.rand() < 0.7 else -1,
                peer_src=int(rng.randint(-1, old)), peer_size=old,
                peer_step=int(rng.randint(2, 6)), ever=1))
        table = np.asarray(rows, np.int64)
        got = port(table, 4)
        assert got == ref(table, 4), rows
        planned += got is not None
    assert planned > 20  # the sample reaches both verdicts


def test_snapshot_fence_commits_whole_snapshots_only():
    """A snapshot commits only once the worker finished it; a third
    submit waits for the slot instead of dropping; the last two commits
    are kept, and the evicted one's leaves are handed back."""
    import threading
    import time

    from horovod_tpu_torch.state.snapshot import ShardSnapshotter

    gate = threading.Event()
    released = []

    snap = ShardSnapshotter(writer=lambda step, leaves, n: gate.wait(10.0),
                            on_release=released.append)
    try:
        snap.submit(1, {0: torch.ones(4)})
        time.sleep(0.05)                   # the worker holds #1
        snap.submit(2, {0: torch.ones(4)})  # queued in the free slot
        assert snap.committed_steps() == []
        t0 = time.perf_counter()
        gate.set()
        snap.submit(3, {0: torch.full((4,), 3.0)})
        assert snap.wait(timeout=10.0)
        assert snap.committed_steps() == [2, 3]
        assert torch.equal(snap.get(3)[0], torch.full((4,), 3.0))
        assert len(released) == 1 and torch.equal(released[0][0],
                                                  torch.ones(4))
        assert time.perf_counter() - t0 < 10.0
        assert len(snap.write_sec) == 3
        snap.clear()
        assert snap.committed_steps() == [] and len(released) == 3
    finally:
        snap.close()


@pytest.fixture
def port_engine():
    import horovod_tpu_torch as hvd

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        os.environ.pop(var, None)
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_snapshot_capture_is_private(port_engine):
    """Mutating the live state after ``snapshot()`` returns cannot reach
    the committed copy."""
    hvd = port_engine
    from horovod_tpu_torch.state import flatten_state

    plane = hvd.state.arm()
    st = hvd.ElasticState(weights=torch.zeros(4), step=1)
    plane.snapshot(st)
    st.weights += 99.0
    assert plane.wait(10.0)
    assert plane.status()["last_snapshot_step"] == 1
    named, _ = flatten_state(st)
    widx = next(i for i, (n, _) in enumerate(named) if n == "weights")
    assert torch.equal(plane._snapshotter.get(1)[widx], torch.zeros(4))
    assert len(plane.capture_sec) == 1
    assert hvd.state.current() is plane
    hvd.shutdown()
    assert hvd.state.current() is None  # shutdown disarms


def test_flatten_state_assign_is_in_place_and_keeps_types(port_engine):
    hvd = port_engine
    import horovod_tpu as ref_hvd
    from horovod_tpu.state.partition import flatten_state as ref_flatten
    from horovod_tpu_torch.state import flatten_state

    w = torch.arange(4.0)
    mu = torch.ones(2)
    st = hvd.ElasticState(weights=w, step=3, lr=0.5, done=False,
                          opt={"mu": [mu], "foreach": None})
    named, assign = flatten_state(st)
    ref = ref_hvd.ElasticState(weights=np.arange(4.0), step=3, lr=0.5,
                               done=False, opt={"mu": [np.ones(2)]})
    assert [n for n, _ in named] == [n for n, _ in ref_flatten(ref)[0]]
    assign([v * 2 if torch.is_tensor(v) else v for _, v in named])
    assert isinstance(st.step, int) and st.step == 3
    assert isinstance(st.lr, float) and st.lr == 0.5
    assert isinstance(st.done, bool) and st.done is False
    assert st.weights is w and torch.equal(w, torch.arange(4.0) * 2)
    assert st.opt["mu"][0] is mu and torch.equal(mu, torch.full((2,), 2.0))
    assert st.opt["foreach"] is None
    with pytest.raises(ValueError, match="state shape changed"):
        assign([1])


def test_state_metrics_section_matches_the_reference():
    from horovod_tpu.common.metrics import MetricsRegistry as Ref
    from horovod_tpu_torch.common.metrics import MetricsRegistry

    regs = (MetricsRegistry(), Ref())
    for reg in regs:
        reg.set_state_armed(True)
        reg.record_state_snapshot(9, 2048)
        reg.set_state_overlap(0.1, 0.9)
        reg.record_state_peer(sent_bytes=2048)
        reg.record_state_peer(received_step=9)
        reg.record_state_restore("peer")
        reg.record_state_restore("root_broadcast")
        with pytest.raises(ValueError):
            reg.record_state_restore("carrier_pigeon")
    port, ref = (r.snapshot()["state"] for r in regs)
    assert port == ref


def test_state_dir_plumbs_the_environment(tmp_path):
    """``--state-dir DIR`` gives every rank ``HVD_TPU_STATE_DIR`` (and
    makes DIR); the armed plane spills its snapshots there in the JAX
    package's snapshot format, which ``tools/ckpt_inspect.py`` reads."""
    import io
    from contextlib import redirect_stdout

    state_dir = tmp_path / "spool"
    script = tmp_path / "probe.py"
    script.write_text("""\
import os, sys
import torch
import horovod_tpu_torch.torch as hvd
hvd.init(device="cpu")
assert os.environ["HVD_TPU_STATE_DIR"] == sys.argv[1]
plane = hvd.state.arm()
st = hvd.ElasticState(weights=torch.zeros(4), step=1)
plane.snapshot(st)
assert plane.wait(15.0)
assert os.path.exists(os.path.join(
    sys.argv[1], f"snap-rank{hvd.rank()}.pkl"))
print("SPILL_OK", hvd.rank(), flush=True)
""")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--state-dir", str(state_dir), "--timeout", "60", "--",
         sys.executable, str(script), str(state_dir)],
        env=_env(), capture_output=True, text=True, timeout=90, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-1200:]
    assert sorted(os.listdir(state_dir)) == ["snap-rank0.pkl",
                                             "snap-rank1.pkl"]
    from tools.ckpt_inspect import inspect

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert inspect(str(state_dir)) == 0
    out = buf.getvalue()
    assert "snap-rank0.pkl: step 1 (rank 0 of 2)" in out, out
    assert "snap-rank1.pkl: step 1 (rank 1 of 2)" in out, out


_LM = """\
import hashlib, json, sys
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import common
from horovod_tpu_torch.state import flatten_state
from horovod_tpu_torch.torch.lm_step import build_lm_step

TOTAL = int(sys.argv[1])
hvd.init(device="cpu")
model, step, data = build_lm_step(
    "cpu", vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
    batch=2, seq=16, dtype=torch.float32, logits_dtype=torch.float32,
    seed=5)
params = list(model.parameters())
plane = hvd.state.arm()
state = hvd.ElasticState(model=model.state_dict(),
                         opt=step.optimizer.state_dict(), step=0)

def digest():
    h = hashlib.sha256()
    for name, leaf in flatten_state(state)[0]:
        h.update(name.encode())
        if torch.is_tensor(leaf):
            h.update(leaf.detach().contiguous().reshape(-1)
                     .view(torch.uint8).numpy())
        else:
            h.update(repr(leaf).encode())
    for p in params:  # the module's own parameters, not the state's
        h.update(p.detach().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()

seen, entries, seq = {}, [], {}

def train(state):
    entries.append((hvd.membership_epoch(), state.step, digest()))
    while state.step < TOTAL:
        seq[state.step] = common._collective_seq
        loss = step(data)
        assert torch.isfinite(loss), loss
        state.step += 1
        seen[state.step] = digest()
        plane.snapshot(state)
    return digest()

final = hvd.run_elastic(train, state)
st = common.metrics_snapshot()["state"]
print("LM " + json.dumps({
    "size": hvd.size(), "entries": entries, "seen": seen, "final": final,
    "seq": seq, "peer": st["peer_restores"],
    "fallbacks": st["root_broadcast_fallbacks"],
    "last": plane.last_restore}), flush=True)
hvd.shutdown()
"""
# 16 collectives a step: 15 parameter allreduces and the loss's; 156
# before the first (build_lm_step's broadcasts of the parameters and the
# optimizer state, then run_elastic's resync).  Op 196 is in the middle of
# the third step's backward.
_LM_CRASH_OP = 196


def test_lm_restores_the_fence_state_in_place(tmp_path):
    """A 2-layer LM (d_model 32) trained by ``DistributedOptimizer(AdamW)``
    at np 3, rank 2 crashed in the third step's backward (gradient
    handles in flight): the two survivors drain the step, reshape,
    restore the fence step's state from their snapshots and rank 2's
    peer copy into the live module and optimizer, bit-equal to what they
    held at that step, and train on to equal final states."""
    from horovod_tpu_torch.runner import membership_succeeded

    script = tmp_path / "lm.py"
    script.write_text(_LM)
    results = _membership("horovod_tpu_torch", script, ["5"], 3, 2,
                          f"rank=2:crash@op={_LM_CRASH_OP}")
    assert membership_succeeded(results, 2), \
        [(r.rank, r.returncode, r.stderr[-3000:]) for r in results]
    crashed = re.search(r"crash at op (\d+) \('([^']*)'\)",
                        results[2].stderr)
    assert crashed and crashed.group(2).startswith(
        "DistributedOptimizer."), results[2].stderr[-500:]
    runs = [json.loads(ln[3:]) for r in results[:2]
            for ln in r.stdout.splitlines() if ln.startswith("LM ")]
    assert len(runs) == 2
    for run in runs:
        assert run["size"] == 2 and run["peer"] == 1
        assert run["fallbacks"] == 0
        fence = run["last"]["fence_step"]
        assert run["last"]["source"] == "peer" and fence in (1, 2)
        (e0, s0, _), (e1, s1, restored) = run["entries"]
        assert (e0, s0, e1, s1) == (0, 0, 1, fence)
        assert restored == runs[0]["seen"][str(fence)]
        assert restored != runs[0]["seen"][str(fence + 1)]
    assert runs[0]["final"] == runs[1]["final"]
    assert runs[0]["seen"] == runs[1]["seen"]
