"""horovod_tpu_torch's elastic membership against horovod_tpu's
(``common/elastic.py``, ``runner/launch.py``).

The ``MEMBER`` script of ``tests/test_elastic.py`` (an averaged allreduce
of ones adds exactly 1.0 a step whatever the membership's size, so the
final weights prove the step count survived the reshape), in torch for
the port and in numpy for the reference, runs under each package's
``run_membership``: at 4 -> 3 (``rank=2:crash@op=12``) and at 2 -> 1,
and the survivors' lines are equal field by field (rank, size, epoch,
the membership section, the weights).  Also: a standby rejoin that grows
the port's job back to 4, ``--min-np`` through the CLI, the bounds
refused with the reference's message, ``ElasticState.sync`` at np 2
writing a module's and an AdamW's ``state_dict`` in place (the module's
own ``parameters()`` hold rank 0's values afterwards), the in-process
units of ``ElasticState``/``run_elastic``/the launcher's accounting, and
the serving scheduler's ``reform`` re-planning the identical step on
both packages, and 4 serving ranks losing one mid-decode and serving on.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MEMBER_PORT = """\
import os, sys, time
import torch
import horovod_tpu_torch.torch as hvd

TOTAL = int(sys.argv[1])
PAUSE = float(os.environ.get("TEST_STEP_PAUSE") or 0)
hvd.init(device="cpu")
state = hvd.ElasticState(weights=torch.zeros(8), step=0)

def train(state):
    while state.step < TOTAL:
        s = state.step
        g = torch.ones(8)
        state.weights = state.weights + hvd.allreduce(
            g, average=True, name=f"grad.{s}")
        state.step = s + 1
        if PAUSE:
            time.sleep(PAUSE)
    return state.weights

w = hvd.run_elastic(train, state)
assert torch.allclose(w, torch.full((8,), float(TOTAL))), (hvd.rank(), w)
assert hvd.local_rank() == hvd.rank(), (hvd.local_rank(), hvd.rank())
assert hvd.local_size() == hvd.size(), (hvd.local_size(), hvd.size())
flat = hvd.allgather(w.reshape(1, -1), name="final.identity")
assert torch.equal(flat, flat[:1].expand_as(flat)), flat
from horovod_tpu_torch import common
m = common.metrics_snapshot()["membership"]
print("MEMBER", hvd.rank(), hvd.size(), m["epoch"], m["size"],
      ",".join(map(str, m["ranks_lost"])) or "-",
      ",".join(map(str, m["ranks_joined"])) or "-", int(w[0]), flush=True)
"""


def _ref_member():
    """The reference's script, as its own test file runs it."""
    from tests import test_elastic

    return test_elastic._TRAIN


def _env(**overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.setdefault("HVD_TPU_KILL_GRACE_SEC", "3")
    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_FAULT_SPEC",
                "HVD_TPU_RESTART_EPOCH", "HVD_TPU_ELASTIC",
                "HVD_TPU_MIN_NP", "HVD_TPU_REJOIN", "HVD_TPU_TIMELINE",
                "HVD_TPU_NET_FAULT_SPEC", "HVD_TPU_HEARTBEAT_MS",
                "HVD_TPU_HEARTBEAT_MISS", "HVD_TPU_STATE_DIR",
                "HVD_TPU_XLA_DATA_PLANE"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in overrides.items()})
    return env


def _members(results):
    """The MEMBER lines of every clean rank, sorted: (rank, size, epoch,
    size in the snapshot, lost, joined, w0)."""
    out = []
    for r in results:
        if r.returncode != 0:
            continue
        for line in r.stdout.splitlines():
            if line.startswith("MEMBER "):
                tok = line.split()
                out.append((int(tok[1]), int(tok[2]), int(tok[3]),
                            int(tok[4]), tok[5], tok[6], int(tok[7])))
    return sorted(out)


@pytest.fixture(scope="module", autouse=True)
def port_engine_built():
    from horovod_tpu_torch.engine import build

    build.build()


def _run_member(package, tmp_path, code, np_, steps, spec, pause=0.0,
                **kw):
    import importlib

    runner = importlib.import_module(f"{package}.runner")
    script = tmp_path / f"{package}_member.py"
    script.write_text(code)
    return runner.run_membership(
        [sys.executable, str(script), str(steps)], np_,
        env=_env(HVD_TPU_FAULT_SPEC=spec, TEST_STEP_PAUSE=pause,
                 HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20"),
        capture=True, report=lambda msg: None, **kw)


@pytest.mark.parametrize("np_,min_np,steps,spec,lost", [
    (4, 2, 30, "rank=2:crash@op=12", 2),
    (2, 1, 12, "rank=1:crash@op=6", 1),
])
def test_member_lines_match_the_reference(np_, min_np, steps, spec, lost,
                                          tmp_path):
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE
    from horovod_tpu_torch.runner import membership_succeeded

    lines = {}
    for package, code in (("horovod_tpu_torch", _MEMBER_PORT),
                          ("horovod_tpu", _ref_member())):
        results = _run_member(package, tmp_path, code, np_, steps, spec,
                              min_np=min_np, max_np=np_, max_rejoins=0,
                              timeout=90.0)
        by_slot = {r.rank: r for r in results}
        assert by_slot[lost].returncode == CRASH_EXIT_CODE, \
            (package, by_slot[lost].stderr[-800:])
        assert membership_succeeded(results, min_np), \
            [(package, r.rank, r.returncode, r.stderr[-600:])
             for r in results]
        lines[package] = _members(results)
    port = lines["horovod_tpu_torch"]
    assert port == lines["horovod_tpu"]
    assert [m[0] for m in port] == list(range(np_ - 1))  # dense ranks
    for m in port:
        assert m[1:] == (np_ - 1, 1, np_ - 1, str(lost), "-", steps), port


_GROW = """\
import os, sys, time
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import common

TOTAL = int(sys.argv[1])
hvd.init(device="cpu")
state = hvd.ElasticState(weights=torch.zeros(8), step=0)

def train(state):
    # Keep stepping while the job is below 4: a late standby cannot end
    # the run first.  The final allgather is inside, so a grow that lands
    # on it is retried like any other step.
    while state.step < TOTAL or (hvd.size() < 4 and state.step < 2000):
        s = state.step
        state.weights = state.weights + hvd.allreduce(
            torch.ones(8), average=True, name=f"grad.{s}")
        state.step = s + 1
        time.sleep(0.05)
    return hvd.allgather(state.weights.reshape(1, -1), name="final")

flat = hvd.run_elastic(train, state)
assert torch.equal(flat, flat[:1].expand_as(flat)), flat
m = common.metrics_snapshot()["membership"]
print("SLOT", os.environ["HVD_TPU_DEVICE_SLOT"], flush=True)
print("MEMBER", hvd.rank(), hvd.size(), m["epoch"], m["size"],
      ",".join(map(str, m["ranks_lost"])) or "-",
      ",".join(map(str, m["ranks_joined"])) or "-", int(flat[0, 0]),
      flush=True)
"""


def test_standby_rejoins_and_grows_back_to_four(tmp_path):
    """4 ranks, rank 2 crashes (shrink to 3), a standby registers with
    the live coordinator and is admitted at the next reshape barrier
    (grow back to 4, epoch 2); every member ends with equal weights, and
    the standby took the dead rank's device slot."""
    from horovod_tpu_torch.runner import membership_succeeded

    results = _run_member(
        "horovod_tpu_torch", tmp_path, _GROW, 4, 40, "rank=2:crash@op=10",
        min_np=2, max_np=4, rejoin_delay=0.3, timeout=100.0)
    assert membership_succeeded(results, 2), \
        [(r.rank, r.returncode, r.stderr[-600:]) for r in results]
    by_slot = {r.rank: r for r in results}
    assert 4 in by_slot and by_slot[4].returncode == 0, \
        by_slot.get(4) and by_slot[4].stderr[-800:]
    assert "SLOT 2" in by_slot[4].stdout  # the dead rank's device slot
    members = _members(results)
    assert [m[0] for m in members] == [0, 1, 2, 3], members
    survivor = next(m for m in members if m[0] == 0)
    assert survivor[1:6] == (4, 2, 4, "2", "3"), members
    steps = {m[6] for m in members}
    assert len(steps) == 1 and steps.pop() >= 40, members


def test_cli_min_np_completes_elastically(tmp_path):
    script = tmp_path / "member.py"
    script.write_text(_MEMBER_PORT)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--min-np", "1", "--timeout", "60", "--",
         sys.executable, str(script), "12"],
        env=_env(HVD_TPU_FAULT_SPEC="rank=1:crash@op=6",
                 HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20"),
        capture_output=True, text=True, timeout=90, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-1200:]
    assert "completed elastically" in proc.stderr, proc.stderr[-800:]
    assert "1 member(s) lost" in proc.stderr, proc.stderr[-800:]
    assert "MEMBER 0 1 1 1 1 - 12" in proc.stdout, proc.stdout


@pytest.mark.parametrize("kw", [dict(min_np=3, max_np=4),
                                dict(min_np=1, max_np=1), dict(min_np=0)])
def test_bad_bounds_are_refused_with_the_reference_message(kw):
    from horovod_tpu.runner import run_membership as ref
    from horovod_tpu_torch.runner import run_membership as port

    with pytest.raises(ValueError, match="min-np") as want:
        ref(["true"], 2, **kw)
    with pytest.raises(ValueError, match="min-np") as got:
        port(["true"], 2, **kw)
    assert str(got.value) == str(want.value)


def test_cli_refuses_bad_bounds():
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--min-np", "3", "--", "true"],
        env=_env(), capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 2
    assert "need 1 <= min-np (3) <= np (2) <= max-np (2)" in proc.stderr


_SYNC = """\
import hashlib, json
import torch
import horovod_tpu_torch.torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
torch.manual_seed(r)
model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
opt = torch.optim.AdamW(model.parameters(), lr=1e-2 * (r + 1))
model(torch.randn(5, 4)).square().mean().backward()
opt.step()

def digest():
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    for st in opt.state.values():
        for k in sorted(st):
            h.update(st[k].detach().numpy().tobytes())
    return h.hexdigest()

before = digest()
params = list(model.parameters())
state = hvd.ElasticState(model=model.state_dict(), opt=opt.state_dict(),
                         step=3 + r, lr=0.5 * (r + 1), done=bool(r))
state.sync(root=0, key=0)
assert all(a is b for a, b in zip(params, model.parameters()))
print("SYNC", json.dumps({
    "before": before, "after": digest(), "step": state.step,
    "lr": state.lr, "done": state.done,
    "types": [type(state.step).__name__, type(state.lr).__name__,
              type(state.done).__name__],
    "group_lr": state.opt["param_groups"][0]["lr"],
    "adam_step": [float(s["step"]) for s in opt.state.values()]}),
    flush=True)
hvd.shutdown()
"""


def test_sync_writes_a_state_dict_into_the_live_module(tmp_path):
    """np 2, each rank its own weights and AdamW state: after
    ``ElasticState(model=..., opt=...).sync()`` the module's own
    ``parameters()`` and the optimizer's buffers hold rank 0's values
    (written in place: the same tensor objects), AdamW's 0-d ``step``
    included, and scalars keep their types."""
    import json

    from horovod_tpu_torch.runner import run_command

    script = tmp_path / "sync.py"
    script.write_text(_SYNC)
    results = run_command([sys.executable, str(script)], 2, env=_env(),
                          timeout=90, capture=True)
    got = []
    for r in results:
        assert r.returncode == 0, r.stderr[-1500:]
        line = next(ln for ln in r.stdout.splitlines()
                    if ln.startswith("SYNC "))
        got.append(json.loads(line[5:]))
    assert got[0]["before"] != got[1]["before"]
    assert got[0]["after"] == got[0]["before"] == got[1]["after"]
    for g in got:
        assert (g["step"], g["lr"], g["done"]) == (3, 0.5, False)
        assert g["types"] == ["int", "float", "bool"]
        assert g["group_lr"] == 1e-2
        assert g["adam_step"] == [1.0] * 4


@pytest.fixture
def port_engine():
    """The port's engine at size 1 in this process."""
    import horovod_tpu_torch as hvd

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        os.environ.pop(var, None)
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_elastic_state_validation_and_keys():
    import horovod_tpu as ref
    import horovod_tpu_torch as hvd

    with pytest.raises(ValueError, match="at least one"):
        hvd.ElasticState()
    st = hvd.ElasticState(weights=torch.ones(3), step=7, lr=0.1)
    want = ref.ElasticState(weights=np.ones(3), step=7, lr=0.1)
    assert st.keys() == want.keys() == ["lr", "step", "weights"]
    assert st.step == 7


def test_sync_roundtrips_leaf_types(port_engine):
    hvd = port_engine
    nested = {"w": [torch.arange(3.0)], "b": (torch.zeros(2), 4),
              "none": None}
    st = hvd.ElasticState(weights=torch.arange(4, dtype=torch.float32),
                          step=3, lr=0.5, done=False, tree=nested)
    w = st.weights
    st.sync(root=0, key=0)
    assert isinstance(st.step, int) and st.step == 3
    assert isinstance(st.lr, float) and st.lr == 0.5
    assert isinstance(st.done, bool) and st.done is False
    assert st.weights is w and torch.equal(w, torch.arange(4.0))
    assert isinstance(st.tree["b"], tuple) and st.tree["b"][1] == 4
    assert st.tree["none"] is None and st.tree["w"][0] is nested["w"][0]
    with pytest.raises(TypeError, match="leaf 'bad'"):
        hvd.ElasticState(bad="text").sync()


def test_run_elastic_returns_and_reraises_fatal(port_engine):
    hvd = port_engine
    from horovod_tpu_torch.common import (CollectiveTimeoutError,
                                          RanksDownError)

    st = hvd.ElasticState(step=0)
    assert hvd.run_elastic(lambda s: "done", st) == "done"
    assert st.step == 0
    for exc in (RanksDownError("ranks down: 1", ranks=[1]),
                CollectiveTimeoutError("stalled"), KeyError("user bug")):
        def fail(_, exc=exc):
            raise exc

        with pytest.raises(type(exc)):
            hvd.run_elastic(fail, st)


def test_membership_changed_error_is_retryable():
    from horovod_tpu_torch.common import (HorovodInternalError,
                                          MembershipChangedError,
                                          RanksDownError, _status_error)

    err = MembershipChangedError("membership changed", lost_ranks=[2, 3])
    assert isinstance(err, HorovodInternalError)
    assert not isinstance(err, RanksDownError)
    assert err.lost_ranks == [2, 3]
    mapped = _status_error(8, "reshape: ranks down: 2", "x")
    assert isinstance(mapped, MembershipChangedError)
    assert mapped.lost_ranks == [2]


def test_membership_epoch_zero_before_init():
    import horovod_tpu_torch as hvd

    if hvd.is_initialized():
        pytest.skip("an engine is up in this process")
    assert hvd.membership_epoch() == 0
    assert hvd.restart_epoch() == int(
        os.environ.get("HVD_TPU_RESTART_EPOCH") or 0)


def test_membership_succeeded_accounting_matches_the_reference():
    from horovod_tpu.runner import RankResult as RR
    from horovod_tpu.runner import membership_succeeded as ref
    from horovod_tpu_torch.runner import RankResult, membership_succeeded

    cases = [([0, 43], 1), ([0, 43], 2), ([43, 0], 1), ([], 1),
             ([0, 43, 0], 2), ([0, -9, 0, 0], 3)]
    for codes, min_np in cases:
        port = [RankResult(i, c, "", "") for i, c in enumerate(codes)]
        want = [RR(i, c, "", "") for i, c in enumerate(codes)]
        assert membership_succeeded(port, min_np) == ref(want, min_np)
    assert membership_succeeded([RankResult(0, 0, "", ""),
                                 RankResult(1, 43, "", "")], 1)


def test_membership_metrics_section():
    from horovod_tpu.common.metrics import MetricsRegistry as Ref
    from horovod_tpu_torch.common.metrics import MetricsRegistry

    reg, ref = MetricsRegistry(), Ref()
    assert reg.snapshot()["membership"] == ref.snapshot()["membership"]
    state = {"epoch": 2, "size": 3, "reshapes": 2, "ranks_lost": [1],
             "ranks_joined": [3]}
    reg.set_membership(state)
    ref.set_membership(state)
    assert reg.snapshot()["membership"] == ref.snapshot()["membership"]
    reg.set_restart_epoch(2)
    reg.record_fault("crash")
    reg.reset()
    assert reg.snapshot()["faults"] == {"injected": {}, "restart_epoch": 2}


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_reform_replans_the_identical_step(package):
    """The reference's ``test_replan_after_reshape_is_identical`` inputs:
    a step cancelled by a reshape is planned again identically (no block
    allocated twice) and counted as ``reformed``."""
    if package == "jax":
        from horovod_tpu.common import metrics
        from horovod_tpu.serving import scheduler as sched
    else:
        from horovod_tpu_torch.common import metrics
        from horovod_tpu_torch.serving import scheduler as sched
    pkg = types.SimpleNamespace(metrics=metrics, sched=sched)
    pkg.metrics.registry.reset()
    cfg = sched.ServeConfig(max_batch=2, prefill_chunk=4, block_tokens=4,
                            num_blocks=16, max_blocks_per_seq=4,
                            queue_limit=8, tenant_max_inflight=4)
    sch = sched.Scheduler(cfg)
    sch.submit("t", [1, 2, 3, 4, 5, 6], 4)
    sch.submit("u", [7, 8], 2)
    p1 = sch.step_plan()
    in_use = sch.pool.blocks_in_use
    sch.reform([1])
    p2 = sch.step_plan()
    assert sch.pool.blocks_in_use == in_use
    fields = ("slot", "request_id", "tokens", "n_new", "length", "table",
              "bulk_len", "samples")
    assert [[getattr(sp, f) for f in fields] for sp in p1.slots] == \
        [[getattr(sp, f) for f in fields] for sp in p2.slots]
    assert pkg.metrics.registry.snapshot()["serving"]["reformed"] == 1
    pkg.metrics.registry.reset()


_SERVE_RESHAPE = """\
import threading
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import common
from horovod_tpu_torch.serving.engine import (ModelSpec, ServingEngine,
                                              broadcast_params, init_params,
                                              reference_decode)
from horovod_tpu_torch.serving.scheduler import Scheduler, ServeConfig

hvd.init(device="cpu")
spec = ModelSpec(vocab=101, d_model=32, n_layers=2, n_heads=2, device="cpu")
cfg = ServeConfig(max_batch=4, prefill_chunk=4, block_tokens=4,
                  num_blocks=64, max_blocks_per_seq=16)
params = broadcast_params(init_params(spec))
rank0 = hvd.rank() == 0
sch = Scheduler(cfg) if rank0 else None
engine = ServingEngine(spec, cfg, params, sch)
if not rank0:
    engine.run()
    hvd.shutdown()
    raise SystemExit(0)
short = sch.submit("acme", [5, 4, 3], 4)
long = sch.submit("beta", list(range(1, 9)), 24)
loop = threading.Thread(target=engine.run, daemon=True)
loop.start()
assert short.event.wait(180) and long.event.wait(180), "request hung"
assert short.error is None and long.error is None, (short.error, long.error)
assert short.generated == reference_decode(engine.model, [5, 4, 3], 4)
assert long.generated == reference_decode(engine.model, list(range(1, 9)), 24)
snap = common.metrics_snapshot()
m = snap["membership"]
assert m["epoch"] == 1 and m["ranks_lost"] == [2], m
assert snap["serving"]["reformed"] >= 1, snap["serving"]
print("SERVED", hvd.size(), len(long.generated), flush=True)
engine.request_stop()
loop.join(60)
hvd.shutdown()
"""


def test_serving_reshape_mid_decode_resumes(tmp_path):
    """4 serving ranks lose rank 2 mid-decode (``--min-np`` semantics):
    the survivors acknowledge the reshape, re-plan the cancelled step
    (``Scheduler.reform``) and keep serving; both requests finish with
    the tokens of the full-context reference decode.  The reference's
    counterpart (``test_reshape_mid_decode_resumes``) is in its slow
    tier for its JAX compiles; this one takes seconds."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE
    from horovod_tpu_torch.runner import membership_succeeded

    results = _run_member(
        "horovod_tpu_torch", tmp_path, _SERVE_RESHAPE, 4, 0,
        "rank=2:crash@op=35", min_np=2, max_np=4, max_rejoins=0,
        timeout=180.0)
    by_slot = {r.rank: r for r in results}
    assert by_slot[2].returncode == CRASH_EXIT_CODE, by_slot[2].stderr
    for slot in (0, 1, 3):
        assert by_slot[slot].returncode == 0, \
            (slot, by_slot[slot].stderr[-1200:])
    assert membership_succeeded(results, 2)
    assert "SERVED 3 24" in by_slot[0].stdout, by_slot[0].stdout
