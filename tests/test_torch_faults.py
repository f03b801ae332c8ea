"""horovod_tpu_torch's fault injector against horovod_tpu's
(``common/faults.py``).

``parse_spec`` gives the same faults, or the same error, on valid and
malformed specs.  One program, named, automatically named, point-to-point
and internal collectives (the state plane's ``__state.*`` allgathers and
``run_elastic``'s ``__elastic.sync.*`` broadcasts), runs at np 2 under
each package's launcher with a ``delay=0`` clause on every op index of
both ranks: each firing names its op index and collective, so the two
packages' lists show that ``op`` counts the same collectives in the same
order; the firings land in ``metrics_snapshot()["faults"]["injected"]``.
Also the ``epoch=`` gating of ``from_env``.  The crash action itself is
held in ``tests/test_torch_elastic.py`` (4 -> 3 at ``crash@op=12``).
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OPS = 14  # past the program's last collective: unused clauses are fine

_PORT = """\
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import common as C
hvd.init(device="cpu")
C.allreduce(torch.ones(4), name="named")
C.allreduce(torch.ones(4))
C.allgather(torch.ones(2, 2))
C.broadcast(torch.arange(3, dtype=torch.float32), 0)
if hvd.rank() == 0:
    C.send(torch.ones(3), 1, name="p")
else:
    C.recv(torch.empty(3), 0, name="p")
plane = hvd.state.arm()
st = hvd.ElasticState(w=torch.zeros(4), step=0)

def train(st):
    st.w = st.w + hvd.allreduce(torch.ones(4), name="g")
    st.step = 1
    plane.snapshot(st)
    return st.w

hvd.run_elastic(train, st)
hvd.allreduce(torch.ones(1), name="last")
import sys
sys.stdout.write(f"INJECTED {C.metrics_snapshot()['faults']['injected']}\\n")
sys.stdout.flush()
hvd.shutdown()
"""

_REF = """\
import numpy as np
import horovod_tpu as hvd
from horovod_tpu import common as C
hvd.init()
C.allreduce(np.ones(4, np.float32), name="named")
C.allreduce(np.ones(4, np.float32))
C.allgather(np.ones((2, 2), np.float32))
C.broadcast(np.arange(3, dtype=np.float32), 0)
if hvd.rank() == 0:
    C.send(np.ones(3, np.float32), 1, name="p")
else:
    C.recv(np.empty(3, np.float32), 0, name="p")
plane = hvd.state.arm()
st = hvd.ElasticState(w=np.zeros(4, np.float32), step=0)

def train(st):
    st.w = st.w + hvd.allreduce(np.ones(4, np.float32), name="g")
    st.step = 1
    plane.snapshot(st)
    return st.w

hvd.run_elastic(train, st)
hvd.allreduce(np.ones(1, np.float32), name="last")
import sys
sys.stdout.write(f"INJECTED {C.metrics_snapshot()['faults']['injected']}\\n")
sys.stdout.flush()
hvd.shutdown()
"""

_ENGINE_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
               "HVD_TPU_DATA", "HVD_TPU_TIMELINE", "HVD_TPU_FAULT_SPEC",
               "HVD_TPU_RESTART_EPOCH", "HVD_TPU_ELASTIC", "HVD_TPU_REJOIN",
               "HVD_TPU_XLA_DATA_PLANE", "HVD_TPU_STATE_DIR")


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    for var in _ENGINE_ENV:
        env.pop(var, None)
    env.update(extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def port_engine_built():
    from horovod_tpu_torch.engine import build

    build.build()


@pytest.mark.parametrize("spec", [
    "rank=1:crash@op=12",
    "rank=2:hang@op=5; rank=1:delay=3.0@op=7",
    "rank=0:freeze@op=0,rank=3:crash@op=9@epoch=2",
    " rank=1 : delay=0.5 @ op=4 @ epoch=1 ;",
    "",
])
def test_parse_spec_matches_the_reference(spec):
    from horovod_tpu.common.faults import parse_spec as ref
    from horovod_tpu_torch.common.faults import parse_spec as port

    assert [vars(f) for f in port(spec)] == [vars(f) for f in ref(spec)]


@pytest.mark.parametrize("spec", [
    "rank=1:explode@op=3",        # unknown action
    "rank=1:crash",               # no op
    "rank=1:delay@op=3",          # delay without a duration
    "rnk=1:crash@op=3",           # not rank=
    "rank=x:crash@op=3",          # rank not an int
    "rank=1:crash@op=3@when=2",   # unknown term
    "rank=1:crash@op=three",      # op not an int
])
def test_malformed_specs_raise_as_the_reference(spec):
    from horovod_tpu.common.faults import parse_spec as ref
    from horovod_tpu_torch.common.faults import parse_spec as port

    with pytest.raises(ValueError) as want:
        ref(spec)
    with pytest.raises(ValueError) as got:
        port(spec)
    assert str(got.value) == str(want.value)


def _firings(package, code):
    spec = ";".join(f"rank={r}:delay=0@op={i}"
                    for r in (0, 1) for i in range(N_OPS))
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.runner", "-np", "2", "--timeout",
         "100", "--", sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env(HVD_TPU_FAULT_SPEC=spec))
    assert proc.returncode == 0, (package, proc.stderr[-3000:])
    fired = re.findall(r"FAULT INJECTION: rank (\d) delay at op (\d+) "
                       r"\('([^']*)'\)", proc.stderr)
    # One write a rank: the two ranks share the launcher's stdout.
    injected = re.findall(r"INJECTED (\{[^}]*\})", proc.stdout)
    return sorted((int(r), int(i), name) for r, i, name in fired), injected


def test_op_counts_the_same_collectives_as_the_reference():
    port, port_injected = _firings("horovod_tpu_torch", _PORT)
    ref, ref_injected = _firings("horovod_tpu", _REF)
    assert port == ref
    names = {name for _, _, name in port}
    # Named, automatic, point-to-point and internal collectives all count.
    assert {"named", "p.p2p.0-1.t0", "__state.plan.0", "__state.peers.0",
            "__elastic.sync.0.step", "__elastic.sync.0.w", "g",
            "last"} <= names, names
    assert any(".noname." in name for name in names), names
    n = len(port) // 2
    assert [i for r, i, _ in port if r == 0] == list(range(n))
    assert port_injected == ref_injected == [f"{{'delay': {n}}}"] * 2


@pytest.mark.parametrize("spec,epoch,armed", [
    ("rank=0:crash@op=3", 0, True),
    ("rank=0:crash@op=3", 1, False),       # no epoch=: the first run only
    ("rank=0:crash@op=3@epoch=1", 1, True),
    ("rank=0:crash@op=3@epoch=1", 0, False),
    ("rank=1:crash@op=3", 0, False),       # another rank's clause
])
def test_epoch_gating_matches_the_reference(spec, epoch, armed, monkeypatch):
    from horovod_tpu.common import faults as ref
    from horovod_tpu_torch.common import faults as port

    monkeypatch.setenv("HVD_TPU_FAULT_SPEC", spec)
    monkeypatch.setenv("HVD_TPU_RESTART_EPOCH", str(epoch))
    assert (port.from_env(0) is not None) == armed
    assert (ref.from_env(0) is not None) == armed
    assert port.CRASH_EXIT_CODE == ref.CRASH_EXIT_CODE == 43
