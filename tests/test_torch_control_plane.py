"""horovod_tpu_torch's coordinator tree against horovod_tpu's
(``tests/test_control_plane.py``'s tree and simulated-scale contracts;
the tree is the engine's C++ in both packages).

One rank program (``tests/torch_twin.py``) runs under each package's
launcher at np 4; nodes of 2 are faked on one host through
``HVD_TPU_LOCAL_SIZE`` so the tree builds:

- one job, four contracts: the launcher's one-host layout keeps the
  star (depth 1, one host); on 2 nodes x 2 the tree builds (depth 2, 2
  hosts; rank 0 reads its node's worker and the other node's
  sub-coordinator, the sub-coordinator its worker, leaves nobody) and
  allreduce, allgather and broadcast stay exact through it, fresh and
  cached; a delayed leaf (rank 3, behind sub-coordinator 2) is named
  last to announce on rank 0; the steady state arms under the tree and
  leaves its flight event.  Every value equal to the reference's;
- rank 3, a leaf, crashed: every survivor's ``RanksDownError`` names
  rank 3 (forwarded by its sub-coordinator), as the reference's;
- the engine's in-process fleet (``hvd_tpu_simscale_run``) of 8
  simulated ranks, 2 a host: with the tree and steady state, rank 0
  reads 4 children and the steady window moves no control frame; as a
  star, 7 children and every cycle moves frames: the port's library's
  report equal to the reference's in the counts that do not follow
  timing (entered, children; the frames a star moves do); at 16
  and 64 ranks (slow, as in the reference) the steady cycle flat in
  ranks while the star's grows;
- ``Config``'s control knobs against the reference's.
"""

import ctypes
import json
import random

import pytest

from tests import torch_twin as twin

TREE = (
    "import os\n"
    "rank = int(os.environ['HVD_TPU_RANK'])\n"
    "def tree_layout():\n"
    "    os.environ['HVD_TPU_LOCAL_SIZE'] = '2'\n"
    "    os.environ['HVD_TPU_LOCAL_RANK'] = str(rank % 2)\n"
)


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


_NP4 = TREE + (
    "import importlib, json, time\n"
    "def shape(c):\n"
    "    return {k: c[k] for k in ('tree', 'depth', 'hosts', 'children')}\n"
    "rec = {}\n"
    "INIT()\n"
    "rec['star_sum'] = as_list(hvd.allreduce(ones(8), average=False,\n"
    "                                        name='star.sum'))\n"
    "rec['star'] = shape(top.metrics_snapshot()['control'])\n"
    "hvd.shutdown()\n"
    "tree_layout()\n"
    "INIT()\n"
    "n = hvd.size()\n"
    "for i in range(6):\n"
    "    if rank == 3 and 1 <= i <= 4:\n"
    "        time.sleep(0.2)\n"
    "    hvd.allreduce(ones(16), name=f'skew.{i}')\n"
    "if rank == 0:\n"
    "    snap = top.metrics_snapshot()\n"
    "    last = snap['skew']['last_to_announce']\n"
    "    rec['last_to_announce'] = max(last, key=last.get)\n"
    "    rec['skew_observed'] = (\n"
    "        snap['histograms']['announce_skew_sec']['count'] > 0)\n"
    "for step in range(4):\n"
    "    out = hvd.allreduce(arange(64) + rank, average=False,\n"
    "                        name='tree.sum')\n"
    "    assert as_list(out) == as_list(arange(64) * n + sum(range(n)))\n"
    "    avg = hvd.allreduce(zeros(8) + float(rank), average=True,\n"
    "                        name='tree.avg')\n"
    "    rec[f'avg{step}'] = as_list(avg)\n"
    "rows = hvd.allgather(zeros(3 * (rank + 1)).reshape(rank + 1, 3) + rank,\n"
    "                     name='tree.ag')\n"
    "rec['gather'] = as_list(rows)\n"
    "src = arange(5) * 2 if rank == 2 else zeros(5)\n"
    "rec['bcast'] = as_list(hvd.broadcast(src, 2, name='tree.bc'))\n"
    "ctrl = top.metrics_snapshot()['control']\n"
    "rec['tree'] = shape(ctrl)\n"
    "rec['tree_frames_sent'] = ctrl['frames']['sent'] > 0\n"
    "hvd.shutdown()\n"
    "os.environ['HVD_TPU_STEADY_THRESHOLD'] = '4'\n"
    "INIT()\n"
    "for s in range(14):\n"
    "    out = hvd.allreduce(ones(8), average=False, name='ts.x')\n"
    "    assert as_list(out) == [float(n)] * 8, s\n"
    "ctrl = top.metrics_snapshot()['control']\n"
    "rec['steady_tree'] = ctrl['tree']\n"
    "rec['steady_entered'] = ctrl['steady']['entries'] >= 1\n"
    "rec['steady_cycles'] = ctrl['steady']['cycles'] > 0\n"
    "pm = importlib.import_module(top.__name__ + '.common.postmortem')\n"
    "kinds = {e['event'] for e in pm.parse_engine_ring(\n"
    "    lib().hvd_tpu_flight_dump().decode())}\n"
    "rec['steady_flight_event'] = 'steady' in kinds\n"
    "hvd.shutdown()\n"
    "print('REC ' + json.dumps(rec), flush=True)\n"
)


@pytest.fixture(scope="module")
def np4():
    """Both packages' records of the np 4 program, by rank."""
    port, ref = twin.both(_NP4, 4, timeout=120.0)
    assert not twin.failures(port) and not twin.failures(ref), (
        twin.failures(port), twin.failures(ref))
    return tuple({r: json.loads(v[-1]) for r, v in
                  twin.lines(results, "REC").items()}
                 for results in (port, ref))


def test_single_host_layout_keeps_star(np4):
    port, ref = np4
    for r in range(4):
        assert port[r]["star"] == ref[r]["star"]
        assert port[r]["star"]["tree"] is False
        assert (port[r]["star"]["depth"], port[r]["star"]["hosts"]) == (1, 1)
        assert port[r]["star_sum"] == [4.0] * 8


def test_tree_collectives_and_control_section(np4):
    port, ref = np4
    for r in range(4):
        g, w = port[r], ref[r]
        for key in ("tree", "gather", "bcast", "tree_frames_sent") + tuple(
                f"avg{s}" for s in range(4)):
            assert g[key] == w[key], (r, key, g[key], w[key])
        assert g["tree"] == {"tree": True, "depth": 2, "hosts": 2,
                             "children": {0: 2, 1: 0, 2: 1, 3: 0}[r]}
        assert g["tree_frames_sent"]
        assert g["avg0"] == [1.5] * 8
        assert len(g["gather"]) == 10 and g["bcast"] == [0.0, 2.0, 4.0,
                                                         6.0, 8.0]


def test_tree_straggler_attribution_two_hosts(np4):
    """A delayed leaf (rank 3) is named last to announce on rank 0, not
    its sub-coordinator."""
    port, ref = np4
    assert port[0]["last_to_announce"] == ref[0]["last_to_announce"] == "3"
    assert port[0]["skew_observed"] and ref[0]["skew_observed"]


def test_steady_under_tree_with_flight_events(np4):
    port, ref = np4
    for r in range(4):
        for key in ("steady_tree", "steady_entered", "steady_cycles",
                    "steady_flight_event"):
            assert port[r][key] is ref[r][key] is True, (r, key)


_LEAF_CRASH = TREE + (
    "tree_layout()\n"
    "INIT()\n"
    "try:\n"
    "    for s in range(12):\n"
    "        hvd.allreduce(ones(8), average=False, name='tc.x')\n"
    "    raise SystemExit(9)\n"
    "except top.RanksDownError as e:\n"
    "    print('DOWN', sorted(e.ranks), flush=True)\n"
    "    raise SystemExit(0)\n"
)


def test_tree_leaf_crash_names_true_rank():
    """Rank 3 (a leaf under sub-coordinator 2) crashes: every survivor's
    ``RanksDownError`` names rank 3."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE

    env = twin.env(HVD_TPU_FAULT_SPEC="rank=3:crash@op=5",
                   HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20")
    port, ref = twin.both(_LEAF_CRASH, 4, timeout=90.0, port_env=env,
                          ref_env=env)
    for results in (port, ref):
        codes = {r.rank: r.returncode for r in results}
        assert codes == {0: 0, 1: 0, 2: 0, 3: CRASH_EXIT_CODE}, \
            twin.failures(results)
    got, want = twin.lines(port, "DOWN"), twin.lines(ref, "DOWN")
    assert got == want
    assert all("3" in got[r][-1] for r in (0, 1, 2)), got


_HANG = TREE + (
    "tree_layout()\n"
    "INIT()\n"
    "try:\n"
    "    for s in range(8):\n"
    "        hvd.allreduce(ones(8), average=False, name='th.x')\n"
    "    os._exit(9)\n"
    "except top.CollectiveTimeoutError as e:\n"
    "    print('TIMEOUT', 'th.x' in str(e), 'rank 3' in str(e), flush=True)\n"
    "    os._exit(7)\n"
)


@pytest.mark.slow
def test_tree_hang_diagnosis_names_hung_rank():
    """As the reference, slow: a Python-side hang on rank 3 behind the
    aggregation trips the collective timeout, and the diagnosis names
    rank 3."""
    env = twin.env(HVD_TPU_FAULT_SPEC="rank=3:hang@op=3",
                   HVD_TPU_COLLECTIVE_TIMEOUT_SEC="2")
    port, ref = twin.both(_HANG, 4, timeout=60.0, port_env=env,
                          ref_env=env)
    for results in (port, ref):
        codes = {r.rank: r.returncode for r in results}
        assert codes == {0: 7, 1: 7, 2: 7, 3: -9}, twin.failures(results)
        assert all(twin.lines(results, "TIMEOUT")[r] == ["True True"]
                   for r in (0, 1, 2))


# --- the simulated-scale fleet ----------------------------------------------

# Fields of the fleet's report that do not follow timing (the frames a
# star moves in its window do).
SIMSCALE_COUNTS = ("ok", "steady_entered", "coord_children")


def _simscale(lib, size, local, ops, warm, steady, threshold, tree,
              timeout=60.0):
    buf = ctypes.create_string_buffer(2048)
    rep = {}
    for _ in range(3):
        port = random.randint(30000, 58000)
        rc = lib.hvd_tpu_simscale_run(size, local, ops, warm, steady,
                                      threshold, int(tree), port, timeout,
                                      buf, 2048)
        rep = json.loads(buf.value.decode() or "{}")
        if rc == 0 and rep.get("ok"):
            return rep
    raise AssertionError(f"simscale failed after retries: {rep}")


def _both_fleets(*args, **kwargs):
    from horovod_tpu.common import _load_lib as ref_lib
    from horovod_tpu_torch.common import _load_lib as port_lib

    got = _simscale(port_lib(), *args, **kwargs)
    want = _simscale(ref_lib(), *args, **kwargs)
    assert set(got) == set(want), (got, want)
    assert {k: got[k] for k in SIMSCALE_COUNTS} == \
        {k: want[k] for k in SIMSCALE_COUNTS}, (got, want)
    return got, want


def test_simscale_smoke_tree_steady():
    """8 ranks, 2 a simulated host: rank 0 reads 4 children (its node's
    worker and 3 sub-coordinators), steady arms, and the steady window
    moves no control frame."""
    got, want = _both_fleets(8, 2, ops=2, warm=25, steady=10, threshold=4,
                             tree=True)
    assert got["steady_entered"] == 1
    assert got["steady_frames_delta"] == want["steady_frames_delta"] == 0
    assert got["coord_children"] == 4
    assert got["steady_cycles"] > 0 and want["steady_cycles"] > 0


def test_simscale_star_baseline_negotiates_every_cycle():
    got, want = _both_fleets(8, 2, ops=2, warm=15, steady=8, threshold=0,
                             tree=False)
    assert got["steady_entered"] == 0 and got["coord_children"] == 7
    assert got["steady_frames_delta"] > 0 and want["steady_frames_delta"] > 0


@pytest.mark.slow
def test_simscale_steady_flat_in_ranks():
    """As the reference, slow: the steady cycle at 64 simulated ranks
    within 1.5x (plus the thread-wake allowance) of 16 ranks', while the
    star's negotiated cycles grow several-fold; in both libraries."""
    from horovod_tpu.common import _load_lib as ref_lib
    from horovod_tpu_torch.common import _load_lib as port_lib

    for lib in (port_lib(), ref_lib()):
        small = _simscale(lib, 16, 4, ops=2, warm=30, steady=25,
                          threshold=6, tree=True, timeout=90.0)
        large = _simscale(lib, 64, 8, ops=2, warm=30, steady=25,
                          threshold=6, tree=True, timeout=120.0)
        assert small["steady_entered"] and large["steady_entered"]
        assert large["steady_frames_delta"] == 0, large
        assert large["steady_p50_us"] <= max(
            1.5 * small["steady_p50_us"], small["steady_p50_us"] + 500.0)
        star_small = _simscale(lib, 16, 4, ops=2, warm=10, steady=15,
                               threshold=0, tree=False, timeout=90.0)
        star_large = _simscale(lib, 64, 8, ops=2, warm=10, steady=15,
                               threshold=0, tree=False, timeout=120.0)
        assert star_large["steady_p50_us"] > \
            2.0 * star_small["steady_p50_us"]
        assert large["steady_p50_us"] < star_large["steady_p50_us"] / 4.0


@pytest.mark.parametrize("env", [
    {}, {"HVD_TPU_COORD_TREE": "0", "HVD_TPU_STEADY_THRESHOLD": "0",
         "HVD_TPU_STEADY_MAX_PERIOD": "64"},
    {"HVD_TPU_COORD_TREE": "1", "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
     "HVD_TPU_CROSS_ALGO_THRESHOLD": "0", "HVD_TPU_SHM": "force",
     "HVD_TPU_SHM_RING_BYTES": "65536",
     "HVD_TPU_NET_FAULT_SPEC": "link=0-1:delay=5"},
    {"HVD_TPU_HIERARCHICAL_ALLREDUCE": "yes", "HVD_TPU_SHM": ""},
])
def test_config_topology_knobs_match_the_reference(env, monkeypatch):
    from horovod_tpu.common import config as ref
    from horovod_tpu_torch.common import config as port

    for var in ("HVD_TPU_COORD_TREE", "HVD_TPU_STEADY_THRESHOLD",
                "HVD_TPU_STEADY_MAX_PERIOD", "HOROVOD_HIERARCHICAL_ALLREDUCE",
                "HVD_TPU_HIERARCHICAL_ALLREDUCE",
                "HVD_TPU_CROSS_ALGO_THRESHOLD", "HVD_TPU_SHM",
                "HVD_TPU_SHM_RING_BYTES", "HVD_TPU_NET_FAULT_SPEC"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = port.Config.from_env(), ref.Config.from_env()
    for field in ("coord_tree", "steady_threshold", "steady_max_period",
                  "hierarchical_allreduce", "cross_algo_threshold", "shm",
                  "shm_ring_bytes", "net_fault_spec"):
        assert getattr(got, field) == getattr(want, field), field
    assert port.Config.unported_requests() == []
