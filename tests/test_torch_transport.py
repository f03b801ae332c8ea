"""horovod_tpu_torch's shared-memory transport against horovod_tpu's
(``tests/test_transport.py``'s contracts; the rings, their arming and
their unlinks are the same C++ in both packages).

Each job runs one rank program (``tests/torch_twin.py``) under each
package's launcher at the same np and layout (nodes faked on one host
through ``HVD_TPU_LOCAL_SIZE``), and the two are held equal:

- the launcher's ``/dev/shm`` sweep: the same FNV-1a name prefix as the
  reference's (the engine's ``ShmSegmentName``), and it removes only the
  job's own segments;
- np 4 (2 nodes x 2): ``HVD_TPU_SHM=force`` against ``HVD_TPU_SHM=0``
  on the same buckets, bit for bit, and both against the reference's;
  ``local_transport`` ``shm`` then ``tcp``; the local peer's link on shm
  with bytes, hand-offs and a latency histogram, the cross peer's on
  TCP; the ``transport`` flight event; no segment left while the job
  runs;
- typed errors at np 2, the reference's messages: ranks that disagree on
  ``HVD_TPU_SHM``; ``force`` on the flat ring; ``force`` against a drop
  clause on a same-host link; under ``auto`` that clause demotes the
  node to TCP and the job runs;
- no residue after an injected crash (np 4), across a
  ``--max-restarts`` relaunch (which arms the rings again under the new
  epoch) and after an elastic 4 -> 3 shrink (elastic keeps the flat ring
  and TCP).
"""

import json
import os

import pytest

from tests import torch_twin as twin

HIER = (
    "import os, json\n"
    "rank = int(os.environ['HVD_TPU_RANK'])\n"
    "os.environ['HVD_TPU_LOCAL_SIZE'] = '2'\n"
    "os.environ['HVD_TPU_LOCAL_RANK'] = str(rank % 2)\n"
    "os.environ['HOROVOD_HIERARCHICAL_ALLREDUCE'] = '1'\n"
    "def residue():\n"
    "    prefix = _shm_job_prefix(os.environ['HVD_TPU_COORD'])\n"
    "    return [n for n in os.listdir('/dev/shm') if n.startswith(prefix)]\n"
)


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _residue(coords):
    """``/dev/shm`` segments of the jobs keyed on ``coords``."""
    from horovod_tpu_torch.runner.launch import _shm_job_prefix

    prefixes = tuple(_shm_job_prefix(c) for c in coords)
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefixes)]


def test_sweep_shm_segments_unit():
    """The port's prefix is the reference's; the sweep removes the
    segments keyed on its coordinator and leaves another job's."""
    from horovod_tpu.runner import launch as ref
    from horovod_tpu_torch.runner import launch as port

    for coord in ("127.0.0.1:45991", "127.0.0.1:45992", "host-a:58930"):
        assert port._shm_job_prefix(coord) == ref._shm_job_prefix(coord)
    coord = "127.0.0.1:45991"
    prefix = port._shm_job_prefix(coord)
    assert prefix.startswith("hvdtpu_") and len(prefix) == len("hvdtpu_") + 9
    assert prefix != port._shm_job_prefix("127.0.0.1:45992")
    mine = os.path.join("/dev/shm", prefix + "n0_e0")
    other_name = port._shm_job_prefix("127.0.0.1:45992") + "n0_e0"
    other = os.path.join("/dev/shm", other_name)
    for p in (mine, other):
        with open(p, "w") as f:
            f.write("x")
    try:
        assert port.sweep_shm_segments(coord) == [os.path.basename(mine)]
        assert not os.path.exists(mine) and os.path.exists(other)
    finally:
        for p in (mine, other):
            if os.path.exists(p):
                os.unlink(p)


# --- np 4: shm against TCP, bit for bit, with the telemetry ----------------

_IDENTITY = HIER + (
    "import hashlib\n"
    "def suite(tag):\n"
    "    h = hashlib.sha256()\n"
    "    for i in range(10):\n"
    "        x = (arange(96 + 11 * i) % 97) + rank + i\n"
    "        h.update(to_bytes(hvd.allreduce(x, average=(i % 2 == 1),\n"
    "                                        name=f'{tag}.mix.{i}')))\n"
    "    big = arange(1 << 17) % 241 + rank\n"
    "    h.update(to_bytes(hvd.allreduce(big, average=False,\n"
    "                                    name=f'{tag}.big')))\n"
    "    return h.hexdigest()\n"
    "rec = {}\n"
    "os.environ['HVD_TPU_SHM'] = 'force'\n"
    "INIT()\n"
    "rec['shm'] = suite('shm')\n"
    "rec['residue_while_running'] = residue()\n"
    "snap = top.metrics_snapshot()\n"
    "rec['shm_transport'] = snap['topology']['local_transport']\n"
    "peers = snap['links']['peers']\n"
    "lp = peers[str(rank + 1 if rank % 2 == 0 else rank - 1)]\n"
    "rec['local_peer'] = {k: lp[k] for k in ('transport', 'shm_bytes_out',\n"
    "    'shm_bytes_in', 'shm_handoffs', 'shm_us_count')}\n"
    "rec['local_peer']['buckets_sum'] = sum(lp['shm_us_buckets'])\n"
    "rec['cross_peer'] = peers[str(rank + 2 if rank < 2 else rank - 2)][\n"
    "    'transport']\n"
    "rec['flight'] = '|transport|shm|' in lib().hvd_tpu_flight_dump().decode()\n"
    "hvd.shutdown()\n"
    "os.environ['HVD_TPU_SHM'] = '0'\n"
    "INIT()\n"
    "rec['tcp_transport'] = top.metrics_snapshot()['topology'][\n"
    "    'local_transport']\n"
    "rec['tcp'] = suite('shm')\n"
    "hvd.shutdown()\n"
    "rec['residue_after'] = residue()\n"
    "print('REC ' + json.dumps(rec), flush=True)\n"
)


def test_shm_bit_identical_to_tcp_with_telemetry():
    port, ref = twin.both(_IDENTITY, 4, timeout=120.0)
    assert not twin.failures(port) and not twin.failures(ref), (
        twin.failures(port), twin.failures(ref))
    got = {r: json.loads(v[-1]) for r, v in twin.lines(port, "REC").items()}
    want = {r: json.loads(v[-1]) for r, v in twin.lines(ref, "REC").items()}
    for r in range(4):
        g, w = got[r], want[r]
        assert g["shm"] == g["tcp"] == w["shm"] == w["tcp"], r
        assert (g["shm_transport"], g["tcp_transport"]) == \
            (w["shm_transport"], w["tcp_transport"]) == ("shm", "tcp")
        assert g["local_peer"]["transport"] == "shm"
        assert g["cross_peer"] == w["cross_peer"] == "tcp"
        lp = g["local_peer"]
        assert lp["shm_bytes_out"] > 0 and lp["shm_bytes_in"] > 0, lp
        assert lp["shm_handoffs"] > 0 and lp["shm_us_count"] > 0, lp
        assert lp["buckets_sum"] == lp["shm_us_count"], lp
        assert g["flight"] and w["flight"]
        assert g["residue_while_running"] == g["residue_after"] == []
    # Every rank holds the same sums.
    assert len({got[r]["shm"] for r in range(4)}) == 1


# --- typed configuration errors --------------------------------------------

_INIT_OUTCOME = (
    "try:\n"
    "    INIT()\n"
    "    print('ERR none', flush=True)\n"
    "except Exception as exc:\n"
    "    print('ERR ' + type(exc).__name__ + ': '\n"
    "          + str(exc).replace('\\n', ' '), flush=True)\n"
)


def _outcomes(body, **env):
    port, ref = twin.both(body + _INIT_OUTCOME, 2, timeout=90.0,
                          port_env=twin.env(**env), ref_env=twin.env(**env))
    got = {r: v[-1] for r, v in twin.lines(port, "ERR").items()}
    want = {r: v[-1] for r, v in twin.lines(ref, "ERR").items()}
    assert got == want, (got, want)
    return got


@pytest.mark.parametrize("case", ["mismatch", "force_flat", "force_drop"])
def test_shm_typed_errors_match_the_reference(case):
    """Ranks that disagree on the transport, ``force`` on the flat ring,
    and ``force`` against a drop clause the rings cannot express each
    fail ``init()`` on every rank with the reference's error."""
    if case == "mismatch":
        got = _outcomes("import os\n"
                        "os.environ['HVD_TPU_SHM'] = ('auto' if int(\n"
                        "    os.environ['HVD_TPU_RANK']) == 0 else '0')\n")
        assert all("HVD_TPU_SHM mismatch" in v for v in got.values()), got
    elif case == "force_flat":
        got = _outcomes("", HVD_TPU_SHM="force")
        assert all("HVD_TPU_SHM=force" in v for v in got.values()), got
    else:
        got = _outcomes(HIER, HVD_TPU_SHM="force",
                        HVD_TPU_NET_FAULT_SPEC="link=0-1:drop@after=100000")
        for v in got.values():
            assert "HVD_TPU_SHM=force" in v and "link=0-1" in v, v
            assert "drop" in v, v
    assert all(v.startswith("HorovodInternalError") for v in got.values())


_DEMOTE = HIER + (
    "INIT()\n"
    "t = top.metrics_snapshot()['topology']['local_transport']\n"
    "out = hvd.allreduce(ones(64), average=False, name='d.0')\n"
    "print('DEMOTED', t, as_list(out)[:2], flush=True)\n"
    "hvd.shutdown()\n"
)


def test_shm_auto_demotes_on_chaos_drop():
    """Under ``auto`` the same drop clause (never firing here) demotes the
    node to TCP with a warning, and the job runs over the sockets."""
    env = twin.env(HVD_TPU_SHM="auto",
                   HVD_TPU_NET_FAULT_SPEC="link=0-1:drop@after=100000")
    port, ref = twin.both(_DEMOTE, 2, timeout=90.0, port_env=env,
                          ref_env=env)
    assert not twin.failures(port) and not twin.failures(ref)
    got, want = twin.lines(port, "DEMOTED"), twin.lines(ref, "DEMOTED")
    assert got == want == {r: ["tcp [2.0, 2.0]"] for r in range(2)}
    warned = [{r.rank for r in results
               if "WARNING" in r.stderr and "link=0-1" in r.stderr}
              for results in (port, ref)]
    assert warned[0] == warned[1] and warned[0], warned


# --- segment lifecycle ------------------------------------------------------

_CRASH = (
    "import os\n"
    "os.environ['HOROVOD_HIERARCHICAL_ALLREDUCE'] = '1'\n"
    "os.environ['HVD_TPU_SHM'] = 'force'\n"
    "print('COORD', os.environ['HVD_TPU_COORD'], flush=True)\n"
    "INIT()\n"
    "assert top.metrics_snapshot()['topology']['local_transport'] == 'shm'\n"
    "try:\n"
    "    for i in range(8):\n"
    "        hvd.allreduce(ones(4096), name=f's.{i}')\n"
    "    raise SystemExit(9)  # the survivors must not complete\n"
    "except top.RanksDownError:\n"
    "    raise SystemExit(0)\n"
)


def test_no_shm_residue_after_injected_crash():
    """Rank 1 crashed (``crash@op=3``) in a job on armed rings: the
    survivors fail typed, the crashed rank exits with the injector's
    code, and no segment is left."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE

    env = twin.env(HVD_TPU_FAULT_SPEC="rank=1:crash@op=3",
                   HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20")
    port, ref = twin.both(_CRASH, 4, timeout=90.0, port_env=env,
                          ref_env=env)
    for results in (port, ref):
        codes = {r.rank: r.returncode for r in results}
        assert codes == {0: 0, 1: CRASH_EXIT_CODE, 2: 0, 3: 0}, \
            twin.failures(results)
        coords = {v[-1] for v in twin.lines(results, "COORD").values()}
        assert not _residue(coords), _residue(coords)


_RELAUNCH = (
    "import os\n"
    "os.environ['HOROVOD_HIERARCHICAL_ALLREDUCE'] = '1'\n"
    "os.environ['HVD_TPU_SHM'] = 'force'\n"
    "with open(os.environ['TWIN_COORDS'], 'a') as f:\n"
    "    f.write(os.environ['HVD_TPU_COORD'] + '\\n')\n"
    "INIT()\n"
    "for i in range(8):\n"
    "    hvd.allreduce(ones(256), name=f's.{i}')\n"
    "print('TRANSPORT', top.restart_epoch(),\n"
    "      top.metrics_snapshot()['topology']['local_transport'],\n"
    "      flush=True)\n"
    "hvd.shutdown()\n"
)


def test_max_restarts_relaunch_rebuilds_shm(tmp_path):
    """A ``--max-restarts`` relaunch arms the rings again under restart
    epoch 1, and neither attempt leaves a segment."""
    envs = [twin.env(HVD_TPU_FAULT_SPEC="rank=1:crash@op=5",
                     HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20",
                     TWIN_COORDS=str(tmp_path / f"{tag}.coords"))
            for tag in ("port", "ref")]
    port, ref = twin.both(_RELAUNCH, 4, timeout=120.0, how="elastic",
                          max_restarts=1, port_env=envs[0], ref_env=envs[1])
    for tag, (results, restarts) in (("port", port), ("ref", ref)):
        assert restarts == 1, tag
        assert not twin.failures(results), twin.failures(results)
        assert twin.lines(results, "TRANSPORT") == {
            r: ["1 shm"] for r in range(4)}, tag
        coords = set((tmp_path / f"{tag}.coords").read_text().split())
        assert len(coords) == 2, coords  # fresh endpoints per attempt
        assert not _residue(coords), _residue(coords)


_ELASTIC = (
    "import os\n"
    "with open(os.environ['TWIN_COORDS'], 'a') as f:\n"
    "    f.write(os.environ['HVD_TPU_COORD'] + '\\n')\n"
    "INIT()\n"
    "state = top.ElasticState(weights=zeros(8), step=0)\n"
    "def train(state):\n"
    "    while state.step < 20:\n"
    "        s = state.step\n"
    "        state.weights = state.weights + hvd.allreduce(\n"
    "            ones(8), average=True, name=f'g.{s}')\n"
    "        state.step = s + 1\n"
    "    return state.weights\n"
    "w = top.run_elastic(train, state)\n"
    "print('DONE', as_list(w)[0],\n"
    "      top.metrics_snapshot()['topology']['local_transport'],\n"
    "      flush=True)\n"
)


def test_elastic_forces_tcp_and_shrinks_clean(tmp_path):
    """Elastic membership keeps the flat ring, so ``auto`` never arms the
    rings: a 4 -> 3 shrink completes on TCP and leaves no segment."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE

    envs = [twin.env(HVD_TPU_FAULT_SPEC="rank=2:crash@op=8",
                     HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20",
                     HOROVOD_HIERARCHICAL_ALLREDUCE="1", HVD_TPU_SHM="auto",
                     TWIN_COORDS=str(tmp_path / f"{tag}.coords"))
            for tag in ("port", "ref")]
    port, ref = twin.both(_ELASTIC, 4, timeout=90.0, how="membership",
                          min_np=2, max_np=4, max_rejoins=0,
                          port_env=envs[0], ref_env=envs[1])
    for tag, results in (("port", port), ("ref", ref)):
        codes = {r.rank: r.returncode for r in results}
        assert codes == {0: 0, 1: 0, 2: CRASH_EXIT_CODE, 3: 0}, \
            twin.failures(results)
        done = twin.lines(results, "DONE")
        assert all(done[r] == ["20.0 tcp"] for r in (0, 1, 3)), done
        coords = set((tmp_path / f"{tag}.coords").read_text().split())
        assert not _residue(coords), _residue(coords)
