"""horovod_tpu_torch's network fault injector and heartbeat detector
against horovod_tpu's (``tests/test_faults.py``'s network chaos cases;
the link faults, ``engine/cc/net.cc``, and the detector are the engine's
C++ in both packages).

``HVD_TPU_NET_FAULT_SPEC`` is parsed by the engine at init and shapes
the sends of the links it names.  One rank program
(``tests/torch_twin.py``) runs under each package's launcher at the same
np, and the two are held equal:

- a malformed clause fails ``init()`` with the reference's typed
  ``bad HVD_TPU_NET_FAULT_SPEC`` message naming it;
- np 4, rank 2 frozen (``SIGSTOP``, the process injector): only the
  heartbeats can see it; every survivor's ``RanksDownError`` names
  exactly rank 2, in heartbeat time (collective timeout 30 s);
- np 4, ``partition=0,1/2,3@after=4``: the cut swallows every byte
  across it, and both sides abort typed, each naming only ranks on the
  far side;
- np 2, ``link=0-1:flaky=0.05``: the chopped writes are absorbed, every
  sum exact, no eviction, the liveness section and its Prometheus
  families live, the ``faults`` section empty as the reference's (it
  counts the process injector's firings);
- (slow, as in the reference) np 4, ``link=0-2:delay=5``: ranks 0 and 2
  name ``slow_link`` 0-2 (snapshot, flight event, rank 0's
  ``/cluster``, ``tools/hvdtop.py``), ranks 1 and 3 no verdict.
"""

import json
import os
import time

import pytest

from tests import torch_twin as twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEARTBEAT = {"HVD_TPU_HEARTBEAT_MS": "100", "HVD_TPU_HEARTBEAT_MISS": "10"}


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


_BAD_CLAUSE = (
    "try:\n"
    "    INIT()\n"
    "    print('ERR none', flush=True)\n"
    "except top.HorovodInternalError as e:\n"
    "    print('ERR', str(e), flush=True)\n"
)


def test_net_fault_spec_rejects_bad_clause():
    env = twin.env(HVD_TPU_NET_FAULT_SPEC="link=0-1:frobnicate")
    port, ref = twin.both(_BAD_CLAUSE, 1, timeout=60.0, port_env=env,
                          ref_env=env)
    got, want = twin.lines(port, "ERR"), twin.lines(ref, "ERR")
    assert got == want, (got, want)
    assert "bad HVD_TPU_NET_FAULT_SPEC" in got[0][-1], got
    assert "frobnicate" in got[0][-1], got


_FREEZE = (
    "import os, time\n"
    "INIT()\n"
    "t0 = time.monotonic()\n"
    "try:\n"
    "    for i in range(200):\n"
    "        hvd.allreduce(ones(8), name=f'hb.{i}')\n"
    "        time.sleep(0.02)\n"
    "    os._exit(9)  # the survivors must not complete\n"
    "except top.RanksDownError as e:\n"
    "    print('DOWN', sorted(e.ranks), 'data-plane heartbeats' in str(e),\n"
    "          round(time.monotonic() - t0, 3), flush=True)\n"
    "    os._exit(7)  # non-zero: the launcher grace-kills the frozen rank\n"
)


def test_nonelastic_freeze_detected_in_heartbeat_time(monkeypatch):
    # The survivors exit typed at once; the frozen rank is killed after
    # the launchers' kill grace, which they read here.
    monkeypatch.setenv("HVD_TPU_KILL_GRACE_SEC", "3")
    env = twin.env(HVD_TPU_FAULT_SPEC="rank=2:freeze@op=2",
                   HVD_TPU_COLLECTIVE_TIMEOUT_SEC="30", **HEARTBEAT)
    t0 = time.monotonic()
    port, ref = twin.both(_FREEZE, 4, timeout=90.0, port_env=env,
                          ref_env=env)
    assert time.monotonic() - t0 < 90.0
    for results in (port, ref):
        codes = {r.rank: r.returncode for r in results}
        assert codes == {0: 7, 1: 7, 2: -9, 3: 7}, twin.failures(results)
    seen = [{r: v[-1].rsplit(" ", 1) for r, v in
             twin.lines(results, "DOWN").items() if v}
            for results in (port, ref)]
    for r in (0, 1, 3):
        assert seen[0][r][0] == seen[1][r][0] == "[2] True", seen
        # The miss window is 1 s; the promote poll adds at most 2.
        assert float(seen[0][r][1]) < 10.0, seen


_PARTITION = (
    "import os, time\n"
    "INIT()\n"
    "t0 = time.monotonic()\n"
    "me = hvd.rank()\n"
    "far = {2, 3} if me in (0, 1) else {0, 1}\n"
    "try:\n"
    "    for i in range(400):\n"
    "        hvd.allreduce(ones(8), name=f'p.{i}')\n"
    "        time.sleep(0.02)\n"
    "    os._exit(9)  # nobody trains through a partition\n"
    "except top.RanksDownError as e:\n"
    "    print('DOWN', bool(e.ranks) and set(e.ranks) <= far,\n"
    "          round(time.monotonic() - t0, 3), flush=True)\n"
    "    os._exit(7)\n"
)


def test_partition_aborts_both_sides():
    """``@after=4``: the clause arms 4 s after each engine starts, past the
    start-up skew of 4 interpreters."""
    env = twin.env(HVD_TPU_NET_FAULT_SPEC="partition=0,1/2,3@after=4",
                   HVD_TPU_COLLECTIVE_TIMEOUT_SEC="30", **HEARTBEAT)
    port, ref = twin.both(_PARTITION, 4, timeout=90.0, port_env=env,
                          ref_env=env)
    for results in (port, ref):
        assert {r.rank: r.returncode for r in results} == {
            r: 7 for r in range(4)}, twin.failures(results)
        for r, v in twin.lines(results, "DOWN").items():
            named_far, seconds = v[-1].split()
            assert named_far == "True", (r, v)
            assert float(seconds) < 15.0, (r, v)


_FLAKY = (
    "import importlib, json, time\n"
    "INIT()\n"
    "want = as_list(arange(512) * 2.0 + 1.0)\n"
    "for i in range(30):\n"
    "    out = hvd.allreduce(arange(512) + hvd.rank(), average=False,\n"
    "                        name=f'fl.{i}')\n"
    "    assert as_list(out) == want, i\n"
    "time.sleep(0.3)  # three heartbeat intervals: the 30 sums can be faster\n"
    "snap = top.metrics_snapshot()\n"
    "lv = snap['liveness']\n"
    "metrics = importlib.import_module(top.__name__ + '.common.metrics')\n"
    "text = metrics.prometheus_text(snap)\n"
    "print('LIVE ' + json.dumps({\n"
    "    'interval_ms': lv['interval_ms'], 'miss_limit': lv['miss_limit'],\n"
    "    'sent': lv['frames']['sent'] > 0,\n"
    "    'received': lv['frames']['received'] > 0,\n"
    "    'evictions': lv['evictions'], 'peers': bool(lv['peers']),\n"
    "    'faults': snap['faults']['injected'],\n"
    "    'families': ['hvd_tpu_liveness_frames_total' in text,\n"
    "                 'hvd_tpu_liveness_peer_age_us' in text]}), flush=True)\n"
)


def test_flaky_link_degrades_transparently():
    """The flaky link's chops and stalls are absorbed: exact sums, no
    eviction.  ``faults`` counts the process injector's firings only, in
    both packages: it stays empty here (a chop is a shorter first write
    that the send loop finishes, which no counter tells apart)."""
    env = twin.env(HVD_TPU_NET_FAULT_SPEC="link=0-1:flaky=0.05", **HEARTBEAT)
    port, ref = twin.both(_FLAKY, 2, timeout=90.0, port_env=env, ref_env=env)
    assert not twin.failures(port) and not twin.failures(ref), (
        twin.failures(port), twin.failures(ref))
    got, want = twin.lines(port, "LIVE"), twin.lines(ref, "LIVE")
    assert got == want, (got, want)
    for r in range(2):
        assert json.loads(got[r][-1]) == {
            "interval_ms": 100, "miss_limit": 10, "sent": True,
            "received": True, "evictions": 0, "peers": True,
            "faults": {}, "families": [True, True]}


_LOCALIZE = (
    "import json, os, subprocess, sys, time, urllib.request\n"
    "INIT()\n"
    "r = hvd.rank()\n"
    "for i in range(250):\n"
    "    hvd.allreduce(ones(64), name=f'ln.{i}')\n"
    "time.sleep(1.5)  # verdicts land on idle sweeps after the stepping\n"
    "snap = top.metrics_snapshot()\n"
    "links, an = snap['links'], snap['anomalies']\n"
    "rec = {'links': links['enabled'] and any(\n"
    "           v['send_us_count'] > 0 for v in links['peers'].values()),\n"
    "       'sigma': an['sigma'], 'interval_ms': an['interval_ms'],\n"
    "       'slow_links': sorted({e['subject'] for e in an['log']\n"
    "                             if e['kind'] == 'slow_link'}),\n"
    "       'verdicts': sum(an['verdicts'].values()),\n"
    "       'flight': '|anomaly|' in lib().hvd_tpu_flight_dump().decode()}\n"
    "if r == 0:\n"
    "    port = int(os.environ['HVD_TPU_MONITOR_PORT'])\n"
    "    doc = json.load(urllib.request.urlopen(\n"
    "        f'http://127.0.0.1:{port}/cluster', timeout=10))\n"
    "    ca = doc['anomalies']\n"
    "    rec['cluster'] = [ca['total'] >= 2,\n"
    "                      ca['verdicts'].get('slow_link', 0) >= 2,\n"
    "                      sorted({e['subject'] for e in ca['recent']\n"
    "                              if e['kind'] == 'slow_link'}),\n"
    "                      sorted({int(e['rank']) for e in ca['recent']})]\n"
    "    top_ = subprocess.run([sys.executable, os.path.join(\n"
    "        os.environ['TWIN_REPO'], 'tools', 'hvdtop.py'), '--port',\n"
    "        str(port), '--once'], capture_output=True, text=True,\n"
    "        timeout=30)\n"
    "    rec['hvdtop'] = [top_.returncode, 'slow_link(0-2)' in top_.stdout,\n"
    "                     '<< slow_link' in top_.stdout]\n"
    "print('LOC ' + json.dumps(rec), flush=True)\n"
    "hvd.allreduce(ones(1), name='loc.barrier')  # monitors up till scraped\n"
    "hvd.shutdown()\n"
)


@pytest.mark.slow
def test_chaos_localization_names_the_slow_link():
    from horovod_tpu_torch.common.basics import pick_free_port

    envs = [twin.env(HVD_TPU_NET_FAULT_SPEC="link=0-2:delay=5",
                     HVD_TPU_ANOMALY_INTERVAL_MS="50",
                     HVD_TPU_HEARTBEAT_MS="50", HVD_TPU_FLIGHT_EVENTS="8192",
                     HVD_TPU_MONITOR_PORT=str(pick_free_port("127.0.0.1")),
                     TWIN_REPO=REPO)
            for _ in range(2)]
    port, ref = twin.both(_LOCALIZE, 4, timeout=120.0,
                          port_env=envs[0], ref_env=envs[1])
    for results in (port, ref):
        assert not twin.failures(results), twin.failures(results)
        recs = {r: json.loads(v[-1])
                for r, v in twin.lines(results, "LOC").items()}
        for r, rec in recs.items():
            assert rec["links"] and (rec["sigma"], rec["interval_ms"]) == (
                5, 50), rec
            if r in (0, 2):
                assert rec["slow_links"] == ["0-2"] and rec["flight"], rec
            else:
                assert rec["verdicts"] == 0, rec
        assert recs[0]["cluster"][:3] == [True, True, ["0-2"]], recs[0]
        assert set(recs[0]["cluster"][3]) <= {0, 2}, recs[0]
        assert recs[0]["hvdtop"] == [0, True, True], recs[0]
