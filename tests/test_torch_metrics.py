"""horovod_tpu_torch's metrics registry, exposition and monitor against
horovod_tpu's.

- The same recorder calls, drawn from a numpy seed, on both registries:
  equal snapshots and Prometheus text equal line for line (the one line
  that differs on purpose is ``step_sec``'s description, which names the
  port's train and serving steps).
- The reference's registry cases (``tests/test_metrics.py``: snapshot
  shape, counters, histogram sums, reset, threads, the endpoint, the pure
  text) on the port, at size 1 on CPU tensors.
- The exposition of a fully populated registry scraped from the port's
  monitor, through ``tools/hvdlint/metrics_check.py``'s ``lint`` and
  ``lint_sections``; the skew, link and anomaly families; ``/health`` and
  ``/cluster`` equal to the reference's for the same registries.
- The engine-fed sections at np 2: named allreduces, an allgather, a
  broadcast and one stall under both packages' engines give the same
  section keys and the same ops, bytes, aborts, cache hits and misses and
  flight events; ``step_sec`` counts the port's train steps.
- The monitor: ``HVD_TPU_MONITOR_PORT`` and ``HVD_TPU_METRICS_FILE`` at
  init, ``port + local_rank``, a scrape during an np 2 job whose dumps
  ``tools/metrics_dump.py`` renders (its stragglers and links views), and
  rank 0's ``/cluster`` over an np 3 job, rendered by ``tools/hvdtop.py``.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tests.torch_watch import ENV, watched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_HELP = "# HELP hvd_tpu_step_seconds "


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    """Both engines built before any timed launch."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **ENV,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_FAULT_SPEC", "HVD_TPU_METRICS",
                "HVD_TPU_POSTMORTEM_DIR", "HVD_TPU_MONITOR_PORT",
                "HVD_TPU_METRICS_FILE"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in overrides.items()})
    return env


def _port_job(code, np_, timeout=120.0, **env):
    from horovod_tpu_torch.runner import run_command

    with watched(timeout + 10, f"port job at np {np_}"):
        results = run_command([sys.executable, "-c", code], np_,
                              env=_env(**env), timeout=timeout, capture=True)
    for r in results:
        assert r.returncode == 0, (r.rank, r.returncode, r.stderr[-2000:])
    return results


# ---------------------------------------------------------------------------
# The same recorder calls on both registries.
# ---------------------------------------------------------------------------


def _drive(reg, metrics, seed, n=300):
    """``n`` recorder calls drawn from ``seed`` (every recorder, the
    stall-name and tenant caps crossed, a reset half way)."""
    rng = np.random.RandomState(seed)
    planes, ops = ("engine", "xla"), ("allreduce", "allgather", "broadcast")

    def pick(xs):
        return xs[rng.randint(len(xs))]

    def peer():
        return {"bytes_out": int(rng.randint(1e6)),
                "bytes_in": int(rng.randint(1e6)),
                "sends": int(rng.randint(99)), "recvs": int(rng.randint(99)),
                "stalls": int(rng.randint(3)),
                "short_writes": int(rng.randint(3)),
                "send_us_sum": int(rng.randint(1e5)),
                "send_us_count": int(rng.randint(1, 99)),
                "send_us_buckets": [int(x) for x in rng.randint(9, size=10)],
                "rtt_last_us": int(rng.randint(500)),
                "rtt_ewma_us": int(rng.randint(500)),
                "rtt_samples": int(rng.randint(3)),
                "transport": "tcp"}

    calls = [
        lambda: reg.record_enqueue(pick(planes), pick(ops),
                                   int(rng.randint(1 << 20))),
        lambda: reg.record_bytes_out(pick(planes), int(rng.randint(1 << 20))),
        lambda: reg.record_batch(int(rng.randint(1, 9))),
        lambda: reg.observe(pick(sorted(metrics.HISTOGRAMS)),
                            float(rng.exponential(0.05))),
        lambda: reg.record_stall(f"t{rng.randint(300)}", float(rng.rand())),
        lambda: reg.record_stall('we"ird\nname', 1.5),
        lambda: reg.record_stall_count(int(rng.randint(3))),
        lambda: reg.record_fault(pick(("crash", "hang", "delay"))),
        lambda: reg.record_abort(pick(("ranks_down", "timeout")),
                                 int(rng.randint(1, 3))),
        lambda: reg.set_restart_epoch(int(rng.randint(3))),
        lambda: reg.record_cache(pick(planes),
                                 pick(("hits", "misses", "evictions")),
                                 int(rng.randint(1, 5))),
        lambda: reg.set_cache_size(pick(planes), int(rng.randint(99))),
        lambda: reg.record_last_announce(int(rng.randint(4)),
                                         int(rng.randint(1, 4))),
        lambda: reg.set_membership({
            "epoch": int(rng.randint(4)), "size": int(rng.randint(1, 5)),
            "reshapes": int(rng.randint(4)), "ranks_lost": [1],
            "ranks_joined": [int(rng.randint(4))]}),
        lambda: reg.set_flight({"events": {"engine": int(rng.randint(999)),
                                           "xla": 0},
                                "capacity": 512}),
        lambda: reg.set_compression({
            "mode": pick(("off", "bf16", "fp8")), "min_bytes": 1024,
            "planes": {"engine": {"wire_bytes": int(rng.randint(1e6)),
                                  "payload_bytes": int(rng.randint(1e6)),
                                  "ops": {"none": 1, "bf16": 2, "fp8": 0}}},
            "residual_bytes": int(rng.randint(1e4)),
            "residual_tensors": int(rng.randint(9))}),
        lambda: reg.set_topology({
            "hierarchical": bool(rng.randint(2)), "nodes": 2,
            "local_size": 2, "cross_algo_threshold": 65536,
            "cross_ops": {"ring": int(rng.randint(9)), "tree": 1},
            "bytes": {"local": int(rng.randint(1e6)), "cross": 7}}),
        lambda: reg.set_control({
            "tree": False, "children": int(rng.randint(4)), "hosts": 1,
            "steady": {"active": bool(rng.randint(2)), "pattern_len": 4,
                       "threshold": 32, "entries": 1, "exits": 0,
                       "replays": int(rng.randint(99)), "cycles": 3},
            "negotiated_ticks": int(rng.randint(99)),
            "frames": {"sent": int(rng.randint(99)), "received": 5}}),
        lambda: reg.set_liveness({
            "interval_ms": 100, "miss_limit": 10,
            "frames": {"sent": int(rng.randint(99)), "received": 3},
            "miss_events": 0, "evictions": 0, "clock_fanin": 1,
            "peers": {int(rng.randint(4)): {"age_us": int(rng.randint(999)),
                                            "misses": 0}}}),
        lambda: reg.set_links({"enabled": True,
                               "peers": {int(rng.randint(4)): peer()}}),
        lambda: reg.set_p2p({"sends": int(rng.randint(9)), "recvs": 2,
                             "bytes": {"out": int(rng.randint(999)),
                                       "in": 5},
                             "matched": 1, "unmatched": int(rng.randint(2)),
                             "group_ops": 0, "channels": 1}),
        lambda: reg.set_anomalies({
            "sigma": 5, "interval_ms": 500,
            "verdicts": {pick(metrics.ANOMALY_KINDS): int(rng.randint(4))},
            "log": [{"kind": "slow_link", "subject": f"0-{rng.randint(4)}",
                     "detail": "x", "age_us": int(rng.randint(1e6))}]}),
        lambda: reg.set_autotune({
            "enabled": True, "frozen": bool(rng.randint(2)),
            "windows": int(rng.randint(9)), "fusion_threshold": 1 << 20,
            "cycle_time_ms": float(rng.rand() * 9),
            "best_score": float(rng.rand()), "history": [], "applied": []}),
        lambda: reg.record_serving(pick(metrics.SERVING_EVENTS),
                                   f"ten{rng.randint(300)}",
                                   int(rng.randint(1, 3))),
        lambda: reg.record_serving_tokens(f"ten{rng.randint(300)}",
                                          pick(("prompt", "generated")),
                                          int(rng.randint(99))),
        lambda: reg.record_serving_step(int(rng.randint(9)), 8),
        lambda: reg.set_serving_gauges(queue_depth=int(rng.randint(9)),
                                       active=int(rng.randint(9))),
        lambda: reg.set_state_armed(bool(rng.randint(2))),
        lambda: reg.record_state_snapshot(int(rng.randint(99)),
                                          int(rng.randint(1e6))),
        lambda: reg.set_state_overlap(float(rng.rand()), float(rng.rand())),
        lambda: reg.record_state_peer(sent_bytes=int(rng.randint(999))),
        lambda: reg.record_state_peer(received_step=int(rng.randint(99))),
        lambda: reg.record_state_restore(pick(metrics.STATE_RESTORE_SOURCES)),
        lambda: reg.record_state_ckpt(pick(metrics.STATE_CKPT_EVENTS),
                                      nbytes=int(rng.randint(999))),
    ]
    for i in range(n):
        calls[rng.randint(len(calls))]()
        if i == n // 2:
            reg.reset()
    for i in range(300):  # past the 256-name caps
        reg.record_stall(f"cap{i}", 0.5)
        reg.record_serving("requests", f"cap{i}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_recorder_calls_same_snapshot_and_text(seed):
    from horovod_tpu.common import metrics as ref
    from horovod_tpu_torch.common import metrics

    port_reg, ref_reg = metrics.MetricsRegistry(), ref.MetricsRegistry()
    _drive(port_reg, metrics, seed)
    _drive(ref_reg, ref, seed)
    snap = port_reg.snapshot()
    assert snap == ref_reg.snapshot()
    assert list(snap) == list(ref_reg.snapshot())
    # 256 names each, then "<other>".
    assert len(snap["stalls"]["tensors"]) == 257
    assert len(snap["serving"]["tenants"]) == 257
    got = metrics.prometheus_text(snap).splitlines()
    want = ref.prometheus_text(snap).splitlines()
    assert len(got) == len(want)
    differ = [(a, b) for a, b in zip(got, want) if a != b]
    assert [a.startswith(STEP_HELP) and b.startswith(STEP_HELP)
            for a, b in differ] == [True], differ
    assert metrics.health_summary(snap) == ref.health_summary(snap)


# ---------------------------------------------------------------------------
# The reference's registry cases on the port (size 1, CPU tensors).
# ---------------------------------------------------------------------------


@pytest.fixture
def hvd_metrics(monkeypatch):
    """The port at size 1 with metrics enabled; the registry cleared
    before and after (it is process-global)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import common
    from horovod_tpu_torch.common import metrics

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_METRICS_FILE",
                "HVD_TPU_MONITOR_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HVD_TPU_METRICS", "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    hvd.metrics_reset()
    yield common
    hvd.metrics_reset()
    hvd.shutdown()
    metrics.registry.disable()


def test_snapshot_shape(hvd_metrics):
    from horovod_tpu.common import metrics as ref

    hvd = hvd_metrics
    hvd.allreduce(torch.ones(100), name="m.ar")
    snap = hvd.metrics_snapshot()
    assert snap["enabled"] is True
    for plane in ("engine", "xla"):
        assert set(snap["ops"][plane]) == {"allreduce", "allgather",
                                           "broadcast"}
        assert set(snap["bytes"][plane]) == {"in", "out"}
    assert set(snap["batches"]) == {"dispatched", "fused_tensors"}
    assert set(snap["stalls"]) == {"count", "tensors"}
    for hist in snap["histograms"].values():
        assert set(hist) == {"buckets", "counts", "sum", "count"}
        assert len(hist["counts"]) == len(hist["buckets"]) + 1
    assert json.loads(json.dumps(snap)) == snap
    empty = ref.MetricsRegistry().snapshot()
    assert list(snap) == list(empty)
    for key, value in empty.items():
        if isinstance(value, dict):
            assert set(snap[key]) == set(value), key


def test_counters_and_monotonicity(hvd_metrics):
    hvd = hvd_metrics
    x = torch.ones(256)
    hvd.allreduce(x, name="m.a")
    hvd.broadcast(x, 0, name="m.b")
    s1 = hvd.metrics_snapshot()
    assert s1["ops"]["engine"]["allreduce"] == 1
    assert s1["ops"]["engine"]["broadcast"] == 1
    assert s1["bytes"]["engine"]["in"] == 2 * 1024
    assert s1["bytes"]["engine"]["out"] == 2 * 1024
    hvd.allgather(torch.ones(4, 8), name="m.g")
    s2 = hvd.metrics_snapshot()
    for plane in ("engine", "xla"):
        for op in ("allreduce", "allgather", "broadcast"):
            assert s2["ops"][plane][op] >= s1["ops"][plane][op]
    assert s2["ops"]["engine"]["allgather"] == 1
    assert s2["bytes"]["engine"]["in"] == s1["bytes"]["engine"]["in"] + 128
    assert s2["bytes"]["engine"]["out"] == s1["bytes"]["engine"]["out"] + 128
    assert s2["ops"]["xla"] == {"allreduce": 0, "allgather": 0,
                                "broadcast": 0}


def test_histogram_bucket_sums(hvd_metrics):
    hvd = hvd_metrics
    n = 7
    for i in range(n):
        hvd.allreduce(torch.ones(32), name=f"m.h{i}")
    hists = hvd.metrics_snapshot()["histograms"]
    for name in ("wait_sec", "negotiation_sec"):
        hist = hists[name]
        assert hist["count"] == n, name
        assert sum(hist["counts"]) == n
        assert hist["buckets"] == sorted(hist["buckets"])
    assert hists["wait_sec"]["sum"] > 0.0


def test_reset_semantics(hvd_metrics):
    hvd = hvd_metrics
    hvd.allreduce(torch.ones(8), name="m.r")
    assert hvd.metrics_snapshot()["ops"]["engine"]["allreduce"] == 1
    hvd.metrics_reset()
    snap = hvd.metrics_snapshot()
    assert snap["ops"]["engine"]["allreduce"] == 0
    assert snap["bytes"]["engine"]["in"] == 0
    assert snap["stalls"] == {"count": 0, "tensors": {}}
    assert all(h["count"] == 0 for h in snap["histograms"].values())
    assert snap["cache"]["engine"]["misses"] == 0
    assert snap["enabled"] is True
    hvd.allreduce(torch.ones(8), name="m.r2")
    assert hvd.metrics_snapshot()["ops"]["engine"]["allreduce"] == 1


def test_thread_safety_smoke(hvd_metrics):
    """Concurrent allreduces from several threads: every op and byte is
    counted exactly once."""
    hvd = hvd_metrics
    threads, per_thread, nbytes = 4, 8, 64 * 4
    errors = []

    def work(t):
        try:
            for i in range(per_thread):
                out = hvd.allreduce(torch.full((64,), float(t)),
                                    name=f"m.t{t}.{i}")
                assert torch.allclose(out, torch.full((64,), float(t)))
        except Exception as exc:  # the failure is the result
            errors.append(exc)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    snap = hvd.metrics_snapshot()
    total = threads * per_thread
    assert snap["ops"]["engine"]["allreduce"] == total
    assert snap["bytes"]["engine"]["in"] == total * nbytes
    assert snap["bytes"]["engine"]["out"] == total * nbytes
    assert snap["histograms"]["wait_sec"]["count"] == total


def test_metrics_off_records_nothing_gated(monkeypatch):
    """With metrics off the collective layer records nothing: the
    hot path pays its one branch and no more."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import common
    from horovod_tpu_torch.common import metrics

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_METRICS", "HVD_TPU_METRICS_FILE",
                "HVD_TPU_MONITOR_PORT"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    metrics.registry.disable()
    hvd.init(device="cpu")
    try:
        hvd.metrics_reset()
        common.allreduce(torch.ones(8), name="off.a")
        snap = hvd.metrics_snapshot()
    finally:
        hvd.shutdown()
    assert snap["enabled"] is False
    assert snap["ops"]["engine"]["allreduce"] == 0
    assert snap["histograms"]["wait_sec"]["count"] == 0
    assert snap["cache"]["engine"]["misses"] == 1  # ungated


def test_prometheus_endpoint_and_json(hvd_metrics):
    from horovod_tpu_torch.common import metrics

    hvd = hvd_metrics
    hvd.allreduce(torch.ones(128), name="m.p")
    port = metrics.start_monitor(0, snapshot_fn=hvd.metrics_snapshot)
    try:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        sample = re.compile(
            r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [0-9.+\-einfa]+$")
        lines = [line for line in text.splitlines() if line]
        assert lines, text
        for line in lines:
            if line.startswith("#"):
                assert line.startswith(("# HELP ", "# TYPE ")), line
            else:
                assert sample.match(line), line
        assert 'hvd_tpu_ops_total{plane="engine",op="allreduce"} 1' in lines
        assert any(line.startswith('hvd_tpu_wait_seconds_bucket{le="+Inf"}')
                   for line in lines)
        assert "hvd_tpu_wait_seconds_count 1" in lines
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json",
            timeout=10).read().decode())
        assert snap["ops"] == hvd.metrics_snapshot()["ops"]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=10).read().decode())
        assert health["live"] is True and health["aborts"] == 0
        # No /cluster on a monitor without targets.
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/cluster",
                                   timeout=10)
    finally:
        metrics.stop_monitor()
    assert metrics.monitor_port() is None


def test_prometheus_text_pure():
    """prometheus_text renders a synthetic snapshot without an engine."""
    from horovod_tpu_torch.common.metrics import (MetricsRegistry,
                                                  prometheus_text)

    reg = MetricsRegistry()
    reg.record_enqueue("xla", "allreduce", 1024)
    reg.record_bytes_out("xla", 1024)
    reg.record_batch(3)
    reg.observe("bucket_fill", 0.42)
    reg.observe("negotiation_sec", 0.003)
    reg.record_stall('we"ird\nname', 1.5)
    text = prometheus_text(reg.snapshot())
    assert 'hvd_tpu_ops_total{plane="xla",op="allreduce"} 1' in text
    assert 'hvd_tpu_bytes_total{plane="xla",direction="out"} 1024' in text
    assert "hvd_tpu_fused_tensors_total 3" in text
    assert "hvd_tpu_stall_events_total 1" in text
    assert '\\"' in text and "\\n" in text
    assert "hvd_tpu_bucket_fill_ratio_count 1" in text
    assert "hvd_tpu_negotiation_seconds_count 1" in text


# ---------------------------------------------------------------------------
# Exposition conformance and the job view.
# ---------------------------------------------------------------------------


def _populated(metrics):
    """``tools/hvdlint/metrics_check.py``'s populated registry, built on
    ``metrics`` (either package's module)."""
    import inspect

    from tools.hvdlint import metrics_check

    src = inspect.getsource(metrics_check.populated_registry).replace(
        "from horovod_tpu.common import metrics\n", "")
    scope = {"metrics": metrics}
    exec(src, scope)
    return scope["populated_registry"]()


def test_prometheus_exposition_conformance():
    """The port's monitor output for a fully populated registry: every
    family paired ``# HELP``/``# TYPE``, named by the convention, every
    sample declared, every snapshot section exported and documented
    (``lint``, ``lint_sections``), and the snapshot the reference's."""
    from horovod_tpu.common import metrics as ref
    from horovod_tpu_torch.common import metrics
    from tools.hvdlint.metrics_check import (SECTION_FAMILIES,
                                             _metrics_doc_text, lint,
                                             lint_sections)

    reg = _populated(metrics)
    snap = reg.snapshot()
    assert snap == _populated(ref).snapshot()
    port = metrics.start_monitor(0, snapshot_fn=reg.snapshot)
    try:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    finally:
        metrics.stop_monitor()
        metrics.registry.disable()  # start_monitor enables the global one
    assert lint(text) == []
    assert lint_sections(snap, text, _metrics_doc_text(REPO)) == []
    helps, types = {}, {}
    for i, line in enumerate(text.splitlines()):
        if line.startswith("# HELP "):
            helps[line.split()[2]] = i
        elif line.startswith("# TYPE "):
            types[line.split()[2]] = i
    assert set(helps) == set(types)
    assert all(types[n] == helps[n] + 1 for n in types)
    expected = {f for fams in SECTION_FAMILIES.values() for f in fams}
    expected |= {metrics._prom_hist_name(h) for h in metrics.HISTOGRAMS}
    assert expected <= set(types), expected - set(types)
    # A section the lint does not know, or a family dropped, is caught.
    errors = lint_sections(dict(snap, mystery={"x": 1}), text,
                           _metrics_doc_text(REPO))
    assert any("mystery" in e for e in errors), errors
    pruned = "\n".join(line for line in text.splitlines()
                       if "hvd_tpu_flight" not in line)
    assert any("hvd_tpu_flight_events_total" in e
               for e in lint_sections(snap, pruned, _metrics_doc_text(REPO)))


def test_skew_links_and_anomalies_sections():
    """The straggler, link and anomaly sections, their families, and the
    ``/health`` and ``/cluster`` documents through the port's monitor,
    equal to the reference's for the same registries."""
    from horovod_tpu.common import metrics as ref
    from horovod_tpu_torch.common import metrics

    docs = {}
    for mod in (metrics, ref):
        reg = _populated(mod)
        reg.record_last_announce(2, 3)
        reg.observe("announce_skew_sec", 0.2)
        remote = mod.MetricsRegistry()
        remote.set_anomalies({"sigma": 5, "interval_ms": 500,
                              "verdicts": {"slow_link": 2},
                              "log": [{"kind": "slow_link", "subject": "0-2",
                                       "detail": "x", "age_us": 50}]})
        port = mod.start_monitor(0, snapshot_fn=remote.snapshot)
        try:
            mod.configure_cluster([(0, "127.0.0.1", 0),
                                   (2, "127.0.0.1", port)])
            doc = mod.cluster_document(reg.snapshot)
        finally:
            mod.stop_monitor()
            mod.registry.disable()
        docs[mod] = (reg.snapshot(), doc)
    snap, doc = docs[metrics]
    ref_snap, ref_doc = docs[ref]
    assert snap == ref_snap
    assert snap["skew"] == {"count": 5, "last_to_announce": {"1": 2, "2": 3}}
    text = metrics.prometheus_text(snap)
    assert 'hvd_tpu_last_to_announce_total{rank="2"} 3' in text
    assert 'hvd_tpu_link_send_latency_us_bucket{peer="1",le="+Inf"} 32' \
        in text
    assert 'hvd_tpu_link_rtt_us{peer="1",stat="ewma"} 200' in text
    assert doc == ref_doc
    assert doc["anomalies"]["total"] == 3
    assert doc["anomalies"]["recent"][0]["rank"] == "2"
    assert metrics.cluster_prometheus_text(doc) == \
        ref.cluster_prometheus_text(ref_doc)
    assert not metrics.cluster_configured()  # stop_monitor cleared it


# ---------------------------------------------------------------------------
# The engine-fed sections at np 2, against the reference's.
# ---------------------------------------------------------------------------

_ENGINE_SECTIONS = """
import json, os, sys, time
import numpy as np
{imports}
hvd.init({init})
hvd.metrics_reset()
r = hvd.rank()
for rnd in range(2):
    for i in range(3):
        out = {allreduce}(arr(100, r + i), average=False, name=f"m.ar.{{i}}")
        assert float(out[0]) == 2 * i + 1, out
    out = {allgather}(arr(4, r), name="m.ag")
    assert [float(v) for v in out] == [0.0] * 4 + [1.0] * 4
    out = {broadcast}(arr(6, r + 1), 1, name="m.bc")
    assert float(out[0]) == 2.0
if r == 0:
    h = {allreduce_async}(arr(4, 1), average=False, name="lonely")
    deadline = time.monotonic() + 20.0
    while (time.monotonic() < deadline
           and hvd.metrics_snapshot()["stalls"]["count"] < 1):
        time.sleep(0.05)
else:
    time.sleep(1.5)
    h = {allreduce_async}(arr(4, 1), average=False, name="lonely")
h.wait()
snap = hvd.metrics_snapshot()
ring = postmortem.parse_engine_ring(common._lib.hvd_tpu_flight_dump().decode())
snap["job_events"] = [(e["event"], e["name"]) for e in ring
                      if e["name"].startswith(("m.", "lonely"))
                      and e["event"] != "tick"]
snap["job_stalls"] = [e for e in snap["job_events"] if e[0] == "stall"]
snap["job_events"] = [e for e in snap["job_events"] if e[0] != "stall"]
{extra}
with open(os.path.join({out!r}, f"{tag}{{r}}.json"), "w") as f:
    json.dump(snap, f)
hvd.shutdown()
"""

_PORT_TRAIN = """
from horovod_tpu_torch.torch import DistributedOptimizer
from horovod_tpu_torch.torch.train import build_train_step
torch.manual_seed(0)
model = torch.nn.Linear(4, 2)
step = build_train_step(lambda m, b: m(b).pow(2).mean(),
                        torch.optim.SGD(model.parameters(), lr=0.1), model)
before = hvd.metrics_snapshot()["histograms"]["step_sec"]["count"]
for _ in range(3):
    step(torch.ones(2, 4) * (r + 1))
snap["step_sec_counted"] = (
    hvd.metrics_snapshot()["histograms"]["step_sec"]["count"] - before)
"""


def test_engine_sections_at_two_ranks_match_reference(tmp_path):
    from horovod_tpu.runner import run_command as ref_run

    out = str(tmp_path)
    code = {
        "port": _ENGINE_SECTIONS.format(
            imports="import torch, horovod_tpu_torch as hvd\n"
                    "from horovod_tpu_torch import common\n"
                    "from horovod_tpu_torch.common import postmortem\n"
                    "arr = lambda n, v: torch.full((n,), float(v))",
            init="device='cpu'", allreduce="common.allreduce",
            allgather="common.allgather", broadcast="common.broadcast",
            allreduce_async="common.allreduce_async", extra=_PORT_TRAIN,
            out=out, tag="port"),
        "ref": _ENGINE_SECTIONS.format(
            imports="import horovod_tpu as hvd\n"
                    "from horovod_tpu import common\n"
                    "from horovod_tpu.common import postmortem\n"
                    "arr = lambda n, v: np.full((n,), float(v), np.float32)",
            init="", allreduce="hvd.allreduce", allgather="hvd.allgather",
            broadcast="hvd.broadcast",
            allreduce_async="common.allreduce_async", extra="", out=out,
            tag="ref"),
    }
    env = dict(HVD_TPU_METRICS="1", HVD_TPU_STALL_WARNING_SEC="0.3")
    _port_job(code["port"], 2, **env)
    with watched(130, "reference job at np 2"):
        ref_results = ref_run([sys.executable, "-c", code["ref"]], 2,
                              env=_env(**env), timeout=120, capture=True)
    for r in ref_results:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    snaps = {}
    for pkg in ("port", "ref"):
        snaps[pkg] = []
        for r in range(2):
            with open(os.path.join(out, f"{pkg}{r}.json")) as f:
                snaps[pkg].append(json.load(f))
    for r in range(2):
        got, want = snaps["port"][r], snaps["ref"][r]
        assert got.pop("step_sec_counted") == 3
        assert list(got) == list(want)
        for key, value in want.items():
            if isinstance(value, dict):
                assert set(got[key]) == set(value), (r, key)
        # How often the coordinator's sweep flags the stall is timing's.
        stalls = [snap.pop("job_stalls") for snap in (got, want)]
        assert bool(stalls[0]) == bool(stalls[1]) == (r == 0), stalls
        for key in ("ops", "bytes", "batches", "faults", "job_events"):
            assert got[key] == want[key], (r, key, got[key], want[key])
        assert got["ops"]["engine"] == {"allreduce": 7, "allgather": 2,
                                        "broadcast": 2}
        for kind in ("hits", "misses"):
            assert got["cache"]["engine"][kind] == \
                want["cache"]["engine"][kind], (r, got["cache"])
        assert got["cache"]["engine"]["hits"] >= 5
        for name in ("negotiation_sec", "wait_sec"):
            assert got["histograms"][name]["count"] == \
                want["histograms"][name]["count"], name
        assert got["histograms"]["wait_sec"]["count"] == 11
        assert got["links"]["enabled"] and set(got["links"]["peers"]) == \
            set(want["links"]["peers"]) == {str(1 - r)}
        assert got["anomalies"]["sigma"] == want["anomalies"]["sigma"] == 5
        assert got["flight"]["capacity"] == want["flight"]["capacity"]
    got, want = snaps["port"][0], snaps["ref"][0]
    for snap in (got, want):
        assert snap["stalls"]["count"] >= 1
        assert "lonely" in snap["stalls"]["tensors"], snap["stalls"]
        assert snap["skew"]["count"] >= 10  # the coordinator's view


# ---------------------------------------------------------------------------
# The monitor, the metrics file and the job view.
# ---------------------------------------------------------------------------


def test_monitor_env_and_metrics_file(tmp_path, monkeypatch):
    """``HVD_TPU_MONITOR_PORT`` starts the monitor at init;
    ``HVD_TPU_METRICS_FILE`` writes this rank's dump at shutdown."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import common
    from horovod_tpu_torch.common import metrics

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_METRICS"):
        monkeypatch.delenv(var, raising=False)
    path = str(tmp_path / "metrics.json")
    monkeypatch.setenv("HVD_TPU_METRICS_FILE", path)
    monkeypatch.setenv("HVD_TPU_MONITOR_PORT", "0")
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        hvd.metrics_reset()
        assert metrics.registry.enabled  # implied by the file and port
        port = metrics.monitor_port()
        assert port
        common.allreduce(torch.ones(16), name="mf.a")
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert 'hvd_tpu_ops_total{plane="engine",op="allreduce"} 1' in text
    finally:
        hvd.shutdown()
        metrics.registry.disable()
        metrics.registry.reset()
    with open(path + ".0") as f:
        dump = json.load(f)
    assert dump["ops"]["engine"]["allreduce"] == 1
    assert metrics.monitor_port() is None


def test_monitor_port_offsets_by_local_rank(monkeypatch):
    """A non-zero ``HVD_TPU_MONITOR_PORT`` binds port + local_rank (rank
    0 at the base), and a port already taken warns and goes on."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_METRICS"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setenv("HVD_TPU_MONITOR_PORT", "19123")
    monkeypatch.setattr(metrics, "start_monitor",
                        lambda port, **kw: calls.append(port) or port)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        assert calls == [19123]
        assert metrics.cluster_configured()  # rank 0, a fixed base port
    finally:
        hvd.shutdown()
        metrics.registry.disable()
        metrics.registry.reset()

    def taken(port, **kw):
        raise OSError(98, "Address already in use")

    monkeypatch.setattr(metrics, "start_monitor", taken)
    with pytest.warns(UserWarning, match="could not bind port 19123"):
        hvd.init(device="cpu")
    try:
        assert hvd.is_initialized() and metrics.monitor_port() is None
    finally:
        hvd.shutdown()
        metrics.registry.disable()
        metrics.registry.reset()


_SCRAPE = """
import json, os, urllib.request
import torch, horovod_tpu_torch as hvd
from horovod_tpu_torch import common
from horovod_tpu_torch.common import metrics
hvd.init(device="cpu")
hvd.metrics_reset()
r, n = hvd.rank(), hvd.size()
x = torch.full((500,), float(r))
for i in range(3):
    out = common.allreduce(x, average=False, name=f"scrape.{i}")
    assert float(out[0]) == sum(range(n))
port = metrics.monitor_port()
assert port, "monitor did not start from HVD_TPU_MONITOR_PORT"
text = urllib.request.urlopen(f"http://localhost:{port}/metrics",
                              timeout=10).read().decode()
snap = hvd.metrics_snapshot()
ar, bin_ = snap["ops"]["engine"]["allreduce"], snap["bytes"]["engine"]["in"]
assert ar == 3 and bin_ == 3 * 2000, snap["ops"]
assert f'hvd_tpu_ops_total{{plane="engine",op="allreduce"}} {ar}' in text
assert f'hvd_tpu_bytes_total{{plane="engine",direction="in"}} {bin_}' in text
hvd.shutdown()
"""


def test_monitor_scrape_during_two_process_job(tmp_path):
    """A scrape of each rank's monitor during an np 2 job matches its
    snapshot; the ranks' metrics files render through
    ``tools/metrics_dump.py``: the default view, the stragglers view of
    rank 0's (the coordinator's) and the links view."""
    metrics_dump = _tool("metrics_dump")
    path = str(tmp_path / "run.json")
    _port_job(_SCRAPE, 2, HVD_TPU_MONITOR_PORT="0",
              HVD_TPU_METRICS_FILE=path)
    dumps = []
    for r in range(2):
        with open(f"{path}.{r}") as f:
            dumps.append(json.load(f))
        assert dumps[r]["ops"]["engine"]["allreduce"] == 3
        assert dumps[r]["links"]["peers"][str(1 - r)]["sends"] > 0
    assert "dominant straggler: rank" in metrics_dump.render_stragglers(
        dumps[0])
    links = metrics_dump.render_links(dumps[1])
    assert "p99" in links and links.splitlines()[2].startswith("0 ")
    for args in ([f"{path}.0"], ["--stragglers", f"{path}.0"],
                 ["--links", f"{path}.1"], [f"{path}.0", f"{path}.1"]):
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "metrics_dump.py"),
             *args], capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, (args, proc.stderr)
        assert proc.stdout.strip(), args


_CLUSTER = """
import json, urllib.request
import torch, horovod_tpu_torch as hvd
from horovod_tpu_torch import common
hvd.init(device="cpu")
for i in range(3):
    common.allreduce(torch.ones(8), name=f"step.{{i}}")
if hvd.rank() == 0:
    url = "http://127.0.0.1:{port}/cluster"
    doc = json.load(urllib.request.urlopen(url, timeout=10))
    assert doc["launched"] == 3 and doc["live"] == 3, doc
    assert sorted(doc["ranks"]) == ["0", "1", "2"], doc
    assert doc["membership_epochs_agree"], doc
    prom = urllib.request.urlopen("http://127.0.0.1:{port}/cluster.prom",
                                  timeout=10).read().decode()
    assert "hvd_tpu_cluster_ranks_live 3" in prom, prom
    with open({out!r}, "w") as f:
        json.dump(doc, f)
# Workers keep their monitors up until rank 0 has scraped.
common.allreduce(torch.ones(1), name="cluster.barrier")
hvd.shutdown()
"""


def test_cluster_endpoint_merges_all_ranks(tmp_path):
    """Rank 0's ``/cluster`` merges every rank's ``/health`` over an np 3
    job (monitors at base + local_rank); ``tools/hvdtop.py`` renders the
    document."""
    from horovod_tpu_torch.common.basics import pick_free_ports

    hvdtop = _tool("hvdtop")
    base = pick_free_ports(1)[0]
    out = str(tmp_path / "cluster.json")
    _port_job(_CLUSTER.format(port=base, out=out), 3,
              HVD_TPU_MONITOR_PORT=str(base))
    with open(out) as f:
        doc = json.load(f)
    assert all(doc["ranks"][r]["live"] for r in ("0", "1", "2"))
    assert all(set(doc["ranks"][r]["links"]) for r in ("0", "1", "2"))
    frame = hvdtop.render(doc, {}, time.time(), f"127.0.0.1:{base}")
    assert "live 3/3" in frame and "epochs agree" in frame, frame
