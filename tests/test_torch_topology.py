"""horovod_tpu_torch's two-level topology against horovod_tpu's
(``tests/test_topology.py``'s contracts; the engine's two-level allreduce
is the same C++ in both packages).

Nodes are faked on one host: each rank re-shapes its launcher
environment into ``local_size``-rank nodes (``HVD_TPU_LOCAL_SIZE``,
``HVD_TPU_LOCAL_RANK``) and asks for ``HOROVOD_HIERARCHICAL_ALLREDUCE``
before ``init()`` (the reference's ``_hier_env``).  One program runs in
the port's rank processes and in the reference's at the same np and
layout, on the same inputs, and the two are held equal bit for bit:

- np 4 (2 nodes x 2), one job: integer-valued float32 buckets, fused,
  mixing sums and averages, on the flat ring and then on the two-level
  topology (equal, and both packages' equal); bf16 and fp16 payloads at
  their own width on both hops (wire bytes equal payload bytes); the
  ring-vs-tree boundary moved mid-run by ``autotune_set`` from rank 0
  at a fixed collective index (the per-bucket choice flips at one tick on
  every rank; the applied log equal across ranks; a ``topology`` flight
  event); then bf16 on the cross hop (every rank's decision log equal,
  cross bytes a quarter of the local hop's, the results equal across
  ranks);
- np 3 (one node of 3): f64, i64, bf16 and a float32 average through the
  local reduce-scatter and allgather alone; bf16 asked for on one node
  stays inert (no cross hop to narrow);
- np 4: rank 2 (rank 0's cross peer and rank 3's local peer) dies in a
  two-level allreduce; every survivor fails with the reference's typed
  error, fast (the other deaths, as in the reference, in the slow tier);
- the registry's ``topology`` section, its Prometheus families and
  ``tools/metrics_dump.py``'s line, on the port's registry against the
  reference's.

Counts that follow the fusion of async handles (buckets, bytes of a
section with async enqueues) follow timing; those are compared across
ranks and against the contract, not between the packages.  Tolerance:
none, every value compared is exact.
"""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from tests.distributed import run_ranks
from tests.test_torch_compression import _same
from tests.test_torch_engine import OUT_ENV, _bits, _launch
from tests.torch_watch import ENV as WATCH_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference's init agrees its XLA data plane through one allreduce of
# this name, which its compression log lists; the port has no such plane.
XLA_AGREEMENT = "__xla_plane_agreement__"


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _hier_env(local_size, **extra):
    """Re-shape this rank's environment into ``local_size``-rank nodes and
    ask for the two-level allreduce, before ``init()`` reads it."""
    rank = int(os.environ["HVD_TPU_RANK"])
    os.environ["HVD_TPU_LOCAL_SIZE"] = str(local_size)
    os.environ["HVD_TPU_LOCAL_RANK"] = str(rank % local_size)
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    os.environ.update(extra)


def _package(port):
    """``(hvd, top, init, lib)`` of the port or of the reference."""
    if port:
        import horovod_tpu_torch as top
        import horovod_tpu_torch.torch as hvd
        from horovod_tpu_torch.common import _load_lib

        return hvd, top, lambda: top.init(device="cpu"), _load_lib
    import horovod_tpu as top
    import horovod_tpu.torch as hvd
    from horovod_tpu.common import _load_lib

    return hvd, top, top.init, _load_lib


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# --- np 4: one job, four contracts -----------------------------------------


def _mixed(hvd, tag):
    """12 integer-valued buckets enqueued together (sums and averages
    fused: exact, whatever the layout), then one of 2^18 elements."""
    r = hvd.rank()
    handles = [hvd.allreduce_async(
        _f32((np.arange(64 + 17 * i) % 89) + r + i), average=(i % 2 == 1),
        name=f"{tag}.mix.{i}") for i in range(12)]
    outs = [hvd.synchronize(h) for h in handles]
    outs.append(hvd.allreduce(_f32(np.arange(1 << 18) % 251 + r),
                              average=False, name=f"{tag}.big"))
    return outs


def _boundary(hvd, top, lib):
    """The cross hop's ring-vs-tree boundary: a sweep below and above 64
    KiB and a collective that every rank enters after reading the
    boundary; then rank 0 pins it at 0 (ring always) and a flush
    collective carries it to every rank; the same sweep again."""
    r, n = hvd.rank(), hvd.size()

    def sweep(tag):
        outs = []
        for i, count in enumerate((64, 1 << 10, 1 << 17)):
            outs.append(hvd.allreduce(_f32(np.arange(count) % 31 + r),
                                      average=False, name=f"{tag}.{i}"))
            want = _f32((np.arange(count) % 31) * n + sum(range(n)))
            assert torch.equal(outs[-1], want), (tag, count)
        return outs

    def ops():
        return dict(top.metrics_snapshot()["topology"]["cross_ops"])

    b = {}
    start = ops()
    b["warm"] = sweep("warm")
    warm = ops()
    b["warm_ops"] = {k: warm[k] - start[k] for k in warm}
    b["threshold_before"] = top.metrics_snapshot()["topology"][
        "cross_algo_threshold"]
    # Every rank has read the boundary before rank 0 can move it: rank 0
    # passes this collective only once all ranks have announced it.
    hvd.allreduce(torch.zeros(4), name="read")
    if r == 0:
        top.autotune_set(cross_algo_threshold=0)
    hvd.allreduce(torch.zeros(4), name="flush")
    before = ops()
    b["ring_only"] = sweep("ringonly")
    after = ops()
    b["ring_only_ops"] = {k: after[k] - before[k] for k in after}
    b["threshold_after"] = top.metrics_snapshot()["topology"][
        "cross_algo_threshold"]
    b["applied"] = [{k: v for k, v in e.items() if k != "tick"}
                    for e in top.autotune_report()["applied"]]
    b["applied_json"] = json.dumps(top.autotune_report()["applied"],
                                   sort_keys=True)
    b["topology_flight_event"] = (
        "|topology|" in lib().hvd_tpu_flight_dump().decode())
    return b


def _dcn(hvd, top):
    """bf16 on the cross hop: three allreduces of one name (its residual
    carried across them), the hops' byte deltas, the decision log."""
    r, n = hvd.rank(), hvd.size()
    base = top.metrics_snapshot()["topology"]["bytes"]
    count = 1 << 19
    x = _f32(np.random.RandomState(r).rand(count) - 0.5)
    outs = [hvd.allreduce(x, average=False, name="comp.big")
            for _ in range(3)]
    after = top.metrics_snapshot()["topology"]["bytes"]
    rep = top.compression_report()
    return {"outs": outs, "local": after["local"] - base["local"],
            "cross": after["cross"] - base["cross"],
            "bf16_buckets": rep["engine"]["ops"]["bf16"],
            "log": [(e["name"], e["mode"]) for e in rep["log"]
                    if e["name"] != XLA_AGREEMENT]}


def _np4_program(port, out_dir):
    hvd, top, init, lib = _package(port)
    rec = {}
    init()
    rec["flat"] = _mixed(hvd, "flat")
    top.shutdown()
    _hier_env(2)
    init()
    rec["local_size"] = hvd.local_size()
    rec["hier"] = _mixed(hvd, "hier")
    topo = top.metrics_snapshot()["topology"]
    rec["topology"] = {k: topo[k] for k in (
        "hierarchical", "nodes", "local_size", "cross_algo_threshold",
        "local_transport")}
    rec["hops_moved"] = (topo["bytes"]["local"] > 0,
                         topo["bytes"]["cross"] > 0)
    before = top.compression_report()["engine"]
    for dtype, name in ((torch.bfloat16, "nb"), (torch.float16, "nh")):
        rec[name] = hvd.allreduce(_f32(np.arange(1 << 15) % 17).to(dtype),
                                  average=False, name=name)
    after = top.compression_report()["engine"]
    rec["half_bytes"] = (after["wire_bytes"] - before["wire_bytes"],
                         after["payload_bytes"] - before["payload_bytes"])
    rec["boundary"] = _boundary(hvd, top, lib)
    top.shutdown()
    os.environ["HVD_TPU_COMPRESSION"] = "bf16"
    init()
    rec["dcn"] = _dcn(hvd, top)
    top.shutdown()
    tag = "port" if port else "ref"
    torch.save(rec, os.path.join(
        out_dir, f"{tag}{int(os.environ['HVD_TPU_RANK'])}.pt"))


def _ref_np4():
    _np4_program(False, os.environ[OUT_ENV])


def _port_np4(out_dir):
    _np4_program(True, out_dir)


def _records(tmp, np_):
    return ([torch.load(tmp / f"port{r}.pt") for r in range(np_)],
            [torch.load(tmp / f"ref{r}.pt") for r in range(np_)])


@pytest.fixture(scope="module")
def np4(tmp_path_factory):
    """Both packages' records of the np 4 program, by rank."""
    tmp = tmp_path_factory.mktemp("topology_np4")
    os.environ[OUT_ENV] = str(tmp)
    try:
        run_ranks(_ref_np4, 4, timeout=120)
    finally:
        del os.environ[OUT_ENV]
    _launch(functools.partial(_port_np4, str(tmp)), 4, timeout=120,
            **WATCH_ENV)
    return _records(tmp, 4)


def test_two_level_matches_flat_mixed_fused(np4):
    """Fused integer-valued buckets mixing sums and averages: the
    two-level results equal the flat ring's bit for bit, and the port's
    equal the reference's."""
    port, ref = np4
    for r, (got, want) in enumerate(zip(port, ref)):
        assert got["local_size"] == want["local_size"] == 2
        for a, b in zip(got["hier"], got["flat"]):
            assert torch.equal(_bits(a), _bits(b)), r
        _same(got["hier"], want["hier"], ("hier", r))
        _same(got["flat"], want["flat"], ("flat", r))
        assert got["topology"] == want["topology"] == {
            "hierarchical": True, "nodes": 2, "local_size": 2,
            "cross_algo_threshold": 64 << 10, "local_transport": "shm"}
        assert got["hops_moved"] == want["hops_moved"] == (True, True)


def test_two_level_half_native_width(np4):
    """bf16 and fp16 cross both hops at their own width: wire bytes equal
    payload bytes, 2 x 2^15 x 2 of them; exact sums."""
    port, ref = np4
    for got, want in zip(port, ref):
        for name in ("nb", "nh"):
            _same(got[name], want[name], (name,))
            assert torch.equal(got[name].float(),
                               _f32((np.arange(1 << 15) % 17) * 4.0))
        assert got["half_bytes"] == want["half_bytes"] == (
            2 * (2 << 15), 2 * (2 << 15))


def test_tree_ring_boundary_crosses_mid_run(np4):
    """Under 64 KiB the cross hop takes the tree, above it the ring; a
    boundary of 0 set by ``autotune_set`` at a fixed point of the program
    reaches every rank at one tick (the applied log is equal across
    ranks), after which every bucket takes the ring; the switch leaves a
    flight event."""
    port, ref = np4
    for recs in (port, ref):
        logs = {x["boundary"]["applied_json"] for x in recs}
        assert len(logs) == 1, logs
    for got, want in zip(port, ref):
        g, w = got["boundary"], want["boundary"]
        _same(g["warm"], w["warm"], ("warm",))
        _same(g["ring_only"], w["ring_only"], ("ring_only",))
        for key in ("warm_ops", "ring_only_ops", "threshold_before",
                    "threshold_after", "applied", "topology_flight_event"):
            assert g[key] == w[key], (key, g[key], w[key])
        assert g["warm_ops"] == {"ring": 1, "tree": 2}, g["warm_ops"]
        assert g["ring_only_ops"] == {"ring": 3, "tree": 0}
        assert (g["threshold_before"], g["threshold_after"]) == (64 << 10, 0)
        assert g["applied"][-1]["cross_algo_threshold"] == 0
        assert g["topology_flight_event"]


def test_two_level_dcn_compression_lockstep(np4):
    """bf16 on the cross hop: the port's results and decision log equal
    the reference's bit for bit; every rank holds the same compressed
    result and the same log; the cross hop moves a quarter of the local
    hop's bytes (half of it from compression); the error stays small."""
    port, ref = np4
    want_sum = sum(np.random.RandomState(j).rand(1 << 19).astype(np.float32)
                   - 0.5 for j in range(4))
    for got, want in zip(port, ref):
        _same(got["dcn"], want["dcn"], ("dcn",))
        d = got["dcn"]
        out = d["outs"][-1].numpy()
        assert np.max(np.abs(out - want_sum)) / np.max(np.abs(want_sum)) \
            < 0.05
        assert d["cross"] > 0 and d["local"] / d["cross"] >= 3.5, d
        assert d["bf16_buckets"] >= 3
    for x in port[1:]:
        assert torch.equal(_bits(x["dcn"]["outs"][-1]),
                           _bits(port[0]["dcn"]["outs"][-1]))
        assert x["dcn"]["log"] == port[0]["dcn"]["log"]


# --- np 3: one node --------------------------------------------------------


def _np3_program(port, out_dir):
    hvd, top, init, _ = _package(port)
    rec = {}
    _hier_env(3)
    init()
    r = hvd.rank()
    rec["f64"] = hvd.allreduce(torch.full((257,), 1.5 * (r + 1),
                                          dtype=torch.float64),
                               average=False, name="f64")
    rec["i64"] = hvd.allreduce(torch.arange(1001, dtype=torch.int64) + r,
                               average=False, name="i64")
    rec["bf16"] = hvd.allreduce(_f32(np.arange(96) % 5).bfloat16(),
                                average=False, name="bf16")
    rec["f32avg"] = hvd.allreduce(torch.full((7,), float(r)), average=True,
                                  name="f32avg")
    topo = top.metrics_snapshot()["topology"]
    # The bytes include the reference's XLA agreement allreduce.
    rec["topology"] = {k: v for k, v in topo.items() if k != "bytes"}
    top.shutdown()
    _hier_env(3, HVD_TPU_COMPRESSION="bf16")
    init()
    before = top.compression_report()["engine"]
    rec["inert"] = hvd.allreduce(torch.full((1 << 15,), 257.0) * (r + 1),
                                 average=False, name="inert")
    after = top.compression_report()["engine"]
    rec["inert_engine"] = {
        "bf16": after["ops"]["bf16"] - before["ops"]["bf16"],
        "wire": after["wire_bytes"] - before["wire_bytes"],
        "payload": after["payload_bytes"] - before["payload_bytes"]}
    top.shutdown()
    tag = "port" if port else "ref"
    torch.save(rec, os.path.join(out_dir, f"{tag}{r}.pt"))


def _ref_np3():
    _np3_program(False, os.environ[OUT_ENV])


def _port_np3(out_dir):
    _np3_program(True, out_dir)


@pytest.fixture(scope="module")
def np3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("topology_np3")
    os.environ[OUT_ENV] = str(tmp)
    try:
        run_ranks(_ref_np3, 3, timeout=120)
    finally:
        del os.environ[OUT_ENV]
    _launch(functools.partial(_port_np3, str(tmp)), 3, timeout=120,
            **WATCH_ENV)
    return _records(tmp, 3)


def test_two_level_single_node_generic_dtypes(np3):
    """One node of 3 (no cross phase): the local reduce-scatter and
    allgather are a whole allreduce for f64, i64, bf16 and a float32
    average, equal to the reference's bit for bit."""
    port, ref = np3
    for got, want in zip(port, ref):
        for key in ("f64", "i64", "bf16", "f32avg", "topology"):
            _same(got[key], want[key], (key,))
        assert torch.equal(got["f64"], torch.full((257,), 9.0,
                                                  dtype=torch.float64))
        assert torch.equal(got["i64"],
                           torch.arange(1001, dtype=torch.int64) * 3 + 3)
        assert torch.equal(got["bf16"].float(), _f32(np.arange(96) % 5) * 3)
        assert torch.allclose(got["f32avg"], torch.full((7,), 1.0))
        assert got["topology"]["hierarchical"]
        assert (got["topology"]["nodes"], got["topology"]["local_size"]) \
            == (1, 3)


def test_single_node_two_level_never_compresses(np3):
    """bf16 asked for on one node has no cross hop to narrow: exact
    results, no compressed bucket, wire bytes equal payload bytes."""
    port, ref = np3
    for got, want in zip(port, ref):
        _same(got["inert"], want["inert"], ("inert",))
        assert got["inert_engine"] == want["inert_engine"]
        assert torch.equal(got["inert"], torch.full((1 << 15,), 257.0 * 6))
        e = got["inert_engine"]
        assert e["bf16"] == 0 and e["wire"] == e["payload"], e


# --- np 4: a member dies in a two-level allreduce ---------------------------


DOOMED_ENV = "TORCH_TOPOLOGY_DOOMED"  # "<rank>" or "<rank>,tree"


def _phase_death(port, out_dir):
    """The doomed rank (``DOOMED_ENV``, default 2: rank 0's cross peer and
    rank 3's local peer) exits inside a 16M-element two-level allreduce
    (``,tree``: with the cross hop on the tree); each survivor records the
    class of what that and the next collectives raise, and the seconds
    it took."""
    doomed, *tree = os.environ.get(DOOMED_ENV, "2").split(",")
    hvd, top, init, _ = _package(port)
    _hier_env(2)
    if tree:
        os.environ["HVD_TPU_CROSS_ALGO_THRESHOLD"] = str(1 << 30)
    init()
    r = hvd.rank()
    h = hvd.allreduce_async(torch.full((16 << 20,), float(r)),
                            average=False, name="doomed")
    if r == int(doomed):
        time.sleep(0.3)
        os._exit(0)
    t0 = time.time()
    seen = []
    try:
        hvd.synchronize(h)
        hvd.allreduce(torch.zeros(4), name="sweep")
        seen.append("none")
    except Exception as exc:  # the class is the result
        seen.append(type(exc).__name__)
    elapsed = time.time() - t0
    try:
        hvd.allgather(torch.zeros(1, 2), name="after")
        seen.append("none")
    except Exception as exc:
        seen.append(type(exc).__name__)
    tag = "port" if port else "ref"
    with open(os.path.join(out_dir, f"{tag}_death{r}.json"), "w") as f:
        json.dump({"seen": seen, "seconds": elapsed}, f)
    os._exit(0)


def _ref_death():
    _phase_death(False, os.environ[OUT_ENV])


def _port_death(out_dir):
    _phase_death(True, out_dir)


def _death_held(tmp_path, monkeypatch, doomed):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_death, 4, timeout=120)
    _launch(functools.partial(_port_death, str(tmp_path)), 4, timeout=120,
            **WATCH_ENV)
    for r in sorted({0, 1, 2, 3} - {doomed}):
        got = json.loads((tmp_path / f"port_death{r}.json").read_text())
        want = json.loads((tmp_path / f"ref_death{r}.json").read_text())
        assert got["seen"] == want["seen"], (r, got, want)
        assert "none" not in got["seen"], got
        assert got["seconds"] < 25.0, got


def test_two_level_phase_death_cross_peer(tmp_path, monkeypatch):
    """Both failure directions cascade: every survivor fails typed (the
    reference's classes) well inside the 30 s exchange silence timeout,
    and so does its next collective."""
    monkeypatch.delenv(DOOMED_ENV, raising=False)
    _death_held(tmp_path, monkeypatch, 2)


@pytest.mark.slow
@pytest.mark.parametrize("doomed,tree", [(1, False), (3, False), (1, True)])
def test_two_level_phase_death_matrix(doomed, tree, tmp_path, monkeypatch):
    """The reference's slow sweep of the other deaths: a same-node peer
    (rank 1), the far corner (rank 3), a death under the tree exchange."""
    monkeypatch.setenv(DOOMED_ENV, f"{doomed},tree" if tree else str(doomed))
    _death_held(tmp_path, monkeypatch, doomed)


# --- the registry's topology section (one process, no engine) --------------


def _both_registries():
    from horovod_tpu.common import metrics as ref
    from horovod_tpu_torch.common import metrics as port

    return port, ref


def test_topology_section_is_ungated():
    """Never enabled, the section reads the flat one-node default; set
    and reset behave as the reference's."""
    port, ref = _both_registries()
    regs = (port.MetricsRegistry(), ref.MetricsRegistry())
    assert regs[0].snapshot()["topology"] == regs[1].snapshot()[
        "topology"] == {
        "hierarchical": False, "nodes": 1, "local_size": 1,
        "cross_algo_threshold": 0, "local_transport": "tcp",
        "cross_ops": {"ring": 0, "tree": 0},
        "bytes": {"local": 0, "cross": 0}}
    for reg in regs:
        reg.set_topology({"hierarchical": True, "nodes": 4, "local_size": 2,
                          "cross_algo_threshold": 1 << 16,
                          "cross_ops": {"ring": 5, "tree": 2},
                          "bytes": {"local": 100, "cross": 40}})
    assert regs[0].snapshot()["topology"] == regs[1].snapshot()["topology"]
    assert regs[0].snapshot()["topology"]["cross_ops"] == {"ring": 5,
                                                           "tree": 2}
    for reg in regs:
        reg.reset()
    assert regs[0].snapshot()["topology"] == regs[1].snapshot()["topology"]
    assert regs[0].snapshot()["topology"]["nodes"] == 1


def test_topology_prometheus_families():
    port, ref = _both_registries()
    texts = []
    for mod in (port, ref):
        reg = mod.MetricsRegistry()
        reg.set_topology({"hierarchical": True, "nodes": 2, "local_size": 2,
                          "cross_algo_threshold": 64 << 10,
                          "cross_ops": {"ring": 3, "tree": 1},
                          "bytes": {"local": 4096, "cross": 1024}})
        reg.observe("topology_local_rs_sec", 0.002)
        reg.observe("topology_cross_sec", 0.004)
        reg.observe("topology_local_ag_sec", 0.001)
        texts.append([ln for ln in mod.prometheus_text(
            reg.snapshot()).splitlines() if "topology" in ln])
    assert texts[0] == texts[1]
    text = "\n".join(texts[0])
    for line in ("hvd_tpu_topology_hierarchical 1",
                 "hvd_tpu_topology_nodes 2",
                 'hvd_tpu_topology_cross_ops_total{algo="ring"} 3',
                 'hvd_tpu_topology_cross_ops_total{algo="tree"} 1',
                 'hvd_tpu_topology_bytes_total{hop="cross"} 1024',
                 "hvd_tpu_topology_cross_algo_threshold_bytes 65536",
                 "hvd_tpu_topology_local_rs_seconds_count 1",
                 "hvd_tpu_topology_cross_seconds_count 1"):
        assert line in text, line


def test_metrics_dump_topology_line():
    """``tools/metrics_dump.py`` renders the port's topology section."""
    from tools.metrics_dump import render

    from horovod_tpu_torch.common import metrics

    reg = metrics.MetricsRegistry()
    reg.enable()
    reg.set_topology({"hierarchical": True, "nodes": 2, "local_size": 2,
                      "cross_algo_threshold": 64 << 10,
                      "cross_ops": {"ring": 4, "tree": 2},
                      "bytes": {"local": 1 << 20, "cross": 1 << 19}})
    text = render(reg.snapshot())
    assert "== topology ==" in text
    assert "ring 4 / tree 2" in text
    assert "2 node(s) x 2 local" in text
