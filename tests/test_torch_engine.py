"""horovod_tpu_torch's collective engine against horovod_tpu's.

The port's ranks start through its own runner (``launch_fn``), the
reference's through ``tests/distributed.py`` (``horovod_tpu.runner``), each
in processes of their own, on the same inputs: numpy-seeded per rank and
per case.  The two engines are the same C++ with the same ring order, so
every value must be equal bit for bit:

- allreduce (sum and average), allgather with a different dim 0 per rank,
  broadcast from the last rank (a non-zero root at np 3), the in-place
  variants, in f32, f64, bf16, i32 and i64;
- 64 small tensors enqueued async, polled, then synchronized (the port's
  must complete in fewer engine cycles than tensors: fused).  Their
  values are small integers: a fused bucket's layout follows timing, and
  a ring sums a segment in an order that depends on where it lies, so
  only exact sums are bit-stable across runs at np 3;
- the autograd gradients of the three ops.

Also: the typed errors (a shape mismatch across ranks, a rank that exits
mid-job) against the reference's classes, the isolation of the two
engine libraries in one process, the exported symbols, the environment
knobs the port refuses (the XLA data plane's) and those it supports (the
topology, transport and network fault knobs against the reference's
size-1 outcome; the heartbeat knobs), and the launcher.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_port
from horovod_tpu_torch.runner import launch_fn
from tests.distributed import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ENV = "TORCH_PARITY_OUT"
DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.int32,
          torch.int64)


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    """Both engine libraries built before any timed launch: in a fresh
    checkout the first rank of each package compiles its engine, which on
    a loaded machine can take most of the launch's time limit."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _inputs(r, dtype, shape, case):
    """Rank ``r``'s input of ``case``: normal floats, or integers."""
    rng = np.random.RandomState(1000 * case + r)
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    return torch.from_numpy(rng.randint(-1000, 1000, shape)).to(dtype)


def _collectives(hvd):
    """Every case on ``hvd`` (``horovod_tpu.torch`` or the port's
    ``horovod_tpu_torch.torch``): ``({name: tensor}, engine cycles of the
    64 small tensors, or None)``."""
    r, n = hvd.rank(), hvd.size()
    root = n - 1
    out = {}
    for i, dtype in enumerate(DTYPES):
        tag = str(dtype)[6:]
        x = _inputs(r, dtype, (33, 7), i)
        out[f"sum.{tag}"] = hvd.allreduce(x, average=False, name=f"sum.{tag}")
        out[f"mean.{tag}"] = hvd.allreduce(x, average=True,
                                           name=f"mean.{tag}")
        y = x.clone()
        assert hvd.allreduce_(y, average=True, name=f"mean_.{tag}") is y
        out[f"mean_.{tag}"] = y
        out[f"gather.{tag}"] = hvd.allgather(
            _inputs(r, dtype, (r + 1, 4), 10 + i), name=f"gather.{tag}")
        out[f"bcast.{tag}"] = hvd.broadcast(x, root, name=f"bcast.{tag}")
        z = x.clone()
        assert hvd.broadcast_(z, root, name=f"bcast_.{tag}") is z
        out[f"bcast_.{tag}"] = z
    handles = [hvd.allreduce_async(
        torch.full((5,), float(j * n + r)), average=False,
        name=f"small.{j}") for j in range(64)]
    assert all(isinstance(hvd.poll(h), bool) for h in handles)
    for j, h in enumerate(handles):
        out[f"small.{j}"] = hvd.synchronize(h)
    ticks = getattr(handles[0], "completion_tick", None)
    if ticks is not None:
        ticks = len({h.completion_tick for h in handles})

    x = _inputs(r, torch.float32, (6, 3), 50).requires_grad_()
    w = _inputs(r, torch.float32, (6, 3), 51)
    (hvd.allreduce(x, average=True, name="grad.ar") * w).sum().backward()
    out["grad.allreduce"] = x.grad
    x = _inputs(r, torch.float32, (r + 1, 3), 52).requires_grad_()
    w = _inputs(0, torch.float32, (n * (n + 1) // 2, 3), 53)
    (hvd.allgather(x, name="grad.ag") * w).sum().backward()
    out["grad.allgather"] = x.grad
    x = _inputs(r, torch.float32, (6, 3), 54).requires_grad_()
    w = _inputs(r, torch.float32, (6, 3), 55)
    (hvd.broadcast(x, root, name="grad.bc") * w).sum().backward()
    out["grad.broadcast"] = x.grad
    return out, ticks


def _ref_rank():
    import horovod_tpu.torch as hvd

    hvd.init()
    out, _ = _collectives(hvd)
    torch.save(out, os.path.join(os.environ[OUT_ENV], f"ref{hvd.rank()}.pt"))
    hvd.shutdown()


def _port_rank(out_dir):
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    out, ticks = _collectives(hvd)
    assert ticks < 64, f"64 small allreduces took {ticks} engine cycles"
    torch.save(out, os.path.join(out_dir, f"port{hvd.rank()}.pt"))
    hvd.shutdown()


def _launch(fn, np_, timeout=120, **extra_env):
    """``launch_fn`` with the repo importable (and ``extra_env``); the
    ranks' results, after raising on a rank that failed."""
    env = dict(os.environ, **extra_env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    results = launch_fn(fn, np_, env=env, timeout=timeout)
    for r in results:
        if r.returncode != 0:
            raise AssertionError(
                f"port rank {r.rank}/{np_} exited with {r.returncode}\n"
                f"--- stdout ---\n{r.stdout}\n--- stderr ---\n{r.stderr}")
    return results


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("np_", [1, 3])
def test_collectives_match_reference_bit_for_bit(np_, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_rank, np_, timeout=120)
    _launch(functools.partial(_port_rank, str(tmp_path)), np_)
    for r in range(np_):
        ref = torch.load(tmp_path / f"ref{r}.pt")
        got = torch.load(tmp_path / f"port{r}.pt")
        assert set(got) == set(ref)
        for name, want in ref.items():
            a = got[name]
            assert (a.dtype, a.shape) == (want.dtype, want.shape), name
            assert torch.equal(_bits(a), _bits(want)), (r, name)


def _errors(hvd, out_path):
    """A shape mismatch across ranks, then rank 1 leaving mid-job: the
    class of each error rank 0 sees, written to ``out_path``."""
    r = hvd.rank()
    seen = []
    try:
        hvd.allreduce(torch.ones(r + 2), name="mismatch")
        seen.append("none")
    except Exception as exc:  # the class is the result
        seen.append(type(exc).__name__)
    hvd.allreduce(torch.ones(4), name="still.alive")
    if r == 1:
        os._exit(0)  # mid-job, without shutdown
    try:
        for i in range(1000):
            hvd.allreduce(torch.ones(4), name=f"after.{i}")
        seen.append("none")
    except Exception as exc:
        seen.append(type(exc).__name__)
    with open(out_path, "w") as f:
        f.write(" ".join(seen))
    os._exit(0)


def _ref_errors_rank():
    import horovod_tpu.torch as hvd

    hvd.init()
    _errors(hvd, os.path.join(os.environ[OUT_ENV], "ref_errors.txt"))


def _port_errors_rank(out_dir):
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    _errors(hvd, os.path.join(out_dir, "port_errors.txt"))


def test_typed_errors_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_errors_rank, 2, timeout=120)
    _launch(functools.partial(_port_errors_rank, str(tmp_path)), 2)
    ref = (tmp_path / "ref_errors.txt").read_text().split()
    got = (tmp_path / "port_errors.txt").read_text().split()
    assert ref == ["ValueError", "RanksDownError"]
    assert got == ref


_ISOLATION = """
import horovod_tpu.common as ref
reflib = ref._load_lib()
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.torch import allreduce
hvd.init(device="cpu")
out = allreduce(torch.arange(4.0), name="iso")
assert torch.equal(out, torch.arange(4.0))
assert hvd.is_initialized() and hvd.size() == 1
assert reflib.hvd_tpu_initialized() == 0, "the port drove the reference"
hvd.shutdown()
print("isolated")
"""


def test_engines_stay_apart_in_one_process():
    """The reference's library loaded RTLD_GLOBAL (every C++ symbol
    exported), then the port's: a size-1 port allreduce must leave the
    reference's engine uninitialised."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HVD_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated")


def test_engine_exports_only_its_c_api():
    from horovod_tpu_torch.engine import build

    path = build.build()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libhvdtpu_torch-")
    symbols = build.exported_symbols(path)
    assert len(symbols) > 20
    assert [s for s in symbols if not s.startswith("hvd_tpu_")] == []
    for name in ("hvd_tpu_init", "hvd_tpu_enqueue", "hvd_tpu_wait",
                 "hvd_tpu_completion_tick", "hvd_tpu_copy_result"):
        assert name in symbols


@pytest.mark.parametrize("var,value,plane", [
    ("HVD_TPU_XLA_DATA_PLANE", "1", "XLA data plane"),
    ("HOROVOD_XLA_DATA_PLANE", "1", "XLA data plane"),
])
def test_unported_engine_planes_raise(var, value, plane, monkeypatch):
    for name in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                 "HVD_TPU_DATA"):
        monkeypatch.delenv(name, raising=False)
    hvd_port.shutdown()
    monkeypatch.setenv(var, value)
    with pytest.raises(hvd_port.HorovodInternalError,
                       match=f"{plane} \\({var}={value}\\)"):
        hvd_port.init(device="cpu")
    assert not hvd_port.is_initialized()


# The topology and transport knobs, refused until those planes were
# ported: each starts a size-1 engine of both packages (or fails both
# inits) the same way.  Last, a cross-algo pin, refused on the flat ring,
# is taken with the hierarchical allreduce.
TOPOLOGY_KNOBS = (
    {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
    {"HVD_TPU_COORD_TREE": "1"},
    {"HVD_TPU_SHM_RING_BYTES": "65536"},
    {"HVD_TPU_SHM": "force"},
    {"HVD_TPU_NET_FAULT_SPEC": "drop"},
    {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
     "HVD_TPU_AUTOTUNE_FIX": "cross_algo_threshold=0"},
)
_SIZE1_OUTCOME = """
import json, os, sys
for k in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD", "HVD_TPU_DATA"):
    os.environ.pop(k, None)
if sys.argv[1] == "port":
    import horovod_tpu_torch as hvd
    init = lambda: hvd.init(device="cpu")
else:
    import horovod_tpu as hvd
    init = hvd.init
out = []
for knobs in json.loads(sys.argv[2]):
    os.environ.update(knobs)
    try:
        init()
        snap = hvd.metrics_snapshot()
        out.append({"topology": snap["topology"],
                    "control": snap["control"]})
        hvd.shutdown()
    except Exception as exc:
        out.append({"error": [type(exc).__name__, str(exc)]})
    for k in knobs:
        del os.environ[k]
    assert not hvd.is_initialized()
print("OUTCOME " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def size1_outcomes():
    """Each package's outcome of every ``TOPOLOGY_KNOBS`` case (a size-1
    engine's ``topology`` and ``control`` sections, or the class and
    message of what ``init()`` raised), each package in one fresh process
    of its own: the engine's counters live as long as its process."""
    import json

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HVD_TPU_") and not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    out = {}
    for package in ("port", "ref"):
        proc = subprocess.run(
            [sys.executable, "-c", _SIZE1_OUTCOME, package,
             json.dumps(TOPOLOGY_KNOBS)],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("OUTCOME ")][-1]
        out[package] = json.loads(line[len("OUTCOME "):])
    return out


@pytest.mark.parametrize("case", range(len(TOPOLOGY_KNOBS)),
                         ids=[",".join(k) for k in TOPOLOGY_KNOBS])
def test_topology_and_transport_knobs_reach_the_engine(case,
                                                       size1_outcomes):
    """Each knob is accepted as the reference's is: the hierarchical
    allreduce and the coordinator tree start (at size 1 there is one node:
    the flat ring's section and the star), the ring size is taken,
    ``HVD_TPU_SHM=force`` starts as the reference's does at size 1 (the
    force check is part of the job-wide agreement, which one rank skips;
    ``tests/test_torch_transport.py`` holds its error at np 2), a bad
    ``HVD_TPU_NET_FAULT_SPEC`` clause fails the engine's init with the
    reference's ``bad HVD_TPU_NET_FAULT_SPEC`` message, and a cross-algo
    pin starts beside the hierarchical allreduce."""
    got = size1_outcomes["port"][case]
    assert got == size1_outcomes["ref"][case]
    if "HVD_TPU_NET_FAULT_SPEC" in TOPOLOGY_KNOBS[case]:
        assert got["error"][0] == "HorovodInternalError"
        assert "bad HVD_TPU_NET_FAULT_SPEC" in got["error"][1]
    else:
        assert "error" not in got, got
        assert got["topology"]["nodes"] == 1


def _accepted_metrics_file(tmp_path, snap):
    assert snap["enabled"] is True
    return lambda: os.path.exists(tmp_path / "m.json.0")


def _accepted_monitor(tmp_path, snap):
    from horovod_tpu_torch.common import metrics

    assert snap["enabled"] is True and metrics.monitor_port()
    return lambda: metrics.monitor_port() is None


def _accepted_postmortem(tmp_path, snap):
    from horovod_tpu_torch.common import postmortem

    assert postmortem.postmortem_dir() == str(tmp_path / "pm")
    # A clean shutdown writes no dump.
    return lambda: postmortem.written_path() is None


def _reads(section, key, want):
    def check(tmp_path, snap):
        assert snap[section][key] == want, snap[section]
    return check


@pytest.mark.parametrize("var,value,check", [
    ("HVD_TPU_METRICS_FILE", "{tmp}/m.json", _accepted_metrics_file),
    ("HVD_TPU_MONITOR_PORT", "0", _accepted_monitor),
    ("HVD_TPU_POSTMORTEM_DIR", "{tmp}/pm", _accepted_postmortem),
    ("HVD_TPU_FLIGHT_EVENTS", "4096", _reads("flight", "capacity", 4096)),
    ("HVD_TPU_LINK_STATS", "0", _reads("links", "enabled", False)),
    ("HVD_TPU_ANOMALY_SIGMA", "3", _reads("anomalies", "sigma", 3)),
    ("HVD_TPU_ANOMALY_INTERVAL_MS", "250",
     _reads("anomalies", "interval_ms", 250)),
])
def test_ported_engine_planes_init(var, value, check, tmp_path, monkeypatch):
    """The metrics and postmortem variables, refused until those planes
    were ported, start a size-1 engine and take effect (the engine reads
    the flight, link and anomaly knobs itself)."""
    from horovod_tpu_torch.common import metrics

    for name in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                 "HVD_TPU_DATA", "HVD_TPU_METRICS"):
        monkeypatch.delenv(name, raising=False)
    hvd_port.shutdown()
    monkeypatch.setenv(var, value.format(tmp=tmp_path))
    hvd_port.init(device="cpu")
    try:
        after_shutdown = check(tmp_path, hvd_port.metrics_snapshot())
    finally:
        hvd_port.shutdown()
        metrics.registry.disable()
        metrics.registry.reset()
    assert not hvd_port.is_initialized()
    assert after_shutdown is None or after_shutdown()


def test_every_variable_the_engine_reads_is_accounted_for():
    """Each ``getenv`` of the engine's sources is refused as an unported
    plane's or supported, so none is honoured silently; the engine reads
    no variable of the one unported plane."""
    import glob
    import re

    from horovod_tpu_torch.common import config

    cc = os.path.join(REPO, "horovod_tpu_torch", "engine", "cc")
    read = set()
    for path in glob.glob(os.path.join(cc, "*.[ch]*")):
        with open(path) as f:
            read |= set(re.findall(r'getenv\("([A-Z0-9_]+)"\)', f.read()))
    assert {"HVD_TPU_NET_FAULT_SPEC", "HVD_TPU_SHM",
            "HVD_TPU_SHM_RING_BYTES"} <= set(config.ENGINE_SUPPORTED)
    assert [plane for plane, _ in config.UNPORTED] == ["XLA data plane"]
    refused = {v for _, names in config.UNPORTED for v in names}
    assert read - refused - set(config.ENGINE_SUPPORTED) == set()
    assert set(config.ENGINE_SUPPORTED) <= read
    assert not refused & set(config.ENGINE_SUPPORTED)
    assert not refused & read


def _heartbeat_rank(out_dir):
    import ctypes
    import time

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import common

    hvd.init(device="cpu")
    r = hvd.rank()
    assert torch.equal(hvd.allreduce(torch.full((5,), float(r)),
                                     average=False, name="hb"),
                       torch.full((5,), 1.0))
    time.sleep(0.3)
    info = common._load_lib().hvd_tpu_liveness_info
    info.restype = ctypes.c_char_p
    with open(os.path.join(out_dir, f"liveness{r}.txt"), "w") as f:
        f.write(info().decode())
    hvd.shutdown()


@pytest.mark.parametrize("interval_ms,miss", [("20", "7"), ("0", "3")])
def test_heartbeat_variables_take_effect(interval_ms, miss, tmp_path):
    """The engine's heartbeat detector runs at ``HVD_TPU_HEARTBEAT_MS``
    with ``HVD_TPU_HEARTBEAT_MISS`` (0: off, no beats) under an
    allreduce at np 2."""
    _launch(functools.partial(_heartbeat_rank, str(tmp_path)), 2,
            HVD_TPU_HEARTBEAT_MS=interval_ms, HVD_TPU_HEARTBEAT_MISS=miss)
    for r in range(2):
        got = (tmp_path / f"liveness{r}.txt").read_text().split("|")
        assert got[:2] == [interval_ms, miss], got
        assert (int(got[2]) > 0) == (interval_ms != "0"), got  # beats sent


def test_config_reads_the_engine_knobs(monkeypatch):
    from horovod_tpu_torch.common.config import Config

    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    monkeypatch.setenv("HVD_TPU_CYCLE_TIME_MS", "2.5")
    monkeypatch.setenv("HVD_TPU_RESPONSE_CACHE", "0")
    monkeypatch.setenv("HVD_TPU_COLLECTIVE_TIMEOUT_SEC", "30")
    cfg = Config.from_env()
    assert (cfg.fusion_threshold, cfg.cycle_time_ms,
            cfg.effective_cache_capacity, cfg.collective_timeout_sec) == \
        (1024, 2.5, 0, 30.0)
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", "2048")  # new name wins
    assert Config.from_env().fusion_threshold == 2048


def test_launcher_drains_ranks_that_write_more_than_a_pipe_holds(
        tmp_path):
    """Captured output is read while the ranks run: 1 MiB on each of
    stdout and stderr neither blocks a rank nor is lost."""
    script = tmp_path / "loud.py"
    script.write_text(
        "import os, sys\n"
        "sys.stdout.write('o' * (1 << 20))\n"
        "sys.stderr.write('e' * (1 << 20) + '\\nlast line\\n')\n"
        "sys.exit(int(os.environ['HVD_TPU_RANK']) + 4)\n")
    from horovod_tpu_torch.runner.launch import run_command

    results = run_command([sys.executable, str(script)], 2, timeout=60,
                          capture=True)
    assert [r.returncode for r in results] == [4, 5]
    for r in results:
        assert len(r.stdout) == 1 << 20
        assert r.stderr.endswith("last line\n")


def test_launcher_reports_the_first_failure(tmp_path):
    """The CLI's exit code and report, and ranks that see their
    identity and endpoints."""
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        "r = int(os.environ['HVD_TPU_RANK'])\n"
        "assert len(os.environ['HVD_TPU_DATA'].split(',')) == 2\n"
        "sys.exit(3 if r == 1 else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2", "--",
         sys.executable, str(script)], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 3
    assert "rank 1 exited with 3" in proc.stderr
    assert "rank 0 exited" not in proc.stderr
