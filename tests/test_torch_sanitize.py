"""Sanitized builds of horovod_tpu_torch's engine against horovod_tpu's
(``docs/contributing.md#sanitized-engine-builds``).

- ``tests/test_hvdlint.py``'s build cases on the port's
  ``engine/build.py``: mode validation (the reference's message), a
  library and a stamp of each mode's own, the sanitizer's flags in place
  of ``-O3 -march=native`` at compile and at link.
- The launcher: under ``HVD_TPU_SANITIZE`` every rank's ``LD_PRELOAD``
  starts with the runtime, composed with what is there already, as the
  reference's ``make_rank_env`` composes it; the launcher's own
  environment is left alone; a bad mode, and a compiler that names no
  runtime (a fake ``CXX``), warn once for a job's ranks, with the
  reference's text.
- The slow tier, as ``tests/test_sanitize.py``: TSan at 4 ranks (two
  nodes of 2, bf16 compression, autotuning, metrics, an API-polling
  thread), ASan at 3, UBSan at 3 on the two-level topology; the port's
  launcher preloads the runtime (the jobs set no ``LD_PRELOAD``) and a
  rank with any sanitizer report fails.
"""

import os
import stat

import pytest

from tests import torch_twin as twin
from tests.torch_watch import watched


def _modules():
    import importlib

    ref = importlib.import_module("horovod_tpu.engine.build")
    from horovod_tpu_torch.engine import build as port

    return port, ref


def test_sanitize_mode_validation(monkeypatch):
    port, ref = _modules()
    monkeypatch.delenv("HVD_TPU_SANITIZE", raising=False)
    assert port.sanitize_mode() == ""
    monkeypatch.setenv("HVD_TPU_SANITIZE", " Thread ")
    assert port.sanitize_mode() == ref.sanitize_mode() == "thread"
    monkeypatch.setenv("HVD_TPU_SANITIZE", "rowhammer")
    msgs = []
    for mod in (port, ref):
        with pytest.raises(ValueError) as exc:
            mod.sanitize_mode()
        msgs.append(str(exc.value))
        # The launcher catches this ValueError (not a KeyError).
        with pytest.raises(ValueError):
            mod.sanitizer_preload("rowhammer")
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError):
        port.build()
    assert port.sanitizer_preload("") == ""


def test_sanitize_lib_paths_flags_and_stamps(monkeypatch):
    port, _ = _modules()
    monkeypatch.delenv("HVD_TPU_SANITIZE", raising=False)
    normal = port.lib_path("")
    assert port.lib_path() == normal
    assert os.path.basename(normal).startswith(port.LIB_STEM + "-")
    paths = {m: port.lib_path(m) for m in ("thread", "address", "undefined")}
    for mode, path in paths.items():
        assert os.path.dirname(path) == port.BUILD_DIR
        assert os.path.basename(path).startswith(
            f"{port.LIB_STEM}.{mode}-")
    assert len({normal, *paths.values()}) == 4
    # The mode in the environment selects its library; the normal path
    # and stamp do not move with it.
    monkeypatch.setenv("HVD_TPU_SANITIZE", "thread")
    assert port.lib_path() == paths["thread"]
    assert port.lib_path("") == normal
    flags = port.cxx_flags("thread")
    assert "-fsanitize=thread" in flags and "-g" in flags
    assert "-O3" not in flags and "-march=native" not in flags
    assert "-O1" in flags and "-fno-omit-frame-pointer" in flags
    assert port.cxx_flags("") == port.CXX_FLAGS
    assert "-O3" in port.cxx_flags("")
    assert "-fsanitize=thread" not in port.cxx_flags("")
    assert "-fsanitize=address" in port.link_flags("address")
    assert port.link_flags("") == port.LINK_FLAGS
    assert "-fno-sanitize-recover=all" in port.cxx_flags("undefined")
    stamps = {m: port.build_stamp(m)
              for m in ("", "thread", "address", "undefined")}
    assert len(set(stamps.values())) == 4
    assert normal.endswith(f"-{stamps['']}.so")


def _fake_cxx(tmp_path):
    """A compiler that prints nothing for ``-print-file-name``."""
    path = tmp_path / "fake-g++"
    path.write_text("#!/bin/sh\nexit 0\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _rank_envs(launch, base, np_=4):
    return [launch.make_rank_env(r, np_, "127.0.0.1:1",
                                 [f"127.0.0.1:{2 + i}" for i in range(np_)],
                                 dict(base)) for r in range(np_)]


def _launchers():
    import horovod_tpu.runner.launch as ref
    import horovod_tpu_torch.runner.launch as port

    return port, ref


def _clear(port, ref):
    for build in _modules():
        build._resolve_preload.cache_clear()
    port._sanitize_warned.clear()
    ref._sanitize_warned.clear()


@pytest.mark.parametrize("existing", ["", "/usr/lib/libjemalloc.so.2",
                                      "RUNTIME"])
def test_launcher_composes_ld_preload(existing, monkeypatch, capsys):
    port, ref = _launchers()
    build, _ = _modules()
    _clear(port, ref)
    runtime = build.sanitizer_preload("address")
    if not runtime:
        pytest.skip("no libasan on this toolchain")
    existing = existing.replace("RUNTIME", runtime)
    own = os.environ.get("LD_PRELOAD")
    base = {"HVD_TPU_SANITIZE": "address", "PATH": os.environ["PATH"]}
    if existing:
        base["LD_PRELOAD"] = existing
    got = [e.get("LD_PRELOAD") for e in _rank_envs(port, base)]
    want = [e.get("LD_PRELOAD") for e in _rank_envs(ref, base)]
    assert got == want
    parts = got[0].split(":")
    assert parts[0] == runtime and parts.count(runtime) == 1
    if existing and existing != runtime:
        assert parts[1:] == [existing]
    assert os.environ.get("LD_PRELOAD") == own
    assert capsys.readouterr().err == ""
    # No mode, no preload.
    base.pop("HVD_TPU_SANITIZE")
    assert [e.get("LD_PRELOAD") for e in _rank_envs(port, base)] == \
        [existing or None] * 4


def _warnings(err, prefix):
    return [ln[len(prefix):] for ln in err.splitlines()
            if ln.startswith(prefix)]


@pytest.mark.parametrize("case", ["bad_mode", "no_runtime",
                                  "no_runtime_user_preload"])
def test_launcher_warns_once_per_job(case, tmp_path, monkeypatch, capsys):
    port, ref = _launchers()
    _clear(port, ref)
    base = {"HVD_TPU_SANITIZE": "thread", "PATH": os.environ["PATH"]}
    if case == "bad_mode":
        base["HVD_TPU_SANITIZE"] = "rowhammer"
    else:
        monkeypatch.setenv("CXX", _fake_cxx(tmp_path))
    if case == "no_runtime_user_preload":
        base["LD_PRELOAD"] = "/usr/lib/libtsan.so.2"
    try:
        got = [e.get("LD_PRELOAD") for e in _rank_envs(port, base)]
        port_err = capsys.readouterr().err
        want = [e.get("LD_PRELOAD") for e in _rank_envs(ref, base)]
        ref_err = capsys.readouterr().err
    finally:
        _clear(port, ref)
    assert got == want == [base.get("LD_PRELOAD")] * 4
    port_lines = _warnings(port_err, "horovod_tpu_torch.runner: WARNING: ")
    assert port_lines == _warnings(ref_err, "hvdrun: WARNING: ")
    if case == "no_runtime_user_preload":
        assert port_lines == []
    else:
        assert len(port_lines) == 1
        assert ("rowhammer" if case == "bad_mode"
                else "could not be resolved") in port_lines[0]


# ---------------------------------------------------------------------------
# The slow tier: sanitized jobs on the port's engine.
# ---------------------------------------------------------------------------

_TSAN_BODY = """
import os, threading
rank = int(os.environ["HVD_TPU_RANK"])
os.environ["HVD_TPU_LOCAL_SIZE"] = "2"
os.environ["HVD_TPU_LOCAL_RANK"] = str(rank % 2)
os.environ["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
os.environ["HVD_TPU_COMPRESSION"] = "bf16"
os.environ["HVD_TPU_AUTOTUNE"] = "1"
os.environ["HVD_TPU_AUTOTUNE_WINDOW"] = "8"
os.environ["HVD_TPU_AUTOTUNE_WARMUP"] = "0"
os.environ["HVD_TPU_METRICS"] = "1"
INIT()
stop = threading.Event()
def poll():
    while not stop.is_set():
        top.metrics_snapshot()
        top.autotune_report()
        top.compression_report()
poller = threading.Thread(target=poll)
poller.start()
try:
    for step in range(40):
        out = hvd.allreduce(ones(80000), name=f"big.{step % 4}")
        assert abs(as_list(out)[0] - 1.0) < 1e-3, as_list(out)[0]
        hvd.allreduce(ones(64) * 2, name=f"small.{step % 4}")
        if step % 7 == 0:
            hvd.allgather(arange(rank + 1), name=f"ag.{step % 2}")
            hvd.broadcast(ones(256), step % hvd.size(),
                          name=f"b.{step % 2}")
    if rank == 0:
        top.autotune_set(fusion_threshold=1 << 20, cycle_time_ms=2.0,
                         cross_algo_threshold=1 << 30)
    for step in range(10):
        hvd.allreduce(ones(80000), name=f"big.{step % 4}")
finally:
    stop.set()
    poller.join()
hvd.shutdown()
print("ENGINE", lib()._name, os.environ.get("LD_PRELOAD"))
print("SANITIZED_OK")
"""

_ASAN_BODY = """
import os
INIT()
for step in range(10):
    hvd.allreduce(ones(4096), name=f"g.{step % 2}")
hvd.allgather(arange(hvd.rank() + 1), name="ag")
hvd.shutdown()
print("ENGINE", lib()._name, os.environ.get("LD_PRELOAD"))
print("SANITIZED_OK")
"""

_UBSAN_BODY = """
import os
rank = int(os.environ["HVD_TPU_RANK"])
os.environ["HVD_TPU_LOCAL_SIZE"] = "1"
os.environ["HVD_TPU_LOCAL_RANK"] = "0"
os.environ["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
os.environ["HVD_TPU_COMPRESSION"] = "bf16"
INIT()
for step in range(12):
    out = hvd.allreduce(ones(80000) * (rank + 1), average=False,
                        name=f"g.{step % 3}")
    assert abs(as_list(out)[0] - 6.0) < 1e-2, as_list(out)[0]
    hvd.allreduce(ones(63) * 2, name=f"s.{step % 3}")
hvd.allgather(arange(rank + 1), name="ag")
hvd.shutdown()
print("ENGINE", lib()._name, os.environ.get("LD_PRELOAD"))
print("SANITIZED_OK")
"""

# mode -> (ranks, body, the runtime's options, the report that fails a
# rank, seconds).  The options are the reference's.
_JOBS = {
    "thread": (4, _TSAN_BODY, {"TSAN_OPTIONS": "exitcode=66 halt_on_error=0"},
               "WARNING: ThreadSanitizer", 420),
    "address": (3, _ASAN_BODY,
                {"ASAN_OPTIONS": "exitcode=66 detect_leaks=0"},
                "ERROR: AddressSanitizer", 300),
    "undefined": (3, _UBSAN_BODY, {"UBSAN_OPTIONS": "print_stacktrace=1"},
                  "runtime error:", 300),
}


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["thread", "address", "undefined"])
def test_sanitized_job_clean(mode, monkeypatch):
    build, _ = _modules()
    np_, body, options, report, seconds = _JOBS[mode]
    if not build.sanitizer_preload(mode):
        pytest.skip(f"no {mode} sanitizer runtime on this toolchain")
    # Build the mode's engine once, before the ranks would race to.
    monkeypatch.setenv("HVD_TPU_SANITIZE", mode)
    build.build()
    env = twin.env(HVD_TPU_SANITIZE=mode, **options)
    env.pop("LD_PRELOAD", None)  # the launcher's to set
    with watched(seconds + 30, f"{mode}-sanitized job at np {np_}"):
        results = twin.run(True, body, np_, timeout=seconds, env=env)
    for r in results:
        assert r.returncode == 0, (
            f"rank {r.rank} exited {r.returncode} under {mode}\n"
            f"--- stderr ---\n{r.stderr[-8000:]}")
        assert report not in r.stderr, (
            f"rank {r.rank} reported:\n{r.stderr[-8000:]}")
        assert "SANITIZED_OK" in r.stdout
        # The mode's own library, loaded under the launcher's preload.
        engine = twin.lines([r], "ENGINE")[r.rank]
        assert engine == [f"{build.lib_path(mode)} "
                          f"{build.sanitizer_preload(mode)}"], engine
