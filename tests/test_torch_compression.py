"""horovod_tpu_torch's wire compression against horovod_tpu's
(``common/config.py``, ``common/__init__.py``; the engine's compressed
ring is the same C++ in both packages).

Each program runs in the port's rank processes (its runner) and in the
reference's (``tests/distributed.py``) at the same np, on the same inputs
(numpy, seeded per rank and step), and the two are held equal:

- ``parse_compression`` and ``Config.compression_code`` on a table of
  spellings, errors and their messages included; ``Config.from_env``'s
  knobs; the refusals of a lossy ``HVD_TPU_AUTOTUNE_FIX`` pin with
  compression off and of a ``cross_algo_threshold`` pin on the flat ring
  (the same ``ValueError``); a mixed ``HVD_TPU_COMPRESSION`` at np 2 is a
  ``HorovodInternalError`` naming it on both ranks;
- at np 4, in bf16 and fp8 (floor 64 B): three steps of one name, whose
  error-feedback residual carries across them, bit for bit; the wire and
  payload byte deltas; the per-bucket decision log (also equal across
  ranks); bf16-representable inputs reduce exactly; the residual gauges;
- at np 2: a floor of 8192 B leaves a 256 B bucket uncompressed and
  compresses a 16 KiB one; ``off`` gives the exact float32 sum of the two
  contributions with wire bytes equal to payload bytes; CPU
  ``torch.bfloat16``/``float16`` tensors ship at their own width, under
  ``bf16`` as under ``off``;
- a small ``nn.Module`` trained by ``DistributedOptimizer`` under bf16 at
  np 2: parameters after 5 steps bit-equal to ``horovod_tpu.torch``'s,
  and one residual per gradient (every one is above the floor), constant
  over the steps (the optimizer names each gradient stably);
- the timeline: the ``COMPRESS_bf16`` instants sit on the reference's
  rows (np 2);
- elastic: a 3 -> 2 job under bf16 (``tests/test_compression.py``'s
  program, in torch) prints the reference's ``COMP`` lines: the survivors
  re-agree the mode at the reshape and go on compressing.

Tolerance: none.  Every comparison is exact (bits, counts, names).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from tests.distributed import run_ranks
from tests.test_torch_engine import OUT_ENV, _bits, _launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("bf16", "fp8")


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _arm(mode, min_bytes):
    os.environ["HVD_TPU_COMPRESSION"] = mode
    os.environ["HVD_TPU_COMPRESSION_MIN_BYTES"] = str(min_bytes)


def _deltas(top, base):
    eng = top.compression_report()["engine"]
    return (eng["wire_bytes"] - base["wire_bytes"],
            eng["payload_bytes"] - base["payload_bytes"],
            {m: eng["ops"][m] - base["ops"][m] for m in eng["ops"]})


# --- units: spellings, the environment, the refusals ----------------------


@pytest.mark.parametrize("spelling", [
    None, "", "off", "OFF", "none", "0", "bf16", "BF16", " bfloat16 ",
    "fp8", "fp8_e4m3", "float8_e4m3fn", "int4", "fp16", "1"])
def test_parse_compression_matches_the_reference(spelling):
    from horovod_tpu.common import config as ref
    from horovod_tpu_torch.common import config as port

    def outcome(mod):
        try:
            return mod.parse_compression(spelling)
        except ValueError as exc:
            return ("ValueError", str(exc))

    def code(mod):
        try:
            return mod.Config(compression=spelling or "off").compression_code
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert outcome(port) == outcome(ref)
    assert code(port) == code(ref)
    assert port.COMPRESSION_CODES == ref.COMPRESSION_CODES
    assert port.COMPRESSION_NAMES == ref.COMPRESSION_NAMES


@pytest.mark.parametrize("env", [
    {},
    {"HVD_TPU_COMPRESSION": "fp8", "HVD_TPU_COMPRESSION_MIN_BYTES": "8192",
     "HVD_TPU_AUTOTUNE": "1", "HVD_TPU_AUTOTUNE_WARMUP": "1",
     "HVD_TPU_AUTOTUNE_WINDOW": "8",
     "HVD_TPU_AUTOTUNE_FIX": "cycle_time_ms=5"},
    {"HVD_TPU_AUTOTUNE": "off", "HVD_TPU_COMPRESSION": "bf16",
     "HVD_TPU_COMPRESSION_MIN_BYTES": "0"},
])
def test_config_reads_the_knobs_as_the_reference(env, monkeypatch):
    from horovod_tpu.common import config as ref
    from horovod_tpu_torch.common import config as port

    for var in ("HVD_TPU_COMPRESSION", "HVD_TPU_COMPRESSION_MIN_BYTES",
                "HVD_TPU_AUTOTUNE", "HVD_TPU_AUTOTUNE_WARMUP",
                "HVD_TPU_AUTOTUNE_WINDOW", "HVD_TPU_AUTOTUNE_FIX"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = port.Config.from_env(), ref.Config.from_env()
    for field in ("compression", "compression_min_bytes", "autotune",
                  "autotune_warmup", "autotune_window", "autotune_fix",
                  "compression_code"):
        assert getattr(got, field) == getattr(want, field), field
    assert port.Config.unported_requests() == []


@pytest.mark.parametrize("env,match", [
    ({"HVD_TPU_AUTOTUNE_FIX": "compression=bf16"},
     "HVD_TPU_COMPRESSION is off"),
    ({"HVD_TPU_AUTOTUNE_FIX": "compression=fp8",
      "HVD_TPU_COMPRESSION": "off"}, "HVD_TPU_COMPRESSION is off"),
    ({"HVD_TPU_AUTOTUNE_FIX": "cross_algo_threshold=65536",
      "HVD_TPU_COMPRESSION": "bf16"}, "no cross-node hop"),
    ({"HVD_TPU_AUTOTUNE_FIX": "cross_algo_threshold=0"},
     "no cross-node hop"),
    ({"HVD_TPU_COMPRESSION": "int4"}, "unknown wire-compression mode"),
    ({"HVD_TPU_AUTOTUNE_FIX": "warmup=3"}, "bad clause"),
])
def test_init_refusals_match_the_reference(env, match, monkeypatch):
    """Both packages refuse before their engine starts, with the same
    ``ValueError``."""
    import horovod_tpu as ref
    import horovod_tpu_torch as port

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA", "HVD_TPU_COMPRESSION",
                "HVD_TPU_AUTOTUNE_FIX", "HVD_TPU_HIERARCHICAL_ALLREDUCE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port.shutdown()
    errors = []
    for init in (lambda: port.init(device="cpu"), ref.init):
        with pytest.raises(ValueError, match=match) as info:
            init()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert not port.is_initialized() and not ref.is_initialized()


def _mixed_env_rank():
    import horovod_tpu_torch as hvd

    rank = int(os.environ["HVD_TPU_RANK"])
    os.environ["HVD_TPU_COMPRESSION"] = "bf16" if rank == 0 else "off"
    with pytest.raises(hvd.HorovodInternalError,
                       match="HVD_TPU_COMPRESSION"):
        hvd.init(device="cpu")
    print("REFUSED", flush=True)


def test_mixed_environment_is_a_typed_error_on_every_rank():
    results = _launch(_mixed_env_rank, 2, timeout=60)
    assert all("REFUSED" in r.stdout for r in results)


# --- numerics at np 4 ------------------------------------------------------


def _numerics(hvd, top, init, out_path):
    """Per mode: 3 steps of one name from per-rank inputs, the byte
    deltas, an exact case, the decision log and the residual gauges."""
    out = {}
    for mode in MODES:
        _arm(mode, 64)
        init()
        r, n = hvd.rank(), hvd.size()
        base = top.compression_report()["engine"]
        log0 = len(top.compression_report()["log"])
        steps = []
        for s in range(3):
            rng = np.random.RandomState(100 * s + r)
            x = (rng.standard_normal(4096) * (1.0 + 30 * s)).astype(
                np.float32)
            steps.append(hvd.allreduce(torch.from_numpy(x), average=False,
                                       name="nm.ef"))
        dw, dp, ops = _deltas(top, base)
        exact = hvd.allreduce(torch.full((1024,), float(r + 1)),
                              average=False, name="nm.exact")
        assert torch.equal(exact, torch.full((1024,), n * (n + 1) / 2.0))
        rep = top.compression_report()
        out[mode] = {
            "steps": steps, "exact": exact, "bytes": (dw, dp), "ops": ops,
            "mode": rep["mode"], "min_bytes": rep["min_bytes"],
            "log": [(e["name"], e["mode"]) for e in rep["log"][log0:]],
            "residual": (rep["residual_bytes"], rep["residual_tensors"]),
        }
        top.shutdown()
    torch.save(out, out_path)


def _ref_numerics():
    import horovod_tpu as top
    import horovod_tpu.torch as hvd

    _numerics(hvd, top, top.init, os.path.join(
        os.environ[OUT_ENV], f"ref{int(os.environ['HVD_TPU_RANK'])}.pt"))


def _port_numerics(out_dir):
    import horovod_tpu_torch as top
    import horovod_tpu_torch.torch as hvd

    _numerics(hvd, top, lambda: top.init(device="cpu"), os.path.join(
        out_dir, f"port{int(os.environ['HVD_TPU_RANK'])}.pt"))


def _same(got, want, where):
    """``got`` equal to ``want``: tensors in dtype and bits, containers
    element by element, anything else by ``==``."""
    if torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype, where
        assert torch.equal(_bits(got), _bits(want)), where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], where + (k,))
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, where + (i,))
    else:
        assert got == want, (where, got, want)


def _held_equal(tmp_path, np_):
    """Each rank's port record against the reference's (tensors bit for
    bit); the port's records, by rank."""
    runs = []
    for r in range(np_):
        got = torch.load(tmp_path / f"port{r}.pt")
        _same(got, torch.load(tmp_path / f"ref{r}.pt"), (r,))
        runs.append(got)
    return runs


def test_compressed_allreduce_matches_the_reference_at_np_4(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_numerics, 4, timeout=120)
    _launch(functools.partial(_port_numerics, str(tmp_path)), 4)
    runs = _held_equal(tmp_path, 4)
    for mode, width in (("bf16", 2), ("fp8", 1)):
        rec = runs[0][mode]
        assert rec["mode"] == mode and rec["min_bytes"] == 64
        # Three buckets of 4096 float32 and one of 1024, all compressed.
        assert rec["bytes"] == (3 * 4096 * width, 3 * 4096 * 4)
        assert rec["ops"][mode] == 3
        assert rec["log"] == [("nm.ef", mode)] * 3 + [("nm.exact", mode)]
        assert rec["residual"] == (4 * (4096 + 1024), 2)
        for other in runs[1:]:  # lockstep: every rank the same verdicts
            assert other[mode]["log"] == rec["log"]
            for a, b in zip(other[mode]["steps"], rec["steps"]):
                assert torch.equal(_bits(a), _bits(b))


# --- the floor, the kill switch, half payloads at np 2 --------------------


def _floor_and_halves(hvd, top, init, out_path):
    out = {}
    for mode, floor in (("bf16", 8192), ("off", 1024)):
        _arm(mode, floor)
        init()
        r = hvd.rank()
        rec = {}
        base = top.compression_report()["engine"]
        log0 = len(top.compression_report()["log"])
        rec["small"] = hvd.allreduce(torch.full((64,), float(r)),
                                     average=False, name="fl.small")
        rec["big"] = hvd.allreduce(torch.full((4096,), float(r) + 0.5),
                                   average=False, name="fl.big")
        x = torch.from_numpy(
            np.random.RandomState(r).randn(4096).astype(np.float32))
        rec["bits"] = hvd.allreduce(x, average=False, name="ks.bits")
        rec["f32"] = _deltas(top, base)
        for dtype in (torch.float16, torch.bfloat16):
            tag = str(dtype)[6:]
            before = top.compression_report()["engine"]
            rec[tag] = hvd.allreduce(torch.full((512,), 0.5 + r,
                                                dtype=dtype),
                                     average=False, name=f"hw.{tag}")
            rec[f"{tag}.bytes"] = _deltas(top, before)
        rep = top.compression_report()
        rec["log"] = [(e["name"], e["mode"]) for e in rep["log"][log0:]]
        rec["mode"] = rep["mode"]
        out[mode] = rec
        top.shutdown()
    torch.save(out, out_path)


def _ref_floor():
    import horovod_tpu as top
    import horovod_tpu.torch as hvd

    _floor_and_halves(hvd, top, top.init, os.path.join(
        os.environ[OUT_ENV], f"ref{int(os.environ['HVD_TPU_RANK'])}.pt"))


def _port_floor(out_dir):
    import horovod_tpu_torch as top
    import horovod_tpu_torch.torch as hvd

    _floor_and_halves(hvd, top, lambda: top.init(device="cpu"),
                      os.path.join(out_dir,
                                   f"port{int(os.environ['HVD_TPU_RANK'])}"
                                   ".pt"))


def test_floor_off_and_half_payloads_match_the_reference(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_floor, 2, timeout=120)
    _launch(functools.partial(_port_floor, str(tmp_path)), 2)
    runs = _held_equal(tmp_path, 2)
    bf16, off = runs[0]["bf16"], runs[0]["off"]
    modes = dict(bf16["log"])
    assert modes["fl.small"] == "none" and modes["fl.big"] == "bf16"
    assert modes["ks.bits"] == "bf16"
    # off: the exact float32 sum of both ranks' contributions, no bucket
    # compressed, wire bytes equal to payload bytes.
    want = sum(torch.from_numpy(np.random.RandomState(i).randn(4096).astype(
        np.float32)) for i in range(2))
    assert torch.equal(_bits(off["bits"]), _bits(want))
    assert off["mode"] == "off" and off["f32"][0] == off["f32"][1]
    assert off["f32"][2]["bf16"] == off["f32"][2]["fp8"] == 0
    assert not torch.equal(_bits(bf16["bits"]), _bits(want))
    for rec in (bf16, off):
        for tag in ("float16", "bfloat16"):
            dw, dp, ops = rec[f"{tag}.bytes"]
            assert dw == dp == 1024, (tag, dw, dp)
            assert ops["bf16"] == ops["fp8"] == 0
            assert torch.equal(rec[tag].float(), torch.full((512,), 2.0))


# --- DistributedOptimizer under bf16 ---------------------------------------


def _optimizer_run(hvd, report, out_path):
    """5 steps of a small MLP (every parameter at or above the 64 B
    floor) under bf16; the residual gauges after each step."""
    r = hvd.rank()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                                torch.nn.Linear(32, 16))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    gauges = []
    for step in range(5):
        x = torch.from_numpy(np.random.RandomState(10 * step + r)
                             .standard_normal((8, 16))).float()
        model(x).pow(2).mean().backward()
        opt.step()
        opt.zero_grad()
        rep = report()
        gauges.append((rep["residual_tensors"], rep["residual_bytes"]))
    torch.save({"optimizer": {"state": model.state_dict(),
                              "gauges": gauges}}, out_path)


def _ref_optimizer():
    import horovod_tpu as top
    import horovod_tpu.torch as hvd

    _arm("bf16", 64)
    top.init()
    _optimizer_run(hvd, top.compression_report, os.path.join(
        os.environ[OUT_ENV], f"ref{top.rank()}.pt"))
    top.shutdown()


def _port_optimizer(out_dir):
    import horovod_tpu_torch.torch as hvd

    _arm("bf16", 64)
    hvd.init(device="cpu")
    _optimizer_run(hvd, hvd.compression_report,
                   os.path.join(out_dir, f"port{hvd.rank()}.pt"))
    hvd.shutdown()


def test_distributed_optimizer_under_bf16_matches_the_reference(
        tmp_path, monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_optimizer, 2, timeout=120)
    _launch(functools.partial(_port_optimizer, str(tmp_path)), 2)
    state = torch.load(tmp_path / "port0.pt")["optimizer"]["state"]
    _held_equal(tmp_path, 2)  # parameters bit for bit, gauges equal
    for r in range(2):
        gauges = torch.load(tmp_path / f"port{r}.pt")["optimizer"]["gauges"]
        n_bytes = 4 * sum(v.numel() for v in state.values())
        assert gauges == [(4, n_bytes)] * 5, gauges
    other = torch.load(tmp_path / "port1.pt")["optimizer"]["state"]
    for k, v in state.items():
        assert torch.equal(_bits(v), _bits(other[k])), k


# --- the timeline's COMPRESS instants --------------------------------------

_TL_PORT = """\
import os
os.environ["HVD_TPU_COMPRESSION"] = "bf16"
os.environ["HVD_TPU_COMPRESSION_MIN_BYTES"] = "8192"
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import common as C
hvd.init(device="cpu")
C.allreduce(torch.ones(4096), name="tl.big")
C.allreduce(torch.ones(64), name="tl.small")
C.allreduce(torch.ones(4096, dtype=torch.bfloat16), name="tl.half")
hvd.shutdown()
"""

_TL_REF = """\
import os
os.environ["HVD_TPU_COMPRESSION"] = "bf16"
os.environ["HVD_TPU_COMPRESSION_MIN_BYTES"] = "8192"
import ml_dtypes
import numpy as np
import horovod_tpu as hvd
from horovod_tpu import common as C
hvd.init()
C.allreduce(np.ones(4096, np.float32), name="tl.big")
C.allreduce(np.ones(64, np.float32), name="tl.small")
C.allreduce(np.ones(4096, ml_dtypes.bfloat16), name="tl.half")
hvd.shutdown()
"""


def test_compress_instants_sit_on_the_reference_rows(tmp_path):
    from tests.test_torch_timeline import _launch as tl_launch
    from tests.test_torch_timeline import _load, _row_names

    got = {}
    for package, code in (("horovod_tpu_torch", _TL_PORT),
                          ("horovod_tpu", _TL_REF)):
        tl = tmp_path / package
        tl_launch(package, tl, code)
        rows = []
        for r in range(2):
            events = _load(os.path.join(tl, f"rank{r}.json"))
            names = _row_names(events)
            rows.append(sorted(
                (names[e["pid"]], e["ph"], e["name"]) for e in events
                if e.get("name", "").startswith("COMPRESS_")))
        got[package] = rows
    assert got["horovod_tpu_torch"] == got["horovod_tpu"]
    for rows in got["horovod_tpu_torch"]:
        assert {(row, name) for row, _, name in rows} == {
            ("tl.big", "COMPRESS_bf16")}, rows


# --- elastic: the mode re-agreed at a reshape ------------------------------

_ELASTIC_PORT = """\
import sys
import torch
import horovod_tpu_torch.torch as hvd

TOTAL = int(sys.argv[1])
hvd.init(device="cpu")
state = hvd.ElasticState(weights=torch.zeros(1024), step=0)

def train(state):
    while state.step < TOTAL:
        g = torch.ones(1024)
        state.weights = state.weights + hvd.allreduce(
            g, average=True, name=f"grad.{state.step}")
        state.step += 1
    return state.weights

w = hvd.run_elastic(train, state)
assert torch.allclose(w, torch.full((1024,), float(TOTAL))), (hvd.rank(), w[0])
rep = hvd.compression_report()
from horovod_tpu_torch import common
m = common.metrics_snapshot()["membership"]
print("COMP", hvd.rank(), hvd.size(), m["epoch"], rep["mode"],
      rep["engine"]["ops"]["bf16"], flush=True)
"""


def _comp_lines(package, script, tmp_path):
    import importlib

    from tests.test_torch_elastic import _env

    runner = importlib.import_module(f"{package}.runner")
    path = tmp_path / f"{package}_comp.py"
    path.write_text(script)
    env = _env(HVD_TPU_COMPRESSION="bf16", HVD_TPU_COMPRESSION_MIN_BYTES=64,
               HVD_TPU_FAULT_SPEC="rank=2:crash@op=6",
               HVD_TPU_COLLECTIVE_TIMEOUT_SEC=20)
    results = runner.run_membership(
        [sys.executable, str(path), "20"], 3, min_np=2, max_np=3,
        max_rejoins=0, env=env, timeout=90.0, capture=True,
        report=lambda msg: None)
    by_slot = {r.rank: r for r in results}
    assert by_slot[2].returncode == 43, (package, by_slot[2].stderr[-800:])
    lines = []
    for slot in (0, 1):
        assert by_slot[slot].returncode == 0, \
            (package, slot, by_slot[slot].stderr[-800:])
        lines += [tuple(ln.split()[1:]) for ln in
                  by_slot[slot].stdout.splitlines() if ln.startswith("COMP ")]
    return sorted(lines)


def test_reshape_reagrees_compression_as_the_reference(tmp_path):
    from tests import test_compression

    port = _comp_lines("horovod_tpu_torch", _ELASTIC_PORT, tmp_path)
    ref = _comp_lines("horovod_tpu", test_compression._ELASTIC_TRAIN,
                      tmp_path)
    assert port == ref
    assert [line[:4] for line in port] == [("0", "2", "1", "bf16"),
                                           ("1", "2", "1", "bf16")]
    # The survivors kept compressing past the reshape (20 steps, 6 before
    # the crash): the reference's bound, on both.
    for line in port + ref:
        assert int(line[4]) >= 12, line
