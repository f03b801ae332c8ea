"""horovod_tpu_torch's checkpoints against horovod_tpu's.

The same trees go through both packages' ``save_checkpoint`` /
``load_checkpoint`` (``jax/train.py``, ``torch/train.py``) and
``state/checkpoint.py``: a plain-container numpy tree, whose manifest and
shard documents must be equal, and a torch ``state_dict`` with an AdamW
``state_dict`` (int keys, ``None`` hyper-parameters) and one bfloat16
leaf, which the JAX package sees as numpy and ``ml_dtypes`` arrays.
Each package reads the other's legacy and sharded checkpoints bit for
bit: at np 1, collectively at np 2, and np 2 shards locally at np 1 and
np 3; the port reads bfloat16 with ``ml_dtypes`` blocked.  The
reference's collective load fails on a 0-d leaf (``_no_0d``), so it
reads the port's np 2 checkpoint collectively with AdamW's ``step``
made 1-d, and the whole tree locally.  Also: torn
directories invisible and refused, retention, ``tools/ckpt_inspect.py``
on the port's files, an LM resumed at np 2 bit-identical to an
uninterrupted run, and the port's server on sharded checkpoints.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = 7
_ENGINE_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
               "HVD_TPU_DATA", "HVD_TPU_TIMELINE", "HOROVOD_TIMELINE",
               "HVD_TPU_CKPT_KEEP", "HVD_TPU_FAULT_SPEC")


def _numpy_tree():
    """A plain-container tree: nested dicts (an int-keyed one), a list, a
    tuple, ``None``, python scalars and numpy arrays of several dtypes."""
    return {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
            "opt": [np.full(6, 2.0, np.float64), np.int16([1, 2, 3]),
                    (np.int64(5), None)],
            "groups": {0: {"lr": 0.5, "flag": True}, 2: {"lr": 0.25}},
            "step_count": 11, "note": "exact", "none": None}


def _state_tree(seed=0):
    """``{"model", "optimizer", "step", "bf"}``: a state_dict, AdamW's
    state_dict after one step, and a bfloat16 leaf."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(2, 4)).square().sum().backward()
    opt.step()
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "step": STEP, "bf": torch.randn(3, 5).to(torch.bfloat16)}


def _tree(kind):
    return _numpy_tree() if kind == "numpy" else _state_tree()


def _as_numpy(tree):
    """The tree as the JAX package holds it: tensors as numpy arrays,
    bfloat16 as ``ml_dtypes.bfloat16``."""
    import ml_dtypes

    from horovod_tpu_torch.state import flatten_tree

    leaves, rebuild = flatten_tree(tree)
    return rebuild([
        (x.float().numpy().astype(ml_dtypes.bfloat16)
         if x.dtype == torch.bfloat16 else x.numpy())
        if torch.is_tensor(x) else x for x in leaves])


def _norm(x):
    """A leaf as (kind, dtype, shape, bytes) for arrays and tensors, else
    (type, value)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        return ("array", str(x.dtype).replace("torch.", ""),
                tuple(x.shape), x.reshape(-1).view(torch.uint8)
                .numpy().tobytes())
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.name, tuple(x.shape),
                np.ascontiguousarray(x).tobytes())
    return (type(x).__name__, x)


def _flat(tree):
    from horovod_tpu_torch.state import flatten_tree

    return [_norm(x) for x in flatten_tree(tree)[0]]


def _same(got, want):
    """Equal structure and leaves bit for bit (dtypes by name)."""
    from horovod_tpu_torch.state import flatten_tree

    assert flatten_tree(got)[1](list(range(len(_flat(got))))) == \
        flatten_tree(want)[1](list(range(len(_flat(want)))))
    assert _flat(got) == _flat(want)


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    for var in _ENGINE_ENV:
        env.pop(var, None)
    env.update(extra)
    return env


@pytest.fixture(autouse=True)
def no_engine(monkeypatch):
    """In-process reads and writes run without an engine, at size 1."""
    import horovod_tpu_torch as hvd

    for var in _ENGINE_ENV:
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()


# ---------------------------------------------------------------------------
# The format: manifests and shard documents equal the reference's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 3])
def test_manifest_and_shards_equal_the_reference(size, tmp_path):
    from horovod_tpu.state import checkpoint as jck
    from horovod_tpu_torch.state import checkpoint as tck

    dirs = {}
    for name, mod in (("jax", jck), ("port", tck)):
        dirs[name] = str(tmp_path / name)
        for r in reversed(range(size)):  # rank 0 commits last
            path = mod.save_sharded(dirs[name], STEP, _numpy_tree(), r, size)
    sub = os.path.basename(path)
    read = {k: json.load(open(os.path.join(d, sub, "manifest.json")))
            for k, d in dirs.items()}
    assert read["port"] == read["jax"]
    for r in range(size):
        docs = {}
        for k, d in dirs.items():
            with open(os.path.join(d, sub, f"rank-{r}.pkl"), "rb") as f:
                docs[k] = pickle.load(f)
        port, ref = docs["port"], docs["jax"]
        assert {k: v for k, v in port.items() if k != "leaves"} == \
            {k: v for k, v in ref.items() if k != "leaves"}
        assert {i: _norm(a) for i, a in port["leaves"].items()} == \
            {i: _norm(a) for i, a in ref["leaves"].items()}


def test_manifest_names_follow_keystr(tmp_path):
    import jax

    from horovod_tpu_torch.state import checkpoint as tck

    tree = _numpy_tree()
    tck.save_sharded(str(tmp_path), STEP, tree, 0, 1)
    manifest = tck.read_manifest(str(tmp_path / f"ckpt-{STEP:08d}"))
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [m["name"] for m in manifest["leaves"]] == want


@pytest.mark.parametrize("size", [1, 2, 3, 5])
def test_partition_contract_matches_the_reference(size):
    from horovod_tpu.state import partition as jp
    from horovod_tpu_torch.state import partition as tp

    n = 11
    assert [tp.owner(i, size) for i in range(n)] == \
        [jp.owner(i, size) for i in range(n)]
    for r in range(size):
        assert tp.shard_indices(r, size, n) == jp.shard_indices(r, size, n)


def test_tree_walk_matches_jax_tree_util_with_none():
    import jax

    from horovod_tpu_torch.state import flatten_tree

    tree = _as_numpy(_state_tree())
    leaves, rebuild = flatten_tree(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(want)
    assert all(a is b for a, b in zip(leaves, want))
    assert rebuild(leaves)["optimizer"]["param_groups"][0]["foreach"] is None


# ---------------------------------------------------------------------------
# Cross reads at np 1, both formats, both directions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["numpy", "state_dict"])
@pytest.mark.parametrize("fmt", ["legacy", "sharded"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others(writer, fmt, kind, tmp_path):
    from horovod_tpu.jax import train as J
    from horovod_tpu_torch.torch import train as T

    tree = _tree(kind)
    write = (J.save_checkpoint, _as_numpy(tree)) if writer == "jax" \
        else (T.save_checkpoint, tree)
    path = write[0](str(tmp_path), STEP, write[1],
                    sharded=fmt == "sharded")
    assert os.path.isdir(path) == (fmt == "sharded")
    reader, own = (T, J) if writer == "jax" else (J, T)
    step, got = reader.load_latest_checkpoint(str(tmp_path))
    assert step == STEP
    # What the writer's own package reads back (the reference's legacy
    # save turns a numpy scalar into a 0-d array).
    _same(got, own.load_latest_checkpoint(str(tmp_path))[1])
    if kind == "state_dict":
        _same(got, tree)
    if kind == "state_dict" and reader is T:
        fresh = _state_tree(seed=1)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                    torch.nn.LayerNorm(3))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        model.load_state_dict(got["model"])
        opt.load_state_dict(got["optimizer"])
        assert _flat(opt.state_dict()) == _flat(tree["optimizer"])
        assert _flat(model.state_dict()) != _flat(fresh["model"])


@pytest.mark.parametrize("fmt", ["legacy", "sharded"])
def test_port_reads_jax_bf16_without_ml_dtypes(fmt, tmp_path):
    from horovod_tpu.jax import train as J

    tree = _state_tree()
    J.save_checkpoint(str(tmp_path), STEP, _as_numpy(tree),
                      sharded=fmt == "sharded")
    code = ("import sys\n"
            "for m in ('ml_dtypes', 'jax', 'jaxlib', 'flax', 'optax',\n"
            "          'horovod_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from horovod_tpu_torch.torch import train as T\n"
            f"step, t = T.load_latest_checkpoint({str(tmp_path)!r})\n"
            "b = t['bf']\n"
            "print(step, b.dtype, b.view(__import__('torch').int16)"
            ".numpy().tobytes().hex())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    step, dtype, bits = out.stdout.split()
    assert (int(step), dtype) == (STEP, "torch.bfloat16")
    assert bits == tree["bf"].view(torch.int16).numpy().tobytes().hex()


# ---------------------------------------------------------------------------
# np 2 jobs: collective reads, and np 2 shards read at np 1 and np 3.
# ---------------------------------------------------------------------------


def _rank_job(package, np_, role, out):
    """Run ``_<role>_rank(out)`` of this module on ``np_`` ranks of
    ``package``'s launcher."""
    code = (f"from tests.test_torch_checkpoint import _{role}_rank\n"
            f"_{role}_rank({out!r})\n")
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.runner", "-np", str(np_), "--",
         sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _record(out, rank, name, tree):
    with open(os.path.join(out, f"{name}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(_flat(tree), f)


def _jax_write_rank(out):
    import horovod_tpu as hvd
    from horovod_tpu.jax import train as J

    hvd.init()
    J.save_checkpoint(os.path.join(out, "jax"), STEP,
                      _as_numpy(_state_tree()), sharded=True)
    hvd.shutdown()


def _no_0d(tree):
    """``tree`` with every 0-d tensor (AdamW's ``step``) made 1-d: the
    reference's collective load sends an owner's 0-d leaf as shape [1]
    (``np.ascontiguousarray``) against the receivers' [], and fails."""
    from horovod_tpu_torch.state import flatten_tree

    leaves, rebuild = flatten_tree(tree)
    return rebuild([x.reshape(1) if torch.is_tensor(x) and x.dim() == 0
                    else x for x in leaves])


def _port_np2_rank(out):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch import train as T

    hvd.init(device="cpu")
    T.save_checkpoint(os.path.join(out, "port"), STEP, _state_tree(),
                      sharded=True)
    T.save_checkpoint(os.path.join(out, "port_no_0d"), STEP,
                      _no_0d(_state_tree()), sharded=True)
    _, tree = T.load_latest_checkpoint(os.path.join(out, "jax"))
    _record(out, hvd.rank(), "port_reads_jax_np2", tree)
    _lm_run(out, resume=False)
    hvd.shutdown()


def _jax_np2_rank(out):
    import horovod_tpu as hvd
    from horovod_tpu.jax import train as J

    hvd.init()
    _, tree = J.load_latest_checkpoint(os.path.join(out, "port_no_0d"))
    _record(out, hvd.rank(), "jax_reads_port_np2", tree)
    hvd.shutdown()


def _port_np3_rank(out):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch import train as T

    hvd.init(device="cpu")
    _, tree = T.load_latest_checkpoint(os.path.join(out, "jax"))
    _record(out, hvd.rank(), "port_reads_jax_np3", tree)
    hvd.shutdown()


def _jax_np3_rank(out):
    import horovod_tpu as hvd
    from horovod_tpu.jax import train as J

    hvd.init()
    _, tree = J.load_latest_checkpoint(os.path.join(out, "port"))
    _record(out, hvd.rank(), "jax_reads_port_np3", tree)
    hvd.shutdown()


@pytest.fixture(scope="module")
def np2_jobs(tmp_path_factory):
    """Both packages write ``_state_tree()`` sharded at np 2 and read the
    other's collectively at np 2 and locally at np 3."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()
    out = str(tmp_path_factory.mktemp("np2"))
    _rank_job("horovod_tpu", 2, "jax_write", out)
    _rank_job("horovod_tpu_torch", 2, "port_np2", out)
    _rank_job("horovod_tpu", 2, "jax_np2", out)
    _rank_job("horovod_tpu_torch", 3, "port_np3", out)
    _rank_job("horovod_tpu", 3, "jax_np3", out)
    return out


@pytest.mark.parametrize("name,np_", [("port_reads_jax_np2", 2),
                                      ("jax_reads_port_np2", 2),
                                      ("port_reads_jax_np3", 3),
                                      ("jax_reads_port_np3", 3)])
def test_np2_checkpoints_read_by_the_other_package(np2_jobs, name, np_):
    want = _flat(_no_0d(_state_tree()) if name == "jax_reads_port_np2"
                 else _state_tree())
    for r in range(np_):
        with open(os.path.join(np2_jobs, f"{name}.rank{r}.pkl"), "rb") as f:
            assert pickle.load(f) == want, (name, r)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_np2_checkpoints_read_locally_at_np1(np2_jobs, writer, reader):
    from horovod_tpu.jax import train as J
    from horovod_tpu_torch.torch import train as T
    from horovod_tpu_torch.state import checkpoint as tck

    d = os.path.join(np2_jobs, writer)
    path = T.latest_checkpoint(d)
    assert tck.read_manifest(path)["size"] == 2
    assert sorted(os.listdir(path)) == ["manifest.json", "rank-0.pkl",
                                        "rank-1.pkl"]
    step, tree = (T if reader == "port" else J).load_checkpoint(
        path, collective=False)
    assert step == STEP
    _same(tree, _state_tree())


# ---------------------------------------------------------------------------
# Torn directories, retention, the inspection tool, the counters.
# ---------------------------------------------------------------------------


def test_latest_checkpoint_mixed_formats_and_torn_dirs(tmp_path):
    from horovod_tpu_torch.torch.train import (latest_checkpoint,
                                               save_checkpoint)

    d = str(tmp_path)
    save_checkpoint(d, 3, {"w": torch.ones(4)})
    save_checkpoint(d, 5, {"w": torch.ones(4)}, sharded=True)
    assert latest_checkpoint(d).endswith("ckpt-00000005")
    save_checkpoint(d, 8, {"w": torch.ones(4)})
    assert latest_checkpoint(d).endswith("ckpt-00000008.pkl")
    os.makedirs(os.path.join(d, "ckpt-00000010"))  # torn: no manifest
    assert latest_checkpoint(d).endswith("ckpt-00000008.pkl")


def test_nothing_to_resume_from(tmp_path):
    from horovod_tpu_torch.torch.train import load_latest_checkpoint

    assert load_latest_checkpoint(str(tmp_path / "absent")) == (0, None)
    assert load_latest_checkpoint(str(tmp_path)) == (0, None)


def _tear(path, case):
    """Tear the sharded checkpoint ``path`` as ``case`` says."""
    shard = os.path.join(path, "rank-0.pkl")
    if case == "missing_shard":
        os.unlink(shard)
    elif case == "step_mismatch":
        with open(shard, "rb") as f:
            doc = pickle.load(f)
        doc["step"] = 99
        with open(shard, "wb") as f:
            pickle.dump(doc, f)
    elif case == "truncated":
        data = open(shard, "rb").read()
        with open(shard, "wb") as f:
            f.write(data[: len(data) // 2])


@pytest.mark.parametrize("case,match", [
    ("no_manifest", "no committed manifest"),
    ("missing_shard", "missing shard"),
    ("step_mismatch", "step 99"),
    ("truncated", "unreadable")])
def test_torn_sharded_checkpoint_refused(case, match, tmp_path):
    from horovod_tpu_torch.torch.train import load_checkpoint, save_checkpoint

    if case == "no_manifest":
        path = str(tmp_path / "ckpt-00000009")
        os.makedirs(path)
    else:
        path = save_checkpoint(str(tmp_path), 5, _state_tree(), sharded=True)
        _tear(path, case)
    with pytest.raises(ValueError, match=match):
        load_checkpoint(path)


def test_retention_keeps_the_last_k(tmp_path):
    from horovod_tpu_torch.state.checkpoint import scan_checkpoints
    from horovod_tpu_torch.torch.train import (latest_checkpoint,
                                               save_checkpoint)

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "ckpt-00000000"))  # torn: never pruned
    for step in (1, 2, 3):
        save_checkpoint(d, step, {"w": torch.ones(4)}, keep=2)
    save_checkpoint(d, 4, {"w": torch.ones(4)}, sharded=True, keep=2)
    assert [s for s, _, _ in scan_checkpoints(d)] == [3, 4]
    assert os.path.isdir(os.path.join(d, "ckpt-00000000"))
    assert latest_checkpoint(d).endswith("ckpt-00000004")


def test_retention_env_knob(tmp_path, monkeypatch):
    from horovod_tpu_torch.state.checkpoint import scan_checkpoints
    from horovod_tpu_torch.torch.train import save_checkpoint

    monkeypatch.setenv("HVD_TPU_CKPT_KEEP", "1")
    d = str(tmp_path)
    save_checkpoint(d, 1, {"w": torch.ones(2)})
    save_checkpoint(d, 2, {"w": torch.ones(2)}, sharded=True)
    assert [s for s, _, _ in scan_checkpoints(d)] == [2]
    monkeypatch.setenv("HVD_TPU_CKPT_KEEP", "banana")
    with pytest.raises(ValueError, match="HVD_TPU_CKPT_KEEP"):
        save_checkpoint(d, 3, {"w": torch.ones(2)})


def test_ckpt_inspect_reads_port_checkpoints(tmp_path, capsys):
    from horovod_tpu_torch.torch.train import save_checkpoint
    from tools.ckpt_inspect import inspect

    d = str(tmp_path)
    save_checkpoint(d, 2, _state_tree())
    save_checkpoint(d, 4, _state_tree(), sharded=True)
    assert inspect(d, leaves=True) == 0
    out = capsys.readouterr().out
    assert "legacy  step 2" in out and "sharded  step 4" in out
    assert "['model']['0.weight']" in out and "bfloat16" in out


def test_checkpoint_counters(tmp_path):
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.torch.train import (load_latest_checkpoint,
                                               save_checkpoint)

    metrics.registry.reset()
    d = str(tmp_path)
    legacy = save_checkpoint(d, 1, _state_tree())
    written = os.path.getsize(legacy)
    sharded = save_checkpoint(d, 2, _state_tree(), sharded=True, keep=1)
    written += os.path.getsize(os.path.join(sharded, "rank-0.pkl"))
    load_latest_checkpoint(d)
    ckpt = metrics.registry.snapshot()["state"]["ckpt"]
    metrics.registry.reset()
    assert not os.path.exists(legacy)
    assert ckpt == {"legacy_saves": 1, "sharded_saves": 1, "loads": 1,
                    "pruned": 1, "shard_bytes": written}


# ---------------------------------------------------------------------------
# A port LM resumed from a sharded checkpoint at np 2.
# ---------------------------------------------------------------------------

_LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           batch=2, seq=16, dtype=torch.float32,
           logits_dtype=torch.float32, seed=3)


def _lm_run(out, resume):
    """Two steps, a sharded save and two more steps of a small LM on this
    rank (``resume``: a restart that loads the save and takes the last
    two); the losses and digests go to ``out``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch import train as T
    from horovod_tpu_torch.torch.lm_step import build_lm_step

    model, step, data = build_lm_step("cpu", **_LM)
    d = os.path.join(out, "lm")
    losses = []
    if resume:
        _, tree = T.load_latest_checkpoint(d)
        model.load_state_dict(tree["model"])
        step.optimizer.load_state_dict(tree["optimizer"])
    else:
        for _ in range(2):
            losses.append(step(data).item())
        T.save_checkpoint(d, 2, {"model": model.state_dict(),
                                 "optimizer": step.optimizer.state_dict(),
                                 "step": 2}, sharded=True)
    for _ in range(2):
        losses.append(step(data).item())
    with open(os.path.join(out, f"lm.{int(resume)}.rank{hvd.rank()}.pkl"),
              "wb") as f:
        pickle.dump([losses, _flat(model.state_dict()),
                     _flat(step.optimizer.state_dict())], f)


def _lm_resume_rank(out):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    _lm_run(out, resume=True)
    hvd.shutdown()


def test_lm_resumed_at_np2_is_bit_identical(np2_jobs):
    """The uninterrupted run is the np 2 job's (``_port_np2_rank``)."""
    _rank_job("horovod_tpu_torch", 2, "lm_resume", np2_jobs)
    for r in range(2):
        with open(os.path.join(np2_jobs, f"lm.0.rank{r}.pkl"), "rb") as f:
            whole_losses, *whole = pickle.load(f)
        with open(os.path.join(np2_jobs, f"lm.1.rank{r}.pkl"), "rb") as f:
            resumed_losses, *resumed = pickle.load(f)
        assert len(whole_losses) == 4 and resumed_losses == whole_losses[2:]
        assert resumed == whole


# ---------------------------------------------------------------------------
# The port's server on sharded checkpoints of either package.
# ---------------------------------------------------------------------------

SPEC = dict(vocab=97, d_model=32, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def flax_params():
    """A served model's weights in the flax layout, as the JAX package's
    training saves them."""
    from horovod_tpu_torch.models.convert import to_flax_params
    from horovod_tpu_torch.serving import engine as tengine

    spec = tengine.ModelSpec(**SPEC, device="cpu", seed=5)
    return to_flax_params(tengine.build_model(spec).state_dict())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_server_serves_a_sharded_checkpoint(writer, flax_params, tmp_path):
    import threading

    import horovod_tpu_torch as hvd
    from horovod_tpu.jax.train import save_checkpoint as jsave
    from horovod_tpu_torch.models.convert import from_flax_params
    from horovod_tpu_torch.serving import engine as tengine
    from horovod_tpu_torch.serving import scheduler as tsched
    from horovod_tpu_torch.torch.train import save_checkpoint as tsave

    want = from_flax_params(flax_params)
    spec = tengine.ModelSpec(**SPEC, device="cpu", ckpt=str(tmp_path))
    model = tengine.build_model(spec)
    model.load_state_dict(want)
    if writer == "jax":
        jsave(str(tmp_path), 4, {"params": flax_params}, sharded=True)
    else:
        opt = torch.optim.AdamW(model.parameters())
        tsave(str(tmp_path), 4, {"model": model.state_dict(),
                                 "optimizer": opt.state_dict(), "step": 4},
              sharded=True)
    params = tengine.init_params(spec)
    assert sorted(params) == sorted(want)
    for k, v in want.items():
        assert torch.equal(params[k], v), k
    hvd.init(device="cpu")
    try:
        cfg = tsched.ServeConfig(max_batch=2, prefill_chunk=4,
                                 block_tokens=4, num_blocks=32,
                                 max_blocks_per_seq=8)
        sch = tsched.Scheduler(cfg)
        engine = tengine.ServingEngine(spec, cfg, params, sch)
        loop = threading.Thread(target=engine.run, daemon=True)
        loop.start()
        req = sch.submit("t", [4, 2, 9, 9], 5)
        assert req.event.wait(120) and req.error is None
        engine.request_stop()
        loop.join(60)
    finally:
        hvd.shutdown()
    assert req.generated == tengine.reference_decode(model, [4, 2, 9, 9], 5)
