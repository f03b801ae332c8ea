"""horovod_tpu_torch's point-to-point plane, stage groups and
``run_pipeline`` across processes, against horovod_tpu's.

The port's ranks start through its own runner (``launch_fn``), the
reference's through ``tests/distributed.py``, each in processes of their
own, on the same inputs (numpy-seeded):

- p2p at np 2: a send/recv round trip on both packages is bit-exact, the
  wire names equal the reference's ``_p2p_wire_name``, and every
  validation error (self-send, peer out of range, negative tag, a
  non-contiguous receive buffer) has the reference's type and message;
  the ``p2p`` section of ``metrics_snapshot()`` counts the transfers.
- Stage groups at np 4: a group allreduce (mean and sum) over {0, 1} and
  {2, 3} equals the reference's bit for bit, beside a world allreduce.
- ``run_pipeline`` at np 2 (2 stages x 1) and np 4 (2 x 2): 3 steps of a
  tiny float32 LM against the reference's ``run_pipeline`` with
  ``optax.adamw(1e-3)`` on the same converted weights (the port's AdamW
  with optax's weight decay 1e-4); losses rtol 1e-4, final parameters
  atol 5e-5 (``tests/test_torch_dp.py``'s tolerances: float32 summation
  order through three Adam steps).  Over steps 2-3 the engine's cache hit
  rate is >= 0.9 and no transfer is unmatched; the two DP replicas of a
  stage end bit-identical.
- Faults: an unmatched send times out naming the tensor and the peer; a
  stage rank that dies mid-schedule is named by its stage on every
  survivor.
"""

import functools
import os
import sys
import time

import numpy as np
import pytest
import torch

from tests.distributed import run_ranks
from tests.test_torch_engine import OUT_ENV, _bits, _launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D_MODEL, LAYERS, HEADS, SEQ, BATCH, MICRO = 64, 32, 4, 4, 16, 4, 2
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    """Both engines built before any timed launch (see
    ``tests/test_torch_engine.py``)."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


# ---------------------------------------------------------------------------
# The point-to-point plane and stage groups.
# ---------------------------------------------------------------------------


def _p2p_payload(r):
    return np.random.RandomState(40 + r).standard_normal((3, 33)).astype(
        np.float32)


def _p2p_case(hvd, as_array, out_path):
    """A round trip 0 -> 1 -> 0 on two tags, then each invalid call's
    ``(type name, message)``; the results saved to ``out_path``."""
    r = hvd.rank()
    peer = 1 - r
    x = as_array(_p2p_payload(r))
    buf = as_array(np.zeros((3, 33), np.float32))
    if r == 0:
        hvd.send(x, peer, tag=0, name="fwd")
        hvd.recv(buf, peer, tag=1, name="bwd")
    else:
        hvd.recv(buf, peer, tag=0, name="fwd")
        hvd.send(x, peer, tag=1, name="bwd")
    errors = {}
    bad = {
        "self": lambda: hvd.send(x, r),
        "range": lambda: hvd.send(x, 99),
        "tag": lambda: hvd.recv(buf, peer, tag=-1),
        "strided": lambda: hvd.recv(as_array(np.zeros((4, 6), np.float32))
                                    [:, ::2], peer),
    }
    for key, call in bad.items():
        try:
            call()
            errors[key] = None
        except Exception as exc:  # the class and message are the result
            errors[key] = (type(exc).__name__, str(exc))
    snap = hvd.metrics_snapshot()["p2p"]
    torch.save({"recv": np.asarray(buf).copy(), "errors": errors,
                "p2p": snap}, out_path)


def _ref_p2p_rank():
    import horovod_tpu as hvd

    hvd.init()
    _p2p_case(hvd, lambda a: a, os.path.join(
        os.environ[OUT_ENV], f"ref_p2p{hvd.rank()}.pt"))
    hvd.shutdown()


def _port_p2p_rank(out_dir):
    import horovod_tpu_torch.common as hvd

    hvd.init(device="cpu")
    _p2p_case(hvd, torch.from_numpy,
              os.path.join(out_dir, f"port_p2p{hvd.rank()}.pt"))
    hvd.shutdown()


def test_p2p_roundtrip_names_and_errors_match_reference(tmp_path,
                                                        monkeypatch):
    from horovod_tpu.common import _p2p_wire_name as ref_name
    from horovod_tpu_torch.common import _p2p_wire_name as port_name

    for args in (("act", 0, 1, 2), (None, 3, 1, 0), ("pipe.fwd.v1.mb3", 2,
                                                      5, 7)):
        assert port_name(*args) == ref_name(*args)
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_p2p_rank, 2, timeout=120)
    _launch(functools.partial(_port_p2p_rank, str(tmp_path)), 2)
    for r in range(2):
        ref = torch.load(tmp_path / f"ref_p2p{r}.pt", weights_only=False)
        got = torch.load(tmp_path / f"port_p2p{r}.pt", weights_only=False)
        want = _p2p_payload(1 - r)
        assert np.asarray(got["recv"]).tobytes() == want.tobytes()
        assert ref["recv"].tobytes() == want.tobytes()
        assert got["errors"] == ref["errors"]
        assert all(e is not None and e[0] == "ValueError"
                   for e in got["errors"].values()), got["errors"]
        p2p = got["p2p"]
        assert (p2p["sends"], p2p["recvs"]) == (1, 1), p2p
        assert p2p["matched"] >= 1 and p2p["unmatched"] == 0, p2p
        assert p2p["bytes"]["out"] >= 3 * 33 * 4 or \
            p2p["bytes"]["in"] >= 3 * 33 * 4, p2p


def _group_case(hvd, as_array, out_path):
    r = hvd.rank()
    stage = r // 2
    group = hvd.stage_group([2 * stage, 2 * stage + 1])
    x = as_array(np.random.RandomState(60 + r).standard_normal(
        (5, 17)).astype(np.float32))
    out = {
        "mean": hvd.allreduce(x, name=f"grad.s{stage}", group=group),
        "sum": hvd.allreduce(x, average=False, name=f"sum.s{stage}",
                             group=group),
        "world": hvd.allreduce(x, average=False, name="world"),
    }
    out = {k: np.asarray(v).copy() for k, v in out.items()}
    out["group_ops"] = hvd.metrics_snapshot()["p2p"]["group_ops"]
    torch.save(out, out_path)


def _ref_group_rank():
    import horovod_tpu as hvd

    hvd.init()
    _group_case(hvd, lambda a: a, os.path.join(
        os.environ[OUT_ENV], f"ref_group{hvd.rank()}.pt"))
    hvd.shutdown()


def _port_group_rank(out_dir):
    import horovod_tpu_torch.common as hvd

    hvd.init(device="cpu")
    _group_case(hvd, torch.from_numpy,
                os.path.join(out_dir, f"port_group{hvd.rank()}.pt"))
    hvd.shutdown()


def test_stage_group_allreduce_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_group_rank, 4, timeout=120)
    _launch(functools.partial(_port_group_rank, str(tmp_path)), 4)
    for r in range(4):
        ref = torch.load(tmp_path / f"ref_group{r}.pt", weights_only=False)
        got = torch.load(tmp_path / f"port_group{r}.pt", weights_only=False)
        for key in ("mean", "sum", "world"):
            assert got[key].tobytes() == ref[key].tobytes(), (r, key)
        partner = np.random.RandomState(60 + (r ^ 1)).standard_normal(
            (5, 17)).astype(np.float32)
        mine = np.random.RandomState(60 + r).standard_normal(
            (5, 17)).astype(np.float32)
        np.testing.assert_allclose(got["sum"], mine + partner, rtol=1e-6)
        assert got["group_ops"] == ref["group_ops"] >= 2


# ---------------------------------------------------------------------------
# run_pipeline against the reference's.
# ---------------------------------------------------------------------------


def _tokens(dp_index):
    tokens = np.random.RandomState(100 + dp_index).randint(
        0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def _flax_init():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerLM

    return jax.device_get(TransformerLM(
        vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS, n_heads=HEADS,
        dtype=jnp.float32, use_flash=False).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"])


def _ref_pipeline_rank():
    import jax
    import optax

    import horovod_tpu as hvd
    from horovod_tpu.jax.train import run_pipeline
    from horovod_tpu.models import next_token_loss
    from horovod_tpu.parallel import (PipelineGrid, partition_params,
                                      partition_transformer)
    from horovod_tpu_torch.models.convert import from_flax_params

    hvd.init()
    grid = PipelineGrid(2, hvd.size(), hvd.rank())
    modules = partition_transformer(
        VOCAB, D_MODEL, LAYERS, HEADS, n_stages=2, dtype=jax.numpy.float32,
        use_flash=False)[grid.stage]
    params = partition_params(_flax_init(), LAYERS, 2)[grid.stage]
    params, _, losses = run_pipeline(
        modules, params, optax.adamw(1e-3), [_tokens(grid.dp_index)] * STEPS,
        n_stages=2, n_microbatches=MICRO, loss_fn=next_token_loss)
    state = {}
    for tree in params:
        state.update(from_flax_params(jax.device_get(tree)))
    torch.save({"losses": losses, "state": state}, os.path.join(
        os.environ[OUT_ENV], f"ref_pipe{hvd.rank()}.pt"))
    hvd.shutdown()


def _port_pipeline_rank(out_dir):
    import horovod_tpu_torch.common as hvd
    from horovod_tpu_torch.parallel import (PipelineGrid, partition_params,
                                            partition_transformer)
    from horovod_tpu_torch.torch.lm_step import adamw
    from horovod_tpu_torch.torch.train import run_pipeline

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    grid = PipelineGrid(2, hvd.size(), hvd.rank())
    init = torch.load(os.path.join(out_dir, "init.pt"))
    modules = partition_transformer(
        VOCAB, D_MODEL, LAYERS, HEADS, 2, dtype=torch.float32,
        device="cpu")[grid.stage]
    modules[0].load_state_dict(partition_params(init, LAYERS, 2)
                               [grid.stage][0], strict=True)
    snaps = []

    def batches():
        for i in range(STEPS):
            if i == 1:  # after the first step: the cache has filled
                snaps.append(hvd.metrics_snapshot())
            yield _tokens(grid.dp_index)
        snaps.append(hvd.metrics_snapshot())

    stats = {}
    modules, opts, losses = run_pipeline(
        modules, adamw, batches(), n_stages=2, n_microbatches=MICRO,
        stats=stats)
    a, b = (s["cache"]["engine"] for s in snaps)
    hits, misses = b["hits"] - a["hits"], b["misses"] - a["misses"]
    torch.save({"losses": losses, "state": modules[0].state_dict(),
                "hit_rate": hits / max(hits + misses, 1),
                "hits": hits, "misses": misses, "p2p": snaps[-1]["p2p"],
                "n_opts": len(opts), "n_params": len(list(
                    modules[0].parameters())),
                "stats": stats}, os.path.join(out_dir, f"port_pipe"
                                                       f"{hvd.rank()}.pt"))
    hvd.shutdown()


@pytest.mark.parametrize("np_", [2, 4])
def test_run_pipeline_matches_reference(np_, tmp_path, monkeypatch):
    from horovod_tpu_torch.models.convert import from_flax_params

    torch.save(from_flax_params(_flax_init()), tmp_path / "init.pt")
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_pipeline_rank, np_, timeout=420)
    _launch(functools.partial(_port_pipeline_rank, str(tmp_path)), np_,
            timeout=300)
    dp = np_ // 2
    for r in range(np_):
        ref = torch.load(tmp_path / f"ref_pipe{r}.pt", weights_only=False)
        got = torch.load(tmp_path / f"port_pipe{r}.pt", weights_only=False)
        last = r >= dp
        if last:
            assert all(lo is not None for lo in got["losses"])
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=1e-4)
        else:
            assert got["losses"] == ref["losses"] == [None] * STEPS
        assert set(got["state"]) == set(ref["state"])
        for name, want in ref["state"].items():
            np.testing.assert_allclose(got["state"][name].numpy(),
                                       want.numpy(), atol=5e-5,
                                       err_msg=f"rank {r} {name}")
        assert got["hit_rate"] >= 0.9, (got["hits"], got["misses"])
        assert got["p2p"]["unmatched"] == 0, got["p2p"]
        # Per step: a forward bucket and a gradient bucket per micro-batch.
        assert got["p2p"]["sends"] == got["p2p"]["recvs"] == STEPS * MICRO
        want_groups = STEPS * got["n_params"] if dp > 1 else 0
        assert got["p2p"]["group_ops"] == want_groups, got["p2p"]
        assert got["n_opts"] == 1 and len(got["stats"]["step_sec"]) == STEPS
        if dp > 1 and r % dp:
            twin = torch.load(tmp_path / f"port_pipe{r - 1}.pt",
                              weights_only=False)["state"]
            for name, t in got["state"].items():
                assert torch.equal(_bits(t), _bits(twin[name])), (r, name)


# ---------------------------------------------------------------------------
# Faults.
# ---------------------------------------------------------------------------


def _env(**overrides):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in overrides.items()})
    return env


def test_unmatched_send_times_out_naming_tensor_and_peer():
    from horovod_tpu_torch.runner.launch import run_command

    code = (
        "import os, time, torch\n"
        "import horovod_tpu_torch.common as hvd\n"
        "hvd.init(device='cpu')\n"
        "t0 = time.monotonic()\n"
        "if hvd.rank() == 0:\n"
        "    try:\n"
        "        hvd.send(torch.ones(8), 1, name='act')\n"
        "        os._exit(9)\n"
        "    except hvd.CollectiveTimeoutError as e:\n"
        "        assert 'act.p2p.0-1.t0' in str(e), str(e)\n"
        "        assert 'peer rank 1' in str(e), str(e)\n"
        "        assert time.monotonic() - t0 < 15.0\n"
        "        os._exit(7)\n"
        "else:\n"
        "    time.sleep(60)\n")
    results = run_command(
        [sys.executable, "-c", code], 2,
        env=_env(HVD_TPU_COLLECTIVE_TIMEOUT_SEC="2",
                 HVD_TPU_KILL_GRACE_SEC="3"),
        timeout=90.0, capture=True)
    by_rank = {r.rank: r for r in results}
    assert by_rank[0].returncode == 7, \
        (by_rank[0].returncode, by_rank[0].stderr[-800:])
    assert by_rank[1].returncode == -9  # the sleeper, killed after grace


DEATH_EXIT = 17


def _stage_death_rank(out_dir):
    """2 stages x 2 DP; rank 3 (stage 1) exits at its fifth send, in the
    third of 40 steps; every survivor must raise ``RanksDownError`` naming
    stage 1 and rank 3."""
    import horovod_tpu_torch.common as hvd
    from horovod_tpu_torch.parallel import (PipelineGrid, partition_params,
                                            partition_transformer,
                                            pipeline)
    from horovod_tpu_torch.torch.lm_step import adamw
    from horovod_tpu_torch.torch.train import run_pipeline

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    grid = PipelineGrid(2, hvd.size(), hvd.rank())
    modules = partition_transformer(
        VOCAB, D_MODEL, LAYERS, HEADS, 2, dtype=torch.float32,
        device="cpu")[grid.stage]
    modules[0].load_state_dict(partition_params(torch.load(
        os.path.join(out_dir, "init.pt")), LAYERS, 2)[grid.stage][0])
    if hvd.rank() == 3:
        real, sent = pipeline.EngineTransport.send, [0]

        def dying_send(self, tensor, peer, name):
            sent[0] += 1
            if sent[0] == 5:
                os._exit(DEATH_EXIT)
            real(self, tensor, peer, name)

        pipeline.EngineTransport.send = dying_send
    t_last = [time.monotonic()]

    def batches():
        for _ in range(40):
            yield _tokens(grid.dp_index)
            t_last[0] = time.monotonic()

    try:
        run_pipeline(modules, adamw, batches(), n_stages=2,
                     n_microbatches=MICRO)
        os._exit(9)  # a survivor must not finish
    except hvd.RanksDownError as exc:
        assert 3 in exc.ranks, (exc.ranks, str(exc))
        assert str(exc).startswith("pipeline aborted"), str(exc)
        assert "stage 1 (ranks [2, 3])" in str(exc), str(exc)
        assert time.monotonic() - t_last[0] < 25.0
    os._exit(0)


def test_stage_death_mid_schedule_names_stage_on_survivors(tmp_path):
    from horovod_tpu_torch.runner.launch import launch_fn

    torch.save(_seeded_state(), tmp_path / "init.pt")
    results = launch_fn(
        functools.partial(_stage_death_rank, str(tmp_path)), 4,
        env=_env(HVD_TPU_COLLECTIVE_TIMEOUT_SEC="20",
                 HVD_TPU_KILL_GRACE_SEC="20"), timeout=180)
    by_rank = {r.rank: r for r in results}
    assert by_rank[3].returncode == DEATH_EXIT, by_rank[3]
    for r in (0, 1, 2):
        assert by_rank[r].returncode == 0, \
            (r, by_rank[r].returncode, by_rank[r].stderr[-1500:])


def _seeded_state():
    """The tiny LM's weights drawn by the port (no JAX needed)."""
    from horovod_tpu_torch.models import TransformerLM

    return TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS, dtype=torch.float32,
                         device="cpu").state_dict()
