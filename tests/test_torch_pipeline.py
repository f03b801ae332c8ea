"""horovod_tpu_torch's pipeline parallelism against horovod_tpu's, in one
process (the schedules, the grid, the partition, the local pipeline).

- Schedules: ``schedule_1f1b``/``schedule_interleaved`` equal the
  reference's action lists for every stage of 1-4 stages, 1-8
  micro-batches and 1-3 chunks, and ``simulate_schedule`` and
  ``bubble_fraction`` its values; where the reference raises, the port
  raises the same exception type with the same message.
- Grid: every attribute of ``PipelineGrid`` equals the reference's for
  worlds 1-8, every stage count and rank.
- Partition: ``partition_params`` on a converted ``state_dict`` equals
  ``from_flax_params`` of each slice of the reference's
  ``partition_params``, leaf for leaf (exactly: the same float32 values),
  and each slice loads into its ``TransformerStage`` with ``strict=True``.
- Local pipeline: ``run_local_pipeline`` on a tiny float32 LM (vocab 64,
  d_model 32, 4 layers, 4 heads, seq 16, batch 4, 2 micro-batches) at
  grids (2, 1), (2, 2) and (4, 1) against the reference's
  ``run_local_pipeline`` on the same converted weights (``use_flash=False``
  on both sides, computed once per module), and against the port's own
  unpartitioned ``TransformerLM`` with ``use_flash=True`` (on the CPU the
  plain versions of K1 and B2).  Loss rtol 1e-5, gradients atol 1e-5 and
  rtol 1e-4 (float32 summation order: measured margins in CHANGES.md).

The engine's point-to-point plane, stage groups, ``run_pipeline`` and the
faults across processes are in ``tests/test_torch_pipeline_ranks.py``.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.parallel import pipeline as P

VOCAB, D_MODEL, LAYERS, HEADS, SEQ, BATCH, MICRO = 64, 32, 4, 4, 16, 4, 2
GRIDS = [(2, 1), (2, 2), (4, 1)]
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _ref():
    import horovod_tpu.parallel.pipeline as R

    return R


def _raised(fn, *args):
    """``(result, None)`` or ``(None, (type, message))``."""
    try:
        return fn(*args), None
    except (ValueError, AssertionError) as exc:
        return None, (type(exc), str(exc))


# ---------------------------------------------------------------------------
# Schedules and the grid.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_micro", range(1, 9))
@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
def test_schedules_match_reference(n_stages, n_chunks, n_micro):
    R = _ref()
    for stage in range(n_stages):
        want = _raised(R.schedule_interleaved, stage, n_stages, n_micro,
                       n_chunks)
        got = _raised(P.schedule_interleaved, stage, n_stages, n_micro,
                      n_chunks)
        assert got[1] == want[1]
        if want[1] is None:
            assert [tuple(a) for a in got[0]] == [tuple(a) for a in want[0]]
        if n_chunks == 1:
            ours = P.schedule_1f1b(stage, n_stages, n_micro)
            theirs = R.schedule_1f1b(stage, n_stages, n_micro)
            assert [tuple(a) for a in ours] == [tuple(a) for a in theirs]
    assert _raised(P.simulate_schedule, n_stages, n_micro, n_chunks) == \
        _raised(R.simulate_schedule, n_stages, n_micro, n_chunks)
    assert P.bubble_fraction(n_stages, n_micro, n_chunks) == \
        R.bubble_fraction(n_stages, n_micro, n_chunks)


@pytest.mark.parametrize("fn,args", [
    ("schedule_1f1b", (2, 2, 4)),
    ("schedule_1f1b", (-1, 2, 4)),
    ("schedule_1f1b", (0, 2, 0)),
    ("schedule_interleaved", (0, 4, 6, 2)),
    ("schedule_interleaved", (0, 2, 4, 0)),
    ("schedule_interleaved", (0, 3, 4, 2)),
    ("simulate_schedule", (2, 2, 1, lambda s, n, m: list(reversed(
        P.schedule_1f1b(s, n, m))))),
    ("simulate_schedule", (2, 2, 1, lambda s, n, m: 2 * P.schedule_1f1b(
        s, n, m))),
    ("_split_layers", (3, 4)),
    ("PipelineGrid", (0, 4, 0)),
    ("PipelineGrid", (3, 4, 0)),
    ("PipelineGrid", (2, 4, 4)),
])
def test_guards_raise_the_reference_errors(fn, args):
    want = _raised(getattr(_ref(), fn), *args)[1]
    assert want is not None
    assert _raised(getattr(P, fn), *args)[1] == want


def _grid_view(g):
    return (g.n_stages, g.world, g.rank, g.dp, g.stage, g.dp_index,
            g.stage_ranks(), [g.stage_ranks(s) for s in range(g.n_stages)],
            [g.rank_of(s) for s in range(g.n_stages)],
            [g.rank_of(s, d) for s in range(g.n_stages)
             for d in range(g.dp)],
            [g.stage_of(r) for r in range(g.world)], g.next_rank,
            g.prev_rank)


@pytest.mark.parametrize("world", range(1, 9))
def test_grid_matches_reference(world):
    R = _ref()
    for n_stages in range(1, world + 2):
        for rank in range(world):
            want = _raised(R.PipelineGrid, n_stages, world, rank)
            got = _raised(P.PipelineGrid, n_stages, world, rank)
            assert got[1] == want[1]
            if want[1] is None:
                assert _grid_view(got[0]) == _grid_view(want[0])


# ---------------------------------------------------------------------------
# Partitioning and the local pipeline.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The tiny LM's flax weights, tokens, and the reference's
    ``run_local_pipeline`` at every grid: ``{grid: (loss, {port name:
    grad})}``."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerLM, next_token_loss
    from horovod_tpu_torch.models.convert import from_flax_params

    R = _ref()
    model = TransformerLM(vocab_size=VOCAB, d_model=D_MODEL,
                          n_layers=LAYERS, n_heads=HEADS,
                          dtype=jnp.float32, use_flash=False)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"])
    tokens = np.random.RandomState(7).randint(
        0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    runs = {}
    for n_stages, n_chunks in GRIDS:
        modules = R.partition_transformer(
            VOCAB, D_MODEL, LAYERS, HEADS, n_stages=n_stages,
            n_chunks=n_chunks, dtype=jnp.float32, use_flash=False)
        parts = R.partition_params(params, LAYERS, n_stages, n_chunks)
        transport = R.LocalTransport()
        runners = [R.PipelineRunner(
            modules[s], parts[s], R.PipelineGrid(n_stages, n_stages, s),
            n_micro=MICRO, transport=transport,
            loss_fn=next_token_loss if s == n_stages - 1 else None)
            for s in range(n_stages)]
        loss, grads = R.run_local_pipeline(runners, tokens[:, :-1],
                                           tokens[:, 1:])
        flat = {}
        for stage_grads in grads:
            for tree in stage_grads:
                flat.update(from_flax_params(jax.device_get(tree)))
        runs[(n_stages, n_chunks)] = (loss, flat)
    return {"params": params, "tokens": tokens, "runs": runs}


def _stage_modules(state, n_stages, n_chunks, use_flash):
    modules = P.partition_transformer(
        VOCAB, D_MODEL, LAYERS, HEADS, n_stages, n_chunks,
        dtype=torch.float32, use_flash=use_flash, device="cpu")
    parts = P.partition_params(state, LAYERS, n_stages, n_chunks)
    for s in range(n_stages):
        for c in range(n_chunks):
            modules[s][c].load_state_dict(parts[s][c], strict=True)
    return modules


def _local_run(state, tokens, n_stages, n_chunks, use_flash):
    from horovod_tpu_torch.models import next_token_loss

    modules = _stage_modules(state, n_stages, n_chunks, use_flash)
    transport = P.LocalTransport()
    runners = [P.PipelineRunner(
        modules[s], P.PipelineGrid(n_stages, n_stages, s), MICRO, transport,
        loss_fn=next_token_loss if s == n_stages - 1 else None)
        for s in range(n_stages)]
    loss, grads = P.run_local_pipeline(runners, tokens[:, :-1],
                                       tokens[:, 1:])
    flat = {}
    for stage_grads in grads:
        for tree in stage_grads:
            flat.update(tree)
    return loss, flat


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("n_stages,n_chunks", [(1, 1), (2, 1), (2, 2),
                                               (4, 1), (3, 1)])
def test_partition_params_matches_from_flax_slices(reference, n_stages,
                                                   n_chunks):
    from horovod_tpu_torch.models.convert import from_flax_params

    R = _ref()
    params = reference["params"]
    ours = P.partition_params(from_flax_params(params), LAYERS, n_stages,
                              n_chunks)
    theirs = R.partition_params(params, LAYERS, n_stages, n_chunks)
    assert P._split_layers(LAYERS, n_stages * n_chunks) == \
        R._split_layers(LAYERS, n_stages * n_chunks)
    modules = P.partition_transformer(
        VOCAB, D_MODEL, LAYERS, HEADS, n_stages, n_chunks,
        dtype=torch.float32, device="meta")
    for s in range(n_stages):
        for c in range(n_chunks):
            want = from_flax_params(theirs[s][c])
            got = ours[s][c]
            assert set(got) == set(want) == set(modules[s][c].state_dict())
            for name, w in want.items():
                assert torch.equal(got[name], w), (s, c, name)
            modules[s][c].to_empty(device="cpu").load_state_dict(
                got, strict=True)


@pytest.mark.parametrize("n_stages,n_chunks", GRIDS)
def test_local_pipeline_matches_reference(reference, n_stages, n_chunks):
    from horovod_tpu_torch.models.convert import from_flax_params

    want_loss, want = reference["runs"][(n_stages, n_chunks)]
    loss, got = _local_run(from_flax_params(reference["params"]),
                           reference["tokens"], n_stages, n_chunks,
                           use_flash=False)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    _assert_grads(got, want)


@pytest.mark.parametrize("n_stages,n_chunks", GRIDS)
def test_local_pipeline_matches_unpartitioned_model(reference, n_stages,
                                                    n_chunks):
    from horovod_tpu_torch.models import TransformerLM, next_token_loss
    from horovod_tpu_torch.models.convert import from_flax_params

    state = from_flax_params(reference["params"])
    tokens = torch.from_numpy(reference["tokens"]).long()
    full = TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS, dtype=torch.float32,
                         use_flash=True, device="cpu")
    full.load_state_dict(state, strict=True)
    want_loss = next_token_loss(full(tokens[:, :-1]), tokens[:, 1:])
    want_loss.backward()
    want = {n: p.grad for n, p in full.named_parameters()}
    loss, got = _local_run(state, reference["tokens"], n_stages, n_chunks,
                           use_flash=True)
    assert loss == pytest.approx(want_loss.item(), rel=LOSS_RTOL)
    _assert_grads(got, want)


def test_runner_contracts():
    """The runner's own errors: the last stage needs ``loss_fn``, a stage
    after the first needs its bucket shape, a batch must split into the
    micro-batches, and a deadlocked local pipeline is reported."""
    from horovod_tpu_torch.models import next_token_loss

    modules = P.partition_transformer(VOCAB, D_MODEL, LAYERS, HEADS, 2,
                                      dtype=torch.float32, device="cpu")
    grid0, grid1 = P.PipelineGrid(2, 2, 0), P.PipelineGrid(2, 2, 1)
    with pytest.raises(ValueError, match="loss_fn"):
        P.PipelineRunner(modules[1], grid1, MICRO, P.LocalTransport())
    r1 = P.PipelineRunner(modules[1], grid1, MICRO, P.LocalTransport(),
                          loss_fn=next_token_loss)
    with pytest.raises(ValueError, match="split"):
        r1.begin_step(None, np.zeros((3, SEQ), np.int64))
    r0 = P.PipelineRunner(modules[0], grid0, MICRO, P.LocalTransport())
    r0.begin_step(np.zeros((BATCH, SEQ), np.int64))
    assert r0.try_next() and r0.try_next()  # the two warm-up forwards
    assert not r0.try_next()  # blocked: no gradient has come back
    with pytest.raises(RuntimeError, match="not drained"):
        r0.finish_step()
    r1.begin_step(None, np.zeros((BATCH, SEQ), np.int64))
    with pytest.raises(ValueError, match="set_bucket_shape"):
        r1._recv_shape_hint()
