"""horovod_tpu_torch.serving against horovod_tpu.serving on the CPU.

The same seeded numpy inputs go through the JAX package's serving plane
and the port's:

- the scheduler and block-pool contracts of ``tests/test_serving.py``,
  each run on both packages, and the packed plans of one seeded workload
  equal word for word;
- the paged store (``gather_context``, ``scatter_new``, ``scatter_bulk``)
  exactly equal in float32 and bfloat16, trash routing and idle slots
  included (the trash block itself is not compared: lanes that land
  there may collide, and which write wins is unspecified in both);
- the LM's decode mode and K/V capture against flax on converted weights,
  and the decode step over three planned steps (pages and greedy tokens);
  float32, atol 1e-5 (summation order through two frameworks' matmuls);
- bulk prefill (the JAX side rings over the 8 virtual CPU devices, the
  port runs its single shard), ``reference_decode``, the HTTP front door
  at size 1 and a 2-rank serve over the port's runner, whose tokens equal
  the JAX ``reference_decode``'s and whose pages are identical across
  ranks;
- a legacy checkpoint of ``horovod_tpu.jax.train.save_checkpoint`` served
  by the port, read without importing JAX;
- ``--serve`` handling, and the typed refusal of a multi-card prefill.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.common import metrics as jmetrics
from horovod_tpu.models.transformer import DecodeContext as JDecodeContext
from horovod_tpu.models.transformer import rope as jrope
from horovod_tpu.serving import engine as jengine
from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu.serving import prefill as jprefill
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu_torch.common import metrics as tmetrics
from horovod_tpu_torch.models import DecodeContext
from horovod_tpu_torch.models.convert import from_flax_params
from horovod_tpu_torch.models.transformer import rope
from horovod_tpu_torch.serving import engine as tengine
from horovod_tpu_torch.serving import kv_cache as tkv
from horovod_tpu_torch.serving import prefill as tprefill
from horovod_tpu_torch.serving import scheduler as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
PACKAGES = {
    "jax": types.SimpleNamespace(kv=jkv, sched=jsched, metrics=jmetrics),
    "torch": types.SimpleNamespace(kv=tkv, sched=tsched, metrics=tmetrics),
}
_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
        "HVD_TPU_LOCAL_SIZE", "HVD_TPU_COORD", "HVD_TPU_DATA")


@pytest.fixture(scope="module", autouse=True)
def port_engine_built():
    """The port's engine library built before any timed launch."""
    from horovod_tpu_torch.engine import build

    build.build()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    p = PACKAGES[request.param]
    p.metrics.registry.reset()
    yield p
    p.metrics.registry.reset()


# ---------------------------------------------------------------------------
# Scheduler and pool contracts, on both packages.
# ---------------------------------------------------------------------------


def _cfg(pkg, **kw):
    base = dict(max_batch=2, prefill_chunk=4, block_tokens=4, num_blocks=16,
                max_blocks_per_seq=4, queue_limit=8, tenant_max_inflight=4)
    base.update(kw)
    return pkg.sched.ServeConfig(**base)


def _token(sp):
    """Deterministic fake decode: a function of request and progress."""
    return (sp.request_id * 17 + sp.length) % 101


def _sampled(sch, plan):
    sampled = [0] * sch.cfg.max_batch
    for sp in plan.slots:
        if sp.samples:
            sampled[sp.slot] = _token(sp)
    return sampled


def _drive(sch, max_steps=500):
    retired = []
    for _ in range(max_steps):
        plan = sch.step_plan()
        if plan is None:
            if sch.idle():
                return retired
            continue
        retired.extend(sch.complete_step(plan, _sampled(sch, plan)))
    raise AssertionError(f"scheduler did not drain in {max_steps} steps")


def test_block_pool_alloc_free(pkg):
    pool = pkg.kv.BlockPool(4, 8)
    assert [pool.blocks_for_tokens(n) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    a = pool.alloc(3)
    assert len(a) == 3 and pool.blocks_in_use == 3
    assert pool.alloc(2) is None  # all or nothing
    assert pool.blocks_in_use == 3 and pool.blocks_free == 1
    pool.free(a)
    assert pool.blocks_in_use == 0 and pool.blocks_free == 4
    assert pool.peak_in_use == 3
    with pytest.raises(ValueError):
        pool.alloc(-1)
    with pytest.raises(ValueError):
        pool.free([99])
    with pytest.raises(ValueError):
        pkg.kv.BlockPool(0, 8)


def test_admission_typed_rejections(pkg):
    s = pkg.sched
    sch = s.Scheduler(_cfg(pkg, queue_limit=3, tenant_max_inflight=2))
    for prompt, max_new in (([], 4), ([1, 2], 0), ([1] * 10, 10)):
        with pytest.raises(s.AdmissionError) as e:
            sch.submit("t", prompt, max_new)
        assert e.value.reason == s.REJECT_TOO_LONG
    sch.submit("t", [1, 2], 2)
    sch.submit("t", [1, 2], 2)
    with pytest.raises(s.AdmissionError) as e:
        sch.submit("t", [1, 2], 2)
    assert e.value.reason == s.REJECT_TENANT_QUOTA and e.value.tenant == "t"
    sch.submit("u", [1, 2], 2)
    with pytest.raises(s.AdmissionError) as e:
        sch.submit("v", [1, 2], 2)
    assert e.value.reason == s.REJECT_QUEUE_FULL
    snap = pkg.metrics.registry.snapshot()["serving"]
    assert (snap["requests"], snap["admitted"], snap["rejected"]) == (8, 3, 5)
    assert snap["tenants"]["t"]["rejected"] == 4
    assert snap["tenants"]["v"]["rejected"] == 1
    assert snap["queue_depth"] == 3


def test_join_and_retire_at_step_boundaries(pkg):
    sch = pkg.sched.Scheduler(_cfg(pkg))
    short = sch.submit("acme", [1, 2, 3], 2)
    long = sch.submit("beta", [4, 5, 6], 10)
    retired, late = [], None
    for _ in range(100):
        plan = sch.step_plan()
        retired.extend(sch.complete_step(plan, _sampled(sch, plan)))
        if retired and late is None:
            assert retired == [short] and long.state == pkg.sched.ACTIVE
            late = sch.submit("acme", [7, 8], 3)
        if len(retired) == 3:
            break
    assert short.finish_seq < late.finish_seq < long.finish_seq
    assert [len(r.generated) for r in (short, long, late)] == [2, 10, 3]
    assert sch.pool.blocks_in_use == 0 and sch.idle()
    snap = pkg.metrics.registry.snapshot()["serving"]
    assert snap["retired"] == 3
    assert snap["tenants"]["acme"]["generated_tokens"] == 5
    assert snap["tenants"]["beta"]["generated_tokens"] == 10
    assert 0.0 < snap["occupancy"] <= 1.0


def test_pool_exhaustion_queues_not_crashes(pkg):
    sch = pkg.sched.Scheduler(_cfg(pkg, num_blocks=4))
    a = sch.submit("t", [1] * 8, 4)
    b = sch.submit("t", [2] * 8, 4)
    assert {r.id for r in _drive(sch)} == {a.id, b.id}
    assert len(a.generated) == 4 and len(b.generated) == 4
    assert sch.pool.blocks_in_use == 0 and sch.pool.peak_in_use <= 4
    snap = pkg.metrics.registry.snapshot()["serving"]
    assert snap["retired"] == 2 and snap["failed"] == 0


def test_priority_ordering(pkg):
    sch = pkg.sched.Scheduler(_cfg(pkg, max_batch=1))
    first = sch.submit("t", [1, 2], 2)
    low = sch.submit("t", [3, 4], 2, priority=0)
    mid = sch.submit("t", [5, 6], 2, priority=1)
    high = sch.submit("u", [7, 8], 2, priority=5)
    assert [r.id for r in _drive(sch)] == [high.id, mid.id, first.id, low.id]


def test_priority_preemption_resumes(pkg):
    sch = pkg.sched.Scheduler(_cfg(pkg, num_blocks=4))
    victim = sch.submit("t", [1] * 8, 4, priority=0)
    for _ in range(3):
        plan = sch.step_plan()
        sch.complete_step(plan, _sampled(sch, plan))
    before = list(victim.generated)
    assert victim.state == pkg.sched.ACTIVE
    vip = sch.submit("u", [2] * 8, 4, priority=9)
    assert [r.id for r in _drive(sch)] == [vip.id, victim.id]
    assert pkg.metrics.registry.snapshot()["serving"]["preempted"] >= 1
    assert victim.generated[:len(before)] == before
    assert len(victim.generated) == 4


def test_replan_is_identical(pkg):
    """A step planned again before it completed is the same step (the JAX
    package re-plans so after an elastic reshape, ``reform``)."""
    sch = pkg.sched.Scheduler(_cfg(pkg))
    sch.submit("t", [1, 2, 3, 4, 5, 6], 4)
    sch.submit("u", [7, 8], 2)
    p1 = sch.step_plan()
    in_use = sch.pool.blocks_in_use
    if hasattr(sch, "reform"):
        sch.reform([1])
    p2 = sch.step_plan()
    assert sch.pool.blocks_in_use == in_use
    fields = ("slot", "request_id", "tokens", "n_new", "length", "table",
              "bulk_len", "samples")
    assert [[getattr(sp, f) for f in fields] for sp in p1.slots] == \
        [[getattr(sp, f) for f in fields] for sp in p2.slots]
    sch.complete_step(p2, _sampled(sch, p2))
    _drive(sch)
    assert sch.idle()


def test_plan_pack_roundtrip(pkg):
    s = pkg.sched
    cfg = _cfg(pkg)
    sch = s.Scheduler(cfg)
    sch.submit("t", [1, 2, 3, 4, 5], 3)
    sch.submit("u", [9], 2)
    plan = sch.step_plan()
    wire = s.pack_plan(cfg, plan)
    assert wire.shape == (s.plan_size(cfg),) and wire.dtype == np.int32
    back = s.unpack_plan(cfg, wire)
    assert back.opcode == s.OP_STEP and back.step == plan.step
    for a, b in zip(plan.slots, back.slots, strict=True):
        assert (a.slot, a.tokens, a.n_new, a.length, a.bulk_len,
                a.samples) == (b.slot, b.tokens, b.n_new, b.length,
                               b.bulk_len, b.samples)
        assert b.table[:len(a.table)] == a.table  # padded with -1
    assert s.unpack_plan(cfg, s.pack_control(cfg, s.OP_STOP)).opcode == \
        s.OP_STOP


def test_fail_all_is_typed_never_hung(pkg):
    s = pkg.sched
    sch = s.Scheduler(_cfg(pkg))
    a = sch.submit("t", [1, 2], 4)
    b = sch.submit("t", [3, 4], 4)
    sch.step_plan()
    sch.fail_all(RuntimeError("ranks died"))
    for req in (a, b):
        assert req.event.is_set()
        assert isinstance(req.error, s.ServingUnavailableError)
        assert "ranks died" in str(req.error)
    assert sch.pool.blocks_in_use == 0
    with pytest.raises(s.ServingUnavailableError):
        sch.submit("t", [5], 1)
    assert pkg.metrics.registry.snapshot()["serving"]["failed"] == 2
    assert [e["event"] for e in sch.trace(a.id)["spans"]][-1] == "failed"


def test_serve_config_from_env(pkg, monkeypatch):
    for var, value in (("MAX_BATCH", "3"), ("KV_BLOCKS", "99"),
                       ("QUEUE", "7"), ("PORT", "18780")):
        monkeypatch.setenv(f"HVD_TPU_SERVE_{var}", value)
    cfg = pkg.sched.ServeConfig.from_env()
    assert (cfg.max_batch, cfg.num_blocks, cfg.queue_limit, cfg.port) == \
        (3, 99, 7, 18780)
    assert cfg.prefill_chunk == pkg.sched.ServeConfig().prefill_chunk
    assert cfg.max_seq == cfg.block_tokens * cfg.max_blocks_per_seq


def test_tenant_cardinality_is_bounded(pkg):
    reg = pkg.metrics.registry
    for i in range(pkg.metrics._MAX_TENANTS + 10):
        reg.record_serving("requests", f"tenant-{i}")
    tenants = reg.snapshot()["serving"]["tenants"]
    assert len(tenants) == pkg.metrics._MAX_TENANTS + 1
    assert tenants["<other>"]["requests"] == 10


def test_packed_plans_equal_between_packages():
    """A seeded workload of mixed tenants, lengths and priorities, with a
    pool small enough to preempt and bulk prefill on: every packed plan
    and every retirement is the same in both packages."""
    rng = np.random.RandomState(0)
    work = [(("acme", "beta", "gamma")[i % 3],
             rng.randint(0, 97, int(rng.randint(1, 30))).tolist(),
             int(rng.randint(1, 12)), int(rng.randint(0, 3)))
            for i in range(16)]
    kw = dict(max_batch=4, prefill_chunk=4, block_tokens=4, num_blocks=24,
              max_blocks_per_seq=12, queue_limit=32, tenant_max_inflight=16,
              ring_min_tokens=20)
    runs = {}
    for name, p in PACKAGES.items():
        cfg = p.sched.ServeConfig(**kw)
        sch = p.sched.Scheduler(cfg)
        reqs = [sch.submit(*w) for w in work[:8]]
        plans, order = [], []
        for step in range(400):
            if step == 3:
                reqs += [sch.submit(*w) for w in work[8:]]
            plan = sch.step_plan()
            if plan is None:
                if sch.idle():
                    break
                continue
            plans.append(p.sched.pack_plan(cfg, plan))
            order += [reqs.index(r) for r in
                      sch.complete_step(plan, _sampled(sch, plan))]
        runs[name] = (plans, order, [r.generated for r in reqs])
        p.metrics.registry.reset()
    (jp, jo, jg), (tp, to, tg) = runs["jax"], runs["torch"]
    assert len(jp) == len(tp) > 16
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    assert jo == to and jg == tg
    assert any(w[3] for w in work) and sorted(to) == list(range(16))


# ---------------------------------------------------------------------------
# The paged store.
# ---------------------------------------------------------------------------

L, H, HD, NB, BT, B, MB = 2, 2, 8, 10, 4, 3, 4  # layers .. max blocks/seq
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pages(rng, dtype):
    vals = rng.standard_normal((L, 2, NB + 1, BT, H, HD)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(vals, jd), torch.from_numpy(vals).to(td)


def _tables():
    """Three slots: one with 3 blocks, one with 1 (its later lanes run past
    the table), one idle (all trash)."""
    t = np.full((B, MB), NB, np.int32)
    t[0, :3] = [4, 1, 7]
    t[1, :1] = [2]
    return t


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint16 if t.element_size() == 2
                                   else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_and_scatter_equal_jax_exactly(dtype):
    rng = np.random.RandomState(1)
    jp, tp = _pages(rng, dtype)
    tables = _tables()
    jk, jv = jkv.gather_context(jp, jnp.asarray(tables))
    tk, tv = tkv.gather_context(tp, torch.from_numpy(tables).long())
    assert tuple(tk.shape) == (L, B, H, MB * BT, HD)
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))

    chunk = 5
    new = rng.standard_normal((2, L, B, H, chunk, HD)).astype(np.float32)
    jd, td = DTYPES[dtype]
    lengths = np.array([6, 1, 0], np.int32)
    n_new = np.array([5, 2, 0], np.int32)  # slot 2 idle
    want = jkv.scatter_new(jp, jnp.asarray(new[0], jd),
                           jnp.asarray(new[1], jd), jnp.asarray(tables),
                           jnp.asarray(lengths), jnp.asarray(n_new))
    got = tkv.scatter_new(tp, torch.from_numpy(new[0]).to(td),
                          torch.from_numpy(new[1]).to(td),
                          torch.from_numpy(tables).long(),
                          torch.from_numpy(lengths).long(),
                          torch.from_numpy(n_new).long())
    assert got is tp  # in place
    np.testing.assert_array_equal(_bits(got)[:, :, :NB],
                                  _bits(want)[:, :, :NB])
    # Slot 0's 5 lanes landed at positions 6..10 (blocks 1 and 7).
    got32 = got.float()
    assert torch.equal(got32[0, 0, 1, 2], torch.from_numpy(new[0, 0, 0, :, 0])
                       .to(td).float())


def test_scatter_bulk_equals_jax_exactly():
    rng = np.random.RandomState(2)
    jp, tp = _pages(rng, "float32")
    table = np.full(MB, NB, np.int32)
    table[:3] = [5, 0, 9]
    padded, real = 16, 11
    kv = rng.standard_normal((2, L, 1, H, padded, HD)).astype(np.float32)
    want = jprefill.scatter_bulk(jp, jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                 table, real, NB)
    got = tprefill.scatter_bulk(tp, torch.from_numpy(kv[0]),
                                torch.from_numpy(kv[1]), table, real, NB)
    np.testing.assert_array_equal(got.numpy()[:, :, :NB],
                                  np.asarray(want)[:, :, :NB])


# ---------------------------------------------------------------------------
# The model's decode mode, the step, prefill and greedy decode.
# ---------------------------------------------------------------------------

SPEC = dict(vocab=97, d_model=32, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def lm():
    """The flax model and params, and the port's model on the converted
    weights (float32, CPU)."""
    jspec = jengine.ModelSpec(**SPEC)
    jmodel = jengine.build_model(jspec)
    params = jax.device_get(jengine.init_params(jspec))
    tspec = tengine.ModelSpec(**SPEC, device="cpu")
    tmodel = tengine.build_model(tspec)
    tmodel.load_state_dict(from_flax_params(params))
    return types.SimpleNamespace(jspec=jspec, jmodel=jmodel, params=params,
                                 tspec=tspec, tmodel=tmodel)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_rope_at_per_row_positions_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11], [40, 41, 42, 43, 44]])
    got = rope(torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, jrope(jnp.asarray(x), jnp.asarray(pos)))
    # Row 1 alone at 1-D positions: the training path's rope.
    _close(got[1:2], rope(torch.from_numpy(x[1:2]), torch.from_numpy(pos[1])))


def test_decode_forward_matches_flax(lm):
    rng = np.random.RandomState(4)
    b, s, ctx = 3, 4, 12
    hd = SPEC["d_model"] // SPEC["n_heads"]
    tokens = rng.randint(0, SPEC["vocab"], (b, s)).astype(np.int32)
    kctx, vctx = rng.standard_normal(
        (2, SPEC["n_layers"], b, SPEC["n_heads"], ctx, hd)).astype(np.float32)
    lengths = np.array([0, 5, 12])
    mask = np.arange(ctx)[None] < lengths[:, None]
    pos = lengths[:, None] + np.arange(s)[None]
    want, (wk, wv) = lm.jmodel.apply(
        {"params": lm.params}, jnp.asarray(tokens),
        decode_ctx=JDecodeContext(jnp.asarray(kctx), jnp.asarray(vctx),
                                  jnp.asarray(mask), jnp.asarray(pos)))
    with torch.no_grad():
        got, (gk, gv) = lm.tmodel(
            torch.from_numpy(tokens).long(),
            decode_ctx=DecodeContext(torch.from_numpy(kctx),
                                     torch.from_numpy(vctx),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(pos)))
    assert tuple(gk.shape) == (SPEC["n_layers"], b, SPEC["n_heads"], s, hd)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)


def test_capture_kv_matches_flax_sow(lm):
    tokens = np.random.RandomState(5).randint(0, SPEC["vocab"], (2, 24))
    model = jengine.build_model(lm.jspec, capture_kv=True)
    want, state = model.apply({"params": lm.params}, jnp.asarray(tokens),
                              mutable=["intermediates"])
    inter = state["intermediates"]
    with torch.no_grad():
        got, (k, v) = lm.tmodel(torch.from_numpy(tokens), capture_kv=True)
    _close(got, want)
    for i in range(SPEC["n_layers"]):
        wk, wv = inter[f"layer_{i}"]["attn"]["kv"][0]
        _close(k[i], wk)
        _close(v[i], wv)


def test_decode_refuses_sequence_parallelism():
    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.parallel import RingMesh

    model = TransformerLM(97, 32, 1, 2, dtype=torch.float32, device="cpu",
                          seq_axis=RingMesh(2, "cpu"))
    with pytest.raises(ValueError, match="sequence parallelism"):
        model(torch.zeros(1, 8, dtype=torch.long), capture_kv=True)


def test_step_fn_matches_jax_over_three_steps(lm):
    cfg = tsched.ServeConfig(max_batch=3, prefill_chunk=4, block_tokens=4,
                             num_blocks=16, max_blocks_per_seq=6)
    jcfg = jsched.ServeConfig(**{f: getattr(cfg, f) for f in (
        "max_batch", "prefill_chunk", "block_tokens", "num_blocks",
        "max_blocks_per_seq")})
    jstep = jengine.make_step_fn(lm.jmodel, lm.jspec, jcfg)
    tstep = tengine.make_step_fn(lm.tmodel, cfg)
    args = (SPEC["n_layers"], SPEC["n_heads"], lm.tspec.head_dim,
            cfg.num_blocks, cfg.block_tokens)
    jpages = jkv.init_pages(*args, jnp.float32)
    tpages = tkv.init_pages(*args, torch.float32, "cpu")
    engine = types.SimpleNamespace(cfg=cfg, _trash=cfg.num_blocks)
    sch = tsched.Scheduler(cfg)
    rng = np.random.RandomState(6)
    for n in (6, 3):  # 6: two chunks of prefill
        sch.submit("t", rng.randint(0, SPEC["vocab"], n).tolist(), 4)
    for _ in range(3):
        plan = sch.step_plan()
        tables = tengine.ServingEngine._tables_array(engine, plan)
        tokens = np.zeros((cfg.max_batch, cfg.prefill_chunk), np.int32)
        n_new = np.zeros(cfg.max_batch, np.int32)
        lengths = np.zeros(cfg.max_batch, np.int32)
        for sp in plan.slots:
            tokens[sp.slot, :sp.n_new] = sp.tokens
            n_new[sp.slot], lengths[sp.slot] = sp.n_new, sp.length
        jpages, want = jstep(jpages, lm.params, tokens, n_new, lengths,
                             tables.astype(np.int32))
        got, _ = tstep(tpages, *(torch.from_numpy(a).long() for a in
                                 (tokens, n_new, lengths, tables)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _close(tpages[:, :, :-1], np.asarray(jpages)[:, :, :-1])
        sch.complete_step(plan, got.numpy())
    assert len(plan.slots) == 2 and any(sp.samples for sp in plan.slots)


def test_bulk_prefill_matches_the_jax_ring(lm):
    """The JAX package rings the prompt over its 8 virtual devices; the
    port runs one shard: the same K/V and first token."""
    want_fn = jprefill.RingPrefill(lm.jspec, jsched.ServeConfig(
        ring_min_tokens=16), lm.params)
    assert want_fn.n_sp == 8
    rng = np.random.RandomState(7)
    real = 200
    buf = np.zeros(jprefill.bucket_len(real), np.int32)
    buf[:real] = rng.randint(0, SPEC["vocab"], real)
    wk, wv, wtok = want_fn(buf, real)
    got_fn = tprefill.RingPrefill(lm.tmodel)
    assert got_fn.n_sp == 1 and tprefill.bucket_len(real) == len(buf)
    gk, gv, gtok = got_fn(buf, real)
    _close(gk, wk)
    _close(gv, wv)
    assert gtok == wtok


@pytest.mark.parametrize("n_devices", [2, 4])
def test_prefill_over_several_cards_raises_typed(lm, n_devices):
    with pytest.raises(tprefill.PrefillMeshError, match="A.10"):
        tprefill.RingPrefill(lm.tmodel, n_devices=n_devices)


def test_reference_decode_matches_jax(lm):
    for prompt, n in (([3, 1, 4, 1, 5], 6), ([2, 7, 1, 8], 9)):
        assert tengine.reference_decode(lm.tmodel, prompt, n) == \
            jengine.reference_decode(lm.jmodel, lm.params, prompt, n)


def test_model_spec_from_env(monkeypatch):
    for var, value in (("VOCAB", "211"), ("D_MODEL", "48"), ("LAYERS", "3"),
                       ("HEADS", "4"), ("DTYPE", "bfloat16"),
                       ("DEVICE", "cpu"), ("SEED", "5")):
        monkeypatch.setenv(f"HVD_TPU_SERVE_{var}", value)
    spec = tengine.ModelSpec.from_env()
    assert spec == tengine.ModelSpec(211, 48, 3, 4, "bfloat16", 5, "", "cpu")
    assert spec.head_dim == 12 and spec.torch_dtype == torch.bfloat16


def test_serve_headline_is_the_lm_headline():
    from horovod_tpu_torch.torch.lm_step import HEADLINE, SERVE_HEADLINE

    spec, cfg = SERVE_HEADLINE["spec"], SERVE_HEADLINE["cfg"]
    assert (spec.vocab, spec.d_model, spec.n_layers, spec.n_heads,
            4 * spec.d_model) == tuple(HEADLINE[k] for k in (
                "vocab_size", "d_model", "n_layers", "n_heads", "d_ff"))
    assert spec.dtype == "bfloat16" and cfg.max_seq == 1024
    pages = 8 * 2 * (cfg.num_blocks + 1) * cfg.block_tokens * 8 * 64 * 2
    assert 130e6 < pages < 140e6


# ---------------------------------------------------------------------------
# Serving end to end: HTTP at size 1, two ranks, a legacy checkpoint.
# ---------------------------------------------------------------------------


def _post(port, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return json.loads(resp.read())


def _shutdown(port):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/shutdown",
                                 data=b"")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture
def size_1(monkeypatch):
    from horovod_tpu_torch import common as hvd

    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    tmetrics.registry.reset()
    yield hvd
    hvd.shutdown()
    tmetrics.registry.reset()


def test_serve_smoke_single_process(size_1, lm):
    from horovod_tpu_torch.serving import server as _server

    cfg = tsched.ServeConfig(max_batch=4, prefill_chunk=4, block_tokens=4,
                             num_blocks=64, max_blocks_per_seq=8, port=0,
                             request_timeout_sec=120.0)
    params = from_flax_params(lm.params)
    sch = tsched.Scheduler(cfg)
    engine = tengine.ServingEngine(lm.tspec, cfg, params, sch)
    loop = threading.Thread(target=engine.run, daemon=True)
    loop.start()
    port = _server.start_server(sch, cfg, engine=engine)
    try:
        assert _get(port, "/healthz") == {"ok": True, "size": 1,
                                          "membership_epoch": 0}
        jobs = {"acme": ([3, 1, 4, 1, 5], 6), "beta": ([2, 7, 1], 3)}
        results = {}

        def client(tenant):
            prompt, max_new = jobs[tenant]
            results[tenant] = _post(port, {"tenant": tenant,
                                           "prompt_ids": prompt,
                                           "max_new_tokens": max_new})

        threads = [threading.Thread(target=client, args=(t,)) for t in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        for tenant, (prompt, max_new) in jobs.items():
            status, body = results[tenant]
            assert status == 200, (tenant, body)
            assert body["tokens"] == jengine.reference_decode(
                lm.jmodel, lm.params, prompt, max_new)
            assert body["ttft_ms"] is not None
            trace = _get(port, f"/v1/trace?id={body['id']}")
            assert trace["spans"][-1]["event"] == "retired"
        status, body = _post(port, {"tenant": "acme", "prompt_ids": [1] * 30,
                                    "max_new_tokens": 30})
        assert status == 400 and body["error"]["reason"] == "too_long"
        status, body = _post(port, {"prompt_ids": [1]})
        assert status == 400 and body["error"]["type"] == "bad_request"
        serving = _get(port, "/v1/stats")["serving"]
        assert (serving["admitted"], serving["retired"],
                serving["rejected"]) == (2, 2, 1)
        assert serving["tenants"]["acme"]["generated_tokens"] == 6
        assert serving["tenants"]["beta"]["generated_tokens"] == 3
        assert serving["tenants"]["acme"]["prompt_tokens"] == 5
        snap = size_1.metrics_snapshot()
        assert snap["serving"]["steps"] == serving["steps"] >= 6
        assert snap["serving"]["kv_blocks_in_use"] == 0
        assert snap["histograms"]["serving_ttft_sec"]["count"] == 2
        assert _shutdown(port)["stopping"]
        loop.join(60)
        assert not loop.is_alive()
    finally:
        engine.request_stop()
        _server.stop_server()


# Two ranks of the port's runner, each running the serving entry point's
# ``serve()`` on the JAX model's weights (a legacy checkpoint); the test
# process is the HTTP client.
_DP_JOBS = {"acme": ([5, 4, 3], 14), "beta": (list(range(1, 21)), 10),
            "gamma": ([9, 8, 7, 6, 5, 4], 16)}
_SERVE_RANK = """
import hashlib, json, os, sys
from horovod_tpu_torch import common as hvd
from horovod_tpu_torch.serving.__main__ import serve
from horovod_tpu_torch.serving.engine import ModelSpec
from horovod_tpu_torch.serving.scheduler import ServeConfig
engine = serve(ModelSpec.from_env(), ServeConfig.from_env())
# Trash block aside: colliding lanes land there, and nothing reads it.
digest = hashlib.sha256(engine.pages[:, :, :-1].numpy().tobytes()).hexdigest()
with open(os.path.join(sys.argv[1], f"rank{hvd.rank()}.json"), "w") as f:
    json.dump({"digest": digest, "size": hvd.size()}, f)
hvd.shutdown()
"""


def test_two_rank_serve_over_the_runner(tmp_path, lm):
    """Prompt "beta" (20 tokens) takes the bulk prefill, whose prompt
    travels in the side broadcast."""
    from horovod_tpu.jax.train import save_checkpoint
    from horovod_tpu_torch.common.basics import pick_free_ports
    from horovod_tpu_torch.runner import run_command

    save_checkpoint(str(tmp_path / "ckpt"), 1, {"params": lm.params})
    port = pick_free_ports(1)[0]
    serve_env = dict(
        VOCAB=SPEC["vocab"], D_MODEL=SPEC["d_model"],
        LAYERS=SPEC["n_layers"], HEADS=SPEC["n_heads"], DEVICE="cpu",
        CKPT=tmp_path / "ckpt", PORT=port, MAX_BATCH=4, PREFILL_CHUNK=4,
        BLOCK_TOKENS=4, KV_BLOCKS=64, MAX_BLOCKS_PER_SEQ=16,
        RING_MIN_TOKENS=16)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="2",
        **{f"HVD_TPU_SERVE_{k}": str(v) for k, v in serve_env.items()})
    for var in _ENV:
        env.pop(var, None)
    box, results = {}, {}

    def job():
        box["ranks"] = run_command(
            [sys.executable, "-c", _SERVE_RANK, str(tmp_path)], 2, env=env,
            timeout=240, capture=True)

    runner = threading.Thread(target=job)
    runner.start()
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                base = _get(port, "/v1/stats", timeout=2)["cache"]["engine"]
                break
            except OSError:
                assert time.monotonic() < deadline and runner.is_alive(), \
                    box.get("ranks")
                time.sleep(0.2)

        def client(tenant):
            prompt, max_new = _DP_JOBS[tenant]
            results[tenant] = _post(port, {"tenant": tenant,
                                           "prompt_ids": prompt,
                                           "max_new_tokens": max_new})

        threads = [threading.Thread(target=client, args=(t,))
                   for t in _DP_JOBS]
        for t in threads:
            t.start()
            time.sleep(0.002)
        for t in threads:
            t.join(180)
        stats = _get(port, "/v1/stats")
        _shutdown(port)
    finally:
        runner.join(240)
    for r in box["ranks"]:
        assert r.returncode == 0, r.stderr[-3000:]
    for tenant, (prompt, max_new) in _DP_JOBS.items():
        status, body = results[tenant]
        assert status == 200, body
        assert body["tokens"] == jengine.reference_decode(
            lm.jmodel, lm.params, prompt, max_new), tenant
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert ranks[0] == ranks[1] and ranks[0]["size"] == 2
    hits = stats["cache"]["engine"]["hits"] - base["hits"]
    misses = stats["cache"]["engine"]["misses"] - base["misses"]
    assert hits / max(hits + misses, 1) >= 0.9, (hits, misses)
    assert stats["serving"]["retired"] == 3


def test_legacy_jax_checkpoint_served_by_the_port(tmp_path, size_1, lm):
    """A ``save_checkpoint`` pickle with optax state beside the params:
    the port serves its params, found in a directory or named as a file,
    and reads it in a process where importing JAX fails."""
    import optax

    from horovod_tpu.jax.train import save_checkpoint

    tree = {"params": lm.params,
            "opt_state": jax.device_get(optax.adam(1e-3).init(lm.params))}
    save_checkpoint(str(tmp_path), 3, tree)
    path = save_checkpoint(str(tmp_path), 7, tree)
    spec = tengine.ModelSpec(**SPEC, device="cpu", ckpt=str(tmp_path))
    for source in (str(tmp_path), path):
        params = tengine.init_params(
            tengine.ModelSpec(**SPEC, device="cpu", ckpt=source))
        for k, v in from_flax_params(lm.params).items():
            assert torch.equal(params[k], v), k
    cfg = tsched.ServeConfig(max_batch=2, prefill_chunk=4, block_tokens=4,
                             num_blocks=32, max_blocks_per_seq=8)
    sch = tsched.Scheduler(cfg)
    engine = tengine.ServingEngine(spec, cfg, tengine.init_params(spec), sch)
    loop = threading.Thread(target=engine.run, daemon=True)
    loop.start()
    req = sch.submit("t", [4, 2, 9, 9], 5)
    assert req.event.wait(120) and req.error is None
    engine.request_stop()
    loop.join(60)
    assert req.generated == jengine.reference_decode(
        lm.jmodel, lm.params, [4, 2, 9, 9], 5)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from horovod_tpu_torch.serving import engine as e\n"
            f"p = e.init_params(e.ModelSpec(ckpt={str(tmp_path)!r}))\n"
            "print(len(p), float(p['lm_head_kernel'].sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    n, total = out.stdout.split()
    assert int(n) == len(params)
    assert float(total) == float(params["lm_head_kernel"].sum())


def test_runner_serve_arguments(monkeypatch):
    from horovod_tpu_torch.runner import launch

    calls = []

    def fake_run(cmd, np_, env=None, timeout=None, host=None):
        calls.append((cmd, np_, env))
        return []

    monkeypatch.setattr(launch, "run_command", fake_run)
    assert launch.main(["-np", "2", "--serve"]) == 0
    assert calls[-1] == ([sys.executable, "-m", "horovod_tpu_torch.serving"],
                         2, None)
    assert launch.main(["-np", "2", "--serve", "--serve-port", "9123"]) == 0
    assert calls[-1][2]["HVD_TPU_SERVE_PORT"] == "9123"
    assert launch.main(["-np", "1", "--serve", "--", "python", "x.py"]) == 0
    assert calls[-1][0] == ["python", "x.py"]
    for argv in (["-np", "1", "--serve-port", "9", "--", "python", "x.py"],
                 ["-np", "1"]):
        with pytest.raises(SystemExit):
            launch.main(argv)
    assert len(calls) == 3


def test_serving_entry_refuses_a_rejoining_rank(monkeypatch, capsys):
    from horovod_tpu_torch.serving import __main__ as entry

    monkeypatch.setenv("HVD_TPU_REJOIN", "1")
    assert entry.main() == 3
    assert "standby" in capsys.readouterr().err


def test_metrics_env_enables_the_registry(monkeypatch):
    from horovod_tpu_torch import common as hvd

    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    monkeypatch.setenv("HVD_TPU_METRICS", "1")
    try:
        hvd.init(device="cpu")
        assert tmetrics.registry.enabled
    finally:
        hvd.shutdown()
        tmetrics.registry.enabled = False


def test_import_walk_covers_the_serving_plane():
    from tests.test_torch_basics import _port_files

    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("__init__", "__main__", "engine", "kv_cache", "prefill",
                 "scheduler", "server"):
        assert f"horovod_tpu_torch/serving/{name}.py" in rel, name
    assert "horovod_tpu_torch/common/metrics.py" in rel
    assert "tools/torch_serve_control.py" in rel
