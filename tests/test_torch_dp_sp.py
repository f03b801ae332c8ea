"""horovod_tpu_torch's dp x sp training (data-parallel ranks, each a
sequence-parallel ring) against horovod_tpu's ``("dp", "sp")`` mesh.

- Three steps at np 2 (ranks of the port's runner, CPU), each rank a
  ``RingMesh(4, "cpu")`` on its two rows of a 4-row batch, against three
  steps of the JAX ``build_train_step`` on a (2, 4) ``("dp", "sp")`` mesh
  of the virtual CPU devices (as ``tests/test_transformer.py``'s
  ``test_dp_sp_train_step`` builds it, ppermute ring), on the same flax
  weights.  The batch carries the padding mask of a shifted sequence
  that 4 does not divide, and the second dp half masks 8 more positions a
  row, so the halves hold different counts and only the count averaged
  over both axes gives the reference's loss.  The port runs the fused
  and the ppermute ring (rdma is held at (1, 4) in
  ``test_torch_ring_model.py``); both modes run in the same two rank
  processes.  Tolerances as ``test_torch_ring_model.py``'s steps: loss
  rtol 1e-4, parameters atol 5e-5 (float32 summation order through three
  Adam steps).  Both ranks end on the same parameters, bit for bit.
- ``next_token_loss``'s axes: ``("dp", mesh)`` at size 1 is the mesh
  alone, and an unknown axis raises.
- The gradient hooks of ``DistributedOptimizer`` fire between the fused
  ring's ops, never between a ring op's fork and its join.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.jax.train import build_train_step as jax_build_train_step
from horovod_tpu.models import TransformerLM as FlaxLM
from horovod_tpu.models import next_token_loss as flax_loss
from horovod_tpu.parallel import replicate
from horovod_tpu_torch.models.convert import from_flax_params
from tests.test_torch_engine import _bits, _launch

DP, SP = 2, 4
VOCAB, D_MODEL, LAYERS, HEADS = 64, 16, 1, 2
BATCH, SEQ, STEPS = 4, SP * 8, 3
MODES = ("fused", "ppermute")


def _flax(seq_axis=None):
    return FlaxLM(vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                  n_heads=HEADS, dtype=jnp.float32, use_flash=False,
                  seq_axis=seq_axis)


def _batch():
    """``(inputs, targets, mask)``, (BATCH, SEQ): the tokens shifted once
    (SEQ - 1 positions) and padded back to SEQ, the padding masked, and
    the second dp half's last 8 positions masked too."""
    tokens = np.random.RandomState(8).randint(
        0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    inputs = np.pad(inputs, ((0, 0), (0, 1)))
    targets = np.pad(targets, ((0, 0), (0, 1)))
    mask = np.pad(np.ones((BATCH, SEQ - 1), np.float32), ((0, 0), (0, 1)))
    mask[BATCH // DP:, -8:] = 0.0
    return inputs, targets, mask


@pytest.fixture(scope="module")
def jax_dp_sp():
    inputs, targets, mask = _batch()
    params0 = jax.device_get(_flax().init(
        jax.random.PRNGKey(3), jnp.asarray(inputs))["params"])
    model = _flax("sp")
    mesh = Mesh(np.array(jax.devices()[:DP * SP]).reshape(DP, SP),
                ("dp", "sp"))

    def loss_fn(params, batch):
        inp, tgt, msk = batch
        return flax_loss(model.apply({"params": params}, inp), tgt, msk,
                         axis_name=("dp", "sp"))

    tx = optax.adamw(1e-3)
    spec = P("dp", "sp")
    step = jax_build_train_step(loss_fn, tx, mesh, axis_name=("dp", "sp"),
                                batch_spec=(spec, spec, spec))
    params = replicate(mesh, params0)
    opt_state = replicate(mesh, tx.init(params))
    batch = tuple(jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
                  for x in (inputs, targets, mask))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return dict(params0=params0, losses=losses,
                params=from_flax_params(jax.device_get(params)))


def _dp_sp_rank(out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM, next_token_loss
    from horovod_tpu_torch.parallel import RingMesh
    from horovod_tpu_torch.torch import DistributedOptimizer
    from horovod_tpu_torch.torch.train import build_train_step

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    init = torch.load(os.path.join(out_dir, "init.pt"))
    rows = slice(r * BATCH // n, (r + 1) * BATCH // n)
    batch = tuple(x[rows] for x in init["batch"])
    out = {}
    for mode in MODES:
        mesh = RingMesh(SP, "cpu")
        model = TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS,
                              dtype=torch.float32, use_flash=False,
                              device="cpu", seq_axis=mesh, ring_impl=mode)
        model.load_state_dict(init["state"], strict=True)
        opt = DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())

        def loss_fn(m, b):
            return next_token_loss(m(b[0]), b[1], b[2],
                                   axis_name=("dp", mesh))

        step = build_train_step(loss_fn, opt, model)
        losses = [step(batch).item() for _ in range(STEPS)]
        out[mode] = {"losses": losses, "state": model.state_dict(),
                     "balanced": mesh.flags_balanced()}
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    hvd.shutdown()


@pytest.fixture(scope="module")
def port_dp_sp(jax_dp_sp, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_sp")
    inputs, targets, mask = _batch()
    torch.save({"state": from_flax_params(jax_dp_sp["params0"]),
                "batch": (torch.from_numpy(inputs).long(),
                          torch.from_numpy(targets).long(),
                          torch.from_numpy(mask))},
               out / "init.pt")
    _launch(functools.partial(_dp_sp_rank, str(out)), DP)
    return [torch.load(out / f"rank{r}.pt") for r in range(DP)]


@pytest.mark.parametrize("ring_impl", MODES)
def test_dp_sp_steps_match_jax_build_train_step(jax_dp_sp, port_dp_sp,
                                                 ring_impl):
    runs = [x[ring_impl] for x in port_dp_sp]
    for name, v in runs[0]["state"].items():
        assert torch.equal(_bits(v), _bits(runs[1]["state"][name])), name
    assert runs[0]["losses"] == runs[1]["losses"]
    assert all(x["balanced"] for x in runs)
    losses = runs[0]["losses"]
    np.testing.assert_allclose(losses, jax_dp_sp["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    want = jax_dp_sp["params"]
    assert set(runs[0]["state"]) == set(want)
    for name, p in runs[0]["state"].items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5,
                                   err_msg=name)


@pytest.fixture
def size_1(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_dp_axis_at_size_1_is_the_mesh_alone_and_unknown_axes_raise(size_1):
    from horovod_tpu_torch.models import next_token_loss
    from horovod_tpu_torch.parallel import RingMesh

    inputs, targets, mask = _batch()
    logits = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (BATCH, SEQ, VOCAB)).astype(np.float32))
    tgt, msk = torch.from_numpy(targets).long(), torch.from_numpy(mask)
    mesh = RingMesh(SP, "cpu")
    want = next_token_loss(logits, tgt, msk, axis_name=mesh)
    for axes in (("dp", mesh), (mesh, "dp")):
        assert torch.equal(next_token_loss(logits, tgt, msk,
                                           axis_name=axes), want)
    assert torch.equal(next_token_loss(logits, tgt, msk, axis_name="dp"),
                       next_token_loss(logits, tgt, msk))
    for bad in ("sp", ("dp", "dp"), (mesh, mesh), ("dp", "sp"),
                ["dp", mesh]):
        with pytest.raises(ValueError, match="unknown axis"):
            next_token_loss(logits, tgt, msk, axis_name=bad)


def test_gradient_hooks_fire_between_ring_ops(size_1, monkeypatch):
    """Every gradient average is enqueued outside the ring ops: no hook
    of the fused ring's step runs between a ring op's fork of the member
    streams and its join."""
    import horovod_tpu_torch.torch as hvdt
    from horovod_tpu_torch.models import TransformerLM, next_token_loss
    from horovod_tpu_torch.parallel import RingMesh
    from horovod_tpu_torch.torch.train import build_train_step

    inside, forks, enqueued = [0], [0], []
    fork, join = RingMesh.fork, RingMesh.join

    def counted_fork(self):
        inside[0] += 1
        forks[0] += 1
        return fork(self)

    def counted_join(self, caller, outputs=()):
        inside[0] -= 1
        return join(self, caller, outputs)

    monkeypatch.setattr(RingMesh, "fork", counted_fork)
    monkeypatch.setattr(RingMesh, "join", counted_join)
    real = hvdt.allreduce_async_

    def recorded(tensor, average=True, name=None, **kw):
        enqueued.append((name, inside[0]))
        return real(tensor, average=average, name=name, **kw)

    monkeypatch.setattr(hvdt, "allreduce_async_", recorded)
    mesh = RingMesh(SP, "cpu")
    model = TransformerLM(VOCAB, D_MODEL, 2, HEADS, dtype=torch.float32,
                          device="cpu", seq_axis=mesh, ring_impl="fused")
    inputs, targets, mask = (torch.from_numpy(x) for x in _batch())

    def loss_fn(m, b):
        return next_token_loss(m(b[0]), b[1], b[2], axis_name=("dp", mesh))

    step = build_train_step(loss_fn, torch.optim.AdamW(model.parameters()),
                            model)
    step((inputs.long(), targets.long(), mask))
    n_params = len(list(model.parameters()))
    assert len(enqueued) == n_params
    assert all(depth == 0 for _, depth in enqueued), enqueued
    assert inside[0] == 0 and forks[0] == 2 * 2  # 2 layers, fwd + bwd
