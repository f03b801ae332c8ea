"""horovod_tpu_torch's sequence-parallel TransformerLM and training step
against horovod_tpu's, on the CPU.

The JAX side runs ``shard_map`` over the virtual 8-device CPU mesh (Pallas
in interpret mode); the port runs a ``RingMesh(4, "cpu")`` (plain
versions).  Weights are the flax model's, converted with
``models.convert.from_flax_params``; tokens come from numpy.  float32
throughout.  Tolerances: logits and parameter gradients 2e-4, as
tests/test_transformer.py holds the JAX sequence-parallel model against
the single-shard one; the training steps as tests/test_torch_train.py
(loss rtol 1e-4, parameters atol 5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.jax.train import build_train_step as jax_build_train_step
from horovod_tpu.jax.train import shard_map
from horovod_tpu.models import TransformerLM as FlaxLM
from horovod_tpu.models import next_token_loss as flax_loss
from horovod_tpu.parallel import replicate
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.models.convert import from_flax_params, to_flax_params
from horovod_tpu_torch.parallel import RingMesh
from horovod_tpu_torch.torch import DistributedOptimizer
from horovod_tpu_torch.torch.lm_step import (HEADLINE, RING_HEADLINE,
                                             build_lm_step)
from horovod_tpu_torch.torch.train import build_train_step

N = 4
VOCAB, D_MODEL, HEADS = 64, 16, 2
BATCH, SEQ = 2, N * 32
MODES = ["fused", "rdma", "ppermute"]


def _flax(n_layers, seq_axis=None, ring_impl="ppermute"):
    return FlaxLM(vocab_size=VOCAB, d_model=D_MODEL, n_layers=n_layers,
                  n_heads=HEADS, dtype=jnp.float32, use_flash=False,
                  seq_axis=seq_axis, ring_impl=ring_impl)


def _tokens(seed, batch=BATCH, seq=SEQ):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (batch, seq + 1)).astype(np.int32)


def _params(n_layers, seed):
    tokens = _tokens(seed)[:, :-1]
    return jax.device_get(_flax(n_layers).init(
        jax.random.PRNGKey(seed), jnp.asarray(tokens))["params"])


def _torch_model(params, n_layers, ring_impl, mesh):
    model = TransformerLM(VOCAB, D_MODEL, n_layers, HEADS,
                          dtype=torch.float32, use_flash=False, device="cpu",
                          seq_axis=mesh, ring_impl=ring_impl)
    model.load_state_dict(from_flax_params(params), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX sequence-parallel model (fused ring) on 4 devices: logits,
    and parameter gradients of the mean next-token loss."""
    params = _params(2, seed=1)
    tokens = _tokens(2)
    inp, tgt = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])
    model = _flax(2, "sp", "fused")
    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))
    spec = P(None, "sp")

    def sp_loss(params):
        def shard(tokens, targets):
            logits = model.apply({"params": params}, tokens)
            return flax_loss(logits, targets)[None], logits

        losses, logits = shard_map(
            shard, mesh=mesh, in_specs=(spec, spec),
            out_specs=(P("sp"), spec), check_vma=False)(inp, tgt)
        return losses.mean(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(sp_loss, has_aux=True))(
        params)
    return dict(params=params, tokens=tokens, logits=np.asarray(logits),
                grads=jax.device_get(grads))


@pytest.mark.parametrize("ring_impl", MODES)
def test_sp_logits_and_grads_match_jax_fused_model(jax_fused, ring_impl):
    mesh = RingMesh(N, "cpu")
    model = _torch_model(jax_fused["params"], 2, ring_impl, mesh)
    tokens = torch.from_numpy(jax_fused["tokens"]).long()
    logits = model(tokens[:, :-1])
    np.testing.assert_allclose(logits.detach().numpy(), jax_fused["logits"],
                               atol=2e-4, rtol=2e-4)
    next_token_loss(logits, tokens[:, 1:], axis_name=mesh).backward()
    want = from_flax_params(jax_fused["grads"])
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
    assert mesh.flags_balanced()


def test_sp_model_takes_the_same_converted_weights():
    """Sequence parallelism adds no parameters: the flax tree converts to
    one state_dict that the port's single-shard and sequence-parallel
    models both take, and converts back unchanged."""
    params = _params(1, seed=3)
    sd = from_flax_params(params)
    for mesh in (None, RingMesh(N, "cpu")):
        model = TransformerLM(VOCAB, D_MODEL, 1, HEADS, dtype=torch.float32,
                              device="cpu", seq_axis=mesh,
                              ring_impl="fused")
        model.load_state_dict(sd, strict=True)
        back = to_flax_params(model.state_dict())
        for path, a in jax.tree_util.tree_leaves_with_path(params):
            b = back
            for key in path:
                b = b[key.key]
            np.testing.assert_array_equal(b, a)


def test_masked_loss_over_shards_matches_jax():
    """``next_token_loss(..., axis_name=)``: each shard normalised by the
    global mean count of valid tokens per shard, then averaged — also
    where the shards hold different numbers of valid tokens."""
    rng = np.random.RandomState(4)
    logits = rng.standard_normal((2, N * 8, 32)).astype(np.float32)
    tgt = rng.randint(0, 32, (2, N * 8))
    mask = (rng.uniform(size=(2, N * 8)) > 0.3).astype(np.float32)
    mask[:, :8] = 0.0  # the first shard holds no valid token
    spec = P(None, "sp")

    def shard(lg, t, m):
        return flax_loss(lg, t, m, axis_name="sp")[None]

    want = shard_map(shard, mesh=Mesh(np.array(jax.devices()[:N]), ("sp",)),
                     in_specs=(P(None, "sp", None), spec, spec),
                     out_specs=P("sp"))(
        *map(jnp.asarray, (logits, tgt, mask))).mean()
    mesh = RingMesh(N, "cpu")
    got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                          torch.from_numpy(mask), axis_name=mesh)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    unmasked = next_token_loss(torch.from_numpy(logits),
                               torch.from_numpy(tgt), axis_name=mesh)
    np.testing.assert_allclose(
        unmasked.item(), next_token_loss(torch.from_numpy(logits),
                                         torch.from_numpy(tgt)).item(),
        rtol=1e-6)


STEPS = 3


@pytest.fixture(scope="module")
def jax_sp_train():
    """Three JAX ``build_train_step`` steps on a (1, 4) ("dp", "sp")
    mesh, ppermute ring, ``check_vma=True`` (with it off the JAX step no
    longer sums the gradients across shards)."""
    params0 = _params(1, seed=5)
    tokens = _tokens(6)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    model = _flax(1, "sp", "ppermute")
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(1, N), ("dp", "sp"))

    def loss_fn(params, batch):
        i, t = batch
        return flax_loss(model.apply({"params": params}, i), t)

    tx = optax.adamw(1e-3)
    spec = P("dp", "sp")
    step = jax_build_train_step(loss_fn, tx, mesh, axis_name=("dp", "sp"),
                                batch_spec=(spec, spec), check_vma=True)
    params = replicate(mesh, params0)
    opt_state = replicate(mesh, tx.init(params))
    batch = tuple(jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
                  for x in (inp, tgt))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return dict(params0=params0, tokens=tokens, losses=losses,
                params=jax.device_get(params))


@pytest.mark.parametrize("ring_impl", MODES)
def test_three_sp_steps_match_jax_build_train_step(jax_sp_train, ring_impl):
    hvd.init(device="cpu")
    try:
        mesh = RingMesh(N, "cpu")
        model = _torch_model(jax_sp_train["params0"], 1, ring_impl, mesh)
        opt = DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())

        def loss_fn(m, batch):
            return next_token_loss(m(batch[0]), batch[1], axis_name=mesh)

        step = build_train_step(loss_fn, opt, model)
        tokens = torch.from_numpy(jax_sp_train["tokens"]).long()
        batch = (tokens[:, :-1], tokens[:, 1:])
        losses = [step(batch).item() for _ in range(STEPS)]
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(losses, jax_sp_train["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    want = from_flax_params(jax_sp_train["params"])
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5,
                                   err_msg=name)
    assert mesh.flags_balanced()


@pytest.mark.parametrize("ring_impl", ["fused", "rdma"])
def test_timed_out_ring_raises_and_never_reaches_the_update(ring_impl):
    """A ring kernel that gave up leaves the mesh's error word set: the
    ring op raises at its join in the forward and in the backward, so
    neither logits nor gradients of the failed ring come back, and the
    training step leaves the parameters as they were."""
    mesh = RingMesh(N, "cpu")
    model = TransformerLM(VOCAB, D_MODEL, 1, HEADS, dtype=torch.float32,
                          device="cpu", seq_axis=mesh, ring_impl=ring_impl)
    tokens = torch.from_numpy(_tokens(7)).long()
    batch = (tokens[:, :-1], tokens[:, 1:])
    mesh.err.fill_(1)
    with pytest.raises(RuntimeError, match="handshake timed out"):
        model(batch[0])
    mesh.err.zero_()

    def loss_fn(m, b):
        loss = next_token_loss(m(b[0]), b[1], axis_name=mesh)
        mesh.err.fill_(2)  # a spin of the backward's ring gives up
        return loss

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    hvd.init(device="cpu")
    try:
        step = build_train_step(
            loss_fn, torch.optim.AdamW(model.parameters(), lr=1e-3), model)
        with pytest.raises(RuntimeError, match="copy gate timed out"):
            step(batch)
    finally:
        hvd.shutdown()
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), before[name]), name


def test_ring_lm_step_recipe_trains_on_cpu():
    """The ring path's recipe, which chip_smoke.py builds at the headline
    widths over 4 members, at a tiny width on the CPU."""
    assert RING_HEADLINE == dict(HEADLINE, batch=4, seq=4096, members=4,
                                 ring_impl="fused")
    hvd.init(device="cpu")
    try:
        model, step, (inp, tgt) = build_lm_step(
            "cpu", vocab_size=VOCAB, d_model=D_MODEL, n_layers=1,
            n_heads=HEADS, d_ff=4 * D_MODEL, batch=BATCH, seq=SEQ,
            dtype=torch.float32, logits_dtype=torch.float32, members=N)
        assert isinstance(model.seq_axis, RingMesh)
        assert model.seq_axis.size == N
        losses = [step((inp, tgt)).item() for _ in range(STEPS)]
    finally:
        hvd.shutdown()
    assert abs(losses[0] - np.log(VOCAB)) < 1.0
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="equal shards"):
        model(inp[:, :SEQ - 1])
