"""horovod_tpu_torch's training step against horovod_tpu's.

Three steps of the port's ``build_train_step`` with
``DistributedOptimizer(AdamW(1e-3, weight_decay=1e-4))`` at size 1 on the
full batch, against three steps of the JAX ``build_train_step`` with
``optax.adamw(1e-3)`` (whose default weight decay is 1e-4) on a 1-device
and on a 2-device mesh.  The mean of the two shards' mean losses is the
full-batch mean, so the 2-device run checks the data-parallel averaging.
The port uses ``use_flash=False`` (its blockwise scan).  The JAX model runs
on a ``("dp", "sp")`` mesh whose sequence axis has size 1, so its
attention is ring attention over a ring of one shard — the same causal
attention.  (Its single-shard blockwise scan cannot run under
``build_train_step``'s ``shard_map`` with the replication check on: the
scan's carry starts unvarying and comes back varying over ``dp``; with the
check off the gradients are no longer summed across shards.)  float32
throughout.  Tolerances: loss trajectory rtol 1e-4; final
parameters atol 5e-5 (float32 summation order through three Adam steps,
each of which normalises the gradient).
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
from horovod_tpu.models import TransformerLM as FlaxLM
from horovod_tpu.models import next_token_loss as flax_loss
from horovod_tpu.parallel import replicate
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.models.convert import from_flax_params, to_flax_params
from horovod_tpu_torch.torch import DistributedOptimizer
from horovod_tpu_torch.torch.lm_step import HEADLINE, build_lm_step
from horovod_tpu_torch.torch.train import build_train_step

VOCAB, D_MODEL, LAYERS, HEADS = 64, 32, 2, 4
BATCH, SEQ, STEPS = 4, 32, 3


def _data(batch=BATCH):
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, VOCAB, (batch, SEQ + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def _flax_model(seq_axis=None):
    return FlaxLM(vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                  n_heads=HEADS, dtype=jnp.float32, use_flash=False,
                  seq_axis=seq_axis)


def _init_params():
    inp, _ = _data()
    return jax.device_get(_flax_model().init(
        jax.random.PRNGKey(1), jnp.asarray(inp))["params"])


def _jax_run(n_devices, batch=BATCH):
    inp, tgt = _data(batch)
    model = _flax_model(seq_axis="sp")
    mesh = Mesh(np.array(jax.devices()[:n_devices]).reshape(n_devices, 1),
                ("dp", "sp"))

    def loss_fn(params, batch):
        i, t = batch
        return flax_loss(model.apply({"params": params}, i), t)

    tx = optax.adamw(1e-3)
    spec = P("dp", "sp")
    step = jax_build_train_step(loss_fn, tx, mesh, axis_name=("dp", "sp"),
                                batch_spec=(spec, spec))
    params = replicate(mesh, _init_params())
    opt_state = replicate(mesh, tx.init(params))
    batch = tuple(jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
                  for x in (inp, tgt))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return losses, jax.device_get(params)


def _torch_run():
    inp, tgt = _data()
    hvd.init(device="cpu")
    try:
        model = TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS,
                              dtype=torch.float32, use_flash=False,
                              device="cpu")
        model.load_state_dict(from_flax_params(_init_params()), strict=True)
        opt = DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())

        def loss_fn(m, batch):
            return next_token_loss(m(batch[0]), batch[1])

        step = build_train_step(loss_fn, opt, model)
        batch = (torch.from_numpy(inp).long(), torch.from_numpy(tgt).long())
        losses = [step(batch).item() for _ in range(STEPS)]
        assert len(step.step_sec) == STEPS
        return losses, to_flax_params(model.state_dict())
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def torch_run():
    return _torch_run()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("n_devices", [1, 2])
def test_three_steps_match_jax_build_train_step(torch_run, n_devices):
    want_losses, want_params = _jax_run(n_devices)
    got_losses, got_params = torch_run
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] < got_losses[0]
    want, got = _flat(want_params), _flat(got_params)
    assert set(want) == set(got)
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, atol=5e-5, err_msg=name)


def test_lm_step_recipe_trains_on_cpu():
    """The main path's recipe, which chip_smoke.py and
    tools/torch_step_profile.py build at the headline widths, at a tiny
    width on the CPU: a fixed batch of in-vocab tokens, a loss that starts
    near ln(vocab) (random init) and falls as the batch is memorised."""
    assert HEADLINE == dict(vocab_size=32768, d_model=512, n_layers=8,
                            n_heads=8, d_ff=2048, batch=16, seq=1024)
    hvd.init(device="cpu")
    try:
        model, step, (inp, tgt) = build_lm_step(
            "cpu", vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
            n_heads=HEADS, d_ff=4 * D_MODEL, batch=BATCH, seq=SEQ,
            dtype=torch.float32, logits_dtype=torch.float32)
        assert inp.shape == tgt.shape == (BATCH, SEQ)
        assert torch.equal(inp[:, 1:], tgt[:, :-1])
        assert int(inp.max()) < VOCAB
        losses = [step((inp, tgt)).item() for _ in range(STEPS)]
    finally:
        hvd.shutdown()
    # As chip_smoke.py: the random head's logits spread by O(1), which
    # lifts the first loss above ln(vocab) by about half their variance.
    assert abs(losses[0] - np.log(VOCAB)) < 1.0
    assert losses[-1] < losses[0]
