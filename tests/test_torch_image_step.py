"""horovod_tpu_torch's image training step against the JAX package's, on
the CPU.

- The data-parallel recipe of ``examples/jax_imagenet_resnet50.py``: the
  JAX ``build_train_step(..., has_aux=True)`` on a 2-device CPU mesh with a
  ResNet whose BN is cross-replica (``axis_name="hvd"``, flax
  ``nn.BatchNorm``), SGD with momentum 0.9, the batch stats averaged as
  aux; against the port's ``build_image_step`` at np 2 through the port's
  runner, each rank on its half of the batch, with ``axis_name`` BN
  (statistics averaged inside the forward, their cotangent inside the
  backward).  Three steps: the losses, the final parameters and the
  running stats, and both ranks bit for bit equal.
- The single-process ``bench.py`` step (``fused_ema=True``: raw batch
  statistics, one ``ema_batch_stats`` after the update) against the same
  step written out in JAX.

A narrow ResNet (stage sizes [1, 1, 1, 1], 8 filters, bottleneck blocks,
the 3 x 3 stem) in float32 on 16 x 16 standard-normal images (centred: see
test_torch_models.py for what uncentred images do to float32 BN
statistics), weights from the flax init moved off their initial values
and converted.  Tolerances: losses rtol 1e-5, parameters and stats within
1e-4 of each tensor's largest element (float32 summation order through
three steps at learning rate 0.1).
"""

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import models as jm
from horovod_tpu.jax.train import build_train_step as jax_build_train_step
from horovod_tpu.parallel import replicate, shard_batch
from horovod_tpu_torch.models.convert import from_flax_variables
from tests.test_torch_engine import _bits, _launch
from tests.test_torch_models import _perturb

BATCH, SIDE, CLASSES, STEPS, LR = 8, 16, 10, 3, 0.1
ARCH = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, small_inputs=True)


def _flax_model(fused, axis_name=None):
    return jm.ResNet(block_cls=jm.resnet.BottleneckBlock,
                     num_classes=CLASSES, dtype=jnp.float32,
                     fused_ema=fused, axis_name=axis_name, **ARCH)


def _data():
    rng = np.random.RandomState(21)
    images = rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, BATCH).astype(np.int32)
    return images, labels


def _init(fused):
    images, _ = _data()
    v = _flax_model(fused).init(jax.random.PRNGKey(3), jnp.asarray(images),
                                train=False)
    return _perturb(v["params"], 4), _perturb(v["batch_stats"], 5)


def _narrow():
    """The image step's model table with the narrow ResNet as
    ``resnet_narrow``, for the duration of a ``with``."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.torch import image_step

    narrow = functools.partial(resnet.ResNet,
                               block_cls=resnet.BottleneckBlock, **ARCH)
    return mock.patch.dict(image_step.MODELS, {"resnet_narrow": narrow})


def _port_model(fused=False):
    from horovod_tpu_torch.torch.image_step import build_image_model

    with _narrow():
        return build_image_model("resnet_narrow", num_classes=CLASSES,
                                 image=SIDE, dtype=torch.float32,
                                 fused_ema=fused, device="cpu")


def _port_state(fused):
    params, stats = _init(fused)
    return from_flax_variables(_port_model(fused), params, stats)


def _torch_batch(rows=slice(None)):
    images, labels = _data()
    x = torch.from_numpy(images[rows]).permute(0, 3, 1, 2)
    return x, torch.from_numpy(labels[rows]).long()


def _run_port(state, fused, axis_name, rows):
    """Three steps of the port's image step on this process; (losses,
    state_dict)."""
    from horovod_tpu_torch.torch.image_step import build_image_step

    with _narrow():
        net, step, _ = build_image_step(
            "cpu", model="resnet_narrow", batch=BATCH, image=SIDE,
            num_classes=CLASSES, dtype=torch.float32, fused_ema=fused,
            axis_name=axis_name, lr=LR)
    net.load_state_dict(state, strict=True)
    data = _torch_batch(rows)
    losses = [step(data).item() for _ in range(STEPS)]
    return losses, {k: v.clone() for k, v in net.state_dict().items()}


def _dp_rank(out_dir):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    state = torch.load(os.path.join(out_dir, "init.pt"))
    losses, sd = _run_port(state, False, "hvd",
                           slice(r * BATCH // n, (r + 1) * BATCH // n))
    torch.save({"losses": losses, "state": sd},
               os.path.join(out_dir, f"dp{r}.pt"))
    hvd.shutdown()


def _jax_dp_run():
    """The example's recipe on a 2-device mesh: losses, params, stats."""
    model = _flax_model(False, axis_name="hvd")
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    params, stats = _init(False)

    def loss_fn(p, batch):
        images, labels, batch_stats = batch
        logits, upd = model.apply({"params": p, "batch_stats": batch_stats},
                                  images, train=True,
                                  mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, upd["batch_stats"]

    tx = optax.sgd(LR, momentum=0.9)
    step = jax_build_train_step(loss_fn, tx, mesh, axis_name="hvd",
                                has_aux=True,
                                batch_spec=(P("hvd"), P("hvd"), P()))
    images, labels = _data()
    params = replicate(mesh, params)
    opt_state = replicate(mesh, tx.init(params))
    stats = replicate(mesh, stats)
    images, labels = shard_batch(mesh, images), shard_batch(mesh, labels)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss, stats = step(params, opt_state,
                                              (images, labels, stats))
        losses.append(float(loss))
    return losses, jax.device_get(params), jax.device_get(stats)


def _hold_state(got, params, stats):
    want = from_flax_variables(_port_model(), params, stats)
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err)


def test_np2_step_with_cross_replica_bn_matches_jax_recipe(tmp_path):
    torch.save(_port_state(False), tmp_path / "init.pt")
    _launch(functools.partial(_dp_rank, str(tmp_path)), 2,
            OMP_NUM_THREADS="2")
    want_losses, params, stats = _jax_dp_run()
    runs = [torch.load(tmp_path / f"dp{r}.pt") for r in range(2)]
    for name, v in runs[0]["state"].items():
        assert torch.equal(_bits(v), _bits(runs[1]["state"][name])), name
    assert runs[0]["losses"] == runs[1]["losses"]
    np.testing.assert_allclose(runs[0]["losses"], want_losses, rtol=1e-5)
    assert want_losses[-1] < want_losses[0]
    _hold_state(runs[0]["state"], params, stats)


def _jax_fused_run():
    """bench.py's image step, written out (no packing): value_and_grad
    with the raw batch stats as aux, ema_batch_stats, optax.sgd."""
    model = _flax_model(True)
    params, stats = _init(True)
    images, labels = map(jnp.asarray, _data())
    tx = optax.sgd(LR, momentum=0.9)
    opt_state = tx.init(params)

    def loss_fn(p, batch_stats):
        logits, upd = model.apply({"params": p, "batch_stats": batch_stats},
                                  images, train=True,
                                  mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, upd["batch_stats"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    losses = []
    for _ in range(STEPS):
        (loss, new), grads = grad_fn(params, stats)
        stats = jm.ema_batch_stats(stats, new, 0.9)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, jax.device_get(params), jax.device_get(stats)


def test_size1_fused_ema_step_matches_jax():
    import horovod_tpu_torch as hvd

    want_losses, params, stats = _jax_fused_run()
    hvd.init(device="cpu")
    try:
        losses, state = _run_port(_port_state(True), True, None,
                                  slice(None))
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert want_losses[-1] < want_losses[0]
    _hold_state(state, params, stats)


def test_image_step_batch_is_bench_batch():
    """synthetic_batch makes bench.py's batch: NHWC uniform images from
    RandomState(seed) handed over as channels_last NCHW (the same bytes),
    labels from RandomState(seed + 1)."""
    from horovod_tpu_torch.torch.image_step import synthetic_batch

    x, y = synthetic_batch("resnet50", 4, 8, 1000, data_seed=0)
    want = np.random.RandomState(0).rand(4, 8, 8, 3).astype(np.float32)
    assert x.shape == (4, 3, 8, 8)
    assert x.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(
        y.numpy(), np.random.RandomState(1).randint(0, 1000, 4))
    x2, y2 = synthetic_batch("resnet50", 4, 8, 1000, data_seed=0,
                             rows=slice(2, 4))
    assert torch.equal(x2, x[2:]) and torch.equal(y2, y[2:])


@pytest.mark.parametrize("has_aux", [False, True])
def test_build_train_step_returns_the_aux(has_aux):
    """has_aux: ``(loss, aux)`` with aux detached (at size 1 the mean over
    one worker); without it the loss alone."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch.train import build_train_step

    hvd.init(device="cpu")
    try:
        lin = torch.nn.Linear(3, 1)
        x = torch.ones(2, 3)

        def loss_fn(m, b):
            loss = m(b).square().mean()
            return (loss, {"a": loss * 2, "b": m.weight}) if has_aux \
                else loss

        step = build_train_step(loss_fn, torch.optim.SGD(lin.parameters(),
                                                         lr=0.0), lin,
                                has_aux=has_aux)
        out = step(x)
        if has_aux:
            loss, aux = out
            assert set(aux) == {"a", "b"} and not aux["b"].requires_grad
            assert torch.allclose(aux["a"], 2 * loss)
        else:
            assert torch.is_tensor(out) and out.dim() == 0
    finally:
        hvd.shutdown()
