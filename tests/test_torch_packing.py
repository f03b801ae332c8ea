"""horovod_tpu_torch's TreePacker and packed image step against
horovod_tpu's.

- The layout on a flax ResNet-18's params and batch stats, converted with
  the port's ``models/convert.py`` and nested by their flax paths: the
  same small flags, bounds and ``packed_size`` as
  ``horovod_tpu.models.packing.TreePacker``'s, and the packed vector bit
  for bit.
- A round trip that is exact, the pieces views of the vector and one
  gradient of the vector; the ``ValueError`` of a tree with no small
  leaf; int, float64 and 2-D leaves left big, as the reference leaves
  them.
- ``tests/test_models.py::test_packed_train_step_bit_identical`` in the
  port: ResNet-18, small inputs, fused EMA, float32, three SGD-momentum
  steps of ``build_image_step``, packed against unpacked, within the
  reference's bounds (loss rtol 1e-5; parameters and stats rtol 1e-5,
  atol 1e-6); the same with flax's BN, whose modules write their running
  statistics into the packed buffer's views.
- The packed port step against the JAX package's packed step (the
  reference test's step) on the same weights, on the narrow ResNet of
  ``tests/test_torch_image_step.py`` and at its tolerance.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import models as jm
from horovod_tpu.models.packing import TreePacker as RefPacker
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.packing import PackedModule, TreePacker
from tests import test_torch_image_step as image_step_test


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps share the CPU with other workers,
    and PyTorch's default of a thread per core makes them 20-40x slower
    under that load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flax_resnet18():
    """A flax ResNet-18's params and batch stats (the tree of
    ``model.init``, traced by ``jax.eval_shape``), every leaf drawn from
    ``RandomState``: the layout needs the tree, not the initializers."""
    model = jm.ResNet18(num_classes=10, dtype=jnp.float32,
                        small_inputs=True, fused_ema=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(x.dtype), shapes)
    return v["params"], v["batch_stats"]


def _nest(flax_tree, sd, names, port_model):
    """The port's tensors ``sd`` (a converted state_dict) as a nested dict
    keyed by the flax paths of ``flax_tree``; ``names`` maps a flax leaf
    name to the port's suffix."""
    out = {}
    for path, prefix, _ in convert.image_layers(port_model):
        src = flax_tree
        for key in path:
            src = src.get(key, {})
        node = out
        for key in path if src else ():
            node = node.setdefault(key, {})
        for leaf in src:
            node[leaf] = sd[f"{prefix}.{names[leaf]}"]
    return out


@functools.lru_cache(maxsize=None)
def _port_trees():
    """``((flax params, port tree), (flax stats, port tree))``; the trees
    are only read."""
    from horovod_tpu_torch import models as M

    params, stats = _flax_resnet18()
    model = M.ResNet18(num_classes=10, dtype=torch.float32,
                       small_inputs=True, fused_ema=True)
    sd = convert.from_flax_variables(model, params, stats)
    p_tree = _nest(params, sd, {"kernel": "weight", "scale": "weight",
                                "bias": "bias"}, model)
    s_tree = _nest(stats, sd, {"mean": "running_mean",
                               "var": "running_var"}, model)
    return (params, p_tree), (stats, s_tree)


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("which", ["params", "batch_stats"])
def test_layout_and_vector_match_reference(which):
    flax_tree, tree = _port_trees()[which == "batch_stats"]
    ref, port = RefPacker(flax_tree), TreePacker(tree)
    assert len(port._is_small) == len(jax.tree_util.tree_leaves(flax_tree))
    assert port._is_small == ref._is_small
    assert port._bounds == [int(b) for b in ref._bounds]
    assert port.packed_size == ref.packed_size
    assert [s for s, f in zip(port._shapes, port._is_small) if f] == \
        [tuple(s) for s, f in zip(ref._shapes, ref._is_small) if f]
    got = port.pack(tree)
    want = ref.pack(flax_tree)
    assert np.array_equal(_u32(got["small"].numpy()),
                          _u32(want["small"]))
    assert len(got["big"]) == len(want["big"])
    if which == "params":
        assert 0 < sum(port._is_small) < len(port._is_small)
    else:
        assert all(port._is_small)


def _flatten(tree):
    from horovod_tpu_torch.state import _tree

    return _tree.flatten(tree)[0]


def test_round_trip_exact_views_and_one_gradient():
    (_, tree), _ = _port_trees()
    packer = TreePacker(tree)
    packed = packer.pack(tree)
    ptr = packed["small"].untyped_storage().data_ptr()
    for a, b, small in zip(_flatten(tree), _flatten(packer.unpack(packed)),
                           packer._is_small):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if small:
            assert b.untyped_storage().data_ptr() == ptr
        else:
            assert b is a
    vec = packed["small"].clone().requires_grad_(True)
    back = _flatten(packer.unpack({"big": packed["big"], "small": vec}))
    pieces = [p for p, f in zip(back, packer._is_small) if f]
    weights = [torch.full_like(p, i + 1.0) for i, p in enumerate(pieces)]
    sum((p * w).sum() for p, w in zip(pieces, weights)).backward()
    assert torch.equal(vec.grad, torch.cat([w.reshape(-1)
                                            for w in weights]))


def test_no_small_leaf_raises_as_reference():
    tree = {"k": torch.ones(3, 3), "n": torch.ones(2, dtype=torch.int32)}
    with pytest.raises(ValueError) as port:
        TreePacker(tree)
    with pytest.raises(ValueError) as ref:
        RefPacker({k: v.numpy() for k, v in tree.items()})
    assert str(port.value) == str(ref.value)


def test_int_and_float64_leaves_stay_big():
    """int, float64, 2-D leaves stay big; 0-D and 1-D float32 leaves are
    packed.  The reference is held to the same flags on the tree without
    its float64 leaf: with JAX's 64-bit mode off, its ``jnp.asarray``
    reads a float64 numpy leaf as float32, so it packs that leaf rounded,
    where its docstring (and the port) keep it big."""
    rng = np.random.RandomState(3)
    tree = {"a": rng.standard_normal(5).astype(np.float32),
            "b": np.arange(4, dtype=np.int32),
            "c": rng.standard_normal(3),
            "d": np.array(2.5, np.float32),
            "e": rng.standard_normal((2, 3)).astype(np.float32),
            "f": {"g": rng.standard_normal(7).astype(np.float32),
                  "h": np.arange(3, dtype=np.int64)}}
    port_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    port = TreePacker(port_tree)
    assert port._is_small == [True, False, False, True, False, True, False]
    assert port.packed_size == 13
    packed = port.pack(port_tree)
    assert [t.dtype for t in packed["big"]] == \
        [torch.int32, torch.float64, torch.float32, torch.int64]
    back = port.unpack(packed)
    for path, leaf in jax.tree_util.tree_leaves_with_path(port_tree):
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf)
    del tree["c"], port_tree["c"]
    ref, port = RefPacker(tree), TreePacker(port_tree)
    assert port._is_small == ref._is_small
    assert port.packed_size == ref.packed_size == 13
    assert np.array_equal(_u32(port.pack(port_tree)["small"].numpy()),
                          _u32(ref.pack(tree)["small"]))


def small_stem():
    """The image step's model table with the reference test's ResNet-18
    (the 3 x 3 stem, ``small_inputs``) as ``resnet18_small``, for the
    duration of a ``with``."""
    from horovod_tpu_torch import models as M
    from horovod_tpu_torch.torch import image_step

    return mock.patch.dict(image_step.MODELS, {"resnet18_small": (
        functools.partial(M.ResNet18, small_inputs=True))})


def _port_run(packed, fused_ema=True):
    """Three steps of the port's ResNet-18 image step (small inputs,
    float32) on the reference test's images: losses, final state by the
    model's own names, and the tensors the optimizer hooks."""
    from horovod_tpu_torch.torch.image_step import build_image_step

    with small_stem():
        net, step, data = build_image_step(
            "cpu", model="resnet18_small", batch=4, image=32,
            num_classes=10, dtype=torch.float32, fused_ema=fused_ema,
            packed=packed)
    losses = [step(data).item() for _ in range(3)]
    state = (net.unpacked_state_dict() if packed
             else {k: v.clone() for k, v in net.state_dict().items()})
    return losses, state, len(list(net.parameters()))


@pytest.mark.parametrize("fused_ema", [True, False])
def test_packed_train_step_matches_unpacked(fused_ema):
    """The reference test's case (fused EMA); and flax's BN, whose module
    writes its running statistics into the packed buffer's views."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        loss_a, state_a, hooked_a = _port_run(False, fused_ema)
        loss_b, state_b, hooked_b = _port_run(True, fused_ema)
    finally:
        hvd.shutdown()
    assert (hooked_a, hooked_b) == (62, 22)
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-5)
    assert loss_a[-1] < loss_a[0]
    assert set(state_a) == set(state_b)
    for name, a in state_a.items():
        np.testing.assert_allclose(state_b[name].numpy(), a.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _jax_packed_run():
    """The reference test's packed step on the narrow ResNet: params and
    stats packed outside the step, unpacked inside the jitted gradient,
    fused EMA on the packed stats, optax.sgd with momentum (outside the
    jit, as ``_jax_fused_run``)."""
    t = image_step_test
    model = t._flax_model(True)
    params0, stats0 = t._init(True)
    images, labels = map(jnp.asarray, t._data())
    p_packer, s_packer = RefPacker(params0), RefPacker(stats0)
    params, stats = p_packer.pack(params0), s_packer.pack(stats0)
    tx = optax.sgd(t.LR, momentum=0.9)
    opt_state = tx.init(params)

    def loss_fn(p, s):
        logits, upd = model.apply(
            {"params": p_packer.unpack(p),
             "batch_stats": s_packer.unpack(s)},
            images, train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        return loss, s_packer.pack(upd["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    losses = []
    for _ in range(t.STEPS):
        (loss, new), grads = grad_fn(params, stats)
        stats = jm.ema_batch_stats(stats, new, 0.9)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return (losses, jax.device_get(p_packer.unpack(params)),
            jax.device_get(s_packer.unpack(stats)))


def _load_unpacked(net, state):
    """Load a ``state_dict`` of the wrapped module's own names into the
    PackedModule ``net`` in place: the tensors the optimizer holds stay
    the same objects."""
    views = net.views()
    own = dict(net.module.state_dict(keep_vars=True))
    assert set(state) == set(views) | set(own)
    with torch.no_grad():
        for k, v in state.items():
            (views[k] if k in views else own[k]).copy_(v)


def test_packed_step_matches_jax_packed_step():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch.image_step import build_image_step

    t = image_step_test
    want_losses, params, stats = _jax_packed_run()
    hvd.init(device="cpu")
    try:
        with t._narrow():
            net, step, _ = build_image_step(
                "cpu", model="resnet_narrow", batch=t.BATCH, image=t.SIDE,
                num_classes=t.CLASSES, dtype=torch.float32, fused_ema=True,
                lr=t.LR, packed=True)
        assert isinstance(net, PackedModule)
        _load_unpacked(net, t._port_state(True))
        data = t._torch_batch()
        losses = [step(data).item() for _ in range(t.STEPS)]
        state = net.unpacked_state_dict()
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert want_losses[-1] < want_losses[0]
    t._hold_state(state, params, stats)
