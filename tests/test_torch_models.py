"""horovod_tpu_torch's image models against horovod_tpu's flax models, on
the CPU.

Each model is built at a width the CPU runs in a second or two, its flax
twin initialised, every parameter and batch stat moved off its initial
value with numpy (so the zero-scale last BN of a residual block does not
hide the convs behind it), and the tree converted into the port's
``state_dict`` (``models.convert.from_flax_variables``).  Both take the
same seeded numpy images (NHWC for flax, the same memory as NCHW
``channels_last`` for the port) and the same cotangent on the logits, in
training mode with dropout inactive (flax through an interceptor that
passes ``nn.Dropout`` by, the port with its ``nn.Dropout`` modules in
eval mode; the port's dropout is checked on its own).

The images are standard normal, centred as a normalizing input pipeline
leaves them.  On uncentred images (uniform in [0, 1), as the bench draws
them) E[x^2] - E[x]^2 cancels in the stem's BN, and XLA's float32
reductions are visibly off their own float64 result there (on the first
blocks' gradients of the ResNet at 63 x 63, fused or not), while
PyTorch's float32 agrees with its float64; a parity test there would
hold the port against the reference's rounding.
Tolerances, float32: logits within 5e-5 of the largest logit, every
gradient within 2e-4 of its largest element, updated batch stats within
1e-5 of the layer's largest E[x^2] (var = E[x^2] - E[x]^2 cancels, so its
error scales with E[x^2]); measured at most 1.2e-5, 5e-5 and 3e-6 (the
two sides sum in different orders, through up to 16 layers).
bfloat16: 4e-2 for logits, gradients and stats (the two frameworks round
activations at different places; 8 bits of mantissa).  The SAME padding
helpers are held at even and odd sizes against flax's ``nn.Conv``,
``nn.max_pool`` and ``nn.avg_pool``; ``ema_batch_stats`` against the
JAX package's (1e-7 relative: one rounding); the parameter counts
against the bounds of tests/test_models.py.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jm
from horovod_tpu.models import inception as jinception
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch import models as tm
from horovod_tpu_torch.models import layers as tl
from horovod_tpu_torch.models import norm as tnorm
from horovod_tpu_torch.models.convert import from_flax_variables


def _perturb(tree, seed):
    """Every leaf of a flax params / batch_stats tree moved off its initial
    value: scales near 1, biases and means near 0, variances in [0.5,
    1.5), kernels kept at their own scale."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.2 * noise
        if name in ("bias", "mean"):
            return 0.1 * noise
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        return x + 0.2 * x.std() * noise

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _flax_run(fmodel, params, stats, x, ct):
    """(logits, param grads, updated batch stats) of one training-mode
    forward and the backward of sum(logits * ct), as numpy float32."""
    def f(p):
        variables = {"params": p}
        if stats is not None:
            variables["batch_stats"] = stats
        with fnn.intercept_methods(_no_dropout):
            out = fmodel.apply(variables, x, train=True,
                               mutable=["batch_stats"])
        logits, upd = out
        return (logits.astype(jnp.float32) * ct).sum(), (logits, upd)

    (_, (logits, upd)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    return (np.asarray(logits, np.float32), jax.device_get(grads),
            jax.device_get(upd.get("batch_stats")))


def _port_run(model, x, ct):
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last NCHW
    assert xt.is_contiguous(memory_format=torch.channels_last)
    out = model(xt)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    return out.detach().float().numpy()


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _hold(model, fmodel, x, seed, fused=False, rel=(5e-5, 2e-4, 1e-5),
          f64=False):
    """The port's model against the flax model on converted weights:
    logits, every parameter gradient and the updated batch stats (the
    running stats after the module's EMA, or the raw batch stats of the
    fused-EMA mode), within ``rel`` of each output's largest value.  With
    ``f64`` both run in float64 (``model`` built with that dtype; the
    heads stay float32 on both sides, as the models fix them)."""
    variables = fmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                            train=False)
    params = _perturb(variables["params"], seed)
    stats = (_perturb(variables["batch_stats"], seed + 1)
             if "batch_stats" in variables else None)
    model.load_state_dict(from_flax_variables(model, params, stats),
                          strict=True)
    ct = np.random.RandomState(seed + 2).standard_normal(
        (x.shape[0], fmodel.num_classes)).astype(np.float32)
    if f64:
        model.double()
        with jax.enable_x64(True):
            cast = functools.partial(jax.tree_util.tree_map,
                                     lambda a: jnp.asarray(a, jnp.float64))
            logits, grads, upd = _flax_run(
                fmodel.clone(dtype=jnp.float64), cast(params),
                None if stats is None else cast(stats),
                jnp.asarray(x, jnp.float64), jnp.asarray(ct))
    else:
        logits, grads, upd = _flax_run(fmodel, params, stats,
                                       jnp.asarray(x), jnp.asarray(ct))
    got = _port_run(model, x, ct)
    _close(got, logits, rel[0], "logits")
    want = from_flax_variables(model, grads)
    names = {n for n, _ in model.named_parameters()}
    assert set(want) == names
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), rel[1], name)
    if stats is not None:
        want = from_flax_variables(model, params, upd)
        for prefix_norm in [n for n, m in model.named_modules()
                            if isinstance(m, tnorm.BatchNorm)]:
            m = model.get_submodule(prefix_norm)
            if fused:
                pairs = ((m.batch_mean, "running_mean"),
                         (m.batch_var, "running_var"))
            else:
                pairs = ((m.running_mean, "running_mean"),
                         (m.running_var, "running_var"))
            # var = E[x^2] - E[x]^2 cancels: its error scales with E[x^2].
            w_mean = want[f"{prefix_norm}.running_mean"].numpy()
            w_var = want[f"{prefix_norm}.running_var"].numpy()
            scale = float(np.max(np.abs(w_var) + w_mean ** 2))
            for t, key in pairs:
                err = float(np.abs(t.numpy() - want[
                    f"{prefix_norm}.{key}"].numpy()).max())
                assert err <= rel[2] * scale, (prefix_norm, key, err, scale)
    return model


def _images(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# SAME padding and the pools, at even and odd sizes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)), (225, 7, 2, (3, 3)), (112, 3, 2, (0, 1)),
    (7, 3, 2, (1, 1)), (56, 1, 2, (0, 0)), (35, 3, 1, (1, 1)),
    (17, 7, 1, (3, 3)), (64, 3, 2, (0, 1))])
def test_same_pads(size, k, s, want):
    assert tl.same_pads(size, k, s) == want


@pytest.mark.parametrize("size", [8, 9, 10, 15])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (7, 2), (1, 2), ((1, 7), 1)])
def test_conv_same_matches_flax(size, k, s):
    """Conv2d "SAME" against flax nn.Conv on the same weights: asymmetric
    (0, 1) / (2, 3) padding at stride 2 on even sizes, symmetric at odd."""
    kk = (k, k) if isinstance(k, int) else k
    x = np.random.RandomState(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    conv = fnn.Conv(4, kk, (s, s), padding="SAME", use_bias=True)
    v = conv.init(jax.random.PRNGKey(0), x)
    v = _perturb(v, 1)
    want = np.asarray(conv.apply(v, x))
    port = tl.Conv2d(3, 4, kk, s, "SAME", bias=True)
    port.weight.data = torch.from_numpy(
        np.transpose(np.asarray(v["params"]["kernel"]), (3, 2, 0, 1)).copy())
    port.bias.data = torch.from_numpy(np.asarray(v["params"]["bias"]))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).detach()
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5, "conv")


@pytest.mark.parametrize("size", [8, 9, 14, 15])
def test_pools_match_flax(size):
    """max_pool 3x3/2 SAME (padded with -inf: the inputs are all negative
    so a zero pad would show), max_pool VALID, avg_pool 3x3/1 SAME
    counting the padded zeros."""
    x = -1.0 - np.random.RandomState(size).rand(2, size, size, 3).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    back = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    _close(back(tl.max_pool(xt, 3, 2, "SAME")),
           np.asarray(fnn.max_pool(x, (3, 3), (2, 2), "SAME")), 0, "max")
    _close(back(tl.max_pool(xt, 3, 2)),
           np.asarray(fnn.max_pool(x, (3, 3), (2, 2), "VALID")), 0, "valid")
    _close(back(tl.avg_pool_same(xt)),
           np.asarray(fnn.avg_pool(x, (3, 3), (1, 1), "SAME")), 1e-6, "avg")


# ---------------------------------------------------------------------------
# The models.
# ---------------------------------------------------------------------------

_SMALL = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("block,size,small", [
    ("bottleneck", 32, True), ("bottleneck", 64, False),
    ("bottleneck", 63, False), ("basic", 32, True)])
def test_resnet_matches_flax(block, size, small, fused):
    """ResNet at stage sizes [1, 1, 1, 1] and 8 filters: the 3x3 stem at
    32 (small_inputs), the 7x7/2 stem with its SAME max pool at 64 (the
    flax side's space-to-depth path) and 63 (its plain conv), both BN
    modes, bottleneck and basic blocks."""
    jblock = jm.resnet.BottleneckBlock if block == "bottleneck" else \
        jm.resnet.BasicBlock
    tblock = tm.resnet.BottleneckBlock if block == "bottleneck" else \
        tm.resnet.BasicBlock
    kw = dict(_SMALL, small_inputs=small, fused_ema=fused)
    fmodel = jm.ResNet(block_cls=jblock, dtype=jnp.float32, **kw)
    model = tm.ResNet(block_cls=tblock, dtype=torch.float32, **kw)
    _hold(model, fmodel, _images((3, size, size, 3), size), seed=size,
          fused=fused)


def test_resnet_bf16_matches_flax():
    """The bench's mode (bf16 body, f32 head, fused EMA): logits within
    4e-2 of the flax bf16 model's largest (measured 1.3e-2), raw batch
    stats within 4e-2 of the layer's largest E[x^2].  bf16 gradients of a
    BN net are far off the float32 ones in both frameworks (the flax bf16
    model's BN bias gradients by more than their own size), so each
    gradient is held to be no further from the float32 flax gradient than
    twice the flax bf16 model's own distance plus 5% of its largest
    element."""
    kw = dict(_SMALL, small_inputs=True, fused_ema=True)
    x = _images((4, 32, 32, 3), 5)
    ct = np.random.RandomState(7).standard_normal((4, 10)).astype(np.float32)
    f32 = jm.ResNet(block_cls=jm.resnet.BottleneckBlock, dtype=jnp.float32,
                    **kw)
    variables = f32.init(jax.random.PRNGKey(5), jnp.asarray(x), train=False)
    params = _perturb(variables["params"], 5)
    stats = _perturb(variables["batch_stats"], 6)
    _, g32, _ = _flax_run(f32, params, stats, jnp.asarray(x),
                          jnp.asarray(ct))
    l16, g16, upd16 = _flax_run(f32.clone(dtype=jnp.bfloat16), params,
                                stats, jnp.asarray(x), jnp.asarray(ct))
    model = tm.ResNet(block_cls=tm.resnet.BottleneckBlock,
                      dtype=torch.bfloat16, **kw)
    model.load_state_dict(from_flax_variables(model, params, stats))
    got = _port_run(model, x, ct)
    _close(got, l16, 4e-2, "logits")
    w32, w16 = (from_flax_variables(model, g) for g in (g32, g16))
    for name, p in model.named_parameters():
        scale = float(w32[name].abs().max())
        ref_err = float((w16[name] - w32[name]).abs().max())
        err = float((p.grad - w32[name]).abs().max())
        assert err <= 2 * ref_err + 0.05 * scale, (name, err, ref_err)
    want = from_flax_variables(model, params, upd16)
    for path, m in model.named_modules():
        if isinstance(m, tnorm.BatchNorm):
            mean = want[f"{path}.running_mean"].numpy()
            var = want[f"{path}.running_var"].numpy()
            scale = float(np.max(np.abs(var) + mean ** 2))
            for t, w in ((m.batch_mean, mean), (m.batch_var, var)):
                assert float(np.abs(t.numpy() - w).max()) <= 4e-2 * scale


def test_vgg_matches_flax():
    """VGG-11 at 32 x 32 (the fc1 input flattened in (h, w, c) order)."""
    fmodel = jvgg.VGG(stage_convs=jvgg._CFG["vgg11"], num_classes=10,
                      dtype=jnp.float32)
    model = tm.vgg.VGG(stage_convs=tm.vgg._CFG["vgg11"], num_classes=10,
                       dtype=torch.float32, image=32)
    _hold(model, fmodel, _images((2, 32, 32, 3), 7), seed=7)


def test_vgg_fc1_takes_hwc_order():
    """A 2 x 2 x 512 feature map: fc1 must see it flattened in (h, w, c)
    order, so permuting channels and positions differ."""
    x = torch.arange(2 * 512 * 2 * 2, dtype=torch.float32).reshape(
        2, 2, 2, 512).permute(0, 3, 1, 2)
    flat = tl.flatten_hwc(x)
    np.testing.assert_array_equal(
        flat.numpy(), x.permute(0, 2, 3, 1).reshape(2, -1).numpy())
    assert flat[0, 1].item() == x[0, 1, 0, 0].item()


def test_inception_matches_flax():
    """InceptionV3 at full width on 75 x 75 images (the smallest its
    VALID convs and reductions take), BN eps 1e-3 in the module.  In
    float64: at this size InceptionC's BNs see 2 values per channel (1 x 1
    maps, batch 2), and float32 is ill-conditioned there in both
    frameworks (each visibly off its own float64 logits, while the two
    agree in float64 to the tolerance below)."""
    fmodel = jinception.InceptionV3(num_classes=10, dtype=jnp.float32)
    model = tm.InceptionV3(num_classes=10, dtype=torch.float64)
    _hold(model, fmodel, _images((2, 75, 75, 3), 9), seed=9, f64=True,
          rel=(1e-5, 1e-4, 1e-5))


def test_mnist_matches_flax():
    fmodel = jm.MnistCNN(num_classes=10)
    model = tm.MnistCNN(num_classes=10)
    _hold(model, fmodel, _images((3, 28, 28, 1), 11), seed=11)


def test_port_dropout_keeps_its_share_and_scale():
    """The port's dropout (PyTorch's; the frameworks draw different masks,
    so it is held alone): kept share 1 - p within 4 sigma, kept values
    scaled by 1 / (1 - p)."""
    torch.manual_seed(0)
    for p in (0.25, 0.5):
        d = torch.nn.Dropout(p)
        d.train()
        y = d(torch.ones(200_000))
        kept = (y != 0).float().mean().item()
        assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / 2e5)
        np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p),
                                   rtol=1e-6)


def test_ema_batch_stats_matches_jax():
    rng = np.random.RandomState(3)
    old = {f"l{i}": {"mean": rng.standard_normal(5).astype(np.float32),
                     "var": rng.rand(5).astype(np.float32)}
           for i in range(3)}
    new = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32), old)
    want = jax.device_get(jm.ema_batch_stats(old, new, 0.9))
    flat = lambda t: [torch.from_numpy(np.array(t[k][s]))  # noqa: E731
                      for k in sorted(t) for s in ("mean", "var")]
    got = flat(old)
    assert tm.ema_batch_stats(got, flat(new), 0.9) is got
    for g, w in zip(got, flat(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-7,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="differ"):
        tm.ema_batch_stats(got, flat(new)[1:])


def test_batch_stats_norm_keeps_raw_stats():
    """BatchStatsNorm is the fused-EMA mode: its running stats stay until
    ema_batch_stats, its raw statistics are E[x] and E[x^2] - E[x]^2."""
    norm = tm.BatchStatsNorm(3, dtype=torch.float32)
    x = torch.from_numpy(_images((4, 5, 5, 3), 1)).permute(0, 3, 1, 2)
    norm.train()
    norm(x)
    assert norm.fused_ema and torch.equal(norm.running_mean, torch.zeros(3))
    xd = x.double()
    mean = xd.mean((0, 2, 3))
    np.testing.assert_allclose(norm.batch_mean.numpy(), mean.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        norm.batch_var.numpy(),
        (xd.square().mean((0, 2, 3)) - mean.square()).numpy(),
        rtol=1e-5, atol=1e-6)


def _count(model):
    return sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name,lo,hi", [
    ("ResNet50", 25.4e6, 25.8e6), ("VGG16", 138.0e6, 138.7e6),
    ("InceptionV3", 23.0e6, 24.5e6)])
def test_param_counts_within_the_reference_bounds(name, lo, hi):
    """Parameter counts within tests/test_models.py's bounds, and equal to
    the flax model's own count."""
    model = getattr(tm, name)(num_classes=1000, device="meta")
    n = _count(model)
    assert lo < n < hi, n
    side = 299 if name == "InceptionV3" else 224
    fmodel = getattr(jm, name)(num_classes=1000)
    variables = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, side, side, 3)), train=False))
    assert n == sum(int(np.prod(x.shape)) for x in
                    jax.tree_util.tree_leaves(variables["params"]))


@pytest.mark.parametrize("name,side", [("ResNet50", 224), ("ResNet18", 224),
                                       ("InceptionV3", 299), ("VGG11", 32),
                                       ("MnistCNN", 28)])
def test_converted_layout_covers_every_weight(name, side):
    """from_flax_variables maps every flax leaf onto a port parameter or
    buffer of the same shape, and covers the whole state_dict (the port
    model on the meta device)."""
    kw = {} if name == "MnistCNN" else {"num_classes": 1000}
    model = getattr(tm, name)(device="meta", **kw,
                              **({"image": side} if "VGG" in name else {}))
    fmodel = getattr(jm, name)(**kw)
    ch = 1 if name == "MnistCNN" else 3
    variables = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, side, side, ch)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), variables)
    sd = from_flax_variables(model, zeros)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
