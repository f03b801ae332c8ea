"""Weights bridge between the JAX package's flax trees and the port's
``state_dict``: the ``TransformerLM`` (:func:`from_flax_params`,
:func:`to_flax_params`) and the image models (:func:`from_flax_variables`).

The port's modules hold their parameters in the flax shapes, so the map is
a rename, plus one transpose for the two MLP kernels that live in
``nn.Linear`` (``weight`` is ``kernel.T``):

================================  ==============================
flax path                          port parameter
================================  ==============================
``embed/embedding``                ``embed.weight``
``layer_i/attn_norm/scale``        ``layers.i.attn_norm.weight``
``layer_i/attn/qkv_kernel``        ``layers.i.attn.qkv_kernel``
``layer_i/attn/o_kernel``          ``layers.i.attn.o_kernel``
``layer_i/mlp_norm/scale``         ``layers.i.mlp_norm.weight``
``layer_i/up/kernel``              ``layers.i.up.weight`` (T)
``layer_i/down/kernel``            ``layers.i.down.weight`` (T)
``final_norm/scale``               ``final_norm.weight``
``lm_head_kernel``                 ``lm_head_kernel``
================================  ==============================
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER_MAP = {
    ("attn_norm", "scale"): ("attn_norm.weight", False),
    ("attn", "qkv_kernel"): ("attn.qkv_kernel", False),
    ("attn", "o_kernel"): ("attn.o_kernel", False),
    ("mlp_norm", "scale"): ("mlp_norm.weight", False),
    ("up", "kernel"): ("up.weight", True),
    ("down", "kernel"): ("down.weight", True),
}


def _tensor(a, transpose):
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def from_flax_params(tree) -> dict:
    """A flax ``params`` tree (nested dicts of arrays, e.g.
    ``jax.device_get(params)``; a ``{"params": ...}`` wrapper is accepted)
    to a ``state_dict`` that ``TransformerLM.load_state_dict(strict=True)``
    takes.  float32 CPU tensors.  A pipeline stage's slice of the tree
    (the reference's ``partition_params``) converts to the names of its
    ``TransformerStage``: only the entries present are converted."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    sd = {}
    if "embed" in tree:
        sd["embed.weight"] = _tensor(tree["embed"]["embedding"], False)
    if "final_norm" in tree:
        sd["final_norm.weight"] = _tensor(tree["final_norm"]["scale"], False)
    if "lm_head_kernel" in tree:
        sd["lm_head_kernel"] = _tensor(tree["lm_head_kernel"], False)
    layers = sorted((int(m.group(1)), key) for key in tree
                    if (m := re.fullmatch(r"layer_(\d+)", key)))
    for i, key in layers:
        sub = tree[key]
        for (mod, leaf), (name, transpose) in _LAYER_MAP.items():
            sd[f"layers.{i}.{name}"] = _tensor(sub[mod][leaf], transpose)
    return sd


def to_flax_params(state_dict) -> dict:
    """Inverse of :func:`from_flax_params`: a nested dict of float32 numpy
    arrays in the flax layout."""
    def arr(name, transpose=False):
        a = state_dict[name].detach().float().cpu().numpy()
        return np.ascontiguousarray(a.T if transpose else a)

    tree = {"embed": {"embedding": arr("embed.weight")},
            "final_norm": {"scale": arr("final_norm.weight")},
            "lm_head_kernel": arr("lm_head_kernel")}
    idx = sorted({int(m.group(1)) for key in state_dict
                  if (m := re.match(r"layers\.(\d+)\.", key))})
    for i in idx:
        layer = {}
        for (mod, leaf), (name, transpose) in _LAYER_MAP.items():
            layer.setdefault(mod, {})[leaf] = arr(f"layers.{i}.{name}",
                                                  transpose)
        tree[f"layer_{i}"] = layer
    return tree


# ---------------------------------------------------------------------------
# Image models.  A flax variables tree (``params`` and ``batch_stats``) maps
# onto the port's modules by structure: each port model yields (flax path,
# port prefix, kind) for its layers, the flax auto-names rebuilt from the
# module classes' counters.  Kinds: ``conv`` (kernel HWIO -> weight OIHW,
# bias), ``dense`` (kernel (in, out) -> weight (out, in), bias) and
# ``norm`` (scale, bias -> weight, bias; batch stats mean, var ->
# running_mean, running_var).
# ---------------------------------------------------------------------------


def _resnet_layers(model):
    from horovod_tpu_torch.models.resnet import BasicBlock

    yield ("conv_init",), "conv_init", "conv"
    yield ("bn_init",), "bn_init", "norm"
    cls = "BasicBlock" if model.block_cls is BasicBlock else \
        "BottleneckBlock"
    for k, block in enumerate(model.blocks):
        for i in range(len(block.convs)):
            yield (f"{cls}_{k}", f"Conv_{i}"), f"blocks.{k}.convs.{i}", \
                "conv"
            yield (f"{cls}_{k}", f"BatchNorm_{i}"), f"blocks.{k}.norms.{i}", \
                "norm"
        if block.conv_proj is not None:
            yield (f"{cls}_{k}", "conv_proj"), f"blocks.{k}.conv_proj", "conv"
            yield (f"{cls}_{k}", "norm_proj"), f"blocks.{k}.norm_proj", "norm"
    yield ("head",), "head", "dense"


def _conv_bn(path, prefix):
    yield path + ("Conv_0",), f"{prefix}.conv", "conv"
    yield path + ("BatchNorm_0",), f"{prefix}.bn", "norm"


def _inception_layers(model):
    for i in range(len(model.stem)):
        yield from _conv_bn((f"ConvBN_{i}",), f"stem.{i}")
    seen = {}
    for n, block in enumerate(model.blocks):
        cls = type(block).__name__
        name = f"{cls}_{seen.get(cls, 0)}"
        seen[cls] = seen.get(cls, 0) + 1
        for i in range(len(block.convs)):
            yield from _conv_bn((name, f"ConvBN_{i}"), f"blocks.{n}.convs.{i}")
    yield ("head",), "head", "dense"


def _vgg_layers(model):
    for n, name in enumerate(model.conv_names):
        yield (name,), f"convs.{n}", "conv"
    for name in ("fc1", "fc2", "head"):
        yield (name,), name, "dense"


def _mnist_layers(model):
    yield ("Conv_0",), "conv0", "conv"
    yield ("Conv_1",), "conv1", "conv"
    yield ("Dense_0",), "fc0", "dense"
    yield ("Dense_1",), "fc1", "dense"


def image_layers(model):
    """``(flax path, port prefix, kind)`` of every layer of an image model
    (ResNet, InceptionV3, VGG, MnistCNN) that holds weights."""
    from horovod_tpu_torch import models as M

    for cls, walk in ((M.ResNet, _resnet_layers),
                      (M.InceptionV3, _inception_layers),
                      (M.vgg.VGG, _vgg_layers), (M.MnistCNN, _mnist_layers)):
        if isinstance(model, cls):
            return list(walk(model))
    raise TypeError(f"no flax layout for {type(model).__name__}")


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def from_flax_variables(model, params, batch_stats=None) -> dict:
    """A flax image model's ``params`` tree (and ``batch_stats``, when
    given) as a ``state_dict`` of ``model``'s layout: float32 CPU tensors,
    conv kernels HWIO -> OIHW, dense kernels transposed, the batch stats
    as the BN buffers.  Without ``batch_stats`` the buffers are left out
    (a gradient tree maps the same way)."""
    if "params" in params and isinstance(params["params"], dict):
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    sd = {}
    for path, prefix, kind in image_layers(model):
        leaf = _leaf(params, path)
        if kind == "conv":
            sd[f"{prefix}.weight"] = _tensor(
                np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)),
                False)
        elif kind == "dense":
            sd[f"{prefix}.weight"] = _tensor(leaf["kernel"], True)
        else:
            sd[f"{prefix}.weight"] = _tensor(leaf["scale"], False)
            if batch_stats is not None:
                stats = _leaf(batch_stats, path)
                sd[f"{prefix}.running_mean"] = _tensor(stats["mean"], False)
                sd[f"{prefix}.running_var"] = _tensor(stats["var"], False)
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = _tensor(leaf["bias"], False)
    return sd
