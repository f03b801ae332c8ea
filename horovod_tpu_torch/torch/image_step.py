"""The image models' training step: the counterpart of ``bench.py``'s image
step and of ``examples/jax_imagenet_resnet50.py``'s data-parallel recipe.

One step is a forward in training mode on a fixed synthetic batch, softmax
cross-entropy with integer labels over float32 logits, the backward
(``DistributedOptimizer`` averaging the gradients through the engine) and
SGD with momentum 0.9 and no dampening (``optax.sgd(lr, momentum=0.9)``:
the buffer starts at the first gradient, then ``buf = 0.9 buf + g`` and
``p -= lr buf``).  The loss function returns the BN statistics as aux, so
:func:`~horovod_tpu_torch.torch.train.build_train_step` averages them
across workers after each step, as the JAX step's ``lax.pmean`` does; the
step then writes them back:

* ``fused_ema`` (the ResNets' default, as in ``bench.py``): the raw batch
  statistics, folded into the running stats by one
  :func:`~horovod_tpu_torch.models.ema_batch_stats` after the update;
* otherwise (flax ``nn.BatchNorm``, as the example trains): the running
  stats the modules updated themselves.

With ``axis_name`` the BN statistics are cross-replica inside the forward
(the example's ``axis_name="hvd"``); the workers' statistics are then
equal, and a data-parallel step on a split batch is the single-process
step on the whole batch.  ``broadcast_parameters(model.state_dict())`` and
``broadcast_optimizer_state`` run before the first step, so parameters
and buffers start, and stay, identical on every worker.

The batch is ``bench.py``'s: images ``RandomState(data_seed).rand(batch,
side, side, channels)`` made in NHWC with numpy and handed over as NCHW in
``channels_last`` memory (the same bytes), labels
``RandomState(data_seed + 1).randint(0, classes, batch)``.

With ``packed=True`` (``bench.py``'s image-step default, ``BENCH_PACKED``)
the model runs as a :class:`~horovod_tpu_torch.models.packing.PackedModule`:
its small float32 parameters (BN scales and biases, the head's bias) are
one ``nn.Parameter`` vector and its BN running statistics one buffer, so
``DistributedOptimizer``, the broadcasts and the allreduce of the
statistics see the big leaves plus one vector per tree (ResNet-50: 55
parameters in place of 161), and the fused EMA is one update of the
packed statistics by the packed batch statistics.

``RESNET_HEADLINE`` (ResNet-50, batch 64, 224 x 224, bf16, 1000 classes:
``BASELINE.json``'s metric) and ``RESNET101_HEADLINE`` (``bench.py``'s
default model) are shared by ``chip_smoke.py`` and the benchmarks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch import common as hvd
from horovod_tpu_torch import models as M
from horovod_tpu_torch.models import norm as norm_mod
from horovod_tpu_torch.models.packing import PackedModule
from horovod_tpu_torch.torch import (DistributedOptimizer,
                                     broadcast_optimizer_state,
                                     broadcast_parameters)
from horovod_tpu_torch.torch.train import build_train_step

RESNET_HEADLINE = dict(model="resnet50", batch=64, image=224,
                       num_classes=1000, dtype=torch.bfloat16)
RESNET101_HEADLINE = dict(RESNET_HEADLINE, model="resnet101")

MODELS = {"resnet18": M.ResNet18, "resnet34": M.ResNet34,
          "resnet50": M.ResNet50, "resnet101": M.ResNet101,
          "resnet152": M.ResNet152, "vgg16": M.VGG16,
          "inception_v3": M.InceptionV3, "mnist": M.MnistCNN}


def default_image(model: str) -> int:
    """``bench.py``'s image side: 299 for Inception, 28 for MNIST, 224
    otherwise."""
    return {"inception_v3": 299, "mnist": 28}.get(model, 224)


def build_image_model(model: str, *, num_classes: int, image: int,
                      dtype=torch.bfloat16, fused_ema: Optional[bool] = None,
                      axis_name: Optional[str] = None, seed: int = 0,
                      device=None):
    """The image model ``model`` (a key of ``MODELS``) with weights from
    ``torch.Generator().manual_seed(seed)`` on ``device`` (its convs
    compute in ``channels_last`` on the card).  ``fused_ema`` defaults to True for the ResNets, as
    ``bench.py`` sets it; ``axis_name`` reaches the BN layers of the
    ResNets and Inception."""
    if model not in MODELS:
        raise ValueError(f"unknown image model {model!r} ({list(MODELS)})")
    kw = dict(num_classes=num_classes, dtype=dtype,
              generator=torch.Generator().manual_seed(seed))
    if model.startswith("resnet"):
        kw.update(fused_ema=True if fused_ema is None else fused_ema,
                  axis_name=axis_name)
    elif model == "inception_v3":
        kw.update(axis_name=axis_name)
    elif model == "vgg16":
        kw.update(image=image)
    return MODELS[model](**kw).to(device)


def synthetic_batch(model: str, batch: int, image: int, num_classes: int,
                    data_seed: int = 0, rows=None, device=None):
    """``bench.py``'s fixed batch ``(images, labels)``, optionally only
    ``rows`` of it, on ``device``: images NCHW in ``channels_last``."""
    ch = 1 if model == "mnist" else 3
    images = np.random.RandomState(data_seed).rand(
        batch, image, image, ch).astype(np.float32)
    labels = np.random.RandomState(data_seed + 1).randint(
        0, num_classes, batch).astype(np.int64)
    if rows is not None:
        images, labels = images[rows], labels[rows]
    x = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2)
    return x.to(device), torch.from_numpy(labels).to(device)


def build_image_step(device=None, *, model: str = "resnet50", batch: int,
                     image: Optional[int] = None, num_classes: int = 1000,
                     dtype=torch.bfloat16, fused_ema: Optional[bool] = None,
                     axis_name: Optional[str] = None, lr: float = 0.1,
                     momentum: float = 0.9, seed: int = 0,
                     data_seed: Optional[int] = None, rows=None,
                     packed: bool = False):
    """``(model, step, data)``: ``step(data)`` is one training step on this
    worker's fixed batch ``data = (images, labels)`` and returns the mean
    loss across workers; ``hvd.init()`` comes first.  ``device=None`` means
    the CUDA device.  Every worker builds its weights from ``seed + rank``
    and its batch from ``data_seed + rank`` (``data_seed`` defaults to
    ``seed``); rank 0's weights, buffers and optimizer state are broadcast
    before the first step.  ``rows`` takes those rows of one batch drawn
    from ``data_seed`` on every worker instead.  ``step.train_step`` is
    the :func:`build_train_step` step (``sync_sec``, ``optimizer``).
    ``packed=True`` returns the model as a :class:`PackedModule` (its
    :meth:`~PackedModule.unpacked_state_dict` has the model's own
    names)."""
    rank, size = hvd.rank(), hvd.size()
    device = hvd.resolve_device(device)
    image = image or default_image(model)
    net = build_image_model(model, num_classes=num_classes, image=image,
                            dtype=dtype, fused_ema=fused_ema,
                            axis_name=axis_name, seed=seed + rank,
                            device=device)
    norms = norm_mod.batch_norms(net)
    fused = bool(norms) and norms[0].fused_ema
    if packed:
        net = PackedModule(net)
    opt = DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=lr, momentum=momentum),
        named_parameters=net.named_parameters())
    if size > 1:
        broadcast_parameters(net.state_dict(), root_rank=0)
        broadcast_optimizer_state(opt, root_rank=0)

    def loss_fn(m, b):
        loss = F.cross_entropy(m(b[0]).float(), b[1])
        if packed:
            stats = [_packed_batch_stats(m) if fused else m.stats]
        else:
            stats = (norm_mod.last_batch_stats(m) if fused
                     else norm_mod.running_stats(m))
        return loss, stats

    train_step = build_train_step(loss_fn, opt, net, has_aux=True)
    running = [net.stats] if packed else norm_mod.running_stats(net)

    def step(data):
        loss, stats = train_step(data)
        if fused:
            M.ema_batch_stats(running, stats, 0.9)
        elif running:
            with torch.no_grad():
                torch._foreach_copy_(running, stats)
        return loss

    step.train_step = train_step
    step.optimizer = opt
    seed_data = seed if data_seed is None else data_seed
    data = synthetic_batch(model, batch, image, num_classes,
                           seed_data if rows is not None
                           else seed_data + rank, rows, device)
    return net, step, data


def _packed_batch_stats(packed: PackedModule):
    """The raw batch statistics of every fused-EMA BN's last training
    forward, as one vector in the layout of ``packed.stats``."""
    stats = {}
    for path, m in packed.module.named_modules():
        if isinstance(m, norm_mod.BatchNorm):
            if m.batch_mean is None:
                raise RuntimeError("a BatchNorm has no batch statistics "
                                   "(no training forward yet)")
            prefix = f"{path}." if path else ""
            stats[prefix + "running_mean"] = m.batch_mean
            stats[prefix + "running_var"] = m.batch_var
    return packed.pack_buffers(stats)
