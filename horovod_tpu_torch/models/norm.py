"""Batch normalization of the image models, with flax's semantics.

Counterpart of ``horovod_tpu/models/norm.py`` and of the flax
``nn.BatchNorm`` the JAX models use.  :class:`BatchNorm` normalizes an
NCHW tensor over (batch, height, width) in one of two modes:

* ``fused_ema=False`` — flax ``nn.BatchNorm``: the module applies the
  running-stats EMA itself, ``new = momentum * old + (1 - momentum) *
  batch``, momentum on the old value (PyTorch's ``momentum=0.1`` means the
  other side of it), variance clipped at 0.
* ``fused_ema=True`` — ``BatchStatsNorm``: the module keeps the raw batch
  statistics of its last training forward (``batch_mean``,
  ``batch_var``), and the training step applies the EMA over every
  module at once with :func:`ema_batch_stats`.

Both take the statistics in float32 as mean = E[x] and var = E[x^2] -
E[x]^2 (the biased variance: ``nn.BatchNorm2d``'s unbiased running
variance is not flax's), fold them into per-channel coefficients a =
rsqrt(var + eps) * weight and b = bias - mean * a in float32, and apply
x * a + b in the compute dtype.  ``weight``/``bias`` are the flax
``scale``/``bias`` parameters, ``running_mean``/``running_var`` its
``mean``/``var`` batch stats, all float32.

Cross-replica statistics: with ``axis_name`` set and more than one
worker, mean and E[x^2] are averaged across the engine's workers inside
the forward (:class:`_CrossReplicaMean`, one allreduce of the two stacked
per layer), the counterpart of ``lax.pmean(..., axis_name)`` under
``shard_map``.  Its backward averages the cotangent across workers too:
in the JAX step the statistics are invariant across the mapped axis and
feed every worker's loss, so their cotangent is summed over the axis
before the pmean's transpose divides it by the axis size; each worker's
gradient then holds the other workers' losses' dependence on its own
activations, and ``DistributedOptimizer``'s average of the parameter
gradients is the gradient of the mean loss.  With one worker (or no
engine) the statistics are the local ones, as a pmean over an axis of
size 1.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from horovod_tpu_torch import common as _common


class _CrossReplicaMean(torch.autograd.Function):
    """The workers' mean of ``stats`` (named ``name``), and of the
    cotangent in the backward (``name + ".grad"``); the host seconds of
    each go to ``norm.sync_sec`` as ``("fwd" or "bwd", seconds)``."""

    @staticmethod
    def forward(ctx, stats, name, norm):
        from horovod_tpu_torch.torch.mpi_ops import allreduce_async

        ctx.name, ctx.norm = name, norm
        t0 = time.perf_counter()
        out = allreduce_async(stats.contiguous(), True, name).synchronize()
        norm.sync_sec.append(("fwd", time.perf_counter() - t0))
        return out

    @staticmethod
    def backward(ctx, g):
        from horovod_tpu_torch.torch.mpi_ops import allreduce_async

        t0 = time.perf_counter()
        out = allreduce_async(g.contiguous(), True,
                              f"{ctx.name}.grad").synchronize()
        ctx.norm.sync_sec.append(("bwd", time.perf_counter() - t0))
        return out, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (``fused_ema=False``) or ``BatchStatsNorm``
    (``fused_ema=True``) over the channels of an NCHW tensor; see the
    module docstring.  ``zero_scale`` starts ``weight`` at 0 (the last BN
    of a residual block).  ``stats_name`` names the cross-replica
    allreduces; the models set it to the module's path."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.bfloat16,
                 axis_name: Optional[str] = None, fused_ema: bool = False,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.axis_name, self.fused_ema = axis_name, fused_ema
        self.weight = nn.Parameter(
            (torch.zeros if zero_scale else torch.ones)(features,
                                                        device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features,
                                                       device=device))
        self.batch_mean: Optional[torch.Tensor] = None
        self.batch_var: Optional[torch.Tensor] = None
        self.stats_name: Optional[str] = None
        self.sync_sec: List[Tuple[str, float]] = []

    def _batch_stats(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        # flax BN reduces in at least float32; BatchStatsNorm in float32.
        xf = x.float() if self.fused_ema else x.to(
            torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        mean, mean2 = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
        if (self.axis_name is not None and _common.is_initialized()
                and _common.size() > 1):
            if self.stats_name is None:
                raise ValueError("cross-replica BatchNorm needs a "
                                 "stats_name, the same on every worker "
                                 "(name_norms(model) sets each to its "
                                 "path)")
            name = f"{self.axis_name}.{self.stats_name}"
            mean, mean2 = _CrossReplicaMean.apply(
                torch.stack([mean, mean2]), name, self).unbind(0)
        var = mean2 - mean * mean
        if not self.fused_ema:
            var = torch.clamp_min(var, 0.0)
        return mean, var

    def forward(self, x):
        if self.training:
            mean, var = self._batch_stats(x)
            if self.fused_ema:
                self.batch_mean, self.batch_var = mean.detach(), var.detach()
            else:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * a
        shape = (1, -1, 1, 1)
        return (x.to(self.dtype) * a.to(self.dtype).view(shape)
                + b.to(self.dtype).view(shape))


class BatchStatsNorm(BatchNorm):
    """:class:`BatchNorm` with ``fused_ema=True``: the JAX package's
    ``BatchStatsNorm``."""

    def __init__(self, features: int, **kw):
        super().__init__(features, fused_ema=True, **kw)


def name_norms(model: nn.Module) -> None:
    """Give every :class:`BatchNorm` in ``model`` its path as
    ``stats_name``, so its cross-replica allreduces carry the same name on
    every worker."""
    for path, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.stats_name = path


def batch_norms(model: nn.Module) -> List[BatchNorm]:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def take_sync_sec(model: nn.Module) -> Dict[str, float]:
    """``{"fwd": s, "bwd": s, "calls": n}``: the host seconds every BN of
    ``model`` spent in its cross-replica allreduces since the last call,
    and their number; the records are cleared."""
    out = {"fwd": 0.0, "bwd": 0.0, "calls": 0}
    for m in batch_norms(model):
        for direction, sec in m.sync_sec:
            out[direction] += sec
            out["calls"] += 1
        m.sync_sec.clear()
    return out


def running_stats(model: nn.Module) -> List[torch.Tensor]:
    """Every BN's ``running_mean`` and ``running_var``, in module order."""
    return [t for m in batch_norms(model)
            for t in (m.running_mean, m.running_var)]


def last_batch_stats(model: nn.Module) -> List[torch.Tensor]:
    """Every fused-EMA BN's raw statistics of its last training forward,
    in the order of :func:`running_stats`."""
    out = []
    for m in batch_norms(model):
        if m.batch_mean is None:
            raise RuntimeError("ema_batch_stats: a BatchNorm has no batch "
                               "statistics (not fused_ema, or no training "
                               "forward yet)")
        out += [m.batch_mean, m.batch_var]
    return out


def ema_batch_stats(old_stats: Sequence[torch.Tensor],
                    batch_stats: Sequence[torch.Tensor],
                    momentum: float = 0.9) -> Sequence[torch.Tensor]:
    """Counterpart of ``horovod_tpu.models.ema_batch_stats``: ``old =
    momentum * old + (1 - momentum) * batch`` over every stats tensor at
    once, in place on ``old_stats`` (returned), a sequence of tensors with
    ``batch_stats`` in the same order (:func:`running_stats`,
    :func:`last_batch_stats`).  Two foreach kernels over the whole list,
    not two per layer."""
    old, new = list(old_stats), list(batch_stats)
    if len(old) != len(new):
        raise ValueError("ema_batch_stats: the two lists differ")
    with torch.no_grad():
        torch._foreach_mul_(old, momentum)
        torch._foreach_add_(old, new, alpha=1.0 - momentum)
    return old_stats
