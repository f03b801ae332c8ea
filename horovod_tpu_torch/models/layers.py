"""Layers of the image models with flax's semantics, over NCHW tensors.

The image models keep PyTorch's NCHW shapes in ``channels_last`` memory,
which is the NHWC layout the JAX package computes in.  What these layers
carry over from flax, where PyTorch's own modules differ:

* ``padding="SAME"`` pads ``total = max((out - 1) * stride + k - n, 0)``
  with ``total // 2`` before and the rest after (:func:`same_pads`): at
  stride 2 on an even size that is asymmetric, (0, 1) for a 3 x 3 window
  and (2, 3) for the 7 x 7 stem, which PyTorch's symmetric ``padding=``
  cannot express (it gives the same output size over shifted windows).
  Max pooling pads with -inf, average pooling with zeros that count.
* Parameters are float32 and contiguous; a layer computes in its
  ``dtype``, the input and the weight cast to it (flax's ``dtype=`` with
  float32 params), channels_last on the card.
* Initial weights: flax's ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1 / fan_in) and zero biases, drawn from
  a ``torch.Generator``; ``device="meta"`` builds the shapes alone.

:class:`Conv2d` holds the flax kernel (kh, kw, in, out) as ``weight``
(out, in, kh, kw) and :class:`Dense` the kernel (in, out) as ``weight``
(out, in); :mod:`.convert` transposes between them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Size2 = Union[int, Tuple[int, int]]


def _pair(x: Size2) -> Tuple[int, int]:
    return (x, x) if isinstance(x, int) else tuple(x)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of flax/XLA ``"SAME"`` along one axis of
    ``size`` for a window of ``kernel`` at ``stride``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: Tuple[int, int], stride: Tuple[int, int],
              value: float = 0.0):
    """``x`` padded as ``"SAME"`` pads it (``value`` in the padding), in
    ``x``'s memory format."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], kernel[0], stride[0]),
                          same_pads(x.shape[3], kernel[1], stride[1]))
    if not (ht or hb or wl or wr):
        return x
    y = F.pad(x, (wl, wr, ht, hb), value=value)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def lecun_normal(shape: Sequence[int], fan_in: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at two standard
    deviations, rescaled to variance 1 / fan_in."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(device)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over NCHW: ``padding`` ``"SAME"`` (flax's,
    :func:`same_pads`) or ``"VALID"``, computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Size2,
                 stride: Size2 = 1, padding: str = "SAME", bias: bool = False,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        self.kernel, self.stride = _pair(kernel), _pair(stride)
        self.padding, self.dtype = padding, dtype
        kh, kw = self.kernel
        self.weight = nn.Parameter(lecun_normal(
            (out_ch, in_ch, kh, kw), in_ch * kh * kw, generator, device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        # The parameter stays contiguous (the engine's in-place allreduce
        # of its gradient needs that); on the card the compute-dtype copy
        # is channels_last, as the activations are.  PyTorch's CPU
        # convolution returns a wrong weight gradient on some
        # channels_last shapes (1 x 1 / 2 from 8 to 16 channels at 16 x
        # 16, torch 2.13), so the CPU path computes in NCHW.
        cpu = x.device.type == "cpu"
        fmt = torch.contiguous_format if cpu else torch.channels_last
        x = x.to(self.dtype, memory_format=fmt)
        w = self.weight.to(self.dtype, memory_format=fmt)
        pad = (0, 0)
        if self.padding == "SAME":
            pads = [same_pads(n, k, s) for n, k, s in
                    zip(x.shape[2:], self.kernel, self.stride)]
            if all(lo == hi for lo, hi in pads):
                pad = (pads[0][0], pads[1][0])
            else:
                x = _pad_same(x, self.kernel, self.stride)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, bias, self.stride, pad)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(lecun_normal(
            (out_features, in_features), in_features, generator, device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def max_pool(x, kernel: Size2, stride: Size2, padding: str = "VALID"):
    """flax ``nn.max_pool``; ``"SAME"`` pads with -inf."""
    kernel, stride = _pair(kernel), _pair(stride)
    if padding == "SAME":
        x = _pad_same(x, kernel, stride, float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def avg_pool_same(x, kernel: int = 3):
    """flax ``nn.avg_pool(x, (k, k), (1, 1), "SAME")``: the padded zeros
    count in every window (``count_include_pad``)."""
    return F.avg_pool2d(x, kernel, 1, kernel // 2, count_include_pad=True)


def flatten_hwc(x):
    """(b, c, h, w) flattened in (h, w, c) order, as flax flattens NHWC:
    free for a ``channels_last`` tensor."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def global_mean(x):
    """``jnp.mean(x, axis=(1, 2))`` of NHWC: summed in at least float32,
    returned in ``x``'s dtype."""
    return x.mean(dim=(2, 3), dtype=torch.promote_types(
        x.dtype, torch.float32)).to(x.dtype)
