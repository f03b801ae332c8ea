"""ResNet family (v1.5) in PyTorch.

Counterpart of ``horovod_tpu/models/resnet.py`` (``BottleneckBlock``,
``BasicBlock``, ``SpaceToDepthStem``, ``ResNet``, ResNet18/34/50/101/152)
over NCHW images in ``channels_last`` memory.  Parameters are float32 and
the body computes in ``dtype`` (bf16 by default); the head is float32.

* The stem is the plain 7 x 7 / 2 ``"SAME"`` conv with the (7, 7, 3, F)
  weight of ``SpaceToDepthStem``, which computes the same function (its
  space-to-depth rewrite exists for the TPU's matrix unit); at even sizes
  its padding is (2, 3), not PyTorch's symmetric 3.  ``small_inputs``
  takes a 3 x 3 / 1 stem and no max pool, as the reference does.
* The stride sits on the 3 x 3 conv (v1.5); a block whose output shape
  differs from its input's projects the shortcut (``conv_proj`` +
  ``norm_proj``); the last BN of each block starts with zero scale.
* ``fused_ema`` and ``axis_name`` go to every :class:`~.norm.BatchNorm`
  (eps 1e-5, momentum 0.9): the step-level EMA, and cross-replica
  statistics through the engine.

Submodules: ``conv_init``, ``bn_init``, ``blocks[k]`` (``convs[i]``,
``norms[i]``, ``conv_proj``, ``norm_proj``), ``head``; :mod:`.convert`
maps the flax auto-names (``BottleneckBlock_3/Conv_1``, ...) onto them.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Conv2d, Dense, global_mean, \
    max_pool
from horovod_tpu_torch.models.norm import BatchNorm, name_norms


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x filters), projection shortcut."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, conv, norm):
        super().__init__()
        out = filters * 4
        self.convs = nn.ModuleList([conv(in_ch, filters, 1),
                                    conv(filters, filters, 3, stride),
                                    conv(filters, out, 1)])
        self.norms = nn.ModuleList([norm(filters), norm(filters),
                                    norm(out, zero_scale=True)])
        self.conv_proj = self.norm_proj = None
        if in_ch != out or stride != 1:
            self.conv_proj = conv(in_ch, out, 1, stride)
            self.norm_proj = norm(out)

    def forward(self, x):
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < len(self.convs) - 1:
                y = F.relu(y)
        residual = x if self.conv_proj is None else \
            self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(BottleneckBlock):
    """3x3 (stride) -> 3x3, projection shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, conv, norm):
        nn.Module.__init__(self)
        self.convs = nn.ModuleList([conv(in_ch, filters, 3, stride),
                                    conv(filters, filters, 3)])
        self.norms = nn.ModuleList([norm(filters),
                                    norm(filters, zero_scale=True)])
        self.conv_proj = self.norm_proj = None
        if in_ch != filters or stride != 1:
            self.conv_proj = conv(in_ch, filters, 1, stride)
            self.norm_proj = norm(filters)


class ResNet(nn.Module):
    """ResNet v1.5 over NCHW inputs (3 channels); returns float32 logits.
    ``axis_name`` enables cross-replica BatchNorm through the engine;
    leave None for per-worker statistics."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, num_filters: int = 64,
                 dtype=torch.bfloat16, axis_name: Optional[str] = None,
                 small_inputs: bool = False, fused_ema: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.stage_sizes, self.block_cls = list(stage_sizes), block_cls
        self.small_inputs, self.dtype = small_inputs, dtype
        conv = functools.partial(Conv2d, dtype=dtype, generator=generator,
                                 device=device)
        norm = functools.partial(BatchNorm, momentum=0.9, eps=1e-5,
                                 dtype=dtype, axis_name=axis_name,
                                 fused_ema=fused_ema, device=device)
        self.conv_init = conv(3, num_filters, 3 if small_inputs else 7,
                              1 if small_inputs else 2)
        self.bn_init = norm(num_filters)
        blocks, ch = [], num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(ch, filters, stride, conv, norm))
                ch = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(ch, num_classes, dtype=torch.float32,
                          generator=generator, device=device)
        name_norms(self)

    def forward(self, x):
        x = F.relu(self.bn_init(self.conv_init(x.to(self.dtype))))
        if not self.small_inputs:
            x = max_pool(x, 3, 2, "SAME")
        for block in self.blocks:
            x = block(x)
        return self.head(global_mean(x).float())


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
