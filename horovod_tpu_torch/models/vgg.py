"""VGG (configurations A/D/E = VGG-11/16/19) in PyTorch.

Counterpart of ``horovod_tpu/models/vgg.py``: 3 x 3 ``"SAME"`` convs with
biases over five stages of 64, 128, 256, 512 and 512 channels, each stage
closed by a 2 x 2 / 2 max pool; then 4096-4096-classes dense layers with
ReLU and dropout 0.5.  bf16 body with float32 params, float32 head.
``fc1`` takes the features flattened in (h, w, c) order, as flax flattens
NHWC, so its weight is the flax kernel transposed with no permutation of
rows.  Submodules ``convs[n]`` (flax ``conv{stage}_{i}``, in order),
``fc1``, ``fc2``, ``head``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Conv2d, Dense, flatten_hwc, \
    max_pool

_CFG = {
    "vgg11": (1, 1, 2, 2, 2),
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_CHANNELS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """Takes (b, 3, h, w) images (h, w multiples of 32); returns float32
    logits.  ``image`` sizes ``fc1``: 224 by default."""

    def __init__(self, stage_convs: Sequence[int], num_classes: int = 1000,
                 dtype=torch.bfloat16, image: int = 224, generator=None,
                 device=None):
        super().__init__()
        self.stage_convs, self.dtype = tuple(stage_convs), dtype
        kw = dict(dtype=dtype, generator=generator, device=device)
        convs, names, ch = [], [], 3
        for stage, n in enumerate(self.stage_convs):
            for i in range(n):
                convs.append(Conv2d(ch, _CHANNELS[stage], 3, bias=True, **kw))
                names.append(f"conv{stage}_{i}")
                ch = _CHANNELS[stage]
        self.convs = nn.ModuleList(convs)
        self.conv_names = names
        side = image >> len(self.stage_convs)
        self.fc1 = Dense(side * side * ch, 4096, **kw)
        self.fc2 = Dense(4096, 4096, **kw)
        self.head = Dense(4096, num_classes, dtype=torch.float32,
                          generator=generator, device=device)
        self.drop1, self.drop2 = nn.Dropout(0.5), nn.Dropout(0.5)

    def forward(self, x):
        x = x.to(self.dtype)
        n = 0
        for count in self.stage_convs:
            for _ in range(count):
                x = F.relu(self.convs[n](x))
                n += 1
            x = max_pool(x, 2, 2)
        x = self.drop1(F.relu(self.fc1(flatten_hwc(x))))
        x = self.drop2(F.relu(self.fc2(x)))
        return self.head(x.float())


VGG11 = functools.partial(VGG, stage_convs=_CFG["vgg11"])
VGG16 = functools.partial(VGG, stage_convs=_CFG["vgg16"])
VGG19 = functools.partial(VGG, stage_convs=_CFG["vgg19"])
