"""MNIST convnet in PyTorch.

Counterpart of ``horovod_tpu/models/mnist.py`` (``MnistCNN``): two 3 x 3
``"VALID"`` convs (32, 64), a 2 x 2 max pool, dropout 0.25, a dense layer
of 128 over the features flattened in (h, w, c) order as flax flattens
NHWC, dropout 0.5 and a float32 head.  float32 throughout by default.
Submodules ``conv0``, ``conv1``, ``fc0``, ``fc1`` (flax ``Conv_0``,
``Conv_1``, ``Dense_0``, ``Dense_1``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Conv2d, Dense, flatten_hwc, \
    max_pool


class MnistCNN(nn.Module):
    """Takes (b, 1, 28, 28) images; returns float32 logits."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32,
                 generator=None, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.conv0 = Conv2d(1, 32, 3, padding="VALID", bias=True, **kw)
        self.conv1 = Conv2d(32, 64, 3, padding="VALID", bias=True, **kw)
        self.fc0 = Dense(12 * 12 * 64, 128, **kw)
        self.fc1 = Dense(128, num_classes, dtype=torch.float32,
                         generator=generator, device=device)
        self.drop0, self.drop1 = nn.Dropout(0.25), nn.Dropout(0.5)

    def forward(self, x):
        x = F.relu(self.conv0(x.to(self.dtype)))
        x = F.relu(self.conv1(x))
        x = self.drop0(max_pool(x, 2, 2))
        x = self.drop1(F.relu(self.fc0(flatten_hwc(x))))
        return self.fc1(x)
