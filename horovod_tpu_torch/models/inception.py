"""Inception V3 in PyTorch.

Counterpart of ``horovod_tpu/models/inception.py``: the stem (299 x 299 x
3 -> 35 x 35 x 192), 3 x InceptionA, ReductionA, 4 x InceptionB,
ReductionB, 2 x InceptionC, a global mean, dropout 0.5 and a float32
head; no auxiliary classifier.  Every conv is a :class:`ConvBN`: a conv
without bias, flax ``nn.BatchNorm`` (eps 1e-3, momentum 0.9, the EMA in
the module) and ReLU.  The branch pools are ``avg_pool`` 3 x 3 / 1
``"SAME"``, whose padded zeros count.

Submodules: ``stem[i]`` (flax ``ConvBN_i``) and ``blocks[n]`` (flax
``InceptionA_0`` ... ``InceptionC_1``), each holding ``convs[i]`` (its
``ConvBN_i``, in creation order), and ``head``; :mod:`.convert` maps the
flax names onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Conv2d, Dense, avg_pool_same, \
    global_mean, max_pool
from horovod_tpu_torch.models.norm import BatchNorm, name_norms


class ConvBN(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding="SAME", *,
                 dtype, axis_name, generator, device):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding,
                           dtype=dtype, generator=generator, device=device)
        self.bn = BatchNorm(out_ch, momentum=0.9, eps=1e-3, dtype=dtype,
                            axis_name=axis_name, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _Block(nn.Module):
    """A block's ConvBN layers in creation order: ``specs`` holds (in, out,
    kernel, stride, padding) with ``in`` an int or the name of an earlier
    output."""

    def __init__(self, specs, in_ch, **kw):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBN(in_ch if i is None else i, o, k, s, p, **kw)
            for i, o, k, s, p in specs)


def _c(i, o, k, s=1, p="SAME"):
    return (i, o, k, s, p)


class InceptionA(_Block):
    def __init__(self, in_ch, pool_features, **kw):
        super().__init__([_c(None, 64, 1), _c(None, 48, 1), _c(48, 64, 5),
                          _c(None, 64, 1), _c(64, 96, 3), _c(96, 96, 3),
                          _c(None, pool_features, 1)], in_ch, **kw)
        self.out_ch = 64 + 64 + 96 + pool_features

    def forward(self, x):
        c = self.convs
        b1 = c[0](x)
        b5 = c[2](c[1](x))
        b3 = c[5](c[4](c[3](x)))
        bp = c[6](avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(_Block):
    def __init__(self, in_ch, **kw):
        super().__init__([_c(None, 384, 3, 2, "VALID"), _c(None, 64, 1),
                          _c(64, 96, 3), _c(96, 96, 3, 2, "VALID")],
                         in_ch, **kw)
        self.out_ch = 384 + 96 + in_ch

    def forward(self, x):
        c = self.convs
        b3 = c[0](x)
        bd = c[3](c[2](c[1](x)))
        return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=1)


class InceptionB(_Block):
    def __init__(self, in_ch, c7, **kw):
        super().__init__([_c(None, 192, 1), _c(None, c7, 1),
                          _c(c7, c7, (1, 7)), _c(c7, 192, (7, 1)),
                          _c(None, c7, 1), _c(c7, c7, (7, 1)),
                          _c(c7, c7, (1, 7)), _c(c7, c7, (7, 1)),
                          _c(c7, 192, (1, 7)), _c(None, 192, 1)],
                         in_ch, **kw)
        self.out_ch = 4 * 192

    def forward(self, x):
        c = self.convs
        b1 = c[0](x)
        b7 = c[3](c[2](c[1](x)))
        b77 = c[8](c[7](c[6](c[5](c[4](x)))))
        bp = c[9](avg_pool_same(x))
        return torch.cat([b1, b7, b77, bp], dim=1)


class ReductionB(_Block):
    def __init__(self, in_ch, **kw):
        super().__init__([_c(None, 192, 1), _c(192, 320, 3, 2, "VALID"),
                          _c(None, 192, 1), _c(192, 192, (1, 7)),
                          _c(192, 192, (7, 1)),
                          _c(192, 192, 3, 2, "VALID")], in_ch, **kw)
        self.out_ch = 320 + 192 + in_ch

    def forward(self, x):
        c = self.convs
        b3 = c[1](c[0](x))
        b7 = c[5](c[4](c[3](c[2](x))))
        return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=1)


class InceptionC(_Block):
    def __init__(self, in_ch, **kw):
        super().__init__([_c(None, 320, 1), _c(None, 384, 1),
                          _c(384, 384, (1, 3)), _c(384, 384, (3, 1)),
                          _c(None, 448, 1), _c(448, 384, 3),
                          _c(384, 384, (1, 3)), _c(384, 384, (3, 1)),
                          _c(None, 192, 1)], in_ch, **kw)
        self.out_ch = 320 + 4 * 384 + 192

    def forward(self, x):
        c = self.convs
        b1 = c[0](x)
        b3 = c[1](x)
        bd = c[5](c[4](x))
        bp = c[8](avg_pool_same(x))
        return torch.cat([b1, c[2](b3), c[3](b3), c[6](bd), c[7](bd), bp],
                         dim=1)


class InceptionV3(nn.Module):
    """Takes (b, 3, 299, 299) images; returns float32 logits."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 axis_name: Optional[str] = None, generator=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, axis_name=axis_name, generator=generator,
                  device=device)
        self.stem = nn.ModuleList([
            ConvBN(3, 32, 3, 2, "VALID", **kw),
            ConvBN(32, 32, 3, 1, "VALID", **kw),
            ConvBN(32, 64, 3, **kw),
            ConvBN(64, 80, 1, 1, "VALID", **kw),
            ConvBN(80, 192, 3, 1, "VALID", **kw)])
        blocks, ch = [], 192
        for make in (lambda c: InceptionA(c, 32, **kw),
                     lambda c: InceptionA(c, 64, **kw),
                     lambda c: InceptionA(c, 64, **kw),
                     lambda c: ReductionA(c, **kw),
                     lambda c: InceptionB(c, 128, **kw),
                     lambda c: InceptionB(c, 160, **kw),
                     lambda c: InceptionB(c, 160, **kw),
                     lambda c: InceptionB(c, 192, **kw),
                     lambda c: ReductionB(c, **kw),
                     lambda c: InceptionC(c, **kw),
                     lambda c: InceptionC(c, **kw)):
            blocks.append(make(ch))
            ch = blocks[-1].out_ch
        self.blocks = nn.ModuleList(blocks)
        self.drop = nn.Dropout(0.5)
        self.head = Dense(ch, num_classes, dtype=torch.float32,
                          generator=generator, device=device)
        name_norms(self)

    def forward(self, x):
        x = x.to(self.dtype)
        s = self.stem
        x = s[2](s[1](s[0](x)))
        x = max_pool(x, 3, 2)
        x = max_pool(s[4](s[3](x)), 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(self.drop(global_mean(x)).float())
