"""Inception V3 in PyTorch: the reference's second scaling workload.

Counterpart of ``horovod_tpu/models/inception.py`` (flax; Szegedy et al.
2015), without the auxiliary head: the stem (299 → 35), three
``InceptionA``, the ``InceptionB`` reduction, four ``InceptionC`` (7x7
factorized into 1x7 / 7x1), the ``InceptionD`` reduction, two
``InceptionE``, the global mean and the head. Every conv is a
:class:`ConvBN` (bias-free conv, flax BatchNorm with eps 1e-3, relu).
As the ResNets: NHWC in, NCHW with channels-last strides inside (the
branches are concatenated on the channel axis, dim 1, in the flax
order), compute in ``dtype`` (bfloat16 by default), parameters and the
head in float32.

What flax decides implicitly, written out:

- the auto names, in creation order: ``ConvBN_{k}`` in each block,
  ``Conv_0`` / ``BatchNorm_0`` in each ``ConvBN``, ``InceptionA_0``, ...;
- ``SAME`` pads, asymmetric where a stride is 2
  (:func:`~horovod_tpu_torch.models.resnet.same_pads`);
- the branch pool ``avg_pool(3x3, stride 1, SAME)``, which counts the
  zero padding in its mean (``count_include_pad=True``);
- the reductions' ``max_pool(3x3, stride 2, VALID)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Dense, FlaxModel
from horovod_tpu_torch.models.resnet import BatchNorm, Conv

_BN_EPS = 1e-3


class ConvBN(nn.Module):
    """conv + BN + relu, the unit of every branch."""

    def __init__(self, cin, filters, kernel, strides=1, padding="SAME", *,
                 dtype, device=None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, kernel, strides, padding,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(filters, eps=_BN_EPS, dtype=dtype,
                                     device=device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x):
    """flax's ``avg_pool(x, (3, 3), (1, 1), "SAME")``: the zero padding
    counts in the mean."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """Builds its ``ConvBN``s in flax's creation order: ``conv(...)``
    names the next one ``ConvBN_{k}``."""

    def __init__(self, dtype, device):
        super().__init__()
        self._kw = dict(dtype=dtype, device=device)
        self._k = 0

    def conv(self, cin, filters, kernel, strides=1, padding="SAME"):
        m = ConvBN(cin, filters, kernel, strides, padding, **self._kw)
        self.add_module(f"ConvBN_{self._k}", m)
        self._k += 1
        return m


class InceptionA(_Block):
    """35x35: 1x1 / 5x5 / double-3x3 / pool branches."""

    def __init__(self, cin, pool_features, *, dtype, device=None):
        super().__init__(dtype, device)
        self.b1 = [self.conv(cin, 64, 1)]
        self.b2 = [self.conv(cin, 48, 1), self.conv(48, 64, 5)]
        self.b3 = [self.conv(cin, 64, 1), self.conv(64, 96, 3),
                   self.conv(96, 96, 3)]
        self.b4 = [self.conv(cin, pool_features, 1)]
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _chain(self.b3, x),
                          _chain(self.b4, _avg_pool_same(x))], dim=1)


class InceptionB(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, cin, *, dtype, device=None):
        super().__init__(dtype, device)
        self.b1 = [self.conv(cin, 384, 3, 2, "VALID")]
        self.b2 = [self.conv(cin, 64, 1), self.conv(64, 96, 3),
                   self.conv(96, 96, 3, 2, "VALID")]
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _max_pool_valid(x)], dim=1)


class InceptionC(_Block):
    """17x17: 7x7 factorized into 1x7 / 7x1 pairs."""

    def __init__(self, cin, channels_7x7, *, dtype, device=None):
        super().__init__(dtype, device)
        c = channels_7x7
        self.b1 = [self.conv(cin, 192, 1)]
        self.b2 = [self.conv(cin, c, 1), self.conv(c, c, (1, 7)),
                   self.conv(c, 192, (7, 1))]
        self.b3 = [self.conv(cin, c, 1), self.conv(c, c, (7, 1)),
                   self.conv(c, c, (1, 7)), self.conv(c, c, (7, 1)),
                   self.conv(c, 192, (1, 7))]
        self.b4 = [self.conv(cin, 192, 1)]
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _chain(self.b3, x),
                          _chain(self.b4, _avg_pool_same(x))], dim=1)


class InceptionD(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, cin, *, dtype, device=None):
        super().__init__(dtype, device)
        self.b1 = [self.conv(cin, 192, 1), self.conv(192, 320, 3, 2, "VALID")]
        self.b2 = [self.conv(cin, 192, 1), self.conv(192, 192, (1, 7)),
                   self.conv(192, 192, (7, 1)),
                   self.conv(192, 192, 3, 2, "VALID")]
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _max_pool_valid(x)], dim=1)


class InceptionE(_Block):
    """8x8: the 3x3 branches fan out into parallel 1x3 and 3x1."""

    def __init__(self, cin, *, dtype, device=None):
        super().__init__(dtype, device)
        # lists, not attributes: an attribute would register a second name
        self.b1 = [self.conv(cin, 320, 1)]
        self.b2 = [self.conv(cin, 384, 1)]
        self.b2_fan = [self.conv(384, 384, (1, 3)), self.conv(384, 384, (3, 1))]
        self.b3 = [self.conv(cin, 448, 1), self.conv(448, 384, 3)]
        self.b3_fan = [self.conv(384, 384, (1, 3)), self.conv(384, 384, (3, 1))]
        self.b4 = [self.conv(cin, 192, 1)]
        self.out_channels = 320 + 2 * 768 + 192

    def forward(self, x):
        b2 = _chain(self.b2, x)
        b3 = _chain(self.b3, x)
        return torch.cat([_chain(self.b1, x)] + [c(b2) for c in self.b2_fan]
                         + [c(b3) for c in self.b3_fan]
                         + [_chain(self.b4, _avg_pool_same(x))], dim=1)


def _chain(convs, x):
    for c in convs:
        x = c(x)
    return x


class InceptionV3(FlaxModel, _Block):
    def __init__(self, *, num_classes: int = 1000, in_channels: int = 3,
                 dtype=torch.bfloat16, seed: int = 0, device=None):
        _Block.__init__(self, dtype, device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.stem = [self.conv(in_channels, 32, 3, 2, "VALID"),
                     self.conv(32, 32, 3, 1, "VALID"), self.conv(32, 64, 3)]
        self.stem2 = [self.conv(64, 80, 1, 1, "VALID"),
                      self.conv(80, 192, 3, 1, "VALID")]
        self.blocks = []
        cin = 192
        counts: dict = {}
        for cls, args in ((InceptionA, (32,)), (InceptionA, (64,)),
                          (InceptionA, (64,)), (InceptionB, ()),
                          (InceptionC, (128,)), (InceptionC, (160,)),
                          (InceptionC, (160,)), (InceptionC, (192,)),
                          (InceptionD, ()), (InceptionE, ()),
                          (InceptionE, ())):
            k = counts.get(cls.__name__, 0)
            counts[cls.__name__] = k + 1
            blk = cls(cin, *args, **kw)
            self.add_module(f"{cls.__name__}_{k}", blk)
            self.blocks.append(blk)
            cin = blk.out_channels
        self.head = Dense(cin, num_classes, device=device)
        self.init_parameters(seed, device)

    def forward(self, x):
        """``x`` NHWC ``[B, H, W, C]`` → f32 logits ``[B, classes]``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view, channels-last
        x = _max_pool_valid(_chain(self.stem, x))
        x = _max_pool_valid(_chain(self.stem2, x))
        for blk in self.blocks:
            x = blk(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x)
