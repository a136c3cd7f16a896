"""VGG family in PyTorch: the reference's allreduce-bandwidth stress case.

Counterpart of ``horovod_tpu/models/vgg.py`` (flax; Simonyan & Zisserman
2014): 3x3 ``SAME`` convolutions between 2x2 stride-2 max-pools, two
``hidden_dim``-wide FC layers and the head. VGG-16's two 4096-wide FC
layers hold most of its 138,357,544 parameters (``fc0/kernel`` alone is
``[25088, 4096]``), which is what makes it the gradient-volume stress
case. As the ResNets: NHWC in, NCHW with channels-last strides inside,
compute in ``dtype`` (bfloat16 by default), parameters and the head in
float32. Batch norm is off by default (the classic network has none, so
``jax_batch_stats()`` is empty); ``use_bn=True`` gives the modern
variant. Leaves are keyed by the flax names (``conv{i}_{j}``,
``bn{i}_{j}``, ``fc0``, ``fc1``, ``head``).

flax infers ``fc0``'s input width at init; here it is fixed by
``input_size`` (224 by default), the spatial size the model is built
for: the last stage's map is flattened in NHWC order, as flax does.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense, FlaxModel
from horovod_tpu_torch.models.resnet import BatchNorm, Conv, _pair

#: conv filter counts between max-pools
_VGG16_STAGES = ((64, 64), (128, 128), (256, 256, 256),
                 (512, 512, 512), (512, 512, 512))
_VGG19_STAGES = ((64, 64), (128, 128), (256, 256, 256, 256),
                 (512, 512, 512, 512), (512, 512, 512, 512))


class VGG(FlaxModel):
    def __init__(self, stages: Sequence[Sequence[int]], *,
                 num_classes: int = 1000, hidden_dim: int = 4096,
                 use_bn: bool = False, in_channels: int = 3,
                 input_size=224, dtype=torch.bfloat16, seed: int = 0,
                 device=None):
        super().__init__()
        self.dtype, self.use_bn = dtype, use_bn
        kw = dict(dtype=dtype, device=device)
        self.convs = []
        cin = in_channels
        h, w = _pair(input_size)
        for i, stage in enumerate(stages):
            names = []
            for j, filters in enumerate(stage):
                self.add_module(f"conv{i}_{j}", Conv(cin, filters, 3,
                                                     bias=not use_bn, **kw))
                if use_bn:
                    self.add_module(f"bn{i}_{j}", BatchNorm(filters, **kw))
                names.append((f"conv{i}_{j}", f"bn{i}_{j}"))
                cin = filters
            self.convs.append(names)
            h, w = h // 2, w // 2
        self.fc0 = Dense(h * w * cin, hidden_dim, **kw)
        self.fc1 = Dense(hidden_dim, hidden_dim, **kw)
        self.head = Dense(hidden_dim, num_classes, device=device)
        self.init_parameters(seed, device)

    def forward(self, x):
        """``x`` NHWC ``[B, H, W, C]`` → f32 logits ``[B, classes]``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view, channels-last
        for stage in self.convs:
            for conv, bn in stage:
                x = getattr(self, conv)(x)
                if self.use_bn:
                    x = getattr(self, bn)(x)
                x = F.relu(x)
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC order
        x = F.relu(self.fc0(x))
        x = F.relu(self.fc1(x))
        return self.head(x).float()


VGG16 = functools.partial(VGG, _VGG16_STAGES)
VGG19 = functools.partial(VGG, _VGG19_STAGES)
