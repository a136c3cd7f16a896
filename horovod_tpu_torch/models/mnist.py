"""Small MNIST CNN, counterpart of ``horovod_tpu/models/mnist.py``
(conv32 - conv64 - 2x2 max-pool - dense128 - dense, relu between, float32,
``SAME`` convs with bias): NHWC in, NCHW inside, the pooled map flattened
in flax's NHWC order. ``input_size`` (28 by default) fixes ``Dense_0``'s
input width, which flax infers."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense, FlaxModel
from horovod_tpu_torch.models.resnet import Conv, _pair


class MnistCNN(FlaxModel):
    def __init__(self, num_classes: int = 10, *, in_channels: int = 1,
                 input_size=28, seed: int = 0, device=None):
        super().__init__()
        kw = dict(bias=True, dtype=torch.float32, device=device)
        self.Conv_0 = Conv(in_channels, 32, 3, **kw)
        self.Conv_1 = Conv(32, 64, 3, **kw)
        h, w = _pair(input_size)
        self.Dense_0 = Dense((h // 2) * (w // 2) * 64, 128, device=device)
        self.Dense_1 = Dense(128, num_classes, device=device)
        self.init_parameters(seed, device)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).float()
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))
