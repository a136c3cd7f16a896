"""Small MLP for tests, counterpart of ``horovod_tpu/models/mlp.py``:
the input flattened, then ``Dense_{i}`` layers with relu between them,
in float32. flax infers the first layer's input width; here it is
``in_features``."""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F

from horovod_tpu_torch.models.layers import Dense, FlaxModel


class MLP(FlaxModel):
    def __init__(self, features: Sequence[int] = (64, 10), *,
                 in_features: int = 784, seed: int = 0, device=None):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(in_features, f, device=device))
            in_features = f
        self.init_parameters(seed, device)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = getattr(self, f"Dense_{i}")(x)
            if i + 1 < self.depth:
                x = F.relu(x)
        return x
