"""ResNet family in PyTorch, the benchmark workload.

Counterpart of ``horovod_tpu/models/resnet.py`` (flax, v1.5: stride on
the 3x3 conv of the bottleneck). It computes what the flax model computes:

- public input NHWC, as the JAX model takes it; inside, the NHWC input is
  viewed as NCHW with channels-last strides (cuDNN's fast layout), so no
  copy is made;
- flax's ``padding="SAME"``, padded explicitly: a stride-2 3x3 conv on an
  even input pads (0, 1), not (1, 1), and the SAME max-pool pads with
  ``-inf``;
- flax's BatchNorm, written out: biased batch variance ``E[x²] - E[x]²``
  in f32, running stats ``0.9 * ra + 0.1 * batch``, eps 1e-5 (torch's
  BatchNorm would update ``running_var`` with the unbiased variance);
- compute in ``dtype`` (bfloat16 by default), parameters and the head in
  float32; the last BatchNorm of each block starts with scale 0.

Parameters keep PyTorch's layouts (conv OIHW, linear ``[out, in]``).
:meth:`ResNet.jax_params` / :meth:`ResNet.jax_grads` /
:meth:`ResNet.jax_batch_stats` return them keyed by the flax path
(``BottleneckBlock_3/Conv_1/kernel``) as views in flax's layouts (HWIO,
``[in, out]``), which is what the optimizer packs.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Dense, lecun_normal_

_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5


def same_pads(size: int, k: int, stride: int):
    """flax/XLA ``SAME`` padding (lo, hi) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free 2-D conv, flax ``nn.Conv`` semantics (``SAME`` by
    default). Weight ``[out, in, kh, kw]``; flax kernel view HWIO."""

    def __init__(self, cin, cout, k, stride=1, padding="SAME", *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))

    def reset_parameters(self, gen):
        lecun_normal_(self.weight.data, self.weight[0].numel(), gen)

    def forward(self, x):
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], self.k, self.stride)
            pw = same_pads(x.shape[3], self.k, self.stride)
        else:
            ph, pw = self.padding
        if any(ph) or any(pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride)

    def jax_params(self, grad=False):
        w = self.weight.grad if grad else self.weight
        return {"kernel": w.permute(2, 3, 1, 0)}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW."""

    def __init__(self, c, *, zero_scale=False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype, self.zero_scale = dtype, zero_scale
        self.scale = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                m = float(np.float32(1 - _BN_MOMENTUM))
                self.mean.copy_(_BN_MOMENTUM * self.mean + m * mean)
                self.var.copy_(_BN_MOMENTUM * self.var + m * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + _BN_EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)

    def jax_params(self, grad=False):
        if grad:
            return {"scale": self.scale.grad, "bias": self.bias.grad}
        return {"scale": self.scale, "bias": self.bias}

    def jax_batch_stats(self):
        return {"mean": self.mean, "var": self.var}


class ResNetBlock(nn.Module):
    """Basic two-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin, filters, stride=1, *, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(cin, filters, 3, stride, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, **kw)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, **kw)
        self.proj = stride != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters, **kw)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        r = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(r + y)


class BottleneckBlock(nn.Module):
    """1-3-1 bottleneck block (ResNet-50/101/152), v1.5."""

    expansion = 4

    def __init__(self, cin, filters, stride=1, *, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(cin, filters, 1, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, filters * 4, 1, **kw)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True, **kw)
        self.proj = stride != 1 or cin != filters * 4
        if self.proj:
            self.conv_proj = Conv(cin, filters * 4, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters * 4, **kw)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        r = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(r + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls, *,
                 num_classes: int = 1000, num_filters: int = 64,
                 in_channels: int = 3, dtype=torch.bfloat16, seed: int = 0,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_init = Conv(in_channels, num_filters, 7, 2,
                              padding=((3, 3), (3, 3)), **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        cin, k = num_filters, 0
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blk = block_cls(cin, num_filters * 2 ** i, stride, **kw)
                name = f"{block_cls.__name__}_{k}"
                self.add_module(name, blk)
                self.blocks.append(name)
                cin, k = num_filters * 2 ** i * block_cls.expansion, k + 1
        self.head = Dense(cin, num_classes, device=device)
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0):
        gen = torch.Generator(device=self.head.weight.device).manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, x):
        """``x`` NHWC ``[B, H, W, C]`` → f32 logits ``[B, classes]``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view, channels-last
        x = F.relu(self.bn_init(self.conv_init(x)))
        ph = same_pads(x.shape[2], 3, 2)
        pw = same_pads(x.shape[3], 3, 2)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x)

    def _collect(self, method: str, **kw) -> dict:
        out = {}
        for name, m in self.named_modules():
            fn = getattr(m, method, None)
            if fn is not None and m is not self:
                for leaf, t in fn(**kw).items():
                    out[f"{name.replace('.', '/')}/{leaf}"] = t
        return out

    def jax_params(self) -> dict:
        """Parameters keyed by flax path, as views in flax's layouts."""
        return self._collect("jax_params")

    def jax_grads(self) -> dict:
        """The parameters' ``.grad`` in the same keys and layouts."""
        return self._collect("jax_params", grad=True)

    def jax_batch_stats(self) -> dict:
        """BatchNorm running stats keyed by flax path (the buffers)."""
        return self._collect("jax_batch_stats")


def _partial(stage_sizes, block_cls):
    return functools.partial(ResNet, stage_sizes, block_cls)


ResNet18 = _partial([2, 2, 2, 2], ResNetBlock)
ResNet34 = _partial([3, 4, 6, 3], ResNetBlock)
ResNet50 = _partial([3, 4, 6, 3], BottleneckBlock)
ResNet101 = _partial([3, 4, 23, 3], BottleneckBlock)
ResNet152 = _partial([3, 8, 36, 3], BottleneckBlock)


