"""Layers both models share, each computing what its flax layer computes.

Parameters are kept in float32 and PyTorch's layouts (linear
``[out, in]``); ``jax_params(grad=...)`` returns them (or their
``.grad``) keyed by the flax leaf name, as views in flax's layouts
(Dense kernel ``[in, out]``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_LN_EPS = 1e-6


def lecun_normal_(w, fan_in: int, gen):
    """flax's lecun_normal: variance_scaling(1, fan_in, truncated_normal)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype`` (float32 by default), parameters in float32; weight
    ``[out, in]``, kernel view ``[in, out]``; the bias is optional."""

    def __init__(self, cin, cout, *, bias: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if bias else None)

    def reset_parameters(self, gen):
        lecun_normal_(self.weight.data, self.weight.shape[1], gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)

    def jax_params(self, grad=False):
        out = {"kernel": (self.weight.grad if grad else self.weight).t()}
        if self.bias is not None:
            out["bias"] = self.bias.grad if grad else self.bias
        return out


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: eps 1e-6, fast variance
    ``E[x²] - E[x]²`` clamped at 0 (``F.layer_norm`` takes the two-pass
    variance), stats and affine in f32, result in ``dtype``."""

    def __init__(self, dim, *, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, gen=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        mu2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        mul = torch.rsqrt(var + _LN_EPS) * self.scale
        return ((xf - mu) * mul + self.bias).to(self.dtype)

    def jax_params(self, grad=False):
        if grad:
            return {"scale": self.scale.grad, "bias": self.bias.grad}
        return {"scale": self.scale, "bias": self.bias}


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=dtype)``: the table cast to ``dtype``, then
    looked up."""

    def __init__(self, vocab, dim, *, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, dim, device=device))

    def reset_parameters(self, gen):
        # variance_scaling(1, fan_in, normal, out_axis=0) on [vocab, dim]:
        # fan_in is dim
        with torch.no_grad():
            self.embedding.normal_(0.0, self.embedding.shape[1] ** -0.5,
                                   generator=gen)

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding.to(self.dtype))

    def jax_params(self, grad=False):
        return {"embedding": self.embedding.grad if grad else self.embedding}
