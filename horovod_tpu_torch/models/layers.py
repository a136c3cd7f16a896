"""Layers both models share, each computing what its flax layer computes.

Parameters are kept in float32 and PyTorch's layouts (linear
``[out, in]``); ``jax_params(grad=...)`` returns them (or their
``.grad``) keyed by the flax leaf name, as views in flax's layouts
(Dense kernel ``[in, out]``), and ``from_jax(leaf)`` maps leaves in
flax's layouts back to parameters in PyTorch's (see :func:`torch_params`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_LN_EPS = 1e-6


def torch_params(model, tree: dict) -> dict:
    """The inverse of ``model.jax_params()``: ``{flax path: tensor in
    flax's layout}`` → ``{parameter name: tensor in PyTorch's layout}``,
    what ``torch.func.functional_call(model, ...)`` takes. Each tensor is
    laid out as the model's own parameter (contiguous), and autograd flows
    back to ``tree``."""
    out = {}
    for name, m in model.named_modules():
        fn = getattr(m, "from_jax", None)
        if fn is None or m is model:
            continue
        prefix = name.replace(".", "/")
        for attr, t in fn(lambda leaf: tree[f"{prefix}/{leaf}"]).items():
            out[f"{name}.{attr}"] = t.contiguous()
    for name, _ in model.named_parameters(recurse=False):
        out[name] = tree[name]
    return out


class FlaxModel(nn.Module):
    """A model whose layers expose their flax-named views
    (``jax_params(grad=...)``, ``jax_batch_stats()``): collects them
    keyed by the flax path (the module path, ``/``-joined), and resets
    every layer's parameters from one generator seeded with ``seed``."""

    def init_parameters(self, seed: int, device) -> None:
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0):
        dev = next(self.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

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

    def from_jax(self, leaf):
        out = {"weight": leaf("kernel").t()}
        if self.bias is not None:
            out["bias"] = leaf("bias")
        return out


def layer_norm(x, scale, bias, dtype):
    """flax ``nn.LayerNorm``'s forward on the last dim (see
    :class:`LayerNorm`)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    mul = torch.rsqrt(var + _LN_EPS) * scale
    return ((xf - mu) * mul + bias).to(dtype)


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
        return layer_norm(x, self.scale, self.bias, self.dtype)

    def jax_params(self, grad=False):
        if grad:
            return {"scale": self.scale.grad, "bias": self.bias.grad}
        return {"scale": self.scale, "bias": self.bias}

    def from_jax(self, leaf):
        return {"scale": leaf("scale"), "bias": leaf("bias")}


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

    def from_jax(self, leaf):
        return {"embedding": leaf("embedding")}
