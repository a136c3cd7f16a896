"""Decoder-only Transformer LM in PyTorch (training path).

Counterpart of ``horovod_tpu/models/transformer.py`` without the kv-cache
decode and the paged serving mode. It computes what the flax model
computes:

- pre-LN blocks; flax's ``nn.LayerNorm`` written out: eps 1e-6 and the
  fast variance ``E[x²] - E[x]²`` clamped at 0, stats in f32
  (``F.layer_norm`` takes the two-pass variance);
- ``nn.Dense``/``nn.Embed`` with ``dtype``: input and kernel (and bias)
  cast to ``dtype`` (bf16 by default), parameters kept in f32;
  ``mlp_up``/``mlp_down`` carry biases, ``qkv``/``q_proj``/``kv_proj``/
  ``proj``/``lm_head`` do not;
- ``nn.gelu``'s default, the tanh approximation;
- learned positions (a ``pos_embed`` table) or RoPE (rotate-half, f32);
  grouped-query attention through ``q_proj``/``kv_proj`` (k the first
  half of ``kv_proj``'s output); an injectable ``attention_fn``
  (:func:`default_attention`, or
  :func:`horovod_tpu_torch.ops.flash_attention.flash_attention`);
- logits in f32.

Parameters keep PyTorch's layouts (linear ``[out, in]``).
:meth:`TransformerLM.jax_params` / :meth:`TransformerLM.jax_grads` return
them keyed by the flax path (``block3/qkv/kernel``,
``tok_embed/embedding``, ``pos_embed``) as views in flax's layouts
(Dense ``[in, out]``), which is what the optimizer packs and
``models.convert.load_flax_variables`` loads through. Random init follows
flax's distributions from an explicit ``torch.Generator``: lecun_normal
kernels, ``normal(0.02)`` ``pos_embed`` and ``variance_scaling(1,
fan_in, normal)`` embeddings (std ``dim**-0.5``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import Dense, Embed, LayerNorm
from horovod_tpu_torch.ops.flash_attention import NEG_INF, repeat_kv_heads


def apply_rope(x, positions, *, base: float = 10000.0):
    """Rotary position embedding on ``[B, T, H, D]`` (D even), rotate-half
    (NeoX-style) convention: feature i pairs with feature i + D/2, rotated
    by ``positions * base**(-i/(D/2))``; math in f32, result in x's
    dtype. ``positions`` are the global token indices, ``[B or 1, T]``."""
    half = x.shape[-1] // 2
    expo = (-torch.arange(half, dtype=torch.float32, device=x.device)
            / torch.tensor(float(half), device=x.device))
    # XLA's f32 pow is correctly rounded (PyTorch's is not, always):
    # take it in f64 and round once
    freqs = torch.pow(torch.tensor(base, dtype=torch.float64, device=x.device),
                      expo.double()).float()
    angles = positions[..., None].float() * freqs          # [B?, T, half]
    cos = torch.cos(angles)[..., None, :]                  # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def default_attention(q, k, v, *, causal: bool = True, sm_scale=None):
    """Dense attention (tiny shapes), GQA-aware like flash attention."""
    if k.shape[2] != q.shape[2]:
        k, v = repeat_kv_heads(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class TransformerBlock(nn.Module):
    """Pre-LN block: attention (fused ``qkv`` or GQA ``q_proj``/
    ``kv_proj``, optional RoPE) then a GELU MLP, each residual."""

    def __init__(self, dim, heads, mlp_ratio, *, dtype, attention_fn,
                 kv_heads: Optional[int] = None, use_rope: bool = False,
                 rope_base: float = 10000.0, device=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.head_dim = dim // heads
        self.h_kv = kv_heads or heads
        self.use_rope, self.rope_base = use_rope, rope_base
        self.attention_fn = attention_fn
        kw = dict(dtype=dtype, device=device)
        self.ln1 = LayerNorm(dim, **kw)
        if self.h_kv == heads:
            self.qkv = Dense(dim, 3 * dim, bias=False, **kw)
        else:
            self.q_proj = Dense(dim, dim, bias=False, **kw)
            self.kv_proj = Dense(dim, 2 * self.h_kv * self.head_dim,
                                 bias=False, **kw)
        self.proj = Dense(dim, dim, bias=False, **kw)
        self.ln2 = LayerNorm(dim, **kw)
        self.mlp_up = Dense(dim, mlp_ratio * dim, bias=True, **kw)
        self.mlp_down = Dense(mlp_ratio * dim, dim, bias=True, **kw)

    def forward(self, x, positions=None):
        b, t = x.shape[:2]
        h = self.ln1(x)
        if self.h_kv == self.heads:
            q, k, v = self.qkv(h).split(self.dim, dim=-1)
        else:
            q = self.q_proj(h)
            k, v = self.kv_proj(h).split(self.h_kv * self.head_dim, dim=-1)
        q = q.reshape(b, t, self.heads, self.head_dim)
        k = k.reshape(b, t, self.h_kv, self.head_dim)
        v = v.reshape(b, t, self.h_kv, self.head_dim)
        if self.use_rope:
            if positions is None:
                raise ValueError("use_rope=True requires positions (global "
                                 "token indices)")
            q = apply_rope(q, positions, base=self.rope_base)
            k = apply_rope(k, positions, base=self.rope_base)
        att = self.attention_fn(q, k, v, causal=True)
        x = x + self.proj(att.reshape(b, t, self.dim))
        h = self.mlp_up(self.ln2(x))
        h = self.mlp_down(F.gelu(h, approximate="tanh"))
        return x + h


class TransformerLM(nn.Module):
    """Causal LM: int tokens ``[B, T]`` → f32 logits ``[B, T, vocab]``.
    Compute in ``dtype`` (bf16 by default), parameters in f32."""

    def __init__(self, vocab: int = 32000, dim: int = 512, depth: int = 8,
                 heads: int = 8, kv_heads: Optional[int] = None,
                 mlp_ratio: int = 4, max_len: int = 65536,
                 dtype=torch.bfloat16,
                 attention_fn: Callable = default_attention,
                 pos_embedding: str = "learned", rope_base: float = 10000.0,
                 seed: int = 0, device=None):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(f"pos_embedding must be 'learned' or 'rope', "
                             f"got {pos_embedding!r}")
        if pos_embedding == "rope" and (dim // heads) % 2:
            raise ValueError(f"rope needs an even head_dim, got "
                             f"{dim // heads} (dim={dim}, heads={heads})")
        if kv_heads is not None and heads % kv_heads:
            raise ValueError(f"heads ({heads}) must be a multiple of "
                             f"kv_heads ({kv_heads})")
        self.dtype, self.max_len, self.depth = dtype, max_len, depth
        self.use_rope = pos_embedding == "rope"
        kw = dict(dtype=dtype, device=device)
        self.tok_embed = Embed(vocab, dim, **kw)
        if not self.use_rope:
            self.pos_embed = nn.Parameter(torch.empty(max_len, dim,
                                                      device=device))
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                dim, heads, mlp_ratio, attention_fn=attention_fn,
                kv_heads=kv_heads, use_rope=self.use_rope,
                rope_base=rope_base, **kw))
        self.ln_f = LayerNorm(dim, **kw)
        self.lm_head = Dense(dim, vocab, bias=False, **kw)
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0):
        gen = torch.Generator(device=self.ln_f.scale.device).manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        if not self.use_rope:
            with torch.no_grad():
                self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, tokens, positions=None):
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.tok_embed(tokens)
        if not self.use_rope:
            x = x + self.pos_embed[positions].to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(
                x, positions if self.use_rope else None)
        return self.lm_head(self.ln_f(x)).float()

    def _collect(self, grad: bool) -> dict:
        out = {}
        for name, m in self.named_modules():
            fn = getattr(m, "jax_params", None)
            if fn is not None and m is not self:
                for leaf, t in fn(grad=grad).items():
                    out[f"{name.replace('.', '/')}/{leaf}"] = t
        if not self.use_rope:
            out["pos_embed"] = self.pos_embed.grad if grad else self.pos_embed
        return out

    def jax_params(self) -> dict:
        """Parameters keyed by flax path, as views in flax's layouts."""
        return self._collect(False)

    def jax_grads(self) -> dict:
        """The parameters' ``.grad`` in the same keys and layouts."""
        return self._collect(True)

    def jax_batch_stats(self) -> dict:
        """TransformerLM keeps no running statistics."""
        return {}


def _with_defaults(**defaults):
    def make(**kw):
        return TransformerLM(**{**defaults, **kw})
    return make


TransformerTiny = _with_defaults(vocab=1024, dim=64, depth=2, heads=4,
                                 max_len=4096)
#: ~GPT-2-small scale
TransformerSmall = _with_defaults(vocab=32768, dim=768, depth=12, heads=12)
