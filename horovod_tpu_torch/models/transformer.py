"""Decoder-only Transformer LM in PyTorch: training, kv-cache decode and
the paged serving mode.

Counterpart of ``horovod_tpu/models/transformer.py``. It computes what
the flax model computes:

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

Decoding: ``forward(tokens, positions, cache=, page_table=)`` runs a
chunk of tokens against a kv cache the caller owns and passes in, one
``(k, v)`` pair a block, written in place (there is no flax-style
``mutable`` collection): a contiguous cache ``[B, L, H_kv, D]``
(:meth:`TransformerLM.decode_cache`; each row's chunk lands at its
``positions[:, 0]``, as ``dynamic_update_slice``), or with a
``page_table`` a page pool ``[P, page_size, H_kv, D]``
(:meth:`TransformerLM.paged_cache`; the serving engine's). :func:`generate`
is the batched prefill + per-token decode loop.

Tensor parallelism: :func:`transformer_param_specs` names the dim each
flax-keyed leaf splits over a model axis (Megatron's column/row rules),
and :func:`tp_block_apply` runs one block split over a mesh axis's
sub-group with its two ``psum``s stated in code.

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
from horovod_tpu_torch.ops.flash_attention import (
    NEG_INF, decode_attention, paged_decode_attention, repeat_kv_heads,
)
from horovod_tpu_torch.parallel import spmd


def apply_rope(x, positions, *, base: float = 10000.0):
    """Rotary position embedding on ``[B, T, H, D]`` (D even), rotate-half
    (NeoX-style) convention: feature i pairs with feature i + D/2, rotated
    by ``positions * base**(-i/(D/2))``; math in f32, result in x's
    dtype. ``positions`` are the global token indices, ``[B or 1, T]``."""
    half = x.shape[-1] // 2
    # constants by torch.full: torch.tensor(..., device=cuda) is a copy
    # from the host that waits for the card
    expo = (-torch.arange(half, dtype=torch.float32, device=x.device)
            / torch.full((), float(half), device=x.device))
    # XLA's f32 pow is correctly rounded (PyTorch's is not, always):
    # take it in f64 and round once
    freqs = torch.pow(torch.full((), base, dtype=torch.float64,
                                 device=x.device), expo.double()).float()
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


def _decode_attention(q, k_cache, v_cache, start_pos):
    """The historical name of
    :func:`horovod_tpu_torch.ops.flash_attention.decode_attention`."""
    return decode_attention(q, k_cache, v_cache, start_pos)


def write_cache(cache, k, v, positions, page_table=None):
    """Write a chunk's ``k``/``v`` ``[B, T, H_kv, D]`` into one block's
    cache ``(k, v)`` in place, and return the per-row frontier
    ``positions[:, 0]``.

    - contiguous ``[B, L, H_kv, D]``: row b's chunk at
      ``positions[b, 0]``, clamped into ``[0, L - T]`` as
      ``dynamic_update_slice`` clamps;
    - paged ``[P, page_size, H_kv, D]`` with ``page_table`` ``[B,
      pages_per_seq]``: token p of row b to slot ``page_table[b, p //
      page_size] * page_size + p % page_size`` of the flat pool, the page
      index clamped to the table as ``take_along_axis`` clamps. Rows the
      engine masks and pad tails past a row's pages go to page 0, whose
      contents are never visible; duplicate slots there make the write
      order-dependent, which is harmless only for that reason."""
    kc, vc = cache
    start = positions[:, 0]
    if page_table is None:
        b, t = k.shape[:2]
        st = start.clamp(0, kc.shape[1] - t)
        idx = (st[:, None] + torch.arange(t, device=k.device)[None, :])
        idx = idx[:, :, None, None].expand(b, t, kc.shape[2], kc.shape[3])
        kc.scatter_(1, idx, k.to(kc.dtype))
        vc.scatter_(1, idx, v.to(vc.dtype))
        return start
    ps = kc.shape[1]
    page_idx = (positions // ps).clamp_max(page_table.shape[1] - 1)
    page_ids = torch.gather(page_table, 1, page_idx)
    slots = (page_ids * ps + positions % ps).reshape(-1)
    flat = (-1, kc.shape[2], kc.shape[3])
    kc.view(flat)[slots] = k.to(kc.dtype).reshape(flat)
    vc.view(flat)[slots] = v.to(vc.dtype).reshape(flat)
    return start


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

    def forward(self, x, positions=None, cache=None, page_table=None):
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
        if cache is None:
            att = self.attention_fn(q, k, v, causal=True)
        elif page_table is not None:
            start = write_cache(cache, k, v, positions, page_table)
            att = paged_decode_attention(q, cache[0], cache[1], page_table,
                                         start, page_size=cache[0].shape[1])
        else:
            start = write_cache(cache, k, v, positions)
            att = decode_attention(q, cache[0], cache[1], start)
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
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.kv_heads, self.mlp_ratio = kv_heads, mlp_ratio
        self.pos_embedding, self.rope_base = pos_embedding, rope_base
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

    def config(self, **overrides) -> dict:
        """The constructor's configuration (``overrides`` replace fields),
        to build a model of the same shape: a draft of fewer blocks, or a
        parameterless twin on the ``meta`` device."""
        cfg = dict(vocab=self.vocab, dim=self.dim, depth=self.depth,
                   heads=self.heads, kv_heads=self.kv_heads,
                   mlp_ratio=self.mlp_ratio, max_len=self.max_len,
                   dtype=self.dtype, pos_embedding=self.pos_embedding,
                   rope_base=self.rope_base)
        cfg.update(overrides)
        return cfg

    def _cache_shape(self, lead) -> tuple:
        return (*lead, self.kv_heads or self.heads, self.dim // self.heads)

    def decode_cache(self, batch: int, length: int, device=None) -> list:
        """A zero contiguous kv cache: one ``(k, v)`` ``[batch, length,
        H_kv, D]`` pair a block, in the compute dtype."""
        shape = self._cache_shape((batch, length))
        return [(torch.zeros(shape, dtype=self.dtype, device=device),
                 torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in range(self.depth)]

    def paged_cache(self, num_pages: int, page_size: int, device=None,
                    heads_div: int = 1) -> list:
        """A zero page pool: one ``(k, v)`` ``[num_pages, page_size,
        H_kv / heads_div, D]`` pair a block (``heads_div`` is a tensor-
        parallel axis's size: a rank's head block)."""
        h_kv = (self.kv_heads or self.heads) // heads_div
        shape = (num_pages, page_size, h_kv, self.dim // self.heads)
        return [(torch.zeros(shape, dtype=self.dtype, device=device),
                 torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in range(self.depth)]

    def forward(self, tokens, positions=None, cache=None, page_table=None):
        """Logits ``[B, T, vocab]`` (f32) of ``tokens`` ``[B, T]``.

        With ``cache`` (a list of one ``(k, v)`` pair a block) the chunk
        is decoded against it and written into it in place; ``positions``
        ``[B, T]`` (each row's global token indices) is then required, and
        ``page_table`` selects the paged cache. A learned position past
        the table is clamped: only a paged prefill chunk's pad tail
        carries one, and its logits are never read (the JAX package's
        ``jnp.take`` fills NaN there instead)."""
        if cache is not None and positions is None:
            raise ValueError(
                "decoding against a cache requires positions (the cache "
                "index of each token, [B, T]) — use generate()")
        if cache is not None and len(cache) != self.depth:
            raise ValueError(f"cache has {len(cache)} blocks, the model "
                             f"{self.depth}")
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.tok_embed(tokens)
        if not self.use_rope:
            x = x + self.pos_embed[positions.clamp(0, self.max_len - 1)].to(
                self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(
                x, positions if (self.use_rope or cache is not None) else None,
                None if cache is None else cache[i], page_table)
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


def transformer_param_specs(params: dict) -> dict:
    """Megatron-style tensor-parallel split of a TransformerLM's
    flax-keyed leaves (``model.jax_params()``: ``block0/qkv/kernel``, ...,
    flax's layouts): for each key, the dim split over the model axis, or
    None (replicated). qkv/``q_proj``/``kv_proj``/``mlp_up`` kernels split
    their output dim (1), ``proj``/``mlp_down`` their input dim (0), so
    each block needs exactly one psum per matmul pair; ``lm_head`` and the
    embedding tables split their feature dim (1); leaves of rank < 2 are
    replicated. The name rules are the JAX package's."""

    def dim_for(name, leaf):
        if leaf.dim() < 2:
            return None
        if ("qkv" in name or "mlp_up" in name or "q_proj" in name
                or "kv_proj" in name):
            return 1
        if "proj" in name or "mlp_down" in name:
            return 0
        if "lm_head" in name:
            return 1
        if "tok_embed" in name or "pos_embed" in name:
            return 1
        return None

    return {k: dim_for(k, v) for k, v in params.items()}


def _tp_layernorm(x, scale, bias, *, eps: float = 1e-6):
    """flax LayerNorm's statistics (mean of squares minus squared mean,
    clamped), in the JAX package's ``_tp_layernorm`` expression order."""
    mu = x.mean(dim=-1, keepdim=True)
    mu2 = (x * x).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(mu2 - mu * mu, 0.0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def tp_block_apply(block_params: dict, x, *, heads: int, axis: str = "tp"):
    """One transformer block, tensor-parallel over the mesh axis ``axis``.

    ``block_params`` is one :class:`TransformerBlock`'s full (replicated)
    parameters as the JAX package's nested dict in flax's layouts
    (``block_params["qkv"]["kernel"]`` ``[D, 3D]``); every rank of the
    axis calls it on the same ``x`` ``[B, T, D]`` and slices its own
    column/row blocks (Megatron: qkv and mlp_up column-split, proj and
    mlp_down row-split), so the block costs exactly two psums forward
    (:func:`~horovod_tpu_torch.parallel.spmd.psum`, whose backward is a
    psum: each rank's gradient is the axis size times its share, and
    their mean over the axis the block's). Attention is dense
    (:func:`default_attention`), as in the JAX package.

    Full multi-head attention only (a fused ``qkv`` kernel), no RoPE;
    ``heads`` and the MLP's hidden width must be divisible by the axis
    size."""
    if "qkv" not in block_params:
        raise ValueError(
            "tp_block_apply requires a fused qkv kernel (kv_heads unset "
            "or == heads); GQA blocks need the GSPMD path "
            "(transformer_param_specs)")
    n = spmd.axis_size(axis)
    r = spmd.axis_index(axis)
    dim = x.shape[-1]
    if heads % n:
        raise ValueError(f"heads={heads} not divisible by tp axis size {n}")
    w = dim // n  # per-rank head-block width (heads//n heads, contiguous)
    head_dim = dim // heads
    b, t = x.shape[:2]

    h = _tp_layernorm(x, block_params["ln1"]["scale"],
                      block_params["ln1"]["bias"])
    # fused qkv kernel layout is [D, 3D] = [q | k | v]; this rank takes
    # the same column window r*w inside each third
    qkv_k = block_params["qkv"]["kernel"]
    qkv_local = torch.cat([qkv_k[:, base + r * w:base + (r + 1) * w]
                           for base in (0, dim, 2 * dim)], dim=1)
    q, k, v = (h @ qkv_local).split(w, dim=-1)
    split = lambda z: z.reshape(b, t, heads // n, head_dim)  # noqa: E731
    att = default_attention(split(q), split(k), split(v), causal=True)
    att = att.reshape(b, t, w)
    # proj row-split: each rank contributes its head-block's slice of the
    # contraction; psum #1 completes it
    partial = att @ block_params["proj"]["kernel"][r * w:(r + 1) * w]
    x = x + spmd.psum(partial, axis)

    h = _tp_layernorm(x, block_params["ln2"]["scale"],
                      block_params["ln2"]["bias"])
    up_k = block_params["mlp_up"]["kernel"]
    hidden = up_k.shape[1]
    if hidden % n:
        raise ValueError(
            f"mlp hidden width {hidden} not divisible by tp axis size {n}")
    fw = hidden // n
    # mlp_up's bias is column-split with its kernel: it lands before the
    # gelu, so it cannot wait for the psum
    h = (h @ up_k[:, r * fw:(r + 1) * fw]
         + block_params["mlp_up"]["bias"][r * fw:(r + 1) * fw])
    h = F.gelu(h, approximate="tanh")
    partial = h @ block_params["mlp_down"]["kernel"][r * fw:(r + 1) * fw]
    # mlp_down's bias is replicated and added exactly once, after psum #2
    return x + spmd.psum(partial, axis) + block_params["mlp_down"]["bias"]


def _with_defaults(**defaults):
    def make(**kw):
        return TransformerLM(**{**defaults, **kw})
    return make


TransformerTiny = _with_defaults(vocab=1024, dim=64, depth=2, heads=4,
                                 max_len=4096)
#: ~GPT-2-small scale
TransformerSmall = _with_defaults(vocab=32768, dim=768, depth=12, heads=12)


def _sample(logits, temperature: float, generator):
    """Greedy argmax (``temperature == 0``) or a draw from
    ``softmax(logits / temperature)`` with ``generator``."""
    if temperature > 0.0:
        p = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(p, 1, generator=generator)[:, 0].to(
            torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(model: TransformerLM, params, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, generator=None, prompt_lens=None,
             device=None):
    """Autoregressive decoding with a kv cache: one batched prefill
    forward writes the whole prompt's K/V, then one forward a token,
    greedy (``temperature == 0``) or sampled. The cache holds ``T_prompt
    + max_new_tokens`` positions, ``H_kv`` wide.

    Ragged batches: ``prompt_lens`` ``[B]`` with a right-padded
    ``prompt``; each row decodes from its own length (the per-row
    frontier keeps the pads unreachable until a decode step overwrites
    them).

    Args:
      model: a :class:`TransformerLM`; it runs where its parameters are.
      params: ``None`` (the model's own parameters), or a tree keyed by
        flax path (the JAX package's nested dict, or ``jax_params()``'s
        flat keys) in flax's layouts, run through
        ``torch.func.functional_call``.
      prompt: int tokens ``[B, T_prompt]`` (a tensor or numpy array).
      max_new_tokens: tokens to append to each row.
      temperature: 0 = greedy; > 0 samples ``logits / temperature``.
      generator: the ``torch.Generator`` (on the model's device) the
        samples are drawn from; required when ``temperature > 0``. The
        JAX package's ``fold_in``-keyed draws are not reproduced.
      prompt_lens: optional ``[B]`` true prompt lengths (1..T_prompt).
      device: where to run; by default the model's parameters' device,
        or, for a parameterless (``meta``) model, this process's device
        once ``init`` has run, else ``cuda:0``.

    Returns int32 tokens ``[B, T_prompt + max_new_tokens]``; a ragged row
    carries its generated tokens at ``[L_i, L_i + max_new_tokens)``, and
    the columns past them are unspecified padding."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 needs a torch.Generator")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    dev = model.ln_f.scale.device
    if device is not None or dev.type == "meta":
        from horovod_tpu_torch.basics import default_device

        dev = default_device(device)
    if params is not None:
        from horovod_tpu_torch.models.convert import torch_weights

        weights = torch_weights(model, params, dev)

        def fwd(*a, **kw):
            return torch.func.functional_call(model, weights, a, kw)
    else:
        fwd = model
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int64)
    b, t_prompt = prompt.shape
    total = t_prompt + max_new_tokens
    if total > model.max_len:
        raise ValueError(f"prompt + max_new_tokens = {total} exceeds max_len "
                         f"{model.max_len}")
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens).to(device=dev, dtype=torch.int64)
        if tuple(lens.shape) != (b,):
            raise ValueError(f"prompt_lens must be [B]={b}, got "
                             f"{tuple(lens.shape)}")
        lo, hi = int(lens.min()), int(lens.max())
        if lo < 1 or hi > t_prompt:
            raise ValueError(f"prompt_lens must be in [1, {t_prompt}], got "
                             f"[{lo}, {hi}]")
    else:
        lens = torch.full((b,), t_prompt, dtype=torch.int64, device=dev)
    cache = model.decode_cache(b, total, device=dev)
    pos = torch.arange(t_prompt, device=dev)[None, :].expand(b, t_prompt)
    logits = fwd(prompt, pos, cache)
    # each row's first token comes from ITS last real position
    last = logits[torch.arange(b, device=dev), lens - 1]
    tok = _sample(last, temperature, generator)
    gen = [tok]
    for i in range(max_new_tokens - 1):
        logits = fwd(tok[:, None].to(torch.int64), (lens + i)[:, None], cache)
        tok = _sample(logits[:, -1], temperature, generator)
        gen.append(tok)
    gen = torch.stack(gen, dim=1)
    out = torch.nn.functional.pad(prompt.to(torch.int32),
                                  (0, max_new_tokens))
    idx = lens[:, None] + torch.arange(max_new_tokens, device=dev)[None, :]
    return out.scatter_(1, idx, gen)
