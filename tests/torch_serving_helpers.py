"""Shared pieces of the serving tests: the same small TransformerLM built
in both packages from one flax init, and seeded ragged prompts. Imports
JAX (the per-rank bodies of the serving worlds live in
``torch_serving_workers.py``, which does not)."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import load_flax_variables

#: the JAX serving tests' model: (vocab, dim, depth, heads, max_len),
#: mlp_ratio 2, f32
VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 97, 32, 2, 4, 64


def jax_model(*, depth=DEPTH, vocab=VOCAB, dim=DIM, heads=HEADS,
              max_len=MAX_LEN, kv_heads=None, pos="learned"):
    return jtr.TransformerLM(vocab=vocab, dim=dim, depth=depth, heads=heads,
                             kv_heads=kv_heads, mlp_ratio=2, max_len=max_len,
                             dtype=jnp.float32, pos_embedding=pos)


def port_model(jm, device="cpu"):
    """The port's TransformerLM of ``jm``'s configuration."""
    return ttr.TransformerLM(
        vocab=jm.vocab, dim=jm.dim, depth=jm.depth, heads=jm.heads,
        kv_heads=jm.kv_heads, mlp_ratio=jm.mlp_ratio, max_len=jm.max_len,
        dtype=torch.float32, pos_embedding=jm.pos_embedding, device=device)


def params(jm, seed=0):
    """flax init of ``jm`` as a nested numpy tree."""
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def pair(seed=0, **kw):
    """``(jax model, port model with the same weights, numpy params)``."""
    jm = jax_model(**kw)
    p = params(jm, seed)
    tm = port_model(jm)
    load_flax_variables(tm, p)
    return jm, tm, p


def ragged_prompts(seed, lens, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).astype(np.int32) for n in lens]


def padded(prompts):
    tp = max(len(p) for p in prompts)
    pad = np.zeros((len(prompts), tp), np.int32)
    for i, p in enumerate(prompts):
        pad[i, :len(p)] = p
    return pad, np.asarray([len(p) for p in prompts], np.int32)


def jax_generate(jm, p, prompts, max_new):
    """The JAX package's ``generate`` over one right-padded ragged batch;
    each row's generated run."""
    pad, lens = padded(prompts)
    out = np.asarray(jtr.generate(jm, p, pad, max_new_tokens=max_new,
                                  prompt_lens=lens))
    return [out[i, lens[i]:lens[i] + max_new] for i in range(len(prompts))]


def port_generate(tm, prompts, max_new, params=None):
    pad, lens = padded(prompts)
    out = ttr.generate(tm, params, pad, max_new_tokens=max_new,
                       prompt_lens=lens, device="cpu").numpy()
    return [out[i, lens[i]:lens[i] + max_new] for i in range(len(prompts))]
