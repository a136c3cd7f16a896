"""The decode primitives and the decode modes of the LM against the JAX
package, in f32 on the CPU:

- ``decode_attention``, ``paged_decode_attention`` (a recycled page full
  of NaN past the frontier must not leak) and ``tp_paged_decode_attention``
  (the JAX version on a 2-device mesh against the port's per-head-block
  calls) at atol/rtol 1e-4, GQA included;
- the contiguous and the paged decode of ``TransformerLM`` against a
  full forward's logits, 1e-4;
- ``generate``: greedy, ragged ``prompt_lens``, learned positions, RoPE
  and GQA, token-identical to the JAX package's ``generate``; its
  validation errors; sampling from a ``torch.Generator``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as jtr
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import flash_attention as tfa

import torch_serving_helpers as H

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pool(seed, b, h, hkv, d, page, n_pages, per_seq, table):
    rng = np.random.RandomState(seed)
    L = per_seq * page
    q = rng.randn(b, 1, h, d).astype(np.float32)
    ck = rng.randn(b, L, hkv, d).astype(np.float32)
    cv = rng.randn(b, L, hkv, d).astype(np.float32)
    kp = np.zeros((n_pages, page, hkv, d), np.float32)
    vp = np.zeros((n_pages, page, hkv, d), np.float32)
    for row in range(b):
        for j in range(per_seq):
            kp[table[row, j]] = ck[row, j * page:(j + 1) * page]
            vp[table[row, j]] = cv[row, j * page:(j + 1) * page]
    return q, ck, cv, kp, vp


# the JAX package's paged-gather trace (tests/test_serving_engine.py), with
# and without GQA
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_decode_and_paged_attention_match_jax(hkv):
    b, h, d, page, n_pages, per_seq = 2, 4, 8, 4, 9, 3
    table = np.array([[5, 2, 7], [1, 8, 3]], np.int32)
    q, ck, cv, kp, vp = _pool(0, b, h, hkv, d, page, n_pages, per_seq, table)
    start = np.array([5, 9], np.int32)
    want = np.asarray(jfa.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(start)))
    got = tfa.decode_attention(_t(q), _t(ck), _t(cv), _t(start).long())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_p = np.asarray(jfa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start), page_size=page))
    got_p = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp),
                                       _t(table).long(), _t(start).long(),
                                       page_size=page)
    np.testing.assert_allclose(got_p.numpy(), want_p, **TOL)
    # the paged gather is the contiguous path exactly (both packages)
    np.testing.assert_array_equal(got_p.numpy(), got.numpy())
    # the model module's historical alias
    np.testing.assert_array_equal(
        ttr._decode_attention(_t(q), _t(ck), _t(cv), _t(start).long()).numpy(),
        got.numpy())


def test_paged_attention_zeroes_a_poisoned_recycled_page():
    """A page recycled from a poisoned generation holds NaN past the
    frontier: the output stays finite and equal to the clean pool's, as
    in the JAX package."""
    b, h, hkv, d, page, n_pages, per_seq = 2, 4, 2, 8, 4, 9, 3
    table = np.array([[5, 2, 7], [1, 8, 3]], np.int32)
    q, _, _, kp, vp = _pool(1, b, h, hkv, d, page, n_pages, per_seq, table)
    start = np.array([5, 6], np.int32)   # rows end inside pages 2 and 8
    clean = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp),
                                       _t(table).long(), _t(start).long(),
                                       page_size=page)
    kp2, vp2 = kp.copy(), vp.copy()
    for pg in (7, 3):                     # wholly past both frontiers
        kp2[pg] = np.nan
        vp2[pg] = np.nan
    kp2[2, 2:] = np.nan                   # row 0's page, past position 5
    vp2[2, 2:] = np.nan
    got = tfa.paged_decode_attention(_t(q), _t(kp2), _t(vp2),
                                     _t(table).long(), _t(start).long(),
                                     page_size=page)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), clean.numpy())
    want = np.asarray(jfa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp2), jnp.asarray(vp2),
        jnp.asarray(table), jnp.asarray(start), page_size=page))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tp_paged_attention_is_the_head_blocks_of_jax():
    """The JAX version shards the heads of a 2-device mesh; the port's
    ranks hold their head blocks and call the plain paged decode on
    them (checked here per block, and the port's wrapper over an axis
    of size 1)."""
    b, h, hkv, d, page, n_pages, per_seq = 2, 4, 2, 8, 4, 9, 3
    table = np.array([[5, 2, 7], [1, 8, 3]], np.int32)
    q, _, _, kp, vp = _pool(2, b, h, hkv, d, page, n_pages, per_seq, table)
    start = np.array([3, 10], np.int32)
    jhvd.init(devices=jax.devices()[:2], axes={"tp": 2})
    try:
        want = np.asarray(jfa.tp_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(start), page_size=page,
            axis="tp"))
    finally:
        jhvd.shutdown()
    n = 2
    blocks = [tfa.paged_decode_attention(
        _t(q[:, :, r * h // n:(r + 1) * h // n]),
        _t(kp[:, :, r * hkv // n:(r + 1) * hkv // n]),
        _t(vp[:, :, r * hkv // n:(r + 1) * hkv // n]),
        _t(table).long(), _t(start).long(), page_size=page)
        for r in range(n)]
    np.testing.assert_allclose(torch.cat(blocks, dim=2).numpy(), want, **TOL)


def test_tp_paged_attention_validates_head_blocks():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import build_mesh

    hvd.init(device="cpu", init_method=f"tcp://127.0.0.1:{_port()}")
    try:
        build_mesh({"tp": 1})
        q = torch.randn(1, 1, 3, 4)
        kp = torch.randn(4, 2, 2, 4)
        table = torch.zeros(1, 2, dtype=torch.long)
        with pytest.raises(ValueError, match="not a multiple"):
            tfa.tp_paged_decode_attention(q, kp, kp, table,
                                          torch.zeros(1, dtype=torch.long),
                                          page_size=2)
        out = tfa.tp_paged_decode_attention(
            torch.randn(1, 1, 4, 4), kp, kp, table,
            torch.zeros(1, dtype=torch.long), page_size=2)
        assert out.shape == (1, 1, 4, 4)
    finally:
        hvd.shutdown()


def _port():
    from horovod_tpu_torch.testing import free_port

    return free_port()


# ------------------------------------------------------------ decode modes

MODELS = {"learned": dict(), "rope": dict(pos="rope"),
          "rope_gqa": dict(pos="rope", kv_heads=2)}


@pytest.mark.parametrize("case", list(MODELS))
def test_cached_decode_matches_full_forward(case):
    """Prefill of 10 tokens then 3 single-token steps against the
    contiguous cache, and the same in 4-token chunks against a shuffled
    page pool: each step's logits are the full forward's at that
    position (and the JAX model's)."""
    jm, tm, p = H.pair(**MODELS[case])
    tok = np.random.RandomState(3).randint(1, H.VOCAB, (2, 13)).astype(
        np.int64)
    full = tm(torch.from_numpy(tok)).detach().numpy()
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(tok)))
    np.testing.assert_allclose(full, want, **TOL)
    with torch.no_grad():
        cache = tm.decode_cache(2, 16)
        pos = torch.arange(10)[None].expand(2, 10)
        got = [tm(torch.from_numpy(tok[:, :10]), pos, cache)]
        for i in range(10, 13):
            got.append(tm(torch.from_numpy(tok[:, i:i + 1]),
                          torch.full((2, 1), i), cache))
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), full, **TOL)
        page, per_seq = 4, 4
        pool = tm.paged_cache(12, page)
        table = torch.tensor([[3, 9, 1, 6], [11, 2, 7, 5]])
        got = []
        for c0 in range(0, 12, 4):
            pos = torch.arange(c0, c0 + 4)[None].expand(2, 4)
            got.append(tm(torch.from_numpy(tok[:, c0:c0 + 4]), pos, pool,
                          table))
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), full[:, :12],
                                   **TOL)
        assert per_seq * page >= 12


def test_paged_pad_tail_goes_to_trash_and_clamps():
    """A chunk whose positions run past the table (a pad tail) writes
    through the clamped last page, and learned positions past max_len are
    clamped, not an index error."""
    _, tm, _ = H.pair()
    pool = tm.paged_cache(4, 4)
    table = torch.tensor([[1, 2]])
    pos = torch.arange(60, 68)[None]       # past the table and max_len 64
    with torch.no_grad():
        out = tm(torch.ones(1, 8, dtype=torch.long), pos, pool, table)
    assert torch.isfinite(out).all()
    assert torch.count_nonzero(pool[0][0][0]) == 0   # page 0 untouched here


@pytest.mark.parametrize("case", list(MODELS))
def test_generate_greedy_ragged_matches_jax(case):
    jm, tm, p = H.pair(**MODELS[case])
    prompts = H.ragged_prompts(0, [7, 3, 11, 5])
    want = H.jax_generate(jm, p, prompts, 6)
    got = H.port_generate(tm, prompts, 6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # the same weights passed as a flax tree to a parameterless twin
    meta = ttr.TransformerLM(**tm.config(), device="meta")
    np.testing.assert_array_equal(
        np.concatenate(H.port_generate(meta, prompts, 6, params=p)),
        np.concatenate(got))


def test_generate_unragged_and_output_layout():
    jm, tm, p = H.pair()
    prompt = np.random.RandomState(4).randint(1, H.VOCAB, (3, 5)).astype(
        np.int32)
    want = np.asarray(jtr.generate(jm, p, prompt, max_new_tokens=4))
    got = ttr.generate(tm, None, prompt, max_new_tokens=4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw,match", [
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(max_new_tokens=70), "exceeds max_len"),
    (dict(max_new_tokens=2, temperature=1.0), "Generator"),
    (dict(max_new_tokens=2, prompt_lens=[1, 2, 3]), r"\[B\]"),
    (dict(max_new_tokens=2, prompt_lens=[0, 5]), r"in \[1, 5\]"),
    (dict(max_new_tokens=2, prompt_lens=[1, 6]), r"in \[1, 5\]"),
])
def test_generate_validation_errors(kw, match):
    _, tm, _ = H.pair()
    with pytest.raises(ValueError, match=match):
        ttr.generate(tm, None, np.ones((2, 5), np.int32), **kw)


def test_generate_samples_from_a_torch_generator():
    _, tm, _ = H.pair()
    prompt = np.ones((2, 3), np.int32)
    draws = [ttr.generate(tm, None, prompt, max_new_tokens=8,
                          temperature=1.0,
                          generator=torch.Generator().manual_seed(s))
             for s in (5, 5, 6)]
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    assert not np.array_equal(draws[0].numpy(), draws[2].numpy())
    assert int(draws[0].max()) < H.VOCAB and int(draws[0].min()) >= 0
