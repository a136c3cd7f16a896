"""Sequence parallelism of the port (``horovod_tpu_torch.parallel``'s ring,
zigzag ring and Ulysses attention, and ``training.make_sp_train_step``)
in gloo worlds of 2, 4 and 8 over a ``seq`` axis, against the JAX
package's functions on the matching CPU mesh (``shard_map``), on the same
seeded numpy inputs.

Tolerances are the JAX oracles' (``tests/test_ring_attention.py``,
``tests/test_transformer.py``): attention outputs rtol/atol 2e-5 and
their gradients rtol/atol 2e-4, against dense attention and against the
JAX package's own sharded result; the SP step's loss rtol 1e-5 and its
parameters after one SGD step rtol 1e-4 / atol 1e-5 against the dense
single-device step. The ring's gradients are those of the global loss
(its backward is a second ring pass, not autodiff through psums), so
they compare as they are.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import collective as JCol
from horovod_tpu.ops.flash_attention import flash_attention as jflash
from horovod_tpu.parallel import (
    SEQUENCE_AXIS, build_mesh, ring_attention, ulysses_attention,
    zigzag_permutation, zigzag_ring_attention,
)
from horovod_tpu_torch.parallel import zigzag_permutation as t_zigzag
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

OUT = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def dense_attention(q, k, v, causal=False):
    d = q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        mask = np.tril(np.ones((q.shape[1], k.shape[1]), bool))
        s = np.where(mask[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def qkv(b=2, t=64, h=4, d=16, seed=0, h_kv=None):
    rng = np.random.RandomState(seed)
    mk = lambda hh: rng.randn(b, t, hh, d).astype(np.float32)  # noqa: E731
    return mk(h), mk(h_kv or h), mk(h_kv or h)


def _rep(x, g):
    return np.repeat(x, g, axis=2)


#: (kind, kwargs, q/k/v, grad, zigzag, causal): each world's cases, the
#: JAX tests' shapes
def _cases():
    c = {8: [], 4: [], 2: []}
    for causal in (False, True):
        c[8].append(("ring", dict(causal=causal, block_k=8),
                     qkv(2, 64, 2, 16), False, False, causal))
        c[4].append(("ulysses", dict(causal=causal), qkv(2, 32, 4, 8, 1),
                     False, False, causal))
    c[4].append(("ring", dict(causal=True, block_k=8), qkv(1, 32, 2, 8, 3),
                 True, False, True))
    c[8].append(("ring", dict(causal=True, block_k=4), qkv(1, 128, 2, 8, 2),
                 False, False, True))
    c[8].append(("ulysses", dict(), qkv(1, 32, 3, 8), False, False, False))
    for n, t in ((4, 64), (8, 64), (2, 32)):
        c[n].append(("zigzag", dict(block_k=8), qkv(2, t, 2, 16, 5), False,
                     True, True))
    c[4].append(("zigzag", dict(block_k=8), qkv(1, 32, 2, 8, 7), True, True,
                 True))
    c[8].append(("zigzag", dict(block_k=8), qkv(1, 8, 2, 8), False, False,
                 True))
    gqa = qkv(1, 32, 4, 8, 10, h_kv=2)
    c[4].append(("ring", dict(causal=True, block_k=8), gqa, False, False,
                 True))
    c[4].append(("ulysses", dict(causal=True), gqa, False, False, True))
    for h, h_kv in ((8, 4), (8, 2), (4, 1)):
        c[4].append(("ulysses", dict(causal=True), qkv(1, 32, h, 8, 13, h_kv),
                     False, False, True))
    gqa_g = qkv(1, 32, 4, 8, 11, h_kv=2)
    c[4].append(("ring", dict(causal=True, block_k=8), gqa_g, True, False,
                 True))
    c[4].append(("zigzag", dict(block_k=8), gqa_g, True, True, True))
    # ulysses gradients (the all-to-all's backward, the flash backward)
    c[4].append(("ulysses", dict(causal=True), qkv(1, 32, 4, 8, 14), True,
                 False, True))
    c[2].append(("ulysses", dict(causal=True), qkv(1, 32, 4, 8, 14, 1), True,
                 False, True))
    return c


CASES = _cases()
IDS = [(n, i) for n in CASES for i in range(len(CASES[n]))]


def _perm(n, case):
    t = case[2][0].shape[1]
    return zigzag_permutation(t, n) if case[4] else np.arange(t)


def _jax_case(n, case):
    kind, kw, (q, k, v), grad, _zz, _causal = case
    mesh = build_mesh({SEQUENCE_AXIS: n}, devices=jax.devices()[:n])
    fn = {"ring": ring_attention, "zigzag": zigzag_ring_attention,
          "ulysses": functools.partial(
              ulysses_attention, attention_fn=functools.partial(
                  jflash, use_pallas=False))}[kind]
    spec = P(None, SEQUENCE_AXIS, None, None)
    sm = JCol._smap(functools.partial(fn, **kw), mesh, (spec,) * 3, spec)
    sh = NamedSharding(mesh, spec)
    perm = _perm(n, case)
    args = [jax.device_put(jnp.asarray(a[:, perm]), sh) for a in (q, k, v)]
    try:
        out = np.asarray(jax.jit(sm)(*args))
    except ValueError as e:
        return {"error": str(e)}
    res = {"out": out}
    if grad:
        res["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
            lambda a, b, c: (sm(a, b, c) ** 2).sum(), argnums=(0, 1, 2)))(
                *args)]
    return res


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futs = {n: pool.submit(
            run_world, W.ring_worker, n,
            [(c[0], c[1]) + tuple(a[:, _perm(n, c)] for a in c[2])
             + (c[3],) for c in CASES[n]], timeout=300) for n in CASES}
        ref = {n: [_jax_case(n, c) for c in CASES[n]] for n in CASES}
        port = {n: f.result() for n, f in futs.items()}
    return port, ref


@pytest.mark.parametrize("n,i", IDS)
def test_attention_matches_jax_and_dense(runs, n, i):
    """Each case's output shards (and q/k/v gradient shards where asked)
    against the JAX package's over the same ``seq`` mesh, and the gathered
    output against dense attention on the un-permuted sequence (GQA
    against repeated heads); the rejections (Ulysses with heads not
    divisible by the axis, zigzag with an odd local length) raise the
    JAX package's text."""
    port, ref = runs
    kind, kw, (q, k, v), grad, zz, causal = CASES[n][i]
    want = ref[n][i]
    tl = q.shape[1] // n
    if "error" in want:
        for r in range(n):
            assert port[n][r][i]["error"] == want["error"]
        return
    perm = _perm(n, CASES[n][i])
    inv = np.argsort(perm)
    g = q.shape[2] // k.shape[2]
    dense = dense_attention(q, _rep(k, g), _rep(v, g), causal=causal)
    full = np.concatenate([port[n][r][i]["out"] for r in range(n)], axis=1)
    _close(full[:, inv], dense, **OUT)
    for r in range(n):
        sl = slice(r * tl, (r + 1) * tl)
        _close(port[n][r][i]["out"], want["out"][:, sl], **OUT)
        if grad:
            for got, w in zip(port[n][r][i]["grads"], want["grads"]):
                _close(got, w[:, sl], **GRAD)


def test_zigzag_permutation_matches_jax():
    perm = t_zigzag(16, 4)
    assert perm.tolist() == [0, 1, 14, 15, 2, 3, 12, 13, 4, 5, 10, 11, 6,
                             7, 8, 9]
    for t, n in ((64, 4), (64, 8), (32, 2), (2048, 4)):
        np.testing.assert_array_equal(t_zigzag(t, n),
                                      zigzag_permutation(t, n))
    with pytest.raises(ValueError) as jerr:
        zigzag_permutation(12, 8)
    with pytest.raises(ValueError) as terr:
        t_zigzag(12, 8)
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------- the SP step


def _lm_data():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 1024, (4, 64)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


TINY = dict(vocab=1024, dim=64, depth=2, heads=4, max_len=4096)


def _jax_tiny(**kw):
    from horovod_tpu.models import TransformerTiny

    return TransformerTiny(dtype=jnp.float32, **kw)


def _jax_params(tokens, **kw):
    from horovod_tpu_torch.models.convert import flatten_tree

    p = jax.jit(_jax_tiny(**kw).init)(jax.random.PRNGKey(0),
                                      jnp.asarray(tokens[:1]))["params"]
    return p, {k: np.asarray(a) for k, a in flatten_tree(p).items()}


def _jax_dense(params, tokens, targets, lr, **kw):
    import optax

    from horovod_tpu_torch.models.convert import flatten_tree

    model = _jax_tiny(**kw)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tokens))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(targets)[..., None], -1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new = optax.apply_updates(params, jax.tree_util.tree_map(
        lambda g: -lr * g, grads))
    return float(loss), {k: np.asarray(a)
                         for k, a in flatten_tree(new).items()}


def _sp_world(flat, tokens, targets, axes, steps, opt, lr, attention,
              **cfg_kw):
    n = int(np.prod(list(axes.values())))
    return run_world(W.sp_step_worker, n, dict(TINY, **cfg_kw), flat,
                     tokens.astype(np.int64), targets.astype(np.int64), axes,
                     steps, opt, lr, attention, 8, timeout=300)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_sp_step_matches_dense_single_step(attention):
    """One SP step (data 1 x seq 8, SGD 0.1) == the dense single-device
    step on the same data: loss rtol 1e-5, every parameter rtol 1e-4 /
    atol 1e-5 (the JAX oracle's bars), with ring attention and with
    Ulysses (heads 4 over seq 4: data 2 x seq 4)."""
    tokens, targets = _lm_data()
    params, flat = _jax_params(tokens)
    axes = ({"data": 1, "seq": 8} if attention == "ring"
            else {"data": 2, "seq": 4})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_sp_world, flat, tokens, targets, axes, 1, "sgd",
                          0.1, attention)
        loss_d, new = _jax_dense(params, tokens, targets, 0.1)
        port = fut.result()
    for res in port:
        _close(res["losses"][0], loss_d, rtol=1e-5)
        for k, a in new.items():
            _close(res["params"][k], a, rtol=1e-4, atol=1e-5, err_msg=k)


def test_rope_sp_matches_dense_single_step():
    """RoPE under sequence parallelism: each shard's global positions
    phase K as the dense run does (loss rtol 1e-5)."""
    tokens, targets = _lm_data()
    params, flat = _jax_params(tokens, pos_embedding="rope")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_sp_world, flat, tokens, targets,
                          {"data": 1, "seq": 8}, 1, "sgd", 0.1, "ring",
                          pos_embedding="rope")
        loss_d, _ = _jax_dense(params, tokens, targets, 0.1,
                               pos_embedding="rope")
        port = fut.result()
    for res in port:
        _close(res["losses"][0], loss_d, rtol=1e-5)


def _jax_sp_losses(params, tokens, targets):
    import optax

    from horovod_tpu.training import make_sp_train_step, replicate

    jhvd.init(axes={"data": 2, SEQUENCE_AXIS: 4})
    try:
        model = _jax_tiny(attention_fn=functools.partial(
            ring_attention, axis_name=SEQUENCE_AXIS, block_k=8))
        tx = optax.adam(1e-2)
        p, st = replicate(params), replicate(tx.init(params))
        sh = NamedSharding(jhvd.mesh(), P("data", SEQUENCE_AXIS))
        tok = jax.device_put(jnp.asarray(tokens), sh)
        tgt = jax.device_put(jnp.asarray(targets), sh)
        step = make_sp_train_step(model, tx, seq_axis=SEQUENCE_AXIS,
                                  donate=False)
        losses = []
        for _ in range(8):
            p, st, loss = step(p, st, tok, tgt)
            losses.append(float(loss))
        return losses
    finally:
        jhvd.shutdown()


def test_sp_train_step_loss_decreases_as_jax():
    """data 2 x seq 4, ring attention, Adam(1e-2), 8 steps: every rank the
    same losses, falling (the JAX test's bar), the first equal to the JAX
    package's ``make_sp_train_step``'s (rtol 1e-5) and the trajectory
    within rtol 1e-3 of it (Adam amplifies last-bit differences)."""
    tokens, targets = _lm_data()
    params, flat = _jax_params(tokens)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_sp_world, flat, tokens, targets,
                          {"data": 2, "seq": 4}, 8, "adam", 1e-2, "ring")
        want = _jax_sp_losses(params, tokens, targets)
        port = fut.result()
    for res in port:
        assert res["losses"] == port[0]["losses"]
        assert np.isfinite(res["losses"]).all()
        assert res["losses"][-1] < res["losses"][0]
        _close(res["losses"][0], want[0], rtol=1e-5)
        _close(res["losses"], want, rtol=1e-3)
