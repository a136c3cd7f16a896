"""horovod_tpu_torch.models.transformer, ``adamw`` and ``lm_xent`` against
the JAX package (flax, optax) on the same numpy inputs and weights, in
f32 on the CPU, and the slice end to end.

- ``apply_rope`` at 1e-6;
- TransformerLM logits and the gradient of every parameter leaf of the
  LM loss, weights carried across with ``load_flax_variables``, at 1e-4
  (learned and RoPE positions, GQA, dense and flash attention): the two
  frameworks sum matrix products in other orders;
- ``adamw`` against jitted ``optax.adamw`` for 5 steps at rtol 1e-6
  (jitted optax contracts its elementwise chain into FMAs; the port
  rounds each operation);
- the slice: 3 steps of ``DistributedOptimizer(adamw)`` + ``lm_xent``
  through ``make_train_step`` on a gloo world of 2 against the JAX
  package's ``make_jit_train_step`` on 2 CPU devices with the same
  global batch: loss at 1e-4 relative, parameters at rtol 1e-4 (there is
  no lossy wire).
"""

import concurrent.futures
import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as jtr
from horovod_tpu.ops.flash_attention import flash_attention as jflash
from horovod_tpu.training import make_jit_train_step, replicate, shard_batch
from horovod_tpu_torch import optim as topt
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import flatten_tree, load_flax_variables
from horovod_tpu_torch.ops.flash_attention import flash_attention as tflash
from horovod_tpu_torch.testing import run_world
from horovod_tpu_torch.training import lm_xent, token_xent

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

VOCAB, DIM, DEPTH, HEADS, T = 97, 64, 2, 4, 32


def _jax_lm_xent(logits, tgts):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, tgts[..., None], axis=-1))


def _tokens(seed, b):
    r = np.random.RandomState(seed)
    tok = r.randint(0, VOCAB, (b, T)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def test_apply_rope_matches_jax():
    r = np.random.RandomState(0)
    x = r.randn(2, 64, 4, 16).astype(np.float32)
    pos = np.arange(64)[None] + 5
    want = np.asarray(jax.jit(jtr.apply_rope)(jnp.asarray(x), jnp.asarray(pos)))
    got = ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert ttr.apply_rope(xb, torch.from_numpy(pos)).dtype == torch.bfloat16


# (pos_embedding, kv_heads, attention)
MODELS = {
    "learned_dense": ("learned", None, "dense"),
    "learned_flash": ("learned", None, "flash"),
    "rope_flash": ("rope", None, "flash"),
    "rope_gqa_flash": ("rope", 2, "flash"),
}


def _jax_model(pos, kv_heads, attn):
    fn = (functools.partial(jflash, use_pallas=False, block_k=8)
          if attn == "flash" else jtr.default_attention)
    return jtr.TransformerLM(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                             kv_heads=kv_heads, max_len=64,
                             dtype=jnp.float32, attention_fn=fn,
                             pos_embedding=pos)


def _port_model(pos, kv_heads, attn):
    fn = (functools.partial(tflash, block_k=8) if attn == "flash"
          else ttr.default_attention)
    return ttr.TransformerLM(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                             kv_heads=kv_heads, max_len=64,
                             dtype=torch.float32, attention_fn=fn,
                             pos_embedding=pos)


def _flax_params(model, seed=0):
    tok, _ = _tokens(seed, 1)
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(tok))
    return jax.tree_util.tree_map(np.asarray, v["params"])


@pytest.mark.parametrize("case", list(MODELS))
def test_logits_and_gradients_match_flax(case):
    jm, tm = _jax_model(*MODELS[case]), _port_model(*MODELS[case])
    params = _flax_params(jm)
    load_flax_variables(tm, params)
    tok, tgt = _tokens(1, 2)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tok))
        return _jax_lm_xent(logits, jnp.asarray(tgt)), logits

    (lj, logits_j), gj = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    logits = tm(torch.from_numpy(tok))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=1e-4)
    loss = lm_xent(logits, torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    loss.backward()
    grads = {k: v.numpy() for k, v in tm.jax_grads().items()}
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, gj))
    assert set(grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, atol=1e-4, rtol=1e-4, err_msg=k)


def test_bf16_model_runs_in_bf16_with_f32_logits():
    tm = ttr.TransformerTiny(vocab=VOCAB, pos_embedding="rope",
                             attention_fn=tflash, seed=3)
    tok, tgt = _tokens(2, 2)
    logits = tm(torch.from_numpy(tok))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, T, VOCAB)
    lm_xent(logits, torch.from_numpy(tgt)).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters())


def test_flagship_configuration_matches_flax_shapes():
    """The slice's configuration (dim 1024, depth 12, heads 16, RoPE):
    the port's flax-keyed leaves have flax's shapes, 216,643,584
    parameters (abstract shapes only, nothing allocated)."""
    jm = jtr.TransformerLM(vocab=32000, dim=1024, depth=12, heads=16,
                           max_len=2048, pos_embedding="rope")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    tm = ttr.TransformerLM(vocab=32000, dim=1024, depth=12, heads=16,
                           max_len=2048, pos_embedding="rope", device="meta")
    got = {k: tuple(v.shape) for k, v in tm.jax_params().items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 216_643_584
    for fn, jfn in ((ttr.TransformerTiny, jtr.TransformerTiny),
                    (ttr.TransformerSmall, jtr.TransformerSmall)):
        j = jfn()
        t = fn(device="meta")
        assert (t.tok_embed.embedding.shape, t.depth, t.max_len) == (
            (j.vocab, j.dim), j.depth, j.max_len)


def test_init_follows_flax_distributions():
    tm = ttr.TransformerLM(vocab=512, dim=128, depth=1, heads=4, max_len=256,
                           seed=5)
    p = {k: v.detach() for k, v in tm.jax_params().items()}
    assert abs(float(p["tok_embed/embedding"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(p["pos_embed"].std()) - 0.02) < 0.002
    w = p["block0/mlp_up/kernel"]
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01       # lecun_normal
    assert float(w.abs().max()) <= 2 * 128 ** -0.5 / 0.8796 + 1e-6
    assert float(p["block0/ln1/scale"].min()) == 1.0
    assert float(p["block0/mlp_up/bias"].abs().max()) == 0.0
    again = ttr.TransformerLM(vocab=512, dim=128, depth=1, heads=4,
                              max_len=256, seed=5).jax_params()
    assert all(torch.equal(v, again[k]) for k, v in p.items())


def test_adamw_matches_optax_adamw():
    r = np.random.RandomState(21)
    params = {"w": r.randn(40, 30).astype(np.float32),
              "b": r.randn(30).astype(np.float32) * 0.1}
    grads = [{k: r.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    tx = optax.adamw(1e-2)
    upd = jax.jit(tx.update)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = tx.init(pj)
    port = topt.adamw(1e-2)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = port.init(pt)
    for g in grads:
        uj, sj = upd({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = port.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, pt)
        for k in params:
            np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
        pt = {k: pt[k] + ut[k] for k in pt}
    assert st["count"] == 5
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6,
                                   atol=2 * np.spacing(np.float32(1e-2)))
        # moments of O(1) gradients: FMA contraction moves them by ULPs
        # of their terms, not of a moment that cancels to near 0
        np.testing.assert_allclose(st["mu"][k].numpy(), np.asarray(sj[0].mu[k]),
                                   rtol=1e-6, atol=2 * np.spacing(np.float32(1)))
    with pytest.raises(ValueError, match="needs params"):
        port.update({k: torch.from_numpy(v) for k, v in grads[0].items()}, st)


# --------------------------------------------------------------------------
# the slice: DistributedOptimizer(adamw) + lm_xent, world of 2

N, STEPS, LR = 2, 3, 1e-4   # the flagship configuration's learning rate
SLICE_CASE = "rope_gqa_flash"


@pytest.fixture(scope="module")
def slice_runs():
    jm = _jax_model(*MODELS[SLICE_CASE])
    params = _flax_params(jm, seed=4)
    tok, tgt = _tokens(5, 2 * N)
    cfg = dict(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, kv_heads=2,
               max_len=64, pos_embedding="rope")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port_run = pool.submit(run_world, W.lm_slice_worker, N, cfg, params,
                               tok, tgt, STEPS, LR)
        ref = _jax_slice(jm, params, tok, tgt)
        port = port_run.result()
    return params, port, ref


def _jax_slice(model, params, tok, tgt):
    jhvd.init(devices=jax.devices()[:N])
    try:
        tx = jhvd.DistributedOptimizer(optax.adamw(LR))
        p = replicate(jax.tree_util.tree_map(jnp.asarray, params))
        st = replicate(tx.init(p))
        step = make_jit_train_step(model, tx, loss_fn=_jax_lm_xent,
                                   instrument=False)
        xs, ys = shard_batch(tok), shard_batch(tgt)
        stats, losses = {}, []
        for _ in range(STEPS):
            p, stats, st, loss = step(p, stats, st, xs, ys)
            losses.append(float(loss))
        return {"losses": losses,
                "params": flatten_tree(jax.tree_util.tree_map(np.asarray, p))}
    finally:
        jhvd.shutdown()


def test_slice_losses_track_jax(slice_runs):
    _, port, ref = slice_runs
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], ref["losses"], rtol=1e-4)
    assert port[0]["losses"][-1] < port[0]["losses"][0]


def test_slice_params_track_jax(slice_runs):
    params, port, ref = slice_runs
    start = flatten_tree(params)
    assert set(port[0]["params"]) == set(ref["params"])
    for k, want in ref["params"].items():
        got = port[0]["params"][k]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * LR,
                                   err_msg=k)
        assert np.array_equal(got, port[1]["params"][k]), k
        assert not np.array_equal(got, start[k]), k


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_token_xent_matches_jax(dtype):
    """``training.token_xent`` (the JAX package's name for the LM loss)
    against ``horovod_tpu.training.token_xent`` on the same logits
    ``[2, 5, 11]`` and targets: log-softmax in f32 (bf16 logits widened
    first), the mean over every token, within 1e-6."""
    from horovod_tpu.training import token_xent as jtoken_xent

    r = np.random.RandomState(91)
    logits = (r.randn(2, 5, 11) * 3).astype(np.float32)
    targets = r.randint(0, 11, (2, 5)).astype(np.int32)
    tl = torch.from_numpy(logits)
    jl = jnp.asarray(logits)
    if dtype == "bfloat16":
        tl, jl = tl.bfloat16(), jl.astype(jnp.bfloat16)
    got = token_xent(tl, torch.from_numpy(targets))
    want = jtoken_xent(jl, jnp.asarray(targets))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) == float(lm_xent(tl, torch.from_numpy(targets)))
