"""The rest of the port's ``DistributedOptimizer`` against the JAX
package's, on a gloo world of 2 (and 4 for ``quantized_reducescatter``)
and the JAX package's bound-axis step on a 2- (4-) device mesh.

- ``gradient_predivide_factor`` (``none``/``fp16``, with and without
  error feedback): the updates and residuals bit for bit over two steps
  (``tests/test_optim.py::test_error_feedback_tracks_predivide_rounding``
  at the wire: the residual is measured against ``compress(g / f) * f``);
- ``backward_passes_per_step`` k = 2 and 3 (allreduce mode with and
  without int8 + EF, and ZeRO-1): bit for bit against the JAX package's
  ``optax.MultiSteps(DistributedOptimizer(...))`` — every update (zeros
  between emits), ``mini_step``, ``gradient_step``, the accumulated mean
  and the residual — with the inner optimizer the identity, so the pin
  is the accumulation and the exchange; no ``torch.distributed`` call on
  a step that does not emit;
- ``quantized_reducescatter`` bit for bit at N = 2 and 4;
- ``DistributedGradientTape``: Average and Sum with ``none``/``fp16``/
  ``int8`` bit for bit, Adasum (and with ``fp16``) within the Adasum bar
  (rtol 2e-5 / atol 2e-6, ``tests/test_optim.py:25-130``); the loss rides
  through; a 2-tuple is ``(loss, grads)`` only with a 0-d first element;
- the env defaults (``HOROVOD_SHARD_OPTIMIZER``, ``HOROVOD_SHARD_PARAMS``,
  ``HOROVOD_COMPRESSION``, ``HOROVOD_POWERSGD_RANK``, ``HOROVOD_OVERLAP``,
  ``HOROVOD_BUCKET_BYTES``), as ``tests/test_compression.py:553`` and
  ``tests/test_overlap.py:121`` pin them for the JAX package;
- every combination the JAX package refuses, refused with its message;
  ``numerics_guard``/``loss_scale`` and bucketed ZeRO-3 raise (not
  ported), never ignored.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops import collective as JCol
from horovod_tpu.optim import _EFState
import horovod_tpu_torch as hvd
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N = 2
JCOMP = {"none": JC.none, "fp16": JC.fp16, "int8": JC.int8}


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    return np.array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params():
    r = np.random.RandomState(60)
    return {"w": (r.randn(40, 30) * 0.1).astype(np.float32),
            "b": np.zeros(30, np.float32), "e": r.randn(1500).astype(
                np.float32)}


def _steps(count, seed):
    r = np.random.RandomState(seed)
    return [{k: (r.randn(N, *v.shape) * 10.0 ** r.randint(-3, 1))
             .astype(np.float32) for k, v in _params().items()}
            for _ in range(count)]


PRED = {"fp16_ef": ("fp16", True, 3.0), "fp16": ("fp16", False, 3.0),
        "none": ("none", False, 3.0), "fp16_ef_f4": ("fp16", True, 4.0)}
MULTI = {"k2_none": (2, "none", False, False),
         "k3_int8_ef": (3, "int8", True, False),
         "k2_zero1_int8_ef": (2, "int8", True, True)}
MULTI_STEPS = 7
TAPE = {"avg_none": (0, "none"), "avg_fp16": (0, "fp16"),
        "avg_int8": (0, "int8"), "sum_fp16": (1, "fp16"),
        "adasum_none": (2, "none"), "adasum_fp16": (2, "fp16")}
TAPE_OPS = {0: JCol.Average, 1: JCol.Sum, 2: JCol.Adasum}


def _tape_tree():
    r = np.random.RandomState(61)
    return {"a": (r.randn(N, 2000).astype(np.float32), "float32"),
            "b": (r.randn(N, 40, 30).astype(np.float32), "float32"),
            "c": (r.randn(N, 7).astype(np.float32), "float32")}


def _qrs_flat(n):
    r = np.random.RandomState(62 + n)
    x = r.randn(n, n * 1000 + n * 3).astype(np.float32)
    x[0, 5] = np.nan
    x[:, 700:1200] = 0.0
    return x


@functools.lru_cache(maxsize=None)
def _port(n):
    inp = {"qrs": _qrs_flat(n)}
    if n == N:
        inp.update(predivide=(_params(), _steps(2, 63), PRED),
                   multisteps=(_params(), _steps(MULTI_STEPS, 64), MULTI),
                   tape=(_tape_tree(), TAPE))
    return run_world(W.slice10_worker, n, inp, timeout=240)


@functools.lru_cache(maxsize=None)
def _jax(n):
    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        ref = {"qrs": _jax_qrs(mesh, ax)}
        if n == N:
            ref["predivide"] = {k: _jax_predivide(mesh, ax, *v)
                                for k, v in PRED.items()}
            ref["multisteps"] = {k: _jax_multisteps(mesh, ax, *v)
                                 for k, v in MULTI.items()}
            ref["tape"] = {k: _jax_tape(mesh, ax, *v) for k, v in TAPE.items()}
    finally:
        jhvd.shutdown()
    return ref


def _jax_qrs(mesh, ax):
    n = mesh.devices.size

    def body(x):
        return JCol.quantized_reducescatter(x[0], axis=ax)[None]

    out = jax.jit(JCol._smap(body, mesh, (P(ax),), P(ax)))(
        jnp.asarray(_qrs_flat(n)))
    return np.asarray(out)


def _stacked(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ef_step(dtx, p, spec_state):
    """A bound-axis step of an allreduce-mode ``dtx`` whose state holds a
    per-rank residual: the residual travels stacked ``[N, ...]``."""
    def step(rr, gg):
        gg = jax.tree_util.tree_map(lambda x: x[0], gg)
        rr = jax.tree_util.tree_map(lambda x: x[0], rr)
        u, ss = dtx.update(gg, _EFState(optax.EmptyState(), rr), p)
        return u, jax.tree_util.tree_map(lambda x: x[None], ss.residual)
    return step


def _jax_predivide(mesh, ax, comp, ef, pf):
    dtx = jhvd.DistributedOptimizer(optax.identity(), compression=JCOMP[comp],
                                    error_feedback=ef,
                                    gradient_predivide_factor=pf)
    p = _stacked(_params())
    ups = []
    if ef:
        res = {k: jnp.zeros((N,) + v.shape) for k, v in p.items()}
        f = jax.jit(JCol._smap(_ef_step(dtx, p, None), mesh, (P(ax), P(ax)),
                               (P(), P(ax))))
        for g in _steps(2, 63):
            u, res = f(res, _stacked(g))
            ups.append({k: _np(v) for k, v in u.items()})
        return {"updates": ups, "residual": {k: np.asarray(v)
                                             for k, v in res.items()}}
    s = dtx.init(p)

    def step(ss, gg):
        gg = jax.tree_util.tree_map(lambda x: x[0], gg)
        return dtx.update(gg, ss, p)
    f = jax.jit(JCol._smap(step, mesh, (P(), P(ax)), (P(), P())))
    for g in _steps(2, 63):
        u, s = f(s, _stacked(g))
        ups.append({k: _np(v) for k, v in u.items()})
    return {"updates": ups, "residual": None}


def _jax_multisteps(mesh, ax, k, comp, ef, shard):
    """``optax.MultiSteps(DistributedOptimizer(identity, ...))`` in a
    bound-axis step: the accumulator is per rank (stacked), as are an
    allreduce-mode residual and a ZeRO-1 state."""
    tx = jhvd.DistributedOptimizer(optax.identity(), compression=JCOMP[comp],
                                   error_feedback=ef, shard_optimizer=shard,
                                   backward_passes_per_step=k)
    p = _stacked(_params())
    s = tx.init(p)
    acc = {key: jnp.zeros((N,) + v.shape) for key, v in p.items()}
    if shard:
        inner, ispec = s.inner_opt_state, P(ax)
    elif ef:
        inner = {key: jnp.zeros((N,) + v.shape) for key, v in p.items()}
        ispec = P(ax)
    else:
        inner, ispec = s.inner_opt_state, P()

    def step(mini, gs, inner, acc, gg):
        gg = jax.tree_util.tree_map(lambda x: x[0], gg)
        acc = jax.tree_util.tree_map(lambda x: x[0], acc)
        if ef and not shard:
            inner = _EFState(optax.EmptyState(),
                             jax.tree_util.tree_map(lambda x: x[0], inner))
        st = optax.MultiStepsState(mini, gs, inner, acc, ())
        u, st = tx.update(gg, st, p)
        inner = st.inner_opt_state
        if ef and not shard:
            inner = jax.tree_util.tree_map(lambda x: x[None], inner.residual)
        return (u, st.mini_step, st.gradient_step, inner,
                jax.tree_util.tree_map(lambda x: x[None], st.acc_grads))

    f = jax.jit(JCol._smap(step, mesh, (P(), P(), ispec, P(ax), P(ax)),
                           (P(), P(), P(), ispec, P(ax))))
    mini, gs = s.mini_step, s.gradient_step
    ups = []
    for g in _steps(MULTI_STEPS, 64):
        u, mini, gs, inner, acc = f(mini, gs, inner, acc, _stacked(g))
        ups.append({key: _np(v) for key, v in u.items()})
    res = None
    if ef:
        res = inner.residual if shard else inner
        res = {key: np.asarray(v) for key, v in res.items()}
    return {"updates": ups, "mini_step": int(mini), "gradient_step": int(gs),
            "acc": {key: np.asarray(v) for key, v in acc.items()},
            "residual": res}


def _jax_tape(mesh, ax, op, comp):
    tree = _tape_tree()
    keys = sorted(tree)

    def body(loss, *vs):
        g = {key: v[0] for key, v in zip(keys, vs)}
        tape = jhvd.DistributedGradientTape(lambda: (loss[0], g),
                                            op=TAPE_OPS[op],
                                            compression=JCOMP[comp])
        value, grads = tape()
        return value[None], {key: v[None] for key, v in grads.items()}

    loss = jnp.arange(N, dtype=jnp.float32) + 0.5
    f = jax.jit(JCol._smap(body, mesh, (P(ax),) * (1 + len(keys)),
                           (P(ax), P(ax))))
    value, grads = f(loss, *[jnp.asarray(tree[key][0]) for key in keys])
    return {"value": np.asarray(value),
            "grads": {key: np.asarray(v) for key, v in grads.items()}}


# --------------------------------------------------------------------------
# worlds


@pytest.mark.parametrize("case", list(PRED))
def test_predivide_bit_equal_to_jax(case):
    want = _jax(N)["predivide"][case]
    for r in range(N):
        got = _port(N)[r]["predivide"][case]
        for t, (g, w) in enumerate(zip(got["updates"], want["updates"])):
            for k in w:
                assert _same_bits(g[k], w[k]), (t, k)
        if want["residual"] is not None:
            for k, v in want["residual"].items():
                assert _same_bits(got["residual"][k], v[r]), (r, k)
    if PRED[case][1]:      # the divide by 3 itself rounds: EF keeps it
        assert np.abs(want["residual"]["e"]).max() > 0


@pytest.mark.parametrize("case", list(MULTI))
def test_multi_steps_bit_equal_to_jax_and_silent_between_emits(case):
    k = MULTI[case][0]
    want = _jax(N)["multisteps"][case]
    for r in range(N):
        got = _port(N)[r]["multisteps"][case]
        assert (got["mini_step"], got["gradient_step"]) == (
            want["mini_step"], want["gradient_step"]) == (
            MULTI_STEPS % k, MULTI_STEPS // k)
        for t, (g, w) in enumerate(zip(got["updates"], want["updates"])):
            emit = (t + 1) % k == 0
            for key in w:
                # zeros between emits (optax's are 0 * u: -0.0 where u < 0)
                assert np.array_equal(g[key], w[key]), (t, key)
                assert emit or not np.any(g[key]), (t, key)
            assert (got["calls"][t] > 0) == emit, (t, got["calls"])
        for key, v in want["acc"].items():
            assert _same_bits(got["acc"][key], v[r]), key
        if want["residual"] is not None:
            for key, v in want["residual"].items():
                assert _same_bits(got["residual"][key], v[r]), key


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_reducescatter_bit_equal_to_jax(n):
    want = _jax(n)["qrs"]
    for r in range(n):
        got = _port(n)[r]["qrs"]
        assert got.shape == want[r].shape
        assert _same_bits(got, want[r]), r
    shard0 = _port(n)[0]["qrs"]      # rank 0's NaN block reaches its owner
    assert np.isnan(shard0[:256]).all() and not np.isnan(shard0[256:]).any()


@pytest.mark.parametrize("case", list(TAPE))
def test_tape_matches_jax(case):
    want = _jax(N)["tape"][case]
    op = TAPE[case][0]
    for r in range(N):
        got = _port(N)[r]["tape"][case]
        assert got["value"] == float(want["value"][r]) == r + 0.5
        for k, v in want["grads"].items():
            if op == 2:
                np.testing.assert_allclose(got["grads"][k], v[r], rtol=2e-5,
                                           atol=2e-6)
            else:
                assert _same_bits(got["grads"][k], v[r]), (r, k)
    if case == "avg_none":
        for r in range(N):
            plain = _port(N)[r]["tape"]["plain"]
            for k, v in plain.items():
                assert _same_bits(v, want["grads"][k][r])


def test_tape_tells_a_loss_from_gradients():
    """A 2-tuple is ``(loss, grads)`` only when its first element is 0-d;
    ``has_aux_value`` overrides the guess."""
    hvd.init(device="cpu")
    try:
        g = {"a": torch.ones(3)}
        two = (torch.ones(2), torch.zeros(2))
        out = hvd.DistributedGradientTape(lambda: {"x": two[0]})()
        assert set(out) == {"x"}
        v, grads = hvd.DistributedGradientTape(
            lambda: (torch.tensor(2.0), g))()
        assert float(v) == 2.0 and torch.equal(grads["a"], g["a"])
        with pytest.raises((AttributeError, TypeError)):
            hvd.DistributedGradientTape(lambda: (torch.ones(2), g))()
        v, grads = hvd.DistributedGradientTape(
            lambda: (torch.ones(2), g), has_aux_value=True)()
        assert torch.equal(v, torch.ones(2))
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# env defaults and refusals (a world of one)


@pytest.fixture()
def one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "HOROVOD_SHARD_OPTIMIZER", "HOROVOD_SHARD_PARAMS",
              "HOROVOD_COMPRESSION", "HOROVOD_POWERSGD_RANK",
              "HOROVOD_OVERLAP", "HOROVOD_BUCKET_BYTES",
              "HOROVOD_FUSION_THRESHOLD", "HOROVOD_NUMERICS_GUARD"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield monkeypatch
    hvd.shutdown()


def test_env_defaults(one):
    mp = one
    tx = hvd.DistributedOptimizer(hvd.adam(1e-3))
    assert (tx.shard_optimizer, tx.shard_params, tx.bucket_bytes) == (
        False, False, None)
    mp.setenv("HOROVOD_SHARD_OPTIMIZER", "1")
    assert hvd.DistributedOptimizer(hvd.adam(1e-3)).shard_optimizer
    assert not hvd.DistributedOptimizer(hvd.adam(1e-3),
                                        shard_optimizer=False).shard_optimizer
    mp.delenv("HOROVOD_SHARD_OPTIMIZER")
    mp.setenv("HOROVOD_SHARD_PARAMS", "true")
    assert hvd.DistributedOptimizer(hvd.adam(1e-3)).shard_params
    mp.delenv("HOROVOD_SHARD_PARAMS")
    # HOROVOD_COMPRESSION=int8: the EF residual shows the wire rounded
    mp.setenv("HOROVOD_COMPRESSION", "int8")
    tx = hvd.DistributedOptimizer(W._identity(), error_feedback=True)
    p = {"w": torch.full((1200,), 1.0 + 2e-3)}
    _, st = tx.update({"w": torch.full((1200,), 1.0 + 2e-3)}, tx.init(p), p)
    assert st["residual"]["w"].abs().max() > 0
    # env-resolved PowerSGD turns error feedback on
    mp.setenv("HOROVOD_COMPRESSION", "powersgd")
    mp.setenv("HOROVOD_POWERSGD_RANK", "2")
    tx = hvd.DistributedOptimizer(hvd.adam(1.0))
    st = tx.init({"w": torch.ones(8, 6)})
    assert set(st) == {"inner", "residual", "q"}
    assert [tuple(q.shape) for q in st["q"].values()] == [(6, 2)]
    for name, jname in (("bogus", "bogus"), ("int4", "int4")):
        mp.setenv("HOROVOD_COMPRESSION", name)
        with pytest.raises(ValueError) as te:
            hvd.DistributedOptimizer(hvd.adam(1.0))
        with pytest.raises(ValueError) as je:
            jhvd.DistributedOptimizer(optax.sgd(1.0))
        assert str(te.value) == str(je.value) and jname in str(te.value)
    for name, comp in (("none", hvd.Compression.none),
                       ("off", hvd.Compression.none),
                       ("bf16", hvd.Compression.fp16),
                       ("16bit", hvd.Compression.fp16),
                       ("int8", hvd.Compression.int8)):
        mp.setenv("HOROVOD_COMPRESSION", name)
        assert hvd.Compression.from_env() is comp
    mp.delenv("HOROVOD_COMPRESSION")
    # the overlap knobs
    mp.setenv("HOROVOD_OVERLAP", "1")
    assert hvd.DistributedOptimizer(hvd.adam(1e-3)).bucket_bytes == 64 << 20
    mp.setenv("HOROVOD_BUCKET_BYTES", "4096")
    assert hvd.DistributedOptimizer(hvd.adam(1e-3)).bucket_bytes == 4096
    assert hvd.DistributedOptimizer(hvd.adam(1e-3),
                                    overlap=False).bucket_bytes is None
    mp.delenv("HOROVOD_OVERLAP")
    assert hvd.DistributedOptimizer(hvd.adam(1e-3),
                                    bucket_bytes=123).bucket_bytes == 123


REFUSED = {
    "zero3_adasum": dict(shard_params=True, op="adasum"),
    "zero3_fp16": dict(shard_params=True, compression="fp16"),
    "zero3_ef": dict(shard_params=True, error_feedback=True),
    "zero3_predivide": dict(shard_params=True, gradient_predivide_factor=2.0),
    "powersgd_no_ef": dict(compression="powersgd"),
    "powersgd_adasum": dict(compression="powersgd", error_feedback=True,
                            op="adasum"),
    "int8_predivide": dict(compression="int8", gradient_predivide_factor=2.0),
    "powersgd_predivide": dict(compression="powersgd", error_feedback=True,
                               gradient_predivide_factor=2.0),
    "ef_none": dict(error_feedback=True),
    "ef_adasum": dict(compression="fp16", error_feedback=True, op="adasum"),
    "int8_adasum": dict(compression="int8", op="adasum"),
    "zero1_adasum": dict(shard_optimizer=True, op="adasum"),
    "overlap_powersgd": dict(compression="powersgd", error_feedback=True,
                             overlap=True),
    "overlap_adasum": dict(op="adasum", bucket_bytes=1 << 20),
    "loss_scale_unguarded": dict(numerics_guard=False, loss_scale="dynamic"),
    "guard_zero3": dict(numerics_guard=True, shard_params=True),
}


def _kw(kw, pkg):
    out = dict(kw)
    comp = {"fp16": pkg.Compression.fp16, "int8": pkg.Compression.int8}
    if "compression" in out:
        out["compression"] = (pkg.Compression.powersgd(2)
                              if out["compression"] == "powersgd"
                              else comp[out["compression"]])
    if out.get("op") == "adasum":
        out["op"] = pkg.Adasum
    return out


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_as_the_jax_package_refuses(one, case):
    kw = REFUSED[case]
    with pytest.raises(ValueError) as je:
        jhvd.DistributedOptimizer(optax.sgd(0.1), **_kw(kw, jhvd))
    with pytest.raises(ValueError) as te:
        hvd.DistributedOptimizer(hvd.adam(0.1), **_kw(kw, hvd))
    assert str(te.value) == str(je.value)


GUARD_ASKS = [(dict(numerics_guard=True), None),
              (dict(loss_scale="dynamic"), None),
              (dict(loss_scale=1024.0, shard_optimizer=True), None),
              ({}, "HOROVOD_NUMERICS_GUARD")]
GUARD_IDS = ["guard", "loss_scale", "loss_scale_zero1", "env"]


@pytest.mark.parametrize("kw,env", GUARD_ASKS, ids=GUARD_IDS)
def test_numerics_guard_is_not_ported_and_never_ignored(one, kw, env):
    """Each way of asking for the numerics guard is never ignored: the
    optimizer it builds skips a step whose gradient is NaN (parameters,
    moments and count kept, the update -0.0) and counts it BAD."""
    from horovod_tpu_torch.resilience import numerics as tnum

    if env:
        one.setenv(env, "1")
    tx = hvd.DistributedOptimizer(hvd.adam(1e-3), **kw)
    p = {"w": torch.ones(4)}
    st = tx.init(p)
    scale = tnum.current_scale(st)
    _, st = tx.update({"w": torch.full((4,), 0.5) * scale}, st, p)
    inner = W._bits_of(st.inner)
    u, st = tx.update({"w": torch.full((4,), float("nan"))}, st, p)
    assert torch.equal(u["w"], torch.zeros(4)) and bool(
        torch.signbit(u["w"]).all())
    assert W.same_bits(inner, W._bits_of(st.inner))
    assert tnum.verdict(st)["bad_count"] == 1


@pytest.mark.parametrize("kw,env", GUARD_ASKS, ids=GUARD_IDS)
def test_numerics_guard_enabled_as_the_jax_package_enables_it(one, kw, env):
    """Each way of asking for the guard builds a guarded optimizer in both
    packages (``numerics.is_guarded``), never an unguarded one: the guard
    wraps the DistributedOptimizer outermost, its state a
    ``NumericsGuardState`` with the loss scale the JAX package starts."""
    from horovod_tpu.resilience import numerics as jnum
    from horovod_tpu_torch.resilience import numerics as tnum

    if env:
        one.setenv(env, "1")
    jhvd.init(devices=jax.devices()[:1])
    try:
        jtx = jhvd.DistributedOptimizer(optax.adam(1e-3), **kw)
        jst = jtx.init({"w": jnp.ones(3)})
    finally:
        jhvd.shutdown()
    ttx = hvd.DistributedOptimizer(hvd.adam(1e-3), **kw)
    assert jnum.is_guarded(jtx) and tnum.is_guarded(ttx)
    tst = ttx.init({"w": torch.ones(3)})
    assert isinstance(tst, tnum.NumericsGuardState)
    assert type(tst).__name__ == type(jst).__name__
    assert float(tnum.current_scale(tst)) == float(jnum.current_scale(jst))
    assert ttx.shard_optimizer == bool(kw.get("shard_optimizer", False))


def test_bucketed_zero3_and_axis_are_refused(one):
    """Bucketed ZeRO-3, once refused, is built now (its trajectory is in
    tests/test_torch_fsdp.py); an axis other than the host mesh's pair,
    half of the pair, and the pair under Adasum are refused."""
    tx = hvd.DistributedOptimizer(hvd.adam(1e-3), shard_params=True,
                                  overlap=True)
    assert tx.shard_params and tx.bucket_bytes
    with pytest.raises(ValueError, match="process group"):
        hvd.DistributedOptimizer(hvd.adam(1e-3), axis="data")
    with pytest.raises(ValueError, match="only one of"):
        hvd.DistributedOptimizer(hvd.adam(1e-3), axis="cross")
    with pytest.raises(ValueError, match="Adasum does not support"):
        hvd.DistributedOptimizer(hvd.adam(1e-3), op=hvd.Adasum,
                                 axis=("cross", "local"))
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        hvd.DistributedOptimizer(hvd.adam(1e-3), backward_passes_per_step=0)
    tx = hvd.DistributedOptimizer(hvd.adam(1e-3))
    p = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="overlap=True"):
        tx.update({"w": torch.ones(3)}, tx.init(p), p, started=object())


def test_quantized_reducescatter_checks(one):
    from horovod_tpu_torch.ops import collective as C

    with pytest.raises(ValueError, match="flat"):
        C.quantized_reducescatter(torch.ones(4, 4))
    with pytest.raises(ValueError, match="float"):
        C.quantized_reducescatter(torch.ones(8, dtype=torch.int32))
    x = torch.randn(3000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(C.quantized_reducescatter(x),
                       C.quantized_psum_scatter(x))
