"""PowerSGD in the port against the JAX package's
(``horovod_tpu/compression.py:PowerSGDCompressor``,
``horovod_tpu/optim.py`` ``_powersgd_update``/``_zero_update_powersgd``).

- the compressor: ``rank``, ``effective_rank``, ``factorizes`` (the
  wire-cost rule ``(d0 + m) * r < d0 * m``), ``wire_bytes``, the int8
  fallback roundtrip and ``repr`` equal the JAX package's on every shape
  tried; ``Compression.powersgd()`` reads ``HOROVOD_POWERSGD_RANK``;
- one factor round at full rank reproduces the matrix; a bf16 leaf
  rides the plain wire with a zero residual
  (``tests/test_compression.py::test_powersgd_full_rank_is_exact``'s bar,
  rtol 1e-4 / atol 1e-5), and the Gram-Schmidt pass is the JAX
  package's;
- ``DistributedOptimizer(adam, Compression.powersgd(r), error_feedback=
  True)`` in allreduce mode and ZeRO-1 at ranks 1, 2 and 4 on a gloo
  world of 2 against the JAX package's bound-axis step on a 2-device
  mesh: a 2-D leaf that factorizes, a conv kernel (``[3, 3, 16, 32]``,
  ``d0 = 3``) that factorizes at
  ranks 1 and 2 and falls back to int8 at 4, a tiny 2-D leaf that
  factorizes at rank 1 only, 1-D leaves on the int8 and the plain wire. The JAX package
  draws its initial ``Q`` from ``jax.random``, the port from its own
  generator; the test carries the JAX package's ``Q`` into the port's
  state. After each of 3 steps the parameters agree within rtol 1e-4 /
  atol 1e-5, the bar of the JAX package's own PowerSGD tests
  (``tests/test_compression.py:282-380``); the residuals and ``Q`` too
  after the first step, and normwise (``|a - b| <= 1e-4 |b|``) after
  the later ones, whose state carries the first step's last-bit
  differences (BLAS and XLA sum the products in other orders) through
  the Gram-Schmidt pass, which scales them by ``P``'s conditioning;
- from the port's own ``Q``, 20 steps of the test MLP: the loss falls.
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
from horovod_tpu import compression as jcomp
from horovod_tpu import optim as jopt
from horovod_tpu.ops import collective as JCol
import horovod_tpu_torch as hvd
from horovod_tpu_torch import compression as tcomp
from horovod_tpu_torch import optim as topt
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N = 2
STEPS = 3
RTOL, ATOL = 1e-4, 1e-5


SHAPES = [(2, 3), (64, 48), (3, 3, 16, 32), (7, 7, 3, 64), (1, 1, 256, 64),
          (3, 3, 64, 64), (2048, 1000), (1000,), (8, 8), (5, 1), (1, 5),
          (16, 4)]


@pytest.mark.parametrize("rank", [1, 2, 4, 8])
def test_compressor_is_the_jax_packages(rank):
    j, t = jcomp.PowerSGDCompressor(rank), tcomp.PowerSGDCompressor(rank)
    assert repr(t) == repr(j) and t.rank == j.rank
    assert (t.factorized, t.quantized, t.block) == (j.factorized, j.quantized,
                                                   j.block)
    assert t.fallback is tcomp.Int8Compressor
    for shape in SHAPES:
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16),
                       (jnp.int32, torch.int32)):
            assert t.factorizes(shape, td) == j.factorizes(shape, jd), shape
            assert t.wire_bytes(shape, td) == j.wire_bytes(shape, jd), shape
        if len(shape) >= 2:
            assert t.effective_rank(shape) == j.effective_rank(shape)
    x = np.random.RandomState(rank).randn(3000).astype(np.float32)
    want = j.decompress(*j.compress(jnp.asarray(x)))
    got = t.decompress(*t.compress(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="rank must be >= 1"):
        tcomp.PowerSGDCompressor(0)


def test_rank_from_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_POWERSGD_RANK", raising=False)
    assert hvd.Compression.powersgd().rank == 4
    monkeypatch.setenv("HOROVOD_POWERSGD_RANK", "2")
    assert hvd.Compression.powersgd().rank == 2
    assert hvd.Compression.powersgd(3).rank == 3


def test_full_rank_round_is_exact_and_gram_schmidt_is_jaxs():
    rng = np.random.RandomState(5)
    m2d = rng.randn(24, 8).astype(np.float32)
    q0 = rng.randn(8, 8).astype(np.float32)
    hvd.init(device="cpu")
    try:
        red, res, q = topt._powersgd_sync(
            {"m": torch.from_numpy(m2d)}, {"m": torch.from_numpy(q0)},
            hvd.Average, hvd.Compression.powersgd(8))
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(red["m"].numpy(), m2d, rtol=RTOL, atol=ATOL)
    # a bf16 leaf neither factorizes nor rides int8: plain wire, zero
    # residual (the JAX package's zeros_like), its Q None
    h = torch.randn(16, 8, generator=torch.Generator().manual_seed(1)).bfloat16()
    hvd.init(device="cpu")
    try:
        red2, res2, q2 = topt._powersgd_sync(
            {"h": h}, {"h": None}, hvd.Average, hvd.Compression.powersgd(2))
    finally:
        hvd.shutdown()
    assert torch.equal(red2["h"], h) and red2["h"].dtype == torch.bfloat16
    assert not res2["h"].any() and res2["h"].dtype == torch.bfloat16
    assert q2["h"] is None
    np.testing.assert_allclose(res["m"].numpy(), 0, atol=ATOL)
    assert tuple(q["m"].shape) == (8, 8)
    p = rng.randn(40, 4).astype(np.float32)
    np.testing.assert_allclose(
        topt._orthonormalize(torch.from_numpy(p)).numpy(),
        np.asarray(jopt._orthonormalize(jnp.asarray(p))), rtol=1e-5,
        atol=1e-6)


def _params():
    r = np.random.RandomState(40)
    f = lambda *s: (r.randn(*s) * 0.1).astype(np.float32)  # noqa: E731
    return {"dense/kernel": f(64, 48), "dense/bias": f(48),
            "conv/kernel": f(3, 3, 16, 32), "emb": f(1500),
            "tiny": f(2, 3)}


#: leaves that are not float32: a bf16 leaf neither factorizes nor rides
#: int8 (the plain wire, a zero residual), and Adam keeps its dtype
DTYPES = {"emb": "bfloat16"}


def _steps():
    r = np.random.RandomState(41)
    return [{k: (r.randn(N, *v.shape) * 10.0 ** r.randint(-2, 1))
             .astype(np.float32) for k, v in _params().items()}
            for _ in range(STEPS)]


def _nested(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _jdt(k):
    return jnp.bfloat16 if DTYPES.get(k) == "bfloat16" else jnp.float32


CASES = [(shard, rank) for shard in (False, True) for rank in (1, 2, 4)]


def _case_name(shard, rank):
    return f"{'zero1' if shard else 'allreduce'}_r{rank}"


def _jax_traces():
    """Per case, the JAX package's initial ``Q`` and, after each step,
    the parameters, this world's residual rows and ``Q``."""
    jhvd.init(devices=jax.devices()[:N])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        out = {}
        for shard, rank in CASES:
            dtx = jhvd.DistributedOptimizer(
                optax.adam(1e-2), compression=jhvd.Compression.powersgd(rank),
                error_feedback=True, shard_optimizer=shard)
            p = _nested({k: jnp.asarray(v, _jdt(k))
                         for k, v in _params().items()})
            s = dtx.init(p)
            q0 = flatten_tree(dict(s.q))
            q0 = {k: None if v is None else np.asarray(v[0] if shard else v)
                  for k, v in q0.items()}
            if shard:
                def step(pp, ss, gg):
                    gg = jax.tree_util.tree_map(lambda x: x[0], gg)
                    u, ss = dtx.update(gg, ss, pp)
                    return optax.apply_updates(pp, u), ss
                f = jax.jit(JCol._smap(step, mesh, (P(), P(ax), P(ax)),
                                       (P(), P(ax))))
                state = s
            else:
                res = jax.tree_util.tree_map(
                    lambda v: jnp.broadcast_to(v[None], (N,) + v.shape),
                    s.residual)

                def step(pp, inner, rr, qq, gg):
                    gg = jax.tree_util.tree_map(lambda x: x[0], gg)
                    rr = jax.tree_util.tree_map(lambda x: x[0], rr)
                    u, ss = dtx.update(gg, jopt._PowerSGDState(inner, rr, qq),
                                       pp)
                    return (optax.apply_updates(pp, u), ss.inner,
                            jax.tree_util.tree_map(lambda x: x[None],
                                                   ss.residual), ss.q)
                f = jax.jit(JCol._smap(step, mesh,
                                       (P(), P(), P(ax), P(), P(ax)),
                                       (P(), P(), P(ax), P())))
                state = (s.inner, res, s.q)
            trace = []
            for g in _steps():
                gg = _nested({k: jnp.asarray(v, _jdt(k)) for k, v in g.items()})
                if shard:
                    p, state = f(p, state, gg)
                    residual, q = state.residual, state.q
                else:
                    p, inner, res, q = f(p, *state, gg)
                    state = (inner, res, q)
                    residual = flatten_tree(dict(res))
                trace.append({
                    "params": {k: np.asarray(v.astype(jnp.float32))
                               for k, v in flatten_tree(dict(p)).items()},
                    "residual": {k: np.asarray(jnp.asarray(v).astype(
                        jnp.float32)) for k, v in residual.items()},
                    "q": {k: None if v is None else np.asarray(v)
                          for k, v in flatten_tree(dict(q)).items()}})
            out[_case_name(shard, rank)] = (q0, trace)
    finally:
        jhvd.shutdown()
    return out


def _mlp_task():
    r = np.random.RandomState(7)
    x = r.randn(64, 16).astype(np.float32)
    teacher = r.randn(16, 10).astype(np.float32)
    return x, np.argmax(x @ teacher, 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _both():
    ref = _jax_traces()
    p0 = {k: v for k, v in _params().items()}
    steps = _steps()
    p0_port = dict(p0)
    cases = {name: (shard, rank, ref[name][0])
             for (shard, rank), name in ((c, _case_name(*c)) for c in CASES)}
    x, y = _mlp_task()
    inp = {"powersgd": (p0_port, steps, cases, DTYPES),
           "psgd_train": (x, y, 20, 2)}
    port = run_world(W.slice10_worker, N, inp, timeout=240)
    return ref, port


@pytest.mark.parametrize("shard,rank", CASES,
                         ids=[_case_name(*c) for c in CASES])
def test_steps_track_jax_from_its_q(shard, rank):
    ref, port = _both()
    name = _case_name(shard, rank)
    q0, want = ref[name]
    factorized = {k for k, v in q0.items() if v is not None}
    assert "dense/kernel" in factorized
    assert ("tiny" in factorized) == (rank == 1)       # (2 + 3) r < 6
    assert ("conv/kernel" in factorized) == (rank < 4)
    for r in range(N):
        got = port[r]["powersgd"][name]
        for t, (g, w) in enumerate(zip(got, want)):
            for k, v in w["params"].items():
                np.testing.assert_allclose(g["params"][k], v, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{t} {k}")
            pairs = [(g["residual"][k], v[r]) for k, v in w["residual"].items()]
            for k, v in w["q"].items():
                if v is None:
                    assert g["q"][k] is None
                    continue
                pairs.append((g["q"][k], v[0] if shard else v))
            for a, b in pairs:
                if t == 0:
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
                else:
                    # from the second step the state carries the first
                    # step's last-bit differences through Gram-Schmidt,
                    # which scales them by P's conditioning: normwise
                    assert np.linalg.norm(a - b) <= RTOL * max(
                        1.0, np.linalg.norm(b)), (t, np.linalg.norm(a - b))


def test_port_started_run_trains():
    """From the port's own ``Q``: the loss falls over 20 steps, and the
    leaves the rule factorizes are the MLP's two kernels."""
    _, port = _both()
    for r in range(N):
        got = port[r]["psgd_train"]
        losses = got["losses"]
        assert losses == port[0]["psgd_train"]["losses"]
        assert losses[-1] < 0.7 * losses[0], losses
        assert losses[-1] < losses[9], losses
        assert got["factorized"] == ["Dense_0/kernel", "Dense_1/kernel"]
