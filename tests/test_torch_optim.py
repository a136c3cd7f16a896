"""horovod_tpu_torch.optim on a gloo world of 2 against the JAX package's
DistributedOptimizer on a 2-device CPU mesh (bound-axis step), same
inputs.

- one int8 + error-feedback update on identical grads and state: with an
  identity inner optimizer the whole exchange — the reduced gradients
  (ZeRO-1 reduce-scatter + gather, or the per-leaf int8 allreduce) and
  the new EF residual — is bit-equal; with Adam inside, the update sits
  within the per-step Adam bar (rtol 1e-6: jitted optax contracts the
  moment updates into FMAs, the port rounds each operation);
- the 6-step trajectory of ``tests/test_pallas.py::_run_zero1`` (ZeRO-1 +
  int8 + EF): the two sides compute their gradients with different
  autodiff, and the int8 wire turns a last-bit difference into at most a
  quantum, so rtol 5e-3 / atol 5e-4 as that test uses; the fp32 wire
  (Compression.none) at 1e-5.
"""

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops.collective import Average, _smap, allreduce
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N = 2
SHAPE = (40, 30)


@pytest.fixture()
def mesh2():
    jhvd.init(devices=jax.devices()[:N])
    yield jhvd.mesh(), jhvd.data_axis()
    jhvd.shutdown()


def _params():
    r = np.random.RandomState(31)
    return {"w": (r.randn(*SHAPE).astype(np.float32) * 0.1),
            "b": np.zeros((SHAPE[1],), np.float32)}


def _batch():
    r = np.random.RandomState(32)
    return (r.randn(2 * N, SHAPE[0]).astype(np.float32),
            r.randn(2 * N, SHAPE[1]).astype(np.float32))


def _inner(name):
    return optax.identity() if name == "identity" else optax.adam(1e-2)


def _jax_one_update(mesh, ax, inp, shard, inner):
    dtx = jhvd.DistributedOptimizer(_inner(inner), compression=JC.int8,
                                    error_feedback=True,
                                    shard_optimizer=shard)
    p = {k: jnp.asarray(inp[k]) for k in ("w", "b")}
    s = dtx.init(p)
    if shard:
        s = s._replace(residual={"float32": jnp.asarray(
            inp["state"]["residual"]["float32"])})
    g = {"w": jnp.asarray(inp["gw"]), "b": jnp.asarray(inp["gb"])}

    def step(ss, gg):
        gg = jax.tree_util.tree_map(lambda x: x[0], gg)
        u, ss = dtx.update(gg, ss, p)
        return (jax.tree_util.tree_map(lambda x: x[None], u),
                ss if shard else jax.tree_util.tree_map(
                    lambda x: x[None], ss.residual))

    sspec = P(ax) if shard else P()
    u, out = jax.jit(_smap(step, mesh, (sspec, P(ax)), (P(ax), P(ax))))(s, g)
    u = {k: np.asarray(v) for k, v in u.items()}
    if shard:
        res = {k: np.asarray(v) for k, v in out.residual.items()}
        mu = ({k: np.asarray(v) for k, v in out.inner[0].mu.items()}
              if inner == "adam" else None)
    else:
        res, mu = {k: np.asarray(v) for k, v in out.items()}, None
    return u, res, mu


def _one_update_inputs(shard):
    r = np.random.RandomState(41)
    inp = dict(_params())
    inp["gw"] = r.randn(N, *SHAPE).astype(np.float32)
    inp["gb"] = r.randn(N, SHAPE[1]).astype(np.float32)
    if shard:
        L = SHAPE[0] * SHAPE[1] + SHAPE[1]
        Lp = L + (-L) % N
        inp["state"] = {
            "count": np.zeros(N, np.int32),
            "mu": {"float32": np.zeros((N, Lp // N), np.float32)},
            "nu": {"float32": np.zeros((N, Lp // N), np.float32)},
            "residual": {"float32": (r.randn(N, Lp) * 1e-3).astype(np.float32)},
        }
    return inp


ONE = [(shard, inner) for shard in (True, False)
       for inner in ("identity", "adam")]
TRAJ = {
    "zero1_int8_ef": (True, "int8", True, 5e-3, 5e-4),
    "zero1_fp32": (True, "none", False, 1e-5, 1e-5),
    "allreduce_int8_ef": (False, "int8", True, 5e-3, 5e-4),
}
STEPS = 6


@pytest.fixture(scope="module")
def port():
    """Every case on the port side, in one gloo world of 2."""
    x, y = _batch()
    one = {(shard, inner): (_one_update_inputs(shard), shard, inner)
           for shard, inner in ONE}
    traj = {k: (dict(_params(), x=x, y=y), (c[0], c[1], c[2], STEPS))
            for k, c in TRAJ.items()}
    return run_world(W.optim_worker, N, one, traj)


@pytest.mark.parametrize("shard", [True, False], ids=["zero1", "allreduce"])
@pytest.mark.parametrize("inner", ["identity", "adam"])
def test_one_int8_ef_update(port, mesh2, shard, inner):
    mesh, ax = mesh2
    inp = _one_update_inputs(shard)
    res = [port[r]["one"][(shard, inner)] for r in range(N)]
    u_j, res_j, mu_j = _jax_one_update(mesh, ax, inp, shard, inner)
    for r in range(N):
        for k in ("w", "b"):
            got, want = res[r]["u"][k], u_j[k][r]
            if inner == "identity":
                assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=2 * np.spacing(np.float32(1e-2)))
        for k, v in res[r]["residual"].items():
            assert np.array_equal(v.view(np.uint32),
                                  res_j[k][r].view(np.uint32)), k
        if mu_j is not None:
            np.testing.assert_allclose(res[r]["inner"]["float32"],
                                       mu_j["float32"][r], rtol=1e-6, atol=1e-12)
    # the int8 wire was really taken: the EF residual is not zero
    assert any(np.abs(v).max() > 0 for v in res[0]["residual"].values())


def _jax_trajectory(mesh, ax, shard, compression, error_feedback, steps):
    dtx = jhvd.DistributedOptimizer(optax.adam(1e-2), compression=compression,
                                    error_feedback=error_feedback,
                                    shard_optimizer=shard)
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    s = dtx.init(p)

    def loss_fn(pp, xx, yy):
        return jnp.mean((xx @ pp["w"] + pp["b"][None] - yy) ** 2)

    def step(pp, ss, xx, yy):
        l, g = jax.value_and_grad(loss_fn)(pp, xx, yy)
        u, ss = dtx.update(g, ss, pp)
        return optax.apply_updates(pp, u), ss, allreduce(l, Average, axis=ax)

    sspec = P(ax) if shard else P()
    sm = jax.jit(_smap(step, mesh, (P(), sspec, P(ax), P(ax)),
                       (P(), sspec, P())))
    x, y = (jnp.asarray(a) for a in _batch())
    for _ in range(steps):
        p, s, l = sm(p, s, x, y)
    return {k: np.asarray(v) for k, v in p.items()}, float(l)


@pytest.mark.parametrize("case", list(TRAJ))
def test_six_step_trajectory(port, mesh2, case):
    shard, comp, ef, rtol, atol = TRAJ[case]
    mesh, ax = mesh2
    res = [port[r]["traj"][case] for r in range(N)]
    pj, lj = _jax_trajectory(mesh, ax, shard, getattr(JC, comp), ef, STEPS)
    for r in range(N):
        for k in ("w", "b"):
            np.testing.assert_allclose(res[r]["params"][k], pj[k],
                                       rtol=rtol, atol=atol)
    np.testing.assert_allclose(res[0]["loss"], lj, rtol=max(rtol, 1e-5))
    # both ranks hold the same parameters: the exchange crossed processes
    for k in ("w", "b"):
        assert np.array_equal(res[0]["params"][k], res[1]["params"][k])


# --------------------------------------------------------------------------
# fused_adam's state: per-leaf views into flat buffers, interchangeable


def _jax_adam_allreduce(mesh, ax, steps):
    """``steps`` allreduce-mode steps (no compression) of the linear
    problem with the JAX package's ``fused_adam``: params, and the
    ``ScaleByAdamState`` count, mu and nu."""
    from horovod_tpu import optim as jo

    dtx = jhvd.DistributedOptimizer(jo.fused_adam(1e-2))
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    s = dtx.init(p)

    def loss_fn(pp, xx, yy):
        return jnp.mean((xx @ pp["w"] + pp["b"][None] - yy) ** 2)

    def step(pp, ss, xx, yy):
        g = jax.grad(loss_fn)(pp, xx, yy)
        u, ss = dtx.update(g, ss, pp)
        return optax.apply_updates(pp, u), ss

    sm = jax.jit(_smap(step, mesh, (P(), P(), P(ax), P(ax)), (P(), P())))
    x, y = (jnp.asarray(a) for a in _batch())
    out = []
    for _ in range(steps + 1):
        out.append((p, s))
        p, s = sm(p, s, x, y)
    return [({k: np.asarray(v) for k, v in pp.items()}, int(ss[0].count),
             {k: np.asarray(v) for k, v in ss[0].mu.items()},
             {k: np.asarray(v) for k, v in ss[0].nu.items()})
            for pp, ss in out[1:] + [(p, s)]]


def test_fused_adam_state_is_interchangeable(mesh2):
    """Allreduce mode over a gloo world of 2: the fused optimizer's state
    (per-leaf views into one flat buffer per moment) is ``adam``'s
    format: 3 steps alternating fused_adam and adam on each other's state
    equal 3 fused steps bit for bit, and both hold the JAX package's
    params and ``ScaleByAdamState`` after those steps (jitted optax
    contracts the moment updates into FMAs: 1e-5, as the fp32 trajectory
    above). One fused step from the JAX package's state after 3 steps
    lands on its 4th."""
    mesh, ax = mesh2
    steps = 3
    traj = _jax_adam_allreduce(mesh, ax, steps)
    pj, cj, muj, nuj = traj[steps - 1]
    x, y = _batch()
    inp = dict(_params(), x=x, y=y,
               jax={"params": pj, "count": cj, "mu": muj, "nu": nuj})
    res = run_world(W.fused_adam_state_worker, N, inp, steps, 1e-2)
    for r in range(N):
        got = res[r]
        assert got["storages"] == {"mu": 1, "nu": 1}
        for k in ("w", "b"):
            for part in ("mu", "nu"):
                assert np.array_equal(got["fused"][part][k].view(np.uint32),
                                      got["alternating"][part][k].view(np.uint32))
            assert np.array_equal(got["fused"]["params"][k].view(np.uint32),
                                  got["alternating"]["params"][k].view(np.uint32))
            np.testing.assert_allclose(got["fused"]["params"][k], pj[k],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["fused"]["mu"][k], muj[k],
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got["fused"]["nu"][k], nuj[k],
                                       rtol=1e-5, atol=1e-9)
            pj4, cj4, muj4, nuj4 = traj[steps]
            np.testing.assert_allclose(got["from_jax"]["params"][k], pj4[k],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["from_jax"]["mu"][k], muj4[k],
                                       rtol=1e-5, atol=1e-7)
        assert got["fused"]["count"] == got["alternating"]["count"] == cj
        assert got["from_jax"]["count"] == cj4
    for k in ("w", "b"):
        assert np.array_equal(res[0]["fused"]["params"][k],
                              res[1]["fused"]["params"][k])
