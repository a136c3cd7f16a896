"""The whole slice: three training steps of a narrow ResNet (f32) with
ZeRO-1 + int8 + error feedback + fused Adam, on a gloo world of 2
(horovod_tpu_torch.make_train_step) against the JAX package's
``make_shardmap_train_step(shard_optimizer=True)`` on 2 CPU devices,
weights carried across and the same global batch.

The two frameworks compute convolution gradients in different orders,
and the int8 wire can turn a last-bit difference into one quantum of a
few elements, so the trajectory is held at rtol 5e-3 / atol 5e-4 (the
bar ``tests/test_pallas.py`` uses for int8 trajectories) and the loss at
1e-4 relative."""

import concurrent.futures

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.models import resnet as jres
from horovod_tpu.training import make_shardmap_train_step, shard_batch
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N, STEPS, LR = 2, 3, 1e-3


@pytest.fixture(scope="module")
def runs():
    r = np.random.RandomState(11)
    x = r.randn(4 * N, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, (4 * N,)).astype(np.int64)
    model = jres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=jres.BottleneckBlock, num_classes=10,
                        num_filters=8, dtype=jnp.float32)
    v = jax.jit(lambda xx: model.init(jax.random.PRNGKey(3), xx, train=True))(
        jnp.asarray(x[:1]))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])

    # the port's world runs in its own processes while JAX compiles here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port_run = pool.submit(run_world, W.slice_worker, N, params, stats,
                               x, y, STEPS, LR)
        ref = _jax_run(model, params, stats, x, y)
        port = port_run.result()
    return params, port, ref


def _jax_run(model, params, stats, x, y):
    jhvd.init(devices=jax.devices()[:N])
    try:
        from horovod_tpu.optim import fused_adam

        dtx = jhvd.DistributedOptimizer(fused_adam(LR), compression=JC.int8,
                                        error_feedback=True,
                                        shard_optimizer=True)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        s = jax.tree_util.tree_map(jnp.asarray, stats)
        st = dtx.init(p)
        step = make_shardmap_train_step(model, dtx, shard_optimizer=True,
                                        instrument=False)
        xs, ys = shard_batch(jnp.asarray(x)), shard_batch(jnp.asarray(y))
        losses = []
        for _ in range(STEPS):
            p, s, st, loss = step(p, s, st, xs, ys)
            losses.append(float(loss))
        ref = {"losses": losses,
               "params": flatten_tree(jax.tree_util.tree_map(np.asarray, p)),
               "stats": flatten_tree(jax.tree_util.tree_map(np.asarray, s)),
               "residual": np.asarray(st.residual["float32"])}
    finally:
        jhvd.shutdown()
    return ref


def test_losses_track_jax(runs):
    _, port, ref = runs
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], ref["losses"], rtol=1e-4)
    assert port[0]["losses"][-1] < port[0]["losses"][0]


def test_params_track_jax(runs):
    params, port, ref = runs
    moved = 0
    for k, want in ref["params"].items():
        got = port[0]["params"][k]
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4, err_msg=k)
        assert np.array_equal(got, port[1]["params"][k]), k
        moved += not np.array_equal(got, flatten_tree(params)[k])
    # (a few leaves, e.g. BN scales born at 0 behind a dead branch, may
    # not move in three steps)
    assert moved > len(ref["params"]) // 2


def test_batch_stats_track_jax(runs):
    _, port, ref = runs
    for k, want in ref["stats"].items():
        for r in range(N):
            np.testing.assert_allclose(port[r]["stats"][k], want,
                                       rtol=5e-3, atol=5e-4, err_msg=k)


def test_error_feedback_residual_is_per_rank(runs):
    """Each rank keeps its own EF residual, as the JAX state's rows. Where
    the two gradients straddle a rounding boundary of the wire, the
    residuals differ by one quantum (at most twice the largest residual);
    that happens in a few elements only."""
    _, port, ref = runs
    for r in range(N):
        got, want = port[r]["residual"], ref["residual"][r]
        off = ~np.isclose(got, want, rtol=5e-3, atol=5e-4)
        assert off.mean() < 5e-3, off.mean()
        assert np.abs(got - want).max() <= 2.5 * np.abs(want).max()
    assert not np.array_equal(port[0]["residual"], port[1]["residual"])
