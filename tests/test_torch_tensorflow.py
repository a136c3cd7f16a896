"""The TensorFlow frontend of horovod_tpu_torch
(``horovod_tpu_torch/tensorflow/``) against the JAX package's
(``horovod_tpu/tensorflow/``) on the same inputs.

In one process the port is a world of one and the JAX package a mesh of
8 replicas: Average (the identity on replicated inputs), the
``tf.function`` and ``jit_compile=True`` routes, the Average gradients,
``DistributedGradientTape``, the Adasum optimizer and Keras's ``fit`` are
held to the JAX package's results bit for bit, except the JAX package's
eager Average, which sums its 8 replicas before dividing and so may land
a rounding off the identity (held within 2.5e-7 relative, a ULP; its
bf16 wire within 2^-8, a bf16 ULP, while the port's is the bf16 cast
exactly); the size-dependent answers
(Sum, allgather's length, the Sum gradients) to ``x * size()`` in each
package. A gloo world of 2 runs every collective on rank-distinct
integer-valued inputs (eager and through ``tf.py_function``) and is held
to numpy arithmetic summed in rank order, exactly (the bf16 wire to the
bf16 sum and halving of the same values)."""

import concurrent.futures

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import horovod_tpu.tensorflow as jhvd  # noqa: E402
import horovod_tpu_torch.tensorflow as thvd  # noqa: E402
from horovod_tpu_torch.tensorflow import mpi_ops as tops  # noqa: E402
from horovod_tpu_torch.testing import run_world  # noqa: E402

import torch_frontends_workers as W  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def world_future():
    """:func:`torch_frontends_workers.tf_world_worker` in one gloo world
    of 2, started at the module's first test so that its children's
    import of TensorFlow overlaps the single-process tests."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_world, W.tf_world_worker, 2, timeout=150)


@pytest.fixture(scope="module")
def both(world_future):
    """The JAX package on its 8-device mesh and the port in a world of
    one on the CPU, side by side."""
    jhvd.init()
    thvd.init(device="cpu")
    yield
    thvd.shutdown()
    jhvd.shutdown()


@pytest.fixture(scope="module")
def world(world_future):
    """Every rank's results of the world of 2."""
    return world_future.result(timeout=180)


def _x(seed=0, shape=(3, 4)):
    return tf.constant(np.random.RandomState(seed).randn(*shape)
                       .astype(np.float32))


def _both(fn):
    """``fn(package)`` for the JAX package and the port, as numpy."""
    return [np.asarray(fn(m)) for m in (jhvd, thvd)]


def _jax_eager_average(j, t, rtol=2.5e-7):
    """The JAX package's eager Average (and Sum) adds 8 replicas: a
    rounding (one ULP) from the product the port computes exactly."""
    np.testing.assert_allclose(j, t, rtol=rtol, atol=0)


def test_average_is_the_identity_in_both(both):
    x = _x()
    j, t = _both(lambda m: m.allreduce(x, op=m.Average))
    np.testing.assert_array_equal(t, x.numpy())
    _jax_eager_average(j, t)


@pytest.mark.parametrize("case", ["sum", "scaled", "int"])
def test_sum_is_x_times_size_in_each(both, case):
    x = _x(1) if case != "int" else tf.constant([1, 2, 3], tf.int32)
    kw = dict(prescale_factor=2.0, postscale_factor=0.5) \
        if case == "scaled" else {}
    for m in (jhvd, thvd):
        out = m.allreduce(x, op=m.Sum, **kw)
        assert out.dtype == x.dtype
        if m is thvd or case == "int":
            np.testing.assert_array_equal(out.numpy(), x.numpy() * m.size())
        else:  # the JAX package sums its 8 replicas in its own order
            _jax_eager_average(out.numpy(), x.numpy() * m.size())


def test_compressed_dtype_and_values_match(both):
    x = _x(2)
    for m in (jhvd, thvd):
        c, ctx = m.Compression.fp16.compress(x)
        assert c.dtype == tf.bfloat16 and ctx == tf.float32
        assert m.Compression.fp16.compress(tf.constant([1]))[0].dtype == tf.int32
        assert m.Compression.none.compress(x)[0] is x
    j, t = _both(lambda m: m.allreduce(x, op=m.Average,
                                       compression=m.Compression.fp16))
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(
        t, tf.cast(tf.cast(x, tf.bfloat16), tf.float32).numpy())
    _jax_eager_average(j, t, rtol=2.0 ** -8)


def test_indexed_slices_shapes_and_dtypes(both):
    values = tf.constant([[1.0, 2.0], [3.0, 4.0]])
    s = tf.IndexedSlices(values, tf.constant([0, 3], tf.int64),
                         dense_shape=tf.constant([5, 2]))
    for m in (jhvd, thvd):
        out = m.allreduce(s, op=m.Average)
        assert isinstance(out, tf.IndexedSlices)
        assert out.values.shape == (2 * m.size(), 2)
        assert out.values.dtype == tf.float32
        assert out.indices.dtype == tf.int64
        np.testing.assert_array_equal(out.indices.numpy(),
                                      np.tile([0, 3], m.size()))
        np.testing.assert_allclose(out.values.numpy(),
                                   np.tile(values.numpy(), (m.size(), 1))
                                   / m.size(), rtol=1e-6)
        with pytest.raises(NotImplementedError):
            m.allreduce(s, op=m.Adasum)
    j, t = _both(lambda m: m.allreduce(s, op=m.Sum, sparse_as_dense=True)
                 / m.size())
    np.testing.assert_array_equal(t, j)


def test_allgather_and_broadcast(both):
    x = _x(3, (2, 3))
    for m in (jhvd, thvd):
        np.testing.assert_array_equal(m.allgather(x).numpy(),
                                      np.tile(x.numpy(), (m.size(), 1)))
    j, t = _both(lambda m: m.broadcast(x, root_rank=0))
    np.testing.assert_array_equal(t, j)


def test_broadcast_variables(both):
    for m in (jhvd, thvd):
        v, w = tf.Variable([1.0, 2.0]), tf.Variable([[3.0]])
        m.broadcast_variables([v, w], root_rank=0)
        np.testing.assert_array_equal(v.numpy(), [1.0, 2.0])
        np.testing.assert_array_equal(w.numpy(), [[3.0]])


def test_gradients_of_the_three_collectives(both):
    for m in (jhvd, thvd):
        x = tf.Variable(np.ones((2, 3), np.float32))
        with tf.GradientTape() as tape:
            y = tf.reduce_sum(m.allreduce(x, op=m.Sum))
        np.testing.assert_array_equal(tape.gradient(y, x).numpy(),
                                      np.full((2, 3), m.size()))
        with tf.GradientTape() as tape:
            y = tf.reduce_sum(m.allreduce(x, op=m.Average))
        np.testing.assert_array_equal(tape.gradient(y, x).numpy(),
                                      np.ones((2, 3)))
        with tf.GradientTape() as tape:
            y = tf.reduce_sum(m.broadcast(x, root_rank=0))
        np.testing.assert_array_equal(tape.gradient(y, x).numpy(),
                                      np.full((2, 3), m.size()))
        with tf.GradientTape() as tape:
            g = m.allgather(x)
            w = tf.range(tf.shape(g)[0], dtype=tf.float32)[:, None]
            y = tf.reduce_sum(g * w)
        np.testing.assert_array_equal(
            tape.gradient(y, x).numpy(),
            m.size() * np.tile(np.arange(2, dtype=np.float32)[:, None],
                               (1, 3)))


def test_distributed_gradient_tape(both):
    def grad(m):
        w = tf.Variable(2.0)
        with m.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = w * w
        return tape.gradient(loss, w)

    j, t = _both(grad)
    assert t == j == 4.0
    with pytest.raises(ValueError):
        thvd.DistributedGradientTape(object())


@pytest.mark.parametrize("jit", [False, True])
def test_graph_routes_match(both, jit):
    """``tf.function``, and with ``jit_compile=True`` XLA: a single-process
    graph is plain TF math in both packages."""
    x = _x(4, (2, 3))
    for m in (jhvd, thvd):
        @tf.function(jit_compile=jit)
        def f(t):
            return (m.allreduce(t, op=m.Sum), m.allreduce(t, op=m.Average),
                    m.allgather(t), m.broadcast(t, root_rank=0))

        s, a, g, b = f(x)
        np.testing.assert_array_equal(s.numpy(), x.numpy() * m.size())
        np.testing.assert_array_equal(a.numpy(), x.numpy())
        assert g.shape[0] == 2 * m.size()
        np.testing.assert_array_equal(b.numpy(), x.numpy())


def test_adasum_optimizer_delta_matches(both):
    """``op=Adasum`` with ``backward_passes_per_step=2`` (the delta-style
    mixin): the same four steps in both packages give the same
    variable."""
    tf.random.set_seed(5)
    w_init = tf.random.normal([4, 2])
    x = tf.random.normal([8, 4])
    out = []
    for m in (jhvd, thvd):
        v = tf.Variable(w_init)
        opt = m.DistributedOptimizer(tf.optimizers.SGD(0.1), op=m.Adasum,
                                     backward_passes_per_step=2)
        for _ in range(4):
            with tf.GradientTape() as tape:
                loss = tf.reduce_mean(tf.square(tf.matmul(x, v)))
            (g,) = tape.gradient(loss, [v])
            opt.apply_gradients([(g, v)])
        out.append(v.numpy())
    np.testing.assert_array_equal(out[1], out[0])


def test_keras_fit_jit_compile_matches(both):
    keras = pytest.importorskip("keras")
    import horovod_tpu.keras as jk
    import horovod_tpu_torch.keras as tk

    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(16, 1).astype(np.float32)
    res = []
    for k in (jk, tk):
        keras.utils.set_random_seed(0)
        model = keras.Sequential([keras.layers.Input(shape=(4,)),
                                  keras.layers.Dense(1)])
        model.compile(optimizer=k.DistributedOptimizer(
            keras.optimizers.SGD(0.01)), loss="mse", jit_compile=True)
        hist = model.fit(x, y, batch_size=8, epochs=2, verbose=0,
                         shuffle=False)
        res.append((hist.history["loss"], model.get_weights()))
    assert res[1][0] == res[0][0]
    for a, b in zip(res[1][1], res[0][1]):
        np.testing.assert_array_equal(a, b)


def test_rank_size_exports(both):
    assert (thvd.size(), thvd.rank(), thvd.local_rank()) == (1, 0, 0)
    assert thvd.join() == 0
    assert set(tops.__all__) == set(__import__(
        "horovod_tpu.tensorflow.mpi_ops", fromlist=["x"]).__all__)
    for name in dir(jhvd):
        if not name.startswith("_") and callable(getattr(jhvd, name)):
            assert hasattr(thvd, name), name


def test_eager_bridge_is_dlpack_on_this_process_device(both, monkeypatch):
    """A float tensor crosses by dlpack (its buffer shared) to
    ``basics.device()``; bool and 64-bit tensors take a host copy, the
    JAX package's list; the collective sees the tensor on the device."""
    seen = []
    real = torch.from_dlpack
    monkeypatch.setattr(torch, "from_dlpack",
                        lambda t: seen.append(t.dtype) or real(t))
    x = _x(5)
    t = tops._tf_to_torch(x)
    assert seen == [tf.float32] and t.device == thvd.mpi_ops.basics.device()
    np.testing.assert_array_equal(t.numpy(), x.numpy())
    for dt in (tf.bool, tf.int64, tf.uint64, tf.float64):
        tops._tf_to_torch(tf.zeros([2], dt))
    assert seen == [tf.float32]
    devices = []
    from horovod_tpu_torch.ops import collective as C

    real_ar = C.allreduce
    monkeypatch.setattr(C, "allreduce", lambda a, *p, **k: devices.append(
        a.device) or real_ar(a, *p, **k))
    thvd.allreduce(x)
    assert devices == [torch.device("cpu")]
    b = tops._torch_to_tf(torch.arange(4, dtype=torch.bfloat16))
    assert b.dtype == tf.bfloat16 and b.numpy().tolist() == [0, 1, 2, 3]


def test_frontend_raises_without_tensorflow(monkeypatch):
    from horovod_tpu_torch.tensorflow import compression

    monkeypatch.setattr(compression, "tf", None)
    with pytest.raises(ImportError, match="TensorFlow"):
        compression.require_tf()


# --------------------------------------------------------------------------
# a gloo world of 2, rank-distinct inputs


def _ranks(shape=(3, 4)):
    return [W.rank_input(r, shape) for r in range(2)]


def test_world_collectives_exact(world):
    x0, x1 = _ranks()
    want = {"sum": x0 + x1, "avg": (x0 + x1) / np.float32(2),
            "scaled": (2 * x0 + 2 * x1) * np.float32(0.5),
            "gather": np.concatenate([x0, x1]), "bcast": x1,
            "graph_sum": x0 + x1, "graph_gather": np.concatenate([x0, x1]),
            "graph_bcast": x1}
    bf = (torch.tensor(x0, dtype=torch.bfloat16)
          + torch.tensor(x1, dtype=torch.bfloat16))
    want["fp16"] = (bf / torch.full((), 2, dtype=torch.bfloat16)).float().numpy()
    for r, got in enumerate(world):
        for k, v in want.items():
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got["int64"], [3, 30])
        assert got["int64"].dtype == np.int64
        np.testing.assert_array_equal(got["alltoall"],
                                      np.stack([x0[r], x1[r]]))
        assert int(got["join"]) == r


def test_world_gradients_exact(world):
    for r, got in enumerate(world):
        np.testing.assert_array_equal(got["grad_allreduce"],
                                      np.full((2, 3), 3.0))
        rows = 3.0 * np.arange(4, dtype=np.float32)[2 * r:2 * r + 2]
        np.testing.assert_array_equal(got["grad_allgather"],
                                      np.tile(rows[:, None], (1, 3)))
        np.testing.assert_array_equal(got["grad_broadcast"],
                                      np.full((2, 3), 3.0 if r == 0 else 0.0))
        assert float(got["tape"]) == (4.0 + 8.0) / 2


def test_world_indexed_slices_and_variables(world):
    v0, v1 = _ranks((2, 2))
    for got in world:
        np.testing.assert_array_equal(
            got["slices_values"], np.concatenate([v0, v1]) / np.float32(2))
        np.testing.assert_array_equal(got["slices_indices"], [0, 3, 1, 4])
        assert got["slices_indices"].dtype == np.int64
        dense = np.zeros((5, 2), np.float32)
        dense[[0, 3]] += v0
        dense[[1, 4]] += v1
        np.testing.assert_array_equal(got["slices_dense"], dense)
        np.testing.assert_array_equal(got["bcast_var"],
                                      W.rank_input(1, (2,)))
