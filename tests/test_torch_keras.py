"""The Keras frontend of horovod_tpu_torch (``horovod_tpu_torch/keras/``,
``horovod_tpu_torch/tensorflow/keras/``) against the JAX package's
(``horovod_tpu/keras/``) on the same inputs, on Keras's TensorFlow
backend.

In one process (the port a world of one, the JAX package 8 replicas
whose averaging is the identity in a graph): ``fit`` losses and weights
bit for bit, the eager custom-loop step within rtol 1e-6 (the JAX
package's eager Average sums its replicas: a ULP); the callbacks' LR sequences equal
the JAX callbacks' at the same world size (the JAX package's ``size()``
set to the port's); ``load_model`` re-wraps the restored optimizer with
the same slot values. A gloo world of 2 holds the Adasum mixin's
combine of two rank-distinct deltas to the JAX package's Adasum of the
same deltas (rtol 1e-6: both sum the dot products in f32, in their own
orders), the averaging mixin's step to numpy exactly, a ``fit`` whose
weights every rank shares, and the metric average."""

import concurrent.futures

import numpy as np
import pytest

keras = pytest.importorskip("keras")
tf = pytest.importorskip("tensorflow")

import horovod_tpu.keras as jk  # noqa: E402
import horovod_tpu.tensorflow as jtf  # noqa: E402
import horovod_tpu_torch.keras as tk  # noqa: E402
import horovod_tpu_torch.tensorflow as ttf  # noqa: E402
import horovod_tpu_torch.tensorflow.keras as ttk  # noqa: E402
from horovod_tpu_torch.testing import run_world  # noqa: E402

import torch_frontends_workers as W  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def world_future():
    """:func:`torch_frontends_workers.keras_world_worker` in one gloo
    world of 2, started with the module's first test."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(run_world, W.keras_world_worker, 2, timeout=150)


@pytest.fixture(scope="module")
def both(world_future):
    jk.init()
    tk.init(device="cpu")
    yield
    tk.shutdown()
    jk.shutdown()


@pytest.fixture(scope="module")
def world(world_future):
    return world_future.result(timeout=180)


def _model():
    model = keras.Sequential([
        keras.layers.Input(shape=(4,)),
        keras.layers.Dense(3, activation="relu"),
        keras.layers.Dense(1),
    ])
    model.set_weights(W._keras_weights())
    return model


def _data(n=32):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 4).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("jit", [False, True])
def test_fit_losses_and_weights_match(both, jit):
    x, y = _data()
    res = []
    for k in (jk, tk):
        model = _model()
        model.compile(optimizer=k.DistributedOptimizer(
            keras.optimizers.SGD(learning_rate=0.01, momentum=0.9)),
            loss="mse", jit_compile=jit)
        keras.utils.set_random_seed(1)
        hist = model.fit(x, y, batch_size=8, epochs=2, verbose=0)
        res.append((hist.history["loss"], model.get_weights()))
    assert res[1][0] == res[0][0]
    _equal(res[1][1], res[0][1])


def test_apply_gradients_matches(both):
    x, y = _data(8)
    out = []
    for k in (jk, tk):
        model = _model()
        opt = k.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.1))
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean((model(x) - y) ** 2)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        out.append(model.get_weights())
        assert isinstance(opt, k._DistributedOptimizerMixin)
        assert isinstance(opt, keras.optimizers.SGD)
    # eager, the JAX package averages its 8 replicas' gradients by a sum
    # (a ULP off the identity); the port's world of one exchanges nothing
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError):
        tk.DistributedOptimizer(keras.optimizers.SGD(0.1),
                                backward_passes_per_step=2)


def _lr_trace(k, cbs, epochs=3, steps=4):
    x, y = _data(8 * steps)
    model = _model()
    model.compile(optimizer=k.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.08, momentum=0.9)), loss="mse")
    lrs = []

    class _Rec(keras.callbacks.Callback):
        def on_batch_begin(self, batch, logs=None):
            lrs.append(float(keras.ops.convert_to_numpy(
                self.model.optimizer.learning_rate)))

    keras.utils.set_random_seed(2)
    hist = model.fit(x, y, batch_size=8, epochs=epochs, verbose=0,
                     callbacks=cbs + [_Rec()])
    return lrs, hist.history


CALLBACKS = {
    "warmup": lambda k: [k.BroadcastGlobalVariablesCallback(0),
                         k.MetricAverageCallback(),
                         k.LearningRateWarmupCallback(warmup_epochs=2,
                                                      steps_per_epoch=4)],
    "schedule": lambda k: [k.LearningRateScheduleCallback(
        multiplier=lambda epoch: 0.5 ** epoch, start_epoch=0,
        momentum_correction=False)],
    "smooth": lambda k: [k.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        steps_per_epoch=4, start_epoch=1)],
}


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CALLBACKS))
def test_callback_lr_sequences_match(both, name, size, monkeypatch):
    """The LR at every batch (and the logged LR and loss) of the JAX
    callbacks equals the port's, each package's ``size()`` set to
    ``size`` for the callbacks."""
    monkeypatch.setattr(jtf, "size", lambda: size)
    monkeypatch.setattr(ttf, "size", lambda: size)
    j = _lr_trace(jk, CALLBACKS[name](jk))
    t = _lr_trace(tk, CALLBACKS[name](tk))
    assert t[0] == j[0]
    if size == 1:   # with size() set above 1, Average runs in the JAX fit
        assert t[1] == j[1]


def test_metric_average_callback_values(both):
    for k in (jk, tk):
        cb = k.MetricAverageCallback()
        logs = {"loss": 2.0, "acc": np.float32(0.5)}
        cb.on_epoch_end(0, logs)
        np.testing.assert_allclose(logs["loss"], 2.0, rtol=1e-6)
        np.testing.assert_allclose(logs["acc"], 0.5, rtol=1e-6)


def test_load_model_rewraps_optimizer_with_its_slots(both, tmp_path):
    model = _model()
    model.compile(optimizer=keras.optimizers.Adam(learning_rate=0.003),
                  loss="mse")
    x, y = _data(16)
    model.fit(x, y, batch_size=8, epochs=1, verbose=0)
    path = str(tmp_path / "model.keras")
    model.save(path)
    loaded = [k.load_model(path) for k in (jk, tk)]
    for k, m in zip((jk, tk), loaded):
        assert isinstance(m.optimizer, k._DistributedOptimizerMixin)
        assert isinstance(m.optimizer, keras.optimizers.Adam)
        np.testing.assert_allclose(
            float(keras.ops.convert_to_numpy(m.optimizer.learning_rate)),
            0.003, rtol=1e-6)
    _equal([v.numpy() for v in loaded[1].optimizer.variables],
           [v.numpy() for v in loaded[0].optimizer.variables])
    _equal([v.numpy() for v in loaded[1].optimizer.variables],
           [v.numpy() for v in model.optimizer.variables])
    for m in loaded:
        m.fit(x, y, batch_size=8, epochs=1, verbose=0, shuffle=False)
    _equal(loaded[1].get_weights(), loaded[0].get_weights())


def test_load_model_custom_objects_and_optimizer(both, tmp_path):
    def myact(x):
        return keras.ops.relu(x) * 1.5

    class MySGD(keras.optimizers.SGD):
        pass

    model = keras.Sequential([
        keras.layers.Input(shape=(4,)),
        keras.layers.Dense(3, activation=myact),
        keras.layers.Dense(1),
    ])
    model.compile(optimizer=MySGD(learning_rate=0.02), loss="mse")
    x, y = _data(16)
    model.fit(x, y, batch_size=8, epochs=1, verbose=0)
    path = str(tmp_path / "model_custom.keras")
    model.save(path)
    for k in (jk, tk):
        loaded = k.load_model(path, custom_optimizers=[MySGD],
                              custom_objects={"myact": myact})
        assert isinstance(loaded.optimizer, k._DistributedOptimizerMixin)
        assert isinstance(loaded.optimizer, MySGD)
        loaded.fit(x, y, batch_size=8, epochs=1, verbose=0)


def test_broadcast_global_variables_and_numpy_allreduce(both):
    for k in (jk, tk):
        model = _model()
        model.compile(optimizer=keras.optimizers.SGD(0.01), loss="mse")
        k.broadcast_global_variables(0, model=model)
        _equal(model.get_weights(), W._keras_weights())
        with pytest.raises(ValueError):
            k.broadcast_global_variables(0)
        np.testing.assert_allclose(k.allreduce(np.float32(3.0),
                                               op=k.Average), 3.0, rtol=1e-6)
    assert tk.allreduce(np.float32(3.0), op=tk.Sum) == 3.0


def test_metrics_callback_emits(both):
    from horovod_tpu_torch.observability import metrics

    seen = []
    cb = tk.MetricsCallback(every_n_steps=2, printer=seen.append)
    before = metrics.value("fit_batches") or 0.0
    x, y = _data(32)
    model = _model()
    model.compile(optimizer=tk.DistributedOptimizer(
        keras.optimizers.SGD(0.01)), loss="mse")
    model.fit(x, y, batch_size=8, epochs=1, verbose=0, callbacks=[cb])
    assert len(seen) == 3   # batches 2 and 4, then the train end
    assert all(s.startswith("horovod_tpu_torch metrics @ batch") for s in seen)
    assert metrics.value("fit_batches") == before + 4


def test_import_alias_and_backend(both):
    assert ttk.DistributedOptimizer is tk.DistributedOptimizer
    assert ttk.load_model is tk.load_model
    assert ttk.callbacks is tk.callbacks
    assert keras.backend.backend() == "tensorflow"
    missing = {n for n in dir(jk) if not n.startswith("_")} - set(dir(tk))
    assert not missing, sorted(missing)


# --------------------------------------------------------------------------
# a gloo world of 2, rank-distinct inputs


def _jax_adasum(d0, d1):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import horovod_tpu as jhvd
    from horovod_tpu.ops import adasum as jada

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        stacked = jax.device_put(
            jnp.asarray(np.stack([d0, d1])),
            NamedSharding(jhvd.mesh(), P(jhvd.data_axis())))
        return np.asarray(jada.adasum_allreduce(stacked))
    finally:
        jhvd.shutdown()


def test_world_adasum_mixin_matches_jax_adasum(world):
    """Apply 1 stays local (``backward_passes_per_step=2``); apply 2 turns
    each rank's local update into a delta and writes back the slot plus
    the Adasum of the two deltas: the JAX package's Adasum of the same
    deltas."""
    start = world[0]["adasum_start"]
    lr = np.float32(0.5)
    deltas = []
    for r, got in enumerate(world):
        g0, g1 = got["adasum_grads"]
        first = start + (-g0 * lr)
        np.testing.assert_array_equal(got["adasum_after"][0], first)
        deltas.append((first + (-g1 * lr)) - start)
    want = start + _jax_adasum(*deltas)
    for got in world:
        np.testing.assert_allclose(got["adasum_after"][1], want, rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(world[0]["adasum_after"][1],
                                  world[1]["adasum_after"][1])


def test_world_average_step_exact(world):
    start = world[0]["adasum_start"]
    g = [got["adasum_grads"][1] for got in world]
    want = start + (-((g[0] + g[1]) / np.float32(2)) * np.float32(0.5))
    for got in world:
        np.testing.assert_array_equal(got["avg_step"], want)


def test_world_fit_shares_weights_and_warmup(world, monkeypatch):
    _equal(world[1]["fit_weights"], world[0]["fit_weights"])
    for a, b in zip(world[0]["fit_weights"], W._keras_weights()):
        assert not np.array_equal(a, b)   # it trained
    np.testing.assert_array_equal(world[0]["fit_loss"], world[1]["fit_loss"])
    # the warmup's rate at each batch, the JAX callback's at a world of 2
    monkeypatch.setattr(jtf, "size", lambda: 2)
    jk.init()
    try:
        want, _ = _lr_trace(jk, [jk.LearningRateWarmupCallback(
            warmup_epochs=2, steps_per_epoch=2)], epochs=3, steps=2)
    finally:
        jk.shutdown()
    for got in world:
        np.testing.assert_array_equal(got["fit_lrs"], want)


def test_world_metric_average_and_numpy_allreduce(world):
    for got in world:
        np.testing.assert_array_equal(got["metrics"], [3.0, 0.375])
        assert float(got["numpy_allreduce"]) == 9.0
