"""Per-rank bodies of the port's frontend and estimator tests (the
TensorFlow, Keras, MXNet and Spark frontends in gloo worlds of 2). They
run inside ``horovod_tpu_torch.testing.run_world`` (or
``run_barrier_job``) children, so this module must not import JAX, and
imports TensorFlow only inside the bodies that need it; results go back
as numpy. Every input is rank-distinct and integer-valued where the
test holds it to numpy arithmetic exactly."""

import numpy as np
import torch

import horovod_tpu_torch as hvd


def rank_input(r: int, shape=(3, 4)) -> np.ndarray:
    """Rank ``r``'s integer-valued f32 input."""
    return (np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            + 100.0 * (r + 1))


# --------------------------------------------------------------------------
# TensorFlow


def tf_world_worker():
    """One rank: every TF collective on rank-distinct inputs, eagerly and
    inside ``tf.function`` (the ``tf.py_function`` route), the three
    registered gradients, ``DistributedGradientTape``, ``IndexedSlices``
    and ``broadcast_variables``."""
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as thvd

    r = thvd.rank()
    x = tf.constant(rank_input(r))
    out = {
        "sum": thvd.allreduce(x, op=thvd.Sum),
        "avg": thvd.allreduce(x, op=thvd.Average),
        "scaled": thvd.allreduce(x, op=thvd.Sum, prescale_factor=2.0,
                                 postscale_factor=0.5),
        "fp16": thvd.allreduce(x, op=thvd.Average,
                               compression=thvd.Compression.fp16),
        "int64": thvd.allreduce(tf.constant([r + 1, 10 * (r + 1)],
                                            tf.int64), op=thvd.Sum),
        "gather": thvd.allgather(x),
        "bcast": thvd.broadcast(x, root_rank=1),
        "alltoall": thvd.alltoall(x[:2]),
    }

    @tf.function
    def graph(t):
        return (thvd.allreduce(t, op=thvd.Sum), thvd.allgather(t),
                thvd.broadcast(t, root_rank=1))

    out["graph_sum"], out["graph_gather"], out["graph_bcast"] = graph(x)

    v = tf.Variable(rank_input(r, (2, 3)))
    with tf.GradientTape() as tape:
        y = tf.reduce_sum(thvd.allreduce(v, op=thvd.Sum) * (r + 1))
    out["grad_allreduce"] = tape.gradient(y, v)
    with tf.GradientTape() as tape:
        g = thvd.allgather(v)
        w = tf.range(tf.shape(g)[0], dtype=tf.float32)[:, None] * (r + 1)
        y = tf.reduce_sum(g * w)
    out["grad_allgather"] = tape.gradient(y, v)
    with tf.GradientTape() as tape:
        y = tf.reduce_sum(thvd.broadcast(v, root_rank=0) * (r + 1))
    out["grad_broadcast"] = tape.gradient(y, v)

    w = tf.Variable(2.0)
    with thvd.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = w * w * float(r + 1)
    out["tape"] = tape.gradient(loss, w)

    values = tf.constant(rank_input(r, (2, 2)))
    indices = tf.constant([r, 3 + r], dtype=tf.int64)
    s = tf.IndexedSlices(values, indices, dense_shape=tf.constant([5, 2]))
    avg = thvd.allreduce(s, op=thvd.Average)
    out["slices_values"] = avg.values
    out["slices_indices"] = avg.indices
    out["slices_dense"] = thvd.allreduce(s, op=thvd.Sum, sparse_as_dense=True)

    var = tf.Variable(rank_input(r, (2,)))
    thvd.broadcast_variables([var], root_rank=1)
    out["bcast_var"] = var
    out["join"] = thvd.join()
    return {k: np.asarray(v) for k, v in out.items()}


# --------------------------------------------------------------------------
# Keras


def _keras_model(r: int):
    import keras

    model = keras.Sequential([
        keras.layers.Input(shape=(4,)),
        keras.layers.Dense(3, activation="relu"),
        keras.layers.Dense(1),
    ])
    model.set_weights([w + 0.5 * r for w in _keras_weights()])
    return model


def _keras_weights():
    rng = np.random.RandomState(7)
    return [rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32),
            rng.randn(3, 1).astype(np.float32), rng.randn(1).astype(np.float32)]


def keras_world_worker():
    """One rank: the Adasum mixin's one sync of two rank-distinct deltas
    (``backward_passes_per_step=2``: the first apply stays local), the
    averaging mixin's one step of rank-distinct gradients, the broadcast
    callback over rank-distinct weights, the metric average, the warmup's
    LR sequence at a world of 2 and a ``model.fit`` whose weights every
    rank must share."""
    import keras
    import tensorflow as tf

    import horovod_tpu_torch.keras as khvd

    r = khvd.rank()
    out = {}
    start = np.arange(8, dtype=np.float32).reshape(4, 2) / 8.0
    v = tf.Variable(start)
    opt = khvd.DistributedOptimizer(keras.optimizers.SGD(0.5), op=khvd.Adasum,
                                    backward_passes_per_step=2)
    grads = [np.full((4, 2), 0.25 * (r + 1), np.float32),
             np.linspace(-1, 1, 8, dtype=np.float32).reshape(4, 2) * (r + 1)]
    for g in grads:
        opt.apply_gradients([(tf.constant(g), v)])
        out.setdefault("adasum_after", []).append(v.numpy().copy())
    out["adasum_start"] = start
    out["adasum_grads"] = np.stack(grads)

    v2 = tf.Variable(start)
    opt2 = khvd.DistributedOptimizer(keras.optimizers.SGD(0.5))
    opt2.apply_gradients([(tf.constant(grads[1]), v2)])
    out["avg_step"] = v2.numpy()

    model = _keras_model(r)
    model.compile(optimizer=khvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.08, momentum=0.9)),
        loss="mse", jit_compile=False)
    rng = np.random.RandomState(11 + r)
    x = rng.randn(16, 4).astype(np.float32)
    y = rng.randn(16, 1).astype(np.float32)
    cbs = [khvd.BroadcastGlobalVariablesCallback(0),
           khvd.MetricAverageCallback(),
           khvd.LearningRateWarmupCallback(warmup_epochs=2, steps_per_epoch=2)]
    lrs = []

    class _LR(keras.callbacks.Callback):
        def on_batch_begin(self, batch, logs=None):
            lrs.append(float(keras.ops.convert_to_numpy(
                self.model.optimizer.learning_rate)))

    keras.utils.set_random_seed(3)
    hist = model.fit(x, y, batch_size=8, epochs=3, verbose=0,
                     callbacks=cbs + [_LR()], shuffle=False)
    out["fit_weights"] = model.get_weights()
    out["fit_loss"] = np.asarray(hist.history["loss"])
    out["fit_lrs"] = np.asarray(lrs)

    cb = khvd.MetricAverageCallback()
    logs = {"loss": float(2 * (r + 1)), "acc": np.float32(0.25 * (r + 1))}
    cb.on_epoch_end(0, logs)
    out["metrics"] = np.asarray([logs["loss"], logs["acc"]])
    out["numpy_allreduce"] = khvd.allreduce(np.float32(3.0 * (r + 1)),
                                            op=khvd.Sum)
    return out


# --------------------------------------------------------------------------
# MXNet (duck-typed)


class NDArray:
    """The small NDArray surface the bridge uses: ``asnumpy()`` and
    ``__setitem__``."""

    def __init__(self, a):
        self._a = np.array(a)

    def asnumpy(self):
        return self._a.copy()

    def __setitem__(self, key, value):
        self._a[key] = value

    @property
    def context(self):
        return "cpu(0)"


class FakeOptimizer:
    def __init__(self):
        self.rescale_grad = 1.0
        self.seen = []

    def update(self, index, weight, grad, state):
        self.seen.append(("update", index, np.array(grad)))

    def update_multi_precision(self, index, weight, grad, state):
        self.seen.append(("ump", index, [np.array(g) for g in grad]))


class FakeParam:
    def __init__(self, name, grad, grad_req="write"):
        self.name = name
        self.grad_req = grad_req
        self._grad = grad

    def list_grad(self):
        return [self._grad]


def mxnet_ops(r: int) -> dict:
    """The mxnet bridge's collectives on rank ``r``'s inputs, numpy
    arrays and a duck-typed NDArray (each result comes back as its
    input's kind; the in-place ones write into the input)."""
    import horovod_tpu_torch.mxnet as mhvd

    x = rank_input(r)
    nd = NDArray(x)
    out = {"sum": mhvd.allreduce(x, average=False, name="s"),
           "avg": mhvd.allreduce(x, average=True),
           "gather": mhvd.allgather(x[:2]),
           "bcast": mhvd.broadcast(x, root_rank=1)}
    inplace = x.copy()
    assert mhvd.allreduce_(inplace, average=False) is inplace
    out["sum_"] = inplace
    assert mhvd.broadcast_(nd, 1) is nd
    out["bcast_nd"] = nd.asnumpy()
    kinds = {k: type(v).__name__ for k, v in out.items()}
    out = {k: np.asarray(v) for k, v in out.items()}
    out["kinds"] = kinds

    inner = FakeOptimizer()
    opt = mhvd.DistributedOptimizer(inner)
    out["rescale_grad"] = opt.rescale_grad
    grad = np.full((3,), 2.0 * (r + 1), np.float32)
    opt.update(0, np.zeros(3, np.float32), grad, None)
    out["update_grad"] = grad
    gs = [np.ones((2,), np.float32) * (r + 1), np.full((2,), 3.0 * (r + 1),
                                                       np.float32)]
    opt.update_multi_precision([4, 7], [None, None], gs, [None, None])
    out["ump_grads"] = np.stack(gs)
    out["inner_seen"] = [s[:2] for s in inner.seen]

    class Trainer(mhvd._TrainerAllreduceMixin):
        def __init__(self, params):
            self._params = params

    g1 = np.full((2,), float(r + 1), np.float32)
    g2 = np.full((2,), 5.0 * (r + 1), np.float32)
    Trainer([FakeParam("w", g1), FakeParam("frozen", g2, "null")])\
        ._allreduce_grads()
    out["trainer"] = np.stack([g1, g2])
    params = {"w": rank_input(r, (4,)), "b": np.full((2,), r + 1.0,
                                                     np.float32)}
    mhvd.broadcast_parameters(params, root_rank=1)
    out["params"] = params
    return out


def mxnet_world_worker():
    return mxnet_ops(hvd.rank())


# --------------------------------------------------------------------------
# Spark (a barrier job over a fake context)


def spark_slot_fn(device="cpu"):
    """``fn`` of a barrier task: form the world from the slot's
    environment, then the mxnet bridge's collectives, exact."""
    import os

    hvd.init(device=device)
    try:
        env = {k: os.environ[k] for k in (
            "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
            "HOROVOD_CROSS_SIZE", "MASTER_ADDR", "MASTER_PORT",
            "TORCHELASTIC_USE_AGENT_STORE")}
        return {"env": env, "rank": hvd.rank(), "size": hvd.size(),
                "device": str(hvd.device()), "ops": mxnet_ops(hvd.rank())}
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# the hook optimizer's launch order


def sync_order_worker():
    """One rank: a hook ``DistributedOptimizer`` whose ``synchronize``
    finds no gradient reduced by a hook (the dummy step of
    ``broadcast_optimizer_state``) must launch the allreduces in
    parameter order; returns the names it launched, in order, and the
    reduced gradients."""
    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch.testing import watching_calls

    r = hvd.rank()
    params = [torch.nn.Parameter(torch.zeros(4)) for _ in range(16)]
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1),
        named_parameters=[(f"p{i:02d}", p) for i, p in enumerate(params)])
    for i, p in enumerate(params):
        p.grad = torch.full((4,), float(i + 10 * r))
    names = []
    with watching_calls(thvd, ["allreduce_async_"],
                        lambda n, a, kw: names.append(kw.get("name"))):
        opt.synchronize()
    return {"names": names,
            "grads": np.stack([p.grad.numpy().copy() for p in params])}


# --------------------------------------------------------------------------
# the harness's bounds


def die_on_rank_one(*_):
    """Rank (or task) 1's process ends without a result; the others
    return at once."""
    import os

    if int(os.environ.get("HOROVOD_RANK", "0")) == 1:
        os._exit(3)
    return 0
