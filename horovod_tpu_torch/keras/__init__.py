"""Keras frontend: ``import horovod_tpu_torch.keras as hvd``.

Counterpart of ``horovod_tpu/keras/__init__.py`` (reference
``horovod/keras/__init__.py`` + the shared ``horovod/_keras/__init__.py``,
0.19.2): ``DistributedOptimizer`` through a dynamically created
subclass of the user's optimizer that aggregates gradients across ranks
before applying them (reference ``_keras/__init__.py:20-78``), the
broadcast / metric / LR callbacks (:mod:`.callbacks`), and ``load_model``,
which re-wraps a checkpointed optimizer as a distributed one
(``keras/__init__.py:117-160``).

Keras 3 on its TensorFlow backend, as in the JAX package: the mixins
keep TF variables and ``tf.cond``; the collectives cross to the port's
data plane through :mod:`horovod_tpu_torch.tensorflow`. Keras's torch
backend is not a route. Without Keras (or TensorFlow) the module imports
and its functions raise.
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, process_rank, process_size, is_homogeneous,
    mpi_threads_supported, mpi_enabled, gloo_enabled,
    nccl_built, mpi_built, gloo_built, ccl_built,
    ddl_built, xla_built,
)
import horovod_tpu_torch.tensorflow as _hvd_tf
from horovod_tpu_torch.tensorflow import (  # noqa: F401
    Adasum, Average, ReduceOp, Sum,
    allgather, allgather_object, alltoall, broadcast, broadcast_object, join,
)
from horovod_tpu_torch.tensorflow.compression import Compression, tf  # noqa: F401
from horovod_tpu_torch.keras import callbacks  # noqa: F401
from horovod_tpu_torch.keras.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    MetricsCallback,
    keras,
    require_keras,
)


def allreduce(value, op=Average, *, name=None, compression=Compression.none):
    """Allreduce of a tensor or numpy value (reference
    ``keras/__init__.py:82-95``)."""
    require_keras()
    if isinstance(value, (np.ndarray, np.generic, float, int)):
        out = _hvd_tf.allreduce(tf.convert_to_tensor(value), op, name=name,
                                compression=compression)
        return out.numpy()
    return _hvd_tf.allreduce(value, op, name=name, compression=compression)


def broadcast_global_variables(root_rank: int = 0, model=None):
    """Broadcast a model's weights + optimizer state from root (reference
    ``keras/__init__.py:97-106``; TF2 has no global-variables collection,
    so the model is passed explicitly)."""
    if model is None:
        raise ValueError(
            "Keras 3 has no global-variables collection; pass model="
        )
    _hvd_tf.broadcast_variables(model.weights, root_rank)
    if getattr(model, "optimizer", None) is not None:
        _hvd_tf.broadcast_variables(model.optimizer.variables, root_rank)


class _DistributedOptimizerMixin:
    """Gradient-aggregating override mixed over the user's optimizer
    class (reference ``_keras/__init__.py:20-78``): every ``apply`` first
    allreduces the gradients across ranks. Keras 3 funnels both
    ``apply_gradients`` and ``apply`` through ``apply``, so this one
    override covers ``model.fit`` and custom training loops."""

    _hvd_compression = Compression.none
    _hvd_sparse_as_dense = False
    _hvd_op = Average

    def _hvd_allreduce_grads(self, grads):
        return [
            g if g is None else _hvd_tf.allreduce(
                g, self._hvd_op, compression=self._hvd_compression,
                sparse_as_dense=self._hvd_sparse_as_dense,
            )
            for g in grads
        ]

    def apply(self, grads, trainable_variables=None):
        if size() > 1:
            grads = self._hvd_allreduce_grads(list(grads))
        return super().apply(grads, trainable_variables)


class _AdasumOptimizerMixin:
    """Delta-style Adasum override mixed over the user's optimizer class
    (semantics of reference ``tensorflow/__init__.py:317-411``, in Keras
    3's API): a ``delta_start`` slot per variable; every
    ``backward_passes_per_step``-th ``apply`` the locally updated
    variables become deltas, Adasum-combined across ranks (the butterfly
    of :mod:`horovod_tpu_torch.ops.adasum`, one tensor a call: the
    ``adasum_pair_combine`` kernel a level on the card), and written back
    on top of the slot."""

    _hvd_compression = Compression.none
    _hvd_backward_passes = 1

    def build(self, variables):
        super().build(variables)
        self._hvd_starts = [
            self.add_variable_from_reference(v, name="delta_start")
            for v in variables
        ]
        for s, v in zip(self._hvd_starts, variables):
            s.assign(v)

    def _hvd_sync(self, tvars):
        for v, s in zip(tvars, self._hvd_starts):
            delta = tf.convert_to_tensor(v) - tf.convert_to_tensor(s)
            reduced = _hvd_tf.allreduce(
                delta, Adasum, compression=self._hvd_compression
            )
            s.assign_add(tf.cast(reduced, s.dtype))
            v.assign(s)
        return tf.constant(True)

    def apply(self, grads, trainable_variables=None):
        result = super().apply(grads, trainable_variables)
        tvars = (
            list(trainable_variables)
            if trainable_variables is not None
            else list(self._trainable_variables)
        )
        bpps = self._hvd_backward_passes
        if bpps == 1:
            self._hvd_sync(tvars)
        else:
            # self.iterations was just incremented by super().apply
            it = tf.cast(tf.convert_to_tensor(self.iterations), tf.int64)
            tf.cond(
                tf.equal(it % bpps, 0),
                lambda: self._hvd_sync(tvars),
                lambda: tf.constant(True),
            )
        return result


def create_distributed_optimizer(optimizer, *, compression=Compression.none,
                                 sparse_as_dense=False, op=Average,
                                 backward_passes_per_step: int = 1,
                                 name=None):
    """Dynamically subclass `optimizer` with distributed gradient
    aggregation (reference ``_keras/__init__.py:20-78``: ``cls =
    type(..., (Mixin, klass))`` then ``from_config``). ``op=Adasum``
    selects the delta-style mixin (reference
    ``tensorflow/__init__.py:317-411``), which also honors
    ``backward_passes_per_step``."""
    require_keras()
    if op == Adasum:
        cls = type(
            name or optimizer.__class__.__name__,
            (_AdasumOptimizerMixin, optimizer.__class__),
            {},
        )
        opt = cls.from_config(optimizer.get_config())
        opt._hvd_compression = compression
        opt._hvd_backward_passes = max(1, int(backward_passes_per_step))
        return opt
    if backward_passes_per_step != 1:
        raise NotImplementedError(
            "backward_passes_per_step > 1 is the torch/optax frontends' "
            "feature; the reference's 0.19.2 Keras wrapper has no local "
            "gradient accumulation (_keras/__init__.py:20-78)"
        )
    cls = type(
        name or optimizer.__class__.__name__,
        (_DistributedOptimizerMixin, optimizer.__class__),
        {},
    )
    opt = cls.from_config(optimizer.get_config())
    opt._hvd_compression = compression
    opt._hvd_sparse_as_dense = sparse_as_dense
    opt._hvd_op = op
    return opt


DistributedOptimizer = create_distributed_optimizer


def _wrap_optimizer_class(klass, compression=Compression.none, op=Average):
    """A deserializable distributed subclass of `klass` (used by
    :func:`load_model`; reference ``keras/__init__.py:117-160``)."""
    return type(
        klass.__name__, (_DistributedOptimizerMixin, klass),
        {"_hvd_compression": compression, "_hvd_op": op},
    )


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a saved model with its optimizer re-wrapped as a
    ``DistributedOptimizer`` (reference ``keras/__init__.py:117-160``).

    The reference shadows optimizer classes during deserialization;
    Keras 3 resolves built-in classes by module path before consulting
    ``custom_objects``, so built-ins are re-wrapped *after* the load,
    their restored slots moved across. ``custom_optimizers`` classes
    (which do resolve through ``custom_objects``) are shadowed the
    reference's way."""
    require_keras()
    horovod_objects = {}
    if custom_optimizers is not None:
        horovod_objects.update({
            klass.__name__: _wrap_optimizer_class(klass, compression)
            for klass in custom_optimizers
        })
    if custom_objects is not None:
        horovod_objects.update(custom_objects)
    model = keras.models.load_model(
        filepath, custom_objects=horovod_objects or None
    )
    opt = getattr(model, "optimizer", None)
    if opt is not None and not isinstance(opt, _DistributedOptimizerMixin):
        dist = create_distributed_optimizer(opt, compression=compression)
        if opt.built:
            dist.build(model.trainable_variables)
            for dst, src in zip(dist.variables, opt.variables):
                dst.assign(src)
        model.optimizer = dist
    return model
