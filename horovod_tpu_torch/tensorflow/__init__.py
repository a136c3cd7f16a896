"""TensorFlow frontend: ``import horovod_tpu_torch.tensorflow as hvd``.

Counterpart of ``horovod_tpu/tensorflow/__init__.py`` (reference
``horovod/tensorflow/__init__.py``, 0.19.2): ``allreduce`` with
IndexedSlices -> allgather handling and Average/Sum/Adasum ops
(reference ``tensorflow/__init__.py:43-122``), ``broadcast_variables``
(``:126-152``), ``DistributedGradientTape`` (``:478-535``), and a
``DistributedOptimizer`` for Keras optimizers (``:270-315`` /
``_keras/__init__.py:20-78``). TF1-style hooks and
``tf.compat.v1.train.Optimizer`` wrapping are out of scope, as in the JAX
package: the frontend targets TF2/Keras 3 eager and ``tf.function``.

Execution: every collective crosses to PyTorch by dlpack and runs on the
port's data plane (:mod:`.mpi_ops`), on this process's GPU unless it
asked for the CPU. TensorFlow is imported here when it can be; the
module imports without it, and its functions raise ``ImportError``.
"""

from __future__ import annotations

from horovod_tpu_torch.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, process_rank, process_size, is_homogeneous,
    mpi_threads_supported, mpi_enabled, gloo_enabled,
    num_rank_is_power_2, gpu_available,
    nccl_built, mpi_built, gloo_built, ccl_built,
    ddl_built, xla_built,
)
from horovod_tpu_torch.tensorflow.compression import (  # noqa: F401
    Compression, require_tf, tf,
)
from horovod_tpu_torch.tensorflow import mpi_ops
from horovod_tpu_torch.tensorflow.mpi_ops import (  # noqa: F401
    Adasum, Average, ReduceOp, Sum,
    allgather, alltoall, broadcast, join,
)
from horovod_tpu_torch.ops.collective import (  # noqa: F401
    allgather_object, broadcast_object,
)


def allreduce(tensor, op=Average, *, name=None, compression=Compression.none,
              sparse_as_dense: bool = False,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Allreduce with the reference's full tensor handling
    (``tensorflow/__init__.py:43-122``): ``tf.IndexedSlices`` gradients
    become an allgather of values and int32 indices (a distributed
    concatenation of the sparse updates) unless ``sparse_as_dense``
    densifies them first; dense tensors are compressed, reduced, and
    decompressed."""
    require_tf()
    if isinstance(tensor, tf.IndexedSlices):
        if sparse_as_dense:
            tensor = tf.convert_to_tensor(tensor)
        else:
            if op != Average and op != Sum:
                raise NotImplementedError(
                    "IndexedSlices allreduce supports Average and Sum only "
                    "(reference tensorflow/__init__.py:74-77)"
                )
            values = mpi_ops.allgather(tensor.values, name=name)
            indices = mpi_ops.allgather(
                tf.cast(tensor.indices, tf.int32),
                name=None if name is None else name + ".indices",
            )
            if op == Average:
                values = tf.cast(values, tensor.values.dtype) / size()
            return tf.IndexedSlices(
                values, tf.cast(indices, tensor.indices.dtype),
                dense_shape=tensor.dense_shape,
            )
    tensor_compressed, ctx = compression.compress(tensor)
    summed = mpi_ops.allreduce(
        tensor_compressed, op, name=name,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
    )
    return compression.decompress(summed, ctx)


def broadcast_variables(variables, root_rank: int = 0):
    """Assign every variable its root-rank value: the start-of-training /
    post-restore sync (reference ``tensorflow/__init__.py:126-152``)."""
    require_tf()
    for var in variables:
        var.assign(mpi_ops.broadcast(tf.convert_to_tensor(var), root_rank))


class DistributedGradientTape:
    """Wrap ``tf.GradientTape`` so ``gradient()`` allreduces the gradients
    (reference ``tensorflow/__init__.py:478-535``)."""

    def __init__(self, gradtape, *, device_dense="", device_sparse="",
                 compression=Compression.none, sparse_as_dense=False,
                 op=Average):
        if not isinstance(gradtape, require_tf().GradientTape):
            raise ValueError("DistributedGradientTape wraps a tf.GradientTape")
        self._tape = gradtape
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense
        self._op = op

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, item):
        return getattr(self._tape, item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        return self._allreduce_grads(grads)

    def _allreduce_grads(self, grads):
        """Per-gradient allreduce (reference ``_make_allreduce_grads_fn``,
        ``tensorflow/__init__.py:234-255``)."""
        return tf.nest.map_structure(
            lambda g: g if g is None else allreduce(
                g, self._op, compression=self._compression,
                sparse_as_dense=self._sparse_as_dense,
            ),
            grads,
        )


def DistributedOptimizer(optimizer, *, compression=Compression.none,
                         sparse_as_dense=False, op=Average,
                         backward_passes_per_step: int = 1):
    """Wrap a Keras optimizer so gradient application first averages the
    gradients across ranks (reference ``tensorflow/__init__.py:270-315``;
    Keras path ``_keras/__init__.py:20-78``). ``op=Adasum`` selects the
    delta-style ``_AdasumOptimizerMixin`` subclass (reference
    ``tensorflow/__init__.py:317-411`` semantics, Keras 3 API), so the
    result stays a Keras optimizer usable with ``model.compile``."""
    from horovod_tpu_torch.keras import (
        create_distributed_optimizer as _create,
    )

    return _create(
        optimizer, compression=compression, sparse_as_dense=sparse_as_dense,
        op=op, backward_passes_per_step=backward_passes_per_step,
    )
