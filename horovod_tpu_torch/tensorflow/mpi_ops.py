"""Functional collective ops on ``tf.Tensor`` values.

Counterpart of ``horovod_tpu/tensorflow/mpi_ops.py`` (reference
``horovod/tensorflow/mpi_ops.py``). The reference registers custom TF
kernels that run in-graph on device buffers (``tensorflow/mpi_ops.cc:
286-473``); the JAX package crosses TF<->JAX by dlpack; here an eager
tensor crosses to PyTorch by dlpack (``torch.from_dlpack``: the buffer is
shared, not copied), moves to this process's device
(:func:`horovod_tpu_torch.basics.device`: ``cuda:<local_rank>`` unless
the process asked for the CPU), goes through the port's collective
(:mod:`horovod_tpu_torch.ops.collective`: NCCL on the card, gloo on the
CPU) and comes back to TF by dlpack of the result on the CPU. Bool and
64-bit tensors take a host copy instead, as in the JAX package.
Gradients are registered as the reference does (``tensorflow/mpi_ops.py:
110-201``): the gradient of allreduce is an allreduce, of allgather a
summed allreduce then this rank's slice, of broadcast a summed allreduce
zeroed off the root.

A single-process graph (a world of one) is plain TF math, so
``tf.function(jit_compile=True)`` compiles it; a multi-process graph
crosses through ``tf.py_function``, the analog of the reference's
AsyncOpKernel boundary, and cannot be compiled with ``jit_compile=True``
(as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.collective import Adasum, Average, ReduceOp, Sum
from horovod_tpu_torch.tensorflow.compression import require_tf, tf

__all__ = [
    "Average", "Sum", "Adasum", "ReduceOp",
    "allreduce", "allgather", "broadcast", "alltoall",
    "join", "size", "rank", "local_size", "local_rank",
]

size = basics.size
rank = basics.rank
local_size = basics.local_size
local_rank = basics.local_rank


def _host_copy_dtype(dtype) -> bool:
    """The dtypes that cross by a host copy, the JAX package's list
    (``horovod_tpu/tensorflow/mpi_ops.py:67``)."""
    return dtype in (tf.bool, tf.int64, tf.uint64, tf.float64)


def _tf_to_torch(t) -> torch.Tensor:
    """``t`` as a torch tensor on this process's device: dlpack (no copy
    while the tensor stays where it is), or a host copy for the dtypes of
    :func:`_host_copy_dtype` and for what dlpack refuses."""
    if _host_copy_dtype(t.dtype):
        host = torch.from_numpy(np.array(t))
    else:
        try:
            host = torch.from_dlpack(t)
        except Exception:  # noqa: BLE001 - the host copy carries anything
            host = torch.from_numpy(np.array(t))
    return host.to(basics.device())


def _torch_to_tf(out: torch.Tensor):
    """A collective's result as a TF tensor: dlpack of its CPU copy, or a
    host array where dlpack fails (bfloat16 through f32, exact)."""
    host = out.detach().cpu().contiguous()
    try:
        return tf.experimental.dlpack.from_dlpack(
            torch.utils.dlpack.to_dlpack(host))
    except Exception:  # noqa: BLE001 - the host array carries anything
        if host.dtype == torch.bfloat16:
            return tf.cast(tf.convert_to_tensor(host.float().numpy()),
                           tf.bfloat16)
        return tf.convert_to_tensor(host.numpy())


def _bridge(fn, inputs, out_dtype, out_shape=None):
    """Run the torch-level ``fn`` on TF ``inputs``; graph-safe through
    ``tf.py_function``. Single-process graphs never reach here (see
    :func:`_single_process_graph`)."""
    def run(*ts):
        return _torch_to_tf(fn(*[_tf_to_torch(t) for t in ts]))

    if tf.executing_eagerly():
        return run(*inputs)
    out = tf.py_function(run, inputs, Tout=out_dtype)
    if out_shape is not None:
        out.set_shape(out_shape)
    return out


def _single_process_graph() -> bool:
    """In a single-process graph the collectives reduce to plain TF math
    (scale / tile / identity), which keeps the traced step
    XLA-compilable (``jit_compile=True``) with no host round trip. The
    port's single process is a world of one, so Sum scales by 1."""
    require_tf()
    return not tf.executing_eagerly() and basics.process_size() == 1


def _allreduce_raw(tensor, op, name, prescale_factor=1.0, postscale_factor=1.0):
    if _single_process_graph():
        n = basics.size()
        t = tensor * prescale_factor if prescale_factor != 1.0 else tensor
        if op == Sum:
            out = t * tf.cast(n, t.dtype) if t.dtype.is_floating else t * n
        else:  # Average / Adasum of identical replicas is the identity
            out = t
        return out * postscale_factor if postscale_factor != 1.0 else out
    return _bridge(
        lambda a: C.allreduce(a, op, prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor),
        [tensor], tensor.dtype, tensor.shape,
    )


def allreduce(tensor, op: ReduceOp = Average, *, name=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Sum/average `tensor` across ranks, differentiably (reference
    ``tensorflow/mpi_ops.py:66-107`` + grad ``:110-143``). ``name`` is
    accepted for API parity."""
    require_tf()
    op = ReduceOp(op)

    @tf.custom_gradient
    def _fn(t):
        out = _allreduce_raw(t, op, name, prescale_factor, postscale_factor)

        def grad(dy):
            return _allreduce_raw(dy, op, None, prescale_factor,
                                  postscale_factor)

        return out, grad

    return _fn(tensor)


def allgather(tensor, *, name=None):
    """Concatenate `tensor` from all ranks on dimension 0, differentiably
    (reference ``tensorflow/mpi_ops.py:145-167``; grad sums the upstream
    gradient across ranks and takes this rank's slice, ``:110-139``)."""
    require_tf()
    n = basics.size()

    @tf.custom_gradient
    def _fn(t):
        if _single_process_graph():
            out = tf.tile(t, [n] + [1] * (len(t.shape) - 1))
        else:
            out = _bridge(C.allgather, [t], t.dtype)

        def grad(dy):
            # sum the gathered gradient across ranks, then take this rank's
            # slice (reference HorovodAllgatherGrad, mpi_ops.py:118-139)
            summed = _allreduce_raw(dy, Sum, None)
            dim0 = tf.shape(summed)[0] // n
            return summed[basics.rank() * dim0:(basics.rank() + 1) * dim0]

        return out, grad

    return _fn(tensor)


def broadcast(tensor, root_rank: int = 0, *, name=None):
    """Broadcast `tensor` from `root_rank` to all ranks, differentiably
    (reference ``tensorflow/mpi_ops.py:169-201``; grad allreduces and
    zeroes on non-root ranks, ``:174-189``)."""
    require_tf()

    @tf.custom_gradient
    def _fn(t):
        if _single_process_graph():
            out = tf.identity(t)
        else:
            out = _bridge(lambda a: C.broadcast(a, root_rank),
                          [t], t.dtype, t.shape)

        def grad(dy):
            g = _allreduce_raw(dy, Sum, None)
            if basics.rank() != root_rank:
                g = tf.zeros_like(g)
            return g

        return out, grad

    return _fn(tensor)


def alltoall(tensor, *, name=None):
    """Even all-to-all scatter/gather over dimension 0."""
    require_tf()
    return _bridge(C.alltoall, [tensor], tensor.dtype)


def join() -> int:
    """Uneven-data join (reference ``torch/mpi_ops.py:511-524``; TF
    gained join upstream post-0.19)."""
    return C.join()
