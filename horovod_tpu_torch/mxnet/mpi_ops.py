"""MXNet collective ops (counterpart of ``horovod_tpu/mxnet/mpi_ops.py``;
reference ``horovod/mxnet/mpi_ops.py:60-242``).

The reference pushes async engine ops through ``horovod_mxnet_*_async`` C
entry points; here an NDArray-like tensor becomes a torch tensor on this
process's device (:func:`horovod_tpu_torch.basics.device`:
``cuda:<local_rank>`` unless the process asked for the CPU), goes through
the port's collective (:mod:`horovod_tpu_torch.ops.collective`) and comes
back as the input's kind. Tensors are duck-typed: anything with
``.asnumpy()`` (an mxnet NDArray) or convertible by ``np.asarray`` works,
and the in-place variants write back with ``tensor[:] = ...``, so the
logic runs without an mxnet install (Apache MXNet is retired upstream).

``name`` and ``priority`` are accepted for API parity (the reference
maps priority to ``FnProperty::kCPUPrioritized`` in its engine,
``mxnet/mpi_ops.cc:67-110``).
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, mpi_threads_supported,
    nccl_built, mpi_built, gloo_built, ccl_built, ddl_built, xla_built,
)
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.collective import (  # noqa: F401
    Adasum, Average, ReduceOp, Sum,
)


def _to_torch(tensor) -> torch.Tensor:
    """``tensor``'s values as a torch tensor on this process's device."""
    host = tensor.asnumpy() if hasattr(tensor, "asnumpy") \
        else np.asarray(tensor)
    return torch.from_numpy(np.ascontiguousarray(host)).to(basics.device())


def _wrap_like(tensor, out: torch.Tensor):
    """``out`` as the same kind of array as ``tensor``."""
    out_np = out.cpu().numpy()
    if hasattr(tensor, "asnumpy"):  # mxnet NDArray
        import mxnet as mx

        return mx.nd.array(out_np, ctx=tensor.context, dtype=out_np.dtype)
    return out_np


def _op(average: bool):
    return C.Average if average else C.Sum


def allreduce(tensor, average=True, name=None, priority=0):
    """Allreduce returning a new tensor (reference ``mpi_ops.py:60-91``)."""
    return _wrap_like(tensor, C.allreduce(_to_torch(tensor), _op(average)))


def allreduce_(tensor, average=True, name=None, priority=0):
    """In-place allreduce (reference ``mpi_ops.py:94-129``)."""
    tensor[:] = C.allreduce(_to_torch(tensor), _op(average)).cpu().numpy()
    return tensor


def allgather(tensor, name=None, priority=0):
    """Concatenate per-rank tensors along dim 0 (reference
    ``mpi_ops.py:132-170``)."""
    return _wrap_like(tensor, C.allgather(_to_torch(tensor)))


def broadcast(tensor, root_rank, name=None, priority=0):
    """Broadcast returning a new tensor (reference ``mpi_ops.py:173-207``)."""
    return _wrap_like(tensor, C.broadcast(_to_torch(tensor), root_rank))


def broadcast_(tensor, root_rank, name=None, priority=0):
    """In-place broadcast (reference ``mpi_ops.py:210-242``)."""
    tensor[:] = C.broadcast(_to_torch(tensor), root_rank).cpu().numpy()
    return tensor
