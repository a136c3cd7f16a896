"""MXNet frontend: ``import horovod_tpu_torch.mxnet as hvd``.

Counterpart of ``horovod_tpu/mxnet/__init__.py`` (reference
``horovod/mxnet/__init__.py`` + ``mxnet/mpi_ops.py``, 0.19.2): a ``DistributedOptimizer`` that allreduces gradients inside
``update()``/``update_multi_precision()``, a gluon ``DistributedTrainer``
whose ``_allreduce_grads`` replaces kvstore push/pull, and
``broadcast_parameters`` with deferred-initialization hooks.

Apache MXNet is retired upstream, so everything here is duck-typed
against the small mxnet surface it touches (optimizer
``update``/``rescale_grad``, trainer ``_params``/``_scale``, parameter
``list_grad``/``grad_req``) and the collective bridge accepts any
NDArray-like (:mod:`horovod_tpu_torch.mxnet.mpi_ops`: the values cross to
this process's device and through the port's collectives). With mxnet
installed the gluon ``DistributedTrainer`` subclass is created
dynamically; without it the same logic is importable and runs through
fakes, as in the JAX package.
"""

from __future__ import annotations

import types
import warnings

from horovod_tpu_torch.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, is_homogeneous, mpi_threads_supported,
    mpi_enabled, gloo_enabled,
    nccl_built, mpi_built, gloo_built, ccl_built, ddl_built, xla_built,
)
from horovod_tpu_torch.mxnet.mpi_ops import (  # noqa: F401
    Adasum, Average, ReduceOp, Sum,
    allgather, allreduce, allreduce_, broadcast, broadcast_,
)

try:  # the gluon trainer is gated on an mxnet install
    import mxnet as mx

    _HAVE_MXNET = True
except ImportError:
    mx = None
    _HAVE_MXNET = False


class DistributedOptimizer:
    """Optimizer wrapper allreducing gradients in ``update()`` (reference
    ``horovod/mxnet/__init__.py:40-78``): ``rescale_grad`` is divided by
    ``size()`` so the summed allreduce averages — cheaper than dividing the
    reduced tensor."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._optimizer.rescale_grad /= size()

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)

    def _do_allreduce(self, index, grad):
        if size() == 1:
            return
        if isinstance(index, (tuple, list)):
            for i in range(len(index)):
                allreduce_(
                    grad[i], average=False, name=str(index[i]), priority=-i
                )
        else:
            allreduce_(grad, average=False, name=str(index))

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


class _TrainerAllreduceMixin:
    """The gluon ``DistributedTrainer`` override logic, separated from the
    ``mx.gluon.Trainer`` base so it is testable without mxnet: allreduce
    (sum) every parameter's gradient; averaging rides the trainer's
    ``_scale / size()`` rescale (reference ``mxnet/__init__.py:85-112``)."""

    def _allreduce_grads(self):
        if size() == 1:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                allreduce_(
                    param.list_grad()[0], average=False,
                    name=param.name, priority=-i,
                )


def DistributedTrainer(params, optimizer, optimizer_params=None):
    """gluon Trainer whose gradient exchange is the allreduce layer instead
    of kvstore push/pull (reference ``mxnet/__init__.py:85-112``)."""
    if not _HAVE_MXNET:
        raise ImportError(
            "DistributedTrainer needs mxnet (retired upstream, not "
            "installed here). The override logic lives in "
            "_TrainerAllreduceMixin and runs through fakes."
        )
    if isinstance(optimizer, DistributedOptimizer):
        optimizer = optimizer._optimizer
        warnings.warn(
            "DistributedTrainer does not take DistributedOptimizer as its "
            "optimizer. We have unwrapped it for you."
        )
    cls = type(
        "DistributedTrainer", (_TrainerAllreduceMixin, mx.gluon.Trainer), {}
    )
    trainer = cls(
        params, optimizer, optimizer_params=optimizer_params, kvstore=None
    )
    # summed allreduce + scale/size == average (reference comment)
    trainer._scale /= size()
    return trainer


def _append_broadcast_init(param, root_rank):
    """Wrap a parameter's ``_init_impl`` so deferred-initialized parameters
    broadcast right after they materialize (reference
    ``mxnet/__init__.py:115-121``)."""
    init_impl = getattr(param, "_init_impl")

    def wrapped_init_impl(self, *args, **kwargs):
        init_impl(*args, **kwargs)
        broadcast_(self.data(), root_rank=root_rank, name=self.name)

    return wrapped_init_impl


def broadcast_parameters(params, root_rank=0):
    """Broadcast parameters from `root_rank` (reference
    ``mxnet/__init__.py:124-155``). Accepts a dict of name -> NDArray-like,
    or a gluon ``ParameterDict`` (deferred initialization handled via an
    ``_init_impl`` hook)."""
    if size() == 1:
        return

    tensors, names = [], []
    if isinstance(params, dict):
        names, tensors = zip(*sorted(params.items())) if params else ((), ())
    elif _HAVE_MXNET and isinstance(
        params, mx.gluon.parameter.ParameterDict
    ):
        for name, p in sorted(params.items()):
            try:
                tensors.append(p.data())
                names.append(name)
            except mx.gluon.parameter.DeferredInitializationError:
                p._init_impl = types.MethodType(
                    _append_broadcast_init(p, root_rank), p
                )
    else:
        raise ValueError(f"invalid params of type: {type(params)}")

    for tensor, name in zip(tensors, names):
        broadcast_(tensor, root_rank, name=str(name))
