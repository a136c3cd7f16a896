"""Functional collective ops on ``torch.Tensor`` values (counterpart of
``horovod_tpu/torch/mpi_ops.py``, reference ``horovod/torch/mpi_ops.py``).

Every op runs on the port's collectives (:mod:`horovod_tpu_torch.ops.
collective`) over the tensor's own device: NCCL for CUDA tensors, gloo
on the CPU; no CUDA tensor is staged through the host. (A CPU tensor in
a world that runs on the card is carried to the card and back.) Sync,
async (handle-based) and in-place spellings mirror the reference;
``allreduce``/``allgather``/``broadcast`` of a tensor that requires grad
are differentiable (reference ``torch/mpi_ops.py:162-240``). With the
native core attached every op, named or not, sync or async, goes through
the core (an unnamed one under a generated name), so only the core's
thread issues collectives, as the reference's ops all go through its one
background thread (``torch/mpi_ops.py:182-263``).
"""

from __future__ import annotations

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops.collective import Adasum, Average, ReduceOp, Sum
from horovod_tpu_torch.torch.compression import Compression

__all__ = [
    "Average", "Sum", "Adasum", "ReduceOp",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_",
    "allgather", "allgather_async",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async",
    "synchronize", "poll", "join",
]


def _dev(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the process group's device (a CPU tensor in a world on
    the card goes to the card)."""
    dev = basics.device()
    return t if t.device.type == dev.type else t.to(dev)


def _like(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out if out.device == like.device else out.to(like.device)


class TorchHandle:
    """Async handle (reference ``torch/handle_manager.{h,cc}`` +
    ``torch/mpi_ops.py:475-524``) over a port handle (a direct op's
    :class:`~horovod_tpu_torch.ops.collective.Handle` or the native
    core's :class:`~horovod_tpu_torch.core.CoreHandle`). ``wait`` applies
    ``post`` and, for an in-place op, copies the result into ``output``."""

    __slots__ = ("_inner", "_like", "_output", "_post", "_result")

    def __init__(self, inner, like, output=None, post=None):
        self._inner = inner
        self._like = like
        self._output = output
        self._post = post
        self._result = None

    def done(self) -> bool:
        return self._result is not None or self._inner.done()

    def wait(self) -> torch.Tensor:
        if self._result is not None:
            return self._result
        t = _like(self._inner.wait(), self._like)
        if self._post is not None:
            t = self._post(t)
        if self._output is not None:
            with torch.no_grad():
                self._output.copy_(t)
            t = self._output
        self._result = t
        return t


def synchronize(handle: TorchHandle) -> torch.Tensor:
    """Block until ``handle`` completes and return its output (reference
    ``torch/mpi_ops.py:491-508``)."""
    return handle.wait()


def poll(handle: TorchHandle) -> bool:
    """Nonblocking completion check (reference ``torch/mpi_ops.py:475-489``)."""
    return handle.done()


def join() -> int:
    """Uneven-data join (reference ``torch/mpi_ops.py:511-524``)."""
    return C.join()


# --------------------------------------------------------------------- sync


def _allreduce(tensor, op):
    return _like(C.allreduce(_dev(tensor), op), tensor)


class _AllreduceFn(torch.autograd.Function):
    """Differentiable allreduce: the gradient of an allreduce is the same
    allreduce of the upstream gradient (reference ``torch/mpi_ops.py:162-174``
    ``HorovodAllreduce``)."""

    @staticmethod
    def forward(ctx, tensor, op):
        ctx.op = op
        return _allreduce(tensor, op)

    @staticmethod
    def backward(ctx, grad_output):
        return _allreduce(grad_output, ctx.op), None


def allreduce(tensor, average=None, name=None, compression=Compression.none,
              op=None):
    """Averaged (or summed, or Adasum-combined) tensor across ranks
    (reference ``torch/mpi_ops.py:182-240``). Differentiable."""
    op = C.handle_average_backwards_compatibility(op, average)
    compressed, ctx = compression.compress(tensor)
    if compressed.requires_grad:
        out = _AllreduceFn.apply(compressed, op)
    else:
        out = _allreduce(compressed, op)
    return compression.decompress(out, ctx)


def allreduce_(tensor, average=None, name=None, op=None):
    """In-place allreduce (reference ``torch/mpi_ops.py:243-263``)."""
    op = C.handle_average_backwards_compatibility(op, average)
    out = _allreduce(tensor, op)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def grouped_allreduce(tensors, average=None, name=None, op=None):
    """One fused collective over a list of tensors (reference grouped
    path; fusion semantics ``controller.cc:640-761``)."""
    op = C.handle_average_backwards_compatibility(op, average)
    outs = C.grouped_allreduce([_dev(t) for t in tensors], op)
    return [_like(o, t) for o, t in zip(outs, tensors)]


def grouped_allreduce_(tensors, average=None, name=None, op=None):
    outs = grouped_allreduce(tensors, average=average, name=name, op=op)
    with torch.no_grad():
        for t, o in zip(tensors, outs):
            t.copy_(o)
    return tensors


def _allgather(tensor):
    return _like(C.allgather(_dev(tensor)), tensor)


class _AllgatherFn(torch.autograd.Function):
    """Differentiable allgather: the backward sums the upstream gradient
    across ranks and takes this rank's rows (reference
    ``torch/mpi_ops.py:299-312`` ``HorovodAllgather``)."""

    @staticmethod
    def forward(ctx, tensor):
        ctx.dim0 = tensor.shape[0]
        return _allgather(tensor)

    @staticmethod
    def backward(ctx, grad_output):
        summed = _allreduce(grad_output, Sum)
        r = basics.rank()
        return summed[r * ctx.dim0:(r + 1) * ctx.dim0]


def allgather(tensor, name=None):
    """Every rank's tensor concatenated along dim 0 (reference
    ``torch/mpi_ops.py:271-297``). Differentiable."""
    if tensor.requires_grad:
        return _AllgatherFn.apply(tensor)
    return _allgather(tensor)


def _broadcast(tensor, root_rank):
    return _like(C.broadcast(_dev(tensor), root_rank), tensor)


class _BroadcastFn(torch.autograd.Function):
    """Differentiable broadcast: the backward sums the gradient to the
    root; the other ranks get zero (reference ``torch/mpi_ops.py:357-371``
    ``HorovodBroadcast``)."""

    @staticmethod
    def forward(ctx, tensor, root_rank):
        ctx.root_rank = root_rank
        return _broadcast(tensor, root_rank)

    @staticmethod
    def backward(ctx, grad_output):
        summed = _allreduce(grad_output, Sum)
        if basics.rank() != ctx.root_rank:
            summed = torch.zeros_like(summed)
        return summed, None


def broadcast(tensor, root_rank, name=None):
    """``root_rank``'s tensor on every rank (reference
    ``torch/mpi_ops.py:329-355``). Differentiable."""
    if tensor.requires_grad:
        return _BroadcastFn.apply(tensor, root_rank)
    return _broadcast(tensor, root_rank)


def broadcast_(tensor, root_rank, name=None):
    """In-place broadcast (reference ``torch/mpi_ops.py:374-394``)."""
    out = _broadcast(tensor, root_rank)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def alltoall(tensor, name=None):
    """Send dim-0 row block j to rank j, receive every rank's block for
    this rank (the reference gained alltoall in 0.20)."""
    return _like(C.alltoall(_dev(tensor)), tensor)


def reducescatter(tensor, average=None, name=None, op=None):
    """Reduce across ranks and give rank r the r-th dim-0 block (the
    reference gained reducescatter in 0.27)."""
    op = C.handle_average_backwards_compatibility(op, average)
    return _like(C.reducescatter(_dev(tensor), op), tensor)


# -------------------------------------------------------------------- async


def allreduce_async(tensor, average=None, name=None, op=None):
    """Handle-returning allreduce (reference ``torch/mpi_ops.py:94-129``)."""
    op = C.handle_average_backwards_compatibility(op, average)
    return TorchHandle(C.allreduce_async(_dev(tensor), op, name=name), tensor)


def allreduce_async_(tensor, average=None, name=None, op=None):
    """In-place async allreduce: on ``synchronize`` the result is copied
    into ``tensor`` (reference ``torch/mpi_ops.py:243-268``)."""
    op = C.handle_average_backwards_compatibility(op, average)
    return TorchHandle(C.allreduce_async(_dev(tensor), op, name=name),
                       tensor, output=tensor)


def allgather_async(tensor, name=None):
    return TorchHandle(C.allgather_async(_dev(tensor), name=name), tensor)


def broadcast_async(tensor, root_rank, name=None):
    return TorchHandle(C.broadcast_async(_dev(tensor), root_rank, name=name),
                       tensor)


def broadcast_async_(tensor, root_rank, name=None):
    return TorchHandle(C.broadcast_async(_dev(tensor), root_rank, name=name),
                       tensor, output=tensor)


def alltoall_async(tensor, name=None):
    return TorchHandle(C.alltoall_async(_dev(tensor), name=name), tensor)


def reducescatter_async(tensor, average=None, name=None, op=None):
    op = C.handle_average_backwards_compatibility(op, average)
    return TorchHandle(C.reducescatter_async(_dev(tensor), op, name=name),
                       tensor)
