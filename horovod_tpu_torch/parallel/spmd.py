"""The per-axis primitives the parallel strategies are written in.

The JAX package writes tensor, sequence, pipeline and expert parallelism
as per-device functions inside ``shard_map``, reduced and exchanged by
``lax.psum``/``pmean``/``ppermute``/``all_to_all`` over a named mesh
axis. The port runs the same function on each rank, and these are those
primitives over the axis's sub-group of the process's mesh
(:func:`horovod_tpu_torch.parallel.mesh.build_mesh`). Each is an
``autograd.Function`` whose backward is JAX's transpose rule:

- :func:`psum`'s backward is a ``psum`` of the cotangent (not the
  identity): every rank differentiates its own copy of the reduced
  value, as under JAX's per-device semantics, so the gradient
  normalisations the JAX package's steps apply carry over unchanged;
- :func:`ppermute`'s backward is the inverse permutation;
- :func:`all_to_all`'s (tiled) backward is the inverse exchange.

``ppermute`` makes one ``dist.batch_isend_irecv`` of every send and
receive of the rank (separate blocking sends and receives deadlock
NCCL and gloo alike). Over an axis of size 1 every primitive is the
identity and makes no call. None runs while the native core is attached
(:func:`~horovod_tpu_torch.parallel.mesh.axis_collectives`). The
collectives are reached through
``dist.<name>`` at call time, so a wrapper of ``torch.distributed``'s
functions sees them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel.mesh import axis_collectives, current_mesh


def axis_index(axis_name: str) -> int:
    """This rank's index along ``axis_name`` (``lax.axis_index``)."""
    return current_mesh().axis_index(axis_name)


def axis_size(axis_name: str) -> int:
    """The size of ``axis_name`` (``lax.psum(1, axis_name)``)."""
    return current_mesh().axis_size(axis_name)


def _size(axis_name: str) -> int:
    """The axis's size, for a primitive over it (refused with the native
    core attached)."""
    return axis_collectives(axis_name).axis_size(axis_name)


def _all_reduce(x, axis_name: str):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=current_mesh().group(axis_name))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _all_reduce(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis_name), None


def psum(x, axis_name: str):
    """Sum ``x`` over ``axis_name``; the backward sums the cotangent."""
    if _size(axis_name) == 1:
        return x
    return _Psum.apply(x, axis_name)


def pmean(x, axis_name: str):
    """``psum(x) / axis size``, as ``lax.pmean``."""
    n = _size(axis_name)
    return x if n == 1 else psum(x, axis_name) / n


def _perm_peers(perm, n: int, me: int) -> Tuple[list, list]:
    """The axis indices this rank sends to and receives from."""
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"ppermute pair {(s, d)} outside an axis of "
                             f"size {n}")
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute needs a permutation, got {perm}")
    return [d for s, d in perm if s == me], [s for s, d in perm if d == me]


def exchange(tensors: Sequence[torch.Tensor], axis_name: str, perm):
    """Move each of ``tensors`` along ``perm`` (``(source, destination)``
    pairs of axis indices) in ONE ``dist.batch_isend_irecv``: rank i's
    tensors go to the rank its pair names; a rank that no pair sends to
    gets zeros. Not differentiable (the ring passes' own backwards use
    it); :func:`ppermute` is."""
    mesh = axis_collectives(axis_name)
    n, me = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    to, frm = _perm_peers(perm, n, me)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.zeros_like(t) for t in tensors]
    ranks, group = mesh.ranks(axis_name), mesh.group(axis_name)
    ops = []
    for d in to:
        if d == me:
            continue
        for t in tensors:
            ops.append(dist.P2POp(dist.isend, t, ranks[d], group))
    for s in frm:
        if s == me:
            for o, t in zip(outs, tensors):
                o.copy_(t)
            continue
        for o in outs:
            ops.append(dist.P2POp(dist.irecv, o, ranks[s], group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return outs


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm):
        ctx.axis_name, ctx.perm = axis_name, perm
        return exchange([x], axis_name, perm)[0]

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return exchange([g], ctx.axis_name, inv)[0], None, None


def ppermute(x, axis_name: str, perm):
    """``lax.ppermute``: ``perm`` lists ``(source, destination)`` axis
    indices; a rank no pair sends to gets zeros. The backward sends the
    cotangent along the inverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if _size(axis_name) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, axis_name, perm)


def _all_to_all(x, axis_name: str, split_axis: int, concat_axis: int):
    mesh = current_mesh()
    n = mesh.axis_size(axis_name)
    shape = list(x.shape)
    if shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: split axis {split_axis} of shape {tuple(shape)} "
            f"is not divisible by the '{axis_name}' axis size {n}")
    # [n, S/n, ...rest]: chunk j goes to axis index j
    chunks = x.movedim(split_axis, 0)
    chunks = chunks.reshape((n, shape[split_axis] // n)
                            + tuple(chunks.shape[1:])).contiguous()
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=mesh.group(axis_name))
    # recv[j] is axis index j's chunk, x's layout with the split axis cut:
    # concatenate them along concat_axis, the source outermost
    parts = recv.movedim(1, split_axis + 1)
    parts = parts.movedim(0, concat_axis)
    out_shape = list(parts.shape)
    out_shape[concat_axis:concat_axis + 2] = [n * out_shape[concat_axis + 1]]
    return parts.reshape(out_shape).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis):
        ctx.args = (axis_name, split_axis, concat_axis)
        return _all_to_all(x, axis_name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, axis_name, concat_axis, split_axis),
                None, None, None)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = True):
    """``lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``: ``x`` cut into axis-size chunks along ``split_axis``,
    chunk j sent to axis index j, the received chunks concatenated along
    ``concat_axis`` in source order. The backward is the inverse exchange
    (``split_axis`` and ``concat_axis`` swapped). The result is
    contiguous."""
    if not tiled:
        raise NotImplementedError("all_to_all supports tiled=True only")
    nd = x.dim()
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    if _size(axis_name) == 1:
        return x
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis)
