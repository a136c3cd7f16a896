"""Two-level (hierarchical) collectives over the host mesh's LOCAL and
CROSS sub-groups.

Counterpart of ``horovod_tpu/ops/hierarchical.py``. The reference's
NCCL-hierarchical allreduce splits the job along the host boundary:
reduce-scatter inside the host, allreduce across hosts on the 1/L piece,
all-gather back inside the host (``common/ops/nccl_operations.cc:
162-354``), with a matching toggle pair for allgather
(``HOROVOD_HIERARCHICAL_ALLREDUCE`` / ``_ALLGATHER``). The JAX package
writes the decomposition over the ``cross``/``local`` axes of its mesh;
the port runs it per rank over the sub-groups of
:func:`horovod_tpu_torch.parallel.mesh.build_host_mesh`:

- :func:`hier_allreduce` — LOCAL ``reduce_scatter`` of the zero-padded
  flat tensor (full width), the piece reduced over CROSS (plain
  ``all_reduce``; a quantized compressor's int8 exchange, the one
  :func:`~horovod_tpu_torch.ops.collective._grouped_quant_allreduce`
  runs on the world, here on CROSS; an elementwise compressor around the
  ``all_reduce``), LOCAL ``all_gather``, the pad cut;
- :func:`hier_allgather` — gathered inside LOCAL, then across CROSS:
  the flat gather's rank order (global rank = cross·L + local);
- :func:`hierarchical_allreduce` / :func:`hierarchical_allgather` — the
  eager entry points (Average divides by cross·local);
- :func:`grouped_hier_allreduce` — :func:`hier_allreduce` of a list of
  tensors in a number of collectives that does not depend on how many
  there are (the distributed optimizer's allreduce mode on an axis
  pair), each result its own (bit-equal with two ranks a host);
- the toggles :func:`set_hierarchical`, :func:`set_hierarchical_allgather`,
  :func:`enabled`, :func:`allgather_enabled` (re-read at every call, so
  the native core's tuned broadcast lands mid-run).

The collectives run on the calling thread (the native core carries no
sub-groups).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel.mesh import CROSS_AXIS, LOCAL_AXIS

_forced: Optional[bool] = None
_forced_allgather: Optional[bool] = None


def set_hierarchical(on: Optional[bool]) -> None:
    """Force the hierarchical allreduce strategy on/off (``None`` = env)."""
    global _forced
    _forced = on


def set_hierarchical_allgather(on: Optional[bool]) -> None:
    """Force the hierarchical allgather strategy on/off (``None`` = env)."""
    global _forced_allgather
    _forced_allgather = on


def _env_on(var: str) -> bool:
    return os.environ.get(var, "0").lower() in ("1", "true", "yes", "on")


def enabled() -> bool:
    """Do ``(cross, local)``-pair allreduces decompose hierarchically?
    :func:`set_hierarchical` wins, else ``HOROVOD_HIERARCHICAL_ALLREDUCE``
    (default off: the flat route over the world). Read at every call."""
    if _forced is not None:
        return _forced
    return _env_on("HOROVOD_HIERARCHICAL_ALLREDUCE")


def allgather_enabled() -> bool:
    """The pair allgather's toggle (``HOROVOD_HIERARCHICAL_ALLGATHER``)."""
    if _forced_allgather is not None:
        return _forced_allgather
    return _env_on("HOROVOD_HIERARCHICAL_ALLGATHER")


def check_pair(axis) -> None:
    """Raise unless ``axis`` is ``(CROSS_AXIS, LOCAL_AXIS)``: naming one of
    the two alone (the pair's half-sharded case: a sum over one of them
    is not the world's) and any other axis."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    pair = (CROSS_AXIS, LOCAL_AXIS)
    if names == pair:
        return
    if len(names) < 2 and set(names) <= set(pair):
        raise ValueError(
            "hierarchical collective: the axis names only one of "
            f"({CROSS_AXIS!r}, {LOCAL_AXIS!r}); reduce over BOTH "
            f"(axis=({CROSS_AXIS!r}, {LOCAL_AXIS!r})) or over the world "
            "(axis=None)")
    raise ValueError(
        f"axis={axis!r}: the port's collectives run on the world's process "
        f"group (axis=None) or on the host mesh's ({CROSS_AXIS!r}, "
        f"{LOCAL_AXIS!r}) pair; there are no other mesh axes to name")


def pair_of(axis):
    """The host mesh for ``axis`` (:func:`check_pair`); a pair without a
    host mesh raises with the JAX package's message."""
    from horovod_tpu_torch.parallel.mesh import host_mesh

    check_pair(axis)
    mesh = host_mesh()
    if mesh is None:
        raise ValueError(
            f"mesh ('data',) has no '{CROSS_AXIS}' axis; build it with "
            f"build_host_mesh() or axes={{'{CROSS_AXIS}': H, "
            f"'{LOCAL_AXIS}': L}}")
    return mesh


def _mesh():
    return pair_of((CROSS_AXIS, LOCAL_AXIS))


def _local_reduce_scatter(flat, mesh):
    """This rank's SUM piece ``[Lp / L]`` of a flat ``[Lp]`` over LOCAL."""
    from horovod_tpu_torch.ops import collective as C

    out = torch.empty(flat.shape[0] // mesh.local, dtype=flat.dtype,
                      device=flat.device)
    with C.on_group(mesh.local_group):
        C._reduce_scatter_single(out, flat.contiguous(), op=dist.ReduceOp.SUM)
    return out


def _gather(piece, group):
    from horovod_tpu_torch.ops import collective as C

    with C.on_group(group):
        return C._all_gather_flat(piece)


def _cross_sum(pieces, mesh, compression=None):
    """Each of ``pieces`` summed over CROSS: the quantizable ones (a
    quantized ``compression``) through one int8 exchange, the others
    through one flat ``all_reduce`` a dtype."""
    from horovod_tpu_torch.ops import collective as C

    quantized = getattr(compression, "quantized", False)
    with C.on_group(mesh.cross_group):
        if quantized:
            return C._grouped_quant_allreduce(
                pieces, op=C.Sum, block=int(compression.block))[0]
        return C._grouped_flat_allreduce(pieces, C.Sum)


def hier_allreduce(v, *, compression=None):
    """Two-level SUM allreduce of this rank's ``v``: LOCAL reduce-scatter
    (``v`` zero-padded to a multiple of L), the piece reduced over CROSS,
    LOCAL all-gather. ``compression`` compresses only the cross hop: a
    quantized one (``Compression.int8``) runs the int8 exchange on the
    piece (int8 + bf16 scales across hosts, f32 sums); an elementwise
    one casts the piece around the cross ``all_reduce``."""
    mesh = _mesh()
    shape, size = v.shape, v.numel()
    flat = v.reshape(-1)
    pad = (-size) % mesh.local
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    piece = _local_reduce_scatter(flat, mesh)
    if compression is None or getattr(compression, "quantized", False):
        piece = _cross_sum([piece], mesh, compression)[0]
    else:
        c, ctx = compression.compress(piece)
        piece = compression.decompress(_cross_sum([c], mesh)[0], ctx)
    out = _gather(piece, mesh.local_group)
    if pad:
        out = out[:size]
    return out.reshape(shape)


def hier_allgather(v):
    """Two-level allgather along dim 0: inside LOCAL, then across CROSS.
    Row-major mesh order makes the result the flat gather's."""
    mesh = _mesh()
    if v.dim() == 0:
        raise ValueError("allgather needs a tensor with a leading dimension")
    g = _gather(v.contiguous(), mesh.local_group)
    return _gather(g, mesh.cross_group)


def grouped_hier_allreduce(tensors, *, compression=None) -> list:
    """:func:`hier_allreduce` of each tensor (SUM), the tensors of a dtype
    laid out as one ``[L, S]`` buffer (tensor ``i`` zero-padded to
    ``L * cols[i]`` and taking ``cols[i]`` columns of every row, so row
    ``l`` holds each tensor's ``l``-th piece): one LOCAL reduce-scatter,
    the pieces over CROSS (:func:`_cross_sum`: a quantized
    ``compression`` takes the pieces of the tensors of at least
    ``min_quant_elems`` elements), one LOCAL all-gather a dtype. Every
    result is bit-equal to its own :func:`hier_allreduce` where a LOCAL
    sum's order does not depend on the element's place in the buffer
    (two ranks a host); a larger host's ring may order it by place."""
    from horovod_tpu_torch.ops import collective as C

    mesh = _mesh()
    L = mesh.local
    quantized = getattr(compression, "quantized", False)
    tensors = list(tensors)
    outs = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idxs in groups.values():
        leaves = [tensors[i] for i in idxs]
        sizes = tuple(t.numel() for t in leaves)
        cols = tuple((sz + (-sz) % L) // L for sz in sizes)
        buf = C._pack_quant_rows(leaves, L, cols)
        row = _local_reduce_scatter(buf.view(-1), mesh)
        pieces = list(row.split(list(cols)))
        q = [j for j, t in enumerate(leaves)
             if quantized and C._quantizes(compression, t)]
        rest = [j for j in range(len(leaves)) if j not in set(q)]
        for part, comp in ((q, compression), (rest, None)):
            if part:
                summed = _cross_sum([pieces[j] for j in part], mesh, comp)
                for j, s in zip(part, summed):
                    pieces[j] = s
        full = _gather(torch.cat(pieces), mesh.local_group).view(L, -1)
        for i, o in zip(idxs, C._unpack_quant_rows(
                full, cols, sizes, [t.shape for t in leaves])):
            outs[i] = o
    return outs


def hierarchical_allreduce(tensor, op=None):
    """Eager two-level allreduce of this rank's ``tensor`` over the host
    mesh: the reduction, averaged (divided by cross·local) unless ``op``
    is ``Sum``."""
    from horovod_tpu_torch.ops import collective as C

    mesh = pair_of((CROSS_AXIS, LOCAL_AXIS))
    out = hier_allreduce(tensor)
    if op is None or op == C.Average:
        out = C._div(out, mesh.cross * mesh.local)
    return out


def hierarchical_allgather(tensor):
    """Eager two-level allgather of this rank's ``tensor`` over the host
    mesh (dim-0 concat in global rank order)."""
    pair_of((CROSS_AXIS, LOCAL_AXIS))
    return hier_allgather(tensor)


__all__ = [
    "CROSS_AXIS", "LOCAL_AXIS", "set_hierarchical",
    "set_hierarchical_allgather", "enabled", "allgather_enabled",
    "hier_allreduce", "hier_allgather", "grouped_hier_allreduce",
    "hierarchical_allreduce", "hierarchical_allgather",
]
