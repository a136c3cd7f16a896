"""Adasum reduction (reference ``horovod/common/ops/adasum/adasum.h``).

Counterpart of ``horovod_tpu/ops/adasum.py`` in its per-rank form: every
process passes its own tensor. At level ``l`` of the butterfly each rank
pairs with ``rank ^ 2^l``; the pair swap their whole tensors (point to
point, ``dist.batch_isend_irecv``) and both compute the same combine
``a' = (1 - a·b/(2|a|²)) a + (1 - a·b/(2|b|²)) b``, with ``a`` the lower
rank's tensor, so the pair end bit-identical. As in the reference there
is no vector halving: log2(N) levels, each one exchange of the full
tensor and one combine.

- :func:`adasum_allreduce` — one tensor, the ``adasum_pair_combine``
  kernel per level;
- :func:`grouped_adasum_allreduce` — a group of tensors flattened into
  one f32 buffer: one exchange and one ``adasum_segment_combine`` kernel
  per level, each tensor still combined with its own scalars;
- :func:`_compressed_adasum` — ``DistributedOptimizer(op=Adasum,
  compression=...)``'s tree: the wire tensors packed into one buffer of
  their (16-bit) type, one exchange and one ``adasum_pair_combine`` over
  the leaf table per level, each leaf bit-equal to its own
  ``allreduce(g, Adasum, compression=...)``.

Power-of-two worlds only, as in the reference
(``torch/mpi_ops.py:117-118``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import kernels as _k


def _world() -> int:
    basics._require_init()
    n = basics.size()
    if not basics.num_rank_is_power_2(n):
        raise ValueError(
            f"Adasum requires a power-of-2 number of ranks, got {n} "
            "(reference horovod/torch/mpi_ops.py:117-118)")
    return n


def _pair_combine(a, b):
    """One Adasum pairwise combine (reference ``adasum.h:271-337``:
    ComputeDotAndNormSqrds + ScaledAdd), the ``adasum_pair_combine``
    kernel."""
    return _k.adasum_pair_combine(a, b)


def _segment_combine(a, b, offsets):
    """The pairwise combine of every tensor of a flat f32 group buffer,
    tensor ``i`` being ``[offsets[i], offsets[i+1])``, in one pass: the
    ``adasum_segment_combine`` kernel."""
    return _k.adasum_segment_combine(a, b, offsets)


def _exchange(v, peer: int):
    """Send ``v`` to ``peer`` and receive its tensor of the same shape."""
    got = torch.empty_like(v)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, v, peer),
                                   dist.P2POp(dist.irecv, got, peer)])
    for r in reqs:
        r.wait()
    return got


def _adasum_butterfly(v, combine=None):
    """log2(N) levels: at level ``l`` exchange with ``rank ^ 2^l`` and
    ``combine(lower rank's tensor, upper rank's tensor)`` (default
    :func:`_pair_combine`)."""
    combine = combine or _pair_combine
    rank, n = basics.rank(), basics.size()
    level = 1
    while level < n:
        partner = _exchange(v, rank ^ level)
        lower = (rank & level) == 0
        v = combine(v, partner) if lower else combine(partner, v)
        level *= 2
    return v


def adasum_allreduce(tensor):
    """Adasum of every rank's ``tensor`` (same shape and type on every
    rank): a new tensor, the identity at a world of one."""
    n = _world()
    v = tensor.contiguous()
    if n == 1:
        return v.clone() if v is tensor else v
    return _adasum_butterfly(v)


def _grouped_butterfly(flat, offsets):
    """The butterfly over a whole flat group buffer: one exchange and one
    :func:`_segment_combine` per level."""
    return _adasum_butterfly(flat, lambda a, b: _segment_combine(a, b, offsets))


def _flatten_group(tensors):
    """``(flat f32 [L], offsets)``: the tensors raveled into one f32
    buffer (the combine runs in f32 whatever their type), tensor ``i`` at
    ``[offsets[i], offsets[i+1])``."""
    offsets = [0]
    for t in tensors:
        offsets.append(offsets[-1] + t.numel())
    flat = torch.empty(offsets[-1], dtype=torch.float32,
                       device=tensors[0].device)
    for t, lo, hi in zip(tensors, offsets, offsets[1:]):
        flat[lo:hi].view(t.shape).copy_(t)
    return flat, tuple(offsets)


def _split_group(flat, offsets, shapes, dtypes):
    return [flat[lo:hi].view(shape).to(dtype)
            for lo, hi, shape, dtype in zip(offsets, offsets[1:], shapes,
                                            dtypes)]


def grouped_adasum_allreduce(tensors):
    """Adasum of a group of tensors with one exchange and one combine
    kernel per level for the whole group (reference ``adasum.h:194-398``
    fuses the same way over its fusion buffer); each tensor keeps its own
    ``a·b``, ``|a|²``, ``|b|²``. Returns new tensors in the inputs' shapes
    and types."""
    n = _world()
    tensors = list(tensors)
    if not tensors:
        return []
    flat, offsets = _flatten_group(tensors)
    if n > 1:
        flat = _grouped_butterfly(flat, offsets)
    return _split_group(flat, offsets, [t.shape for t in tensors],
                        [t.dtype for t in tensors])


#: each leaf of a packed buffer starts on this many bytes: the combine's
#: vector width
LEAF_ALIGN_BYTES = 16


@functools.lru_cache(maxsize=16)
def _leaf_table(sizes: tuple, itemsize: int) -> tuple:
    """The layout of leaves of ``sizes`` packed into one flat buffer of a
    type of ``itemsize`` bytes: leaf ``i`` at ``starts[i]``, a multiple of
    :data:`LEAF_ALIGN_BYTES`, then zeros up to the next leaf. The
    combine's segments ``offsets`` are each leaf, then its pad (maybe
    empty), so a leaf is combined with its own scalars over exactly its
    elements, its chunks cut from its first element. Returns ``(starts,
    offsets)``; ``offsets[-1]`` is the buffer's length."""
    step = LEAF_ALIGN_BYTES // itemsize
    offsets = [0]
    for s in sizes:
        offsets += [offsets[-1] + s, offsets[-1] + s + (-s) % step]
    return tuple(offsets[:-1:2]), tuple(offsets)


def _pack(leaves, offsets):
    """``leaves`` (one type) raveled into one flat buffer at
    :func:`_leaf_table`'s ``offsets``, the pads zero: one ``torch.cat``."""
    zeros = leaves[0].new_zeros(LEAF_ALIGN_BYTES)
    parts = []
    for leaf, end, nxt in zip(leaves, offsets[1::2], offsets[2::2]):
        parts += [leaf.reshape(-1), zeros[:nxt - end]]
    return torch.cat(parts)


def _compressed_adasum(tensors, compression):
    """Adasum of every tensor with ``compression`` on the wire, each
    bit-equal to its own ``allreduce(t, Adasum, compression=compression)``:
    every tensor is compressed, the wire tensors of each type are packed
    into one flat buffer (:func:`_leaf_table`, :func:`_pack`), and the
    butterfly runs once over the buffer. Per level that is one exchange
    and one ``adasum_pair_combine`` over the leaf table in the wire type,
    narrowed to it after the level as each tensor's own combine narrows
    it; the pads are zero and segments of their own, so they change no
    sum. Returns the decompressed tensors."""
    _world()
    wires = [compression.compress(t) for t in tensors]
    outs = [w for w, _ in wires]
    by_type: dict = {}
    for i, (w, _) in enumerate(wires):
        by_type.setdefault(w.dtype, []).append(i)
    for idxs in by_type.values():
        leaves = [outs[i] for i in idxs]
        starts, offsets = _leaf_table(tuple(l.numel() for l in leaves),
                                      leaves[0].element_size())
        flat = _adasum_butterfly(
            _pack(leaves, offsets),
            lambda a, b: _k.adasum_pair_combine_packed(a, b, offsets))
        for i, lo, leaf in zip(idxs, starts, leaves):
            outs[i] = flat[lo:lo + leaf.numel()].view(leaf.shape)
    return [compression.decompress(o, ctx) for o, (_, ctx) in zip(outs, wires)]
