"""Flat packing of a gradient tree into exchange groups.

Counterpart of the segment layer of ``horovod_tpu/ops/overlap.py``:
:class:`Segment`, :class:`Bucket`, :func:`pack_group` and
:func:`assemble`, which the (non-bucketed) ZeRO-1 exchange uses — one
group per dtype whose segments are whole leaves. ``BucketPlan`` and the
bucketed allreduce come with a later slice.

Leaves may be non-contiguous views (the models hand the optimizer their
parameters in the JAX package's layouts, e.g. a conv kernel permuted to
HWIO): :func:`pack_group` copies each one straight into its place in the
flat buffer, so the permutation costs no copy beyond the packing's own.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch


class Segment(NamedTuple):
    """Elements ``[start, stop)`` of raveled leaf ``idx``."""

    idx: int
    start: int
    stop: int

    @property
    def size(self) -> int:
        return self.stop - self.start


class Bucket(NamedTuple):
    """One exchange group: single dtype, ordered segments, true packed
    length ``L`` and ``Lp`` padded to a multiple of the world size."""

    key: str
    dtype: str
    segs: Tuple[Segment, ...]
    L: int
    Lp: int


@torch.no_grad()
def pack_group(leaves: Sequence[torch.Tensor], bucket: Bucket) -> torch.Tensor:
    """Concatenate one bucket's segments into a new flat ``[Lp]`` buffer,
    zero-padded past ``L`` (a copy, outside autograd)."""
    ref = leaves[bucket.segs[0].idx]
    flat = torch.empty(bucket.Lp, dtype=ref.dtype, device=ref.device)
    off = 0
    for s in bucket.segs:
        leaf = leaves[s.idx]
        dst = flat[off:off + s.size]
        if s.start == 0 and s.stop == leaf.numel():
            dst.view(leaf.shape).copy_(leaf)
        else:
            dst.copy_(leaf.reshape(-1)[s.start:s.stop])
        off += s.size
    flat[bucket.L:].zero_()
    return flat


def assemble(flats: Dict[str, torch.Tensor], groups: Dict[str, Bucket],
             shapes: Sequence[Tuple[int, ...]], dtypes: Sequence) -> list:
    """Leaves back from per-bucket flat buffers (length >= ``L``). A leaf
    in one segment is a view of its buffer; a leaf split across segments
    is stitched in element order; a leaf no bucket covers comes back as
    zeros. The views come from one ``torch.split`` per bucket, so under
    autograd (the ZeRO-3 gather) the leaves' gradients are concatenated
    into the buffer's once, not each padded to its full length and
    summed."""
    pieces: dict = {}
    for key, b in groups.items():
        sizes = [s.size for s in b.segs]
        parts = torch.split(flats[key][:sum(sizes)], sizes)
        for s, part in zip(b.segs, parts):
            pieces.setdefault(s.idx, []).append((s.start, part))
    out = []
    for i, shape in enumerate(shapes):
        ps = sorted(pieces.get(i, ()), key=lambda t: t[0])
        if not ps:
            out.append(torch.zeros(shape, dtype=dtypes[i]))
            continue
        flat = ps[0][1] if len(ps) == 1 else torch.cat([p for _, p in ps])
        out.append(flat.view(shape))
    return out
