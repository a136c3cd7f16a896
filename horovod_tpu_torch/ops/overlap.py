"""Bucketed gradient exchange: the packing and the plan.

Counterpart of ``horovod_tpu/ops/overlap.py``, Horovod's fusion-buffer
overlap: the gradient tree is packed flat per dtype and cut into
buckets of about ``HOROVOD_BUCKET_BYTES`` (default 64 MiB, else
``HOROVOD_FUSION_THRESHOLD``) in reverse flatten order (the last leaves'
gradients are the backward's first), and each bucket is one collective.
The plan depends only on the leaves' shapes and dtypes and the bucket
size, never on the world size (which only pads ``Lp``), and its keys
(``float32#0``, ...), segments, ``L`` and ``Lp`` are the JAX package's:
optimizer states and checkpoints are keyed by them.

- :class:`Segment`, :class:`Bucket`, :func:`pack_group`,
  :func:`assemble` — the segment layer, which the ZeRO-1 exchange also
  uses with one whole-leaf group per dtype;
- :class:`BucketPlan`, :func:`plan_for` — the plan, cached by signature;
- :func:`bucketed_allreduce` — allreduce mode's exchange, one
  ``allreduce`` per bucket (an int8 bucket is one quantize, one
  requantize and one dequantize launch), with error-feedback residuals
  keyed by bucket;
- :func:`bucket_bytes_from_env`, :func:`resolve_bucket_bytes` — the
  ``overlap=``/``bucket_bytes=`` knobs.

Launching the buckets while the backward still runs is
:func:`horovod_tpu_torch.training.make_train_step`'s part (gradient
hooks); the JAX package's schedule pins (``barrier_after``,
``sync_hook``) have no counterpart in eager PyTorch.

Leaves may be non-contiguous views (the models hand the optimizer their
parameters in the JAX package's layouts, e.g. a conv kernel permuted to
HWIO): :func:`pack_group` copies each one straight into its place in the
flat buffer, so the permutation costs no copy beyond the packing's own.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.observability import metrics as _metrics

#: the reference fusion buffer's 64 MiB
DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024
BUCKET_BYTES_ENV = "HOROVOD_BUCKET_BYTES"
OVERLAP_ENV = "HOROVOD_OVERLAP"


def _env_true(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).lower() in ("1", "true", "yes")


def bucket_bytes_from_env() -> int:
    """``HOROVOD_BUCKET_BYTES`` when set, else ``HOROVOD_FUSION_THRESHOLD``
    (the native core's bin size), else 64 MiB."""
    for name in (BUCKET_BYTES_ENV, "HOROVOD_FUSION_THRESHOLD"):
        v = os.environ.get(name)
        if v:
            return max(1, int(v))
    return DEFAULT_BUCKET_BYTES


def resolve_bucket_bytes(overlap=None, bucket_bytes: Optional[int] = None
                         ) -> Optional[int]:
    """The bucket capacity of an ``overlap=``/``bucket_bytes=`` pair, or
    ``None`` for the monolithic exchange. ``overlap=None`` reads
    ``HOROVOD_OVERLAP``; ``overlap=False`` wins over the env;
    ``bucket_bytes`` alone implies overlap."""
    if overlap is None:
        overlap = True if bucket_bytes is not None else _env_true(OVERLAP_ENV)
    if not overlap:
        return None
    if bucket_bytes is not None:
        return max(1, int(bucket_bytes))
    return bucket_bytes_from_env()


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

    @property
    def idxs(self) -> Tuple[int, ...]:
        """The leaves it holds, each once, in segment order."""
        return tuple(dict.fromkeys(s.idx for s in self.segs))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shape_dtype(leaf) -> Tuple[Tuple[int, ...], str]:
    return tuple(int(d) for d in leaf.shape), _dtype_name(leaf.dtype)


class BucketPlan:
    """The leaves of a tree cut into buckets of about ``bucket_bytes``,
    in reverse flatten order. ``groups`` maps each key to its
    :class:`Bucket`, in plan order."""

    def __init__(self, buckets: Sequence[Bucket], *, n: int,
                 bucket_bytes: int):
        self.buckets: Tuple[Bucket, ...] = tuple(buckets)
        self.n = int(n)
        self.bucket_bytes = int(bucket_bytes)
        self.groups = {b.key: b for b in self.buckets}

    def __len__(self) -> int:
        return len(self.buckets)

    def describe(self) -> str:
        return "\n".join(
            f"{b.key}: L={b.L} Lp={b.Lp} segs="
            + ",".join(f"{s.idx}[{s.start}:{s.stop}]" for s in b.segs)
            for b in self.buckets)

    @classmethod
    def build(cls, leaves: Sequence, n: int,
              bucket_bytes: Optional[int] = None) -> "BucketPlan":
        """The plan of ``leaves`` (anything with ``.shape`` and a torch
        ``.dtype``, or ``(shape, dtype name)`` pairs): leaves walked last
        to first, each dtype filling its own open bucket, a leaf split
        where a bucket fills, every segment at least one element (so a
        ``bucket_bytes`` below one itemsize still ends)."""
        bucket_bytes = int(bucket_bytes or bucket_bytes_from_env())
        n = max(1, int(n))
        infos = [l if isinstance(l, tuple) else _shape_dtype(l) for l in leaves]
        open_segs: dict = {}            # dtype -> (segs, bytes, elems)
        counters: dict = {}
        buckets: List[Bucket] = []

        def close(dt: str) -> None:
            segs, _nbytes, elems = open_segs.pop(dt)
            if not segs:
                return
            k = counters.get(dt, 0)
            counters[dt] = k + 1
            buckets.append(Bucket(key=f"{dt}#{k}", dtype=dt, segs=tuple(segs),
                                  L=elems, Lp=elems + (-elems) % n))

        for i in reversed(range(len(infos))):
            shape, dt = infos[i]
            size = math.prod(shape) if shape else 1
            if size == 0:
                continue
            itemsize = getattr(torch, dt).itemsize
            pos = 0
            while pos < size:
                segs, nbytes, elems = open_segs.setdefault(dt, ([], 0, 0))
                take = min(size - pos, max(1, (bucket_bytes - nbytes) // itemsize))
                segs.append(Segment(i, pos, pos + take))
                nbytes += take * itemsize
                open_segs[dt] = (segs, nbytes, elems + take)
                pos += take
                if nbytes >= bucket_bytes:
                    close(dt)
        for dt in list(open_segs):
            close(dt)
        return cls(buckets, n=n, bucket_bytes=bucket_bytes)


@functools.lru_cache(maxsize=256)
def _cached_plan(sig: tuple, n: int, bucket_bytes: int) -> BucketPlan:
    return BucketPlan.build(list(sig), n, bucket_bytes)


def plan_for(leaves: Sequence, n: int,
             bucket_bytes: Optional[int] = None) -> BucketPlan:
    """:meth:`BucketPlan.build`, cached by the leaves' (shape, dtype)
    signature: a step asks for it every time."""
    bucket_bytes = int(bucket_bytes or bucket_bytes_from_env())
    sig = tuple(l if isinstance(l, tuple) else _shape_dtype(l) for l in leaves)
    return _cached_plan(sig, max(1, int(n)), bucket_bytes)


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
    device = next((f.device for f in flats.values()), None)
    for key, b in groups.items():
        sizes = [s.size for s in b.segs]
        parts = torch.split(flats[key][:sum(sizes)], sizes)
        for s, part in zip(b.segs, parts):
            pieces.setdefault(s.idx, []).append((s.start, part))
    out = []
    for i, shape in enumerate(shapes):
        ps = sorted(pieces.get(i, ()), key=lambda t: t[0])
        if not ps:
            out.append(torch.zeros(shape, dtype=dtypes[i], device=device))
            continue
        flat = ps[0][1] if len(ps) == 1 else torch.cat([p for _, p in ps])
        out.append(flat.view(shape))
    return out


# --------------------------------------------------------------------------
# allreduce mode


def _check_op(op, compression):
    from horovod_tpu_torch.ops import collective as _C

    if op not in (_C.Average, _C.Sum):
        raise ValueError(
            "bucketed overlap supports op=Average/Sum (Adasum's pairwise "
            "projections are per-tensor scalars; bucket packing would mix "
            "them)")
    if getattr(compression, "factorized", False):
        raise ValueError(
            "factorized compression (PowerSGD) syncs per-leaf rank-r "
            "factors; bucket-level overlap does not apply — drop "
            "overlap= or use the int8/fp16 wire")


def _predivide(x, f: float):
    """``x / f`` as the JAX package's compiled step computes the gradient
    predivide: XLA turns a divide by the constant ``f`` into a multiply by
    its f32 reciprocal (a 16-bit ``x`` widened to f32 for it and the
    product rounded back)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    recip = torch.tensor(f, dtype=wide).reciprocal().to(x.device)
    return (x.to(wide) * recip).to(x.dtype)


def predivided_average(tensors, compression, f: float) -> list:
    """Average with the gradient predivide ``f``: each tensor times
    ``1/f`` (:func:`_predivide`), summed across ranks in one grouped
    exchange, the sums times ``f / N``."""
    from horovod_tpu_torch.ops import collective as _C

    outs = _C._grouped_allreduce([_predivide(t, f) for t in tensors], _C.Sum,
                                 compression)[0]
    return [o * torch.tensor(f / _C._n(), dtype=o.dtype, device=o.device)
            for o in outs]


def allreduce_bucket(flat, op, compression, *, predivide: float = 1.0,
                     residual=None, roundtrip=None):
    """One bucket's flat ``[L]`` buffer allreduced: with ``residual``
    (error feedback) the corrected ``flat + residual`` goes on the wire
    and ``corrected - roundtrip(corrected)`` comes back as the new
    residual. Without a predivide the residual comes from the exchange's
    own quantize pass (bit-equal to the int8 compressor's roundtrip:
    the one-leaf ``[N, S]`` layout cuts the flat vector's 256-element
    blocks). Returns ``(reduced [L], new residual or None)``."""
    from horovod_tpu_torch.ops import collective as _C

    ef = residual is not None
    if ef:
        flat = flat + residual
    if op == _C.Average and predivide != 1.0:
        res = flat - roundtrip(flat) if ef else None
        return predivided_average([flat], compression, predivide)[0], res
    outs, res = _C._grouped_allreduce([flat], op, compression, residuals=ef)
    return outs[0], (res[0] if ef else None)


def _record_buckets(mode: str, k: int) -> None:
    """The ``grad_sync_buckets{mode=}`` gauge: gradient-sync collectives
    (buckets) a step issues."""
    if not _metrics.enabled():
        return
    _metrics.gauge(
        "grad_sync_buckets",
        help="gradient-sync collectives (buckets) issued per step",
        mode=mode,
    ).set(k)


def bucketed_allreduce(grads: dict, op=None, *, compression=None,
                       bucket_bytes: Optional[int] = None,
                       plan: Optional[BucketPlan] = None,
                       predivide: float = 1.0,
                       residual: Optional[dict] = None, roundtrip=None):
    """Allreduce a flat gradient dict (keys in the JAX package's flatten
    order, :func:`~horovod_tpu_torch.optim.tree_keys`) bucket by bucket:
    one :func:`allreduce_bucket` per bucket of the plan (built at N = 1:
    the allreduce pads internally, so ``L == Lp``), each leaf's reduced
    value assembled back from its segments. For ``none`` and ``fp16``
    each leaf is bit-equal to its own allreduce (the wire is elementwise
    and packing a permutation); int8's blocks follow the bucket. With
    ``residual`` (a dict keyed by bucket) returns ``(reduced, new
    residual)``, else ``(reduced, None)``."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.ops import collective as _C
    from horovod_tpu_torch.optim import tree_keys

    op = _C.Average if op is None else _C.ReduceOp(op)
    compression = Compression.none if compression is None else compression
    _check_op(op, compression)
    keys = tree_keys(grads)
    leaves = [grads[k] for k in keys]
    if plan is None:
        plan = plan_for(leaves, 1, bucket_bytes)
    if roundtrip is None:
        def roundtrip(v):
            return compression.decompress(*compression.compress(v))
    flats, new_res = {}, ({} if residual is not None else None)
    for key, b in plan.groups.items():
        out, res = allreduce_bucket(
            pack_group(leaves, b), op, compression, predivide=predivide,
            residual=None if residual is None else residual[key],
            roundtrip=roundtrip)
        flats[key] = out
        if new_res is not None:
            new_res[key] = res
    out = assemble(flats, plan.groups, [tuple(l.shape) for l in leaves],
                   [l.dtype for l in leaves])
    _record_buckets("allreduce", len(plan.groups))
    return dict(zip(keys, out)), new_res
