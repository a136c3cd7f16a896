"""Collective ops over the ``torch.distributed`` process group.

Counterpart of ``horovod_tpu/ops/collective.py`` in its per-rank form
(the reference's "bound axis" path inside ``shard_map``): every process
passes its own tensor and gets its own result. NCCL carries the
collectives on the GPU, gloo on the CPU. The ops return new tensors and
leave their inputs untouched.

The int8 exchange (``allreduce(t, compression=Compression.int8)`` and
:func:`quantized_psum_scatter`) keeps the wire low-bit and the arithmetic
wide: quantize per destination chunk, ``all_to_all`` the int8 values and
the bf16 scales, dequantize-accumulate in f32 on the owning rank, and —
for the allreduce — divide, requantize, and all-gather int8 + scales.
:func:`grouped_allreduce` is Horovod's fusion buffer: one flat
``all_reduce`` per dtype, and for the int8 wire one exchange (one
quantize, two ``all_to_all``, one requantize, two ``all_gather``, one
dequantize) for every quantizable leaf of a dtype at once, in a layout
that keeps each leaf's scale blocks as its own allreduce cuts them.
The ZeRO-3 parameter gather (:func:`gather_shards`,
:func:`quantized_all_gather`) is differentiable: its backward is the
exact SUM reduce-scatter. ``allreduce(t, Adasum)`` runs the butterfly of
:mod:`horovod_tpu_torch.ops.adasum`.

The ``*_async`` ops return a :class:`Handle` (``synchronize``, ``poll``)
and register their ``name`` among the outstanding ones, where a
duplicate raises (the reference's ``DUPLICATE_NAME_ERROR``). Without the
native core an async op is ``torch.distributed``'s ``async_op=True``,
and each sync op is its async op waited on at once, so the two agree
bit for bit.

With the native core attached (``init(native_core=True)``) every op a
caller's thread issues — named or not, sync or async — is queued to the
core (:func:`_core_enqueue`; an op without a name gets the next of
``<op>.noname.<k>``, counted per core), which negotiates it across
ranks, fuses it with others ready in the same cycle and runs it on the
core's thread and process group (:func:`on_group`); a sync op waits on
its handle. So on one rank only the core's thread issues collectives,
in the negotiated order every rank shares, as the reference's one
background thread does: two threads issuing on two NCCL communicators
in an order that differs between ranks can deadlock the card. (A
compressed :func:`allreduce` and the exchanges of the functional
:func:`~horovod_tpu_torch.optim.DistributedOptimizer` still run on the
caller's thread: the core carries no compression.)

``axis=`` of :func:`allreduce` / :func:`allgather` is ``None`` (the
world) or the host mesh's ``(CROSS, LOCAL)`` pair
(:func:`horovod_tpu_torch.parallel.mesh.build_host_mesh`): with the
pair and the toggle on they take the two-level route of
:mod:`horovod_tpu_torch.ops.hierarchical`, else the flat one. A mesh
axis's name (``axis="seq"``, :func:`horovod_tpu_torch.parallel.mesh.
build_mesh`) runs :func:`allreduce`, :func:`grouped_allreduce`,
:func:`allgather`, :func:`alltoall` and :func:`reducescatter` over that
axis's sub-group (:func:`on_group`), Average dividing by its size; not
with the native core attached, which they would bypass (they raise).
"""

from __future__ import annotations

import contextlib
import enum
import functools
import itertools
import pickle
import threading
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.analysis import sanitizer as _sanitizer
from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import straggler as _straggler
from horovod_tpu_torch.ops import adasum as _adasum
from horovod_tpu_torch.ops import kernels as _k
from horovod_tpu_torch.resilience import chaos as _chaos
from horovod_tpu_torch.resilience import retry as _retry


class ReduceOp(enum.IntEnum):
    """Reduction ops. ``AVERAGE``/``SUM``/``ADASUM`` keep the JAX
    package's values; ``MIN``/``MAX`` are what ``torch.distributed``
    adds."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX

_DIST_OP = {
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


# torch renamed the flat-tensor collectives; take whichever this one has,
# looked up through ``dist`` at each call, as every other collective here
_AG = ("all_gather_single" if hasattr(dist, "all_gather_single")
       else "all_gather_into_tensor")
_RS = ("reduce_scatter_single" if hasattr(dist, "reduce_scatter_single")
       else "reduce_scatter_tensor")


_local = threading.local()


def _group():
    """The process group this thread's collectives run on: the default
    one, or the native core's inside :func:`on_group`."""
    return getattr(_local, "group", None)


@contextlib.contextmanager
def on_group(group):
    """Run this thread's collectives on ``group`` while open (the native
    core's thread, on the core's own process group)."""
    saved = _group()
    _local.group = group
    try:
        yield
    finally:
        _local.group = saved


def _axis_group(axis, required: bool = False):
    """The sub-group of the process mesh's axis ``axis`` (a name), or None
    when the mesh has no such axis (the host mesh's pair route then
    judges ``axis``); ``required`` raises instead. Refused while the
    native core is attached (its thread issues every collective)."""
    mesh = basics._state.mesh
    if isinstance(axis, str) and mesh is not None and axis in mesh.shape:
        from horovod_tpu_torch.parallel.mesh import axis_collectives

        return axis_collectives(axis).group(axis)
    if required:
        raise ValueError(f"no mesh axis {axis!r}: build it with "
                         "horovod_tpu_torch.parallel.build_mesh first")
    return None


def _all_gather_single(out, t, async_op=False):
    return getattr(dist, _AG)(out, t, group=_group(), async_op=async_op)


def _reduce_scatter_single(out, t, op, async_op=False):
    return getattr(dist, _RS)(out, t, op=op, group=_group(),
                              async_op=async_op)


def _n() -> int:
    """The size of the group this thread's collectives run on."""
    g = _group()
    return basics.size() if g is None else dist.get_world_size(g)


def _div(x, n: int):
    """``x / n`` as the reference's ``_div``: an integer tensor divides
    in float and truncates back; a float one divides by an ``n`` of its
    own dtype (a 0-d tensor made on the tensor's device, so CUDA performs
    a true division and nothing is copied from the host)."""
    if x.dtype.is_floating_point:
        return x / torch.full((), n, dtype=x.dtype, device=x.device)
    return torch.div(x, n).to(x.dtype)


def _via_core():
    """The native core, when this thread's collectives go through it: one
    is attached and this is not the core's own thread (which runs its
    plans inside :func:`on_group`)."""
    core = basics._state.core
    return core if core is not None and _group() is None else None


def _check_device(tensor):
    dev = basics.device()
    if tensor.device.type != dev.type:
        raise ValueError(
            f"tensor on {tensor.device} but the process group runs on {dev}")


def _all_gather_flat(t):
    """Concatenate every rank's ``t`` along dim 0."""
    out = torch.empty((_n() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather_single(out, t.contiguous())
    return out


def _start_all_to_all(t):
    out = torch.empty_like(t)
    work = dist.all_to_all_single(out, t.contiguous(), group=_group(),
                                  async_op=True)
    return [work], lambda: out


def _all_to_all(t):
    return _run(_start_all_to_all(t))


def _run(started):
    """A started op ``(works, finish)`` waited on at once: its result."""
    works, finish = started
    for w in works:
        if w is not None:
            w.wait()
    return finish()


# --------------------------------------------------------------------------
# int8 exchange


def _quant_exchange(flat, block, pre=None):
    """The wire half of the quantized reduce-scatter: split this rank's
    ``[Lp]`` vector into N destination-chunk rows, quantize blockwise
    (the shared ``_pad_to_block`` layout), and ``all_to_all`` the int8
    values and the bf16 scales. ``pre=(q, scales)`` reuses a wire image
    already computed in the same layout (the fused error-feedback path).
    Returns ``(qr [N, sp], scr [N, sp/block], n, s, sp)``."""
    from horovod_tpu_torch.compression import _pad_to_block, quantize_blockwise

    n = _n()
    s = flat.shape[0] // n
    rows = _pad_to_block(flat.reshape(n, s), block)
    sp = rows.shape[1]
    if pre is not None:
        q, scales = pre
    else:
        q, scales = quantize_blockwise(rows.reshape(-1), block)
    qr = _all_to_all(q).reshape(n, sp)
    scr = _all_to_all(scales).reshape(n, sp // block)
    return qr, scr, n, s, sp


def quantized_psum_scatter(flat, *, block=None, pre=None):
    """int8 SUM reduce-scatter of this rank's flat ``[Lp]`` vector
    (``Lp`` a multiple of the world size N): returns this rank's f32 sum
    shard ``[Lp // N]``. The epilogue is the ``dequant_accumulate``
    kernel."""
    from horovod_tpu_torch.compression import INT8_BLOCK

    block = int(block or INT8_BLOCK)
    qr, scr, _n_, s, _sp = _quant_exchange(flat, block, pre=pre)
    return _k.dequant_accumulate(qr, scr, flat.dtype, block)[:s]


def quantized_reducescatter(tensor, *, block=None):
    """SUM reduce-scatter over the int8 wire of this rank's flat packed
    ``[Lp]`` buffer (``Lp`` a multiple of the world size N, as the ZeRO-1
    packing makes it): this rank's f32 sum shard ``[Lp // N]``. One
    quantize, two ``all_to_all`` (int8 values, bf16 scales) and one
    ``dequant_accumulate`` (:func:`quantized_psum_scatter`)."""
    basics._require_init()
    _check_device(tensor)
    if tensor.dim() != 1:
        raise ValueError("quantized_reducescatter takes this rank's flat "
                         f"[Lp] buffer, got shape {tuple(tensor.shape)}")
    if not tensor.dtype.is_floating_point:
        raise ValueError("quantized_reducescatter quantizes a float buffer, "
                         f"got {tensor.dtype}")
    n = _n()
    if tensor.shape[0] % n:
        raise ValueError(
            f"quantized_reducescatter: Lp={tensor.shape[0]} is not a "
            f"multiple of the world size {n} (pad the flat buffer to it)")
    return quantized_psum_scatter(tensor, block=block)


@functools.lru_cache(maxsize=64)
def _quant_rows_layout(sizes: tuple, n: int, block: int) -> tuple:
    """The ``[N, S]`` layout of the fused int8 exchange of leaves of
    ``sizes``: leaf ``i``, zero-padded to ``N * cols[i]`` (a multiple of
    ``N * block``, as its own allreduce pads it), takes columns
    ``[offs[i], offs[i] + cols[i])`` of every row; row ``j`` is what goes
    to rank ``j``. Every ``cols[i]`` and ``offs[i]`` is a multiple of
    ``block``, so no scale block holds two leaves' elements, and each
    leaf's blocks are the ones its own allreduce quantizes. Returns
    ``(cols, offs, S)``."""
    cols = tuple((sz + (-sz) % (n * block)) // n for sz in sizes)
    offs = tuple(itertools.accumulate((0,) + cols[:-1]))
    return cols, offs, sum(cols)


def _pack_quant_rows(leaves, n: int, cols) -> torch.Tensor:
    """The ``[N, S]`` buffer of :func:`_quant_rows_layout`: one
    ``torch.cat`` of each leaf's zero-padded ``[N, cols[i]]`` rows."""
    rows = []
    for leaf, s in zip(leaves, cols):
        flat = leaf.reshape(-1)
        pad = n * s - flat.shape[0]
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        rows.append(flat.view(n, s))
    return torch.cat(rows, dim=1)


def _unpack_quant_rows(buf, cols, sizes, shapes) -> list:
    """The leaves back from an ``[N, S]`` buffer: views at N = 1 (the
    columns of one row are each leaf's elements), a copy a leaf at N > 1."""
    parts = buf.split(list(cols), dim=1)
    return [p.reshape(-1)[:sz].view(shape)
            for p, sz, shape in zip(parts, sizes, shapes)]


def _grouped_quant_allreduce(leaves, *, op, block, residuals=False):
    """int8 allreduce of several leaves of one float dtype in one
    exchange: the leaves laid side by side as ``[N, S]``
    (:func:`_quant_rows_layout`), one quantize over it, one
    ``all_to_all`` each of the int8 values and the bf16 scales, one
    ``dequant_accumulate_requantize`` (divide by N for Average), one
    ``all_gather`` each, one ``dequantize_rows``. Every scale, quotient and
    sender-order sum is the one the leaf's own allreduce computes, so each
    result is bit-equal to it. With ``residuals`` the quantize also emits
    its roundtrip, and each leaf's ``c - roundtrip(c)`` (what error
    feedback keeps) comes from that same pass. Returns ``(outs,
    residuals or None)``."""
    n = _n()
    sizes = tuple(l.numel() for l in leaves)
    shapes = [l.shape for l in leaves]
    dtype = leaves[0].dtype
    cols, _offs, S = _quant_rows_layout(sizes, n, block)
    buf = _pack_quant_rows(leaves, n, cols)
    pre = res = None
    if residuals:
        q, scales, rt = _k.quantize_roundtrip(buf.view(-1), block)
        res = _unpack_quant_rows(buf - rt.view(n, S), cols, sizes, shapes)
        pre = (q, scales)
    qr, scr, n, _s, _sp = _quant_exchange(buf.view(-1), block, pre=pre)
    q2, sc2 = _k.dequant_accumulate_requantize(
        qr, scr, dtype, block, divisor=(n if op == Average else None))
    qg = _all_gather_flat(q2).view(n, S)
    scg = _all_gather_flat(sc2).view(n, S // block)
    out = _k.dequantize_rows(qg, scg, dtype, block)
    return _unpack_quant_rows(out, cols, sizes, shapes), res


class _ShardGather(torch.autograd.Function):
    """Tiled all-gather of this rank's flat ``[s]`` shard → ``[N*s]``,
    over the int8 wire when ``block`` is given. The backward is the plain
    gather's transpose whatever the wire: the exact SUM reduce-scatter of
    the cotangent."""

    @staticmethod
    def forward(ctx, flat, block):
        if block is None:
            return _all_gather_flat(flat)
        from horovod_tpu_torch.compression import (
            dequantize_rows, quantize_blockwise,
        )

        n, s = _n(), flat.shape[0]
        q, scales = quantize_blockwise(flat, block)          # [sp], [sp/block]
        sp = q.shape[0]
        qg = _all_gather_flat(q).reshape(n, sp)
        scg = _all_gather_flat(scales).reshape(n, sp // block)
        return dequantize_rows(qg, scg, flat.dtype, block)[:, :s].reshape(-1)

    @staticmethod
    def backward(ctx, ct):
        out = torch.empty(ct.shape[0] // _n(), dtype=ct.dtype, device=ct.device)
        _reduce_scatter_single(out, ct.contiguous(), op=dist.ReduceOp.SUM)
        return out, None


class _PairGather(torch.autograd.Function):
    """The ZeRO-3 gather on the host mesh's ``(CROSS, LOCAL)`` pair:
    ``allgather(flat, axis=pair)`` (inside LOCAL then across CROSS while
    ``HOROVOD_HIERARCHICAL_ALLGATHER`` is on, else flat), after the
    shard's int8 roundtrip when ``roundtrip`` (the pair has no int8
    gather: the JAX package sends the roundtripped values). The backward
    is the gather's exact transpose: a reduce-scatter over CROSS then
    LOCAL for the two-level gather, the flat one for the flat gather."""

    @staticmethod
    def forward(ctx, flat, roundtrip):
        from horovod_tpu_torch.compression import INT8_BLOCK, _pad_to_block
        from horovod_tpu_torch.ops import hierarchical as _hier

        ctx.mesh = _hier._mesh()
        if roundtrip:
            padded = _pad_to_block(flat, INT8_BLOCK).contiguous()
            flat = _k.quantize_roundtrip(padded, INT8_BLOCK)[2][:flat.shape[0]]
        ctx.hier = _hier.allgather_enabled()
        if ctx.hier:
            return _hier.hier_allgather(flat)
        return _all_gather_flat(flat)

    @staticmethod
    def backward(ctx, ct):
        mesh = ctx.mesh
        steps = ((mesh.cross_group, mesh.cross), (mesh.local_group,
                                                  mesh.local)) \
            if ctx.hier else ((None, mesh.cross * mesh.local),)
        ct = ct.contiguous()
        for group, size in steps:
            out = torch.empty(ct.shape[0] // size, dtype=ct.dtype,
                              device=ct.device)
            with on_group(group):
                _reduce_scatter_single(out, ct, op=dist.ReduceOp.SUM)
            ct = out
        return ct, None


def gather_shards(flat, *, axis=None, roundtrip: bool = False):
    """Differentiable tiled all-gather of this rank's flat shard (the
    ZeRO-3 full-precision parameter gather): ``[s]`` → ``[N*s]``; the
    backward reduce-scatters (SUM) the cotangent. ``axis`` the host
    mesh's pair: :class:`_PairGather` (``roundtrip`` sends the shard's
    int8 roundtrip)."""
    if axis is not None:
        from horovod_tpu_torch.ops import hierarchical as _hier

        _hier.pair_of(axis)
        return _PairGather.apply(flat, roundtrip)
    if roundtrip:
        raise ValueError("roundtrip= is the axis pair's int8 gather")
    return _ShardGather.apply(flat, None)


def quantized_all_gather(flat, *, block=None):
    """The ZeRO-3 int8 parameter gather (``HOROVOD_FSDP_WIRE=int8``):
    this rank's ``[s]`` shard is quantized blockwise (zero-padded to the
    block inside), the int8 values and bf16 scales are all-gathered, and
    the ``dequantize_rows`` kernel turns the N rows back into ``[N*s]``.
    Differentiable: the backward is the exact f32 SUM reduce-scatter of
    the cotangent, so a step trains on int8-rounded weights but exact
    gradients."""
    from horovod_tpu_torch.compression import INT8_BLOCK

    return _ShardGather.apply(flat, int(block or INT8_BLOCK))


def _quantizes(compression, tensor) -> bool:
    from horovod_tpu_torch.compression import _quantizable

    return _quantizable(tensor.dtype) and \
        tensor.numel() >= int(getattr(compression, "min_quant_elems", 0))


def _start_flat_allreduce(tensors, op):
    """The fusion buffer: per dtype, the tensors raveled into one flat
    buffer and one ``all_reduce`` started on it. Returns ``(works,
    finish)``; ``finish()`` divides for Average (:func:`_div`) and splits
    each buffer back into views of the tensors' shapes."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    works, flats = [], []
    for idxs in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        works.append(dist.all_reduce(flat, op=_DIST_OP[op], group=_group(),
                                     async_op=True))
        flats.append((idxs, flat))

    def finish():
        outs = [None] * len(tensors)
        for idxs, flat in flats:
            if op == Average:
                flat = _div(flat, _n())
            parts = flat.split([tensors[i].numel() for i in idxs])
            for i, part in zip(idxs, parts):
                outs[i] = part.view(tensors[i].shape)
        return outs

    return works, finish


def _grouped_flat_allreduce(tensors, op):
    return _run(_start_flat_allreduce(tensors, op))


def _grouped_allreduce(tensors, op, compression=None, *, residuals=False):
    """``allreduce(t, op, compression=compression)`` of every tensor, in a
    number of collectives that does not depend on how many there are: the
    quantizable tensors of each dtype (a quantized ``compression``, at
    least ``min_quant_elems`` elements) through one int8 exchange
    (:func:`_grouped_quant_allreduce`), the rest compressed one by one and
    reduced by :func:`_grouped_flat_allreduce`. ``residuals``: also each
    tensor's ``t - decompress(compress(t))``, the rounding error feedback
    keeps (``t - t`` for a tensor the wire carries exactly, so a NaN or
    an infinity stays NaN). Returns ``(outs, residuals or None)``."""
    from horovod_tpu_torch.compression import Compression

    compression = compression or Compression.none
    tensors = list(tensors)
    outs = [None] * len(tensors)
    res = [None] * len(tensors) if residuals else None
    quantized = getattr(compression, "quantized", False)
    qgroups: dict = {}
    rest = []
    for i, t in enumerate(tensors):
        if quantized and _quantizes(compression, t):
            qgroups.setdefault(t.dtype, []).append(i)
        else:
            rest.append(i)
    if qgroups and op not in (Average, Sum):
        raise ValueError(f"quantized compression supports Average/Sum, not {op!r}")
    for idxs in qgroups.values():
        o, r = _grouped_quant_allreduce([tensors[i] for i in idxs], op=op,
                                        block=int(compression.block),
                                        residuals=residuals)
        for j, i in enumerate(idxs):
            outs[i] = o[j]
            if residuals:
                res[i] = r[j]
    if rest:
        wire = [compression.compress(tensors[i]) for i in rest]
        red = _grouped_flat_allreduce([c for c, _ in wire], op)
        for i, (c, ctx), o in zip(rest, wire, red):
            outs[i] = compression.decompress(o, ctx)
            if residuals:
                res[i] = tensors[i] - compression.decompress(c, ctx)
    return outs, res


# --------------------------------------------------------------------------
# the eager dispatch guard


#: substrings marking a failure of a world of one's collective as
#: transient (a rendezvous abort, where a re-dispatch succeeds);
#: deliberately narrow, as in the JAX package
_TRANSIENT_DISPATCH_MARKERS = (
    "deadline exceeded",
    "deadline_exceeded",
    "rendezvous",
)

_dispatch_policy: Optional[_retry.RetryPolicy] = None


def _get_dispatch_policy() -> _retry.RetryPolicy:
    """The shared policy for eager launch retries, built at the first
    retry so ``HOROVOD_RETRY_COLLECTIVE_DISPATCH_*`` set after import is
    still honored."""
    global _dispatch_policy
    if _dispatch_policy is None:
        _dispatch_policy = _retry.policy_from_env(
            "collective_dispatch", max_attempts=3, base_delay=0.05,
            max_delay=1.0)
    return _dispatch_policy


def _transient_dispatch_error(e: BaseException) -> bool:
    """Is this eager-launch failure worth re-dispatching? Only when every
    participant failed together: a chaos injection (it fires ahead of the
    launch, on every rank alike) and, in a world of one, the rendezvous
    abort class. Across processes nothing else is retried: a rank that
    re-launches a collective its peers completed would desynchronize the
    job."""
    if isinstance(e, _retry.TransientError):
        return True
    if basics.is_initialized() and basics.process_size() > 1:
        return False
    msg = str(e).lower()
    return any(m in msg for m in _TRANSIENT_DISPATCH_MARKERS)


def _record_eager_op(op_name: str, tensors, axis=None) -> None:
    """Count one dispatched eager collective and its payload bytes, and
    give it its fleet correlation key ``(step, elastic generation, per-op
    seq)`` through :func:`~horovod_tpu_torch.observability.straggler.
    collective_begin` (arrival stamps, the ``rank_slow`` charge), the
    flight ring's begin (the ``rank_hang_at_step`` charge fires there)
    and, under ``HOROVOD_SANITIZE=1``, the schedule sanitizer's record.
    The correlation runs with metrics off too: ranks that disagreed on
    ``seq`` would mis-correlate every later collective."""
    if basics.is_initialized():
        world, prank, psize = (basics.size(), basics.process_rank(),
                               basics.process_size())
    else:
        world, prank, psize = 1, 0, 1
    key = _straggler.collective_begin(
        op_name, world=world, process_rank=prank, process_size=psize)
    _flight.collective_begin(
        op_name, key, world=world, process_rank=prank, process_size=psize)
    _sanitizer.record(op_name, tensors, axis=axis)
    if not _metrics.enabled():
        return
    _metrics.counter(
        f"{op_name}_count", help="eager collectives dispatched").inc()
    _metrics.counter(
        f"{op_name}_bytes", help="payload bytes through eager collectives"
    ).inc(sum(t.numel() * t.element_size() for t in tensors
              if isinstance(t, torch.Tensor)))
    _metrics.counter(
        f"{op_name}_tensors", help="tensors through eager collectives"
    ).inc(len(tensors))


#: this thread is inside a recorded public collective (a nested public
#: call, such as an ``axis=`` op re-entering on its sub-group, is part of
#: the outer op's record)
_in_op = threading.local()


def _guarded(fn):
    """Wrap one public eager collective with the fault-tolerance guard:
    chaos injection (``collective_delay``/``collective_fail``) ahead of
    the launch, and the shared retry policy around transient dispatch
    failures. The happy path is one chaos check and a bare call; the
    backoff schedule is only built once a launch fails.

    A call that launches here (not one this thread hands to the native
    core, which records the op on its own thread when the plan runs, in
    the same order on every rank) is recorded first
    (:func:`_record_eager_op`), and the flight ring gets its end marker
    once the launch returned."""
    op_name = fn.__name__

    @functools.wraps(fn)
    def launch(*args, **kw):
        if getattr(_in_op, "busy", False) or _via_core() is not None:
            return _launch(*args, **kw)
        first = args[0] if args else next(iter(kw.values()))
        tensors = list(first) if isinstance(first, (list, tuple)) \
            else [first]
        _record_eager_op(op_name, tensors, axis=kw.get("axis"))
        _in_op.busy = True
        try:
            out = _launch(*args, **kw)
        finally:
            _in_op.busy = False
        _flight.collective_end()
        return out

    def _launch(*args, **kw):
        if _chaos.enabled():
            _chaos.maybe_delay("collective_delay")

            def attempt():
                if _chaos.enabled():
                    _chaos.inject_failure("collective_fail")
                return fn(*args, **kw)

            return _get_dispatch_policy().call(
                attempt, retriable=_transient_dispatch_error)
        try:
            return fn(*args, **kw)
        except Exception as e:
            if not _transient_dispatch_error(e):
                raise
            # the failure that already happened is the policy's first
            # attempt: launches stay within max_attempts, and the first
            # re-dispatch waits out base_delay
            first = [e]

            def rerun():
                if first:
                    raise first.pop()
                return fn(*args, **kw)

            return _get_dispatch_policy().call(
                rerun, retriable=_transient_dispatch_error)

    return launch


# --------------------------------------------------------------------------
# the public collectives


@_guarded
def allreduce(tensor, op: ReduceOp = Average, *, compression=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              axis=None):
    """Reduce ``tensor`` across ranks (Average divides the sum by the
    world size; Adasum runs the butterfly of :mod:`.adasum` on a
    power-of-two world). A quantized ``compression`` (``Compression.int8``)
    sends f32/f64 tensors of at least ``min_quant_elems`` elements through
    the int8 exchange; other compressors cast around the reduction.
    ``prescale_factor`` multiplies the tensor before the reduction,
    ``postscale_factor`` the result after it, as in the JAX package.
    ``axis`` a mesh axis's name: over its sub-group. ``axis`` the host
    mesh's ``(CROSS, LOCAL)`` pair: the two-level route
    while ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is on
    (:func:`~horovod_tpu_torch.ops.hierarchical.hier_allreduce`, a
    quantized compressor on the cross hop only), else the flat one (a
    quantized compressor's roundtrip through the plain sum, as the JAX
    package models a pair's wire)."""
    basics._require_init()
    _check_device(tensor)
    op = ReduceOp(op)
    if _axis_group(axis) is not None:
        if op == Adasum:
            raise ValueError("Adasum runs over the world; pass axis=None")
        with on_group(_axis_group(axis)):
            return allreduce(tensor, op, compression=compression,
                             prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor)
    if axis is not None:
        return _pair_allreduce(tensor, op, compression, axis,
                               prescale_factor, postscale_factor)
    if compression is None and _via_core() is not None:
        return allreduce_async(tensor, op, prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor).wait()
    if prescale_factor != 1.0:
        tensor = tensor * prescale_factor
    if op != Adasum:
        out = _grouped_allreduce([tensor], op, compression)[0][0]
    elif getattr(compression, "quantized", False) and \
            _quantizes(compression, tensor):
        raise ValueError("quantized compression does not support op=Adasum")
    elif compression is None:
        out = _adasum.adasum_allreduce(tensor)
    else:
        wire, ctx = compression.compress(tensor)
        out = compression.decompress(_adasum.adasum_allreduce(wire), ctx)
    return out * postscale_factor if postscale_factor != 1.0 else out


def _roundtrip_residuals(tensors, compression) -> list:
    """Each tensor's ``t - decompress(compress(t))``, the rounding error
    feedback keeps on a route whose wire is not the tensor's own
    exchange (the axis pair's). A quantized compressor's roundtrips run
    as one ``quantize`` launch a dtype over the tensors laid side by side
    (:func:`_quant_rows_layout` at one row: each tensor's own 256-element
    blocks, so every value is its own compressor's); the tensors it does
    not quantize give ``t - t``."""
    from horovod_tpu_torch.compression import Compression

    compression = compression or Compression.none
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        if getattr(compression, "quantized", False) and \
                _quantizes(compression, t):
            groups.setdefault(t.dtype, []).append(i)
        else:
            out[i] = t - compression.decompress(*compression.compress(t))
    block = int(getattr(compression, "block", 0) or 0)
    for idxs in groups.values():
        leaves = [tensors[i] for i in idxs]
        sizes = tuple(t.numel() for t in leaves)
        cols, _offs, _S = _quant_rows_layout(sizes, 1, block)
        buf = _pack_quant_rows(leaves, 1, cols)
        rt = _k.quantize_roundtrip(buf.view(-1), block)[2]
        for i, r in zip(idxs, _unpack_quant_rows(
                buf - rt.view(buf.shape), cols, sizes,
                [t.shape for t in leaves])):
            out[i] = r
    return out


def _pair_allreduce(tensor, op, compression, axis, prescale_factor,
                    postscale_factor):
    """:func:`allreduce` over the host mesh's ``(CROSS, LOCAL)`` pair
    (:func:`_pair_grouped_allreduce` of the one tensor)."""
    from horovod_tpu_torch.ops import hierarchical as _hier

    _hier.pair_of(axis)
    if prescale_factor != 1.0:
        tensor = tensor * prescale_factor
    return _pair_grouped_allreduce([tensor], op, compression,
                                   postscale_factor=postscale_factor)[0]


def _pair_grouped_allreduce(tensors, op, compression=None, *,
                            postscale_factor: float = 1.0) -> list:
    """``allreduce(t, op, compression=, axis=(CROSS, LOCAL))`` of every
    tensor, as the JAX package dispatches a tuple axis, with the
    collectives grouped: while ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is on,
    the tensors a quantized compressor quantizes go through
    :func:`~horovod_tpu_torch.ops.hierarchical.grouped_hier_allreduce`
    with it (int8 on the cross hop only), the others compressed whole
    around it; with it off the flat route, a quantized compressor's
    roundtrip through the plain sum. Average divides by the world size.
    Adasum has no tuple-axis route, and the two-level one sums only."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.ops import hierarchical as _hier

    mesh = _hier._mesh()
    op = ReduceOp(op)
    if op == Adasum:
        raise ValueError(
            "Adasum does not support hierarchical (tuple) axes; the VHDD "
            "butterfly needs one flat rank ordering — pass a single-axis "
            "mesh or an explicit axis")
    hier = _hier.enabled()
    compression = compression or Compression.none
    quantized = getattr(compression, "quantized", False)
    q = [i for i, t in enumerate(tensors)
         if quantized and _quantizes(compression, t)]
    rest = [i for i in range(len(tensors)) if i not in set(q)]
    if (q or hier) and op not in (Average, Sum):
        raise ValueError(
            f"the hierarchical and quantized routes support Average/Sum, "
            f"not {op!r}")
    n = mesh.cross * mesh.local
    outs = [None] * len(tensors)

    def finish(o):
        if op == Average:
            o = _div(o, n)
        return o * postscale_factor if postscale_factor != 1.0 else o

    if q and hier:
        # one grouped call: a quantized compressor leaves the tensors it
        # does not quantize as they are, and they ride its buffers exact
        red = _hier.grouped_hier_allreduce(tensors, compression=compression)
        return [finish(o) for o in red]
    if q:
        red = _grouped_flat_allreduce(
            [compression.decompress(*compression.compress(tensors[i]))
             for i in q], Sum)
        for i, o in zip(q, red):
            outs[i] = finish(o)
    if rest:
        wire = [compression.compress(tensors[i]) for i in rest]
        if hier:
            red = [finish(o) for o in _hier.grouped_hier_allreduce(
                [c for c, _ in wire])]
        else:
            red = _grouped_flat_allreduce([c for c, _ in wire], op)
            if postscale_factor != 1.0:
                red = [o * postscale_factor for o in red]
        for i, (_c, ctx), o in zip(rest, wire, red):
            outs[i] = compression.decompress(o, ctx)
    return outs


def allreduce_(tensor, op: ReduceOp = Average, **kw):
    """In-place :func:`allreduce`: the result is copied into ``tensor``,
    which is returned."""
    out = allreduce(tensor, op, **kw)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


@_guarded
def grouped_allreduce(tensors, op: ReduceOp = Average, *, axis=None):
    """Fused allreduce of a list of tensors (Horovod's fusion buffer,
    ``MemcpyInFusionBuffer`` -> one reduction -> ``MemcpyOutFusionBuffer``):
    one flat ``all_reduce`` per dtype, split back into views of each
    tensor's shape. ``op=Adasum`` runs one grouped butterfly
    (:func:`~horovod_tpu_torch.ops.adasum.grouped_adasum_allreduce`).
    As the JAX package's ``grouped_allreduce``, every other op sums:
    ``Min`` and ``Max`` are summed, not reduced by min or max. ``axis``
    a mesh axis's name: over its sub-group (not Adasum)."""
    basics._require_init()
    tensors = list(tensors)
    if axis is not None:
        if ReduceOp(op) == Adasum:
            raise ValueError("Adasum runs over the world; pass axis=None")
        with on_group(_axis_group(axis, required=True)):
            return grouped_allreduce(tensors, op)
    for t in tensors:
        _check_device(t)
    op = ReduceOp(op)
    if op not in (Average, Sum, Adasum):
        op = Sum
    if _via_core() is not None:
        return [h.wait() for h in [allreduce_async(t, op) for t in tensors]]
    if op == Adasum:
        return _adasum.grouped_adasum_allreduce(tensors)
    return _grouped_allreduce(tensors, op)[0]


def _start_allgather(tensor):
    basics._require_init()
    _check_device(tensor)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with a leading dimension")
    t = tensor.contiguous()
    out = torch.empty((_n() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return [_all_gather_single(out, t, async_op=True)], lambda: out


@_guarded
def allgather(tensor, *, axis=None):
    """Concatenate every rank's tensor along dim 0 (equal dim 0 on every
    rank, as the reference's static-shape path requires). ``axis`` a
    mesh axis's name: over its sub-group. ``axis`` the
    host mesh's ``(CROSS, LOCAL)`` pair: while
    ``HOROVOD_HIERARCHICAL_ALLGATHER`` is on, gathered inside LOCAL then
    across CROSS (:func:`~horovod_tpu_torch.ops.hierarchical.
    hier_allgather`, the same rank order)."""
    if _axis_group(axis) is not None:
        with on_group(_axis_group(axis)):
            return allgather(tensor)
    if axis is not None:
        from horovod_tpu_torch.ops import hierarchical as _hier

        basics._require_init()
        _check_device(tensor)
        _hier.pair_of(axis)
        if _hier.allgather_enabled():
            return _hier.hier_allgather(tensor)
    if _via_core() is not None:
        return allgather_async(tensor).wait()
    return _run(_start_allgather(tensor))


@_guarded
def grouped_allgather(tensors):
    """:func:`allgather` of each tensor of a list, all started before any
    is waited on (the reference fuses allgather responses too; mixed
    dtypes welcome)."""
    if _via_core() is not None:
        return [h.wait() for h in [allgather_async(t) for t in tensors]]
    started = [_start_allgather(t) for t in tensors]
    return [_run(s) for s in started]


def _start_broadcast(tensor, root_rank: int):
    basics._require_init()
    _check_device(tensor)
    if not 0 <= root_rank < _n():
        raise ValueError(
            f"broadcast root_rank {root_rank} out of range [0, {_n()})")
    out = tensor.clone(memory_format=torch.contiguous_format)
    was_bool = out.dtype == torch.bool
    if was_bool:
        out = out.to(torch.int8)
    work = dist.broadcast(out, src=root_rank, group=_group(), async_op=True)
    return [work], lambda: out.to(torch.bool) if was_bool else out


@_guarded
def broadcast(tensor, root_rank: int = 0):
    """Every rank gets ``root_rank``'s tensor."""
    if _via_core() is not None:
        return broadcast_async(tensor, root_rank).wait()
    return _run(_start_broadcast(tensor, root_rank))


def broadcast_(tensor, root_rank: int = 0):
    """In-place :func:`broadcast`: root's value is copied into ``tensor``,
    which is returned."""
    out = broadcast(tensor, root_rank)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def broadcast_object(obj, root_rank: int = 0):
    """Every rank gets a copy of ``root_rank``'s picklable ``obj``
    (reference ``torch/__init__.py:609-648``): root pickles it into a
    ``uint8`` tensor, and its length, then the bytes, are broadcast over
    the process group. Floats, ints and strings arrive exact."""
    basics._require_init()
    if not 0 <= root_rank < _n():
        raise ValueError(
            f"broadcast_object root_rank {root_rank} out of range [0, {_n()})")
    if _n() == 1:
        return pickle.loads(pickle.dumps(obj))
    dev = basics.device()
    root = basics.rank() == root_rank
    blob = pickle.dumps(obj) if root else b""
    length = broadcast(torch.tensor([len(blob)], dtype=torch.int64,
                                    device=dev), root_rank)
    if root:
        buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
    else:
        buf = torch.empty(int(length.item()), dtype=torch.uint8, device=dev)
    buf = broadcast(buf, root_rank)
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj) -> list:
    """Every rank's picklable ``obj``, rank-ordered (reference pattern
    ``torch/__init__.py:609-648``): each rank pickles its object into a
    ``uint8`` tensor; the lengths are gathered, then the bytes, each
    padded to the longest."""
    basics._require_init()
    if _n() == 1:
        return [pickle.loads(pickle.dumps(obj))]
    dev = basics.device()
    blob = pickle.dumps(obj)
    lengths = allgather(torch.tensor([len(blob)], dtype=torch.int64,
                                     device=dev)).tolist()
    buf = torch.zeros(max(lengths), dtype=torch.uint8, device=dev)
    buf[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    rows = allgather(buf).view(_n(), -1).cpu().numpy()
    return [pickle.loads(row[:n].tobytes()) for row, n in zip(rows, lengths)]


def _pad_rows(tensor, n: int):
    """Zero-pad dim 0 up to a multiple of ``n`` — the reference's
    reducescatter quirk: the pad rows land in the tail ranks' shards."""
    pad = (-tensor.shape[0]) % n
    if not pad:
        return tensor
    return torch.cat([tensor, tensor.new_zeros((pad,) + tuple(tensor.shape[1:]))])


def _check_rs_op(op) -> ReduceOp:
    op = ReduceOp(op)
    if op not in (Average, Sum):
        raise ValueError(f"reducescatter supports Average/Sum, got {op!r}")
    return op


def _start_reducescatter(tensor, op):
    basics._require_init()
    _check_device(tensor)
    op = _check_rs_op(op)
    n = _n()
    t = _pad_rows(tensor, n).contiguous()
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    work = _reduce_scatter_single(out, t, op=dist.ReduceOp.SUM, async_op=True)
    return [work], lambda: _div(out, n) if op == Average else out


@_guarded
def reducescatter(tensor, op: ReduceOp = Average, *, axis=None):
    """Reduce along dim 0 and give rank r the r-th of N equal row blocks.
    A dim 0 that N does not divide is zero-padded first. ``axis`` a mesh
    axis's name: over its sub-group, r and N its index and size."""
    if axis is not None:
        with on_group(_axis_group(axis, required=True)):
            return reducescatter(tensor, op)
    if _via_core() is not None:
        return reducescatter_async(tensor, op).wait()
    return _run(_start_reducescatter(tensor, op))


def _start_alltoall(tensor):
    basics._require_init()
    _check_device(tensor)
    if tensor.dim() == 0 or tensor.shape[0] % _n():
        raise ValueError(
            f"alltoall needs dim 0 divisible by the world size {_n()}, "
            f"got shape {tuple(tensor.shape)}")
    return _start_all_to_all(tensor)


@_guarded
def alltoall(tensor, *, axis=None):
    """Rank i sends row block j of its tensor to rank j; dim 0 must be a
    multiple of the world size. ``axis`` a mesh axis's name: over its
    sub-group, i and j its indices."""
    if axis is not None:
        with on_group(_axis_group(axis, required=True)):
            return alltoall(tensor)
    if _via_core() is not None:
        return alltoall_async(tensor).wait()
    return _run(_start_alltoall(tensor))


# --------------------------------------------------------------------------
# async ops and their handles


class Handle:
    """An async op without the native core (reference
    ``torch/handle_manager.{h,cc}``, poll/wait ``torch/mpi_ops.py:475-524``):
    owns the started ``torch.distributed`` works and the op's output."""

    __slots__ = ("_works", "_finish", "_name", "_result")

    def __init__(self, works, finish, name=None):
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._name = name
        self._result = None

    def done(self) -> bool:
        """Have the works completed? On the card a work's completion is
        the query of the event NCCL records after the collective."""
        return self._finish is None or all(w.is_completed()
                                           for w in self._works)

    def wait(self, timeout=None):
        """The op's output; the caller's stream waits on the collective
        (on the CPU the host blocks until it is done). ``timeout`` is for
        the signature of :meth:`CoreHandle.wait` and not enforced."""
        del timeout
        if self._finish is not None:
            try:
                for w in self._works:
                    w.wait()
                self._result = self._finish()
            finally:
                self._finish = None
                self._works = []
                _release_name(self._name)
        return self._result


_outstanding_lock = threading.Lock()
_outstanding_names = set()


def _register_name(name: Optional[str]):
    """Duplicate outstanding names are an error, as in the reference
    (``DUPLICATE_NAME_ERROR``, ``common/common.h:161-164``)."""
    if name is None:
        return
    with _outstanding_lock:
        if name in _outstanding_names:
            raise ValueError(
                f"Duplicate tensor name '{name}' in outstanding collective; "
                "synchronize the previous op first (reference "
                "DUPLICATE_NAME_ERROR).")
        _outstanding_names.add(name)


def clear_outstanding_names() -> None:
    """Forget every outstanding async-collective name
    (:func:`horovod_tpu_torch.basics.shutdown` calls this)."""
    with _outstanding_lock:
        _outstanding_names.clear()


def _release_name(name: Optional[str]):
    if name is None:
        return
    with _outstanding_lock:
        _outstanding_names.discard(name)


def _async(start, name):
    """Register ``name``, start the op, and release the name if starting
    it fails (else the name would be poisoned for good)."""
    _register_name(name)
    try:
        works, finish = start()
    except BaseException:
        _release_name(name)
        raise
    return Handle(works, finish, name=name)


def _done(value):
    """A started op that has already run: ``value`` is its output."""
    return [], lambda: value


def synchronize(handle):
    """Block until the handle's op completed and return its output
    (reference ``torch/mpi_ops.py:491-508``)."""
    return handle.wait()


def poll(handle) -> bool:
    """Nonblocking completion check (reference ``torch/mpi_ops.py:475-489``)."""
    return handle.done()


def join() -> int:
    """Uneven-data join (reference ``torch/mpi_ops.py:511-524``,
    ``controller.cc:219-307``): with the native core attached this rank
    keeps taking part in the other ranks' negotiated reductions with zero
    contributions until every rank has joined, and the result is the last
    rank to join. Without the core there is no negotiation to backfill
    from, and, as the JAX package's, it returns this rank."""
    basics._require_init()
    core = basics._state.core
    if core is not None:
        from horovod_tpu_torch.core import JOIN_TENSOR_NAME, REQUEST_JOIN

        h = core.enqueue(JOIN_TENSOR_NAME,
                         torch.zeros(0, device=basics.device()), REQUEST_JOIN)
        return int(h.wait())
    return basics.rank()


def _core_enqueue(name, tensor, request_type, **kw):
    """Queue an async op to the native core when this thread's ops go
    through it (:func:`_via_core`); None when the op should start here.
    An op without a name takes the core's next generated one
    (``<op>.noname.<k>``: every rank issues its ops in the same order, so
    the names agree). The name stays outstanding until the handle is
    waited on, as on the direct path (the core's own check sees only the
    names it still queues)."""
    core = _via_core()
    if core is None:
        return None
    basics._require_init()
    _check_device(tensor)
    if name is None:
        name = core.auto_name(request_type)
    _register_name(name)
    try:
        handle = core.enqueue(name, tensor, request_type, **kw)
    except BaseException:
        _release_name(name)
        raise
    handle.on_wait = lambda: _release_name(name)
    return handle


def _start_allreduce(tensor, op, prescale_factor, postscale_factor):
    basics._require_init()
    _check_device(tensor)
    op = ReduceOp(op)
    if op == Adasum:        # the butterfly's exchanges wait as they go
        return _done(allreduce(tensor, op, prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor))
    if prescale_factor != 1.0:
        tensor = tensor * prescale_factor
    works, finish = _start_flat_allreduce([tensor], op)
    if postscale_factor == 1.0:
        return works, lambda: finish()[0]
    return works, lambda: finish()[0] * postscale_factor


def allreduce_async(tensor, op: ReduceOp = Average, *, name=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0):
    """Async :func:`allreduce` returning a handle (reference
    ``torch/mpi_ops.py:94-129``). With the native core attached and a
    ``name`` given it is negotiated and fused by the core."""
    from horovod_tpu_torch.core import REQUEST_ADASUM, REQUEST_ALLREDUCE

    h = _core_enqueue(
        name, tensor, REQUEST_ADASUM if op == Adasum else REQUEST_ALLREDUCE,
        op=ReduceOp(op), prescale=prescale_factor, postscale=postscale_factor)
    if h is not None:
        return h
    return _async(lambda: _start_allreduce(tensor, op, prescale_factor,
                                           postscale_factor), name)


class _InPlaceHandle:
    """Handle of an in-place async op: ``wait`` copies the op's output
    into the tensor it was given and returns that tensor."""

    __slots__ = ("_inner", "_tensor", "_copied")

    def __init__(self, inner, tensor):
        self._inner = inner
        self._tensor = tensor
        self._copied = False

    def done(self) -> bool:
        return self._inner.done()

    def wait(self, timeout=None):
        out = self._inner.wait(timeout)
        if not self._copied:
            with torch.no_grad():
                self._tensor.copy_(out)
            self._copied = True
        return self._tensor


def allreduce_async_(tensor, op: ReduceOp = Average, *, name=None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0):
    """In-place :func:`allreduce_async`: on ``wait`` the result is copied
    into ``tensor``, which ``wait`` returns."""
    return _InPlaceHandle(
        allreduce_async(tensor, op, name=name,
                        prescale_factor=prescale_factor,
                        postscale_factor=postscale_factor), tensor)


class _GroupHandle:
    """Handle of several ops queued to the core as one: ``wait`` gives
    their outputs, in order."""

    __slots__ = ("_handles",)

    def __init__(self, handles):
        self._handles = handles

    def done(self) -> bool:
        return all(h.done() for h in self._handles)

    def wait(self, timeout=None):
        return [h.wait(timeout) for h in self._handles]


def grouped_allreduce_async(tensors, op: ReduceOp = Average, *, name=None):
    """Async :func:`grouped_allreduce`. With the core attached each
    tensor is queued to it (``<name>.<i>``), and the core fuses those of
    a cycle."""
    op = ReduceOp(op)
    if _via_core() is not None:
        op = op if op in (Average, Sum, Adasum) else Sum
        return _GroupHandle([
            allreduce_async(t, op, name=None if name is None
                            else f"{name}.{i}")
            for i, t in enumerate(tensors)])

    def start():
        basics._require_init()
        for t in tensors:
            _check_device(t)
        if op == Adasum:
            return _done(grouped_allreduce(tensors, op))
        return _start_flat_allreduce(list(tensors),
                                     op if op in (Average, Sum) else Sum)

    return _async(start, name)


def allgather_async(tensor, *, name=None):
    from horovod_tpu_torch.core import REQUEST_ALLGATHER

    h = _core_enqueue(name, tensor, REQUEST_ALLGATHER)
    if h is not None:
        return h
    return _async(lambda: _start_allgather(tensor), name)


def broadcast_async(tensor, root_rank: int = 0, *, name=None):
    from horovod_tpu_torch.core import REQUEST_BROADCAST

    if not 0 <= root_rank < _n():
        raise ValueError(
            f"broadcast root_rank {root_rank} out of range [0, {_n()})")
    h = _core_enqueue(name, tensor, REQUEST_BROADCAST, root_rank=root_rank)
    if h is not None:
        return h
    return _async(lambda: _start_broadcast(tensor, root_rank), name)


def broadcast_async_(tensor, root_rank: int = 0, *, name=None):
    """In-place :func:`broadcast_async`: on ``wait`` root's value is
    copied into ``tensor``, which ``wait`` returns."""
    return _InPlaceHandle(broadcast_async(tensor, root_rank, name=name),
                          tensor)


def alltoall_async(tensor, *, name=None):
    from horovod_tpu_torch.core import REQUEST_ALLTOALL

    h = _core_enqueue(name, tensor, REQUEST_ALLTOALL)
    if h is not None:
        return h
    return _async(lambda: _start_alltoall(tensor), name)


def reducescatter_async(tensor, op: ReduceOp = Average, *, name=None):
    """Async :func:`reducescatter`; with the core attached and a ``name``
    it rides the negotiation as ``REQUEST_REDUCESCATTER``."""
    from horovod_tpu_torch.core import REQUEST_REDUCESCATTER

    op = _check_rs_op(op)
    h = _core_enqueue(name, tensor, REQUEST_REDUCESCATTER, op=op)
    if h is not None:
        return h
    return _async(lambda: _start_reducescatter(tensor, op), name)


def handle_average_backwards_compatibility(op, average):
    """Resolve the deprecated ``average=`` kwarg against ``op=`` (reference
    ``horovod/common/util.py``): exactly one may be given; ``average``
    defaults to True, i.e. Average."""
    if op is not None:
        if average is not None:
            raise ValueError(
                "The op parameter supersedes average; provide only one.")
        return op
    return Average if (average is None or average) else Sum
