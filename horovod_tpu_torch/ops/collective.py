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
"""

from __future__ import annotations

import enum
import functools
import itertools
import pickle

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import adasum as _adasum
from horovod_tpu_torch.ops import kernels as _k


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


def _all_gather_single(out, t):
    getattr(dist, _AG)(out, t)


def _reduce_scatter_single(out, t, op):
    getattr(dist, _RS)(out, t, op=op)


def _n() -> int:
    return basics.size()


def _div(x, n: int):
    """``x / n`` as the reference's ``_div``: an integer tensor divides
    in float and truncates back; a float one divides by an ``n`` of its
    own dtype (a tensor, so CUDA performs a true division)."""
    if x.dtype.is_floating_point:
        return x / torch.tensor(n, dtype=x.dtype, device=x.device)
    return torch.div(x, n).to(x.dtype)


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


def _all_to_all(t):
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous())
    return out


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


def gather_shards(flat):
    """Differentiable tiled all-gather of this rank's flat shard (the
    ZeRO-3 full-precision parameter gather): ``[s]`` → ``[N*s]``; the
    backward reduce-scatters (SUM) the cotangent."""
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


def _grouped_flat_allreduce(tensors, op):
    """The fusion buffer: per dtype, the tensors raveled into one flat
    buffer, one ``all_reduce`` (Average divides it by :func:`_div`), and
    split back into views."""
    outs = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idxs in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        dist.all_reduce(flat, op=_DIST_OP[op])
        if op == Average:
            flat = _div(flat, _n())
        parts = flat.split([tensors[i].numel() for i in idxs])
        for i, part in zip(idxs, parts):
            outs[i] = part.view(tensors[i].shape)
    return outs


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
# the public collectives


def allreduce(tensor, op: ReduceOp = Average, *, compression=None):
    """Reduce ``tensor`` across ranks (Average divides the sum by the
    world size; Adasum runs the butterfly of :mod:`.adasum` on a
    power-of-two world). A quantized ``compression`` (``Compression.int8``)
    sends f32/f64 tensors of at least ``min_quant_elems`` elements through
    the int8 exchange; other compressors cast around the reduction."""
    basics._require_init()
    _check_device(tensor)
    op = ReduceOp(op)
    if op != Adasum:
        return _grouped_allreduce([tensor], op, compression)[0][0]
    if getattr(compression, "quantized", False) and \
            _quantizes(compression, tensor):
        raise ValueError("quantized compression does not support op=Adasum")
    if compression is None:
        return _adasum.adasum_allreduce(tensor)
    wire, ctx = compression.compress(tensor)
    return compression.decompress(_adasum.adasum_allreduce(wire), ctx)


def grouped_allreduce(tensors, op: ReduceOp = Average):
    """Fused allreduce of a list of tensors (Horovod's fusion buffer,
    ``MemcpyInFusionBuffer`` -> one reduction -> ``MemcpyOutFusionBuffer``):
    one flat ``all_reduce`` per dtype, split back into views of each
    tensor's shape. ``op=Adasum`` runs one grouped butterfly
    (:func:`~horovod_tpu_torch.ops.adasum.grouped_adasum_allreduce`).
    As the JAX package's ``grouped_allreduce``, every other op sums:
    ``Min`` and ``Max`` are summed, not reduced by min or max."""
    basics._require_init()
    tensors = list(tensors)
    for t in tensors:
        _check_device(t)
    op = ReduceOp(op)
    if op == Adasum:
        return _adasum.grouped_adasum_allreduce(tensors)
    if op not in (Average, Sum):
        op = Sum
    return _grouped_allreduce(tensors, op)[0]


def allgather(tensor):
    """Concatenate every rank's tensor along dim 0 (equal dim 0 on every
    rank, as the reference's static-shape path requires)."""
    basics._require_init()
    _check_device(tensor)
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with a leading dimension")
    return _all_gather_flat(tensor)


def broadcast(tensor, root_rank: int = 0):
    """Every rank gets ``root_rank``'s tensor."""
    basics._require_init()
    _check_device(tensor)
    if not 0 <= root_rank < _n():
        raise ValueError(
            f"broadcast root_rank {root_rank} out of range [0, {_n()})")
    out = tensor.clone(memory_format=torch.contiguous_format)
    was_bool = out.dtype == torch.bool
    if was_bool:
        out = out.to(torch.int8)
    dist.broadcast(out, src=root_rank)
    return out.to(torch.bool) if was_bool else out


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
    length = torch.tensor([len(blob)], dtype=torch.int64, device=dev)
    dist.broadcast(length, src=root_rank)
    if root:
        buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
    else:
        buf = torch.empty(int(length.item()), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=root_rank)
    return pickle.loads(buf.cpu().numpy().tobytes())


def _pad_rows(tensor, n: int):
    """Zero-pad dim 0 up to a multiple of ``n`` — the reference's
    reducescatter quirk: the pad rows land in the tail ranks' shards."""
    pad = (-tensor.shape[0]) % n
    if not pad:
        return tensor
    return torch.cat([tensor, tensor.new_zeros((pad,) + tuple(tensor.shape[1:]))])


def reducescatter(tensor, op: ReduceOp = Average):
    """Reduce along dim 0 and give rank r the r-th of N equal row blocks.
    A dim 0 that N does not divide is zero-padded first."""
    basics._require_init()
    _check_device(tensor)
    op = ReduceOp(op)
    if op not in (Average, Sum):
        raise ValueError(f"reducescatter supports Average/Sum, got {op!r}")
    n = _n()
    t = _pad_rows(tensor, n).contiguous()
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _reduce_scatter_single(out, t, op=dist.ReduceOp.SUM)
    return _div(out, n) if op == Average else out


def alltoall(tensor):
    """Rank i sends row block j of its tensor to rank j; dim 0 must be a
    multiple of the world size."""
    basics._require_init()
    _check_device(tensor)
    if tensor.dim() == 0 or tensor.shape[0] % _n():
        raise ValueError(
            f"alltoall needs dim 0 divisible by the world size {_n()}, "
            f"got shape {tuple(tensor.shape)}")
    return _all_to_all(tensor)
