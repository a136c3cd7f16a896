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
The ZeRO-3 parameter gather (:func:`gather_shards`,
:func:`quantized_all_gather`) is differentiable: its backward is the
exact SUM reduce-scatter. ``allreduce(t, Adasum)`` runs the butterfly of
:mod:`horovod_tpu_torch.ops.adasum`.
"""

from __future__ import annotations

import enum

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


# torch renamed the flat-tensor collectives; take whichever this one has
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


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


def _quant_allreduce_bound(v, *, op, block):
    """int8 allreduce: quantized reduce-scatter, f32 accumulate, divide
    (Average), requantize — one ``dequant_accumulate_requantize`` kernel
    — then all-gather int8 + scales and dequantize."""
    from horovod_tpu_torch.compression import dequantize_blockwise

    n = _n()
    shape, size, dtype = v.shape, v.numel(), v.dtype
    flat = v.reshape(-1)
    pad = (-size) % (n * block)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    qr, scr, n, _s, _sp = _quant_exchange(flat, block)
    q2, sc2 = _k.dequant_accumulate_requantize(
        qr, scr, dtype, block, divisor=(n if op == Average else None))
    qg = _all_gather_flat(q2)
    scg = _all_gather_flat(sc2)
    out = dequantize_blockwise(qg, scg, dtype, block)
    return out[:size].reshape(shape)


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
    if compression is not None and getattr(compression, "quantized", False) \
            and _quantizes(compression, tensor):
        if op == Adasum:
            raise ValueError("quantized compression does not support op=Adasum")
        if op not in (Average, Sum):
            raise ValueError(f"quantized compression supports Average/Sum, not {op!r}")
        return _quant_allreduce_bound(
            tensor, op=op, block=int(compression.block))
    ctx = None
    if compression is not None:
        tensor, ctx = compression.compress(tensor)
    if op == Adasum:
        out = _adasum.adasum_allreduce(tensor)
    else:
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_DIST_OP[op])
        if op == Average:
            out = _div(out, _n())
    if compression is not None:
        out = compression.decompress(out, ctx)
    return out


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
