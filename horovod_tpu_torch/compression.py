"""Gradient compression: compress before the collective, decompress after.

Counterpart of ``horovod_tpu/compression.py`` (reference
``horovod/torch/compression.py``): ``Compression.none``, ``.fp16``
(bfloat16 on the wire), ``.int8`` (blockwise-scaled int8, one bf16
max-abs scale per :data:`INT8_BLOCK` elements) and ``.powersgd(r)``
(rank-``r`` factors of the >= 2-D leaves, Vogels et al. 2019; the
factorization itself lives in :mod:`horovod_tpu_torch.optim`, which
keeps its warm-started ``Q``). :meth:`Compression.from_env` reads the
``HOROVOD_COMPRESSION`` spelling. The int8 collectives in
:mod:`horovod_tpu_torch.ops.collective` never sum int8: they quantize per
destination chunk, exchange int8 + scales, and accumulate in f32.

The quantize itself is the ``quantize`` kernel of
:mod:`horovod_tpu_torch.ops.kernels` (its plain version on CPU tensors);
the block layout — which elements share a scale — is spelled here by
:func:`_pad_to_block`, so CPU and CUDA consume identical layouts.
"""

from __future__ import annotations

import math
import os

import torch

from horovod_tpu_torch.ops import kernels as _k

#: elements per int8 quantization scale (one bf16 scale per block)
INT8_BLOCK = 256

#: bytes of one int8 scale on the wire (bfloat16)
_SCALE_BYTES = 2

#: smallest leaf the per-leaf int8 paths quantize: below it the block
#: padding of the quantized ring would move more bytes than fp32, so such
#: leaves ride uncompressed (the ZeRO-1 flat buffers amortize the padding)
MIN_QUANT_ELEMS = 1024


def _quantizable(dtype) -> bool:
    """int8 compresses only wide floats (f32/f64); integer and 16-bit
    float leaves pass through uncompressed."""
    return dtype.is_floating_point and dtype.itemsize > 2


def _pad_to_block(x, block: int):
    """Zero-pad a flat ``[L]`` vector, or the trailing axis of ``[n, s]``
    destination-chunk rows, up to a multiple of ``block``."""
    pad = (-x.shape[-1]) % block
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def quantize_blockwise(flat, block: int = INT8_BLOCK):
    """Blockwise int8 quantize of a flat float vector (a tail shorter than
    ``block`` is zero-padded): ``(q int8 [Lpad], scales bf16
    [Lpad/block])``. The scale is rounded to bf16 before the divide, so
    sender and receiver agree on the exact scale the wire carries."""
    return _k.quantize_blockwise(_pad_to_block(flat, block).contiguous(), block)


def dequantize_blockwise(q, scales, dtype, block: int = INT8_BLOCK):
    """Inverse of :func:`quantize_blockwise` back to a flat ``dtype``
    vector."""
    m = q.to(dtype).reshape(-1, block)
    return (m * scales.to(dtype)[:, None]).reshape(-1)


def dequantize_rows(qr, scr, dtype, block: int = INT8_BLOCK):
    """Per-row dequantize of gathered int8 rows: ``qr [N, sp]`` + bf16
    scales ``scr [N, sp/block]`` → ``[N, sp]`` in ``dtype``, no
    accumulation (each row is another rank's parameter shard). The ZeRO-3
    int8 parameter-gather epilogue, the ``dequantize_rows`` kernel."""
    return _k.dequantize_rows(qr, scr, dtype, block)


def int8_roundtrip(tensor, block: int = INT8_BLOCK):
    """What ``tensor`` looks like after one trip through the int8 wire
    (flat-block layout): ``dequant(quant(.))`` through the ``quantize``
    kernel's roundtrip image, in the tensor's shape. Identity (the same
    object) on dtypes that are not quantized and on leaves below the
    :data:`MIN_QUANT_ELEMS` floor, which ride uncompressed."""
    if not _quantizable(tensor.dtype) or tensor.numel() < MIN_QUANT_ELEMS:
        return tensor
    flat = _pad_to_block(tensor.reshape(-1), block).contiguous()
    deq = _k.quantize_roundtrip(flat, block)[2]
    return deq[:tensor.numel()].reshape(tensor.shape)


def quantize_chunked(flat, n: int, block: int = INT8_BLOCK):
    """The wire image of a flat packed ``[Lp]`` buffer in the layout the
    quantized reduce-scatter sends: split into ``n`` destination chunks,
    each zero-padded to the block, quantized in one pass that also emits
    the dequantized roundtrip. Returns ``(q, scales, rt)``; ``rt`` is the
    roundtrip sliced back to ``[Lp]``. ``Lp`` must be a multiple of
    ``n``."""
    s = flat.shape[0] // n
    rows = _pad_to_block(flat.reshape(n, s), block)
    sp = rows.shape[1]
    q, scales, deq = _k.quantize_roundtrip(rows.reshape(-1).contiguous(), block)
    rt = deq.reshape(n, sp)[:, :s].reshape(-1)
    return q, scales, rt


def quantize_roundtrip_chunked(flat, n: int, block: int = INT8_BLOCK):
    """The dequantized wire roundtrip of :func:`quantize_chunked`: what
    error feedback measures its residual against."""
    return quantize_chunked(flat, n, block)[2]


class Compressor:
    """Interface (reference ``torch/compression.py``): ``compress``
    returns ``(compressed, ctx)``; ``decompress(compressed, ctx)``
    inverts it; ``wire_bytes(shape, dtype)`` is what one leaf costs on
    the wire per transfer direction."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


def _numel(shape) -> int:
    return int(math.prod(int(d) for d in shape))


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor

    @staticmethod
    def wire_bytes(shape, dtype) -> int:
        return _numel(shape) * dtype.itemsize


class FP16Compressor(Compressor):
    """16-bit float wire: bfloat16, as the JAX package chose for the
    dynamic range."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(torch.bfloat16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor

    @staticmethod
    def wire_bytes(shape, dtype) -> int:
        return _numel(shape) * (2 if dtype.is_floating_point else dtype.itemsize)


class Int8Compressor(Compressor):
    """Blockwise-scaled int8, f32/f64 leaves of at least
    :data:`MIN_QUANT_ELEMS` elements; everything else passes through.
    ``compress``/``decompress`` are the wire roundtrip error feedback
    measures against; the collectives route ``quantized`` compressors to
    the int8 exchange."""

    quantized = True
    block = INT8_BLOCK
    min_quant_elems = MIN_QUANT_ELEMS

    @classmethod
    def quantizes(cls, shape, dtype) -> bool:
        return _quantizable(dtype) and _numel(shape) >= cls.min_quant_elems

    @classmethod
    def compress(cls, tensor):
        if not cls.quantizes(tensor.shape, tensor.dtype):
            return tensor, None
        q, scales = quantize_blockwise(tensor.reshape(-1), cls.block)
        return q, (scales, tensor.dtype, tuple(tensor.shape))

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is None:
            return tensor
        scales, dtype, shape = ctx
        flat = dequantize_blockwise(tensor, scales, dtype, cls.block)
        return flat[:_numel(shape)].reshape(shape)

    @classmethod
    def wire_bytes(cls, shape, dtype) -> int:
        n = _numel(shape)
        if not cls.quantizes(shape, dtype):
            return n * dtype.itemsize
        return n + math.ceil(n / cls.block) * _SCALE_BYTES


class PowerSGDCompressor(Compressor):
    """Rank-``r`` low-rank gradient factorization (PowerSGD): a >= 2-D
    leaf ``M``, seen as ``[d0, prod(rest)]``, syncs only ``P = M @ Q``
    and ``Q' = M^T @ P``, ``(d0 + m) * r`` floats in place of ``d0 * m``,
    with ``Q`` warm-started across steps in the optimizer's state.
    Stateful, so it rides ``DistributedOptimizer(compression=
    Compression.powersgd(r), error_feedback=True)`` only. The other
    leaves fall back to the int8 wire; ``compress``/``decompress`` are
    that fallback's roundtrip."""

    #: the optimizer factorizes; the other leaves ride the int8 wire
    factorized = True
    quantized = True
    block = INT8_BLOCK
    fallback = Int8Compressor

    def __init__(self, rank: int = 4):
        if rank < 1:
            raise ValueError(f"PowerSGD rank must be >= 1, got {rank}")
        self.rank = int(rank)

    def effective_rank(self, shape) -> int:
        return min(self.rank, int(shape[0]), _numel(shape[1:]))

    def factorizes(self, shape, dtype) -> bool:
        """Factorize only where the factors cost less wire than the leaf:
        ``(d0 + m) * r < d0 * m``."""
        if len(shape) < 2 or not _quantizable(dtype):
            return False
        r = self.effective_rank(shape)
        d0, m = int(shape[0]), _numel(shape[1:])
        return r >= 1 and (d0 + m) * r < d0 * m

    def compress(self, tensor):
        return Int8Compressor.compress(tensor)

    def decompress(self, tensor, ctx):
        return Int8Compressor.decompress(tensor, ctx)

    def wire_bytes(self, shape, dtype) -> int:
        if not self.factorizes(shape, dtype):
            return Int8Compressor.wire_bytes(shape, dtype)
        d0, m = int(shape[0]), _numel(shape[1:])
        return (d0 + m) * self.effective_rank(shape) * 4   # f32 P and Q

    def __repr__(self):
        return f"PowerSGD(rank={self.rank})"


class Compression:
    """``hvd.Compression``: ``none``, ``fp16``, ``int8`` and
    ``powersgd(r)``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    int8 = Int8Compressor

    @staticmethod
    def powersgd(rank: int = None) -> PowerSGDCompressor:
        """Rank-``r`` PowerSGD (default ``HOROVOD_POWERSGD_RANK``, else
        4)."""
        if rank is None:
            rank = int(os.environ.get("HOROVOD_POWERSGD_RANK", "4"))
        return PowerSGDCompressor(rank)

    @staticmethod
    def from_env(default=NoneCompressor):
        """The compressor ``HOROVOD_COMPRESSION`` names
        (``none|off|0``, ``fp16|bf16|16bit``, ``int8``, ``powersgd``);
        ``default`` when it is unset."""
        name = os.environ.get("HOROVOD_COMPRESSION", "").strip().lower()
        if not name:
            return default
        if name in ("none", "off", "0"):
            return NoneCompressor
        if name in ("fp16", "bf16", "16bit"):
            return FP16Compressor
        if name == "int8":
            return Int8Compressor
        if name == "powersgd":
            return Compression.powersgd()
        raise ValueError(
            f"HOROVOD_COMPRESSION={name!r}: expected one of "
            "none|fp16|int8|powersgd")
