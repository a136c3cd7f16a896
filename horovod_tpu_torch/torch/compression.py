"""Gradient compression for the PyTorch frontend (counterpart of
``horovod_tpu/torch/compression.py``, reference
``horovod/torch/compression.py:20-73``): compress before the collective,
decompress after. ``Compression.fp16`` puts IEEE float16 on the wire and
halves its bytes."""

import torch


class Compressor:
    """Interface (reference ``torch/compression.py:20-30``)."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity (reference ``torch/compression.py:33-43``)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast floating tensors to float16 for the wire, back to their own
    type after (reference ``torch/compression.py:46-63``)."""

    @staticmethod
    def compress(tensor):
        ctx = tensor.dtype
        if tensor.dtype.is_floating_point:
            tensor = tensor.to(torch.float16)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and ctx.is_floating_point and tensor.dtype != ctx:
            tensor = tensor.to(ctx)
        return tensor


class Compression:
    """Selector namespace (reference ``torch/compression.py:66-73``)."""

    none = NoneCompressor
    fp16 = FP16Compressor
