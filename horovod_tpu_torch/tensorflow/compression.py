"""Gradient compression for TensorFlow tensors (counterpart of
``horovod_tpu/tensorflow/compression.py``, reference
``horovod/tensorflow/compression.py``): cast floats to 16 bits before the
collective, cast back after. As in the JAX package, the 16-bit wire type
is bfloat16 (the same two bytes as the reference's float16, no overflow
scaling), a quirk the port keeps so that both packages put the same
values on the wire.

TensorFlow is imported here when it can be; without it (not installed,
or its ``ml_dtypes`` dependency missing) the module still imports and
the compressors raise on use."""

from __future__ import annotations

try:
    import tensorflow as tf
except ImportError:  # the TensorFlow frontend is gated on its install
    tf = None


def require_tf():
    """TensorFlow, or an ``ImportError`` naming what needs it."""
    if tf is None:
        raise ImportError(
            "horovod_tpu_torch.tensorflow needs TensorFlow (and its "
            "ml_dtypes), which this interpreter cannot import")
    return tf


class Compressor:
    """Interface for compressing and decompressing a given tensor
    (reference ``tensorflow/compression.py:22-33``)."""

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Compress floating-point gradients to 16 bits for the collective
    (reference ``tensorflow/compression.py:45-65``); bfloat16 on the
    wire, as in the JAX package."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating:
            return require_tf().cast(tensor, tf.bfloat16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return require_tf().cast(tensor, ctx) if ctx is not None else tensor


class Compression:
    """Optional gradient compression algorithms used during allreduce
    (reference ``tensorflow/compression.py:68-75``)."""

    none = NoneCompressor
    fp16 = FP16Compressor
