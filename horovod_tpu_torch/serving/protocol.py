"""Wire protocol for streaming weight publication (training → serving).

Counterpart of ``horovod_tpu/serving/protocol.py``, and wire-compatible
with it: the payload is the same pickle of records, so a subscriber of
either package reads a publication of the other.

A published **generation** is one tree of weights, either a full-precision
**keyframe** or an int8-compressed **delta** against the previous
generation's *reconstruction*. The publisher tracks exactly what a
subscriber that decoded every generation holds (``decode(encode(...))``
of its own payload), and each delta is measured against THAT, so
quantization error never accumulates across generations: it is
re-measured and folded into the next delta. A subscriber's tree is
therefore bit-identical to the publisher's reconstruction, and within one
blockwise-int8 quantization error of the trainer's weights.

On the KV the layout is commit-last:

- ``/<scope>/chunks/<gen>/<i>``: the payload split into bounded blobs;
- ``/<scope>/manifest/<gen>``: JSON: generation, step, kind,
  base/keyframe generation, per-chunk CRC32s, payload CRC, elastic
  generation fence;
- ``/<scope>/head``: the newest *committed* generation, written only
  after every chunk and the manifest have landed.

A reader that starts from ``head`` never observes a torn generation.
:class:`ChainError` is the subscriber's single resync trigger (gap, GC'd
manifest, CRC mismatch, base mismatch).

The payload: ``{"v", "kind", "block", "treedef", "records"}`` pickled,
``treedef`` JAX's treedef written and read through
:mod:`horovod_tpu_torch.pytree` (the checkpoints' stand-in), every array
leaf a numpy array of the JAX package's flax-path tree
(``models.convert.flax_params``). A bf16 array is its two bytes a value
(``V2`` on the host, as the checkpoints hold it) and is written under
``ml_dtypes``' ``bfloat16`` name, which is how the JAX package pickles
its bf16 arrays, and read back as ``V2`` (this side imports no
``ml_dtypes``).

Quantization is the collective wire's format
(:func:`horovod_tpu_torch.compression.quantize_blockwise`: one bf16
max-abs scale per 256-element block), decided per leaf by
:meth:`~horovod_tpu_torch.compression.Int8Compressor.quantizes`. The
encoder writes the quantizable deltas of one dtype end to end into one
host buffer, each padded to whole blocks (so no block spans two leaves),
moves it to the publisher's device in one copy and quantizes it in one
call (on a CUDA device one ``quantize`` launch); each leaf's q and
scales are its slices of the result, the bits a per-leaf quantize
gives. Leaves below the floor and non-float leaves ride raw, as on the
collective wire.
"""

from __future__ import annotations

import io
import json
import pickle
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import pytree
from horovod_tpu_torch.compression import (
    INT8_BLOCK,
    Int8Compressor,
    dequantize_blockwise,
    quantize_blockwise,
)

FORMAT_VERSION = 1

#: payload chunk size on the KV (env ``HOROVOD_PUBLISH_CHUNK_BYTES``)
DEFAULT_CHUNK_BYTES = 1 << 20


class ChainError(RuntimeError):
    """The generation chain cannot be applied from here: a manifest is
    missing or GC-tombstoned, a chunk failed its CRC, or a delta's base
    does not match the subscriber's generation. The remedy is always the
    same: resync from the chain's keyframe."""


def head_key(scope: str) -> str:
    return f"/{scope}/head"


def manifest_key(scope: str, generation: int) -> str:
    return f"/{scope}/manifest/{generation}"


def chunk_key(scope: str, generation: int, index: int) -> str:
    return f"/{scope}/chunks/{generation}/{index}"


def crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class _MlDtypesBfloat16:
    """Pickles as ``ml_dtypes.bfloat16``, the scalar type of the JAX
    package's bf16 numpy dtype."""

    _jax_global = ("ml_dtypes", "bfloat16")


#: the state numpy's ``dtype.__reduce__`` gives ``ml_dtypes``' bfloat16
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


def _is_bf16_bits(dtype) -> bool:
    return dtype.kind == "V" and dtype.itemsize == 2 and dtype.fields is None


class _WirePickler(pytree.Pickler):
    """The pytree pickler, with a ``V2`` dtype written as the JAX
    package's bf16 dtype."""

    def reducer_override(self, obj):
        if isinstance(obj, np.dtype) and _is_bf16_bits(obj):
            return (np.dtype, (_MlDtypesBfloat16, False, True),
                    _BF16_DTYPE_STATE)
        return NotImplemented


class _WireUnpickler(pytree.Unpickler):
    """The pytree unpickler, with the JAX package's bf16 dtype read as
    ``V2``."""

    def find_class(self, module, name):
        if (module, name) == _MlDtypesBfloat16._jax_global:
            return "V2"   # np.dtype("V2", False, True)
        return super().find_class(module, name)


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _WirePickler(buf, pickle.DEFAULT_PROTOCOL).dump(obj)
    return buf.getvalue()


def _loads(payload: bytes):
    return _WireUnpickler(io.BytesIO(payload)).load()


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, torch.Tensor))


def _host(x) -> np.ndarray:
    """A host numpy view of an array leaf (a copy for a tensor)."""
    if isinstance(x, torch.Tensor):
        from horovod_tpu_torch.training import host_array

        return host_array(x)
    return np.asarray(x)


def _torch_dtype(dtype: np.dtype):
    """The torch dtype of a numpy dtype (``V2`` is bf16)."""
    if _is_bf16_bits(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _tensor(a, device) -> torch.Tensor:
    """A host array (``V2`` as bf16) or a tensor, on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if _is_bf16_bits(a.dtype):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _device(device):
    """None/False: the host path; True: the default device
    (:func:`horovod_tpu_torch.basics.default_device`); else that device."""
    if device is None or device is False:
        return None
    from horovod_tpu_torch.basics import default_device

    return default_device(None if device is True else device)


def _quantizes(arr) -> bool:
    """Would this delta leaf ride the int8 wire (the compressor's floor
    decision, on the leaf's torch dtype)?"""
    return Int8Compressor.quantizes(tuple(arr.shape), _torch_dtype(arr.dtype))


def encode(tree: Any, base: Optional[Any] = None, *,
           block: int = INT8_BLOCK, device=None) -> Tuple[bytes, dict]:
    """Serialize ``tree`` as one payload blob.

    With ``base=None`` this is a keyframe: every array leaf rides raw at
    full precision. With a ``base`` (the previous generation's
    reconstruction, same treedef) each quantizable leaf's *delta* is
    blockwise-int8 quantized on ``device`` (by default this process's
    device, else ``cuda:0``: one ``quantize`` launch a dtype over every
    such delta, see the module docstring; a CPU device takes its plain
    version), the others ride their raw delta, non-array leaves as
    objects. The delta is taken on the host, in the leaf's dtype, as the
    JAX package takes it. Returns ``(payload, info)``:
    ``info["wire_bytes"]`` counts the array bytes on the wire,
    ``info["kind"]`` is ``"key"``/``"delta"``, ``info["quantized"]`` the
    leaves quantized."""
    leaves, treedef = pytree.flatten(tree)
    base_leaves = None
    if base is not None:
        base_leaves, base_def = pytree.flatten(base)
        if base_def != treedef:
            raise ValueError(
                "delta base treedef does not match the published tree")
    records: List[Any] = []
    wire = 0
    finite = True  # float leaves of the ENCODED tree (keyframe path)
    quant: dict = {}  # dtype -> [(record index, leaf, its base)]
    for i, leaf in enumerate(leaves):
        if not _is_array(leaf):
            records.append(("obj", leaf))
            continue
        arr = _host(leaf)
        if base_leaves is None:
            if arr.dtype.kind == "f" and finite \
                    and not np.isfinite(arr).all():
                finite = False
            records.append(("raw", arr))
            wire += arr.nbytes
            continue
        if arr.dtype.kind not in "fiu":
            # bool masks, bf16 bits and other non-subtractable dtypes ride
            # as the full value inside a delta
            records.append(("full", arr))
            wire += arr.nbytes
            continue
        base_arr = np.asarray(_host(base_leaves[i]), dtype=arr.dtype)
        if _quantizes(arr):
            quant.setdefault(arr.dtype, []).append((len(records), arr,
                                                    base_arr))
            records.append(None)  # filled below
        else:
            delta = arr - base_arr
            records.append(("raw", delta))
            wire += delta.nbytes
    if quant:
        dev = _device(True if device is None else device)
        for dtype, items in quant.items():
            for (j, arr, _), (q, scales) in zip(
                    items, _quantize_deltas(dtype, items, block, dev)):
                records[j] = ("q", q, scales, tuple(arr.shape), dtype.str)
                wire += q.size + scales.size * 2  # int8 values + bf16 scales
    kind = "key" if base is None else "delta"
    payload = _dumps({
        "v": FORMAT_VERSION,
        "kind": kind,
        "block": block,
        "treedef": treedef,
        "records": records,
    })
    info = {"kind": kind, "wire_bytes": wire, "leaves": len(leaves),
            "quantized": sum(map(len, quant.values()))}
    if base is None:
        # keyframe: the encoded tree IS the publisher's reconstruction;
        # its finiteness is recorded here so the publisher's poisoned-base
        # check needs no second pass
        info["finite"] = finite
    return payload, info


def _quantize_deltas(dtype, items, block: int, dev) -> list:
    """The deltas ``leaf - base`` of ``items`` (one dtype), each written
    into its place in one host buffer padded to whole blocks, quantized
    by one call on ``dev``: each leaf's ``(q, scales)``, host slices of
    the one result."""
    sizes = [arr.size + (-arr.size) % block for _, arr, _ in items]
    offs = np.cumsum([0] + sizes)
    buf = np.zeros(int(offs[-1]), dtype)
    for (_, arr, base_arr), o in zip(items, offs):
        np.subtract(arr, base_arr, out=buf[o:o + arr.size].reshape(arr.shape))
    q, scales = quantize_blockwise(torch.from_numpy(buf).to(dev), block)
    q, scales = _host(q), _host(scales)
    return [(q[o:o + n], scales[o // block:(o + n) // block])
            for o, n in zip(offs, sizes)]


def decode(payload: bytes, base: Optional[Any] = None, *,
           device=None) -> Any:
    """Inverse of :func:`encode`: payload (+ ``base`` for deltas) → tree.

    ``device`` None (the host path): owned numpy leaves; the publisher
    runs this over its own payload to track the subscriber view.
    ``device=True`` (this process's device) or a device: the serving
    engine's ingest. An int8 delta leaf goes to the device in its wire
    form (int8 values, bf16 scales) and is dequantized and added to its
    base there, so a generation update never round-trips an f32 copy
    through host memory; leaves come back as tensors. The values are
    bit-identical to the host path (the same elementwise IEEE f32
    operations)."""
    dev = _device(device)
    d = _loads(payload)
    if d.get("v") != FORMAT_VERSION:
        raise ChainError(f"unknown payload format version {d.get('v')!r}")
    block = d["block"]
    base_leaves = None
    if d["kind"] == "delta":
        if base is None:
            raise ChainError("delta payload decoded without a base tree")
        base_leaves = pytree.flatten(base)[0]
    leaves = []
    for i, rec in enumerate(d["records"]):
        tag = rec[0]
        if tag == "obj":
            leaves.append(rec[1])
            continue
        if tag == "full":  # full value inside a delta: no base addition
            leaves.append(_own(rec[1], dev))
            continue
        if tag == "raw":
            val = rec[1] if dev is None else _tensor(rec[1], dev)
        else:  # ("q", q, scales, shape, dtype)
            _, q, scales, shape, dtype = rec
            size = int(np.prod(shape, dtype=np.int64))
            tdt = _torch_dtype(np.dtype(dtype))
            flat = dequantize_blockwise(
                _tensor(q, dev or "cpu"), _tensor(scales, dev or "cpu"),
                tdt, block)
            val = flat[:size].reshape(tuple(shape))
            if dev is None:
                val = val.numpy()
        if base_leaves is not None:
            if dev is None:
                val = np.asarray(_host(base_leaves[i]), dtype=val.dtype) + val
            else:
                val = _tensor(base_leaves[i], dev).to(val.dtype) + val
        leaves.append(_own(val, dev))
    return pytree.unflatten(d["treedef"], leaves)


def _own(val, dev):
    """An owned leaf: a numpy copy on the host path, a device tensor on
    the engine's."""
    if dev is not None:
        return _tensor(val, dev)
    return np.array(val)


def split_chunks(payload: bytes, chunk_bytes: int) -> List[bytes]:
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    return [
        payload[i:i + chunk_bytes]
        for i in range(0, len(payload), chunk_bytes)
    ] or [b""]


def build_manifest(*, generation: int, step: int, kind: str,
                   keyframe: int, chunks: List[bytes], payload: bytes,
                   wire_bytes: int, elastic_generation: Optional[int],
                   published_at: float, chain: str = "") -> bytes:
    """The commit record for one generation (JSON; values a subscriber in
    another language could parse — only the payload itself is pickled).

    `chain` is the publisher instance's unique token: generation numbers
    alone cannot identify a delta's base across a trainer restart (a fresh
    publisher re-uses numbers over the same KV), so a delta is applicable
    only when BOTH its base generation and its chain match what the
    subscriber holds — any chain change is a resync trigger."""
    return json.dumps({
        "version": FORMAT_VERSION,
        "generation": generation,
        "step": step,
        "kind": kind,
        "base": generation - 1 if kind == "delta" else None,
        "keyframe": keyframe,
        "chain": chain,
        "chunks": len(chunks),
        "chunk_crc": [crc(c) for c in chunks],
        "payload_bytes": len(payload),
        "payload_crc": crc(payload),
        "wire_bytes": wire_bytes,
        "elastic_generation": elastic_generation,
        "time": published_at,
    }).encode()


def parse_manifest(blob: bytes) -> dict:
    """Parse AND structurally validate a manifest. Every malformed shape
    raises :class:`ChainError` here — the subscriber's poll() catches only
    that, so a corrupt manifest (the one record no CRC protects) must
    never escape as a TypeError/KeyError and crash a serving process."""
    try:
        m = json.loads(blob)
    except ValueError as e:
        raise ChainError(f"unparseable manifest: {e}") from None
    if not isinstance(m, dict):
        raise ChainError(f"manifest is {type(m).__name__}, not an object")
    if m.get("version") != FORMAT_VERSION:
        raise ChainError(f"unknown manifest version {m.get('version')!r}")
    try:
        gen = int(m["generation"])
        kf = int(m["keyframe"])
        chunks = int(m["chunks"])
        crcs = m["chunk_crc"]
        int(m["payload_bytes"])
        int(m["payload_crc"])
        kind = m["kind"]
    except (KeyError, TypeError, ValueError) as e:
        raise ChainError(f"malformed manifest field: {e!r}") from None
    if kind not in ("key", "delta"):
        raise ChainError(f"unknown manifest kind {kind!r}")
    if not (1 <= kf <= gen):
        raise ChainError(f"keyframe {kf} outside [1, {gen}]")
    if kind == "delta" and m.get("base") != gen - 1:
        raise ChainError(f"delta {gen} with base {m.get('base')!r}")
    if chunks < 1 or not isinstance(crcs, list) or len(crcs) != chunks:
        raise ChainError(
            f"chunk table mismatch: {chunks} chunks, "
            f"{len(crcs) if isinstance(crcs, list) else 'no'} CRCs")
    return m
