"""Hand-written Hopper kernels of the int8 wire, the fused Adam update,
the flash-attention forward and the Adasum combine, each beside its plain
PyTorch version.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py`` and of the Pallas
forward of ``horovod_tpu/ops/flash_attention.py``. Every public
function here dispatches on where its tensors live:

- a CUDA tensor launches the CUDA kernel (``csrc/*.cu``, built at first
  use by :mod:`._build`). If the kernel cannot be built or launched, the
  call raises; nothing falls back to the plain version.
- a CPU tensor runs the plain PyTorch version, which repeats the
  reference's discrete expressions one operation at a time (the CPU
  tests hold it against the JAX package; ``chip_smoke.py`` holds each
  kernel against it on the card).

Kernels (``launches`` counts each wrapper's kernel launches, and only
those):

- ``quantize`` — blockwise int8 quantize, optionally also emitting the
  dequantized wire image (:func:`quantize_blockwise`,
  :func:`quantize_roundtrip`);
- ``dequant_accumulate`` — the reduce-scatter epilogue;
- ``dequant_accumulate_requantize`` — the allreduce epilogue;
- ``fused_adam`` — :func:`fused_adam_update`;
- ``flash_fwd`` — :func:`flash_fwd`, attention's forward with its
  log-sum-exp rows;
- ``dequantize_rows`` — the ZeRO-3 int8 parameter-gather epilogue;
- ``adasum_pair_combine`` / ``adasum_segment_combine`` — one Adasum
  combine of a tensor pair, or of every segment of a flat group buffer
  (three CUDA launches, one count: reduce, finalize, blend).

The plain versions divide by tensors, never by Python numbers: PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which is not
the reference's rounding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

INT8_BLOCK = 256  # the block the CUDA kernels are compiled for

KERNELS = ("quantize", "dequant_accumulate", "dequant_accumulate_requantize",
           "fused_adam", "flash_fwd", "dequantize_rows", "adasum_pair_combine",
           "adasum_segment_combine")
#: head dims the flash_fwd kernel is compiled for
FLASH_HEAD_DIMS = (64, 128)

#: elements per block of the Adasum reduce and blend passes
ADASUM_CHUNK = 8192
#: operand types of the Adasum kernel, by the code it is passed
_ADASUM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_ARGTYPES = {
    "hvd_quantize": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "hvd_dequant_accumulate": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "hvd_dequant_accumulate_requantize": [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P],
    "hvd_fused_adam": [_P] * 6 + [ctypes.c_longlong] + [ctypes.c_float] * 9
    + [ctypes.c_int, _P],
    "hvd_flash_fwd": [_P] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    "hvd_dequantize_rows": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "hvd_adasum_combine": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, _P, _P, _P, ctypes.c_int,
                           ctypes.c_longlong, _P, _P, _P],
}
_fns: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn(lib: str, sym: str):
    f = _fns.get(sym)
    if f is None:
        from horovod_tpu_torch.ops import _build

        f = getattr(_build.library(lib), sym)
        f.argtypes = _ARGTYPES[sym]
        f.restype = ctypes.c_int
        _fns[sym] = f
    return f


def _launch(kernel: str, lib: str, sym: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _fn(lib, sym)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{sym} launch failed: cudaError {rc}")
    launches[kernel] += 1


def _on_cuda(*ts) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else raises."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def _need(t, dtype, name, ndim):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _need_block(block: int):
    if block != INT8_BLOCK:
        raise ValueError(
            f"the CUDA kernels are built for block {INT8_BLOCK}, got {block}")


def _f32_scalar(x, like):
    """A 0-d f32 tensor on ``like``'s device (true division, see module
    docstring)."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=like.device)


# --------------------------------------------------------------------------
# blockwise int8 quantize (+ roundtrip image)


def quantize_plain(flat, block: int = INT8_BLOCK, roundtrip: bool = False):
    """The reference's discrete quantize: ``(q, scales[, deq])``. A NaN
    in a block makes its scale NaN and its q 0; an infinity makes the
    scale inf, and the NaN quotient inf / inf becomes q 0, as XLA's
    float-to-int cast makes it (spelled out here: a NaN cast to int8 is
    undefined in C++)."""
    m = flat.reshape(-1, block)
    amax = m.abs().amax(dim=1, keepdim=True)
    sc = (amax / _f32_scalar(127.0, m)).to(torch.bfloat16)
    sf = sc.to(m.dtype)
    pos = sf > 0
    q = torch.where(pos, m / torch.where(pos, sf, torch.ones_like(sf)),
                    torch.zeros_like(m))
    q = torch.nan_to_num(torch.round(q), nan=0.0)
    qi = torch.clamp(q, -127, 127).to(torch.int8)
    out = (qi.reshape(-1), sc.reshape(-1))
    if roundtrip:
        out += ((qi.to(m.dtype) * sf).reshape(-1),)
    return out


def _quantize(flat, block: int, roundtrip: bool):
    if not _on_cuda(flat):
        return quantize_plain(flat, block, roundtrip)
    _need_block(block)
    _need(flat, torch.float32, "flat", 1)
    L = flat.shape[0]
    if L % block:
        raise ValueError(f"length {L} is not a multiple of block {block}")
    q = torch.empty(L, dtype=torch.int8, device=flat.device)
    s = torch.empty(L // block, dtype=torch.bfloat16, device=flat.device)
    d = torch.empty_like(flat) if roundtrip else None
    if L:
        _launch("quantize", "int8_wire", "hvd_quantize", flat.device,
                flat.data_ptr(), q.data_ptr(), s.data_ptr(),
                d.data_ptr() if roundtrip else None, L)
    return (q, s, d) if roundtrip else (q, s)


def quantize_blockwise(flat, block: int = INT8_BLOCK):
    """Blockwise int8 quantize of a flat f32 vector whose length is a
    multiple of ``block``: ``(q int8 [L], scales bf16 [L/block])``."""
    return _quantize(flat, block, False)


def quantize_roundtrip(flat, block: int = INT8_BLOCK):
    """As :func:`quantize_blockwise`, also emitting the dequantized wire
    image ``q * scale`` from the same pass: ``(q, scales, deq [L])``."""
    return _quantize(flat, block, True)


# --------------------------------------------------------------------------
# post-all_to_all epilogues


def dequant_accumulate_plain(qr, scr, dtype=torch.float32,
                             block: int = INT8_BLOCK):
    n, sp = qr.shape
    deq = (qr.to(dtype).reshape(n, sp // block, block)
           * scr.to(dtype)[:, :, None]).reshape(n, sp)
    acc = torch.zeros(sp, dtype=dtype, device=qr.device)
    for r in range(n):  # sender order, from zero, as deq.sum(axis=0)
        acc = acc + deq[r]
    return acc


def _check_wire(qr, scr, block):
    _need_block(block)
    _need(qr, torch.int8, "qr", 2)
    _need(scr, torch.bfloat16, "scr", 2)
    n, sp = qr.shape
    if sp % block or tuple(scr.shape) != (n, sp // block):
        raise ValueError(
            f"wire image shapes {tuple(qr.shape)}/{tuple(scr.shape)} do not "
            f"match block {block}")
    return n, sp


def dequant_accumulate(qr, scr, dtype=torch.float32, block: int = INT8_BLOCK):
    """Reduce-scatter epilogue: dequantize the N senders' int8 rows
    ``qr [N, sp]`` with their bf16 scales ``scr [N, sp/block]`` and sum
    them in sender order in f32 → ``[sp]``."""
    if not _on_cuda(qr, scr):
        return dequant_accumulate_plain(qr, scr, dtype, block)
    if dtype != torch.float32:
        raise TypeError(f"the CUDA kernel accumulates in float32, not {dtype}")
    n, sp = _check_wire(qr, scr, block)
    out = torch.empty(sp, dtype=torch.float32, device=qr.device)
    if sp:
        _launch("dequant_accumulate", "int8_wire", "hvd_dequant_accumulate",
                qr.device, qr.data_ptr(), scr.data_ptr(), out.data_ptr(), n, sp)
    return out


def dequant_accumulate_requantize_plain(qr, scr, dtype=torch.float32,
                                        block: int = INT8_BLOCK, divisor=None):
    acc = dequant_accumulate_plain(qr, scr, dtype, block)
    if divisor is not None:
        acc = acc / _f32_scalar(divisor, acc)
    return quantize_plain(acc, block)


def dequant_accumulate_requantize(qr, scr, dtype=torch.float32,
                                  block: int = INT8_BLOCK, divisor=None):
    """Allreduce epilogue: as :func:`dequant_accumulate`, then divide by
    ``divisor`` (Average), then requantize blockwise → ``(q2 int8 [sp],
    scales2 bf16 [sp/block])``."""
    if not _on_cuda(qr, scr):
        return dequant_accumulate_requantize_plain(qr, scr, dtype, block,
                                                   divisor)
    if dtype != torch.float32:
        raise TypeError(f"the CUDA kernel accumulates in float32, not {dtype}")
    n, sp = _check_wire(qr, scr, block)
    if divisor is not None and int(divisor) < 1:
        raise ValueError(f"divisor must be a positive integer, got {divisor}")
    q2 = torch.empty(sp, dtype=torch.int8, device=qr.device)
    s2 = torch.empty(sp // block, dtype=torch.bfloat16, device=qr.device)
    if sp:
        _launch("dequant_accumulate_requantize", "int8_wire",
                "hvd_dequant_accumulate_requantize", qr.device,
                qr.data_ptr(), scr.data_ptr(), q2.data_ptr(), s2.data_ptr(),
                n, sp, int(divisor or 0))
    return q2, s2


# --------------------------------------------------------------------------
# fused Adam


def adam_constants(lr, b1, b2, eps, eps_root, count: int) -> dict:
    """The f32 scalars of one Adam step, as JAX forms them: the Python
    doubles ``1-b1``, ``1-b2``, ``-lr`` cast to f32, and the bias
    corrections ``1 - b**count`` in f32. XLA's f32 ``pow`` is correctly
    rounded, so ``b**count`` is taken in double and rounded once; the
    subtraction from 1 then cancels most digits, which is why a ``pow``
    one f32 ULP off would move the update by far more than one ULP."""
    f = np.float32

    def bias_correction(b):
        return float(f(1.0) - f(float(f(b)) ** count))

    return dict(
        omb1=float(f(1.0 - b1)), b1=float(f(b1)),
        omb2=float(f(1.0 - b2)), b2=float(f(b2)),
        b1c=bias_correction(b1), b2c=bias_correction(b2),
        eps=float(f(eps)), eps_root=float(f(eps_root)), neg_lr=float(f(-lr)),
    )


def fused_adam_plain(g, mu, nu, c: dict):
    t = lambda x: _f32_scalar(x, g)  # noqa: E731
    mu2 = c["omb1"] * g + c["b1"] * mu
    nu2 = c["omb2"] * (g * g) + c["b2"] * nu
    # the square root is taken in f64 and rounded once: PyTorch's
    # vectorized CPU f32 sqrt is not correctly rounded (XLA's and CUDA's
    # are), and a rounding of f64 sqrt to f32 is exact-rounded
    root = torch.sqrt((nu2 / t(c["b2c"]) + c["eps_root"]).double()).float()
    u = c["neg_lr"] * ((mu2 / t(c["b1c"])) / (root + c["eps"]))
    return u, mu2, nu2


def fused_adam_update(g, mu, nu, count: int, *, lr, b1=0.9, b2=0.999,
                      eps=1e-8, eps_root=0.0):
    """One Adam step over a flat f32 shard, bias corrections taken at step
    ``count`` (the incremented count): ``(update, mu', nu')`` in optax's
    ``scale_by_adam -> scale(-lr)`` order."""
    c = adam_constants(lr, b1, b2, eps, eps_root, count)
    if not _on_cuda(g, mu, nu):
        return fused_adam_plain(g, mu, nu, c)
    for name, x in (("g", g), ("mu", mu), ("nu", nu)):
        if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D float32 tensor")
    L = g.shape[0]
    if mu.shape[0] != L or nu.shape[0] != L:
        raise ValueError("g, mu and nu must have the same length")
    u, mu2, nu2 = (torch.empty_like(g) for _ in range(3))
    vec = int(all(x.data_ptr() % 16 == 0 for x in (g, mu, nu, u, mu2, nu2)))
    if L:
        _launch("fused_adam", "fused_adam", "hvd_fused_adam", g.device,
                g.data_ptr(), mu.data_ptr(), nu.data_ptr(), u.data_ptr(),
                mu2.data_ptr(), nu2.data_ptr(), L,
                c["omb1"], c["b1"], c["omb2"], c["b2"], c["b1c"], c["b2c"],
                c["eps"], c["eps_root"], c["neg_lr"], vec)
    return u, mu2, nu2


# --------------------------------------------------------------------------
# flash-attention forward


def flash_fwd_plain(q, k, v, *, causal: bool, sm_scale: float,
                    block_k: int = 128):
    """The reference's scan forward: ``(out [B, Tq, H, D] in q's dtype,
    lse [B, H, Tq] f32)``, K/V broadcast over the query groups."""
    from horovod_tpu_torch.ops import flash_attention as fa

    g = fa.gqa_group(q, k)
    m, l, acc = fa._attention_scan(
        q, fa.rep_group(k, g), fa.rep_group(v, g), causal=causal,
        sm_scale=sm_scale, q_offset=0, kv_offset=0, block_k=block_k)
    return fa._finalize(m, l, acc, q.dtype), fa.lse_from_state(m, l)


def flash_fwd(q, k, v, *, causal: bool = False, sm_scale=None,
              block_k: int = 128):
    """Attention forward over ``q [B, Tq, H, D]``, ``k``/``v``
    ``[B, Tk, H_kv, D]`` (``H % H_kv == 0``): ``(out [B, Tq, H, D],
    lse [B, H, Tq] f32)``. The kernel takes bf16 (or f32) inputs of head
    dim 64 or 128 with a contiguous last dim, any other strides, and
    tiles by its own 64-row blocks; ``block_k`` is the plain version's
    K blocking."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not _on_cuda(q, k, v):
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_k=block_k)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q: expected bfloat16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {x.dtype} != q's {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name}: expected [B, T, H, D], got "
                             f"{tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    b, t_q, h, d = q.shape
    t_k, h_kv = k.shape[1], k.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash_fwd kernel is built for head dims "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if h % h_kv:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads "
                         f"({h_kv})")
    if min(b, t_q, t_k) < 1 or b * h > 65535:
        raise ValueError(f"flash_fwd: unsupported sizes B={b} H={h} "
                         f"Tq={t_q} Tk={t_k}")
    out = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v) for s in (x.stride(0), x.stride(1),
                                               x.stride(2))]
    _launch("flash_fwd", "flash_attention", "hvd_flash_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, h_kv, t_q, t_k, d, *strides,
            float(sm_scale), int(bool(causal)), int(q.dtype == torch.bfloat16))
    return out, lse


# --------------------------------------------------------------------------
# per-row dequantize (the ZeRO-3 int8 parameter gather)


def dequantize_rows_plain(qr, scr, dtype=torch.float32,
                          block: int = INT8_BLOCK):
    n, sp = qr.shape
    return (qr.to(dtype).reshape(n, sp // block, block)
            * scr.to(dtype)[:, :, None]).reshape(n, sp)


def dequantize_rows(qr, scr, dtype=torch.float32, block: int = INT8_BLOCK):
    """All-gather epilogue of the int8 parameter gather: the N gathered
    int8 rows ``qr [N, sp]`` times their bf16 scales ``scr [N, sp/block]``
    → ``[N, sp]`` in ``dtype``, row by row, with no accumulation (each row
    is another rank's shard). The product is exact in f32, so the kernel
    is bit-equal to the plain version."""
    if not _on_cuda(qr, scr):
        return dequantize_rows_plain(qr, scr, dtype, block)
    if dtype != torch.float32:
        raise TypeError(f"the CUDA kernel dequantizes to float32, not {dtype}")
    n, sp = _check_wire(qr, scr, block)
    out = torch.empty((n, sp), dtype=torch.float32, device=qr.device)
    if n * sp:
        _launch("dequantize_rows", "int8_wire", "hvd_dequantize_rows",
                qr.device, qr.data_ptr(), scr.data_ptr(), out.data_ptr(), n, sp)
    return out


# --------------------------------------------------------------------------
# Adasum pairwise combine


def _adasum_coefficients(dot, na, nb):
    """The reference's ``where(n == 0, 0, 1 - dot / (2 max(n, 1e-30)))``
    for ``a`` and ``b``, in f32."""
    floor = torch.tensor(1e-30, dtype=torch.float32, device=dot.device)

    def one(n):
        return torch.where(n == 0, torch.zeros_like(n),
                           1.0 - dot / (2.0 * torch.maximum(n, floor)))

    return one(na), one(nb)


def adasum_pair_combine_plain(a, b):
    af, bf = a.reshape(-1).float(), b.reshape(-1).float()
    ca, cb = _adasum_coefficients((af * bf).sum(), (af * af).sum(),
                                  (bf * bf).sum())
    return (ca * af + cb * bf).to(a.dtype).reshape(a.shape)


def adasum_segment_combine_plain(a, b, offsets):
    offs = [int(o) for o in offsets]
    prods = torch.stack([a * b, a * a, b * b])
    sums = torch.stack([prods[:, lo:hi].sum(dim=1)
                        for lo, hi in zip(offs, offs[1:])], dim=1)
    ca, cb = _adasum_coefficients(*sums)
    lengths = torch.tensor(np.diff(offs), device=a.device)
    return (torch.repeat_interleave(ca, lengths) * a
            + torch.repeat_interleave(cb, lengths) * b)


@functools.lru_cache(maxsize=8)
def _segment_tables(offsets: tuple, device: str):
    """Device tables of a segment layout, built once per layout (a
    model's gradient group): element offsets int64 ``[S+1]``, each
    chunk's segment int32 ``[n_chunks]``, each segment's first chunk
    int32 ``[S+1]`` (chunks of at most :data:`ADASUM_CHUNK` elements,
    never straddling a segment), and ``n_chunks``."""
    sizes = np.diff(np.asarray(offsets, np.int64))
    per = -(-sizes // ADASUM_CHUNK)
    first = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    chunk_seg = np.repeat(np.arange(len(sizes), dtype=np.int32), per)
    return (torch.tensor(offsets, dtype=torch.int64, device=device),
            torch.from_numpy(chunk_seg).to(device),
            torch.from_numpy(first).to(device), int(first[-1]))


def _adasum_launch(kernel, a, b, tables):
    """Launch the three passes over contiguous ``a``, ``b`` of one shape
    and type: ``tables`` None for one segment, else
    :func:`_segment_tables`."""
    for name, x in (("a", a), ("b", b)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    out = torch.empty_like(a)
    L = a.numel()
    if not L:
        return out
    if tables is None:
        n_seg, n_chunks, ptrs = 1, -(-L // ADASUM_CHUNK), (None, None, None)
    else:
        seg_off, chunk_seg, first, n_chunks = tables
        n_seg = seg_off.numel() - 1
        ptrs = (seg_off.data_ptr(), chunk_seg.data_ptr(), first.data_ptr())
    partials = torch.empty(3 * n_chunks, dtype=torch.float32, device=a.device)
    coef = torch.empty(2 * n_seg, dtype=torch.float32, device=a.device)
    _launch(kernel, "adasum", "hvd_adasum_combine", a.device, a.data_ptr(),
            b.data_ptr(), out.data_ptr(), _ADASUM_DTYPES[a.dtype], L, n_seg,
            *ptrs, n_chunks, ADASUM_CHUNK, partials.data_ptr(),
            coef.data_ptr())
    return out


def adasum_pair_combine(a, b):
    """One Adasum pairwise combine of two tensors of one shape and type
    (f32, bf16 or f16): ``ca·a + cb·b`` in that type, with ``a·b``,
    ``|a|²``, ``|b|²`` summed in f32 and ``ca = 0 if |a|² = 0 else
    1 - a·b / (2 max(|a|², 1e-30))`` (``cb`` alike). The kernel sums in a
    fixed order: the same inputs give the same bits."""
    if not _on_cuda(a, b):
        return adasum_pair_combine_plain(a, b)
    if a.dtype not in _ADASUM_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"adasum_pair_combine: expected two tensors of one of "
                        f"{sorted(map(str, _ADASUM_DTYPES))}, got {a.dtype} "
                        f"and {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    return _adasum_launch("adasum_pair_combine", a, b, None)


def adasum_segment_combine(a, b, offsets):
    """:func:`adasum_pair_combine` of every segment ``[offsets[i],
    offsets[i+1])`` of two flat f32 group buffers at once (``offsets``
    runs from 0 to their length)."""
    offsets = tuple(int(o) for o in offsets)
    if not _on_cuda(a, b):
        return adasum_segment_combine_plain(a, b, offsets)
    if a.dtype != torch.float32 or b.dtype != torch.float32 or a.dim() != 1:
        raise TypeError(f"adasum_segment_combine: expected flat float32 "
                        f"buffers, got {a.dtype} {tuple(a.shape)}")
    if a.shape != b.shape or offsets[0] != 0 or offsets[-1] != a.numel() \
            or any(hi < lo for lo, hi in zip(offsets, offsets[1:])):
        raise ValueError(f"segment offsets 0..{offsets[-1]} do not cover "
                         f"a {tuple(a.shape)} / b {tuple(b.shape)}")
    return _adasum_launch("adasum_segment_combine", a, b,
                          _segment_tables(offsets, str(a.device)))
