"""Hand-written Hopper kernels of the int8 gradient wire and the fused
Adam update, each beside its plain PyTorch version.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py``. Every public
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
- ``fused_adam`` — :func:`fused_adam_update`.

The plain versions divide by tensors, never by Python numbers: PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which is not
the reference's rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

INT8_BLOCK = 256  # the block the CUDA kernels are compiled for

KERNELS = ("quantize", "dequant_accumulate", "dequant_accumulate_requantize",
           "fused_adam")

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
