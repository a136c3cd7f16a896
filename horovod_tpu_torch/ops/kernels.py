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
- ``fused_adam`` — :func:`fused_adam_multi`, every tensor of a step in
  one launch (:func:`fused_adam_update` is its one-tensor case, with the
  optional int8 requantize epilogue);
- ``flash_fwd`` — :func:`flash_fwd`, attention's forward with its
  log-sum-exp rows;
- ``dequantize_rows`` — the ZeRO-3 int8 parameter-gather epilogue;
- ``adasum_pair_combine`` — one Adasum combine of a tensor pair
  (:func:`adasum_pair_combine`), or of every leaf of a packed leaf table
  (:func:`adasum_pair_combine_packed`, the compressed route);
  ``adasum_segment_combine`` — of every segment of the f32 group buffer
  (the grouped route). Two CUDA launches, one count: reduce (with the
  finalize), blend.

The plain versions divide by tensors, never by Python numbers: PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which is not
the reference's rounding.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import operator

import numpy as np
import torch

INT8_BLOCK = 256  # the block the CUDA kernels are compiled for

KERNELS = ("quantize", "dequant_accumulate", "dequant_accumulate_requantize",
           "fused_adam", "flash_fwd", "dequantize_rows", "adasum_pair_combine",
           "adasum_segment_combine")
#: head dims the flash_fwd kernel is compiled for
FLASH_HEAD_DIMS = (64, 128)

#: elements of one chunk of a fused_adam launch (csrc/fused_adam.cu kChunk)
ADAM_CHUNK = 2048
#: tensors one fused_adam launch takes (csrc/fused_adam.cu kMaxLeaves: its
#: table of pointers is the kernel's parameter, at most 32,764 bytes)
ADAM_MAX_LEAVES = 256

#: elements per block of the Adasum reduce and blend passes, one constant
#: for every route: a leaf's chunks are the same alone, in a packed leaf
#: table and in the group buffer (a multiple of 8: 16-byte groups)
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
    "hvd_fused_adam": [_P, _P, _P, ctypes.c_int, _P, _P]
    + [ctypes.c_float] * 9 + [_P],
    "hvd_flash_fwd": [_P] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    "hvd_dequantize_rows": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "hvd_adasum_combine": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, _P, _P, _P, ctypes.c_int,
                           ctypes.c_longlong, _P, _P, _P, _P],
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
    index = set(map(torch.Tensor.get_device, ts))  # no device objects: cheap
    if len(index) == 1 and index.pop() >= 0 and ts[0].is_cuda:
        return True
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


def fused_adam_requant_plain(g, mu, nu, c: dict, block: int = INT8_BLOCK):
    """:func:`fused_adam_plain` and the update's blockwise int8 wire image
    ``(q [ceil(L/block)*block], scales [ceil(L/block)])``: the tail block
    is the update of zero ``g``, ``mu``, ``nu``, as the reference pads."""
    L = g.shape[0]
    pad = (-L) % block
    u, mu2, nu2 = fused_adam_plain(
        *(torch.cat([x, x.new_zeros(pad)]) for x in (g, mu, nu)), c)
    return u[:L], mu2[:L], nu2[:L], quantize_plain(u, block)


@functools.lru_cache(maxsize=64)
def adam_launch_plan(lengths: tuple, cap: int = ADAM_MAX_LEAVES) -> tuple:
    """The ``fused_adam`` launches of one call over leaves of ``lengths``:
    ``((leaf indices, first), ...)``, one launch per ``cap`` non-empty
    leaves, in order. A launch cuts its leaves into chunks of
    :data:`ADAM_CHUNK` elements: ``first[j]`` is the first chunk of its
    ``j``-th leaf and ``first[-1]`` the number of chunks; chunk ``c`` is
    chunk ``c - first[j]`` of the last leaf ``j`` with ``first[j] <= c``."""
    live = [i for i, n in enumerate(lengths) if n]
    plan = []
    for s in range(0, len(live), cap):
        idx = live[s:s + cap]
        per = [-(-lengths[i] // ADAM_CHUNK) for i in idx]
        plan.append((tuple(idx), np.cumsum([0] + per, dtype=np.int32)))
    return tuple(plan)


@functools.lru_cache(maxsize=64)
def _adam_layout(lengths: tuple) -> tuple:
    """Where each leaf's outputs lie in the flat output buffers: every leaf
    at a 4-element (16-byte) boundary, so the kernel's float4 path takes
    it. ``(split sizes, the leaves' places among the split pieces or None
    when there is no gap, offsets int64, total)``."""
    offs, sizes, take, at = [], [], [], 0
    for n in lengths:
        offs.append(at)
        take.append(len(sizes))
        sizes.append(n)
        if n % 4:
            sizes.append(4 - n % 4)
        at += n + (-n) % 4
    return (tuple(sizes), None if len(sizes) == len(lengths) else tuple(take),
            np.asarray(offs, dtype=np.int64), at)


def _contiguous(xs):
    if all(map(torch.Tensor.is_contiguous, xs)):
        return xs
    return [x if x.is_contiguous() else x.contiguous() for x in xs]


def _adam_launch(gs, mus, nus, c: dict, wire=None):
    """Launch the ``fused_adam`` kernel over f32 leaves (a strided one is
    copied contiguous first): the updates and moments as views of the
    leaves' shapes into three flat buffers; with ``wire = (q, scales)``
    (one leaf) also the update's int8 image. Per-leaf work is one pass of
    ``map`` per attribute: it is the host's share of a step's update."""
    T = torch.Tensor
    gs, mus, nus = _contiguous(gs), _contiguous(mus), _contiguous(nus)
    lengths = tuple(map(T.numel, gs))
    if tuple(map(T.numel, mus)) != lengths or \
            tuple(map(T.numel, nus)) != lengths:
        raise ValueError("g, mu and nu must have the same lengths")
    dtypes = set(map(operator.attrgetter("dtype"), itertools.chain(gs, mus, nus)))
    if dtypes != {torch.float32}:
        raise TypeError(f"fused_adam takes float32 tensors, got {dtypes}")
    sizes, take, offs, total = _adam_layout(lengths)
    dev = gs[0].device
    flats = [torch.empty(total, dtype=torch.float32, device=dev)
             for _ in range(3)]
    shaped = [(j, gs[j].shape) for j, d in enumerate(map(T.dim, gs)) if d != 1]
    outs = []
    for flat in flats:
        views = [flat] if len(sizes) == 1 else flat.split_with_sizes(sizes)
        views = list(views) if take is None else [views[j] for j in take]
        for j, shape in shaped:
            views[j] = views[j].view(shape)
        outs.append(views)
    ptrs = np.empty((len(gs), 6), dtype=np.int64)
    for j, xs in enumerate((gs, mus, nus)):
        ptrs[:, j] = list(map(T.data_ptr, xs))
    for j, flat in enumerate(flats):
        ptrs[:, 3 + j] = flat.data_ptr() + 4 * offs
    n = np.asarray(lengths, dtype=np.int64)
    q, s = wire if wire is not None else (None, None)
    plan = adam_launch_plan(lengths)
    for idx, first in plan:
        if len(plan) == 1 and len(idx) == len(lengths):
            tp, tn = ptrs, n                    # every leaf, in order
        else:
            tp, tn = ptrs[list(idx)], n[list(idx)]
        _launch("fused_adam", "fused_adam", "hvd_fused_adam", dev,
                tp.ctypes.data, tn.ctypes.data, first.ctypes.data, len(idx),
                None if q is None else q.data_ptr(),
                None if s is None else s.data_ptr(),
                c["omb1"], c["b1"], c["omb2"], c["b2"], c["b1c"], c["b2c"],
                c["eps"], c["eps_root"], c["neg_lr"])
    return outs


def fused_adam_multi(gs, mus, nus, count: int, *, lr, b1=0.9, b2=0.999,
                     eps=1e-8, eps_root=0.0):
    """One Adam step over many f32 tensors at once, bias corrections taken
    at step ``count`` (the incremented count): ``(updates, mus', nus')``,
    lists of tensors of the inputs' shapes in optax's ``scale_by_adam ->
    scale(-lr)`` order. On the card, one ``fused_adam`` launch for every
    :data:`ADAM_MAX_LEAVES` non-empty tensors (:func:`adam_launch_plan`);
    the outputs are views into three flat buffers."""
    c = adam_constants(lr, b1, b2, eps, eps_root, count)
    if len(mus) != len(gs) or len(nus) != len(gs):
        raise ValueError("gs, mus and nus must hold as many tensors")
    if not gs:
        return [], [], []
    if not _on_cuda(*gs, *mus, *nus):
        outs = [fused_adam_plain(g, m, v, c) for g, m, v in zip(gs, mus, nus)]
        return [list(o) for o in zip(*outs)]
    return _adam_launch(gs, mus, nus, c)


def fused_adam_update(g, mu, nu, count: int, *, lr, b1=0.9, b2=0.999,
                      eps=1e-8, eps_root=0.0, requant_block=None):
    """One Adam step over a flat f32 shard: :func:`fused_adam_multi` of one
    tensor, ``(update, mu', nu')``. With ``requant_block`` also the
    update's blockwise int8 wire image from the same pass, ``(update, mu',
    nu', (q int8 [ceil(L/block)*block], scales bf16 [ceil(L/block)]))``,
    the tail block zero-padded as the reference pads (no training path
    consumes it, as in the reference)."""
    c = adam_constants(lr, b1, b2, eps, eps_root, count)
    if not _on_cuda(g, mu, nu):
        if requant_block is None:
            return fused_adam_plain(g, mu, nu, c)
        return fused_adam_requant_plain(g, mu, nu, c, requant_block)
    if requant_block is None:
        (u,), (m,), (v,) = _adam_launch([g], [mu], [nu], c)
        return u, m, v
    _need_block(requant_block)
    if g.dim() != 1:
        raise ValueError(f"g: expected a flat shard, got {tuple(g.shape)}")
    nb = -(-g.shape[0] // requant_block)
    q = torch.empty(nb * requant_block, dtype=torch.int8, device=g.device)
    s = torch.empty(nb, dtype=torch.bfloat16, device=g.device)
    (u,), (m,), (v,) = _adam_launch([g], [mu], [nu], c, wire=(q, s))
    return u, m, v, (q, s)


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
    lse [B, H, Tq] f32)``. The kernel takes bf16 (tensor cores) or f32
    inputs of head dim 64 or 128 with a contiguous last dim, any other
    strides, and tiles by its own 64-row blocks; ``block_k`` is the plain
    version's K blocking."""
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
    if q.dtype == torch.bfloat16:
        # the kernel's asynchronous copies move 16 bytes: rows that do not
        # start 16-byte aligned are copied into a fresh contiguous tensor
        q, k, v = (x if x.data_ptr() % 16 == 0 and not any(
            st % 8 for st in x.stride()[:3]) else
            torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)
            for x in (q, k, v))
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
    """:func:`adasum_pair_combine_plain` of each segment ``[offsets[i],
    offsets[i+1])`` in turn: every segment's output is that function's
    for the segment alone, bit for bit, in any operand type."""
    offs = [int(o) for o in offsets]
    return torch.cat([adasum_pair_combine_plain(a[lo:hi], b[lo:hi])
                      for lo, hi in zip(offs, offs[1:])] or [a[:0]])


@functools.lru_cache(maxsize=8)
def _segment_tables(offsets: tuple, device: str):
    """Device tables of a segment layout, built once per layout (a
    model's gradient group): element offsets int64 ``[S+1]``, each
    chunk's segment int32 ``[n_chunks]``, each segment's first chunk
    int32 ``[S+1]`` (chunks of at most :data:`ADASUM_CHUNK` elements,
    never straddling a segment), and ``n_chunks``. Checks, once per
    layout, that the offsets start at 0 and never decrease."""
    sizes = np.diff(np.asarray(offsets, np.int64))
    if offsets[0] != 0 or (sizes < 0).any():
        raise ValueError(f"segment offsets must start at 0 and not decrease, "
                         f"got {offsets[:4]}...")
    per = -(-sizes // ADASUM_CHUNK)
    first = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    chunk_seg = np.repeat(np.arange(len(sizes), dtype=np.int32), per)
    return (torch.tensor(offsets, dtype=torch.int64, device=device),
            torch.from_numpy(chunk_seg).to(device),
            torch.from_numpy(first).to(device), int(first[-1]))


@functools.lru_cache(maxsize=16)
def _adasum_counters(n_seg: int, device: str):
    """The kernel's per-segment tickets, zeroed once: each launch leaves
    them zero again, so the launches on a device share them, one after
    another on the stream they are made on (the port launches on the
    current stream; two combines running at once on two streams would
    share tickets)."""
    return torch.zeros(n_seg, dtype=torch.int32, device=device)


def _adasum_launch(kernel, a, b, tables):
    """Launch the two passes over contiguous ``a``, ``b`` of one shape
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
    counters = _adasum_counters(n_seg, str(a.device))
    _launch(kernel, "adasum", "hvd_adasum_combine", a.device, a.data_ptr(),
            b.data_ptr(), out.data_ptr(), _ADASUM_DTYPES[a.dtype], L, n_seg,
            *ptrs, n_chunks, ADASUM_CHUNK, partials.data_ptr(),
            coef.data_ptr(), counters.data_ptr())
    return out


def _check_types(name, a, b):
    if a.dtype not in _ADASUM_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{name}: expected two tensors of one of "
                        f"{sorted(map(str, _ADASUM_DTYPES))}, got {a.dtype} "
                        f"and {b.dtype}")


def adasum_pair_combine(a, b):
    """One Adasum pairwise combine of two tensors of one shape and type
    (f32, bf16 or f16): ``ca·a + cb·b`` in that type, with ``a·b``,
    ``|a|²``, ``|b|²`` summed in f32 and ``ca = 0 if |a|² = 0 else
    1 - a·b / (2 max(|a|², 1e-30))`` (``cb`` alike). The kernel sums in a
    fixed order: the same inputs give the same bits, wherever they lie."""
    if not _on_cuda(a, b):
        return adasum_pair_combine_plain(a, b)
    _check_types("adasum_pair_combine", a, b)
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    return _adasum_launch("adasum_pair_combine", a, b, None)


def _segmented(kernel, a, b, offsets):
    offsets = tuple(map(int, offsets))
    if not _on_cuda(a, b):
        return adasum_segment_combine_plain(a, b, offsets)
    _check_types(kernel, a, b)
    if a.dim() != 1 or a.shape != b.shape or offsets[-1] != a.numel():
        raise ValueError(f"segment offsets 0..{offsets[-1]} do not cover "
                         f"a {tuple(a.shape)} / b {tuple(b.shape)}")
    # the layout's own checks run once, where its tables are built
    return _adasum_launch(kernel, a, b,
                          _segment_tables(offsets, str(a.device)))


def adasum_segment_combine(a, b, offsets):
    """:func:`adasum_pair_combine` of every segment ``[offsets[i],
    offsets[i+1])`` of two flat buffers of one type at once (``offsets``
    runs from 0 to their length): the grouped route's combine, over the
    f32 group buffer."""
    return _segmented("adasum_segment_combine", a, b, offsets)


def adasum_pair_combine_packed(a, b, offsets):
    """:func:`adasum_pair_combine` of every leaf of a leaf table: two
    flat buffers of one type (the compressed route's 16-bit wire type)
    holding the leaves as segments ``[offsets[i], offsets[i+1])``, in one
    call of the ``adasum_pair_combine`` kernel. Each leaf gets the bits of
    its own :func:`adasum_pair_combine`: its chunks and 16-byte groups are
    cut from its first element, as there (a leaf starting on a 16-byte
    boundary reads its groups as vectors)."""
    return _segmented("adasum_pair_combine", a, b, offsets)
