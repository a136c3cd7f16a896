#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # one GPU
    python3 chip_smoke.py --gpus 4   # and then across 4 GPUs

Phases, each fatal on failure (exit code 1, no result line):

1. versions, and the card's name and power limit from nvidia-smi;
2. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` (one nvcc
   per source, started together);
3. small-input check: three ZeRO-1 int8 + error-feedback steps of a
   narrow ResNet on the GPU agree with the same steps on the CPU (a
   child process, plain versions, gloo);
4. end to end: ResNet-50 at full width (224x224x3, 1000 classes, bf16
   compute, f32 parameters), batch 64, random weights from a seed, a
   world of one over NCCL: (a) ZeRO-1 + int8 + EF + fused Adam, 10 steps;
   (b) allreduce mode + int8 + EF + fused Adam, 5 steps. Losses must be
   finite and fall on the repeated batch, and every kernel of each run's
   path must have launched during it. Every kernel-wrapper call of the
   run is logged with its shape;
5. with ``--gpus N``: phase 4 again across N GPUs of the host (one process
   per GPU, NCCL, each rank on its own 64 rows of one global batch, 4
   steps per mode); every rank must report the same falling losses and
   the same parameters;
6. kernels: every call of one step of each run above is replayed on
   fresh inputs at its own shape (the flat buffer's quantize, the 152
   per-leaf quantizes and 76 requantizes of allreduce mode, the 161
   per-leaf Adam updates, ...) and held against the plain PyTorch version:
   bit for bit for the int8 wire, within 2 ULP for fused Adam, a NaN
   meeting a NaN. The inputs carry all-zero blocks, exact half-way
   quotients, NaN and infinite blocks. Each mode's replay is timed with
   CUDA events (kernel, plain version, and for fused Adam
   ``torch._fused_adam_`` over the same tensors as a yardstick) beside
   the sum of the calls' bounds. ResNet-50's flat buffer is also checked
   with a tail that does not divide the block and with eight synthetic
   senders.

A kernel's ``ms``/``plain_ms``/``bound_ms``/``library_ms`` in the
``{"kernels": [...]}`` line are per step: the sum over one step of each
one-GPU mode that launches it; ``by_mode`` splits them. ``launches``
counts the one-GPU runs' launches. The last two lines of standard output
are that record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peak memory bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense f32 rate outside the tensor cores, operations/s
F32_OPS_PER_S = 67e12
#: fused Adam's bar against its plain version
ADAM_ULPS = 2

TPU_KERNELS = {
    "quantize": "horovod_tpu/ops/pallas_kernels.py:220",
    "dequant_accumulate": "horovod_tpu/ops/pallas_kernels.py:323",
    "dequant_accumulate_requantize": "horovod_tpu/ops/pallas_kernels.py:354",
    "fused_adam": "horovod_tpu/ops/pallas_kernels.py:673",
}
SOURCES = {
    "quantize": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "dequant_accumulate": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "dequant_accumulate_requantize": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "fused_adam": "horovod_tpu_torch/ops/csrc/fused_adam.cu",
}
#: the public wrappers of ops.kernels the path calls, and their kernel
WRAPPERS = {
    "quantize_blockwise": "quantize",
    "quantize_roundtrip": "quantize",
    "dequant_accumulate": "dequant_accumulate",
    "dequant_accumulate_requantize": "dequant_accumulate_requantize",
    "fused_adam_update": "fused_adam",
}
#: kernels each mode's path must launch
NEED = {"zero1": ("quantize", "dequant_accumulate", "fused_adam"),
        "allreduce": ("quantize", "dequant_accumulate_requantize",
                      "fused_adam")}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def _numbers(a, b):
    """``a`` and ``b`` where neither is NaN, after checking that they are
    NaN at the same places (a NaN's payload is not part of the contract:
    PyTorch's CPU and CUDA casts and the CUDA intrinsics differ in it)."""
    import torch

    if not a.is_floating_point():
        return a, b
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return None
    return a[~nan], b[~nan]


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ab = _numbers(a, b)
    if ab is None:
        return False
    a, b = ab
    if a.is_floating_point():
        itype = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return torch.equal(a.view(itype[a.dtype]), b.view(itype[b.dtype]))
    return torch.equal(a, b)


def within_ulps(a, b, ulps: int = ADAM_ULPS) -> bool:
    import torch

    ab = _numbers(a, b)
    if ab is None:
        return False
    a, b = ab
    inf = torch.isinf(a) | torch.isinf(b)
    if not torch.equal(a[inf], b[inf]):
        return False
    a, b = a[~inf], b[~inf]
    big = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return bool(((a - b).abs() <= ulps * spacing).all())


def max_abs(a, b) -> float:
    """Largest |a - b| where both are numbers."""
    d = (a.float() - b.float()).abs()
    d = d[~d.isnan()]
    return float(d.max()) if d.numel() else 0.0


# --------------------------------------------------------------------------
# the kernel calls of the main path


def _signature(wrapper: str, args, kw) -> tuple:
    kernel = WRAPPERS[wrapper]
    if kernel == "quantize":
        return (kernel, wrapper == "quantize_roundtrip", args[0].numel())
    if kernel == "dequant_accumulate":
        return (kernel, *args[0].shape)
    if kernel == "dequant_accumulate_requantize":
        return (kernel, *args[0].shape, kw.get("divisor"))
    return (kernel, args[0].numel(), args[3], tuple(sorted(kw.items())))


@contextlib.contextmanager
def logging_calls(steps: list):
    """Log the shape signature of every call of a kernel wrapper into
    ``steps[-1]`` (the caller appends a list per step). The path reaches
    the wrappers through the ``ops.kernels`` module, so wrapping the
    module's attributes sees every call; :func:`train` checks that the
    log and the launch counters agree."""
    from horovod_tpu_torch.ops import kernels as K

    saved = {w: getattr(K, w) for w in WRAPPERS}

    def logged(w, f):
        def call(*args, **kw):
            steps[-1].append(_signature(w, args, kw))
            return f(*args, **kw)
        return call

    for w, f in saved.items():
        setattr(K, w, logged(w, f))
    try:
        yield
    finally:
        for w, f in saved.items():
            setattr(K, w, f)


def call_bound(sig) -> tuple:
    """``(bytes, operations)`` of one call: each input read once, each
    output written once."""
    kernel = sig[0]
    if kernel == "quantize":
        _, roundtrip, L = sig
        return 4 * L + L + 2 * (L // 256) + 4 * L * roundtrip, 4 * L
    if kernel in ("dequant_accumulate", "dequant_accumulate_requantize"):
        n, sp = sig[1], sig[2]
        wire = n * sp + 2 * n * (sp // 256)
        if kernel == "dequant_accumulate":
            return wire + 4 * sp, 2 * n * sp
        return wire + sp + 2 * (sp // 256), 2 * n * sp + 4 * sp
    L = sig[1]
    return 24 * L, 12 * L


def bound_ms(sigs) -> tuple:
    """The least time for all of ``sigs``: the sum of each call's larger
    of bytes over the memory rate and operations over the f32 rate."""
    total, by = 0.0, set()
    for sig in sigs:
        nbytes, ops = call_bound(sig)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        total += max(t_b, t_o)
        by.add("bytes" if t_b >= t_o else "operations")
    return total * 1e3, "bytes" if by == {"bytes"} else "operations"


def _special_blocks(x, gen) -> None:
    """Overwrite the first blocks of a flat f32 input with edge cases, as
    far as it has blocks and leaving at least one ordinary block: all zero;
    exact half-way quotients (amax 127 gives scale 1); a NaN; infinities."""
    import torch

    half = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5] * 32,
                        device=x.device)
    nan = torch.randn(256, device=x.device, generator=gen)
    nan[17] = math.nan
    inf = torch.randn(256, device=x.device, generator=gen)
    inf[3], inf[200] = math.inf, -math.inf
    for i, block in enumerate((torch.zeros_like(half), half, nan, inf)):
        if (i + 2) * 256 > x.numel():
            break
        x[i * 256:(i + 1) * 256] = block


def make_call(sig, gen):
    """``(kernel_call, plain_call, compare)`` on fresh inputs on
    ``gen``'s device for one logged call; ``compare(out, ref)`` is None
    when they agree, else a message."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    dev = gen.device
    kernel = sig[0]
    if kernel == "quantize":
        _, roundtrip, L = sig
        x = torch.randn(L, device=dev, generator=gen) * 1e-2
        _special_blocks(x, gen)
        f = K.quantize_roundtrip if roundtrip else K.quantize_blockwise
        return (lambda: f(x), lambda: K.quantize_plain(x, roundtrip=roundtrip),
                _bits)
    if kernel in ("dequant_accumulate", "dequant_accumulate_requantize"):
        n, sp = sig[1], sig[2]
        nb = sp // 256
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, nb, device=dev, generator=gen) * 1e-2).to(
            torch.bfloat16)
        q[:, :256], s[:, 0] = 0, 0.0           # an all-zero block
        if nb >= 4:                             # a sender's NaN / inf block
            s[0, 1], s[n - 1, 2] = math.nan, math.inf
        if kernel == "dequant_accumulate":
            return (lambda: (K.dequant_accumulate(q, s),),
                    lambda: (K.dequant_accumulate_plain(q, s),), _bits)
        d = sig[3]
        return (lambda: K.dequant_accumulate_requantize(q, s, divisor=d),
                lambda: K.dequant_accumulate_requantize_plain(q, s, divisor=d),
                _bits)
    _, L, count, kw = sig
    kw = dict(kw)
    g = torch.randn(L, device=dev, generator=gen) * 1e-2
    mu = torch.randn(L, device=dev, generator=gen) * 1e-3
    nu = torch.rand(L, device=dev, generator=gen) * 1e-6
    if L >= 8:
        g[1], g[5] = math.nan, math.inf
    c = K.adam_constants(kw["lr"], kw["b1"], kw["b2"], kw["eps"],
                         kw["eps_root"], count)
    call = (lambda: K.fused_adam_update(g, mu, nu, count, **kw),
            lambda: K.fused_adam_plain(g, mu, nu, c), _ulps)
    call[0].tensors = (g, mu, nu)
    return call


def _bits(out, ref):
    for i, (a, b) in enumerate(zip(out, ref)):
        if not same_bits(a, b):
            return f"output {i} differs (max abs err {max_abs(a, b)})"
    return None


def _ulps(out, ref):
    for name, a, b in zip(("update", "mu", "nu"), out, ref):
        if not within_ulps(a, b):
            return (f"{name} more than {ADAM_ULPS} ULP from the plain "
                    f"version (max abs err {max_abs(a, b)})")
    return None


def library_adam_ms(calls, count: int, kw: dict) -> float:
    """``torch._fused_adam_`` over the same tensors as one step's fused
    Adam calls, in one multi-tensor call (a yardstick; the port never
    calls it)."""
    import torch

    gs, mus, nus = zip(*(c.tensors for c in calls))
    params = [torch.zeros_like(g) for g in gs]
    m2, v2 = [m.clone() for m in mus], [v.clone() for v in nus]
    steps = [torch.tensor(float(count), device=gs[0].device) for _ in gs]
    return cuda_ms(lambda: torch._fused_adam_(
        params, list(gs), m2, v2, [], steps, lr=kw["lr"], beta1=kw["b1"],
        beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
        maximize=False))


def kernel_phase(step_calls: dict, main_modes) -> dict:
    """Replay each mode's logged step on fresh inputs: hold every call
    against its plain version, then time the kernel, plain and library
    replays. Returns the per-kernel record."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {k: dict(max_abs_err=0.0, calls_checked=0, by_mode={})
            for k in K.KERNELS}
    for mode, sigs in step_calls.items():
        for kernel in K.KERNELS:
            ks = [s for s in sigs if s[0] == kernel]
            if not ks:
                continue
            calls = [make_call(s, gen) for s in ks]
            row = rows[kernel]
            for sig, (run, plain, compare) in zip(ks, calls):
                out, ref = run(), plain()
                bad = compare(out, ref)
                if bad:
                    fail(f"{kernel} at {sig} ({mode}): {bad}")
                row["max_abs_err"] = max(
                    [row["max_abs_err"]]
                    + [max_abs(a, b) for a, b in zip(out, ref)])
                row["calls_checked"] += 1
            b, by = bound_ms(ks)
            lib = None
            if kernel == "fused_adam" and hasattr(torch, "_fused_adam_"):
                lib = library_adam_ms([c[0] for c in calls], ks[0][2],
                                      dict(ks[0][3]))
            row["by_mode"][mode] = dict(
                calls=len(ks), shapes=len(set(ks)),
                ms=cuda_ms(lambda: [c[0]() for c in calls]),
                plain_ms=cuda_ms(lambda: [c[1]() for c in calls]),
                bound_ms=b, bound_by=by, library_ms=lib)
            del calls
            torch.cuda.empty_cache()
    for kernel, row in rows.items():
        main = [row["by_mode"][m] for m in main_modes if m in row["by_mode"]]
        for key in ("ms", "plain_ms", "bound_ms"):
            row[key] = sum(m[key] for m in main)
        row["bound_by"] = ("bytes" if all(m["bound_by"] == "bytes"
                                          for m in main) else "operations")
        libs = [m["library_ms"] for m in main if m["library_ms"] is not None]
        row["library_ms"] = sum(libs) if libs else None
    return rows


def flat_buffer_checks(L: int) -> None:
    """ResNet-50's whole flat buffer, whose length does not divide the
    block, through the padding the path uses; and the reduce-scatter
    epilogues at eight synthetic senders."""
    import torch

    from horovod_tpu_torch.compression import _pad_to_block
    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(L, device=gen.device, generator=gen)
    _special_blocks(x, gen)
    xp = _pad_to_block(x, K.INT8_BLOCK)
    bad = _bits(K.quantize_roundtrip(xp), K.quantize_plain(xp, roundtrip=True))
    if bad:
        fail(f"quantize roundtrip at the flat buffer [{L}]: {bad}")
    s = -(-L // 8)
    sp = s + (-s) % 256
    for sig in (("dequant_accumulate", 8, sp),
                ("dequant_accumulate_requantize", 8, sp, 8),
                ("dequant_accumulate_requantize", 8, sp, None)):
        run, plain, compare = make_call(sig, gen)
        bad = compare(run(), plain())
        if bad:
            fail(f"{sig} (flat buffer, 8 senders): {bad}")


# --------------------------------------------------------------------------
# phase 3: a small input, GPU against CPU


def small_run(device: str) -> list:
    """Three ZeRO-1 int8 + EF fused-Adam steps of a narrow f32 ResNet in a
    world of one on ``device``; returns the losses."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_filters=8,
                   num_classes=10, dtype=torch.float32, seed=7)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    model.to(device)
    x, y = x.to(device), y.to(device)
    tx = hvd.DistributedOptimizer(hvd.fused_adam(1e-2),
                                  compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=True)
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    losses = []
    for _ in range(3):
        st, loss = step(st, x, y)
        losses.append(float(loss))
    return losses


def cpu_reference() -> None:
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        print(json.dumps(small_run("cpu")))
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# phases 4 and 5: ResNet-50 end to end


def train(shard: bool, steps: int, x, y, model_seed: int = 0) -> dict:
    """``steps`` steps of ResNet-50 on this rank's batch ``x, y`` in one
    optimizer mode; fails unless the loss is finite and falls and every
    kernel of the mode's path launched. ``step_calls`` is the kernel
    calls of the last step."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    model = ResNet50(dtype=torch.bfloat16, seed=model_seed, device=dev)
    tx = hvd.DistributedOptimizer(hvd.fused_adam(1e-3),
                                  compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=shard)
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=shard)
    with torch.no_grad():
        logits = model(x)
    if tuple(logits.shape) != (x.shape[0], 1000) or not bool(
            torch.isfinite(logits).all()):
        fail(f"ResNet-50 logits: shape {tuple(logits.shape)} or non-finite")
    torch.cuda.synchronize()
    calls: list = []
    K.reset_launches()                  # count the main path's run only
    losses, times = [], []
    with logging_calls(calls):
        for _ in range(steps):
            calls.append([])
            t0 = time.perf_counter()
            st, loss = step(st, x, y)
            losses.append(float(loss))  # device->host read fences the step
            times.append(time.perf_counter() - t0)
    launches = dict(K.launches)
    mode = "zero1" if shard else "allreduce"
    if not all(math.isfinite(v) for v in losses):
        fail(f"{mode}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{mode}: loss did not fall on the repeated batch: {losses}")
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != launches[k]:
            fail(f"{mode}: {launches[k]} launches of {k} but {logged} "
                 "logged calls: a caller bypasses ops.kernels' wrappers")
    for k in NEED[mode]:
        if launches[k] < 1:
            fail(f"{mode}: kernel {k} was not launched on the main path "
                 f"({launches})")
    steady = times[1:] if len(times) > 1 else times
    checksum = float(sum(p.detach().double().sum() for p in model.parameters()))
    return dict(mode=mode, steps=steps, losses=losses, launches=launches,
                step_s=times, img_per_s=x.shape[0] * len(steady) / sum(steady),
                checksum=checksum, step_calls=calls[-1])


def _world_rank() -> list:
    """One rank of the multi-GPU run: ZeRO-1 then allreduce mode, int8 +
    EF + fused Adam, each rank on its own rows of one global batch."""
    import torch

    import horovod_tpu_torch as hvd

    gen = torch.Generator().manual_seed(0)
    n = hvd.size()
    x = torch.randn(64 * n, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (64 * n,), generator=gen)
    xs, ys = hvd.shard_batch(x).to(hvd.device()), hvd.shard_batch(y).to(
        hvd.device())
    return [train(True, 4, xs, ys), train(False, 4, xs, ys)]


def run_gpus(n: int) -> list:
    """Phase 5: ``[zero1, allreduce]`` results of rank 0, after checking
    that every rank reports the same losses and parameters."""
    from horovod_tpu_torch.testing import run_world

    try:
        res = run_world(_world_rank, n, device=None, timeout=600)
    except RuntimeError as e:
        fail(f"{n} GPUs: {e}")
    for r, runs in enumerate(res):
        for o, o0 in zip(runs, res[0]):
            if o["losses"] != o0["losses"] or o["checksum"] != o0["checksum"]:
                fail(f"{n} GPUs, {o['mode']}: rank {r} diverged from rank 0")
    return res[0]


def _summary(run: dict) -> str:
    return json.dumps({k: v for k, v in run.items() if k != "step_calls"})


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--cpu-reference":
        sys.path.insert(0, ROOT)
        cpu_reference()
        return
    gpus = 1
    if len(sys.argv) > 2 and sys.argv[1] == "--gpus":
        gpus = int(sys.argv[2])

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if torch.cuda.device_count() < gpus:
        fail(f"--gpus {gpus}: only {torch.cuda.device_count()} GPUs")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(smi, flush=True)

    sys.path.insert(0, ROOT)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import ResNet50
        from horovod_tpu_torch.ops import _build, kernels as K
    except ImportError as e:
        fail(f"horovod_tpu_torch is not importable next to chip_smoke.py: {e}")

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          + ", ".join(f"{n} {r['seconds']:.2f} s" for n, r in report.items()),
          flush=True)

    cpu = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--cpu-reference"], capture_output=True, text=True,
                         timeout=300)
    if cpu.returncode != 0:
        fail(f"CPU reference run failed:\n{cpu.stderr[-2000:]}")
    ref = json.loads(cpu.stdout.strip().splitlines()[-1])
    hvd.init()
    try:
        got = small_run(hvd.device())
        # f32 on both sides with TF32 off: the convolutions sum in another
        # order, and the int8 wire may turn that into one quantum of
        # difference in a few gradient elements
        if not all(abs(a - b) <= 2e-3 * abs(b) + 1e-4 for a, b in zip(got, ref)):
            fail(f"small input: GPU losses {got} vs CPU {ref}")
        print(f"small input: GPU losses {got}, CPU losses {ref}", flush=True)
        torch.backends.cudnn.allow_tf32 = True

        gen = torch.Generator(device=hvd.device()).manual_seed(0)
        x = torch.randn(64, 224, 224, 3, device=hvd.device(), generator=gen)
        y = torch.randint(0, 1000, (64,), device=hvd.device(), generator=gen)
        runs = [train(True, 10, x, y), train(False, 5, x, y)]
        del x, y
    finally:
        hvd.shutdown()
    for run in runs:
        print(f"e2e {run['mode']}: {_summary(run)}", flush=True)
    step_calls = {run["mode"]: run["step_calls"] for run in runs}
    if gpus > 1:
        torch.cuda.empty_cache()
        for run in run_gpus(gpus):
            print(f"e2e {gpus} GPUs {run['mode']}: {_summary(run)}", flush=True)
            step_calls[f"{run['mode']}@{gpus}"] = run["step_calls"]

    L = sum(v.numel() for v in ResNet50(device="meta").jax_params().values())
    flat_buffer_checks(L)
    rows = kernel_phase(step_calls, main_modes=("zero1", "allreduce"))
    for name, r in rows.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)

    kernels = []
    for name in K.KERNELS:
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=TPU_KERNELS[name],
            launches=sum(run["launches"][name] for run in runs),
            launches_by_mode={run["mode"]: run["launches"][name]
                              for run in runs},
            max_abs_err=r["max_abs_err"], ms=r["ms"], kernel_ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
