"""Per-rank bodies for the port's multi-process tests, and the tests that
need no JAX.

The functions here run inside ``horovod_tpu_torch.testing.run_world``
children (spawned processes, gloo), so this module must not import JAX:
each child imports it to unpickle its function. Inputs arrive as numpy
arrays stacked ``[N, ...]`` (row r is rank r's), results go back as numpy.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.testing import run_world

pytestmark = pytest.mark.torch_port


def _mine(stacked):
    return torch.from_numpy(np.ascontiguousarray(stacked[hvd.rank()]))


def identity_worker():
    return dict(rank=hvd.rank(), size=hvd.size(), local_rank=hvd.local_rank(),
                device=str(hvd.device()))


def collectives_worker(inp):
    int8 = hvd.Compression.int8
    out = {
        "psum_scatter": C.quantized_psum_scatter(_mine(inp["flat"])),
        "q_allreduce_avg": hvd.allreduce(_mine(inp["v"]), hvd.Average,
                                         compression=int8),
        "q_allreduce_sum": hvd.allreduce(_mine(inp["v"]), hvd.Sum,
                                         compression=int8),
        "q_small_passthrough": hvd.allreduce(_mine(inp["small"]), hvd.Average,
                                             compression=int8),
        "allreduce_sum": hvd.allreduce(_mine(inp["x"]), hvd.Sum),
        "allreduce_avg": hvd.allreduce(_mine(inp["x"]), hvd.Average),
        "allreduce_min": hvd.allreduce(_mine(inp["x"]), hvd.Min),
        "allreduce_max": hvd.allreduce(_mine(inp["x"]), hvd.Max),
        "allreduce_int_avg": hvd.allreduce(_mine(inp["ints"]), hvd.Average),
        "allreduce_fp16": hvd.allreduce(_mine(inp["x"]), hvd.Average,
                                        compression=hvd.Compression.fp16),
        "allgather": hvd.allgather(_mine(inp["x"])),
        "broadcast": hvd.broadcast(_mine(inp["x"]), 1),
        "reducescatter_sum": hvd.reducescatter(_mine(inp["rows"]), hvd.Sum),
        "reducescatter_avg": hvd.reducescatter(_mine(inp["rows"]), hvd.Average),
        "alltoall": hvd.alltoall(_mine(inp["a2a"])),
    }
    # broadcast_parameters writes root's values through (permuted) views
    base = _mine(inp["x"]).clone()
    params = {"w": base.permute(1, 0), "b": base[:, 0]}
    hvd.broadcast_parameters(params, 1)
    out["bcast_params"] = base
    state = {"count": 3 + hvd.rank(), "mu": {"w": _mine(inp["x"])}}
    st = hvd.broadcast_optimizer_state(state, 1)
    out["bcast_state_mu"] = st["mu"]["w"]
    out["bcast_state_count"] = torch.tensor(st["count"])
    zero = {"shard": {"rank": hvd.rank(), "size": 2}, "inner": state}
    assert hvd.broadcast_optimizer_state(zero, 1) is zero
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in out.items()}


def test_world_identity():
    res = run_world(identity_worker, 2)
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["size"] == 2 and r["device"] == "cpu" for r in res)


def test_init_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hvd.init()
    assert not hvd.is_initialized()


def test_world_of_one_and_reinit(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size()) == (0, 1)
        x = torch.arange(4.0)
        assert torch.equal(hvd.allreduce(x, hvd.Sum), x)
        hvd.shutdown()
        assert not hvd.is_initialized()
        with pytest.raises(RuntimeError, match="not been initialized"):
            hvd.rank()
        hvd.init(device="cpu")
        assert torch.equal(hvd.allgather(x), x)
        with pytest.raises(ValueError, match="root_rank"):
            hvd.broadcast(x, 1)
        with pytest.raises(ValueError, match="divisible"):
            hvd.alltoall(torch.zeros(()))
    finally:
        hvd.shutdown()


def test_identity_from_launcher_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "0")
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 1, 0)
    finally:
        hvd.shutdown()


def _identity():
    """The inner optimizer that returns the reduced gradients: pins the
    exchange itself bit for bit (``optax.identity`` on the JAX side)."""
    from horovod_tpu_torch.optim import Transform

    return Transform(lambda p: {}, lambda g, s, p=None: (g, s))


def _compression(name):
    return getattr(hvd.Compression, name)


def one_update_worker(inp, shard, inner):
    """One DistributedOptimizer(int8, EF) update on identical per-rank
    grads and (with shard) an identical nonzero EF residual."""
    from horovod_tpu_torch.models.convert import zero1_state_from_jax

    r = hvd.rank()
    params = {k: torch.from_numpy(inp[k].copy()) for k in ("w", "b")}
    opt = _identity() if inner == "identity" else hvd.adam(1e-2)
    tx = hvd.DistributedOptimizer(opt, compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=shard)
    st = tx.init(params)
    if shard:
        jst = inp["state"]
        st = zero1_state_from_jax(jst["count"], jst["mu"], jst["nu"], r,
                                  residual=jst["residual"])
        if inner == "identity":
            st["inner"] = {}
    grads = {"w": _mine(inp["gw"]), "b": _mine(inp["gb"])}
    u, st = tx.update(grads, st, params)
    res = st["residual"]
    return {"u": {k: v.numpy() for k, v in u.items()},
            "residual": {k: v.numpy() for k, v in res.items()},
            "inner": ({k: v.numpy() for k, v in st["inner"]["mu"].items()}
                      if inner == "adam" else None)}


def trajectory_worker(inp, shard, compression, error_feedback, steps):
    """``steps`` steps of the ``tests/test_pallas.py::_run_zero1`` problem:
    a linear layer under MSE, this rank's rows of the batch."""
    from horovod_tpu_torch.training import shard_batch

    params = {k: torch.from_numpy(inp[k].copy()) for k in ("w", "b")}
    tx = hvd.DistributedOptimizer(hvd.adam(1e-2),
                                  compression=_compression(compression),
                                  error_feedback=error_feedback,
                                  shard_optimizer=shard)
    st = tx.init(params)
    x = shard_batch(torch.from_numpy(inp["x"]))
    y = shard_batch(torch.from_numpy(inp["y"]))
    loss = None
    for _ in range(steps):
        w = params["w"].clone().requires_grad_()
        b = params["b"].clone().requires_grad_()
        loss = ((x @ w + b[None] - y) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, [w, b])
        u, st = tx.update({"w": gw, "b": gb}, st, params)
        params = {k: params[k] + u[k] for k in params}
        loss = hvd.allreduce(loss.detach(), hvd.Average)
    return {"params": {k: v.numpy() for k, v in params.items()},
            "loss": float(loss)}


def optim_worker(one_update_cases, trajectory_cases):
    """Every optimizer case of tests/test_torch_optim.py in one world."""
    return {
        "one": {key: one_update_worker(inp, shard, inner)
                for key, (inp, shard, inner) in one_update_cases.items()},
        "traj": {key: trajectory_worker(inp, *args)
                 for key, (inp, args) in trajectory_cases.items()},
    }


def plan_leaf(first, c):
    """The kernel's rule: chunk ``c`` belongs to the last leaf ``j`` with
    ``first[j] <= c``."""
    import bisect

    return bisect.bisect_right(list(first[:-1]), c) - 1


def emulate_fused_adam(setattr_, launched):
    """Send CPU tensors down ``ops.kernels``' CUDA path (``setattr_``:
    ``monkeypatch.setattr``, or ``setattr`` in a world's child) and run
    the ``fused_adam`` launches through a Python model of the kernel: it
    reads the table the wrapper passes (pointers, lengths, prefix), walks
    every chunk by the kernel's rule and writes the plain version's update
    (and the int8 epilogue) through the pointers. ``launched`` collects
    ``(leaves, epilogue)`` per launch."""
    import ctypes

    from horovod_tpu_torch.ops import kernels as K

    def at(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr)) if n \
            else np.zeros(0)

    def launch(kernel, lib, sym, device, ptrs, n, first, k, q, s, *consts):
        assert sym == "hvd_fused_adam" and len(consts) == 9
        c = dict(zip(("omb1", "b1", "omb2", "b2", "b1c", "b2c", "eps",
                      "eps_root", "neg_lr"), consts))
        tp = at(ptrs, 6 * k, ctypes.c_longlong).reshape(k, 6)
        tn, tf = at(n, k, ctypes.c_longlong), at(first, k + 1, ctypes.c_int)
        for ch in range(int(tf[k])):
            j = plan_leaf(tf, ch)
            lo = (ch - int(tf[j])) * K.ADAM_CHUNK
            hi = min(lo + K.ADAM_CHUNK, int(tn[j]))
            io = [torch.from_numpy(at(int(tp[j, i]) + 4 * lo, hi - lo,
                                      ctypes.c_float)) for i in range(6)]
            for dst, val in zip(io[3:], K.fused_adam_plain(*io[:3], c)):
                dst.copy_(val)
        if q is not None:           # the epilogue: one leaf, whole blocks
            L = int(tn[0])
            g, mu, nu = (torch.from_numpy(at(int(tp[0, i]), L, ctypes.c_float))
                         for i in range(3))
            *_, (qq, ss) = K.fused_adam_requant_plain(g, mu, nu, c)
            torch.from_numpy(at(q, qq.numel(), ctypes.c_int8)).copy_(qq)
            torch.from_numpy(at(s, ss.numel(), ctypes.c_int16)).copy_(
                ss.view(torch.int16))
        launched.append((k, q is not None))

    setattr_(K, "_on_cuda", lambda *ts: True)
    setattr_(K, "_launch", launch)


def fused_adam_state_worker(inp, steps, lr):
    """Allreduce mode (no compression) on the linear problem of
    :func:`trajectory_worker`, fused Adam through its launch path with the
    kernel modelled (:func:`emulate_fused_adam`): ``steps`` steps of
    ``DistributedOptimizer(fused_adam)``, and the same steps alternating
    fused_adam and adam on each other's state; then one fused step from
    the JAX package's state after ``steps`` steps (``inp["jax"]``)."""
    from horovod_tpu_torch.training import shard_batch

    emulate_fused_adam(setattr, [])  # the flat-buffer path, kernel modelled
    x = shard_batch(torch.from_numpy(inp["x"]))
    y = shard_batch(torch.from_numpy(inp["y"]))
    txs = {"fused": hvd.DistributedOptimizer(hvd.fused_adam(lr)),
           "adam": hvd.DistributedOptimizer(hvd.adam(lr))}

    def grads(params):
        w = params["w"].clone().requires_grad_()
        b = params["b"].clone().requires_grad_()
        gw, gb = torch.autograd.grad(((x @ w + b[None] - y) ** 2).mean(),
                                     [w, b])
        return {"w": gw, "b": gb}

    def run(params, st, names):
        for name in names:
            u, st = txs[name].update(grads(params), st, params)
            params = {k: params[k] + u[k] for k in params}
        return params, st

    def numpy(params, st):
        return {"params": {k: v.numpy() for k, v in params.items()},
                "count": st["count"],
                **{m: {k: v.numpy() for k, v in st[m].items()}
                   for m in ("mu", "nu")}}

    p0 = {k: torch.from_numpy(inp[k].copy()) for k in ("w", "b")}
    pf, sf = run(p0, txs["fused"].init(p0), ["fused"] * steps)
    pa, sa = run(p0, txs["adam"].init(p0), [("fused", "adam")[i % 2]
                                            for i in range(steps)])
    j = inp["jax"]
    pj = {k: torch.from_numpy(j["params"][k].copy()) for k in ("w", "b")}
    sj = {"count": int(j["count"]),
          **{m: {k: torch.from_numpy(j[m][k].copy()) for k in ("w", "b")}
             for m in ("mu", "nu")}}
    pj, sj = run(pj, sj, ["fused"])
    storages = {m: len({v.untyped_storage().data_ptr() for v in sf[m].values()})
                for m in ("mu", "nu")}
    return {"fused": numpy(pf, sf), "alternating": numpy(pa, sa),
            "from_jax": numpy(pj, sj), "storages": storages}


def slice_worker(params, stats, x, y, steps, lr):
    """The slice end to end: a narrow f32 ResNet, weights carried across,
    ZeRO-1 + int8 + EF + fused Adam through make_train_step."""
    from horovod_tpu_torch.models import BottleneckBlock, ResNet
    from horovod_tpu_torch.models.convert import (
        flatten_tree, flax_params, load_flax_variables,
    )

    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10,
                   num_filters=8, dtype=torch.float32)
    load_flax_variables(model, params, stats)
    tx = hvd.DistributedOptimizer(hvd.fused_adam(lr),
                                  compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=True)
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    xs = hvd.shard_batch(torch.from_numpy(x))
    ys = hvd.shard_batch(torch.from_numpy(y))
    losses = []
    for _ in range(steps):
        st, loss = step(st, xs, ys)
        losses.append(float(loss))
    return {"losses": losses,
            "params": flatten_tree(flax_params(model)),
            "stats": {k: v.numpy().copy()
                      for k, v in model.jax_batch_stats().items()},
            "residual": st["residual"]["float32"].numpy()}


def lm_slice_worker(cfg, params, tokens, targets, steps, lr):
    """The LM slice end to end: an f32 TransformerLM with flash attention,
    weights carried across, DistributedOptimizer(adamw) + lm_xent through
    make_train_step, this rank's rows of the global batch."""
    import functools

    from horovod_tpu_torch.models import TransformerLM
    from horovod_tpu_torch.models.convert import (
        flatten_tree, flax_params, load_flax_variables,
    )

    model = TransformerLM(**cfg, dtype=torch.float32,
                          attention_fn=functools.partial(hvd.flash_attention,
                                                         block_k=8))
    load_flax_variables(model, params)
    tx = hvd.DistributedOptimizer(hvd.adamw(lr))
    st = hvd.broadcast_optimizer_state(tx.init(model.jax_params()))
    step = hvd.make_train_step(model, tx, loss_fn=hvd.lm_xent)
    xs = hvd.shard_batch(torch.from_numpy(tokens))
    ys = hvd.shard_batch(torch.from_numpy(targets))
    losses = []
    for _ in range(steps):
        st, loss = step(st, xs, ys)
        losses.append(float(loss))
    return {"losses": losses, "params": flatten_tree(flax_params(model))}


# --------------------------------------------------------------------------
# ZeRO-3 (tests/test_torch_fsdp.py)


def _np_any(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _narrow_resnet(params, stats):
    from horovod_tpu_torch.models import BottleneckBlock, ResNet
    from horovod_tpu_torch.models.convert import load_flax_variables

    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10,
                   num_filters=8, dtype=torch.float32)
    load_flax_variables(model, params, stats)
    return model


def _run_steps(model, tx, x, y, steps, record_at, **kw):
    """``steps`` steps of make_train_step on this rank's rows; returns the
    losses, the full params after each step in ``record_at`` and the final
    BatchNorm running stats."""
    step = hvd.make_train_step(model, tx, **kw)
    zero3 = kw.get("shard_params", False)
    st = tx.init(step.params if zero3 else model.jax_params())
    xs, ys = hvd.shard_batch(torch.from_numpy(x)), hvd.shard_batch(
        torch.from_numpy(y))
    losses, snaps = [], {}
    for i in range(steps):
        st, loss = step(st, xs, ys)
        losses.append(float(loss))
        if i + 1 in record_at:
            tree = (hvd.fsdp_unpack_params(step.params) if zero3
                    else model.jax_params())
            snaps[i + 1] = {k: _np_any(v) for k, v in tree.items()}
    stats = {k: _np_any(v) for k, v in model.jax_batch_stats().items()}
    return {"losses": losses, "params": snaps, "stats": stats}


def fsdp_worker(inp, steps, lr):
    """Every ZeRO-3 case of tests/test_torch_fsdp.py in one world."""
    import os

    from horovod_tpu_torch.models.convert import fsdp_params_from_jax
    from horovod_tpu_torch.ops.collective import quantized_all_gather

    r, n = hvd.rank(), hvd.size()
    out = {}
    # pack / unpack / gather of a mixed f32/bf16 tree
    mixed = {k: torch.from_numpy(v) for k, v in inp["mixed"].items()}
    mixed["b/c"] = mixed["b/c"].to(torch.bfloat16)
    fp = hvd.fsdp_pack_params(mixed)
    out["pack_rows"] = {k: _np_any(v) for k, v in fp.shards.items()}
    un = hvd.fsdp_unpack_params(fp)
    ga = hvd.fsdp_gather_params(fp, wire="none")
    out["roundtrip"] = all(un[k].dtype == v.dtype and torch.equal(un[k], v)
                           for k, v in mixed.items())
    out["gather"] = all(torch.equal(ga[k], v) for k, v in mixed.items())
    # the int8 gather and its backward
    shard = torch.from_numpy(inp["gather_shard"][r]).requires_grad_()
    full = quantized_all_gather(shard)
    (g,) = torch.autograd.grad(full, shard, torch.from_numpy(inp["ct"][r]))
    out["qgather"], out["qgather_grad"] = _np_any(full), _np_any(g)
    os.environ["HOROVOD_FSDP_WIRE"] = "fp8"
    try:
        hvd.fsdp_gather_params(fp)
        out["fp8"] = None
    except ValueError as e:
        out["fp8"] = str(e)
    # trajectories from the JAX weights: ZeRO-1, ZeRO-3 on both wires
    args = (inp["x"], inp["y"], steps, (3, steps))
    model = _narrow_resnet(inp["params"], inp["stats"])
    tx1 = hvd.DistributedOptimizer(hvd.fused_adam(lr), shard_optimizer=True)
    st1 = tx1.init(model.jax_params())
    out["zero1"] = _run_steps(model, tx1, *args, shard_optimizer=True)
    for wire in ("none", "int8"):
        os.environ["HOROVOD_FSDP_WIRE"] = wire
        model = _narrow_resnet(inp["params"], inp["stats"])
        fp = fsdp_params_from_jax(inp["rows"], model.jax_params(), r)
        tx3 = hvd.DistributedOptimizer(hvd.fused_adam(lr), shard_params=True)
        if wire == "none":
            st3 = tx3.init(fp)
            out["init_equal"] = (
                st3["shard"] == st1["shard"]
                and st3["inner"]["count"] == st1["inner"]["count"]
                and all(torch.equal(st3["inner"][m][k], st1["inner"][m][k])
                        for m in ("mu", "nu") for k in st1["inner"][m]))
        out[f"zero3_{wire}"] = _run_steps(model, tx3, *args,
                                          shard_params=True, params=fp)
        if wire == "none":       # what the step holds between steps
            out["storage"] = {
                "model_params": sum(p.numel() for p in model.parameters()),
                "shards": sum(v.numel() for v in fp.shards.values()),
                "row": sum(v.shape[1] for v in inp["rows"].values())}
    del os.environ["HOROVOD_FSDP_WIRE"]
    return out


# --------------------------------------------------------------------------
# Adasum (tests/test_torch_adasum.py)


def adasum_worker(inp):
    """Adasum of this rank's rows: single tensors (f32, f16) and a group,
    and with ``inp["train"]`` the DistributedOptimizer(op=Adasum) runs."""
    from horovod_tpu_torch.ops.adasum import (
        adasum_allreduce, grouped_adasum_allreduce,
    )

    out = {"pair": {k: _np_any(adasum_allreduce(_mine(v)))
                    for k, v in inp["pair"].items()},
           "public": _np_any(hvd.allreduce(_mine(inp["pair"]["f32"]),
                                           hvd.Adasum)),
           "group": [_np_any(t) for t in grouped_adasum_allreduce(
               [_mine(v) for v in inp["group"]])]}
    out["pair"]["f16"] = _np_any(adasum_allreduce(
        _mine(inp["pair"]["f32"]).to(torch.float16)))
    if "packed" in inp:
        out["packed"] = packed_adasum_worker(inp["packed"])
    train = inp.get("train")
    if train:
        for name, comp in (("grouped", None), ("fp16", hvd.Compression.fp16)):
            model = _narrow_resnet(train["params"], train["stats"])
            tx = hvd.DistributedOptimizer(hvd.fused_adam(train["lr"]),
                                          op=hvd.Adasum, compression=comp)
            out[name] = _run_steps(model, tx, train["x"], train["y"],
                                   train["steps"], (train["steps"],))
    return out


class F16Compressor(hvd.Compression.fp16):
    """A 16-bit wire in float16 (``Compression.fp16`` puts bfloat16 on
    it): the packed route in the other 16-bit type."""

    @staticmethod
    def compress(tensor):
        return tensor.to(torch.float16), tensor.dtype


#: the combine wrappers and the exchange a compressed-Adasum update may
#: reach, counted per update
ADASUM_CALLS = ("adasum_pair_combine", "adasum_pair_combine_packed",
                "adasum_segment_combine")


def packed_adasum_worker(leaves):
    """``DistributedOptimizer(op=Adasum, compression=...)`` (identity
    inner optimizer) on this rank's rows of ``leaves`` against each
    leaf's own ``allreduce(g, Adasum, compression=...)``, for
    ``Compression.fp16`` (bf16 wire) and :class:`F16Compressor`; with the
    kernel-wrapper and exchange calls of each update."""
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.testing import watching_calls

    grads = {k: _mine(v) for k, v in leaves.items()}
    out = {}
    for name, comp in (("bf16", hvd.Compression.fp16), ("f16", F16Compressor)):
        tx = hvd.DistributedOptimizer(_identity(), op=hvd.Adasum,
                                      compression=comp)
        counts: dict = {}

        def count(fn, args, kw):
            counts[fn] = counts.get(fn, 0) + 1

        with watching_calls(K, ADASUM_CALLS, count), \
                watching_calls(A, ("_exchange",), count):
            packed, _ = tx.update(grads, tx.init(grads))
        own = {k: hvd.allreduce(g, hvd.Adasum, compression=comp)
               for k, g in grads.items()}
        out[name] = {"packed": {k: _np_any(v) for k, v in packed.items()},
                     "own": {k: _np_any(v) for k, v in own.items()},
                     "counts": counts}
    return out


def adasum_world_error_worker():
    from horovod_tpu_torch.ops.adasum import adasum_allreduce

    try:
        adasum_allreduce(torch.ones(4))
    except ValueError as e:
        return str(e)
    return None


# --------------------------------------------------------------------------
# the fused exchange (tests/test_torch_grouped.py)

#: the kernel wrappers the int8 exchange reaches, counted per update
INT8_WRAPPERS = ("quantize_roundtrip", "quantize_blockwise",
                 "dequant_accumulate_requantize", "dequantize_rows")


def _tree(spec, seed):
    """This rank's leaves of ``spec`` (``{key: (shape, dtype name)}``),
    random from ``seed`` and the rank."""
    gen = torch.Generator().manual_seed(seed * 100 + hvd.rank())
    return {k: torch.randn(shape, generator=gen).to(getattr(torch, dt))
            for k, (shape, dt) in spec.items()}


def dispatch_counts(spec, error_feedback):
    """Kernel-wrapper and collective calls of one allreduce-mode int8
    update (identity inner optimizer) of a tree of ``spec``; also whether
    the new residual keeps the parameters' keys, shapes and dtypes."""
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.testing import watching_calls

    params = _tree(spec, 1)
    tx = hvd.DistributedOptimizer(_identity(), compression=hvd.Compression.int8,
                                  error_feedback=error_feedback)
    st = tx.init(params)
    counts: dict = {}

    def count(name, args, kw):
        counts[name] = counts.get(name, 0) + 1

    with watching_calls(K, INT8_WRAPPERS, count), watching_calls(
            C.dist, ("all_to_all_single", "all_gather_single",
                     "all_gather_into_tensor", "all_reduce"), count):
        _, st = tx.update(_tree(spec, 2), st, params)
    res = st["residual"] if error_feedback else params
    layout = set(res) == set(params) and all(
        res[k].shape == p.shape and res[k].dtype == p.dtype
        for k, p in params.items())
    return {"counts": counts, "layout": layout}


def residual_worker(inp):
    """Two allreduce-mode int8 + EF updates (identity inner optimizer) on
    ``inp["g1"]``, ``inp["g2"]``: each step's new residual."""
    keys = list(inp["g1"])
    params = {k: torch.zeros(inp["g1"][k].shape[1:]) for k in keys}
    tx = hvd.DistributedOptimizer(_identity(), compression=hvd.Compression.int8,
                                  error_feedback=True)
    st = tx.init(params)
    out = []
    for g in (inp["g1"], inp["g2"]):
        _, st = tx.update({k: _mine(g[k]) for k in keys}, st, params)
        out.append({k: v.numpy().copy() for k, v in st["residual"].items()})
    return out


def grouped_worker(inp):
    """Every case of tests/test_torch_grouped.py on this world: the fused
    int8 exchange (``ops.collective._grouped_allreduce``, which allreduce
    mode calls) and grouped_allreduce of this rank's rows, and (where
    ``inp`` asks) the allreduce-mode trajectory, the residual steps and
    the dispatch counts."""
    int8 = hvd.Compression.int8
    leaves = [_mine(x) for x in inp["int8"]]
    mixed = [_mine(x).to(getattr(torch, dt)) for x, dt in inp["mixed"]]
    out = {}
    for name, op in (("avg", hvd.Average), ("sum", hvd.Sum)):
        out[f"int8_{name}"] = [_np_any(t) for t in C._grouped_allreduce(
            leaves, op, int8)[0]]
        out[f"mixed_{name}"] = [_np_any(t) for t in hvd.grouped_allreduce(
            mixed, op)]
        out[f"mixed_int8_{name}"] = [_np_any(t) for t in C._grouped_allreduce(
            mixed, op, int8)[0]]
    out["mixed_min"] = [_np_any(t) for t in hvd.grouped_allreduce(mixed, hvd.Min)]
    if "traj" in inp:
        out["traj"] = trajectory_worker(inp["traj"], False, "int8", True,
                                        inp["traj_steps"])
    if "residual" in inp:
        out["residual"] = residual_worker(inp["residual"])
    if "dispatch" in inp:
        out["dispatch"] = {name: dispatch_counts(spec, ef)
                           for name, (spec, ef) in inp["dispatch"].items()}
    return out


def test_train_step_with_a_plain_optimizer_allreduces_itself(monkeypatch):
    """make_train_step given a plain optimizer exchanges the gradients
    itself (the reference step): same result as DistributedOptimizer."""
    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16, 16, 3, generator=gen)
    y = torch.randint(0, 5, (4,), generator=gen)
    hvd.init(device="cpu")
    try:
        out = []
        for tx in (hvd.adam(1e-2), hvd.DistributedOptimizer(hvd.adam(1e-2))):
            m = ResNet([1, 1], BottleneckBlock, num_filters=4, num_classes=5,
                       dtype=torch.float32, seed=2)
            step = hvd.make_train_step(m, tx)
            st, losses = tx.init(m.jax_params()), []
            for _ in range(2):
                st, loss = step(st, x, y)
                losses.append(float(loss))
            out.append((losses, [p.detach().clone() for p in m.parameters()]))
        assert out[0][0] == out[1][0]
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
        with pytest.raises(ValueError, match="shard_optimizer"):
            hvd.make_train_step(m, hvd.adam(1e-2), shard_optimizer=True)
    finally:
        hvd.shutdown()


def test_train_step_phase_hook_sees_each_part_and_changes_nothing(monkeypatch):
    """``on_phase`` is called once per part of the step, in order, and a
    step with the hook computes what the step without it computes."""
    from horovod_tpu_torch.models import TransformerLM

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    tok = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(3))
    hvd.init(device="cpu")
    try:
        out, seen = [], []
        for hook in (None, seen.append):
            m = TransformerLM(vocab=64, dim=32, depth=2, heads=4, max_len=16,
                              dtype=torch.float32, pos_embedding="rope", seed=1)
            tx = hvd.DistributedOptimizer(hvd.adamw(1e-3))
            step = hvd.make_train_step(m, tx, loss_fn=hvd.lm_xent, on_phase=hook)
            st, losses = tx.init(m.jax_params()), []
            for _ in range(2):
                st, loss = step(st, tok, tok.roll(-1, 1))
                losses.append(float(loss))
            out.append((losses, [p.detach().clone() for p in m.parameters()]))
        assert seen == ["forward", "backward", "optimizer", "loss"] * 2
        assert out[0][0] == out[1][0]
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# broadcast_object and broadcast_optimizer_state (tests/test_torch_collective.py)


class Moments(NamedTuple):
    mu: object
    nu: object


def bcast_state(r):
    """An optimizer state whose every leaf depends on the rank ``r``:
    floats, ints, a bool, strings, ``None``, tensors inside a list, a
    tuple and a named tuple."""
    return {"count": 3 + r, "lr": 0.1 + 0.2 * r, "name": f"adam{r}",
            "flag": r == 0, "none": None,
            "list": [torch.full((3,), float(r)), 7 + r],
            "tuple": (torch.arange(4.0) * (r + 1), f"t{r}"),
            "moments": Moments(torch.full((2, 2), r + 0.5), 1e-8 * (r + 1))}


def _tree_out(x):
    """``x`` with its tensors as numpy arrays, containers and types kept."""
    if isinstance(x, dict):
        return type(x)((k, _tree_out(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        items = [_tree_out(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return _np_any(x) if isinstance(x, torch.Tensor) else x


def broadcast_worker():
    """Rank 0's state through broadcast_optimizer_state, a ZeRO-1 state
    through it, and the last rank's object through broadcast_object."""
    r, n = hvd.rank(), hvd.size()
    zero = {"shard": {"rank": r, "size": n}, "inner": bcast_state(r)}
    return {"state": _tree_out(hvd.broadcast_optimizer_state(bcast_state(r))),
            "zero1_untouched": hvd.broadcast_optimizer_state(zero) is zero,
            "object": hvd.broadcast_object(
                {"x": [1.5 + r, f"s{r}", None], "y": (r, 0.1 * r)},
                root_rank=n - 1)}
