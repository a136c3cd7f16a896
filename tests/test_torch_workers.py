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

    def launch(kernel, lib, sym, device, ptrs, n, first, k, dtype, q, s, bc,
               *consts):
        assert sym == "hvd_fused_adam" and len(consts) == 9
        c = dict(zip(("omb1", "b1", "omb2", "b2", "b1c", "b2c", "eps",
                      "eps_root", "neg_lr"), consts))
        if bc is not None:          # the device bias corrections
            c["b1c"], c["b2c"] = (float(v) for v in at(bc, 2, ctypes.c_float))
        elem, item = ((ctypes.c_float, 4), (ctypes.c_int16, 2))[dtype]

        def view(ptr, count):
            t = torch.from_numpy(at(ptr, count, elem))
            return t.view(torch.bfloat16) if dtype == 1 else t

        tp = at(ptrs, 6 * k, ctypes.c_longlong).reshape(k, 6)
        tn, tf = at(n, k, ctypes.c_longlong), at(first, k + 1, ctypes.c_int)
        for ch in range(int(tf[k])):
            j = plan_leaf(tf, ch)
            lo = (ch - int(tf[j])) * K.ADAM_CHUNK
            hi = min(lo + K.ADAM_CHUNK, int(tn[j]))
            io = [view(int(tp[j, i]) + item * lo, hi - lo) for i in range(6)]
            for dst, val in zip(io[3:], K.fused_adam_plain(*io[:3], c)):
                dst.copy_(val)
        if q is not None:           # the epilogue: one leaf, whole blocks
            L = int(tn[0])
            g, mu, nu = (view(int(tp[0, i]), L) for i in range(3))
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

    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10,
                   num_filters=8, dtype=torch.float32)
    return _zero1_int8_steps(model, params, stats, x, y, steps, lr)


def model_slice_worker(spec, params, stats, x, y, steps, lr):
    """:func:`slice_worker`'s steps on another f32 model: ``spec`` names
    the family and its configuration (``{"family": "vgg", ...}``)."""
    from horovod_tpu_torch import models as M

    spec = dict(spec)
    family = spec.pop("family")
    if family != "vgg":
        raise ValueError(family)
    model = M.VGG(spec.pop("stages"), dtype=torch.float32, **spec)
    return _zero1_int8_steps(model, params, stats, x, y, steps, lr)


def _zero1_int8_steps(model, params, stats, x, y, steps, lr):
    from horovod_tpu_torch.models.convert import (
        flatten_tree, flax_params, load_flax_variables,
    )

    load_flax_variables(model, params, stats or None)
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
    bucketed_zero3_cases(out, inp, mixed, args, lr)
    del os.environ["HOROVOD_FSDP_WIRE"]
    return out


def bucketed_zero3_cases(out, inp, mixed, args, lr):
    """Bucketed ZeRO-3 (``bucket_bytes``): the packed rows of the mixed
    tree, the gather giving it back, the refusal of a pack of another
    size, the gathers and reduce-scatters of one step, and the exact-wire
    trajectory beside bucketed ZeRO-1 at the same size."""
    import os

    import torch.distributed as dist

    from horovod_tpu_torch.testing import watching_calls

    bb = inp["bucket_bytes"]
    os.environ["HOROVOD_FSDP_WIRE"] = "none"
    fpb = hvd.fsdp_pack_params(mixed, bucket_bytes=inp["mixed_bucket_bytes"])
    out["bucket_rows"] = {k: _np_any(v) for k, v in fpb.shards.items()}
    ga = hvd.fsdp_gather_params(fpb)
    out["bucket_gather"] = all(torch.equal(ga[k], v) for k, v in mixed.items())
    tx = hvd.DistributedOptimizer(hvd.fused_adam(lr), shard_params=True,
                                  bucket_bytes=2 * inp["mixed_bucket_bytes"])
    out["bucket_mismatch"] = _err(lambda: tx.init(fpb))
    model = _narrow_resnet(inp["params"], inp["stats"])
    tx1 = hvd.DistributedOptimizer(hvd.fused_adam(lr), shard_optimizer=True,
                                   bucket_bytes=bb)
    out["zero1_bucketed"] = _run_steps(model, tx1, *args,
                                       shard_optimizer=True)
    model = _narrow_resnet(inp["params"], inp["stats"])
    tx3 = hvd.DistributedOptimizer(hvd.fused_adam(lr), shard_params=True,
                                   bucket_bytes=bb)
    out["zero3_bucketed"] = _run_steps(model, tx3, *args, shard_params=True)
    # one more step, its collectives counted
    model = _narrow_resnet(inp["params"], inp["stats"])
    step = hvd.make_train_step(model, tx3, shard_params=True)
    st = tx3.init(step.params)
    calls = {}

    def count(name, a, kw):
        calls[name] = calls.get(name, 0) + 1

    xs, ys = (hvd.shard_batch(torch.from_numpy(v)) for v in args[:2])
    with watching_calls(C, ("gather_shards",), count), \
            watching_calls(dist, ("reduce_scatter_tensor",
                                  "reduce_scatter_single"), count):
        step(st, xs, ys)
    out["zero3_bucketed_calls"] = calls
    out["zero3_bucketed_groups"] = sorted(step.params.shards)


def zero3_ckpt_worker(base, params, stats, x, y, bb, lr, phase):
    """The bucketed ZeRO-3 checkpoint across world sizes. ``run``: 3
    steps, saving after the second into ``base/a``; ``move``: restore
    ``base/a`` at this world's size and save it unstepped into
    ``base/b``; ``resume``: restore ``base/b`` and take the third step.
    Returns the losses and the full parameters."""
    import os

    import horovod_tpu_torch.checkpoint as ck

    os.environ["HOROVOD_FSDP_WIRE"] = "none"
    model = _narrow_resnet(params, stats)
    tx = hvd.DistributedOptimizer(hvd.fused_adam(lr), shard_params=True,
                                  bucket_bytes=bb)
    xs, ys = (hvd.shard_batch(torch.from_numpy(v)) for v in (x, y))
    losses = []
    if phase == "move":
        tree = ck.restore(os.path.join(base, "a"), 2)
        fp = ck.fsdp_params(tree["params"])
        st = ck.consolidate_opt_state(tree["opt"], tree["params"])
        ck.save(os.path.join(base, "b"), 2, {"params": fp, "opt": st})
        full = hvd.fsdp_unpack_params(fp)
        return {"losses": losses, "size": fp.meta.size,
                "groups": sorted(fp.shards),
                "params": {k: _np_any(v) for k, v in full.items()}}
    if phase == "resume":
        tree = ck.restore(os.path.join(base, "b"), 2)
        fp = ck.fsdp_params(tree["params"])
        st = ck.consolidate_opt_state(tree["opt"], tree["params"])
        step = hvd.make_train_step(model, tx, shard_params=True, params=fp)
        todo = 1
    else:
        step = hvd.make_train_step(model, tx, shard_params=True)
        st = tx.init(step.params)
        todo = 3
    for i in range(todo):
        st, loss = step(st, xs, ys)
        losses.append(float(loss))
        if phase == "run" and i == 1:
            ck.save(os.path.join(base, "a"), 2, {"params": step.params,
                                                 "opt": st})
    full = hvd.fsdp_unpack_params(step.params)
    return {"losses": losses,
            "params": {k: _np_any(v) for k, v in full.items()},
            "count": int(st["inner"]["count"])}


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


# --------------------------------------------------------------------------
# checkpoint across ranks (tests/test_torch_checkpoint.py)


def ckpt_state(r=0):
    """A state of tensors (f32, int32, bf16), a numpy array and objects;
    ``r`` makes a rank's state its own."""
    return {"params": {"w": torch.arange(6.0).reshape(2, 3) + 10 * r,
                       "h": torch.tensor([1.5, -2.25, 3.0]).bfloat16() + r},
            "ids": torch.arange(5, dtype=torch.int32) * (r + 1),
            "host": np.full((2, 2), 0.5 + r, np.float32),
            "step": 7 + r, "meta": ("adam", None, [0.1 * (r + 1)])}


def ckpt_root_worker(base):
    """Every rank saves its own state into its own directory (only rank
    0 writes, so only rank 0's holds the step), restores from it, and
    reports what it got and whether the others' directories stayed
    empty."""
    import os

    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.training import host_snapshot

    r = hvd.rank()
    mine = os.path.join(base, f"rank{r}")
    ck.save(mine, 3, ckpt_state(r))
    hvd.broadcast_object(None)                    # every save has returned
    others_empty = all(not os.path.exists(os.path.join(base, f"rank{q}"))
                       for q in range(1, hvd.size()))
    return {"restored": host_snapshot(ck.restore(mine, 3)),
            "others_empty": others_empty}


def ckpt_writer_failure_worker(base):
    """A second save of the same step without ``force``: rank 0's write
    fails, and every rank must raise. Async too, at the fence."""
    from horovod_tpu_torch import checkpoint as ck

    ck.save(base, 1, ckpt_state())
    out = []
    try:
        ck.save(base, 1, ckpt_state())
        out.append(None)
    except (FileExistsError, RuntimeError) as e:
        out.append(type(e).__name__)
    mgr = ck.CheckpointManager(base)
    mgr.save(1, ckpt_state(), asynchronous=True)
    try:
        mgr.wait_until_finished()
        out.append(None)
    except (FileExistsError, RuntimeError) as e:
        out.append(type(e).__name__)
    return out


def zero1_save_worker(base, count, mu, nu, residual, params):
    """This rank's ZeRO-1 + EF state from the JAX package's ``[N, s]``
    rows, saved (gathered back to the rows), then restored at the same
    size: returns the rank's state as it held it and as it came back."""
    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.models.convert import zero1_state_from_jax
    from horovod_tpu_torch.training import host_snapshot

    st = zero1_state_from_jax(count, mu, nu, hvd.rank(), residual=residual)
    ck.save(base, 5, {"opt": st, "step": 5})
    back = ck.consolidate_opt_state(
        ck.restore(base, 5)["opt"],
        {k: torch.from_numpy(v) for k, v in params.items()})
    return {"held": host_snapshot(st), "back": host_snapshot(back)}


def zero1_restore_worker(base, params):
    """Restore a ZeRO-1 state saved by another world and make it this
    rank's state in this world."""
    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.training import host_snapshot

    tree = ck.restore(base, 5)
    return host_snapshot(ck.consolidate_opt_state(
        tree["opt"], {k: torch.from_numpy(v) for k, v in params.items()}))


# --------------------------------------------------------------------------
# bucketed overlap, PowerSGD, MultiSteps, the tape


def _leaves_of(tree: dict) -> dict:
    """This rank's leaves of ``{key: (stacked [N, ...], dtype name)}``."""
    return {k: _mine(x).to(getattr(torch, dt)) for k, (x, dt) in tree.items()}


def _np_tree(tree):
    if tree is None:
        return None
    return {k: (None if v is None else _np_any(v)) for k, v in tree.items()}


def _inner_tx(name: str):
    return _identity() if name == "identity" else hvd.fused_adam(1e-2)


def bucketed_worker(tree, cases):
    """``bucketed_allreduce`` of this rank's leaves, one result per case
    ``name: (op, compression, residual {bucket: stacked} or None,
    predivide, bucket_bytes)``; also the port's per-leaf allreduce of the
    same leaves, for the cases without a residual."""
    from horovod_tpu_torch.ops import overlap as ov

    leaves = _leaves_of(tree)
    out = {}
    for name, (op, comp, residual, pf, bb) in cases.items():
        res = None if residual is None else {
            k: _mine(v).to(getattr(torch, k.partition("#")[0]))
            for k, v in residual.items()}
        red, new = ov.bucketed_allreduce(
            leaves, op, compression=_compression(comp), bucket_bytes=bb,
            predivide=pf, residual=res)
        out[name] = {"reduced": _np_tree(red), "residual": _np_tree(new)}
        if residual is None and pf == 1.0:
            out[name]["per_leaf"] = _np_tree({
                k: hvd.allreduce(v, op, compression=_compression(comp))
                for k, v in leaves.items()})
    return out


def overlap_traj_worker(p0, steps, shard, comp, ef, bucket_bytes, inner):
    """``len(steps)`` updates of ``DistributedOptimizer(inner, ...)`` from
    the parameters ``p0`` with this rank's gradients of each step (updates
    added to the parameters): the final parameters, the state's group keys
    and its residual and Adam moments (this rank's)."""
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tx = hvd.DistributedOptimizer(
        _inner_tx(inner), compression=_compression(comp), error_feedback=ef,
        shard_optimizer=shard, overlap=bucket_bytes is not None,
        bucket_bytes=bucket_bytes)
    st = tx.init(params)
    for g in steps:
        u, st = tx.update({k: _mine(v) for k, v in g.items()}, st, params)
        params = {k: params[k] + u[k] for k in params}
    inner_st = st["inner"] if (ef or shard) else st
    return {"params": _np_tree(params),
            "residual": _np_tree(st["residual"]) if ef else None,
            "mu": _np_tree(inner_st["mu"]) if inner == "adam" else None,
            "nu": _np_tree(inner_st["nu"]) if inner == "adam" else None,
            "count": inner_st.get("count")}


def _small_resnet(seed=0):
    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    return ResNet([1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                  seed=seed)


def hook_route_worker(x, y, steps, cases):
    """Each case ``name: (shard, compression, ef, bucket_bytes)``: the
    small ResNet trained ``steps`` steps through ``make_train_step`` with
    the buckets launched from the backward's hooks, and again exchanging
    after the backward (the same optimizer without its ``exchange``): both
    routes' parameters and states, and how many buckets the hooks
    started."""
    xs = hvd.shard_batch(torch.from_numpy(x))
    ys = hvd.shard_batch(torch.from_numpy(y))
    out = {}
    for name, (shard, comp, ef, bb) in cases.items():
        res = {}
        for route in ("hooks", "after"):
            model = _small_resnet()
            tx = hvd.DistributedOptimizer(
                hvd.fused_adam(1e-2), compression=_compression(comp),
                error_feedback=ef, shard_optimizer=shard, bucket_bytes=bb)
            if route == "after":
                tx = tx._replace(exchange=None)
            step = hvd.make_train_step(model, tx, shard_optimizer=shard)
            st = tx.init(model.jax_params())
            losses = []
            for _ in range(steps):
                st, loss = step(st, xs, ys)
                losses.append(float(loss))
            ex = step.last_exchange
            for h in step.hooks:
                h.remove()
            res[route] = {
                "params": _np_tree(model.jax_params()), "losses": losses,
                "residual": _np_tree(st["residual"]) if ef else None,
                "mu": _np_tree((st["inner"] if (ef or shard) else st)["mu"]),
                "started": None if ex is None else (ex.in_backward,
                                                    len(ex.order))}
        out[name] = res
    return out


def quantized_rs_worker(flat):
    return _np_any(C.quantized_reducescatter(_mine(flat)))


def tape_worker(tree, cases):
    """``DistributedGradientTape`` over a function returning ``(0-d loss,
    this rank's leaves)`` for each case ``name: (op, compression)``, and
    the plain-gradients form once."""
    leaves = _leaves_of(tree)
    loss = torch.tensor(float(hvd.rank()) + 0.5)
    out = {}
    for name, (op, comp) in cases.items():
        tape = hvd.DistributedGradientTape(lambda: (loss, dict(leaves)),
                                           op=op,
                                           compression=_compression(comp))
        value, grads = tape()
        out[name] = {"value": float(value), "grads": _np_tree(grads)}
    out["plain"] = _np_tree(hvd.DistributedGradientTape(
        lambda: dict(leaves))())
    return out


def predivide_worker(p0, steps, cases):
    """Each case ``name: (compression, ef, predivide)``: updates of
    ``DistributedOptimizer(identity, gradient_predivide_factor=...)``:
    each step's update and the final residual."""
    out = {}
    for name, (comp, ef, pf) in cases.items():
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        tx = hvd.DistributedOptimizer(_identity(), compression=_compression(comp),
                                      error_feedback=ef,
                                      gradient_predivide_factor=pf)
        st = tx.init(params)
        ups = []
        for g in steps:
            u, st = tx.update({k: _mine(v) for k, v in g.items()}, st, params)
            ups.append(_np_tree(u))
        out[name] = {"updates": ups,
                     "residual": _np_tree(st["residual"]) if ef else None}
    return out


def multisteps_worker(p0, steps, cases):
    """Each case ``name: (k, compression, ef, shard)``:
    ``DistributedOptimizer(identity, backward_passes_per_step=k)`` over
    the steps: each update, the final ``MultiStepsState`` and the number
    of ``torch.distributed`` calls each step made."""
    from horovod_tpu_torch.testing import watching_calls

    out = {}
    for name, (k, comp, ef, shard) in cases.items():
        params = {key: torch.from_numpy(v.copy()) for key, v in p0.items()}
        tx = hvd.DistributedOptimizer(_identity(), compression=_compression(comp),
                                      error_feedback=ef, shard_optimizer=shard,
                                      backward_passes_per_step=k)
        st = tx.init(params)
        ups, calls = [], []
        for g in steps:
            n = [0]
            with watching_calls(C.dist, DIST_NAMES,
                                lambda *a: n.__setitem__(0, n[0] + 1)):
                u, st = tx.update({key: _mine(v) for key, v in g.items()},
                                  st, params)
            calls.append(n[0])
            ups.append(_np_tree(u))
            params = {key: params[key] + u[key] for key in params}
        inner = st.inner_opt_state
        out[name] = {"updates": ups, "calls": calls,
                     "mini_step": int(st.mini_step),
                     "gradient_step": int(st.gradient_step),
                     "acc": _np_tree(st.acc_grads),
                     "residual": _np_tree(inner["residual"]) if ef else None,
                     "params": _np_tree(params)}
    return out


#: every torch.distributed call the port's collectives make
DIST_NAMES = ("all_reduce", "all_to_all_single", "all_gather_single",
              "all_gather_into_tensor", "reduce_scatter_single",
              "reduce_scatter_tensor", "broadcast", "all_gather",
              "batch_isend_irecv")


def powersgd_worker(p0, steps, cases, dtypes):
    """Each case ``name: (shard, rank, q0)``: ``DistributedOptimizer(adam,
    Compression.powersgd(rank), error_feedback=True)`` from ``p0``, its
    initial ``Q`` replaced by ``q0`` (the JAX package's draw, ``None``
    where a leaf does not factorize), over the steps: after each, the
    parameters, the residual and ``Q``. ``dtypes`` names the leaves that
    are not float32."""
    from horovod_tpu_torch.models.convert import powersgd_q_from_jax

    def dt(k):
        return getattr(torch, dtypes.get(k, "float32"))

    out = {}
    for name, (shard, rank, q0) in cases.items():
        params = {k: torch.from_numpy(v.copy()).to(dt(k))
                  for k, v in p0.items()}
        tx = hvd.DistributedOptimizer(
            hvd.adam(1e-2), compression=hvd.Compression.powersgd(rank),
            error_feedback=True, shard_optimizer=shard)
        st = tx.init(params)
        assert {k for k, q in st["q"].items() if q is not None} == \
            {k for k, q in q0.items() if q is not None}, name
        st["q"] = powersgd_q_from_jax(q0)
        trace = []
        for g in steps:
            u, st = tx.update({k: _mine(v).to(dt(k)) for k, v in g.items()},
                              st, params)
            params = {k: params[k] + u[k] for k in params}
            trace.append({"params": _np_tree(params),
                          "residual": _np_tree(st["residual"]),
                          "q": _np_tree(st["q"])})
        out[name] = trace
    return out


def powersgd_train_worker(x, y, steps, rank):
    """The test MLP trained ``steps`` steps with PowerSGD(rank) + EF and
    Adam from the port's own initial ``Q``: the losses."""
    from horovod_tpu_torch.models import MLP

    model = MLP((64, 10), in_features=x.shape[1], seed=3)
    tx = hvd.DistributedOptimizer(hvd.adam(1e-2),
                                  compression=hvd.Compression.powersgd(rank),
                                  error_feedback=True)
    step = hvd.make_train_step(model, tx)
    st = tx.init(model.jax_params())
    xs = hvd.shard_batch(torch.from_numpy(x))
    ys = hvd.shard_batch(torch.from_numpy(y))
    losses = []
    for _ in range(steps):
        st, loss = step(st, xs, ys)
        losses.append(float(loss))
    return {"losses": losses,
            "factorized": sorted(k for k, q in st["q"].items()
                                 if q is not None)}


def slice10_worker(inp):
    """Every port case of the slice-10 test files that runs in a world of
    this size, in one world."""
    out = {}
    if "bucketed" in inp:
        out["bucketed"] = bucketed_worker(*inp["bucketed"])
    if "traj" in inp:
        out["traj"] = {name: overlap_traj_worker(*args)
                       for name, args in inp["traj"].items()}
    if "hooks" in inp:
        out["hooks"] = hook_route_worker(*inp["hooks"])
    if "qrs" in inp:
        out["qrs"] = quantized_rs_worker(inp["qrs"])
    if "tape" in inp:
        out["tape"] = tape_worker(*inp["tape"])
    if "predivide" in inp:
        out["predivide"] = predivide_worker(*inp["predivide"])
    if "multisteps" in inp:
        out["multisteps"] = multisteps_worker(*inp["multisteps"])
    if "powersgd" in inp:
        out["powersgd"] = powersgd_worker(*inp["powersgd"])
    if "psgd_train" in inp:
        out["psgd_train"] = powersgd_train_worker(*inp["psgd_train"])
    return out


# --------------------------------------------------------------------------
# the numerics guard (tests/test_torch_numerics.py, tests/test_torch_collective.py)


def sgd(lr):
    """``optax.sgd(lr)`` (no momentum): ``f32(-lr) * g``, the inner
    optimizer of the JAX package's guard tests."""
    from horovod_tpu_torch.optim import Transform

    neg = float(np.float32(-lr))
    return Transform(lambda p: {},
                     lambda g, s, p=None: ({k: v * neg for k, v in g.items()},
                                           s))


def _bits_of(tree) -> list:
    """Every tensor leaf of a state tree as its raw bits (so -0.0 and +0.0
    differ), other leaves as they are."""
    from horovod_tpu_torch import pytree

    leaves, _ = pytree.flatten(tree)
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            x = x.detach().contiguous()
            if x.is_floating_point():
                x = x.view({2: torch.int16, 4: torch.int32,
                            8: torch.int64}[x.element_size()])
            out.append(x.clone())
        else:
            out.append(x)
    return out


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def nested_zero1_bcast_worker():
    """Two ZeRO-1 states whose shard sits below the top of the tree —
    under ``backward_passes_per_step=2`` (``MultiStepsState``) and under
    the numerics guard (``NumericsGuardState.inner``) — after two updates
    with rank-dependent gradients, through ``broadcast_optimizer_state``:
    each rank's ``mu`` and shard before and after."""
    from horovod_tpu_torch.resilience import numerics

    r = hvd.rank()
    params = {"w": torch.arange(8, dtype=torch.float32)}
    out = {}
    for name, kw in (("k2", dict(backward_passes_per_step=2)),
                     ("guarded", dict(numerics_guard=True))):
        tx = hvd.DistributedOptimizer(hvd.adam(1e-3), shard_optimizer=True,
                                      **kw)
        st = tx.init(params)
        for i in range(2):
            g = {"w": torch.arange(8, dtype=torch.float32) * 0.1 * (r + 1 + i)}
            _, st = tx.update(g, st, params)
        zero = st.inner_opt_state if name == "k2" else st.inner
        before = zero["inner"]["mu"]["float32"].clone()
        bst = hvd.broadcast_optimizer_state(st, 0)
        bzero = bst.inner_opt_state if name == "k2" else bst.inner
        out[name] = {"mu_before": before.numpy(),
                     "mu_after": bzero["inner"]["mu"]["float32"].numpy(),
                     "shard_after": dict(bzero["shard"]),
                     "untouched": bzero is zero}
        if name == "guarded":
            out[name]["verdict"] = numerics.verdict(bst)
    return out


def _guard_tx(c):
    """The guarded DistributedOptimizer of a guard-matrix case."""
    from horovod_tpu_torch.optim import DistributedOptimizer

    inner = sgd(c["lr"]) if c["inner"] == "sgd" else hvd.adam(c["lr"])
    kw = dict(c["kw"])
    if "compression" in kw:
        kw["compression"] = (hvd.Compression.powersgd(kw["compression"][1])
                             if isinstance(kw["compression"], tuple)
                             else _compression(kw["compression"]))
    if kw.get("op") == "adasum":
        kw["op"] = hvd.Adasum
    return DistributedOptimizer(inner, numerics_guard=True,
                                loss_scale=c["loss_scale"], **kw)


def guard_matrix_worker(p0, grads, losses, cases):
    """Each case ``name: config``: the guarded DistributedOptimizer of
    :func:`_guard_tx` from ``p0`` over the steps' per-rank gradients
    ``grads[t][k]`` (``[N, ...]``) and losses ``losses[t][r]``, its chaos
    spec armed. After each step the verdict (``note_step``), the
    parameters, and on a BAD step whether the parameters and the whole
    inner state kept their bits."""
    from horovod_tpu_torch.models.convert import powersgd_q_from_jax
    from horovod_tpu_torch.resilience import chaos, numerics

    out = {}
    for name, c in cases.items():
        chaos.reset()
        chaos.configure(c["chaos"])
        tx = _guard_tx(c)
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        st = tx.init(params)
        if c.get("q0") is not None:
            st.inner["q"] = powersgd_q_from_jax(c["q0"])
        trace = []
        for t, g in enumerate(grads):
            before = (_bits_of(params), _bits_of(st.inner))
            u, st = tx.update({k: _mine(v) for k, v in g.items()}, st, params,
                              loss=torch.tensor(float(losses[t][hvd.rank()])))
            params = {k: params[k] + u[k] for k in params}
            v = numerics.note_step(t, st)
            rec = {"verdict": v, "good_streak": int(st.good_streak),
                   "params": {k: x.numpy() for k, x in params.items()}}
            if v["last_bad"]:
                rec["frozen"] = (same_bits(before[0], _bits_of(params)),
                                 same_bits(before[1], _bits_of(st.inner)))
            trace.append(rec)
        out[name] = {"trace": trace, "armed": chaos.grad_nan_step(),
                     "injected": dict(chaos.injected)}
        chaos.configure(None)
    return out


def guard_e2e_worker(params, x, y, steps, chaos_spec, lr):
    """The test MLP with flax's weights, ZeRO-1 + int8 + EF + Adam under
    ``loss_scale="dynamic"`` through make_train_step, ``chaos_spec``
    armed: per step the loss, the verdict, the parameters and, on a BAD
    step, whether the parameters and the inner state kept their bits."""
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.models.convert import (
        flatten_tree, flax_params, load_flax_variables,
    )
    from horovod_tpu_torch.resilience import chaos, numerics

    chaos.reset()
    chaos.configure(chaos_spec)
    model = MLP((64, 10), in_features=x.shape[1], seed=0)
    load_flax_variables(model, params)
    tx = hvd.DistributedOptimizer(hvd.adam(lr), compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=True,
                                  loss_scale="dynamic")
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    xs = hvd.shard_batch(torch.from_numpy(x))
    ys = hvd.shard_batch(torch.from_numpy(y))
    trace = []
    for t in range(steps):
        before = (_bits_of(model.jax_params()), _bits_of(st.inner))
        st, loss = step(st, xs, ys)
        v = numerics.note_step(t, st)
        rec = {"loss": float(loss), "verdict": v,
               "params": flatten_tree(flax_params(model))}
        if v["last_bad"]:
            rec["frozen"] = (same_bits(before[0], _bits_of(model.jax_params())),
                             same_bits(before[1], _bits_of(st.inner)))
        trace.append(rec)
    out = {"trace": trace, "armed": chaos.grad_nan_step(),
           "injected": dict(chaos.injected)}
    chaos.configure(None)
    return out


def guard_hook_worker(x, y, steps, nan_step, cases):
    """Each case ``name: (shard, bucket_bytes)``: a guarded, loss-scaled
    bucketed DistributedOptimizer (int8 + EF, Adam) trained twice from the
    same weights — its buckets started from the backward's gradient hooks,
    and the same optimizer with the hook route taken away (the exchange
    after the backward) — with ``grad_nan_at_step=nan_step`` armed afresh
    for each run. Just before the NaN step one parameter element is set
    to -0.0. Per step of each run: the verdict, the bits of the
    parameters and of the inner state, the buckets the hooks started."""
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.resilience import chaos, numerics

    def run(shard, bucket_bytes, hooks):
        chaos.reset()
        chaos.configure(f"grad_nan_at_step={nan_step}")
        model = MLP((64, 10), in_features=x.shape[1], seed=5)
        tx = hvd.DistributedOptimizer(
            hvd.adam(1e-2), compression=hvd.Compression.int8,
            error_feedback=True, shard_optimizer=shard,
            bucket_bytes=bucket_bytes, loss_scale="dynamic")
        if not hooks:
            tx = tx._replace(exchange=None)
        st = tx.init(model.jax_params())
        step = hvd.make_train_step(model, tx, shard_optimizer=shard)
        xs = hvd.shard_batch(torch.from_numpy(x))
        ys = hvd.shard_batch(torch.from_numpy(y))
        trace = []
        for t in range(steps):
            if t == nan_step:
                with torch.no_grad():
                    model.jax_params()["Dense_0/bias"][3] = -0.0
            before = (_bits_of(model.jax_params()), _bits_of(st.inner))
            st, _ = step(st, xs, ys)
            v = numerics.note_step(t, st)
            ex = step.last_exchange
            trace.append({
                "verdict": v, "params": _bits_of(model.jax_params()),
                "inner": _bits_of(st.inner),
                "kept": (same_bits(before[0], _bits_of(model.jax_params())),
                         same_bits(before[1], _bits_of(st.inner))),
                "hooked": None if ex is None else (ex.in_backward,
                                                   len(ex.order)),
                "neg0": bool(torch.signbit(
                    model.jax_params()["Dense_0/bias"][3]))})
        out = {"trace": trace, "armed": chaos.grad_nan_step(),
               "injected": dict(chaos.injected)}
        chaos.configure(None)
        return out

    res = {}
    for name, (shard, bb) in cases.items():
        hooked, after = run(shard, bb, True), run(shard, bb, False)
        res[name] = {
            "hooked": [{k: v for k, v in s.items()
                        if k not in ("params", "inner")}
                       for s in hooked["trace"]],
            "after": [{k: v for k, v in s.items()
                       if k not in ("params", "inner")}
                      for s in after["trace"]],
            "bit_equal": [same_bits(a["params"], b["params"])
                          and same_bits(a["inner"], b["inner"])
                          for a, b in zip(hooked["trace"], after["trace"])],
            "armed": (hooked["armed"], after["armed"]),
            "injected": (hooked["injected"], after["injected"])}
    return res


def guard_world_worker(inp):
    """Every case of tests/test_torch_numerics.py's world of 2 in one world."""
    out = {}
    if "matrix" in inp:
        out["matrix"] = guard_matrix_worker(*inp["matrix"])
    if "e2e" in inp:
        out["e2e"] = guard_e2e_worker(*inp["e2e"])
    if "hooks" in inp:
        out["hooks"] = guard_hook_worker(*inp["hooks"])
    return out


# --------------------------------------------------------------------------
# hierarchical sync over the host mesh (tests/test_torch_hierarchical.py)


PAIR = ("cross", "local")


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def hier_worker(inp, local, with_optim):
    """One rank of a ``cross x local`` world: the errors before and after
    the host mesh, the sub-groups, each hierarchical collective of
    ``inp`` and, with ``with_optim``, the distributed optimizer on the
    axis pair (allreduce mode and ZeRO-1, int8 + error feedback, an
    identity inner optimizer so the exchange is held bit for bit)."""
    from horovod_tpu_torch.ops import hierarchical as H
    from horovod_tpu_torch.parallel import mesh as M

    int8 = hvd.Compression.int8
    v, v16, a = _mine(inp["v"]), _mine(inp["v16"]), _mine(inp["ag"])
    out = {"no_mesh": _err(lambda: C.allreduce(v, axis=PAIR)),
           "half": _err(lambda: C.allreduce(v, axis="cross"))}
    m = M.build_host_mesh(local=local)
    out["groups"] = (m.local_ranks, m.cross_ranks, m.shape)
    out["adasum"] = _err(lambda: C.allreduce(v, hvd.Adasum, axis=PAIR))
    H.set_hierarchical(True)
    H.set_hierarchical_allgather(True)
    try:
        out["f32_sum"] = H.hierarchical_allreduce(v, hvd.Sum)
        out["f32_avg"] = H.hierarchical_allreduce(v)
        out["f16_sum"] = H.hierarchical_allreduce(v16, hvd.Sum)
        out["int8_sum"] = C.allreduce(v, hvd.Sum, compression=int8,
                                      axis=PAIR)
        out["int8_avg"] = C.allreduce(v, hvd.Average, compression=int8,
                                      axis=PAIR)
        out["bf16_cross"] = H.hier_allreduce(
            v, compression=hvd.Compression.fp16)
        out["grouped"] = H.grouped_hier_allreduce([v, v[:300], v16],
                                                  compression=int8)
        out["grouped_own"] = [H.hier_allreduce(v, compression=int8),
                              H.hier_allreduce(v[:300]), H.hier_allreduce(v16)]
        out["ag_hier"] = C.allgather(a, axis=PAIR)
        out["ag_flat"] = C.allgather(a)
        if with_optim:
            out["optim"] = {mode: pair_optim_steps(inp["params"], inp["grads"],
                                                   mode)
                            for mode in ("allreduce", "zero1")}
        out["zero3"] = pair_zero3_gather(inp)
        H.set_hierarchical(False)
        out["int8_flat_route"] = C.allreduce(v, hvd.Sum, compression=int8,
                                             axis=PAIR)
        out["f32_flat_route"] = C.allreduce(v, hvd.Sum, axis=PAIR)
    finally:
        H.set_hierarchical(None)
        H.set_hierarchical_allgather(None)
    return _tree_out(out)


def pair_optim_steps(params, grads, mode):
    """``DistributedOptimizer(identity, int8, error_feedback,
    axis=(cross, local))`` over the steps of ``grads`` (each ``[N, ...]``
    a leaf): each step's reduced tree and the last residuals."""
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = hvd.DistributedOptimizer(_identity(), compression=hvd.Compression.int8,
                                  error_feedback=True, axis=PAIR,
                                  shard_optimizer=mode == "zero1")
    st = tx.init(p)
    ups = []
    for g in grads:
        u, st = tx.update({k: _mine(v) for k, v in g.items()}, st, p)
        ups.append(_tree_out(u))
    return {"updates": ups, "residual": _tree_out(st["residual"])}


# --------------------------------------------------------------------------
# the frontend beside the native core (tests/test_torch_core.py)


WATCHED = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
           "reduce_scatter_tensor", "reduce_scatter_single", "broadcast",
           "all_to_all_single", "batch_isend_irecv")


def frontend_threads_worker(x, y, steps):
    """The hook ``DistributedOptimizer`` of Horovod's torch API on a small
    MLP, with the native core attached, and on every second parameter a
    hook that allreduces its gradient's squared norm without a name (as
    ``chip_smoke.py``'s ``norm_hook``). Every ``torch.distributed``
    collective of the steps is recorded with the thread and the group
    that issued it. Returns the distinct ``(thread, group)`` pairs (the
    core's thread and group named ``"core"``), the last step's norms and
    the parameters."""
    import threading

    import torch.distributed as dist

    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.testing import watching_calls

    core = basics.core()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 3))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    norms = []

    def norm_hook(p):
        local = p.grad.detach().float().pow(2).sum()
        norms.append((float(local), thvd.allreduce(local, op=thvd.Sum)))

    for p in list(model.parameters())[::2]:
        p.register_post_accumulate_grad_hook(norm_hook)
    issued = []

    def on_call(name, args, kw):
        g = kw.get("group")
        issued.append((threading.get_ident(),
                       "core" if g is not None and g is core._group
                       else ("default" if g is None else "other")))

    xs, ys = torch.from_numpy(x[hvd.rank()]), torch.from_numpy(y[hvd.rank()])
    with watching_calls(dist, WATCHED, on_call):
        for _ in range(steps):
            del norms[:]
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(xs), ys).backward()
            opt.step()
    threads = sorted({t for t, _ in issued})
    pairs = sorted({("core" if len(threads) == 1 else f"t{threads.index(t)}",
                     g) for t, g in issued})
    return {"pairs": pairs, "calls": len(issued),
            "norms": [(a, float(b)) for a, b in norms],
            "params": [_np_any(p.detach()) for p in model.parameters()]}


def pair_zero3_gather(inp):
    """The ZeRO-3 gather on the axis pair (``fsdp_pack_params(axis=)``,
    the two-level gather on): the exact gather gives the tree back, its
    backward against the flat gather's on the same cotangent, and the
    int8 wire's pair route (the shard's roundtrip, gathered) against each
    rank's roundtripped row gathered flat."""
    from horovod_tpu_torch.compression import (
        INT8_BLOCK, dequantize_blockwise, quantize_blockwise,
    )

    tree = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    fp = hvd.fsdp_pack_params(tree, axis=PAIR)
    flat = hvd.fsdp_pack_params(tree)
    got = hvd.fsdp_gather_params(fp, wire="none")
    out = {"exact": all(torch.equal(got[k], v) for k, v in tree.items())}
    ct = _mine(inp["ct"])
    for name, pack, kw in (("pair", fp, {"axis": PAIR}), ("flat", flat, {})):
        shard = pack.shards["float32"].clone().requires_grad_()
        full = C.gather_shards(shard, **kw)
        out[f"grad_{name}"] = _np_any(torch.autograd.grad(
            full, shard, ct[:full.shape[0]])[0])
    row = flat.shards["float32"]
    rt = dequantize_blockwise(*quantize_blockwise(row, INT8_BLOCK),
                              torch.float32)[:row.shape[0]]
    want = C.allgather(rt)
    q = C.gather_shards(fp.shards["float32"], axis=PAIR, roundtrip=True)
    out["int8"] = (_np_any(q), _np_any(want))
    return out


# --------------------------------------------------------------------------
# tensor, sequence, pipeline and expert parallelism (tests/test_torch_parallel.py,
# tests/test_torch_sequence.py, tests/test_torch_tp.py)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _vg(fn, x, w):
    """``fn(x)`` and the gradient of ``sum(fn(x) * w)`` at ``x``."""
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out * w).sum(), [x])
    return _n(out), _n(g)


def mesh_worker(cases):
    """Each ``axes`` of ``cases`` through ``build_mesh``: the mesh's axis
    order, sizes, this rank's coordinates and each axis's line of ranks,
    or the error's text."""
    from horovod_tpu_torch.parallel import MeshConfig, build_mesh

    out = []
    for axes in cases:
        try:
            m = (MeshConfig(*axes).build() if isinstance(axes, tuple)
                 else build_mesh(axes))
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        out.append({"names": m.axis_names, "shape": dict(m.shape),
                    "coords": {a: m.axis_index(a) for a in m.axis_names},
                    "ranks": {a: m.ranks(a) for a in m.axis_names}})
    return out


def mesh_axis_under_core_worker():
    """A world with the native core attached and a ``tp`` mesh over every
    rank: each collective over the axis (``axis="tp"`` and the spmd
    primitives) raises before it issues anything; a world allreduce then
    still goes through the core. The errors' texts and the sum."""
    from horovod_tpu_torch.parallel import build_mesh, spmd

    build_mesh({"tp": hvd.size()})
    x = torch.full((4,), float(hvd.rank() + 1))
    calls = {
        "allreduce": lambda: hvd.allreduce(x, hvd.Sum, axis="tp"),
        "grouped_allreduce": lambda: hvd.grouped_allreduce([x], axis="tp"),
        "allgather": lambda: hvd.allgather(x, axis="tp"),
        "alltoall": lambda: hvd.alltoall(x, axis="tp"),
        "reducescatter": lambda: hvd.reducescatter(x, axis="tp"),
        "psum": lambda: spmd.psum(x, "tp"),
        "pmean": lambda: spmd.pmean(x, "tp"),
        "ppermute": lambda: spmd.ppermute(x, "tp", [(0, 1), (1, 0)]),
        "all_to_all": lambda: spmd.all_to_all(x, "tp", 0, 0),
        "exchange": lambda: spmd.exchange([x], "tp", [(0, 1), (1, 0)]),
    }
    errors = {}
    for name, call in calls.items():
        try:
            call()
            errors[name] = None
        except RuntimeError as e:
            errors[name] = str(e)
    return {"errors": errors,
            "sum": _n(hvd.allreduce(x, hvd.Sum))}


def spmd_worker(inp):
    """The per-axis primitives and the collectives' ``axis=<name>`` on a
    ``data 2 x seq 2`` mesh, then on ``pipe 4``: each output and the
    gradient of ``sum(out * w)``."""
    from horovod_tpu_torch.parallel import build_mesh, spmd

    r = hvd.rank()
    x, w = _t(inp["x"][r]), _t(inp["w"][r])
    a, wa = _t(inp["a"][r]), _t(inp["wa"][r])
    out = {}
    build_mesh({"data": 2, "seq": 2})
    out["psum_seq"] = _vg(lambda v: spmd.psum(v, "seq"), x, w)
    out["pmean_data"] = _vg(lambda v: spmd.pmean(v, "data"), x, w)
    out["ppermute_seq"] = _vg(
        lambda v: spmd.ppermute(v, "seq", [(0, 1), (1, 0)]), x, w)
    out["a2a_seq"] = _vg(lambda v: spmd.all_to_all(v, "seq", 2, 1), a, wa)
    out["index"] = (spmd.axis_index("data"), spmd.axis_index("seq"),
                    spmd.axis_size("seq"))
    out["ar_sum_seq"] = _n(hvd.allreduce(x, hvd.Sum, axis="seq"))
    out["ar_avg_data"] = _n(hvd.allreduce(x, hvd.Average, axis="data"))
    out["ag_seq"] = _n(hvd.allgather(x, axis="seq"))
    out["grouped_seq"] = [_n(t) for t in hvd.grouped_allreduce(
        [x, a], hvd.Average, axis="seq")]
    build_mesh({"pipe": 4})
    out["shift_open"] = _vg(
        lambda v: spmd.ppermute(v, "pipe", [(0, 1), (1, 2), (2, 3)]), x, w)
    out["shift_ring"] = _vg(
        lambda v: spmd.ppermute(v, "pipe", [(i, (i + 1) % 4)
                                            for i in range(4)]), x, w)
    e, we = _t(inp["e"][r]), _t(inp["we"][r])
    out["a2a_pipe_0_1"] = _vg(lambda v: spmd.all_to_all(v, "pipe", 0, 1),
                              e, we)
    f, wf = _t(inp["f"][r]), _t(inp["wf"][r])
    out["a2a_pipe_1_0"] = _vg(lambda v: spmd.all_to_all(v, "pipe", 1, 0),
                              f, wf)
    out["alltoall_pipe"] = _n(hvd.alltoall(e, axis="pipe"))
    out["rs_pipe"] = _n(hvd.reducescatter(e, hvd.Sum, axis="pipe"))
    return out


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_worker(cases):
    """GPipe and interleaved pipelines on the pipe axis of this world:
    each case's output psum-ed over the axis, and this rank's stage
    gradient of ``sum(psum(out) ** 2)``."""
    from horovod_tpu_torch.parallel import (
        build_mesh, pipeline_apply, pipeline_apply_interleaved, spmd,
    )

    r = hvd.rank()
    build_mesh({"pipe": hvd.size()})
    res = []
    for kind, stacked, x in cases:
        local = {k: _t(v[r]).requires_grad_(True) for k, v in stacked.items()}
        fn = pipeline_apply if kind == "gpipe" else pipeline_apply_interleaved
        out = spmd.psum(fn(_stage_fn, local, _t(x)), "pipe")
        grads = torch.autograd.grad((out ** 2).sum(),
                                    [local["w"], local["b"]])
        res.append({"out": _n(out), "w": _n(grads[0]), "b": _n(grads[1])})
    return res


def pp_step_worker(stacked, x, y, steps, interleaved, lr):
    """``make_pp_train_step`` with Adam over this rank's stage slice:
    the losses of ``steps`` steps."""
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.training import make_pp_train_step

    r = hvd.rank()
    build_mesh({"pipe": hvd.size()})
    local = {k: _t(v[r:r + 1]) for k, v in stacked.items()}
    tx = hvd.adam(lr)
    st = tx.init(local)
    step = make_pp_train_step(_stage_fn, tx, interleaved=interleaved)
    losses = []
    for _ in range(steps):
        local, st, loss = step(local, st, _t(x), _t(y))
        losses.append(float(loss))
    return losses


def transformer_pp_worker(cfg, params, tokens, targets, S, v, lr):
    """One ``make_transformer_pp_train_step`` step (SGD) of a TransformerLM
    (f32, learned positions) loaded from flax-keyed numpy ``params``:
    the loss and every updated leaf, stages as this rank's slice."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.training import (
        make_transformer_pp_train_step, split_transformer_for_pp,
    )

    r = hvd.rank()
    build_mesh({"pipe": S})
    model = TransformerLM(**cfg, dtype=torch.float32)
    with torch.no_grad():
        for k, t in model.jax_params().items():
            t.copy_(_t(params[k]))
    pp = split_transformer_for_pp(
        model, {k: t.detach().clone() for k, t in model.jax_params().items()},
        S, interleaved_v=v)
    pp["stages"] = {k: t[r:r + 1].clone() for k, t in pp["stages"].items()}
    tx = sgd(lr)
    st = {p: tx.init(pp[p]) for p in pp}
    step = make_transformer_pp_train_step(model, tx, interleaved_v=v)
    M, mb, T = tokens.shape
    pp, st, loss = step(pp, st, _t(tokens), _t(targets))
    return {"loss": float(loss),
            **{f"{p}:{k}": _n(t) for p in pp for k, t in pp[p].items()}}


def three_d_worker(w1, w2, x, y):
    """DP 2 x PP 2 x TP 2 in one world of 8: an MLP stage whose hidden dim
    is split over ``model``, pipelined over ``pipe``, the batch split over
    ``data``; the loss and this rank's gradient shards, normalised by
    S * tp and averaged over data (the JAX test's recipe)."""
    from horovod_tpu_torch.parallel import build_mesh, pipeline_apply, spmd

    m = build_mesh({"data": 2, "pipe": 2, "model": 2})
    d, p, t = m.axis_index("data"), m.axis_index("pipe"), m.axis_index("model")
    hid = w1.shape[2] // 2
    mb = x.shape[1] // 2
    a = _t(w1[p, :, t * hid:(t + 1) * hid]).requires_grad_(True)
    b = _t(w2[p, t * hid:(t + 1) * hid, :]).requires_grad_(True)
    xm, ym = _t(x[:, d * mb:(d + 1) * mb]), _t(y[:, d * mb:(d + 1) * mb])

    def tp_stage(lp, h):
        return spmd.psum(torch.relu(h @ lp[0]) @ lp[1], "model")

    out = spmd.psum(pipeline_apply(tp_stage, (a, b), xm, axis_name="pipe"),
                    "pipe")
    loss = torch.mean((out - ym) ** 2)
    g1, g2 = torch.autograd.grad(loss, [a, b])
    k = spmd.axis_size("pipe") * spmd.axis_size("model")
    loss = spmd.pmean(loss.detach(), "data")
    g1 = spmd.pmean(g1 / k, "data")
    g2 = spmd.pmean(g2 / k, "data")
    return {"coords": (d, p, t), "loss": float(loss), "g1": _n(g1),
            "g2": _n(g2)}


def _expert_fn(p, tokens):
    return torch.relu(tokens @ p[0]) @ p[1]


def moe_worker(cases):
    """``expert_parallel_moe`` on the expert axis of this world, each
    case's output, aux and the gradients of ``sum(y ** 2) + 0.01 aux``
    (router, this rank's experts)."""
    from horovod_tpu_torch.parallel import build_mesh, expert_parallel_moe

    r, n = hvd.rank(), hvd.size()
    build_mesh({"expert": n})
    res = []
    for router, w1, w2, x, factor, routing in cases:
        e_local = w1.shape[0] // n
        rt = _t(router).requires_grad_(True)
        a = _t(w1[r * e_local:(r + 1) * e_local]).requires_grad_(True)
        b = _t(w2[r * e_local:(r + 1) * e_local]).requires_grad_(True)
        y, aux = expert_parallel_moe(rt, (a, b), _t(x), _expert_fn,
                                     capacity_factor=factor, routing=routing)
        grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, [rt, a, b])
        res.append({"y": _n(y), "aux": float(aux),
                    "router": _n(grads[0]), "w1": _n(grads[1]),
                    "w2": _n(grads[2])})
    return res


def ring_worker(cases):
    """Ring, zigzag and Ulysses attention on a ``seq`` axis over this
    world: each case's output shard and its q/k/v shards' gradients of
    ``sum(out ** 2)`` (``grad`` cases)."""
    import functools

    from horovod_tpu_torch.parallel import (
        build_mesh, ring_attention, ulysses_attention, zigzag_ring_attention,
    )

    r, n = hvd.rank(), hvd.size()
    build_mesh({"seq": n})
    fns = {"ring": ring_attention, "zigzag": zigzag_ring_attention,
           "ulysses": ulysses_attention}
    res = []
    for kind, kw, q, k, v, grad in cases:
        fn = functools.partial(fns[kind], **kw)
        tl = q.shape[1] // n
        loc = [_t(a[:, r * tl:(r + 1) * tl]).requires_grad_(grad)
               for a in (q, k, v)]
        try:
            out = fn(*loc)
        except ValueError as e:
            res.append({"error": str(e)})
            continue
        item = {"out": _n(out)}
        if grad:
            item["grads"] = [_n(g) for g in torch.autograd.grad(
                (out ** 2).sum(), loc)]
        res.append(item)
    return res


def sp_step_worker(cfg, params, tokens, targets, axes, steps, opt, lr,
                   attention, block_k):
    """``make_sp_train_step`` of a TransformerLM (f32) loaded from
    flax-keyed numpy ``params`` on the ``axes`` mesh: the losses of
    ``steps`` steps and the parameters after them."""
    import functools

    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import (
        build_mesh, ring_attention, ulysses_attention,
    )
    from horovod_tpu_torch.training import make_sp_train_step

    m = build_mesh(axes)
    attn = (functools.partial(ring_attention, axis_name="seq",
                              block_k=block_k) if attention == "ring"
            else functools.partial(ulysses_attention, axis_name="seq"))
    model = TransformerLM(**cfg, dtype=torch.float32, attention_fn=attn)
    with torch.no_grad():
        for k, t in model.jax_params().items():
            t.copy_(_t(params[k]))
    tx = sgd(lr) if opt == "sgd" else hvd.adam(lr)
    st = tx.init(model.jax_params())
    step = make_sp_train_step(model, tx)
    d, s = m.axis_index("data"), m.axis_index("seq")
    bl = tokens.shape[0] // m.axis_size("data")
    tl = tokens.shape[1] // m.axis_size("seq")
    tok = _t(tokens[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl])
    tgt = _t(targets[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl])
    losses = []
    for _ in range(steps):
        st, loss = step(st, tok, tgt)
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _n(t) for k, t in model.jax_params().items()}}


def tp_worker(params, x, heads, w):
    """``tp_block_apply`` over the ``tp`` axis of a ``data 2 x tp 4``
    (world of 8) or ``tp 2`` mesh: the output, and the gradients of
    ``sum(out * w)`` (x and every parameter) averaged over the axis; then
    the rejections' texts."""
    from horovod_tpu_torch.models.transformer import tp_block_apply
    from horovod_tpu_torch.parallel import build_mesh, spmd

    build_mesh({"data": 2, "tp": 4} if hvd.size() == 8 else {"tp": 2})
    flat = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tree: dict = {}
    for k, v in flat.items():
        a, b = k.split("/")
        tree.setdefault(a, {})[b] = v
    xt = _t(x).requires_grad_(True)
    out = tp_block_apply(tree, xt, heads=heads, axis="tp")
    keys = sorted(flat)
    grads = torch.autograd.grad((out * _t(w)).sum(),
                                [xt] + [flat[k] for k in keys])
    grads = [spmd.pmean(g, "tp") for g in grads]
    res = {"out": _n(out), "grad_x": _n(grads[0]),
           "grads": {k: _n(g) for k, g in zip(keys, grads[1:])}}
    errs = []
    ones = torch.ones(1, 4, 32)
    for bad, h in (({"q_proj": {}}, 4),
                   ({"qkv": {"kernel": torch.ones(32, 96)},
                     "ln1": {"scale": torch.ones(32), "bias": torch.zeros(32)}},
                    3),
                   ({**tree, "mlp_up": {"kernel": torch.ones(32, 7),
                                        "bias": torch.zeros(7)}}, 4)):
        try:
            tp_block_apply(bad, ones, heads=h, axis="tp")
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    res["errors"] = errs
    return res
