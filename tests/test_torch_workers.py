"""Per-rank bodies for the port's multi-process tests, and the tests that
need no JAX.

The functions here run inside ``horovod_tpu_torch.testing.run_world``
children (spawned processes, gloo), so this module must not import JAX:
each child imports it to unpickle its function. Inputs arrive as numpy
arrays stacked ``[N, ...]`` (row r is rank r's), results go back as numpy.
"""

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
