"""Per-rank bodies of the port's launcher and input-plane tests (the
callbacks in a gloo world). They run inside
``horovod_tpu_torch.testing.run_world`` children, so this module must not
import JAX; results go back as numpy."""

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as cbs, optim


class _Trainer:
    pass


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return tree


def callbacks_worker():
    """One rank: ``BroadcastGlobalVariablesCallback`` over rank-specific
    parameters, a ZeRO-1 ``inject_hyperparams(fused_adam)`` state whose
    rows are made rank-specific, and a plain ``inject_hyperparams(sgd)``
    state with a rank-specific momentum trace; then
    ``MetricAverageCallback`` over rank-specific logs."""
    r = hvd.rank()
    params = {"w": torch.full((2, 3), float(r + 1)),
              "b": torch.arange(5, dtype=torch.float32) * (r + 1)}
    views = dict(params)
    tx = hvd.DistributedOptimizer(
        optim.inject_hyperparams(hvd.fused_adam)(learning_rate=0.1),
        shard_optimizer=True, compression=hvd.Compression.int8,
        error_feedback=True)
    zero1 = tx.init(params)
    for mu in zero1["inner"]["inner_state"]["mu"].values():
        mu.fill_(r + 10.0)
    for res in zero1["residual"].values():
        res.fill_(r - 3.0)
    before = _np(zero1)
    sgd = optim.inject_hyperparams(optim.sgd)(learning_rate=0.05 * (r + 1),
                                              momentum=0.9)
    plain = sgd.init(params)
    plain["inner_state"]["trace"] = {
        k: torch.full_like(v, 7.0 * (r + 1)) for k, v in params.items()}
    t = _Trainer()
    t.params, t.opt_state, t.lr = params, zero1, 0.1
    cb = cbs.BroadcastGlobalVariablesCallback(0)
    cb.set_trainer(t)
    cb.on_train_begin()
    cb.on_batch_end(1)             # a no-op: done once
    t2 = _Trainer()
    t2.params, t2.opt_state = None, plain
    cb2 = cbs.BroadcastGlobalVariablesCallback(0)
    cb2.set_trainer(t2)
    cb2.on_batch_end(0)
    logs = {"loss": float(r + 1), "acc": np.float32(2 * r),
            "t": torch.tensor(3.0 * r), "name": "epoch0"}
    cbs.MetricAverageCallback().on_epoch_end(0, logs)
    return {"params": _np(params), "views_same": all(
                views[k] is params[k] for k in params),
            "zero1_before": before, "zero1_after": _np(t.opt_state),
            "plain": _np(t2.opt_state), "logs": {
                k: (v if isinstance(v, str) else float(v))
                for k, v in logs.items()},
            "done": cb.broadcast_done}
