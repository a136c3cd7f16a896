"""Per-rank bodies of the observability and analysis tests of
horovod_tpu_torch (``tests/test_torch_preempt_asym.py``,
``tests/test_torch_observability_world.py``). Spawned children import
this module, so it must not import JAX."""

import os
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.callbacks import Callback
from horovod_tpu_torch.resilience import elastic, loop

import torch_resilience_workers as W


def asym_sigterm_worker(ckdir, victim, params):
    """The ZeRO-1 Tiny through ``elastic.run`` with a checkpoint every
    step, the SIGTERM charge armed on rank ``victim`` only. A preempted
    rank writes, beside ``ckdir``, the seconds from the end of its last
    step to its ``Preempted``, then leaves with code 75."""
    me = hvd.rank()
    W.fresh_registries("sigterm_at_step=2" if me == victim else None)
    model = W.dense(params)
    last = {"t": time.monotonic()}

    class _Stamp(Callback):
        def on_batch_end(self, batch, logs=None):
            last["t"] = time.monotonic()

    try:
        out = elastic.run(W.make_builder(model), W.fresh_state(model),
                          num_steps=5, checkpoint_dir=ckdir,
                          checkpoint_every=1, callbacks=[_Stamp()])
    except loop.Preempted:
        with open(os.path.join(os.path.dirname(ckdir),
                               f"preempted-{me}.txt"), "w") as f:
            f.write(repr(time.monotonic() - last["t"]))
        raise
    return None if out is None else {"params": W.host_params(out["params"])}


# --------------------------------------------------------------------------
# phase-20 drills on the Tiny: the hang, the corrupt rank


def drill_worker(drill, hold=6.0):
    """The ZeRO-1 Tiny through ``elastic.run`` (committed at the start
    only), each step through ``instrument_step`` and followed by one more
    eager collective (the slowest rank's step time, ``Max``), the world's
    KV store carrying every plane. ``hang``: the highest rank holds
    ``hold`` s before its second collective of step 3; ``corrupt``: rank
    2 publishes a non-finite fingerprint from step 2. Returns this rank's
    outcome and, on rank 0, the verdict, the publish gate at the verdict
    and the aggregator's live-rank counts."""
    from horovod_tpu_torch.analysis import sanitizer
    from horovod_tpu_torch.observability import aggregate, flight, metrics
    from horovod_tpu_torch.resilience import chaos, health, numerics
    from horovod_tpu_torch.run import rendezvous
    from horovod_tpu_torch.training import instrument_step

    me, n = hvd.rank(), hvd.size()
    W.fresh_registries()
    if drill == "hang" and me == n - 1:
        chaos.configure(f"rank_hang_at_step=3,rank_hang_hold={hold}")
    elif drill == "corrupt":
        chaos.configure("grad_corrupt_rank=2:2")
    kv = rendezvous.kv_client_from_env()
    pub = aggregate.MetricsPublisher(kv, rank=me, ttl=1.0)
    agg = aggregate.FleetAggregator(kv, world=n) if me == 0 else None
    seen, gates = [], []

    def builder(world):
        fn = instrument_step(inner(world))

        def step_fn(st, i):
            st = fn(st, i)
            hvd.allreduce(torch.ones(1), op=hvd.Max)
            pub.publish_once()
            if agg is not None:
                seen.append(len(agg.collect()["ranks"]))
            return st

        return step_fn

    model = W.dense(_PARAMS["params"])
    inner = W.make_builder(model)
    if me == 0:
        real = health.record_numeric_corruption

        def gated(*a, **kw):
            gates.append(numerics.publish_gate_reason(None, {}))
            return real(*a, **kw)
        health.record_numeric_corruption = gated
    try:
        final = elastic.run(builder, W.fresh_state(model), num_steps=6,
                            snapshot_every=100)
    finally:
        if me == 0:
            health.record_numeric_corruption = real
        chaos.reset()
    out = {"rank": me, "final": final is not None,
           "size": hvd.size() if hvd.is_initialized() else 0}
    if me == 0:
        flight.disarm_watchdog()
        deadline = time.monotonic() + 5.0
        while seen[-1] != hvd.size() and time.monotonic() < deadline:
            time.sleep(0.1)
            seen.append(len(agg.collect()["ranks"]))
        hang = flight.last_hang() or {}
        corrupt = numerics.last_corruption()
        out.update(
            verdict={k: hang.get(k) for k in ("verdict", "key",
                                              "hung_ranks")},
            corrupt=corrupt and {"rank": corrupt["rank"],
                                 "step": corrupt["step"]},
            gates=gates, seen=seen,
            fired=metrics.value("hang_watchdog_fired"),
            divergence=sanitizer.last_divergence(),
            checked=metrics.value("sanitizer_steps_checked"))
    return out


_PARAMS = {}


def set_params(params):
    _PARAMS["params"] = params


def drill_entry(drill, params, hold=6.0):
    set_params(params)
    return drill_worker(drill, hold)


# --------------------------------------------------------------------------
# the aggregate plane and the flushed timeline sidecars


def fleet_timeline_worker(params, steps=4):
    """An instrumented loop of the ZeRO-1 Tiny with ``HOROVOD_TIMELINE``
    set: each rank publishes its metrics, rank 0 aggregates; returns what
    the aggregator saw and each rank's recorded step spans (the files are
    read by the test after the world ended)."""
    from horovod_tpu_torch.observability import aggregate, metrics
    from horovod_tpu_torch.run import rendezvous
    from horovod_tpu_torch.training import instrument_step

    me, n = hvd.rank(), hvd.size()
    W.fresh_registries()
    kv = rendezvous.kv_client_from_env()
    pub = aggregate.MetricsPublisher(kv, rank=me)
    model = W.dense(params)
    fn = instrument_step(W.make_builder(model)(n))
    st = W.fresh_state(model)
    for i in range(steps):
        st = fn(st, i)
        hvd.allreduce(torch.ones(1))
        pub.publish_once()
    hvd.allreduce(torch.ones(1))        # every rank has published
    out = {"rank": me, "train_steps": metrics.value("train_steps")}
    if me == 0:
        fleet = aggregate.FleetAggregator(kv, world=n).collect()
        out.update(ranks=fleet["ranks"], dead=fleet["dead_ranks"],
                   fleet_steps=[s["ranks"] for s in fleet["metrics"][
                       "train_steps"]["samples"].values()])
    return out


# --------------------------------------------------------------------------
# the schedule recorder


def schedule_worker(cells):
    """One step of each ``(sync, compression)`` cell on the JAX schedule
    matrix's model (``w [64, 32]``, ``b [32]``, mean squared error, Adam
    at 1e-2; 8 rows of a 16-row batch a rank), recorded from its
    ``torch.distributed`` calls: the optimizer's exchange and the loss
    average. Returns ``{cell: schedule JSON}``."""
    from horovod_tpu_torch.analysis import schedule

    rng = np.random.RandomState(0)
    w0 = (rng.randn(64, 32).astype(np.float32) * 0.1)
    rng = np.random.RandomState(1)
    x = rng.randn(16, 64).astype(np.float32)
    y = rng.randn(16, 32).astype(np.float32)
    me, n = hvd.rank(), hvd.size()
    rows = slice(me * 16 // n, (me + 1) * 16 // n)
    out = {}
    for sync, comp in cells:
        params = {"w": torch.from_numpy(w0.copy()),
                  "b": torch.zeros(32)}
        compression = {"none": hvd.Compression.none,
                       "fp16": hvd.Compression.fp16,
                       "int8": hvd.Compression.int8}[comp]
        tx = hvd.DistributedOptimizer(
            hvd.adam(1e-2), compression=compression,
            error_feedback=comp != "none",
            shard_optimizer=sync == "zero1", overlap=False)
        st = tx.init(params)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = ((torch.from_numpy(x[rows]) @ p["w"] + p["b"][None]
                 - torch.from_numpy(y[rows])) ** 2).mean()
        loss.backward()
        grads = {k: v.grad for k, v in p.items()}

        def step():
            tx.update(grads, st, params)
            hvd.allreduce(loss.detach(), op=hvd.Average)

        out[f"{sync}|{comp}"] = schedule.collective_schedule(step).to_json()
    return out


# --------------------------------------------------------------------------
# a rebuilt step's gradient hooks


def hooks_resize_worker(params):
    """``elastic.run`` of the ZeRO-1 Tiny with bucketed overlap (its step
    registers a gradient hook a parameter) in a world of 2 resized to 1
    and back: the hooks registered on the model at each build."""
    from horovod_tpu_torch.resilience import chaos

    W.fresh_registries()
    # the buckets of the state, and of its reshard at every resize
    os.environ["HOROVOD_BUCKET_BYTES"] = "64"
    if hvd.rank() == 0:
        chaos.configure("rank_fail=1,rank_fail_at_step=2,rank_join_at_step=4")
    model = W.dense(params)
    counts = []

    def hooks():
        return sum(len(getattr(p, "_post_accumulate_grad_hooks", None) or {})
                   for p in model.parameters())

    def builder(world):
        counts.append(("before", world, hooks()))
        step = hvd.make_train_step(
            model, hvd.DistributedOptimizer(hvd.adam(1e-2),
                                            shard_optimizer=True,
                                            overlap=True),
            shard_optimizer=True)
        counts.append(("after", world, hooks()))

        def step_fn(state, i):
            x, y = W.batch_for(i)
            W._load(model, state["params"])
            opt, _ = step(state["opt_state"],
                          hvd.shard_batch(torch.from_numpy(x)),
                          hvd.shard_batch(torch.from_numpy(y)))
            return {"params": model.jax_params(), "opt_state": opt}

        return step_fn

    tx = hvd.DistributedOptimizer(hvd.adam(1e-2), shard_optimizer=True,
                                  overlap=True)
    try:
        elastic.run(builder, {"params": model.jax_params(),
                              "opt_state": tx.init(model.jax_params())},
                    num_steps=6)
    finally:
        chaos.reset()
    return {"counts": counts, "params": len(list(model.parameters()))}
