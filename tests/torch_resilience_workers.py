"""Per-rank bodies of the port's resilience and elastic tests.

These functions run inside ``horovod_tpu_torch.testing.run_world``
children (spawned processes, gloo), so this module must not import JAX:
each child imports it to unpickle its function. Flax parameters arrive as
nested dicts of numpy arrays; results go back as numpy.

The model of the elastic tests is the JAX tests' ``Tiny`` (one
``nn.Dense(2)`` on 8 features: the port's ``MLP((2,), in_features=8)``),
trained with ``adam(1e-2)`` ZeRO-1 through ``make_train_step`` on
:func:`batch_for`'s batch of 48, each rank on its rows.
"""

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.observability import metrics
from horovod_tpu_torch.resilience import chaos, elastic, health, loop, numerics

#: metrics the elastic tests compare with the JAX package's
ELASTIC_METRICS = (
    ("resilience_elastic_generation", {}),
    ("resilience_elastic_world_size", {}),
    ("resilience_elastic_membership_changes", {"kind": "shrink"}),
    ("resilience_elastic_membership_changes", {"kind": "grow"}),
    ("resilience_rank_lost", {}),
    ("resilience_elastic_rollback_steps", {}),
    ("resilience_chaos_injected", {"site": "rank_fail"}),
    ("resilience_chaos_injected", {"site": "rank_join_at_step"}),
    ("numerics_rollbacks", {}),
    ("numerics_rollback_steps", {}),
)


def read_metrics(m) -> dict:
    """``ELASTIC_METRICS`` from registry ``m`` (either package's); a
    histogram as its count."""
    out = {}
    for name, labels in ELASTIC_METRICS:
        v = m.value(name, **labels)
        key = name + "".join(f"{{{k}={v2}}}" for k, v2 in labels.items())
        out[key] = v
    hist = m.value("resilience_elastic_resize_seconds")
    out["resilience_elastic_resize_seconds.count"] = (
        None if hist is None else hist["count"])
    return out


def fresh_registries(spec=None) -> None:
    metrics.reset()
    metrics.set_enabled(True)
    health.reset()
    numerics.reset()
    chaos.reset()
    chaos.configure(spec)


def batch_for(step, n=48, epoch=0):
    rng = np.random.RandomState(1000 * epoch + step)
    x = rng.rand(n, 8).astype(np.float32)
    y = (x.sum(axis=1) > 4).astype(np.int64)
    return x, y


def dense(params):
    """The port's ``Tiny`` with flax's weights ``params``."""
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.models.convert import load_flax_variables

    model = MLP((2,), in_features=8)
    load_flax_variables(model, params)
    return model


def _load(model, params: dict) -> None:
    """Copy a state's parameters into ``model`` unless they are its own
    (after a rollback or a resize the state holds new tensors)."""
    with torch.no_grad():
        for k, v in model.jax_params().items():
            if params[k].data_ptr() != v.data_ptr():
                v.copy_(params[k])


def make_tx(guard: bool):
    if guard:
        return hvd.DistributedOptimizer(
            hvd.adam(1e-2), shard_optimizer=True,
            compression=hvd.Compression.fp16, error_feedback=True,
            numerics_guard=True)
    return hvd.DistributedOptimizer(hvd.adam(1e-2), shard_optimizer=True)


def make_builder(model, *, guard=False, poison=None, seen=None,
                 builds=None):
    """The JAX tests' step builder: a fresh ZeRO-1 optimizer and step for
    each world; ``poison(step, epoch)`` multiplies that batch by NaN;
    ``seen`` collects ``(world, step, replay epoch)``."""
    def builder(world):
        if builds is not None:
            builds.append(world)
        step = hvd.make_train_step(model, make_tx(guard),
                                   shard_optimizer=True)

        def step_fn(state, i):
            epoch = numerics.replay_epoch()
            if seen is not None:
                seen.append((hvd.size(), i, epoch))
            x, y = batch_for(i, epoch=epoch)
            if poison is not None and poison(i, epoch):
                x = x * np.nan
            _load(model, state["params"])
            opt, _ = step(state["opt_state"],
                          hvd.shard_batch(torch.from_numpy(x)),
                          hvd.shard_batch(torch.from_numpy(y)))
            return {"params": model.jax_params(), "opt_state": opt}

        return step_fn

    return builder


def fresh_state(model, guard=False) -> dict:
    return {"params": model.jax_params(),
            "opt_state": make_tx(guard).init(model.jax_params())}


def host_params(params: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def _world_over(base, ranks, tag: str) -> None:
    """Re-form this rank's world by hand over ``ranks`` (base-world
    ranks), under ``tag`` on the base store; a rank outside waits for the
    members' ``tag``/done key (:func:`_done`)."""
    me = _base_rank()
    if basics.is_initialized():
        hvd.shutdown()
    if me in ranks:
        hvd.init(device="cpu", rank=list(ranks).index(me), size=len(ranks),
                 store=dist.PrefixStore(tag, base))
    else:
        base.wait([tag + "done"], datetime.timedelta(seconds=60))


def _done(base, tag: str) -> None:
    if hvd.rank() == 0:
        base.set(tag + "done", "1")


_BASE = {}


def _base_rank() -> int:
    return _BASE["rank"]


def _remember_base():
    _BASE.update(store=basics._state.store, rank=hvd.rank(),
                 size=hvd.size())
    return _BASE["store"], _BASE["size"]


def _full_world(tag: str) -> None:
    base, n = _BASE["store"], _BASE["size"]
    _world_over(base, range(n), f"full/{tag}/")


def elastic_pin_worker(params, spec, steps, fail_at, join_at, n_fail):
    """The acceptance pin, per rank: ``elastic.run`` under ``spec``, then
    the same schedule driven by hand — the full world for steps
    ``[0, fail_at)``, a fresh world of the survivors restored from the
    snapshot (``consolidate_opt_state(to_size=)``) for ``[fail_at,
    join_at)``, the full world again to ``steps`` — and both final
    parameter sets, rank 0's metrics and the world sizes seen."""
    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.training import host_snapshot

    base, n = _remember_base()
    fresh_registries(spec)
    model = dense(params)
    seen = []
    final = elastic.run(make_builder(model, seen=seen), fresh_state(model),
                        num_steps=steps, snapshot_every=1)
    out = {"size": hvd.size(), "seen": seen,
           "metrics": read_metrics(metrics),
           "params": host_params(final["params"])}
    chaos.configure(None)

    # the hand-driven reference
    def restore_into(snap, size):
        st = dict(snap)
        st["opt_state"] = ck.consolidate_opt_state(
            st["opt_state"], st["params"], to_size=size)
        _load(model, {k: torch.from_numpy(v) for k, v in
                      st["params"].items()})
        st["params"] = model.jax_params()
        return st

    model = dense(params)
    _full_world("ref1/")
    fn = make_builder(model)(n)
    st = fresh_state(model)
    for i in range(fail_at):
        st = fn(st, i)
    snap = host_snapshot(ck._gather_sharded(st))
    survivors = list(range(n - n_fail))
    _world_over(base, survivors, "ref2/")
    if hvd.is_initialized():
        st = restore_into(snap, len(survivors))
        fn = make_builder(model)(len(survivors))
        for i in range(fail_at, join_at):
            st = fn(st, i)
        snap = host_snapshot(ck._gather_sharded(st))
        _done(base, "ref2/")
    _full_world("ref3/")
    snap = _bcast_snapshot(snap)
    st = restore_into(snap, n)
    fn = make_builder(model)(n)
    for i in range(join_at, steps):
        st = fn(st, i)
    out["reference"] = host_params(st["params"])
    return out


def _bcast_snapshot(snap):
    """Rank 0's host snapshot on every rank (the ranks that sat out the
    middle world hold a stale one)."""
    from horovod_tpu_torch import checkpoint as ck

    return ck.broadcast_host_tree(snap if hvd.rank() == 0 else None)


# --------------------------------------------------------------------------
# the other elastic cases, each in a fresh world of the base world's ranks


def _case_too_small(ckdir):
    from horovod_tpu_torch import checkpoint as ck

    model = dense(_case_params())
    chaos.configure("rank_fail=1,rank_fail_at_step=2")
    try:
        elastic.run(make_builder(model), fresh_state(model), num_steps=6,
                    min_workers=_BASE["size"], checkpoint_dir=ckdir)
    except elastic.WorldTooSmall as e:
        return {"raised": [e.alive, e.min_workers, e.step],
                "latest": ck.latest_step(ckdir) if hvd.rank() == 0 else None}
    return {"raised": None}


def _case_min_workers_at_formation(_):
    try:
        elastic.run(lambda world: (lambda st, i: st), {"w": np.zeros(1)},
                    num_steps=3, min_workers=_BASE["size"] + 1)
    except elastic.WorldTooSmall as e:
        return {"raised": [e.alive, e.min_workers]}
    return {"raised": None}


def _case_no_faults(_):
    calls = []

    def builder(world):
        calls.append(world)
        return lambda st, i: {"w": st["w"] + world}

    out = elastic.run(builder, {"w": np.zeros(2)}, num_steps=4)
    return {"w": np.asarray(out["w"]).tolist(), "calls": calls}


def _case_rollback_replays(_):
    seen = []

    def builder(world):
        def fn(st, i):
            seen.append((world, i))
            return {"w": st["w"] + 1}
        return fn

    chaos.configure("rank_fail=1,rank_fail_at_step=3")
    out = elastic.run(builder, {"w": np.zeros(1)}, num_steps=5,
                      snapshot_every=2)
    return {"seen": seen,
            "w": None if out is None else np.asarray(out["w"]).tolist()}


def _case_join_waits(_):
    chaos.configure("rank_fail=1,rank_fail_at_step=2,rank_join_at_step=2")
    out = elastic.run(lambda world: (lambda st, i: {"w": st["w"] + 1}),
                      {"w": np.zeros(1)}, num_steps=5)
    return {"w": np.asarray(out["w"]).tolist(), "size": hvd.size()}


def _case_unknown_rank(_):
    coord = elastic.ElasticCoordinator(ttl=5.0) if hvd.rank() == 0 else None
    if coord is not None:
        coord.heartbeat(40)     # a rank this world has no process for
    try:
        out = elastic.run(lambda world: (lambda st, i: {"w": st["w"] + 1}),
                          {"w": np.zeros(1)}, num_steps=3, coordinator=coord)
    finally:
        if coord is not None:
            coord.close()
    return {"w": np.asarray(out["w"]).tolist(), "size": hvd.size()}


#: the TTL case's heartbeat TTL (seconds)
TTL_S = 1.5


def _case_ttl(_):
    """No chaos: the highest rank stops beating after step 2's boundary;
    the driver drops it at step 3's, once the TTL has passed."""
    me, victim = _base_rank(), _BASE["size"] - 1
    beat = elastic.ElasticRun._beat
    seen = []

    def maybe_beat(self):
        if not (me == victim and self._seq >= 3):
            beat(self)

    def builder(world):
        def fn(st, i):
            seen.append((world, i))
            return {"w": st["w"] + 1}
        return fn

    coord = elastic.ElasticCoordinator(ttl=TTL_S) if me == 0 else None
    elastic.ElasticRun._beat = maybe_beat
    try:
        t0 = time.monotonic()
        out = elastic.run(builder, {"w": np.zeros(1)}, num_steps=6,
                          coordinator=coord)
        dt = time.monotonic() - t0
    finally:
        elastic.ElasticRun._beat = beat
        if coord is not None:
            coord.close()
    return {"seen": seen, "seconds": dt,
            "w": None if out is None else np.asarray(out["w"]).tolist(),
            "size": hvd.size() if hvd.is_initialized() else None}


_CASE_PARAMS = {}


def _case_params():
    return _CASE_PARAMS["params"]


CASES = {
    "too_small": _case_too_small,
    "min_workers_at_formation": _case_min_workers_at_formation,
    "no_faults": _case_no_faults,
    "rollback_replays": _case_rollback_replays,
    "join_waits": _case_join_waits,
    "unknown_rank": _case_unknown_rank,
    "ttl": _case_ttl,
}


def elastic_cases_worker(names, params, ckdir):
    """Each case of ``names`` in a fresh world of every rank, the
    registries reset before it: ``{name: (result, this rank's
    metrics)}``."""
    _remember_base()
    _CASE_PARAMS["params"] = params
    out = {}
    for i, name in enumerate(names):
        _full_world(f"case{i}/")
        fresh_registries()
        res = CASES[name](os.path.join(ckdir, name))
        out[name] = (res, read_metrics(metrics))
        chaos.configure(None)
    return out


# --------------------------------------------------------------------------
# the numerics rollback policy (the JAX tests' three scenarios)


def _poison(name):
    if name == "fresh_data":
        return lambda i, e: e == 0 and i >= 3
    if name == "budget_exhausted":
        return lambda i, e: i >= 1
    return lambda i, e: (i == 2 and e == 0) or (i == 6 and e == 1)


#: (num_steps, HOROVOD_NUMERICS_MAX_BAD, HOROVOD_NUMERICS_MAX_ROLLBACKS)
ROLLBACK_SCENARIOS = {
    "fresh_data": (6, "2", None),
    "budget_exhausted": (5, "1", "1"),
    "budget_resets": (9, "1", "1"),
}


def rollback_worker(params, names):
    """Each scenario under ``elastic.run`` with the guarded ZeRO-1
    optimizer (bf16 wire + EF): the steps seen, the replay epoch, rank 0's
    metrics, the outcome (finite parameters and the last verdict's
    streak, or the error and the health state)."""
    _remember_base()
    out = {}
    for i, name in enumerate(names):
        _full_world(f"rb{i}/")
        fresh_registries()
        steps, max_bad, max_rb = ROLLBACK_SCENARIOS[name]
        os.environ["HOROVOD_NUMERICS_MAX_BAD"] = max_bad
        if max_rb is None:
            os.environ.pop("HOROVOD_NUMERICS_MAX_ROLLBACKS", None)
        else:
            os.environ["HOROVOD_NUMERICS_MAX_ROLLBACKS"] = max_rb
        model = dense(params)
        seen, builds = [], []
        res = {}
        try:
            final = elastic.run(
                make_builder(model, guard=True, poison=_poison(name),
                             seen=seen, builds=builds),
                fresh_state(model, guard=True), num_steps=steps,
                snapshot_every=1)
            res["finite"] = numerics.tree_finite(final["params"])
            res["bad_streak"] = numerics.verdict(
                final["opt_state"])["bad_streak"]
        except numerics.NumericsError as e:
            res["error"] = type(e).__name__
        res.update(seen=[(i, e) for _, i, e in seen], builds=builds,
                   replay_epoch=numerics.replay_epoch(),
                   health=health.health_state().name)
        out[name] = (res, read_metrics(metrics))
    os.environ.pop("HOROVOD_NUMERICS_MAX_BAD", None)
    os.environ.pop("HOROVOD_NUMERICS_MAX_ROLLBACKS", None)
    return out


# --------------------------------------------------------------------------
# preemption, resume and dispatch across ranks


def count_step(state, step):
    return {"w": state["w"] + 1.0}


def sigterm_world_worker(ckdir, spec, params=None):
    """``resilience.run`` of :func:`count_step` in a world under ``spec``
    (with flax ``params``: the ZeRO-1 Tiny through ``elastic.run``); a
    ``Preempted`` leaves the process with its code."""
    fresh_registries(spec)
    if params is not None:
        model = dense(params)
        out = elastic.run(make_builder(model), fresh_state(model),
                          num_steps=5, checkpoint_dir=ckdir)
        return {"params": host_params(out["params"])}
    out = loop.run(count_step, {"w": np.zeros(2)}, num_steps=5,
                   checkpoint_dir=ckdir)
    return {"w": np.asarray(out["w"])}


def resume_worker(base_dir):
    """Only rank 0's directory holds a checkpoint (written before the
    world started); every rank resumes from it through rank 0's choice."""
    mine = os.path.join(base_dir, f"rank{hvd.rank()}")
    got = loop.resume_state(mine)
    if got is None:
        return None
    step, state = got
    out = loop.run(count_step, {"w": np.zeros(2)}, num_steps=5,
                   checkpoint_dir=mine)
    return {"step": step, "w": np.asarray(state["w"]).tolist(),
            "final": np.asarray(out["w"]).tolist()}


def dispatch_worker(spec):
    """One eager allreduce clean, then the same under ``spec``: both
    results, the retries counted and the charge consumed."""
    fresh_registries()
    x = torch.arange(8, dtype=torch.float32) * (hvd.rank() + 1)
    clean = hvd.allreduce(x, op=hvd.Average)
    chaos.configure(spec)
    got = hvd.allreduce(x, op=hvd.Average)
    return {"clean": clean.numpy(), "got": got.numpy(),
            "retries": metrics.value("resilience_retries",
                                     scope="collective_dispatch"),
            "injected": metrics.value("resilience_chaos_injected",
                                      site="collective_fail")}


# --------------------------------------------------------------------------
# shutdown -> init over a new store


def reinit_worker():
    """A world of every rank, then one of all but the last, then every
    rank again, each formed by ``shutdown()`` -> ``init()`` over a new
    prefix of the base store: each world's collectives see its own size,
    the meshes and the outstanding names do not outlive their world."""
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel.mesh import build_host_mesh

    base, n = _remember_base()
    me = _base_rank()
    out = {}
    x = torch.ones(4)
    out["first"] = hvd.allreduce(x, op=hvd.Sum).tolist()
    build_host_mesh(local=1)
    C._register_name("grad/w0")     # an async op left outstanding
    _world_over(base, range(n - 1), "small/")
    out["mesh_after"] = basics._state.host_mesh is None
    out["name_after"] = "grad/w0" in C._outstanding_names
    if me < n - 1:
        out["small"] = hvd.allreduce(x, op=hvd.Sum).tolist()
        out["small_size"] = hvd.size()
        C._register_name("grad/w0")    # must not raise a duplicate name
        C._release_name("grad/w0")
        layout = C._quant_rows_layout((1000,), hvd.size(), 256)
        out["layout"] = [list(layout[0]), layout[2]]
        _done(base, "small/")
    _full_world("again/")
    out["again"] = hvd.allreduce(x, op=hvd.Sum).tolist()
    out["again_size"] = hvd.size()
    return out


def reinit_core_worker():
    """The native core across worlds: attached in the base world, then
    in a world of all but the last rank and in every rank again, each
    formed over a new prefix of the base store on the same coordinator
    port; a named allreduce through it in each."""
    base, n = _remember_base()
    me = _base_rank()
    out = []

    def named(tag):
        h = hvd.allreduce_async(torch.ones(3), name=f"g.{tag}", op=hvd.Sum)
        return hvd.synchronize(h).tolist()

    out.append(named("base"))
    for tag, ranks in (("small", range(n - 1)), ("full", range(n))):
        if basics.is_initialized():
            hvd.shutdown()
        if me in ranks:
            hvd.init(device="cpu", rank=list(ranks).index(me),
                     size=len(ranks), native_core=True,
                     store=dist.PrefixStore(f"core/{tag}/", base))
            assert basics.core() is not None
            out.append(named(tag))
            if tag == "small":
                _done(base, "core/small/")
        else:
            base.wait(["core/small/done"], datetime.timedelta(seconds=60))
    return out
