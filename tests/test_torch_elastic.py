"""Elastic world-size training of horovod_tpu_torch against the JAX
package's (``horovod_tpu/resilience/elastic.py``), on the CPU.

The JAX driver re-forms a mesh over a subset of one process's 8 CPU
devices; the port re-forms a process group of gloo ranks
(``elastic.run`` on every rank, rank 0 the driver). Each module fixture
runs one gloo world while JAX computes the same cases:

- the acceptance pin (``tests/test_elastic.py``'s
  ``test_elastic_shrink_matches_fresh_run_then_rejoins``): a world of 8
  under ``rank_fail=2,rank_fail_at_step=3,rank_join_at_step=6``, the
  ``Tiny`` Dense model with flax's initial weights, ``adam(1e-2)``
  ZeRO-1, ``_batch_for(step)``: 8 -> 6 -> 8, every rank's final
  parameters within rtol 1e-5 / atol 1e-6 of the JAX run's and bit-equal
  to the same schedule driven by hand in the port, rank 0's metrics equal
  to the JAX registry's;
- the other elastic cases at a world of 4 against JAX on 4 devices
  (world too small, ``min_workers`` at formation, no faults, rollback of
  uncommitted steps, the join charge waiting for a failure, an unknown
  rank's heartbeat), and a TTL case (a rank stops beating, no chaos);
- the numerics rollback policy's three scenarios
  (``tests/test_numerics.py``) at a world of 2 against JAX on 2 devices;
- SIGTERM under ``elastic.run`` exits 75 and the resumed world finishes
  bit-equal to an uninterrupted one;
- ``shutdown()`` -> ``init()`` over a new store, with and without the
  native core (the ported ``test_reinit_on_new_mesh_clears_stale_kernel_
  caches`` and ``test_stale_collective_name_does_not_poison_reinit``).
"""

import concurrent.futures
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu.observability import metrics as jmetrics
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import elastic as jelastic
from horovod_tpu.resilience import health as jhealth
from horovod_tpu.resilience import numerics as jnum
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.testing import WorldExit, run_world

import torch_resilience_workers as W

pytestmark = pytest.mark.torch_port

#: the acceptance pin's tolerance against the JAX run
RTOL, ATOL = 1e-5, 1e-6


def _reset_jax(spec=None):
    jmetrics.reset()
    jmetrics.set_enabled(True)
    jhealth.reset()
    jnum.reset()
    jchaos.reset()
    jchaos.configure(spec)


def _tiny_model():
    import flax.linen as nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train=True):
            return nn.Dense(2)(x)

    return Tiny()


def _flax_params():
    params = _tiny_model().init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_tx(guard):
    if guard:
        return jhvd.DistributedOptimizer(
            optax.adam(1e-2), shard_optimizer=True,
            compression=JCompression.fp16, error_feedback=True,
            numerics_guard=True)
    return jhvd.DistributedOptimizer(optax.adam(1e-2), shard_optimizer=True)


def _jax_builder(model, guard=False, poison=None, seen=None, builds=None):
    from horovod_tpu.training import make_shardmap_train_step, shard_batch
    from horovod_tpu.training import softmax_xent

    def builder(world):
        if builds is not None:
            builds.append(world)
        step = make_shardmap_train_step(
            model, _jax_tx(guard), loss_fn=softmax_xent,
            shard_optimizer=True, instrument=False, donate=False)

        def step_fn(state, i):
            epoch = jnum.replay_epoch()
            if seen is not None:
                seen.append((jhvd.size(), i, epoch))
            x, y = W.batch_for(i, epoch=epoch)
            if poison is not None and poison(i, epoch):
                x = x * np.nan
            p, _, os_, _ = step(state["params"], {}, state["opt_state"],
                                shard_batch(x), shard_batch(y))
            return {"params": p, "opt_state": os_}

        return step_fn

    return builder


def _jax_state(guard=False):
    from horovod_tpu.training import replicate

    params = replicate(jax.tree_util.tree_map(jnp.array, _flax_params()))
    return {"params": params, "opt_state": _jax_tx(guard).init(params)}


def _jax_world(n):
    jhvd.init(devices=jax.devices()[:n])
    return jax.devices()[:n]


# --------------------------------------------------------- the acceptance pin


PIN = dict(spec="rank_fail=2,rank_fail_at_step=3,rank_join_at_step=6",
           steps=9, fail_at=3, join_at=6, n_fail=2)


def _jax_pin():
    _reset_jax(PIN["spec"])
    devices = _jax_world(8)
    try:
        seen = []
        final = jelastic.run(_jax_builder(_tiny_model(), seen=seen),
                             _jax_state(), num_steps=PIN["steps"],
                             snapshot_every=1, devices=devices)
        return {"params": flatten_tree(jax.tree_util.tree_map(
                    np.asarray, final["params"])),
                "metrics": W.read_metrics(jmetrics), "seen": seen,
                "size": jhvd.size()}
    finally:
        jhvd.shutdown()
        _reset_jax()


@pytest.fixture(scope="module")
def pin():
    params = _flax_params()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(run_world, W.elastic_pin_worker, 8, params,
                         PIN["spec"], PIN["steps"], PIN["fail_at"],
                         PIN["join_at"], PIN["n_fail"], timeout=300)
        ref = _jax_pin()
        return port.result(), ref


def test_pin_matches_the_jax_run(pin):
    port, ref = pin
    for r, out in enumerate(port):
        assert out["size"] == ref["size"] == 8
        assert set(out["params"]) == set(ref["params"])
        for k, v in ref["params"].items():
            np.testing.assert_allclose(out["params"][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(out["params"][k],
                                          port[0]["params"][k])


def test_pin_matches_the_schedule_driven_by_hand(pin):
    port, _ = pin
    for out in port:
        for k, v in out["reference"].items():
            np.testing.assert_array_equal(out["params"][k], v, err_msg=k)


def test_pin_metrics_match_the_jax_registry(pin):
    port, ref = pin
    assert port[0]["metrics"] == ref["metrics"]
    m = port[0]["metrics"]
    assert m["resilience_elastic_generation"] == 3.0
    assert m["resilience_elastic_membership_changes{kind=shrink}"] == 1.0
    assert m["resilience_elastic_membership_changes{kind=grow}"] == 1.0
    assert m["resilience_elastic_world_size"] == 8.0
    assert m["resilience_rank_lost"] == 2.0
    assert m["resilience_elastic_resize_seconds.count"] == 2
    assert m["resilience_chaos_injected{site=rank_fail}"] == 1.0


def test_pin_schedule_matches_the_jax_run(pin):
    port, ref = pin
    survivors = [(n, i) for n, i, _ in ref["seen"]]
    assert survivors == [(8, 0), (8, 1), (8, 2), (6, 3), (6, 4), (6, 5),
                         (8, 6), (8, 7), (8, 8)]
    for r, out in enumerate(port):
        got = [(n, i) for n, i, _ in out["seen"]]
        want = survivors if r < 6 else [s for s in survivors if s[0] == 8]
        assert got == want, r


# ------------------------------------------------- the other elastic cases


N_CASES = 4
CASE_NAMES = ("too_small", "min_workers_at_formation", "no_faults",
              "rollback_replays", "join_waits", "unknown_rank", "ttl")


def _jax_case(name, ckdir):
    """The JAX package's counterpart of a worker case on 4 devices."""
    devices = _jax_world(N_CASES)
    try:
        if name == "too_small":
            jchaos.configure("rank_fail=1,rank_fail_at_step=2")
            try:
                jelastic.run(_jax_builder(_tiny_model()), _jax_state(),
                             num_steps=6, min_workers=N_CASES,
                             checkpoint_dir=ckdir, devices=devices)
            except jelastic.WorldTooSmall as e:
                from horovod_tpu import checkpoint as jck

                return {"raised": [e.alive, e.min_workers, e.step],
                        "latest": jck.latest_step(ckdir)}
            return {"raised": None}
        if name == "min_workers_at_formation":
            try:
                jelastic.run(lambda world: (lambda st, i: st),
                             {"w": np.zeros(1)}, num_steps=3,
                             min_workers=N_CASES + 1, devices=devices)
            except jelastic.WorldTooSmall as e:
                return {"raised": [e.alive, e.min_workers]}
            return {"raised": None}
        if name == "no_faults":
            calls = []

            def builder(world):
                calls.append(world)
                return lambda st, i: {"w": st["w"] + world}

            out = jelastic.run(builder, {"w": np.zeros(2)}, num_steps=4,
                               devices=devices)
            return {"w": np.asarray(out["w"]).tolist(), "calls": calls}
        if name == "rollback_replays":
            seen = []

            def builder(world):
                def fn(st, i):
                    seen.append((world, i))
                    return {"w": st["w"] + 1}
                return fn

            jchaos.configure("rank_fail=1,rank_fail_at_step=3")
            out = jelastic.run(builder, {"w": np.zeros(1)}, num_steps=5,
                               snapshot_every=2, devices=devices)
            return {"seen": seen, "w": np.asarray(out["w"]).tolist()}
        if name == "join_waits":
            jchaos.configure(
                "rank_fail=1,rank_fail_at_step=2,rank_join_at_step=2")
            out = jelastic.run(
                lambda world: (lambda st, i: {"w": st["w"] + 1}),
                {"w": np.zeros(1)}, num_steps=5, devices=devices)
            return {"w": np.asarray(out["w"]).tolist(), "size": jhvd.size()}
        if name == "unknown_rank":
            coord = jelastic.ElasticCoordinator(ttl=5.0)
            coord.heartbeat(40)
            try:
                out = jelastic.run(
                    lambda world: (lambda st, i: {"w": st["w"] + 1}),
                    {"w": np.zeros(1)}, num_steps=3, coordinator=coord,
                    devices=devices)
            finally:
                coord.close()
            return {"w": np.asarray(out["w"]).tolist(), "size": jhvd.size()}
        return None
    finally:
        jhvd.shutdown()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    port_dir = str(tmp_path_factory.mktemp("port_cases"))
    jax_dir = str(tmp_path_factory.mktemp("jax_cases"))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(run_world, W.elastic_cases_worker, N_CASES,
                         CASE_NAMES, _flax_params(), port_dir, timeout=300)
        ref = {}
        for name in CASE_NAMES:
            _reset_jax()
            res = _jax_case(name, os.path.join(jax_dir, name))
            ref[name] = (res, W.read_metrics(jmetrics))
        _reset_jax()
        return port.result(), ref


def _case(cases, name):
    port, ref = cases
    return [out[name] for out in port], ref[name]


def test_world_too_small_checkpoints_and_raises(cases):
    got, (want, want_m) = _case(cases, "too_small")
    assert want["raised"] == [N_CASES - 1, N_CASES, 2]
    assert want["latest"] == 2
    for r, (res, _) in enumerate(got):
        assert res["raised"] == want["raised"]
    assert got[0][0]["latest"] == 2
    assert got[0][1] == want_m


def test_min_workers_enforced_at_initial_formation(cases):
    got, (want, _) = _case(cases, "min_workers_at_formation")
    assert want["raised"] == [N_CASES, N_CASES + 1]
    assert all(res["raised"] == want["raised"] for res, _ in got)


def test_no_faults_is_a_plain_run(cases):
    got, (want, want_m) = _case(cases, "no_faults")
    assert want == {"w": [16.0, 16.0], "calls": [N_CASES]}
    for res, _ in got:
        assert res == want
    assert got[0][1] == want_m
    assert got[0][1]["resilience_elastic_generation"] == 1.0


def test_rollback_replays_uncommitted_steps(cases):
    got, (want, want_m) = _case(cases, "rollback_replays")
    assert (4, 2) in want["seen"] and (3, 2) in want["seen"]
    assert want["w"] == [5.0]
    for r, (res, _) in enumerate(got[:-1]):
        assert res == want, r
    victim = got[-1][0]
    assert victim["w"] is None
    assert victim["seen"] == [s for s in want["seen"] if s[0] == N_CASES]
    assert got[0][1] == want_m
    assert want_m["resilience_elastic_rollback_steps"] == 1.0


def test_join_charge_survives_until_someone_failed(cases):
    got, (want, want_m) = _case(cases, "join_waits")
    assert want == {"w": [5.0], "size": N_CASES}
    for res, _ in got:
        assert res == want
    assert got[0][1] == want_m
    assert want_m["resilience_elastic_membership_changes{kind=shrink}"] == 1
    assert want_m["resilience_elastic_membership_changes{kind=grow}"] == 1


def test_unknown_rank_heartbeat_is_ignored(cases):
    got, (want, _) = _case(cases, "unknown_rank")
    assert want == {"w": [3.0], "size": N_CASES}
    for res, _ in got:
        assert res == want


def test_a_rank_that_stops_beating_is_dropped_after_the_ttl(cases):
    """No chaos: the highest rank sends no beat from step 3's boundary;
    the driver waits the TTL, drops it there, and the survivors replay
    nothing (``snapshot_every=1``) and finish at 3 ranks."""
    got, _ = _case(cases, "ttl")
    survivors = [(4, 0), (4, 1), (4, 2), (3, 3), (3, 4), (3, 5)]
    for res, _ in got[:-1]:
        assert res["seen"] == survivors and res["w"] == [6.0]
        assert res["size"] == N_CASES - 1
    assert got[-1][0]["w"] is None and got[-1][0]["size"] is None
    assert got[0][0]["seconds"] >= W.TTL_S
    m = got[0][1]
    assert m["resilience_rank_lost"] == 1.0
    assert m["resilience_elastic_membership_changes{kind=shrink}"] == 1.0
    assert m["resilience_chaos_injected{site=rank_fail}"] is None


# ------------------------------------------- the numerics rollback policy


N_ROLLBACK = 2


def _jax_rollback(name):
    steps, max_bad, max_rb = W.ROLLBACK_SCENARIOS[name]
    os.environ["HOROVOD_NUMERICS_MAX_BAD"] = max_bad
    if max_rb is not None:
        os.environ["HOROVOD_NUMERICS_MAX_ROLLBACKS"] = max_rb
    devices = _jax_world(N_ROLLBACK)
    seen, builds, res = [], [], {}
    try:
        final = jelastic.run(
            _jax_builder(_tiny_model(), guard=True, poison=W._poison(name),
                         seen=seen, builds=builds),
            _jax_state(guard=True), num_steps=steps, snapshot_every=1,
            devices=devices)
        res["finite"] = jnum.tree_finite(final["params"])
        res["bad_streak"] = jnum.verdict(final["opt_state"])["bad_streak"]
    except jnum.NumericsError as e:
        res["error"] = type(e).__name__
    finally:
        jhvd.shutdown()
        os.environ.pop("HOROVOD_NUMERICS_MAX_BAD", None)
        os.environ.pop("HOROVOD_NUMERICS_MAX_ROLLBACKS", None)
    res.update(seen=[(i, e) for _, i, e in seen], builds=builds,
               replay_epoch=jnum.replay_epoch(),
               health=jhealth.health_state().name)
    return res, W.read_metrics(jmetrics)


@pytest.fixture(scope="module")
def rollbacks():
    names = tuple(W.ROLLBACK_SCENARIOS)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(run_world, W.rollback_worker, N_ROLLBACK,
                         _flax_params(), names, timeout=300)
        ref = {}
        for name in names:
            _reset_jax()
            ref[name] = _jax_rollback(name)
        _reset_jax()
        return port.result(), ref


def _rollback(rollbacks, name):
    port, ref = rollbacks
    got = [out[name] for out in port]
    for res, m in got[1:]:
        assert res == got[0][0]
    return got[0], ref[name]


def test_bad_streak_rolls_back_with_fresh_data(rollbacks):
    (res, m), (want, want_m) = _rollback(rollbacks, "fresh_data")
    assert res == want
    assert m == want_m
    assert res["replay_epoch"] == 1 and m["numerics_rollbacks"] == 1.0
    assert {(3, 0), (4, 0), (3, 1)} <= set(res["seen"])
    assert res["finite"] and res["bad_streak"] == 0
    assert res["builds"] == [N_ROLLBACK]


def test_rollback_budget_exhaustion_is_fatal(rollbacks):
    (res, m), (want, want_m) = _rollback(rollbacks, "budget_exhausted")
    assert res == want
    assert m == want_m
    assert res["error"] == "NumericsError" and res["health"] == "FATAL"


def test_rollback_budget_resets_on_sound_progress(rollbacks):
    (res, m), (want, want_m) = _rollback(rollbacks, "budget_resets")
    assert res == want
    assert m == want_m
    assert m["numerics_rollbacks"] == 2.0 and res["finite"]


# ----------------------------------------------- SIGTERM under elastic


def test_sigterm_under_elastic_exits_75_and_resumes_bit_equal(tmp_path):
    """``sigterm_at_step=2`` inside an elastic run of 2 ranks (the ZeRO-1
    Tiny): every rank exits 75 after the emergency checkpoint of step 2;
    the relaunched world resumes (the rows re-packed for its ranks) and
    finishes bit-equal to a world that was never interrupted."""
    from horovod_tpu_torch import checkpoint as ck

    params = _flax_params()
    d = str(tmp_path / "ck")
    with pytest.raises(WorldExit) as ei:
        run_world(W.sigterm_world_worker, 2, d, "sigterm_at_step=2", params)
    assert ei.value.codes == {0: 75, 1: 75}
    assert ei.value.exitcodes == {0: 75, 1: 75}
    assert ck.latest_step(d) == 2
    resumed = run_world(W.sigterm_world_worker, 2, d, None, params)
    clean = run_world(W.sigterm_world_worker, 2, str(tmp_path / "clean"),
                      None, params)
    for r in range(2):
        for k, v in clean[r]["params"].items():
            np.testing.assert_array_equal(resumed[r]["params"][k], v)


# ------------------------------------------ shutdown -> init, a new store


def test_reinit_over_a_new_store_leaves_no_stale_state():
    """The port of ``test_reinit_on_new_mesh_clears_stale_kernel_caches``
    and ``test_stale_collective_name_does_not_poison_reinit``: a world of
    4, then of 3 and of 4 again, each formed by ``shutdown()`` ->
    ``init()`` over a new store prefix: collectives see each world's size,
    the host mesh and an outstanding async name do not outlive their
    world (the name may be registered again), the size-keyed layouts are
    the new size's."""
    res = run_world(W.reinit_worker, 4)
    for r, out in enumerate(res):
        assert out["first"] == [4.0] * 4
        assert out["mesh_after"] and not out["name_after"]
        assert out["again"] == [4.0] * 4 and out["again_size"] == 4
        if r < 3:
            assert out["small"] == [3.0] * 4 and out["small_size"] == 3
            assert out["layout"] == [[512], 512]


def test_reinit_restarts_the_native_core():
    """The native core across worlds: re-attached in each, its thread and
    process group fresh, its coordinator on the same reserved port."""
    res = run_world(W.reinit_core_worker, 3, native_core=True, timeout=180)
    assert res[0] == [[3.0] * 3, [2.0] * 3, [3.0] * 3]
    assert res[1] == res[0]
    assert res[2] == [[3.0] * 3, [3.0] * 3]
