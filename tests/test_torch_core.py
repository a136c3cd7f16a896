"""The port's native core (``horovod_tpu_torch/core.py``, the repository's
``csrc/`` built with g++ into ``horovod_tpu_torch/ops/_build/``) on gloo
worlds of 1, 2 and 4 (``HOROVOD_CYCLE_TIME`` 1 ms).

Every named async op negotiated by the core is bit-equal to its sync
form, and to the JAX package's collective on a 2- and 4-device mesh on
the same numpy inputs (at 4 ranks the inputs are multiples of 1/8, so
every order of summation is exact). Also: k names ready in one cycle
run as one plan and one ``all_reduce``; mixed dtypes fuse into one plan
(one ``all_reduce`` per dtype); a tensor's result is the same in every
fusion bin; a duplicate outstanding name is refused; a name repeated
every round rides the response cache; ``join`` backfills zeros. Named
Adasum, alone and fused into one plan, is bit-equal to its sync form
and within rtol 1e-5 of the JAX package's ``allreduce(..., Adasum)``.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import collective as JCol
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.testing import run_world

import test_torch_workers as TW
import torch_core_workers as W

pytestmark = pytest.mark.torch_port

WORLDS = (1, 2, 4)
#: the named ops each world checks against their sync forms
PAIRS = ("sum", "avg", "prepost", "allgather", "broadcast", "alltoall",
         "reducescatter_sum", "reducescatter_avg")


def _inputs(n: int) -> dict:
    rs = np.random.RandomState(10 + n)

    def f(*shape):
        if n <= 2:      # a sum of two is the same in either order
            return rs.randn(*shape).astype(np.float32)
        return (rs.randint(-64, 64, shape) / 8).astype(np.float32)

    return {"x": f(n, 6, 5), "rows": f(n, 5, 3), "a2a": f(n, 2 * n, 3),
            "ints": rs.randint(-50, 50, (n, 7)).astype(np.int64),
            "a": f(n, 300), "m1": f(n, 1000), "m2": f(n, 700)}


def _jax_refs(n: int, inp: dict) -> dict:
    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()

        def per_rank(fn, x):
            body = lambda v: fn(v[0])[None]  # noqa: E731
            out = jax.jit(JCol._smap(body, mesh, (P(ax),), P(ax)))(
                jnp.asarray(x))
            return np.asarray(out)

        x, rows = inp["x"], inp["rows"]
        return {
            "sum": per_rank(lambda v: JCol.allreduce(v, JCol.Sum, axis=ax), x),
            "avg": per_rank(lambda v: JCol.allreduce(v, JCol.Average, axis=ax),
                            x),
            "prepost": per_rank(lambda v: JCol.allreduce(
                v, JCol.Average, axis=ax, prescale_factor=0.5,
                postscale_factor=3.0), x),
            "allgather": per_rank(lambda v: JCol.allgather(v, axis=ax), x),
            "broadcast": per_rank(lambda v: JCol.broadcast(v, n - 1, axis=ax),
                                  x),
            "alltoall": per_rank(lambda v: JCol.alltoall(v, axis=ax),
                                 inp["a2a"]),
            "reducescatter_sum": per_rank(
                lambda v: JCol.reducescatter(v, JCol.Sum, axis=ax), rows),
            "reducescatter_avg": per_rank(
                lambda v: JCol.reducescatter(v, JCol.Average, axis=ax), rows),
            "grouped_allgather": [
                per_rank(lambda v: JCol.grouped_allgather([v], axis=ax)[0], a)
                for a in (x, rows)],
            "adasum_group": [
                per_rank(lambda v: JCol.allreduce(v, JCol.Adasum, axis=ax), a)
                for a in (x, inp["a"], inp["m1"])],
        }
    finally:
        jhvd.shutdown()


@pytest.fixture(scope="module")
def worlds():
    inputs = {n: _inputs(n) for n in WORLDS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_CYCLE_TIME", "1")
        # one world at a time beside the JAX references: the suite's
        # timing-sensitive tests share the host
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            futs = {n: ex.submit(run_world, W.core_worker, n, inputs[n],
                                 native_core=True, timeout=180)
                    for n in WORLDS}
            refs = {n: _jax_refs(n, inputs[n]) for n in WORLDS if n > 1}
            port = {n: f.result() for n, f in futs.items()}
    return inputs, port, refs


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want, equal_nan=True), (
        what, np.abs(got.astype(np.float64) - want).max())


@pytest.mark.parametrize("case", PAIRS)
@pytest.mark.parametrize("n", WORLDS)
def test_named_op_is_bit_equal_to_its_sync_form(worlds, n, case):
    _, port, _ = worlds
    for r in range(n):
        named, sync = port[n][r][case]
        _same(named, sync, (n, r, case))


@pytest.mark.parametrize("case", PAIRS + ("grouped_allgather",))
@pytest.mark.parametrize("n", (2, 4))
def test_named_op_is_bit_equal_to_the_jax_package(worlds, n, case):
    _, port, refs = worlds
    for r in range(n):
        named = port[n][r][case][0]
        if case == "grouped_allgather":
            for got, want in zip(named, refs[n][case]):
                _same(got, want[r], (n, r, case))
        else:
            _same(named, refs[n][case][r], (n, r, case))


@pytest.mark.parametrize("n", WORLDS)
def test_named_adasum_is_bit_equal_to_its_sync_form(worlds, n):
    """A named Adasum alone, and three of different sizes fused into one
    plan (the grouped combine), each against its own sync Adasum."""
    _, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        _same(*out["adasum"], (n, r, "adasum"))
        plans = out["adasum_group_plans"]
        assert len(plans) == 1 and len(plans[0]) == 3, plans
        for got, want in zip(*out["adasum_group"]):
            _same(got, want, (n, r, "adasum_group"))


@pytest.mark.parametrize("n", (2, 4))
def test_named_adasum_matches_the_jax_package(worlds, n):
    """The fused named Adasum against the JAX package's ``allreduce(...,
    Adasum)`` of each tensor (rtol 1e-5, atol 1e-6: the dot products sum
    in another order). Each reference is first shown to be far from the
    sum and the average, so a wrong combine fails."""
    inputs, port, refs = worlds
    for i, want in enumerate(refs[n]["adasum_group"]):
        stacked = inputs[n][("x", "a", "m1")[i]]
        for other in (stacked.sum(0), stacked.mean(0)):
            assert np.abs(want[0] - other).max() > 1e-2
    for r in range(n):
        got = port[n][r]["adasum_group"][0]
        for i, (g, want) in enumerate(zip(got, refs[n]["adasum_group"])):
            np.testing.assert_allclose(g, want[r], rtol=1e-5, atol=1e-6,
                                       err_msg=str((n, r, i)))
        np.testing.assert_allclose(port[n][r]["adasum"][0],
                                   refs[n]["adasum_group"][0][r],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_k_names_in_one_cycle_are_one_plan_and_one_all_reduce(worlds, n):
    _, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        plans = out["one_cycle_plans"]
        assert len(plans) == 1 and len(plans[0]) == 6, plans
        assert out["one_cycle_calls"] == 1
        for got, want in zip(*out["one_cycle"]):
            _same(got, want, (n, r))


@pytest.mark.parametrize("n", WORLDS)
def test_mixed_dtypes_fuse_into_one_plan(worlds, n):
    """Six dtypes in one plan: one ``all_reduce`` a dtype, each result
    bit-equal to its own sync allreduce."""
    _, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        assert len(out["mixed_plans"]) == 1 and len(out["mixed_plans"][0]) == 6
        assert out["mixed_calls"] == 6
        for got, want in zip(*out["mixed"]):
            _same(got, want, (n, r))


@pytest.mark.parametrize("n", WORLDS)
def test_allgathers_in_one_cycle_run_grouped(worlds, n):
    _, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        assert len(out["grouped_allgather_plans"]) == 1
        assert len(out["grouped_allgather_plans"][0]) == 3
        for got, want in zip(*out["grouped_allgather"]):
            _same(got, want, (n, r))


@pytest.mark.parametrize("n", WORLDS)
def test_a_result_does_not_depend_on_its_fusion_bin(worlds, n):
    """The same tensor alone, beside two mates in one plan, and split off
    by a fusion threshold below the mates' size: three bit-equal results,
    each the sync allreduce's (the core keeps no fixed buckets)."""
    _, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        plans = out["bins_plans"]
        assert [len(p) for p in plans] == [1, 1, 3], plans
        assert len(plans[1][0]) == 3 and all(len(p) == 1 for p in plans[2])
        for got in out["bins"]:
            _same(got, out["bins_sync"], (n, r))


@pytest.mark.parametrize("n", WORLDS)
def test_a_duplicate_outstanding_name_is_refused(worlds, n):
    inputs, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        assert "Duplicate tensor name 'dup'" in out["duplicate"]
        np.testing.assert_allclose(out["duplicate_first"],
                                   inputs[n]["x"].sum(axis=0), rtol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_a_repeated_name_rides_the_response_cache(worlds, n):
    _, port, _ = worlds
    for r in range(n):
        out = port[n][r]
        assert out["cache_hits"] >= 3, out["cache_hits"]
        for got in out["cached"][1:]:
            _same(got, out["cached"][0], (n, r))
        _same(out["cached"][0], out["sum"][1], (n, r))


@pytest.mark.parametrize("n", WORLDS)
def test_join_backfills_zeros_for_the_ranks_that_joined(worlds, n):
    """Rank 0 reduces three batches, the others one: the two reductions
    after they joined see zeros for them; rank 0 joins last."""
    _, port, _ = worlds
    full = float(sum(range(1, n + 1)))
    for r in range(n):
        out = port[n][r]
        want = [full] + ([1.0, 1.0] if r == 0 else [])
        assert [float(s[0]) for s in out["join_sums"]] == want
        assert out["join_last"] == 0


def test_the_coordinator_port_defaults_above_master_port(monkeypatch):
    """``HVD_CORE_COORD_PORT`` wins; else the port above ``MASTER_PORT``
    (which rank 0's rendezvous store binds); a world of more than one
    with neither raises, naming the variable; a world of one needs
    none."""
    from horovod_tpu_torch import basics

    monkeypatch.delenv("HVD_CORE_COORD_PORT", raising=False)
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert basics._coordinator_port(4) == 29501
    monkeypatch.setenv("HVD_CORE_COORD_PORT", "31000")
    assert basics._coordinator_port(4) == 31000
    monkeypatch.delenv("HVD_CORE_COORD_PORT")
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(ValueError, match="HVD_CORE_COORD_PORT"):
        basics._coordinator_port(2)
    assert basics._coordinator_port(1) == 0


def test_the_core_is_built_from_csrc_into_the_package_build_dir():
    path = _build.core_library()
    assert os.path.dirname(path) == _build.build_dir()
    assert os.path.basename(path).startswith("libhvd_core-")
    assert _build.CORE_SRC == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    assert _build.core_library() == path        # built once, then reused


def test_a_core_that_fails_to_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "CORE_FLAGS", _build.CORE_FLAGS + (
        "-DHVD_BROKEN_BUILD", "-include", str(tmp_path / "missing.h")))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.core_library()
    assert not [f for f in os.listdir(_build.build_dir())
                if f.endswith(".d") or "missing" in f]


def test_the_frontend_issues_every_collective_from_the_cores_thread():
    """A world of 4 with the core attached, the hook optimizer and
    unnamed squared-norm allreduces from gradient hooks: every collective
    of the steps, the unnamed ones included, is issued by one thread (the
    core's) on the core's group, so no collective of another communicator
    runs beside a core plan (two threads issuing on two NCCL
    communicators in orders that differ between ranks can deadlock the
    card). The norms agree on every rank and sum the ranks' local
    values; every rank ends with the same parameters."""
    n, steps = 4, 2
    r = np.random.RandomState(3)
    x = r.randn(n, 8, 6).astype(np.float32)
    y = r.randint(0, 3, (n, 8)).astype(np.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_CYCLE_TIME", "1")
        res = run_world(TW.frontend_threads_worker, n, x, y, steps,
                        native_core=True, timeout=180)
    for out in res:
        assert out["calls"] > 0
        assert out["pairs"] == [("core", "core")], out["pairs"]
        for a, b in zip(out["params"], res[0]["params"]):
            np.testing.assert_array_equal(a, b)
    norms = [out["norms"] for out in res]
    assert len(norms[0]) == 2
    for i in range(len(norms[0])):
        glob = {v[i][1] for v in norms}
        assert len(glob) == 1
        np.testing.assert_allclose(glob.pop(), sum(v[i][0] for v in norms),
                                   rtol=1e-6)


def test_a_world_comes_up_while_the_first_free_port_is_held(monkeypatch):
    """``run_world`` chooses no port that it releases before binding: the
    store listens on a port the kernel picks as it binds, and the core's
    coordinator port stays reserved until the world ends. Here another
    socket listens on the port ``free_port()`` returns first, and a world
    of 2 with the core still comes up."""
    import socket

    from horovod_tpu_torch import testing

    held = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    held.bind(("127.0.0.1", 0))
    held.listen()
    try:
        first = iter([held.getsockname()[1]])
        real = testing.free_port
        monkeypatch.setattr(testing, "free_port",
                            lambda: next(first, None) or real())
        monkeypatch.setenv("HOROVOD_CYCLE_TIME", "1")
        res = testing.run_world(TW.identity_worker, 2, native_core=True,
                                timeout=120)
        assert [o["rank"] for o in res] == [0, 1]
    finally:
        held.close()


def test_the_tuned_hierarchical_toggles_apply_at_a_cycle_and_shutdown_restores(
        monkeypatch):
    """The coordinator's tuned hierarchical pair rides the tail of a
    cycle's response list; the core applies it to
    ``ops.hierarchical`` before the cycle's plans run, as the JAX
    package's ``_apply_hier_toggles``; ``shutdown`` restores the
    process's own choice."""
    import time

    import torch

    import horovod_tpu_torch as thvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import hierarchical as TH

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
              "HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_ALLGATHER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "1")
    TH.set_hierarchical_allgather(True)
    thvd.init(device="cpu", native_core=True)
    try:
        core = basics.core()
        assert (core.hier_allreduce(), core.hier_allgather()) == (-1, -1)
        assert not TH.enabled() and TH.allgather_enabled()
        core.set_autotuned_params(hier_allreduce=1, hier_allgather=0)
        deadline = time.time() + 30
        k = 0
        while not TH.enabled() and time.time() < deadline:
            thvd.allreduce_async(torch.ones(3), name=f"tick.{k}").wait()
            k += 1
        assert (core.hier_allreduce(), core.hier_allgather()) == (1, 0)
        assert TH.enabled() and not TH.allgather_enabled()
    finally:
        thvd.shutdown()
    assert TH._forced is None and TH._forced_allgather is True
    TH.set_hierarchical_allgather(None)
