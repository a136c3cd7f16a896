"""The port's PyTorch frontend (``import horovod_tpu_torch.torch as hvd``)
on gloo worlds, with and without the native core (``HOROVOD_CYCLE_TIME``
1 ms).

Every case of ``tests/test_torch.py`` (the JAX package's frontend) has a
counterpart here, in classes of the same names, on a world of 2 where
each rank holds its own values (the expectations are the cross-rank
sums, averages and gathers). Beyond them: the hook optimizer on
identical per-rank batches is bit-equal to the JAX package's
``horovod_tpu.torch.DistributedOptimizer`` on the same module and data;
on disjoint per-rank batches it matches one process on the whole batch
(rtol 1e-5, atol 1e-6); ``SyncBatchNorm`` matches ``BatchNorm2d`` on the
gathered batch (atol 1e-5, 1e-4 for the summed weight and bias grads)
and, on identical inputs, the JAX package's ``SyncBatchNorm`` bit for
bit; the Adasum optimizer on disjoint per-rank batches matches the JAX
package's Adasum of the per-rank deltas (rtol 1e-5, atol 1e-6); at
worlds of 2 and 4.
"""

import concurrent.futures

import numpy as np
import pytest
import torch
import jax

import horovod_tpu as jhvd
from horovod_tpu.ops import collective as JCol
from jax.sharding import PartitionSpec as P
from horovod_tpu_torch.testing import run_world

import torch_core_workers as W

pytestmark = pytest.mark.torch_port

N = 2
WORLD4 = ["extra_hook_sgd", "extra_disjoint_batches", "extra_adasum_disjoint",
          "extra_sync_bn_gathered"]


@pytest.fixture(scope="module")
def runs():
    inp2, inp4 = W.frontend_inputs(2), W.frontend_inputs(4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_CYCLE_TIME", "1")
        # one world at a time beside the references: the suite's
        # timing-sensitive tests share the host
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            futs = {
                (2, core): ex.submit(run_world, W.frontend_worker, 2, inp2,
                                     native_core=core, timeout=240)
                for core in (False, True)}
            futs.update({
                (4, core): ex.submit(run_world, W.frontend_worker, 4, inp4,
                                     WORLD4, native_core=core, timeout=240)
                for core in (False, True)})
            refs = _references(inp2, inp4)
            port = {k: f.result() for k, f in futs.items()}
    return port, refs


def _references(inp2, inp4):
    """The JAX package's frontend on a 2-device mesh, and one process."""
    import horovod_tpu.torch as jthvd

    jhvd.init(devices=jax.devices()[:2])
    try:
        refs = {"extra_hook_sgd": W.hook_optimizer_steps(jthvd, inp2, "sgd"),
                "extra_hook_adam_fp16_ef": W.hook_optimizer_steps(
                    jthvd, inp2, "adam_fp16_ef")}
        torch.manual_seed(5)
        refs["extra_sync_bn_identical"] = W.sync_bn_run(
            jthvd.SyncBatchNorm(3), W._t(inp2["bn_same"]),
            W._t(inp2["bn_same"]))
    finally:
        jhvd.shutdown()
    for n, inp in ((2, inp2), (4, inp4)):
        refs[("disjoint", n)] = W.disjoint_sgd_steps(inp)
        refs[("adasum", n)] = _adasum_reference(n, inp)
        refs[("bn", n)] = W.sync_bn_run(torch.nn.BatchNorm2d(3),
                                        W._t(inp["bn_x"]), W._t(inp["bn_w"]))
    return refs


def _adasum_reference(n, inp, steps=3):
    """The delta-style Adasum step of ``horovod_tpu.torch.
    DistributedOptimizer(op=Adasum)`` on per-rank batches. That frontend
    in one process sees every rank's tensor as the same one, so the
    step is replayed here: each rank's SGD delta (lr 0.1, its 8 rows)
    from the shared parameters, combined per parameter by the JAX
    package's ``allreduce(..., Adasum)`` over the stacked ``[n, ...]``
    deltas on an n-device mesh, then added to the start."""
    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        combine = jax.jit(JCol._smap(
            lambda v: JCol.allreduce(v[0], JCol.Adasum, axis=ax)[None],
            mesh, (P(ax),), P(ax)))
        model = W._mlp(4)
        params = list(model.parameters())
        x, y = W._t(inp["x"]), W._t(inp["y"])
        for _ in range(steps):
            start = [p.detach().clone() for p in params]
            deltas = [[] for _ in params]
            for r in range(n):
                with torch.no_grad():
                    for p, s in zip(params, start):
                        p.copy_(s)
                opt = torch.optim.SGD(params, lr=0.1)
                opt.zero_grad()
                rows = slice(8 * r, 8 * r + 8)
                torch.nn.functional.cross_entropy(
                    model(x[rows]), y[rows]).backward()
                opt.step()
                for d, p, s in zip(deltas, params, start):
                    d.append(W._np(p - s))
            with torch.no_grad():
                for d, p, s in zip(deltas, params, start):
                    out = np.asarray(combine(np.stack(d)))
                    assert all(np.array_equal(o, out[0]) for o in out)
                    p.copy_(s + torch.from_numpy(out[0].copy()))
        return [W._np(p) for p in params]
    finally:
        jhvd.shutdown()


@pytest.fixture(params=[False, True], ids=["direct", "core"])
def core(request):
    return request.param


@pytest.fixture
def world(runs, core):
    """Rank-ordered results of every case on the world of 2."""
    return runs[0][(N, core)]


def ok(world, case):
    """Each rank's value of ``case``, which must not have raised."""
    vals = []
    for r, out in enumerate(world):
        res = out[case]
        assert res[0] == "ok", (case, r, res)
        vals.append(res[1])
    return vals


def _all_equal(vals):
    for v in vals[1:]:
        for a, b in zip(v, vals[0]):
            np.testing.assert_array_equal(a, b)


def _same(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


def test_identity_and_build_flags(world, core):
    """One process per rank on one host: cross_* are 0 and 1, process_*
    the rank and size; the flags answer for this installation (gloo
    here; NCCL as ``torch.distributed`` reports it; no MPI, DDL, CCL or
    XLA)."""
    import torch.distributed as dist

    for r, v in enumerate(ok(world, "basics_and_flags")):
        assert (v["rank"], v["size"]) == (r, N)
        assert (v["cross_rank"], v["cross_size"]) == (0, 1)
        assert (v["process_rank"], v["process_size"]) == (r, N)
        assert v["homogeneous"] and v["core"] == core
        assert v["flags"] == dict(
            mpi_threads_supported=False, mpi_built=False, gloo_built=True,
            nccl_built=dist.is_nccl_available(), ddl_built=False,
            ccl_built=False, xla_built=False,
            gpu_available=torch.cuda.is_available(), mpi_enabled=False,
            gloo_enabled=True)


class TestOps:
    def test_allreduce_average(self, world):
        for out, dtype in ok(world, "allreduce_average"):
            want = np.arange(12, dtype=np.float32).reshape(3, 4) + 0.5
            _same(out, want)
            assert dtype == "torch.float32"

    def test_allreduce_sum(self, world):
        for out in ok(world, "allreduce_sum"):
            _same(out, np.full(5, 3.0, np.float32))

    def test_allreduce_average_kwarg_conflict(self, world):
        for err in ok(world, "allreduce_average_kwarg_conflict"):
            assert err[0] == "ValueError"

    def test_allreduce_inplace(self, world):
        for same, out in ok(world, "allreduce_inplace"):
            assert same
            _same(out, np.full(4, 3.0, np.float32))

    def test_allreduce_fp16_compression(self, world):
        mean = sum(torch.rand(8, generator=torch.Generator().manual_seed(r))
                   for r in range(N)) / N
        for out, dtype in ok(world, "allreduce_fp16_compression"):
            assert dtype == "torch.float32"
            np.testing.assert_allclose(out, mean.numpy(), atol=1e-2)

    def test_allreduce_int_dtype(self, world):
        for out, dtype in ok(world, "allreduce_int_dtype"):
            assert dtype == "torch.int32"
            _same(out, np.arange(6, dtype=np.int32) * 3)

    def test_allreduce_grad(self, world):
        for g in ok(world, "allreduce_grad"):
            _same(g, np.full((3, 3), float(N), np.float32))

    def test_allreduce_async(self, world):
        for out, polled in ok(world, "allreduce_async"):
            _same(out, np.full(3, 3.0, np.float32))
            assert polled

    def test_allreduce_async_inplace(self, world):
        for same, out in ok(world, "allreduce_async_inplace"):
            assert same
            _same(out, np.full(3, 3.0, np.float32))

    def test_package_async_inplace_writes_the_tensor(self, world):
        """``horovod_tpu_torch.allreduce_async_``/``broadcast_async_``:
        ``synchronize`` returns the tensor given, now holding the
        result."""
        for ar, bc in ok(world, "package_async_inplace"):
            assert ar[0] and bc[0]
            _same(ar[1], np.full(3, 3.0, np.float32))
            _same(bc[1], np.arange(4, dtype=np.float32) + 1)

    def test_duplicate_name_rejected(self, world):
        for err in ok(world, "duplicate_name_rejected"):
            assert err[0] == "ValueError" and "Duplicate" in err[1]

    def test_grouped_allreduce(self, world):
        for outs in ok(world, "grouped_allreduce"):
            for i, o in enumerate(outs):
                _same(o, np.full((2, 2), 2.0 * i + 3, np.float32))

    def test_allgather(self, world):
        want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3)
                               + 10 * r for r in range(N)])
        for out in ok(world, "allgather"):
            _same(out, want)

    def test_allgather_grad(self, world):
        for g in ok(world, "allgather_grad"):
            _same(g, np.full((2, 2), float(N), np.float32))

    def test_broadcast(self, world):
        for out in ok(world, "broadcast"):
            _same(out, np.arange(4, dtype=np.float32))

    def test_broadcast_inplace(self, world):
        for same, out in ok(world, "broadcast_inplace"):
            assert same
            _same(out, np.ones(4, np.float32))

    def test_broadcast_bad_root(self, world):
        for err in ok(world, "broadcast_bad_root"):
            assert err[0] == "ValueError"

    def test_join(self, world, core):
        last = ok(world, "join")
        assert all(isinstance(v, int) and 0 <= v < N for v in last)
        if core:        # the last rank to join, the same on every rank
            assert len(set(last)) == 1
        else:           # no negotiation: this rank, as the JAX package's
            assert last == list(range(N))

    def test_broadcast_object(self, world):
        for out in ok(world, "broadcast_object"):
            assert out == {"lr": 0.1, "steps": [1, 2, 3]}

    def test_allgather_object(self, world):
        for out in ok(world, "allgather_object"):
            assert out == [{"r": r} for r in range(N)]


class TestDistributedOptimizer:
    def test_train_step(self, world):
        vals = ok(world, "train_step")
        for before, after in vals:
            assert any(not np.array_equal(b, a) for b, a in zip(before, after))
        _all_equal([after for _, after in vals])

    def test_matches_local_sgd(self, world):
        # identical batches: the averaged gradients are the local ones,
        # so the wrapped optimizer tracks plain SGD bit for bit
        for local, wrapped in ok(world, "matches_local_sgd"):
            for a, b in zip(local, wrapped):
                _same(a, b)

    def test_backward_passes_per_step(self, world):
        _all_equal(ok(world, "backward_passes_per_step"))

    def test_too_many_backwards_raises(self, world):
        for err in ok(world, "too_many_backwards_raises"):
            assert err[0] == "AssertionError"
            assert "backward_passes_per_step" in err[1]

    def test_zero_grad_mid_step_raises(self, world):
        for err in ok(world, "zero_grad_mid_step_raises"):
            assert err[0] == "AssertionError" and "zero_grad" in err[1]

    def test_duplicate_names_rejected(self, world):
        for err in ok(world, "duplicate_names_rejected"):
            assert err[0] == "ValueError" and "unique" in err[1]

    def test_synchronize_then_skip(self, world):
        _all_equal(ok(world, "synchronize_then_skip"))

    def test_identical_batches_bit_equal_to_the_jax_frontend(self, runs, world):
        """The hook optimizer on identical per-rank batches against
        ``horovod_tpu.torch.DistributedOptimizer`` on the same module and
        data: SGD with momentum, and Adam with fp16 and error feedback."""
        refs = runs[1]
        for case in ("extra_hook_sgd", "extra_hook_adam_fp16_ef"):
            for params in ok(world, case):
                for a, b in zip(params, refs[case]):
                    _same(a, b)

    @pytest.mark.parametrize("n", [2, 4])
    def test_disjoint_batches_match_one_process(self, runs, core, n):
        """Each rank on its own rows of one batch (BN-free MLP, SGD, 3
        steps) against one process on the whole batch."""
        port, refs = runs
        for params in ok(port[(n, core)], "extra_disjoint_batches"):
            for a, b in zip(params, refs[("disjoint", n)]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


class TestBroadcastState:
    def test_broadcast_parameters(self, world):
        vals = ok(world, "broadcast_parameters")
        for v in vals[1:]:
            for k in vals[0]:
                _same(v[k], vals[0][k])

    def test_broadcast_optimizer_state(self, world):
        vals = ok(world, "broadcast_optimizer_state")
        for lr, bufs in vals:
            assert lr == pytest.approx(0.3)
            assert bufs and set(bufs) == set(vals[0][1])
            for k in bufs:
                _same(bufs[k], vals[0][1][k])

    def test_broadcast_optimizer_state_fresh(self, world):
        vals = ok(world, "broadcast_optimizer_state_fresh")
        assert vals[0] == [0, 1] and all(v == vals[0] for v in vals)


class TestSyncBatchNorm:
    def test_matches_local_bn_replicated(self, world):
        # identical data on every rank: the global statistics are the
        # local ones; running_var's unbiased correction uses the global
        # count, as in tests/test_torch.py
        for local, synced in ok(world, "sync_bn_matches_local_bn_replicated"):
            np.testing.assert_allclose(synced[0], local[0], atol=1e-5)
            np.testing.assert_allclose(synced[1], local[1], atol=1e-5)
            np.testing.assert_allclose(synced[2], local[2], atol=1e-3)

    def test_backward_matches(self, world):
        for local, synced in ok(world, "sync_bn_backward_matches"):
            for a, b in zip(synced, local):
                np.testing.assert_allclose(a, b, atol=1e-4)

    def test_eval_uses_running_stats(self, world):
        for got, want in ok(world, "sync_bn_eval_uses_running_stats"):
            assert got == want

    @pytest.mark.parametrize("n", [2, 4])
    def test_matches_batchnorm2d_on_the_gathered_batch(self, runs, core, n):
        """Each rank's rows of one batch through SyncBatchNorm against
        BatchNorm2d over the whole batch: this rank's output and input
        grad rows, running statistics, and the weight and bias grads
        summed over ranks (each rank's are local sums, which the
        optimizer then averages)."""
        port, refs = runs
        y, gx, gw, gb, rm, rv = refs[("bn", n)]
        vals = ok(port[(n, core)], "extra_sync_bn_gathered")
        for r, v in enumerate(vals):
            rows = slice(2 * r, 2 * r + 2)
            np.testing.assert_allclose(v[0], y[rows], atol=1e-5)
            np.testing.assert_allclose(v[1], gx[rows], atol=1e-5)
            np.testing.assert_allclose(v[4], rm, atol=1e-5)
            np.testing.assert_allclose(v[5], rv, atol=1e-5)
        np.testing.assert_allclose(sum(v[2] for v in vals), gw, atol=1e-4)
        np.testing.assert_allclose(sum(v[3] for v in vals), gb, atol=1e-4)

    def test_identical_inputs_bit_equal_to_the_jax_frontend(self, runs, world):
        ref = runs[1]["extra_sync_bn_identical"]
        for v in ok(world, "extra_sync_bn_identical"):
            for a, b in zip(v, ref):
                _same(a, b)


class TestDistributedAdasumOptimizer:
    """Delta-style Adasum: the Adasum of identical deltas is the delta,
    so on identical batches the wrapped optimizer tracks the plain one."""

    def test_matches_local_sgd(self, world):
        for got, want in ok(world, "adasum_matches_local_sgd"):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, atol=1e-6)

    def test_backward_passes_per_step_accumulates(self, world):
        for got, want in ok(world, "adasum_backward_passes_per_step_accumulates"):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, atol=1e-6)

    @pytest.mark.parametrize("n", [2, 4])
    def test_disjoint_batches_match_the_jax_package(self, runs, core, n):
        """Each rank on its own rows (BN-free MLP, SGD, 3 steps) against
        the JAX package's Adasum of the per-rank deltas. The reference
        is first shown to be far (more than 1e-3) from the averaged
        step, so an averaging or otherwise wrong combine fails."""
        port, refs = runs
        want, mean = refs[("adasum", n)], refs[("disjoint", n)]
        assert max(np.abs(a - b).max() for a, b in zip(want, mean)) > 1e-3
        for params in ok(port[(n, core)], "extra_adasum_disjoint"):
            for a, b in zip(params, want):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_skip_synchronize_rejected(self, world):
        for err in ok(world, "adasum_skip_synchronize_rejected"):
            assert err[0] == "AssertionError"


class TestErrorFeedback:
    def test_requires_lossy_compression(self, world):
        for err in ok(world, "ef_requires_lossy_compression"):
            assert err[0] == "ValueError" and "lossy" in err[1]

    def test_rejected_with_adasum(self, world):
        for err in ok(world, "ef_rejected_with_adasum"):
            assert err[0] == "ValueError" and "Adasum" in err[1]

    def test_residual_tracks_fp16_rounding(self, world):
        g = np.float32(1.0 + 2.0 ** -12)     # rounds away in fp16
        rt = lambda v: v.astype(np.float16).astype(np.float32)  # noqa: E731
        for v in ok(world, "ef_residual_tracks_fp16_rounding"):
            first = np.full((1, 1), g) - rt(np.full((1, 1), g))
            assert float(np.abs(first).max()) > 0
            _same(v["first"], first)
            _same(v["grad"], rt(np.full((1, 1), g)))
            folded = np.full((1, 1), g) + first
            _same(v["second"], folded - rt(folded))
            assert v["keys"] == [0]
            _same(v["restored"], v["second"])

    def test_works_with_adam_lazy_state_init(self, world):
        vals = ok(world, "ef_works_with_adam_lazy_state_init")
        assert all(n == 2 for n, _ in vals)      # weight + bias
        _all_equal([p for _, p in vals])


class TestReduceScatter:
    def test_reducescatter_sum_and_async(self, world):
        x = np.arange(N * 2, dtype=np.float32) * N
        for r, (out, out_async) in enumerate(ok(world, "reducescatter_sum_and_async")):
            _same(out, x[2 * r:2 * r + 2])
            _same(out_async, x[2 * r:2 * r + 2])


def test_the_frontend_offers_the_jax_frontends_names():
    import horovod_tpu.torch as jthvd
    import horovod_tpu_torch.torch as thvd

    names = {n for n in dir(jthvd) if not n.startswith("_")
             and not type(getattr(jthvd, n)).__name__ == "module"}
    missing = sorted(n for n in names if not hasattr(thvd, n))
    assert not missing, missing
