"""The Spark veneer of horovod_tpu_torch (``horovod_tpu_torch/spark/``)
against the JAX package's (``horovod_tpu/spark/``). pyspark is not
installed, so the barrier dispatch runs through fakes of its
``BarrierTaskContext``: the JAX tests' scripted fake, and
``testing.StoreBarrierContext``, whose ``allGather`` runs over a store.

The slot's rank grouping (host-major ranks, local and cross coordinates)
equals the JAX package's on the same gathers; the environment it exports
is the launcher's (``run.runner.worker_env``), with rank 0 serving the
world's store on a port the kernel picked and publishing it in the second
gather. A barrier job of 2 processes forms its world from that
environment and runs the mxnet bridge's collectives, exact against numpy
arithmetic."""

import ast
import inspect
import os
import socket
import textwrap

import numpy as np
import pytest

import horovod_tpu.spark as jsp
import horovod_tpu_torch.spark as tsp
from horovod_tpu_torch import estimator as engine
from horovod_tpu_torch.testing import StoreBarrierContext, run_barrier_job

import torch_frontends_workers as W
from tests.test_estimator import FakeBarrierCtx
from tests.test_spark_contract import PYSPARK3_BARRIER_CONTRACT

pytestmark = pytest.mark.torch_port

IDENTITY = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
            "HVD_PROCESS_ID", "HVD_NUM_PROCESSES")


def _slot_env(sp, ctx):
    """Run ``sp._run_barrier_slot`` on ``ctx`` with a ``fn`` that reads the
    environment; the process's environment is restored after."""
    saved = dict(os.environ)
    try:
        ((rank, env),) = list(sp._run_barrier_slot(
            ctx, lambda: dict(os.environ), (), {}))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return rank, env


@pytest.mark.parametrize("idx", [1, 2, 3])
def test_rank_grouping_matches_the_jax_package(idx, monkeypatch):
    """Four tasks on two hosts: partitions 0 and 2 on hostA get ranks 0-1,
    1 and 3 on hostB ranks 2-3, in both packages. A task that is not
    rank 0 serves no store and takes rank 0's ``host:port`` (rank 0,
    which serves one, is the next test's)."""
    host = "hostA" if idx in (0, 2) else "hostB"
    monkeypatch.setattr(socket, "gethostname", lambda: host)
    first = ["3:hostB", "1:hostB", "2:hostA", "0:hostA"]
    second = ["1:hostA:0", "0:hostA:12345", "3:hostB:0", "2:hostB:0"]
    rank = {2: 1, 1: 2, 3: 3}[idx]
    out = {}
    for sp in (jsp, tsp):
        ctx = FakeBarrierCtx(idx, gathers=[first, second])
        out[sp] = _slot_env(sp, ctx)
        assert ctx.sent[0] == f"{idx}:{host}"
        assert ctx.sent[1] == f"{rank}:{host}:0"
    (jr, jenv), (tr, tenv) = out[jsp], out[tsp]
    assert jr == tr == rank
    assert {k: tenv[k] for k in IDENTITY} == {k: jenv[k] for k in IDENTITY}
    assert (tenv["MASTER_ADDR"], tenv["MASTER_PORT"]) == ("hostA", "12345")
    assert jenv["HVD_COORDINATOR_ADDR"] == "hostA:12345"
    assert tenv["TORCHELASTIC_USE_AGENT_STORE"] == "True"


def test_rank_zero_serves_the_store_and_runs_fn():
    """A one-task job: rank 0 binds its store to a port the kernel picks,
    publishes it, and ``fn`` forms a world of one over it."""
    saved = dict(os.environ)
    ctx = FakeBarrierCtx(0)
    try:
        def fn(a, b=1):
            import torch

            import horovod_tpu_torch as hvd

            hvd.init(device="cpu")
            try:
                out = float(hvd.allreduce(torch.ones(2), op=hvd.Sum)[0])
            finally:
                hvd.shutdown()
            return a + b + out, os.environ["MASTER_PORT"]

        ((rank, (result, port)),) = list(
            tsp._run_barrier_slot(ctx, fn, (10,), {"b": 2}))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    host = socket.gethostname()
    assert rank == 0 and result == 13.0
    assert ctx.sent[0] == f"0:{host}"
    assert ctx.sent[1] == f"0:{host}:{port}" and int(port) > 0


def test_barrier_job_of_two_forms_its_world_exactly():
    res = run_barrier_job(W.spark_slot_fn, 2, "cpu", timeout=120)
    x0, x1 = W.rank_input(0), W.rank_input(1)
    for r, got in enumerate(res):
        assert (got["rank"], got["size"], got["device"]) == (r, 2, "cpu")
        env = got["env"]
        assert (env["HOROVOD_RANK"], env["HOROVOD_SIZE"]) == (str(r), "2")
        assert (env["HOROVOD_LOCAL_RANK"], env["HOROVOD_LOCAL_SIZE"]) == (
            str(r), "2")
        assert env["MASTER_PORT"] == res[0]["env"]["MASTER_PORT"]
        ops = got["ops"]
        np.testing.assert_array_equal(ops["sum"], x0 + x1)
        np.testing.assert_array_equal(ops["avg"], (x0 + x1) / np.float32(2))
        np.testing.assert_array_equal(ops["bcast_nd"], x1)
        np.testing.assert_array_equal(ops["update_grad"], np.full(3, 6.0))


def test_store_context_satisfies_the_pyspark_contract():
    for name, (args, _) in PYSPARK3_BARRIER_CONTRACT.items():
        params = [p.name for p in inspect.signature(
            getattr(StoreBarrierContext, name)).parameters.values()
            if p.name != "self"]
        assert params[:len(args)] == args, name


def test_dispatch_uses_only_contract_methods():
    tree = ast.parse(textwrap.dedent(inspect.getsource(tsp._run_barrier_slot)))
    used = {n.func.attr for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name) and n.func.value.id == "ctx"}
    assert used == {"partitionId", "allGather"}
    assert "_free_port" not in inspect.getsource(tsp)


def test_run_is_gated_and_the_estimators_stay():
    for sp in (jsp, tsp):
        with pytest.raises(ImportError, match="pyspark"):
            sp.run(lambda: 0)
    from horovod_tpu_torch.spark.keras import KerasEstimator as KE
    from horovod_tpu_torch.spark.torch import TorchEstimator as TE
    from horovod_tpu_torch.spark.keras import KerasModel, LocalStore

    assert KE is tsp.KerasEstimator and TE is tsp.TorchEstimator
    assert KE is not engine.KerasEstimator
    assert issubclass(KE, engine.KerasEstimator)
    assert issubclass(TE, engine.TorchEstimator)
    assert KerasModel is engine.KerasModel and LocalStore is not None
    missing = {n for n in dir(jsp) if not n.startswith("_")} - set(dir(tsp))
    assert not missing, sorted(missing)


def test_spark_estimator_takes_a_spark_frame(tmp_path):
    """``fit`` of the Spark-facing estimator collects a Spark DataFrame
    (anything with ``toPandas``) before staging."""
    import pandas as pd
    import torch

    df = pd.DataFrame({"f0": np.arange(8, dtype=np.float32),
                       "label": np.arange(8, dtype=np.float32) * 2})

    class SparkFrame:
        def toPandas(self):
            return df

    model = torch.nn.Linear(1, 1)
    est = tsp.TorchEstimator(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.01),
        loss=torch.nn.functional.mse_loss, feature_cols=["f0"],
        label_cols=["label"], batch_size=4, epochs=1,
        store=engine.LocalStore(str(tmp_path)), device="cpu", seed=0)
    out = est.fit(SparkFrame()).transform(df)
    assert np.isfinite(out["label_pred"].to_numpy()).all()


@pytest.mark.parametrize("runner", ["run_world", "run_barrier_job"])
def test_a_process_that_dies_fails_the_job_at_once(runner):
    """A rank whose process ends without a result (a crash, a kill) fails
    the wait within seconds, naming it, instead of holding the caller
    for the whole timeout."""
    import time

    from horovod_tpu_torch import testing

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"\[1\] ended \(exit codes \[3\]\)"):
        getattr(testing, runner)(W.die_on_rank_one, 2, timeout=120)
    assert time.monotonic() - t0 < 60
