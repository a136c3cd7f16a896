"""Spark integration veneer (counterpart of ``horovod_tpu/spark/__init__.py``;
reference ``horovod/spark/``).

``horovod_tpu_torch.spark.run(fn)`` runs a function on Spark executors
with the port's world wired up (reference ``spark/runner.py:131-237``);
the estimators train on Spark DataFrames (``spark/keras/estimator.py``,
``spark/torch/estimator.py``).

The estimator engine stays Spark-free (:mod:`horovod_tpu_torch.estimator`
over the port's launcher); this module adapts it to Spark inputs when
pyspark is installed: Spark DataFrames are collected to pandas for
staging, and ``run`` dispatches ``fn`` onto executors through a
barrier-mode ``mapPartitions``. Only :func:`run` needs pyspark.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional

from horovod_tpu_torch.estimator import (  # noqa: F401
    Estimator,
    EstimatorModel,
    KerasEstimator as _KerasEstimator,
    KerasModel,
    TorchEstimator as _TorchEstimator,
    TorchModel,
)

#: how long rank 0's store waits for a client before an op times out
STORE_TIMEOUT_S = 300.0


def _require_pyspark():
    try:
        import pyspark  # noqa: F401

        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark needs pyspark (reference horovod/spark/"
            "runner.py); without Spark use horovod_tpu_torch.estimator "
            "directly: the same estimators, the port's launcher as the fabric"
        ) from e


def _run_barrier_slot(ctx, fn, args, kwargs):
    """Executor-side body of the barrier-mode dispatch, one invocation per
    Spark barrier task (reference ``spark/runner.py:40-114`` task fn +
    ``:194-221`` host-hash rank grouping).

    ``ctx`` is a ``pyspark.BarrierTaskContext``; only ``partitionId()``
    and ``allGather(str)`` are used, so a fake drives it too. Steps:

    1. allGather ``partition:host`` and order ranks host-major, so tasks
       on the same host get consecutive ranks (the reference's host-hash
       grouping; the launcher's rank-major slot allocation).
    2. Rank 0 serves the world's ``TCPStore`` on a port the kernel picks
       as it binds (port 0: no port is chosen, released and bound again),
       and the second allGather publishes its ``host:port``.
    3. Export the slot's environment, the launcher's
       (:func:`horovod_tpu_torch.run.runner.worker_env`: identity,
       ``MASTER_ADDR``/``MASTER_PORT`` of that store, every rank a
       client), and run ``fn``, whose ``hvd.init()`` forms the world.
       Rank 0 keeps the store alive until ``fn`` returns.

    Yields ``(rank, result)``; the driver sorts by rank.
    """
    from horovod_tpu_torch.run.hosts import HostSlots
    from horovod_tpu_torch.run.runner import worker_env

    idx = int(ctx.partitionId())
    host = socket.gethostname()
    infos = sorted(
        (s.split(":", 1)[1], int(s.split(":", 1)[0]))
        for s in ctx.allGather(f"{idx}:{host}")
    )  # [(host, partition)] host-major
    size = len(infos)
    rank_of = {part: r for r, (_, part) in enumerate(infos)}
    my_rank = rank_of[idx]

    # local/cross coordinates within the host grouping
    local_rank = sum(1 for h, _ in infos[:my_rank] if h == host)
    local_size = sum(1 for h, _ in infos if h == host)
    hosts_in_order = []
    for h, _ in infos:
        if h not in hosts_in_order:
            hosts_in_order.append(h)

    store, port = None, 0
    if my_rank == 0:
        import torch.distributed as dist

        store = dist.TCPStore(
            host, 0, None, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S))
        port = store.port
    coords = [
        s for s in ctx.allGather(f"{my_rank}:{host}:{port}")
        if s.startswith("0:")
    ]
    _, coord_host, coord_port = coords[0].split(":")
    slot = HostSlots(hostname=host, rank=my_rank, size=size,
                     local_rank=local_rank, local_size=local_size,
                     cross_rank=hosts_in_order.index(host),
                     cross_size=len(hosts_in_order))
    os.environ.update(worker_env(slot, {}, store_addr=coord_host,
                                 store_port=int(coord_port)))
    try:
        result = fn(*(args or ()), **(kwargs or {}))
    finally:
        del store
    yield (my_rank, result)


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None, verbose: int = 0,
        use_barrier: Optional[bool] = None):
    """Run ``fn`` on ``num_proc`` Spark tasks with collectives wired up
    (reference ``spark/runner.py:131-237``). Requires pyspark.

    Dispatch is barrier-mode ``mapPartitions`` on the executors by default
    (each barrier task computes its rank via allGather and runs ``fn``:
    :func:`_run_barrier_slot`); ``use_barrier=False`` runs the job from
    the *driver* through the port's launcher (:func:`horovod_tpu_torch.
    run.runner.run`), using Spark only for the slot count.
    """
    _require_pyspark()
    from pyspark.sql import SparkSession

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    np_ = num_proc or sc.defaultParallelism
    kwargs = kwargs or {}
    if use_barrier is None:
        use_barrier = True

    if use_barrier:
        def _task(_it):
            from pyspark import BarrierTaskContext

            return list(
                _run_barrier_slot(BarrierTaskContext.get(), fn, args, kwargs)
            )

        pairs = (
            sc.parallelize(range(np_), np_).barrier().mapPartitions(_task)
            .collect()
        )
        return [r for _, r in sorted(pairs)]

    from horovod_tpu_torch.run import runner

    return runner.run(fn, args, kwargs, np=np_, verbose=bool(verbose))


def _to_pandas(df):
    if hasattr(df, "toPandas"):
        return df.toPandas()
    return df


class KerasEstimator(_KerasEstimator):
    """Spark-facing Keras estimator: accepts Spark or pandas DataFrames
    (reference ``spark/keras/estimator.py:40-160``)."""

    def fit(self, df):
        return super().fit(_to_pandas(df))


class TorchEstimator(_TorchEstimator):
    """Spark-facing torch estimator (reference
    ``spark/torch/estimator.py:36-150``)."""

    def fit(self, df):
        return super().fit(_to_pandas(df))
