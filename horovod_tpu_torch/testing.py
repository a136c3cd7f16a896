"""Run a function in a world of processes, one per rank.

``run_world(fn, n, *args)`` spawns ``n`` processes, initializes
``horovod_tpu_torch`` in each on the CPU (gloo), calls ``fn(*args)`` and
returns the per-rank results, rank-ordered. ``device=None`` gives each
rank its GPU instead (``cuda:<rank>``, NCCL). The rendezvous store is a
``torch.distributed.TCPStore`` that this process serves on a port the
kernel picks as it binds (port 0), and the ranks connect to it as
clients: no port is chosen, released and bound again, so worlds run
side by side cannot take each other's ports. ``native_core=True``
attaches the native core in every rank; its coordinator's port is
reserved here (:func:`reserve_port`: bound, not listening, until the
world ends) and passed to the ranks through
``HVD_CORE_COORD_ADDR``/``HVD_CORE_COORD_PORT``. Like the launcher
(``python -m horovod_tpu_torch.run``), :func:`run_world` serves one
:class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` (HTTP, with a
fresh secret) and exports ``HVD_RUN_KV_ADDR``/``HVD_RUN_KV_PORT``/
``HVD_RUN_SECRET`` to every rank: the sanitizer, the flight recorder's
tails, the numerics fingerprints and the metrics publisher of every rank
meet there. Each rank's environment is the launcher's for its slot
(:func:`horovod_tpu_torch.run.runner.worker_env`): the same identity,
store and coordinator variables.
``fn`` must be importable by the children (a module-level function of a
module that does not import JAX keeps the spawn cheap). A rank whose
``fn`` raises ``SystemExit`` (the preemption loop's ``Preempted``, exit
code 75) exits its process with that code, and :func:`run_world` raises
:class:`WorldExit` with every such rank's code.
``watching_calls(module, names, on_call)`` reports every call of some of
a module's functions (kernel wrappers, collectives) while it is open.
``run_barrier_job(fn, n, *args)`` runs a Spark barrier job without
Spark: ``n`` processes, each through
:func:`horovod_tpu_torch.spark._run_barrier_slot` with a
:class:`StoreBarrierContext` (pyspark's ``BarrierTaskContext`` surface
over a store this process serves).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
import traceback

import torch.multiprocessing as mp

from horovod_tpu_torch.run.runner import reserve_port  # noqa: F401


def free_port() -> int:
    """A port that was free when this returned (another process may take
    it before it is bound again: :func:`reserve_port` holds one)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def watching_calls(module, names, on_call):
    """While open, every call of ``module``'s attributes ``names`` (those
    it has) first runs ``on_call(name, args, kwargs)``. It sees the calls
    that reach a function through the module's attribute, not those made
    through a reference taken before."""
    saved = {n: getattr(module, n) for n in names if hasattr(module, n)}

    def watched(name, f):
        def call(*args, **kw):
            on_call(name, args, kw)
            return f(*args, **kw)
        return call

    for n, f in saved.items():
        setattr(module, n, watched(n, f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


class WorldExit(RuntimeError):
    """Ranks of a :func:`run_world` left through ``SystemExit``:
    ``codes`` maps each such rank to its exit code, ``exitcodes`` every
    rank's process exit code; ``results`` holds the other ranks'
    returns."""

    def __init__(self, codes: dict, exitcodes: dict, results: dict):
        self.codes = codes
        self.exitcodes = exitcodes
        self.results = results
        super().__init__(f"ranks exited: {codes}")


def _collect(q, procs, timeout: float, what: str):
    """Yield each process's ``(index, ok, out)`` from ``q``, within
    ``timeout`` seconds in all. A process that ends without putting its
    item fails the wait at once: a rank that crashed (an abort in a
    collective, a kill) would otherwise hold the caller for the whole
    timeout while its peers wait on it. Raises ``RuntimeError`` naming
    the processes at fault."""
    import queue

    deadline = time.monotonic() + timeout
    seen = set()
    while len(seen) < len(procs):
        try:
            item = q.get(timeout=1.0)
        except queue.Empty:
            gone = [i for i, p in enumerate(procs)
                    if i not in seen and p.exitcode is not None]
            try:    # an item put just before its process ended may lag
                item = q.get(timeout=2.0) if gone else None
            except queue.Empty:
                item = None
            if item is None and gone:
                raise RuntimeError(
                    f"{what}: process(es) {gone} ended (exit codes "
                    f"{[procs[i].exitcode for i in gone]}) without a "
                    f"result") from None
            if item is None:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{what}: no result from process(es) "
                        f"{sorted(set(range(len(procs))) - seen)} within "
                        f"{timeout} s") from None
                continue
        seen.add(item[0])
        yield item


def _stop(procs) -> None:
    """Join each started process for up to 10 s, then kill it."""
    for p in procs:
        if p.pid is not None:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _child(rank, n, port, device, fn, args, q, native_core=False,
           timeout=120.0, env=None):
    import datetime

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    os.environ.update(env or {})
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        store = dist.TCPStore("127.0.0.1", port, n, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout))
        hvd.init(device=device, store=store, rank=rank, size=n,
                 native_core=native_core)
        out = fn(*args)
        q.put((rank, True, out))
    except SystemExit as e:     # the process exits with its code
        q.put((rank, "exit", e.code))
        raise
    except BaseException:  # noqa: BLE001 - shipped to the parent
        q.put((rank, False, traceback.format_exc()))
    finally:
        hvd.shutdown()


def run_world(fn, n: int, *args, device="cpu", timeout: float = 120.0,
              native_core: bool = False, env=None) -> list:
    """``[fn(*args) on rank 0, ..., on rank n-1]``; raises with the first
    failing rank's traceback, at once when a rank's process ends without
    a result, and when ``timeout`` seconds pass without every result
    (the processes are killed). ``env``: variables every rank sets
    before it starts (this process's environment stays as it is)."""
    import datetime

    import torch.distributed as dist

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    held = reserve_port() if native_core else None
    core_port = held.getsockname()[1] if held is not None else None
    from horovod_tpu_torch.run import hosts
    from horovod_tpu_torch.run.rendezvous import KVStoreServer, make_secret
    from horovod_tpu_torch.run.runner import worker_env

    secret = make_secret()
    kv = KVStoreServer(secret=secret)
    kv_env = {"HVD_RUN_KV_ADDR": "127.0.0.1",
              "HVD_RUN_KV_PORT": str(kv.start()),
              "HVD_RUN_SECRET": secret}
    slots = hosts.allocate([hosts.HostInfo("localhost", n)], n)
    procs = [ctx.Process(target=_child,
                         args=(r, n, store.port, device, fn, args, q,
                               native_core, timeout,
                               worker_env(slots[r],
                                          dict(kv_env, **(env or {})),
                                          store_addr="127.0.0.1",
                                          store_port=store.port,
                                          core_port=core_port)))
             for r in range(n)]
    results, exits = {}, {}
    try:
        for p in procs:
            p.start()
        for rank, ok, out in _collect(q, procs, timeout, "run_world"):
            if ok == "exit":
                exits[rank] = out
            elif not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            else:
                results[rank] = out
    finally:
        _stop(procs)
        if held is not None:
            held.close()
        kv.close()
        del store
    if exits:
        raise WorldExit(exits, {r: p.exitcode for r, p in enumerate(procs)},
                        results)
    return [results[r] for r in range(n)]


class StoreBarrierContext:
    """A stand-in for pyspark's ``BarrierTaskContext`` over a
    ``torch.distributed`` store: ``partitionId()``, ``allGather(message)``
    and ``barrier()``, the surface :func:`horovod_tpu_torch.spark.
    _run_barrier_slot` uses. ``allGather`` returns the messages in the
    tasks' reverse order: Spark orders them by task attempt, not by
    partition, so the slot must read the partition from the message."""

    def __init__(self, idx: int, n: int, store, timeout: float = 120.0):
        self.idx, self.n, self.store = idx, n, store
        self.timeout = timeout
        self._round = 0

    def partitionId(self) -> int:
        return self.idx

    def allGather(self, message: str = "") -> list:
        import datetime

        keys = [f"barrier/{self._round}/{i}" for i in range(self.n)]
        self._round += 1
        self.store.set(keys[self.idx], message)
        self.store.wait(keys, datetime.timedelta(seconds=self.timeout))
        return [self.store.get(k).decode() for k in reversed(keys)]

    def barrier(self) -> None:
        self.allGather("")


def _barrier_child(idx, n, port, fn, args, q, timeout):
    import datetime

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.spark import _run_barrier_slot

    torch.set_num_threads(1)
    try:
        store = dist.TCPStore("127.0.0.1", port, n, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout))
        ctx = StoreBarrierContext(idx, n, store, timeout)
        (rank, out), = list(_run_barrier_slot(ctx, fn, args, {}))
        q.put((idx, True, (rank, out)))
    except BaseException:  # noqa: BLE001 - shipped to the parent
        q.put((idx, False, traceback.format_exc()))


def run_barrier_job(fn, n: int, *args, timeout: float = 120.0) -> list:
    """A Spark barrier job without Spark: ``n`` processes, each calling
    :func:`horovod_tpu_torch.spark._run_barrier_slot` with a
    :class:`StoreBarrierContext` (its ``allGather`` over a store this
    process serves on port 0) and ``fn(*args)``, which forms its world
    with ``hvd.init()`` from the slot's environment. Returns
    ``[fn's result on rank 0, ..., on rank n-1]``; raises as
    :func:`run_world` does (the tasks are killed)."""
    import datetime

    import torch.distributed as dist

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    procs = [ctx.Process(target=_barrier_child,
                         args=(i, n, store.port, fn, args, q, timeout))
             for i in range(n)]
    results = {}
    try:
        for p in procs:
            p.start()
        for idx, ok, out in _collect(q, procs, timeout, "barrier job"):
            if not ok:
                raise RuntimeError(f"task {idx} failed:\n{out}")
            results[out[0]] = out[1]
    finally:
        _stop(procs)
        del store
    return [results[r] for r in range(n)]
