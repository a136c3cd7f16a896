"""Run a function in a world of processes, one per rank.

``run_world(fn, n, *args)`` spawns ``n`` processes, initializes
``horovod_tpu_torch`` in each on the CPU (gloo, a free localhost port),
calls ``fn(*args)`` and returns the per-rank results, rank-ordered.
``device=None`` gives each rank its GPU instead (``cuda:<rank>``, NCCL).
``native_core=True`` attaches the native core in every rank; its
coordinator listens on a second free port, picked here and passed to
the ranks through ``HVD_CORE_COORD_ADDR``/``HVD_CORE_COORD_PORT``, so
that worlds run side by side never share a port.
``fn`` must be importable by the children (a module-level function of a
module that does not import JAX keeps the spawn cheap).
``watching_calls(module, names, on_call)`` reports every call of some of
a module's functions (kernel wrappers, collectives) while it is open.
"""

from __future__ import annotations

import contextlib
import os
import socket
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
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


def _child(rank, n, port, device, fn, args, q, core_port=None):
    import torch

    import horovod_tpu_torch as hvd

    if device == "cpu":
        torch.set_num_threads(1)
    if core_port is not None:
        os.environ["HVD_CORE_COORD_ADDR"] = "127.0.0.1"
        os.environ["HVD_CORE_COORD_PORT"] = str(core_port)
    try:
        hvd.init(device=device, init_method=f"tcp://127.0.0.1:{port}",
                 rank=rank, size=n, native_core=core_port is not None)
        out = fn(*args)
        q.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - shipped to the parent
        q.put((rank, False, traceback.format_exc()))
    finally:
        hvd.shutdown()


def run_world(fn, n: int, *args, device="cpu", timeout: float = 120.0,
              native_core: bool = False) -> list:
    """``[fn(*args) on rank 0, ..., on rank n-1]``; raises with the first
    failing rank's traceback."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    core_port = None
    while native_core and core_port in (None, port):
        core_port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, n, port, device, fn, args, q, core_port))
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(n):
            rank, ok, out = q.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(n)]
