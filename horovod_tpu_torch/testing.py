"""Run a function in a world of processes, one per rank.

``run_world(fn, n, *args)`` spawns ``n`` processes, initializes
``horovod_tpu_torch`` in each on the CPU (gloo, a free localhost port),
calls ``fn(*args)`` and returns the per-rank results, rank-ordered.
``device=None`` gives each rank its GPU instead (``cuda:<rank>``, NCCL).
``fn`` must be importable by the children (a module-level function of a
module that does not import JAX keeps the spawn cheap).
"""

from __future__ import annotations

import socket
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, n, port, device, fn, args, q):
    import torch

    import horovod_tpu_torch as hvd

    if device == "cpu":
        torch.set_num_threads(1)
    try:
        hvd.init(device=device, init_method=f"tcp://127.0.0.1:{port}",
                 rank=rank, size=n)
        out = fn(*args)
        q.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - shipped to the parent
        q.put((rank, False, traceback.format_exc()))
    finally:
        hvd.shutdown()


def run_world(fn, n: int, *args, device="cpu", timeout: float = 120.0) -> list:
    """``[fn(*args) on rank 0, ..., on rank n-1]``; raises with the first
    failing rank's traceback."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, n, port, device, fn, args, q))
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
