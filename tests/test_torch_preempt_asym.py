"""The emergency checkpoint under a SIGTERM that reaches one rank only.

A gloo world of 2 runs the ZeRO-1 Tiny through ``elastic.run`` (as
``test_torch_elastic.py``'s symmetric case does) with a checkpoint every
step and ``sigterm_at_step=2`` armed on one rank. The preempted rank must
leave with code 75 within ``HOROVOD_PREEMPT_DRAIN_TIMEOUT`` (here 3 s):
its peer never joins the ZeRO-1 rows' gather, so the rank agrees through
the world's store first and skips the gather. The newest checkpoint must
still restore. The test tears the unpreempted peer down itself.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch.distributed as dist
import torch.multiprocessing as mp

from horovod_tpu_torch import checkpoint as ck
from horovod_tpu_torch import testing

import torch_observability_workers as OW
from test_torch_elastic import _flax_params

pytestmark = pytest.mark.torch_port

DRAIN_S = 3.0


def _spawn(fn, n, *args, timeout=60.0):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    procs = [ctx.Process(target=testing._child,
                         args=(r, n, store.port, "cpu", fn, args, q, None,
                               timeout))
             for r in range(n)]
    for p in procs:
        p.start()
    return store, q, procs


@pytest.mark.parametrize("victim", [0, 1])
def test_sigterm_on_one_rank_exits_75_within_the_drain_bound(
        tmp_path, monkeypatch, victim):
    monkeypatch.setenv("HOROVOD_PREEMPT_DRAIN_TIMEOUT", str(DRAIN_S))
    monkeypatch.setenv("HOROVOD_ELASTIC_HEARTBEAT_TTL", "2")
    d = str(tmp_path / "ck")
    store, q, procs = _spawn(OW.asym_sigterm_worker, 2, d, victim,
                          _flax_params())
    try:
        # spawn, init and two steps take a few seconds; the parent's
        # code blocked in the gather for good
        procs[victim].join(timeout=60)
        code = procs[victim].exitcode
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        del store, q
    assert code == 75, f"the preempted rank {victim} left with {code}"
    with open(tmp_path / f"preempted-{victim}.txt") as f:
        held = float(f.read())
    assert held < DRAIN_S + 2.0, held
    step = ck.latest_step(d)
    assert step is not None and step >= 2
    payload = ck.restore(d, step)
    assert payload["step"] == step
    assert set(payload["state"]) == {"params", "opt_state"}
    for v in payload["state"]["params"].values():
        assert np.all(np.isfinite(np.asarray(v)))
