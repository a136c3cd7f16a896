"""The input plane of horovod_tpu_torch (``horovod_tpu_torch/data/``)
against the JAX package's (``horovod_tpu/data/``): ``shard_indices`` and
each rank's ``ResumableLoader`` stream equal the JAX package's id for id
over a grid of (n, rank, size, seed, epoch, replay, drop_last);
``ShardedLoader``'s blocks are the JAX mesh's; resume mid-epoch, the
4 -> 3 reshard and the replay salt; an ``ArrayShardStore`` written by
either package read by the other, byte for byte, with the quarantine's
substitution equal; the ``data_stall`` drill; ``make_loader_step`` under
``resilience.run`` with a resume; and the copy to the card's stream and
event handling, host-only, with the copy path stubbed."""

import os

import numpy as np
import pytest
import torch

from horovod_tpu.data import loader as jloader, store as jstore
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import numerics as jnumerics
from horovod_tpu_torch.data import loader as tloader, store as tstore
from horovod_tpu_torch.data import sampler
from horovod_tpu_torch.observability import flight, metrics, straggler
from horovod_tpu_torch.resilience import chaos, health, numerics

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _fresh():
    for m in (metrics, health, numerics, jnumerics, straggler):
        m.reset()
    chaos.configure(None)
    jchaos.configure(None)
    sampler.reset()
    yield
    chaos.reset()
    jchaos.reset()
    numerics.reset()
    jnumerics.reset()
    sampler.reset()


def _xy(n, feat=4):
    rng = np.random.default_rng(n)
    return (rng.standard_normal((n, feat)).astype(np.float32),
            np.arange(n, dtype=np.int64))


# ------------------------------------------------------------- index streams


@pytest.mark.parametrize("n,size,seed,epoch,replay,drop_last", [
    (10, 3, 0, 0, 0, False), (10, 3, 0, 0, 0, True), (97, 4, 5, 2, 0, False),
    (1, 4, 1, 0, 0, False), (64, 8, 3, 1, 2, True), (33, 2, 9, 7, 1, False),
])
def test_shard_indices_match_jax(n, size, seed, epoch, replay, drop_last):
    for rank in range(size):
        kw = dict(seed=seed, epoch=epoch, replay_epoch=replay,
                  drop_last=drop_last)
        np.testing.assert_array_equal(
            tloader.shard_indices(n, rank, size, **kw),
            jloader.shard_indices(n, rank, size, **kw))
    np.testing.assert_array_equal(
        tloader.shard_indices(n, 0, size, shuffle=False),
        jloader.shard_indices(n, 0, size, shuffle=False))


@pytest.mark.parametrize("n,bs,size,seed,replay", [
    (48, 12, 4, 0, 0), (50, 12, 3, 7, 0), (40, 8, 2, 3, 1), (30, 6, 1, 11, 2),
])
def test_per_rank_streams_match_jax(n, bs, size, seed, replay):
    """Each rank's ids over 2.5 epochs, under a replay epoch, equal the
    JAX package's per-rank loader's."""
    x, y = _xy(n)
    for _ in range(replay):
        numerics.bump_replay_epoch()
        jnumerics.bump_replay_epoch()
    steps = (n // bs) * 5 // 2
    for rank in range(size):
        t = tloader.ResumableLoader((x, y), bs, seed=seed, rank=rank,
                                    size=size, device=False, prefetch=2,
                                    register=False)
        j = jloader.ResumableLoader((x, y), bs, seed=seed, rank=rank,
                                    size=size, device=False, prefetch=0,
                                    register=False)
        try:
            for _ in range(steps):
                tx, ty = t.next_batch()
                jx, jy = j.next_batch()
                assert t.last_key == j.last_key
                np.testing.assert_array_equal(t.last_indices,
                                              j.last_indices)
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
                np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            assert t.state() == j.state()
        finally:
            t.close()
            j.close()


@pytest.mark.parametrize("n,bs,size,drop_last", [(40, 8, 2, True),
                                                 (44, 8, 4, False)])
def test_sharded_loader_blocks_are_the_jax_meshs(n, bs, size, drop_last):
    """Rank r's batch is block r of the JAX loader's global batch (what
    its mesh puts on device r), epoch by epoch."""
    x, y = _xy(n)
    j = jloader.ShardedLoader((x, y), bs, seed=2, drop_last=drop_last)
    for epoch in (0, 1):
        order = j._order(epoch)
        for rank in range(size):
            t = tloader.ShardedLoader((x, y), bs, seed=2, rank=rank,
                                      size=size, device=False,
                                      drop_last=drop_last)
            t.set_epoch(epoch)
            got = [yb.numpy() for _, yb in t]
            assert len(got) == len(j)
            for i, yb in enumerate(got):
                sel = order[i * bs:(i + 1) * bs]
                per = len(sel) // size
                np.testing.assert_array_equal(
                    yb, y[sel[rank * per:(rank + 1) * per]])


def test_sharded_loader_set_epoch_mid_iteration_raises():
    x, y = _xy(16)
    t = tloader.ShardedLoader((x, y), 4, device=False, rank=0, size=1)
    it = iter(t)
    next(it)
    with pytest.raises(RuntimeError, match="iterator is live"):
        t.set_epoch(1)
    it.close()
    t.set_epoch(1)


# ----------------------------------------------------- resume, reshard, replay


def test_resume_mid_epoch_reproduces_the_remaining_stream():
    x, y = _xy(60)
    ref = tloader.ResumableLoader((x, y), 12, seed=4, device=False,
                                  register=False)
    want = [ref.next_batch()[1].numpy() for _ in range(9)]
    ref.close()
    a = tloader.ResumableLoader((x, y), 12, seed=4, device=False,
                                register=False)
    got = [a.next_batch()[1].numpy() for _ in range(3)]
    cursor = a.state()
    a.close()
    b = tloader.ResumableLoader((x, y), 12, seed=4, device=False,
                                register=False)
    b.restore(cursor)
    got += [b.next_batch()[1].numpy() for _ in range(6)]
    b.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    j = jloader.ResumableLoader((x, y), 12, seed=4, device=False,
                                register=False, prefetch=0)
    j.restore(cursor)
    assert j.cursor() == (0, 3)
    j.close()


def test_reshard_4_to_3_covers_the_remaining_epoch_exactly_once():
    """Four ranks consume two steps, then the world shrinks to three: the
    union over the new ranks of the rest of the epoch is every remaining
    id once; each new rank's ids equal the JAX package's resharded
    loader's."""
    n, bs = 96, 12
    x, y = _xy(n)
    loaders = [tloader.ResumableLoader((x, y), bs, seed=6, rank=r, size=4,
                                       device=False, register=False)
               for r in range(4)]
    jl = [jloader.ResumableLoader((x, y), bs, seed=6, rank=r, size=4,
                                  device=False, register=False, prefetch=0)
          for r in range(4)]
    seen = []
    for _ in range(2):
        for t, j in zip(loaders, jl):
            seen += t.next_batch()[1].tolist()
            j.next_batch()
    for r in range(3):
        loaders[r].reshard(rank=r, size=3, generation=1)
        jl[r].reshard(rank=r, size=3, generation=1)
    for _ in range(n // bs - 2):
        for t, j in zip(loaders[:3], jl[:3]):
            got = t.next_batch()[1].tolist()
            assert got == np.asarray(j.next_batch()[1]).tolist()
            seen += got
    assert sorted(seen) == list(range(n))
    with pytest.raises(ValueError):
        loaders[0].reshard(rank=3, size=3)
    for t in loaders + jl:
        t.close()


def test_replay_salt_draws_fresh_batches_then_matches_jax():
    x, y = _xy(48)
    t = tloader.ResumableLoader((x, y), 12, seed=1, device=False,
                                register=False)
    first = t.next_batch()[1].numpy()
    t.restore({"epoch": 0, "step": 0})
    numerics.bump_replay_epoch()
    jnumerics.bump_replay_epoch()
    replayed = t.next_batch()[1].numpy()
    assert not np.array_equal(first, replayed)
    j = jloader.ResumableLoader((x, y), 12, seed=1, device=False,
                                register=False, prefetch=0)
    np.testing.assert_array_equal(replayed, np.asarray(j.next_batch()[1]))
    assert t.last_key == j.last_key
    t.close()
    j.close()


def test_loader_following_the_world_reshards_at_the_generation_fence(
        monkeypatch):
    from horovod_tpu_torch import basics

    world = {"rank": 1, "size": 4}
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "rank", lambda: world["rank"])
    monkeypatch.setattr(basics, "size", lambda: world["size"])
    x, y = _xy(48)
    t = tloader.ResumableLoader((x, y), 12, seed=3, device=False,
                                name="follow")
    pinned = tloader.ResumableLoader((x, y), 12, seed=3, device=False,
                                     rank=1, size=4, name="pinned")
    try:
        assert len(t.next_batch()[1]) == 3
        pinned.next_batch()
        world.update(rank=0, size=3)
        sampler.generation_fence(2, 3)
        yb = t.next_batch()[1].numpy()
        np.testing.assert_array_equal(
            yb, y[t.index.rank_indices(0, 1, 0, 3)])
        assert t.state()["generation"] == 2
        assert len(pinned.next_batch()[1]) == 3       # its share stays
    finally:
        t.close()
        pinned.close()


# ---------------------------------------------------------------- the store


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_written_by_either_package_reads_in_the_other(tmp_path,
                                                            writer):
    x, y = _xy(50)
    mods = {"jax": jstore, "torch": tstore}
    a = mods[writer].ArrayShardStore.write(str(tmp_path / "a"), (x, y), 16)
    b = mods["torch" if writer == "jax" else "jax"].ArrayShardStore.write(
        str(tmp_path / "b"), (x, y), 16)
    assert a == b                              # the same manifest, CRCs
    for s in a["shards"]:
        assert (tmp_path / "a" / s["file"]).read_bytes() == \
            (tmp_path / "b" / s["file"]).read_bytes()
    reader = mods["torch" if writer == "jax" else "jax"].ArrayShardStore(
        str(tmp_path / "a"))
    xs, ys = reader.gather([0, 17, 33, 49])
    np.testing.assert_array_equal(xs, x[[0, 17, 33, 49]])
    np.testing.assert_array_equal(ys, [0, 17, 33, 49])
    empty = tstore.ArrayShardStore(str(tmp_path / "a")).gather([])
    assert empty[0].shape == (0, 4) and empty[1].dtype == np.int64


def test_quarantine_substitution_equals_jax(tmp_path):
    """``shard_corrupt=2:0`` in both packages on one store: the shard is
    quarantined, health goes SUSPECT naming it, and every gather of the
    epoch substitutes the same rows as the JAX store."""
    n, bs = 96, 24
    x, y = _xy(n)
    tstore.ArrayShardStore.write(str(tmp_path), (x, y), 16)
    chaos.configure("shard_corrupt=2:0")
    jchaos.configure("shard_corrupt=2:0")
    ts, js = (tstore.ArrayShardStore(str(tmp_path)),
              jstore.ArrayShardStore(str(tmp_path)))
    t = tloader.ResumableLoader(ts, bs, seed=4, device=False, prefetch=2,
                                name="corrupt")
    j = jloader.ResumableLoader(js, bs, seed=4, device=False, prefetch=0,
                                register=False)
    try:
        seen = []
        for _ in range(n // bs):
            tx, ty = t.next_batch()
            jx, jy = j.next_batch()
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            seen += ty.tolist()
        assert ts.quarantined() == js.quarantined() == [2]
        assert not set(range(32, 48)) & set(seen)
        assert metrics.value("data_samples_substituted") >= 16.0
        assert metrics.value("data_quarantined_shards") == 1.0
        assert health.health_state() >= health.HealthState.SUSPECT
        assert "shard-00002" in health.MONITOR.reason()
        assert any(e.get("event") == "shard_quarantined"
                   for e in flight.events() if e["kind"] == "data")
    finally:
        t.close()
        j.close()


def test_all_shards_quarantined_raises(tmp_path):
    x, y = _xy(16)
    tstore.ArrayShardStore.write(str(tmp_path), (x, y), 16)
    chaos.configure("shard_corrupt=0:0")
    with pytest.raises(tstore.DataUnavailableError):
        tstore.ArrayShardStore(str(tmp_path)).gather([0, 1])


def test_local_store_paths_and_hdfs_gate(tmp_path):
    s = tstore.LocalStore(str(tmp_path))
    j = jstore.LocalStore(str(tmp_path))
    for f in ("get_run_path", "get_train_data_path", "get_checkpoint_path",
              "get_logs_path"):
        assert getattr(s, f)("run1") == getattr(j, f)("run1")
    s.make_dirs(s.get_logs_path("run1"))
    assert s.exists(s.get_logs_path("run1"))
    s.delete(s.get_run_path("run1"))
    assert not s.exists(s.get_run_path("run1"))
    with pytest.raises(ImportError, match="libhdfs"):
        tstore.HDFSStore("/x", host="127.0.0.1", port=1)


# ---------------------------------------------------------------- drills


def test_data_stall_drill_is_detected_and_attributed(monkeypatch):
    """``data_stall=3:0.5`` in a world of one: the watchdog (0.2 s)
    detects the stall (flight event, health strike, counter), and the
    charge's rank is noted input-bound by the wait it caused."""
    monkeypatch.setenv("HOROVOD_DATA_WATCHDOG", "0.2")
    chaos.configure("data_stall=3:0.5")
    x, y = _xy(96, feat=8)
    t = tloader.ResumableLoader((x, y), 24, seed=0, prefetch=1,
                                device=False, name="stall")
    try:
        for _ in range(2):
            t.next_batch()
        assert metrics.value("data_prefetch_stalls") >= 1.0
        assert metrics.value("resilience_input_stalls") >= 1.0
        assert metrics.value("resilience_chaos_injected",
                             site="data_stall") >= 1.0
        assert any(e.get("event") == "input_stall"
                   for e in flight.events() if e["kind"] == "data")
        assert straggler.data_waits()[3] >= 0.4
        assert t.last_wait >= 0.2
        assert metrics.value("data_wait_seconds_recent") is not None
        assert health.health_state() >= health.HealthState.SUSPECT
    finally:
        t.close()
    chaos.configure(None)


def test_make_loader_step_resumes_at_the_cursor(tmp_path):
    """``make_loader_step`` under ``resilience.run``: a run stopped after
    5 steps (a checkpoint each step) and resumed to 12 goes on from its
    newest checkpoint with exactly the batches an uninterrupted 12-step
    run draws there, and ends in its state; the cursor rode the
    checkpoint."""
    from horovod_tpu_torch import resilience
    from horovod_tpu_torch.training import make_loader_step

    x, y = _xy(40)

    def run(steps, ckpt, log):
        ld = tloader.ResumableLoader((x, y), 8, seed=2, device=False,
                                     name="train")

        def step(state, batch, i):
            log.append((i, batch[1].tolist()))
            return {"w": state["w"] + batch[0].sum()}

        try:
            return resilience.run(make_loader_step(step, ld),
                                  {"w": torch.zeros(())}, num_steps=steps,
                                  checkpoint_dir=ckpt, checkpoint_every=1)
        finally:
            ld.close()

    whole, first, resumed = [], [], []
    want = run(12, None, whole)
    run(5, str(tmp_path), first)
    got = run(12, str(tmp_path), resumed)
    assert first == whole[:5]
    at = resumed[0][0]          # the newest checkpoint's step
    assert 0 < at <= 5 and resumed == whole[at:]
    assert float(got["w"]) == float(want["w"])


def test_a_loader_asked_for_the_card_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _xy(16)
    for device in (None, "cuda", "cuda:0", True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tloader.ResumableLoader((x, y), 4, device=device,
                                    register=False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tloader.ShardedLoader((x, y), 4, device=device)
    t = tloader.ResumableLoader((x, y), 4, device="cpu", register=False)
    assert t.next_batch()[0].device.type == "cpu"
    t.close()


# ---------------------------------------------- the copy to the card, stubbed


class _Fake:
    """Stand-ins for the CUDA stream and event API that log what the feed
    does, in order."""

    def __init__(self, log):
        self.log = log

    def stream(self, device):
        log = self.log

        class Stream:
            def wait_event(self, ev):
                log.append(("wait_event", ev.n))

        return Stream()

    def event(self):
        log, n = self.log, len([e for e in self.log if e[0] == "record"])

        class Event:
            def record(self, stream):
                log.append(("record", n))

            def synchronize(self):
                log.append(("synchronize", n))

        ev = Event()
        ev.n = n
        return ev


def test_card_feed_fences_the_copy_and_the_slot_reuse(monkeypatch):
    """The feed's contract, host-only: each batch is copied on the copy
    stream and an event recorded after it; the consumer's stream waits on
    that event and every batch tensor is ``record_stream``-ed on it; a
    page-locked slot is refilled only after its last copy's event has
    been synchronised; the delivered rows are the gathered rows."""
    import contextlib

    log = []
    fake = _Fake(log)
    current = fake.stream(None)
    monkeypatch.setattr(torch.cuda, "Stream", fake.stream)
    monkeypatch.setattr(torch.cuda, "Event", fake.event)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: current)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, s: log.append(("record_stream",
                                                 t.shape[0])), raising=False)
    feed = tloader._CardFeed(torch.device("cpu"), 2)
    allocs = []

    def alloc(shape, dtype):
        allocs.append(shape)
        return torch.empty(shape, dtype=dtype)

    monkeypatch.setattr(feed, "_alloc", alloc)
    monkeypatch.setattr(feed, "_copy", lambda b: b.clone())
    x, y = _xy(24)
    staged = [feed.stage((x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8]))
              for i in range(3)]
    assert len(allocs) == 4                   # two slots, two arrays each
    # the third batch reuses slot 0: its first copy's event was waited on
    assert log.index(("synchronize", 0)) > log.index(("record", 1))
    assert [e for e in log if e[0] == "synchronize"] == [("synchronize", 0)]
    for i, (tensors, ev) in enumerate(staged):
        out = feed.hand_over(tensors, ev)
        np.testing.assert_array_equal(out[1].numpy(), y[i * 8:(i + 1) * 8])
        np.testing.assert_array_equal(out[0].numpy(), x[i * 8:(i + 1) * 8])
    waits = [e for e in log if e[0] == "wait_event"]
    assert waits == [("wait_event", 0), ("wait_event", 1), ("wait_event", 2)]
    assert [e for e in log if e[0] == "record_stream"] == \
        [("record_stream", 8)] * 6
