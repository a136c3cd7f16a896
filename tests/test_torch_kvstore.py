"""The rendezvous KV store of horovod_tpu_torch against the JAX package's
(``horovod_tpu/run/rendezvous.py``), on the wire: each package's
``KVStoreClient`` drives the other's ``KVStoreServer`` over HTTP (and its
own, as the control) through TTL expiry and the 410 tombstone,
``/-/clock``, the HMAC digest, fencing, and ``wait_for``'s
``DeadRankError`` carrying the dead rank; a write-ahead log written by
one package's server replays in the other's constructor and in its
``restart()``. Also the in-process pieces: ``InProcessKVStore``,
``kv_client_from_env`` and the server-side ``wait_for``."""

import os
import shutil
import time

import pytest

from horovod_tpu.run import rendezvous as jrdv
from horovod_tpu_torch.run import rendezvous as trdv

pytestmark = pytest.mark.torch_port

PKGS = {"jax": jrdv, "torch": trdv}
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]


@pytest.fixture(params=PAIRS, ids=IDS)
def pair(request):
    c, s = request.param
    secret = PKGS[s].make_secret()
    server = PKGS[s].KVStoreServer(secret=secret)
    port = server.start()
    client = PKGS[c].KVStoreClient("127.0.0.1", port, secret=secret)
    yield c, s, server, client
    server.close()


def test_put_get_delete_roundtrip(pair):
    c, s, server, client = pair
    client.put("job/a", b"\x00\x01bytes")
    assert client.get("job/a") == b"\x00\x01bytes"
    assert server.get("job/a") == b"\x00\x01bytes"
    assert client.get("job/missing") is None
    assert client.delete("job/a") is True
    assert client.delete("job/a") is False
    assert client.get("job/a") is None


def test_ttl_expiry_answers_410_with_the_rank(pair):
    c, s, server, client = pair
    client.put("job/ready/3", b"x", ttl=0.2)
    assert client.get("job/ready/3") == b"x"
    time.sleep(0.4)
    with pytest.raises(PKGS[c].DeadRankError) as ei:
        client.get("job/ready/3")
    assert ei.value.rank == 3
    t0 = time.monotonic()
    with pytest.raises(PKGS[c].DeadRankError) as ei:
        client.wait_for("job/ready/3", timeout=10.0)
    assert ei.value.rank == 3 and time.monotonic() - t0 < 2.0
    assert "/job/ready/3" in server.dead_keys()
    # a refreshed key is alive again
    client.put("job/ready/3", b"y", ttl=5.0)
    assert client.get("job/ready/3") == b"y"


def test_explicit_tombstone(pair):
    c, s, server, client = pair
    client.put("hb/5", b"1")
    client.delete("hb/5", tombstone=True)
    with pytest.raises(PKGS[c].DeadRankError) as ei:
        client.get("hb/5")
    assert ei.value.rank == 5


def test_wait_for_returns_a_late_key(pair):
    c, s, server, client = pair

    import threading

    threading.Timer(0.2, lambda: server.put("late/0", b"v")).start()
    assert client.wait_for("late/0", timeout=10.0) == b"v"
    with pytest.raises(TimeoutError):
        client.wait_for("never/0", timeout=0.3)


def test_clock_route(pair):
    c, s, server, client = pair
    before = time.monotonic()
    remote = client.server_clock()
    after = time.monotonic()
    # one process, one monotonic clock: the server's reading lies inside
    # the request's window
    assert before <= remote <= after


def test_digest_is_checked(pair):
    c, s, server, client = pair
    bad = PKGS[c].KVStoreClient("127.0.0.1", server.port,
                                secret=PKGS[c].make_secret())
    with pytest.raises(RuntimeError, match="403"):
        bad.put("job/x", b"1")
    assert server.get("job/x") is None
    assert jrdv._digest("k", b"body") == trdv._digest("k", b"body")


def test_fencing_refuses_a_stale_write(pair):
    c, s, server, client = pair
    client.put("gen/1", b"a")
    # a client that saw a newer epoch deposes the server: writes are 409
    client.note_epoch(server.fencing_epoch + 1)
    with pytest.raises(Exception, match="409|fenced|deposed"):
        client.put("gen/2", b"b")
    assert server.get("gen/2") is None


@pytest.mark.parametrize("writer,reader",
                         [("jax", "torch"), ("torch", "jax")])
def test_a_wal_replays_across_packages(tmp_path, writer, reader):
    wal = str(tmp_path / "kv.wal")
    a = PKGS[writer].KVStoreServer(wal_path=wal)
    a.put("gen/1", b"weights-1")
    a.put("hb/2", b"1", ttl=30.0)
    a.put("gone", b"x")
    a.delete("gone")
    a.put("dead/4", b"x")
    a.delete("dead/4", tombstone=True)
    a.close()
    # the other package's constructor replays it
    b = PKGS[reader].KVStoreServer(wal_path=wal)
    try:
        assert b.get("gen/1") == b"weights-1"
        assert b.get("hb/2") == b"1"
        assert b.get("gone") is None
        assert "/dead/4" in b.dead_keys()
        assert "/hb/2" in b.live_keys("/hb")
    finally:
        b.close()
    # and its restart(): a server of the reader's package on its own log,
    # which the writer's log replaces, comes back holding the writer's keys
    wal2 = str(tmp_path / "kv2.wal")
    c = PKGS[reader].KVStoreServer(wal_path=wal2)
    try:
        c.put("mine", b"1")
        c.start()
        shutil.copy(wal, wal2 + ".new")
        os.replace(wal2 + ".new", wal2)
        port = c.restart(replay=True)
        assert port == c.port
        assert c.get("gen/1") == b"weights-1" and c.get("mine") is None
        client = PKGS[writer].KVStoreClient("127.0.0.1", port)
        assert client.get("gen/1") == b"weights-1"
    finally:
        c.close()


def test_in_process_store_and_env_client(monkeypatch):
    for pkg in (jrdv, trdv):
        kv = pkg.InProcessKVStore()
        kv.put("a", b"1", ttl=5.0)
        assert kv.get("a") == b"1" and kv.get("b") is None
    server = trdv.KVStoreServer(secret="s3cret")
    port = server.start()
    try:
        monkeypatch.delenv("HVD_RUN_KV_ADDRS", raising=False)
        monkeypatch.setenv("HVD_RUN_KV_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVD_RUN_KV_PORT", str(port))
        monkeypatch.setenv("HVD_RUN_SECRET", "s3cret")
        for pkg in (jrdv, trdv):
            client = pkg.kv_client_from_env()
            client.put(f"env/{pkg.__name__}", b"ok")
        assert server.get("env/horovod_tpu.run.rendezvous") == b"ok"
        assert server.get("env/horovod_tpu_torch.run.rendezvous") == b"ok"
        monkeypatch.delenv("HVD_RUN_KV_ADDR")
        assert trdv.kv_client_from_env() is None
    finally:
        server.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_server_wait_for_attributes_a_dead_heartbeat(pkg):
    server = PKGS[pkg].KVStoreServer()
    try:
        server.put("hb/2", b"1", ttl=0.1)
        time.sleep(0.25)
        with pytest.raises(PKGS[pkg].DeadRankError) as ei:
            server.wait_for(["ready/2"], timeout=5.0, hb_scope="hb")
        assert ei.value.rank == 2
    finally:
        server.close()
