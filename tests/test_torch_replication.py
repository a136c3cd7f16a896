"""The rendezvous KV store's replication in horovod_tpu_torch
(``horovod_tpu_torch/run/replication.py``) against the JAX package's,
case for case with ``tests/test_replication.py`` where a case has meaning
in the port: the WAL stream shipped append-before-ack, the snapshot
bootstrap, the duplicate guard, the unreachable standby's lag, fencing
(409 for a deposed primary's writes and stream), the standby's redirect,
promotion with and without a WAL, the client's failover, the lease
monitor's election, and the process entry point's ready line. Each
two-server case runs for a port primary shipping to a port standby, for
a JAX primary shipping to a port standby, and back: the stream is the
same wire."""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from horovod_tpu.run import rendezvous as jrdv, replication as jrep
from horovod_tpu_torch.observability import metrics
from horovod_tpu_torch.resilience import chaos, health
from horovod_tpu_torch.resilience.retry import RetryPolicy
from horovod_tpu_torch.run import rendezvous as trdv, replication as trep

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL = "127.0.0.1"
PKG = {"jax": (jrdv, jrep), "torch": (trdv, trep)}
#: (primary and its sender's package, standby's package)
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]
IDS = [f"{p}-primary-{s}-standby" for p, s in PAIRS]


@pytest.fixture(autouse=True)
def _fresh():
    metrics.reset()
    metrics.set_enabled(True)
    health.reset()
    chaos.configure(None)
    yield
    metrics.reset()
    health.reset()
    chaos.reset()


def _free_dead_port() -> int:
    s = socket.socket()
    s.bind((LOCAL, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _policy(**kw):
    base = dict(scope="kv", max_attempts=10, base_delay=0.1,
                max_delay=0.4, multiplier=2.0, jitter=0.0, deadline=30.0)
    base.update(kw)
    return RetryPolicy(**base)


@pytest.fixture(params=PAIRS, ids=IDS)
def pkgs(request):
    return request.param


def _pair(pkgs, tmp_path=None, wal=True):
    """A primary of the first package with its sender shipping (quorum 1)
    to a warm standby of the second."""
    p, s = pkgs
    prdv, prep = PKG[p]
    srdv = PKG[s][0]
    pw = str(tmp_path / "primary.wal") if wal and tmp_path else None
    sw = str(tmp_path / "standby.wal") if wal and tmp_path else None
    primary = prdv.KVStoreServer(wal_path=pw)
    primary.start()
    standby = srdv.KVStoreServer(wal_path=sw, role="standby")
    standby.start()
    sender = prep.ReplicationSender(
        [(LOCAL, standby.port)], quorum=1, timeout=2.0,
        primary_hint=f"{LOCAL}:{primary.port}")
    primary.attach_replicator(sender)
    return primary, standby, sender


def _close(*things):
    for t in things:
        t.close()


def test_wal_stream_ships_to_standby(pkgs, tmp_path):
    primary, standby, sender = _pair(pkgs, tmp_path)
    try:
        primary.put("/a", b"1")
        primary.put("/b", b"2", ttl=30.0)
        primary.put("/c", b"3")
        primary.delete("/c")
        assert standby.get("/a") == b"1"
        assert standby.get("/b") == b"2"
        assert standby.get("/c") is None
        assert sender.lag() == 0
        assert standby.applied_seq == sender.seq
        shipped = (tmp_path / "standby.wal").read_bytes()
        assert b'"/a"' in shipped and b'"del"' in shipped
        assert standby.state_digest() == primary.state_digest()
    finally:
        _close(sender, standby, primary)


def test_snapshot_bootstrap_for_late_joiner(pkgs, tmp_path):
    p, s = pkgs
    primary = PKG[p][0].KVStoreServer(wal_path=str(tmp_path / "p.wal"))
    primary.start()
    primary.put("/warm/a", b"A")
    primary.put("/warm/b", b"B")
    standby = PKG[s][0].KVStoreServer(wal_path=str(tmp_path / "s.wal"),
                                      role="standby")
    standby.start()
    sender = PKG[p][1].ReplicationSender([(LOCAL, standby.port)], quorum=1,
                                         timeout=2.0)
    try:
        sender.bootstrap(primary.state_records())
        assert standby.get("/warm/a") == b"A"
        primary.attach_replicator(sender)
        primary.put("/after", b"C")
        assert standby.get("/after") == b"C"
        assert standby.state_digest() == primary.state_digest()
    finally:
        _close(sender, standby, primary)


def test_duplicate_or_reordered_shipment_dropped():
    standby = trdv.KVStoreServer(role="standby")
    try:
        code, _ = standby.apply_replicated(
            b'{"op":"put","k":"/k","v":"bmV3"}\n', seq=2)
        assert code == 200 and standby.applied_seq == 2
        code, _ = standby.apply_replicated(
            b'{"op":"put","k":"/k","v":"b2xk"}\n', seq=1)
        assert code == 200
        assert standby.get("/k") == b"new" and standby.applied_seq == 2
    finally:
        standby.close()


def test_lag_counts_unreachable_standby():
    sender = trep.ReplicationSender([(LOCAL, _free_dead_port())], quorum=1,
                                    timeout=0.3)
    try:
        for _ in range(3):
            sender.ship(b'{"op":"put","k":"/x","v":""}\n')
        assert sender.lag() == 3
        assert metrics.value("rendezvous_replication_lag_entries") == 3.0
    finally:
        sender.close()


def test_deposed_primary_rejects_writes_409():
    s = trdv.KVStoreServer()
    s.start()
    client = trdv.KVStoreClient(LOCAL, s.port, retry_policy=_policy())
    try:
        client.put("/pre", b"ok")
        client.note_epoch(3)
        with pytest.raises(trdv.FencedError) as exc:
            client.put("/late", b"stale write")
        assert exc.value.epoch >= 3
        assert s.role == "deposed" and s.get("/late") is None
        assert s.get("/pre") == b"ok"
    finally:
        s.close()


def test_primary_deposed_when_standby_fences_stream(pkgs):
    primary, standby, sender = _pair(pkgs)
    try:
        standby.apply_replicated(b"", epoch=5, seq=0)
        primary.put("/x", b"1")
        assert sender.fenced and sender.fenced_epoch == 5
        assert primary.role == "deposed"
        client = PKG[pkgs[0]][0].KVStoreClient(LOCAL, primary.port,
                                               retry_policy=_policy())
        with pytest.raises(PKG[pkgs[0]][0].FencedError):
            client.put("/y", b"2")
    finally:
        _close(sender, standby, primary)


def test_standby_redirects_writes_to_primary(pkgs, tmp_path):
    primary, standby, sender = _pair(pkgs, tmp_path)
    client = trdv.KVStoreClient(LOCAL, standby.port, retry_policy=_policy())
    try:
        client.put("/via/standby", b"routed")
        assert primary.get("/via/standby") == b"routed"
        assert standby.get("/via/standby") == b"routed"
        assert (LOCAL, primary.port) in client.endpoints
    finally:
        _close(sender, standby, primary)


@pytest.mark.parametrize("wal", [False, True], ids=["wal_less", "wal"])
def test_promotion_keeps_every_commit(pkgs, tmp_path, wal):
    """Promotion of the standby (through its own package's ``promote``)
    comes up with the primary's state byte for byte, TTL leases re-armed;
    a promoted standby's WAL reopens at fencing epoch 1."""
    primary, standby, sender = _pair(pkgs, tmp_path, wal=wal)
    try:
        primary.put("/lease", b"alive", ttl=30.0)
        primary.put("/plain", b"x")
        pre = primary.state_records()
        primary.kill()
        res = PKG[pkgs[1]][1].promote(standby, reason="test")
        assert res.epoch == 1 and res.state == pre
        assert standby.role == "primary"
        assert standby.get("/lease") == b"alive"
    finally:
        _close(sender, standby, primary)
    if wal:
        reopened = trdv.KVStoreServer(wal_path=str(tmp_path / "standby.wal"))
        assert reopened.fencing_epoch == 1
        reopened.close()


def test_reads_fail_over_writes_resume_after_promotion(pkgs, tmp_path):
    primary, standby, sender = _pair(pkgs, tmp_path)
    client = trdv.KVStoreClient(
        endpoints=[(LOCAL, primary.port), (LOCAL, standby.port)],
        retry_policy=_policy())
    try:
        client.put("/before", b"1")
        primary.kill()
        assert client.get("/before") == b"1"
        assert client.failovers >= 1
        PKG[pkgs[1]][1].promote(standby)
        client.put("/after", b"2")
        assert standby.get("/after") == b"2"
        assert client.fencing_epoch_seen == 1
    finally:
        _close(sender, standby, primary)


def test_failover_monitor_promotes_after_the_lease(pkgs, tmp_path):
    """The standby's lease monitor (its package's) promotes it once the
    primary stops answering, and only then."""
    primary, standby, sender = _pair(pkgs, tmp_path)
    mon = PKG[pkgs[1]][1].FailoverMonitor(
        standby, (LOCAL, primary.port), lease=0.4, poll=0.05)
    mon.start()
    try:
        primary.put("/k", b"v")
        time.sleep(0.6)
        assert standby.role == "standby"     # the primary still answers
        t0 = time.monotonic()
        primary.kill()
        mon.join(timeout=10)       # the monitor ends once it promoted
        assert not mon.is_alive() and time.monotonic() - t0 < 10
        assert standby.role == "primary"
        assert mon.result is not None and mon.result.epoch == 1
        assert standby.get("/k") == b"v"
    finally:
        mon.stop()
        _close(sender, standby, primary)


def test_lowest_ready_standby_wins_the_election():
    primary = trdv.KVStoreServer()
    primary.start()
    s0 = trdv.KVStoreServer(role="standby")
    s1 = trdv.KVStoreServer(role="standby")
    s0.start()
    s1.start()
    peers = [(LOCAL, s0.port), (LOCAL, s1.port)]
    m1 = trep.FailoverMonitor(s1, (LOCAL, primary.port), peers=peers,
                              index=1, lease=0.3, poll=0.05)
    m0 = trep.FailoverMonitor(s0, (LOCAL, primary.port), peers=peers,
                              index=0, lease=0.3, poll=0.05)
    m1.start()
    m0.start()
    try:
        primary.kill()
        t0 = time.monotonic()
        while s0.role != "primary":
            assert time.monotonic() - t0 < 10
            time.sleep(0.02)
        time.sleep(0.5)
        assert s1.role == "standby"
    finally:
        m0.stop()
        m1.stop()
        _close(s0, s1, primary)


@pytest.mark.parametrize("module", ["horovod_tpu.run.replication",
                                    "horovod_tpu_torch.run.replication"])
def test_process_primary_ready_line_and_kill_drill(tmp_path, module):
    """``python -m <package>.run.replication --role primary`` prints the
    same ready line in both packages; killed, its port standby (or the
    JAX package's, for the port's primary) promotes and holds every
    replicated write."""
    standby_pkg = "torch" if module.startswith("horovod_tpu.") else "jax"
    srdv, srep = PKG[standby_pkg]
    standby = srdv.KVStoreServer(role="standby")
    standby.start()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--role", "primary", "--port", "0",
         "--replicas", f"{LOCAL}:{standby.port}", "--quorum", "1"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    mon = None
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("KV primary ready on port "), line
        pport = int(line.rsplit(" ", 1)[1])
        client = trdv.KVStoreClient(
            endpoints=[(LOCAL, pport), (LOCAL, standby.port)],
            retry_policy=_policy())
        for i in range(3):
            client.put(f"/drill/{i}", str(i).encode())
        mon = srep.FailoverMonitor(standby, (LOCAL, pport), lease=0.4,
                                   poll=0.05)
        mon.start()
        os.kill(proc.pid, signal.SIGKILL)
        assert proc.wait(timeout=10) == -signal.SIGKILL
        client.put("/drill/3", b"3")          # fails over, then resumes
        assert client.failovers >= 1
        assert standby.role == "primary"
        assert [standby.get(f"/drill/{i}") for i in range(4)] == [
            str(i).encode() for i in range(4)]
    finally:
        if mon is not None:
            mon.stop()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()
        standby.close()


def test_spawn_local_standbys_and_the_cli_help():
    standbys = trep.spawn_local_standbys(2)
    try:
        assert [s.role for s in standbys] == ["standby", "standby"]
        assert len({s.port for s in standbys}) == 2
    finally:
        for s in standbys:
            s.close()
    r = subprocess.run([sys.executable, "-m",
                        "horovod_tpu_torch.run.replication", "--help"],
                       capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    assert r.returncode == 0 and "--role" in r.stdout
    assert "found in sys.modules" not in r.stderr
