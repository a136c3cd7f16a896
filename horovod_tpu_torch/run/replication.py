"""Control-plane high availability for the rendezvous KV store.

The rendezvous :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` carries
everything the fleet coordinates through — elastic membership, the
sanitizer/numerics planes, the weight-publication chain, replica leases,
the rollout decision log — which made the one KV host the last single
point of failure in the system. This module closes it with the classic
production-control-plane shape (ZooKeeper/Raft lineage, scaled down to
the launcher's needs):

- :class:`ReplicationSender` — the primary ships every WAL record to N
  warm standbys *before* acknowledging the mutation (append-before-ack to
  a quorum, ``HOROVOD_KV_REPLICATION_QUORUM`` default 1; endpoints beyond
  the quorum receive the stream asynchronously). The wire format IS the
  WAL record format, torn-tail tolerance included. A standby that cannot
  be reached within ``HOROVOD_KV_REPLICATION_TIMEOUT`` is detached rather
  than stalling the primary; its divergence is visible as
  ``rendezvous_replication_lag_entries``.
- :class:`FailoverMonitor` — lease-based election: each standby probes
  the primary's ``/-/status``; once the lease
  (``HOROVOD_KV_REPLICA_LEASE``) expires it defers to any *ready*
  lower-index standby (lowest-ready wins) and otherwise promotes itself.
- :func:`promote` — the observable promotion wrapper: runs
  ``KVStoreServer.promote()`` (WAL lock acquired atomically, shipped WAL
  replayed with TTL leases re-armed, fencing epoch bumped past everything
  the log has seen), emits the ``FAILOVER`` flight-recorder event, bumps
  ``rendezvous_failovers``, and captures the promoted state's canonical
  bytes + digest so drills can assert zero lost commits.

A deposed primary's late writes are rejected with HTTP 409 — fencing is
enforced on the client-write path AND on the replication stream (see
``rendezvous.KVStoreServer.fence_check`` / ``apply_replicated``). A
standby that answers the stream with 409 deposes the shipping primary
(``KVStoreServer._ship_locked`` consults :attr:`ReplicationSender.fenced`),
so clients still pointed at it get 409 instead of silently-lost acks;
this module only elects and promotes, it never overrides a fence.

Run a control-plane member as a process (drills, remote standby hosts)::

    python -m horovod_tpu_torch.run.replication --role primary \
        --port 7021 --wal /var/run/hvd/kv.wal --replicas host2:7021
    python -m horovod_tpu_torch.run.replication --role standby \
        --port 7021 --wal /var/run/hvd/standby.wal \
        --primary host1:7021 --index 0

stdlib-only.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import queue
import threading
import time
from typing import Callable, Optional

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.run.rendezvous import (
    _EPOCH_HEADER,
    _HMAC_HEADER,
    _PRIMARY_HEADER,
    _REPL_MODE_HEADER,
    _SEQ_HEADER,
    _digest,
    KVStoreServer,
    REPLICATE_PATH,
    SECRET_ENV,
    STATUS_PATH,
    format_endpoints,
    parse_endpoints,
)

logger = logging.getLogger("horovod_tpu_torch.replication")

#: how many standbys ``horovodrun``/``run()`` should launch (flag
#: ``--kv-standbys`` overrides)
REPLICAS_ENV = "HOROVOD_KV_REPLICAS"

#: standbys that must acknowledge a record before the mutation is acked
#: (append-before-ack); endpoints beyond the quorum stream asynchronously
QUORUM_ENV = "HOROVOD_KV_REPLICATION_QUORUM"

#: primary lease (seconds): a standby promotes only after this long
#: without a healthy ``/-/status`` answer from the primary
LEASE_ENV = "HOROVOD_KV_REPLICA_LEASE"

#: per-shipment socket timeout (seconds); a standby slower than this is
#: detached rather than stalling every primary mutation behind it
TIMEOUT_ENV = "HOROVOD_KV_REPLICATION_TIMEOUT"


def replication_quorum() -> int:
    return int(os.environ.get(QUORUM_ENV, "1"))


def replica_lease() -> float:
    return float(os.environ.get(LEASE_ENV, "5.0"))


def replication_timeout() -> float:
    return float(os.environ.get(TIMEOUT_ENV, "5.0"))


class ReplicationFencedError(RuntimeError):
    """A standby answered the replication stream with 409: it has adopted
    a fencing epoch NEWER than this primary's — this primary is deposed
    and its shipments are the "late writes" the fence exists to stop."""


class _Endpoint:
    __slots__ = ("host", "port", "acked", "detached", "fenced",
                 "fenced_epoch", "queue", "thread")

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        self.acked = 0
        self.detached = False
        self.fenced = False
        self.fenced_epoch = 0  # the newer epoch the 409 answered with
        self.queue: "queue.Queue" = queue.Queue()
        self.thread: Optional[threading.Thread] = None

    def __repr__(self):
        return f"{self.host}:{self.port}"


class ReplicationSender:
    """Ships WAL records from a primary to its standbys.

    :meth:`ship` runs under the primary's store lock (the
    append-before-ack point): every record goes through a per-endpoint
    FIFO queue (strict delivery order per standby, even across sync/async
    reshuffles when a laggard detaches), and the mutation is not
    acknowledged until `quorum` live endpoints have accepted the record —
    the sync wait blocks on those endpoints' queue drains. The remaining
    endpoints receive the same stream asynchronously. ``lag()`` (and the
    ``rendezvous_replication_lag_entries`` gauge) reports the worst
    ``shipped - acked`` gap across non-fenced endpoints, detached ones
    included: a detached standby is an infinitely-lagging one, and the
    gauge is how an operator sees it."""

    def __init__(self, endpoints, secret: Optional[str] = None,
                 quorum: Optional[int] = None,
                 timeout: Optional[float] = None,
                 primary_hint: str = ""):
        self._endpoints = [_Endpoint(h, p) for h, p in endpoints]
        self._secret = secret if secret is not None else os.environ.get(
            SECRET_ENV, "")
        self._quorum = quorum if quorum is not None else replication_quorum()
        self._timeout = (
            timeout if timeout is not None else replication_timeout())
        self._primary_hint = primary_hint
        self._seq = 0
        self._closed = False
        for ep in self._endpoints:
            ep.thread = threading.Thread(
                target=self._drain, args=(ep,),
                name=f"hvd-kv-repl-{ep.host}:{ep.port}", daemon=True)
            ep.thread.start()

    @property
    def seq(self) -> int:
        """Records shipped so far (the stream's sequence counter)."""
        return self._seq

    @property
    def fenced(self) -> bool:
        """True once any standby has fenced this primary's stream."""
        return any(ep.fenced for ep in self._endpoints)

    @property
    def fenced_epoch(self) -> int:
        """Highest fencing epoch any 409 answered the stream with — the
        regime evidence ``KVStoreServer._ship_locked`` deposes on."""
        return max(
            (ep.fenced_epoch for ep in self._endpoints if ep.fenced),
            default=0)

    def endpoints(self) -> list:
        return [(ep.host, ep.port) for ep in self._endpoints]

    def _post(self, ep: _Endpoint, payload: bytes, epoch: int, seq: int,
              mode: str) -> None:
        headers = {
            _EPOCH_HEADER: str(epoch),
            _SEQ_HEADER: str(seq),
            _REPL_MODE_HEADER: mode,
        }
        if self._primary_hint:
            headers[_PRIMARY_HEADER] = self._primary_hint
        if self._secret:
            headers[_HMAC_HEADER] = _digest(self._secret, payload)
        c = http.client.HTTPConnection(
            ep.host, ep.port, timeout=self._timeout)
        try:
            c.request("POST", REPLICATE_PATH, body=payload, headers=headers)
            r = c.getresponse()
            body = r.read()
            if r.status == 409:
                ep.fenced = True
                try:
                    ep.fenced_epoch = max(
                        ep.fenced_epoch,
                        int(r.getheader(_EPOCH_HEADER) or 0))
                except ValueError:
                    pass
                raise ReplicationFencedError(
                    f"standby {ep} fenced this primary: "
                    f"{body.decode('utf-8', 'replace')}")
            if r.status != 200:
                raise RuntimeError(f"replicate to {ep}: HTTP {r.status}")
            ep.acked = max(ep.acked, seq)
        finally:
            c.close()

    def _detach(self, ep: _Endpoint, why: BaseException) -> None:
        logger.warning(
            "replication to standby %s failed (%s); detaching — it will "
            "need a snapshot re-bootstrap to rejoin", ep, why)
        ep.detached = True

    def _drain(self, ep: _Endpoint) -> None:
        while True:
            item = ep.queue.get()
            if item is None:
                return
            data, epoch, seq, done = item
            try:
                if not ep.detached and not ep.fenced:
                    self._post(ep, data, epoch, seq, "append")
                    self._update_lag_gauge()
            except ReplicationFencedError as e:
                logger.warning("replication: %s", e)
            except Exception as e:
                self._detach(ep, e)
            finally:
                # set unconditionally (detached/fenced/failed included)
                # so a sync waiter in ship() never hangs on this record
                done.set()

    def ship(self, data: bytes, epoch: int = 0) -> None:
        """Ship one WAL record. Called under the primary's store lock —
        returning IS the acknowledgement, so the sync quorum blocks
        here. Every record is routed through its endpoint's FIFO queue
        (an endpoint promoted into the sync set after a laggard detaches
        must flush its backlog first — an inline send would overtake the
        queued older records and reorder the stream on that standby);
        "sync" means waiting on the drain thread's completion event,
        walking down the endpoint list until the quorum is met. A fenced
        standby (409) marks this primary deposed-in-fact; the shipment
        is dropped and ``KVStoreServer._ship_locked`` deposes the
        server."""
        if self._closed:
            return
        self._seq += 1
        seq = self._seq
        entries = []
        for ep in self._endpoints:
            if ep.detached or ep.fenced:
                continue
            done = threading.Event()
            depth = ep.queue.qsize()
            ep.queue.put((data, epoch, seq, done))
            entries.append((ep, done, depth))
        synced = 0
        for ep, done, depth in entries:
            if synced >= self._quorum:
                break
            # the drain thread bounds each queued item by the socket
            # timeout, so this wait terminates; an endpoint whose backlog
            # cannot flush in time is a laggard — detach it and walk on
            # to the next endpoint for the quorum
            if not done.wait(self._timeout * (depth + 2)):
                self._detach(ep, TimeoutError(
                    f"backlog of {depth} queued records did not flush "
                    f"within {self._timeout * (depth + 2):.1f}s"))
                continue
            if ep.acked >= seq and not ep.detached and not ep.fenced:
                synced += 1
        self._update_lag_gauge()

    def bootstrap(self, payload: bytes, epoch: int = 0) -> None:
        """Snapshot-bootstrap every attached standby: the payload (the
        primary's canonical state records) REPLACES the standby's state
        and truncates its shipped WAL, after which the append stream is
        exact. Called under the primary's store lock by
        ``KVStoreServer.attach_replicator`` so no mutation can slip
        between the snapshot and the first shipped record."""
        for ep in self._endpoints:
            if ep.detached or ep.fenced:
                continue
            try:
                self._post(ep, payload, epoch, self._seq, "snapshot")
                ep.acked = max(ep.acked, self._seq)
            except Exception as e:
                self._detach(ep, e)
        self._update_lag_gauge()

    def lag(self) -> int:
        """Worst ``shipped - acked`` gap across non-fenced endpoints
        (detached included — that is the divergence the gauge exists to
        surface)."""
        lags = [self._seq - ep.acked
                for ep in self._endpoints if not ep.fenced]
        return max(lags) if lags else 0

    def _update_lag_gauge(self) -> None:
        if _metrics.enabled():
            _metrics.gauge(
                "rendezvous_replication_lag_entries",
                help="worst standby lag behind the primary's WAL stream "
                     "(entries shipped but not acknowledged)",
            ).set(float(self.lag()))

    def close(self) -> None:
        self._closed = True
        for ep in self._endpoints:
            ep.queue.put(None)
        for ep in self._endpoints:
            if ep.thread is not None:
                ep.thread.join(timeout=2)


class PromotionResult:
    """What :func:`promote` hands back: the new regime's epoch plus the
    canonical state bytes/digest at promotion time — the drill's
    zero-lost-commits evidence."""

    __slots__ = ("epoch", "digest", "state")

    def __init__(self, epoch: int, digest: str, state: bytes):
        self.epoch = epoch
        self.digest = digest
        self.state = state


def promote(kv: KVStoreServer, reason: str = "") -> PromotionResult:
    """Promote a standby to primary, observably: run the mechanical
    promotion (``KVStoreServer.promote()``), record the ``FAILOVER``
    flight event, bump ``rendezvous_failovers``, and capture the promoted
    state's canonical bytes + sha256 digest. Raises (naming the lock
    holder) if a live primary still owns the WAL lock — promotion is
    atomic or not at all."""
    epoch = kv.promote()
    state = kv.state_records()
    import hashlib

    digest = hashlib.sha256(state).hexdigest()
    if _metrics.enabled():
        _metrics.counter(
            "rendezvous_failovers",
            help="standby promotions to control-plane primary",
        ).inc()
    try:
        from horovod_tpu_torch.observability import flight as _flight

        _flight.record(
            "failover", epoch=epoch, reason=reason or "promotion",
            digest=digest, keys=len(kv.live_keys()))
    except Exception as e:  # observability must not block the promotion
        logger.debug("FAILOVER flight event skipped: %s", e)
    logger.warning(
        "KV standby promoted to primary (fencing epoch %d, state %s%s)",
        epoch, digest[:12], f"; reason: {reason}" if reason else "")
    return PromotionResult(epoch=epoch, digest=digest, state=state)


def status_of(host: str, port: int, secret: Optional[str] = None,
              timeout: float = 2.0) -> Optional[dict]:
    """One ``GET /-/status`` probe → the status dict, or None when the
    server is unreachable/unhealthy (the monitor's liveness signal)."""
    secret = secret if secret is not None else os.environ.get(
        SECRET_ENV, "")
    headers = {}
    if secret:
        headers[_HMAC_HEADER] = _digest(secret, b"")
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("GET", STATUS_PATH, headers=headers)
        r = c.getresponse()
        body = r.read()
        if r.status != 200:
            return None
        return json.loads(body)
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        c.close()


class FailoverMonitor(threading.Thread):
    """Lease-based election, run by each standby.

    Probes the primary's ``/-/status`` every ``poll`` seconds; while the
    primary answers as a primary the lease keeps renewing. Once the lease
    (`lease`, env ``HOROVOD_KV_REPLICA_LEASE``) expires, the election
    rule is *lowest-ready standby wins*: this standby (at `index`) defers
    as long as any lower-index peer still answers its status probe as a
    standby — and promotes itself otherwise. A peer that already answers
    as ``primary`` ends the election (the monitor keeps watching the NEW
    primary). Promotion failure (e.g. a live primary still holds the WAL
    lock — the lease expired on a slow network, not a dead process) logs
    and re-enters the wait instead of split-braining."""

    def __init__(self, kv: KVStoreServer, primary, *, peers=(),
                 index: int = 0, lease: Optional[float] = None,
                 poll: Optional[float] = None,
                 secret: Optional[str] = None,
                 on_promote: Optional[Callable] = None):
        super().__init__(name="hvd-kv-failover", daemon=True)
        self._kv = kv
        self._primary = (primary[0], int(primary[1]))
        self._peers = [(h, int(p)) for h, p in peers]
        self._index = index
        self._lease = lease if lease is not None else replica_lease()
        self._poll = poll if poll is not None else max(self._lease / 4, 0.05)
        self._secret = secret
        self._on_promote = on_promote
        # NOT named _stop: that would shadow threading.Thread's internal
        # _stop() and break join()
        self._halt = threading.Event()
        self.result: Optional[PromotionResult] = None

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)

    def run(self) -> None:
        last_ok = time.monotonic()
        while not self._halt.wait(self._poll):
            st = status_of(*self._primary, secret=self._secret,
                           timeout=max(self._poll, 0.25))
            if st is not None and st.get("role") == "primary":
                last_ok = time.monotonic()
                # track the primary's regime: a standby that has seen
                # epoch N can spot a stale regime the moment it answers
                self._watch_primary(st)
                continue
            if time.monotonic() - last_ok < self._lease:
                continue
            # lease expired — election: lowest READY standby wins
            if self._defer_to_lower_peer():
                continue
            try:
                self.result = promote(
                    self._kv,
                    reason=f"primary {self._primary[0]}:"
                           f"{self._primary[1]} lease expired "
                           f"({self._lease:.2f}s)")
            except RuntimeError as e:
                logger.warning(
                    "promotion deferred: %s (re-entering lease wait)", e)
                last_ok = time.monotonic()
                continue
            if self._on_promote is not None:
                try:
                    self._on_promote(self.result)
                except Exception as e:
                    logger.warning("on_promote callback failed: %s", e)
            return  # this server is the primary now; election is over

    def _watch_primary(self, st: dict) -> None:
        del st  # liveness is the signal; epoch travels in the stream

    def _defer_to_lower_peer(self) -> bool:
        """True when a lower-index peer should win this election: it is
        reachable and still a standby (it will promote), or it already
        promoted (the election is over and we stay a standby)."""
        for i, (host, port) in enumerate(self._peers):
            if i >= self._index:
                continue
            st = status_of(host, port, secret=self._secret,
                           timeout=max(self._poll, 0.25))
            if st is None:
                continue  # that peer is as dead as the primary
            if st.get("role") in ("standby", "primary"):
                return True
        return False


def spawn_local_standbys(n: int, secret: Optional[str] = None,
                         wal_dir: Optional[str] = None) -> list:
    """`n` in-process warm standbys (each with its own shipped-WAL file
    under `wal_dir` when given), started and ready to receive the
    replication stream. The launcher's local spelling of
    ``--kv-standbys``; remote hosts run the CLI below instead."""
    standbys = []
    for i in range(n):
        wal = (os.path.join(wal_dir, f"kv-standby-{i}.wal")
               if wal_dir else None)
        s = KVStoreServer(secret=secret, wal_path=wal, role="standby")
        s.start()
        standbys.append(s)
    return standbys


def main(argv=None) -> int:
    """Run one control-plane member as a process — the remote-standby
    launch target and the SIGKILL-drill victim. Prints
    ``KV <role> ready on port <port>`` once serving."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run.replication",
        description="Run a rendezvous KV control-plane member "
                    "(primary or warm standby).")
    p.add_argument("--role", choices=["primary", "standby"], required=True)
    p.add_argument("--port", type=int, default=0,
                   help="bind port (0 = ephemeral)")
    p.add_argument("--wal", default=None, help="write-ahead log path")
    p.add_argument("--replicas", default="",
                   help="primary: standby host:port list to ship to")
    p.add_argument("--quorum", type=int, default=None,
                   help="primary: sync replication quorum")
    p.add_argument("--advertise", default="127.0.0.1",
                   help="host to advertise in redirects/hints")
    p.add_argument("--primary", default=None,
                   help="standby: current primary host:port to monitor")
    p.add_argument("--peers", default="",
                   help="standby: other standbys host:port list "
                        "(election precedence order)")
    p.add_argument("--index", type=int, default=0,
                   help="standby: this standby's election index")
    p.add_argument("--lease", type=float, default=None,
                   help="standby: primary lease seconds")
    args = p.parse_args(argv)

    secret = os.environ.get(SECRET_ENV, "")
    kv = KVStoreServer(port=args.port, secret=secret or None,
                       wal_path=args.wal, role=args.role)
    kv.start()
    print(f"KV {args.role} ready on port {kv.port}", flush=True)

    monitor = None
    sender = None
    if args.role == "primary" and args.replicas:
        sender = ReplicationSender(
            parse_endpoints(args.replicas), secret=secret,
            quorum=args.quorum,
            primary_hint=f"{args.advertise}:{kv.port}")
        kv.attach_replicator(sender)
        logger.info("replicating to %s",
                    format_endpoints(sender.endpoints()))
    if args.role == "standby" and args.primary:
        monitor = FailoverMonitor(
            kv, parse_endpoints(args.primary)[0],
            peers=parse_endpoints(args.peers) if args.peers else (),
            index=args.index, lease=args.lease, secret=secret)
        monitor.start()

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if monitor is not None:
            monitor.stop()
        if sender is not None:
            sender.close()
        kv.close()
    return 0


if __name__ == "__main__":  # pragma: no cover - process entry
    raise SystemExit(main())
