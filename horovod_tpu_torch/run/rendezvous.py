"""HTTP rendezvous / key-value store server.

Reference: ``horovod/run/http/http_server.py`` — the launcher runs a small
HTTP KV server; ranks PUT/GET scoped keys during bootstrap, and the
programmatic ``run()`` API ships the pickled function down and results back
through it (``KVStoreServer``, reference ``http_server.py:210-250``).

Counterpart of ``horovod_tpu/run/rendezvous.py``, the same wire format
(routes, headers, digest, WAL records), so the two packages' clients and
servers interoperate. The data-plane rendezvous is ``torch.distributed``'s
store, so this store's remaining jobs are (a) the ``run()`` function/result
shuttle, (b) generic scoped KV for launcher extensions, and (c) the elastic
membership plane: **heartbeat-scoped keys with a TTL**. A key PUT with a TTL
(``put(key, value, ttl=...)`` / the ``X-Hvd-TTL`` header) expires once its
writer stops refreshing it; expiry leaves a *tombstone*, so readers can tell
"never written" (404) from "written by a rank that since died" (410 Gone).
``wait_for`` consults the tombstones and the heartbeat namespace to surface
:class:`DeadRankError` carrying the dead rank's id *immediately* instead of
burning its whole deadline on a key whose writer can never write it.

Values are opaque bytes; a shared-secret HMAC header authenticates requests
(reference ``run/common/util/{secret,network}.py:49-83``).

**Durability** (the serving handoff leans on it): with ``wal_path`` the
server appends every mutation to a write-ahead log *before* acknowledging
it and :meth:`KVStoreServer.restart` / a fresh server on the same path
replays it — a KV restart no longer loses elastic membership or published
weight generations. TTL leases are re-armed for their full duration on
replay (a live writer refreshes them anyway; a dead one re-expires).
``sweep_interval`` arms a background sweep so TTL expiry and tombstone GC
happen on a timer, not only on access — bounding memory on long elastic
runs independent of traffic patterns (``rendezvous_keys_swept``).

**High availability**: the hooks the JAX package's ``run/replication.py``
drives are here (:meth:`KVStoreServer.apply_replicated`,
:meth:`KVStoreServer.promote`, :meth:`KVStoreServer.attach_replicator`);
the replicator is :mod:`horovod_tpu_torch.run.replication`. A primary
server ships every WAL record to warm standbys before acknowledging the
mutation (quorum 1 by default), every mutation carries a monotone
**fencing epoch** persisted in the WAL (``fe`` field), and a deposed
primary — one that has seen evidence of a newer epoch — answers every
write with **HTTP 409** instead of silently applying it. Standbys serve
reads, answer writes with a 307 redirect to the primary, and accept the
replication stream on ``/-/replicate``; promotion (``replication.promote``)
acquires the WAL lock, replays the shipped WAL, and re-arms TTL leases
exactly like :meth:`KVStoreServer.restart`. :class:`KVStoreClient` takes a
multi-endpoint list (``HVD_RUN_KV_ADDRS``) and fails over between them
under the existing retry scope without resetting ``wait_for`` deadlines,
echoing the highest fencing epoch it has seen so stale primaries are
detected on read AND fenced on write.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import http.server
import json
import os
import logging
import re
import threading
import time
from typing import Optional

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.resilience import chaos as _chaos, retry as _retry

logger = logging.getLogger("horovod_tpu_torch.rendezvous")

SECRET_ENV = "HVD_RUN_SECRET"
_HMAC_HEADER = "X-Hvd-Digest"
_TTL_HEADER = "X-Hvd-TTL"
_TOMBSTONE_HEADER = "X-Hvd-Tombstone"
#: fencing epoch: echoed on every response; clients send their highest
#: seen value on writes so a deposed primary fences (409) instead of
#: silently applying a stale regime's mutation
_EPOCH_HEADER = "X-Hvd-Fencing-Epoch"
_ROLE_HEADER = "X-Hvd-Role"
#: ``host:port`` hint a standby attaches to its 307 write redirects
_PRIMARY_HEADER = "X-Hvd-Primary"
#: replication stream sequence number (count of records shipped so far)
_SEQ_HEADER = "X-Hvd-Repl-Seq"
#: ``snapshot`` (bootstrap: replace state) or ``append`` (incremental)
_REPL_MODE_HEADER = "X-Hvd-Repl-Mode"

#: reserved routes (``-`` cannot collide with a rank-owned key)
REPLICATE_PATH = "/-/replicate"
STATUS_PATH = "/-/status"

#: multi-endpoint client wiring: comma-separated ``host:port`` list, the
#: primary first then the standbys (``kv_client_from_env`` prefers this
#: over the single-endpoint ``HVD_RUN_KV_ADDR``/``HVD_RUN_KV_PORT`` pair)
ADDRS_ENV = "HVD_RUN_KV_ADDRS"

#: fencing escape hatch: ``HOROVOD_KV_FENCING=0`` disables the 409
#: rejection path (debugging only — a disabled fence means a deposed
#: primary's late writes CAN be applied)
FENCING_ENV = "HOROVOD_KV_FENCING"


def fencing_enabled() -> bool:
    return os.environ.get(FENCING_ENV, "1") != "0"

#: reserved GET path answering the server's ``time.monotonic()`` — the
#: shared reference clock every rank's offset is estimated against
#: (:mod:`horovod_tpu_torch.observability.clock`); ``-`` cannot collide with a
#: rank-owned key (see ``_OWNER_RE``)
CLOCK_PATH = "/-/clock"

#: default TTL for heartbeat-scoped keys (seconds); the elastic layer's
#: failure-detection horizon. Tests use ~0.2s.
HEARTBEAT_TTL_ENV = "HOROVOD_ELASTIC_HEARTBEAT_TTL"

#: background sweep cadence (seconds; 0 = lazy sweep on access only)
SWEEP_INTERVAL_ENV = "HOROVOD_KV_SWEEP_INTERVAL"

#: tombstone retention (seconds) before the background sweep drops them;
#: must comfortably exceed the slowest reader's poll interval — a dropped
#: tombstone makes a dead key look never-written (404 instead of 410)
TOMBSTONE_TTL_ENV = "HOROVOD_KV_TOMBSTONE_TTL"


def default_heartbeat_ttl() -> float:
    return float(os.environ.get(HEARTBEAT_TTL_ENV, "10.0"))


class DeadRankError(RuntimeError):
    """A KV wait cannot complete because the rank that owns the awaited key
    is dead (its heartbeat TTL expired or it was explicitly tombstoned).
    ``rank`` is the dead rank's id (or -1 when unattributable)."""

    def __init__(self, rank: int, key: str = ""):
        self.rank = int(rank)
        self.key = key
        super().__init__(
            f"rank {rank} is dead (heartbeat expired)"
            + (f"; awaited key {key}" if key else "")
        )


class FencedError(RuntimeError):
    """A KV write was rejected with HTTP 409: the target server is deposed
    (a newer fencing epoch exists) and must never silently apply a stale
    regime's mutation. ``epoch`` is the highest epoch the client has
    observed — the regime the write should be re-issued under."""

    def __init__(self, msg: str, epoch: int = -1):
        self.epoch = int(epoch)
        super().__init__(msg)


#: trailing rank id in a scoped key: ``.../ack/3`` or ``.../result_3``
_OWNER_RE = re.compile(r"(?:/|_)(\d+)$")


def _key_owner(key: str) -> Optional[int]:
    m = _OWNER_RE.search(key)
    return int(m.group(1)) if m else None

#: failures worth retrying on the KV path. ``OSError`` deliberately covers
#: the whole startup-race family (ConnectionRefusedError/ResetError, and
#: socket.timeout, all OSError subclasses on py3.10+) — retrying an
#: occasional non-transient OSError is bounded by the policy's deadline,
#: while a missed transient one kills the job. Torn HTTP exchanges surface
#: as ``HTTPException``; chaos injections as ``TransientError``.
TRANSIENT_KV_ERRORS = (
    OSError,
    http.client.HTTPException,
    _retry.TransientError,
)


def make_secret() -> str:
    return os.urandom(16).hex()


def _digest(secret: str, body: bytes) -> str:
    return hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _check_auth(self, body: bytes) -> bool:
        secret = self.server._secret  # type: ignore[attr-defined]
        if not secret:
            return True
        given = self.headers.get(_HMAC_HEADER, "")
        return hmac.compare_digest(given, _digest(secret, body))

    def _reply(self, code: int, body: bytes = b"", headers=None):
        self.send_response(code)
        kv = getattr(self.server, "_kv", None)
        if kv is not None:
            # fencing-epoch echo on EVERY response: readers compare it to
            # the highest epoch they have seen and walk away from a stale
            # primary instead of trusting its pre-failover view
            self.send_header(_EPOCH_HEADER, str(kv.fencing_epoch))
            self.send_header(_ROLE_HEADER, kv.role)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _gate_mutation(self) -> bool:
        """Standby redirect + fencing check shared by PUT/DELETE. True when
        the mutation may proceed; False after a 307/409 reply."""
        kv = self.server._kv  # type: ignore[attr-defined]
        if kv.role == "standby":
            hint = kv.primary_hint
            self._reply(
                307, b"standby: redirect writes to the primary",
                headers={_PRIMARY_HEADER: hint} if hint else None,
            )
            return False
        code = kv.fence_check(self.headers.get(_EPOCH_HEADER))
        if code is not None:
            self._reply(code, b"write fenced: this server is deposed")
            return False
        return True

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._check_auth(body):
            return self._reply(403)
        if not self._gate_mutation():
            return
        ttl = self.headers.get(_TTL_HEADER)
        self.server._kv.put(  # type: ignore[attr-defined]
            self.path, body, ttl=float(ttl) if ttl is not None else None
        )
        self._reply(200)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._check_auth(body):
            return self._reply(403)
        if self.path != REPLICATE_PATH:
            return self._reply(404)
        code, reply = self.server._kv.apply_replicated(  # type: ignore[attr-defined]
            body,
            epoch=int(self.headers.get(_EPOCH_HEADER, 0)),
            seq=int(self.headers.get(_SEQ_HEADER, 0)),
            mode=self.headers.get(_REPL_MODE_HEADER, "append"),
            primary=self.headers.get(_PRIMARY_HEADER),
        )
        self._reply(code, reply)

    def do_GET(self):
        if not self._check_auth(b""):
            return self._reply(403)
        if self.path == CLOCK_PATH:
            # read the clock as late as possible: the client's midpoint
            # estimate charges everything between its t0/t1 to the RTT
            return self._reply(200, repr(time.monotonic()).encode())
        if self.path == STATUS_PATH:
            return self._reply(
                200, json.dumps(self.server._kv.status()).encode()  # type: ignore[attr-defined]
            )
        val, dead = self.server._kv._get_with_liveness(self.path)  # type: ignore[attr-defined]
        if val is None:
            if dead:
                owner = _key_owner(self.path)
                return self._reply(
                    410, str(owner if owner is not None else -1).encode()
                )
            return self._reply(404)
        self._reply(200, val)

    def do_DELETE(self):
        if not self._check_auth(b""):
            return self._reply(403)
        if not self._gate_mutation():
            return
        tombstone = self.headers.get(_TOMBSTONE_HEADER) == "1"
        existed = self.server._kv.delete(  # type: ignore[attr-defined]
            self.path, tombstone=tombstone
        )
        self._reply(200 if existed else 404)

    def log_message(self, *a):  # quiet
        pass


class KVStoreServer:
    """Threaded KV server; start/stop + blocking wait for keys.

    Beyond plain KV, keys can carry a **TTL** (heartbeat-scoped keys): an
    expired key is removed from the store and *tombstoned*, so
    :meth:`wait_for` (and the HTTP GET path, which answers 410 Gone) can
    attribute "this key's writer died" instead of timing out. Expiry is
    swept lazily under the store lock on every access; `sweep_interval`
    (env ``HOROVOD_KV_SWEEP_INTERVAL``, 0 = off) additionally arms a
    background timer that sweeps expiry AND drops tombstones older than
    `tombstone_ttl` (env ``HOROVOD_KV_TOMBSTONE_TTL``), so memory stays
    bounded on long runs whose keys nobody reads.

    With `wal_path` every mutation is appended to a write-ahead log before
    it is acknowledged; a fresh server on the same path — or
    :meth:`restart` in place — replays it, so membership and published
    weight generations survive a KV process crash. The log is compacted to
    the live state on every open.

    With ``role="standby"`` the server is a warm replica: it opens the
    shipped WAL **read-only** for replay — no ``.lock`` steal, no
    compaction — serves reads, answers writes with a 307 redirect to the
    primary, and applies the primary's replication stream
    (:meth:`apply_replicated`). Replicated records are persisted to the
    standby's WAL only once it *owns* the ``.lock``; a standby pointed at
    a live primary's WAL path (shared filesystem) keeps the stream in
    memory and lets the primary's own log be the durable copy.
    ``replication.promote`` turns it into the
    primary. Every mutation is stamped with the server's **fencing epoch**
    (persisted in the WAL, so a restarted server keeps its regime);
    evidence of a newer epoch — a client write or a replication record
    carrying one — deposes the server, and a deposed server answers every
    write with HTTP 409, never silently applying it."""

    def __init__(self, port: int = 0, secret: Optional[str] = None,
                 wal_path: Optional[str] = None,
                 sweep_interval: Optional[float] = None,
                 tombstone_ttl: Optional[float] = None,
                 role: str = "primary",
                 fencing_epoch: int = 0):
        if role not in ("primary", "standby"):
            raise ValueError(f"role must be primary|standby, got {role!r}")
        self._store: dict = {}
        self._ttl: dict = {}  # key -> (expiry_monotonic, lease_seconds)
        self._dead: dict = {}  # tombstones: key -> time of death
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._secret = secret or ""
        self._wal_path = wal_path
        self._wal = None
        self._wal_records = 0
        self._role = role
        self._fencing_epoch = int(fencing_epoch)
        self._deposed = False
        self._applied_seq = 0  # replication records applied (standby side)
        self._primary_hint = ""  # host:port the replication stream names
        self._replicator = None  # ReplicationSender (primary side)
        self._sweep_interval = (
            sweep_interval
            if sweep_interval is not None
            else float(os.environ.get(SWEEP_INTERVAL_ENV, "0"))
        )
        self._tombstone_ttl = (
            tombstone_ttl
            if tombstone_ttl is not None
            else float(os.environ.get(TOMBSTONE_TTL_ENV, "300"))
        )
        self._sweep_stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        self._thread: Optional[threading.Thread] = None
        self._wal_lock = None
        if wal_path is not None:
            if role == "primary":
                # exclusive-lock the WAL BEFORE replay/compaction: a second
                # server on the same path (operator error, a restart racing
                # the old process) would otherwise compact the live
                # server's log out from under it — observed as silently
                # truncated generations when the loser's constructor ran
                # before its port bind failed
                self._acquire_wal_lock()
            # a standby replays WITHOUT the lock (read-only open): it must
            # be able to warm up from a shipped WAL while the primary on a
            # shared filesystem still owns the live log
            self._replay_wal()
        if role == "primary":
            self._open_wal()
        # standby: no compaction, no append handle — the shipped WAL is
        # opened for append lazily on the first replicated record, and
        # only after claiming the .lock, so a replica sharing a live
        # primary's path never writes the primary's file
        self._httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._httpd._secret = self._secret  # type: ignore[attr-defined]
        self._httpd._kv = self  # type: ignore[attr-defined]
        self._start_sweeper()
        self._set_ha_gauges()

    # ------------------------------------------------------ write-ahead log

    def _acquire_wal_lock(self) -> None:
        """Hold ``<wal_path>.lock`` exclusively for this server's lifetime
        (kept across :meth:`restart`, released by :meth:`close`). Raises
        when another live server owns the WAL; the error names the holder
        from the lock file's ``role=... fe=... pid=...`` stamp, so a
        promotion that raced a still-live primary reads as exactly that.
        Idempotent: a standby that already claimed the lock (to persist
        the shipped stream) keeps its handle through promotion."""
        if self._wal_lock is not None:
            return
        try:
            import fcntl
        except ImportError:  # pragma: no cover - non-POSIX
            return
        fd = os.fdopen(
            os.open(self._wal_path + ".lock",
                    os.O_RDWR | os.O_CREAT, 0o644),
            "r+b",
        )
        try:
            fcntl.flock(fd.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                holder = fd.read(256).decode("utf-8", "replace").strip()
            except Exception:
                holder = ""
            fd.close()
            raise RuntimeError(
                f"WAL {self._wal_path} is locked by another live "
                "KVStoreServer"
                + (f" ({holder})" if holder else "")
                + "; refusing to replay/compact a log that is "
                "still being written"
            ) from None
        self._wal_lock = fd
        self._stamp_wal_lock()

    def _stamp_wal_lock(self) -> None:
        """Write ``role=<role> fe=<epoch> pid=<pid>`` into the held lock
        file — purely diagnostic, read by the loser of a lock race."""
        if self._wal_lock is None:
            return
        try:
            self._wal_lock.seek(0)
            self._wal_lock.truncate()
            self._wal_lock.write(
                f"role={self.role} fe={self._fencing_epoch} "
                f"pid={os.getpid()}\n".encode()
            )
            self._wal_lock.flush()
        except Exception as e:  # diagnostics must never fail serving
            logger.debug("WAL lock stamp failed: %s", e)

    def _release_wal_lock(self) -> None:
        if self._wal_lock is not None:
            try:
                self._wal_lock.close()  # closing drops the flock
            except Exception as e:
                logger.debug("WAL lock release failed: %s", e)
            self._wal_lock = None

    def _replay_wal(self) -> None:
        """Rebuild the in-memory store from the WAL. TTL leases are
        re-armed for their full duration (a live writer's next heartbeat
        refreshes them; a dead writer's lease re-expires and tombstones),
        tombstones are restored as of replay time."""
        if not os.path.exists(self._wal_path):
            return
        now = time.monotonic()
        replayed = 0
        with open(self._wal_path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break  # torn tail write: everything before it is good
                self._apply_record_locked(rec, now)
                replayed += 1
        if replayed and _metrics.enabled():
            _metrics.counter(
                "rendezvous_wal_replayed",
                help="WAL records replayed into a restarted KV store",
            ).inc(replayed)

    def _apply_record_locked(self, rec: dict, now: float) -> None:
        """Apply one WAL/replication record to the in-memory maps; caller
        holds the store lock (or is the single-threaded constructor). A
        record's ``fe`` field raises this server's fencing epoch — replay
        of a WAL written under epoch N restores epoch >= N, so a regime
        survives its server's restart ("fencing epoch pinned")."""
        op, k = rec.get("op"), rec.get("k")
        if op == "put":
            self._store[k] = base64.b64decode(rec["v"])
            if rec.get("ttl") is not None:
                lease = float(rec["ttl"])
                self._ttl[k] = (now + lease, lease)
            else:
                self._ttl.pop(k, None)
            self._dead.pop(k, None)
        elif op == "del":
            self._store.pop(k, None)
            self._ttl.pop(k, None)
            if rec.get("ts"):
                self._dead[k] = now
            else:
                self._dead.pop(k, None)
        elif op == "prune":
            for m in (self._store, self._ttl, self._dead):
                for kk in [kk for kk in m if kk.startswith(k)]:
                    del m[kk]
        # "epoch" records carry only the fe field (compaction marker)
        fe = rec.get("fe")
        if fe is not None and int(fe) > self._fencing_epoch:
            self._fencing_epoch = int(fe)

    def _open_wal(self) -> None:
        """(Re-)open the WAL compacted to the current live state: one put
        per surviving key + one tombstone record per death, instead of the
        full mutation history."""
        if self._wal_path is None:
            return
        tmp = self._wal_path + ".compact"
        with open(tmp, "wb") as f:
            n = 0
            for k, v in self._store.items():
                lease = self._ttl.get(k)
                f.write(_wal_record(
                    "put", k, v, ttl=lease[1] if lease else None))
                n += 1
            for k in self._dead:
                if k not in self._store:
                    f.write(_wal_record("del", k, tombstone=True))
                    n += 1
            if self._fencing_epoch > 0:
                # pin the regime: a fresh server replaying an otherwise
                # empty compacted log must still come up at this epoch
                f.write(_wal_record("epoch", "/", fe=self._fencing_epoch))
                n += 1
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._wal_path)
        self._wal = open(self._wal_path, "ab")
        self._wal_records = n
        self._update_wal_gauge()
        self._stamp_wal_lock()

    def _wal_append_locked(self, data: bytes) -> None:
        """Append one record; caller holds the store lock. A WAL write
        failure is fatal to durability, not to serving — log-and-continue
        would silently lose acknowledged writes, so let it raise."""
        if self._wal is None:
            return
        self._wal.write(data)
        self._wal.flush()
        self._wal_records += 1
        self._update_wal_gauge()

    def _update_wal_gauge(self) -> None:
        if self._wal is not None and _metrics.enabled():
            _metrics.gauge(
                "rendezvous_wal_records",
                help="records in the KV write-ahead log since last compact",
            ).set(self._wal_records)

    # --------------------------------------------------- HA / replication

    @property
    def role(self) -> str:
        """``primary`` / ``standby`` / ``deposed`` (a server that saw
        evidence of a newer fencing epoch and must not apply writes)."""
        return "deposed" if self._deposed else self._role

    @property
    def fencing_epoch(self) -> int:
        return self._fencing_epoch

    @property
    def primary_hint(self) -> str:
        """``host:port`` of the primary as named by the replication
        stream — attached to a standby's 307 write redirects."""
        return self._primary_hint

    @property
    def applied_seq(self) -> int:
        """Highest replication sequence number applied (standby side)."""
        return self._applied_seq

    def _set_ha_gauges(self) -> None:
        if not _metrics.enabled():
            return
        role_code = (
            2.0 if self._deposed
            else (0.0 if self._role == "primary" else 1.0)
        )
        _metrics.gauge(
            "rendezvous_role",
            help="control-plane role of this KV server "
                 "(0=primary, 1=standby, 2=deposed)",
        ).set(role_code)
        _metrics.gauge(
            "rendezvous_fencing_epoch",
            help="highest fencing epoch this KV server has adopted",
        ).set(float(self._fencing_epoch))

    def _depose_locked(self, newer_epoch: int) -> None:
        """Mark this server fenced: epoch `newer_epoch` (> ours) exists,
        so a newer primary was elected while we weren't looking. Every
        subsequent write is answered 409 — the "late writes from a
        deposed primary" hole is closed at the server, not only at the
        clients. Our own epoch is deliberately NOT bumped: readers
        comparing the echoed epoch against the newest they have seen must
        keep detecting this server as stale."""
        if not self._deposed:
            logger.warning(
                "KV server deposed: observed fencing epoch %d > own %d",
                newer_epoch, self._fencing_epoch,
            )
        self._deposed = True

    def fence_check(self, raw_epoch: Optional[str]) -> Optional[int]:
        """Gate one client mutation. `raw_epoch` is the client's echoed
        highest-seen-epoch header (string or None). Returns None when the
        write may proceed, else the HTTP status (409) to answer."""
        if not fencing_enabled():
            return None
        try:
            seen = int(raw_epoch) if raw_epoch else 0
        except (TypeError, ValueError):
            seen = 0
        deposed_now = False
        with self._lock:
            if seen > self._fencing_epoch:
                self._depose_locked(seen)
                deposed_now = True
            fenced = self._deposed
        if deposed_now:
            self._set_ha_gauges()
        return 409 if fenced else None

    def _try_own_wal(self) -> bool:
        """Best-effort exclusive claim on the WAL for standby-side
        persistence of the shipped stream. False when another live server
        owns it — the shared-filesystem configuration, where the standby's
        ``wal_path`` IS the primary's live log: writing there would
        truncate/interleave into a file the primary still appends to, so
        the standby keeps the stream in memory only (the owner's WAL is
        the durable copy, replayed at promotion once the lock is free)."""
        if self._wal_lock is not None:
            return True
        try:
            self._acquire_wal_lock()
            return True
        except RuntimeError:
            return False

    def _standby_wal_append_locked(self, data: bytes) -> None:
        """Persist one replicated record to the shipped WAL. The append
        handle opens lazily on the first record, and ONLY once this
        standby owns the ``.lock`` — a standby sharing the primary's WAL
        path must never write into the live log the primary still owns."""
        if self._wal_path is None:
            return
        if self._wal is None:
            if not self._try_own_wal():
                return
            self._wal = open(self._wal_path, "ab")
        self._wal.write(data)
        self._wal.flush()
        self._wal_records += 1
        self._update_wal_gauge()

    def apply_replicated(self, payload: bytes, *, epoch: int = 0,
                         seq: int = 0, mode: str = "append",
                         primary: Optional[str] = None):
        """Apply a shipped batch of WAL records (the ``/-/replicate``
        POST body). Fencing first: a batch whose epoch is BEHIND this
        server's is a deposed primary's late shipment — rejected with
        409, never applied; a batch AHEAD of a primary's own epoch is
        evidence this server lost an election it never saw — it deposes
        itself. A standby adopts the stream's epoch, applies the records
        under the store lock, and persists them to its shipped WAL.
        ``mode="snapshot"`` (bootstrap) replaces state and truncates the
        shipped WAL first. Returns ``(http_status, body)``."""
        with self._lock:
            if self._role == "primary" or self._deposed:
                if epoch > self._fencing_epoch:
                    self._depose_locked(epoch)
                return 409, (
                    f"not a standby (role={self.role}, "
                    f"fe={self._fencing_epoch})"
                ).encode()
            if fencing_enabled() and epoch < self._fencing_epoch:
                return 409, (
                    f"replication fenced: batch epoch {epoch} is behind "
                    f"fencing epoch {self._fencing_epoch}"
                ).encode()
            if epoch > self._fencing_epoch:
                self._fencing_epoch = epoch
            if primary:
                self._primary_hint = primary
            now = time.monotonic()
            if mode == "snapshot":
                self._store.clear()
                self._ttl.clear()
                self._dead.clear()
                # the snapshot defines the stream position: appends the
                # old stream already delivered are behind it by seq
                self._applied_seq = seq
                if self._wal is not None:
                    self._wal.close()
                    self._wal = None
                if self._wal_path is not None and self._try_own_wal():
                    # the snapshot replaces history: truncate OUR shipped
                    # log (a shared WAL still owned by a live primary is
                    # never touched — see _try_own_wal)
                    self._wal = open(self._wal_path, "wb")
                    self._wal_records = 0
            elif seq and seq <= self._applied_seq:
                # duplicate / reordered shipment (at-least-once delivery):
                # applying it would regress last-write-wins keys to stale
                # values — drop it idempotently
                return 200, str(self._applied_seq).encode()
            applied = 0
            for line in payload.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break  # torn tail: same tolerance as replay
                self._apply_record_locked(rec, now)
                self._standby_wal_append_locked(line + b"\n")
                applied += 1
            if mode == "snapshot":
                pass  # position pinned to the snapshot's seq above
            elif seq:
                self._applied_seq = max(self._applied_seq, seq)
            else:
                self._applied_seq += applied
            self._cv.notify_all()
            result = 200, str(self._applied_seq).encode()
        self._set_ha_gauges()
        return result

    def _ship_locked(self, data: bytes) -> None:
        """Append-before-ack replication: the record reaches the quorum
        of standbys (or the sender detaches the laggard) before the
        mutation is acknowledged. Caller holds the store lock. A standby
        that fences the stream (409) is proof a newer regime exists —
        this server deposes itself on the spot, so clients still pointed
        here get 409 on their next write instead of HTTP 200 for commits
        the new regime will never see."""
        if self._replicator is None:
            return
        self._replicator.ship(data, epoch=self._fencing_epoch)
        if (fencing_enabled() and not self._deposed
                and self._replicator.fenced):
            self._depose_locked(max(
                self._replicator.fenced_epoch, self._fencing_epoch + 1))
            self._set_ha_gauges()

    def attach_replicator(self, sender) -> None:
        """Wire a :class:`horovod_tpu_torch.run.replication.ReplicationSender`:
        the standbys are bootstrapped with a snapshot of the current
        state under the store lock (no mutation can slip between the
        snapshot and the first shipped record), then every subsequent
        mutation ships before it is acknowledged."""
        with self._lock:
            self._replicator = sender
            sender.bootstrap(
                b"".join(self._state_records_locked()),
                epoch=self._fencing_epoch,
            )

    def _state_records_locked(self) -> list:
        recs = []
        for k in sorted(self._store):
            lease = self._ttl.get(k)
            recs.append(_wal_record(
                "put", k, self._store[k],
                ttl=lease[1] if lease else None))
        for k in sorted(self._dead):
            if k not in self._store:
                recs.append(_wal_record("del", k, tombstone=True))
        return recs

    def state_records(self) -> bytes:
        """Canonical serialization of the live state: sorted puts + sorted
        tombstones, WITHOUT epoch stamps — comparable across regimes. The
        failover drill compares a promoted standby's bytes against what
        the dead primary's WAL replays to; byte identity means zero lost
        commits."""
        with self._lock:
            return b"".join(self._state_records_locked())

    def state_digest(self) -> str:
        return hashlib.sha256(self.state_records()).hexdigest()

    def status(self) -> dict:
        """The ``GET /-/status`` body — what the failover monitor and the
        launcher read to pick a promotion candidate."""
        with self._lock:
            return {
                "role": self.role,
                "fencing_epoch": self._fencing_epoch,
                "applied_seq": self._applied_seq,
                "keys": len(self._store),
                "wal_records": self._wal_records,
                "primary_hint": self._primary_hint,
            }

    def promote(self) -> int:
        """Standby → primary: the :meth:`restart` path wearing a new
        regime. Acquires the WAL ``.lock`` atomically (raises, naming the
        holder, if a live primary still owns it), replays the shipped WAL
        with TTL leases re-armed for their full duration, bumps the
        fencing epoch past everything the log has seen, and starts
        compacting + appending as the new write path. A WAL-less standby
        promotes in place from its replicated in-memory state (leases
        re-armed the same way) instead of clearing it. Returns the new
        fencing epoch. Observability (the FAILOVER flight event and the
        ``rendezvous_failovers`` counter) lives in
        :func:`horovod_tpu_torch.run.replication.promote`, which wraps this."""
        if self.role != "standby":
            raise RuntimeError(
                f"promote(): role is {self.role}, not standby")
        if self._wal is not None:  # the standby's lazy append handle
            self._wal.close()
            self._wal = None
        if self._wal_path is not None:
            self._acquire_wal_lock()
        with self._lock:
            if self._wal_path is not None:
                self._store.clear()
                self._ttl.clear()
                self._dead.clear()
                self._replay_wal()
            else:
                # WAL-less standby (the runner's default local wiring):
                # the replicated in-memory state IS the state — promote
                # in place, re-arming TTL leases for their full duration
                # exactly like a WAL replay would
                now = time.monotonic()
                for k, (_, lease) in list(self._ttl.items()):
                    self._ttl[k] = (now + lease, lease)
            self._fencing_epoch += 1
            self._role = "primary"
            self._deposed = False
            self._primary_hint = ""
            self._open_wal()
            self._cv.notify_all()
        self._set_ha_gauges()
        return self._fencing_epoch

    def kill(self) -> None:
        """Model a SIGKILL of the KV process: drop the socket, the WAL
        append handle, and the ``.lock`` with no graceful teardown and no
        final compaction — durable state is exactly the WAL bytes already
        flushed (the kernel releases a dead process's flock the same
        way). Chaos ``kv_kill_primary_at_step`` drives this in the
        failover drill."""
        self._stop_sweeper()
        try:
            if self._thread is not None:
                self.stop()
            else:
                self._httpd.server_close()
        except Exception as e:
            logger.debug("kill: socket teardown: %s", e)
        if self._wal is not None:
            try:
                self._wal.close()
            except Exception as e:
                logger.debug("kill: wal close: %s", e)
            self._wal = None
        self._release_wal_lock()

    # ------------------------------------------------------------- sweeping

    def _sweep_locked(self):
        """Move TTL-expired keys to the tombstone map. Caller holds the
        store lock."""
        now = time.monotonic()
        expired = [k for k, (t, _) in self._ttl.items() if t <= now]
        for k in expired:
            self._ttl.pop(k, None)
            self._store.pop(k, None)
            self._dead[k] = now
        if expired and _metrics.enabled():
            _metrics.counter(
                "rendezvous_keys_swept",
                help="KV keys reclaimed by the TTL/tombstone sweep",
                kind="expired",
            ).inc(len(expired))

    def _gc_tombstones_locked(self):
        """Drop tombstones past their retention. Timer-only: lazy access
        must never shorten the 410 window readers rely on."""
        if self._tombstone_ttl <= 0:
            return
        horizon = time.monotonic() - self._tombstone_ttl
        stale = [k for k, t in self._dead.items() if t <= horizon]
        for k in stale:
            del self._dead[k]
        if stale and _metrics.enabled():
            _metrics.counter(
                "rendezvous_keys_swept",
                help="KV keys reclaimed by the TTL/tombstone sweep",
                kind="tombstone",
            ).inc(len(stale))

    def _start_sweeper(self) -> None:
        if self._sweep_interval <= 0 or self._sweeper is not None:
            return
        self._sweep_stop.clear()

        def _loop():
            while not self._sweep_stop.wait(self._sweep_interval):
                with self._lock:
                    self._sweep_locked()
                    self._gc_tombstones_locked()
                    self._cv.notify_all()

        self._sweeper = threading.Thread(
            target=_loop, name="hvd-kv-sweep", daemon=True)
        self._sweeper.start()

    def _stop_sweeper(self) -> None:
        if self._sweeper is None:
            return
        self._sweep_stop.set()
        self._sweeper.join(timeout=5)
        self._sweeper = None

    # ------------------------------------------------------------ lifecycle

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def close(self):
        """Release the bound socket whether or not :meth:`start` ever ran
        (``stop`` would hang waiting on a serve loop that never started).
        Owners that only use the store in-process call this."""
        self._stop_sweeper()
        if self._thread is not None:
            self.stop()
        else:
            self._httpd.server_close()
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        self._release_wal_lock()

    def restart(self, replay: bool = True) -> int:
        """Tear the server down and bring it back up on the SAME port — the
        KV process crash+restart, in place. With a WAL and ``replay=True``
        the store is rebuilt from the log (membership and committed weight
        generations survive); ``replay=False`` models a restart that lost
        its disk: the store comes back empty and the WAL is truncated to
        match. Waiters blocked in :meth:`wait_for` keep their lock/condvar
        (the maps are cleared and repopulated, never replaced) and observe
        the post-restart state on their next wakeup. Returns the port."""
        was_serving = self._thread is not None
        port = self.port
        if was_serving:
            self.stop()
        else:
            self._httpd.server_close()
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        with self._lock:
            self._store.clear()
            self._ttl.clear()
            self._dead.clear()
            if self._wal_path is not None and replay:
                self._replay_wal()
            elif self._wal_path is not None and os.path.exists(self._wal_path):
                os.unlink(self._wal_path)
            self._open_wal()
            self._cv.notify_all()
        self._httpd = http.server.ThreadingHTTPServer(
            ("0.0.0.0", port), _Handler)
        self._httpd._secret = self._secret  # type: ignore[attr-defined]
        self._httpd._kv = self  # type: ignore[attr-defined]
        if was_serving:
            self.start()
        if _metrics.enabled():
            _metrics.counter(
                "rendezvous_restarts",
                help="KV server restarts (crash simulation or operational)",
            ).inc()
        return self.port

    # ------------------------------------------------------------ store ops

    def server_clock(self) -> float:
        """This server's ``time.monotonic()`` — the fleet's reference
        timebase (in-process spelling of the ``GET /-/clock`` route)."""
        return time.monotonic()

    def put(self, key: str, value: bytes, ttl: Optional[float] = None):
        with self._lock:
            k = _norm(key)
            self._store[k] = value
            if ttl is not None:
                self._ttl[k] = (time.monotonic() + ttl, ttl)
            else:
                self._ttl.pop(k, None)
            # a refreshed key is alive again: clear any tombstone
            self._dead.pop(k, None)
            data = _wal_record(
                "put", k, value, ttl=ttl, fe=self._fencing_epoch)
            self._wal_append_locked(data)
            self._ship_locked(data)
            self._cv.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self._sweep_locked()
            return self._store.get(_norm(key))

    def _get_with_liveness(self, key: str):
        """(value, tombstoned) in one locked read — the HTTP GET path."""
        with self._lock:
            self._sweep_locked()
            k = _norm(key)
            return self._store.get(k), k in self._dead

    def delete(self, key: str, tombstone: bool = False) -> bool:
        """Remove `key`; with ``tombstone=True`` readers see it as dead
        (410 / :class:`DeadRankError`) rather than never-written — the
        explicit-kill analog of a TTL expiry (chaos ``rank_fail`` uses it
        so failure detection needs no real-time sleep)."""
        with self._lock:
            k = _norm(key)
            existed = self._store.pop(k, None) is not None
            self._ttl.pop(k, None)
            if tombstone:
                self._dead[k] = time.monotonic()
            if existed or tombstone:
                data = _wal_record(
                    "del", k, tombstone=tombstone, fe=self._fencing_epoch)
                self._wal_append_locked(data)
                self._ship_locked(data)
            if tombstone:
                self._cv.notify_all()
            return existed

    def prune(self, prefix: str) -> int:
        """Drop every key, TTL record, and tombstone under `prefix`;
        returns how many entries were removed. The elastic coordinator
        uses this to retire prior generations' ack-barrier keys — without
        it the store grows monotonically across membership changes."""
        p = _norm(prefix)
        n = 0
        with self._lock:
            for m in (self._store, self._ttl, self._dead):
                for k in [k for k in m if k.startswith(p)]:
                    del m[k]
                    n += 1
            if n:
                data = _wal_record("prune", p, fe=self._fencing_epoch)
                self._wal_append_locked(data)
                self._ship_locked(data)
        return n

    def dead_keys(self) -> list:
        with self._lock:
            self._sweep_locked()
            return sorted(self._dead)

    def live_keys(self, prefix: str = "/") -> list:
        """Unexpired keys under `prefix` (the heartbeat-liveness query)."""
        with self._lock:
            self._sweep_locked()
            return sorted(
                k for k in self._store if k.startswith(_norm(prefix))
            )

    def wait_for(self, keys, timeout: Optional[float] = None,
                 hb_scope: Optional[str] = None) -> dict:
        """Block until every key in `keys` exists; return {key: value}.

        A missing key whose own tombstone exists — or, with `hb_scope`,
        whose owner rank's heartbeat key ``<hb_scope>/<rank>`` is
        tombstoned — raises :class:`DeadRankError` with the rank id
        immediately: the writer died, no amount of deadline will produce
        the key. TTL expiry is re-swept on every wakeup (bounded poll), so
        a rank dying *mid-wait* also fails fast instead of burning the
        whole deadline."""
        keys = [_norm(k) for k in keys]
        hb_prefix = _norm(hb_scope) if hb_scope else None
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self._lock:
            while True:
                self._sweep_locked()
                missing = [k for k in keys if k not in self._store]
                if not missing:
                    return {k: self._store[k] for k in keys}
                for k in missing:
                    owner = _key_owner(k)
                    if k in self._dead:
                        raise DeadRankError(
                            owner if owner is not None else -1, k)
                    if (
                        hb_prefix is not None
                        and owner is not None
                        and f"{hb_prefix}/{owner}" in self._dead
                    ):
                        raise DeadRankError(owner, k)
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"timed out waiting for keys: {missing}")
                # TTL expiry happens without a notify, so the sleep is
                # bounded by the SOONEST expiry; with no TTL'd keys at
                # all the wait is purely notify-driven (no busy-poll)
                poll = (
                    max(
                        min(t for t, _ in self._ttl.values())
                        - time.monotonic(),
                        0.01,
                    )
                    if self._ttl else None
                )
                if remaining is None:
                    wake = poll
                elif poll is None:
                    wake = remaining
                else:
                    wake = min(poll, remaining)
                self._cv.wait(wake)


def _wal_record(op: str, key: str, value: Optional[bytes] = None, *,
                ttl: Optional[float] = None,
                tombstone: bool = False, fe: int = 0) -> bytes:
    rec = {"op": op, "k": key}
    if op == "put":
        rec["v"] = base64.b64encode(value or b"").decode("ascii")
        if ttl is not None:
            rec["ttl"] = ttl
    elif op == "del" and tombstone:
        rec["ts"] = True
    if fe:
        # fencing epoch; omitted at epoch 0 so pre-HA logs stay
        # byte-identical and old readers keep parsing new logs
        rec["fe"] = fe
    return json.dumps(rec).encode() + b"\n"


def _norm(key: str) -> str:
    return key if key.startswith("/") else "/" + key


def parse_endpoints(spec: str) -> list:
    """``host:port,host:port`` → ``[(host, port), ...]``, primary first —
    the ``HVD_RUN_KV_ADDRS`` wire format."""
    eps = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port_s = part.rpartition(":")
        if not host:
            raise ValueError(f"endpoint {part!r} is not host:port")
        eps.append((host, int(port_s)))
    return eps


def format_endpoints(eps) -> str:
    return ",".join(f"{h}:{p}" for h, p in eps)


class KVStoreClient:
    """Client for :class:`KVStoreServer` (reference ``http_client.py``).

    Every request retries transient connection errors with the shared
    backoff policy (``resilience.retry``; env knobs
    ``HOROVOD_RETRY_KV_*``): during bootstrap the ranks race the launcher's
    server startup, and a first-packet ``ConnectionRefusedError`` used to
    fail the whole job. Chaos (``HOROVOD_CHAOS=kv_drop=N``) injects exactly
    that failure on demand so the recovery stays tested.

    **Failover**: with `endpoints` (or ``HVD_RUN_KV_ADDRS``) the client
    holds the whole control plane's address list — primary first, then
    the standbys. A dead endpoint rotates to the next one *inside* the
    existing retry scope: per-request backoff schedules and ``wait_for``
    total deadlines are never reset by a reconnect. The client tracks the
    highest **fencing epoch** any response has echoed and sends it with
    every request, so a deposed primary fences the write (409) instead of
    silently applying it; a 409 on a multi-endpoint client rotates and
    retries (the promoted primary is elsewhere), on a single-endpoint
    client it raises :class:`FencedError`. A standby's 307 write redirect
    is followed to the ``X-Hvd-Primary`` hint."""

    def __init__(self, addr: Optional[str] = None,
                 port: Optional[int] = None,
                 secret: Optional[str] = None,
                 retry_policy: Optional[_retry.RetryPolicy] = None,
                 endpoints: Optional[list] = None):
        if endpoints:
            self._endpoints = [(h, int(p)) for h, p in endpoints]
        elif addr is not None and port is not None:
            self._endpoints = [(addr, int(port))]
        else:
            raise ValueError(
                "KVStoreClient needs addr+port or a non-empty endpoints "
                "list")
        self._active = 0
        self._epoch_seen = 0
        self._failovers = 0
        self._ep_lock = threading.Lock()
        self._secret = secret or os.environ.get(SECRET_ENV, "")
        self._retry = retry_policy or _retry.policy_from_env(
            "kv", max_attempts=6, base_delay=0.05, max_delay=1.0,
            deadline=30.0,
        )
        #: socket timeout per HTTP request; callers operating under a hard
        #: budget (the preemption-drain publish flush) clamp this down so
        #: ONE blocked request cannot exceed their whole window
        self.request_timeout: float = 30.0

    # -------------------------------------------------- endpoint tracking

    @property
    def endpoints(self) -> list:
        return list(self._endpoints)

    @property
    def _addr(self) -> str:
        return self._endpoints[self._active][0]

    @property
    def _port(self) -> int:
        return self._endpoints[self._active][1]

    @property
    def fencing_epoch_seen(self) -> int:
        """Highest fencing epoch any response has echoed to this client."""
        return self._epoch_seen

    @property
    def failovers(self) -> int:
        """Endpoint rotations this client has performed."""
        return self._failovers

    def note_epoch(self, epoch: int) -> None:
        """Pin the newest fencing epoch this client must trust (learned
        out of band, e.g. from a promoted standby's status). Mutations
        echo it, so a stale primary fences instead of applying."""
        with self._ep_lock:
            if int(epoch) > self._epoch_seen:
                self._epoch_seen = int(epoch)

    def _rotate(self) -> None:
        with self._ep_lock:
            if len(self._endpoints) > 1:
                self._active = (self._active + 1) % len(self._endpoints)
                self._failovers += 1

    def _point_at(self, hint: str) -> None:
        """Follow a 307 redirect's ``host:port`` primary hint."""
        try:
            host, _, port_s = hint.rpartition(":")
            ep = (host, int(port_s))
        except (TypeError, ValueError):
            self._rotate()
            return
        with self._ep_lock:
            if ep not in self._endpoints:
                self._endpoints.append(ep)
            if self._endpoints[self._active] != ep:
                self._active = self._endpoints.index(ep)
                self._failovers += 1

    def _on_retry(self, exc: BaseException, attempts: int) -> None:
        """Between retry attempts, walk to the next endpoint — unless the
        failing response already moved us (redirect / stale-epoch)."""
        if len(self._endpoints) > 1 and not getattr(exc, "rotated", False):
            self._rotate()

    def _observe_response(self, resp, method: str, key: str) -> int:
        """Epoch/role bookkeeping for one response; raises to trigger a
        rotation (TransientError with ``rotated=True``) or to fence
        (:class:`FencedError`). Returns the status for normal handling."""
        status = resp.status
        raw = resp.getheader(_EPOCH_HEADER)
        try:
            epoch = int(raw) if raw is not None else None
        except ValueError:
            epoch = None
        if epoch is not None:
            with self._ep_lock:
                if epoch > self._epoch_seen:
                    self._epoch_seen = epoch
                    epoch_stale = False
                else:
                    epoch_stale = epoch < self._epoch_seen
            if epoch_stale and len(self._endpoints) > 1 and status < 300:
                # a pre-failover regime answered: its view predates the
                # newest epoch we have seen — walk away rather than trust
                # a stale primary's reads
                self._rotate()
                err = _retry.TransientError(
                    f"KV endpoint {self._addr}:{self._port} echoes stale "
                    f"fencing epoch {epoch} < {self._epoch_seen}")
                err.rotated = True
                raise err
        if status == 307:
            hint = resp.getheader(_PRIMARY_HEADER)
            if hint:
                self._point_at(hint)
            else:
                self._rotate()
            err = _retry.TransientError(
                f"KV {method} {key}: standby redirected the write to "
                f"the primary ({hint or 'unknown'})")
            err.rotated = True
            raise err
        if status == 409:
            if len(self._endpoints) > 1:
                self._rotate()
                err = _retry.TransientError(
                    f"KV {method} {key}: endpoint is fenced/deposed "
                    f"(epoch seen {self._epoch_seen}); rotating")
                err.rotated = True
                raise err
            raise FencedError(
                f"KV {method} {key} rejected with HTTP 409: the server "
                f"is deposed (a fencing epoch newer than its own "
                f"exists; client has seen {self._epoch_seen})",
                epoch=self._epoch_seen,
            )
        return status

    # ------------------------------------------------------------ requests

    def _conn(self):
        return http.client.HTTPConnection(
            self._addr, self._port, timeout=self.request_timeout)

    def _headers(self, body: bytes = b"", ttl: Optional[float] = None,
                 tombstone: bool = False):
        h = {}
        if self._secret:
            h[_HMAC_HEADER] = _digest(self._secret, body)
        if ttl is not None:
            h[_TTL_HEADER] = str(ttl)
        if tombstone:
            h[_TOMBSTONE_HEADER] = "1"
        if self._epoch_seen > 0:
            # epoch echo: a deposed primary receiving this fences itself
            h[_EPOCH_HEADER] = str(self._epoch_seen)
        return h

    def _request(self, method: str, key: str, body: Optional[bytes] = None,
                 ttl: Optional[float] = None, tombstone: bool = False):
        """One HTTP round trip → (status, body). Chaos drop-injection sits
        in front of the socket so retries see a refused connection exactly
        like the real startup race; ``kv_partition`` blackholes the
        first-listed endpoint (the original primary) for its window."""
        if _chaos.enabled():
            _chaos.inject_failure(
                "kv_drop",
                lambda m: ConnectionRefusedError(m),
            )
            if self._active == 0 and _chaos.kv_partition_active():
                raise ConnectionRefusedError(
                    "chaos kv_partition: primary endpoint unreachable")
        c = self._conn()
        try:
            c.request(
                method, _norm(key), body=body,
                headers=self._headers(body or b"", ttl, tombstone),
            )
            r = c.getresponse()
            data = r.read()
            status = self._observe_response(r, method, key)
            return status, data
        finally:
            c.close()

    def put(self, key: str, value: bytes, ttl: Optional[float] = None):
        status, _ = self._retry.call(
            self._request, "PUT", key, value, ttl=ttl,
            retriable=TRANSIENT_KV_ERRORS, on_retry=self._on_retry,
        )
        if status != 200:
            raise RuntimeError(f"KV put {key} failed: HTTP {status}")

    def heartbeat(self, rank: int, scope: str = "hb",
                  ttl: Optional[float] = None):
        """Refresh this rank's liveness key (``/<scope>/<rank>``) with the
        heartbeat TTL; stop calling it and the server tombstones the rank."""
        self.put(
            f"{scope}/{rank}", b"1",
            ttl=ttl if ttl is not None else default_heartbeat_ttl(),
        )

    def delete(self, key: str, tombstone: bool = False) -> bool:
        """Remove `key` on the server; with ``tombstone=True`` readers see
        it as dead (410) rather than never-written — same contract as the
        server-side :meth:`KVStoreServer.delete`. Returns whether the key
        existed."""
        status, _ = self._retry.call(
            self._request, "DELETE", key, tombstone=tombstone,
            retriable=TRANSIENT_KV_ERRORS, on_retry=self._on_retry,
        )
        if status not in (200, 404):
            raise RuntimeError(f"KV delete {key} failed: HTTP {status}")
        return status == 200

    def server_clock(self) -> float:
        """One ``GET /-/clock`` round trip → the server's monotonic
        seconds. Deliberately NO retry wrapper: a retried probe would fold
        backoff sleeps into the request/response window and blow up the
        midpoint estimate's error bound — the clock layer takes several
        probes and keeps the tightest anyway."""
        status, body = self._request("GET", CLOCK_PATH)
        if status != 200:
            raise RuntimeError(f"KV clock probe failed: HTTP {status}")
        return float(body)

    def get(self, key: str) -> Optional[bytes]:
        status, body = self._retry.call(
            self._request, "GET", key, retriable=TRANSIENT_KV_ERRORS,
            on_retry=self._on_retry,
        )
        if status == 404:
            return None
        if status == 410:
            # tombstoned: the key's writer died (TTL expiry) — classify,
            # same contract as wait_for, instead of an opaque RuntimeError
            try:
                rank = int(body)
            except (TypeError, ValueError):
                rank = -1
            raise DeadRankError(rank, key)
        if status != 200:
            raise RuntimeError(f"KV get {key} failed: HTTP {status}")
        return body

    def wait_for(self, key: str, timeout: float = 60.0,
                 interval: float = 0.1) -> bytes:
        """Block until `key` exists; total deadline = `timeout` seconds.

        The poll interval backs off geometrically from `interval` (capped
        at 2 s) instead of hammering the server at a fixed rate, the final
        sleep is clipped to the remaining budget, and transient connection
        errors *inside* the poll count against the same total deadline
        rather than each spinning up their own retry schedule. An endpoint
        failover mid-wait rotates to the next server but keeps BOTH the
        original deadline and the current geometric poll state — reconnect
        time is charged against the caller's budget, never granted on
        top of it."""
        deadline = time.monotonic() + timeout
        poll = interval
        last_err: Optional[BaseException] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                status, body = self._request("GET", key)
                if status == 200:
                    return body
                if status == 410:
                    # the key's writer died (TTL expiry/tombstone): fail
                    # fast with the rank id instead of burning the deadline
                    try:
                        rank = int(body)
                    except (TypeError, ValueError):
                        rank = -1
                    raise DeadRankError(rank, key)
                if status != 404:
                    raise RuntimeError(
                        f"KV wait_for {key} failed: HTTP {status}"
                    )
            except TRANSIENT_KV_ERRORS as e:
                last_err = e  # server down/failing over; deadline governs
                if not getattr(e, "rotated", False):
                    self._rotate()
            time.sleep(min(poll, max(0.0, deadline - time.monotonic())))
            poll = min(poll * 1.5, 2.0)
        raise TimeoutError(
            f"timed out after {timeout}s waiting for KV key {key} "
            f"(endpoints {format_endpoints(self._endpoints)})"
            + (f" (last transient error: {last_err!r})" if last_err else "")
        )


class InProcessKVStore:
    """Minimal thread-safe ``put``/``get`` dict — the in-process stand-in
    the observability/analysis planes (schedule sanitizer, flight
    recorder) fall back to when no rendezvous KV is wired up, so
    single-controller runs still get their full publish/cross-check
    paths. TTLs are accepted and ignored: process lifetime bounds the
    data."""

    def __init__(self):
        self._lock = threading.Lock()
        self._d: dict = {}

    def put(self, key: str, value: bytes, ttl: Optional[float] = None):
        del ttl
        with self._lock:
            self._d[key] = value

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._d.get(key)

    def delete(self, key: str, tombstone: bool = False) -> bool:
        """Drop ``key`` (a tombstone reads as missing here)."""
        del tombstone
        with self._lock:
            return self._d.pop(key, None) is not None


def kv_client_from_env() -> Optional["KVStoreClient"]:
    """:class:`KVStoreClient` built from the launcher env — the shared
    wiring the fleet metrics publisher, the schedule sanitizer, and the
    flight recorder all ride, so each launched worker's records land on
    the real fleet store without explicit configuration. Prefers the
    multi-endpoint ``HVD_RUN_KV_ADDRS`` list (primary + standbys, with
    automatic failover) over the single-endpoint
    ``HVD_RUN_KV_ADDR``/``HVD_RUN_KV_PORT`` pair. None when the env is
    absent or bring-up fails (callers fall back to
    :class:`InProcessKVStore`)."""
    addrs = os.environ.get(ADDRS_ENV)
    if addrs:
        try:
            eps = parse_endpoints(addrs)
            if eps:
                return KVStoreClient(endpoints=eps)
        except Exception as e:
            logger.debug("KV client bring-up from %s failed: %s",
                         ADDRS_ENV, e)
    addr = os.environ.get("HVD_RUN_KV_ADDR")
    port = os.environ.get("HVD_RUN_KV_PORT")
    if not addr or not port:
        return None
    try:
        return KVStoreClient(addr, int(port))
    except Exception as e:
        logger.debug("KV client bring-up from env failed: %s", e)
        return None
