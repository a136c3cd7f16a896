"""The rendezvous key-value store's in-memory core: heartbeat-scoped keys.

Counterpart of ``horovod_tpu/run/rendezvous.py``, as far as the port has
it: :class:`KVStoreServer`'s store operations, the membership plane of the
elastic driver (:class:`~horovod_tpu_torch.resilience.elastic.
ElasticCoordinator` owns a private one, the JAX package's default).
A key put with a TTL (``put(key, value, ttl=...)``) expires once its
writer stops refreshing it; expiry leaves a *tombstone*, so readers can
tell "never written" from "written by a rank that since died".
:meth:`KVStoreServer.wait_for` consults the tombstones and the heartbeat
namespace to raise :class:`DeadRankError` carrying the dead rank's id
*immediately* instead of burning its whole deadline on a key whose writer
can never write it. ``sweep_interval`` arms a background sweep, so TTL
expiry and tombstone GC happen on a timer, not only on access.

Values are opaque bytes. The HTTP serving, the write-ahead log, the
standbys' replication and fencing, and the client wait for the launcher
port (ROADMAP Queue A item 12). stdlib-only.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Optional

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "DeadRankError",
    "KVStoreServer",
    "default_heartbeat_ttl",
]

logger = logging.getLogger("horovod_tpu_torch.rendezvous")

#: default TTL for heartbeat-scoped keys (seconds); the elastic layer's
#: failure-detection horizon. Tests use ~0.2s.
HEARTBEAT_TTL_ENV = "HOROVOD_ELASTIC_HEARTBEAT_TTL"

#: background sweep cadence (seconds; 0 = lazy sweep on access only)
SWEEP_INTERVAL_ENV = "HOROVOD_KV_SWEEP_INTERVAL"

#: tombstone retention (seconds) before the background sweep drops them;
#: must comfortably exceed the slowest reader's poll interval — a dropped
#: tombstone makes a dead key look never-written
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


_OWNER_RE = re.compile(r"(?:/|_)(\d+)$")


def _key_owner(key: str) -> Optional[int]:
    m = _OWNER_RE.search(key)
    return int(m.group(1)) if m else None


def _norm(key: str) -> str:
    return key if key.startswith("/") else "/" + key


class KVStoreServer:
    """In-memory KV store with a blocking wait for keys.

    Beyond plain KV, keys can carry a **TTL** (heartbeat-scoped keys): an
    expired key is removed from the store and *tombstoned*, so
    :meth:`wait_for` can attribute "this key's writer died" instead of
    timing out. Expiry is swept lazily under the store lock on every
    access; `sweep_interval` (env ``HOROVOD_KV_SWEEP_INTERVAL``, 0 = off)
    additionally arms a background timer that sweeps expiry AND drops
    tombstones older than `tombstone_ttl` (env
    ``HOROVOD_KV_TOMBSTONE_TTL``), so memory stays bounded on long runs
    whose keys nobody reads. :meth:`close` stops that timer."""

    def __init__(self, sweep_interval: Optional[float] = None,
                 tombstone_ttl: Optional[float] = None):
        self._store: dict = {}
        self._ttl: dict = {}  # key -> (expiry_monotonic, lease_seconds)
        self._dead: dict = {}  # tombstones: key -> time of death
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
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
        self._start_sweeper()

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
        must never shorten the window readers rely on."""
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

    def close(self):
        """Stop the background sweep (if armed)."""
        self._stop_sweeper()

    # ------------------------------------------------------------ store ops

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
            self._cv.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self._sweep_locked()
            return self._store.get(_norm(key))

    def delete(self, key: str, tombstone: bool = False) -> bool:
        """Remove `key`; with ``tombstone=True`` readers see it as dead
        (:class:`DeadRankError`) rather than never-written — the
        explicit-kill analog of a TTL expiry (chaos ``rank_fail`` uses it
        so failure detection needs no real-time sleep)."""
        with self._lock:
            k = _norm(key)
            existed = self._store.pop(k, None) is not None
            self._ttl.pop(k, None)
            if tombstone:
                self._dead[k] = time.monotonic()
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
