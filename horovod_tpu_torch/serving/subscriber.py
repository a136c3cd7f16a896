"""Polling weight subscriber — the serving-fleet side of the handoff.

Counterpart of ``horovod_tpu/serving/subscriber.py``.

:class:`WeightSubscriber` follows the commit-last protocol from the reader
end: read ``head``, then the manifests/chunks it points at, CRC-checking
everything. The failure philosophy is **degrade, don't crash**: any problem
applying the chain (a GC'd manifest, a CRC mismatch, a gap after a KV
restart that lost its disk) triggers one resync from the chain's keyframe;
if even that fails the subscriber keeps serving generation ``G−k`` and
reports the lag through the staleness watermark instead of raising. A
trainer that is preempted, resizing, or simply gone makes ``poll()`` return
None forever while ``staleness_seconds()`` grows — the serving process
decides when stale is too stale (``stale()`` /
``HOROVOD_SERVING_STALE_AFTER``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Optional

from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.resilience import chaos as _chaos, retry as _retry
from horovod_tpu_torch.serving import protocol
from horovod_tpu_torch.serving.protocol import ChainError

__all__ = ["WeightSubscriber", "subscribe_weights"]

logger = logging.getLogger("horovod_tpu_torch.serving")

STALE_AFTER_ENV = "HOROVOD_SERVING_STALE_AFTER"


class WeightSubscriber:
    """Incrementally reconstruct published weights from a KV store.

    `store` is the same duck type the publisher takes: a
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` (direct) or
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreClient` (HTTP). All KV reads
    ride the shared retry policy (``HOROVOD_RETRY_SUBSCRIBE_*``).

    - :meth:`poll` — apply everything new; returns the fresh tree when the
      generation advanced, else None. Never raises for trainer-side
      conditions (no publication yet, torn nothing — that cannot happen —
      GC'd history, KV briefly down).
    - :meth:`weights` / :attr:`generation` / :attr:`step` — what is being
      served right now.
    - :meth:`lag` / :meth:`staleness_seconds` / :meth:`stale` — the
      staleness contract: serve G−k, report how far behind.
    """

    def __init__(self, store, *, scope: str = "serving",
                 retry_policy: Optional[_retry.RetryPolicy] = None,
                 stale_after: Optional[float] = None,
                 device=False):
        #: False: host numpy trees. True (this process's device, else
        #: ``cuda:0``) or a device: the inference engine's ingest mode,
        #: payloads decode with ``protocol.decode(..., device=)`` — int8
        #: delta leaves land on the device in wire form and the
        #: dequant-accumulate runs there, so the served tree is
        #: device-resident with no host f32 round-trip (values stay
        #: bit-identical to the host path)
        self._device = None
        if device is not False and device is not None:
            from horovod_tpu_torch.basics import default_device

            self._device = default_device(None if device is True else device)
        self._store = store
        self._scope = scope.strip("/")
        self._retry = retry_policy or _retry.policy_from_env(
            "subscribe", max_attempts=4, base_delay=0.05, max_delay=1.0,
            deadline=30.0,
        )
        self._stale_after = float(
            stale_after
            if stale_after is not None
            else os.environ.get(STALE_AFTER_ENV, "0")
        )
        self._tree: Any = None
        self._generation = 0
        self._step: Optional[int] = None
        self._published_at: Optional[float] = None
        self._head_seen = 0
        self._chain: Optional[str] = None  # publisher token of the applied chain
        self._applies = 0  # commits ever; poll() reports progress from it

    # ----------------------------------------------------------- properties

    @property
    def generation(self) -> int:
        """The generation currently being served (0 = nothing yet)."""
        return self._generation

    @property
    def step(self) -> Optional[int]:
        """The trainer step of the served generation."""
        return self._step

    def weights(self) -> Any:
        """The currently served weight tree (None before the first
        successful poll)."""
        return self._tree

    def lag(self) -> int:
        """Generations between the last observed head and what is served —
        0 when caught up."""
        return max(0, self._head_seen - self._generation)

    def staleness_seconds(self) -> Optional[float]:
        """Wall-clock age of the served generation (publisher timestamp →
        now), or None before the first apply. Grows without bound while
        the trainer is preempted/resizing — that is the signal."""
        if self._published_at is None:
            return None
        return max(0.0, time.time() - self._published_at)

    def stale(self) -> bool:
        """True when the served weights are older than the configured
        watermark (``stale_after`` / ``HOROVOD_SERVING_STALE_AFTER``;
        0 disables). A serving process uses this to degrade gracefully —
        shed traffic, report lag — instead of crashing."""
        if self._stale_after <= 0:
            return False
        age = self.staleness_seconds()
        return age is None or age > self._stale_after

    # ---------------------------------------------------------------- polls

    def poll(self) -> Optional[Any]:
        """Apply every generation published since the last poll.

        Returns the new weight tree when the served generation advanced,
        None otherwise (nothing new, nothing published yet, or recovery
        exhausted — in which case the old tree keeps being served and the
        staleness watermark reports the gap)."""
        _chaos.maybe_delay("subscriber_stall")
        head = self._read_head()
        if head is None:
            self._record_gauges()
            return None
        self._head_seen = head
        if head == self._generation:
            self._record_gauges()
            return None
        # progress = "did a generation COMMIT during this poll", not "did
        # we reach head": applying 2 of 3 pending generations and then
        # failing must still hand the caller the newest applied tree —
        # returning None there would leave the serving process on old
        # weights while the staleness watermark (set by the commit)
        # reports fresh, the exact stale-marked-fresh state the
        # acceptance criteria forbid.
        applies0 = self._applies
        try:
            if head < self._generation:
                # a new publisher re-rooted LOWER than what we serve (the
                # KV lost its disk and the trainer restarted): our chain is
                # dead — resync onto the new one rather than ignore it
                # forever
                logger.warning(
                    "head went backward (%d < %d): new publisher chain; "
                    "resyncing", head, self._generation)
                self._resync(head, reason="chain")
            elif self._tree is None:
                self._resync(head, reason="fresh")
            else:
                try:
                    for g in range(self._generation + 1, head + 1):
                        self._apply_generation(g)
                except ChainError as e:
                    logger.warning(
                        "weight chain broken at generation %d (%s); "
                        "resyncing from keyframe", self._generation + 1, e)
                    self._resync(head, reason="chain")
        except ChainError as e:
            # even the keyframe path failed: keep serving what we have
            logger.warning(
                "weight resync to generation %d failed (%s); still "
                "serving generation %d", head, e, self._generation)
            if _metrics.enabled():
                _metrics.counter(
                    "serving_subscribe_errors",
                    help="polls that could neither advance nor resync",
                ).inc()
        self._record_gauges()
        return self._tree if self._applies > applies0 else None

    def wait_for_generation(self, generation: int, *,
                            timeout: float = 30.0,
                            interval: float = 0.05) -> Any:
        """Poll until at least `generation` is served; returns the tree.
        Raises ``TimeoutError`` past `timeout` — a bootstrap convenience
        for serving processes that need SOME weights before taking
        traffic."""
        deadline = time.monotonic() + timeout
        while True:
            self.poll()
            if self._generation >= generation:
                return self._tree
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no weight generation >= {generation} within "
                    f"{timeout}s (serving {self._generation}, head "
                    f"{self._head_seen})"
                )
            time.sleep(interval)

    # ------------------------------------------------------------- internals

    def _read_head(self) -> Optional[int]:
        blob = self._get(protocol.head_key(self._scope))
        if blob is None:
            return None
        try:
            return int(blob)
        except ValueError:
            return None

    def _get(self, key: str) -> Optional[bytes]:
        """Retry-wrapped KV read; a tombstoned key (410/DeadRankError over
        HTTP) reads as missing — for this protocol both mean "resync"."""
        from horovod_tpu_torch.run.rendezvous import (
            DeadRankError,
            TRANSIENT_KV_ERRORS,
        )

        try:
            return self._retry.call(
                self._store.get, key, retriable=TRANSIENT_KV_ERRORS)
        except DeadRankError:
            return None
        except _retry.RetryError:
            return None

    def _fetch(self, generation: int) -> tuple:
        """(manifest, payload) for one generation, fully CRC-verified.
        Raises :class:`ChainError` on anything short of that."""
        blob = self._get(protocol.manifest_key(self._scope, generation))
        if blob is None:
            raise ChainError(f"manifest {generation} missing or GC'd")
        m = protocol.parse_manifest(blob)
        parts = []
        for i in range(m["chunks"]):
            c = self._get(protocol.chunk_key(self._scope, generation, i))
            if c is None:
                raise ChainError(f"chunk {generation}/{i} missing")
            if protocol.crc(c) != m["chunk_crc"][i]:
                raise ChainError(f"chunk {generation}/{i} CRC mismatch")
            parts.append(c)
        payload = b"".join(parts)
        if len(payload) != m["payload_bytes"] \
                or protocol.crc(payload) != m["payload_crc"]:
            raise ChainError(f"payload {generation} CRC mismatch")
        return m, payload

    def _apply_generation(self, generation: int) -> None:
        m, payload = self._fetch(generation)
        if m["kind"] == "delta":
            if m["base"] != self._generation or self._tree is None:
                raise ChainError(
                    f"delta {generation} bases on {m['base']}, serving "
                    f"{self._generation}"
                )
            if m.get("chain") != self._chain:
                # a restarted publisher re-used this generation NUMBER but
                # its base is a different tree — applying would silently
                # corrupt the served weights
                raise ChainError(
                    f"delta {generation} belongs to publisher chain "
                    f"{m.get('chain')!r}, serving {self._chain!r}"
                )
            tree = protocol.decode(payload, self._tree, device=self._device)
        else:
            tree = protocol.decode(payload, device=self._device)
        self._commit(m, payload, tree)

    def _resync(self, head: int, *, reason: str) -> bool:
        """Rebuild from the chain's keyframe: head's manifest names it;
        replay keyframe..head fresh. Raises :class:`ChainError` when the
        keyframe chain itself is unreadable."""
        if _metrics.enabled():
            _metrics.counter(
                "serving_subscribe_resyncs",
                help="keyframe resyncs by trigger",
                reason=reason,
            ).inc()
        m_head, payload_head = self._fetch(head)
        kf = int(m_head["keyframe"])
        if kf == head:
            if m_head["kind"] != "key":
                raise ChainError(f"generation {head} claims to be its own "
                                 "keyframe but is a delta")
            self._commit(m_head, payload_head,
                         protocol.decode(payload_head, device=self._device))
            return True
        tree = None
        committed = None
        chain = None
        for g in range(kf, head + 1):
            m, payload = (m_head, payload_head) if g == head \
                else self._fetch(g)
            if g == kf:
                if m["kind"] != "key":
                    raise ChainError(f"keyframe {kf} is not a keyframe")
                chain = m.get("chain")
                tree = protocol.decode(payload, device=self._device)
            else:
                if m["kind"] != "delta" or m["base"] != g - 1 \
                        or m.get("chain") != chain:
                    raise ChainError(
                        f"generation {g} does not chain from {g - 1}")
                tree = protocol.decode(payload, tree, device=self._device)
            committed = (m, payload, tree)
        m, payload, tree = committed
        self._commit(m, payload, tree)
        return True

    def _commit(self, manifest: dict, payload: bytes, tree: Any) -> None:
        self._tree = tree
        self._generation = int(manifest["generation"])
        self._step = manifest.get("step")
        self._published_at = manifest.get("time")
        self._chain = manifest.get("chain")
        self._applies += 1
        # flight ring: which generation this process was serving is the
        # first question a serving post-mortem asks
        _flight.record(
            "serve", what="subscribe", generation=self._generation,
            payload=manifest.get("kind"),
        )
        if _metrics.enabled():
            _metrics.counter(
                "serving_subscribe_bytes",
                help="payload bytes fetched and applied",
            ).inc(len(payload))

    def _record_gauges(self) -> None:
        if not _metrics.enabled():
            return
        _metrics.gauge(
            "serving_subscribe_generation",
            help="weight generation currently served",
        ).set(self._generation)
        _metrics.gauge(
            "serving_subscribe_lag_generations",
            help="generations between the observed head and what is served",
        ).set(self.lag())
        age = self.staleness_seconds()
        if age is not None:
            _metrics.gauge(
                "serving_subscribe_staleness_seconds",
                help="wall-clock age of the served generation",
            ).set(age)


def subscribe_weights(addr: Optional[str] = None,
                      port: Optional[int] = None, *,
                      store=None, scope: str = "serving",
                      secret: Optional[str] = None,
                      **kwargs) -> WeightSubscriber:
    """Open a weight subscription — the ``hvd.subscribe_weights()`` entry
    point a serving process polls::

        sub = hvd.subscribe_weights("10.0.0.1", 7799)
        while True:
            fresh = sub.poll()
            if fresh is not None:
                model.load(fresh)
            if sub.stale():
                health.degrade(f"weights {sub.staleness_seconds():.0f}s old")
            time.sleep(poll_interval)

    Pass ``addr``/``port`` (and optionally `secret`, default
    ``HVD_RUN_SECRET``) for the launcher's KV server over HTTP, or
    ``store=`` for an in-process :class:`KVStoreServer`; with neither,
    the launcher's KV from the environment
    (:func:`~horovod_tpu_torch.run.rendezvous.kv_client_from_env`).
    Remaining kwargs reach :class:`WeightSubscriber`."""
    if store is None:
        from horovod_tpu_torch.run.rendezvous import (
            KVStoreClient, kv_client_from_env,
        )

        if addr is None and port is None:
            store = kv_client_from_env()
        elif addr is not None and port is not None:
            store = KVStoreClient(addr, int(port), secret=secret)
        if store is None:
            raise ValueError(
                "subscribe_weights needs addr+port (HTTP), store= "
                "(in-process) or the launcher's KV in the environment")
    elif addr is not None or port is not None:
        raise ValueError("pass either addr/port or store=, not both")
    return WeightSubscriber(store, scope=scope, **kwargs)
