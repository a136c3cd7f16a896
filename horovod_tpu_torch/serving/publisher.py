"""Generation-numbered weight publication onto the rendezvous KV.

Counterpart of ``horovod_tpu/serving/publisher.py``.
:class:`WeightPublisher` is the trainer side of the training → serving
handoff: every N steps rank 0 consolidates the weights (the
``training.host_snapshot`` discipline — an owned host copy that survives a
mesh teardown), encodes a keyframe or an int8 delta
(:mod:`horovod_tpu_torch.serving.protocol`), and publishes it commit-last: chunks
first, manifest next, the ``head`` pointer only after everything landed. A
publisher crash at ANY point mid-publish leaves the previous head intact —
subscribers can never observe a torn generation.

Failure handling is layered the same way the rest of the stack is:

- transient KV failures (and the ``publish_fail`` chaos charge, which fires
  partway through the chunk upload) retry under the shared
  :class:`~horovod_tpu_torch.resilience.retry.RetryPolicy`
  (``HOROVOD_RETRY_PUBLISH_*``), overwriting the partial upload;
- an elastic resize mid-publish trips the **generation fence**
  (``fence_fn``): the in-flight generation is deleted and
  :class:`PublishAborted` raised — the elastic driver republishes from the
  post-resize consolidated state;
- superseded generations are GC'd back to the newest keyframe (manifests
  tombstoned so a lagging subscriber sees "GC'd", not "never existed"),
  bounding KV memory.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Any, Callable, Optional

import numpy as np

from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.resilience import chaos as _chaos, retry as _retry
from horovod_tpu_torch.serving import protocol

__all__ = [
    "PublishError",
    "PublishAborted",
    "PublishRejected",
    "WeightPublisher",
    "active_publishers",
    "flush_on_preempt",
]

logger = logging.getLogger("horovod_tpu_torch.serving")

KEYFRAME_EVERY_ENV = "HOROVOD_PUBLISH_KEYFRAME_EVERY"
CHUNK_BYTES_ENV = "HOROVOD_PUBLISH_CHUNK_BYTES"
PUBLISH_EVERY_ENV = "HOROVOD_PUBLISH_EVERY"


class PublishError(RuntimeError):
    """A publication failed after exhausting its retry budget; the head
    still points at the last committed generation."""


class PublishAborted(PublishError):
    """The elastic generation fence changed mid-publish: the in-flight
    generation was deleted, nothing was committed. Republish from the
    post-resize consolidated state."""


class PublishRejected(PublishError):
    """The numerics gate refused the generation BEFORE any byte went to
    the KV: the consolidated tree is non-finite, the trainer's most
    recent guarded steps were BAD, or a corrupting-rank quarantine is
    pending. The head still points at the last healthy commit —
    subscribers keep serving it under the staleness contract
    (``serving_publish_rejected{reason=}`` counts the refusal).
    Disable with ``HOROVOD_PUBLISH_NUMERICS_GATE=0``."""

    def __init__(self, reason: str, generation: int):
        super().__init__(
            f"weight generation {generation} rejected by the numerics "
            f"gate (reason={reason})"
        )
        self.reason = reason
        self.generation = generation


#: publishers that registered for the preemption-drain final flush
_ACTIVE: "weakref.WeakSet[WeightPublisher]" = weakref.WeakSet()
_ACTIVE_LOCK = threading.Lock()


def active_publishers() -> list:
    with _ACTIVE_LOCK:
        return list(_ACTIVE)


def flush_on_preempt(state: Any, step: int, budget_s: float) -> int:
    """Best-effort final publication from every registered publisher —
    the SIGTERM-drain hook (:mod:`horovod_tpu_torch.resilience.loop`).
    `budget_s` bounds the WHOLE flush pass, not each publisher — a hanging
    KV must not multiply the drain overrun by the publisher count and eat
    the emergency checkpoint's grace window. Never raises; returns how
    many publishers flushed."""
    deadline = time.monotonic() + budget_s
    n = 0
    for pub in active_publishers():
        remaining = deadline - time.monotonic()
        if remaining <= 0.05:
            logger.warning(
                "preemption flush budget exhausted; skipping remaining "
                "publisher(s)")
            break
        if pub.flush(state, step, budget_s=remaining):
            n += 1
    return n


def _tree_finite(tree: Any) -> bool:
    """True when every float leaf of `tree` is finite — the delta-base
    health check (host numpy; the reconstruction is already host-side)."""
    from horovod_tpu_torch import pytree

    for leaf in pytree.flatten(tree)[0]:
        if not hasattr(leaf, "dtype"):
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            return False
    return True


def _nested(tree: Any) -> Any:
    """A flat ``{"a/b/c": leaf}`` dict (``model.jax_params()``) as the
    JAX package's nested flax tree; any other tree as it is."""
    if isinstance(tree, dict) and tree and all(
            isinstance(k, str) for k in tree) and any("/" in k for k in tree):
        from horovod_tpu_torch.models.convert import unflatten_tree

        return unflatten_tree(tree)
    return tree


def default_extract(state: Any) -> Any:
    """The weight tree a serving fleet consumes from a training state: the
    ``params`` entry of a loop-state dict, else the state itself."""
    if isinstance(state, dict) and "params" in state:
        return state["params"]
    return state


class WeightPublisher:
    """Publish consolidated weights to a KV store as numbered generations.

    `store` is anything with the rendezvous surface (``put``/``get``/
    ``delete``): a :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer`
    (direct, single-controller) or a
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreClient` (the launcher's KV
    over HTTP).

    - `keyframe_every`: publish a full-precision keyframe every K
      generations (env ``HOROVOD_PUBLISH_KEYFRAME_EVERY``, default 8);
      deltas in between ride the blockwise-int8 wire.
    - `publish_every`: step cadence for :meth:`maybe_publish` (env
      ``HOROVOD_PUBLISH_EVERY``; 0 = only explicit :meth:`publish` calls).
    - `fence_fn`: returns the current elastic generation; a change between
      publish start and commit aborts the in-flight generation
      (:class:`PublishAborted`). :class:`horovod_tpu_torch.resilience.elastic.
      ElasticRun` wires this to its coordinator automatically.
    - `extract`: training state → weight tree (default: ``state["params"]``
      for dicts, else the state).
    - `register`: join the process-wide registry the preemption drain
      flushes (:func:`flush_on_preempt`).
    - `device`: where each delta's quantizable leaves are quantized (the
      ``quantize`` kernel on a CUDA device); by default this process's
      device once ``init`` has run, else ``cuda:0``.

    The published tree is the JAX package's: the ``params`` entry of a
    state as flax-path nested dicts (a state holding the port's flat
    ``a/b/c`` keys, ``model.jax_params()``, is nested on the way), so a
    subscriber of either package reads it.
    """

    def __init__(self, store, *, scope: str = "serving",
                 keyframe_every: Optional[int] = None,
                 chunk_bytes: Optional[int] = None,
                 publish_every: Optional[int] = None,
                 retry_policy: Optional[_retry.RetryPolicy] = None,
                 fence_fn: Optional[Callable[[], int]] = None,
                 extract: Optional[Callable[[Any], Any]] = None,
                 register: bool = True, device=None):
        #: where a delta's int8 quantize runs (the ``quantize`` kernel on
        #: a CUDA device); resolved at the first delta by
        #: :func:`horovod_tpu_torch.basics.default_device`
        self._device = device
        self._store = store
        self._scope = scope.strip("/")
        self._keyframe_every = max(1, int(
            keyframe_every
            if keyframe_every is not None
            else os.environ.get(KEYFRAME_EVERY_ENV, "8")
        ))
        self._chunk_bytes = int(
            chunk_bytes
            if chunk_bytes is not None
            else os.environ.get(
                CHUNK_BYTES_ENV, str(protocol.DEFAULT_CHUNK_BYTES))
        )
        self._publish_every = int(
            publish_every
            if publish_every is not None
            else os.environ.get(PUBLISH_EVERY_ENV, "0")
        )
        self._retry = retry_policy or _retry.policy_from_env(
            "publish", max_attempts=4, base_delay=0.05, max_delay=1.0,
            deadline=30.0,
        )
        self.fence_fn = fence_fn
        self._extract = extract or default_extract
        self._generation = 0
        self._keyframe_gen = 0
        self._gc_floor = 1  # lowest generation still on the KV
        self._chunk_counts: dict = {}  # generation -> chunks written
        self._recon: Any = None  # the subscriber view (decode of own wire)
        self._recon_finite = True  # False → next delta re-roots (keyframe)
        self._last_step = -1
        #: unique per publisher INSTANCE: a restarted trainer's fresh
        #: publisher writes a new chain, so a surviving subscriber can
        #: never mistake the new deltas' bases for the old chain's
        self._chain = os.urandom(8).hex()
        #: the failover drill's kill target for ``kv_kill_primary_at_step``
        #: — the primary KVStoreServer, when ``store`` is a failover
        #: client rather than the server itself
        self.chaos_primary: Optional[Any] = None
        if register:
            with _ACTIVE_LOCK:
                _ACTIVE.add(self)

    def unregister(self) -> None:
        """Leave the preemption-flush registry (a publisher whose serving
        fleet is torn down should not be flushed to on SIGTERM)."""
        with _ACTIVE_LOCK:
            _ACTIVE.discard(self)

    # ----------------------------------------------------------- properties

    @property
    def generation(self) -> int:
        """The last committed generation (0 before the first publish)."""
        return self._generation

    @property
    def keyframe_generation(self) -> int:
        return self._keyframe_gen

    @property
    def scope(self) -> str:
        return self._scope

    def reconstruction(self) -> Any:
        """What a fully caught-up subscriber holds right now (bit-identical
        by construction — the publisher decodes its own wire)."""
        return self._recon

    # ------------------------------------------------------------ publishing

    def maybe_publish(self, state: Any, step: int) -> Optional[int]:
        """Publish when `step` hits the ``publish_every`` cadence.
        Swallows :class:`PublishError` (serving is best-effort from the
        trainer's point of view — the staleness contract covers the gap);
        :class:`PublishAborted` also ends up here when no elastic driver
        handles it. Returns the committed generation or None."""
        if self._publish_every <= 0 or step % self._publish_every != 0 \
                or step == self._last_step:
            return None
        try:
            return self.publish(state, step)
        except PublishError as e:
            logger.warning("weight publication at step %d failed: %s",
                           step, e)
            return None

    def publish(self, state: Any, step: int, *,
                force_keyframe: bool = False) -> int:
        """Publish one generation from `state`; returns its number.

        Consolidation first (``host_snapshot`` of the extracted tree — an
        owned host copy, so a donated next step cannot invalidate the
        payload mid-upload), then encode, then the commit-last upload
        under the retry policy. Raises :class:`PublishAborted` when the
        elastic fence trips, :class:`PublishError` when the KV stays down
        past the retry budget."""
        from horovod_tpu_torch.training import host_snapshot

        t0 = time.monotonic()
        if _chaos.enabled() and _chaos.take_kv_restart(step):
            # the chaos harness's KV crash: restart in place (WAL replay
            # when configured) at this publish boundary. A store that
            # cannot restart (an HTTP client) fails LOUDLY — the chaos
            # contract is "typos raise, not silently inject nothing",
            # and the injection metric has already counted this charge.
            if not hasattr(self._store, "restart"):
                raise RuntimeError(
                    "HOROVOD_CHAOS kv_restart_at_step armed, but this "
                    "publisher's store is not restartable (pass the "
                    "KVStoreServer, not a client, to chaos-test restarts)"
                )
            self._store.restart()
        if _chaos.enabled() and _chaos.take_kv_kill_primary(step):
            # the control-plane failover drill: SIGKILL-model the primary
            # KV server at this publish boundary. The kill target is
            # ``chaos_primary`` (set by the drill when the publisher's
            # store is a failover CLIENT, as in production) or the store
            # itself; either way a target that cannot be killed fails
            # LOUDLY, same contract as kv_restart_at_step above.
            target = self.chaos_primary or self._store
            if not hasattr(target, "kill"):
                raise RuntimeError(
                    "HOROVOD_CHAOS kv_kill_primary_at_step armed, but "
                    "neither publisher.chaos_primary nor the store is a "
                    "killable KVStoreServer (point chaos_primary at the "
                    "primary to chaos-test failover)"
                )
            target.kill()
        fence0 = self.fence_fn() if self.fence_fn is not None else None
        try:
            tree = host_snapshot(_nested(self._extract(state)))
        except BaseException as e:
            if _metrics.enabled():
                _metrics.counter(
                    "serving_publish_failures",
                    help="publications abandoned after the retry budget",
                ).inc()
            raise PublishError(
                f"consolidating state for publication failed: {e!r}"
            ) from e
        if self._generation == 0:
            # first publish of this instance: adopt the KV's head so the
            # generation sequence stays MONOTONIC across trainer restarts
            # (a subscriber ignores head <= its own generation — numbers
            # going backward would strand it forever)
            head = self._kv_head()
            if head is not None and head > 0:
                self._generation = head
                # the dead chain's live range is [its keyframe, head]; our
                # first keyframe supersedes all of it, so the GC floor must
                # start there or the old generations leak on the KV forever
                # (re-copied into every WAL compaction). Unreadable head
                # manifest ⇒ the store lost that chain's data anyway.
                self._gc_floor = self._chain_start(head)
        # the gate sits AFTER head adoption so a restarted trainer's
        # rejection reports generations relative to the REAL head the
        # subscribers are serving, not this instance's zero
        reason = self._numerics_gate_reason(state, tree)
        if reason is not None:
            if _metrics.enabled():
                _metrics.counter(
                    "serving_publish_rejected",
                    help="weight generations refused by the numerics gate "
                         "before any byte reached the KV",
                    reason=reason,
                ).inc()
            logger.warning(
                "weight publication at step %d rejected by the numerics "
                "gate (reason=%s); head stays at generation %d",
                step, reason, self._generation,
            )
            raise PublishRejected(reason, self._generation + 1)
        gen = self._generation + 1
        keyframe = (
            force_keyframe
            or self._recon is None
            or gen - self._keyframe_gen >= self._keyframe_every
        )
        if not keyframe and not self._recon_finite:
            # the delta base is poisoned (a gate-less or gate-disabled
            # publisher shipped a non-finite generation): NaN absorbs any
            # delta, so the chain could never recover — a healthy publish
            # re-roots with a keyframe instead of propagating the poison
            # to every subscriber forever
            logger.warning(
                "delta base (generation %d) is non-finite; re-rooting the "
                "chain with a keyframe", self._generation,
            )
            keyframe = True
        if not keyframe and self._kv_head() != self._generation:
            # the KV does not agree with our chain state — it restarted
            # without its WAL (or someone else wrote the scope). A delta
            # would chain onto manifests that no longer exist; a keyframe
            # re-roots the chain unconditionally.
            logger.warning(
                "KV head does not match generation %d; re-rooting the "
                "chain with a keyframe", self._generation,
            )
            keyframe = True
        base = None if keyframe else self._recon
        try:
            payload, info = protocol.encode(tree, base, device=self._device)
        except BaseException as e:
            if base is not None:
                # a delta that cannot be encoded (the published treedef
                # changed, a dtype stopped subtracting) re-roots with a
                # keyframe instead of failing the same way forever
                logger.warning(
                    "delta encode failed (%r); re-rooting with a keyframe",
                    e)
                keyframe, base = True, None
                try:
                    payload, info = protocol.encode(tree, None)
                except BaseException as e2:
                    raise PublishError(
                        f"encoding generation {gen} failed: {e2!r}"
                    ) from e2
            else:
                raise PublishError(
                    f"encoding generation {gen} failed: {e!r}") from e
        chunks = protocol.split_chunks(payload, self._chunk_bytes)
        kf_gen = gen if keyframe else self._keyframe_gen
        manifest = protocol.build_manifest(
            generation=gen, step=step, kind=info["kind"], keyframe=kf_gen,
            chunks=chunks, payload=payload, wire_bytes=info["wire_bytes"],
            elastic_generation=fence0, published_at=time.time(),
            chain=self._chain,
        )

        def _attempt():
            for i, c in enumerate(chunks):
                self._store.put(
                    protocol.chunk_key(self._scope, gen, i), c)
                if i == 0:
                    # chaos: die partway through the upload — chunk 0 is
                    # on the KV, the manifest never will be. The retry
                    # wrapper republishes over the torn remains.
                    _chaos.inject_failure("publish_fail")
            self._check_fence(fence0, gen, len(chunks), manifest=False)
            self._store.put(
                protocol.manifest_key(self._scope, gen), manifest)
            self._check_fence(fence0, gen, len(chunks), manifest=True)
            self._store.put(
                protocol.head_key(self._scope), str(gen).encode())

        try:
            self._retry.call(
                _attempt,
                retriable=self._transient_errors(),
            )
        except PublishAborted:
            raise
        except BaseException as e:
            self._cleanup(gen, len(chunks), manifest=True)
            if _metrics.enabled():
                _metrics.counter(
                    "serving_publish_failures",
                    help="publications abandoned after the retry budget",
                ).inc()
            raise PublishError(
                f"publishing generation {gen} failed: {e!r}") from e

        # committed: advance the chain and track the subscriber view. A
        # keyframe's records are raw, so its decode IS the snapshot we
        # already hold — skip the O(model) deserialize+copy on that path.
        self._recon = tree if keyframe else protocol.decode(payload, base)
        # keyframe finiteness comes from encode() (which already held the
        # host copies); the delta path's recon is host numpy already, so
        # the sweep is isfinite-only — no device transfer either way
        self._recon_finite = (
            bool(info["finite"]) if "finite" in info
            else _tree_finite(self._recon)
        )
        self._generation = gen
        self._keyframe_gen = kf_gen
        self._chunk_counts[gen] = len(chunks)
        self._last_step = step
        dt = time.monotonic() - t0
        if _metrics.enabled():
            kind = info["kind"]
            _metrics.counter(
                "serving_publish_generations",
                help="weight generations committed to the KV",
                kind=kind,
            ).inc()
            _metrics.counter(
                "serving_publish_bytes",
                help="payload bytes published (chunks, before framing)",
            ).inc(len(payload))
            _metrics.gauge(
                "serving_publish_wire_bytes",
                help="array bytes of the last published payload",
                kind=kind,
            ).set(info["wire_bytes"])
            _metrics.gauge(
                "serving_head_generation",
                help="newest committed weight generation",
            ).set(gen)
            _metrics.histogram(
                "serving_publish_seconds",
                help="wall time of one committed publication",
            ).observe(dt)
        # flight ring: a committed generation is a control-plane decision
        # the post-mortem record must carry (was the crash before or
        # after generation G reached subscribers?)
        _flight.record(
            "serve", what="publish", generation=int(gen), step=int(step),
            payload=info["kind"],
        )
        self._gc()
        logger.info(
            "published weight generation %d (%s, step %d, %d bytes, %.3fs)",
            gen, info["kind"], step, len(payload), dt,
        )
        return gen

    def flush(self, state: Any, step: int, *,
              budget_s: float = 5.0) -> Optional[int]:
        """Best-effort final publication inside a bounded budget — the
        preemption-drain path. Forces nothing (a delta is fine: the chain
        stays intact), retries once, never raises. Returns the generation
        or None."""
        policy = _retry.RetryPolicy(
            scope="publish_flush", max_attempts=2, base_delay=0.05,
            max_delay=0.2, deadline=max(0.1, budget_s),
        )
        saved = self._retry
        self._retry = policy
        # the retry deadline only bounds inter-attempt SLEEPS; a single
        # blocked HTTP request rides the store's socket timeout, so clamp
        # that too — a black-holed KV must not turn a 5s flush budget into
        # a 30s-per-chunk hang that eats the checkpoint's grace window
        saved_timeout = getattr(self._store, "request_timeout", None)
        if saved_timeout is not None:
            self._store.request_timeout = min(
                saved_timeout, max(0.5, budget_s))
        try:
            gen = self.publish(state, step)
        except BaseException as e:
            logger.warning("final weight publication failed: %s", e)
            return None
        finally:
            self._retry = saved
            if saved_timeout is not None:
                self._store.request_timeout = saved_timeout
        if _metrics.enabled():
            _metrics.counter(
                "serving_final_flushes",
                help="weight generations flushed during a preemption drain",
            ).inc()
        return gen

    # ------------------------------------------------------------- internals

    @staticmethod
    def _numerics_gate_reason(state, tree) -> Optional[str]:
        """Why this publication must be refused, or None. Delegates to
        :func:`horovod_tpu_torch.resilience.numerics.publish_gate_reason`
        (quarantine pending / trainer mid-bad-streak / non-finite tree);
        an import failure never blocks publication."""
        try:
            from horovod_tpu_torch.resilience import numerics as _numerics
        except Exception as e:
            logger.debug("numerics gate unavailable: %s", e)
            return None
        return _numerics.publish_gate_reason(state, tree)

    def _transient_errors(self):
        from horovod_tpu_torch.run.rendezvous import TRANSIENT_KV_ERRORS

        return TRANSIENT_KV_ERRORS

    def _chain_start(self, head: int) -> int:
        """Keyframe generation of the chain `head` belongs to, from its
        manifest; ``head + 1`` when unreadable (nothing left to GC)."""
        from horovod_tpu_torch.run.rendezvous import DeadRankError

        try:
            blob = self._store.get(
                protocol.manifest_key(self._scope, head))
            if blob is None:
                return head + 1
            return int(protocol.parse_manifest(blob)["keyframe"])
        except (DeadRankError, protocol.ChainError, _retry.RetryError,
                ValueError, TypeError):
            return head + 1
        except self._transient_errors():
            return head + 1

    def _kv_head(self) -> Optional[int]:
        """The committed head as the KV sees it (None when unreadable —
        missing, tombstoned, or the KV is down; the delta/keyframe decision
        treats every one of those as "chain not intact")."""
        from horovod_tpu_torch.run.rendezvous import DeadRankError

        try:
            blob = self._store.get(protocol.head_key(self._scope))
            return None if blob is None else int(blob)
        except (DeadRankError, ValueError, _retry.RetryError):
            return None
        except self._transient_errors():
            return None

    def _check_fence(self, fence0, gen: int, n_chunks: int,
                     *, manifest: bool) -> None:
        if self.fence_fn is None:
            return
        if self.fence_fn() == fence0:
            return
        self._cleanup(gen, n_chunks, manifest=manifest)
        if _metrics.enabled():
            _metrics.counter(
                "serving_publish_aborts",
                help="in-flight generations aborted by the elastic fence",
            ).inc()
        raise PublishAborted(
            f"elastic generation changed mid-publish (was {fence0}); "
            f"aborted in-flight weight generation {gen}"
        )

    def _cleanup(self, gen: int, n_chunks: int, *, manifest: bool) -> None:
        """Delete the partial remains of an uncommitted generation; the
        head never pointed at it, so this is purely hygiene (best-effort:
        an unreachable KV keeps the garbage until the next overwrite)."""
        try:
            if manifest:
                self._store.delete(protocol.manifest_key(self._scope, gen))
            for i in range(n_chunks):
                self._store.delete(protocol.chunk_key(self._scope, gen, i))
        except Exception as e:
            logger.debug("aborted-generation cleanup incomplete: %s", e)

    def _gc(self) -> None:
        """Retire generations older than the newest keyframe: a subscriber
        can always resync from the keyframe, so nothing before it is
        reachable. Manifests are tombstoned (a lagging subscriber's GET
        sees "GC'd", not "never written"); chunks are plain-deleted."""
        n = 0
        while self._gc_floor < self._keyframe_gen:
            g = self._gc_floor
            try:
                n_chunks = self._chunk_counts.get(g)
                if n_chunks is None:
                    # an adopted dead chain's generation: its chunk count
                    # lives only in its manifest — read before tombstoning
                    try:
                        blob = self._store.get(
                            protocol.manifest_key(self._scope, g))
                        n_chunks = (
                            int(protocol.parse_manifest(blob)["chunks"])
                            if blob is not None else 1
                        )
                    except Exception:
                        # unreadable/tombstoned manifest must not stall
                        # the floor — delete what we can and move on
                        n_chunks = 1
                self._store.delete(
                    protocol.manifest_key(self._scope, g), tombstone=True)
                for i in range(n_chunks):
                    self._store.delete(protocol.chunk_key(self._scope, g, i))
            except Exception:
                return  # retry from the same floor next publish
            self._chunk_counts.pop(g, None)
            self._gc_floor = g + 1
            n += 1
        if n and _metrics.enabled():
            _metrics.counter(
                "serving_generations_gc",
                help="superseded weight generations retired from the KV",
            ).inc(n)
