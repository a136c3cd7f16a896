"""Elastic world-size training: survive rank loss/join without a restart.

Counterpart of ``horovod_tpu/resilience/elastic.py``: the same schedule,
commit, rollback, chaos charges, metrics and error texts, in a world of
processes, one a rank (the JAX driver is single-controller and re-forms
a mesh over a subset of one process's devices):

- **rank 0 is the driver**, as in the JAX package: it is never evicted
  (chaos victims are the highest ranks), owns the
  :class:`ElasticCoordinator` over the in-process KV store
  (:class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer`) and fires
  the chaos charges. The other ranks talk to it through the rendezvous
  store the world was formed over (the *base* store), under
  ``elastic/<run>/`` (``<run>`` numbers this process's runs).
- **membership** is the coordinator's heartbeat-scoped TTL keys: at each
  step boundary every other member adds one to its beat counter
  (``.../beat/<rank>``), and the driver refreshes the heartbeat of
  each member whose counter moved. A member whose beat does not reach
  the driver within the TTL of the driver reaching the boundary is
  tombstoned (a rank that stopped, or wedged) and dropped there.
- **decisions**: at each boundary the driver publishes ``continue`` or the
  new membership (``.../dec/<generation>/<boundary>``), which every
  member reads before its step, so all members agree on the world.
- **re-formation**: each member of the new generation — survivors and
  re-admitted ranks — calls ``basics.shutdown()`` then ``basics.init()``
  at its index in the sorted member list, over the base store under the
  prefix ``.../gen<G>/``, on its own device. A dropped rank shuts down
  too and parks on the base store, not beating, until a generation
  record (``.../genrec/<G>``) names it again or the driver publishes
  the run's end (``.../end``).
- **state** rolls back to the last *committed* step: a commit gathers
  every ZeRO-1 row (``checkpoint._gather_sharded``, a collective) and
  takes a host snapshot, so every member holds the consolidated state, as
  the JAX single-controller snapshot does. After a re-formation that
  re-admits ranks the snapshot is broadcast from rank 0, and
  ``reshard_fn`` (default :func:`~horovod_tpu_torch.checkpoint.
  rank_state`: ``consolidate_opt_state(..., to_size=len(alive))``, the
  arrays as tensors on the device) takes each rank's row.
- **numerics**: a guarded state's verdict is read at the boundary;
  ``HOROVOD_NUMERICS_MAX_BAD`` BAD steps in a row roll back to the
  committed snapshot with the replay epoch bumped (every member reaches
  the same verdict, so no decision is published for it).

- **eviction**: at each boundary the driver tombstones a rank the
  fingerprint cross-check quarantined (:func:`~horovod_tpu_torch.
  resilience.numerics.take_corrupt_ranks`) or, under
  ``HOROVOD_HANG_EVICT=1``, one the hang watchdog named missing
  (:func:`~horovod_tpu_torch.observability.flight.take_hung_ranks`),
  never rank 0; the survivors re-form without it. The driver owns the
  fingerprint boundary while it runs (``numerics.claim_boundary``).
- **observability**: each generation re-anchors the straggler keys'
  generation, records an ``epoch`` flight event and re-estimates this
  rank's clock offset to the driver's KV server.
- **hooks**: a rebuilt step's gradient hooks (``make_train_step``'s
  ``register_post_accumulate_grad_hook`` handles) are removed when the
  step is built again for a new membership.

A rank that dies inside a collective is out of scope, as it is for the
JAX driver: its peers block in the collective.

- **publication**: with ``publisher=`` (a
  :class:`~horovod_tpu_torch.serving.WeightPublisher`, on the rank that
  writes) and ``publish_every=N``, the committed snapshot is published
  every N steps, and again from the post-resize state after each
  resize; the publisher's generation fence is the elastic generation, so
  a resize aborts a publication in flight.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence

from horovod_tpu_torch.observability import clock as _obs_clock
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import straggler as _straggler
from horovod_tpu_torch.resilience import chaos as _chaos, health as _health
from horovod_tpu_torch.resilience import loop as _loop

__all__ = [
    "ElasticCoordinator",
    "ElasticRun",
    "WorldChanged",
    "WorldTooSmall",
    "run",
]

logger = logging.getLogger("horovod_tpu_torch.resilience.elastic")

MIN_WORKERS_ENV = "HOROVOD_ELASTIC_MIN_WORKERS"
MAX_WORKERS_ENV = "HOROVOD_ELASTIC_MAX_WORKERS"

#: seconds the generation ack barrier waits before declaring the epoch dead
BARRIER_TIMEOUT_ENV = "HOROVOD_ELASTIC_BARRIER_TIMEOUT"

#: numbers the runs of this process: every rank calls :func:`run` the
#: same number of times, so a run's keys on the base store
#: (``elastic/<run>/``) are the same on every rank and no run reads
#: another's
_run_ids = itertools.count()


class WorldChanged(Exception):
    """Internal control flow: membership changed at `step`'s boundary; the
    elastic driver unwinds the inner training segment, re-forms the world
    over `alive`, and resumes. ``lost``/``joined`` carry the delta."""

    def __init__(self, step: int, alive: Sequence[int],
                 lost: Sequence[int] = (), joined: Sequence[int] = ()):
        self.step = step
        self.alive = tuple(alive)
        self.lost = tuple(lost)
        self.joined = tuple(joined)
        super().__init__(
            f"membership changed at step {step}: alive={list(alive)} "
            f"lost={list(lost)} joined={list(joined)}"
        )


class WorldTooSmall(RuntimeError):
    """Surviving ranks fell below ``min_workers``; the job cannot re-form.
    The driver wrote an emergency checkpoint (when a ``checkpoint_dir`` was
    given) before raising, so a relaunch resumes cleanly."""

    def __init__(self, alive: int, min_workers: int, step: int):
        self.alive = alive
        self.min_workers = min_workers
        self.step = step
        super().__init__(
            f"only {alive} rank(s) alive at step {step}, below "
            f"min_workers={min_workers}"
        )


class ElasticCoordinator:
    """Membership over the KV plane: heartbeats, liveness,
    generation-numbered epochs with an ack barrier.

    Keys (all under ``/<scope>``):

    - ``/hb/<rank>`` — TTL'd heartbeat; expiry (or an explicit
      :meth:`mark_dead`) tombstones the rank.
    - ``/gen`` — the current epoch record: ``{"generation": G, "ranks":
      [...]}``; every resize rewrites it.
    - ``/ack/<G>/<rank>`` — the epoch barrier: a member acks generation G
      once it has re-formed; :meth:`await_acks` blocks for the full set and
      fails fast with :class:`DeadRankError` when a member dies
      mid-barrier instead of burning the deadline.

    Pass a :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` to
    share a store; by default the coordinator owns a private one."""

    def __init__(self, server=None, *, ttl: Optional[float] = None,
                 scope: str = "elastic"):
        from horovod_tpu_torch.run import rendezvous as _rdv

        self._rdv = _rdv
        self._own = server is None
        self._server = server if server is not None else _rdv.KVStoreServer()
        self._scope = "/" + scope.strip("/")
        self._ttl = ttl if ttl is not None else _rdv.default_heartbeat_ttl()
        self._generation = 0

    # ------------------------------------------------------------ liveness

    @property
    def server(self):
        return self._server

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def ttl(self) -> float:
        """Seconds a heartbeat stays live without a refresh."""
        return self._ttl

    def _hb_key(self, rank: int) -> str:
        return f"{self._scope}/hb/{rank}"

    def heartbeat(self, rank: int) -> None:
        """Refresh `rank`'s liveness (also re-admits a tombstoned rank —
        the rejoin signal)."""
        self._server.put(self._hb_key(rank), b"1", ttl=self._ttl)

    def heartbeat_all(self, ranks: Iterable[int]) -> None:
        for r in ranks:
            self.heartbeat(r)

    def mark_dead(self, rank: int) -> None:
        """Explicitly tombstone `rank` (deterministic kill: the chaos path
        and controlled drains use this instead of waiting out the TTL)."""
        self._server.delete(self._hb_key(rank), tombstone=True)

    def alive(self) -> List[int]:
        """Ranks with unexpired heartbeats, ascending."""
        prefix = f"{self._scope}/hb/"
        out = []
        for k in self._server.live_keys(prefix):
            try:
                out.append(int(k[len(prefix):]))
            except ValueError:
                continue
        return sorted(out)

    # -------------------------------------------------------------- epochs

    def begin_generation(self, ranks: Sequence[int]) -> int:
        """Open a new epoch over `ranks`; returns its generation number.
        Mirrored into ``resilience_elastic_generation`` /
        ``resilience_elastic_world_size`` so the transition is observable
        from the metrics alone. Prior generations' ack-barrier keys are
        retired — every barrier on generation G has resolved before G+1
        opens, and without the prune the store would grow by one key per
        member per resize forever."""
        if self._generation and hasattr(self._server, "prune"):
            self._server.prune(f"{self._scope}/ack/")
        self._generation += 1
        record = {"generation": self._generation, "ranks": sorted(ranks)}
        self._server.put(
            f"{self._scope}/gen", json.dumps(record).encode())
        if _metrics.enabled():
            _metrics.gauge(
                "resilience_elastic_generation",
                help="current elastic membership epoch",
            ).set(self._generation)
            _metrics.gauge(
                "resilience_elastic_world_size",
                help="ranks in the current elastic epoch",
            ).set(len(record["ranks"]))
        return self._generation

    def membership(self) -> Optional[dict]:
        """The current epoch record, or None before the first epoch."""
        blob = self._server.get(f"{self._scope}/gen")
        return None if blob is None else json.loads(blob)

    def ack(self, generation: int, rank: int) -> None:
        self._server.put(f"{self._scope}/ack/{generation}/{rank}", b"1")

    def await_acks(self, generation: int, ranks: Sequence[int],
                   timeout: Optional[float] = None) -> None:
        """Epoch barrier: block until every rank in `ranks` acked
        `generation`. A member dying mid-barrier raises
        :class:`~horovod_tpu_torch.run.rendezvous.DeadRankError` with its
        rank id immediately (heartbeat-scoped fast-fail), so the caller can
        drop it and open the next epoch rather than waiting out the
        deadline."""
        if timeout is None:
            timeout = float(os.environ.get(BARRIER_TIMEOUT_ENV, "60"))
        self._server.wait_for(
            [f"{self._scope}/ack/{generation}/{r}" for r in ranks],
            timeout=timeout,
            hb_scope=f"{self._scope}/hb",
        )

    def close(self) -> None:
        if self._own:
            self._server.close()


def _default_reshard(state: Any, new_size: int) -> Any:
    """This rank's state for `new_size` ranks from a committed snapshot:
    a dict carrying ``params`` + ``opt_state`` gets its optimizer state
    consolidated (ZeRO-1 rows re-packed, EF residual mass preserved), and
    every host array becomes a tensor on the world's device
    (:func:`~horovod_tpu_torch.checkpoint.rank_state`)."""
    from horovod_tpu_torch import checkpoint as _checkpoint

    return _checkpoint.rank_state(state, to_size=new_size)


class _Ended(Exception):
    """Internal: the run ended while this rank was parked."""


class ElasticRun:
    """The elastic driver: wraps :func:`horovod_tpu_torch.resilience.run`
    in membership epochs. Each epoch trains under one world; a membership
    change unwinds the inner loop, re-forms the world, reshards state, and
    re-enters. Every rank of the world calls it. See :func:`run` for the
    functional spelling and argument docs."""

    def __init__(
        self,
        step_builder: Callable[[int], Callable[[Any, int], Any]],
        *,
        min_workers: Optional[int] = None,
        max_workers: Optional[int] = None,
        snapshot_every: int = 1,
        reshard_fn: Optional[Callable[[Any, int], Any]] = None,
        coordinator: Optional[ElasticCoordinator] = None,
        publisher=None,
        publish_every: int = 0,
    ):
        if min_workers is None:
            min_workers = int(os.environ.get(MIN_WORKERS_ENV, "1"))
        self._step_builder = step_builder
        self._publisher = publisher
        self._publish_every = max(0, publish_every)
        self._published_step: Optional[int] = None
        self._min_workers = max(1, min_workers)
        self._max_workers = max_workers
        self._snapshot_every = max(1, snapshot_every)
        self._reshard = reshard_fn or _default_reshard
        self._coord = coordinator
        self._own_coord = coordinator is None
        self._alive: List[int] = []
        self._failed: List[int] = []
        self._committed_step = 0
        self._committed: Any = None
        #: input-pipeline cursors snapshotted WITH the committed state: a
        #: rollback that rewinds the weights must rewind the sample
        #: stream to the same boundary or the replay consumes the wrong
        #: batches
        self._committed_cursors: dict = {}
        self._has_guard: Optional[bool] = None  # lazily probed once
        #: (step, staged verdict) read one boundary late on non-commit
        #: steps — the guard's observability without fencing every step
        self._staged: Optional[tuple] = None
        self._warned_unevictable: set = set()
        #: the gradient hooks the current step's build registered
        self._hooks: list = []
        self._numerics_rollbacks = 0
        self._recovering_until: Optional[int] = None
        # the base world, fixed at run(): its store, this process's rank
        # and device in it, its size, and whether it ran the native core
        self._base = None
        self._me = 0
        self._world = 1
        self._device = None
        self._local_rank = 0
        self._native_core = False
        self._ns = "elastic/"   # this run's keys on the base store
        self._gen = 0           # the generation this rank trains in
        self._seq = 0           # step boundaries crossed in it
        self._beats: dict = {}  # driver: member -> beat count seen

    # ----------------------------------------------------------- internals

    def _set(self, key: str, record: dict) -> None:
        self._base.set(self._ns + key, json.dumps(record))

    def _get(self, key: str) -> Optional[dict]:
        if not self._base.check([self._ns + key]):
            return None
        return json.loads(self._base.get(self._ns + key))

    def _beat(self) -> None:
        """This member's heartbeat at a step boundary (not the driver's:
        the driver refreshes its own)."""
        self._base.add(f"{self._ns}beat/{self._me}", 1)

    def _beat_count(self, rank: int) -> int:
        return self._base.add(f"{self._ns}beat/{rank}", 0)

    def _await(self, key: str) -> dict:
        """The driver's record under `key`, once it is there; the run's end
        record instead, when the driver ended it first. Polled with
        ``check`` (a store ``wait`` that times out can leave its reply
        behind on the connection, to be read as the next call's)."""
        start = time.monotonic()
        limit = start + self._coord_wait_s()
        pause, next_end = 1e-4, start + 1.0
        while True:
            rec = self._get(key)
            if rec is not None:
                return rec
            now = time.monotonic()
            if now >= next_end:
                end = self._get("end")
                if end is not None:
                    return end
                if now > limit:
                    raise TimeoutError(
                        f"elastic: no record {key!r} from the driver "
                        f"(rank 0) within {self._coord_wait_s():.0f}s")
                next_end = now + 1.0
            time.sleep(pause)
            pause = min(2 * pause, 5e-3)

    def _coord_wait_s(self) -> float:
        from horovod_tpu_torch.run import rendezvous as _rdv

        return (float(os.environ.get(BARRIER_TIMEOUT_ENV, "60"))
                + _rdv.default_heartbeat_ttl())

    def _form(self, ranks: Sequence[int], generation: int) -> None:
        """(Re-)form the world over `ranks` on this live process — the
        no-relaunch membership change: a fresh process group (and native
        core) over the base store under ``elastic/<run>/gen<G>/``, this rank at
        its index among `ranks`, on its own device."""
        import torch.distributed as dist

        from horovod_tpu_torch import basics

        basics.shutdown()
        basics.init(device=self._device, rank=list(ranks).index(self._me),
                    size=len(ranks), local_rank=self._local_rank,
                    native_core=self._native_core,
                    store=dist.PrefixStore(f"{self._ns}gen{generation}/",
                                           self._base))

    def _collect_beats(self) -> None:
        """Driver: wait (at most the TTL) for every member's beat for this
        boundary, then refresh the heartbeat of the driver and of each
        member that beat, and tombstone the others."""
        pending = {r for r in self._alive if r != 0}
        deadline = time.monotonic() + self._coord.ttl
        pause = 1e-4
        beat = [0]
        while pending:
            for r in sorted(pending):
                n = self._beat_count(r)
                if n > self._beats.get(r, 0):
                    self._beats[r] = n
                    beat.append(r)
                    pending.discard(r)
            if not pending or time.monotonic() >= deadline:
                break
            time.sleep(pause)
            pause = min(2 * pause, 5e-3)
        self._coord.heartbeat_all(beat)
        for r in sorted(pending):
            logger.warning("elastic: rank %d sent no heartbeat within %.3gs",
                           r, self._coord.ttl)
            self._coord.mark_dead(r)

    def _poll_membership(self, step: int) -> None:
        """Step-boundary membership sweep. A member beats and reads the
        driver's decision; the driver collects the beats, fires any armed
        chaos charges, compares the KV liveness view with the current
        epoch and publishes the decision. Raises :class:`WorldChanged` on
        a delta."""
        if self._me != 0:
            self._beat()
            rec = self._await(f"dec/{self._gen}/{self._seq}")
            self._seq += 1
            if "outcome" in rec:    # the run's end record
                raise _Ended(rec)
            if rec["op"] == "resize":
                raise WorldChanged(step, rec["alive"], rec["lost"],
                                   rec["joined"])
            return
        coord = self._coord
        self._collect_beats()
        self._evict(coord)
        if _chaos.enabled():
            n_fail = _chaos.take_rank_fail(step)
            if n_fail:
                # highest ranks first, never rank 0 (the driver)
                victims = [r for r in sorted(self._alive) if r != 0][-n_fail:]
                for r in victims:
                    coord.mark_dead(r)
            # check _failed FIRST: take_rank_join pops the charge, and a
            # join armed at/before the fail step must stay armed until
            # there is actually someone to re-admit
            if self._failed and _chaos.take_rank_join(step):
                for r in self._failed:
                    coord.heartbeat(r)  # rejoin = heartbeat resumes
        alive = coord.alive()
        # a heartbeat from a rank this world has no process for (a shared
        # store serving several parties, a stray key) must be ignored
        known = [r for r in alive if 0 <= r < self._world]
        if len(known) < len(alive):
            logger.warning(
                "elastic: ignoring heartbeats for unknown ranks %s "
                "(the world has %d)",
                sorted(set(alive) - set(known)), self._world,
            )
        alive = known
        if self._max_workers is not None:
            alive = alive[: self._max_workers]
        changed = set(alive) != set(self._alive)
        lost = sorted(set(self._alive) - set(alive))
        joined = sorted(set(alive) - set(self._alive))
        if self._world > 1:
            self._set(f"dec/{self._gen}/{self._seq}",
                      {"op": "resize", "alive": alive, "lost": lost,
                       "joined": joined} if changed else {"op": "continue"})
            if self._seq >= 2:      # every member has read it by now
                self._base.delete_key(
                    f"{self._ns}dec/{self._gen}/{self._seq - 2}")
        self._seq += 1
        if changed:
            for r in lost:
                _health.record_rank_lost(r)
            raise WorldChanged(step, alive, lost, joined)

    def _evict(self, coord) -> None:
        """Driver: tombstone each rank the numerics cross-check
        quarantined or the hang diagnosis queued (never rank 0: a corrupt
        rank 0 stays quarantined, so publication stays gated); a failed
        tombstone requeues the verdict for the next boundary."""
        from horovod_tpu_torch.observability import flight as _flight
        from horovod_tpu_torch.resilience import numerics as _numerics

        for what, take, requeue in (
                ("numerically corrupt", _numerics.take_corrupt_ranks,
                 _numerics.requeue_corrupt_ranks),
                ("hung", _flight.take_hung_ranks,
                 _flight.requeue_hung_ranks)):
            keep = []
            for r in take():
                if r == 0:
                    keep.append(r)
                    if r not in self._warned_unevictable:
                        self._warned_unevictable.add(r)
                        logger.error(
                            "elastic: rank 0 flagged %s but it is the "
                            "driver and cannot be evicted", what)
                elif r in self._alive:
                    logger.warning("elastic: evicting %s rank %d", what, r)
                    try:
                        coord.mark_dead(r)
                    except Exception as e:
                        keep.append(r)
                        logger.warning(
                            "elastic: eviction of %s rank %d failed (%s); "
                            "requeued for the next boundary", what, r, e)
            if keep:
                requeue(keep)

    def _sync_observability(self, gen: int) -> None:
        """Re-anchor observability on a generation: the straggler keys
        carry it (they never collide across generations), the flight ring
        records the epoch, and this rank's clock offset to the driver's KV
        server is estimated again. Never fails a resize."""
        from horovod_tpu_torch.observability import flight as _flight

        from horovod_tpu_torch.analysis import sanitizer as _sanitizer
        from horovod_tpu_torch.run import rendezvous as _rdv

        _straggler.set_generation(gen)
        _sanitizer.begin_generation()
        try:
            _flight.record("epoch", generation=int(gen),
                           alive=list(self._alive))
            # the fleet's reference clock is the launcher's KV server;
            # without one, the driver's own store (rank 0 only)
            kv = _rdv.kv_client_from_env()
            if kv is None and self._me == 0 and self._coord is not None:
                kv = self._coord.server
            if kv is not None:
                _obs_clock.refresh_from_kv(kv, rank=self._me,
                                           generation=gen)
        except Exception as e:
            logger.debug("observability re-anchoring skipped: %s", e)

    def _commit(self, step: int, state: Any) -> None:
        """Snapshot `state` as the rollback point: every ZeRO-1 row
        gathered (a collective over the members), then one host copy."""
        from horovod_tpu_torch import checkpoint as _checkpoint
        from horovod_tpu_torch.data import sampler as _data_sampler
        from horovod_tpu_torch.training import host_snapshot

        self._committed_step = step
        self._committed = host_snapshot(_checkpoint._gather_sharded(state))
        self._committed_cursors = _data_sampler.export_state()

    def _restore_cursors(self) -> None:
        """Rewind every registered loader to the committed boundary (the
        state just rolled back there)."""
        from horovod_tpu_torch.data import sampler as _data_sampler

        _data_sampler.restore_state(self._committed_cursors)

    def _wrap(self, step_fn):
        def wrapped(state, step):
            from horovod_tpu_torch.resilience import numerics as _numerics

            _numerics.claim_boundary()
            self._poll_membership(step)
            out = step_fn(state, step)
            # numerics policy: read the guard verdict carried in the
            # state (probed once — states without a guard never pay the
            # boundary sync) and escalate a bad streak to a rollback
            if self._has_guard is None:
                self._has_guard = bool(_numerics.find_guard_states(out))
            v = None
            if self._has_guard:
                committing = (step + 1) % self._snapshot_every == 0
                if _numerics.fingerprint_enabled() or committing:
                    # exact (synchronous) read: the fingerprint plane
                    # needs THIS step's record, and a commit must be gated
                    # on THIS step's verdict (never snapshot mid-incident).
                    # Drain any staged verdict first so its chaos
                    # accounting and gauges are not lost.
                    if self._staged is not None:
                        _numerics.note_step_staged(*self._staged)
                        self._staged = None
                    v = _numerics.note_step(step, out)
                else:
                    # lagged read, one boundary late: the previous step's
                    # staged scalars, while this step still runs on the
                    # device. The rollback policy tolerates MAX_BAD steps
                    # of latency, so a one-step-late verdict is safe.
                    if self._staged is not None:
                        v = _numerics.note_step_staged(*self._staged)
                    self._staged = (step, _numerics.stage_verdict(out))
            if _numerics.fingerprint_enabled():
                _numerics.boundary(step)
            if v is not None and v["bad_streak"] >= \
                    _numerics.max_consecutive_bad():
                raise _numerics.NumericsRollback(step, v["bad_streak"])
            bad_now = v is not None and v["bad_streak"] > 0
            if (step + 1) % self._snapshot_every == 0 and not bad_now:
                # never commit a mid-incident snapshot: rolling back to a
                # state whose guard already counts a bad streak would
                # re-trigger the rollback it is recovering from
                self._commit(step + 1, out)
                if (
                    self._recovering_until is not None
                    and step + 1 > self._recovering_until
                ):
                    # sound progress COMMITTED past the incident that
                    # forced the last rollback: the budget guards against
                    # rollbacks *without* progress, so it resets here
                    self._numerics_rollbacks = 0
                    self._recovering_until = None
            self._maybe_publish(step + 1)
            return out

        return wrapped

    def _maybe_publish(self, step: int) -> None:
        """Publish the COMMITTED snapshot on the publish cadence — the
        consolidated state (host copy, reshard-safe), not the live device
        tree, so a publication is always replayable after a resize. A
        fence abort here means a concurrent party resized under us; the
        resize path republishes, so it is not an error."""
        if self._publisher is None or self._publish_every <= 0:
            return
        if step % self._publish_every or self._committed is None:
            return
        if self._committed_step == self._published_step:
            # snapshot_every > publish_every: the committed tree has not
            # moved since the last publication — re-publishing it would
            # mint identical generations and reset subscriber staleness
            # for weights that never changed
            return
        from horovod_tpu_torch import serving as _serving

        try:
            self._publisher.publish(self._committed, self._committed_step)
            self._published_step = self._committed_step
        except _serving.PublishAborted as e:
            logger.warning("publication fenced off mid-resize: %s", e)
        except _serving.PublishError as e:
            logger.warning(
                "weight publication at step %d failed: %s", step, e)

    def _fence(self) -> int:
        """The publish fence: the coordinator's generation on the driver,
        this rank's generation elsewhere."""
        return self._coord.generation if self._coord is not None \
            else self._gen

    def _build(self):
        """The step for the current membership; the previous build's
        gradient hooks are removed first (they would stay registered on
        the model, inert, across every resize)."""
        from horovod_tpu_torch import training as _training

        for h in self._hooks:
            _training.release_hook(h)
        mark = len(_training._step_hooks)
        step_fn = self._step_builder(len(self._alive))
        self._hooks = _training._step_hooks[mark:]
        return step_fn

    def _open_generation(self, alive: Sequence[int]) -> int:
        """Driver: open the coordinator's next epoch over `alive` and pass
        its ack barrier (the members' process-group formation was the
        real barrier: every member joined it)."""
        gen = self._coord.begin_generation(alive)
        for r in alive:
            self._coord.ack(gen, r)
        self._coord.await_acks(gen, alive)
        return gen

    def _park(self, generation: int) -> dict:
        """A dropped rank: leave the world and wait, not beating, for a
        generation record from `generation` on that names this rank (it
        is returned), or for the run's end (:class:`_Ended`)."""
        from horovod_tpu_torch import basics

        basics.shutdown()
        logger.warning("elastic: rank %d dropped at generation %d; parked",
                       self._me, generation)
        while True:
            rec = self._get(f"genrec/{generation}")
            if rec is not None:
                if self._me in rec["ranks"]:
                    return rec
                generation += 1
                continue
            end = self._get("end")
            if end is not None:
                raise _Ended(end)
            time.sleep(0.05)

    def _enter(self, alive: Sequence[int], generation: int, next_step: int,
               joining: bool) -> Any:
        """Re-form the world over `alive` as `generation` and return this
        rank's state for `next_step`: the committed snapshot, broadcast
        from rank 0 first when the generation re-admits ranks (they hold
        none), resharded for the new size."""
        self._alive = list(alive)
        self._gen, self._seq = generation, 0
        if self._me == 0 and self._world > 1:
            # the count a re-admitted rank's first beat must pass: read
            # before the formation, which it cannot pass before the driver
            # joins it (a survivor's count is the one last seen)
            for r in set(alive) - set(self._beats):
                self._beats[r] = self._beat_count(r)
        self._form(alive, generation)
        if joining:
            from horovod_tpu_torch import checkpoint as _checkpoint

            snap = _checkpoint.broadcast_host_tree(
                {"state": self._committed, "cursors": self._committed_cursors,
                 "step": self._committed_step} if self._me == 0 else None)
            self._committed = snap["state"]
            self._committed_cursors = snap["cursors"]
            self._committed_step = int(snap["step"])
        return self._reshard(self._committed, len(alive))

    def _resize(self, wc: WorldChanged):
        """Handle one membership change: rollback to the last committed
        snapshot, world re-formation, state reshard, epoch barrier.
        Returns ``(state, next_step)``.

        Both directions resume from the committed snapshot: on a loss the
        interrupted step is unreproducible at the old size, and on a join
        the snapshot IS the boundary state (with ``snapshot_every=1``
        nothing is replayed) — the one source of truth keeps the
        post-resize trajectory bit-deterministic."""
        from horovod_tpu_torch.data import sampler as _data_sampler

        t0 = time.monotonic()
        alive = list(wc.alive)
        if len(alive) < self._min_workers:
            raise WorldTooSmall(len(alive), self._min_workers, wc.step)
        next_step = self._committed_step
        if wc.lost:
            self._failed = sorted(set(self._failed) | set(wc.lost))
            for r in wc.lost:       # a re-admission reads a fresh count
                self._beats.pop(r, None)
        if wc.joined:
            self._failed = [r for r in self._failed if r not in wc.joined]
        if _metrics.enabled() and wc.step > next_step:
            _metrics.counter(
                "resilience_elastic_rollback_steps",
                help="steps replayed after rolling back to the last "
                     "committed snapshot",
            ).inc(wc.step - next_step)
        old_size = len(self._alive)
        gen = self._gen + 1
        if self._me == 0 and self._world > 1:
            self._set(f"genrec/{gen}", {"generation": gen, "ranks": alive,
                                        "step": next_step})
        joining = bool(wc.joined)
        if self._me not in alive:
            rec = self._park(gen)
            alive, gen, joining = rec["ranks"], rec["generation"], True
            wc = WorldChanged(rec["step"], alive, joined=[self._me])
            old_size, t0 = 0, time.monotonic()
        state = self._enter(alive, gen, next_step, joining)
        next_step = self._committed_step
        # the sample stream rolls back WITH the state, and the loaders
        # are fenced on the same generation as the world: the members
        # repartition the remaining epoch under the new world size
        self._restore_cursors()
        if self._me == 0:
            self._open_generation(alive)
        _data_sampler.generation_fence(gen, len(alive))
        self._sync_observability(gen)
        dt = time.monotonic() - t0
        if _metrics.enabled():
            _metrics.counter(
                "resilience_elastic_membership_changes",
                help="elastic resizes by direction",
                kind="grow" if len(alive) > old_size else "shrink",
            ).inc()
            _metrics.histogram(
                "resilience_elastic_resize_seconds",
                help="wall time of one membership change (rollback + world "
                     "re-formation + reshard + epoch barrier)",
            ).observe(dt)
        logger.warning(
            "elastic: resized to world size %d (generation %d, lost=%s "
            "joined=%s) in %.3fs",
            len(alive), gen, list(wc.lost), list(wc.joined), dt,
        )
        if self._publisher is not None and self._published_step != next_step:
            # republish from the post-resize consolidated state: any
            # generation the fence aborted mid-resize is superseded here,
            # and subscribers see the exact weights the replayed steps
            # start from (off-cadence on purpose — the resize IS the
            # event; skipped only when this exact committed step already
            # published)
            from horovod_tpu_torch import serving as _serving

            try:
                self._publisher.publish(state, next_step)
                self._published_step = next_step
            except _serving.PublishError as e:
                logger.warning(
                    "post-resize weight publication failed: %s", e)
        return state, next_step

    def _numerics_rollback(self, nr):
        """Handle one :class:`numerics.NumericsRollback`: replay from the
        last committed snapshot with a FRESH data epoch (the replay salt
        data pipelines fold into batch selection), bounded by
        ``HOROVOD_NUMERICS_MAX_ROLLBACKS``. Exhausting the budget is
        FATAL — the run cannot make numerically sound progress."""
        from horovod_tpu_torch.resilience import numerics as _numerics

        self._numerics_rollbacks += 1
        if self._numerics_rollbacks > _numerics.max_rollbacks():
            _health.record_fatal(
                f"numerics rollback budget exhausted "
                f"({self._numerics_rollbacks - 1} rollbacks)"
            )
            raise _numerics.NumericsError(
                f"still seeing {nr.streak} consecutive bad steps after "
                f"{self._numerics_rollbacks - 1} rollback(s); giving up"
            ) from nr
        if self._committed is None:
            _health.record_fatal("numerics rollback with no snapshot")
            raise _numerics.NumericsError(
                "consecutive bad steps before any committed snapshot"
            ) from nr
        self._recovering_until = nr.step + 1
        epoch = _numerics.bump_replay_epoch()
        if _metrics.enabled():
            _metrics.counter(
                "numerics_rollbacks",
                help="rollbacks to the committed snapshot forced by "
                     "consecutive bad steps",
            ).inc()
            if nr.step >= self._committed_step:
                _metrics.counter(
                    "numerics_rollback_steps",
                    help="steps replayed after a numerics rollback",
                ).inc(nr.step + 1 - self._committed_step)
        logger.warning(
            "numerics: %d consecutive bad steps at step %d; rolling back "
            "to committed step %d (replay epoch %d)",
            nr.streak, nr.step, self._committed_step, epoch,
        )
        # rewind the sample cursors to the committed boundary; the bumped
        # replay epoch (folded into batch selection by the loader) makes
        # the replayed steps draw FRESH batches from that same cursor
        self._restore_cursors()
        return (self._reshard(self._committed, len(self._alive)),
                self._committed_step)

    def _ended(self, rec: dict):
        """A parked rank at the run's end: None after a finished run; the
        driver's outcome raised here too otherwise."""
        outcome = rec.get("outcome")
        if outcome == "done":
            return None
        if outcome == "too_small":
            raise WorldTooSmall(rec["alive"], rec["min_workers"], rec["step"])
        if outcome == "preempted":
            raise _loop.Preempted(rec["step"])
        raise RuntimeError(f"the elastic driver (rank 0) failed: "
                           f"{rec.get('error')}")

    # -------------------------------------------------------------- driver

    def run(
        self,
        state: Any,
        *,
        num_steps: int,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        callbacks: Optional[Iterable] = None,
    ) -> Any:
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.data import sampler as _data_sampler
        from horovod_tpu_torch.resilience import numerics as _numerics

        if not basics.is_initialized():
            basics.init()
        self._base = basics._state.store
        self._me, self._world = basics.rank(), basics.size()
        self._device = basics.device()
        self._local_rank = basics.local_rank()
        self._native_core = basics.core() is not None
        self._ns = f"elastic/{next(_run_ids)}/"
        cap = self._max_workers or int(
            os.environ.get(MAX_WORKERS_ENV, "0")
        ) or self._world
        self._max_workers = min(cap, self._world)
        if self._me == 0 and self._coord is None:
            self._coord = ElasticCoordinator()
        if self._publisher is not None and self._publisher.fence_fn is None:
            # the elastic generation IS the publish fence: a resize bumps
            # it, aborting any in-flight generation before it can commit
            self._publisher.fence_fn = self._fence
        end = {"outcome": "error", "error": "the driver raised"}
        try:
            # initial formation at full strength (bounded by max_workers);
            # the admissible band applies from step 0, not just on
            # resizes — a world that cannot field min_workers must error,
            # not silently train below the floor for the whole run
            self._alive = list(range(self._max_workers))
            if len(self._alive) < self._min_workers:
                raise WorldTooSmall(
                    len(self._alive), self._min_workers, 0)
            self._gen = 1
            if self._me == 0:
                self._coord.heartbeat_all(self._alive)
                # this run's beat counters start at 0
                self._beats = {r: 0 for r in self._alive if r != 0}
            if len(self._alive) < self._world:
                # a world wider than max_workers: the first generation is
                # the lowest ranks, formed apart; the others park
                if self._me == 0:
                    self._set("genrec/1", {"generation": 1, "step": 0,
                                           "ranks": self._alive})
                if self._me in self._alive:
                    self._form(self._alive, 1)
                else:
                    rec = self._park(2)
                    self._gen = rec["generation"]
            if self._me == 0:
                self._open_generation(self._alive)
            _data_sampler.generation_fence(self._gen, len(self._alive))
            self._sync_observability(self._gen)

            next_step = 0
            if self._gen > 1:       # re-admitted from the start's park
                state = self._enter(rec["ranks"], rec["generation"], 0, True)
                next_step = self._committed_step
            else:
                if checkpoint_dir:
                    resumed = _loop.resume_state(checkpoint_dir)
                    if resumed is not None:
                        next_step, state = resumed
                        logger.info(
                            "elastic: resumed from checkpoint at step %d",
                            next_step)
                self._commit(next_step, state)

            built_for: Optional[tuple] = None  # membership the fn targets
            step_fn = None
            while True:
                # key the cache on MEMBERSHIP, not count: a simultaneous
                # loss+join keeps the size but re-forms the world over a
                # different rank set — only a numerics rollback (same
                # membership, replay) may reuse the built step
                membership = tuple(self._alive)
                if step_fn is None or built_for != membership:
                    step_fn = self._build()
                    built_for = membership
                try:
                    out = _loop.run(
                        self._wrap(step_fn),
                        state,
                        num_steps=num_steps,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every,
                        start_step=next_step,
                        callbacks=callbacks,
                    )
                    end = {"outcome": "done"}
                    return out
                except WorldChanged as wc:
                    # a staged verdict from the abandoned trajectory must
                    # not be read against the new one
                    self._staged = None
                    state, next_step = self._resize(wc)
                except _numerics.NumericsRollback as nr:
                    self._staged = None
                    state, next_step = self._numerics_rollback(nr)
        except _Ended as e:
            return self._ended(e.args[0])
        except WorldTooSmall as e:
            end = {"outcome": "too_small", "alive": e.alive,
                   "min_workers": e.min_workers, "step": e.step}
            # _committed is None when the floor broke before any snapshot
            # (initial formation): nothing to save, just surface the error
            if checkpoint_dir and self._committed is not None:
                from horovod_tpu_torch import checkpoint as _checkpoint

                _checkpoint.save(
                    checkpoint_dir, self._committed_step,
                    _checkpoint.attach_data_state(
                        {"step": self._committed_step,
                         "state": self._committed},
                        cursors=self._committed_cursors,
                    ),
                    force=True, fence=False,
                )
            raise
        except _loop.Preempted as e:
            end = {"outcome": "preempted", "step": e.step}
            raise
        finally:
            if self._staged is not None:
                # the LAST step's lagged verdict has no next boundary —
                # drain it so its gauges/chaos accounting land
                _numerics.note_step_staged(*self._staged)
                self._staged = None
            # a standalone InstrumentedStep loop after this run publishes
            # its fingerprints again
            _numerics.release_boundary()
            if self._me == 0:
                if self._world > 1:     # releases the parked ranks
                    self._set("end", end)
                if self._own_coord and self._coord is not None:
                    self._coord.close()


def run(
    step_builder: Callable[[int], Callable[[Any, int], Any]],
    state: Any,
    *,
    num_steps: int,
    min_workers: Optional[int] = None,
    max_workers: Optional[int] = None,
    snapshot_every: int = 1,
    reshard_fn: Optional[Callable[[Any, int], Any]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    callbacks: Optional[Iterable] = None,
    coordinator: Optional[ElasticCoordinator] = None,
    publisher=None,
    publish_every: int = 0,
) -> Any:
    """Drive elastic training: ``state = step_fn(state, i)`` where
    ``step_fn = step_builder(world_size)`` is rebuilt every time membership
    changes. Every rank of the world (``hvd.init()`` first; without it the
    world is this process on its GPU) calls it with its own state.
    Returns the final state; a rank that is not a member when the run ends
    returns None.

    - `step_builder(world_size)`: called after each world (re-)formation —
      ``hvd.size()``/``hvd.rank()`` are the fresh world's — and must return
      a ``(state, step) -> state`` step callable for that world.
    - `min_workers` / `max_workers` (env ``HOROVOD_ELASTIC_MIN_WORKERS`` /
      ``HOROVOD_ELASTIC_MAX_WORKERS``): the admissible world-size band.
      Falling below `min_workers` raises :class:`WorldTooSmall` after an
      emergency checkpoint of the last committed snapshot.
    - `snapshot_every`: commit a host-offloaded rollback snapshot every N
      completed steps (default 1). On a rank loss the run rolls back to
      the last committed step — a death detected at step k replays steps
      ``[committed, k)`` at the new world size.
    - `reshard_fn(state, new_size)`: this rank's state from the committed
      snapshot (host arrays, every ZeRO-1 row); the default consolidates
      the ZeRO-1 optimizer state of dicts carrying ``params`` +
      ``opt_state`` and puts every array on the device.
    - `checkpoint_dir` / `checkpoint_every` / `callbacks`: forwarded to the
      inner :func:`horovod_tpu_torch.resilience.run` — periodic
      checkpoints, SIGTERM preemption (drain → emergency checkpoint → exit
      75), and resume all keep working inside each epoch.
    - `coordinator`: an :class:`ElasticCoordinator` for rank 0 (by default
      the run owns a private one).
    - `publisher` / `publish_every`: a
      :class:`~horovod_tpu_torch.serving.WeightPublisher` (give it on the
      rank that writes) publishing the committed snapshot every
      `publish_every` steps and after each resize, fenced on the elastic
      generation.

    The numerics guard composes (:mod:`horovod_tpu_torch.resilience.
    numerics`): when the carried state holds a guarded optimizer, the
    driver reads the per-step verdict — ``HOROVOD_NUMERICS_MAX_BAD``
    consecutive bad steps roll back to the committed snapshot with a
    bumped replay epoch (bounded by ``HOROVOD_NUMERICS_MAX_ROLLBACKS``,
    then FATAL).

    Membership faults are injectable deterministically, on rank 0:
    ``HOROVOD_CHAOS="rank_fail=2,rank_fail_at_step=3,rank_join_at_step=6"``
    drops the two highest ranks at step 3's boundary and re-admits them at
    step 6's.
    """
    return ElasticRun(
        step_builder,
        min_workers=min_workers,
        max_workers=max_workers,
        snapshot_every=snapshot_every,
        reshard_fn=reshard_fn,
        coordinator=coordinator,
        publisher=publisher,
        publish_every=publish_every,
    ).run(
        state,
        num_steps=num_steps,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        callbacks=callbacks,
    )
