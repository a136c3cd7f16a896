"""The input pipeline: sharded, resumable batch iteration onto the card.

Counterpart of ``horovod_tpu/data/loader.py``. The index streams are the
JAX package's, id for id: :func:`shard_indices` (the DistributedSampler
role), :class:`ShardedLoader` (each rank's block of every global batch)
and :class:`ResumableLoader` (a rank's strided slice of each global
batch of :class:`~horovod_tpu_torch.data.sampler.GlobalSampleIndex`,
with the cursor, the replay salt, the generation fence and the
registry the checkpoint and the elastic driver call).

Placement is the port's own. One process drives one GPU, so a loader is
always per rank: by default it follows this process's world
(``basics.rank()``/``basics.size()``) and places each batch on
``basics.device()``. ``device=False`` (or a CPU device) hands back host
tensors. A loader asked for the card on a machine without CUDA raises:
it never falls back to host tensors.

On the card, each batch is gathered into a page-locked buffer and copied
to the device with ``non_blocking=True`` on a copy stream of its own
(:class:`_CardFeed`); with ``prefetch > 0`` a producer thread does this
ahead of the step loop, so step N+1's copy overlaps step N's compute.
The step's stream waits on the copy's event before it reads the batch,
and every batch tensor is ``record_stream``-ed on that stream, so the
caching allocator cannot hand its memory out while the step still reads
it; a page-locked buffer is refilled only after its last copy's event
has completed.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.data import sampler as _sampler
from horovod_tpu_torch.observability import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch.data")

#: host batches kept in flight ahead of the step loop (ResumableLoader)
PREFETCH_ENV = "HOROVOD_PREFETCH_BATCHES"
#: seconds the step loop waits for a prefetched batch before the stall is
#: *detected* (flight event + health strike) instead of silently freezing
WATCHDOG_ENV = "HOROVOD_DATA_WATCHDOG"


def shard_indices(
    n: int,
    rank: Optional[int] = None,
    size: Optional[int] = None,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    replay_epoch: int = 0,
    drop_last: bool = False,
) -> np.ndarray:
    """This process's example indices for one epoch.

    DistributedSampler semantics (reference examples
    ``pytorch_mnist.py:98-103``): every process sees a disjoint slice of a
    deterministic epoch-seeded permutation; unless ``drop_last``, the
    permutation is padded by wrap-around so all slices have equal length
    (keeping collective step counts identical across processes — a
    mismatched count is exactly the stall/join case).

    ``(seed, epoch, replay_epoch)`` are mixed through a real hash
    (:func:`horovod_tpu_torch.data.sampler.mix_seed`) before seeding the
    RNG; `replay_epoch` is the numerics rollback's salt: bump it to draw a
    fresh permutation of the same epoch.
    """
    rank = basics.process_rank() if rank is None else rank
    size = basics.process_size() if size is None else size
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(
            _sampler.mix_seed(seed, epoch, replay_epoch)
        ).permutation(n)
    if drop_last:
        per = n // size
        return order[rank * per:(rank + 1) * per]
    per = -(-n // size)  # ceil
    # wrap-around padding may need more than one repetition of the order
    # (n=1, size=4 needs 4 copies) — DistributedSampler-style tiling keeps
    # every slice exactly `per` long
    reps = -(-per * size // n)
    padded = np.tile(order, reps)[: per * size]
    return padded[rank::size][:per]


def _target(device) -> Optional[torch.device]:
    """Where batches go: None for host tensors (``device=False`` or a CPU
    device), else a CUDA device — ``device=None`` is this process's
    (:func:`basics.default_device`). A CUDA target without CUDA raises."""
    if device is False:
        return None
    dev = basics.default_device(None if device is True else device)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"a loader places on the CPU or a GPU, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the loader was asked to place batches on {dev}, but CUDA is "
            f"not available; pass device=False for host tensors")
    return dev


def _world(rank, size) -> tuple:
    """``(rank, size)``; None for both follows this process's world."""
    if (rank is None) != (size is None):
        raise ValueError("pass rank and size together (or neither)")
    if rank is not None:
        return int(rank), int(size)
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


class _Slot:
    """One page-locked staging buffer set and the event of its last copy."""

    __slots__ = ("buffers", "event")

    def __init__(self):
        self.buffers: tuple = ()
        self.event = None


class _CardFeed:
    """The copy of host batches to one GPU: a ring of page-locked slots,
    a copy stream, and an event a copy. :meth:`stage` (the producer's
    side) fills a slot and starts its copy; :meth:`hand_over` (the step
    loop's side) makes the current stream wait for it."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._ring = [_Slot() for _ in range(max(2, slots))]
        self._next = 0
        self._stream = None

    def _alloc(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _copy(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.device, non_blocking=True)

    def stage(self, arrays) -> tuple:
        """Copy ``arrays`` (numpy) to the card: ``(tensors, event)``."""
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot.event is not None:
            slot.event.synchronize()   # its last copy has read the slot
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if [(b.shape, b.dtype) for b in slot.buffers] != \
                [(h.shape, h.dtype) for h in host]:
            slot.buffers = tuple(self._alloc(h.shape, h.dtype) for h in host)
        for b, h in zip(slot.buffers, host):
            b.copy_(h)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = tuple(self._copy(b) for b in slot.buffers)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return out, event

    def hand_over(self, tensors: tuple, event) -> tuple:
        """The staged batch, safe to read on the current stream."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in tensors:
            t.record_stream(stream)
        return tensors


def _host(arrays) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


class ShardedLoader:
    """Iterate this rank's block of each global batch, with prefetch.

    Args:
      arrays: one array or a tuple/list of arrays sharing dim 0 (e.g.
        ``(images, labels)``).
      batch_size: GLOBAL batch size; must divide by the world size. Rank
        ``r`` of ``n`` gets rows ``[r*b/n, (r+1)*b/n)`` of each global
        batch: what the JAX package's mesh puts on its ``r``-th device.
      shuffle/seed: epoch-reshuffled order (``set_epoch`` reseeds, the
        DistributedSampler idiom).
      drop_last: drop the trailing partial batch (default True — static
        shapes).
      prefetch: batches whose copy to the card is started ahead of the
        consumer.
      rank/size: the share (default this process's world).
      device: as :class:`ResumableLoader`'s.
    """

    def __init__(
        self,
        arrays,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        rank: Optional[int] = None,
        size: Optional[int] = None,
        device=None,
    ):
        self._arrays = tuple(arrays) if isinstance(
            arrays, (tuple, list)
        ) else (arrays,)
        self._single = not isinstance(arrays, (tuple, list))
        n = self._arrays[0].shape[0]
        for a in self._arrays[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    f"arrays disagree on dim 0: {a.shape[0]} != {n}"
                )
        self._n = n
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        if prefetch < 0:
            raise ValueError("prefetch must be >= 0")
        self._prefetch = prefetch
        self._rank, self._size = _world(rank, size)
        self._target = _target(device)
        self._epoch = 0
        self._live_iters = 0

    def set_epoch(self, epoch: int):
        """Reseed the shuffle for a new epoch (DistributedSampler idiom).

        Raises while an iterator is live: the running iterator
        materialized its order at ``__iter__``, so a mid-iteration call
        would silently change nothing about the batches in flight."""
        if self._live_iters > 0:
            raise RuntimeError(
                "set_epoch() called while an iterator is live; the "
                "running epoch's order was materialized at __iter__ and "
                "will not change — finish (or close) the iterator first"
            )
        self._epoch = epoch

    def __len__(self) -> int:
        if self._drop_last:
            return self._n // self._bs
        return -(-self._n // self._bs)

    def _order(self, epoch: Optional[int] = None) -> np.ndarray:
        """The (snapshotted) epoch's permutation, salted with the numerics
        ``replay_epoch`` so a rollback's replay draws fresh batches."""
        epoch = self._epoch if epoch is None else epoch
        if self._shuffle:
            from horovod_tpu_torch.resilience import numerics as _numerics

            return np.random.RandomState(
                _sampler.mix_seed(
                    self._seed, epoch, _numerics.replay_epoch())
            ).permutation(self._n)
        return np.arange(self._n)

    def __iter__(self) -> Iterator:
        if self._bs % self._size != 0:
            raise ValueError(
                f"global batch size {self._bs} must divide by the world "
                f"size {self._size} (static even sharding)"
            )
        tail = self._n % self._bs
        if not self._drop_last and tail % self._size != 0:
            # fail at iterator start, not mid-epoch on the tail
            raise ValueError(
                f"with drop_last=False the trailing batch of {tail} rows "
                f"must also divide by the world size {self._size}; drop "
                f"the tail or pad the dataset"
            )
        # the epoch is snapshotted HERE, eagerly (see set_epoch)
        order = self._order(self._epoch)
        self._live_iters += 1
        return _EpochIterator(self, self._iterate(order))

    def _rows(self, order: np.ndarray, i: int) -> tuple:
        sel = order[i * self._bs:(i + 1) * self._bs]
        per = len(sel) // self._size
        sel = sel[self._rank * per:(self._rank + 1) * per]
        return tuple(np.asarray(a)[sel] for a in self._arrays)

    def _iterate(self, order: np.ndarray) -> Iterator:
        def out(batch):
            return batch[0] if self._single else batch

        if self._target is None:
            for i in range(len(self)):
                yield out(_host(self._rows(order, i)))
            return
        feed = _CardFeed(self._target, self._prefetch + 2)
        pending = []
        for i in range(len(self)):
            pending.append(feed.stage(self._rows(order, i)))
            if len(pending) > self._prefetch:
                yield out(feed.hand_over(*pending.pop(0)))
        while pending:
            yield out(feed.hand_over(*pending.pop(0)))


class _EpochIterator:
    """One live epoch of a :class:`ShardedLoader`. Owns the loader's
    live-iterator count — in a wrapper, not the generator's ``finally``,
    because closing a never-started generator skips its body entirely
    and would leak the count (making ``set_epoch`` raise forever)."""

    def __init__(self, loader: "ShardedLoader", gen: Iterator):
        self._loader = loader
        self._gen = gen
        self._open = True

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:
            self._finish()
            raise

    def close(self) -> None:
        self._gen.close()
        self._finish()

    def _finish(self) -> None:
        if self._open:
            self._open = False
            self._loader._live_iters -= 1

    def __del__(self):  # pragma: no cover - best effort
        self._finish()


class _ArraySource:
    """In-memory source behind :class:`ResumableLoader` — the duck type
    :class:`~horovod_tpu_torch.data.store.ArrayShardStore` also
    implements."""

    def __init__(self, arrays):
        self._arrays = tuple(arrays) if isinstance(
            arrays, (tuple, list)) else (arrays,)
        n = self._arrays[0].shape[0]
        for a in self._arrays[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    f"arrays disagree on dim 0: {a.shape[0]} != {n}"
                )
        self.n_rows = n

    def gather(self, indices):
        sel = np.asarray(indices)
        return tuple(np.asarray(a)[sel] for a in self._arrays)


class ResumableLoader:
    """Elastic-aware, deterministically resumable, fault-isolated input
    pipeline, one rank's share of a global stream.

    Every batch is selected by a :class:`~horovod_tpu_torch.data.sampler
    .GlobalSampleIndex`: a pure function of ``(seed, epoch, step,
    replay_epoch)``, a rank's share (its strided slice) a pure function of
    ``(rank, world_size)`` on top. Consequences:

    - **resume** — the ``(epoch, step)`` cursor rides every checkpoint
      (the loader registers with :mod:`horovod_tpu_torch.data.sampler`;
      ``resilience.run``/``elastic.run`` attach and restore it), so a
      kill/resume mid-epoch reproduces the exact remaining stream;
    - **replay** — a numerics rollback bumps
      ``numerics.replay_epoch()``; the loader folds it into selection, so
      replayed steps draw fresh batches while a plain elastic rollback
      (same replay epoch) re-draws identical ones;
    - **elastic resharding** — the global batch never depends on the
      world size, so a resize repartitions the remaining epoch by
      re-slicing: no sample dropped, none visited twice. A loader that
      follows the process's world (``rank``/``size`` None) re-slices
      itself at the elastic driver's generation fence
      (:meth:`on_generation`); one given an explicit share is moved by
      :meth:`reshard`;
    - **fault isolation** — an :class:`~horovod_tpu_torch.data.store
      .ArrayShardStore` source brings CRC-verified, retried,
      quarantine-capable reads; the prefetch thread's stall is
      *detected* (``HOROVOD_DATA_WATCHDOG`` → flight-recorder ``data``
      event + ``health.record_input_stall``);
    - **attribution** — per-batch ``data_wait_seconds`` /
      ``input_examples_per_second`` metrics and the straggler plane's
      data wait (``HOROVOD_CHAOS=data_stall=<rank>:<s>`` drills it).

    Args:
      source: one array, a tuple of arrays sharing dim 0, or any object
        with ``n_rows`` + ``gather(indices)`` (e.g. ``ArrayShardStore``).
      batch_size: GLOBAL batch size (drop-last semantics; must divide by
        ``size``).
      seed / shuffle: the stream identity.
      rank / size: the share; default (None) this process's world.
      device: where batches go — None this process's device
        (``basics.default_device()``), False or a CPU device host
        tensors, else the given GPU; a GPU without CUDA raises.
      prefetch: batches produced (and, on the card, copied) ahead by the
        background thread (``HOROVOD_PREFETCH_BATCHES``, default 2;
        0 = synchronous).
      watchdog: stall-detection timeout seconds
        (``HOROVOD_DATA_WATCHDOG``, default 30).
      name: registry name (cursor checkpointing); unique per process.

    ``last_key``/``last_indices`` record what the last batch consumed,
    ``last_wait`` how long the step loop waited for it (seconds).
    """

    def __init__(
        self,
        source,
        batch_size: int,
        *,
        seed: int = 0,
        shuffle: bool = True,
        rank: Optional[int] = None,
        size: Optional[int] = None,
        device=None,
        prefetch: Optional[int] = None,
        watchdog: Optional[float] = None,
        name: str = "input",
        register: bool = True,
    ):
        if hasattr(source, "gather") and hasattr(source, "n_rows"):
            self._source = source
        else:
            self._source = _ArraySource(source)
        self._follows_world = rank is None and size is None
        self._rank, self._size = _world(rank, size)
        self.index = _sampler.GlobalSampleIndex(
            self._source.n_rows, batch_size, seed=seed, shuffle=shuffle)
        if batch_size % self._size != 0:
            raise ValueError(
                f"batch size {batch_size} must divide by the world size "
                f"{self._size}")
        self._target = _target(device)
        if prefetch is None:
            prefetch = int(os.environ.get(PREFETCH_ENV, "2"))
        if prefetch < 0:
            raise ValueError("prefetch must be >= 0")
        self._prefetch = prefetch
        self._feed = (None if self._target is None
                      else _CardFeed(self._target, prefetch + 2))
        if watchdog is None:
            watchdog = float(os.environ.get(WATCHDOG_ENV, "30"))
        self._watchdog = max(0.05, float(watchdog))
        self.name = name
        # cursor: the NEXT (epoch, step) to draw
        self._epoch = 0
        self._step = 0
        self._generation = 0
        self._last_consume_t: Optional[float] = None
        self.last_key: Optional[tuple] = None
        self.last_indices: Optional[np.ndarray] = None
        self.last_wait: Optional[float] = None
        # prefetch plumbing: entries are (token, key, payload, indices,
        # stalled); token bumps invalidate in-flight production
        # (restore/reshard/replay change), stale entries are dropped at
        # consume
        self._lock = threading.Lock()
        self._token = 0
        self._prod_cursor: Optional[tuple] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registered = bool(register)
        if register:
            _sampler.register(self, name)

    # ------------------------------------------------------------- cursor

    @property
    def steps_per_epoch(self) -> int:
        return self.index.steps_per_epoch

    def __len__(self) -> int:
        return self.index.steps_per_epoch

    def cursor(self) -> tuple:
        """The next ``(epoch, step)`` this loader will draw."""
        with self._lock:
            return (self._epoch, self._step)

    def state(self) -> dict:
        """JSON/npz-able cursor — what rides the checkpoint payload."""
        with self._lock:
            return {
                "epoch": int(self._epoch),
                "step": int(self._step),
                "seed": int(self.index.seed),
                "generation": int(self._generation),
            }

    def restore(self, state: dict) -> None:
        """Move the cursor (resume, elastic rollback). A seed mismatch is
        loud: restoring another stream's cursor silently would desync
        exactly-once accounting."""
        seed = state.get("seed")
        if seed is not None and int(seed) != self.index.seed:
            logger.warning(
                "loader %r: restoring a cursor recorded under seed %s "
                "onto a loader seeded %s — streams will differ",
                self.name, int(seed), self.index.seed,
            )
        with self._lock:
            self._epoch = int(state["epoch"])
            self._step = int(state["step"])
            gen = state.get("generation")
            if gen is not None:
                self._generation = max(self._generation, int(gen))
        self._resync()
        self._set_cursor_gauges()

    def on_generation(self, generation: int,
                      world_size: Optional[int] = None) -> None:
        """Elastic generation fence: the world re-formed under membership
        epoch `generation`. A loader that follows the process's world
        takes its new rank and size (the world is formed by now); any
        loader drops its in-flight speculation and records the
        generation for the ``data_generation`` gauge."""
        if self._follows_world and basics.is_initialized():
            self.reshard(rank=basics.rank(), size=basics.size(),
                         generation=generation)
        else:
            with self._lock:
                self._generation = int(generation)
            self._resync()
        if _metrics.enabled():
            _metrics.gauge(
                "data_generation",
                help="elastic generation the input pipeline is fenced on",
            ).set(int(generation))

    def reshard(self, *, rank: int, size: int,
                generation: Optional[int] = None) -> None:
        """Repartition mid-epoch (elastic resize): same cursor, same
        global stream, new ``(rank, size)`` slice — the union over the new
        rank set still covers every remaining global batch exactly
        once."""
        if size < 1 or not 0 <= rank < size:
            # validate BEFORE mutating: a stale rank id from the old
            # world must fail here, not mid-step after the speculation
            # was already discarded
            raise ValueError(f"invalid rank {rank} of size {size}")
        if self.index.batch_size % size != 0:
            raise ValueError(
                f"batch size {self.index.batch_size} must divide by the "
                f"new world size {size}"
            )
        with self._lock:
            self._rank = int(rank)
            self._size = int(size)
            if generation is not None:
                self._generation = int(generation)
        self._resync()

    # ------------------------------------------------------------ pipeline

    def _replay(self) -> int:
        from horovod_tpu_torch.resilience import numerics as _numerics

        return _numerics.replay_epoch()

    def _key_locked(self) -> tuple:
        return (self._epoch, self._step, self._replay())

    def _resync(self) -> None:
        """Invalidate in-flight speculation and point the producer at the
        consumer cursor (restore/reshard/replay-epoch change)."""
        with self._lock:
            self._token += 1
            token = self._token
            self._prod_cursor = self._key_locked()
        # drain STALE entries so a producer blocked in put() wakes. A
        # fresh-token entry must survive: the producer may already have
        # produced under the new token (and advanced its cursor past it)
        # between the bump and this drain. Single producer ⇒ FIFO order:
        # once the head is fresh, everything behind it is too.
        while True:
            try:
                entry = self._q.get_nowait()
            except queue.Empty:
                break
            if entry[0] == token:
                self._q.put(entry)
                break

    def _maybe_stall(self) -> float:
        """Apply an armed ``data_stall`` charge; returns the injected
        seconds (0 when unarmed or another rank's charge)."""
        from horovod_tpu_torch.resilience import chaos as _chaos

        if not _chaos.enabled():
            return 0.0
        charge = _chaos.data_stall()
        if charge is None or charge[1] <= 0:
            return 0.0
        rank, seconds = charge
        if basics.is_initialized() and basics.process_size() > 1:
            if basics.process_rank() != rank:
                return 0.0
        _chaos.record_injection("data_stall")
        time.sleep(seconds)
        return seconds

    def _produce(self, key: tuple):
        """One batch for cursor `key` — the (possibly background)
        producer half: the rows gathered and, on the card, staged and
        their copy started. Chaos stalls land here, where a real slow
        disk would."""
        epoch, step, replay = key
        stalled = self._maybe_stall()
        with self._lock:
            rank, size = self._rank, self._size
        idx = self.index.rank_indices(epoch, step, rank, size, replay)
        arrays = self._source.gather(idx)
        payload = (_host(arrays) if self._feed is None
                   else self._feed.stage(arrays))
        return payload, idx, stalled

    def _producer_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                token = self._token
                key = self._prod_cursor
            if key is None:
                time.sleep(0.001)
                continue
            failed = False
            try:
                payload, idx, stalled = self._produce(key)
                entry = (token, key, payload, idx, stalled)
            except BaseException as e:  # surfaced at consume
                entry = (token, key, e, None, 0.0)
                failed = True
            while not self._stop.is_set():
                try:
                    self._q.put(entry, timeout=0.1)
                    break
                except queue.Full:
                    continue
            with self._lock:
                if self._token == token and not failed:
                    self._prod_cursor = (
                        *self.index.advance(key[0], key[1]), key[2])
            if failed:
                # don't spin on a persistently failing key: the consumer
                # raised (or will); re-produce on its cadence, not ours
                time.sleep(0.05)

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._prod_cursor is None:
                self._prod_cursor = self._key_locked()
        self._thread = threading.Thread(
            target=self._producer_loop,
            name=f"hvd-data-{self.name}",
            daemon=True,
        )
        self._thread.start()

    def _record_stall_detected(self, waited: float, key: tuple) -> None:
        from horovod_tpu_torch.resilience import health as _health

        logger.warning(
            "data: input pipeline stalled — no batch for (epoch=%d, "
            "step=%d) after %.1fs", key[0], key[1], waited,
        )
        _health.record_input_stall(waited)
        if _metrics.enabled():
            _metrics.counter(
                "data_prefetch_stalls",
                help="watchdog expiries while waiting on the prefetch "
                     "thread",
            ).inc()
        try:
            from horovod_tpu_torch.observability import flight as _flight

            _flight.record(
                "data", event="input_stall", seconds=round(waited, 3),
                epoch=int(key[0]), step=int(key[1]),
            )
        except Exception as e:
            logger.debug("flight input-stall event skipped: %s", e)

    def next_batch(self):
        """The next batch on the cursor (advancing it): a tuple of tensors
        (or the single tensor for a one-array source), on the loader's
        device. ``last_key`` / ``last_indices`` / ``last_wait`` record
        what was just consumed."""
        t0 = time.monotonic()
        with self._lock:
            expected = self._key_locked()
            stale_replay = (
                self._prod_cursor is not None
                and self._prod_cursor[2] != expected[2]
            )
        if stale_replay:
            # the replay epoch moved under us (numerics rollback):
            # in-flight speculation belongs to the abandoned stream
            self._resync()
        if self._prefetch == 0:
            payload, idx, stalled = self._produce(expected)
        else:
            self._ensure_thread()
            while True:
                try:
                    entry = self._q.get(timeout=self._watchdog)
                except queue.Empty:
                    # detected, not silent: one strike per watchdog
                    # interval, then keep waiting (the producer may
                    # recover — a crash surfaces as its exception entry)
                    self._record_stall_detected(
                        time.monotonic() - t0, expected)
                    continue
                e_token, e_key, e_payload, e_idx, e_stalled = entry
                with self._lock:
                    token = self._token
                if e_token != token or e_key != expected:
                    continue  # stale speculation: drop
                payload, idx, stalled = e_payload, e_idx, e_stalled
                break
        if isinstance(payload, BaseException):
            raise payload
        wait = time.monotonic() - t0
        self._note_consumed(expected, idx, wait, stalled)
        with self._lock:
            self._epoch, self._step = self.index.advance(
                expected[0], expected[1])
        self._set_cursor_gauges()
        out = self._place(payload)
        return out[0] if len(out) == 1 else out

    def _place(self, payload) -> tuple:
        """The consumed payload as the step loop's tensors: host tensors
        as they are; a staged card batch handed over to the current
        stream (:meth:`_CardFeed.hand_over`)."""
        if self._feed is None:
            return tuple(payload)
        return self._feed.hand_over(*payload)

    def _note_consumed(self, key, idx, wait: float, stalled: float
                       ) -> None:
        self.last_key = (key[0], key[1], key[2], self._generation)
        self.last_indices = idx
        self.last_wait = wait
        now = time.monotonic()
        from horovod_tpu_torch.observability import straggler as _straggler

        multi = basics.is_initialized() and basics.process_size() > 1
        if multi:
            # this process's own pipeline: measured wait attributes to it
            _straggler.note_data_wait(basics.process_rank(), wait)
        elif stalled > 0:
            # a world of one: the chaos charge names the simulated victim
            # (the rank_slow convention) — without a charge there is no
            # per-rank skew to attribute
            from horovod_tpu_torch.resilience import chaos as _chaos

            charge = _chaos.data_stall()
            if charge is not None:
                _straggler.note_data_wait(
                    charge[0], max(wait, stalled))
        else:
            # a batch produced without a stall CLEARS previously noted
            # waits — a disarmed chaos charge must not leave a permanent
            # false input-bound straggler behind
            for r, w in _straggler.data_waits().items():
                if w > 0:
                    _straggler.note_data_wait(r, 0.0)
        if not _metrics.enabled():
            self._last_consume_t = now
            return
        _metrics.histogram(
            "data_wait_seconds",
            help="time the step loop waited on the input pipeline per "
                 "batch",
        ).observe(wait)
        _metrics.gauge(
            "data_wait_seconds_recent",
            help="input-pipeline wait of the most recent batch (the "
                 "input-bound attribution signal on /fleet)",
        ).set(wait)
        _metrics.counter(
            "input_batches", help="batches consumed by the step loop",
        ).inc()
        if self._last_consume_t is not None:
            dt = now - self._last_consume_t
            per_rank = self.index.batch_size // self._size
            if dt > 0:
                _metrics.gauge(
                    "input_examples_per_second",
                    help="examples/s delivered by the input pipeline "
                         "over the last inter-batch interval",
                ).set(per_rank / dt)
        self._last_consume_t = now

    def _set_cursor_gauges(self) -> None:
        if not _metrics.enabled():
            return
        with self._lock:
            e, s = self._epoch, self._step
        _metrics.gauge(
            "data_cursor_epoch",
            help="epoch of the next batch the loader will draw",
        ).set(e)
        _metrics.gauge(
            "data_cursor_step",
            help="step-in-epoch of the next batch the loader will draw",
        ).set(s)

    def close(self) -> None:
        """Stop the prefetch thread and unregister (tests / teardown).
        Only a loader that registered itself unregisters — and only
        while it still owns the name (a replacement registration, e.g. a
        cold restart's fresh loader, must not be torn out of the
        registry by the old instance's teardown)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._registered and \
                _sampler.active_loaders().get(self.name) is self:
            _sampler.unregister(self.name)

    def __del__(self):  # pragma: no cover - best effort
        # only the flag flip: joining (or logging) from a finalizer at
        # interpreter teardown is unsafe; the producer is a daemon thread
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
