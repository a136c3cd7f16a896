"""Global sample index and the loaders' cursor registry.

A copy of ``horovod_tpu/data/sampler.py`` (stdlib and numpy only), kept
in the port so that :mod:`horovod_tpu_torch.checkpoint` can carry the
input pipeline's ``(epoch, step)`` cursors without importing the JAX
package:

- :func:`mix_seed` — ``(seed, epoch, replay_epoch)`` mixed through a real
  hash before seeding the permutation RNG (``seed + epoch`` would make
  ``(seed=0, epoch=1)`` and ``(seed=1, epoch=0)`` the same stream);
- :class:`GlobalSampleIndex` — every batch's member indices are a pure
  function of ``(seed, epoch, step, replay_epoch)``, a rank's share a
  pure function of ``(rank, world_size)`` on top, so the global batch
  never depends on the world size;
- a **cursor registry** — loaders register here so their ``(epoch,
  step)`` cursors ride every checkpoint
  (:func:`horovod_tpu_torch.checkpoint.attach_data_state`); a cursor
  restored before its loader registers is kept pending and applied at
  :func:`register`.

The loaders are :mod:`horovod_tpu_torch.data.loader`'s.
"""

from __future__ import annotations

import hashlib
import logging
import struct
import threading
import weakref
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "mix_seed",
    "GlobalSampleIndex",
    "register",
    "unregister",
    "export_state",
    "restore_state",
    "generation_fence",
    "active_loaders",
    "reset",
]

logger = logging.getLogger("horovod_tpu_torch.data")


def mix_seed(seed: int, epoch: int, replay_epoch: int = 0) -> int:
    """Mix ``(seed, epoch, replay_epoch)`` into one 32-bit RNG seed through
    a real hash (blake2b), so no two distinct triples collide the way
    ``seed + epoch`` does: ``(seed=0, epoch=1)`` and ``(seed=1, epoch=0)``
    must be *different* permutations, and every ``replay_epoch`` bump must
    reshuffle the epoch it replays."""
    h = hashlib.blake2b(
        struct.pack("<qqq", int(seed), int(epoch), int(replay_epoch)),
        digest_size=8,
        person=b"hvd-data",
    ).digest()
    return int.from_bytes(h[:4], "little")


class GlobalSampleIndex:
    """Pure-function batch selection over ``n`` examples.

    ``batch_indices(epoch, step)`` is the global batch — a contiguous
    window of the epoch's :func:`mix_seed`-seeded permutation — and
    ``rank_indices(epoch, step, rank, size)`` is one rank's strided slice
    of it. Neither touches any state, so checkpoint resume, rollback
    replay, an elastic resize, and a cold restart all reproduce (or, with
    a bumped ``replay_epoch``, intentionally diverge) the exact stream.

    ``drop_last`` semantics are fixed at True (``steps_per_epoch = n //
    batch_size``): a ragged tail batch would retrace the compiled step,
    and exactly-once accounting is over the *selected* window — the
    permutation makes the dropped tail a different sample set each epoch,
    so no example is starved across epochs.
    """

    def __init__(self, n: int, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if n < batch_size:
            raise ValueError(
                f"dataset of {n} rows cannot fill one batch of "
                f"{batch_size}"
            )
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.steps_per_epoch = self.n // self.batch_size
        # one-entry order cache: sequential iteration re-derives the same
        # epoch's permutation steps_per_epoch times otherwise
        self._cached: Optional[Tuple[Tuple[int, int], np.ndarray]] = None

    def epoch_order(self, epoch: int, replay_epoch: int = 0) -> np.ndarray:
        """The epoch's full permutation (or ``arange`` unshuffled)."""
        key = (int(epoch), int(replay_epoch))
        # single atomic read: the prefetch producer and the step loop
        # share this index, and a two-step read could hand one caller
        # the OTHER key's permutation mid-swap
        cached = self._cached
        if cached is not None and cached[0] == key:
            return cached[1]
        if self.shuffle:
            order = np.random.RandomState(
                mix_seed(self.seed, epoch, replay_epoch)
            ).permutation(self.n)
        else:
            order = np.arange(self.n)
        self._cached = (key, order)
        return order

    def batch_indices(self, epoch: int, step: int,
                      replay_epoch: int = 0) -> np.ndarray:
        """The global batch at ``(epoch, step)`` — world-size independent."""
        if not 0 <= step < self.steps_per_epoch:
            raise IndexError(
                f"step {step} out of range [0, {self.steps_per_epoch})"
            )
        order = self.epoch_order(epoch, replay_epoch)
        return order[step * self.batch_size:(step + 1) * self.batch_size]

    def rank_indices(self, epoch: int, step: int, rank: int, size: int,
                     replay_epoch: int = 0) -> np.ndarray:
        """Rank ``rank``-of-``size``'s strided slice of the global batch.
        The slices partition the batch exactly (``batch_size`` must divide
        by ``size`` — static even sharding, same rule the loader's
        device_put enforces), so the union over any rank set that covers
        ``range(size)`` is the global batch — the exactly-once invariant
        an elastic repartition leans on."""
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"invalid rank {rank} of size {size}")
        if self.batch_size % size != 0:
            raise ValueError(
                f"batch size {self.batch_size} must divide by world size "
                f"{size} (static even sharding)"
            )
        return self.batch_indices(epoch, step, replay_epoch)[rank::size]

    def stream(self, epoch: int = 0, step: int = 0, *, num_steps: int,
               replay_epoch: int = 0
               ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield ``(epoch, step, batch_indices)`` for ``num_steps`` cursor
        advances from ``(epoch, step)`` — the reference stream tests pin
        resumed/replayed loaders against."""
        e, s = int(epoch), int(step)
        for _ in range(int(num_steps)):
            yield e, s, self.batch_indices(e, s, replay_epoch)
            s += 1
            if s >= self.steps_per_epoch:
                s, e = 0, e + 1

    def advance(self, epoch: int, step: int) -> Tuple[int, int]:
        """The cursor after consuming ``(epoch, step)``."""
        step = int(step) + 1
        if step >= self.steps_per_epoch:
            return int(epoch) + 1, 0
        return int(epoch), step


# --------------------------------------------------------------- registry
#
# Loaders register here (by name) so the resilience layers can move every
# cursor without holding loader references: checkpoint.save attaches
# `export_state()` to its payload, resume/rollback paths call
# `restore_state()`, and the elastic coordinator's resize calls
# `generation_fence()` beside the mesh re-formation.

_reg_lock = threading.Lock()
_registry: "weakref.WeakValueDictionary[str, object]" = (
    weakref.WeakValueDictionary()
)
#: cursors restored before their loader existed (cold restart: the
#: checkpoint is read before user code rebuilds its loaders) — applied at
#: register() time
_pending: Dict[str, dict] = {}


def register(loader, name: Optional[str] = None) -> str:
    """Register `loader` (anything with ``state()``/``restore(state)`` and
    ``on_generation(generation, world_size)``) under `name` (default: its
    ``.name``). Re-registering a name replaces the old binding — a cold
    restart's fresh loader takes over its predecessor's cursor. Returns
    the name; a cursor restored before registration is applied here."""
    name = name or getattr(loader, "name", None)
    if not name:
        raise ValueError("loader needs a name to register")
    with _reg_lock:
        _registry[name] = loader
        cursor = _pending.pop(name, None)
    if cursor is not None:
        loader.restore(cursor)
    return name


def unregister(name: str) -> None:
    with _reg_lock:
        _registry.pop(name, None)
        _pending.pop(name, None)


def active_loaders() -> Dict[str, object]:
    with _reg_lock:
        return dict(_registry)


def export_state() -> Dict[str, dict]:
    """``{name: cursor}`` for every registered loader — what rides the
    checkpoint payload and the elastic coordinator's committed snapshot. Empty
    when no loader is registered (callers skip attaching it)."""
    out = {}
    for name, loader in active_loaders().items():
        try:
            out[name] = dict(loader.state())
        except Exception as e:
            logger.warning("loader %r cursor export failed: %s", name, e)
    return out


def restore_state(cursors: Optional[Dict[str, dict]]) -> None:
    """Apply exported cursors to the registered loaders. A cursor whose
    loader is not registered yet is kept pending and applied when it
    registers (the cold-restart order: restore the checkpoint first,
    build the loaders after)."""
    if not cursors:
        return
    for name, cursor in cursors.items():
        loader = active_loaders().get(name)
        if loader is None:
            with _reg_lock:
                _pending[name] = dict(cursor)
            continue
        loader.restore(cursor)


def generation_fence(generation: int, world_size: Optional[int] = None
                     ) -> None:
    """Re-anchor every registered loader on elastic generation
    `generation` (world size `world_size` when known) — called by the
    elastic coordinator beside the mesh re-formation, so the loader's
    partitioning identity can never straddle two membership epochs.
    Best-effort per loader: the data plane must never fail a resize."""
    for name, loader in active_loaders().items():
        try:
            loader.on_generation(int(generation), world_size)
        except Exception as e:
            logger.warning(
                "loader %r generation fence failed: %s", name, e)


def reset() -> None:
    """Forget every registration and pending cursor (tests)."""
    with _reg_lock:
        _registry.clear()
        _pending.clear()
