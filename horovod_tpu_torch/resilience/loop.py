"""Preemption-aware training loop: drain, checkpoint, exit resumable.

Counterpart of ``horovod_tpu/resilience/loop.py``. Preemptible capacity
takes a job away with a SIGTERM and a short grace window; :func:`run`
turns that into a classified, resumable outcome:

1. SIGTERM/SIGINT handlers (installed for the duration of the loop, on the
   main thread only, previous handlers restored) set a flag; the loop
   checks it at every step boundary.
2. On preemption the loop *drains*: it waits for the native core's queued
   collectives (bounded by ``HOROVOD_PREEMPT_DRAIN_TIMEOUT``), then
   synchronizes the CUDA devices the state's tensors live on, so no kernel
   or collective is cut mid-flight.
3. It writes an **emergency checkpoint** via ``checkpoint.save`` (wrapped as
   ``{"step": N, "state": ...}``) and raises :class:`Preempted` — a
   ``SystemExit`` subclass whose code is :data:`RESUMABLE_EXIT_CODE` (75 =
   BSD ``EX_TEMPFAIL``), so an unguarded training script exits with the
   code launchers read as "preempted, retry" rather than "failed".
4. On the next launch, :func:`run` (or :func:`resume_state`) restores the
   newest *valid* checkpoint and continues from the recorded step.

A process holds its own rank's state, so the port differs from the JAX
package's single controller in two places. The emergency checkpoint of a
sharded state needs every ZeRO-1 row or ZeRO-3 shard
(``checkpoint._gather_sharded``, a collective), and a SIGTERM may reach
only some ranks: so each preempted rank first posts
``preempt/<gen>/<step>/<rank>`` on the world's rendezvous store and
polls until every rank has posted, for at most
``HOROVOD_PREEMPT_DRAIN_TIMEOUT`` seconds (:func:`_agree_to_gather`).
When all posted, the rows are gathered and saved as before; when not,
no rank enters the gather, the writer keeps the newest valid checkpoint
(the skip is logged and counted in
``resilience_emergency_checkpoint_unagreed``), and every preempted rank
still exits 75. A peer that was not preempted blocks in its next
collective, as under the JAX driver. :func:`resume_state` hands back this
rank's state (:func:`~horovod_tpu_torch.checkpoint.rank_state`: the
optimizer state re-packed for the world, the arrays as tensors on its
device). The drain flushes the flight ring and the timeline, then every
registered weight publisher (:func:`horovod_tpu_torch.serving.
flush_on_preempt`: a final generation for the serving fleet, inside the
drain budget), before the checkpoint.

This module is stdlib-importable; the data plane is imported inside the
functions that need it.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Iterable, Optional, Tuple

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.resilience import chaos as _chaos, health as _health

__all__ = ["RESUMABLE_EXIT_CODE", "Preempted", "run", "resume_state"]

logger = logging.getLogger("horovod_tpu_torch.resilience")

#: BSD EX_TEMPFAIL: "temporary failure, retry later" — distinct from every
#: code the stack otherwise produces (0 ok, 1/2 errors, 143 SIGTERM-kill),
#: so supervisors can tell "preempted, resume me" from "failed, debug me".
RESUMABLE_EXIT_CODE = 75

#: seconds to wait for the native core's queued collectives while draining
DRAIN_TIMEOUT_S = float(os.environ.get("HOROVOD_PREEMPT_DRAIN_TIMEOUT", "30"))


class Preempted(SystemExit):
    """Raised by :func:`run` after a preemption was drained and emergency-
    checkpointed. Subclasses ``SystemExit`` with :data:`RESUMABLE_EXIT_CODE`
    so an unguarded ``python train.py`` exits resumable; catch it to handle
    preemption in-process instead."""

    def __init__(self, step: int, checkpoint_path: Optional[str] = None,
                 signum: Optional[int] = None):
        super().__init__(RESUMABLE_EXIT_CODE)
        self.step = step
        self.checkpoint_path = checkpoint_path
        self.signum = signum

    def __str__(self):
        sig = (
            f" (signal {self.signum})" if self.signum is not None else ""
        )
        ckpt = (
            f"; emergency checkpoint at {self.checkpoint_path}"
            if self.checkpoint_path
            else "; no emergency checkpoint from this rank"
        )
        return f"preempted at step {self.step}{sig}{ckpt}"


def resume_state(checkpoint_dir: str) -> Optional[Tuple[int, Any]]:
    """``(next_step, state)`` from the newest valid checkpoint under
    `checkpoint_dir` written by :func:`run`, or None when there is none.
    Corrupt/incomplete step directories are skipped (``checkpoint.restore``
    falls back). Collective when ``process_size() > 1``: the root's
    filesystem decides the resume step for every rank, so a rank whose
    local disk lacks the checkpoint still joins the restore broadcast
    instead of silently starting fresh while its peers resume. The state
    comes back as this rank holds it (:func:`~horovod_tpu_torch.checkpoint.
    rank_state`)."""
    from horovod_tpu_torch import basics, checkpoint

    multi = basics.is_initialized() and basics.process_size() > 1
    # only the broadcast root pays the CRC sweep of latest_step — every
    # other rank's answer would be discarded by the broadcast anyway
    step = (
        checkpoint.latest_step(checkpoint_dir)
        if not multi or basics.process_rank() == 0
        else None
    )
    if multi:
        from horovod_tpu_torch.ops import collective as C

        step = C.broadcast_object(step, 0)
    if step is None:
        return None
    payload = checkpoint.restore(checkpoint_dir, step)
    # any input-pipeline cursor riding the payload is restored into the
    # loader registry here (pending until the loader registers on a cold
    # restart), so the resumed run draws the exact remaining sample stream
    payload = checkpoint.detach_data_state(payload)
    if isinstance(payload, dict) and "step" in payload and "state" in payload:
        return int(payload["step"]), checkpoint.rank_state(payload["state"])
    # a checkpoint not written by run(): resume after its step number
    return step, checkpoint.rank_state(payload)


def _agree_to_gather(step: int) -> bool:
    """Whether every rank of the world was preempted at `step`: this rank
    posts ``preempt/<gen>/<step>/<rank>`` on the world's rendezvous store
    (``gen`` is the elastic generation the straggler keys carry) and polls
    with ``check`` until every rank's key is there, for at most
    :data:`DRAIN_TIMEOUT_S`. Enters no collective: a peer that was not
    preempted never posts, and the caller skips the gather instead of
    blocking in it."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.observability import straggler as _straggler

    if not basics.is_initialized() or basics.process_size() == 1:
        return True
    store = basics._state.store
    prefix = f"preempt/{_straggler.generation()}/{step}/"
    store.set(prefix + str(basics.process_rank()), b"1")
    keys = [prefix + str(r) for r in range(basics.process_size())]
    deadline = time.monotonic() + DRAIN_TIMEOUT_S
    pause = 1e-3
    while not store.check(keys):
        if time.monotonic() >= deadline:
            return False
        time.sleep(pause)
        pause = min(2 * pause, 0.05)
    return True


def _drain(state: Any, timeout_s: float = DRAIN_TIMEOUT_S) -> None:
    """Quiesce the data plane before checkpointing: wait out the native
    core's queued collectives (bounded), then synchronize every CUDA
    device the state's tensors live on, so the snapshot sees completed
    values, not in-flight buffers."""
    import torch

    from horovod_tpu_torch import basics, pytree

    core = basics._state.core
    if core is not None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and core.pending_count():
            time.sleep(0.01)
    leaves, _ = pytree.flatten(state)
    for dev in {x.device for x in leaves
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


def run(
    step_fn: Callable[[Any, int], Any],
    state: Any,
    *,
    num_steps: int,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    start_step: Optional[int] = None,
    callbacks: Optional[Iterable] = None,
    signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
) -> Any:
    """Drive ``state = step_fn(state, i)`` for ``i in [start, num_steps)``
    with preemption awareness; returns the final state.

    - `checkpoint_dir`: enables resume (newest valid checkpoint is restored
      when `start_step` is None) and emergency checkpoints on preemption.
    - `checkpoint_every`: also checkpoint every N completed steps (0 = only
      on preemption).
    - `callbacks`: :class:`horovod_tpu_torch.callbacks.Callback` objects;
      the loop fires ``on_batch_begin/on_batch_end`` per step and
      ``on_train_begin/on_train_end`` around the run.
    - `signals`: which signals mean "preempted" (default SIGTERM + SIGINT).
      Handlers are only installable on the main thread; elsewhere the loop
      still runs, relying on ``HOROVOD_CHAOS`` or an external flag for
      preemption testing.

    On preemption: drain → emergency checkpoint → raise :class:`Preempted`
    (a ``SystemExit`` carrying :data:`RESUMABLE_EXIT_CODE`). The chaos
    harness (``HOROVOD_CHAOS=sigterm_at_step=K``) delivers a real SIGTERM
    to this process before step K so the whole path is testable in-process.
    """
    first = start_step or 0
    if checkpoint_dir and start_step is None:
        resumed = resume_state(checkpoint_dir)
        if resumed is not None:
            first, state = resumed
            logger.info("resuming from checkpoint at step %d", first)
            if _metrics.enabled():
                _metrics.counter(
                    "resilience_resumes",
                    help="runs resumed from a checkpoint",
                ).inc()

    flag = threading.Event()
    draining = threading.Event()
    received = {"signum": None, "extra": 0}

    def _on_signal(signum, frame):
        # Signal latch: the handler ONLY ever sets flags/counters. Once the
        # drain → emergency-checkpoint sequence has begun, a second SIGTERM
        # (impatient supervisors escalate) must neither re-enter the drain
        # path nor interrupt the in-progress checkpoint write — it is
        # recorded and the first preemption keeps its grace window. The
        # handlers stay installed until _preempt() has completed, so the
        # default action (terminate, truncating the staged npz before its
        # atomic rename) can never fire mid-write.
        if draining.is_set():
            received["extra"] += 1
            return
        received["signum"] = signum
        flag.set()

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in signals:
            try:
                previous[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):  # pragma: no cover
                pass

    from horovod_tpu_torch.callbacks import CallbackList

    cbs = CallbackList(list(callbacks or []))
    chaos_step = _chaos.sigterm_at_step() if _chaos.enabled() else None

    def _preempt(step: int) -> None:
        if draining.is_set():
            # non-reentrant: a second path into preemption (signal during
            # the final-step check, a callback raising) must not drain or
            # checkpoint again over the first pass's in-progress write
            raise Preempted(step, None, received["signum"])
        draining.set()
        drain_deadline = time.monotonic() + DRAIN_TIMEOUT_S
        _drain(state)
        # flush the observability record before the emergency checkpoint:
        # a supervisor's escalation to SIGKILL never reaches shutdown()
        try:
            from horovod_tpu_torch import basics as _basics
            from horovod_tpu_torch.observability import flight as _flight

            _flight.record("preempt", step=step)
            _flight.flush()
            _basics.flush_timeline()
        except Exception:
            logger.debug(
                "observability flush during drain failed", exc_info=True)
        # final weight publication (best-effort, inside the remaining drain
        # budget): a preempted trainer's subscribers get the last good
        # generation instead of a staleness gap the length of the restart.
        # Before the emergency checkpoint: the publish is bounded and
        # lossy-safe where the checkpoint is neither.
        try:
            from horovod_tpu_torch import serving as _serving

            if _serving.active_publishers():
                budget = max(0.5, drain_deadline - time.monotonic())
                flushed = _serving.flush_on_preempt(state, step, budget)
                if flushed:
                    logger.warning(
                        "flushed final weight publication from %d "
                        "publisher(s) before the emergency checkpoint",
                        flushed,
                    )
        except Exception:
            logger.warning(
                "final weight publication failed; continuing to the "
                "emergency checkpoint", exc_info=True,
            )
        path = None
        note = "(disabled)"
        state_finite = True
        agreed = True
        save_state = state
        if checkpoint_dir:
            # a live state carrying NaN/Inf must NOT become the emergency
            # checkpoint: writing it would displace the newest VALID
            # checkpoint as the resume target. ONE device→host snapshot
            # serves both the sweep and the save — the drain window races
            # a supervisor's kill deadline, so the state must not cross
            # the bus twice. The rows of a sharded state are gathered on
            # every rank first (the save needs them all), and only once
            # every rank has said it is preempted here: a peer that was
            # not would never join the gather. Only the WRITER then pays
            # the host copy: save() writes nothing elsewhere.
            from horovod_tpu_torch import checkpoint as _ckpt
            from horovod_tpu_torch.resilience import numerics as _numerics
            from horovod_tpu_torch.training import host_snapshot

            if _ckpt._holds_sharded(state):
                agreed = _agree_to_gather(step)
            if agreed:
                save_state = _ckpt._gather_sharded(state)
                if _ckpt._is_writer():
                    save_state = host_snapshot(save_state)
                    if _numerics.checkpoint_finite_check_enabled():
                        state_finite = _numerics.tree_finite(save_state)
        if checkpoint_dir and not agreed:
            note = "(skipped: not every rank was preempted at this step; " \
                   "newest valid checkpoint preserved)"
            from horovod_tpu_torch import checkpoint as _ckpt

            if _ckpt._is_writer():
                logger.error(
                    "emergency checkpoint at step %d skipped: not every "
                    "rank was preempted within %.3gs, so the sharded rows "
                    "cannot be gathered", step, DRAIN_TIMEOUT_S,
                )
                if _metrics.enabled():
                    _metrics.counter(
                        "resilience_emergency_checkpoint_unagreed",
                        help="emergency checkpoints skipped because not "
                             "every rank was preempted at the step",
                    ).inc()
        elif checkpoint_dir and not state_finite:
            note = "(skipped: live state is non-finite; newest valid " \
                   "checkpoint preserved)"
            logger.error(
                "emergency checkpoint at step %d skipped: the live state "
                "carries non-finite values", step,
            )
            if _metrics.enabled():
                _metrics.counter(
                    "resilience_emergency_checkpoint_skipped",
                    help="emergency checkpoints skipped because the live "
                         "state was non-finite",
                ).inc()
        elif checkpoint_dir:
            from horovod_tpu_torch import checkpoint

            # fence=False: on an asymmetric preemption the peers would
            # never join the save's status broadcast — the grace window
            # must not be spent deadlocked in a collective
            saved = checkpoint.save(
                checkpoint_dir, step,
                checkpoint.attach_data_state(
                    {"step": step, "state": save_state}),
                force=True, fence=False,
            )
            # save() only stages anything on the writer (rank 0); a
            # preempted non-root rank must not report — or count — a
            # checkpoint it never wrote
            if checkpoint._is_writer():
                path = saved
                note = path
                if _metrics.enabled():
                    _metrics.counter(
                        "resilience_emergency_checkpoints",
                        help="checkpoints written on preemption",
                    ).inc()
                    _metrics.gauge(
                        "resilience_last_checkpoint_step",
                        help="step of the most recent resilience checkpoint",
                    ).set(step)
            else:
                note = "(rank 0 is the writer)"
        if _metrics.enabled():
            _metrics.counter(
                "resilience_preemptions",
                help="preemption signals honored by the training loop",
            ).inc()
            if received["extra"]:
                _metrics.counter(
                    "resilience_extra_preempt_signals",
                    help="signals latched while draining/checkpointing",
                ).inc(received["extra"])
        if received["extra"]:
            logger.warning(
                "latched %d extra signal(s) during drain/checkpoint",
                received["extra"],
            )
        logger.warning(
            "preempted at step %d; emergency checkpoint: %s", step, note,
        )
        raise Preempted(step, path, received["signum"])

    try:
        cbs.on_train_begin()
        step = first
        for step in range(first, num_steps):
            if chaos_step is not None and step >= chaos_step:
                _chaos.consume_sigterm()
                chaos_step = None
                os.kill(os.getpid(), signal.SIGTERM)
                # the Python-level handler runs at the next bytecode
                # boundary; give it one explicit chance before the check
                time.sleep(0)
            if flag.is_set():
                _preempt(step)
            cbs.on_batch_begin(step)
            state = step_fn(state, step)
            _health.beat()
            cbs.on_batch_end(step)
            if (
                checkpoint_dir
                and checkpoint_every
                and (step + 1) % checkpoint_every == 0
                and step + 1 < num_steps
            ):
                from horovod_tpu_torch import checkpoint

                _drain(state)
                checkpoint.save(
                    checkpoint_dir, step + 1,
                    checkpoint.attach_data_state(
                        {"step": step + 1, "state": state}),
                    force=True,
                )
                if _metrics.enabled():
                    _metrics.gauge(
                        "resilience_last_checkpoint_step",
                        help="step of the most recent resilience checkpoint",
                    ).set(step + 1)
        if flag.is_set():
            # the signal landed during the final step: still checkpoint so
            # the restart is a no-op resume instead of a silent rerun
            _preempt(num_steps)
        cbs.on_train_end()
        return state
    finally:
        for sig, handler in previous.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
