"""Training-loop callbacks.

Counterpart of ``horovod_tpu/callbacks.py``: the hook surface
(:class:`Callback`, the Keras-named ``on_train_begin`` ...
``on_batch_end``), the dispatcher a loop drives (:class:`CallbackList`,
what :func:`horovod_tpu_torch.resilience.run` fires),
:class:`BroadcastGlobalVariablesCallback`, :class:`MetricAverageCallback`,
:class:`LearningRateScheduleCallback`, :class:`LearningRateWarmupCallback`,
:class:`MetricsCallback`, :class:`HealthCallback` and
:class:`PublishCallback`, and the optimizer-state helpers :func:`apply_lr`
and :func:`scale_momentum`. The JAX module imports JAX at module level, so
these are ported, not the file.

A callback is wired to any *trainer* object via
:meth:`Callback.set_trainer`; the hooks' names and meaning are Keras's.
The trainer contract is attribute-based: ``trainer.params`` (a dict of
tensors, broadcast in place), ``trainer.opt_state`` (a state of
:mod:`horovod_tpu_torch.optim`) and ``trainer.lr`` (a float the LR
callbacks set; build the optimizer with
:func:`horovod_tpu_torch.optim.inject_hyperparams` and push it into the
state with :func:`apply_lr` each step). stdlib-only at import.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Optional


class Callback:
    """Base callback (hook surface of ``keras.callbacks.Callback`` as used by
    the reference in ``_keras/callbacks.py``)."""

    trainer: Any = None

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass


class CallbackList:
    """Dispatch helper a fit loop drives (Keras ``CallbackList`` analog)."""

    def __init__(self, callbacks: List[Callback], trainer=None):
        self.callbacks = list(callbacks)
        if trainer is not None:
            for cb in self.callbacks:
                cb.set_trainer(trainer)

    def __iter__(self):
        return iter(self.callbacks)

    def _fire(self, hook, *args):
        for cb in self.callbacks:
            getattr(cb, hook)(*args)

    def on_train_begin(self, logs=None):
        self._fire("on_train_begin", logs)

    def on_train_end(self, logs=None):
        self._fire("on_train_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._fire("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._fire("on_epoch_end", epoch, logs)

    def on_batch_begin(self, batch, logs=None):
        self._fire("on_batch_begin", batch, logs)

    def on_batch_end(self, batch, logs=None):
        self._fire("on_batch_end", batch, logs)


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast initial parameters and optimizer state from `root_rank` so
    all ranks start identically (reference ``_keras/callbacks.py:22-46``).
    The parameters are overwritten in place
    (:func:`~horovod_tpu_torch.optim.broadcast_parameters`: views write
    through to the model); the optimizer state goes through
    :func:`~horovod_tpu_torch.optim.broadcast_optimizer_state`, which
    leaves ZeRO-1 rows alone (each rank's row is its own state)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        from horovod_tpu_torch.optim import (
            broadcast_optimizer_state, broadcast_parameters,
        )

        t = self.trainer
        if getattr(t, "params", None) is not None:
            t.params = broadcast_parameters(t.params, self.root_rank)
        if getattr(t, "opt_state", None) is not None:
            t.opt_state = broadcast_optimizer_state(
                t.opt_state, self.root_rank)
        self.broadcast_done = True

    # the reference broadcasts after the first batch (variables exist by
    # then); the port's parameters exist up-front, so train_begin works
    def on_train_begin(self, logs=None):
        self.on_batch_end(0, logs)


class MetricAverageCallback(Callback):
    """Average epoch metrics over ranks before they are logged or
    checkpointed (reference ``_keras/callbacks.py:48-87``): each numeric
    (or 0-d tensor) entry of ``logs`` becomes its mean over the world,
    reduced in float64 on this process's device."""

    def _average(self, logs: Optional[Dict[str, Any]]):
        if not logs:
            return
        import numpy as np
        import torch

        from horovod_tpu_torch import basics
        from horovod_tpu_torch.ops import collective as C

        for k, v in list(logs.items()):
            if isinstance(v, (int, float, np.floating, np.integer)) or (
                hasattr(v, "shape") and tuple(v.shape) == ()
            ):
                t = torch.full((), float(v), dtype=torch.float64,
                               device=basics.device())
                logs[k] = float(C.allreduce(t, C.Average))

    def on_epoch_end(self, epoch, logs=None):
        self._average(logs)


class LearningRateScheduleCallback(Callback):
    """Multiply the base LR by ``multiplier(epoch)`` (or a constant) within
    ``[start_epoch, end_epoch)`` (reference ``_keras/callbacks.py:90-152``).

    With ``staircase=True`` the LR changes per epoch; otherwise per batch,
    using fractional epochs (requires ``steps_per_epoch``). When the
    multiplier changes and ``momentum_correction`` is set, SGD-momentum
    buffers are rescaled by ``new_lr/old_lr`` so the effective update
    magnitude is preserved across the LR jump (reference
    ``_keras/callbacks.py:118-136``)."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 initial_lr: Optional[float] = None):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.initial_lr = initial_lr
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        self._last_lr = None
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_window(self, epoch) -> bool:
        return epoch >= self.start_epoch and (
            self.end_epoch is None or epoch < self.end_epoch
        )

    def _resolve_initial_lr(self):
        if self.initial_lr is None:
            self.initial_lr = getattr(self.trainer, "lr", None)
        if self.initial_lr is None:
            raise ValueError(
                "initial_lr not given and trainer has no .lr attribute"
            )

    def _set_lr(self, lr: float):
        old = self._last_lr
        self.trainer.lr = lr
        if (
            self.momentum_correction
            and old
            and old > 0
            and not math.isclose(lr, old)
        ):
            scale_momentum(self.trainer, lr / old)
        self._last_lr = lr

    def on_train_begin(self, logs=None):
        self._resolve_initial_lr()
        if self._last_lr is None:
            self._last_lr = self.initial_lr

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_window(epoch):
            self._resolve_initial_lr()
            self._set_lr(self.initial_lr * self.multiplier(epoch))

    def on_batch_begin(self, batch, logs=None):
        if self.staircase or not self._in_window(self.current_epoch):
            return
        if self.steps_per_epoch is None:
            raise ValueError(
                "steps_per_epoch is required with staircase=False "
                "(reference _keras/callbacks.py:108-116)"
            )
        self._resolve_initial_lr()
        epoch = self.current_epoch + float(batch) / self.steps_per_epoch
        self._set_lr(self.initial_lr * self.multiplier(epoch))


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Ramp the LR from ``initial_lr / size`` to ``initial_lr`` over the first
    ``warmup_epochs`` — the "gradual warmup" of Goyal et al. the reference
    implements (``_keras/callbacks.py:155-192``):

        lr = initial_lr * (epoch * (size - 1) / warmup_epochs + 1) / size
    """

    def __init__(self, warmup_epochs: int = 5, momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0,
                 initial_lr: Optional[float] = None):
        from horovod_tpu_torch import basics

        def multiplier(epoch):
            if warmup_epochs > 0:
                epoch = min(epoch, warmup_epochs)
                return (
                    epoch * (basics.size() - 1) / warmup_epochs + 1
                ) / basics.size()
            return 1.0

        super().__init__(
            multiplier, start_epoch=0, end_epoch=warmup_epochs + 1,
            staircase=False, momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch, initial_lr=initial_lr,
        )
        self.verbose = verbose
        self.warmup_epochs = warmup_epochs

    def on_epoch_end(self, epoch, logs=None):
        if epoch == self.warmup_epochs - 1 and self.verbose:
            print(
                f"Epoch {epoch + 1}: finished gradual learning rate warmup to "
                f"{self.trainer.lr}."
            )


class MetricsCallback(Callback):
    """Log (or dump) the metrics-registry snapshot every ``every_n_steps``
    batches, and record the fit loop's own cadence under names of its own
    (``fit_batch_seconds`` histogram, ``fit_batches`` counter,
    ``fit_examples`` when the trainer has ``global_batch_size``), apart
    from :class:`~horovod_tpu_torch.training.InstrumentedStep`'s
    ``train_*``.

    Args:
      every_n_steps: emit cadence in batches (0 = only at train end).
      dump_path: when set, write the JSON snapshot there (atomic replace)
        instead of printing the summary.
      printer: summary sink (default ``print``); only rank 0 emits.
    """

    def __init__(self, every_n_steps: int = 100, dump_path: str = None,
                 printer: Callable[[str], Any] = print):
        self.every_n_steps = every_n_steps
        self.dump_path = dump_path
        self.printer = printer
        self._seen = 0
        self._t0 = None

    def _emit(self):
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.observability import exporters

        if basics.is_initialized() and basics.process_rank() != 0:
            return
        exporters.emit_snapshot(
            self.dump_path, self.printer,
            header=f"horovod_tpu_torch metrics @ batch {self._seen}:\n")

    def on_batch_begin(self, batch, logs=None):
        import time

        self._t0 = time.perf_counter()

    def on_batch_end(self, batch, logs=None):
        import time

        from horovod_tpu_torch.observability import metrics

        self._seen += 1
        if metrics.enabled():
            if self._t0 is not None:
                metrics.histogram(
                    "fit_batch_seconds", help="fit-loop batch wall time"
                ).observe(time.perf_counter() - self._t0)
            metrics.counter("fit_batches", help="fit batches run").inc()
            examples = getattr(self.trainer, "global_batch_size", None)
            if examples:
                metrics.counter(
                    "fit_examples", help="examples seen by the fit loop"
                ).inc(examples)
        if self.every_n_steps and self._seen % self.every_n_steps == 0:
            self._emit()

    def on_train_end(self, logs=None):
        self._emit()


class HealthCallback(Callback):
    """Surface the resilience health state machine inside the fit loop.

    Every batch end feeds a progress beat into the monitor (a completed
    batch *is* forward progress — this walks SUSPECT/DEGRADED back toward
    HEALTHY) and, on a state change, logs the transition with its reason.
    With ``abort_on`` set (default ``FATAL``), reaching that severity raises
    ``RuntimeError`` at the batch boundary so a poisoned run stops at a
    clean step edge instead of hanging in the next collective.
    """

    def __init__(self, printer: Callable[[str], Any] = None,
                 abort_on=None):
        from horovod_tpu_torch.resilience import health as _health

        self._health = _health
        self.printer = printer
        self.abort_on = (
            _health.HealthState.FATAL if abort_on is None else abort_on
        )
        self._last = _health.health_state()

    def _say(self, msg: str) -> None:
        if self.printer is not None:
            self.printer(msg)
        else:
            logging.getLogger("horovod_tpu_torch.resilience").warning(
                "%s", msg)

    def on_batch_end(self, batch, logs=None):
        # read (and possibly abort on) the state the batch produced BEFORE
        # feeding the progress beat — beat() walks SUSPECT back to HEALTHY,
        # which would make abort_on=SUSPECT unreachable
        state = self._health.health_state()
        if state != self._last:
            self._say(
                f"health: {self._last.name} -> {state.name} at batch "
                f"{batch} ({self._health.MONITOR.reason()})"
            )
            self._last = state
        if state >= self.abort_on:
            raise RuntimeError(
                f"health state {state.name} reached at batch {batch}: "
                f"{self._health.MONITOR.reason()}"
            )
        self._health.beat()


class PublishCallback(Callback):
    """Stream consolidated weights to a serving fleet from inside a fit
    loop: every `every` completed batches (and once more at train end),
    rank 0 publishes ``trainer.params`` through a
    :class:`horovod_tpu_torch.serving.WeightPublisher`. Publication
    failures are logged and swallowed — the staleness contract on the
    subscriber side covers the gap; training never dies because the
    serving KV is down.

    For ``resilience.run``/``elastic.run`` loops use the
    ``publisher=``/``publish_every=`` arguments of
    :class:`~horovod_tpu_torch.resilience.elastic.ElasticRun` instead
    (they publish the committed, reshard-safe snapshot)."""

    def __init__(self, publisher, every: int = 100):
        if every < 1:
            raise ValueError(f"publish cadence must be >= 1, got {every}")
        self.publisher = publisher
        self.every = every
        self._seen = 0
        self._published_at = -1

    def _publish(self, batch: int) -> None:
        from horovod_tpu_torch import basics

        if basics.is_initialized() and basics.process_rank() != 0:
            return  # one writer, same as checkpointing
        params = getattr(self.trainer, "params", None)
        if params is None:
            return
        from horovod_tpu_torch import serving as _serving

        try:
            self.publisher.publish({"params": params}, batch)
            self._published_at = batch
        except _serving.PublishError as e:
            logging.getLogger("horovod_tpu_torch.serving").warning(
                "weight publication at batch %d failed: %s", batch, e)

    def on_batch_end(self, batch, logs=None):
        self._seen = batch + 1
        if (batch + 1) % self.every == 0:
            self._publish(batch + 1)

    def on_train_end(self, logs=None):
        # the final weights are the ones a serving fleet actually wants
        if self._seen and self._published_at != self._seen:
            self._publish(self._seen)


# --------------------------------------------------------------------------
# optimizer states


def _walk(x, fn):
    """``fn`` on every dict of a state tree (dicts, lists and tuples,
    named ones included, descended into)."""
    if isinstance(x, dict):
        fn(x)
        for v in x.values():
            _walk(v, fn)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _walk(v, fn)


def apply_lr(opt_state, lr: float):
    """Push a callback-adjusted LR into an
    :func:`~horovod_tpu_torch.optim.inject_hyperparams` state, wherever it
    sits (under a ZeRO-1 state's ``inner``, a guard's, ...); returns the
    state, updated in place. Use in the fit loop each step:
    ``opt_state = apply_lr(opt_state, trainer.lr)``."""
    found = []

    def set_lr(d):
        hp = d.get("hyperparams")
        if "inner_state" in d and isinstance(hp, dict) \
                and "learning_rate" in hp:
            hp["learning_rate"] = float(lr)
            found.append(d)

    _walk(opt_state, set_lr)
    if not found:
        raise ValueError(
            "opt_state has no injected 'learning_rate' hyperparameter; build "
            "the optimizer with optim.inject_hyperparams(optim.sgd)(...)"
        )
    return opt_state


def scale_momentum(trainer, factor: float):
    """Rescale SGD momentum buffers by `factor` (= new_lr/old_lr) — the
    reference's momentum-correction trick applied to
    :func:`~horovod_tpu_torch.optim.sgd`'s ``trace`` (reference
    ``_keras/callbacks.py:118-136``), in the buffers' dtype."""
    opt_state = getattr(trainer, "opt_state", None)
    if opt_state is None:
        return
    from horovod_tpu_torch.ops import kernels as _k

    def rescale(d):
        if set(d) == {"trace"} and isinstance(d["trace"], dict):
            d["trace"] = {k: t * _k._adam_scalar(factor, t)
                          for k, t in d["trace"].items()}

    _walk(opt_state, rescale)
    trainer.opt_state = opt_state
