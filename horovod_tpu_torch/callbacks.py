"""Training-loop callbacks.

Counterpart of ``horovod_tpu/callbacks.py``, as far as the port has it:
the hook surface (:class:`Callback`, the Keras-named ``on_train_begin``
... ``on_batch_end``), the dispatcher a loop drives
(:class:`CallbackList`, what :func:`horovod_tpu_torch.resilience.run`
fires), :class:`MetricsCallback`, :class:`HealthCallback` and
:class:`PublishCallback`. The JAX module imports JAX at module level, so
these classes are copied, not the file. The broadcast and learning-rate
callbacks wait for the launcher port (ROADMAP Queue A item 12).

A callback is wired to any *trainer* object via
:meth:`Callback.set_trainer`; the hooks' names and meaning are Keras's.
stdlib-only at import.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List


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
