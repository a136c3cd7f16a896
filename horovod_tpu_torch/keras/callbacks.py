"""Keras callbacks (counterpart of ``horovod_tpu/keras/callbacks.py``;
reference ``horovod/_keras/callbacks.py``):

- :class:`BroadcastGlobalVariablesCallback`: sync weights + optimizer
  state from root after the first batch (reference
  ``_keras/callbacks.py:22-46``).
- :class:`MetricAverageCallback`: average epoch metrics across ranks
  (reference ``_keras/callbacks.py:48-87``).
- :class:`LearningRateScheduleCallback`: multiply the LR by a (possibly
  epoch-dependent) factor over an epoch range (reference
  ``_keras/callbacks.py:90-160``).
- :class:`LearningRateWarmupCallback`: ramp the LR from lr/size to lr
  over the first epochs, the "Accurate Large Minibatch SGD" gradual
  warmup (reference ``_keras/callbacks.py:163-192``).
- :class:`MetricsCallback`: the port's metrics registry
  (:mod:`horovod_tpu_torch.observability`) at a fit loop's cadence.

Keras runs on its TensorFlow backend, as in the JAX package. Without
Keras (or TensorFlow) the module imports and the callbacks raise on
construction.
"""

from __future__ import annotations

import numpy as np

import horovod_tpu_torch.tensorflow as hvd
from horovod_tpu_torch.tensorflow.compression import tf

try:
    import keras
except ImportError:  # the Keras frontend is gated on its install
    keras = None


def require_keras():
    """Keras on its TensorFlow backend, or an error naming what is
    missing."""
    hvd.require_tf()
    if keras is None:
        raise ImportError("horovod_tpu_torch.keras needs Keras 3")
    if keras.backend.backend() != "tensorflow":
        raise ValueError(
            f"horovod_tpu_torch.keras runs Keras on its TensorFlow backend, "
            f"not {keras.backend.backend()!r} (set KERAS_BACKEND=tensorflow)")
    return keras


_Callback = keras.callbacks.Callback if keras is not None else object


class BroadcastGlobalVariablesCallback(_Callback):
    """Broadcast all variables from root rank at the start of training
    (reference ``_keras/callbacks.py:22-46``: fires once, after the first
    batch, so lazily-built optimizer slots exist on every rank)."""

    def __init__(self, root_rank: int = 0):
        require_keras()
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        if hvd.size() > 1:
            hvd.broadcast_variables(self.model.weights, self.root_rank)
            if getattr(self.model, "optimizer", None) is not None:
                hvd.broadcast_variables(
                    self.model.optimizer.variables, self.root_rank
                )
        self.broadcast_done = True


class MetricAverageCallback(_Callback):
    """Average epoch-end metrics over ranks before they reach other
    callbacks (checkpointers, LR schedulers, loggers): reference
    ``_keras/callbacks.py:48-87``. Order this callback before any
    consumer."""

    def __init__(self):
        require_keras()
        super().__init__()

    def on_epoch_end(self, epoch, logs=None):
        if logs is None or hvd.size() == 1:
            return
        for k, v in list(logs.items()):
            arr = np.asarray(v, dtype=np.float32)
            avg = np.asarray(hvd.allreduce(
                tf.convert_to_tensor(arr), hvd.Average, name=f"metric.{k}"
            ))
            logs[k] = float(avg) if np.ndim(v) == 0 else avg


class LearningRateScheduleCallback(_Callback):
    """Scale the optimizer LR by ``multiplier`` within ``[start_epoch,
    end_epoch)`` (reference ``_keras/callbacks.py:90-160``).
    ``multiplier`` may be a constant or a function of epoch; with
    ``staircase=False`` and ``steps_per_epoch`` set, the multiplier sees
    fractional epochs for smooth per-batch schedules.
    ``momentum_correction`` temporarily rescales momentum when the LR
    changes so the implied update velocity is preserved."""

    def __init__(self, multiplier, start_epoch: int = 0, end_epoch=None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch=None, initial_lr=None):
        require_keras()
        super().__init__()
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.initial_lr = initial_lr
        self.restore_momentum = None
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = None
        if not callable(multiplier):
            self.staircase = True
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _autodetect_steps_per_epoch(self):
        if self.steps_per_epoch is not None:
            return self.steps_per_epoch
        params = getattr(self, "params", None) or {}
        if params.get("steps"):
            return params["steps"]
        raise ValueError(
            "LearningRateScheduleCallback with staircase=False needs "
            "steps_per_epoch (could not autodetect from fit params)"
        )

    def _current_lr(self):
        return float(
            keras.ops.convert_to_numpy(self.model.optimizer.learning_rate)
        )

    def _set_lr(self, lr: float):
        self.model.optimizer.learning_rate = lr

    def _in_range(self, epoch) -> bool:
        return epoch >= self.start_epoch and (
            self.end_epoch is None or epoch < self.end_epoch
        )

    def on_train_begin(self, logs=None):
        if self.initial_lr is None:
            self.initial_lr = self._current_lr()
        if not self.staircase and self.steps_per_epoch is None:
            self.steps_per_epoch = self._autodetect_steps_per_epoch()

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            self._adjust_lr(epoch)

    def on_batch_begin(self, batch, logs=None):
        if not self.staircase and self._in_range(self.current_epoch):
            epoch = self.current_epoch + float(batch) / self.steps_per_epoch
            self._adjust_lr(epoch)

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            # log the LR keras-style so downstream callbacks see it
            logs["lr"] = self._current_lr()

    def _adjust_lr(self, epoch):
        old_lr = self._current_lr()
        new_lr = self.initial_lr * self.multiplier(epoch)
        self._set_lr(new_lr)
        opt = getattr(self.model, "optimizer", None)
        if (self.momentum_correction and opt is not None
                and isinstance(getattr(opt, "momentum", None),
                               keras.Variable)
                and old_lr > 0):
            # momentum correction (reference _keras/callbacks.py:129-143):
            # scale momentum by new_lr/old_lr for one step so velocity
            # carries over, then restore. Only possible when momentum is a
            # backend Variable: Keras 3's stock SGD keeps it a Python
            # float baked into the traced step.
            self._restore_momentum_if_needed()
            self.restore_momentum = float(
                keras.ops.convert_to_numpy(opt.momentum)
            )
            opt.momentum.assign(self.restore_momentum * new_lr / old_lr)

    def _restore_momentum_if_needed(self):
        if self.restore_momentum is not None:
            self.model.optimizer.momentum.assign(self.restore_momentum)
            self.restore_momentum = None

    def on_batch_end(self, batch, logs=None):
        self._restore_momentum_if_needed()


class MetricsCallback(_Callback):
    """Keras spelling of :class:`horovod_tpu_torch.callbacks.
    MetricsCallback`: every ``every_n_steps`` batches, print the metrics
    registry's summary (or dump the JSON snapshot to ``dump_path``) on
    rank 0. The registry is fed by the instrumented collective and core
    layers; this callback adds the fit loop's cadence counter."""

    def __init__(self, every_n_steps: int = 100, dump_path=None,
                 printer=print):
        require_keras()
        super().__init__()
        self.every_n_steps = every_n_steps
        self.dump_path = dump_path
        self.printer = printer
        self._seen = 0

    def _emit(self):
        from horovod_tpu_torch.observability import exporters

        try:
            if hvd.rank() != 0:
                return
        except RuntimeError:
            pass  # not initialized (single-machine debugging): emit anyway
        exporters.emit_snapshot(
            self.dump_path, self.printer,
            header=f"horovod_tpu_torch metrics @ batch {self._seen}:\n",
        )

    def on_batch_end(self, batch, logs=None):
        from horovod_tpu_torch.observability import metrics

        self._seen += 1
        if metrics.enabled():
            metrics.counter("fit_batches", help="fit batches run").inc()
        if self.every_n_steps and self._seen % self.every_n_steps == 0:
            self._emit()

    def on_train_end(self, logs=None):
        self._emit()


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR warmup from ``initial_lr / size`` to ``initial_lr`` over
    ``warmup_epochs`` (reference ``_keras/callbacks.py:163-192``, after
    Goyal et al. 2017)."""

    def __init__(self, warmup_epochs: int = 5, momentum_correction: bool = True,
                 steps_per_epoch=None, verbose: int = 0, initial_lr=None):
        def multiplier(epoch):
            # epoch is fractional; ramp 1/size -> 1 across warmup_epochs
            return 1.0 / hvd.size() + epoch * (
                1.0 - 1.0 / hvd.size()) / warmup_epochs

        super().__init__(
            multiplier, start_epoch=0, end_epoch=warmup_epochs,
            staircase=False, momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch, initial_lr=initial_lr,
        )
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0:
            print(
                f"\nEpoch {epoch + 1}: finished gradual learning rate warmup "
                f"to {self._current_lr():.6g}."
            )
