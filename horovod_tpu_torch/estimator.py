"""Estimator workflow: fit a model on a DataFrame with distributed training.

Counterpart of ``horovod_tpu/estimator.py`` (reference: Horovod's Spark
estimators, ``horovod/spark/common/estimator.py``,
``spark/keras/estimator.py``, ``spark/torch/estimator.py``): stage the
DataFrame into a ``Store``, launch one training process a worker that
reads its shard, wrap the optimizer in ``DistributedOptimizer``, and
return a trained model wrapper with ``transform()``.

The execution fabric is the port's launcher (:func:`horovod_tpu_torch.
run.runner.run`: one process a GPU) and the staging format
pandas -> parquet (:class:`~horovod_tpu_torch.data.store.LocalStore`).
The Spark-facing veneer is :mod:`horovod_tpu_torch.spark` (gated on
pyspark); this module works without Spark.

What the port does differently, and why:

- The worker is a module-level function with picklable arguments, not a
  closure, so ``run.run`` ships it with plain ``pickle`` too
  (``TorchEstimator(num_proc=4)`` needs no cloudpickle).
- The worker calls ``hvd.init(device)``: this process's GPU by default;
  ``Estimator(device="cpu")`` asks for the CPU, as the tests do.
- The epoch shuffle draws from an explicit CPU ``torch.Generator``:
  ``seed=None`` draws from the global generator, as the JAX package's
  worker does; an int seeds it (the permutation ``torch.manual_seed``
  of that int would give).
- Rank 0's ``state_dict`` comes back on the CPU, so the launching
  process never unpickles CUDA tensors.
- The JAX package's ``_maybe_force_platform`` (a JAX platform pin) has
  no counterpart: there is no platform to pin.
"""

from __future__ import annotations

import functools
import os
import uuid
from typing import Callable, Optional, Sequence

import numpy as np

from horovod_tpu_torch.data.store import LocalStore, Store


def _default_store() -> Store:
    return LocalStore(os.path.join(os.getcwd(), ".hvd_estimator_runs"))


def _load_shard(store, run_id: str, feature_cols, label_cols, rank: int,
                size: int):
    """Worker-side: this rank's rows of the staged train data (reference
    petastorm row-group sharding, ``spark/keras/remote.py:93-178``)."""
    df = store.read_dataframe(store.get_train_data_path(run_id))
    shard = df.iloc[rank::size]
    x = shard[list(feature_cols)].to_numpy(dtype=np.float32)
    y = shard[list(label_cols)].to_numpy(dtype=np.float32)
    return x, y


class EstimatorModel:
    """Base trained-model wrapper (reference
    ``spark/common/estimator.py:70-110`` ``HorovodModel``)."""

    def __init__(self, feature_cols, label_cols, output_cols, history):
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.output_cols = list(output_cols)
        self.history_ = history

    def _predict(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, df):
        """Append prediction columns to a pandas DataFrame (reference
        ``HorovodModel.transform``)."""
        feats = df[self.feature_cols].to_numpy(dtype=np.float32)
        preds = np.asarray(self._predict(feats))
        out = df.copy()
        if preds.ndim == 1:
            preds = preds[:, None]
        for i, col in enumerate(self.output_cols):
            if preds.shape[1] == len(self.output_cols):
                out[col] = preds[:, i]
            else:  # one multi-dim output column
                out[col] = list(preds)
        return out


class Estimator:
    """Base estimator (reference ``spark/common/estimator.py:27-68``
    ``HorovodEstimator``): ``fit(df) -> model``.

    Parameters mirror the reference's param set
    (``spark/common/params.py``): feature/label columns, batch size,
    epochs, validation split, num_proc, store, verbosity; and the port's
    ``device`` (None: each worker's GPU; ``"cpu"``: the CPU) and ``seed``
    (the epoch shuffle's, see the module's docstring).
    """

    def __init__(self, *, feature_cols: Sequence[str],
                 label_cols: Sequence[str], batch_size: int = 32,
                 epochs: int = 1, num_proc: int = 1,
                 store: Optional[Store] = None,
                 validation: Optional[float] = None,
                 run_id: Optional[str] = None,
                 env: Optional[dict] = None, verbose: int = 0,
                 device=None, seed: Optional[int] = None):
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.num_proc = num_proc
        self.store = store or _default_store()
        self.validation = validation
        self.run_id = run_id
        self.env = env
        self.verbose = verbose
        self.device = device
        self.seed = seed

    # subclasses provide a picklable train fn + model builder ---------------

    def _make_train_fn(self, run_id: str) -> Callable:
        raise NotImplementedError

    def _make_model(self, remote_result, run_id: str) -> EstimatorModel:
        raise NotImplementedError

    def fit(self, df) -> EstimatorModel:
        """Stage `df`, train on ``num_proc`` processes, return the model
        (reference ``HorovodEstimator.fit``,
        ``spark/common/estimator.py:27-46``)."""
        run_id = self.run_id or f"run_{uuid.uuid4().hex[:12]}"
        train_df, val_df = self._split(df)
        self.store.write_dataframe(
            train_df, self.store.get_train_data_path(run_id))
        if val_df is not None:
            self.store.write_dataframe(
                val_df, self.store.get_val_data_path(run_id))

        train_fn = self._make_train_fn(run_id)
        if self.num_proc <= 1:
            results = [train_fn()]
        else:
            from horovod_tpu_torch.run import runner

            results = runner.run(
                train_fn, np=self.num_proc,
                env=self._job_env(), verbose=bool(self.verbose),
            )
        # rank 0 carries the authoritative state (reference: rank-0 checkpoint)
        return self._make_model(results[0], run_id)

    def _split(self, df):
        if not self.validation:
            return df, None
        n_val = int(len(df) * self.validation)
        if n_val == 0:
            return df, None
        return df.iloc[:-n_val], df.iloc[-n_val:]

    def _job_env(self) -> dict:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        return env

    def _load_shard(self, run_id: str, rank: int, size: int):
        return _load_shard(self.store, run_id, self.feature_cols,
                           self.label_cols, rank, size)


class _Init:
    """``hvd.init(device)`` for the worker's body; the world is shut down
    after it only if the worker made it (a caller's world stays up)."""

    def __init__(self, hvd, device):
        self.hvd, self.device = hvd, device

    def __enter__(self):
        self.made = not self.hvd.is_initialized()
        self.hvd.init(self.device)
        return self.hvd

    def __exit__(self, *exc):
        if self.made:
            self.hvd.shutdown()


# --------------------------------------------------------------------------
# Keras


def _keras_worker(spec: dict):
    """One rank's Keras training (the JAX package's ``train`` closure,
    ``horovod_tpu/estimator.py:195-222``): ``spec`` holds the model's
    JSON, the serialized optimizer, the loss and the staging paths."""
    import keras

    import horovod_tpu_torch.keras as hvd

    with _Init(hvd, spec["device"]):
        x, y = _load_shard(spec["store"], spec["run_id"],
                           spec["feature_cols"], spec["label_cols"],
                           hvd.process_rank(), hvd.process_size())
        model = keras.models.model_from_json(spec["model_json"])
        opt = spec["optimizer"]
        base_opt = (keras.optimizers.get(opt) if isinstance(opt, str)
                    else keras.optimizers.deserialize(opt))
        model.compile(
            optimizer=hvd.DistributedOptimizer(base_opt),
            loss=spec["loss"], metrics=spec["metrics"] or None,
        )
        callbacks = [hvd.BroadcastGlobalVariablesCallback(0),
                     hvd.MetricAverageCallback()]
        hist = model.fit(
            x, y, batch_size=spec["batch_size"], epochs=spec["epochs"],
            callbacks=callbacks,
            verbose=spec["verbose"] if hvd.process_rank() == 0 else 0,
        )
        if hvd.process_rank() == 0:
            return {"weights": model.get_weights(), "history": hist.history}
        return None


class KerasModel(EstimatorModel):
    """Trained Keras model wrapper (reference ``spark/keras/estimator.py``
    ``KerasModel``)."""

    def __init__(self, model_json, weights, **kw):
        super().__init__(**kw)
        self._model_json = model_json
        self._weights = weights
        self._model = None

    @property
    def keras_model(self):
        if self._model is None:
            import keras

            self._model = keras.models.model_from_json(self._model_json)
            self._model.set_weights(self._weights)
        return self._model

    def _predict(self, features):
        return self.keras_model.predict(features, verbose=0)


class KerasEstimator(Estimator):
    """Distributed Keras training on a DataFrame (reference
    ``spark/keras/estimator.py:40-160`` ``KerasEstimator``), on Keras's
    TensorFlow backend."""

    def __init__(self, *, model, optimizer="sgd", loss="mse", metrics=(),
                 **kw):
        super().__init__(**kw)
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = list(metrics)

    def _make_train_fn(self, run_id: str):
        opt = self.optimizer
        if not isinstance(opt, str):
            import keras

            opt = keras.optimizers.serialize(opt)
        return functools.partial(_keras_worker, dict(
            model_json=self.model.to_json(), optimizer=opt, loss=self.loss,
            metrics=self.metrics, batch_size=self.batch_size,
            epochs=self.epochs, verbose=self.verbose, device=self.device,
            store=self.store, run_id=run_id,
            feature_cols=self.feature_cols, label_cols=self.label_cols))

    def _make_model(self, result, run_id):
        return KerasModel(
            self.model.to_json(), result["weights"],
            feature_cols=self.feature_cols, label_cols=self.label_cols,
            output_cols=[f"{c}_pred" for c in self.label_cols],
            history=result["history"],
        )


# --------------------------------------------------------------------------
# Torch


def _torch_worker(spec: dict):
    """One rank's torch training (the JAX package's ``train`` closure,
    ``horovod_tpu/estimator.py:290-325``): the model moved to this
    process's device, the hook ``DistributedOptimizer`` of
    :mod:`horovod_tpu_torch.torch` over a fresh optimizer of the user's
    class and defaults, root's parameters and optimizer state broadcast,
    then ``epochs`` passes over this rank's shard in a permutation drawn
    each epoch (from a generator seeded ``spec["seed"]``, or the global
    one). Rank 0 returns its ``state_dict`` on the CPU and the mean loss
    of each epoch; the other ranks None."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import basics

    with _Init(hvd, spec["device"]):
        x, y = _load_shard(spec["store"], spec["run_id"],
                           spec["feature_cols"], spec["label_cols"],
                           hvd.process_rank(), hvd.process_size())
        dev = basics.device()
        local = spec["model"].to(dev)
        opt = spec["opt_cls"](local.parameters(), **spec["opt_defaults"])
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=local.named_parameters())
        hvd.broadcast_parameters(local.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        xs = torch.tensor(x, device=dev)
        ys = torch.tensor(y, device=dev)
        gen = None
        if spec["seed"] is not None:
            gen = torch.Generator().manual_seed(int(spec["seed"]))
        loss_fn, batch_size = spec["loss"], spec["batch_size"]
        history = []
        for _ in range(spec["epochs"]):
            perm = torch.randperm(len(xs), generator=gen).to(dev)
            epoch_loss = 0.0
            nb = 0
            for i in range(0, len(xs), batch_size):
                idx = perm[i:i + batch_size]
                opt.zero_grad()
                out = local(xs[idx])
                loss = loss_fn(out, ys[idx])
                loss.backward()
                opt.step()
                epoch_loss += float(loss.detach())
                nb += 1
            history.append(epoch_loss / max(nb, 1))
        if hvd.process_rank() == 0:
            return {"state_dict": {k: v.detach().cpu() for k, v in
                                   local.state_dict().items()},
                    "history": history}
        return None


class TorchModel(EstimatorModel):
    """Trained torch model wrapper (reference ``spark/torch/estimator.py``
    ``TorchModel``): predicts on the model's device, returns host
    arrays."""

    def __init__(self, model, **kw):
        super().__init__(**kw)
        self.torch_model = model

    def _predict(self, features):
        import torch

        dev = next(self.torch_model.parameters()).device
        self.torch_model.eval()
        with torch.no_grad():
            return self.torch_model(
                torch.tensor(features, device=dev)).cpu().numpy()


class TorchEstimator(Estimator):
    """Distributed PyTorch training on a DataFrame (reference
    ``spark/torch/estimator.py:36-150`` ``TorchEstimator``). ``optimizer``
    is a ``torch.optim`` optimizer over the model's parameters (its class
    and defaults are what the workers rebuild), ``loss`` a callable
    ``(output, target)``; with ``num_proc > 1`` the model and the loss
    must pickle."""

    def __init__(self, *, model, optimizer, loss, **kw):
        super().__init__(**kw)
        self.model = model
        self.optimizer = optimizer  # torch optimizer instance over model params
        self.loss = loss            # callable(output, target)

    def _make_train_fn(self, run_id: str):
        return functools.partial(_torch_worker, dict(
            model=self.model, opt_cls=type(self.optimizer),
            opt_defaults=dict(self.optimizer.defaults), loss=self.loss,
            batch_size=self.batch_size, epochs=self.epochs,
            device=self.device, seed=self.seed, store=self.store,
            run_id=run_id, feature_cols=self.feature_cols,
            label_cols=self.label_cols))

    def _make_model(self, result, run_id):
        self.model.load_state_dict(result["state_dict"])
        return TorchModel(
            self.model,
            feature_cols=self.feature_cols, label_cols=self.label_cols,
            output_cols=[f"{c}_pred" for c in self.label_cols],
            history=result["history"],
        )
