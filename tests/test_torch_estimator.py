"""The estimators of horovod_tpu_torch (``horovod_tpu_torch/estimator.py``)
against the JAX package's (``horovod_tpu/estimator.py``) on the same
DataFrame and seed.

At ``num_proc=1`` on the CPU: ``KerasEstimator``'s weights are the JAX
package's bit for bit and its losses within 2.5e-7 (the JAX package's
``MetricAverageCallback`` averages each epoch's loss over its 8 replicas
by a sum: a ULP); ``TorchEstimator``'s losses and weights within rtol
1e-5 / atol 1e-6 (the JAX package's hook optimizer averages each
gradient over its 8 replicas by a sum, a ULP a step that SGD with
momentum carries; measured 3.6e-7). ``TorchEstimator(num_proc=2)``
through ``run.run`` (its worker shipped by plain ``pickle``) equals a
plain two-shard loop bit for bit. The hook ``DistributedOptimizer`` that
the workers use launches the collectives a ``synchronize`` starts itself
in parameter order on every rank (a gloo world of 2)."""

import copy
import functools
import os
import pathlib
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from horovod_tpu import estimator as jest
from horovod_tpu_torch import basics, estimator as test_
from horovod_tpu_torch.data import LocalStore
from horovod_tpu_torch.testing import run_world

import torch_frontends_workers as W

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
FEATURES = [f"f{i}" for i in range(4)]


def _teacher_df(n=256, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    y = X @ w + 0.01 * rng.randn(n).astype(np.float32)
    df = pd.DataFrame({f"f{i}": X[:, i] for i in range(d)})
    df["label"] = y
    return df


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 1))


def _torch_est(cls, model, tmp_path, **kw):
    opt = kw.pop("opt", None) or torch.optim.SGD(model.parameters(), lr=0.05,
                                                 momentum=0.9)
    return cls(model=model, optimizer=opt, loss=torch.nn.functional.mse_loss,
               feature_cols=FEATURES, label_cols=["label"], batch_size=32,
               epochs=3, store=LocalStore(str(tmp_path)), **kw)


def test_torch_estimator_matches_jax_at_one_process(hvd, tmp_path):
    df = _teacher_df(seed=1)
    init = _mlp()
    jm, tm = copy.deepcopy(init), copy.deepcopy(init)
    torch.manual_seed(5)    # the JAX worker draws from the global generator
    jfit = _torch_est(jest.TorchEstimator, jm, tmp_path / "j").fit(df)
    tfit = _torch_est(test_.TorchEstimator, tm, tmp_path / "t",
                      device="cpu", seed=5).fit(df)
    np.testing.assert_allclose(tfit.history_, jfit.history_, rtol=1e-5)
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert tfit.history_[-1] < tfit.history_[0]
    jo, to = jfit.transform(df.head(8)), tfit.transform(df.head(8))
    assert list(to.columns) == list(jo.columns)
    np.testing.assert_allclose(to["label_pred"], jo["label_pred"],
                               rtol=1e-5, atol=1e-6)
    assert not basics.is_initialized()   # the worker shut its world down


def test_keras_estimator_matches_jax_at_one_process(hvd, tmp_path):
    keras = pytest.importorskip("keras")
    df = _teacher_df()
    out = []
    for cls, kw in ((jest.KerasEstimator, {}),
                    (test_.KerasEstimator, dict(device="cpu"))):
        keras.utils.set_random_seed(3)
        est = cls(model=keras.Sequential([keras.layers.Input((4,)),
                                          keras.layers.Dense(1)]),
                  optimizer=keras.optimizers.SGD(0.05), loss="mse",
                  feature_cols=FEATURES, label_cols=["label"], batch_size=32,
                  epochs=3, num_proc=1, validation=0.1,
                  store=LocalStore(str(tmp_path / cls.__module__)), **kw)
        keras.utils.set_random_seed(4)
        out.append(est.fit(df))
    j, t = out
    for a, b in zip(t._weights, j._weights):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.history_["loss"], j.history_["loss"],
                               rtol=2.5e-7)
    np.testing.assert_array_equal(t.transform(df.head(8))["label_pred"],
                                  j.transform(df.head(8))["label_pred"])


def test_seeded_shuffle_draws_what_manual_seed_draws():
    gen = torch.Generator().manual_seed(11)
    got = [torch.randperm(100, generator=gen) for _ in range(3)]
    torch.manual_seed(11)
    want = [torch.randperm(100) for _ in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_worker_pickles_without_cloudpickle(tmp_path):
    """The train fn is a module-level function with picklable arguments,
    so plain ``pickle`` ships it (``run.run`` falls back to it)."""
    m = _mlp()
    fn = _torch_est(test_.TorchEstimator, m, tmp_path)._make_train_fn("r")
    assert isinstance(fn, functools.partial)
    assert fn.func is test_._torch_worker
    back = pickle.loads(pickle.dumps(fn))
    assert back.args[0]["opt_cls"] is torch.optim.SGD
    assert back.args[0]["seed"] is None and back.args[0]["device"] is None


def _plain_two_shard_loop(model, df, seed, lr, epochs, batch):
    """What two ranks of the estimator compute, in one process: each
    rank's shard ``df.iloc[r::2]`` in the same seeded permutations, the
    two gradients averaged ((g0 + g1) / 2), one SGD step; rank 0's mean
    loss an epoch."""
    xs = [torch.tensor(df.iloc[r::2][FEATURES].to_numpy(np.float32))
          for r in range(2)]
    ys = [torch.tensor(df.iloc[r::2][["label"]].to_numpy(np.float32))
          for r in range(2)]
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    gen = torch.Generator().manual_seed(seed)
    history = []
    for _ in range(epochs):
        perm = torch.randperm(len(xs[0]), generator=gen)
        losses = []
        for i in range(0, len(xs[0]), batch):
            idx = perm[i:i + batch]
            grads = []
            for r in range(2):
                model.zero_grad()
                loss = torch.nn.functional.mse_loss(model(xs[r][idx]),
                                                    ys[r][idx])
                loss.backward()
                grads.append([p.grad.clone() for p in model.parameters()])
                if r == 0:
                    losses.append(float(loss.detach()))
            for p, g0, g1 in zip(model.parameters(), *grads):
                p.grad = (g0 + g1) / torch.full((), 2.0)
            opt.step()
        history.append(sum(losses) / len(losses))
    return history


def test_two_processes_through_run_equal_a_plain_two_shard_loop(
        tmp_path, monkeypatch):
    df = _teacher_df(seed=2)
    init = _mlp(1)
    m = copy.deepcopy(init)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    est = _torch_est(test_.TorchEstimator, m, tmp_path, num_proc=2,
                     device="cpu", seed=7, env=env,
                     opt=torch.optim.SGD(m.parameters(), lr=0.05))
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    trained = est.fit(df)
    ref = copy.deepcopy(init)
    want = _plain_two_shard_loop(ref, df, 7, 0.05, 3, 32)
    assert trained.history_ == want
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(m.state_dict()[k].numpy(), v.numpy(),
                                      err_msg=k)
    assert all(v.device.type == "cpu" for v in m.state_dict().values())


def test_hook_optimizer_launches_in_parameter_order():
    """A ``synchronize`` that reduces gradients no hook reduced (the
    dummy step of ``broadcast_optimizer_state``, which the estimator's
    worker runs) launches them in parameter order on every rank, and
    every gradient is averaged with its own peer."""
    res = run_world(W.sync_order_worker, 2, timeout=60)
    names = [f"allreduce.p{i:02d}" for i in range(16)]
    for got in res:
        assert got["names"] == names
        np.testing.assert_array_equal(
            got["grads"], np.repeat(np.arange(16, dtype=np.float32)[:, None]
                                    + 5.0, 4, axis=1))


def test_a_callers_world_stays_up(tmp_path):
    basics.init(device="cpu")
    try:
        m = _mlp()
        _torch_est(test_.TorchEstimator, m, tmp_path, seed=0).fit(
            _teacher_df(64))
        assert basics.is_initialized()
    finally:
        basics.shutdown()


def test_the_default_device_is_the_card(tmp_path):
    """With no ``device`` the worker's ``hvd.init()`` takes the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    m = _mlp()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _torch_est(test_.TorchEstimator, m, tmp_path).fit(_teacher_df(64))
