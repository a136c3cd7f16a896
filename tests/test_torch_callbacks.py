"""The callbacks of horovod_tpu_torch (``horovod_tpu_torch/callbacks.py``)
against the JAX package's, case for case with ``tests/test_callbacks.py``:
the LR schedule and the warmup give the JAX callbacks' learning rate at
every step (for worlds of 1, 2, 4 and 8); ``inject_hyperparams(sgd)``
with ``apply_lr`` and ``scale_momentum`` follows optax's
``inject_hyperparams(optax.sgd)`` trajectory within rtol 1e-6 (the bar
the fused Adam tests set); ``BroadcastGlobalVariablesCallback`` in a
gloo world of 2 leaves ZeRO-1 rows untouched and gives every other leaf
rank 0's value; ``MetricAverageCallback`` averages; the optax states
convert to the port's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from horovod_tpu import basics as jbasics, callbacks as jcbs
from horovod_tpu_torch import basics, callbacks as cbs, optim
from horovod_tpu_torch.models.convert import opt_state_from_jax
from horovod_tpu_torch.testing import run_world

import torch_launcher_workers as LW

pytestmark = pytest.mark.torch_port


class _T:
    def __init__(self, lr):
        self.lr = lr
        self.opt_state = None


def _drive(mod, make, schedule, size, monkeypatch, base):
    """The learning rate a callback sets at each ``(epoch, batch)`` of
    ``schedule`` in a world of ``size``."""
    monkeypatch.setattr(base, "size", lambda: size)
    t = _T(1.5)
    cb = make(mod)
    cb.set_trainer(t)
    cb.on_train_begin()
    out = []
    for epoch, batches in schedule:
        cb.on_epoch_begin(epoch)
        for b in range(batches):
            cb.on_batch_begin(b)
            out.append(t.lr)
        cb.on_epoch_end(epoch)
    return out


SCHEDULES = {
    "warmup": lambda m: m.LearningRateWarmupCallback(
        warmup_epochs=2, steps_per_epoch=5, momentum_correction=False),
    "warmup_3": lambda m: m.LearningRateWarmupCallback(
        warmup_epochs=3, steps_per_epoch=4, initial_lr=0.4),
    "staircase": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 0.5 ** e, start_epoch=1, end_epoch=4,
        momentum_correction=False),
    "smooth": lambda m: m.LearningRateScheduleCallback(
        multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        steps_per_epoch=5, momentum_correction=False),
    "constant": lambda m: m.LearningRateScheduleCallback(
        multiplier=0.1, start_epoch=2, momentum_correction=False),
}


@pytest.mark.parametrize("size", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_equal_jax_at_every_step(name, size, monkeypatch):
    schedule = [(e, 5) for e in range(6)]
    got = _drive(cbs, SCHEDULES[name], schedule, size, monkeypatch, basics)
    want = _drive(jcbs, SCHEDULES[name], schedule, size, monkeypatch,
                  jbasics)
    assert got == want


def test_smooth_schedule_requires_steps_per_epoch():
    t = _T(1.0)
    cb = cbs.LearningRateScheduleCallback(multiplier=lambda e: 1.0,
                                          staircase=False)
    cb.set_trainer(t)
    cb.on_train_begin()
    cb.on_epoch_begin(0)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        cb.on_batch_begin(0)


class _SgdTrainer:
    def __init__(self, tx, params, lr):
        self.opt_state, self.lr = tx.init(params), lr


@pytest.mark.parametrize("nesterov", [False, True])
def test_inject_hyperparams_sgd_follows_optax(nesterov, monkeypatch):
    """Eight steps of SGD with momentum under a staircase schedule with
    momentum correction (``scale_momentum`` at each LR jump), the LR
    pushed in with ``apply_lr`` every step, in both packages: parameters,
    trace and hyperparameters within rtol 1e-6."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b/c": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(8)]

    def nest(flat):
        return {"a": jnp.asarray(flat["a"]), "b": {"c": jnp.asarray(
            flat["b/c"])}}

    ttx = optim.inject_hyperparams(optim.sgd)(learning_rate=0.1,
                                              momentum=0.9,
                                              nesterov=nesterov)
    jtx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.1,
                                              momentum=0.9,
                                              nesterov=nesterov)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jp = nest(p0)
    tt, jt = _SgdTrainer(ttx, tp, 0.1), _SgdTrainer(jtx, jp, 0.1)
    make = lambda m: m.LearningRateScheduleCallback(  # noqa: E731
        multiplier=lambda e: 0.5 ** e, steps_per_epoch=2)
    tcb, jcb = make(cbs), make(jcbs)
    for cb, t in ((tcb, tt), (jcb, jt)):
        cb.set_trainer(t)
        cb.on_train_begin()
    for i, g in enumerate(grads):
        if i % 2 == 0:
            tcb.on_epoch_begin(i // 2)
            jcb.on_epoch_begin(i // 2)
        tt.opt_state = cbs.apply_lr(tt.opt_state, tt.lr)
        jt.opt_state = jcbs.apply_lr(jt.opt_state, jt.lr)
        up, tt.opt_state = ttx.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tt.opt_state, tp)
        tp = {k: tp[k] + up[k] for k in tp}
        jup, jt.opt_state = jtx.update(nest(g), jt.opt_state, jp)
        jp = optax.apply_updates(jp, jup)
    assert tt.lr == jt.lr == 0.1 * 0.5 ** 3
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tp["b/c"].numpy(), np.asarray(jp["b"]["c"]),
                               rtol=1e-6)
    conv = opt_state_from_jax(jt.opt_state)
    assert conv["count"] == tt.opt_state["count"] == 8
    assert conv["hyperparams"]["learning_rate"] == pytest.approx(
        tt.opt_state["hyperparams"]["learning_rate"], rel=1e-7)
    for k in p0:
        np.testing.assert_allclose(
            tt.opt_state["inner_state"]["trace"][k].numpy(),
            conv["inner_state"]["trace"][k], rtol=1e-6)


def test_apply_lr_finds_the_injected_state_at_any_depth():
    import horovod_tpu_torch as hvd

    params = {"w": torch.ones(3)}
    st = optim.inject_hyperparams(optim.sgd)(learning_rate=0.1).init(params)
    nested = {"shard": {"rank": 0, "size": 1}, "inner": st}
    assert cbs.apply_lr(nested, 0.02) is nested
    assert st["hyperparams"]["learning_rate"] == 0.02
    ups, _ = optim.inject_hyperparams(optim.sgd)(learning_rate=0.1).update(
        {"w": torch.ones(3)}, st, params)
    np.testing.assert_allclose(ups["w"].numpy(), -0.02 * np.ones(3),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="inject_hyperparams"):
        cbs.apply_lr(optim.sgd(0.1).init(params), 0.5)
    with pytest.raises(ValueError, match="inject_hyperparams"):
        cbs.apply_lr(hvd.fused_adam(0.1).init(params), 0.5)


def test_injected_fused_adam_takes_the_new_lr_without_a_rebuild():
    """``inject_hyperparams(fused_adam)``: each update is the plain
    ``fused_adam`` of the state's learning rate, bit for bit, and the
    state's lr changes nothing else."""
    import horovod_tpu_torch as hvd

    rng = np.random.default_rng(2)
    p = {"a": torch.from_numpy(rng.standard_normal(300).astype(np.float32))}
    g = {"a": torch.from_numpy(rng.standard_normal(300).astype(np.float32))}
    tx = optim.inject_hyperparams(hvd.fused_adam)(learning_rate=1e-3)
    st = tx.init(p)
    ref = hvd.fused_adam(1e-3).init(p)
    for lr in (1e-3, 5e-4, 2e-3):
        cbs.apply_lr(st, lr)
        u, st = tx.update(g, st, p)
        ur, ref = hvd.fused_adam(lr).update(g, ref, p)
        assert torch.equal(u["a"], ur["a"])
        assert torch.equal(st["inner_state"]["mu"]["a"], ref["mu"]["a"])
    assert st["count"] == 3 and st["inner_state"]["count"] == 3


def test_injected_state_holds_numbers_and_keeps_flags_static():
    tx = optim.inject_hyperparams(optim.sgd)(learning_rate=0.1, momentum=0.9,
                                             nesterov=True)
    p = {"w": torch.zeros(2)}
    st = tx.init(p)
    assert st["hyperparams"] == {"learning_rate": 0.1, "momentum": 0.9}
    for k in range(3):
        u, st = tx.update({"w": torch.ones(2)}, st, p)
    assert st["count"] == 3


def test_scale_momentum_rescales_the_trace_only():
    p = {"w": torch.ones(2, 2)}
    t = _T(1.0)
    t.opt_state = optim.inject_hyperparams(optim.sgd)(
        learning_rate=1.0, momentum=0.9).init(p)
    t.opt_state["inner_state"]["trace"]["w"].fill_(1.0)
    cb = cbs.LearningRateScheduleCallback(multiplier=0.5)
    cb.set_trainer(t)
    cb.on_train_begin()
    cb.on_epoch_begin(0)
    assert t.lr == pytest.approx(0.5)
    np.testing.assert_allclose(
        t.opt_state["inner_state"]["trace"]["w"].numpy(),
        0.5 * np.ones((2, 2)))
    assert t.opt_state["hyperparams"]["learning_rate"] == 1.0


def test_callback_list_dispatch_and_wiring():
    t = _T(0.1)
    seen = []

    class Probe(cbs.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            seen.append(("epoch", epoch, self.trainer is t))

    cbs.CallbackList([Probe()], trainer=t).on_epoch_begin(3, {})
    assert seen == [("epoch", 3, True)]


@pytest.fixture(scope="module")
def world():
    return run_world(LW.callbacks_worker, 2)


def test_broadcast_callback_in_a_world_of_two(world):
    r0, r1 = world
    for r in (r0, r1):
        assert r["done"] and r["views_same"]
        np.testing.assert_array_equal(r["params"]["w"], np.ones((2, 3)))
        np.testing.assert_array_equal(r["params"]["b"],
                                      np.arange(5, dtype=np.float32))
        # rank 0's plain state everywhere: trace and hyperparameters
        np.testing.assert_array_equal(r["plain"]["inner_state"]["trace"]["w"],
                                      np.full((2, 3), 7.0))
        assert r["plain"]["hyperparams"]["learning_rate"] == 0.05


def test_broadcast_callback_leaves_zero1_rows_alone(world):
    for rank, r in enumerate(world):
        before, after = r["zero1_before"], r["zero1_after"]
        assert after["shard"] == {"rank": rank, "size": 2}
        for k, v in before["inner"]["inner_state"]["mu"].items():
            np.testing.assert_array_equal(
                after["inner"]["inner_state"]["mu"][k], v)
            assert (v == rank + 10.0).all()
        for k, v in before["residual"].items():
            np.testing.assert_array_equal(after["residual"][k], v)


def test_metric_average_callback_in_a_world_of_two(world):
    for r in world:
        assert r["logs"] == {"loss": 1.5, "acc": 1.0, "t": 1.5,
                             "name": "epoch0"}


def test_metric_average_callback_empty_logs():
    cbs.MetricAverageCallback().on_epoch_end(0, None)
    cbs.MetricAverageCallback().on_epoch_end(0, {})
