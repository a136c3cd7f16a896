"""Resilience of horovod_tpu_torch against the JAX package's
(``horovod_tpu/resilience``), on the CPU.

- health, retry and chaos: the same calls on both packages' modules give
  the same states, reasons, snapshot fields, delays, parsed specs, error
  texts and charge sequences;
- the preemption loop: ``TestPreemptionLoop``'s cases
  (``tests/test_resilience.py``), the double-SIGTERM latch and the
  non-reentrant preemption (``tests/test_elastic.py``), the skipped
  non-finite emergency checkpoint (``tests/test_numerics.py``), a
  ``Preempted`` leaving a process (and a gloo world of 2) with exit code
  75, and a two-rank ``resume_state`` in which only rank 0's directory
  holds the checkpoint;
- the eager dispatch guard (``collective_fail`` retried on two gloo
  ranks, the result bit-equal to the clean call), the core handle's
  attributable timeout, ``basics.health_state()``/``health()``, the
  ``HealthCallback``, the KV store's heartbeat TTL and the elastic
  coordinator.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from horovod_tpu.observability import metrics as jmetrics
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import health as jhealth
from horovod_tpu.resilience import retry as jretry
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.observability import metrics
from horovod_tpu_torch.resilience import chaos, elastic, health, loop, retry
from horovod_tpu_torch.resilience.health import HealthMonitor, HealthState
from horovod_tpu_torch.resilience.retry import RetryError, RetryPolicy, \
    TransientError
from horovod_tpu_torch.run.rendezvous import DeadRankError, KVStoreServer
from horovod_tpu_torch.testing import WorldExit, run_world

import torch_resilience_workers as W

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_resilience():
    """Every test sees HEALTHY monitors, empty registries, and no chaos,
    in both packages."""
    for m, h, c in ((metrics, health, chaos), (jmetrics, jhealth, jchaos)):
        m.reset()
        m.set_enabled(True)
        h.reset()
        c.configure(None)
    yield
    for m, h, c in ((metrics, health, chaos), (jmetrics, jhealth, jchaos)):
        m.reset()
        m.set_enabled(True)
        h.reset()
        c.reset()


@pytest.fixture
def world_of_one():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# ------------------------------------------------------ health state machine


def _drive(mod):
    """One sequence of every ``record_*`` feed on a fresh monitor of
    ``mod``: the state, reason and strikes after each."""
    m = mod.HealthMonitor()
    calls = [
        ("record_stall", ("grad/w0", 60.0)), ("beat", ()),
        ("record_timeout", ("grad/w1",)), ("record_stall", ("grad/w1",)),
        ("record_timeout", ("grad/w1",)),
    ] + [("beat", ())] * 5 + [
        ("record_rank_lost", (5,)), ("record_replica_lost", ("r1", "gone")),
        ("record_schedule_divergence", (3, 7, "allreduce")),
        ("beat", ()), ("record_numeric_corruption", (2, 4)),
        ("record_hang", (6,)), ("record_serving_stale", (9, 4)),
        ("record_serving_fresh", ()), ("record_straggler", (1, 0.5)),
        ("record_data_corruption", ("shard7",)),
        ("record_input_stall", (2.0,)), ("record_slo_burn", ("ttft", "5m")),
        ("record_retry", ("kv",)), ("record_retry_exhausted", ("kv",)),
    ] + [("beat", ())] * 6 + [
        ("record_fatal", ("coordinator gone",)), ("beat", ()),
        ("record_stall", ("x",)),
    ]
    out = []
    for name, args in calls:
        getattr(m, name)(*args)
        snap = m.snapshot()
        out.append((name, m.state().name, m.reason(), snap["state"],
                    snap["value"], snap["strikes"]))
    return out


def test_health_feeds_match_the_jax_package():
    """The same sequence of every feed walks both machines through the
    same states, reasons and strike counts, and the mirrored metrics
    agree."""
    got, want = _drive(health), _drive(jhealth)
    assert got == want
    assert {s for _, s, *_ in got} == {"HEALTHY", "SUSPECT", "DEGRADED",
                                      "FATAL"}
    for mod, m in ((health, metrics), (jhealth, jmetrics)):
        m.reset()
        mod.record_stall("grad/w0")
    assert metrics.value("resilience_health_state") == jmetrics.value(
        "resilience_health_state") == float(HealthState.SUSPECT)
    labels = {"from": "HEALTHY", "to": "SUSPECT"}
    assert metrics.value("resilience_health_transitions", **labels) == \
        jmetrics.value("resilience_health_transitions", **labels) == 1.0


@pytest.mark.parametrize("case", ["suspect_then_beat", "degrade",
                                  "recovery_beats", "retry_exhaustion",
                                  "fatal_terminal"])
def test_health_machine_cases(case):
    """``TestHealthMachine``'s cases, on the port's monitor."""
    m = HealthMonitor()
    assert m.state() == HealthState.HEALTHY
    if case == "suspect_then_beat":
        m.record_stall("grad/w0", 60.0)
        assert m.state() == HealthState.SUSPECT and "grad/w0" in m.reason()
        m.beat()
        assert m.state() == HealthState.HEALTHY
    elif case == "degrade":
        for _ in range(m.escalate_after):
            m.record_stall("grad/w0")
        assert m.state() == HealthState.DEGRADED
    elif case == "recovery_beats":
        for _ in range(m.escalate_after):
            m.record_timeout("grad/w0")
        for _ in range(m.recovery_beats - 1):
            m.beat()
        assert m.state() == HealthState.DEGRADED
        m.beat()
        assert m.state() == HealthState.HEALTHY
    elif case == "retry_exhaustion":
        m.record_retry_exhausted("kv")
        assert m.state() == HealthState.DEGRADED and "kv" in m.reason()
    else:
        m.record_fatal("coordinator gone")
        for _ in range(10):
            m.beat()
            m.record_stall("x")
        assert m.state() == HealthState.FATAL
        assert m.reason() == "coordinator gone"


def test_basics_health_surface():
    assert hvd.health_state() == HealthState.HEALTHY
    health.record_stall("grad/w0")
    assert hvd.health_state() == HealthState.SUSPECT
    snap = hvd.health()
    assert snap["state"] == "SUSPECT" and "grad/w0" in snap["reason"]


def test_record_rank_lost_strikes_and_counts():
    health.record_rank_lost(5)
    assert health.health_state() == HealthState.SUSPECT
    assert "rank 5" in health.snapshot()["reason"]
    assert metrics.value("resilience_rank_lost") == 1.0
    health.beat()
    assert health.health_state() == HealthState.HEALTHY


def test_health_callback_abort_on_suspect():
    from horovod_tpu_torch.callbacks import HealthCallback

    cb = HealthCallback(printer=lambda m: None,
                        abort_on=HealthState.SUSPECT)
    health.record_stall("grad/w0")
    with pytest.raises(RuntimeError, match="SUSPECT"):
        cb.on_batch_end(0)


def test_health_callback_beats_recover():
    from horovod_tpu_torch.callbacks import HealthCallback

    seen = []
    cb = HealthCallback(printer=seen.append)
    health.record_stall("grad/w0")
    cb.on_batch_end(0)
    assert health.health_state() == HealthState.HEALTHY
    assert any("SUSPECT" in m for m in seen)


def test_core_handle_timeout_is_attributable():
    from horovod_tpu_torch.core import CoreHandle

    h = CoreHandle("grad/dense0")
    with pytest.raises(TimeoutError) as ei:
        h.wait(timeout=0.01)
    e = ei.value
    assert e.tensor_name == "grad/dense0"
    assert e.health_state == HealthState.SUSPECT
    assert "grad/dense0" in str(e) and "SUSPECT" in str(e)
    assert metrics.value("resilience_wait_timeouts") == 1.0


def test_core_stall_log_feeds_health():
    """The stall inspector's warning, through the core's log callback,
    makes the monitor SUSPECT naming the tensor."""
    from horovod_tpu_torch.core import NativeCore

    NativeCore._on_log(None, 2, b"Stalled collective: grad/w3 waited 61.5s; "
                       b"missing ranks: 1")
    assert health.health_state() == HealthState.SUSPECT
    assert "grad/w3" in health.MONITOR.reason()


# ---------------------------------------------------------- retry policy


POLICIES = [
    dict(max_attempts=5, base_delay=0.05, max_delay=0.3, multiplier=2.0,
         jitter=0.0),
    dict(max_attempts=6, jitter=0.5, seed=42),
    dict(max_attempts=8, base_delay=0.01, max_delay=1.0, multiplier=3.0,
         jitter=0.25, seed=7),
]


@pytest.mark.parametrize("kw", POLICIES)
def test_retry_delays_match_the_jax_package(kw):
    assert list(RetryPolicy(**kw).delays()) == list(
        jretry.RetryPolicy(**kw).delays())


def test_retry_delays_exponential_capped_and_jitter_bounded():
    p = RetryPolicy(max_attempts=5, base_delay=0.05, max_delay=0.3,
                    multiplier=2.0, jitter=0.0)
    assert list(p.delays()) == [0.05, 0.1, 0.2, 0.3]
    base = RetryPolicy(max_attempts=6, jitter=0.0)
    for with_j, without in zip(RetryPolicy(max_attempts=6, jitter=0.5,
                                           seed=42).delays(), base.delays()):
        assert without <= with_j < without * 1.5


def _fast_policy(mod, scope="test", **kw):
    kw.setdefault("max_attempts", 5)
    kw.setdefault("base_delay", 0.005)
    kw.setdefault("max_delay", 0.02)
    kw.setdefault("jitter", 0.0)
    kw.setdefault("seed", 0)
    return mod.RetryPolicy(scope=scope, **kw)


def test_retry_call_and_exhaustion_match_the_jax_package():
    """Retries then success, a non-retriable error, and exhaustion: the
    same attempts, sleeps, counters, errors and health in both."""
    out = {}
    for mod, m, h in ((retry, metrics, health), (jretry, jmetrics, jhealth)):
        attempts, slept = [], []

        def flaky():
            attempts.append(1)
            if len(attempts) < 3:
                raise mod.TransientError("not yet")
            return "ok"

        res = _fast_policy(mod).call(flaky, sleep=slept.append)
        with pytest.raises(ValueError):
            _fast_policy(mod).call(
                lambda: (_ for _ in ()).throw(ValueError("logic bug")),
                sleep=lambda _: None)

        def always():
            raise mod.TransientError("still down")

        with pytest.raises(mod.RetryError) as ei:
            _fast_policy(mod, max_attempts=3).call(always,
                                                   sleep=lambda _: None)
        assert isinstance(ei.value.__cause__, mod.TransientError)
        out[mod.__name__.split(".")[0]] = (
            res, len(attempts), slept, ei.value.attempts, str(ei.value),
            m.value("resilience_retries", scope="test"),
            m.value("resilience_retry_exhausted", scope="test"),
            h.health_state().name)
    assert out["horovod_tpu_torch"] == out["horovod_tpu"]
    assert out["horovod_tpu_torch"][:4] == ("ok", 3, [0.005, 0.01], 3)


def test_retry_deadline_and_predicate():
    def always():
        raise TransientError("still down")

    p = RetryPolicy(scope="dl", max_attempts=10, base_delay=10.0,
                    deadline=0.05, jitter=0.0)
    t0 = time.monotonic()
    with pytest.raises(RetryError) as ei:
        p.call(always)
    assert time.monotonic() - t0 < 1.0 and ei.value.attempts == 1
    seen = []

    def flaky():
        seen.append(1)
        if len(seen) == 1:
            raise OSError("EHOSTUNREACH")
        return 7

    assert _fast_policy(retry).call(
        flaky, retriable=lambda e: isinstance(e, OSError),
        sleep=lambda _: None) == 7


def test_policy_from_env_reads_the_same_names(monkeypatch):
    monkeypatch.setenv("HOROVOD_RETRY_KV_MAX_ATTEMPTS", "9")
    monkeypatch.setenv("HOROVOD_RETRY_BASE_DELAY", "0.125")
    monkeypatch.setenv("HOROVOD_RETRY_COLLECTIVE_DISPATCH_JITTER", "0.3")
    for scope, kw in (("kv", dict(max_attempts=3, base_delay=0.5,
                                  max_delay=1.0)),
                      ("collective_dispatch", dict(max_attempts=3))):
        p = retry.policy_from_env(scope, **kw)
        q = jretry.policy_from_env(scope, **kw)
        assert (p.max_attempts, p.base_delay, p.max_delay, p.jitter,
                p.multiplier, p.deadline) == (
            q.max_attempts, q.base_delay, q.max_delay, q.jitter,
            q.multiplier, q.deadline)
    p = retry.policy_from_env("kv", max_attempts=3, base_delay=0.5,
                              max_delay=1.0)
    assert (p.max_attempts, p.base_delay, p.max_delay) == (9, 0.125, 1.0)


# ------------------------------------------------------------ chaos harness


#: one spec per key of the grammar, and malformed ones
SPECS = [
    "kv_drop=2, collective_delay=0.05,sigterm_at_step=3", "",
    "collective_fail=1,publish_fail=3", "subscriber_stall=0.1",
    "rank_hang_hold=2.5,kv_partition=0.4",
    "rank_fail=2,rank_fail_at_step=3,rank_join_at_step=6",
    "kv_restart_at_step=4,kv_kill_primary_at_step=5",
    "schedule_diverge_at_step=2,grad_nan_at_step=7,request_burst=9",
    "rank_hang_at_step=3,cache_evict_at_pass=2", "rank_slow=3:0.05",
    "grad_spike_at_step=4:1000", "grad_spike_at_step=4",
    "grad_corrupt_rank=5:4", "data_stall=2:0.1", "shard_corrupt=3:2",
    "shard_corrupt=3", "slow_decode=0.05", "slow_decode=0.05:canary@r1",
    "replica_kill=1", "replica_kill=2:5", "replica_stale=1:3.5",
    "kv_dorp=2", "rank_slow=3", "grad_corrupt_rank=5", "replica_stale=1",
    "kv_drop", "rank_fail=x",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_the_jax_package(spec):
    def parse(mod):
        try:
            return ("ok", mod.parse_spec(spec))
        except ValueError as e:
            return ("error", str(e))

    assert parse(chaos) == parse(jchaos)


def test_every_key_of_the_grammar_is_the_jax_packages():
    for name in ("_COUNT_KEYS", "_FLOAT_KEYS", "_INT_KEYS", "_STRUCT_KEYS"):
        assert getattr(chaos, name) == getattr(jchaos, name)
    assert set(chaos.__all__) - {"injected"} == set(jchaos.__all__)


def _takes(mod):
    """The charge accessors' answers, in one order, under one spec."""
    mod.configure("kv_drop=2,rank_fail=2,rank_fail_at_step=3,"
                  "rank_join_at_step=5,kv_restart_at_step=2,"
                  "kv_kill_primary_at_step=3,request_burst=4,"
                  "cache_evict_at_pass=1,schedule_diverge_at_step=2,"
                  "grad_nan_at_step=3,grad_spike_at_step=4:10,"
                  "grad_corrupt_rank=3:2,rank_hang_at_step=6,"
                  "rank_slow=1:0.01,data_stall=2:0.01,shard_corrupt=1:2,"
                  "slow_decode=0.01:canary,replica_kill=1:2,"
                  "replica_stale=0:2.0,sigterm_at_step=4")
    out = [mod.enabled(), mod.should_fail("kv_drop"),
           mod.should_fail("kv_drop"), mod.should_fail("kv_drop")]
    out += [mod.take_rank_fail(s) for s in (0, 2, 3, 3, 4)]
    out += [mod.take_rank_join(s) for s in (4, 6, 7)]
    out += [mod.take_kv_restart(s) for s in (1, 2, 3)]
    out += [mod.take_kv_kill_primary(s) for s in (2, 3, 4)]
    out += [mod.take_request_burst(), mod.take_request_burst()]
    out += [mod.take_cache_evict(s) for s in (0, 1, 2)]
    out += [mod.take_schedule_diverge(s) for s in (1, 2, 3)]
    out += [mod.take_replica_kill(s) for s in (1, 2, 3)]
    out += [mod.grad_nan_step(), mod.grad_spike(), mod.grad_corrupt(),
            mod.rank_hang_step(), mod.rank_hang_hold(), mod.rank_slow(),
            mod.data_stall(), mod.shard_corrupt(), mod.slow_decode(),
            mod.replica_stale(), mod.sigterm_at_step()]
    mod.consume_grad_nan()
    mod.consume_grad_spike()
    mod.consume_grad_corrupt()
    mod.consume_rank_hang()
    mod.consume_sigterm()
    out += [mod.grad_nan_step(), mod.grad_spike(), mod.grad_corrupt(),
            mod.rank_hang_step(), mod.sigterm_at_step()]
    with pytest.raises(mod.TransientError):
        mod.configure({"collective_fail": 1})
        mod.inject_failure("collective_fail")
    mod.inject_failure("collective_fail")       # spent: no-op
    return out


def test_take_sequences_match_the_jax_package():
    got, want = _takes(chaos), _takes(jchaos)
    assert got == want
    sites = ("kv_drop", "rank_fail", "rank_join_at_step", "grad_nan_at_step",
             "sigterm_at_step", "collective_fail", "replica_kill")
    for site in sites:
        assert metrics.value("resilience_chaos_injected", site=site) == \
            jmetrics.value("resilience_chaos_injected", site=site), site
    assert chaos.injected["kv_drop"] == 2


# ---------------------------------------------- the eager dispatch guard


def test_collective_fail_retried_across_two_ranks():
    """Both ranks' first launch fails ahead of the collective; the shared
    policy retries it on both, and the result is the clean call's."""
    res = run_world(W.dispatch_worker, 2, "collective_fail=1")
    for r in res:
        np.testing.assert_array_equal(r["got"], r["clean"])
        assert r["retries"] == 1.0 and r["injected"] == 1.0


def test_collective_fail_retried_in_a_world_of_one(world_of_one):
    x = torch.ones(8)
    chaos.configure("collective_fail=1")
    out = hvd.allreduce(x, op=hvd.Average)
    np.testing.assert_array_equal(out.numpy(), 1.0)
    assert metrics.value("resilience_retries",
                         scope="collective_dispatch") == 1.0
    assert chaos.injected["collective_fail"] == 1


def test_dispatch_guard_classifies_like_the_jax_package(world_of_one):
    from horovod_tpu_torch.ops import collective as C

    assert C._transient_dispatch_error(TransientError("x"))
    assert C._transient_dispatch_error(RuntimeError("DEADLINE_EXCEEDED"))
    assert not C._transient_dispatch_error(RuntimeError("device lost"))
    with mock.patch.object(hvd.basics, "process_size", lambda: 2):
        assert not C._transient_dispatch_error(
            RuntimeError("rendezvous aborted"))
        assert C._transient_dispatch_error(TransientError("x"))


def test_collective_delay_and_exhaustion(world_of_one, monkeypatch):
    chaos.configure("collective_delay=0.05")
    t0 = time.monotonic()
    hvd.allreduce(torch.ones(2))
    assert time.monotonic() - t0 >= 0.05
    monkeypatch.setenv("HOROVOD_RETRY_COLLECTIVE_DISPATCH_MAX_ATTEMPTS", "2")
    from horovod_tpu_torch.ops import collective as C

    monkeypatch.setattr(C, "_dispatch_policy", None)
    chaos.configure("collective_fail=5")
    with pytest.raises(RetryError):
        hvd.allreduce(torch.ones(2))
    assert health.health_state() == HealthState.DEGRADED


# ------------------------------------------- preemption-aware training loop


def _count_step(state, step):
    return {"w": state["w"] + 1.0}


class TestPreemptionLoop:
    def test_plain_run_completes(self):
        out = loop.run(_count_step, {"w": np.zeros(2)}, num_steps=4)
        np.testing.assert_allclose(out["w"], 4.0)
        assert health.health_state() == HealthState.HEALTHY

    def test_sigterm_checkpoint_restore_roundtrip(self, world_of_one,
                                                  tmp_path):
        d = str(tmp_path / "ck")
        chaos.configure("sigterm_at_step=2")
        with pytest.raises(loop.Preempted) as ei:
            loop.run(_count_step, {"w": np.zeros(2)}, num_steps=5,
                     checkpoint_dir=d)
        e = ei.value
        assert e.code == loop.RESUMABLE_EXIT_CODE == 75
        assert e.step == 2 and e.signum == signal.SIGTERM
        assert ckpt.latest_step(d) == 2
        assert metrics.value("resilience_preemptions") == 1.0
        assert metrics.value("resilience_emergency_checkpoints") == 1.0
        assert metrics.value("resilience_chaos_injected",
                             site="sigterm_at_step") == 1.0
        chaos.configure(None)
        out = loop.run(_count_step, {"w": np.zeros(2)}, num_steps=5,
                       checkpoint_dir=d)
        np.testing.assert_allclose(out["w"], 5.0)
        assert metrics.value("resilience_resumes") == 1.0

    def test_preempted_is_resumable_system_exit(self):
        p = loop.Preempted(3, "/ck/step_3", signal.SIGTERM)
        assert isinstance(p, SystemExit) and p.code == 75
        assert "step 3" in str(p)
        assert str(p) == str(__import__(
            "horovod_tpu.resilience.loop", fromlist=["Preempted"]
        ).Preempted(3, "/ck/step_3", signal.SIGTERM))

    def test_periodic_checkpoints(self, world_of_one, tmp_path):
        d = str(tmp_path / "ck")
        loop.run(_count_step, {"w": np.zeros(1)}, num_steps=6,
                 checkpoint_dir=d, checkpoint_every=2)
        assert ckpt.valid_steps(d) == [2, 4]

    def test_resume_state_empty_dir(self, tmp_path):
        assert loop.resume_state(str(tmp_path / "none")) is None

    def test_preempt_checkpoints_without_init(self, tmp_path):
        assert not hvd.is_initialized()
        d = str(tmp_path / "ck")
        chaos.configure("sigterm_at_step=1")
        with pytest.raises(loop.Preempted) as ei:
            loop.run(_count_step, {"w": np.zeros(2)}, num_steps=3,
                     checkpoint_dir=d)
        assert ei.value.checkpoint_path is not None
        assert ckpt.latest_step(d) == 1
        chaos.configure(None)
        out = loop.run(_count_step, {"w": np.zeros(2)}, num_steps=3,
                       checkpoint_dir=d)
        np.testing.assert_allclose(out["w"], 3.0)

    def test_signal_restored_after_run(self):
        before = signal.getsignal(signal.SIGTERM)
        loop.run(_count_step, {"w": np.zeros(1)}, num_steps=1)
        assert signal.getsignal(signal.SIGTERM) is before

    def test_callbacks_fire(self):
        from horovod_tpu_torch.callbacks import Callback

        seen = []

        class Spy(Callback):
            def on_train_begin(self, logs=None):
                seen.append("begin")

            def on_batch_end(self, batch, logs=None):
                seen.append(batch)

            def on_train_end(self, logs=None):
                seen.append("end")

        loop.run(_count_step, {"w": np.zeros(1)}, num_steps=2,
                 callbacks=[Spy()])
        assert seen == ["begin", 0, 1, "end"]


def test_double_sigterm_single_drain_valid_checkpoint(world_of_one,
                                                      tmp_path):
    """A second SIGTERM landing during the emergency checkpoint write is
    latched: no drain re-entry, no torn npz."""
    d = str(tmp_path / "ck")
    real_save = ckpt.save
    drains = []

    def noisy_save(directory, step, state, **kw):
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0)
        return real_save(directory, step, state, **kw)

    chaos.configure("sigterm_at_step=2")
    with mock.patch.object(loop, "_drain", lambda st, t=None: drains.append(1)), \
            mock.patch("horovod_tpu_torch.checkpoint.save", noisy_save):
        with pytest.raises(loop.Preempted) as ei:
            loop.run(lambda st, i: {"w": st["w"] + 1}, {"w": np.zeros(2)},
                     num_steps=5, checkpoint_dir=d)
    assert ei.value.step == 2 and len(drains) == 1
    assert ckpt.latest_step(d) == 2
    assert metrics.value("resilience_preemptions") == 1.0
    assert metrics.value("resilience_extra_preempt_signals") == 1.0


def test_preempt_is_not_reentrant():
    chaos.configure("sigterm_at_step=1")
    with pytest.raises(loop.Preempted):
        loop.run(lambda st, i: st, {}, num_steps=3)
    assert metrics.value("resilience_preemptions") == 1.0


def test_emergency_checkpoint_skips_nonfinite_state(tmp_path):
    d = str(tmp_path / "ck")

    def step_fn(st, i):
        if i == 2:
            return {"w": st["w"] * np.nan}
        return {"w": st["w"] + 1}

    chaos.configure("sigterm_at_step=3")
    with pytest.raises(loop.Preempted) as ei:
        loop.run(step_fn, {"w": np.zeros(2)}, num_steps=6,
                 checkpoint_dir=d, checkpoint_every=2)
    assert ei.value.step == 3 and ei.value.checkpoint_path is None
    assert ckpt.latest_step(d) == 2
    assert metrics.value("resilience_emergency_checkpoint_skipped") == 1.0


def test_drain_waits_for_the_core_and_syncs_no_cpu_state():
    """``_drain`` waits while the core reports queued ops (bounded), and
    a state of CPU tensors needs no device synchronization."""
    class Core:
        def __init__(self):
            self.n = 3

        def pending_count(self):
            self.n -= 1
            return max(self.n, 0)

    core = Core()
    with mock.patch.object(hvd.basics._state, "core", core):
        loop._drain({"w": torch.ones(2)}, timeout_s=5)
    assert core.n <= 0


_PREEMPT_CHILD = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from horovod_tpu_torch.resilience import loop
out = loop.run(lambda st, i: {{"w": st["w"] + 1.0}}, {{"w": np.zeros(2)}},
               num_steps=5, checkpoint_dir={d!r})
print("final", float(out["w"][0]))
"""


def test_sigterm_leaves_the_process_with_exit_75(tmp_path):
    """An unguarded script under the chaos SIGTERM exits 75 with the
    emergency checkpoint written; relaunched, it resumes and finishes."""
    d = str(tmp_path / "ck")
    code = _PREEMPT_CHILD.format(root=ROOT, d=d)
    env = dict(os.environ, HOROVOD_CHAOS="sigterm_at_step=2")
    first = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
    assert first.returncode == 75, first.stderr[-2000:]
    assert ckpt.latest_step(d) == 2
    env.pop("HOROVOD_CHAOS")
    second = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120)
    assert second.returncode == 0, second.stderr[-2000:]
    assert second.stdout.split()[-1] == "5.0"


def test_sigterm_in_a_world_exits_75_and_resumes(tmp_path):
    """A gloo world of 2: every rank preempted at step 2 exits 75 (the
    harness reports the code, it does not swallow it); only rank 0
    wrote; a relaunched world resumes and finishes."""
    d = str(tmp_path / "ck")
    with pytest.raises(WorldExit) as ei:
        run_world(W.sigterm_world_worker, 2, d, "sigterm_at_step=2")
    assert ei.value.codes == {0: 75, 1: 75}
    assert ei.value.exitcodes == {0: 75, 1: 75}
    assert ckpt.latest_step(d) == 2
    res = run_world(W.sigterm_world_worker, 2, d, None)
    for r in res:
        np.testing.assert_allclose(r["w"], 5.0)


def test_resume_state_takes_rank_0s_checkpoint(tmp_path):
    """Only rank 0's directory holds the checkpoint: both ranks resume
    from it (rank 0's choice of step, broadcast), and finish."""
    base = str(tmp_path)
    ckpt.save(os.path.join(base, "rank0"), 3,
              {"step": 3, "state": {"w": np.full(2, 3.0)}})
    os.makedirs(os.path.join(base, "rank1"))
    res = run_world(W.resume_worker, 2, base)
    assert res == [{"step": 3, "w": [3.0, 3.0], "final": [5.0, 5.0]}] * 2


def test_resume_state_gives_this_ranks_zero1_state(world_of_one, tmp_path):
    """A ZeRO-1 state saved by ``run``'s checkpoint comes back as this
    rank's state, bit-equal, with its arrays as tensors."""
    from horovod_tpu_torch.models import MLP

    model = MLP((2,), in_features=8)
    tx = hvd.DistributedOptimizer(hvd.adam(1e-2), shard_optimizer=True)
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    st = tx.init(model.jax_params())
    x, y = W.batch_for(0)
    st, _ = step(st, torch.from_numpy(x), torch.from_numpy(y))
    state = {"params": model.jax_params(), "opt_state": st}
    ckpt.save(str(tmp_path), 1, {"step": 1, "state": state})
    got_step, got = loop.resume_state(str(tmp_path))
    assert got_step == 1
    assert got["opt_state"]["shard"] == {"rank": 0, "size": 1}
    for k, v in state["params"].items():
        assert torch.equal(got["params"][k], v)
    for part in ("mu", "nu"):
        for k, v in st["inner"][part].items():
            assert torch.equal(got["opt_state"]["inner"][part][k], v)


# ------------------------------------------------- KV heartbeats / TTL


class TestKVHeartbeats:
    def test_ttl_key_expires_to_tombstone(self):
        s = KVStoreServer()
        s.put("/e/hb/3", b"1", ttl=0.05)
        assert s.get("/e/hb/3") == b"1"
        time.sleep(0.08)
        assert s.get("/e/hb/3") is None
        assert "/e/hb/3" in s.dead_keys()

    def test_refresh_clears_tombstone(self):
        s = KVStoreServer()
        s.put("/e/hb/2", b"1", ttl=0.05)
        time.sleep(0.08)
        assert "/e/hb/2" in s.dead_keys()
        s.put("/e/hb/2", b"1", ttl=5.0)
        assert "/e/hb/2" not in s.dead_keys()
        assert s.get("/e/hb/2") == b"1"

    def test_wait_for_dead_heartbeat_fast_fails(self):
        s = KVStoreServer()
        s.put("/e/hb/5", b"1", ttl=0.05)
        time.sleep(0.08)
        t0 = time.monotonic()
        with pytest.raises(DeadRankError) as ei:
            s.wait_for(["/e/ack/7/5"], timeout=30, hb_scope="/e/hb")
        assert ei.value.rank == 5 and time.monotonic() - t0 < 5

    def test_wait_for_tombstoned_key_itself(self):
        s = KVStoreServer()
        s.put("/e/hb/4", b"1", ttl=0.05)
        time.sleep(0.08)
        with pytest.raises(DeadRankError) as ei:
            s.wait_for(["/e/hb/4"], timeout=30)
        assert ei.value.rank == 4

    def test_wait_for_mid_wait_death(self):
        s = KVStoreServer()
        s.put("/e/hb/6", b"1", ttl=0.15)
        err = []

        def waiter():
            try:
                s.wait_for(["/e/ack/1/6"], timeout=30, hb_scope="/e/hb")
            except BaseException as e:  # noqa: BLE001 - inspected below
                err.append(e)

        t = threading.Thread(target=waiter)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
        assert isinstance(err[0], DeadRankError) and err[0].rank == 6

    def test_wait_for_plain_timeout_and_values(self):
        s = KVStoreServer()
        with pytest.raises(TimeoutError):
            s.wait_for(["/never"], timeout=0.1)
        s.put("/a/1", b"x")
        s.put("/a/2", b"y")
        assert s.wait_for(["/a/1", "/a/2"], timeout=1) == {
            "/a/1": b"x", "/a/2": b"y"}

    def test_background_sweep_expires_and_forgets(self):
        s = KVStoreServer(sweep_interval=0.02, tombstone_ttl=0.05)
        try:
            s.put("/e/hb/1", b"1", ttl=0.03)
            deadline = time.monotonic() + 5
            while metrics.value("rendezvous_keys_swept",
                                kind="tombstone") is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert s.dead_keys() == []
            assert metrics.value("rendezvous_keys_swept",
                                 kind="expired") == 1.0
        finally:
            s.close()


class TestElasticCoordinator:
    def test_liveness_mark_dead_rejoin(self):
        c = elastic.ElasticCoordinator(ttl=5.0)
        try:
            c.heartbeat_all(range(4))
            assert c.alive() == [0, 1, 2, 3]
            c.mark_dead(3)
            c.mark_dead(2)
            assert c.alive() == [0, 1]
            c.heartbeat(2)
            assert c.alive() == [0, 1, 2]
        finally:
            c.close()

    def test_generation_record_and_metrics(self):
        c = elastic.ElasticCoordinator(ttl=5.0)
        try:
            c.heartbeat_all(range(3))
            assert c.begin_generation([0, 1, 2]) == 1
            assert c.membership() == {"generation": 1, "ranks": [0, 1, 2]}
            assert metrics.value("resilience_elastic_generation") == 1.0
            assert metrics.value("resilience_elastic_world_size") == 3.0
            assert c.begin_generation([0, 1]) == 2
            assert metrics.value("resilience_elastic_world_size") == 2.0
        finally:
            c.close()

    def test_barrier_completes_and_prunes_prior_acks(self):
        c = elastic.ElasticCoordinator(ttl=5.0)
        try:
            c.heartbeat_all(range(3))
            g1 = c.begin_generation([0, 1, 2])
            for r in (0, 1, 2):
                c.ack(g1, r)
            c.await_acks(g1, [0, 1, 2], timeout=2)
            g2 = c.begin_generation([0, 1])
            assert c.server.live_keys("/elastic/ack/") == []
            c.ack(g2, 0)
            assert c.server.live_keys("/elastic/ack/") == [
                f"/elastic/ack/{g2}/0"]
        finally:
            c.close()

    def test_barrier_fast_fails_on_dead_member(self):
        c = elastic.ElasticCoordinator(ttl=5.0)
        try:
            c.heartbeat_all(range(3))
            g = c.begin_generation([0, 1, 2])
            c.ack(g, 0)
            c.ack(g, 1)
            c.mark_dead(2)
            t0 = time.monotonic()
            with pytest.raises(DeadRankError) as ei:
                c.await_acks(g, [0, 1, 2], timeout=30)
            assert ei.value.rank == 2 and time.monotonic() - t0 < 5
        finally:
            c.close()


def test_resilience_exports_match_the_jax_package():
    import horovod_tpu.resilience as jres
    import horovod_tpu_torch.resilience as tres

    assert set(jres.__all__) <= set(tres.__all__)
    for name in jres.__all__:
        assert hasattr(tres, name), name
    assert tres.RESUMABLE_EXIT_CODE == jres.RESUMABLE_EXIT_CODE
    assert set(elastic.__all__) == set(__import__(
        "horovod_tpu.resilience.elastic", fromlist=["x"]).__all__)
