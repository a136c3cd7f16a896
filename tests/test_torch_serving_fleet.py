"""Rollout and the fleet tier against the JAX package, f32 on the CPU.

The JAX package's traces (``tests/test_serving_engine.py``'s rollout
cases, ``tests/test_fleet.py``) written once against a package interface
and run through both packages on the same flax weights; what each trace
observes must be equal: the rollout's verdicts and events, the served
tokens, which replica served each request, the fleet's decision log on
the KV, and the counters (failovers, lost replicas, chaos injections,
rollout outcomes).

- ``GenerationRollout``: a healthy canary promotes; a poisoned one
  (non-finite weights past a disabled publish gate) rolls back to G−1,
  is vetoed, and the next healthy generation canaries again;
- ``FleetRouter``: ``replica_kill`` mid-flight, every request completed
  exactly once with tokens equal to ``generate``'s;
- ``FleetRollout``: one fleet-wide promotion through the KV decision
  log, committed decision-first and head last.
"""

import json
import types

import numpy as np
import pytest

import horovod_tpu.observability as jobs
import horovod_tpu.resilience.chaos as jchaos
import horovod_tpu.resilience.health as jhealth
import horovod_tpu.run.rendezvous as jrdv
import horovod_tpu.serving as jserving
import horovod_tpu_torch.observability as tobs
import horovod_tpu_torch.resilience.chaos as tchaos
import horovod_tpu_torch.resilience.health as thealth
import horovod_tpu_torch.run.rendezvous as trdv
import horovod_tpu_torch.serving as tserving
from horovod_tpu_torch.serving.engine import InferenceEngine

import torch_serving_helpers as H

pytestmark = pytest.mark.torch_port

_ENV = ("HOROVOD_SLO", "HOROVOD_SLO_FAST_WINDOW", "HOROVOD_SLO_SLOW_WINDOW",
        "HOROVOD_SLO_BURN_THRESHOLD", "HOROVOD_REQTRACE",
        "HOROVOD_REQTRACE_WINDOW", "HOROVOD_TIMELINE",
        "HOROVOD_FLEET_HEDGE_AFTER", "HOROVOD_FLEET_STATUS_TTL",
        "HOROVOD_RETRY_ROUTE_MAX_ATTEMPTS", "HOROVOD_RETRY_ROUTE_BASE_DELAY",
        "HOROVOD_RETRY_ROUTE_DEADLINE")


def _reset_all():
    for obs, chaos, health, serving in ((jobs, jchaos, jhealth, jserving),
                                        (tobs, tchaos, thealth, tserving)):
        obs.metrics.reset()
        obs.metrics.set_enabled(True)
        health.reset()
        chaos.configure(None)
        for m in ("reqtrace", "slo", "regression", "flight", "trace"):
            __import__(f"{obs.__name__}.{m}", fromlist=["reset"]).reset()
        with serving.publisher._ACTIVE_LOCK:
            serving.publisher._ACTIVE.clear()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    _reset_all()
    yield
    _reset_all()
    jchaos.reset()
    tchaos.reset()


_CACHE: dict = {}


def _pair(depth=1):
    if depth not in _CACHE:
        _CACHE[depth] = H.pair(depth=depth)
    return _CACHE[depth]


def _pkg(which, depth=1):
    jm, tm, p = _pair(depth)
    if which == "jax":
        return types.SimpleNamespace(
            serving=jserving, rdv=jrdv, chaos=jchaos, health=jhealth,
            metrics=jobs.metrics, params=p,
            engine=lambda **kw: jserving.InferenceEngine(jm, **kw),
            subscriber=lambda s: jserving.WeightSubscriber(s, device=True),
            publisher=lambda s, **kw: jserving.WeightPublisher(s, **kw))
    return types.SimpleNamespace(
        serving=tserving, rdv=trdv, chaos=tchaos, health=thealth,
        metrics=tobs.metrics, params=p,
        engine=lambda **kw: InferenceEngine(tm, device="cpu", **kw),
        subscriber=lambda s: tserving.WeightSubscriber(s, device="cpu"),
        publisher=lambda s, **kw: tserving.WeightPublisher(
            s, device="cpu", **kw))


def _scaled(p, f):
    if isinstance(p, dict):
        return {k: _scaled(v, f) for k, v in p.items()}
    return np.asarray(p) * np.float32(f)


def _toks(reqs):
    return [(r.error, list(map(int, r.generated or []))) for r in reqs]


# ---------------------------------------------------------------- rollout


def _rollout_stack(P):
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, keyframe_every=8, register=False)
    sub = P.subscriber(s)
    eng = P.engine(page_size=8, num_pages=40, max_batch=2, prefill_chunk=8,
                   max_seq_len=24)
    events = []
    roll = P.serving.GenerationRollout(
        eng, sub, canary_fraction=1.0, min_canary_requests=2,
        max_latency_ratio=None, on_event=lambda e, g: events.append((e, g)))
    pub.publish({"params": P.params}, 1)
    roll.poll()
    return s, pub, eng, roll, events


def sc_rollout_promotes(P):
    s, pub, eng, roll, events = _rollout_stack(P)
    pub.publish({"params": _scaled(P.params, 1.01)}, 2)
    roll.poll()
    canary = roll.canary_generation
    reqs = [roll.submit(f"canary-seed-{i}", x, 3)
            for i, x in enumerate(H.ragged_prompts(21, (5, 7, 4)))]
    roll.drain()
    s.close()
    return dict(canary=canary, tokens=_toks(reqs),
                gens=(roll.stable_generation, roll.canary_generation,
                      eng.arm_generation("stable"),
                      eng.arm_generation("canary")),
                events=events,
                outcome=P.metrics.value("serving_rollouts",
                                        outcome="promoted"))


def sc_rollout_poisoned_rolls_back(P):
    s, pub, eng, roll, events = _rollout_stack(P)
    pub.publish({"params": _scaled(P.params, np.nan)}, 2)
    roll.poll()
    prompts = H.ragged_prompts(31, (5, 6))
    bad = [roll.submit(f"canary-seed-{i}", x, 3)
           for i, x in enumerate(prompts)]
    roll.drain()
    after = (roll.stable_generation, sorted(roll.vetoed))
    roll.poll()
    pub.publish({"params": _scaled(P.params, 1.01)}, 3)
    roll.poll()
    canary = roll.canary_generation
    good = [roll.submit(f"canary-seed-{10 + i}", x, 2)
            for i, x in enumerate(prompts)]
    roll.drain()
    s.close()
    return dict(bad=_toks(bad), after=after, canary=canary,
                good=_toks(good), stable=roll.stable_generation,
                events=events,
                rolled_back=P.metrics.value("serving_rollouts",
                                            outcome="rolled_back"))


# ------------------------------------------------------------------ fleet


def _fleet(P, s, n=3, **roll_kw):
    router = P.serving.FleetRouter(store=s, hedge_after=0.0)
    for i in range(n):
        router.add_replica(f"r{i}", P.engine(
            page_size=8, num_pages=24, max_batch=2, prefill_chunk=8,
            max_seq_len=32), P.subscriber(s))
    roll_kw.setdefault("canary_fraction", 1.0)
    roll_kw.setdefault("max_latency_ratio", None)
    return router, P.serving.FleetRollout(router, s, **roll_kw)


def sc_fleet_failover_exactly_once(P):
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, keyframe_every=8, register=False)
    router, roll = _fleet(P, s, min_canary_requests=2)
    pub.publish({"params": P.params}, 1)
    router.pump()
    prompts = H.ragged_prompts(5, (6, 9, 5, 7))
    reqs = [router.submit(f"q-{i}", x, 3) for i, x in enumerate(prompts)]
    router.drain()
    P.chaos.configure("replica_kill=0:1")
    reqs2 = [router.submit(f"k-{i}", x, 3) for i, x in enumerate(prompts)]
    router.drain()
    out = dict(tokens=_toks(reqs + reqs2),
               replicas=[q.replica for q in reqs + reqs2],
               dead=[r.id for r in router.replicas if r.dead],
               failed_over=P.metrics.value("fleet_requests_failed_over"),
               ok=P.metrics.value("fleet_requests", arm="stable",
                                  outcome="ok"),
               lost=P.metrics.value("resilience_replicas_lost"),
               injected=P.metrics.value("resilience_chaos_injected",
                                        site="replica_kill"))
    router.close()
    s.close()
    return out


def sc_fleet_promotion_decision_log(P):
    events = []
    s = P.rdv.KVStoreServer()
    pub = P.publisher(s, keyframe_every=8, register=False)
    router, roll = _fleet(P, s, min_canary_requests=4,
                          on_event=lambda e, g: events.append((e, g)))
    pub.publish({"params": P.params}, 1)
    router.pump()
    pub.publish({"params": _scaled(P.params, 1.01)}, 2)
    router.pump()
    canary = [r.engine.arm_generation("canary") for r in router.replicas]
    reqs = [router.submit(f"p-{i}", x, 2)
            for i, x in enumerate(H.ragged_prompts(6, (6, 9, 5, 7)))]
    router.drain()
    log = []
    for e in range(1, roll.head_epoch() + 1):
        d = json.loads(s.get(f"/fleetserve/rollout/decision/{e}"))
        log.append((d["epoch"], d["action"], d["generation"]))
    out = dict(canary=canary, tokens=_toks(reqs), events=events, log=log,
               head=json.loads(s.get("/fleetserve/rollout/epoch"))["epoch"],
               applied=[r.applied_epoch for r in router.replicas],
               stable=[r.engine.arm_generation("stable")
                       for r in router.replicas],
               decisions=P.metrics.value("fleet_serving_decisions",
                                         action="promote"))
    router.close()
    s.close()
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_rollout_promotes, sc_rollout_poisoned_rolls_back,
    sc_fleet_failover_exactly_once, sc_fleet_promotion_decision_log)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serving_scenario_matches_jax(name, monkeypatch):
    monkeypatch.setenv("HOROVOD_PUBLISH_NUMERICS_GATE", "0")
    want = SCENARIOS[name](_pkg("jax"))
    _reset_all()
    got = SCENARIOS[name](_pkg("torch"))
    assert got == want


def test_failover_tokens_equal_generate():
    """The fleet's tokens (after a replica kill) are the port's
    ``generate`` on the same weights."""
    _, tm, p = _pair()
    P = _pkg("torch")
    got = sc_fleet_failover_exactly_once(P)
    prompts = H.ragged_prompts(5, (6, 9, 5, 7))
    want = [list(map(int, w)) for w in H.port_generate(tm, prompts, 3)]
    assert [t for _, t in got["tokens"]] == want + want
    assert all(e is None for e, _ in got["tokens"])
    assert got["dead"] == ["r0"] and got["failed_over"] >= 1
