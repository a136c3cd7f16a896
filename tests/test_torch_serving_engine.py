"""The serving engine and its scheduler against the JAX package's, in f32
on the CPU.

Each scenario is one of the JAX package's serving traces
(``tests/test_serving_engine.py``, ``tests/test_prefix_spec.py``), written
once against a small package interface and run through both packages on
the same flax weights: the greedy tokens must be identical, and so must
the scheduler's decisions (pages in use and queue depth after every
iteration) and the counters the trace reads (prefill tokens, prefix
hits, speculative proposals and acceptances, chaos injections,
admission rejections). The port's tokens are also held against its own
``generate``. The tensor-parallel engine runs in a gloo world of 2
(``test_torch_serving_tp.py``).
"""

import types

import numpy as np
import pytest
import torch
import jax

import horovod_tpu.observability.metrics as jmetrics
import horovod_tpu.resilience.chaos as jchaos
import horovod_tpu.resilience.health as jhealth
import horovod_tpu.serving as jserving
import horovod_tpu_torch.observability.metrics as tmetrics
import horovod_tpu_torch.resilience.chaos as tchaos
import horovod_tpu_torch.resilience.health as thealth
import horovod_tpu_torch.serving as tserving
from horovod_tpu_torch.models.convert import load_flax_variables
from horovod_tpu_torch.serving.engine import InferenceEngine

import torch_serving_helpers as H

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _fresh():
    for m, c, h in ((jmetrics, jchaos, jhealth), (tmetrics, tchaos, thealth)):
        m.reset()
        m.set_enabled(True)
        h.reset()
        c.configure(None)
    yield
    for m, c, h in ((jmetrics, jchaos, jhealth), (tmetrics, tchaos, thealth)):
        m.reset()
        h.reset()
        c.reset()


_CACHE: dict = {}


def _pair(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _CACHE:
        _CACHE[key] = H.pair(**kw)
    return _CACHE[key]


def _pkg(which: str, **model_kw):
    """The package interface a scenario is written against."""
    jm, tm, p = _pair(**model_kw)
    if which == "jax":
        def engine(**kw):
            return jserving.InferenceEngine(jm, **kw)
        return types.SimpleNamespace(engine=engine, params=p,
                                     metrics=jmetrics, chaos=jchaos,
                                     depth=jm.depth)

    def engine(**kw):
        return InferenceEngine(tm, device="cpu", **kw)
    return types.SimpleNamespace(engine=engine, params=p, metrics=tmetrics,
                                 chaos=tchaos, depth=tm.depth)


def _eng(P, *, generation=1, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_seq_len", 48)
    e = P.engine(**kw)
    e.set_weights(P.params, generation=generation)
    return e


def _drive(e, log):
    """run_until_idle, logging (pages in use, queue depth, active) after
    every iteration: the scheduler's decisions."""
    for _ in range(10000):
        if e.scheduler.idle():
            return
        e.step()
        log.append((e.scheduler.pages_in_use(), e.scheduler.queue_depth(),
                    len(e.scheduler.active())))
    raise RuntimeError("engine did not drain")


def _serve(e, prompts, max_new, tag, log, **kw):
    reqs = [e.submit(p, max_new, rid=f"{tag}-{i}", **kw)
            for i, p in enumerate(prompts)]
    _drive(e, log)
    for r in reqs:
        assert r.error is None, r.error
    return [list(map(int, r.generated)) for r in reqs]


def _m(P, name, **labels):
    return P.metrics.value(name, **labels)


# ---------------------------------------------------------------- scenarios
# each returns what the two packages must agree on


def sc_ragged_overflow(P, log):
    """5 requests through 3 slots: joins and leaves mid-flight."""
    e = _eng(P, page_size=8, num_pages=40, max_batch=3, max_seq_len=32)
    out = _serve(e, H.ragged_prompts(42, (5, 11, 3, 8, 14)), 6, "r", log)
    assert e.scheduler.pages_in_use() == 0
    return dict(tokens=out)


def sc_staggered(P, log):
    e = _eng(P, page_size=8, num_pages=40, max_batch=4, max_seq_len=32)
    prompts = H.ragged_prompts(7, (9, 4, 13, 6))
    first = [e.submit(p, 5, rid=f"a{i}") for i, p in enumerate(prompts[:2])]
    for _ in range(3):
        e.step()
    late = [e.submit(p, 5, rid=f"b{i}") for i, p in enumerate(prompts[2:])]
    _drive(e, log)
    return dict(tokens=[list(map(int, r.generated)) for r in first + late])


def sc_chunked_prefill(P, log):
    e = _eng(P, page_size=8, num_pages=16, max_batch=2, max_seq_len=32)
    out = _serve(e, H.ragged_prompts(3, (21,)), 4, "long", log)
    return dict(tokens=out, prefills=_m(P, "serving_engine_steps",
                                        kind="prefill"),
                prefill_tokens=_m(P, "serving_prefill_tokens"))


def sc_backpressure(P, log):
    """5 allocatable pages of 8, each request needs 3: the second waits
    in the queue until the first frees its pages."""
    e = _eng(P, page_size=8, num_pages=6, max_batch=2, max_seq_len=24)
    out = _serve(e, H.ragged_prompts(11, (10, 10)), 8, "bp", log)
    return dict(tokens=out, admitted=_m(P, "serving_sequences_admitted"))


def sc_prefix_warm(P, log):
    lens = (19, 8, 27, 12, 33)
    prompts = H.ragged_prompts(3, lens)
    e = _eng(P, prefix_cache=True)
    cold = _serve(e, prompts, 8, "cold", log)
    t_cold = _m(P, "serving_prefill_tokens")
    warm = _serve(e, prompts, 8, "warm", log)
    assert warm == cold
    assert _m(P, "serving_prefix_hits") > 0
    return dict(tokens=warm, cold_prefill=t_cold,
                warm_prefill=_m(P, "serving_prefill_tokens") - t_cold,
                hits=_m(P, "serving_prefix_hits"))


def sc_prefix_mid_flight(P, log):
    prompts = H.ragged_prompts(7, (21, 9, 26, 17))
    e = _eng(P, prefix_cache=True)
    base = _serve(e, prompts, 8, "cold", log)
    reqs = [e.submit(p, 8, rid=f"j{i}") for i, p in enumerate(prompts[:2])]
    for _ in range(4):
        e.step()
    reqs += [e.submit(p, 8, rid=f"j{i + 2}")
             for i, p in enumerate(prompts[2:])]
    _drive(e, log)
    got = [list(map(int, r.generated)) for r in reqs]
    assert got == base
    return dict(tokens=got, hits=_m(P, "serving_prefix_hits"))


def sc_prefix_off(P, log):
    prompts = H.ragged_prompts(1, (17, 17))
    e = _eng(P, prefix_cache=False)
    a = _serve(e, prompts, 4, "a", log)
    b = _serve(e, prompts, 4, "b", log)
    assert e.scheduler.cached_page_count() == 0
    return dict(tokens=a + b, hits=_m(P, "serving_prefix_hits"))


def sc_prefix_generation_namespace(P, log):
    prompts = H.ragged_prompts(2, (19,))
    e = _eng(P, prefix_cache=True)
    base = _serve(e, prompts, 6, "g1", log)
    e.set_weights(P.params, generation=2)
    warm = _serve(e, prompts, 6, "g2", log)
    return dict(tokens=base + warm, hits=_m(P, "serving_prefix_hits"),
                misses=_m(P, "serving_prefix_misses"))


def sc_spec_full_depth(P, log):
    prompts = H.ragged_prompts(3, (19, 8, 27, 12, 5))
    base = _serve(_eng(P, prefix_cache=False), prompts, 10, "p", log)
    spec = _eng(P, prefix_cache=False, draft_depth=P.depth, spec_lookahead=3)
    out = _serve(spec, prompts, 10, "s", log)
    assert out == base
    assert _m(P, "spec_rollbacks") is None       # the draft IS the target
    return dict(tokens=out, proposed=_m(P, "spec_proposed"),
                accepted=_m(P, "spec_accepted"))


def sc_spec_shallow_mid_flight(P, log):
    prompts = H.ragged_prompts(5, (21, 9, 26, 17, 6, 13))
    base = _serve(_eng(P), prompts, 9, "p", log)
    spec = _eng(P, draft_depth=1, spec_lookahead=4)
    reqs = [spec.submit(p, 9, rid=f"s-{i}") for i, p in enumerate(prompts[:3])]
    for _ in range(5):
        spec.step()
    reqs += [spec.submit(p, 9, rid=f"s-{i + 3}")
             for i, p in enumerate(prompts[3:])]
    _drive(spec, log)
    got = [list(map(int, r.generated)) for r in reqs]
    assert got == base
    assert _m(P, "spec_rollbacks") > 0
    return dict(tokens=got, proposed=_m(P, "spec_proposed"),
                accepted=_m(P, "spec_accepted"),
                rollbacks=_m(P, "spec_rollbacks"))


def sc_spec_on_prefix_cache(P, log):
    prompts = H.ragged_prompts(8, (19, 25, 11))
    base = _serve(_eng(P, prefix_cache=False), prompts, 10, "p", log)
    spec = _eng(P, prefix_cache=True, draft_depth=1, spec_lookahead=3)
    cold = _serve(spec, prompts, 10, "c", log)
    warm = _serve(spec, prompts, 10, "w", log)
    assert warm == cold == base
    return dict(tokens=warm, hits=_m(P, "serving_prefix_hits"))


def sc_spec_sampled_rows_fall_back(P, log):
    """Sampled rows never speculate (tokens are drawn on the host from
    the rid-seeded sampler, the same in both packages)."""
    prompts = H.ragged_prompts(6, (12, 15))
    base = _serve(_eng(P), prompts, 8, "t", log, temperature=0.7)
    spec = _eng(P, draft_depth=1, spec_lookahead=3)
    out = _serve(spec, prompts, 8, "t", log, temperature=0.7)
    assert out == base
    return dict(tokens=out, proposed=_m(P, "spec_proposed"))


def sc_cache_evict_chaos(P, log):
    prompts = H.ragged_prompts(3, (19, 8, 27, 12))
    e = _eng(P, prefix_cache=True)
    base = _serve(e, prompts, 10, "b", log)
    P.chaos.configure(f"cache_evict_at_pass={e._step_count + 6}")
    out = _serve(e, prompts, 10, "v", log)
    assert out == base
    assert e.scheduler.pages_in_use() == 0
    return dict(tokens=out, injected=_m(P, "resilience_chaos_injected",
                                        site="cache_evict_at_pass"),
                hits=_m(P, "serving_prefix_hits"),
                evictions=_m(P, "serving_prefix_evictions"))


def sc_request_burst_chaos(P, log):
    e = _eng(P, page_size=8, num_pages=40, max_batch=2, max_seq_len=16,
             max_queue=3)
    P.chaos.configure("request_burst=6")
    e.step()
    first = _m(P, "resilience_chaos_injected", site="request_burst")
    _drive(e, log)
    e.step()
    return dict(first=first, injected=_m(P, "resilience_chaos_injected",
                                         site="request_burst"),
                rejected=_m(P, "serving_admission_rejected",
                            reason="queue_full"))


def sc_slow_decode_chaos(P, log):
    """``slow_decode`` on the canary arm only: tokens unchanged, the
    injection counted on the arm's passes."""
    prompts = H.ragged_prompts(4, (7, 9))
    e = _eng(P)
    e.set_weights(P.params, generation=2, arm="canary")
    P.chaos.configure("slow_decode=0.001:canary")
    a = [e.submit(p, 4, rid=f"s{i}") for i, p in enumerate(prompts)]
    c = [e.submit(p, 4, rid=f"c{i}", arm="canary")
         for i, p in enumerate(prompts)]
    _drive(e, log)
    return dict(tokens=[list(map(int, r.generated)) for r in a + c],
                injected=_m(P, "resilience_chaos_injected",
                            site="slow_decode"))


def sc_arms_promote_and_retire(P, log):
    """A canary arm serves its slice, is promoted mid-flight (the old
    stable's sequences drain on their own weights), then a second canary
    is retired (queued requests re-route to stable)."""
    prompts = H.ragged_prompts(9, (6, 10, 8, 5))
    e = _eng(P)
    e.set_weights(P.params, generation=2, arm="canary")
    s = [e.submit(prompts[0], 5, rid="st0"),
         e.submit(prompts[1], 5, rid="ca0", arm="canary")]
    for _ in range(2):
        e.step()
    e.promote_canary()
    gens = (e.arm_generation("stable"), e.arm_generation("canary"))
    _drive(e, log)
    e.set_weights(P.params, generation=3, arm="canary")
    q = [e.submit(prompts[2], 5, rid="ca1", arm="canary"),
         e.submit(prompts[3], 5, rid="st1")]
    e.retire_arm("canary")
    _drive(e, log)
    return dict(tokens=[list(map(int, r.generated)) for r in s + q],
                arms=[r.arm for r in q], gens=gens,
                after=(e.arm_generation("stable"),
                       e.arm_generation("canary")))


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_ragged_overflow, sc_staggered, sc_chunked_prefill, sc_backpressure,
    sc_prefix_warm, sc_prefix_mid_flight, sc_prefix_off,
    sc_prefix_generation_namespace, sc_spec_full_depth,
    sc_spec_shallow_mid_flight, sc_spec_on_prefix_cache,
    sc_spec_sampled_rows_fall_back, sc_cache_evict_chaos,
    sc_request_burst_chaos, sc_slow_decode_chaos,
    sc_arms_promote_and_retire)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_jax(name):
    fn = SCENARIOS[name]
    jlog, tlog = [], []
    want = fn(_pkg("jax"), jlog)
    for m, c in ((jmetrics, jchaos), (tmetrics, tchaos)):
        m.reset()
        c.configure(None)
    got = fn(_pkg("torch"), tlog)
    assert got == want
    assert tlog == jlog


@pytest.mark.parametrize("case", ["learned", "rope_gqa"])
def test_engine_matches_generate_ragged(case):
    """Greedy decode through the paged engine equals the port's
    ``generate`` (and the JAX package's) for a ragged batch that
    overflows the slots."""
    kw = {} if case == "learned" else dict(pos="rope", kv_heads=2)
    jm, tm, p = _pair(**kw)
    prompts = H.ragged_prompts(42, (5, 11, 3, 8, 14))
    want = H.port_generate(tm, prompts, 6)
    jwant = H.jax_generate(jm, p, prompts, 6)
    e = InferenceEngine(tm, device="cpu", page_size=8, num_pages=40,
                        max_batch=3, prefill_chunk=8, max_seq_len=32)
    e.set_weights(p, generation=1)
    reqs = [e.submit(x, 6, rid=f"r{i}") for i, x in enumerate(prompts)]
    e.run_until_idle()
    for r, w, jw in zip(reqs, want, jwant):
        np.testing.assert_array_equal(np.asarray(r.generated), w)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(r.tokens, np.concatenate([r.prompt, w]))


@pytest.mark.parametrize("draft_depth", [None, 1])
def test_engine_pass_seconds_by_kind(draft_depth):
    """``pass_seconds`` holds a positive sum for each kind of pass that
    ran, and only for those: the kinds whose forward the
    ``serving_engine_steps`` counter saw."""
    _, tm, p = _pair()
    e = InferenceEngine(tm, device="cpu", page_size=8, num_pages=40,
                        max_batch=3, prefill_chunk=8, max_seq_len=32,
                        draft_depth=draft_depth, spec_lookahead=2)
    e.set_weights(p, generation=1)
    for i, x in enumerate(H.ragged_prompts(7, (5, 11, 3, 8))):
        e.submit(x, 6, rid=f"s{i}")
    e.run_until_idle()
    ran = {k for k, v in (("prefill", "prefill"), ("spec", "spec_verify"),
                          ("decode", "decode"))
           if tmetrics.value("serving_engine_steps", kind=v)}
    assert ran == ({"prefill", "spec", "decode"} if draft_depth
                   else {"prefill", "decode"})
    assert set(e.pass_seconds) == ran
    assert all(v > 0 for v in e.pass_seconds.values())


def test_engine_takes_tensor_and_flat_trees():
    """Weights as the port's flat ``jax_params()`` tensors (a training
    state's ``params``, live parameters) serve the same tokens as the
    numpy flax tree, and the engine owns copies: training on after the
    install does not reach the served weights."""
    _, tm, p = H.pair()
    prompts = H.ragged_prompts(1, (6, 9))
    outs = []
    for live in (False, True):
        load_flax_variables(tm, p)
        e = InferenceEngine(tm, device="cpu", page_size=8, num_pages=16,
                            max_batch=2, prefill_chunk=8, max_seq_len=32)
        e.set_weights({"params": tm.jax_params()} if live else p,
                      generation=1)
        with torch.no_grad():
            for w in tm.parameters():
                w.mul_(1.5)
        reqs = [e.submit(x, 4, rid=f"t{i}") for i, x in enumerate(prompts)]
        e.run_until_idle()
        outs.append([list(r.generated) for r in reqs])
    assert outs[0] == outs[1]


def test_engine_validation_errors():
    _, tm, p = _pair()
    with pytest.raises(ValueError, match="max_len"):
        InferenceEngine(tm, device="cpu", max_seq_len=128)
    with pytest.raises(ValueError, match="page pool too small"):
        InferenceEngine(tm, device="cpu", page_size=8, num_pages=4,
                        prefill_chunk=8, max_seq_len=48)
    with pytest.raises(ValueError, match="draft_depth"):
        InferenceEngine(tm, device="cpu", page_size=8, num_pages=16,
                        prefill_chunk=8, max_seq_len=16, draft_depth=3)
    e = InferenceEngine(tm, device="cpu", page_size=8, num_pages=16,
                        max_batch=1, prefill_chunk=8, max_seq_len=16,
                        draft_depth=1)
    with pytest.raises(ValueError, match="truncation"):
        e.set_draft_weights({"tok_embed": {"embedding": np.zeros((3, 3))}})
    e.submit(np.ones(4, np.int32), 2, rid="w")
    with pytest.raises(RuntimeError, match="no weights"):
        e.run_until_idle()
    e.set_weights(p, generation=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        e.submit(np.ones(14, np.int32), 8, rid="big")
    with pytest.raises(RuntimeError, match="hvd.init"):
        InferenceEngine(tm, device="cpu", tp_axis="tp")   # no mesh


def test_engine_needs_cuda_unless_told_the_cpu(monkeypatch):
    from horovod_tpu_torch import basics

    _, tm, _ = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not basics.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.WeightSubscriber(object(), device=True)


def test_poisoned_page_never_leaks_into_later_requests():
    """A generation whose weights are NaN fills the pages it wrote with
    NaN; after its requests fail (non-finite logits) and free their
    pages, clean requests on good weights reuse those pages and stay
    finite and token-identical to a fresh engine (the zeroing in
    paged_decode_attention)."""
    _, tm, p = _pair()
    bad = jax.tree_util.tree_map(lambda a: a * np.float32("nan"), p)
    prompts = H.ragged_prompts(12, (9, 13))
    e = InferenceEngine(tm, device="cpu", page_size=8, num_pages=8,
                        max_batch=2, prefill_chunk=8, max_seq_len=24)
    e.set_weights(bad, generation=1)
    r = [e.submit(x, 4, rid=f"bad{i}") for i, x in enumerate(prompts)]
    e.run_until_idle()
    assert all(x.error == "non-finite logits" for x in r)
    assert any(torch.isnan(k).any() for k, _ in e._cache)
    e.set_weights(p, generation=2)
    good = [e.submit(x, 6, rid=f"ok{i}") for i, x in enumerate(
        H.ragged_prompts(13, (5, 11)))]
    e.run_until_idle()
    fresh = H.port_generate(tm, H.ragged_prompts(13, (5, 11)), 6)
    for x, w in zip(good, fresh):
        assert x.error is None
        np.testing.assert_array_equal(np.asarray(x.generated), w)
