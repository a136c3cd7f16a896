"""The observability and analysis planes of horovod_tpu_torch against the
JAX package's, as pure functions on identical inputs (no world):

- ``flight.analyze`` of the same per-rank event streams, and of the same
  sidecar files (``load_dir`` + ``analyze_dir``, torn tail included),
  gives equal verdicts;
- ``straggler`` gives the same attribution from the same arrival stamps;
- ``exporters`` gives byte-equal Prometheus and JSON exposition from
  registries fed the same calls;
- ``trace`` gives equal Chrome JSON up to timestamps;
- ``slo``, ``regression`` and ``reqtrace`` give equal verdicts;
- the sanitizer's hash is the same hex for the same op list (JAX arrays
  against torch tensors), and ``cross_check`` names the same divergent
  rank and op under ``_perturb``;
- the fingerprint record of the same gradients matches (per-dtype norms
  within rtol 1e-6, finite flags equal);
- ``lint`` gives the same (rule, path, line) findings for HVD001, HVD002,
  HVD005 and HVD006, and its HVD003/HVD004 scope is ``torch.compile``'s;
- the schedule's signature JSON and fingerprint, the profiler's peak
  table and the gated tuning.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from horovod_tpu.analysis import lint as jlint
from horovod_tpu.analysis import sanitizer as jsan
from horovod_tpu.analysis import schedule as jsched
from horovod_tpu.observability import exporters as jexp
from horovod_tpu.observability import flight as jflight
from horovod_tpu.observability import metrics as jmetrics
from horovod_tpu.observability import regression as jreg
from horovod_tpu.observability import reqtrace as jreq
from horovod_tpu.observability import slo as jslo
from horovod_tpu.observability import straggler as jstrag
from horovod_tpu.observability import trace as jtrace
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import health as jhealth
from horovod_tpu.resilience import numerics as jnum
from horovod_tpu.run.rendezvous import InProcessKVStore as JKV

from horovod_tpu_torch import profiler as tprof
from horovod_tpu_torch import tuning as ttuning
from horovod_tpu_torch.analysis import lint as tlint
from horovod_tpu_torch.analysis import sanitizer as tsan
from horovod_tpu_torch.analysis import schedule as tsched
from horovod_tpu_torch.observability import exporters as texp
from horovod_tpu_torch.observability import flight as tflight
from horovod_tpu_torch.observability import metrics as tmetrics
from horovod_tpu_torch.observability import regression as treg
from horovod_tpu_torch.observability import reqtrace as treq
from horovod_tpu_torch.observability import slo as tslo
from horovod_tpu_torch.observability import straggler as tstrag
from horovod_tpu_torch.observability import trace as ttrace
from horovod_tpu_torch.resilience import chaos as tchaos
from horovod_tpu_torch.resilience import health as thealth
from horovod_tpu_torch.resilience import numerics as tnum
from horovod_tpu_torch.run.rendezvous import InProcessKVStore as TKV

pytestmark = pytest.mark.torch_port

SIDES = (
    dict(flight=jflight, strag=jstrag, metrics=jmetrics, exp=jexp,
         trace=jtrace, slo=jslo, reg=jreg, req=jreq, san=jsan, chaos=jchaos,
         health=jhealth, num=jnum, lint=jlint, kv=JKV),
    dict(flight=tflight, strag=tstrag, metrics=tmetrics, exp=texp,
         trace=ttrace, slo=tslo, reg=treg, req=treq, san=tsan, chaos=tchaos,
         health=thealth, num=tnum, lint=tlint, kv=TKV),
)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("HOROVOD_FLIGHT_DIR", "HOROVOD_HANG_TIMEOUT",
                "HOROVOD_SANITIZE", "HOROVOD_TIMELINE", "HOROVOD_SLO",
                "HOROVOD_STRAGGLER_THRESHOLD", "HOROVOD_STRAGGLER_PERSIST",
                "HOROVOD_NUMERICS_FINGERPRINT"):
        monkeypatch.delenv(var, raising=False)

    def clean():
        for s in SIDES:
            s["metrics"].reset()
            s["metrics"].set_enabled(True)
            s["flight"].reset()
            s["strag"].reset()
            s["health"].reset()
            s["chaos"].reset()
            s["num"].reset()
            s["san"].reset()
            s["slo"].reset()
            s["reg"].reset()
            s["req"].reset()
            s["trace"].reset()
    clean()
    yield
    clean()


def _both(fn):
    """``fn(side)`` on the JAX package, then on the port: both results."""
    return fn(SIDES[0]), fn(SIDES[1])


# ---------------------------------------------------------------- flight


def _stream(keys, end_last=True, ops=None):
    out = []
    for i, (s, q) in enumerate(keys):
        o = (ops or ["allreduce"] * len(keys))[i]
        out.append({"t": float(i), "kind": "collective", "ph": "b",
                    "op": o, "step": s, "gen": 0, "seq": q})
        if end_last or i < len(keys) - 1:
            out.append({"t": float(i) + 0.5, "kind": "collective",
                        "ph": "e", "op": o, "step": s, "gen": 0, "seq": q})
    return out


def _sched(stream, step, h):
    return stream + [{"t": 9.0, "kind": "sched", "step": step, "hash": h,
                      "n": 1}]


SCENARIOS = {
    "rank_missing": ({0: _stream([(0, 0), (0, 1), (1, 0)], False),
                      1: _stream([(0, 0), (0, 1), (1, 0)], False),
                      2: _stream([(0, 0), (0, 1)])}, [0, 1, 2]),
    "no_record_at_all": ({0: _stream([(0, 0)], False)}, [0, 1]),
    "moved_on": ({0: _stream([(0, 0), (0, 1), (1, 0), (1, 1), (2, 0)]),
                  1: _stream([(0, 0), (0, 1)])}, [0, 1]),
    "sched_hash": ({0: _sched(_stream([(0, 0), (1, 0)], False), 0, "aa"),
                    1: _sched(_stream([(0, 0), (1, 0)], False), 0, "bb")},
                   [0, 1]),
    "forked_op": ({0: _stream([(0, 0), (0, 1)], False,
                              ["allreduce", "allreduce"]),
                   1: _stream([(0, 0), (0, 1)], False,
                              ["allreduce", "allgather"])}, [0, 1]),
    "all_parked": ({r: _stream([(0, 0)], False) for r in range(3)},
                   [0, 1, 2]),
    "progressing": ({r: _stream([(0, 0)]) for r in range(3)}, [0, 1, 2]),
    "no_data": ({}, [0]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_flight_analyze_gives_equal_verdicts(name):
    evs, expected = SCENARIOS[name]
    want, got = _both(lambda s: s["flight"].analyze(evs, expected=expected))
    assert got == want
    assert s_describe(got) == jflight.describe(want)


def s_describe(v):
    return tflight.describe(v)


def _write_sidecars(d, streams, world, offsets):
    os.makedirs(d, exist_ok=True)
    for r, evs in streams.items():
        with open(os.path.join(d, f"flight-rank{r}.jsonl"), "w") as f:
            f.write(json.dumps({"kind": "header", "ranks": [r],
                                "world": world, "offset_s": offsets[r],
                                "error_s": 1e-4, "generation": 0,
                                "written_t": 10.0}) + "\n")
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
            if r == 1:      # a write cut by SIGKILL
                f.write('{"t": 3.0, "kind": "collec')


def test_flight_sidecars_load_and_analyze_equally(tmp_path):
    evs, expected = SCENARIOS["rank_missing"]
    d = str(tmp_path / "flight")
    _write_sidecars(d, evs, 3, {0: 0.0, 1: 0.25, 2: -0.5})
    want, got = _both(lambda s: s["flight"].load_dir(d))
    assert got == want
    want, got = _both(lambda s: s["flight"].analyze_dir(d))
    assert got == want and got["hung_ranks"] == [2]


def test_flight_sidecar_roundtrip_of_each_package_loads_in_the_other(
        tmp_path, monkeypatch):
    """Each package records the same events into its own sidecar; each
    file loads in the other package to the same events and header."""
    out = []
    for i, s in enumerate(SIDES):
        d = str(tmp_path / f"side{i}")
        s["flight"].configure(dir=d)
        s["flight"].record("step", step=0)
        s["flight"].collective_begin("allreduce", (0, 0, 0))
        s["flight"].collective_end()
        s["flight"].record("epoch", generation=1, alive=[0, 1])
        s["flight"].flush()
        out.append(d)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "t"}  # noqa: E731
                         for e in evs[0]]
    a = jflight.load_dir(out[1])[0]
    b = tflight.load_dir(out[0])[0]
    assert strip(a) == strip(b)


# ------------------------------------------------------------- straggler


def _arrivals():
    rng = np.random.RandomState(3)
    recs = []
    for step in range(6):
        base = 100.0 + step
        arr = {r: base + float(rng.rand()) * 1e-3 for r in range(4)}
        if step >= 2:
            arr[2] = base + 0.5        # rank 2 late from step 2 on
        recs.append({"key": [step, 0, 0], "op": "allreduce",
                     "arrivals": arr})
    return recs


def test_straggler_attribution_is_equal(monkeypatch):
    monkeypatch.setenv("HOROVOD_STRAGGLER_THRESHOLD", "0.1")
    monkeypatch.setenv("HOROVOD_STRAGGLER_PERSIST", "3")
    recs = _arrivals()

    def run(s):
        s["strag"].reset()
        got = [s["strag"].attribute(recs[:k], expected_ranks=4)
               for k in range(1, len(recs) + 1)]
        return got, s["metrics"].value("straggler_rank"), \
            s["metrics"].value("straggler_collectives", rank=2), \
            s["health"].health_state().name
    want, got = _both(run)
    assert got == want
    assert got[0][-1]["rank"] == 2 and got[3] == "SUSPECT"
    merged = _both(lambda s: s["strag"].merge_arrival_exports(
        [[{"key": r["key"], "op": r["op"],
           "arrivals": {k: v for k, v in r["arrivals"].items() if k < 2}}]
         for r in recs] + [[{"key": r["key"], "op": r["op"],
                             "arrivals": {k: v for k, v in r["arrivals"].items()
                                          if k >= 2}} for r in recs]]))
    assert merged[0] == merged[1]


# ------------------------------------------------------------- exporters


def _feed(m):
    m.counter("allreduce_count", help="eager collectives dispatched").inc(3)
    m.counter("allreduce_bytes", help="payload bytes").inc(4096)
    m.gauge("grad_sync_bytes_per_step", help="ring model",
            mode="sharded").set(1.5e6)
    m.gauge("straggler_rank", help="last rank").set(-1)
    h = m.histogram("train_step_seconds", help="step interval")
    for v in (0.01, 0.2, 0.3, 7.0):
        h.observe(v)
    m.counter("resilience_health_transitions", help="t",
              **{"from": "HEALTHY", "to": 'SUS"PECT\n'}).inc()


def test_exporters_are_byte_equal():
    def run(s):
        _feed(s["metrics"])
        return s["exp"].to_prometheus(), s["exp"].to_json(indent=1)
    want, got = _both(run)
    assert got[0] == want[0]
    assert got[1] == want[1]


# ----------------------------------------------------------------- trace


def test_trace_gives_equal_chrome_json_up_to_timestamps(tmp_path,
                                                       monkeypatch):
    def run(s):
        path = str(tmp_path / f"{s['trace'].__name__}.json")
        monkeypatch.setenv("HOROVOD_TIMELINE", path)
        s["trace"].reset()
        s["trace"].set_recording(True)
        s["trace"].set_epoch()
        with s["trace"].span("step", "train step 0", step=0):
            with s["trace"].span("enqueue", "grad/w"):
                pass
        s["trace"].instant("cycle", "CYCLE_START", n=2)
        s["trace"].set_clock_info({"rank": 1, "offset_s": 0.5,
                                   "error_s": 1e-3})
        assert s["trace"].flush() == path
        with open(path) as f:
            evs = json.load(f)
        for e in evs:
            e.pop("ts", None)
            e.pop("dur", None)
        return evs
    want, got = _both(run)
    assert got == want and len(got) == 4


# ------------------------------------------------- slo, regression, reqtrace


def test_slo_verdicts_are_equal():
    vals = [0.05, 0.6, 0.07, 0.9, 0.8, 0.7, 0.02, 0.01, 0.95, 0.99]

    def run(s):
        reg = s["slo"].SLORegistry("ttft_p99<0.1,error_rate<0.2,"
                                   "step_time<0.5", fast_window=4,
                                   slow_window=8)
        out = []
        for v in vals:
            reg.observe("ttft", v)
            reg.observe("error_rate", 1.0 if v > 0.9 else 0.0)
            reg.observe("step_time", v)
            out.append(reg.status())
        canary = {"ttft": [0.2, 0.21], "done": 2, "errors": 0}
        out.append(reg.judge_canary(canary, {"ttft": [0.01, 0.02],
                                             "done": 2, "errors": 0}))
        out.append(s["health"].health_state().name)
        out.append(s["metrics"].value("resilience_slo_burns",
                                      objective="ttft_p99"))
        return out
    want, got = _both(run)
    assert got == want


def test_regression_verdicts_are_equal():
    series = [1.0, 1.02, 0.98, 1.01, 1.0, 5.0, 5.0, 1.0, 0.99]

    def run(s):
        out = [s["reg"].track("x_step_seconds", v, warmup=3, factor=4.0)
               for v in series]
        out.append(s["reg"].trend([
            {"lm_step_seconds": 1.0, "lm_examples_per_sec": 100.0},
            {"lm_step_seconds": 1.2, "lm_examples_per_sec": 80.0}],
            threshold=0.05))
        out.append(s["metrics"].value("regression_drift_events",
                                      metric="x_step_seconds"))
        return out
    want, got = _both(run)
    assert got == want


class _Req:
    def __init__(self, rid, arm, t):
        self.rid, self.arm, self.submitted_at = rid, arm, t
        self.done_at = None

    def latency_seconds(self):
        return self.done_at - self.submitted_at


class _Seq:
    def __init__(self, req):
        self.req = req


def test_reqtrace_verdicts_are_equal(monkeypatch):
    """Two requests through the lifecycle on a fake clock: the windows,
    quantiles and histograms each package keeps are equal."""
    def run(s):
        clock = iter([1.0 + 0.125 * i for i in range(200)])
        monkeypatch.setattr(s["req"].time, "monotonic", lambda: next(clock))
        reqs = [_Req(f"r{i}", "stable", 0.5 + 0.25 * i) for i in range(2)]
        for r in reqs:
            s["req"].on_enqueue(r)
        for r in reqs:
            seq = _Seq(r)
            s["req"].on_admit(seq)
            s["req"].on_first_token(seq, 1)
            for _ in range(3):
                s["req"].on_token(seq, 1)
            r.done_at = 6.0
            s["req"].on_finish(seq)
        w = s["req"].arm_window("stable")
        return (w, s["req"].quantile(w["ttft"], 0.5),
                s["metrics"].value("reqtrace_tpot_seconds", arm="stable",
                                   generation="1"),
                s["req"].live_requests())
    want, got = _both(run)
    assert got == want and got[0]["done"] == 2


# ------------------------------------------------------------- sanitizer


def _ops(side):
    if side is SIDES[0]:
        mk = lambda shape, dt: jnp.zeros(shape, dt)  # noqa: E731
        f32, bf16, i8 = jnp.float32, jnp.bfloat16, jnp.int8
    else:
        mk = lambda shape, dt: torch.zeros(shape, dtype=dt)  # noqa: E731
        f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    return [("allreduce", [mk((64, 32), f32), mk((32,), f32)], None),
            ("allgather", [mk((8, 256), i8)], None),
            ("reducescatter", [mk((2080,), bf16)], "data"),
            ("broadcast", [mk((), f32)], ("cross", "local"))]


def test_sanitizer_hash_is_the_same_hex():
    def run(s):
        s["san"].configure(True, kv=s["kv"](), world=1)
        for op, ts, axis in _ops(s):
            s["san"].record(op, ts, axis=axis)
        with s["san"]._lock:
            return s["san"]._snapshot_locked()
    want, got = _both(run)
    assert got == want and len(got["hash"]) == 64


def test_sanitizer_cross_check_names_the_same_rank_and_op():
    def run(s):
        kv = s["kv"]()
        s["san"].configure(True, kv=kv, world=4)
        s["chaos"].configure("schedule_diverge_at_step=1")
        out = []
        for step in range(3):
            s["san"].set_step(step)
            for op, ts, axis in _ops(s):
                s["san"].record(op, ts, axis=axis)
        out.append(s["san"].flush())
        out.append(s["san"].last_divergence())
        out.append(s["metrics"].value("sanitizer_schedule_divergence",
                                      rank=3))
        out.append(s["san"]._perturb({"hash": "0" * 64, "n": 1, "dropped": 0,
                                      "ops": [["allreduce", "data", []]]}))
        return out
    want, got = _both(run)
    assert got == want
    d = got[1]
    assert d["rank"] == 3 and d["step"] == 1


# ------------------------------------------------------ fingerprint record


def test_fingerprint_record_of_the_same_gradients(monkeypatch):
    rng = np.random.RandomState(5)
    g = {"a": rng.randn(64, 8).astype(np.float32),
         "b": rng.randn(17).astype(np.float32),
         "c": (rng.randn(33) * 4).astype(np.float32)}

    def run(s):
        kv = s["kv"]()
        s["num"].configure(kv=kv, fingerprint=True)
        if s is SIDES[0]:
            p = {k: jnp.zeros(v.shape, jnp.bfloat16 if k == "c"
                              else jnp.float32) for k, v in g.items()}
            gr = {k: jnp.asarray(v, p[k].dtype) for k, v in g.items()}
            tx = jnum.guard(optax.sgd(1.0))
        else:
            p = {k: torch.zeros(v.shape, dtype=torch.bfloat16 if k == "c"
                                else torch.float32) for k, v in g.items()}
            gr = {k: torch.from_numpy(v).to(p[k].dtype) for k, v in g.items()}
            from horovod_tpu_torch import optim as topt

            tx = tnum.guard(topt.sgd(1.0) if hasattr(topt, "sgd")
                            else topt.adam(1.0))
        _, st = tx.update(gr, tx.init(p), p)
        s["num"].note_step(0, st)
        s["num"].publish_fingerprint(0)
        return json.loads(kv.get(s["num"].fingerprint_key(0, 0)))
    want, got = _both(run)
    assert got["finite"] == want["finite"] == 1
    assert set(got["per_dtype"]) == set(want["per_dtype"]) == \
        {"float32", "bfloat16"}
    for k, v in want["per_dtype"].items():
        np.testing.assert_allclose(got["per_dtype"][k], v, rtol=1e-6)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-6)


def test_fingerprint_cross_check_quarantines_the_same_rank():
    recs = {0: {"finite": 1, "norm": 1.0}, 1: {"finite": 1, "norm": 1.1},
            2: {"finite": 0, "norm": None}, 3: {"finite": 1, "norm": 0.9}}

    def run(s):
        kv = s["kv"]()
        s["num"].configure(kv=kv, fingerprint=True)
        for r, rec in recs.items():
            kv.put(s["num"].fingerprint_key(7, r),
                   json.dumps(dict(rec, step=7)).encode())
        real = s["num"]._identity
        s["num"]._identity = lambda: (4, 0, 4)
        try:
            found = s["num"].cross_check_fingerprints(7)
        finally:
            s["num"]._identity = real
        return (found, s["num"].quarantine_pending(),
                s["num"].publish_gate_reason(None, {}),
                s["health"].health_state().name,
                s["num"].take_corrupt_ranks(),
                s["num"].quarantine_pending())
    want, got = _both(run)
    assert got == want
    assert got[0][0]["rank"] == 2 and got[2] == "quarantine"


# ------------------------------------------------------------------ lint


LINT_SOURCES = {
    "rank_branch.py": '''
import horovod_tpu as hvd

def f(x):
    if hvd.rank() == 0:
        hvd.allreduce(x)
    return x

def g(x):
    if hvd.rank() != 0:
        return None
    return hvd.broadcast(x, 0)
''',
    "loops.py": '''
import horovod_tpu as hvd

def h(x, n):
    while float(x.sum()) > 0:
        x = hvd.allreduce(x)
    for _ in range(int(x.max())):
        x = hvd.allgather(x)
    for _ in range(3):
        x = hvd.allreduce(x)
    return x
''',
    "threads.py": '''
import threading

_seen = {}
_lock = threading.Lock()

def worker():
    _seen["a"] = 1
    with _lock:
        _seen["b"] = 2

def start():
    threading.Thread(target=worker).start()

def swallow():
    try:
        start()
    except:
        pass
    try:
        start()
    except ValueError:
        pass
''',
}


def test_lint_findings_are_equal_for_the_shared_rules(tmp_path):
    for name, src in LINT_SOURCES.items():
        (tmp_path / name).write_text(src)
    shared = {"HVD001", "HVD002", "HVD005", "HVD006"}

    def run(s):
        return sorted((f.rule, os.path.basename(f.path), f.line)
                      for f in s["lint"].lint_paths([str(tmp_path)])
                      if f.rule in shared)
    want, got = _both(run)
    assert got == want
    assert {r for r, _, _ in got} == shared


def test_lint_traced_rules_scope_torch_compile():
    src = '''
import time
import torch

@torch.compile
def step(x):
    t = time.time()
    return x.sum().item() + t

def plain(x):
    return x.sum().item() + time.time()

fast = torch.jit.script(plain)
'''
    rules = sorted((f.rule, f.line) for f in tlint.lint_source(src, "m.py"))
    assert ("HVD003", 8) in rules and ("HVD004", 7) in rules
    assert ("HVD003", 11) in rules and ("HVD004", 11) in rules
    # the JAX package's scope is jit's, so it finds none of these
    assert not [f for f in jlint.lint_source(src, "m.py")
                if f.rule in ("HVD003", "HVD004")]
    assert tlint.main([__file__]) in (0, 1)


# -------------------------------------------- schedule, profiler, tuning


def test_schedule_signature_json_and_fingerprint_match():
    ops = [("psum", ("data",), (32,), "float32", ()),
           ("all_to_all", ("data",), (8, 256), "int8", ()),
           ("all_gather", ("data",), (260,), "float32", ())]
    js = jsched.Schedule(ops=[jsched.CollectiveSig(*o) for o in ops])
    ts = tsched.Schedule(ops=[tsched.CollectiveSig(*o) for o in ops])
    assert ts.to_json() == js.to_json()
    assert ts.fingerprint() == js.fingerprint()
    other = tsched.Schedule(ops=ts.ops[:2])
    with pytest.raises(tsched.ScheduleDivergence, match="extra"):
        tsched.assert_same_schedule(ts, other)


def test_profiler_peaks_are_nvidia_only_and_tuning_is_gated():
    assert tprof.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tprof.device_peak_hbm_bytes("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tprof.device_peak_flops("TPU v5 lite") is None
    assert tprof.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert tprof.device_peak_flops() is None
    assert ttuning.apply_xla_flags("overlap", env={}) == ([], [])
    assert ttuning.maybe_apply_from_env({}) == ([], [])
    with pytest.raises(ValueError):
        ttuning.apply_xla_flags("nope", env={})
    fenced, dt = tprof.timed_steps(lambda: torch.tensor(1.0), 3, lag=1)
    assert fenced == [1.0] * 3 and dt >= 0


def test_profiler_timeline_writes_a_chrome_trace(tmp_path):
    with tprof.timeline(str(tmp_path)):
        with tprof.annotate("my_region"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_region" for e in evs)


# ------------------------------------------------------ traffic counters


def test_traffic_gauges_price_the_wire_as_the_jax_package():
    """``grad_sync_bytes_per_step`` and ``param_gather_bytes_per_step``
    from the same leaves, compressor and world size."""
    from horovod_tpu import optim as jopt
    from horovod_tpu.compression import Compression as JC
    from horovod_tpu_torch import optim as topt
    from horovod_tpu_torch.compression import Compression as TC

    shapes = [(64, 32), (32,), (3, 3, 64, 128), (7,)]
    for jc, tc in ((JC.none, TC.none), (JC.fp16, TC.fp16),
                   (JC.int8, TC.int8)):
        jt = {f"l{i}": jnp.zeros(s, jnp.float32)
              for i, s in enumerate(shapes)}
        tl = [torch.zeros(s) for s in shapes]
        want = jopt._tree_sync_wire_bytes(jt, jc)
        got = topt._tree_sync_wire_bytes(tl, tc)
        assert got == want, (jc, got, want)
        for mode in ("allreduce", "sharded"):
            jopt._record_sync_bytes(mode, 4, want, 1000)
            topt._record_sync_bytes(mode, 4, got, 1000)
            for name in ("grad_sync_bytes_per_step",
                         "param_gather_bytes_per_step"):
                assert tmetrics.value(name, mode=mode) == \
                    jmetrics.value(name, mode=mode)


def test_metrics_callback_records_the_fit_loop():
    from horovod_tpu.callbacks import MetricsCallback as JCB
    from horovod_tpu_torch.callbacks import MetricsCallback as TCB

    class Trainer:
        global_batch_size = 32

    out = []
    for cb, m in ((JCB(every_n_steps=2, printer=out.append), jmetrics),
                  (TCB(every_n_steps=2, printer=out.append), tmetrics)):
        cb.set_trainer(Trainer())
        for b in range(4):
            cb.on_batch_begin(b)
            cb.on_batch_end(b)
        assert m.value("fit_batches") == 4.0
        assert m.value("fit_examples") == 128.0
        assert m.value("fit_batch_seconds")["count"] == 4
    assert len(out) == 4 and all("metrics @ batch" in o for o in out)


def test_tape_counts_its_exchanges():
    """``tape_steps``/``tape_grad_bytes``, the JAX tape's counters, in a
    world of one."""
    import horovod_tpu_torch as thvd

    thvd.init(device="cpu")
    try:
        g = {"w": torch.ones(4, 8), "b": torch.ones(3, dtype=torch.bfloat16)}
        tape = thvd.DistributedGradientTape(lambda: (torch.tensor(1.0), g))
        for _ in range(2):
            loss, out = tape()
        assert tmetrics.value("tape_steps") == 2.0
        assert tmetrics.value("tape_grad_bytes") == 2.0 * (32 * 4 + 3 * 2)
    finally:
        thvd.shutdown()
