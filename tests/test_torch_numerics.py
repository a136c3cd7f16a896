"""The numerics guard of horovod_tpu_torch against the JAX package's
(``horovod_tpu/resilience/numerics.py``), on the CPU, same inputs made
from numpy seeds.

- ``TestGuard``: the JAX package's guard unit cases
  (``tests/test_numerics.py``'s ``TestGuard``), one for one, each run on
  both packages (the JAX guard outside ``shard_map``, the port's before
  ``hvd.init``: the unbound route of both) and held against each other:
  integer fields and ``loss_scale`` exact, ``ewma``, ``last_norm``,
  ``norms`` and ``rank_norms`` within rtol 1e-6 (the port squares each
  leaf's f32 norm where JAX sums its squares, and adds the leaves in
  another order: a few ULPs apart), the updates bit for bit (SGD, and
  Adam op by op: optax unjitted rounds each operation as the port
  does), plus the JAX test's own assertions on the port's run;
- ``TestChaosCharges``: the grad-NaN and grad-spike charges, the same;
- the loss-scale trajectory (``test_jit_builder_loss_scaling_matches_
  unscaled``): ``make_train_step`` with a guarded, loss-scaled optimizer
  tracks the unguarded one and returns the unscaled loss;
- a gloo world of 2 against a 2-device JAX mesh, the JAX guard inside
  ``shard_map`` (the bound-axis route): the composition matrix —
  allreduce mode and ZeRO-1 (int8 + EF), Adasum, PowerSGD,
  ``backward_passes_per_step=2``, bucketed ZeRO-1 — over the same
  per-rank gradients with a NaN step (``grad_nan_at_step``), a NaN loss
  on one rank only, and a scale backoff: the verdicts as above, the
  parameters within each path's own bar, and on a BAD step the port's
  parameters and whole inner state bit-identical to the step before;
  then the ZeRO-1 int8 + EF step end to end through
  ``make_shardmap_train_step`` against ``make_train_step`` (the MLP,
  ``loss_scale="dynamic"``): step 0's norms within 1e-6, every later one
  within the int8 trajectory bar (rtol 5e-3: the two frameworks'
  gradients differ in their last bits and the int8 wire can turn that
  into a quantum), the NaN step exact;
- the hook route: a guarded bucketed optimizer whose buckets start from
  the backward's gradient hooks is bit-equal to the same optimizer
  exchanging after the backward, on good steps and on the NaN step.
"""

import concurrent.futures

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops.collective import _smap
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import numerics as jnum
import horovod_tpu_torch as hvd
from horovod_tpu_torch.resilience import chaos as tchaos
from horovod_tpu_torch.resilience import numerics as tnum
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N = 2
#: the verdict's float fields against the JAX package's
NORM_RTOL = 1e-6
INT_FIELDS = ("count", "bad_count", "bad_streak", "last_bad", "last_finite",
              "loss_scale", "chaos_fired")
FLOAT_FIELDS = ("ewma", "last_norm")


@pytest.fixture(autouse=True)
def _fresh_chaos():
    from horovod_tpu.observability import metrics

    metrics.reset()
    metrics.set_enabled(True)
    jchaos.configure(None)
    jnum.reset()
    tchaos.reset()
    tchaos.configure(None)
    yield
    metrics.reset()
    jchaos.reset()
    jnum.reset()
    tchaos.reset()


def assert_verdicts(got: dict, want: dict, rtol: float = NORM_RTOL):
    """A port verdict against a JAX one: integer fields and the scale
    exact, the norms within ``rtol``."""
    for k in INT_FIELDS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert set(got["per_dtype"]) == set(want["per_dtype"])
    for k, v in want["per_dtype"].items():
        np.testing.assert_allclose(got["per_dtype"][k], v, rtol=rtol,
                                   err_msg=k)
    np.testing.assert_allclose(got["rank_norms"], want["rank_norms"],
                               rtol=rtol)


# --------------------------------------------------------------------------
# both packages behind one small interface (the guard unbound)


class _Jax:
    name = "jax"
    nan, inf = np.nan, np.inf

    @staticmethod
    def guard(inner, lr, **kw):
        base = optax.adam(lr) if inner == "adam" else optax.sgd(lr)
        return jnum.guard(base, **kw)

    @staticmethod
    def tree(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    @staticmethod
    def loss(v):
        return jnp.float32(v)

    @staticmethod
    def np(x):
        return np.asarray(x)

    @staticmethod
    def apply(p, u):
        return optax.apply_updates(p, u)

    numerics, chaos = jnum, jchaos

    @staticmethod
    def injected(site):
        from horovod_tpu.observability import metrics

        return metrics.value("resilience_chaos_injected", site=site) or 0

    @staticmethod
    def inner_leaves(st):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(st.inner)]


class _Torch:
    name = "port"
    nan, inf = np.nan, np.inf

    @staticmethod
    def guard(inner, lr, **kw):
        base = hvd.adam(lr) if inner == "adam" else W.sgd(lr)
        return tnum.guard(base, **kw)

    @staticmethod
    def tree(d):
        return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}

    @staticmethod
    def loss(v):
        return torch.tensor(v, dtype=torch.float32)

    @staticmethod
    def np(x):
        return x.numpy()

    @staticmethod
    def apply(p, u):
        return {k: p[k] + u[k] for k in p}

    numerics, chaos = tnum, tchaos

    @staticmethod
    def injected(site):
        return tchaos.injected.get(site, 0)

    @staticmethod
    def inner_leaves(st):
        from horovod_tpu_torch import pytree

        return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in pytree.flatten(st.inner)[0]]


def _w(v):
    return {"w": np.full(4, v, np.float32)}


def _both(body, *args):
    """``body(side, *args)`` on the JAX package and on the port; each
    returns a list of ``(updates {k: array}, verdict)``. The updates must
    be bit-equal, the verdicts as :func:`assert_verdicts` says. Returns
    the port's list."""
    jchaos.configure(None)
    want = body(_Jax, *args)
    jchaos.configure(None)
    tchaos.configure(None)
    got = body(_Torch, *args)
    tchaos.configure(None)
    assert len(got) == len(want)
    for (gu, gv), (wu, wv) in zip(got, want):
        assert set(gu) == set(wu)
        for k in wu:
            np.testing.assert_array_equal(np.asarray(gu[k]).view(np.uint32)
                                          if gu[k].dtype == np.float32
                                          else gu[k],
                                          np.asarray(wu[k]).view(np.uint32)
                                          if wu[k].dtype == np.float32
                                          else wu[k], err_msg=k)
        assert_verdicts(gv, wv)
    return got


def _steps(S, tx, p, values, loss=None):
    st = tx.init(p)
    out = []
    for v in values:
        kw = {} if loss is None else {"loss": S.loss(loss)}
        u, st = tx.update(S.tree(_w(v)), st, p, **kw)
        out.append(({k: S.np(x) for k, x in u.items()},
                    S.numerics.verdict(st)))
    return out, st


# --------------------------------------------------------------------------
# TestGuard (tests/test_numerics.py)


class TestGuard:
    def test_good_step_matches_unguarded(self):
        def body(S):
            p = S.tree(_w(1.0))
            out, st = _steps(S, S.guard("adam", 1e-2), p, (0.5, -0.25, 0.1))
            plain = hvd.adam(1e-2) if S is _Torch else optax.adam(1e-2)
            sp = plain.init(p)
            for v, (ug, _) in zip((0.5, -0.25, 0.1), out):
                up, sp = plain.update(S.tree(_w(v)), sp, p)
                np.testing.assert_array_equal(ug["w"], S.np(up["w"]))
            return out

        out = _both(body)
        v = out[-1][1]
        assert v["count"] == 3 and v["bad_count"] == 0

    @pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
    def test_nonfinite_grads_skip_atomically(self, poison):
        def body(S):
            tx = S.guard("adam", 1e-2)
            p = S.tree(_w(1.0))
            st = tx.init(p)
            _, st = tx.update(S.tree(_w(0.5)), st, p)
            before = S.inner_leaves(st)
            u, st = tx.update(S.tree(_w(poison)), st, p)
            np.testing.assert_array_equal(S.np(u["w"]), 0.0)
            assert np.all(np.signbit(S.np(u["w"])))      # -0.0
            for a, b in zip(before, S.inner_leaves(st)):
                np.testing.assert_array_equal(a, b)
            return [({k: S.np(x) for k, x in u.items()},
                     S.numerics.verdict(st))]

        v = _both(body)[-1][1]
        assert v["bad_count"] == 1 and v["bad_streak"] == 1
        assert v["last_bad"] and not v["last_finite"]

    def test_nonfinite_loss_marks_bad(self):
        def body(S):
            return _steps(S, S.guard("sgd", 0.1), S.tree(_w(1.0)), (0.5,),
                          loss=np.nan)[0]

        u, v = _both(body)[0]
        np.testing.assert_array_equal(u["w"], 0.0)
        assert v["bad_count"] == 1

    def test_spike_detected_after_warmup_only(self):
        def body(S):
            out, _ = _steps(S, S.guard("sgd", 0.1, warmup=3, spike_factor=5.0),
                            S.tree(_w(1.0)), (0.5, 50.0, 0.5, 0.5, 0.5, 500.0,
                                              0.5))
            return out

        out = _both(body)
        assert out[1][1]["bad_count"] == 0       # inside warmup: absorbed
        v = out[5][1]
        assert v["bad_count"] == 1 and v["last_bad"]
        np.testing.assert_array_equal(out[5][0]["w"], 0.0)
        assert v["ewma"] == pytest.approx(out[4][1]["ewma"])
        assert out[6][1]["bad_streak"] == 0 and np.all(out[6][0]["w"] != 0)

    def test_ewma_seeds_on_first_good_step_after_bad_start(self):
        def body(S):
            out, _ = _steps(S, S.guard("sgd", 0.1, warmup=2, spike_factor=10.0),
                            S.tree(_w(1.0)), (np.nan, 0.5, 0.5, 1.5))
            return out

        out = _both(body)
        assert out[1][1]["ewma"] == pytest.approx(1.0)
        assert out[3][1]["last_bad"] is False
        assert np.all(out[3][0]["w"] != 0)

    def test_bad_step_preserves_negative_zero_params(self):
        def body(S):
            tx = S.guard("sgd", 0.1)
            p = S.tree({"w": np.array([-0.0, 0.0, 1.0], np.float32)})
            st = tx.init(p)
            u, st = tx.update(S.tree({"w": np.full(3, np.nan, np.float32)}),
                              st, p)
            got = S.np(S.apply(p, u)["w"])
            np.testing.assert_array_equal(got, S.np(p["w"]))
            assert np.signbit(got[0]) and not np.signbit(got[1])
            out = [({"w": S.np(u["w"])}, S.numerics.verdict(st))]
            u, st = tx.update(S.tree({"w": np.full(3, 0.5, np.float32)}), st,
                              p)
            assert np.all(S.np(u["w"]) != 0)
            return out + [({"w": S.np(u["w"])}, S.numerics.verdict(st))]

        _both(body)

    def test_staged_verdict_is_read_one_boundary_late(self):
        """The JAX package's standalone-hook case: a verdict staged at one
        boundary (an on-device copy) and noted at the next consumes the
        fired charge then. ``maybe_note_output``/``flush_staged``, which
        drive it there, wait for the observability port; the staging and
        the lagged note they are made of are these."""
        def body(S):
            S.chaos.configure("grad_nan_at_step=1")
            tx = S.guard("sgd", 0.1)
            p = S.tree(_w(1.0))
            st = tx.init(p)
            _, st = tx.update(S.tree(_w(0.5)), st, p)
            staged0 = S.numerics.stage_verdict(st)
            u, st = tx.update(S.tree(_w(0.5)), st, p)  # count 1: fires
            staged1 = S.numerics.stage_verdict(st)
            _, st = tx.update(S.tree(_w(0.5)), st, p)   # the copy survives
            v0 = S.numerics.note_step_staged(0, staged0)
            assert v0["count"] == 1 and S.chaos.grad_nan_step() == 1
            v1 = S.numerics.note_step_staged(1, staged1)
            assert v1["bad_count"] == 1 and v1["count"] == 2
            assert S.chaos.grad_nan_step() is None        # consumed
            assert S.injected("grad_nan_at_step") == 1
            return [({"w": S.np(u["w"])}, v1)]

        _both(body)

    def test_warmup_counts_good_steps_only(self):
        def body(S):
            out, _ = _steps(S, S.guard("sgd", 0.1, warmup=3, spike_factor=5.0),
                            S.tree(_w(1.0)),
                            (np.nan, 0.5, 0.5, 25.0, 0.5, 500.0))
            return out

        out = _both(body)
        assert out[3][1]["bad_count"] == 1 and np.all(out[3][0]["w"] != 0)
        v = out[5][1]
        assert v["last_bad"] and v["bad_count"] == 2
        np.testing.assert_array_equal(out[5][0]["w"], 0.0)

    def test_streak_counts_consecutive_bad(self):
        def body(S):
            return _steps(S, S.guard("sgd", 0.1), S.tree(_w(1.0)),
                          (np.nan, np.nan, np.nan, 0.5))[0]

        out = _both(body)
        assert out[2][1]["bad_streak"] == 3 and out[2][1]["bad_count"] == 3
        assert out[3][1]["bad_streak"] == 0

    def test_int_leaves_ride_through(self):
        def body(S):
            tx, plain = S.guard("sgd", 1.0), (
                W.sgd(1.0) if S is _Torch else optax.sgd(1.0))
            p = S.tree({"w": np.ones(4, np.float32),
                        "steps": np.zeros(2, np.int32)})
            g = S.tree({"w": np.full(4, 0.5, np.float32),
                        "steps": np.ones(2, np.int32)})
            ug, sg = tx.update(g, tx.init(p), p)
            up, _ = plain.update(g, plain.init(p), p)
            for k in p:
                np.testing.assert_array_equal(S.np(ug[k]), S.np(up[k]))
            return [({k: S.np(x) for k, x in ug.items()},
                     S.numerics.verdict(sg))]

        v = _both(body)[0][1]
        assert v["bad_count"] == 0 and v["last_norm"] == pytest.approx(1.0)

    def test_per_dtype_norms_recorded(self):
        def body(S):
            tx = S.guard("sgd", 1.0)
            if S is _Torch:
                p = {"a": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}
                g = {"a": torch.full((3,), 2.0),
                     "b": torch.full((2,), 1.0, dtype=torch.bfloat16)}
                cast = lambda x: x.float().numpy()  # noqa: E731
            else:
                p = {"a": jnp.ones(3), "b": jnp.ones(2, jnp.bfloat16)}
                g = {"a": jnp.full((3,), 2.0),
                     "b": jnp.full((2,), 1.0, jnp.bfloat16)}
                cast = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
            u, st = tx.update(g, tx.init(p), p)
            assert str(u["b"].dtype).endswith("bfloat16")
            return [({k: cast(x) for k, x in u.items()},
                     S.numerics.verdict(st))]

        v = _both(body)[0][1]
        assert set(v["per_dtype"]) == {"float32", "bfloat16"}
        assert v["per_dtype"]["float32"] == pytest.approx(np.sqrt(12.0))
        assert v["per_dtype"]["bfloat16"] == pytest.approx(np.sqrt(2.0))

    def test_loss_scale_unscales_and_backs_off(self):
        def body(S):
            tx = S.guard("sgd", 0.1, loss_scale=16.0)
            p = S.tree(_w(1.0))
            st = tx.init(p)
            assert float(np.asarray(S.numerics.current_scale(st))) == 16.0
            u, st = tx.update(S.tree(_w(16.0 * 0.5)), st, p)
            np.testing.assert_allclose(S.np(u["w"]), -0.05, rtol=1e-6)
            out = [({"w": S.np(u["w"])}, S.numerics.verdict(st))]
            u, st = tx.update(S.tree(_w(np.inf)), st, p)
            return out + [({"w": S.np(u["w"])}, S.numerics.verdict(st))]

        assert _both(body)[1][1]["loss_scale"] == 8.0

    def test_loss_scale_grows_after_interval(self):
        def body(S):
            return _steps(S, S.guard("sgd", 0.1, loss_scale=4.0,
                                     growth_interval=3), S.tree(_w(1.0)),
                          (2.0, 2.0, 2.0, 4.0, 4.0))[0]

        out = _both(body)
        assert out[2][1]["loss_scale"] == 8.0 and out[4][1]["loss_scale"] == 8.0

    def test_unguarded_state_has_no_verdict(self):
        st = hvd.adam(1e-2).init(_Torch.tree(_w(1.0)))
        assert tnum.verdict(st) is None and tnum.note_step(0, st) is None
        assert float(tnum.current_scale(st)) == 1.0
        jst = optax.adam(1e-2).init(_Jax.tree(_w(1.0)))
        assert jnum.verdict(jst) is None
        assert float(np.asarray(jnum.current_scale(jst))) == 1.0

    def test_distributed_optimizer_wraps_and_env_enables(self, monkeypatch):
        hvd.init(device="cpu")
        try:
            monkeypatch.delenv("HOROVOD_NUMERICS_GUARD", raising=False)
            assert tnum.is_guarded(hvd.DistributedOptimizer(
                hvd.adam(1e-2), numerics_guard=True))
            monkeypatch.setenv("HOROVOD_NUMERICS_GUARD", "1")
            assert tnum.is_guarded(hvd.DistributedOptimizer(W.sgd(0.1)))
            monkeypatch.delenv("HOROVOD_NUMERICS_GUARD")
            assert not tnum.is_guarded(hvd.DistributedOptimizer(W.sgd(0.1)))
            assert tnum.is_guarded(hvd.DistributedOptimizer(
                W.sgd(0.1), loss_scale="dynamic"))
        finally:
            hvd.shutdown()


# --------------------------------------------------------------------------
# TestChaosCharges (tests/test_numerics.py)


class TestChaosCharges:
    @pytest.mark.parametrize("spec", [
        "grad_nan_at_step=3,grad_spike_at_step=7:100.0,grad_corrupt_rank=5:4",
        "grad_spike_at_step=2", "kv_drop=2,rank_slow=1:0.05,sigterm_at_step=4",
        "slow_decode=0.05:canary@r1,replica_kill=1,shard_corrupt=2:3"])
    def test_parse_grammar(self, spec):
        assert tchaos.parse_spec(spec) == jchaos.parse_spec(spec)
        for bad in ("grad_corrupt_rank=5", "no_such_site=1", "grad_nan_at_step"):
            with pytest.raises(ValueError):
                tchaos.parse_spec(bad)
            with pytest.raises(ValueError):
                jchaos.parse_spec(bad)

    def test_nan_charge_fires_exactly_once(self):
        def body(S):
            S.chaos.configure("grad_nan_at_step=1")
            tx, p = S.guard("sgd", 0.1), S.tree(_w(1.0))
            st, out = tx.init(p), []
            for i in range(4):
                u, st = tx.update(S.tree(_w(0.5)), st, p)
                out.append(({"w": S.np(u["w"])}, S.numerics.note_step(i, st)))
            assert S.chaos.grad_nan_step() is None
            assert S.injected("grad_nan_at_step") == 1
            return out

        out = _both(body)
        assert out[-1][1]["bad_count"] == 1 and out[-1][1]["chaos_fired"] == 0
        assert out[1][1]["chaos_fired"] == 1

    def test_spike_charge_fires_exactly_once(self):
        def body(S):
            S.chaos.configure("grad_spike_at_step=4:1000")
            tx, p = S.guard("sgd", 0.1, warmup=2), S.tree(_w(1.0))
            st, out = tx.init(p), []
            for i in range(6):
                u, st = tx.update(S.tree(_w(0.5)), st, p)
                out.append(({"w": S.np(u["w"])}, S.numerics.note_step(i, st)))
            assert S.chaos.grad_spike() is None
            assert S.injected("grad_spike_at_step") == 1
            return out

        out = _both(body)
        assert out[-1][1]["bad_count"] == 1 and out[4][1]["chaos_fired"] == 2

    def test_overlapping_nan_and_spike_charges_compose(self):
        def body(S):
            S.chaos.configure("grad_nan_at_step=1,grad_spike_at_step=1:100")
            tx, p = S.guard("sgd", 0.1), S.tree(_w(1.0))
            st, out = tx.init(p), []
            for i in range(3):
                u, st = tx.update(S.tree(_w(0.5)), st, p)
                out.append(({"w": S.np(u["w"])}, S.numerics.note_step(i, st)))
            assert S.chaos.grad_nan_step() is None
            assert S.chaos.grad_spike() is None
            assert S.injected("grad_nan_at_step") == 1
            assert S.injected("grad_spike_at_step") == 1
            return out

        out = _both(body)
        assert out[-1][1]["bad_count"] == 1 and out[1][1]["chaos_fired"] == 3

    def test_unfired_charge_stays_armed(self):
        def body(S):
            S.chaos.configure("grad_nan_at_step=50")
            tx, p = S.guard("sgd", 0.1), S.tree(_w(1.0))
            st, out = tx.init(p), []
            for i in range(3):
                u, st = tx.update(S.tree(_w(0.5)), st, p)
                out.append(({"w": S.np(u["w"])}, S.numerics.note_step(i, st)))
            assert S.chaos.grad_nan_step() == 50
            assert S.injected("grad_nan_at_step") == 0
            return out

        _both(body)

    def test_restored_state_past_k_never_counts_a_phantom_injection(self):
        def body(S):
            tx, p = S.guard("sgd", 0.1), S.tree(_w(1.0))
            st = tx.init(p)
            for _ in range(5):
                _, st = tx.update(S.tree(_w(0.5)), st, p)
            S.chaos.configure("grad_nan_at_step=3")     # armed past count 3
            u, st = tx.update(S.tree(_w(0.5)), st, p)
            v = S.numerics.note_step(5, st)
            assert S.chaos.grad_nan_step() == 3
            assert S.injected("grad_nan_at_step") == 0
            assert v["chaos_fired"] == 0
            return [({"w": S.np(u["w"])}, v)]

        _both(body)


# --------------------------------------------------------------------------
# the gate


def test_tree_finite_and_publish_gate_reason(monkeypatch):
    """``tree_finite`` and ``publish_gate_reason`` on the same trees as
    the JAX package's: a NaN leaf, a bad streak, the opt-out; and the
    checkpoint validator's predicate is the guard module's one copy."""
    from horovod_tpu_torch import checkpoint as ck

    assert ck.array_finite is tnum.array_finite
    assert ck.checkpoint_finite_check_enabled is \
        tnum.checkpoint_finite_check_enabled
    good = {"w": np.ones(3, np.float32), "i": np.arange(3)}
    bad = {"w": np.array([1.0, np.nan], np.float32)}
    for t, want in ((good, True), (bad, False)):
        assert tnum.tree_finite(_Torch.tree(t)) is want
        assert tnum.tree_finite(t) is want
        assert jnum.tree_finite(_Jax.tree(t)) is want
    for S in (_Torch, _Jax):
        tx, p = S.guard("sgd", 0.1), S.tree(_w(1.0))
        st = tx.init(p)
        assert S.numerics.publish_gate_reason(st, S.tree(good)) is None
        assert S.numerics.publish_gate_reason(st, S.tree(bad)) == "nonfinite"
        _, st = tx.update(S.tree(_w(np.nan)), st, p)
        assert S.numerics.publish_gate_reason(st, S.tree(good)) == "bad_step"
        monkeypatch.setenv("HOROVOD_PUBLISH_NUMERICS_GATE", "0")
        assert S.numerics.publish_gate_reason(st, S.tree(bad)) is None
        monkeypatch.delenv("HOROVOD_PUBLISH_NUMERICS_GATE")
    assert tnum.quarantine_pending() is False


# --------------------------------------------------------------------------
# the loss-scale trajectory (tests/test_numerics.py:1588)


def test_train_step_loss_scaling_matches_unscaled(monkeypatch):
    """``make_train_step`` with ``DistributedOptimizer(adam,
    numerics_guard=True, loss_scale=64.0)``: the loss is scaled before the
    backward and the guard unscales the gradients exactly (a power of
    two), so five steps of the test MLP track the unguarded run (rtol
    1e-4, the JAX test's bar) and the reported loss is the unscaled one."""
    from horovod_tpu_torch.models import MLP

    for k in ("HOROVOD_NUMERICS_GUARD", "HOROVOD_SHARD_OPTIMIZER",
              "HOROVOD_COMPRESSION", "HOROVOD_OVERLAP", "HOROVOD_BUCKET_BYTES"):
        monkeypatch.delenv(k, raising=False)
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(16, 8).astype(np.float32))
    y = torch.from_numpy(r.randint(0, 4, 16).astype(np.int64))
    hvd.init(device="cpu")
    try:
        def run(guarded):
            model = MLP((16, 4), in_features=8, seed=1)
            kw = dict(numerics_guard=True, loss_scale=64.0) if guarded else {}
            tx = hvd.DistributedOptimizer(hvd.adam(1e-2), **kw)
            step = hvd.make_train_step(model, tx)
            st = tx.init(model.jax_params())
            for _ in range(5):
                st, loss = step(st, x, y)
            return model.jax_params(), float(loss), st

        pg, lg, sg = run(True)
        pu, lu, _ = run(False)
    finally:
        hvd.shutdown()
    assert lg == pytest.approx(lu, rel=1e-4)
    for k in pu:
        np.testing.assert_allclose(pg[k].detach().numpy(),
                                   pu[k].detach().numpy(), rtol=1e-4,
                                   atol=1e-6)
    v = tnum.verdict(sg)
    assert v["loss_scale"] == 64.0 and v["bad_count"] == 0


# --------------------------------------------------------------------------
# a gloo world of 2 against the JAX guard inside shard_map (bound axis)

STEPS = 6
NAN_STEP = 2            # grad_nan_at_step: the guard's third update
NAN_LOSS_STEP = 4       # rank 1's loss is NaN at this step
SCALE = 8.0
#: (DistributedOptimizer kwargs, inner optimizer, lr, parameters' rtol,
#: atol): Adam's per-step bar (jitted optax contracts FMAs; the reduced
#: gradients themselves are bit-equal), PowerSGD's, Adasum's (under SGD)
MATRIX = {
    "allreduce_int8_ef": (dict(compression="int8", error_feedback=True),
                          "adam", 1e-2, 1e-6, 1e-7),
    "zero1_int8_ef": (dict(compression="int8", error_feedback=True,
                           shard_optimizer=True), "adam", 1e-2, 1e-6, 1e-7),
    "adasum": (dict(op="adasum"), "sgd", 0.1, 2e-5, 2e-6),
    "powersgd_r2": (dict(compression=("powersgd", 2), error_feedback=True),
                    "adam", 1e-2, 1e-4, 1e-5),
    "multisteps_k2": (dict(compression="int8", error_feedback=True,
                           backward_passes_per_step=2), "adam", 1e-2, 1e-6,
                      1e-7),
    "zero1_bucketed": (dict(compression="int8", error_feedback=True,
                            shard_optimizer=True, bucket_bytes=4096), "adam",
                       1e-2, 1e-6, 1e-7),
}
#: the MLP end to end: its batch, steps, the NaN step and Adam's rate
E2E_STEPS, E2E_NAN, E2E_LR = 6, 3, 1e-2
#: the hook route: (shard_optimizer, bucket_bytes); the MLP's 7,976 bytes
#: of f32 make 2 buckets of 4,096
HOOK_CASES = {"allreduce_bucketed": (False, 4096),
              "zero1_bucketed": (True, 4096)}
HOOK_STEPS, HOOK_NAN = 5, 3


def _matrix_inputs():
    r = np.random.RandomState(71)
    p0 = {"w": (r.randn(40, 30) * 0.1).astype(np.float32),
          "b": np.zeros(30, np.float32),
          "e": (r.randn(1500) * 0.1).astype(np.float32)}
    grads = [{k: (r.randn(N, *v.shape) * SCALE).astype(np.float32)
              for k, v in p0.items()} for _ in range(STEPS)]
    losses = (1.0 + r.rand(STEPS, N)).astype(np.float32)
    losses[NAN_LOSS_STEP, 1] = np.nan
    return p0, grads, losses


def _jax_kw(kw):
    out = dict(kw)
    comp = out.get("compression")
    if isinstance(comp, tuple):
        out["compression"] = jhvd.Compression.powersgd(comp[1])
    elif comp is not None:
        out["compression"] = getattr(jhvd.Compression, comp)
    if out.get("op") == "adasum":
        out["op"] = jhvd.Adasum
    return out


def _jax_matrix(mesh, ax, name, p0, grads, losses):
    """One case on the JAX package: the guarded DistributedOptimizer's
    update inside ``shard_map`` (each device one rank's gradients; the
    loss averaged over the ranks, as ``make_shardmap_train_step`` gives
    it), the state of a non-ZeRO-1 case carried per rank (its residuals
    are)."""
    from horovod_tpu.ops.collective import Average, allreduce
    from horovod_tpu_torch.models.convert import flatten_tree

    kw, inner, lr = MATRIX[name][:3]
    jchaos.configure(f"grad_nan_at_step={NAN_STEP}")
    base = optax.adam(lr) if inner == "adam" else optax.sgd(lr)
    dtx = jhvd.DistributedOptimizer(base, numerics_guard=True,
                                    loss_scale=SCALE, **_jax_kw(kw))
    p = {k: jnp.asarray(v) for k, v in p0.items()}
    st = dtx.init(p)
    q0 = None
    if isinstance(kw.get("compression"), tuple):
        q0 = {k: None if v is None else np.asarray(v)
              for k, v in flatten_tree(dict(st.inner.q)).items()}
    zero1 = bool(kw.get("shard_optimizer"))
    if zero1:
        sspec = jnum.shard_state_spec(P(ax))
    else:
        st = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), st)
        sspec = P(ax)

    def step(pp, ss, gg, ll):
        gg = jax.tree_util.tree_map(lambda x: x[0], gg)
        if not zero1:
            ss = jax.tree_util.tree_map(lambda x: x[0], ss)
        u, ss = dtx.update(gg, ss, pp, loss=allreduce(ll[0], Average, axis=ax))
        if not zero1:
            ss = jax.tree_util.tree_map(lambda x: x[None], ss)
        return optax.apply_updates(pp, u), ss

    f = jax.jit(_smap(step, mesh, (P(), sspec, P(ax), P(ax)), (P(), sspec)))
    trace = []
    for t, g in enumerate(grads):
        p, st = f(p, st, {k: jnp.asarray(v) for k, v in g.items()},
                  jnp.asarray(losses[t]))
        view = st if zero1 else jax.tree_util.tree_map(lambda x: x[0], st)
        trace.append({"verdict": jnum.note_step(t, view),
                      "good_streak": int(view.good_streak),
                      "params": {k: np.asarray(v) for k, v in p.items()}})
    out = {"trace": trace, "armed": jchaos.grad_nan_step(), "q0": q0}
    jchaos.configure(None)
    return out


def _e2e_inputs():
    r = np.random.RandomState(72)
    x = r.randn(8 * N, 20).astype(np.float32)
    y = r.randint(0, 10, 8 * N).astype(np.int64)
    return x, y


def _jax_e2e(x, y):
    """The MLP, ZeRO-1 + int8 + EF + Adam under ``loss_scale="dynamic"``,
    through ``make_shardmap_train_step``, ``grad_nan_at_step`` armed."""
    from horovod_tpu.models import MLP
    from horovod_tpu.training import make_shardmap_train_step, shard_batch
    from horovod_tpu_torch.models.convert import flatten_tree

    model = MLP((64, 10))
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(4), jnp.asarray(x[:1]))["params"])
    jchaos.configure(f"grad_nan_at_step={E2E_NAN}")
    dtx = jhvd.DistributedOptimizer(
        optax.adam(E2E_LR), compression=jhvd.Compression.int8,
        error_feedback=True, shard_optimizer=True, loss_scale="dynamic")
    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = dtx.init(p)
    step = make_shardmap_train_step(model, dtx, shard_optimizer=True,
                                    instrument=False)
    xs, ys = shard_batch(jnp.asarray(x)), shard_batch(jnp.asarray(y))
    trace = []
    for t in range(E2E_STEPS):
        p, _, st, loss = step(p, {}, st, xs, ys)
        trace.append({"loss": float(loss), "verdict": jnum.note_step(t, st),
                      "params": flatten_tree(jax.tree_util.tree_map(
                          np.asarray, p))})
    jchaos.configure(None)
    return params, {"trace": trace, "armed": jchaos.grad_nan_step()}


@pytest.fixture(scope="module")
def world():
    """Every port case in one gloo world of 2 while JAX runs here."""
    p0, grads, losses = _matrix_inputs()
    x, y = _e2e_inputs()
    jhvd.init(devices=jax.devices()[:N])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        ref = {name: _jax_matrix(mesh, ax, name, p0, grads, losses)
               for name in MATRIX}
        cases = {name: dict(kw=MATRIX[name][0], inner=MATRIX[name][1],
                            lr=MATRIX[name][2], loss_scale=SCALE,
                            chaos=f"grad_nan_at_step={NAN_STEP}",
                            q0=ref[name]["q0"]) for name in MATRIX}
        params, e2e_ref = _jax_e2e(x, y)
        inp = {"matrix": (p0, grads, losses, cases),
               "e2e": (params, x, y, E2E_STEPS,
                       f"grad_nan_at_step={E2E_NAN}", E2E_LR),
               "hooks": (x, y, HOOK_STEPS, HOOK_NAN, HOOK_CASES)}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(run_world, W.guard_world_worker, N, inp,
                               timeout=300).result()
    finally:
        jhvd.shutdown()
    return ref, e2e_ref, port


@pytest.mark.parametrize("name", list(MATRIX))
def test_composition_matches_the_jax_bound_guard(world, name):
    """Each mode under the guard over the same per-rank gradients as the
    JAX package's guard inside ``shard_map``: every step's verdict (the
    NaN step, rank 1's NaN loss and the scale's backoff 8 -> 4 -> 2
    included) with the integer fields and the scale exact and the norms
    within 1e-6, the parameters within the mode's bar, every rank the
    same; on each BAD step the port's parameters and whole inner state
    (moments, EF residuals, PowerSGD's Q, the accumulator) keep their
    bits; the charge consumed once on both sides."""
    ref, _, port = world
    _, _, _, rtol, atol = MATRIX[name]
    want = ref[name]["trace"]
    bad_steps = []
    for r in range(N):
        got = port[r]["matrix"][name]
        assert got["armed"] is None and ref[name]["armed"] is None
        assert got["injected"] == {"grad_nan_at_step": 1}
        for t, (g, w) in enumerate(zip(got["trace"], want)):
            assert_verdicts(g["verdict"], w["verdict"])
            assert g["good_streak"] == w["good_streak"]
            for k, v in w["params"].items():
                np.testing.assert_allclose(g["params"][k], v, rtol=rtol,
                                           atol=atol, err_msg=f"{t} {k}")
                assert np.array_equal(g["params"][k],
                                      port[0]["matrix"][name]["trace"][t]
                                      ["params"][k])
            if g["verdict"]["last_bad"]:
                assert g["frozen"] == (True, True), (t, g["frozen"])
                bad_steps.append(t)
    assert sorted(set(bad_steps)) == [NAN_STEP, NAN_LOSS_STEP]
    scales = [s["verdict"]["loss_scale"] for s in want]
    assert scales == [8.0, 8.0, 4.0, 4.0, 2.0, 2.0]
    assert want[NAN_STEP]["verdict"]["rank_norms"] == [-1.0, -1.0]


def test_end_to_end_step_matches_make_shardmap_train_step(world):
    """The MLP through ``make_train_step`` against the JAX package's
    ``make_shardmap_train_step`` (ZeRO-1 + int8 + EF + Adam,
    ``loss_scale="dynamic"``, ``grad_nan_at_step=3``): losses within the
    slice's 1e-4, the verdicts' integer fields and the scale exact at
    every step, step 0's norms within 1e-6 and the later ones within the
    int8 trajectory bar; at the NaN step the norms exactly 0 (-1 for each
    rank) and the EWMA the step before's; parameters within rtol
    5e-3 / atol 5e-4; the NaN step skipped bit for bit on every rank."""
    _, want, port = world
    for r in range(N):
        got = port[r]["e2e"]
        assert got["armed"] is None and want["armed"] is None
        for t, (g, w) in enumerate(zip(got["trace"], want["trace"])):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            assert_verdicts(g["verdict"], w["verdict"],
                            rtol=NORM_RTOL if t == 0 else 5e-3)
            for k, v in w["params"].items():
                np.testing.assert_allclose(g["params"][k], v, rtol=5e-3,
                                           atol=5e-4, err_msg=f"{t} {k}")
            if t == E2E_NAN:
                v = g["verdict"]
                assert v["last_bad"] and g["frozen"] == (True, True)
                assert v["loss_scale"] == 2.0 ** 14
                assert v["last_norm"] == 0.0 and v["rank_norms"] == [-1.0] * N
                assert set(v["per_dtype"].values()) == {0.0}
                assert v["ewma"] == got["trace"][t - 1]["verdict"]["ewma"]
            else:
                assert not g["verdict"]["last_bad"]
        assert got["trace"][-1]["loss"] < got["trace"][0]["loss"]


@pytest.mark.parametrize("name", list(HOOK_CASES))
def test_hook_route_is_bit_equal_under_the_guard(world, name):
    """A guarded, loss-scaled bucketed optimizer whose buckets start from
    the gradient hooks (the guard hands each gradient over multiplied by
    the chaos factor and unscaled) against the same optimizer exchanging
    after the backward: parameters and inner state bit-equal at every
    step, the NaN step included; that step keeps every parameter (a -0.0
    among them) and the buckets' EF residuals; the hooks started buckets
    from the backward."""
    _, _, port = world
    for r in range(N):
        got = port[r]["hooks"][name]
        assert all(got["bit_equal"]), got["bit_equal"]
        assert got["armed"] == (None, None)
        for run in ("hooked", "after"):
            trace = got[run]
            for t, s in enumerate(trace):
                assert s["verdict"]["last_bad"] == (t == HOOK_NAN)
            assert trace[HOOK_NAN]["kept"] == (True, True)
            assert trace[HOOK_NAN]["neg0"]
            assert trace[HOOK_NAN]["verdict"]["loss_scale"] == 2.0 ** 14
        assert all(s["hooked"][0] >= 1 and s["hooked"][1] == 2
                   for s in got["hooked"])
        assert all(s["hooked"] is None for s in got["after"])


def test_fused_update_is_selected_as_one_buffer(monkeypatch):
    """The guard over ``fused_adam`` on its kernel path (the launch
    modelled on the CPU, ``test_torch_workers.emulate_fused_adam``), whose
    updates and moments are views of one flat buffer each: from the second
    step on the select keeps them views of one buffer (one ``where`` a
    buffer); every step, the NaN step included, bit-equal to the guard
    over the per-leaf ``adam``, and the NaN step keeps the moments."""
    r = np.random.RandomState(73)
    shapes = {"a": (3, 5), "b": (257,), "c": (2, 3, 4), "d": (1,)}
    p = {k: torch.from_numpy((r.randn(*s) * 0.1).astype(np.float32))
         for k, s in shapes.items()}
    steps = [{k: torch.from_numpy(r.randn(*s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(4)]
    steps[2]["b"][7] = np.nan
    ref_tx = tnum.guard(hvd.adam(1e-2))
    ref_st, ref = ref_tx.init(p), []
    for g in steps:
        u, ref_st = ref_tx.update(g, ref_st, p)
        ref.append((u, ref_st))
    launched = []
    W.emulate_fused_adam(monkeypatch.setattr, launched)
    tx = tnum.guard(hvd.fused_adam(1e-2))
    st = tx.init(p)
    for t, (g, (ru, rst)) in enumerate(zip(steps, ref)):
        before = W._bits_of(st.inner)
        u, st = tx.update(g, st, p)
        assert tnum.verdict(st) == tnum.verdict(rst)
        for k in shapes:
            for a, b in ((u[k], ru[k]), (st.inner["mu"][k], rst.inner["mu"][k]),
                         (st.inner["nu"][k], rst.inner["nu"][k])):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if t == 2:
            assert tnum.verdict(st)["last_bad"]
            assert W.same_bits(before, W._bits_of(st.inner))
        if t >= 1:
            for part in (u, st.inner["mu"], st.inner["nu"]):
                assert len({x.untyped_storage().data_ptr()
                            for x in part.values()}) == 1
    assert len(launched) == 4


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "good"])
def test_select_picks_host_leaves_on_the_verdict(bad):
    """``_select`` over a state with host leaves that the update changed
    (a Python number here; ``multi_steps``' CPU counters under a CUDA
    verdict take the same branch): the old leaf on a BAD step, the new
    one on a good step, tensors through ``where`` and an unchanged leaf
    as it is."""
    same = torch.arange(3.0)
    old = {"n": 1, "t": torch.zeros(2), "same": same}
    new = {"n": 2, "t": torch.ones(2), "same": same}
    out = tnum._select(torch.tensor(bad), old, new)
    assert out["n"] == (1 if bad else 2)
    assert torch.equal(out["t"], old["t"] if bad else new["t"])
    assert out["same"] is same
