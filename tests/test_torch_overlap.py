"""Bucketed overlap in the port against the JAX package's
``horovod_tpu/ops/overlap.py`` and ``DistributedOptimizer(overlap=True)``.

- ``BucketPlan``: ``describe()`` and every ``Bucket`` the JAX package's,
  on the real ResNet-50 and flagship ``TransformerLM`` leaf lists at
  1 KiB, 25 MiB and 64 MiB, a mixed f32/bf16/int32 tree and a
  ``bucket_bytes`` below one itemsize (pure Python);
- ``bucketed_allreduce`` (none, fp16, int8; with and without a residual;
  with and without a predivide for none/fp16) bit-equal to the JAX
  package's at N = 2 and 4 on the same per-rank inputs, the new residuals
  too (N = 4 inputs are multiples of 1/8, so every f32 summation order
  is exact);
- 3-step trajectories of ``DistributedOptimizer(fused_adam, overlap=
  True)`` in allreduce mode and ZeRO-1 x {none, fp16, int8} x {EF, no
  EF} at N = 2: the exchange is the JAX package's
  (``DistributedOptimizer(optax.identity(), ...)`` in a bound-axis step)
  bit for bit, the parameters and moments those of optax's Adam run op
  by op on the JAX package's reduced gradients, bit for bit (the jitted
  optax Adam contracts the moment updates into FMAs on the CPU, which the
  port's Adam never does), the state keyed as the JAX package keys it;
  for none/fp16 bit-equal to the port's own monolithic path too;
- the hook route (buckets launched from the backward's gradient hooks)
  bit-equal to the update after the backward on a small ResNet at N = 2
  and 4, every rank ending with the same parameters;
- bucketed ZeRO-1 states re-packed 2 -> 4 -> 2 as the JAX package
  re-packs them, the ambiguous tail bucket by its key, a wrong
  ``bucket_bytes`` refused with the JAX package's message.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops import collective as JCol
from horovod_tpu.ops import overlap as jov
from horovod_tpu.optim import _EFState, reshard_optimizer_state as jreshard
from horovod_tpu_torch import optim as topt
from horovod_tpu_torch.ops import overlap as tov
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

JCOMP = {"none": JC.none, "fp16": JC.fp16, "int8": JC.int8}
OPS = {"avg": (JCol.Average, 0), "sum": (JCol.Sum, 1)}
BB = 4096


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    it = {4: np.uint32, 2: np.uint16, 8: np.uint64}[a.dtype.itemsize]
    return np.array_equal(a[~nan].view(it), b[~nan].view(it))


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _flat(tree):
    from horovod_tpu_torch.models.convert import flatten_tree

    return flatten_tree(dict(tree))


# --------------------------------------------------------------------------
# the plan


class _S:
    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype


def _plans_equal(jleaves, tleaves, n, bb):
    a = jov.BucketPlan.build(jleaves, n, bb)
    b = tov.plan_for(tleaves, n, bb)
    assert a.describe() == b.describe()
    assert [tuple(x) for x in a.buckets] == [
        (x.key, x.dtype, tuple(tuple(s) for s in x.segs), x.L, x.Lp)
        for x in b.buckets]
    assert [x.idxs for x in a.buckets] == [x.idxs for x in b.buckets]
    return b


@functools.lru_cache(maxsize=None)
def _resnet50_leaves():
    from horovod_tpu.models import resnet as jres
    from horovod_tpu_torch.models import resnet as tres

    shapes = jax.eval_shape(lambda: jres.ResNet50().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    jl = jax.tree_util.tree_leaves(shapes["params"])
    tp = tres.ResNet50(device="meta").jax_params()
    return jl, [tp[k] for k in topt.tree_keys(tp)]


@functools.lru_cache(maxsize=None)
def _lm_leaves():
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import transformer as ttr

    jm = jtr.TransformerLM(vocab=32000, dim=1024, depth=12, heads=16,
                           max_len=2048, pos_embedding="rope")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(vocab=32000, dim=1024, depth=12, heads=16,
                           max_len=2048, pos_embedding="rope", device="meta")
    tp = tm.jax_params()
    return jax.tree_util.tree_leaves(shapes), [tp[k] for k in topt.tree_keys(tp)]


@pytest.mark.parametrize("bb", [1024, 25 * 2 ** 20, 64 * 2 ** 20],
                         ids=["1KiB", "25MiB", "64MiB"])
@pytest.mark.parametrize("model", ["resnet50", "lm_flagship"])
def test_plan_is_the_jax_packages_on_real_models(model, bb):
    jl, tl = _resnet50_leaves() if model == "resnet50" else _lm_leaves()
    plan = _plans_equal(jl, tl, 4 if bb == 1024 else 1, bb)
    if model == "resnet50" and bb == 25 * 2 ** 20:
        assert len(plan) == 4       # ResNet-50's 102.2 MB of f32 in 4
    if model == "resnet50" and bb == 64 * 2 ** 20:
        assert len(plan) == 2


def test_plan_of_a_mixed_tree_and_a_tiny_bucket():
    spec = [((100,), "float32"), ((100,), "int32"), ((100,), "bfloat16"),
            ((7, 9), "float32"), ((), "float32"), ((0,), "float32"),
            ((3,), "bfloat16")]
    jl = [_S(s, getattr(jnp, d)) for s, d in spec]
    tl = [torch.empty(s, dtype=getattr(torch, d), device="meta")
          for s, d in spec]
    for bb in (1, 3, 64, 400, 1 << 20):
        for n in (1, 3, 8):
            plan = _plans_equal(jl, tl, n, bb)
    assert [b.key for b in plan.buckets] == ["bfloat16#0", "float32#0",
                                             "int32#0"]
    tiny = tov.BucketPlan.build([torch.empty(3)], 1, 1)
    assert [b.L for b in tiny.buckets] == [1, 1, 1]
    assert tov.plan_for(tl, 4, 64) is tov.plan_for(tl, 4, 64)   # cached


def test_bucket_knobs_resolve_as_the_jax_packages(monkeypatch):
    for name in ("HOROVOD_OVERLAP", "HOROVOD_BUCKET_BYTES",
                 "HOROVOD_FUSION_THRESHOLD"):
        monkeypatch.delenv(name, raising=False)
    cases = [(None, None), (True, None), (None, 123), (False, None),
             (False, 5)]

    def both():
        return [(jov.resolve_bucket_bytes(*c), tov.resolve_bucket_bytes(*c))
                for c in cases]

    for env in ({}, {"HOROVOD_OVERLAP": "1"},
                {"HOROVOD_OVERLAP": "yes", "HOROVOD_FUSION_THRESHOLD": "2048"},
                {"HOROVOD_FUSION_THRESHOLD": "2048",
                 "HOROVOD_BUCKET_BYTES": "4096"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for a, b in both():
            assert a == b
    assert tov.resolve_bucket_bytes(True, None) == 4096
    assert tov.DEFAULT_BUCKET_BYTES == jov.DEFAULT_BUCKET_BYTES


# --------------------------------------------------------------------------
# worlds


def _tree(n, *, bf16=True):
    """Stacked per-rank leaves and dtypes; at N = 4 multiples of 1/8, so
    that every summation order gives the same bits."""
    r = np.random.RandomState(80 + n)
    spec = {"a": (2000,), "b": (40, 30), "c": (7,), "d": (3, 5, 7, 11),
            "e": (1500,)}
    tree = {}
    for k, s in spec.items():
        x = r.randn(n, *s).astype(np.float32)
        if n > 2:
            x = np.round(np.clip(x, -3, 3) * 8) / 8
        tree[k] = (x, "float32")
    if bf16:       # at N = 4 also within +-2, so bf16 sums stay exact
        h = r.randn(n, 300)
        if n > 2:
            h = np.round(np.clip(h, -2, 2) * 8) / 8
        h = np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
        tree["h"] = (h, "bfloat16")
    return tree


def _bucket_residual(tree, n, seed):
    """A per-rank residual for each bucket of the allreduce-mode plan (at
    N = 4 multiples of 1/8, as the leaves)."""
    r = np.random.RandomState(seed)
    leaves = [_S(x.shape[1:], getattr(jnp, dt))
              for _, (x, dt) in sorted(tree.items())]
    plan = jov.plan_for(leaves, 1, BB)
    res = {}
    for b in plan.buckets:
        x = (r.randn(n, b.L) * 1e-2).astype(np.float32)
        if n > 2:       # exact through the bf16 wire and any sum order
            x = r.randint(-4, 5, (n, b.L)).astype(np.float32) / 8
        res[b.key] = x if b.dtype == "float32" else np.asarray(
            jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return res


def _bucketed_cases(n):
    """At N = 4 the predivide is 2: x / 3 would make the f32 sums
    order-dependent."""
    cases = {}
    for comp in ("none", "fp16", "int8"):
        for op in ("avg", "sum"):
            for ef in (False, True):
                for pf in ((1.0, 3.0 if n == 2 else 2.0) if comp != "int8"
                           else (1.0,)):
                    if pf != 1.0 and op != "avg":
                        continue
                    name = f"{comp}_{op}_{'ef' if ef else 'plain'}_pf{pf:g}"
                    cases[name] = (OPS[op][1], comp, ef, pf)
    return cases


def _traj_inputs():
    r = np.random.RandomState(90)
    p0 = {"w": (r.randn(64, 33) * 0.1).astype(np.float32),
          "b": np.zeros(33, np.float32),
          "c": (r.randn(5, 4, 3, 20) * 0.1).astype(np.float32)}
    steps = [{k: (r.randn(2, *v.shape) * 10.0 ** r.randint(-3, 0))
              .astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    return p0, steps


TRAJ = [(shard, comp, ef) for shard in (False, True)
        for comp in ("none", "fp16", "int8") for ef in (False, True)
        if not (comp == "none" and ef)]


def _traj_name(shard, comp, ef, bb):
    return (f"{'zero1' if shard else 'allreduce'}_{comp}_"
            f"{'ef' if ef else 'plain'}_{'mono' if bb is None else 'bucketed'}")


HOOK_CASES = {"allreduce_int8_ef": (False, "int8", True, 20000),
              "zero1_int8_ef": (True, "int8", True, 20000),
              "allreduce_none": (False, "none", False, 20000),
              "zero1_fp16_ef": (True, "fp16", True, 20000)}


def _hooks_input(n):
    r = np.random.RandomState(95)
    x = r.randn(2 * n, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, 2 * n).astype(np.int64)
    return (x, y, 2, HOOK_CASES)


def _inputs(n):
    tree = _tree(n)
    res = _bucket_residual(tree, n, 7)
    bcases = {name: (op, comp, res if ef else None, pf, BB)
              for name, (op, comp, ef, pf) in _bucketed_cases(n).items()}
    inp = {"bucketed": (tree, bcases), "hooks": _hooks_input(n)}
    if n == 2:
        p0, steps = _traj_inputs()
        inp["traj"] = {
            _traj_name(shard, comp, ef, bb): (p0, steps, shard, comp, ef, bb,
                                              "adam")
            for shard, comp, ef in TRAJ for bb in (None, BB)}
        inp["traj"].update({
            _traj_name(shard, comp, ef, BB) + "_identity":
                (p0, steps, shard, comp, ef, BB, "identity")
            for shard, comp, ef in TRAJ})
    return inp


@functools.lru_cache(maxsize=None)
def _world(n):
    inp = _inputs(n)
    return inp, run_world(W.slice10_worker, n, inp, timeout=300)


@functools.lru_cache(maxsize=None)
def _mesh_refs(n):
    inp = _inputs(n)
    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()
        ref = {"bucketed": _jax_bucketed(mesh, ax, inp["bucketed"])}
        if "traj" in inp:
            ref["traj"] = _jax_trajs(mesh, ax, n)
    finally:
        jhvd.shutdown()
    return ref


def _jax_bucketed(mesh, ax, bucketed):
    tree, cases = bucketed
    keys = sorted(tree)
    xs = [jnp.asarray(tree[k][0], getattr(jnp, tree[k][1])) for k in keys]
    out = {}
    for name, (op, comp, res, pf, bb) in cases.items():
        rkeys = sorted(res) if res is not None else []

        def body(*vs):
            g = {k: v[0] for k, v in zip(keys, vs[:len(keys)])}
            r = ({k: v[0] for k, v in zip(rkeys, vs[len(keys):])}
                 if res is not None else None)
            red, new = jov.bucketed_allreduce(
                g, (JCol.Average, JCol.Sum)[op], axis=ax,
                compression=JCOMP[comp], bucket_bytes=bb, predivide=pf,
                residual=r)
            return ({k: v[None] for k, v in red.items()},
                    None if new is None else {k: v[None]
                                              for k, v in new.items()})

        args = xs + [jnp.asarray(res[k]).astype(
            jnp.bfloat16 if k.startswith("bfloat16") else jnp.float32)
            for k in rkeys]
        f = jax.jit(JCol._smap(body, mesh, (P(ax),) * len(args),
                               (P(ax), P(ax))))
        red, new = f(*args)
        out[name] = ({k: _np(v) for k, v in red.items()},
                     None if new is None else {k: _np(v) for k, v in new.items()})
    return out


def _jax_trajs(mesh, ax, n):
    """Per trajectory case: the JAX package's exchange (identity inner,
    bound axis) each step, its final residual, and optax's Adam op by op
    over the reduced gradients; the Adam state's group keys."""
    p0, steps = _traj_inputs()
    out = {}
    for shard, comp, ef in TRAJ:
        for bb in (None, BB):
            kw = dict(compression=JCOMP[comp], error_feedback=ef,
                      shard_optimizer=shard, overlap=bb is not None,
                      bucket_bytes=bb)
            dtx = jhvd.DistributedOptimizer(optax.identity(), **kw)
            p = {k: jnp.asarray(v) for k, v in p0.items()}
            s = dtx.init(p)
            if ef and not shard:     # per-rank residuals, stacked
                res = jax.tree_util.tree_map(
                    lambda v: jnp.broadcast_to(v[None], (n,) + v.shape),
                    s.residual)

                def step(rr, gg):
                    gg = jax.tree_util.tree_map(lambda x: x[0], gg)
                    ss = _EFState(optax.EmptyState(), jax.tree_util.tree_map(
                        lambda x: x[0], rr))
                    u, ss = dtx.update(gg, ss, p)
                    return u, jax.tree_util.tree_map(lambda x: x[None],
                                                     ss.residual)
                state, spec = res, P(ax)
            else:
                def step(ss, gg):
                    gg = jax.tree_util.tree_map(lambda x: x[0], gg)
                    return dtx.update(gg, ss, p)
                state, spec = s, (P(ax) if shard else P())
            f = jax.jit(JCol._smap(step, mesh, (spec, P(ax)), (P(), spec)))
            reduced = []
            for g in steps:
                u, state = f(state, {k: jnp.asarray(v) for k, v in g.items()})
                reduced.append(u)
            adam = optax.adam(1e-2)
            pa, sa = dict(p), adam.init(p)
            for u in reduced:
                upd, sa = adam.update(u, sa)
                pa = optax.apply_updates(pa, upd)
            residual = None
            if ef:
                residual = state if not shard else state.residual
            keys = jhvd.DistributedOptimizer(optax.adam(1e-2), **kw).init(p)
            inner = keys.inner if ef else keys
            mu_keys = sorted(inner[0].mu) if shard else None
            out[_traj_name(shard, comp, ef, bb)] = {
                "reduced": [{k: _np(v) for k, v in u.items()}
                            for u in reduced],
                "params": {k: _np(v) for k, v in pa.items()},
                "mu": {k: _np(v) for k, v in sa[0].mu.items()},
                "nu": {k: _np(v) for k, v in sa[0].nu.items()},
                "residual": (None if residual is None else
                             {k: _np(v) for k, v in _flat(residual).items()}),
                "mu_keys": mu_keys}
    return out


@pytest.fixture(params=[2, 4], ids=["n2", "n4"])
def n(request):
    return request.param


def _bf16_model(x, res, pf, n, op):
    """The bucketed allreduce of a bf16 leaf (the tree's only one, so its
    bucket's residual is its own), each operation rounded to bf16 as the
    dtype asks: ``x + residual``, ``x * f32(1/f)`` (the predivide), the
    sum in rank order, then ``* f/N`` or the Average's divide."""
    t = torch.from_numpy(np.array(x)).bfloat16()
    if res is not None:
        t = t + torch.from_numpy(np.array(res)).bfloat16()
    if pf != 1.0:
        t = (t.float() * torch.tensor(pf).float().reciprocal()).bfloat16()
    total = t[0]
    for row in t[1:]:
        total = total + row
    if pf != 1.0:
        total = (total.float() * torch.tensor(pf / n).float()).bfloat16()
    elif op == 0:
        total = total / torch.tensor(n, dtype=torch.bfloat16)
    return total.float().numpy()


@pytest.mark.parametrize("comp", ["none", "fp16", "int8"])
def test_bucketed_allreduce_bit_equal_to_jax(n, comp):
    """Bit for bit, with one exception the reference makes: a bf16 leaf
    whose bucket is corrected by a residual or predivided before the sum.
    XLA on the CPU runs a bf16 all-reduce in f32 and drops the rounding of
    the elementwise operation that feeds it; the port rounds each
    operation to the leaf's dtype (so does NCCL's bf16 sum). There the
    port is the per-operation bf16 model (N = 2) and within those
    roundings of the JAX package."""
    inp, port = _world(n)
    tree = inp["bucketed"][0]
    ref = _mesh_refs(n)["bucketed"]
    names = [k for k in inp["bucketed"][1] if k.startswith(comp + "_")]
    assert names
    for name in names:
        jred, jres = ref[name]
        op, _, res, pf, _ = inp["bucketed"][1][name]
        for r in range(n):
            got = port[r]["bucketed"][name]
            for k, v in got["reduced"].items():
                if tree[k][1] == "bfloat16" and (pf != 1.0 or res is not None):
                    # half a bf16 step (2^-9 relative) for each rank's
                    # corrected or predivided value, for the port's sum
                    # and for each side's rounding of the result
                    x = tree[k][0]
                    bar = 2.0 ** -8 * (np.abs(x).sum(0) / (n if op == 0
                                                           else 1)
                                       + 2 * np.abs(jred[k][r]))
                    assert (np.abs(v - jred[k][r]) <= bar).all(), (name, k)
                    if n == 2:
                        want = _bf16_model(x, None if res is None else
                                           res["bfloat16#0"], pf, n, op)
                        assert _same_bits(v, want), (name, k)
                    continue
                assert _same_bits(v, jred[k][r]), (name, r, k)
            if jres is None:
                assert got["residual"] is None
                continue
            assert sorted(got["residual"]) == sorted(jres)
            for k, v in got["residual"].items():
                assert _same_bits(v, jres[k][r]), (name, r, k)
    if comp == "int8":      # the wire really rounded, and EF kept it
        any_res = next(ref[k][1] for k in names if ref[k][1] is not None)
        assert any(np.abs(v).max() > 0 for v in any_res.values())


@pytest.mark.parametrize("comp", ["none", "fp16"])
def test_bucketed_allreduce_equals_the_per_leaf_allreduce(n, comp):
    """Packing is a permutation and the wire elementwise: each leaf is
    its own allreduce's bits."""
    inp, port = _world(n)
    for name in inp["bucketed"][1]:
        if not name.startswith(comp + "_") or "per_leaf" not in port[0][
                "bucketed"][name]:
            continue
        for r in range(n):
            got = port[r]["bucketed"][name]
            for k, v in got["per_leaf"].items():
                assert _same_bits(got["reduced"][k], v), (name, r, k)


@pytest.mark.parametrize("shard,comp,ef", TRAJ, ids=[
    _traj_name(*c, BB) for c in TRAJ])
def test_three_step_trajectory_bit_equal_to_jax(shard, comp, ef):
    _, port = _world(2)
    ref = _mesh_refs(2)["traj"]
    name = _traj_name(shard, comp, ef, BB)
    want = ref[name]
    p0, _ = _traj_inputs()
    for r in range(2):
        # the exchange alone: identity inner, the updates are the reduced
        # gradients, added step by step
        ident = port[r]["traj"][name + "_identity"]
        for k, v in p0.items():
            want_k = v
            for u in want["reduced"]:
                want_k = want_k + u[k]
            assert _same_bits(ident["params"][k], want_k), (r, k)
        got = port[r]["traj"][name]
        for k in want["params"]:
            assert _same_bits(got["params"][k], want["params"][k]), (r, k)
        if not shard:
            for k in want["mu"]:
                assert _same_bits(got["mu"][k], want["mu"][k]), (r, k)
                assert _same_bits(got["nu"][k], want["nu"][k]), (r, k)
        else:
            assert sorted(got["mu"]) == want["mu_keys"]
            assert len(want["mu_keys"]) >= 2
        if ef:
            assert sorted(got["residual"]) == sorted(want["residual"])
            for k, v in got["residual"].items():
                assert _same_bits(v, want["residual"][k][r]), (r, k)
    if comp in ("none", "fp16"):     # and the monolithic path's bits
        mono = port[0]["traj"][_traj_name(shard, comp, ef, None)]
        for k, v in port[0]["traj"][name]["params"].items():
            assert _same_bits(v, mono["params"][k]), k
        assert _same_bits(ref[_traj_name(shard, comp, ef, None)]["params"]["w"],
                          want["params"]["w"])


def test_hook_route_is_the_after_backward_route(n):
    """The buckets launched from the gradient hooks give the update that
    the exchange after the backward gives, bit for bit, over two steps;
    the ranks agree; the hooks started every bucket (the last hook of the
    backward starts the plan's first bucket, which holds the stem)."""
    _, port = _world(n)
    for name in HOOK_CASES:
        for r in range(n):
            got = port[r]["hooks"][name]
            for k, v in got["hooks"]["params"].items():
                assert _same_bits(v, got["after"]["params"][k]), (name, r, k)
                assert _same_bits(v, port[0]["hooks"][name]["hooks"][
                    "params"][k]), (name, r, k)
            if got["hooks"]["residual"] is not None:
                for k, v in got["hooks"]["residual"].items():
                    assert _same_bits(v, got["after"]["residual"][k])
            for k, v in got["hooks"]["mu"].items():
                assert _same_bits(v, got["after"]["mu"][k])
            assert got["hooks"]["losses"] == got["after"]["losses"]
            started, k = got["hooks"]["started"]
            assert k >= 2 and started == k, (name, started, k)
            assert got["after"]["started"] is None


# --------------------------------------------------------------------------
# bucketed ZeRO-1 states across world sizes


def _rows_state(jstate):
    """The JAX package's bucketed ZeRO-1 ``_EFState`` as the port's
    consolidated view (host arrays)."""
    from horovod_tpu_torch.models.convert import opt_state_from_jax

    return opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))


def _assert_rows_match(port, jstate):
    adam = jstate.inner[0]
    assert _same_bits(port["inner"]["count"], np.asarray(adam.count))
    for part in ("mu", "nu"):
        want = getattr(adam, part)
        assert sorted(port["inner"][part]) == sorted(want)
        for k, v in want.items():
            assert _same_bits(port["inner"][part][k], np.asarray(v)), (part, k)
    assert sorted(port["residual"]) == sorted(jstate.residual)
    for k, v in jstate.residual.items():
        np.testing.assert_array_equal(port["residual"][k], np.asarray(v))


def _bucketed_jax_state(params, n):
    jhvd.init(devices=jax.devices()[:n])
    try:
        dtx = jhvd.DistributedOptimizer(
            optax.adam(1e-2), shard_optimizer=True, compression=JC.fp16,
            error_feedback=True, overlap=True, bucket_bytes=BB)
        s = dtx.init({k: jnp.asarray(v) for k, v in params.items()})
        r = np.random.RandomState(3)
        s = jax.tree_util.tree_map(
            lambda x: np.asarray(r.randn(*x.shape).astype(x.dtype))
            if np.issubdtype(np.asarray(x).dtype, np.floating)
            else np.asarray(x), s)
    finally:
        jhvd.shutdown()
    return s


def test_bucketed_state_reshards_2_4_2_as_jax():
    params = {"b": np.zeros(33, np.float32),
              "w": np.zeros((64, 33), np.float32)}
    j2 = _bucketed_jax_state(params, 2)
    j4 = jreshard(j2, params, to_size=4, bucket_bytes=BB)
    back = jreshard(j4, params, to_size=2, bucket_bytes=BB)
    p4 = topt.reshard_optimizer_state(_rows_state(j2), params, to_size=4,
                                      bucket_bytes=BB)
    _assert_rows_match(p4, jax.tree_util.tree_map(np.asarray, j4))
    p2 = topt.reshard_optimizer_state(p4, params, to_size=2, bucket_bytes=BB)
    _assert_rows_match(p2, jax.tree_util.tree_map(np.asarray, back))
    assert len(p2["residual"]) >= 2


def test_ambiguous_tail_bucket_reshards_by_its_key():
    """2044 f32 elements at 4096-byte buckets: L = 1024 and 1020, both
    ``[8, 128]`` at N = 8; each re-packs by its own key."""
    params = {"w": np.zeros(2044, np.float32)}
    j8 = _bucketed_jax_state(params, 8)
    j4 = jreshard(j8, params, to_size=4, bucket_bytes=BB)
    p4 = topt.reshard_optimizer_state(_rows_state(j8), params, to_size=4,
                                      bucket_bytes=BB)
    _assert_rows_match(p4, jax.tree_util.tree_map(np.asarray, j4))
    assert p4["residual"]["float32#1"].shape == (4, 1020)
    assert {np.shape(v) for v in p4["inner"]["mu"].values()} == {(4, 256),
                                                                 (4, 255)}


def test_wrong_bucket_bytes_is_refused_as_jax_refuses_it(monkeypatch):
    params = {"b": np.zeros(33, np.float32),
              "w": np.zeros((64, 33), np.float32)}
    j2 = _bucketed_jax_state(params, 2)
    with pytest.raises(ValueError) as je:
        jreshard(j2, params, to_size=4, bucket_bytes=1024)
    with pytest.raises(ValueError) as te:
        topt.reshard_optimizer_state(_rows_state(j2), params, to_size=4,
                                     bucket_bytes=1024)
    assert str(te.value) == str(je.value)
    assert "HOROVOD_BUCKET_BYTES" in str(te.value)
    monkeypatch.setenv("HOROVOD_BUCKET_BYTES", str(BB))  # the env's knob
    p4 = topt.reshard_optimizer_state(_rows_state(j2), params, to_size=4)
    assert p4["shard"] == {"size": 4}
    # a user parameter named with a '#' is not a bucket
    plain = {"shard": {"size": 2}, "inner": {
        "count": np.full(2, 1, np.int32),
        "mu": {"float32": np.zeros((2, 3), np.float32)}}}
    out = topt.reshard_optimizer_state(plain, {"block#0": np.ones(5,
                                                                  np.float32)},
                                       to_size=4)
    assert out["inner"]["mu"]["float32"].shape == (4, 2)
