"""The port's named-axis mesh, per-axis primitives, pipelines and experts
(``horovod_tpu_torch.parallel``) in gloo worlds of 2, 4 and 8, against
the JAX package's ``build_mesh``, ``shard_map`` collectives,
``pipeline_apply``/``pipeline_apply_interleaved``, PP train steps and
``expert_parallel_moe`` on the 8-device CPU mesh, on the same seeded
numpy inputs.

Tolerances are the JAX oracles' (``tests/test_pipeline_moe.py``,
``tests/test_transformer.py``): pipeline outputs rtol/atol 1e-5, their
gradients rtol 1e-4 / atol 1e-5; the transformer PP step's loss rtol
1e-5 and parameters rtol 1e-4 / atol 1e-5; the 3-D step's loss rtol 1e-5
and gradients rtol 1e-4 / atol 1e-5; MoE outputs rtol/atol 1e-4. The
primitives (one reduction each) hold within rtol 1e-6 / atol 1e-6 of
JAX. psum's backward is a psum in both frameworks, so a loss computed on
every rank from a psum-ed output over-counts a rank's gradient by the
axis size: the pipeline gradients are compared divided by it (what
``make_pp_train_step`` divides by), and the MoE's expert gradients (every
rank routing the same replicated tokens) are the axis size times the
one-device run's.
"""

import concurrent.futures

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import collective as JCol
from horovod_tpu.parallel import mesh as JM
from horovod_tpu.parallel import moe as JMoE
from horovod_tpu.parallel import pipeline as JP
from horovod_tpu_torch.parallel import mesh as TM
from horovod_tpu_torch.parallel import moe as TMoE
from horovod_tpu_torch.parallel import pipeline as TP
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

PRIM = dict(rtol=1e-6, atol=1e-6)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _smap(fn, mesh, axes, n_in=1):
    spec = P(axes)
    return jax.jit(JCol._smap(
        lambda *vs: fn(*[v[0] for v in vs])[None], mesh, (spec,) * n_in,
        spec))


def _jax_vg(fn, mesh, axes, x, w):
    f = _smap(fn, mesh, axes)
    out = f(jnp.asarray(x))
    g = jax.grad(lambda v: jnp.sum(f(v) * w))(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


# ---------------------------------------------------------------- the mesh


MESH_CASES = [
    {"data": 2, "pipe": 2, "model": 2},
    {"tp": 2, "data": -1},
    {"foo": 2, "seq": 2, "data": 2},
    {"data": -1},
    {"expert": 4, "data": 2},
    ((2, 2, 2),),
    {"data": -1, "seq": -1},
    {"data": 3, "tp": -1},
    {"data": 2, "tp": 2},
]


def _jax_mesh_case(axes):
    devices = jax.devices()[:8]
    try:
        m = (JM.MeshConfig(*axes).build(devices=devices)
             if isinstance(axes, tuple) else JM.build_mesh(axes, devices))
    except ValueError as e:
        return {"error": str(e)}
    ids = np.vectorize(lambda d: d.id)(m.devices)
    per_rank = []
    for r in range(8):
        pos = tuple(int(i) for i in np.argwhere(ids == r)[0])
        ranks = {}
        for i, a in enumerate(m.axis_names):
            idx = list(pos)
            line = []
            for j in range(ids.shape[i]):
                idx[i] = j
                line.append(int(ids[tuple(idx)]))
            ranks[a] = tuple(line)
        per_rank.append({"names": tuple(m.axis_names),
                         "shape": dict(m.shape),
                         "coords": dict(zip(m.axis_names, pos)),
                         "ranks": ranks})
    return per_rank


@pytest.fixture(scope="module")
def mesh_runs():
    port = run_world(W.mesh_worker, 8, MESH_CASES, timeout=300)
    return port, [_jax_mesh_case(c) for c in MESH_CASES]


@pytest.mark.parametrize("i", range(len(MESH_CASES)))
def test_build_mesh_layout_and_errors_match_jax(mesh_runs, i):
    port, ref = mesh_runs
    want = ref[i]
    for r in range(8):
        got = port[r][i]
        if isinstance(want, dict):
            assert got == want, (MESH_CASES[i], r)
        else:
            assert got == want[r], (MESH_CASES[i], r)


def test_mesh_config_rejections_match_jax():
    for args in (((2, 2), ("data", "fsdp", "tp")), ((2, 0, 2),),
                 ((2, -2, 2),)):
        with pytest.raises(ValueError) as jerr:
            JM.MeshConfig(*args)
        with pytest.raises(ValueError) as terr:
            TM.MeshConfig(*args)
        assert str(terr.value) == str(jerr.value)
    assert TM.MeshConfig((2, -1, 1)).axes == JM.MeshConfig((2, -1, 1)).axes


def test_shutdown_forgets_the_mesh():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        m = TM.build_mesh({"data": -1})
        assert TM.current_mesh() is m and m.shape == {"data": 1}
        assert m.axis_index("data") == 0 and m.ranks("data") == (0,)
        with pytest.raises(ValueError, match="no mesh axis 'seq'"):
            m.group("seq")
    finally:
        hvd.shutdown()
    hvd.init(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="build_mesh"):
            TM.current_mesh()
    finally:
        hvd.shutdown()


def test_mesh_axes_refuse_to_bypass_the_native_core():
    """With the native core attached, a collective over a mesh axis would
    run on the axis's communicator from the caller's thread beside the
    core's plans (two threads, two communicators, orders that can differ
    between ranks): every ``axis=<mesh axis>`` op and every spmd
    primitive raises instead, on every rank, and the world's ops still
    go through the core afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_CYCLE_TIME", "1")
        res = run_world(W.mesh_axis_under_core_worker, 2, native_core=True,
                        timeout=180)
    for out in res:
        assert len(out["errors"]) == 10
        for name, err in out["errors"].items():
            assert err is not None and "mesh axis 'tp'" in err \
                and "native core" in err, (name, err)
        np.testing.assert_array_equal(out["sum"], np.full(4, 3.0, np.float32))


# ------------------------------------------------------------ the primitives


def _spmd_inputs():
    r = np.random.RandomState(21)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    return {"x": f(4, 3, 5), "w": f(4, 3, 5), "a": f(4, 2, 4, 4, 3),
            "wa": f(4, 2, 8, 2, 3), "e": f(4, 8, 3, 2), "we": f(4, 2, 12, 2),
            "f": f(4, 2, 8, 3), "wf": f(4, 8, 2, 3)}


def _jax_spmd(inp):
    ref = {}
    devices = jax.devices()[:4]
    ds = JM.build_mesh({"data": 2, "seq": 2}, devices)
    DS = ("data", "seq")
    jhvd.init(mesh=ds)
    try:
        x, w, a, wa = inp["x"], inp["w"], inp["a"], inp["wa"]
        ref["psum_seq"] = _jax_vg(lambda v: lax.psum(v, "seq"), ds, DS, x, w)
        ref["pmean_data"] = _jax_vg(lambda v: lax.pmean(v, "data"), ds, DS,
                                    x, w)
        ref["ppermute_seq"] = _jax_vg(
            lambda v: lax.ppermute(v, "seq", [(0, 1), (1, 0)]), ds, DS, x, w)
        ref["a2a_seq"] = _jax_vg(
            lambda v: lax.all_to_all(v, "seq", 2, 1, tiled=True), ds, DS,
            a, wa)
        ref["ar_sum_seq"] = np.asarray(_smap(
            lambda v: JCol.allreduce(v, JCol.Sum, axis="seq"), ds, DS)(x))
        ref["ar_avg_data"] = np.asarray(_smap(
            lambda v: JCol.allreduce(v, JCol.Average, axis="data"), ds,
            DS)(x))
        ref["ag_seq"] = np.asarray(_smap(
            lambda v: JCol.allgather(v, axis="seq"), ds, DS)(x))
        ref["grouped_seq"] = [np.asarray(o) for o in jax.jit(JCol._smap(
            lambda u, v: tuple(o[None] for o in JCol.grouped_allreduce(
                [u[0], v[0]], JCol.Average, axis="seq")),
            ds, (P(DS), P(DS)), (P(DS), P(DS))))(x, a)]
    finally:
        jhvd.shutdown()
    pipe = JM.build_mesh({"pipe": 4}, devices)
    jhvd.init(mesh=pipe)
    try:
        ref["shift_open"] = _jax_vg(
            lambda v: lax.ppermute(v, "pipe", [(0, 1), (1, 2), (2, 3)]), pipe,
            "pipe", x, w)
        ref["shift_ring"] = _jax_vg(
            lambda v: lax.ppermute(v, "pipe", [(i, (i + 1) % 4)
                                               for i in range(4)]),
            pipe, "pipe", x, w)
        ref["a2a_pipe_0_1"] = _jax_vg(
            lambda v: lax.all_to_all(v, "pipe", 0, 1, tiled=True), pipe,
            "pipe", inp["e"], inp["we"])
        ref["a2a_pipe_1_0"] = _jax_vg(
            lambda v: lax.all_to_all(v, "pipe", 1, 0, tiled=True), pipe,
            "pipe", inp["f"], inp["wf"])
        ref["alltoall_pipe"] = np.asarray(_smap(
            lambda v: JCol.alltoall(v, axis="pipe"), pipe, "pipe")(inp["e"]))
        ref["rs_pipe"] = np.asarray(_smap(
            lambda v: JCol.reducescatter(v, JCol.Sum, axis="pipe"), pipe,
            "pipe")(inp["e"]))
    finally:
        jhvd.shutdown()
    return ref


@pytest.fixture(scope="module")
def spmd_runs():
    inp = _spmd_inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_world, W.spmd_worker, 4, inp, timeout=300)
        ref = _jax_spmd(inp)
        port = fut.result()
    return port, ref


@pytest.mark.parametrize("case", ["psum_seq", "pmean_data", "ppermute_seq",
                                  "a2a_seq", "shift_open", "shift_ring",
                                  "a2a_pipe_0_1", "a2a_pipe_1_0"])
def test_primitive_values_and_grads_match_jax(spmd_runs, case):
    """Each primitive's output and the gradient of ``sum(out * w)``
    against ``jax.grad`` through the JAX package's ``shard_map``: psum's
    backward sums the cotangents, ppermute's sends them back along the
    inverse pairs (zeros to a rank no pair names), all_to_all's exchanges
    them back."""
    port, ref = spmd_runs
    want_out, want_g = ref[case]
    for r in range(4):
        out, g = port[r][case]
        _close(out, want_out[r], **PRIM)
        _close(g, want_g[r], **PRIM)


@pytest.mark.parametrize("case", ["ar_sum_seq", "ar_avg_data", "ag_seq",
                                  "grouped_seq", "alltoall_pipe", "rs_pipe"])
def test_collectives_on_a_mesh_axis_match_jax(spmd_runs, case):
    port, ref = spmd_runs
    for r in range(4):
        got, want = port[r][case], ref[case]
        if case == "grouped_seq":
            for a, b in zip(got, want):
                _close(a, b[r], **PRIM)
        else:
            _close(got, want[r], **PRIM)


def test_axis_index_and_size_on_the_mesh(spmd_runs):
    port, _ = spmd_runs
    assert [p["index"] for p in port] == [(0, 0, 2), (0, 1, 2), (1, 0, 2),
                                          (1, 1, 2)]


# ------------------------------------------------------------------ pipelines


def _stages(n_stages, d, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) * 0.5).astype(np.float32),
             "b": (rng.randn(d) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_pipe(mesh, stacked, x, interleaved):
    fn = JP.pipeline_apply_interleaved if interleaved else JP.pipeline_apply

    def inner(sp, xm):
        local = jax.tree_util.tree_map(lambda p: p[0], sp)
        return lax.psum(fn(_jstage, local, xm, axis_name="pipe"), "pipe")

    return JCol._smap(inner, mesh, (P("pipe"), P()), P())(stacked, x)


#: world size -> (kind, v, n_micro, d, mb, seed): GPipe and the interleaved
#: schedule at the JAX tests' shapes
PIPE_CASES = {
    4: [("gpipe", 1, 4, 8, 3, 0), ("gpipe", 1, 7, 8, 3, 0),
        ("gpipe", 1, 5, 6, 2, 2), ("gpipe", 1, 2, 6, 2, 9),
        ("interleaved", 1, 5, 8, 3, 4), ("interleaved", 2, 4, 8, 3, 4),
        ("interleaved", 2, 7, 8, 3, 4)],
    2: [("interleaved", 3, 5, 8, 3, 4), ("interleaved", 2, 1, 8, 3, 4),
        ("interleaved", 2, 4, 6, 2, 6)],
}


def _pipe_inputs(n, case):
    kind, v, m, d, mb, seed = case
    stages = _stages(n * v, d, seed)
    x = np.random.RandomState(seed + 1).randn(m, mb, d).astype(np.float32)
    if kind == "gpipe":
        stacked = {k: np.stack([s[k] for s in stages]) for k in ("w", "b")}
    else:
        stacked = {k: np.asarray(v_) for k, v_ in JP.make_interleaved_stage_params(
            [{kk: jnp.asarray(a) for kk, a in s.items()} for s in stages],
            n).items()}
    return stages, stacked, x


def _jax_pipes(n):
    mesh = JM.build_mesh({"pipe": n}, jax.devices()[:n])
    out = []
    for case in PIPE_CASES[n]:
        _, stacked, x = _pipe_inputs(n, case)
        il = case[0] == "interleaved"
        st = {k: jnp.asarray(v) for k, v in stacked.items()}
        xj = jnp.asarray(x)
        y = jax.jit(lambda s: _jax_pipe(mesh, s, xj, il))(st)
        g = jax.jit(jax.grad(
            lambda s: jnp.sum(_jax_pipe(mesh, s, xj, il) ** 2)))(st)
        out.append({"out": np.asarray(y),
                    **{k: np.asarray(v) for k, v in g.items()}})
    return out


def _sequential(stages, x):
    outs = []
    for m in range(x.shape[0]):
        h = x[m].astype(np.float64)
        for p in stages:
            h = np.tanh(h @ p["w"] + p["b"])
        outs.append(h)
    return np.stack(outs)


@pytest.fixture(scope="module")
def pipe_runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futs = {n: pool.submit(run_world, W.pipeline_worker, n,
                               [(c[0],) + _pipe_inputs(n, c)[1:]
                                for c in PIPE_CASES[n]], timeout=300)
                for n in PIPE_CASES}
        ref = {n: _jax_pipes(n) for n in PIPE_CASES}
        port = {n: f.result() for n, f in futs.items()}
    return port, ref


@pytest.mark.parametrize("n,i", [(n, i) for n in PIPE_CASES
                                 for i in range(len(PIPE_CASES[n]))])
def test_pipeline_matches_jax_and_sequential(pipe_runs, n, i):
    """GPipe (``n_micro`` 4, 7, 5 and 2 < S) and the interleaved schedule
    (v 1, 2, 3; M 1, 4, 5, 7): the psum-ed output on every rank against
    the JAX package's and the sequential stages (rtol/atol 1e-5), each
    rank's stage gradient over S against JAX's (rtol 1e-4, atol 1e-5)."""
    port, ref = pipe_runs
    case = PIPE_CASES[n][i]
    stages, _, x = _pipe_inputs(n, case)
    seq = _sequential(stages, x)
    want = ref[n][i]
    _close(want["out"], seq, rtol=1e-5, atol=1e-5)
    for r in range(n):
        got = port[n][r][i]
        _close(got["out"], want["out"], rtol=1e-5, atol=1e-5)
        for k in ("w", "b"):
            _close(got[k] / n, want[k][r], rtol=1e-4, atol=1e-5)


def test_interleaved_schedule_is_the_drain_first_greedy():
    """The host simulation of the JAX scan's ``meta`` carry: every
    micro-batch visits the L stages in order, one a tick, each on device
    ``stage % S``; the last work lands no earlier than the make-span
    bound ``M*v + S - 2`` and inside the scan's ``M*v + L`` ticks; the
    last device completes each micro-batch once."""
    for S, v, M in ((4, 1, 5), (4, 2, 4), (4, 2, 7), (2, 3, 5), (2, 2, 1),
                    (4, 3, 8)):
        ticks = TP.interleaved_schedule(S, v, M)
        assert len(ticks) == M * v + S * v
        visits = {m: [] for m in range(M)}
        last = 0
        for t, row in enumerate(ticks):
            for d, tick in enumerate(row):
                if tick.active:
                    visits[tick.mb].append((t, tick.w * S + d))
                    last = t
        for m in range(M):
            assert [s for _, s in visits[m]] == list(range(S * v)), (S, v, m)
            ts = [t for t, _ in visits[m]]
            assert ts == sorted(ts) and len(set(ts)) == len(ts)
        assert M * v + S - 2 <= last < len(ticks), (S, v, M, last)
        finals = [(t, d) for t, row in enumerate(ticks)
                  for d, tick in enumerate(row) if tick.final]
        assert len(finals) == M and all(d == S - 1 for _, d in finals)


def test_stage_params_layouts_match_jax():
    stages = _stages(6, 4, 3)
    jst = [{k: jnp.asarray(a) for k, a in s.items()} for s in stages]
    tst = [{k: W._t(a) for k, a in s.items()} for s in stages]
    for n in (2, 3, 6):
        want = JP.make_interleaved_stage_params(jst, n)
        got = TP.make_interleaved_stage_params(tst, n)
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    want, got = JP.make_stage_params(jst), TP.make_stage_params(tst)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError) as jerr:
        JP.make_interleaved_stage_params(jst[:5], 2)
    with pytest.raises(ValueError) as terr:
        TP.make_interleaved_stage_params(tst[:5], 2)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------- PP train steps


def _pp_step_inputs(interleaved):
    S, v, d, mb, M = 4, 2, 8, 4, 6
    rng = np.random.RandomState(0)
    L = S * v if interleaved else S
    stages = [{"w": (rng.randn(d, d) * 0.3).astype(np.float32),
               "b": np.zeros(d, np.float32)} for _ in range(L)]
    wt = rng.randn(d, d).astype(np.float32)
    x = rng.randn(M, mb, d).astype(np.float32)
    y = np.tanh(x @ wt).astype(np.float32)
    if interleaved:
        stacked = {k: np.asarray(a) for k, a in
                   JP.make_interleaved_stage_params(
                       [{kk: jnp.asarray(a) for kk, a in s.items()}
                        for s in stages], S).items()}
    else:
        stacked = {k: np.stack([s[k] for s in stages]) for k in ("w", "b")}
    return stacked, x, y


PP_STEPS, PP_LR = 30, 3e-3


def _jax_pp_losses(stacked, x, y, interleaved):
    import optax

    from horovod_tpu.training import make_pp_train_step

    jhvd.init(axes={"pipe": 4}, devices=jax.devices()[:4])
    try:
        tx = optax.adam(PP_LR)
        st = {k: jnp.asarray(a) for k, a in stacked.items()}
        opt = jax.vmap(tx.init)(st)
        step = make_pp_train_step(_jstage, tx, interleaved=interleaved,
                                  donate=False)
        losses = []
        for _ in range(PP_STEPS):
            st, opt, loss = step(st, opt, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        return losses
    finally:
        jhvd.shutdown()


@pytest.mark.parametrize("interleaved", [False, True])
def test_make_pp_train_step_trains_as_jax(interleaved):
    """The stacked PP step with Adam(3e-3), 30 steps on a learnable
    teacher: the loss falls below 0.7 of its start (the JAX test's bar),
    the first loss equals JAX's (rtol 1e-5) and the trajectory stays
    within rtol 1e-3 of JAX's (Adam turns last-bit gradient differences
    into small update differences)."""
    stacked, x, y = _pp_step_inputs(interleaved)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_world, W.pp_step_worker, 4, stacked, x, y,
                          PP_STEPS, interleaved, PP_LR, timeout=300)
        want = _jax_pp_losses(stacked, x, y, interleaved)
        port = fut.result()
    for losses in port:
        assert losses == port[0]
        assert losses[-1] < losses[0] * 0.7, losses[::10]
        _close(losses[0], want[0], rtol=1e-5)
        _close(losses, want, rtol=1e-3)


def _lm_cfg(vocab, depth):
    return dict(vocab=vocab, dim=32, depth=depth, heads=4, max_len=64)


def _jax_dense_step(cfg, params, tokens, targets, lr):
    from horovod_tpu.models import TransformerLM
    from horovod_tpu.training import token_xent

    model = TransformerLM(**cfg, dtype=jnp.float32)

    def loss_fn(p):
        return token_xent(model.apply({"params": p}, jnp.asarray(tokens)),
                          jnp.asarray(targets))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return float(loss), new


def _transformer_pp_case(S, v, vocab, depth, seed):
    from horovod_tpu.models import TransformerLM
    from horovod_tpu_torch.models.convert import flatten_tree

    cfg = _lm_cfg(vocab, depth)
    rng = np.random.RandomState(seed)
    M, mb, T = 4, 2, 12
    tokens = rng.randint(0, vocab, (M * mb, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    params = jax.jit(TransformerLM(**cfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(seed), jnp.asarray(tokens[:1]))["params"]
    flat = {k: np.asarray(a) for k, a in flatten_tree(params).items()}
    lr = 0.1
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_world, W.transformer_pp_worker, S, cfg, flat,
                          tokens.reshape(M, mb, T).astype(np.int64),
                          targets.reshape(M, mb, T).astype(np.int64), S, v,
                          lr, timeout=300)
        loss_d, new = _jax_dense_step(cfg, params, tokens, targets, lr)
        port = fut.result()
    return flatten_tree(new), loss_d, port


@pytest.mark.parametrize("S,v,vocab,seed", [(4, 1, 256, 11), (2, 2, 128, 13)])
def test_transformer_pp_step_matches_dense(S, v, vocab, seed):
    """``make_transformer_pp_train_step`` (GPipe at S=4 over 4 blocks, and
    S=2 x v=2): one SGD(0.1) step's loss (rtol 1e-5) and every updated
    parameter (rtol 1e-4, atol 1e-5) against the JAX package's dense
    single-device step, the JAX oracle's bars; the embedding and head
    agree on every rank."""
    new, loss_d, port = _transformer_pp_case(S, v, vocab, 4, seed)
    for r, res in enumerate(port):
        _close(res["loss"], loss_d, rtol=1e-5)
        for k in ("tok_embed/embedding", "pos_embed"):
            _close(res[f"embed:{k}"], new[k], rtol=1e-4, atol=1e-5)
        for k in ("ln_f/scale", "ln_f/bias", "lm_head/kernel"):
            _close(res[f"head:{k}"], new[k], rtol=1e-4, atol=1e-5)
        for k in [k for k in res if k.startswith("stages:")]:
            leaf = k[len("stages:b0/"):]
            for w in range(v):
                block = w * S + r
                got = res[k][0] if v == 1 else res[k][0, w]
                _close(got, new[f"block{block}/{leaf}"], rtol=1e-4,
                       atol=1e-5, err_msg=f"block{block}/{leaf}")


def test_split_transformer_for_pp_rejections_match_jax():
    import torch

    from horovod_tpu.models import TransformerLM as JLM
    from horovod_tpu.training import split_transformer_for_pp as jsplit
    from horovod_tpu_torch.models.transformer import TransformerLM as TLM
    from horovod_tpu_torch.training import split_transformer_for_pp as tsplit

    for kw, n in ((dict(), 3), (dict(pos_embedding="rope"), 2)):
        jm = JLM(**_lm_cfg(64, 4), dtype=jnp.float32, **kw)
        jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
        tm = TLM(**_lm_cfg(64, 4), dtype=torch.float32, **kw)
        with pytest.raises(ValueError) as jerr:
            jsplit(jm, jp["params"], n)
        with pytest.raises(ValueError) as terr:
            tsplit(tm, tm.jax_params(), n)
        assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------- 3-D (DP x PP x TP)


def test_3d_parallel_step_matches_dense():
    """DP 2 x PP 2 x TP 2 in one gloo world of 8: an MLP stage split over
    ``model`` (psum inside the stage), pipelined over ``pipe``, the batch
    over ``data``; gradients divided by S*tp (psum's backward over-counts
    by it) and pmean-ed over data. Loss (rtol 1e-5) and every rank's
    gradient shards (rtol 1e-4, atol 1e-5) against the dense model's, the
    JAX test's oracle and bars."""
    dp, S, tp = 2, 2, 2
    d, hid, mb, M = 4, 8, 6, 4
    rng = np.random.RandomState(0)
    w1 = (rng.randn(S, d, hid) * 0.4).astype(np.float32)
    w2 = (rng.randn(S, hid, d) * 0.4).astype(np.float32)
    x = rng.randn(M, mb, d).astype(np.float32)
    y = rng.randn(M, mb, d).astype(np.float32)
    port = run_world(W.three_d_worker, 8, w1, w2, x, y, timeout=300)

    def dense_loss(params):
        a, b = params
        out = []
        for m in range(M):
            h = x[m]
            for s in range(S):
                h = jax.nn.relu(h @ a[s]) @ b[s]
            out.append(h)
        return jnp.mean((jnp.stack(out) - y) ** 2)

    loss, (g1, g2) = jax.value_and_grad(dense_loss)((jnp.asarray(w1),
                                                     jnp.asarray(w2)))
    g1, g2 = np.asarray(g1), np.asarray(g2)
    h = hid // tp
    for res in port:
        dd, p, t = res["coords"]
        _close(res["loss"], float(loss), rtol=1e-5)
        _close(res["g1"], g1[p, :, t * h:(t + 1) * h], rtol=1e-4, atol=1e-5)
        _close(res["g2"], g2[p, t * h:(t + 1) * h], rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------- MoE


def _jexpert(p, tokens):
    w1, w2 = p
    return jax.nn.relu(tokens @ w1) @ w2


def _moe_case(n, e_local, d, t, seed, factor, routing, hidden=2):
    rng = np.random.RandomState(seed)
    e = n * e_local
    router = (rng.randn(d, e) * 0.3).astype(np.float32)
    w1 = (rng.randn(e, d, hidden * d) * 0.3).astype(np.float32)
    w2 = (rng.randn(e, hidden * d, d) * 0.3).astype(np.float32)
    x = rng.randn(t, d).astype(np.float32)
    return router, w1, w2, x, factor, routing


def _drop_case():
    rng = np.random.RandomState(7)
    d, t = 4, 12
    router = np.zeros((d, 2), np.float32)
    router[0, 0] = 5.0
    w1 = rng.randn(2, d, d).astype(np.float32)
    w2 = rng.randn(2, d, d).astype(np.float32)
    x = np.abs(rng.randn(t, d)).astype(np.float32)
    return router, w1, w2, x, 0.5, "top1"


MOE_CASES = {
    4: [_moe_case(4, 2, 8, 16, 5, 8.0, "top1"),
        _moe_case(4, 2, 8, 16, 7, 8.0, "top2")],
    2: [_moe_case(2, 2, 4, 8, 11, 4.0, "top1"), _drop_case(),
        _moe_case(2, 2, 4, 8, 11, 1.0, "top2")],
}


def _jax_moe(case, mesh_n):
    router, w1, w2, x, factor, routing = case
    mesh = JM.build_mesh({"expert": mesh_n}, jax.devices()[:mesh_n])
    f = JCol._smap(
        lambda r, a, b, xx: JMoE.expert_parallel_moe(
            r, (a, b), xx, _jexpert, axis_name="expert",
            capacity_factor=factor, routing=routing),
        mesh, (P(), P("expert"), P("expert"), P()), (P(), P()))
    y, aux = jax.jit(f)(router, w1, w2, x)

    def loss(r, a, b):
        yy, au = f(r, a, b, x)
        return (yy ** 2).sum() + 0.01 * au

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(router, w1, w2)
    return {"y": np.asarray(y), "aux": float(aux),
            "grads": [np.asarray(a) for a in g]}


@pytest.fixture(scope="module")
def moe_runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futs = {n: pool.submit(run_world, W.moe_worker, n, MOE_CASES[n],
                               timeout=300) for n in MOE_CASES}
        ref = {n: [(_jax_moe(c, n), _jax_moe(c, 1))
                   for c in MOE_CASES[n]] for n in MOE_CASES}
        port = {n: f.result() for n, f in futs.items()}
    return port, ref


@pytest.mark.parametrize("n,i", [(n, i) for n in MOE_CASES
                                 for i in range(len(MOE_CASES[n]))])
def test_moe_matches_jax(moe_runs, n, i):
    """``expert_parallel_moe`` (top1 and top2, ample capacity, the
    all-to-expert-0 capacity drop, and top2 at capacity factor 1 where
    second choices drop): output and aux against the JAX package's on the
    same expert mesh (rtol/atol 1e-4); the gradients of ``sum(y**2) +
    0.01 aux`` against the JAX package's one-device run (all experts
    local): the router's equal, each rank's experts' the axis size times
    (every rank routes the same tokens to them)."""
    port, ref = moe_runs
    want, one = ref[n][i]
    e_local = MOE_CASES[n][i][1].shape[0] // n
    for r in range(n):
        got = port[n][r][i]
        _close(got["y"], want["y"], rtol=1e-4, atol=1e-4)
        _close(got["aux"], want["aux"], rtol=1e-5)
        _close(got["router"], one["grads"][0], rtol=1e-4, atol=1e-4)
        sl = slice(r * e_local, (r + 1) * e_local)
        _close(got["w1"], n * one["grads"][1][sl], rtol=1e-4, atol=1e-4)
        _close(got["w2"], n * one["grads"][2][sl], rtol=1e-4, atol=1e-4)


def test_moe_local_reference_and_drops(moe_runs):
    """The JAX tests' own oracles: with ample capacity each token is its
    argmax expert's output scaled by its gate (top1) or the pair's
    renormalized mixture (top2); the all-to-expert-0 case returns at
    least t - 4 zero rows."""
    port, _ = moe_runs
    for n, i in ((4, 0), (4, 1)):
        router, w1, w2, x, _, routing = MOE_CASES[n][i]
        logits = x @ router
        gates = np.exp(logits - logits.max(-1, keepdims=True))
        gates /= gates.sum(-1, keepdims=True)
        ref = np.zeros_like(x)
        for t_ in range(x.shape[0]):
            order = np.argsort(-gates[t_])
            picks = order[:1] if routing == "top1" else order[:2]
            gs = gates[t_, picks] / (1.0 if routing == "top1"
                                     else gates[t_, picks].sum())
            for e, g in zip(picks, gs):
                h = np.maximum(x[t_] @ w1[e], 0) @ w2[e]
                ref[t_] += g * h
        _close(port[n][0][i]["y"], ref, rtol=1e-4, atol=1e-4)
    y = port[2][0][1]["y"]
    assert (np.abs(y).sum(axis=1) == 0).sum() >= y.shape[0] - 4


def test_dispatch_tensors_match_jax():
    """top1/top2 dispatch, combine and aux bit for bit against the JAX
    package's (capacity drops included: top2's second choices after every
    first choice), and top2's gradient through combine and aux (rtol
    1e-6)."""
    import torch

    rng = np.random.RandomState(0)
    cases = [(rng.randn(16, 4).astype(np.float32), 3),
             (np.tile(np.array([[3.0, 1.0]], np.float32), (6, 1)), 3),
             (np.array([[3.0, 1.0]] * 3 + [[1.0, 3.0]] * 3, np.float32), 4),
             (rng.randn(8, 4).astype(np.float32), 4)]
    for logits, cap in cases:
        for jf, tf in ((JMoE.top1_dispatch, TMoE.top1_dispatch),
                       (JMoE.top2_dispatch, TMoE.top2_dispatch)):
            want = jf(jnp.asarray(logits), cap)
            got = tf(torch.from_numpy(logits), cap)
            for a, b in zip(got, want):
                _close(a.numpy(), b, rtol=1e-6, atol=1e-7)
    logits = cases[3][0]
    jg = jax.grad(lambda lg: jnp.sum(JMoE.top2_dispatch(lg, 4)[1])
                  + JMoE.top2_dispatch(lg, 4)[2])(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    _, c, aux = TMoE.top2_dispatch(tl, 4)
    (tg,) = torch.autograd.grad(c.sum() + aux, [tl])
    _close(tg.numpy(), jg, rtol=1e-6, atol=1e-7)
    assert TMoE.moe_capacity(4096, 8, 2.0) == 1024


def test_moe_bad_routing_raises_the_jax_text():
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        TM.build_mesh({"expert": 1})
        with pytest.raises(ValueError, match="top1.*top2"):
            TMoE.expert_parallel_moe(
                torch.zeros(8, 8), (torch.zeros(2, 8, 8),
                                    torch.zeros(2, 8, 8)),
                torch.zeros(8, 8), W._expert_fn, routing="top3")
    finally:
        hvd.shutdown()
