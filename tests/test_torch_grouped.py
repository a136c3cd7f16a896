"""The fused exchange of allreduce mode on gloo worlds of 2 and 4 against
the JAX package on 2- and 4-device CPU meshes, same per-rank inputs.

- the fused int8 exchange (``ops.collective._grouped_allreduce(leaves,
  op, Compression.int8)``, which allreduce mode calls): one int8
  exchange for every quantizable leaf, each result bit for bit the
  JAX package's own per-leaf ``allreduce(g, op, compression=int8)`` at
  N = 2 and 4 (the ``[N, S]`` layout keeps each leaf's scale blocks, and
  B4 sums in sender order), NaN, infinite and all-zero blocks included;
- ``grouped_allreduce`` of mixed f32/bf16/int32 lists against the JAX
  ``grouped_allreduce``: bit for bit at N = 2; at N = 4 the int8 members
  and the integers bit for bit, the f32 and bf16 sums within
  ``(N - 1) * eps * sum_r |x_r|`` (divided by N for Average): the
  backend may add N terms in another order for another buffer size, and
  two orders of N - 1 rounded additions differ by at most that; ``Min``
  sums, as the JAX package's grouped op does;
- allreduce mode + int8 + error feedback over 6 steps at N = 4 against
  JAX's ``DistributedOptimizer(..., shard_optimizer=False)``, under the
  bars of ``tests/test_torch_optim.py::test_six_step_trajectory``;
- the residual of the one quantize pass equals the JAX package's
  ``c - decompress(compress(c))`` per leaf, NaN and infinite leaves
  included;
- one update makes one quantize, one requantize and one dequantize
  whatever the number of leaves, and four int8 collectives plus one
  ``all_reduce`` per other dtype.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops import collective as JCol
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

STEPS = 6
TRAJ_RTOL, TRAJ_ATOL = 5e-3, 5e-4     # test_six_step_trajectory's int8 bars
EPS = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


def _int8_leaves(n):
    """Stacked ``[N, ...]`` f32 leaves at awkward sizes: a NaN block
    (rank 0's), an all-zero block on every rank, an infinity (rank 1's)."""
    r = np.random.RandomState(50 + n)
    shapes = [(1024,), (1025,), (4095,), (4096,), (4097,), (64, 3, 7, 7),
              (n * 256 * 3 + 5,)]
    leaves = [(r.randn(n, *s) * 10.0 ** r.randint(-3, 1)).astype(np.float32)
              for s in shapes]
    leaves[1][0, 300] = np.nan
    leaves[3][:, 512:768] = 0.0
    leaves[5][1, 2, 1, 3, 4] = np.inf
    return leaves


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _mixed(n):
    """Stacked leaves and their dtypes: f32 that rides int8 (two), small
    f32, bf16 (one above the int8 floor, which bf16 never rides), int32."""
    r = np.random.RandomState(60 + n)
    return [
        (r.randn(n, 1500).astype(np.float32), "float32"),
        (_bf16(r.randn(n, 300)), "bfloat16"),
        ((r.randn(n, 37, 41) * 3).astype(np.float32), "float32"),
        (r.randint(-50, 50, (n, 7)).astype(np.int32), "int32"),
        (r.randn(n, 100).astype(np.float32), "float32"),
        (_bf16(r.randn(n, 2, 1100)), "bfloat16"),
        (r.randn(n, 3).astype(np.float32), "float32"),
    ]


def _quantized(x, dt):
    return dt == "float32" and x[0].size >= JC.int8.min_quant_elems


def _params():
    r = np.random.RandomState(31)
    return {"w": (r.randn(40, 30).astype(np.float32) * 0.1),
            "b": np.zeros((30,), np.float32)}


def _batch(n):
    r = np.random.RandomState(32)
    return (r.randn(2 * n, 40).astype(np.float32),
            r.randn(2 * n, 30).astype(np.float32))


def _residual_inputs():
    r = np.random.RandomState(70)
    shapes = {"a": (1024,), "b": (1025,), "c": (64, 3, 7, 7), "d": (4097,),
              "e": (100,), "f": (30,)}
    g1, g2 = ({k: (r.randn(2, *s) * 1e-2).astype(np.float32)
               for k, s in shapes.items()} for _ in range(2))
    g1["b"][0, 10] = np.nan               # a NaN in a quantized leaf
    g1["c"][1, 0, 0, 0, 5] = np.inf       # an infinity in one
    g2["e"][0, 3] = np.nan                # a NaN and an infinity in leaves
    g2["f"][1, 7] = np.inf                # the wire carries exactly
    return {"g1": g1, "g2": g2}


SPEC40 = {**{f"q{i:02d}": ((1024 + 37 * i,), "float32") for i in range(20)},
          **{f"s{i:02d}": ((10 + i,), "float32") for i in range(15)},
          **{f"h{i}": ((300,), "bfloat16") for i in range(5)}}
SPEC4 = {"a": ((2000,), "float32"), "b": ((40, 30), "float32"),
         "c": ((7,), "float32"), "d": ((50,), "bfloat16")}


def _inputs(n):
    inp = {"int8": _int8_leaves(n), "mixed": _mixed(n)}
    if n == 4:
        x, y = _batch(n)
        inp.update(traj=dict(_params(), x=x, y=y), traj_steps=STEPS)
    if n == 2:
        inp["residual"] = _residual_inputs()
        inp["dispatch"] = {f"{name}_{'ef' if ef else 'plain'}": (spec, ef)
                           for name, spec in (("tree40", SPEC40),
                                              ("tree4", SPEC4))
                           for ef in (True, False)}
    return inp


def _np(x):
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _jax_refs(n, inp):
    """The JAX package's results on an n-device mesh: per-leaf int8
    allreduce per rank (bound axis), and the eager grouped allreduce."""
    jhvd.init(devices=jax.devices()[:n])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()

        def per_rank_int8(xs, op):
            body = lambda *vs: tuple(  # noqa: E731
                JCol.allreduce(v[0], op, axis=ax, compression=JC.int8)[None]
                for v in vs)
            f = jax.jit(JCol._smap(body, mesh, (P(ax),) * len(xs),
                                   (P(ax),) * len(xs)))
            return [np.asarray(o) for o in f(*map(jnp.asarray, xs))]

        def grouped(op):
            xs = [jax.device_put(jnp.asarray(x, getattr(jnp, dt)),
                                 NamedSharding(mesh, P(ax)))
                  for x, dt in inp["mixed"]]
            return [_np(o) for o in JCol.grouped_allreduce(xs, op)]

        big = [x for x, dt in inp["mixed"] if _quantized(x, dt)]
        ref = {}
        for name, op in (("avg", JCol.Average), ("sum", JCol.Sum)):
            ref[f"int8_{name}"] = per_rank_int8(inp["int8"], op)
            ref[f"mixed_{name}"] = grouped(op)
            ref[f"mixed_int8_{name}"] = per_rank_int8(big, op)
        if "traj" in inp:
            ref["traj"] = _jax_trajectory(mesh, ax, n)
    finally:
        jhvd.shutdown()
    return ref


def _jax_trajectory(mesh, ax, n):
    dtx = jhvd.DistributedOptimizer(optax.adam(1e-2), compression=JC.int8,
                                    error_feedback=True, shard_optimizer=False)
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    s = dtx.init(p)

    def loss_fn(pp, xx, yy):
        return jnp.mean((xx @ pp["w"] + pp["b"][None] - yy) ** 2)

    def step(pp, ss, xx, yy):
        l, g = jax.value_and_grad(loss_fn)(pp, xx, yy)
        u, ss = dtx.update(g, ss, pp)
        return (optax.apply_updates(pp, u), ss,
                JCol.allreduce(l, JCol.Average, axis=ax))

    sm = jax.jit(JCol._smap(step, mesh, (P(), P(), P(ax), P(ax)),
                            (P(), P(), P())))
    x, y = (jnp.asarray(a) for a in _batch(n))
    for _ in range(STEPS):
        p, s, l = sm(p, s, x, y)
    return {k: np.asarray(v) for k, v in p.items()}, float(l)


@functools.lru_cache(maxsize=None)
def _world(n):
    """Every port case in one gloo world of ``n``, and the JAX side's."""
    inp = _inputs(n)
    port = run_world(W.grouped_worker, n, inp, timeout=240)
    return n, inp, port, _jax_refs(n, inp)


@pytest.fixture(params=[2, 4], ids=["n2", "n4"])
def world(request):
    return _world(request.param)


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


@pytest.mark.parametrize("op", ["avg", "sum"])
def test_fused_int8_matches_jax_per_leaf_bitwise(world, op):
    n, inp, port, ref = world
    for r in range(n):
        got = port[r][f"int8_{op}"]
        assert len(got) == len(inp["int8"])
        for i, (g, want) in enumerate(zip(got, ref[f"int8_{op}"])):
            assert _same_bits(g, want[r]), (op, r, i)
    # the wire really quantized, and the NaN block reached every rank
    exact = inp["int8"][0].sum(axis=0) / (n if op == "avg" else 1)
    assert not np.array_equal(port[0][f"int8_{op}"][0], exact)
    assert np.isnan(port[n - 1][f"int8_{op}"][1][256:512]).all()


@pytest.mark.parametrize("op", ["avg", "sum"])
@pytest.mark.parametrize("wire", ["none", "int8"])
def test_grouped_allreduce_mixed_matches_jax(world, op, wire):
    n, inp, port, ref = world
    key = f"mixed_{op}" if wire == "none" else f"mixed_int8_{op}"
    big = iter(ref[f"mixed_int8_{op}"])
    for i, ((x, dt), want) in enumerate(zip(inp["mixed"], ref[f"mixed_{op}"])):
        quant = wire == "int8" and _quantized(x, dt)
        rows = next(big) if _quantized(x, dt) else None
        for r in range(n):
            got = port[r][key][i]
            if quant:
                assert _same_bits(got, rows[r]), (i, r)
            elif n == 2 or dt == "int32":
                assert _same_bits(got, want), (i, r, dt)
            else:
                # another summation order: (N-1) roundings of at most
                # eps/2 * sum|x| on each side
                bar = (n - 1) * EPS[dt] * np.abs(x).sum(axis=0)
                bar = bar / (n if op == "avg" else 1)
                assert got.shape == want.shape and got.dtype == want.dtype
                assert (np.abs(got - want) <= bar).all(), (i, r, dt)


def test_grouped_min_sums_as_the_jax_package_does(world):
    """The JAX package's grouped_allreduce psums every op but Average and
    Adasum; the port's matches it (ROADMAP Queue C)."""
    n, _, port, _ = world
    for r in range(n):
        for got, want in zip(port[r]["mixed_min"], port[r]["mixed_sum"]):
            assert _same_bits(got, want)


def test_allreduce_mode_int8_ef_trajectory_at_four():
    n, _, port, ref = _world(4)
    pj, lj = ref["traj"]
    for r in range(n):
        for k in ("w", "b"):
            np.testing.assert_allclose(port[r]["traj"]["params"][k], pj[k],
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
        assert all(np.array_equal(port[r]["traj"]["params"][k],
                                  port[0]["traj"]["params"][k])
                   for k in ("w", "b"))
    np.testing.assert_allclose(port[0]["traj"]["loss"], lj, rtol=TRAJ_RTOL)


def _jax_residual(c):
    """The JAX package's ``c - _roundtrip(c)`` of one leaf."""
    cj = jnp.asarray(c)
    return np.asarray(cj - JC.int8.decompress(*JC.int8.compress(cj)))


def test_single_pass_residual_is_c_minus_roundtrip_per_leaf():
    """Error feedback's residual from the fused exchange's one quantize
    pass is, leaf by leaf and bit for bit, the JAX package's residual of
    that leaf alone (computed apart from the wire there), over two steps,
    NaN and infinite leaves included."""
    n, inp, port, _ = _world(2)
    g1, g2 = inp["residual"]["g1"], inp["residual"]["g2"]
    for r in range(n):
        res1, res2 = port[r]["residual"]
        for k in g1:
            c1 = g1[k][r] + np.zeros_like(g1[k][r])
            assert _same_bits(res1[k], _jax_residual(c1)), (r, k)
            c2 = g2[k][r] + res1[k]
            assert _same_bits(res2[k], _jax_residual(c2)), (r, k)
    res1 = port[0]["residual"][0]
    assert np.isnan(res1["b"][:256]).all() and not np.isnan(res1["b"][256:]).any()
    assert np.abs(res1["a"]).max() > 0               # the wire rounded
    assert np.isnan(port[1]["residual"][1]["f"][7])  # inf - inf, not zero
    assert np.count_nonzero(port[1]["residual"][1]["f"]) == 1


@pytest.mark.parametrize("tree", ["tree40", "tree4"])
@pytest.mark.parametrize("ef", ["ef", "plain"])
def test_one_kernel_call_and_four_collectives_a_step(tree, ef):
    """One allreduce-mode int8 update makes one quantize (the roundtrip
    one with error feedback), one requantize and one dequantize, two
    ``all_to_all`` and two ``all_gather`` for the one quantizable dtype
    and one ``all_reduce`` for each other dtype (small f32, bf16),
    whatever the number of leaves; the state keeps its layout."""
    _, _, port, _ = _world(2)
    got = port[0]["dispatch"][f"{tree}_{ef}"]
    counts = got["counts"]
    want = {"quantize_roundtrip": int(ef == "ef"),
            "quantize_blockwise": int(ef == "plain"),
            "dequant_accumulate_requantize": 1, "dequantize_rows": 1}
    assert {k: counts.get(k, 0) for k in want} == want, counts
    gathers = counts.get("all_gather_single", 0) + counts.get(
        "all_gather_into_tensor", 0)
    assert (counts.get("all_to_all_single", 0), gathers,
            counts.get("all_reduce", 0)) == (2, 2, 2), counts
    assert got["layout"]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_quant_rows_layout_round_trips_and_keeps_each_leafs_blocks(n):
    """The ``[N, S]`` layout: every offset and width a multiple of the
    256-element block, zeros past each leaf, every leaf back exactly
    (views of the buffer at N = 1), and the buffer's scale blocks those of
    each leaf's own padded ``[N, s_i]`` rows."""
    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(n)
    conv = torch.randn(64, 3, 7, 7, generator=gen)
    leaves = [torch.randn(sz, generator=gen)
              for sz in (1024, 1025, 4095, 7, n * 256 * 3 + 5, 256)]
    leaves.insert(2, conv.permute(2, 3, 1, 0))       # an HWIO view
    sizes = tuple(x.numel() for x in leaves)
    cols, offs, S = C._quant_rows_layout(sizes, n, 256)
    assert all(o % 256 == 0 for o in offs) and all(c % 256 == 0 for c in cols)
    assert S == sum(cols) and offs[0] == 0
    assert all(0 <= n * c - sz < n * 256 for c, sz in zip(cols, sizes))
    buf = C._pack_quant_rows(leaves, n, cols)
    assert tuple(buf.shape) == (n, S)
    back = C._unpack_quant_rows(buf, cols, sizes, [x.shape for x in leaves])
    for x, y in zip(leaves, back):
        assert y.shape == x.shape and torch.equal(x, y)
        if n == 1:
            assert y.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
    _, scales = K.quantize_plain(buf.reshape(-1))
    scales = scales.view(n, S // 256)
    for x, c, o, sz in zip(leaves, cols, offs, sizes):
        own = torch.nn.functional.pad(x.reshape(-1), (0, n * c - sz))
        assert not buf[:, o:o + c].reshape(-1)[sz:].any()
        _, own_scales = K.quantize_plain(own)
        assert torch.equal(scales[:, o // 256:(o + c) // 256].reshape(-1),
                           own_scales)


def test_grouped_allreduce_world_of_one_and_refusals(monkeypatch):
    """At a world of one the grouped op is the identity (the fused int8
    exchange: the wire's rounding). The int8 exchange refuses every op but
    Average and Sum, as ``allreduce`` does; ``grouped_allreduce`` takes no
    compression, as the JAX package's."""
    import horovod_tpu_torch as hvd

    int8 = hvd.Compression.int8
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        xs = [torch.arange(6.0).view(2, 3), torch.arange(4, dtype=torch.int32)]
        outs = hvd.grouped_allreduce(xs)
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(outs, xs))
        big = torch.randn(2048, generator=torch.Generator().manual_seed(0))
        (q,), _ = C._grouped_allreduce([big], hvd.Average, int8)
        assert torch.equal(q, hvd.allreduce(big, compression=int8))
        assert not torch.equal(q, big)
        for op in (hvd.Min, hvd.Max):
            with pytest.raises(ValueError, match="Average/Sum"):
                C._grouped_allreduce([big], op, int8)
            with pytest.raises(ValueError, match="Average/Sum"):
                hvd.allreduce(big, op, compression=int8)
        with pytest.raises(TypeError):
            hvd.grouped_allreduce([big], compression=int8)
    finally:
        hvd.shutdown()
