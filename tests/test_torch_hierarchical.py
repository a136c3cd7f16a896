"""Hierarchical sync of the port (``horovod_tpu_torch.ops.hierarchical``
over ``parallel.mesh.build_host_mesh``'s LOCAL/CROSS sub-groups) on gloo
worlds of 4 (2 x 2) and 8 (2 x 4), against the JAX package's
``hier_allreduce``/``hier_allgather`` and tuple-axis ``allreduce`` on a
``build_host_mesh`` sub-mesh of the 8-device CPU mesh.

- 2 x 2: every sum has two operands, so order cannot differ: f32 and the
  int8 cross hop are bit-equal to JAX's (sum and Average); an f16 tensor
  within one f16 ULP (XLA on the CPU sums a 16-bit all-reduce in f32);
  the bf16 cross hop within one bf16 ULP; the grouped form bit-equal to
  each tensor's own; the allgather in the flat gather's order; the
  distributed optimizer on the pair (allreduce mode and ZeRO-1, int8 +
  error feedback) bit-equal to the JAX package's, updates and residuals;
- 2 x 4: the LOCAL sums have four operands: f32 within rtol 1e-6 of JAX
  (atol 1e-6 of the largest sum), int8 within one int8 quantum of the
  largest sum (a last-bit difference in a piece can move one rounding);
- the toggles and their env names, the half-pair and missing-mesh
  errors (the JAX package's message), and Adasum's refusal.
"""

import concurrent.futures

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops import collective as JCol
from horovod_tpu.ops import hierarchical as JH
from horovod_tpu.optim import _EFState
from horovod_tpu.parallel.mesh import build_host_mesh
from horovod_tpu_torch.ops import hierarchical as TH
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

PAIR = ("cross", "local")
SIZE = 3001                 # not a multiple of L, nor of the int8 block
WORLDS = {4: 2, 8: 4}       # world size -> local size


def _inputs(n):
    r = np.random.RandomState(40 + n)
    return {"v": r.randn(n, SIZE).astype(np.float32),
            "v16": r.randn(n, 517, 3).astype(np.float16),
            "ag": r.randn(n, 3, 5).astype(np.float32),
            "params": {"w": (r.randn(40, 30) * 0.1).astype(np.float32),
                       "b": np.zeros(30, np.float32),
                       "e": r.randn(1500).astype(np.float32)},
            "ct": r.randn(n, 2736).astype(np.float32),
            "grads": [{"w": r.randn(n, 40, 30).astype(np.float32),
                       "b": r.randn(n, 30).astype(np.float32),
                       "e": (r.randn(n, 1500) * 0.01).astype(np.float32)}
                      for _ in range(2)]}


def _mesh_of(n):
    mesh = build_host_mesh(local=WORLDS[n], devices=jax.devices()[:n])
    assert mesh.shape == {"cross": n // WORLDS[n], "local": WORLDS[n]}
    return mesh


def _smap(fn, mesh):
    return jax.jit(JCol._smap(lambda v: fn(v[0]), mesh, (P(PAIR),), P()))


def _jax_side(n, inp):
    mesh = _mesh_of(n)
    jhvd.init(mesh=mesh)
    JH.set_hierarchical(True)
    JH.set_hierarchical_allgather(True)
    try:
        ref = {}
        v, v16 = jnp.asarray(inp["v"]), jnp.asarray(inp["v16"])
        ref["f32_sum"] = _smap(JH.hier_allreduce, mesh)(v)
        ref["f16_sum"] = _smap(JH.hier_allreduce, mesh)(v16)
        ref["int8_sum"] = _smap(lambda x: JCol.allreduce(
            x, JCol.Sum, axis=PAIR, compression=JC.int8), mesh)(v)
        ref["int8_avg"] = _smap(lambda x: JCol.allreduce(
            x, JCol.Average, axis=PAIR, compression=JC.int8), mesh)(v)
        ref["bf16_cross"] = _smap(lambda x: JH.hier_allreduce(
            x, compression=JC.fp16), mesh)(v)
        ref["ag"] = _smap(JH.hier_allgather, mesh)(jnp.asarray(inp["ag"]))
        ref["f32_avg"] = JH.hierarchical_allreduce(
            jax.device_put(v, NamedSharding(mesh, P(PAIR))))
        if n == 4:
            ref["optim"] = {mode: _jax_optim(mesh, inp, mode == "zero1")
                            for mode in ("allreduce", "zero1")}
        return {k: jax.tree_util.tree_map(np.asarray, x)
                for k, x in ref.items()}
    finally:
        JH.set_hierarchical(None)
        JH.set_hierarchical_allgather(None)
        jhvd.shutdown()


def _jax_optim(mesh, inp, shard):
    """``DistributedOptimizer(optax.identity(), int8, error_feedback,
    axis=(cross, local))`` in a bound step over the pair: the per-rank
    residual (allreduce mode) or state (ZeRO-1) travels stacked."""
    tx = jhvd.DistributedOptimizer(optax.identity(), compression=JC.int8,
                                   error_feedback=True, axis=PAIR,
                                   shard_optimizer=shard)
    p = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    n = mesh.devices.size
    if shard:
        state = tx.init(p)

        def step(ss, gg):
            gg = jax.tree_util.tree_map(lambda x: x[0], gg)
            return tx.update(gg, ss, p)
    else:
        state = {k: jnp.zeros((n,) + v.shape) for k, v in p.items()}

        def step(rr, gg):
            gg = jax.tree_util.tree_map(lambda x: x[0], gg)
            rr = jax.tree_util.tree_map(lambda x: x[0], rr)
            u, ss = tx.update(gg, _EFState(optax.EmptyState(), rr), p)
            return u, jax.tree_util.tree_map(lambda x: x[None], ss.residual)

    f = jax.jit(JCol._smap(step, mesh, (P(PAIR), P(PAIR)), (P(), P(PAIR))))
    ups = []
    for g in inp["grads"]:
        u, state = f(state, {k: jnp.asarray(v) for k, v in g.items()})
        ups.append({k: np.asarray(x) for k, x in u.items()})
    res = state.residual if shard else state
    return {"updates": ups,
            "residual": {k: np.asarray(x) for k, x in res.items()}}


@pytest.fixture(scope="module")
def runs():
    inp = {n: _inputs(n) for n in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futs = {n: pool.submit(run_world, W.hier_worker, n, inp[n],
                               WORLDS[n], n == 4, timeout=300)
                for n in WORLDS}
        refs = {n: _jax_side(n, inp[n]) for n in WORLDS}
        port = {n: f.result() for n, f in futs.items()}
    return inp, port, refs


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _ulps16(a, b, dtype):
    """The largest distance in units of the last place of ``dtype``
    (float16) between ``a`` and ``b``."""
    a = np.asarray(a, dtype).astype(np.float64)
    b = np.asarray(b, dtype).astype(np.float64)
    ulp = np.spacing(np.abs(b).astype(dtype)).astype(np.float64)
    return float(np.max(np.abs(a - b) / ulp))


def _bf16_ulps(a, b):
    """Distance in bf16 ULPs of two f32 arrays whose values are bf16."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.abs(b).view(np.uint32) & np.uint32(0x7F800000)
    ulp = ulp.view(np.float32) * np.float32(2.0 ** -7)
    ulp = np.where(ulp == 0, np.float32(2.0 ** -133), ulp)
    return float(np.max(np.abs(a - b) / ulp))


@pytest.mark.parametrize("case", ["f32_sum", "f32_avg", "int8_sum",
                                  "int8_avg"])
def test_2x2_bit_equal_to_jax(runs, case):
    _, port, ref = runs
    for r in range(4):
        assert _bits(port[4][r][case], ref[4][case]), (case, r)


def test_2x2_f16_within_one_ulp_of_jax(runs):
    _, port, ref = runs
    for r in range(4):
        got = port[4][r]["f16_sum"]
        assert got.dtype == np.float16
        assert _ulps16(got, ref[4]["f16_sum"], np.float16) <= 1.0


def test_2x2_bf16_cross_hop_within_one_ulp_of_jax(runs):
    _, port, ref = runs
    for r in range(4):
        assert _bf16_ulps(port[4][r]["bf16_cross"], ref[4]["bf16_cross"]) <= 1.0


def test_2x4_within_tolerance_of_jax(runs):
    """Four-operand LOCAL sums: f32 rtol 1e-6 (atol 1e-6 of the largest
    sum), int8 within one quantum of the largest sum."""
    _, port, ref = runs
    for r in range(8):
        want = ref[8]["f32_sum"]
        np.testing.assert_allclose(port[8][r]["f32_sum"], want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        q = ref[8]["int8_sum"]
        np.testing.assert_allclose(port[8][r]["int8_sum"], q, rtol=0,
                                   atol=np.abs(q).max() / 127)
        assert not np.array_equal(port[8][r]["int8_sum"], want)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_allgather_order_is_the_flat_gathers(runs, n):
    inp, port, ref = runs
    flat = inp[n]["ag"].reshape(-1, 5)
    for r in range(n):
        assert _bits(port[n][r]["ag_hier"], flat)
        assert _bits(port[n][r]["ag_flat"], flat)
    assert _bits(ref[n]["ag"], flat)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_grouped_is_bit_equal_to_each_tensors_own(runs, n):
    """Bit-equal where a LOCAL sum has two operands (2 x 2); at four a
    ring orders the sum by the element's offset in the buffer, which the
    grouping moves: within rtol 1e-6 there (the int8 hop one quantum)."""
    _, port, _ = runs
    for r in range(n):
        for got, own in zip(port[n][r]["grouped"], port[n][r]["grouped_own"]):
            if n == 4:
                assert _bits(got, own)
            else:
                np.testing.assert_allclose(
                    got.astype(np.float32), own.astype(np.float32),
                    rtol=1e-3 if got.dtype == np.float16 else 1e-6,
                    atol=np.abs(own.astype(np.float32)).max() / 127)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_sub_groups_follow_the_row_major_mesh(runs, n):
    _, port, _ = runs
    L = WORLDS[n]
    for r in range(n):
        local, cross, shape = port[n][r]["groups"]
        assert local == tuple(range(r // L * L, r // L * L + L))
        assert cross == tuple(range(r % L, n, L))
        assert shape == {"cross": n // L, "local": L}


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_toggle_off_takes_the_flat_route(runs, n):
    """With the toggle off the pair is the world: f32 equals the flat
    sum, int8 the flat sum of each rank's int8 roundtrip (the JAX
    package's model of a pair's wire)."""
    import torch

    from horovod_tpu_torch.compression import Compression

    inp, port, _ = runs
    v = inp[n]["v"]
    rts = [Compression.int8.decompress(*Compression.int8.compress(
        torch.from_numpy(row))).numpy() for row in v]
    for r in range(n):
        np.testing.assert_allclose(port[n][r]["f32_flat_route"], v.sum(0),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port[n][r]["int8_flat_route"],
                                   np.sum(rts, axis=0), rtol=1e-5, atol=1e-5)
        assert _bits(port[n][r]["int8_flat_route"],
                     port[n][0]["int8_flat_route"])


@pytest.mark.parametrize("mode", ["allreduce", "zero1"])
def test_distributed_optimizer_on_the_pair_bit_equal_to_jax(runs, mode):
    _, port, ref = runs
    want = ref[4]["optim"][mode]
    for r in range(4):
        got = port[4][r]["optim"][mode]
        for s, (gu, wu) in enumerate(zip(got["updates"], want["updates"])):
            for k in wu:
                assert _bits(gu[k], wu[k]), (mode, r, s, k)
        for k, wres in want["residual"].items():
            assert _bits(got["residual"][k], wres[r]), (mode, r, k)


def test_errors(runs):
    _, port, _ = runs
    for r in range(4):
        out = port[4][r]
        assert "has no 'cross' axis; build it with build_host_mesh()" in \
            out["no_mesh"]
        assert "only one of ('cross', 'local')" in out["half"]
        assert "Adasum does not support hierarchical" in out["adasum"]


def test_toggles_and_their_env_names(monkeypatch):
    for var, on, setter in (
            ("HOROVOD_HIERARCHICAL_ALLREDUCE", TH.enabled, TH.set_hierarchical),
            ("HOROVOD_HIERARCHICAL_ALLGATHER", TH.allgather_enabled,
             TH.set_hierarchical_allgather)):
        monkeypatch.delenv(var, raising=False)
        assert not on()
        for spelling in ("1", "true", "YES", "on"):
            monkeypatch.setenv(var, spelling)
            assert on()
        monkeypatch.setenv(var, "0")
        assert not on()
        setter(True)
        assert on()
        monkeypatch.setenv(var, "1")
        setter(False)
        assert not on()
        setter(None)
        assert on()
    # the JAX package reads the same names
    assert JH.enabled() and JH.allgather_enabled()


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_zero3_gather_on_the_pair(runs, n):
    """``fsdp_pack_params(axis=(cross, local))``: the exact two-level
    gather gives the tree back; its backward (reduce-scatters over CROSS
    then LOCAL) is the flat gather's within rtol 1e-6, both the sum over
    ranks of the cotangent's block; the int8 wire's pair route is each
    rank's roundtripped row, gathered (bit for bit)."""
    inp, port, _ = runs
    ct = inp[n]["ct"]
    for r in range(n):
        z = port[n][r]["zero3"]
        assert z["exact"]
        s = z["grad_flat"].shape[0]
        want = ct[:, r * s:(r + 1) * s].sum(0)
        np.testing.assert_allclose(z["grad_flat"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(z["grad_pair"], z["grad_flat"], rtol=1e-6,
                                   atol=1e-6)
        got, exp = z["int8"]
        assert _bits(got, exp)
