"""horovod_tpu_torch.ops.collective on a gloo world of 2 against the JAX
package's bound-axis collectives on a 2-device CPU mesh, same per-rank
inputs: the int8 reduce-scatter and allreduce bit for bit, the plain
collectives exactly (reducescatter's zero-padding quirk included).
``broadcast_object`` and ``broadcast_optimizer_state`` on worlds of 2 and
4: root's Python values arrive exact, containers keep their types, as
the JAX package's ``broadcast_optimizer_state`` returns them."""

import concurrent.futures

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops import collective as JCol
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N = 2


def _inputs():
    r = np.random.RandomState(5)
    x = r.randn(N, 6, 5).astype(np.float32)
    x[1, 0, 0] = x[0, 0, 0]  # a tie for min/max
    return {
        "flat": r.randn(N, 1230).astype(np.float32),       # Lp % N == 0
        "v": (r.randn(N, 37, 41) * 3).astype(np.float32),   # 1517: pads
        "small": r.randn(N, 100).astype(np.float32),        # below the floor
        "x": x,
        "ints": r.randint(-50, 50, (N, 7)).astype(np.int64),
        "rows": r.randn(N, 5, 3).astype(np.float32),        # 5 % 2 != 0
        "a2a": r.randn(N, 4, 3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def results():
    inp = _inputs()
    port = run_world(W.collectives_worker, N, inp)
    jhvd.init(devices=jax.devices()[:N])
    try:
        mesh, ax = jhvd.mesh(), jhvd.data_axis()

        def per_rank(fn, x):
            body = lambda v: fn(v[0])[None]  # noqa: E731
            out = jax.jit(JCol._smap(body, mesh, (P(ax),), P(ax)))(
                jnp.asarray(x))
            return np.asarray(out.astype(jnp.float32)
                              if out.dtype == jnp.bfloat16 else out)

        ref = {
            "psum_scatter": per_rank(
                lambda v: JCol.quantized_psum_scatter(v, ax), inp["flat"]),
            "q_allreduce_avg": per_rank(
                lambda v: JCol.allreduce(v, JCol.Average, axis=ax,
                                         compression=JC.int8), inp["v"]),
            "q_allreduce_sum": per_rank(
                lambda v: JCol.allreduce(v, JCol.Sum, axis=ax,
                                         compression=JC.int8), inp["v"]),
            "q_small_passthrough": per_rank(
                lambda v: JCol.allreduce(v, JCol.Average, axis=ax,
                                         compression=JC.int8), inp["small"]),
            "allreduce_sum": per_rank(
                lambda v: JCol.allreduce(v, JCol.Sum, axis=ax), inp["x"]),
            "allreduce_avg": per_rank(
                lambda v: JCol.allreduce(v, JCol.Average, axis=ax), inp["x"]),
            "allreduce_fp16": per_rank(
                lambda v: JCol.allreduce(v, JCol.Average, axis=ax,
                                         compression=JC.fp16), inp["x"]),
            "allgather": per_rank(
                lambda v: JCol.allgather(v, axis=ax), inp["x"]),
            "broadcast": per_rank(
                lambda v: JCol.broadcast(v, 1, axis=ax), inp["x"]),
            "reducescatter_sum": per_rank(
                lambda v: JCol.reducescatter(v, JCol.Sum, axis=ax),
                inp["rows"]),
            "reducescatter_avg": per_rank(
                lambda v: JCol.reducescatter(v, JCol.Average, axis=ax),
                inp["rows"]),
            "alltoall": per_rank(
                lambda v: JCol.alltoall(v, axis=ax), inp["a2a"]),
        }
    finally:
        jhvd.shutdown()
    return inp, port, ref


@pytest.mark.parametrize("name", [
    "psum_scatter", "q_allreduce_avg", "q_allreduce_sum",
    "q_small_passthrough", "allreduce_sum", "allreduce_avg",
    "allreduce_fp16", "allgather", "broadcast", "reducescatter_sum",
    "reducescatter_avg", "alltoall",
])
def test_matches_jax_bitwise(results, name):
    _, port, ref = results
    for r in range(N):
        got, want = np.asarray(port[r][name]), ref[name][r]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
            name, r, np.abs(got - want).max())


def test_int8_allreduce_is_lossy_but_close(results):
    """The int8 wire really quantized (not a disguised fp32 allreduce),
    within a quantum of the exact average."""
    inp, port, _ = results
    exact = inp["v"].mean(axis=0)
    got = port[0]["q_allreduce_avg"]
    assert not np.array_equal(got, exact)
    step = np.abs(inp["v"]).max() / 127
    assert np.abs(got - exact).max() <= 2 * step


def test_min_max_and_int_average(results):
    inp, port, _ = results
    for r in range(N):
        assert np.array_equal(port[r]["allreduce_min"], inp["x"].min(axis=0))
        assert np.array_equal(port[r]["allreduce_max"], inp["x"].max(axis=0))
        # the reference's integer Average: divide in float, truncate back
        want = (inp["ints"].sum(axis=0).astype(np.float32) / N).astype(np.int64)
        assert np.array_equal(port[r]["allreduce_int_avg"], want)


def test_reducescatter_pads_rows(results):
    """5 rows over 2 ranks: rank 1's shard ends in a zero pad row."""
    _, port, _ = results
    assert port[0]["reducescatter_sum"].shape == (3, 3)
    assert np.all(port[1]["reducescatter_sum"][-1] == 0)


def test_broadcast_parameters_and_optimizer_state(results):
    """Root 1's parameters and (non-ZeRO) optimizer state reach every
    rank; a ZeRO-1 state is left alone (each rank owns its shard)."""
    inp, port, _ = results
    for r in range(N):
        assert np.array_equal(port[r]["bcast_params"], inp["x"][1])
        assert np.array_equal(port[r]["bcast_state_mu"], inp["x"][1])
        assert int(port[r]["bcast_state_count"]) == 4


# --------------------------------------------------------------------------
# broadcast_object and broadcast_optimizer_state


@pytest.fixture(scope="module")
def bcast():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = {n: pool.submit(run_world, W.broadcast_worker, n)
                for n in (2, 4)}
        jhvd.init(devices=jax.devices()[:N])
        try:
            state = W._tree_out(W.bcast_state(0))
            ref = jhvd.broadcast_optimizer_state(jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
                state))
        finally:
            jhvd.shutdown()
        port = {n: f.result() for n, f in port.items()}
    return port, state, ref


def _assert_same_tree(got, want):
    """Equal leaves of equal types in containers of equal types; arrays
    equal in value and dtype."""
    if isinstance(want, (dict, list, tuple)):
        assert type(got) is type(want), (type(got), type(want))
        assert len(got) == len(want)
        if isinstance(want, dict):
            assert list(got) == list(want)
            got, want = got.values(), want.values()
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif isinstance(want, (np.ndarray, jax.Array)):
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert np.array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, (got, want)


def test_broadcast_optimizer_state_is_exact(bcast):
    """Every rank ends with rank 0's state: 0.1 stays 0.1 (not f32's
    0.10000000149011612), strings, ints, bools and None arrive, tensors
    inside a list, a tuple and a named tuple are broadcast."""
    port, state, _ = bcast
    assert state["lr"] == 0.1
    for r in range(2):
        _assert_same_tree(port[2][r]["state"], state)


def test_broadcast_optimizer_state_matches_jax(bcast):
    """The JAX package's broadcast_optimizer_state of rank 0's state (on a
    2-device mesh: arrays replicated, scalars through broadcast_object)
    is what every rank of the port returns."""
    port, _, ref = bcast
    for r in range(2):
        got = port[2][r]["state"]
        assert set(got) == set(ref)     # JAX rebuilds a dict in key order
        _assert_same_tree(got, {k: ref[k] for k in got})


def test_broadcast_optimizer_state_leaves_zero1(bcast):
    """A ZeRO-1 state comes back as the same object: each rank's shard is
    its own."""
    port, _, _ = bcast
    assert all(out["zero1_untouched"] for out in port[2])


@pytest.mark.parametrize("n", [2, 4])
def test_broadcast_object(bcast, n):
    port, _, _ = bcast
    want = {"x": [1.5 + (n - 1), f"s{n - 1}", None], "y": (n - 1, 0.1 * (n - 1))}
    for r in range(n):
        _assert_same_tree(port[n][r]["object"], want)
