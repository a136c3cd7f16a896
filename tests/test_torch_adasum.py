"""Adasum of the port on gloo worlds of 2 and 4 against the JAX package's
Adasum on 2- and 4-device CPU meshes (the eager path over stacked
per-rank values), same inputs.

- ``adasum_allreduce`` and ``grouped_adasum_allreduce`` within rtol 2e-5
  / atol 2e-6 of the JAX functions, the bar ``tests/test_pallas.py``
  holds the Pallas combine to (the sums run in another order), f32
  against both JAX paths (``HOROVOD_PALLAS=0`` and ``=1``); f16 against
  the Pallas path only, whose sums are f32 as the port's are (the
  discrete ``jnp.vdot`` sums f16 in f16). Every rank's output is
  bit-identical.
  An f16 output may sit one f16 ULP off where the f32 value lies on a
  rounding boundary of f16 and the two sum orders put it on either side:
  such elements are counted and held to one ULP.
- ``DistributedOptimizer(op=Adasum)``: 3 steps of the narrow ResNet with
  no compression (the grouped butterfly) and with ``Compression.fp16``
  (per leaf, in the 16-bit wire type), at the slice test's bars (save at
  most 0.1 % of the elements, held within Adam's 2 lr a step), against
  the JAX step that reduces with ``reduce_op=Adasum`` itself (its
  allreduce-mode step takes a plain optimizer; the per-leaf combine is
  the grouped one's function, ``tests/test_ops.py`` pins that), under
  ``HOROVOD_PALLAS=1`` for fp16.
- the compressed route packs the wire tensors into one buffer of their
  16-bit type: every leaf bit-equal to its own ``allreduce(g, Adasum,
  compression=...)`` (bf16 and f16 wires; sizes 1 to 3·8192+5, an
  all-zero leaf, a NaN), in log2(N) exchanges and log2(N) combine calls
  an update.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.ops import adasum as jada
from horovod_tpu.training import make_shardmap_train_step, shard_batch
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.testing import run_world

import test_torch_fsdp as F
import test_torch_workers as W

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-5, 2e-6
STEPS, LR = 3, 1e-3
GROUP_SHAPES = [(40, 30), (7,), (1,), (3, 5, 2)]
#: the compressed route's tree: sizes across the combine's 16-byte groups
#: and 8192-element chunks, a leaf zero on every rank, one zero on rank 0
#: only, and one with a NaN on rank 1
PACKED_SHAPES = {"a": (1,), "b": (7,), "c": (64,), "d": (3 * 8192 + 5,),
                 "e_zero": (5, 3), "f_nan": (9,), "g": (40, 30),
                 "h_zero_rank0": (33,)}


def _inputs(n, seed):
    r = np.random.RandomState(seed)
    inp = {"pair": {"f32": r.randn(n, 1000).astype(np.float32)},
           "group": [r.randn(n, *s).astype(np.float32) for s in GROUP_SHAPES]}
    packed = inp["packed"] = {k: r.randn(n, *s).astype(np.float32)
                              for k, s in PACKED_SHAPES.items()}
    packed["e_zero"][:] = 0.0
    packed["f_nan"][1, 4] = np.nan
    packed["h_zero_rank0"][0] = 0.0
    return inp


@pytest.fixture(scope="module")
def runs():
    x = np.random.RandomState(11).randn(8, 32, 32, 3).astype(np.float32)
    y = np.random.RandomState(12).randint(0, 10, (8,)).astype(np.int64)
    model = F._model()
    v = jax.jit(lambda xx: model.init(jax.random.PRNGKey(3), xx, train=True))(
        jnp.asarray(x[:1]))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    inp = {2: _inputs(2, 1), 4: _inputs(4, 2)}
    inp[2]["train"] = dict(params=params, stats=stats, x=x, y=y, lr=LR,
                           steps=STEPS)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        port = {n: pool.submit(run_world, W.adasum_worker, n, inp[n])
                for n in (2, 4)}
        world3 = pool.submit(run_world, W.adasum_world_error_worker, 3)
        ref = {n: _jax_collectives(n, inp[n]) for n in (2, 4)}
        ref["train"] = _jax_train(model, params, stats, x, y)
        port = {n: f.result() for n, f in port.items()}
        port[3] = world3.result()
    return inp, port, ref


def _stacked(x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jhvd.mesh(),
                                                        P(jhvd.data_axis())))


def _jax_collectives(n, inp):
    out = {}
    jhvd.init(devices=jax.devices()[:n])
    try:
        for knob in ("0", "1"):
            os.environ["HOROVOD_PALLAS"] = knob
            try:
                out[knob] = {
                    "f32": np.asarray(jada.adasum_allreduce(
                        _stacked(inp["pair"]["f32"]))),
                    "group": [np.asarray(t) for t in jada.grouped_adasum_allreduce(
                        [_stacked(g) for g in inp["group"]])]}
                if knob == "1":
                    out[knob]["f16"] = np.asarray(jada.adasum_allreduce(
                        _stacked(inp["pair"]["f32"].astype(np.float16))))
            finally:
                del os.environ["HOROVOD_PALLAS"]
    finally:
        jhvd.shutdown()
    return out


def _jax_train(model, params, stats, x, y):
    from horovod_tpu.optim import fused_adam

    out = {}
    jhvd.init(devices=jax.devices()[:2])
    try:
        xs, ys = shard_batch(jnp.asarray(x)), shard_batch(jnp.asarray(y))
        for name, comp, knob in (("grouped", None, None),
                                 ("fp16", JC.fp16, "1")):
            if knob:
                os.environ["HOROVOD_PALLAS"] = knob
            try:
                tx = fused_adam(LR)
                step = make_shardmap_train_step(model, tx, reduce_op=jhvd.Adasum,
                                                compression=comp,
                                                instrument=False)
                p = jax.tree_util.tree_map(jnp.asarray, params)
                s = jax.tree_util.tree_map(jnp.asarray, stats)
                st = tx.init(p)
                losses = []
                for _ in range(STEPS):
                    p, s, st, loss = step(p, s, st, xs, ys)
                    losses.append(float(loss))
            finally:
                os.environ.pop("HOROVOD_PALLAS", None)
            out[name] = {"losses": losses,
                         "params": flatten_tree(jax.tree_util.tree_map(
                             np.asarray, p))}
    finally:
        jhvd.shutdown()
    return out


def _same_on_every_rank(outs):
    a0 = outs[0]
    for a in outs[1:]:
        assert a.dtype == a0.dtype and np.array_equal(a.view(np.uint8),
                                                      a0.view(np.uint8))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("knob", ["0", "1"], ids=["discrete", "pallas"])
def test_adasum_allreduce_matches_jax(runs, n, knob):
    _, port, ref = runs
    outs = [port[n][r]["pair"]["f32"] for r in range(n)]
    _same_on_every_rank(outs)
    np.testing.assert_allclose(outs[0], ref[n][knob]["f32"], rtol=RTOL,
                               atol=ATOL)
    _same_on_every_rank([port[n][r]["public"] for r in range(n)])
    assert np.array_equal(port[n][0]["public"], outs[0])


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_allreduce_f16_matches_the_pallas_path(runs, n):
    _, port, ref = runs
    outs = [port[n][r]["pair"]["f16"] for r in range(n)]
    _same_on_every_rank(outs)
    want = ref[n]["1"]["f16"]
    got = outs[0].astype(np.float16)
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got.astype(np.float32) - want)[off] <= ulp[off]).all()
    assert off.mean() < 0.01, off.mean()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("knob", ["0", "1"], ids=["discrete", "pallas"])
def test_grouped_adasum_matches_jax(runs, n, knob):
    _, port, ref = runs
    for i, shape in enumerate(GROUP_SHAPES):
        outs = [port[n][r]["group"][i] for r in range(n)]
        _same_on_every_rank(outs)
        assert outs[0].shape == shape
        np.testing.assert_allclose(outs[0], ref[n][knob]["group"][i],
                                   rtol=RTOL, atol=ATOL)


def test_world_of_three_raises(runs):
    _, port, _ = runs
    assert all("power-of-2" in msg for msg in port[3])


@pytest.mark.parametrize("name", ["grouped", "fp16"])
def test_distributed_optimizer_adasum_tracks_jax(runs, name):
    _, port, ref = runs
    want = ref["train"][name]
    for r in range(2):
        got = port[2][r][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        off = total = 0
        for k, v in want["params"].items():
            g = got["params"][STEPS][k]
            bad = ~np.isclose(g, v, rtol=5e-3, atol=5e-4)
            # the combine's sums run in another order, so a combined
            # gradient may differ in its last bit (or, in 16 bits, by one
            # ULP, see the f16 test): where the moments nearly cancel,
            # Adam turns that into an update up to 2 lr apart (it moves an
            # element at most ~lr a step). Such elements must be rare.
            assert (np.abs(g - v)[bad] <= 2 * LR * STEPS).all(), k
            off, total = off + bad.sum(), total + bad.size
            assert np.array_equal(g, port[2][0][name]["params"][STEPS][k])
        assert off <= 1e-3 * total, (off, total)
    assert port[2][0][name]["losses"][-1] < port[2][0][name]["losses"][0]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("wire", ["bf16", "f16"])
def test_packed_compressed_adasum_is_bit_equal_to_per_leaf(runs, n, wire):
    """DistributedOptimizer(op=Adasum, compression=...) on the packed
    buffer gives every leaf the bits of its own allreduce(g, Adasum,
    compression=...), on every rank; the NaN stays in its leaf."""
    _, port, _ = runs
    for r in range(n):
        got = port[n][r]["packed"][wire]
        for k, shape in PACKED_SHAPES.items():
            p, own = got["packed"][k], got["own"][k]
            assert p.shape == own.shape == shape, k
            assert p.dtype == own.dtype == np.float32, k
            assert np.array_equal(p.view(np.uint32), own.view(np.uint32)), (k, r)
            _same_on_every_rank([port[n][q]["packed"][wire]["packed"][k]
                                 for q in range(n)])
            assert np.isnan(p).all() == (k == "f_nan"), k
            if k != "f_nan":
                assert np.isfinite(p).all(), k
        assert not got["packed"]["e_zero"].any()


@pytest.mark.parametrize("n", [2, 4])
def test_packed_compressed_adasum_calls_per_step(runs, n):
    """log2(N) exchanges and log2(N) combine calls an update, whatever the
    number of leaves; no per-leaf combine."""
    _, port, _ = runs
    levels = n.bit_length() - 1
    for wire in ("bf16", "f16"):
        assert port[n][0]["packed"][wire]["counts"] == {
            "_exchange": levels, "adasum_pair_combine_packed": levels}, wire


@pytest.mark.parametrize("itemsize", [2, 4])
def test_leaf_table_aligns_every_leaf(itemsize):
    """Every leaf starts on 16 bytes, its pad is a segment of its own
    (shorter than 16 bytes) and zero in the packed buffer."""
    from horovod_tpu_torch.ops import adasum as A

    sizes = (1, 7, 64, 0, 3 * 8192 + 5, 8)
    starts, offsets = A._leaf_table(sizes, itemsize)
    step = 16 // itemsize
    assert len(offsets) == 2 * len(sizes) + 1 and offsets[0] == 0
    for i, (size, lo) in enumerate(zip(sizes, starts)):
        assert lo % step == 0 and offsets[2 * i] == lo
        assert offsets[2 * i + 1] == lo + size
        assert 0 <= offsets[2 * i + 2] - lo - size < step
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    leaves = [torch.full((s,), 1.0 + i, dtype=dtype) for i, s in enumerate(sizes)]
    flat = A._pack(leaves, offsets)
    assert flat.dtype == dtype and flat.numel() == offsets[-1]
    for i, (leaf, lo) in enumerate(zip(leaves, starts)):
        assert torch.equal(flat[lo:lo + leaf.numel()], leaf)
        assert not flat[offsets[2 * i + 1]:offsets[2 * i + 2]].any()


def test_num_rank_is_power_2():
    assert [n for n in range(20) if thvd.num_rank_is_power_2(n)] == [1, 2, 4, 8, 16]


ADASUM_REJECT = {
    "error_feedback": dict(compression=thvd.Compression.fp16,
                           error_feedback=True),
    "quantized": dict(compression=thvd.Compression.int8),
    "shard_optimizer": dict(shard_optimizer=True),
    "shard_params": dict(shard_params=True),
}


@pytest.mark.parametrize("case", list(ADASUM_REJECT))
def test_distributed_optimizer_adasum_rejects(case):
    with pytest.raises(ValueError, match="Adasum"):
        thvd.DistributedOptimizer(thvd.adam(1e-3), op=thvd.Adasum,
                                  **ADASUM_REJECT[case])


def test_quantized_allreduce_rejects_adasum_and_small_leaves_pass(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    thvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="Adasum"):
            thvd.allreduce(torch.ones(4096), thvd.Adasum,
                           compression=thvd.Compression.int8)
        small = torch.arange(8.0)     # below MIN_QUANT_ELEMS: not quantized
        assert torch.equal(thvd.allreduce(small, thvd.Adasum,
                                          compression=thvd.Compression.int8),
                           small)
        with pytest.raises(ValueError, match="Average/Sum"):
            thvd.reducescatter(small, thvd.Adasum)
    finally:
        thvd.shutdown()
