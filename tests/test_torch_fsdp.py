"""ZeRO-3 of the port (``DistributedOptimizer(shard_params=True)`` +
``make_train_step(shard_params=True)``) on a gloo world of 2 against the
JAX package's ZeRO-3 on a 2-device CPU mesh, and against the port's own
ZeRO-1.

- the packed rows are bit-equal to ``fsdp_pack_params``'s; pack/unpack
  and the gather give the tree back (mixed f32/bf16);
- the int8 gather is bit-equal to JAX's ``quantized_all_gather``, and its
  backward is the exact f32 reduce-scatter of the cotangent;
- 12 f32 Adam steps of ZeRO-3 are bit-equal to ZeRO-1: losses, every
  parameter, and the BatchNorm running stats (which a second update
  under the backward's recompute would move);
- 3 steps track the JAX package's ZeRO-3 on both wires at the slice
  test's bars (loss rtol 1e-4, params rtol 5e-3 / atol 5e-4: the two
  frameworks order the convolutions' sums differently, and the int8 wire
  can turn a last-bit difference into one quantum);
- the int8-wire trajectory stays in ``tests/test_fsdp.py``'s envelope of
  the fp32 ZeRO-1 one;
- bucketed ZeRO-3 (``bucket_bytes``): the packed rows bit-equal to the
  JAX package's ``fsdp_pack_params(bucket_bytes=)``; one gather a bucket
  in the forward and one in the recompute, one reduce-scatter a bucket
  in the backward; 12 steps bit-equal to bucketed ZeRO-1 at the same
  size (the unbucketed pin, bucketed); a pack of another size refused
  with the JAX package's text;
- ``fsdp_reshard_params`` 8 -> 4 -> 8 bit-equal to the JAX package's
  (mixed f32/bf16, unbucketed and bucketed), and a bucketed ZeRO-3
  checkpoint of 2 ranks moved to 4 and back resumes bit-equal to the run
  that never moved.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.models import resnet as jres
from horovod_tpu.ops.collective import _smap
from horovod_tpu.ops.collective import quantized_all_gather as jax_qgather
from horovod_tpu.training import (
    fsdp_shard_params, make_shardmap_train_step, shard_batch,
)
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

N, STEPS, JAX_STEPS, LR = 2, 12, 3, 1e-3
GATHER_S = 700          # a shard that is not a multiple of the int8 block
#: the narrow ResNet's 524 kB of parameters in 4 buckets; the mixed
#: tree's 129 elements in several
BUCKET_BYTES, MIXED_BUCKET_BYTES = 150_000, 128


def _mixed():
    r = np.random.RandomState(0)
    return {"a": r.randn(17, 5).astype(np.float32),
            "b/c": np.arange(11, dtype=np.float32),
            "b/d": r.randn(33).astype(np.float32)}


def _model():
    return jres.ResNet(stage_sizes=[1, 1, 1, 1],
                       block_cls=jres.BottleneckBlock, num_classes=10,
                       num_filters=8, dtype=jnp.float32)


@pytest.fixture(scope="module")
def runs():
    r = np.random.RandomState(11)
    x = r.randn(4 * N, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, (4 * N,)).astype(np.int64)
    model = _model()
    v = jax.jit(lambda xx: model.init(jax.random.PRNGKey(3), xx, train=True))(
        jnp.asarray(x[:1]))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    g = np.random.RandomState(5)
    inp = dict(mixed=_mixed(), params=params, stats=stats, x=x, y=y,
               gather_shard=g.randn(N, GATHER_S).astype(np.float32),
               ct=g.randn(N, N * GATHER_S).astype(np.float32),
               bucket_bytes=BUCKET_BYTES,
               mixed_bucket_bytes=MIXED_BUCKET_BYTES)
    jhvd.init(devices=jax.devices()[:N])
    try:
        fp = jhvd.fsdp_pack_params(jax.tree_util.tree_map(jnp.asarray, params))
        inp["rows"] = {k: np.asarray(v) for k, v in fp.shards.items()}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port_run = pool.submit(run_world, W.fsdp_worker, N, inp, STEPS, LR)
            ref = _jax_side(model, params, stats, x, y, inp)
            port = port_run.result()
    finally:
        jhvd.shutdown()
    return inp, port, ref


def _jax_side(model, params, stats, x, y, inp):
    ref = {}
    mixed = _mixed()
    tree = {"a": jnp.asarray(mixed["a"]),
            "b": {"c": jnp.asarray(mixed["b/c"]).astype(jnp.bfloat16),
                  "d": jnp.asarray(mixed["b/d"])}}
    ref["pack_rows"] = {k: np.asarray(v.astype(jnp.float32))
                        for k, v in jhvd.fsdp_pack_params(tree).shards.items()}
    ref["bucket_rows"] = {
        k: np.asarray(v.astype(jnp.float32)) for k, v in jhvd.fsdp_pack_params(
            tree, bucket_bytes=MIXED_BUCKET_BYTES).shards.items()}
    mesh, ax = jhvd.mesh(), jhvd.data_axis()
    gather = jax.jit(_smap(lambda v: jax_qgather(v[0], ax)[None], mesh,
                           (P(ax),), P(ax)))
    ref["qgather"] = np.asarray(gather(jnp.asarray(inp["gather_shard"])))
    from horovod_tpu.optim import fused_adam

    xs, ys = shard_batch(jnp.asarray(x)), shard_batch(jnp.asarray(y))
    for wire in ("none", "int8"):
        os.environ["HOROVOD_FSDP_WIRE"] = wire
        try:
            dtx = jhvd.DistributedOptimizer(fused_adam(LR), shard_params=True)
            step = make_shardmap_train_step(model, dtx, shard_params=True,
                                            instrument=False)
            fp = fsdp_shard_params(jhvd.fsdp_pack_params(
                jax.tree_util.tree_map(jnp.asarray, params)))
            s = jax.tree_util.tree_map(jnp.asarray, stats)
            st = dtx.init(fp)
            losses = []
            for _ in range(JAX_STEPS):
                fp, s, st, loss = step(fp, s, st, xs, ys)
                losses.append(float(loss))
        finally:
            del os.environ["HOROVOD_FSDP_WIRE"]
        ref[wire] = {
            "losses": losses,
            "params": flatten_tree(jax.tree_util.tree_map(
                np.asarray, jhvd.fsdp_unpack_params(fp))),
            "stats": flatten_tree(jax.tree_util.tree_map(np.asarray, s))}
    return ref


def test_pack_rows_bit_equal_to_jax(runs):
    _, port, ref = runs
    for r in range(N):
        got = port[r]["pack_rows"]
        assert sorted(got) == sorted(ref["pack_rows"]) == ["bfloat16", "float32"]
        for k, rows in ref["pack_rows"].items():
            assert np.array_equal(got[k].view(np.uint32),
                                  rows[r].view(np.uint32)), k


def test_pack_unpack_roundtrip_and_gather_give_the_tree(runs):
    _, port, _ = runs
    for r in range(N):
        assert port[r]["roundtrip"] and port[r]["gather"]


def test_int8_gather_bit_equal_to_jax(runs):
    inp, port, ref = runs
    exact = inp["gather_shard"].reshape(-1)
    for r in range(N):
        got = port[r]["qgather"]
        assert np.array_equal(got.view(np.uint32), ref["qgather"][r].view(np.uint32))
        assert not np.array_equal(got, exact)       # the int8 wire was taken
        np.testing.assert_allclose(got, exact, atol=np.abs(exact).max() / 127)


def test_int8_gather_backward_is_the_exact_reduce_scatter(runs):
    inp, port, _ = runs
    ct = inp["ct"]
    for r in range(N):
        want = sum(ct[j, r * GATHER_S:(r + 1) * GATHER_S] for j in range(N))
        assert np.array_equal(port[r]["qgather_grad"].view(np.uint32),
                              want.astype(np.float32).view(np.uint32))


def test_zero3_bit_equal_to_zero1_over_12_steps(runs):
    _, port, _ = runs
    for r in range(N):
        z1, z3 = port[r]["zero1"], port[r]["zero3_none"]
        assert z1["losses"] == z3["losses"]
        for k, v in z1["params"][STEPS].items():
            assert np.array_equal(v.view(np.uint32),
                                  z3["params"][STEPS][k].view(np.uint32)), k
        for k, v in z1["stats"].items():
            assert np.array_equal(v.view(np.uint32),
                                  z3["stats"][k].view(np.uint32)), k
    assert port[0]["zero3_none"]["losses"] == port[1]["zero3_none"]["losses"]
    assert port[0]["zero1"]["losses"][-1] < port[0]["zero1"]["losses"][0]


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_zero3_tracks_jax(runs, wire):
    _, port, ref = runs
    want = ref[wire]
    for r in range(N):
        got = port[r][f"zero3_{wire}"]
        np.testing.assert_allclose(got["losses"][:JAX_STEPS], want["losses"],
                                   rtol=1e-4)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][JAX_STEPS][k], v,
                                       rtol=5e-3, atol=5e-4, err_msg=k)
            assert np.array_equal(got["params"][JAX_STEPS][k],
                                  port[0][f"zero3_{wire}"]["params"][JAX_STEPS][k])


def test_int8_wire_trajectory_within_envelope_of_zero1(runs):
    """tests/test_fsdp.py's pin: the int8 gather perturbs forward values
    only, so the trajectory's deviation is bounded by that rounding:
    every parameter within 0.1 of the fp32 ZeRO-1 run after 12 steps, and
    the loss gap no larger than the first step's, which is the rounded
    weights' alone (0.013 on this narrow net, where test_fsdp.py's MLP
    shows none), plus that test's 5e-3."""
    _, port, _ = runs
    z1, z8 = port[0]["zero1"], port[0]["zero3_int8"]
    first = abs(z8["losses"][0] - z1["losses"][0])
    assert 0 < first and abs(z8["losses"][-1] - z1["losses"][-1]) <= first + 5e-3
    for k, v in z1["params"][STEPS].items():
        assert np.abs(z8["params"][STEPS][k] - v).max() < 0.1, k


def test_zero3_init_state_equals_zero1(runs):
    _, port, _ = runs
    assert all(port[r]["init_equal"] for r in range(N))


def test_no_full_size_parameter_storage_between_steps(runs):
    _, port, _ = runs
    for r in range(N):
        st = port[r]["storage"]
        assert st["model_params"] == 0
        assert st["shards"] == st["row"]


def test_fsdp_wire_env_rejects_unknown(runs):
    _, port, _ = runs
    assert all("HOROVOD_FSDP_WIRE" in port[r]["fp8"] for r in range(N))


REJECT = {
    "adasum": (dict(op=thvd.Adasum), "Average/Sum"),
    "min": (dict(op=thvd.Min), "Average/Sum"),
    "fp16": (dict(compression=thvd.Compression.fp16), "compress"),
    "int8": (dict(compression=thvd.Compression.int8), "compress"),
    "error_feedback": (dict(compression=thvd.Compression.int8,
                            error_feedback=True), "compress"),
    "shard_optimizer": (dict(shard_optimizer=True), "shard_optimizer"),
}


@pytest.mark.parametrize("case", list(REJECT))
def test_shard_params_rejects(case):
    kw, match = REJECT[case]
    with pytest.raises(ValueError, match=match):
        thvd.DistributedOptimizer(thvd.adam(1e-3), shard_params=True, **kw)


def test_shard_params_rejects_error_feedback_alone():
    with pytest.raises(ValueError, match="error_feedback"):
        thvd.DistributedOptimizer(thvd.adam(1e-3), shard_params=True,
                                  error_feedback=True)


def test_shard_params_init_and_update_take_fsdp_params():
    import torch

    tx = thvd.DistributedOptimizer(thvd.adam(1e-3), shard_params=True)
    with pytest.raises(TypeError, match="FsdpParams"):
        tx.init({"w": torch.zeros(4)})
    st = {"shard": {"rank": 0, "size": 1}, "inner": {}}
    with pytest.raises(TypeError, match="FsdpParams"):
        tx.update({"w": torch.zeros(4)}, st)


def test_train_step_needs_matching_shard_params():
    import torch

    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    m = ResNet([1], BottleneckBlock, num_filters=4, num_classes=3,
               dtype=torch.float32)
    z3 = thvd.DistributedOptimizer(thvd.adam(1e-3), shard_params=True)
    with pytest.raises(ValueError, match="shard_params"):
        thvd.make_train_step(m, z3)
    with pytest.raises(ValueError, match="shard_params"):
        thvd.make_train_step(m, thvd.DistributedOptimizer(thvd.adam(1e-3)),
                             shard_params=True)


def test_zero3_step_reuses_the_packed_group_plan(monkeypatch):
    """The group plan is built once, with the shards' meta: a step (two
    gathers, the recompute's included) builds none."""
    import torch

    from horovod_tpu_torch import optim as topt
    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FSDP_WIRE", "int8")
    thvd.init(device="cpu")
    try:
        m = ResNet([1], BottleneckBlock, num_filters=8, num_classes=3,
                   dtype=torch.float32, seed=1)
        tx = thvd.DistributedOptimizer(thvd.adam(1e-3), shard_params=True)
        step = thvd.make_train_step(m, tx, shard_params=True)
        st = tx.init(step.params)
        assert step.params.meta.groups["float32"].L == sum(
            int(np.prod(s)) for s in step.params.meta.shapes)
        built = []
        real = topt._zero_groups
        monkeypatch.setattr(topt, "_zero_groups",
                            lambda *a: built.append(1) or real(*a))
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, 32, 32, 3, generator=gen)
        y = torch.tensor([0, 2])
        st, loss = step(st, x, y)
        assert np.isfinite(float(loss))
        thvd.fsdp_unpack_params(step.params)
        assert built == []
    finally:
        thvd.shutdown()


def test_bucketed_pack_rows_bit_equal_to_jax(runs):
    _, port, ref = runs
    assert len(ref["bucket_rows"]) > 2
    for r in range(N):
        got = port[r]["bucket_rows"]
        assert sorted(got) == sorted(ref["bucket_rows"])
        for k, rows in ref["bucket_rows"].items():
            assert np.array_equal(got[k].view(np.uint32),
                                  rows[r].view(np.uint32)), k
        assert port[r]["bucket_gather"]


def test_bucketed_zero3_gathers_and_reduce_scatters_once_a_bucket(runs):
    """K buckets: K gathers in the forward and K in the recompute, K
    reduce-scatters in the backward (the loss allreduce is no
    reduce-scatter)."""
    _, port, _ = runs
    for r in range(N):
        k = len(port[r]["zero3_bucketed_groups"])
        assert k == 4 and all("#" in g for g in port[r]["zero3_bucketed_groups"])
        calls = port[r]["zero3_bucketed_calls"]
        assert calls.get("gather_shards") == 2 * k
        assert calls.get("reduce_scatter_tensor", 0) + calls.get(
            "reduce_scatter_single", 0) == k


def test_bucketed_zero3_bit_equal_to_bucketed_zero1_over_12_steps(runs):
    _, port, _ = runs
    for r in range(N):
        z1, z3 = port[r]["zero1_bucketed"], port[r]["zero3_bucketed"]
        assert z1["losses"] == z3["losses"]
        for k, v in z1["params"][STEPS].items():
            assert np.array_equal(v.view(np.uint32),
                                  z3["params"][STEPS][k].view(np.uint32)), k
        for k, v in z1["stats"].items():
            assert np.array_equal(v.view(np.uint32),
                                  z3["stats"][k].view(np.uint32)), k
    z = port[0]["zero3_bucketed"]["losses"]
    assert z == port[1]["zero3_bucketed"]["losses"] and z[-1] < z[0]


def test_bucketed_zero3_refuses_a_pack_of_another_size(runs):
    _, port, _ = runs
    for r in range(N):
        msg = port[r]["bucket_mismatch"]
        assert msg.startswith("bucket_bytes mismatch: params were packed with "
                              f"bucket_bytes={MIXED_BUCKET_BYTES}")
        assert "the pack defines the exchange granularity" in msg


@pytest.mark.parametrize("bucket_bytes", [None, 64])
def test_fsdp_reshard_params_8_4_8_bit_equal_to_jax(bucket_bytes):
    """The consolidated rows of a pack at 8 re-packed for 4 and back:
    each step bit-equal to the JAX package's ``fsdp_reshard_params`` of
    the same ``FsdpParams``, and 8 -> 4 -> 8 gives the rows back."""
    from horovod_tpu_torch.optim import FSDP_ROWS

    mixed = _mixed()
    tree = {"a": jnp.asarray(mixed["a"]),
            "b": {"c": jnp.asarray(mixed["b/c"]).astype(jnp.bfloat16),
                  "d": jnp.asarray(mixed["b/d"])}}
    jhvd.init(devices=jax.devices()[:8])
    try:
        fp8 = jhvd.fsdp_pack_params(tree, bucket_bytes=bucket_bytes)
        fp4 = jhvd.fsdp_reshard_params(fp8, to_size=4)
        fp8b = jhvd.fsdp_reshard_params(fp4, to_size=8)
        rows = {n: {k: np.asarray(v) for k, v in fp.shards.items()}
                for n, fp in ((8, fp8), (4, fp4))}
        back = {k: np.asarray(v) for k, v in fp8b.shards.items()}
    finally:
        jhvd.shutdown()
    saved = {FSDP_ROWS: rows[8], "keys": ["a", "b/c", "b/d"],
             "shapes": [[17, 5], [11], [33]],
             "dtypes": ["float32", "bfloat16", "float32"]}
    if bucket_bytes:
        saved["bucket_bytes"] = bucket_bytes
    got4 = thvd.fsdp_reshard_params(saved, to_size=4)
    got8 = thvd.fsdp_reshard_params(got4, to_size=8)
    for k in rows[4]:
        assert got4[FSDP_ROWS][k].shape == rows[4][k].shape
        assert np.array_equal(got4[FSDP_ROWS][k].view(np.uint8),
                              rows[4][k].view(np.uint8)), k
        assert np.array_equal(got8[FSDP_ROWS][k].view(np.uint8),
                              back[k].view(np.uint8)), k
        assert np.array_equal(back[k].view(np.uint8),
                              rows[8][k].view(np.uint8)), k
    assert thvd.fsdp_reshard_params(saved, to_size=8) is saved


def test_bucketed_zero3_checkpoint_moves_to_4_ranks_and_back(tmp_path):
    """Bucketed ZeRO-3, 2 ranks: 2 steps, a checkpoint, the third step.
    The checkpoint restored at 4 ranks (parameters re-packed by
    ``fsdp_reshard_params``, the state by ``reshard_optimizer_state``)
    gives the same tree and is saved again; restored at 2, the third
    step is bit-equal to the run that never moved."""
    r = np.random.RandomState(23)
    x = r.randn(4 * N, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, (4 * N,)).astype(np.int64)
    model = _model()
    v = jax.jit(lambda xx: model.init(jax.random.PRNGKey(7), xx, train=True))(
        jnp.asarray(x[:1]))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    args = (str(tmp_path), params, stats, x, y, BUCKET_BYTES, LR)
    ran = run_world(W.zero3_ckpt_worker, N, *args, "run", timeout=240)
    moved = run_world(W.zero3_ckpt_worker, 4, *args, "move", timeout=240)
    back = run_world(W.zero3_ckpt_worker, N, *args, "resume", timeout=240)
    assert moved[0]["size"] == 4 and len(moved[0]["groups"]) == 4
    for r_ in range(N):
        assert back[r_]["losses"] == ran[r_]["losses"][2:]
        assert back[r_]["count"] == ran[r_]["count"] == 3
        for k, want in ran[r_]["params"].items():
            assert np.array_equal(back[r_]["params"][k].view(np.uint32),
                                  want.view(np.uint32)), k
    for k, w in moved[0]["params"].items():
        assert all(np.array_equal(w, m["params"][k]) for m in moved)
