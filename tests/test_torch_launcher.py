"""The slice as a whole on the CPU: ``python -m horovod_tpu_torch.run -np
2`` (gloo) runs phase 22's worker (``tools/launcher_phase.py``) on a
narrow ResNet for 2 epochs — an ``ArrayShardStore`` read through
``ResumableLoader``, ``make_loader_step`` under ``resilience.run`` with a
checkpoint each epoch, ZeRO-1 + int8 + EF around
``inject_hyperparams(fused_adam)``, the broadcast, metric-average,
warmup, schedule and metrics callbacks. It is held two ways:

- bit for bit against the same worker under ``testing.run_world`` (the
  launcher changes no arithmetic), with every rank's ids the sample
  index's and every rank's parameters identical;
- against the JAX package's run of the same model on a 2-device CPU mesh
  (``make_shardmap_train_step``, ZeRO-1 + int8 + EF around
  ``optax.inject_hyperparams(optax.adam)`` with the same warmup and
  decay as an optax schedule), fed the same global batches (device ``r``
  the rows the port's rank ``r`` drew): the losses within rtol 1e-4 and
  the running stats within rtol 5e-3 / atol 5e-4, as in the earlier
  ZeRO-1 parity test (``tests/test_torch_slice.py``), and the parameters'
  update from their shared start within 3 % of the JAX update in its own
  norm (0.8 % here). Element by element the update is no bar: over 16
  steps Adam turns a last-bit gradient difference (XLA and PyTorch sum a
  convolution's gradient in other orders) into up to a whole learning
  rate of update where a gradient is near 0. The bar fails the same
  parameters with their update scaled as a wrong learning rate would
  scale it."""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.models import resnet as jres
from horovod_tpu.training import make_shardmap_train_step, shard_batch
from horovod_tpu_torch.data import ArrayShardStore, GlobalSampleIndex
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.testing import run_world

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import launcher_phase as LP  # noqa: E402

N, IMAGES, SIDE, CLASSES, SHARD = 2, 64, 32, 10, 16
BATCH, EPOCHS, LR, SEED = 8, 2, 1e-3, 7
SPE = IMAGES // BATCH


def _cfg(tmp, tag, init):
    out = os.path.join(tmp, tag)
    os.makedirs(out)
    cfg = dict(store=os.path.join(tmp, "store"), model="narrow",
               model_seed=0, classes=CLASSES, init=init, batch=BATCH,
               seed=SEED, epochs=EPOCHS, lr=LR, warmup_epochs=1,
               checkpoint_dir=os.path.join(out, "ckpt"), deterministic=True,
               out=out, signal_dir=out, device="cpu", save_params=True)
    path = os.path.join(out, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _hvdrun(path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("HOROVOD_CHAOS", None)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(N),
         "--kv-standbys", "1", sys.executable,
         os.path.join(ROOT, "tools", "launcher_phase.py"), "--worker", path],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def _jax_run(model, params, stats, x, y):
    """The JAX package's ZeRO-1 run over the port's global batches: step
    i's array is rank 0's rows then rank 1's, so device r trains on what
    rank r drew."""
    index = GlobalSampleIndex(IMAGES, BATCH, seed=SEED)

    def schedule(count):
        epoch = count.astype(jnp.float32) / SPE
        warm = LR * ((jnp.minimum(epoch, 1.0) * (N - 1) / 1 + 1) / N)
        return jnp.where(count < SPE, warm, LR * 0.5 ** epoch)

    jhvd.init(devices=jax.devices()[:N])
    try:
        dtx = jhvd.DistributedOptimizer(
            optax.inject_hyperparams(optax.adam)(learning_rate=schedule),
            compression=JC.int8, error_feedback=True, shard_optimizer=True)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        s = jax.tree_util.tree_map(jnp.asarray, stats)
        st = dtx.init(p)
        step = make_shardmap_train_step(model, dtx, shard_optimizer=True,
                                        instrument=False)
        losses = []
        for i in range(SPE * EPOCHS):
            e, k = divmod(i, SPE)
            ids = np.concatenate([index.rank_indices(e, k, r, N)
                                  for r in range(N)])
            xb = jnp.asarray(x[ids], jnp.float32) * np.float32(1.0 / 255.0)
            p, s, st, loss = step(p, s, st, shard_batch(xb),
                                  shard_batch(jnp.asarray(y[ids])))
            losses.append(float(loss))
        return {"losses": losses,
                "params": flatten_tree(jax.tree_util.tree_map(np.asarray, p)),
                "stats": flatten_tree(jax.tree_util.tree_map(np.asarray, s))}
    finally:
        jhvd.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("launcher_slice"))
    LP.make_dataset(os.path.join(tmp, "store"), IMAGES, SIDE, CLASSES, SHARD)
    x, y = ArrayShardStore(os.path.join(tmp, "store")).gather(
        np.arange(IMAGES))
    model = jres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=jres.BottleneckBlock, num_classes=CLASSES,
                        num_filters=8, dtype=jnp.float32)
    v = jax.jit(lambda xx: model.init(jax.random.PRNGKey(3), xx, train=True))(
        jnp.zeros((1, SIDE, SIDE, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    init = os.path.join(tmp, "init.npz")
    np.savez(init, **{f"p/{k}": a for k, a in flatten_tree(params).items()},
             **{f"s/{k}": a for k, a in flatten_tree(stats).items()})
    hv_cfg, hv_path = _cfg(tmp, "hvdrun", init)
    rw_cfg, _ = _cfg(tmp, "run_world", init)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = pool.submit(_hvdrun, hv_path)
        harness = pool.submit(run_world, LP.worker, N, rw_cfg,
                              timeout=300)
        ref = _jax_run(model, params, stats, x, y)
        proc = launched.result()
        world = harness.result()
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = []
    for r in range(N):
        with open(os.path.join(hv_cfg["out"], f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, world, ref, flatten_tree(params)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_launched_run_is_bit_equal_to_run_world(runs):
    recs, world, _, _ = runs
    shas = {r["params_sha"] for r in recs} | {r["params_sha"] for r in world}
    assert len(shas) == 1
    for a, b in zip(recs, world):
        assert [s["loss"] for s in a["steps"]] == \
            [s["loss"] for s in b["steps"]]
        pa, pb = _npz(a["params_npz"]), _npz(b["params_npz"])
        assert pa.keys() == pb.keys()
        assert all(np.array_equal(pa[k], pb[k]) for k in pa)


def test_launched_ranks_draw_the_sample_index_stream(runs):
    recs, _, _, _ = runs
    index = GlobalSampleIndex(IMAGES, BATCH, seed=SEED)
    for r, rec in enumerate(recs):
        assert (rec["rank"], rec["size"]) == (r, N)
        assert rec["first_batch_equal"] is True
        assert [s["i"] for s in rec["steps"]] == list(range(SPE * EPOCHS))
        for s in rec["steps"]:
            e, k = divmod(s["i"], SPE)
            assert s["key"] == [e, k]
            assert s["ids"] == index.rank_indices(e, k, r, N).tolist()
    for e in range(EPOCHS):
        ids = [i for rec in recs for s in rec["steps"][e * SPE:(e + 1) * SPE]
               for i in s["ids"]]
        assert sorted(ids) == list(range(IMAGES))


def test_launched_run_warms_up_and_averages_its_metrics(runs):
    recs, _, _, _ = runs
    lrs = [s["lr"] for s in recs[0]["steps"]]
    assert lrs == [LR * ((i / SPE * (N - 1) / 1 + 1) / N) if i < SPE
                   else LR * 0.5 ** (i // SPE + float(i % SPE) / SPE)
                   for i in range(SPE * EPOCHS)]
    assert lrs[0] == LR / N and lrs[SPE] == LR / 2
    assert len(set(lrs[SPE:])) == SPE
    # MetricAverageCallback: the epoch loss is the same mean on each rank
    assert recs[0]["epoch_logs"] == recs[1]["epoch_logs"]
    assert len(recs[0]["epoch_logs"]) == EPOCHS


def _update_error(got, want, p0, scale=1.0):
    """``|dp - dj| / |dj|`` over every parameter: the port's update from
    the shared initial parameters (``scale`` times it) against the JAX
    package's, in the norm of the JAX update itself."""
    num = den = 0.0
    for k, w in want.items():
        dj = w.astype(np.float64) - p0[k]
        dp = scale * (got[f"p/{k}"].astype(np.float64) - p0[k])
        num += float(np.sum((dp - dj) ** 2))
        den += float(np.sum(dj ** 2))
    return (num / den) ** 0.5


#: the bar on the update error; an lr 10 % off moves it to about 0.1
UPDATE_BAR = 0.03


def test_launched_run_tracks_jax(runs):
    recs, _, ref, p0 = runs
    losses = [s["loss"] for s in recs[0]["steps"]]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    got = _npz(recs[0]["params_npz"])
    assert _update_error(got, ref["params"], p0) < UPDATE_BAR
    for k, want in ref["stats"].items():
        np.testing.assert_allclose(got[f"s/{k}"], want, rtol=5e-3,
                                   atol=5e-4, err_msg=k)


@pytest.mark.parametrize("scale", [0.0, 0.9, 1.1, -1.0])
def test_update_bar_fails_a_planted_fault(runs, scale):
    """The bar fails the launched run's own parameters when their update
    is scaled: none at all, an lr 10 % low or high, the wrong sign."""
    recs, _, ref, p0 = runs
    got = _npz(recs[0]["params_npz"])
    assert _update_error(got, ref["params"], p0, scale) > UPDATE_BAR
