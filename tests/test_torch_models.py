"""The port's VGG, Inception V3, MLP and MNIST CNN against the flax models
of the JAX package, weights carried across through ``models/convert.py``
(f32 compute): logits at 1e-4 (``tests/test_torch_resnet.py``'s bar),
the narrow VGG's gradients, VGG-16 and Inception V3 leaf for leaf at full
width (shapes on the ``meta`` device), and three ZeRO-1 int8 + EF steps
of the narrow VGG on a gloo world of 2 against the JAX package's step on
2 CPU devices."""

import concurrent.futures

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JC
from horovod_tpu.models import MLP, VGG, VGG16, InceptionV3, MnistCNN
from horovod_tpu.training import (
    make_shardmap_train_step, shard_batch, softmax_xent as jxent,
)
from horovod_tpu_torch.models.convert import (
    flatten_tree, load_flax_variables, port_model,
)
from horovod_tpu_torch.testing import run_world
from horovod_tpu_torch.training import softmax_xent

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)

#: (flax model, input shape, what flax infers from the input)
CASES = {
    "mlp": (lambda: MLP(features=(32, 10)), (4, 8, 8, 1),
            dict(in_features=64)),
    "mnist": (lambda: MnistCNN(), (2, 28, 28, 1), dict(input_size=28)),
    "vgg_narrow": (lambda: VGG(stages=((4,), (8,)), num_classes=10,
                               hidden_dim=16, dtype=jnp.float32),
                   (2, 16, 16, 3), dict(input_size=16)),
    "vgg_narrow_bn": (lambda: VGG(stages=((4,), (8,)), num_classes=10,
                                  hidden_dim=16, dtype=jnp.float32,
                                  use_bn=True),
                      (2, 16, 16, 3), dict(input_size=16)),
    "vgg16_hidden32": (lambda: VGG16(num_classes=10, hidden_dim=32,
                                     dtype=jnp.float32),
                       (2, 32, 32, 3), dict(input_size=32)),
    "inception_v3": (lambda: InceptionV3(num_classes=10, dtype=jnp.float32),
                     (1, 128, 128, 3), {}),
}


def _setup(name, seed=0):
    make, shape, inferred = CASES[name]
    fm = make()
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    v = jax.jit(lambda xx: fm.init(jax.random.PRNGKey(seed), xx,
                                   train=False))(jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    # running stats away from (0, 1), so eval mode reads them
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(r.randn(*a.shape)) * 0.5 + 0.5).astype(np.float32),
        v.get("batch_stats", {}))
    m = port_model(fm, **inferred)
    load_flax_variables(m, params, stats or None)
    return fm, m, params, stats, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_flax(name):
    fm, m, params, stats, x = _setup(name)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want = jax.jit(lambda xx: fm.apply(variables, xx, train=False))(
        jnp.asarray(x))
    m.eval()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["vgg_narrow", "vgg_narrow_bn"])
def test_narrow_vgg_gradients_match_flax(name):
    fm, m, params, stats, x = _setup(name, seed=1)
    y = np.random.RandomState(2).randint(0, 10, (x.shape[0],))

    def loss_fn(p):
        variables = {"params": p, **({"batch_stats": stats} if stats else {})}
        logits, upd = fm.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return jxent(logits, jnp.asarray(y)), upd.get("batch_stats", {})

    (lj, stats_j), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    m.train()
    loss = softmax_xent(m(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), **TOL)
    gj, gp = flatten_tree(gj), m.jax_grads()
    assert set(gp) == set(gj)
    for k, want in gj.items():
        want = np.asarray(want)
        np.testing.assert_allclose(gp[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=k)
    for k, want in flatten_tree(stats_j).items():
        np.testing.assert_allclose(m.jax_batch_stats()[k].numpy(),
                                   np.asarray(want), err_msg=k, **TOL)


@pytest.mark.parametrize("name,leaves,stats,count", [
    ("vgg16", 32, 0, 138_357_544),
    ("inception_v3", 284, 188, 23_834_568),
])
def test_full_width_leaf_for_leaf(name, leaves, stats, count):
    """At full width (224 / 299): the flax leaf names, shapes and flatten
    order, which the ZeRO-1 flat packing and the int8 blocks follow."""
    if name == "vgg16":
        fm, size, inferred = VGG16(), 224, dict(input_size=224)
    else:
        fm, size, inferred = InceptionV3(), 299, {}
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=True))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    want = {"/".join(k.key for k in path): tuple(a.shape)
            for path, a in flat}
    m = port_model(fm, device="meta", **inferred)
    got = {k: tuple(v.shape) for k, v in m.jax_params().items()}
    assert len(got) == leaves and got == want
    assert list(sorted(got, key=lambda k: tuple(k.split("/")))) == list(want)
    assert sum(int(np.prod(s)) for s in got.values()) == count
    assert len(m.jax_batch_stats()) == stats
    assert len(jax.tree_util.tree_leaves(shapes.get("batch_stats", {}))) \
        == stats
    if name == "vgg16":
        assert got["fc0/kernel"] == (25088, 4096)


def test_inception_avg_pool_counts_the_padding():
    """flax's SAME avg_pool divides every window by 9, the zero padding
    included: a corner of a ones map is 4/9."""
    import flax.linen as nn
    from horovod_tpu_torch.models.inception import _avg_pool_same

    x = np.ones((1, 5, 5, 2), np.float32)
    want = np.asarray(nn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                  padding="SAME"))
    got = _avg_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-7)
    assert abs(want[0, 0, 0, 0] - 4 / 9) < 1e-7


# --------------------------------------------------------------------------
# three ZeRO-1 int8 + EF steps of the narrow VGG, port (gloo, 2 ranks) vs JAX

N, STEPS, LR = 2, 3, 1e-3


@pytest.fixture(scope="module")
def vgg_runs():
    r = np.random.RandomState(5)
    x = r.randn(4 * N, 16, 16, 3).astype(np.float32)
    y = r.randint(0, 10, (4 * N,)).astype(np.int64)
    fm = CASES["vgg_narrow"][0]()
    v = jax.jit(lambda xx: fm.init(jax.random.PRNGKey(4), xx, train=True))(
        jnp.asarray(x[:1]))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    spec = dict(family="vgg", stages=((4,), (8,)), num_classes=10,
                hidden_dim=16, input_size=16)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port_run = pool.submit(run_world, W.model_slice_worker, N, spec,
                               params, {}, x, y, STEPS, LR)
        ref = _jax_run(fm, params, x, y)
        port = port_run.result()
    return params, port, ref


def _jax_run(model, params, x, y):
    jhvd.init(devices=jax.devices()[:N])
    try:
        from horovod_tpu.optim import fused_adam

        dtx = jhvd.DistributedOptimizer(fused_adam(LR), compression=JC.int8,
                                        error_feedback=True,
                                        shard_optimizer=True)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        st = dtx.init(p)
        step = make_shardmap_train_step(model, dtx, shard_optimizer=True,
                                        instrument=False)
        xs, ys = shard_batch(jnp.asarray(x)), shard_batch(jnp.asarray(y))
        s, losses = {}, []
        for _ in range(STEPS):
            p, s, st, loss = step(p, s, st, xs, ys)
            losses.append(float(loss))
        return {"losses": losses,
                "params": flatten_tree(jax.tree_util.tree_map(np.asarray, p)),
                "residual": np.asarray(st.residual["float32"])}
    finally:
        jhvd.shutdown()


def test_narrow_vgg_zero1_int8_steps_track_jax(vgg_runs):
    """The trajectory at the int8 bar of ``tests/test_torch_slice.py``
    (rtol 5e-3 / atol 5e-4; the loss at 1e-4 relative): the two
    frameworks sum the convolutions' gradients in different orders, and
    the wire can turn a last-bit difference into one quantum."""
    params, port, ref = vgg_runs
    for r in range(N):
        np.testing.assert_allclose(port[r]["losses"], ref["losses"], rtol=1e-4)
    assert port[0]["losses"][-1] < port[0]["losses"][0]
    moved = 0
    for k, want in ref["params"].items():
        got = port[0]["params"][k]
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4, err_msg=k)
        assert np.array_equal(got, port[1]["params"][k]), k
        moved += not np.array_equal(got, flatten_tree(params)[k])
    assert moved == len(ref["params"])
    for r in range(N):
        off = ~np.isclose(port[r]["residual"], ref["residual"][r],
                          rtol=5e-3, atol=5e-4)
        assert off.mean() < 5e-3, off.mean()


def test_port_model_covers_the_families():
    from horovod_tpu.models import ResNet18

    assert type(port_model(ResNet18(num_classes=5), device="meta")).__name__ \
        == "ResNet"
    with pytest.raises(ValueError, match="no port model"):
        port_model(object())
