"""horovod_tpu_torch.models.resnet against the flax ResNet of the JAX
package, weights carried across (f32, small widths): logits, loss,
gradients and BatchNorm running-stat updates at 1e-4; ResNet-50 at full
width leaf for leaf (shapes on the ``meta`` device); and the traps of the
port one by one: SAME padding, flax's BatchNorm, and the flax leaf order
and layouts the int8 wire's flat packing depends on."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as nn

from horovod_tpu.models import resnet as jres
from horovod_tpu.training import softmax_xent as jxent
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models.convert import (
    flatten_tree, flax_params, load_flax_variables,
)
from horovod_tpu_torch.ops import overlap as tov
from horovod_tpu_torch.optim import _zero_groups, tree_keys
from horovod_tpu_torch.training import softmax_xent

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)


def _flax_small():
    return jres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=jres.BottleneckBlock,
                       num_classes=10, num_filters=8, dtype=jnp.float32)


def _port_small():
    return tres.ResNet([1, 1, 1, 1], tres.BottleneckBlock, num_classes=10,
                       num_filters=8, dtype=torch.float32)


@pytest.fixture(scope="module")
def small():
    """Random weights (every leaf, BN scales included — the zero init of
    the last BN would hide a block's branch) and running stats."""
    r = np.random.RandomState(0)
    x = r.randn(4, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, (4,))
    fm = _flax_small()
    v = jax.jit(lambda xx: fm.init(jax.random.PRNGKey(0), xx, train=True))(
        jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: (r.randn(*a.shape) * 0.3).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(r.randn(*a.shape)) + 0.5).astype(np.float32),
        v["batch_stats"])
    return fm, params, stats, x, y


def test_train_step_matches_flax(small):
    fm, params, stats, x, y = small

    def loss_fn(p):
        logits, upd = fm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return jxent(logits, jnp.asarray(y)), (logits, upd["batch_stats"])

    (lj, (logits_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    m = _port_small()
    load_flax_variables(m, params, stats)
    m.train()
    logits = m(torch.from_numpy(x))
    loss = softmax_xent(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(lj), **TOL)
    gj = flatten_tree(grads_j)
    gp = m.jax_grads()
    assert set(gp) == set(gj)
    for k in gj:
        # 1e-4 relative to the leaf's own scale: both sides take the fast
        # variance E[x²]-E[x]², whose cancellation magnifies f32 noise in
        # single elements (seen: 4.7e-4 relative, on a 4.4-sized leaf)
        want = np.asarray(gj[k])
        np.testing.assert_allclose(gp[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=k)
    sj = flatten_tree(stats_j)
    sp = m.jax_batch_stats()
    for k in sj:
        np.testing.assert_allclose(sp[k].numpy(), np.asarray(sj[k]),
                                   err_msg=k, **TOL)


def test_eval_uses_running_stats(small):
    fm, params, stats, x, _ = small
    logits_j = jax.jit(lambda xx: fm.apply(
        {"params": params, "batch_stats": stats}, xx, train=False))(
            jnp.asarray(x))
    m = _port_small()
    load_flax_variables(m, params, stats)
    m.eval()
    with torch.no_grad():
        logits = m(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_resnet50_full_width_leaf_for_leaf():
    shapes = jax.eval_shape(lambda: jres.ResNet50().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    leaves_j = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    shapes_j = {"/".join(k.key for k in path): tuple(a.shape)
                for path, a in leaves_j}
    m = tres.ResNet50(device="meta")
    shapes_t = {k: tuple(v.shape) for k, v in m.jax_params().items()}
    assert len(shapes_t) == 161
    assert shapes_t == shapes_j
    assert sum(int(np.prod(s)) for s in shapes_t.values()) == 25_557_032
    # JAX's flatten order, which the flat packing follows
    order_j = list(shapes_j)
    assert tree_keys(m.jax_params()) == order_j
    assert order_j.index("BottleneckBlock_10/BatchNorm_0/bias") < \
        order_j.index("BottleneckBlock_2/BatchNorm_0/bias")


def test_flat_packing_matches_jax_layout(small):
    """The ZeRO-1 flat buffer of the port's params (flax order, HWIO
    kernels, [in, out] head) holds the same elements as JAX's."""
    _, params, _, _, _ = small
    m = _port_small()
    load_flax_variables(m, params)
    views = m.jax_params()
    keys = tree_keys(views)
    leaves = [views[k] for k in keys]
    (g,) = _zero_groups(leaves, 2).values()
    flat = tov.pack_group(leaves, g).numpy()
    want = np.concatenate([np.asarray(a).ravel()
                           for a in jax.tree_util.tree_leaves(params)])
    assert np.array_equal(flat[:want.size], want)
    assert np.all(flat[want.size:] == 0)
    # and the unpack inverts it, views included
    back = tov.assemble({g.key: torch.from_numpy(flat)}, {g.key: g},
                        [tuple(l.shape) for l in leaves],
                        [l.dtype for l in leaves])
    for k, b in zip(keys, back):
        assert torch.equal(b, views[k].detach())
    assert flatten_tree(flax_params(m)).keys() == set(keys)


@pytest.mark.parametrize("size,k,stride,want", [
    (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
    (57, 3, 2, (1, 1)), (8, 1, 1, (0, 0)),
])
def test_same_padding(size, k, stride, want):
    assert tres.same_pads(size, k, stride) == want


def test_stride2_conv_and_maxpool_pad_like_flax():
    r = np.random.RandomState(3)
    x = r.randn(2, 8, 8, 4).astype(np.float32) - 3.0   # all negative-ish
    w = r.randn(3, 3, 4, 5).astype(np.float32)
    conv = nn.Conv(5, (3, 3), (2, 2), use_bias=False, dtype=jnp.float32)
    yj = conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    c = tres.Conv(4, 5, 3, 2, dtype=torch.float32)
    with torch.no_grad():
        c.jax_params()["kernel"].copy_(torch.from_numpy(w))
        yt = c(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    pj = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ph, pw = tres.same_pads(8, 3, 2), tres.same_pads(8, 3, 2)
    pt = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(xt, (pw[0], pw[1], ph[0], ph[1]),
                                value=float("-inf")), 3, 2)
    np.testing.assert_array_equal(pt.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(pj))


def test_batchnorm_biased_variance_and_momentum():
    """Running var follows 0.9·ra + 0.1·(biased batch var), eps 1e-5 —
    torch.nn.BatchNorm2d would fold in the unbiased variance."""
    r = np.random.RandomState(4)
    x = (r.randn(3, 6, 4, 4) * 2 + 1).astype(np.float32)
    bn = tres.BatchNorm(6, dtype=torch.float32)
    bn.reset_parameters()
    bn.train()
    y = bn(torch.from_numpy(x))
    mean = x.mean(axis=(0, 2, 3))
    var = (x * x).mean(axis=(0, 2, 3)) - mean * mean
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * var, rtol=1e-5)
    ref = torch.nn.BatchNorm2d(6, momentum=0.1, eps=1e-5)
    ref(torch.from_numpy(x))
    assert not np.allclose(ref.running_var.numpy(), bn.var.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        y.detach().numpy(),
        (x - mean[:, None, None]) / np.sqrt(var[:, None, None] + 1e-5),
        rtol=1e-4, atol=1e-4)


def test_last_bn_of_each_block_starts_at_zero_scale():
    m = tres.ResNet50(num_filters=4, num_classes=10)
    p = m.jax_params()
    for name in m.blocks:
        assert torch.all(p[f"{name}/BatchNorm_2/scale"] == 0)
        assert torch.all(p[f"{name}/BatchNorm_0/scale"] == 1)
