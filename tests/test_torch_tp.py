"""Tensor parallelism of the port: ``models.transformer.
transformer_param_specs`` against the JAX package's PartitionSpecs, and
``tp_block_apply`` over the ``tp`` axis of a gloo world (``data 2 x tp
4`` in a world of 8, the JAX fixture's mesh; ``tp 2`` in a world of 2)
against the JAX package's ``tp_block_apply`` on the matching CPU mesh and
against flax's ``TransformerBlock.apply``.

The output's bar is the JAX test's (``tests/test_fsdp.py``: rtol 2e-5,
atol 2e-6, at dim 32). Gradients: psum's backward is a psum, so each
rank's gradient is the axis size times its share and their mean over the
axis is the block's; that mean is held against ``jax.grad`` of the dense
block (x and every parameter) at rtol 1e-4 / atol 1e-5, the JAX
package's gradient bar for sharded-vs-dense (``tests/test_pipeline_moe.
py``).
"""

import concurrent.futures

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import TransformerTiny
from horovod_tpu.models.transformer import (
    TransformerBlock, default_attention, tp_block_apply,
    transformer_param_specs as jspecs,
)
from horovod_tpu.ops import collective as JCol
from horovod_tpu_torch.models.convert import flatten_tree
from horovod_tpu_torch.models.transformer import (
    TransformerLM, transformer_param_specs,
)
from horovod_tpu_torch.testing import run_world

import test_torch_workers as W

pytestmark = pytest.mark.torch_port

DIM, HEADS = 32, 4


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_param_specs_match_jax(kv_heads):
    """Every flax-keyed leaf of a TransformerTiny (fused qkv, and GQA's
    q_proj/kv_proj) splits the dim the JAX package's PartitionSpec names,
    or none."""
    import torch

    jm = TransformerTiny(dtype=jnp.float32, kv_heads=kv_heads)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    want = flatten_tree(jspecs(params, "model"))
    tm = TransformerLM(vocab=1024, dim=64, depth=2, heads=4, max_len=4096,
                       kv_heads=kv_heads, dtype=torch.float32)
    got = transformer_param_specs(tm.jax_params())
    assert set(got) == set(want)
    for k, spec in want.items():
        dims = [i for i, a in enumerate(spec) if a == "model"]
        assert got[k] == (dims[0] if dims else None), k


def _block_inputs(seed=0):
    block = TransformerBlock(dim=DIM, heads=HEADS, mlp_ratio=2,
                             dtype=jnp.float32, attention_fn=default_attention)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 6, DIM).astype(np.float32)
    w = rng.randn(2, 6, DIM).astype(np.float32)
    bp = jax.jit(block.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # non-zero biases and LayerNorm affines, so each is exercised
    bp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), a.dtype)
        if a.ndim == 1 else a, bp)
    return block, bp, x, w


def _jax_side(block, bp, x, w, mesh_axes, n):
    jhvd.init(axes=mesh_axes, devices=jax.devices()[:n])
    try:
        fn = jax.jit(JCol._smap(
            lambda p, t: tp_block_apply(p, t, heads=HEADS, axis="tp"),
            jhvd.mesh(), (P(), P()), P()))
        tp_out = np.asarray(fn(bp, jnp.asarray(x)))
    finally:
        jhvd.shutdown()
    ref = np.asarray(block.apply({"params": bp}, jnp.asarray(x)))
    gx, gp = jax.grad(lambda xx, pp: jnp.sum(
        block.apply({"params": pp}, xx) * w), argnums=(0, 1))(
            jnp.asarray(x), bp)
    return tp_out, ref, np.asarray(gx), {
        k: np.asarray(a) for k, a in flatten_tree(gp).items()}


WORLDS = {8: {"data": 2, "tp": 4}, 2: {"tp": 2}}


@pytest.fixture(scope="module")
def runs():
    block, bp, x, w = _block_inputs()
    flat = {k: np.asarray(a) for k, a in flatten_tree(bp).items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futs = {n: pool.submit(run_world, W.tp_worker, n, flat, x, HEADS, w,
                               timeout=300) for n in WORLDS}
        ref = {n: _jax_side(block, bp, x, w, WORLDS[n], n) for n in WORLDS}
        port = {n: f.result() for n, f in futs.items()}
    return port, ref


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_tp_block_apply_matches_jax_and_the_block(runs, n):
    """The two-psum Megatron block on every rank == the JAX package's
    ``tp_block_apply`` on the same mesh and == flax's
    ``TransformerBlock.apply`` (rtol 2e-5, atol 2e-6)."""
    port, ref = runs
    tp_out, dense, _, _ = ref[n]
    np.testing.assert_allclose(tp_out, dense, rtol=2e-5, atol=2e-6)
    for res in port[n]:
        np.testing.assert_allclose(res["out"], tp_out, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(res["out"], dense, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_tp_block_apply_gradients_match_the_block(runs, n):
    """The mean over tp of each rank's gradients of ``sum(out * w)`` (x and
    every parameter, biases and LayerNorms included) against ``jax.grad``
    of flax's block (rtol 1e-4, atol 1e-5)."""
    port, ref = runs
    _, _, gx, gp = ref[n]
    for res in port[n]:
        np.testing.assert_allclose(res["grad_x"], gx, rtol=1e-4, atol=1e-5)
        assert set(res["grads"]) == set(gp)
        for k, g in gp.items():
            np.testing.assert_allclose(res["grads"][k], g, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_tp_block_apply_rejections_match_jax(runs, n):
    """GQA params (no fused qkv), heads not divisible by the axis and an
    MLP hidden width not divisible by it raise the JAX package's texts."""
    port, _ = runs
    axis = WORLDS[n]["tp"]
    want = [
        "tp_block_apply requires a fused qkv kernel (kv_heads unset "
        "or == heads); GQA blocks need the GSPMD path "
        "(transformer_param_specs)",
        f"heads=3 not divisible by tp axis size {axis}",
        f"mlp hidden width 7 not divisible by tp axis size {axis}",
    ]
    for res in port[n]:
        assert res["errors"] == want
