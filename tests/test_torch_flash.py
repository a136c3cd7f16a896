"""horovod_tpu_torch.ops.flash_attention against the JAX package's
``ops/flash_attention.py`` on the same numpy inputs, in f32 on the CPU.

- forward ``(out, lse)``: the port's ``flash_fwd`` (on CPU tensors the
  kernel's plain version, which ``flash_attention``'s forward reaches)
  against the Pallas kernel ``_flash_fwd_pallas(..., interpret=True)``
  and the scan path (``use_pallas=False``), at atol 1e-5: the two sum in
  other orders (blocks of 16 here, the kernel's own tiles there);
- gradients of ``sum(out * cot)`` against ``jax.grad`` through
  ``flash_attention``, at atol 1e-5;
- the building blocks ring attention reuses, at global offsets, and the
  finalize of rows with no key (zeros and ``LSE_MASKED``).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.torch_port

B, T, D, H = 2, 64, 16, 4
ATOL = 1e-5


def _qkv(seed, t=T, h_kv=H, t_k=None):
    r = np.random.RandomState(seed)
    q = r.randn(B, t, H, D).astype(np.float32)
    k = r.randn(B, t_k or t, h_kv, D).astype(np.float32)
    v = r.randn(B, t_k or t, h_kv, D).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


CASES = [(h_kv, causal) for h_kv in (4, 2, 1) for causal in (True, False)]


@pytest.mark.parametrize("h_kv,causal", CASES)
@pytest.mark.parametrize("ref", ["pallas_interpret", "scan"])
def test_forward_out_and_lse(h_kv, causal, ref):
    q, k, v = _qkv(1, h_kv=h_kv)
    scale = D ** -0.5
    if ref == "pallas_interpret":
        out_j, lse_j = jfa._flash_fwd_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            sm_scale=scale, block_q=16, block_k=16, interpret=True)
    else:
        out_j, lse_j = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, scale,
                                     (16, 16, False, False))
    K.reset_launches()
    out, lse = K.flash_fwd(*_t(q, k, v), causal=causal, sm_scale=scale,
                           block_k=16)
    assert K.launches["flash_fwd"] == 0  # CPU tensors: the plain version
    assert out.dtype == torch.float32 and tuple(lse.shape) == (B, H, T)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL)
    # the public op returns the same forward
    pub = tfa.flash_attention(*_t(q, k, v), causal=causal, block_k=16)
    assert torch.equal(pub, out)


def test_forward_block_sizes_halve():
    """T = 48 with blocks of 32: ``_block_sizes`` halves them to 16 on
    both sides; the result does not depend on the blocking."""
    t = 48
    assert tfa._block_sizes(t, t, 32, 32) == jfa._block_sizes(t, t, 32, 32) == (16, 16)
    q, k, v = _qkv(2, t=t)
    out_j, lse_j = jfa._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sm_scale=D ** -0.5, block_q=32, block_k=32, interpret=True)
    for bk in (32, 48, 128):
        out, lse = K.flash_fwd(*_t(q, k, v), causal=True, block_k=bk)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL)


@pytest.mark.parametrize("h_kv,causal", CASES)
def test_gradients_match_jax(h_kv, causal):
    q, k, v = _qkv(3, h_kv=h_kv)
    cot = np.random.RandomState(4).randn(B, T, H, D).astype(np.float32)

    def jloss(qq, kk, vv):
        out = jfa.flash_attention(qq, kk, vv, causal=causal, block_k=16,
                                  use_pallas=False)
        return jnp.sum(out * jnp.asarray(cot))

    gj = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_k=16)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), gj):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_backward_keeps_kv_heads():
    """bf16 in, bf16 gradients out, K/V gradients H_kv-wide."""
    q, k, v = (x.to(torch.bfloat16).requires_grad_()
               for x in _t(*_qkv(5, h_kv=2)))
    tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and tuple(k.grad.shape) == (B, T, 2, D)
    assert all(bool(torch.isfinite(g.float()).all()) for g in (q.grad, k.grad, v.grad))


@pytest.mark.parametrize("q_offset,kv_offset", [(0, 0), (64, 0), (0, 32)])
def test_scan_state_and_block_bwd_with_offsets(q_offset, kv_offset):
    """``_attention_scan``'s online-softmax state at global offsets
    (rows whose keys all lie in the causal future see only ``NEG_INF``
    scores, as in the reference), ``_finalize`` and ``lse_from_state``
    (rows with no key: zeros and LSE_MASKED), and ``_block_bwd``."""
    q, k, v = _qkv(6)
    kw = dict(causal=True, sm_scale=D ** -0.5, q_offset=q_offset,
              kv_offset=kv_offset)
    mj, lj, aj = jfa._attention_scan(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), block_k=16, **kw)
    m, l, acc = tfa._attention_scan(*_t(q, k, v), block_k=16, **kw)
    for got, want in ((m, mj), (l, lj), (acc, aj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # rows with no key at all (l == 0) finalize to zeros and LSE_MASKED
    l0 = l.clone()
    l0[..., :5] = 0.0
    lj0 = jnp.asarray(l0.numpy())
    out0 = tfa._finalize(m, l0, acc, torch.float32)
    lse0 = tfa.lse_from_state(m, l0)
    np.testing.assert_allclose(out0.numpy(),
                               np.asarray(jfa._finalize(mj, lj0, aj, jnp.float32)),
                               atol=ATOL)
    np.testing.assert_allclose(lse0.numpy(), np.asarray(jfa.lse_from_state(mj, lj0)),
                               atol=ATOL)
    assert bool((lse0[..., :5] == tfa.LSE_MASKED).all())
    assert bool((out0[:, :5] == 0).all())
    out = tfa._finalize(m, l, acc, torch.float32)
    lse = tfa.lse_from_state(m, l)

    r = np.random.RandomState(7)
    dout = r.randn(B, T, H, D).astype(np.float32)
    delta = np.asarray(jfa._delta(jnp.asarray(out.numpy()), jnp.asarray(dout)))
    np.testing.assert_allclose(
        tfa._delta(out, torch.from_numpy(dout)).numpy(), delta, atol=ATOL)
    gj = jfa._block_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(dout), jnp.asarray(delta),
                        jnp.asarray(lse.numpy()), **kw)
    gt = tfa._block_bwd(*_t(q, k, v, dout, delta), lse, **kw)
    for got, want in zip(gt, gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_group_helpers_match_jax():
    x = np.random.RandomState(8).randn(B, 5, 3, D).astype(np.float32)
    rep = tfa.rep_group(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(jfa.rep_group(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        tfa.reduce_group(rep, 4).numpy(),
        np.asarray(jfa.reduce_group(jnp.asarray(rep.numpy()), 4)))
    q = torch.zeros(B, 5, 12, D)
    assert tfa.gqa_group(q, torch.from_numpy(x)) == 4
    with pytest.raises(ValueError, match="multiple"):
        tfa.gqa_group(torch.zeros(B, 5, 4, D), torch.from_numpy(x))
    k, v = tfa.repeat_kv_heads(q, torch.from_numpy(x), torch.from_numpy(x))
    assert tuple(k.shape) == tuple(v.shape) == (B, 5, 12, D)


def test_public_op_validates_shapes():
    q, k, v = _t(*_qkv(9))
    with pytest.raises(ValueError, match="batch, seq, heads"):
        tfa.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="k/v shape"):
        tfa.flash_attention(q, k, v[:, :32])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        K.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
