"""Blockwise (flash) attention.

Counterpart of ``horovod_tpu/ops/flash_attention.py`` (training path;
the kv-cache decode primitives wait for serving). Layout is the JAX
package's: ``q`` ``[B, Tq, H, D]``, ``k``/``v`` ``[B, Tk, H_kv, D]`` with
``H % H_kv == 0`` (grouped-query attention broadcasts each K/V head over
its query group; MQA is ``H_kv == 1``).

- forward: the ``flash_fwd`` kernel (:func:`horovod_tpu_torch.ops.kernels.flash_fwd`),
  an online-softmax pass that emits ``out`` and the log-sum-exp rows;
  on CPU tensors its plain version (:func:`_attention_scan` →
  :func:`_finalize`, :func:`lse_from_state`);
- backward: the flash backward in plain PyTorch, as the reference's is a
  ``lax.scan`` (:func:`flash_bwd`): it loops over K/V blocks recomputing
  each block's probabilities from ``(q, k, lse)``, so no score matrix is
  saved (O(T) extra memory), and keeps K/V ``H_kv``-wide, broadcasting
  each block over the query group and summing its gradient back.

``_attention_scan`` and ``_block_bwd`` keep the reference's
``q_offset``/``kv_offset`` arguments (global positions of element 0), the
building blocks ring attention reuses.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops import kernels as _k

NEG_INF = -1e30
#: lse stand-in for fully-masked rows: exp(s - BIG) == 0 for any real score
LSE_MASKED = 1e30


def _block_sizes(t_q: int, t_k: int, block_q: int, block_k: int):
    bq = min(block_q, t_q)
    bk = min(block_k, t_k)
    while t_q % bq:
        bq //= 2
    while t_k % bk:
        bk //= 2
    return max(bq, 1), max(bk, 1)


def _causal_mask(q_ids, k_ids):
    return q_ids[:, None] >= k_ids[None, :]


def lse_from_state(m, l):
    """log-sum-exp rows from online-softmax state; fully-masked rows get
    ``LSE_MASKED`` so recomputed probabilities vanish."""
    return torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)),
                       torch.full_like(m, LSE_MASKED))


def _attention_scan(q, k, v, *, causal: bool, sm_scale: float,
                    q_offset: int, kv_offset: int, block_k: int):
    """Online-softmax attention over K/V blocks.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D] (already broadcast to H heads).
    Returns the online-softmax state ``(m, l, acc)`` in f32 with m/l
    ``[B, H, Tq]`` and acc ``[B, H, Tq, D]``. ``q`` is scaled by
    ``sm_scale`` in f32 before the dot, and masked scores are ``NEG_INF``
    (a true ``-inf`` would give NaN in ``m_prev - m_new``)."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    _, bk = _block_sizes(t_q, t_k, t_q, block_k)
    qf = (q.float() * sm_scale).transpose(1, 2)       # [B, H, Tq, D]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    q_ids = q_offset + torch.arange(t_q, device=q.device)

    m = torch.full((b, h, t_q), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_q), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t_q, d), dtype=torch.float32, device=q.device)
    for j in range(t_k // bk):
        k_blk = kf[:, :, j * bk:(j + 1) * bk]
        v_blk = vf[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk)
        if causal:
            k_ids = kv_offset + j * bk + torch.arange(bk, device=q.device)
            s = torch.where(_causal_mask(q_ids, k_ids), s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
        m = m_new
    return m, l, acc


def _finalize(m, l, acc, dtype):
    # fully-masked rows (ring attention with kv entirely in the causal
    # future) have l == 0; emit zeros, not NaNs
    pos = l > 0
    safe_l = torch.where(pos, l, torch.ones_like(l))
    out = acc / safe_l[..., None]
    out = torch.where(pos[..., None], out, torch.zeros_like(out))
    return out.transpose(1, 2).to(dtype)               # [B, Tq, H, D]


def _block_bwd(q, k_blk, v_blk, dout, delta, lse, *, causal: bool,
               sm_scale: float, q_offset: int, kv_offset: int):
    """Gradient contributions of one K/V block, recomputing p from lse.

    q/dout: [B, Tq, H, D]; k_blk/v_blk: [B, Tk, H, D];
    delta/lse: [B, H, Tq] (delta = rowsum(dout * out)).
    Returns ``(dq_contrib [B,Tq,H,D], dk_blk, dv_blk [B,Tk,H,D])`` in f32.
    """
    qf, kf, vf = q.float(), k_blk.float(), v_blk.float()
    dof = dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    if causal:
        q_ids = q_offset + torch.arange(q.shape[1], device=q.device)
        k_ids = kv_offset + torch.arange(k_blk.shape[1], device=q.device)
        s = torch.where(_causal_mask(q_ids, k_ids), s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])                  # [B, H, Tq, Tk]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    return dq, dk, dv


def _delta(out, dout):
    """delta = rowsum(dout * out): [B, Tq, H, D] -> [B, H, Tq]."""
    return torch.einsum("bqhd,bqhd->bhq", out.float(), dout.float())


def gqa_group(q, k) -> int:
    """Query-group size for GQA/MQA (1 = standard multi-head)."""
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({h_kv})")
    return h // h_kv


def rep_group(x, g: int):
    """Broadcast K/V heads over query groups (the g copies of each kv head
    adjacent, as ``jnp.repeat``)."""
    return torch.repeat_interleave(x, g, dim=2) if g > 1 else x


def reduce_group(dx, g: int):
    """Transpose of :func:`rep_group` for gradients: sum each kv head's
    adjacent query-group copies of a ``[B, T, H, D]`` block."""
    if g == 1:
        return dx
    b, t, h, d = dx.shape
    return dx.reshape(b, t, h // g, g, d).sum(dim=3)


def repeat_kv_heads(q, k, v):
    """Broadcast K/V heads over query groups for GQA/MQA."""
    g = gqa_group(q, k)
    return rep_group(k, g), rep_group(v, g)


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool, sm_scale: float,
              block_k: int = 128):
    """The flash backward (reference ``_flash_bwd``): loop over K/V
    blocks, recompute each block's p from ``lse``, accumulate dq in f32
    and emit each block's dk/dv (group-summed back to ``H_kv`` heads).
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    b, t_k, h_kv, d = k.shape
    grp = q.shape[2] // h_kv
    _, bk = _block_sizes(q.shape[1], t_k, q.shape[1], block_k)
    delta = _delta(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(t_k // bk):
        sl = slice(j * bk, (j + 1) * bk)
        dq_c, dk_b, dv_b = _block_bwd(
            q, rep_group(k[:, sl], grp), rep_group(v[:, sl], grp), dout,
            delta, lse, causal=causal, sm_scale=sm_scale, q_offset=0,
            kv_offset=j * bk)
        dq = dq + dq_c
        dks.append(reduce_group(dk_b, grp))
        dvs.append(reduce_group(dv_b, grp))
    dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_k):
        out, lse = _k.flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                block_k=block_k)
        # out is saved in its output dtype: delta is computed from it, as
        # the reference's residual holds it
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.block_k = causal, sm_scale, block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                               sm_scale=ctx.sm_scale, block_k=ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128):
    """Memory-efficient attention. ``q``: [B, Tq, H, D]; ``k``/``v``:
    [B, Tk, H_kv, D] with ``H % H_kv == 0``. Returns [B, Tq, H, D] in
    ``q``'s dtype.

    CUDA tensors run the ``flash_fwd`` kernel, which tiles by its own
    blocks; ``block_q``/``block_k`` set the blocking of the plain version
    (CPU) and of the backward, as in the reference (the result is the
    same whatever the blocking, up to rounding)."""
    del block_q  # the plain forward, like the reference's scan, blocks K only
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q/k/v must be [batch, seq, heads, head_dim]")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    gqa_group(q, k)  # validate H % H_kv == 0
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, bool(causal), float(sm_scale), int(block_k))
