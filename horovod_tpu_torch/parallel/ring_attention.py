"""Sequence parallelism over the ``seq`` mesh axis: ring, zigzag ring and
Ulysses attention.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``. Each rank
holds ``T/n`` of the sequence (``[B, T_local, H, D]``):

- :func:`ring_attention` folds the visiting K/V block into online-softmax
  state (the plain :func:`~horovod_tpu_torch.ops.flash_attention.
  _attention_scan`, then :func:`_merge_state`) and hands it to the next
  rank; at ring step s rank r holds block ``(r - s) mod n``, which the
  port knows on the host, so a block wholly in the causal future is
  skipped by a host ``if``. The forward makes n - 1 rotations (the n-th
  would carry nothing that is used), each ONE ``batch_isend_irecv`` of
  the K and V blocks;
- the backward is a second ring pass (one ``autograd.Function`` with the
  forward): the ``(k, v, dk, dv)`` bundle rotates n times, every rank
  adding its contribution to the visiting block's gradients from the
  saved ``lse`` (:func:`~horovod_tpu_torch.ops.flash_attention.
  _block_bwd`), so the n-th rotation brings dk and dv home (it carries
  them alone); dq accumulates locally. No score matrix is saved;
- :func:`zigzag_ring_attention` is the same ring over the load-balanced
  layout of :func:`zigzag_permutation` (rank i holds chunks i and
  2n-1-i);
- :func:`ulysses_attention` trades the sequence sharding for a head
  sharding with a tiled all-to-all, attends full-length (by default the
  port's :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`:
  on CUDA tensors the ``flash_fwd`` kernel, with the plain backward) and
  trades back.

GQA: K/V may carry fewer heads (``H % H_kv == 0``); the ring rotates the
``H_kv``-wide bundle and broadcasts per fold, summing each group's
gradient back before the bundle moves on.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from horovod_tpu_torch.ops.flash_attention import (
    NEG_INF, _attention_scan, _block_bwd, _delta, _finalize, gqa_group,
    lse_from_state, reduce_group, rep_group,
)
from horovod_tpu_torch.parallel import spmd
from horovod_tpu_torch.parallel.mesh import SEQUENCE_AXIS


def _ring_perm(n):
    return tuple((i, (i + 1) % n) for i in range(n))


def _merge_state(state, new):
    """Merge two online-softmax partial states; a fully-masked partial has
    m == NEG_INF and is suppressed by a zero weight."""
    m, l, acc = state
    m2, l2, acc2 = new
    m_new = torch.maximum(m, m2)
    a1 = torch.exp(m - m_new)
    a2 = torch.where(m2 > NEG_INF / 2, torch.exp(m2 - m_new),
                     torch.zeros_like(m2))
    return (m_new, l * a1 + l2 * a2,
            acc * a1[..., None] + acc2 * a2[..., None])


def _init_state(q, t):
    b, _, h, d = q.shape
    return (torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device))


def _rotate(tensors, axis_name, n):
    """Every rank's tensors to the next rank of the ring, one batch."""
    return spmd.exchange(tensors, axis_name, _ring_perm(n)) if n > 1 \
        else list(tensors)


def _ring_fwd_impl(q, k, v, axis_name, causal, sm_scale, block_k):
    n, my = spmd.axis_size(axis_name), spmd.axis_index(axis_name)
    t_q, t_kv = q.shape[1], k.shape[1]
    g = gqa_group(q, k)
    q_offset = my * t_q
    state = _init_state(q, t_q)
    k_blk, v_blk = k, v
    for s in range(n):
        src = (my - s) % n
        # skip the blocks wholly in the causal future (the ring's
        # built-in imbalance: early ranks skip most steps)
        if not causal or src * t_kv <= q_offset + t_q - 1:
            new = _attention_scan(
                q, rep_group(k_blk, g), rep_group(v_blk, g), causal=causal,
                sm_scale=sm_scale, q_offset=q_offset if causal else 0,
                kv_offset=src * t_kv if causal else 0, block_k=block_k)
            state = _merge_state(state, new)
        if s < n - 1:
            k_blk, v_blk = _rotate([k_blk, v_blk], axis_name, n)
    m, l, acc = state
    return _finalize(m, l, acc, q.dtype), lse_from_state(m, l)


def _ring_bwd_impl(q, k, v, out, lse, dout, axis_name, causal, sm_scale):
    n, my = spmd.axis_size(axis_name), spmd.axis_index(axis_name)
    t_q, t_kv = q.shape[1], k.shape[1]
    grp = gqa_group(q, k)
    q_offset = my * t_q
    delta = _delta(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for s in range(n):
        src = (my - s) % n
        if not causal or src * t_kv <= q_offset + t_q - 1:
            dq_c, dk_c, dv_c = _block_bwd(
                q, rep_group(k_blk, grp), rep_group(v_blk, grp), dout, delta,
                lse, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                kv_offset=src * t_kv if causal else 0)
            # GQA: fold each query group's contribution back onto its kv
            # head so the rotating dk/dv bundle stays H_kv-wide
            dq = dq + dq_c
            dk = dk + reduce_group(dk_c, grp)
            dv = dv + reduce_group(dv_c, grp)
        if s < n - 1:
            k_blk, v_blk, dk, dv = _rotate([k_blk, v_blk, dk, dv], axis_name, n)
        else:  # the n-th rotation brings dk and dv home
            dk, dv = _rotate([dk, dv], axis_name, n)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis_name, causal, sm_scale, block_k):
        out, lse = _ring_fwd_impl(q, k, v, axis_name, causal, sm_scale,
                                  block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis_name, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _ring_bwd_impl(q, k, v, out, lse, dout, *ctx.args) + (
            None, None, None, None)


def ring_attention(q, k, v, *, axis_name: str = SEQUENCE_AXIS,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   block_k: int = 256):
    """Attention over a sequence sharded on ``axis_name``: ``q``/``k``/
    ``v`` are this rank's ``[B, T_local, H, D]`` shards of a global
    ``[B, T, H, D]`` sequence laid out contiguously by axis index (rank i
    holds positions ``[i*T_local, (i+1)*T_local)``). K/V may carry fewer
    (GQA/MQA) heads with ``H % H_kv == 0``. Returns this rank's output
    shard."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, axis_name, bool(causal), float(sm_scale),
                       int(block_k))


# --------------------------------------------------------------- zigzag ring


def zigzag_permutation(t: int, n: int):
    """Token permutation for the zigzag (load-balanced causal) layout:
    the sequence is cut into ``2n`` chunks and device ``i`` holds chunks
    ``i`` and ``2n-1-i``. Returns ``perm`` (np.ndarray) such that
    ``x[perm]`` is the zigzag order (shard i of length ``t/n`` is device
    i's chunk pair); invert with ``np.argsort(perm)``."""
    if t % (2 * n) != 0:
        raise ValueError(
            f"zigzag layout needs sequence length ({t}) divisible by "
            f"2 * axis size ({2 * n})"
        )
    tc = t // (2 * n)
    chunks = np.arange(t).reshape(2 * n, tc)
    order = []
    for i in range(n):
        order.append(chunks[i])
        order.append(chunks[2 * n - 1 - i])
    return np.concatenate(order)


def _zz_offsets(src, tc, n):
    """Global offsets of the two chunks device ``src`` holds."""
    return src * tc, (2 * n - 1 - src) * tc


def _zz_fwd_impl(q, k, v, axis_name, sm_scale, block_k):
    n, my = spmd.axis_size(axis_name), spmd.axis_index(axis_name)
    tc = q.shape[1] // 2
    g = gqa_group(q, k)
    qs = (q[:, :tc], q[:, tc:])
    my_offs = _zz_offsets(my, tc, n)
    states = [_init_state(q, tc), _init_state(q, tc)]
    k_blk, v_blk = k, v
    for s in range(n):
        src_offs = _zz_offsets((my - s) % n, tc, n)
        kvs = ((k_blk[:, :tc], v_blk[:, :tc]), (k_blk[:, tc:], v_blk[:, tc:]))
        for i, (q_sub, q_off) in enumerate(zip(qs, my_offs)):
            for (k_sub, v_sub), kv_off in zip(kvs, src_offs):
                if kv_off <= q_off + tc - 1:
                    new = _attention_scan(
                        q_sub, rep_group(k_sub, g), rep_group(v_sub, g),
                        causal=True, sm_scale=sm_scale, q_offset=q_off,
                        kv_offset=kv_off, block_k=block_k)
                    states[i] = _merge_state(states[i], new)
        if s < n - 1:
            k_blk, v_blk = _rotate([k_blk, v_blk], axis_name, n)
    out = torch.cat([_finalize(*st, q.dtype) for st in states], dim=1)
    lse = torch.cat([lse_from_state(st[0], st[1]) for st in states], dim=2)
    return out, lse


def _zz_bwd_impl(q, k, v, out, lse, dout, axis_name, sm_scale):
    n, my = spmd.axis_size(axis_name), spmd.axis_index(axis_name)
    tc = q.shape[1] // 2
    grp = gqa_group(q, k)
    delta = _delta(out, dout)
    my_a, my_b = _zz_offsets(my, tc, n)
    subs = (  # (q chunk, dout chunk, delta rows, lse rows, global offset)
        (q[:, :tc], dout[:, :tc], delta[:, :, :tc], lse[:, :, :tc], my_a),
        (q[:, tc:], dout[:, tc:], delta[:, :, tc:], lse[:, :, tc:], my_b),
    )
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for s in range(n):
        src_offs = _zz_offsets((my - s) % n, tc, n)
        kv_subs = ((k_blk[:, :tc], v_blk[:, :tc]),
                   (k_blk[:, tc:], v_blk[:, tc:]))
        dk_halves = [dk[:, :tc], dk[:, tc:]]
        dv_halves = [dv[:, :tc], dv[:, tc:]]
        dq_parts = []
        for q_sub, g_sub, d_sub, l_sub, q_off in subs:
            dq_sub = torch.zeros(q_sub.shape, dtype=torch.float32,
                                 device=q.device)
            for ki, kv_off in enumerate(src_offs):
                if kv_off > q_off + tc - 1:
                    continue
                k_sub, v_sub = kv_subs[ki]
                dq_c, dk_c, dv_c = _block_bwd(
                    q_sub, rep_group(k_sub, grp), rep_group(v_sub, grp),
                    g_sub, d_sub, l_sub, causal=True, sm_scale=sm_scale,
                    q_offset=q_off, kv_offset=kv_off)
                dq_sub = dq_sub + dq_c
                dk_halves[ki] = dk_halves[ki] + reduce_group(dk_c, grp)
                dv_halves[ki] = dv_halves[ki] + reduce_group(dv_c, grp)
            dq_parts.append(dq_sub)
        dq = dq + torch.cat(dq_parts, dim=1)
        dk, dv = torch.cat(dk_halves, dim=1), torch.cat(dv_halves, dim=1)
        if s < n - 1:
            k_blk, v_blk, dk, dv = _rotate([k_blk, v_blk, dk, dv], axis_name, n)
        else:  # the n-th rotation brings dk and dv home
            dk, dv = _rotate([dk, dv], axis_name, n)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Zigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis_name, sm_scale, block_k):
        out, lse = _zz_fwd_impl(q, k, v, axis_name, sm_scale, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis_name, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return _zz_bwd_impl(q, k, v, out, lse, dout, *ctx.args) + (
            None, None, None)


def zigzag_ring_attention(q, k, v, *, axis_name: str = SEQUENCE_AXIS,
                          sm_scale: Optional[float] = None,
                          block_k: int = 256):
    """Load-balanced CAUSAL ring attention over the zigzag layout: the
    same ring as :func:`ring_attention` over local shards ``[B, 2*Tc, H,
    D]`` of the PERMUTED sequence (``x[:, zigzag_permutation(T, n)]``
    sharded contiguously), so every rank does the same causal work a
    step. The output comes back in the zigzag layout."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.shape[1] % 2:
        raise ValueError(
            "zigzag_ring_attention expects local length 2*Tc (one early + "
            "one late chunk per device); got odd local length "
            f"{q.shape[1]}"
        )
    return _Zigzag.apply(q, k, v, axis_name, float(sm_scale), int(block_k))


def ulysses_attention(q, k, v, *, axis_name: str = SEQUENCE_AXIS,
                      causal: bool = False, sm_scale: Optional[float] = None,
                      attention_fn=None):
    """All-to-all sequence parallelism (DeepSpeed Ulysses): ``[B,
    T_local, H, D]`` shards go to ``[B, T, H/n, D]`` by a tiled all-to-all
    over ``axis_name`` (split heads, concat sequence), attend full-length,
    and come back. Requires ``H % axis size == 0``. K/V may carry fewer
    heads: the exchange moves the smallest head count that splits over
    the axis (repeating to ``lcm(H_kv, n)`` when ``H_kv`` does not), so
    ``attention_fn`` must accept fewer K/V heads than Q (the default
    :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`
    does)."""
    n = spmd.axis_size(axis_name)
    h, h_kv = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"'{axis_name}' axis size ({n}); use ring_attention instead"
        )
    gqa_group(q, k)  # validate divisibility
    if h_kv % n != 0:
        # no head sharding exists at h_kv: repeat only up to lcm(h_kv, n),
        # the smallest head count that splits over the axis and divides h
        target = h_kv * n // math.gcd(h_kv, n)
        factor = target // h_kv
        k, v = rep_group(k, factor), rep_group(v, factor)
    if attention_fn is None:
        from horovod_tpu_torch.ops.flash_attention import flash_attention

        attention_fn = flash_attention

    def seq_to_heads(x):  # [B, T/n, H, D] -> [B, T, H/n, D]
        return spmd.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = attention_fn(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return spmd.all_to_all(out, axis_name, split_axis=1, concat_axis=2)
