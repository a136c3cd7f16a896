"""Optimizers and the distributed optimizer wrapper.

Counterpart of ``horovod_tpu/optim.py``, in its functional shape: an
optimizer is a :class:`Transform` of ``init(params) -> state`` and
``update(grads, state, params=None) -> (updates, state)``, over dicts of
tensors in place of pytrees. Updates are to be *added* to the parameters
(optax's ``apply_updates``).

Leaf order is the JAX package's: a dict's keys sorted by their
``/``-separated path (``jax.tree_util`` flattens dicts in sorted key
order), so flat packings hold the same elements in the same places —
which the int8 wire needs, since its 256-element scale blocks are
layout-dependent.

- :func:`adam` — plain PyTorch Adam in optax's ``scale_by_adam ->
  scale(-lr)`` expression order;
- :func:`fused_adam` — the same update through the ``fused_adam`` kernel
  (plain version on CPU tensors); states are interchangeable;
- :func:`adamw` — optax's ``adamw`` (Adam, decoupled weight decay, then
  ``-lr``), plain PyTorch, same state;
- :func:`DistributedOptimizer` — allreduce mode (Horovod's classic
  gradient allreduce, optionally with error feedback) or ZeRO-1
  (``shard_optimizer=True``: flat-packed reduce-scatter, this rank's
  optimizer shard, all-gather of the update shards).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.compression import (
    Compression, _quantizable, quantize_chunked,
)
from horovod_tpu_torch.ops import collective as _C
from horovod_tpu_torch.ops import kernels as _k
from horovod_tpu_torch.ops import overlap as _ov
from horovod_tpu_torch.ops.collective import Average, ReduceOp, Sum


class Transform(NamedTuple):
    init: Callable
    update: Callable


class DistributedTransform(NamedTuple):
    """What :func:`DistributedOptimizer` returns: a :class:`Transform`
    that exchanges gradients itself."""

    init: Callable
    update: Callable
    shard_optimizer: bool


def tree_keys(tree: dict) -> list:
    """The keys of a flat param dict in JAX's flatten order."""
    return sorted(tree, key=lambda k: tuple(k.split("/")))


def _dtype_key(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# Adam


def _adam(lr, b1, b2, eps, eps_root, step: Callable) -> Transform:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device)  # noqa: E731
        return {"count": 0, "mu": {k: z(p) for k, p in params.items()},
                "nu": {k: z(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        count = state["count"] + 1
        ups, mus, nus = {}, {}, {}
        for k in tree_keys(grads):
            ups[k], mus[k], nus[k] = step(
                grads[k], state["mu"][k], state["nu"][k], count,
                None if params is None else params[k])
        return ups, {"count": count, "mu": mus, "nu": nus}

    return Transform(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Transform:
    """Plain PyTorch Adam, expression for expression optax's
    ``adam`` (``scale_by_adam -> scale(-lr)``), each operation rounded
    on its own. The state is ``{"count", "mu", "nu"}``."""
    lr = float(learning_rate)

    def step(g, mu, nu, count, p):
        c = _k.adam_constants(lr, b1, b2, eps, eps_root, count)
        return _k.fused_adam_plain(g, mu, nu, c)

    return _adam(lr, b1, b2, eps, eps_root, step)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> Transform:
    """Plain PyTorch AdamW, expression for expression optax's ``adamw``:
    ``chain(scale_by_adam, add_decayed_weights(weight_decay),
    scale(-lr))``, i.e. ``-lr * (adam_direction + weight_decay * p)``,
    each operation rounded on its own. Same state as :func:`adam`;
    ``update`` needs the parameters."""
    lr = float(learning_rate)
    wd = float(np.float32(weight_decay))

    def step(g, mu, nu, count, p):
        if p is None:
            raise ValueError("adamw's weight decay needs params: call "
                             "update(grads, state, params)")
        c = _k.adam_constants(lr, b1, b2, eps, eps_root, count)
        # the Adam direction: the plain Adam update with -lr set to 1,
        # which multiplies exactly
        d, mu2, nu2 = _k.fused_adam_plain(g, mu, nu, dict(c, neg_lr=1.0))
        return c["neg_lr"] * (d + wd * p), mu2, nu2

    return _adam(lr, b1, b2, eps, eps_root, step)


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, eps_root: float = 0.0) -> Transform:
    """Adam as one ``fused_adam`` kernel launch per leaf (per shard under
    ZeRO-1): moments, bias correction and the ``-lr`` step in one pass.
    Same state as :func:`adam`; on CPU tensors it runs the kernel's plain
    version, which is :func:`adam`'s arithmetic. Only a static float
    learning rate."""
    if callable(learning_rate):
        raise ValueError("fused_adam requires a static float learning_rate")
    lr = float(learning_rate)

    def step(g, mu, nu, count, p):
        u, m, v = _k.fused_adam_update(
            g.reshape(-1), mu.reshape(-1), nu.reshape(-1), count,
            lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root)
        return u.view(g.shape), m.view(mu.shape), v.view(nu.shape)

    return _adam(lr, b1, b2, eps, eps_root, step)


# --------------------------------------------------------------------------
# ZeRO-1: flat-packed reduce-scatter, sharded optimizer state, all-gather


def _zero_spec(leaves, n: int):
    """Per-dtype flat packing plan ``{dtype_key: (idxs, sizes, shapes, L,
    Lp)}``, dtypes in first-seen order, ``Lp`` padded to a multiple of
    ``n``."""
    order, groups = [], {}
    for i, leaf in enumerate(leaves):
        k = _dtype_key(leaf.dtype)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(i)
    spec = {}
    for k in order:
        idxs = groups[k]
        shapes = [tuple(leaves[i].shape) for i in idxs]
        sizes = [leaves[i].numel() for i in idxs]
        L = int(sum(sizes))
        spec[k] = (idxs, sizes, shapes, L, L + (-L) % n)
    return spec


def _zero_groups(leaves, n: int):
    """One whole-leaf :class:`~horovod_tpu_torch.ops.overlap.Bucket` per
    dtype (keys = dtype names, the JAX package's state layout)."""
    groups = {}
    for k, (idxs, sizes, _shapes, L, Lp) in _zero_spec(leaves, n).items():
        segs = tuple(_ov.Segment(i, 0, sz) for i, sz in zip(idxs, sizes))
        groups[k] = _ov.Bucket(key=k, dtype=k, segs=segs, L=L, Lp=Lp)
    return groups


def _rank_shard(flat, n: int, r: int):
    s = flat.shape[0] // n
    return flat[r * s:(r + 1) * s]


def _zero_init(optimizer, params, n: int, r: int, *, error_feedback: bool):
    """This rank's ZeRO-1 state: the inner optimizer initialized on this
    rank's row of each per-dtype ``[N, shard]`` flat buffer, plus (with
    error feedback) the ``[Lp]`` per-dtype residuals."""
    leaves = [params[k] for k in tree_keys(params)]
    groups = _zero_groups(leaves, n)
    shards = {k: _rank_shard(_ov.pack_group(leaves, g), n, r).clone()
              for k, g in groups.items()}
    state = {"shard": {"rank": r, "size": n},
             "inner": optimizer.init(shards)}
    if error_feedback:
        state["residual"] = {
            k: torch.zeros(g.Lp, dtype=shards[k].dtype, device=shards[k].device)
            for k, g in groups.items()}
    return state


def _zero_update(grads, state, params, *, optimizer, compression,
                 error_feedback, op, roundtrip):
    """One ZeRO-1 update on this rank (the reference's bound-axis branch):
    pack, (error-feedback correct,) reduce-scatter — the int8 exchange
    for quantizable groups, with ONE quantize pass serving both the
    residual and the wire — update this rank's shard, all-gather the
    update shards, unpack."""
    n, r = state["shard"]["size"], state["shard"]["rank"]
    quantized = getattr(compression, "quantized", False)
    qblock = int(getattr(compression, "block", 0) or 0)
    keys = tree_keys(grads)
    leaves = [grads[k] for k in keys]
    p_leaves = [params[k] for k in keys] if params is not None else None
    groups = _zero_groups(leaves, n)
    residual = state.get("residual")
    gshards, pshards, new_residual = {}, ({} if p_leaves else None), {}
    for key, g in groups.items():
        qgroup = (quantized and _quantizable(leaves[g.segs[0].idx].dtype)
                  and g.Lp >= int(getattr(compression, "min_quant_elems", 0)))
        flat = _ov.pack_group(leaves, g)
        pre = None
        if error_feedback:
            corrected = flat + residual[key]
            if qgroup:
                q_w, sc_w, rt = quantize_chunked(corrected, n, qblock)
                pre = (q_w, sc_w)
            else:
                rt = roundtrip(corrected)
            new_residual[key] = corrected - rt
            send = corrected
        else:
            send = flat
        if qgroup:
            shard = _C.quantized_psum_scatter(send, block=qblock, pre=pre)
            ctx = None
        else:
            comp, ctx = compression.compress(send)
            shard = _C.reducescatter(comp, Sum)
        if op == Average:
            shard = _C._div(shard, n)
        if not qgroup:
            shard = compression.decompress(shard, ctx)
        gshards[key] = shard
        if p_leaves is not None:
            pshards[key] = _rank_shard(_ov.pack_group(p_leaves, g), n, r)
    upd_shards, new_inner = optimizer.update(gshards, state["inner"], pshards)

    # gather leg: one all-gather per dtype of this rank's update shard
    full_flats = {}
    for key, g in groups.items():
        s = g.Lp // n
        gat = _C.allgather(upd_shards[key].reshape(-1))
        full_flats[key] = gat.reshape(n, s).reshape(-1)[:g.L]
    out_leaves = _ov.assemble(full_flats, groups,
                              [tuple(l.shape) for l in leaves],
                              [l.dtype for l in leaves])
    new_state = {"shard": state["shard"], "inner": new_inner}
    if error_feedback:
        new_state["residual"] = new_residual
    return dict(zip(keys, out_leaves)), new_state


# --------------------------------------------------------------------------
# DistributedOptimizer


def DistributedOptimizer(optimizer: Transform, *, op: ReduceOp = Average,
                         compression=None, error_feedback: bool = False,
                         shard_optimizer: bool = False) -> DistributedTransform:
    """Wrap ``optimizer`` so each ``update`` first combines the gradients
    across ranks.

    - allreduce mode (default): every gradient leaf is allreduced
      (``compression=Compression.int8`` rides the int8 exchange for
      leaves of at least ``MIN_QUANT_ELEMS`` f32 elements), then the
      inner optimizer updates the full tree on every rank.
    - ``shard_optimizer=True`` (ZeRO-1): the tree is flat-packed per
      dtype and reduce-scattered; this rank updates only its shard of the
      optimizer state and the update shards are all-gathered. The state
      holds this rank's shard only (``state["shard"]`` names it).

    ``error_feedback=True`` keeps what the lossy wire rounded away and
    adds it to the next step's gradient (EF-SGD); it needs a lossy
    ``compression``.
    """
    if compression is None:
        compression = Compression.none
    op = ReduceOp(op)
    quantized = getattr(compression, "quantized", False)
    if error_feedback and compression is Compression.none:
        raise ValueError(
            "error_feedback=True needs a lossy compression (e.g. "
            "Compression.int8); with Compression.none there is no rounding "
            "error to feed back")
    if (quantized or shard_optimizer) and op not in (Average, Sum):
        raise ValueError(
            f"op={op!r} is supported only without quantized compression "
            "and without shard_optimizer")

    def _roundtrip(g):
        c, ctx = compression.compress(g)
        return compression.decompress(c, ctx)

    def init(params):
        if shard_optimizer:
            return _zero_init(optimizer, params, basics.size(), basics.rank(),
                              error_feedback=error_feedback)
        inner = optimizer.init(params)
        if error_feedback:
            return {"inner": inner,
                    "residual": {k: torch.zeros(p.shape, dtype=p.dtype,
                                                device=p.device)
                                 for k, p in params.items()}}
        return inner

    def update(grads, state, params=None):
        if shard_optimizer:
            return _zero_update(
                grads, state, params, optimizer=optimizer,
                compression=compression, error_feedback=error_feedback,
                op=op, roundtrip=_roundtrip)
        keys = tree_keys(grads)
        if error_feedback:
            corrected = {k: grads[k] + state["residual"][k] for k in keys}
            # the residual is what the wire will round away: the
            # allreduce below compresses `corrected` itself
            residual = {k: c - _roundtrip(c) for k, c in corrected.items()}
            reduced = {k: _C.allreduce(corrected[k], op, compression=compression)
                       for k in keys}
            updates, inner = optimizer.update(reduced, state["inner"], params)
            return updates, {"inner": inner, "residual": residual}
        reduced = {k: _C.allreduce(grads[k], op, compression=compression)
                   for k in keys}
        return optimizer.update(reduced, state, params)

    return DistributedTransform(init, update, bool(shard_optimizer))


@torch.no_grad()
def broadcast_parameters(params: dict, root_rank: int = 0) -> dict:
    """Overwrite every parameter in place with ``root_rank``'s value
    (tensors may be views: the copy writes through them)."""
    for k in tree_keys(params):
        params[k].copy_(_C.broadcast(params[k], root_rank))
    return params


def broadcast_optimizer_state(state, root_rank: int = 0):
    """``root_rank``'s optimizer state on every rank. A ZeRO-1 state
    (``state["shard"]``) is returned as it is: each rank's shard is its
    own authoritative state, and broadcasting root's row would corrupt
    the others."""
    if isinstance(state, dict) and "shard" in state:
        return state
    dev = basics.device()

    def one(x):
        if isinstance(x, torch.Tensor):
            return _C.broadcast(x, root_rank)
        if isinstance(x, (int, float)):
            t = torch.tensor(x, device=dev)
            return type(x)(_C.broadcast(t, root_rank).item())
        return x

    return _tree_map(one, state)
