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
- :func:`fused_adam` — the same update through the ``fused_adam`` kernel,
  all leaves in one launch (plain version on CPU tensors); states are
  interchangeable;
- :func:`adamw` — optax's ``adamw`` (Adam, decoupled weight decay, then
  ``-lr``), plain PyTorch, same state;
- :func:`DistributedOptimizer` — allreduce mode (Horovod's classic
  gradient allreduce, optionally with error feedback, or Adasum), ZeRO-1
  (``shard_optimizer=True``: flat-packed reduce-scatter, this rank's
  optimizer shard, all-gather of the update shards) or ZeRO-3
  (``shard_params=True``: the parameters themselves are this rank's
  shards, :class:`FsdpParams`, gathered on use).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.compression import (
    MIN_QUANT_ELEMS, Compression, _quantizable, quantize_chunked,
)
from horovod_tpu_torch.ops import collective as _C
from horovod_tpu_torch.ops import kernels as _k
from horovod_tpu_torch.ops import overlap as _ov
from horovod_tpu_torch.ops.adasum import (
    _compressed_adasum, grouped_adasum_allreduce,
)
from horovod_tpu_torch.ops.collective import Adasum, Average, ReduceOp, Sum


class Transform(NamedTuple):
    init: Callable
    update: Callable


class DistributedTransform(NamedTuple):
    """What :func:`DistributedOptimizer` returns: a :class:`Transform`
    that exchanges gradients itself."""

    init: Callable
    update: Callable
    shard_optimizer: bool
    shard_params: bool = False


def tree_keys(tree: dict) -> list:
    """The keys of a flat param dict in JAX's flatten order."""
    return sorted(tree, key=lambda k: tuple(k.split("/")))


def _dtype_key(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# Adam


def _adam_init(params):
    z = lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device)  # noqa: E731
    return {"count": 0, "mu": {k: z(p) for k, p in params.items()},
            "nu": {k: z(p) for k, p in params.items()}}


def _adam(lr, b1, b2, eps, eps_root, step: Callable) -> Transform:
    def update(grads, state, params=None):
        count = state["count"] + 1
        ups, mus, nus = {}, {}, {}
        for k in tree_keys(grads):
            ups[k], mus[k], nus[k] = step(
                grads[k], state["mu"][k], state["nu"][k], count,
                None if params is None else params[k])
        return ups, {"count": count, "mu": mus, "nu": nus}

    return Transform(_adam_init, update)


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
    """Adam through the ``fused_adam`` kernel: moments, bias correction and
    the ``-lr`` step of every leaf in one pass, one launch a step (the
    leaves in :func:`tree_keys` order; ZeRO-1 and ZeRO-3 update one flat
    shard a dtype). The new moments are per-leaf views into two flat
    buffers, the updates into a third: the state is :func:`adam`'s and
    interchangeable with it. On CPU tensors it runs the kernel's plain
    version, which is :func:`adam`'s arithmetic. Only a static float
    learning rate."""
    if callable(learning_rate):
        raise ValueError("fused_adam requires a static float learning_rate")
    lr = float(learning_rate)

    def update(grads, state, params=None):
        count = state["count"] + 1
        keys = tree_keys(grads)
        ups, mus, nus = _k.fused_adam_multi(
            [grads[k] for k in keys], [state["mu"][k] for k in keys],
            [state["nu"][k] for k in keys], count,
            lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root)
        return dict(zip(keys, ups)), {"count": count,
                                      "mu": dict(zip(keys, mus)),
                                      "nu": dict(zip(keys, nus))}

    return Transform(_adam_init, update)


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
# ZeRO-3: the parameters are this rank's shards, gathered on use
#
# A ZeRO-3 step gathers the full tree from the shards before the forward
# (fsdp_gather_params); the gather's backward reduce-scatters the packed
# full gradient, so the gradient arrives as this rank's SUM shard — the
# buffer ZeRO-1's explicit reduce-scatter produces. The update then runs
# on the shard and comes back as a shard: no all-gather, the next step's
# gather sees shards + updates.

FSDP_WIRE_ENV = "HOROVOD_FSDP_WIRE"


def _fsdp_wire() -> str:
    """The parameter-gather wire (``HOROVOD_FSDP_WIRE``): ``none``
    (full-precision all-gather) or ``int8`` (blockwise int8 + bf16
    scales, :func:`~horovod_tpu_torch.ops.collective.quantized_all_gather`).
    Read at every gather."""
    wire = os.environ.get(FSDP_WIRE_ENV, "none").lower()
    if wire not in ("none", "int8"):
        raise ValueError(
            f"{FSDP_WIRE_ENV} must be 'none' or 'int8', got {wire!r}")
    return wire


class _FsdpMeta(NamedTuple):
    """What re-assembles the tree from the shards: the leaves' keys (in
    JAX's flatten order), shapes and dtypes, this rank's place, and the
    ZeRO-1 group plan at that world size. Build with :func:`_fsdp_meta`,
    which computes the plan once."""

    keys: tuple
    shapes: tuple
    dtypes: tuple
    rank: int
    size: int
    groups: dict


class FsdpParams:
    """ZeRO-3 parameters of one rank: ``{group_key: [s]}``, this rank's
    row of each ZeRO-1 group (per-dtype flat buffer ``[N, s]``), plus the
    metadata to re-assemble the tree. Build with :func:`fsdp_pack_params`;
    re-materialize with :func:`fsdp_gather_params` (differentiable, in a
    step) or :func:`fsdp_unpack_params`."""

    __slots__ = ("shards", "meta")

    def __init__(self, shards: dict, meta: _FsdpMeta):
        self.shards = dict(shards)
        self.meta = meta

    def __repr__(self):
        return (f"FsdpParams(groups={sorted(self.shards)}, "
                f"rank={self.meta.rank}, size={self.meta.size})")


def _fsdp_meta(keys, shapes, dtypes, rank: int, size: int) -> _FsdpMeta:
    """The :class:`_FsdpMeta` of a tree of ``shapes``/``dtypes`` packed for
    ``rank`` of ``size``, with its ZeRO-1 group plan."""
    shapes = tuple(tuple(s) for s in shapes)
    dtypes = tuple(dtypes)
    leaves = [torch.empty(s, dtype=d, device="meta")
              for s, d in zip(shapes, dtypes)]
    return _FsdpMeta(tuple(keys), shapes, dtypes, int(rank), int(size),
                     _zero_groups(leaves, size))


def _check_world(fp: FsdpParams) -> None:
    if (fp.meta.rank, fp.meta.size) != (basics.rank(), basics.size()):
        raise ValueError(
            f"{fp!r} was packed for rank {fp.meta.rank} of {fp.meta.size}, "
            f"this is rank {basics.rank()} of {basics.size()}")


def fsdp_pack_params(params: dict) -> FsdpParams:
    """This rank's ZeRO-3 shards of a full parameter tree (the same on
    every rank): each per-dtype group packed flat as ZeRO-1 packs it, and
    this rank's ``[Lp/N]`` row kept. The layout is ZeRO-1's, so
    ``DistributedOptimizer(shard_params=True).init`` gives the ZeRO-1
    state."""
    n, r = basics.size(), basics.rank()
    keys = tree_keys(params)
    leaves = [params[k] for k in keys]
    meta = _fsdp_meta(keys, [l.shape for l in leaves],
                      [l.dtype for l in leaves], r, n)
    shards = {k: _rank_shard(_ov.pack_group(leaves, g), n, r).clone()
              for k, g in meta.groups.items()}
    return FsdpParams(shards, meta)


def _assemble(fp: FsdpParams, fulls: dict) -> dict:
    groups = fp.meta.groups
    flats = {k: fulls[k][:g.L] for k, g in groups.items()}
    leaves = _ov.assemble(flats, groups, fp.meta.shapes, fp.meta.dtypes)
    return dict(zip(fp.meta.keys, leaves))


@torch.no_grad()
def fsdp_unpack_params(fp: FsdpParams) -> dict:
    """The full parameter tree from every rank's shards (a collective:
    one full-precision all-gather per group), outside autograd."""
    _check_world(fp)
    return _assemble(fp, {k: _C.allgather(s) for k, s in fp.shards.items()})


def fsdp_gather_params(fp: FsdpParams, *, wire=None) -> dict:
    """The gather-on-use leg of a ZeRO-3 step: the full tree from the
    shards, one all-gather per group, differentiable (the backward
    reduce-scatters the packed gradient into shard gradients). A group
    rides the int8 wire (``wire="int8"``, default ``HOROVOD_FSDP_WIRE``)
    when its dtype is quantizable and it has at least ``MIN_QUANT_ELEMS``
    elements; otherwise the full-precision gather."""
    _check_world(fp)
    wire = _fsdp_wire() if wire is None else wire
    if wire not in ("none", "int8"):
        raise ValueError(f"wire must be 'none' or 'int8', got {wire!r}")
    fulls = {}
    for key, g in fp.meta.groups.items():
        local = fp.shards[key]
        if wire == "int8" and _quantizable(local.dtype) \
                and g.Lp >= MIN_QUANT_ELEMS:
            fulls[key] = _C.quantized_all_gather(local)
        else:
            fulls[key] = _C.gather_shards(local)
    return _assemble(fp, fulls)


def _fsdp_init(optimizer, params):
    if not isinstance(params, FsdpParams):
        raise TypeError(
            "DistributedOptimizer(shard_params=True).init expects the packed "
            "FsdpParams shards: build them with fsdp_pack_params(params), got "
            f"{type(params).__name__}")
    _check_world(params)
    return {"shard": {"rank": params.meta.rank, "size": params.meta.size},
            "inner": optimizer.init(dict(params.shards))}


def _fsdp_update(grads, state, params, *, optimizer, op):
    """One ZeRO-3 update on this rank: the gradient shards arrive summed
    over ranks (the gather's backward), so divide for Average, run the
    inner optimizer on the shards, and return the update shards as
    :class:`FsdpParams` (no all-gather)."""
    if not isinstance(grads, FsdpParams):
        raise TypeError(
            "DistributedOptimizer(shard_params=True) updates FsdpParams "
            "gradient shards (differentiate through fsdp_gather_params), got "
            f"{type(grads).__name__}")
    n = state["shard"]["size"]
    gshards = dict(grads.shards)
    if op == Average:
        gshards = {k: _C._div(v, n) for k, v in gshards.items()}
    pshards = dict(params.shards) if isinstance(params, FsdpParams) else None
    upd, inner = optimizer.update(gshards, state["inner"], pshards)
    return FsdpParams(upd, grads.meta), {"shard": state["shard"],
                                         "inner": inner}


# --------------------------------------------------------------------------
# DistributedOptimizer


def _adasum_tree(grads: dict, compression) -> dict:
    """Adasum of the whole gradient tree in log2(N) exchanges and combine
    kernels a step, whatever the number of leaves: uncompressed, the
    grouped butterfly over one f32 group buffer; compressed, the butterfly
    over the wire tensors packed in their own (16-bit) type, where each
    leaf is bit-equal to its own ``allreduce(g, Adasum,
    compression=compression)``."""
    keys = tree_keys(grads)
    leaves = [grads[k] for k in keys]
    if compression is Compression.none:
        return dict(zip(keys, grouped_adasum_allreduce(leaves)))
    return dict(zip(keys, _compressed_adasum(leaves, compression)))


def DistributedOptimizer(optimizer: Transform, *, op: ReduceOp = Average,
                         compression=None, error_feedback: bool = False,
                         shard_optimizer: bool = False,
                         shard_params: bool = False) -> DistributedTransform:
    """Wrap ``optimizer`` so each ``update`` first combines the gradients
    across ranks.

    - allreduce mode (default): the gradient tree is allreduced in one
      fused exchange (:func:`~horovod_tpu_torch.ops.collective.grouped_allreduce`:
      one flat ``all_reduce`` per dtype; ``compression=Compression.int8``
      takes the leaves of at least ``MIN_QUANT_ELEMS`` f32 elements
      through one int8 exchange, each leaf bit-equal to its own int8
      allreduce), then the inner optimizer updates the full tree on
      every rank. ``op=Adasum``
      without compression runs one grouped butterfly over the whole tree;
      with ``Compression.fp16`` one butterfly over the leaves packed in
      their 16-bit wire type, each leaf combined in that type as its own
      ``allreduce(g, Adasum, compression=...)`` combines it.
    - ``shard_optimizer=True`` (ZeRO-1): the tree is flat-packed per
      dtype and reduce-scattered; this rank updates only its shard of the
      optimizer state and the update shards are all-gathered. The state
      holds this rank's shard only (``state["shard"]`` names it).
    - ``shard_params=True`` (ZeRO-3): ``init`` takes :class:`FsdpParams`
      and gives the ZeRO-1 state; ``update`` takes the gradient shards
      (the gather's backward reduce-scattered them) and returns update
      shards. The gradient leg is exact: compression and error feedback
      are refused (``HOROVOD_FSDP_WIRE=int8`` compresses the gather).

    ``error_feedback=True`` keeps what the lossy wire rounded away and
    adds it to the next step's gradient (EF-SGD); it needs a lossy
    ``compression``.
    """
    if compression is None:
        compression = Compression.none
    op = ReduceOp(op)
    quantized = getattr(compression, "quantized", False)
    if shard_params:
        if op not in (Average, Sum):
            raise ValueError(
                "shard_params=True (ZeRO-3) supports op=Average/Sum only "
                "(Adasum's pairwise projections have no reduce-scatter "
                "formulation)")
        if compression is not Compression.none:
            raise ValueError(
                "gradient compression does not compose with "
                "shard_params=True: the ZeRO-3 gradient leg is the parameter "
                "gather's transpose, exact by construction. Compress the "
                "parameter GATHER instead (HOROVOD_FSDP_WIRE=int8)")
        if error_feedback:
            raise ValueError(
                "error_feedback needs a lossy gradient wire; the ZeRO-3 "
                "gradient leg is exact (see shard_params)")
        if shard_optimizer:
            raise ValueError(
                "shard_params=True already shards the optimizer state; "
                "pass shard_optimizer=False")
    if error_feedback and compression is Compression.none:
        raise ValueError(
            "error_feedback=True needs a lossy compression (e.g. "
            "Compression.int8); with Compression.none there is no rounding "
            "error to feed back")
    if op == Adasum:
        if error_feedback:
            raise ValueError("error_feedback is not supported with op=Adasum")
        if quantized:
            raise ValueError(
                "quantized compression is not supported with op=Adasum (the "
                "scalar projections have no low-bit reduction formulation)")
        if shard_optimizer:
            raise ValueError(
                "shard_optimizer=True is not supported with op=Adasum (the "
                "pairwise projections have no reduce-scatter formulation)")
    elif (quantized or shard_optimizer) and op not in (Average, Sum):
        raise ValueError(
            f"op={op!r}: the reduce-scatter paths (quantized compression, "
            "shard_optimizer) support Average/Sum only")

    def _roundtrip(g):
        c, ctx = compression.compress(g)
        return compression.decompress(c, ctx)

    def _reduce(grads, residuals=False):
        """The reduced tree (and with ``residuals`` each leaf's ``g -
        roundtrip(g)`` from the same quantize pass): one int8 exchange per
        quantizable dtype and one flat ``all_reduce`` per other dtype a
        step, or Adasum's butterfly."""
        keys = tree_keys(grads)
        if op == Adasum:
            return _adasum_tree(grads, compression), None
        outs, res = _C._grouped_allreduce([grads[k] for k in keys], op,
                                          compression, residuals=residuals)
        return dict(zip(keys, outs)), (dict(zip(keys, res)) if residuals
                                       else None)

    def init(params):
        if shard_params:
            return _fsdp_init(optimizer, params)
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
        if shard_params:
            return _fsdp_update(grads, state, params, optimizer=optimizer,
                                op=op)
        if shard_optimizer:
            return _zero_update(
                grads, state, params, optimizer=optimizer,
                compression=compression, error_feedback=error_feedback,
                op=op, roundtrip=_roundtrip)
        if error_feedback:
            corrected = {k: grads[k] + state["residual"][k]
                         for k in tree_keys(grads)}
            # the residual is what the wire rounds away: the exchange
            # quantizes `corrected` once, for the wire and the residual
            reduced, residual = _reduce(corrected, residuals=True)
            updates, inner = optimizer.update(reduced, state["inner"], params)
            return updates, {"inner": inner, "residual": residual}
        return optimizer.update(_reduce(grads)[0], state, params)

    return DistributedTransform(init, update, bool(shard_optimizer),
                                bool(shard_params))


@torch.no_grad()
def broadcast_parameters(params: dict, root_rank: int = 0) -> dict:
    """Overwrite every parameter in place with ``root_rank``'s value
    (tensors may be views: the copy writes through them)."""
    for k in tree_keys(params):
        params[k].copy_(_C.broadcast(params[k], root_rank))
    return params


def _map_state(fn, x):
    """``fn`` of every leaf of a state tree: dicts, lists and tuples
    (named ones included) are descended into and rebuilt with their own
    type; everything else is a leaf."""
    if isinstance(x, dict):
        return type(x)((k, _map_state(fn, v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        items = [_map_state(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return fn(x)


def broadcast_optimizer_state(state, root_rank: int = 0):
    """``root_rank``'s optimizer state on every rank, as the JAX package
    maps it: tensors through :func:`broadcast`, every other leaf (ints,
    floats, strings, ``None``, ...) through :func:`broadcast_object`, so
    it arrives exact. A ZeRO-1 state (``state["shard"]``) is returned as
    it is: each rank's shard is its own authoritative state, and
    broadcasting root's row would corrupt the others."""
    if isinstance(state, dict) and "shard" in state:
        return state

    def one(x):
        if isinstance(x, torch.Tensor):
            return _C.broadcast(x, root_rank)
        return _C.broadcast_object(x, root_rank)

    return _map_state(one, state)
