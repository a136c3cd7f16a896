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
- :func:`sgd` — optax's ``sgd`` (momentum ``trace``, then ``-lr``), plain
  PyTorch, and :func:`inject_hyperparams`, optax's, which keeps a
  factory's hyperparameters (the learning rate) in its state as host
  floats;
- :func:`DistributedOptimizer` — allreduce mode (Horovod's classic
  gradient allreduce, optionally with error feedback, or Adasum), ZeRO-1
  (``shard_optimizer=True``: flat-packed reduce-scatter, this rank's
  optimizer shard, all-gather of the update shards) or ZeRO-3
  (``shard_params=True``: the parameters themselves are this rank's
  shards, :class:`FsdpParams`, gathered on use); bucketed overlap
  (``overlap=True``: one exchange a bucket, launched from the backward
  through a :class:`BucketExchange`), PowerSGD, the gradient predivide
  and ``backward_passes_per_step`` (:func:`multi_steps`, optax's
  ``MultiSteps``);
- :class:`DistributedGradientTape` — a gradient function's gradients
  combined across ranks.

``DistributedOptimizer(numerics_guard=True)`` or ``loss_scale=`` wraps
the optimizer in the numerics guard
(:mod:`horovod_tpu_torch.resilience.numerics`), outermost;
:func:`distributed_transform` sees through it.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from horovod_tpu_torch import basics, pytree
from horovod_tpu_torch.compression import (
    INT8_BLOCK, MIN_QUANT_ELEMS, Compression, _quantizable, quantize_chunked,
)
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.ops import collective as _C
from horovod_tpu_torch.ops import kernels as _k
from horovod_tpu_torch.ops import overlap as _ov
from horovod_tpu_torch.ops.adasum import (
    _compressed_adasum, grouped_adasum_allreduce,
)
from horovod_tpu_torch.ops.collective import Adasum, Average, ReduceOp, Sum
from horovod_tpu_torch.resilience import numerics as _numerics


class Transform(NamedTuple):
    init: Callable
    update: Callable


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
        # optax's constants in the leaf's type
        return (_k._adam_scalar(c["neg_lr"], g)
                * (d + _k._adam_scalar(wd, g) * p)), mu2, nu2

    return _adam(lr, b1, b2, eps, eps_root, step)


def fused_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, eps_root: float = 0.0) -> Transform:
    """Adam through the ``fused_adam`` kernel: moments, bias correction and
    the ``-lr`` step of every leaf in one pass, one launch a step (the
    leaves in :func:`tree_keys` order; ZeRO-1 and ZeRO-3 update one flat
    shard a dtype). The new moments are per-leaf views into two flat
    buffers, the updates into a third: the state is :func:`adam`'s and
    interchangeable with it. On CPU tensors it runs the kernel's plain
    version, which is :func:`adam`'s arithmetic. A float learning rate:
    to change it during a run, build the optimizer with
    :func:`inject_hyperparams`."""
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


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Transform:
    """Plain PyTorch SGD, expression for expression optax's ``sgd``:
    ``chain(trace(decay=momentum, nesterov), scale(-lr))``, each
    operation rounded on its own, the constants in the leaf's type. The
    state is ``{"trace": {leaf: tensor}}`` (optax's ``TraceState``), or
    ``{}`` without momentum; :func:`horovod_tpu_torch.callbacks.
    scale_momentum` rescales its ``trace``."""
    lr = float(learning_rate)

    def init(params):
        if momentum is None:
            return {}
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        keys = tree_keys(grads)
        d, new = dict(grads), {}
        if momentum is not None:
            trace = {}
            for k in keys:
                g, decay = grads[k], _k._adam_scalar(momentum, grads[k])
                trace[k] = g + decay * state["trace"][k]
                d[k] = g + decay * trace[k] if nesterov else trace[k]
            new = {"trace": trace}
        return {k: _k._adam_scalar(-lr, d[k]) * d[k] for k in keys}, new

    return Transform(init, update)


def _host_float(x) -> float:
    """A hyperparameter as a host float (a restored one may come back as
    an array or a 0-d tensor: read once, kept as a float after)."""
    if isinstance(x, torch.Tensor):
        return float(x.item())
    return float(np.asarray(x))


def inject_hyperparams(factory: Callable):
    """optax's ``inject_hyperparams``: ``inject_hyperparams(fused_adam)(
    learning_rate=1e-3)`` is the optimizer ``factory(**hyperparams)``
    whose numeric hyperparameters live in its state, ``{"count",
    "hyperparams": {name: float}, "inner_state"}``, as host floats, so a
    callback can change them between updates
    (:func:`horovod_tpu_torch.callbacks.apply_lr`); the others
    (``nesterov``) are static arguments, as in optax. Each update builds
    ``factory`` with the state's values: under ``fused_adam`` the
    learning rate reaches the kernel as its ``neg_lr`` argument, so a new
    value costs nothing and rebuilds nothing."""

    def make(**hyperparams) -> Transform:
        static = {k: v for k, v in hyperparams.items()
                  if isinstance(v, bool) or not isinstance(
                      v, (int, float, np.number, np.ndarray, torch.Tensor))}

        def init(params):
            hp = {k: _host_float(v) for k, v in hyperparams.items()
                  if k not in static}
            return {"count": 0, "hyperparams": hp,
                    "inner_state": factory(**hp, **static).init(params)}

        def update(grads, state, params=None):
            hp = {k: _host_float(v) for k, v in state["hyperparams"].items()}
            ups, inner = factory(**hp, **static).update(
                grads, state["inner_state"], params)
            return ups, {"count": int(state["count"]) + 1,
                         "hyperparams": hp, "inner_state": inner}

        return Transform(init, update)

    return make


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


def _zero_groups(leaves, n: int, bucket_bytes=None):
    """The ZeRO-1 exchange groups, as
    :class:`~horovod_tpu_torch.ops.overlap.Bucket`: one whole-leaf group
    per dtype (keys = dtype names), or with ``bucket_bytes`` the
    :class:`~horovod_tpu_torch.ops.overlap.BucketPlan`'s buckets (keys
    ``dtype#k``) — the JAX package's state layouts."""
    if bucket_bytes:
        return _ov.plan_for(leaves, n, bucket_bytes).groups
    groups = {}
    for k, (idxs, sizes, _shapes, L, Lp) in _zero_spec(leaves, n).items():
        segs = tuple(_ov.Segment(i, 0, sz) for i, sz in zip(idxs, sizes))
        groups[k] = _ov.Bucket(key=k, dtype=k, segs=segs, L=L, Lp=Lp)
    return groups


def _rank_shard(flat, n: int, r: int):
    s = flat.shape[0] // n
    return flat[r * s:(r + 1) * s]


def _zero_init(optimizer, params, n: int, r: int, *, error_feedback: bool,
               compression=None, bucket_bytes=None):
    """This rank's ZeRO-1 state: the inner optimizer initialized on this
    rank's row of each group's ``[N, shard]`` flat buffer, plus (with
    error feedback) the ``[Lp]`` residual of each group and, under
    PowerSGD, the warm-start ``Q`` of each factorized leaf."""
    leaves = [params[k] for k in tree_keys(params)]
    groups = _zero_groups(leaves, n, bucket_bytes)
    shards = {k: _rank_shard(_ov.pack_group(leaves, g), n, r).clone()
              for k, g in groups.items()}
    state = {"shard": {"rank": r, "size": n},
             "inner": optimizer.init(shards)}
    if error_feedback:
        state["residual"] = {
            k: torch.zeros(g.Lp, dtype=shards[k].dtype, device=shards[k].device)
            for k, g in groups.items()}
    if getattr(compression, "factorized", False):
        state["q"] = _powersgd_q_init(params, compression)
    return state


def _zero_bucket(flat, key, g, *, residual, n, op, compression, predivide,
                 roundtrip, pair=False):
    """One ZeRO-1 group's exchange on this rank: (error-feedback correct,)
    reduce-scatter — the int8 exchange for a quantizable group, whose one
    quantize pass serves the residual and the wire — and divide for
    Average. On the host mesh's axis pair (``pair``) a quantizable group
    takes the JAX package's tuple-axis route instead: the int8 exchange
    needs one axis, so its chunk-aligned roundtrip goes through the plain
    reduce-scatter. Returns ``(this rank's [Lp/N] gradient shard, new
    residual or None)``."""
    quantized = getattr(compression, "quantized", False)
    qgroup = (quantized and _quantizable(flat.dtype)
              and g.Lp >= int(getattr(compression, "min_quant_elems", 0)))
    pre = res = rt = None
    send = flat
    if residual is not None:
        send = flat + residual[key]
        if qgroup:
            q_w, sc_w, rt = quantize_chunked(send, n, int(compression.block))
            pre = (q_w, sc_w)
        else:
            rt = roundtrip(send)
        res = send - rt
    pdiv = op == Average and predivide != 1.0
    if pdiv:
        send = _ov._predivide(send, predivide)
    if qgroup and pair:
        if rt is None:
            rt = quantize_chunked(send, n, int(compression.block))[2]
        shard = _C.reducescatter(rt, Sum)
    elif qgroup:
        shard = _C.quantized_psum_scatter(send, block=int(compression.block),
                                          pre=pre)
    else:
        comp, ctx = compression.compress(send)
        shard = _C.reducescatter(comp, Sum)
    if op == Average and not pdiv:
        shard = _C._div(shard, n)          # on the wire's dtype, as JAX
    if not qgroup:
        shard = compression.decompress(shard, ctx)
    if pdiv:
        shard = shard * torch.tensor(predivide / n, dtype=shard.dtype,
                                     device=shard.device)
    return shard, res


def _zero_update(grads, state, params, *, optimizer, compression,
                 error_feedback, op, predivide, roundtrip, bucket_bytes=None,
                 started=None, pair=False):
    """One ZeRO-1 update on this rank (the reference's bound-axis branch):
    each group (a dtype, or with ``bucket_bytes`` a bucket) packed and
    reduce-scattered by :func:`_zero_bucket` — or taken from ``started``,
    a :class:`BucketExchange` that ran them during the backward — then
    the inner optimizer on this rank's shards (one update over every
    group), and the update shards back through ONE all-gather per dtype
    (this rank's shards of a dtype's buckets concatenated first)."""
    if state.get("q") is not None:
        return _zero_update_powersgd(grads, state, params,
                                     optimizer=optimizer,
                                     compression=compression, op=op)
    n, r = state["shard"]["size"], state["shard"]["rank"]
    keys = tree_keys(grads)
    leaves = [grads[k] for k in keys]
    groups = _zero_groups(leaves, n, bucket_bytes)
    if started is None:
        started = {key: _zero_bucket(
            _ov.pack_group(leaves, g), key, g,
            residual=state.get("residual") if error_feedback else None, n=n,
            op=op, compression=compression, predivide=predivide,
            roundtrip=roundtrip, pair=pair) for key, g in groups.items()}
    gshards = {k: started[k][0] for k in groups}
    pshards = None
    if params is not None:
        p_leaves = [params[k] for k in keys]
        pshards = {k: _rank_shard(_ov.pack_group(p_leaves, g), n, r)
                   for k, g in groups.items()}
    upd_shards, new_inner = optimizer.update(gshards, state["inner"], pshards)
    full_flats = _gather_updates(upd_shards, groups, n)
    out_leaves = _ov.assemble(full_flats, groups,
                              [tuple(l.shape) for l in leaves],
                              [l.dtype for l in leaves])
    new_state = {"shard": state["shard"], "inner": new_inner}
    if error_feedback:
        new_state["residual"] = {k: started[k][1] for k in groups}
    return dict(zip(keys, out_leaves)), new_state


def _gather_updates(upd_shards: dict, groups: dict, n: int) -> dict:
    """The gather leg: per dtype, this rank's update shards of its groups
    concatenated, one all-gather, and each group's ``[L]`` sliced back out
    of the ``[N, S]`` rows."""
    by_dtype: dict = {}
    for key, g in groups.items():
        by_dtype.setdefault(g.dtype, []).append(key)
    full = {}
    for keys in by_dtype.values():
        cats = [upd_shards[k].reshape(-1) for k in keys]
        cat = cats[0] if len(cats) == 1 else torch.cat(cats)
        rows = _C.allgather(cat).view(n, -1)
        off = 0
        for k in keys:
            s = groups[k].Lp // n
            full[k] = rows[:, off:off + s].reshape(-1)[:groups[k].L]
            off += s
    return full


# --------------------------------------------------------------------------
# ZeRO-1 state across world sizes
#
# A rank's ZeRO-1 state is its own row: {"shard": {"rank", "size"},
# "inner": {"count", "mu": {group: [s]}, "nu"}, "residual": {group: [Lp]},
# "q": {leaf: [m, r] | None} (PowerSGD)}, a group being a dtype or, under
# overlap, a bucket ("dtype#k"). checkpoint.save writes the consolidated
# view, every rank's row stacked as the JAX package holds it: {"shard":
# {"size": N}, "inner": {"count": [N], "mu": {group: [N, s]}, ...},
# "residual": {group: [N, Lp]}, "q": {leaf: [N, m, r] | None}}.


def is_zero1_rows(state) -> bool:
    """Is ``state`` a consolidated ZeRO-1 state (``shard`` names only the
    world size: the rows of every rank)?"""
    return (isinstance(state, dict) and "inner" in state
            and isinstance(state.get("shard"), dict)
            and set(state["shard"]) == {"size"})


def _leaf_sigs(params) -> list:
    """``[(shape, dtype name)]`` of ``params`` in :func:`tree_keys` order:
    a flat dict of tensors or host arrays (``|V2`` is bf16), or
    :class:`FsdpParams`."""
    if isinstance(params, FsdpParams):
        return [(tuple(s), _dtype_key(d))
                for s, d in zip(params.meta.shapes, params.meta.dtypes)]
    sigs = []
    for k in tree_keys(params):
        p = params[k]
        if isinstance(p, torch.Tensor):
            sigs.append((tuple(p.shape), _dtype_key(p.dtype)))
        else:
            p = np.asarray(p)
            sigs.append((tuple(p.shape), "bfloat16" if p.dtype == np.dtype("V2")
                         else str(p.dtype)))
    return sigs


def _group_lengths(params) -> dict:
    """``{dtype: L}``, the true packed length of each per-dtype ZeRO-1
    group of ``params``."""
    lengths: dict = {}
    for shape, dt in _leaf_sigs(params):
        lengths[dt] = lengths.get(dt, 0) + int(np.prod(shape, dtype=np.int64))
    return lengths


def _is_bucket_key(k) -> bool:
    """Exactly the bucket keys ``dtype#k`` (a parameter whose name holds a
    ``#`` is not one)."""
    if not isinstance(k, str) or "#" not in k:
        return False
    dt, _, idx = k.rpartition("#")
    return idx.isdigit() and isinstance(getattr(torch, dt, None), torch.dtype)


def _bucket_lengths(state, params, bucket_bytes) -> dict:
    """``{bucket key: L}`` of a bucketed state's plan, re-derived from
    ``params`` and ``bucket_bytes`` (default the env's); raises, as the
    JAX package does, when the state's keys or row lengths are not that
    plan's."""
    plan = _ov.plan_for(_leaf_sigs(params), 1,
                        bucket_bytes or _ov.bucket_bytes_from_env())
    exact = {b.key: b.L for b in plan.buckets}

    def mismatch(detail):
        raise ValueError(
            "bucketed (overlap) optimizer state does not match the "
            f"re-derived BucketPlan ({detail}); reshard with the SAME "
            "HOROVOD_BUCKET_BYTES (or pass bucket_bytes=) the state was "
            "trained with")

    keys = {k for k in _dict_keys(state) if _is_bucket_key(k)}
    unknown = sorted(keys - set(exact))
    if unknown:
        mismatch(f"unknown bucket keys {unknown}")

    def check(x, key):
        if isinstance(x, dict):
            for k, v in x.items():
                check(v, k if k in exact else key)
        elif isinstance(x, (list, tuple)):
            for v in x:
                check(v, key)
        elif key is not None and np.ndim(x) == 2:
            rows, width = np.shape(x)
            L = exact[key]
            Lp = L + (-L) % rows
            if width not in (Lp, Lp // rows):
                mismatch(f"buffer {key} has row length {width}, expected "
                         f"{Lp} or {Lp // rows}")

    check({k: v for k, v in state.items() if k in ("inner", "residual")}, None)
    return exact


def _sum_rows(x: np.ndarray, n_new: int) -> np.ndarray:
    """``x.sum(axis=0) / n_new`` as the JAX package computes it: rows
    added in order in f32 (bf16 rows widened, the sum rounded back), then
    the divide in f32 (for bf16, rounded again)."""
    from horovod_tpu_torch.training import host_array, host_tensor

    bf16 = x.dtype == np.dtype("V2")
    rows = host_tensor(x).float().numpy() if bf16 else x
    total = np.zeros(rows.shape[1], rows.dtype)
    for row in rows:
        total = total + row
    if bf16:
        total = torch.from_numpy(total).bfloat16().float().numpy()
    total = total / np.asarray(n_new, total.dtype)
    return host_array(torch.from_numpy(total).bfloat16()) if bf16 else total


def reshard_optimizer_state(state, params, *, to_size=None,
                            bucket_bytes=None):
    """Re-pack a consolidated ZeRO-1 state (:func:`is_zero1_rows`, host
    arrays as :func:`~horovod_tpu_torch.checkpoint.restore` returns them)
    for ``to_size`` ranks (default the world's size), as the JAX package's
    ``reshard_optimizer_state`` does: each ``[N, s]`` row buffer of a
    group is unpadded to the group's true length (from ``params``, the
    tree the state was built on), re-padded for ``to_size`` and reshaped
    ``[to_size, s']``; a per-rank scalar (``count``, ``[N]``) and
    PowerSGD's ``Q`` (``[N, m, r]``, identical rows) are re-tiled from row
    0; the error-feedback residuals ``[N, Lp]`` are summed over the old
    ranks and the sum spread evenly over the new ones (the gradient mass
    the old ranks still owed is kept); other leaves pass through. A
    bucketed state (``dtype#k`` groups, ``overlap=True``) is re-packed by
    the plan of ``params`` at ``bucket_bytes`` (default the
    ``HOROVOD_BUCKET_BYTES`` resolution: reshard with the knob the state
    was trained with; another one raises). A ``NumericsGuardState`` has
    its ``inner`` re-packed and its scalars carried through, ``rank_norms``
    (one step deep) re-created as zeros at the new size, as the JAX
    package does. Any other state is returned as it is."""
    if isinstance(state, _numerics.NumericsGuardState):
        n = int(to_size) if to_size is not None else basics.size()
        rank_norms = state.rank_norms
        if tuple(np.shape(rank_norms)) != (n,):
            rank_norms = (torch.zeros(n, dtype=torch.float32,
                                      device=rank_norms.device)
                          if isinstance(rank_norms, torch.Tensor)
                          else np.zeros((n,), np.float32))
        return state._replace(
            inner=reshard_optimizer_state(state.inner, params, to_size=to_size,
                                          bucket_bytes=bucket_bytes),
            rank_norms=rank_norms)
    if not is_zero1_rows(state):
        return state
    from horovod_tpu_torch.training import host_snapshot

    n_new = int(to_size) if to_size is not None else basics.size()
    n_old = int(state["shard"]["size"])
    if bucket_bytes is None and isinstance(params, FsdpParams):
        bucket_bytes = params.meta.bucket_bytes
    lengths = _group_lengths(params)
    if any(_is_bucket_key(k) for k in _dict_keys(state)):
        lengths = _bucket_lengths(state, params, bucket_bytes)
    unknown = sorted(set(state.get("residual", {})) - set(lengths))
    if unknown:
        raise ValueError(f"residual groups {unknown} are not groups of params "
                         f"{sorted(lengths)}")
    if n_old == n_new:
        return state
    state = host_snapshot(state)

    def repad(flat, L):
        pad = (-L) % n_new
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        return flat

    def one(x, group):
        shape = np.shape(x)
        if group is not None and len(shape) == 2 and shape[0] == n_old:
            L = lengths[group]
            if n_old * shape[1] == L + (-L) % n_old:
                return repad(x.reshape(-1)[:L], L).reshape(n_new, -1)
        if len(shape) == 1 and shape[0] == n_old:
            return np.broadcast_to(x[:1], (n_new,)).copy()
        return x

    def walk(x, group=None):        # the innermost group key names x's group
        if isinstance(x, dict):
            return {k: walk(v, k if k in lengths else group)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            items = [walk(v, group) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
        return one(x, group)

    def one_q(x):
        if x is None:
            return None
        return np.broadcast_to(x[:1], (n_new,) + np.shape(x)[1:]).copy()

    out = {k: (v if k in ("shard", "residual", "q") else walk(v))
           for k, v in state.items()}
    out["shard"] = {"size": n_new}
    if "residual" in state:
        out["residual"] = {}
        for k, x in state["residual"].items():
            L = lengths[k]
            total = repad(_sum_rows(x, n_new)[:L], L)
            out["residual"][k] = np.broadcast_to(
                total, (n_new, total.shape[0])).copy()
    if "q" in state:
        out["q"] = {k: one_q(x) for k, x in state["q"].items()}
    return out


def _dict_keys(tree) -> set:
    keys: set = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            keys.update(node)
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return keys


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
    JAX's flatten order), shapes and dtypes, this rank's place, the
    ZeRO-1 group plan at that world size (one group a dtype, or with
    ``bucket_bytes`` the buckets of :func:`_zero_groups`), the bucket size
    and the axis the gathers run on (``None`` or the host mesh's pair).
    Build with :func:`_fsdp_meta`, which computes the plan once."""

    keys: tuple
    shapes: tuple
    dtypes: tuple
    rank: int
    size: int
    groups: dict
    bucket_bytes: Optional[int] = None
    axis: Optional[tuple] = None


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


def _fsdp_groups(shapes, dtypes, size: int, bucket_bytes=None) -> dict:
    """The ZeRO-3 exchange groups of a tree of ``shapes``/``dtypes`` at
    ``size`` ranks: ZeRO-1's (:func:`_zero_groups`). Their boundaries
    depend only on the shapes and ``bucket_bytes``, never on the world
    size (only ``Lp`` does), which makes :func:`fsdp_reshard_params` a
    re-pad."""
    leaves = [torch.empty(tuple(s), dtype=d, device="meta")
              for s, d in zip(shapes, dtypes)]
    return _zero_groups(leaves, size, bucket_bytes)


def _fsdp_meta(keys, shapes, dtypes, rank: int, size: int,
               bucket_bytes=None, axis=None) -> _FsdpMeta:
    """The :class:`_FsdpMeta` of a tree of ``shapes``/``dtypes`` packed for
    ``rank`` of ``size``, with its group plan."""
    shapes = tuple(tuple(s) for s in shapes)
    dtypes = tuple(dtypes)
    bucket_bytes = int(bucket_bytes) if bucket_bytes else None
    return _FsdpMeta(tuple(keys), shapes, dtypes, int(rank), int(size),
                     _fsdp_groups(shapes, dtypes, size, bucket_bytes),
                     bucket_bytes, None if axis is None else tuple(axis))


def _check_world(fp: FsdpParams) -> None:
    if (fp.meta.rank, fp.meta.size) != (basics.rank(), basics.size()):
        raise ValueError(
            f"{fp!r} was packed for rank {fp.meta.rank} of {fp.meta.size}, "
            f"this is rank {basics.rank()} of {basics.size()}")


def fsdp_pack_params(params: dict, *, axis=None,
                     bucket_bytes: Optional[int] = None) -> FsdpParams:
    """This rank's ZeRO-3 shards of a full parameter tree (the same on
    every rank): each group packed flat as ZeRO-1 packs it, and this
    rank's ``[Lp/N]`` row kept. The layout is ZeRO-1's, so
    ``DistributedOptimizer(shard_params=True).init`` gives the ZeRO-1
    state. ``bucket_bytes`` sets the gather granularity (ZeRO-1's
    buckets, keys ``dtype#k``: one gather a bucket, in the forward and in
    the recompute, and one reduce-scatter a bucket in the backward);
    default one group a dtype. ``axis`` is the gathers' axis: ``None``
    (the world) or the host mesh's ``(CROSS, LOCAL)`` pair."""
    if axis is not None:
        from horovod_tpu_torch.ops import hierarchical as _hier

        _hier.check_pair(axis)
    n, r = basics.size(), basics.rank()
    keys = tree_keys(params)
    leaves = [params[k] for k in keys]
    meta = _fsdp_meta(keys, [l.shape for l in leaves],
                      [l.dtype for l in leaves], r, n,
                      bucket_bytes=bucket_bytes, axis=axis)
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
    pair = fp.meta.axis is not None
    fulls = {}
    for key, g in fp.meta.groups.items():
        local = fp.shards[key]
        qgroup = wire == "int8" and _quantizable(local.dtype) \
            and g.Lp >= MIN_QUANT_ELEMS
        if qgroup and not pair:
            fulls[key] = _C.quantized_all_gather(local)
        else:
            # on the axis pair the int8 wire needs one axis: the shard's
            # roundtrip goes through the routed gather, as in the JAX package
            fulls[key] = _C.gather_shards(local, axis=fp.meta.axis,
                                          roundtrip=qgroup)
    return _assemble(fp, fulls)


#: the key of a ZeRO-3 parameter tree's consolidated form (what
#: :func:`horovod_tpu_torch.checkpoint.save` writes for an
#: :class:`FsdpParams`): ``{FSDP_ROWS: {group: [N, s]}, "keys", "shapes",
#: "dtypes"}``, and ``"bucket_bytes"`` for a bucketed pack
FSDP_ROWS = "fsdp_rows"


def fsdp_reshard_params(fp, *, to_size: Optional[int] = None):
    """ZeRO-3 parameter shards re-packed for ``to_size`` ranks (default
    the world's size), as the JAX package's ``fsdp_reshard_params``: each
    group's ``[N, s]`` rows unpadded to its true length ``L``, re-padded
    for the new size and reshaped ``[to_size, s']``. The group boundaries
    do not depend on the world size, so this is a re-pad: no collective,
    no arithmetic. ``fp`` is the consolidated form (:data:`FSDP_ROWS`,
    what ``checkpoint.restore`` returns for a saved :class:`FsdpParams`),
    returned at the new size; a rank's own :class:`FsdpParams` holds one
    row, and is returned only at its own size.
    :func:`reshard_optimizer_state` re-packs the state half against the
    same ``fp``."""
    from horovod_tpu_torch.training import host_array

    n_new = int(to_size) if to_size is not None else basics.size()
    if isinstance(fp, FsdpParams):
        if fp.meta.size != n_new:
            raise ValueError(
                f"{fp!r} holds one rank's row; re-pack the consolidated "
                "rows (checkpoint.save writes them, checkpoint.restore "
                f"returns them) for a world of {n_new}")
        return fp
    rows = fp[FSDP_ROWS]
    n_old = int(np.shape(next(iter(rows.values())))[0])
    if n_old == n_new:
        return fp
    dtypes = [getattr(torch, d) for d in fp["dtypes"]]
    bb = fp.get("bucket_bytes")
    old = _fsdp_groups(fp["shapes"], dtypes, n_old, bb)
    new = _fsdp_groups(fp["shapes"], dtypes, n_new, bb)
    out = {}
    for k, g in new.items():
        flat = host_array(rows[k]).reshape(-1)[:old[k].L]
        if g.Lp > g.L:
            flat = np.concatenate([flat, np.zeros(g.Lp - g.L, flat.dtype)])
        out[k] = flat.reshape(n_new, -1)
    return {**fp, FSDP_ROWS: out}


def _fsdp_init(optimizer, params, bucket_bytes=None):
    if not isinstance(params, FsdpParams):
        raise TypeError(
            "DistributedOptimizer(shard_params=True).init expects the packed "
            "FsdpParams shards: build them with fsdp_pack_params(params), got "
            f"{type(params).__name__}")
    if bucket_bytes and params.meta.bucket_bytes != bucket_bytes:
        raise ValueError(
            "bucket_bytes mismatch: params were packed with "
            f"bucket_bytes={params.meta.bucket_bytes} but this "
            f"optimizer resolved {bucket_bytes}; pass the same value "
            "to fsdp_pack_params — the pack defines the exchange "
            "granularity")
    _check_world(params)
    return {"shard": {"rank": params.meta.rank, "size": params.meta.size},
            "inner": optimizer.init(dict(params.shards))}


def _record_sync_bytes(mode: str, n: int, wire_bytes: int,
                       gather_bytes: Optional[int] = None) -> None:
    """The per-step gradient-sync wire volume under the ring model
    (``grad_sync_bytes_per_step{mode=}``): allreduce moves
    ``2(N-1)/N·B`` gradient bytes, the sharded modes ``(N-1)/N·B``
    (reduce-scatter) plus the all-gather's bytes, reported apart
    (``param_gather_bytes_per_step{mode=}``)."""
    if not _metrics.enabled():
        return
    ring = (n - 1) / n if n > 1 else 0.0
    factor = 2.0 * ring if mode == "allreduce" else ring
    _metrics.gauge(
        "grad_sync_bytes_per_step",
        help="ring-model gradient bytes exchanged per step",
        mode=mode,
    ).set(factor * wire_bytes)
    if gather_bytes is not None:
        _metrics.gauge(
            "param_gather_bytes_per_step",
            help="ring-model parameter/update bytes all-gathered per step "
                 "(sharded optimizer only)",
            mode=mode,
        ).set(ring * gather_bytes)


def _tree_sync_wire_bytes(leaves, compression) -> int:
    """Wire bytes of one exchange direction: each leaf through the
    compressor's ``wire_bytes(shape, dtype)`` (its own dtype's bytes
    without a compressor)."""
    total = 0
    for g in leaves:
        hook = getattr(compression, "wire_bytes", None)
        if hook is not None:
            total += int(hook(tuple(g.shape), g.dtype))
        else:
            total += g.numel() * g.element_size()
    return total


def _fsdp_gather_wire_bytes(shards: dict, n: int, wire: str) -> int:
    """Wire image of ONE parameter all-gather: a group on the f32 wire
    moves its whole padded length ``Lp``; on the int8 wire each rank's
    block-padded shard moves as int8 plus one bf16 scale a block, times
    N ranks."""
    total = 0
    for s in shards.values():
        lp = s.numel() * n
        if wire == "int8" and _quantizable(s.dtype) and lp >= MIN_QUANT_ELEMS:
            sp = s.numel() + (-s.numel()) % INT8_BLOCK
            total += n * (sp + (sp // INT8_BLOCK) * 2)
        else:
            total += lp * s.element_size()
    return total


#: the traffic gauges' values by the update's shapes (they are the same
#: every step: priced once, as the JAX package prices them at trace time)
_traffic_cache: dict = {}


def _record_traffic(grads, state, *, shard_optimizer, shard_params,
                    compression, op, ov_bytes) -> None:
    """The traffic gauges of one update (metrics on, in a world)."""
    if not _metrics.enabled() or not basics.is_initialized() or op == Adasum:
        return
    tensors = list(grads.shards.values()) if shard_params \
        else [grads[k] for k in tree_keys(grads)]
    n = state["shard"]["size"] if shard_optimizer or shard_params \
        else basics.size()
    sig = (tuple((tuple(t.shape), t.dtype) for t in tensors), n,
           shard_optimizer, shard_params, repr(compression), ov_bytes,
           _fsdp_wire() if shard_params else None)
    args = _traffic_cache.get(sig)
    if args is None:
        if shard_params:
            wire = sum(s.numel() * n * s.element_size() for s in tensors)
            # the gather runs twice a step (forward and the backward's
            # re-gather under activation checkpointing)
            args = ("zero3", wire, 2 * _fsdp_gather_wire_bytes(
                grads.shards, n, _fsdp_wire()), len(tensors))
        elif shard_optimizer:
            args = ("sharded", _tree_sync_wire_bytes(tensors, compression),
                    sum(g.numel() * g.element_size() for g in tensors),
                    len(_zero_groups(tensors, n, ov_bytes)))
        else:
            args = ("allreduce", _tree_sync_wire_bytes(tensors, compression),
                    None, None)
        _traffic_cache[sig] = args
    mode, wire, gather, buckets = args
    _record_sync_bytes(mode, n, wire, gather)
    if buckets is not None:
        _ov._record_buckets(mode, buckets)


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
# PowerSGD


#: the JAX package seeds leaf i's Q with PRNGKey(POWERSGD_SEED + i); the
#: port seeds its own generator the same way (the draws differ: a JAX
#: state's Q is carried over with ``convert.powersgd_q_from_jax``)
POWERSGD_SEED = 0x9D5D


def _powersgd_q_init(params: dict, compression) -> dict:
    """The warm-start ``Q`` ``[m, r]`` of each factorized leaf (``None``
    elsewhere): standard normal from a generator seeded with
    ``POWERSGD_SEED + i`` (``i`` the leaf's place in :func:`tree_keys`),
    so every rank draws the same ``Q`` without a broadcast."""
    qs = {}
    for i, k in enumerate(tree_keys(params)):
        p = params[k]
        shape = tuple(p.shape)
        if compression.factorizes(shape, p.dtype):
            m = int(np.prod(shape[1:]))
            gen = torch.Generator().manual_seed(POWERSGD_SEED + i)
            q = torch.randn((m, compression.effective_rank(shape)),
                            generator=gen, dtype=torch.float32)
            qs[k] = q.to(p.device)
        else:
            qs[k] = None
    return qs


def _orthonormalize(p, eps: float = 1e-8):
    """One modified Gram-Schmidt pass over ``P``'s few columns."""
    cols = []
    for i in range(p.shape[1]):
        v = p[:, i]
        for u in cols:
            v = v - torch.dot(u, v) * u
        v = v / (torch.sqrt(torch.sum(v * v)) + eps)
        cols.append(v)
    return torch.stack(cols, dim=1)


def _powersgd_sync(corrected: dict, qs: dict, op, compression):
    """One PowerSGD exchange of the corrected leaves (``g + residual``):
    each factorized leaf ``M`` (``[d0, m]``) sends ``P = M @ Q``, every
    ``P`` of the step in one flat mean allreduce, then ``Q' = M^T @
    orthonormalize(P)``, every ``Q'`` in a second; the leaf's mean is
    ``P @ Q'^T`` and its residual ``M - P @ Q'^T``. The other float
    leaves ride the grouped int8 exchange (their residual from its one
    quantize pass), the rest the plain allreduce with a zero residual.
    Returns ``(reduced, residual, new Q)`` dicts."""
    n = basics.size()
    keys = tree_keys(corrected)
    fact = [k for k in keys if qs.get(k) is not None]
    quant = [k for k in keys if qs.get(k) is None
             and _quantizable(corrected[k].dtype)]
    rest = [k for k in keys if qs.get(k) is None and k not in quant]
    reduced, res, new_q = {}, {}, dict(qs)
    if fact:
        m2d = {k: corrected[k].reshape(corrected[k].shape[0], -1) for k in fact}
        ps = _C._grouped_flat_allreduce([m2d[k] @ qs[k] for k in fact],
                                        Average)
        ps = [_orthonormalize(p) for p in ps]
        qn = _C._grouped_flat_allreduce(
            [m2d[k].T @ p for k, p in zip(fact, ps)], Average)
        for k, p, q in zip(fact, ps, qn):
            approx = p @ q.T
            res[k] = (m2d[k] - approx).view(corrected[k].shape)
            red = approx.view(corrected[k].shape)
            reduced[k] = red * n if op == Sum else red
            new_q[k] = q
    if quant:
        outs, rs = _C._grouped_allreduce([corrected[k] for k in quant], op,
                                         compression.fallback, residuals=True)
        reduced.update(zip(quant, outs))
        res.update(zip(quant, rs))
    if rest:
        outs = _C._grouped_allreduce([corrected[k] for k in rest], op)[0]
        reduced.update(zip(rest, outs))
        res.update((k, torch.zeros_like(corrected[k])) for k in rest)
    return reduced, res, new_q


def _powersgd_update(grads, state, params, *, optimizer, compression, op):
    """Allreduce mode under PowerSGD: the state is ``{"inner",
    "residual" (param-shaped), "q"}``."""
    corrected = {k: grads[k] + state["residual"][k] for k in tree_keys(grads)}
    reduced, res, q = _powersgd_sync(corrected, state["q"], op, compression)
    updates, inner = optimizer.update(reduced, state["inner"], params)
    return updates, {"inner": inner, "residual": res, "q": q}


def _zero_update_powersgd(grads, state, params, *, optimizer, compression,
                          op):
    """ZeRO-1 under PowerSGD: the per-dtype ``[Lp]`` residual rows unpacked
    onto the leaves, :func:`_powersgd_sync` (after which the mean gradient
    is known on every rank, so this rank's shard is a slice: no
    reduce-scatter), the inner update of the shards and the all-gather of
    the update shards, as :func:`_zero_update`."""
    n, r = state["shard"]["size"], state["shard"]["rank"]
    keys = tree_keys(grads)
    leaves = [grads[k] for k in keys]
    groups = _zero_groups(leaves, n)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    cflats = {key: _ov.pack_group(leaves, g) + state["residual"][key]
              for key, g in groups.items()}
    corrected = dict(zip(keys, _ov.assemble(cflats, groups, shapes, dtypes)))
    reduced, res, q = _powersgd_sync(corrected, state["q"], op, compression)
    red_leaves = [reduced[k] for k in keys]
    res_leaves = [res[k] for k in keys]
    gshards, new_res = {}, {}
    for key, g in groups.items():
        gshards[key] = _rank_shard(_ov.pack_group(red_leaves, g), n, r)
        new_res[key] = _ov.pack_group(res_leaves, g)
    pshards = None
    if params is not None:
        p_leaves = [params[k] for k in keys]
        pshards = {k: _rank_shard(_ov.pack_group(p_leaves, g), n, r)
                   for k, g in groups.items()}
    upd_shards, inner = optimizer.update(gshards, state["inner"], pshards)
    out = _ov.assemble(_gather_updates(upd_shards, groups, n), groups, shapes,
                       dtypes)
    return dict(zip(keys, out)), {"shard": state["shard"], "inner": inner,
                                  "residual": new_res, "q": q}


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


def _env_true(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).lower() in ("1", "true", "yes")


_side_streams: dict = {}


def _side_stream(device) -> "torch.cuda.Stream":
    """The one stream per device the bucket exchanges run on: made once,
    so the caching allocator reuses the exchanges' buffers step to step
    (a new stream a step would start an empty pool each time)."""
    key = torch.device(device).index
    if key not in _side_streams:
        _side_streams[key] = torch.cuda.Stream(device=device)
    return _side_streams[key]


class BucketExchange:
    """One step's bucketed exchange, launched from the backward: the
    training step hands each leaf's gradient to :meth:`ready` as the
    backward produces it (a gradient hook), and a bucket's exchange
    starts as soon as its last leaf is ready and every bucket before it
    in the plan has started (all ranks issue the collectives in plan
    order). :meth:`flush` starts the rest after the backward, a leaf
    whose parameter got no gradient counting as zeros.

    ``run(key, flat)`` is the bucket's exchange (the same function the
    update runs when it exchanges after the backward, so both routes give
    the same bits). On the GPU the buckets run on a side stream (one a
    device, :func:`_side_stream`) that first waits for the backward's
    stream at each launch, and :meth:`results` makes the caller's stream
    wait for it.

    ``prepare``, when set (the numerics guard sets it), is applied to each
    gradient as it is handed over, before any bucket sees it; ``leaves``
    then holds the prepared gradients."""

    def __init__(self, groups: dict, n_leaves: int, run: Callable):
        self.groups = groups
        self.run = run
        self.prepare: Optional[Callable] = None
        self.order = list(groups)
        self.leaves = [None] * n_leaves
        self.left = {k: len(b.idxs) for k, b in groups.items()}
        self.of_leaf: dict = {}
        for k, b in groups.items():
            for i in b.idxs:
                self.of_leaf.setdefault(i, []).append(k)
        self.done: dict = {}
        self.next = 0
        self.missing = n_leaves
        #: buckets started from the backward (before :meth:`flush`), and
        #: of them those started while leaves were still to come
        self.in_backward = 0
        self.early = 0
        self.stream = None

    def ready(self, i: int, grad) -> None:
        """Leaf ``i``'s gradient is final (called once per leaf)."""
        if self.leaves[i] is not None:
            return
        self._take(i, grad)
        self._advance(in_backward=True)

    def _take(self, i: int, grad) -> None:
        self.leaves[i] = grad if self.prepare is None else self.prepare(grad)
        self.missing -= 1
        for k in self.of_leaf.get(i, ()):
            self.left[k] -= 1

    def _advance(self, in_backward: bool) -> None:
        while self.next < len(self.order) and \
                self.left[self.order[self.next]] == 0:
            key = self.order[self.next]
            self._launch(key)
            self.next += 1
            self.in_backward += int(in_backward)
            self.early += int(in_backward and self.missing > 0)

    @torch.no_grad()
    def _launch(self, key: str) -> None:
        b = self.groups[key]
        ref = self.leaves[b.segs[0].idx]
        if ref.device.type != "cuda":
            self.done[key] = self.run(key, _ov.pack_group(self.leaves, b))
            return
        if self.stream is None:
            self.stream = _side_stream(ref.device)
        self.stream.wait_stream(torch.cuda.current_stream(ref.device))
        with torch.cuda.stream(self.stream):
            self.done[key] = self.run(key, _ov.pack_group(self.leaves, b))

    def flush(self, grads: list) -> None:
        """Start every bucket not yet started, with ``grads`` (every
        leaf's gradient after the backward, zeros for a parameter that got
        none) for the leaves no hook handed over."""
        for i, g in enumerate(grads):
            if self.leaves[i] is None:
                self._take(i, g)
        self._advance(in_backward=False)

    def results(self) -> dict:
        """``{key: run's result}`` of every bucket, safe to read on the
        caller's stream."""
        if len(self.done) != len(self.order):
            raise RuntimeError(f"{len(self.order) - len(self.done)} buckets "
                               "were never started: call flush() first")
        if self.stream is not None:
            cur = torch.cuda.current_stream(self.stream.device)
            cur.wait_stream(self.stream)
            for out in self.done.values():
                for t in out:
                    if isinstance(t, torch.Tensor):
                        t.record_stream(cur)
        return self.done


class DistributedTransform(NamedTuple):
    """What :func:`DistributedOptimizer` returns: a :class:`Transform`
    that exchanges gradients itself. ``update(grads, state, params=None,
    *, started=None)``: ``started`` is a :class:`BucketExchange` from
    ``exchange(state, params)`` that already ran the buckets during the
    backward (``bucket_bytes`` set, allreduce mode or ZeRO-1)."""

    init: Callable
    update: Callable
    shard_optimizer: bool
    shard_params: bool = False
    bucket_bytes: Optional[int] = None
    exchange: Optional[Callable] = None
    axis: Optional[tuple] = None


#: optax's ``MultiStepsState``, under its JAX name (checkpoints of either
#: package read it): ``mini_step``/``gradient_step`` are 0-d int32
#: tensors on the host (the emit is decided there; under the numerics
#: guard a BAD micro-step keeps them, which reads the verdict once an
#: update), ``acc_grads`` the running mean of the gradients
MultiStepsState = pytree._stand_in(
    "optax.transforms._accumulation", "MultiStepsState",
    pytree._NAMEDTUPLE_FIELDS[("optax", "MultiStepsState")])


def multi_steps(tx, every_k: int):
    """``optax.MultiSteps(tx, every_k_schedule=every_k)`` with the mean of
    the gradients (Welford: ``acc + (g - acc) / (n + 1)``): every
    ``every_k``-th update runs ``tx`` on the mean of the last ``every_k``
    gradients and returns its update; the others return zeros. optax runs
    ``tx`` on every mini-step and keeps its state only on the emitting
    one; here ``tx`` runs on the emitting step only, which gives the same
    values and no exchange between emits. On an emit the accumulator is
    reset as ``0 * acc``, as optax does (a NaN stays NaN)."""
    k = int(every_k)

    def init(params):
        return MultiStepsState(
            torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32),
            tx.init(params),
            {key: torch.zeros_like(p) for key, p in params.items()}, ())

    def update(grads, state, params=None, **kw):
        mini = int(state.mini_step)
        acc = {}
        for key in tree_keys(grads):
            g, a = grads[key], state.acc_grads[key]
            acc[key] = a + (g - a) / torch.tensor(mini + 1, dtype=g.dtype,
                                                  device=g.device)
        step = int(state.gradient_step)
        if mini == k - 1:
            updates, inner = tx.update(acc, state.inner_opt_state, params)
            acc = {key: a * 0 for key, a in acc.items()}
            step += 1
        else:
            updates = {key: torch.zeros_like(g) for key, g in grads.items()}
            inner = state.inner_opt_state
        return updates, MultiStepsState(
            torch.tensor((mini + 1) % k, dtype=torch.int32),
            torch.tensor(step, dtype=torch.int32), inner, acc,
            state.skip_state)

    return Transform(init, update)


def DistributedOptimizer(optimizer: Transform, *, op: ReduceOp = Average,
                         compression=None, backward_passes_per_step: int = 1,
                         axis=None, gradient_predivide_factor: float = 1.0,
                         error_feedback: bool = False,
                         shard_optimizer: Optional[bool] = None,
                         shard_params: Optional[bool] = None,
                         overlap: Optional[bool] = None,
                         bucket_bytes: Optional[int] = None,
                         numerics_guard: Optional[bool] = None,
                         loss_scale=None):
    """Wrap ``optimizer`` so each ``update`` first combines the gradients
    across ranks. The JAX package's signature and refusals, same messages.

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
    - ``shard_optimizer=True`` (ZeRO-1; default ``HOROVOD_SHARD_OPTIMIZER``):
      the tree is flat-packed per dtype and reduce-scattered; this rank
      updates only its shard of the optimizer state and the update shards
      are all-gathered. The state holds this rank's shard only
      (``state["shard"]`` names it).
    - ``shard_params=True`` (ZeRO-3; default ``HOROVOD_SHARD_PARAMS``):
      ``init`` takes :class:`FsdpParams` and gives the ZeRO-1 state;
      ``update`` takes the gradient shards (the gather's backward
      reduce-scattered them) and returns update shards. The gradient leg
      is exact: compression and error feedback are refused
      (``HOROVOD_FSDP_WIRE=int8`` compresses the gather).

    ``compression=None`` reads ``HOROVOD_COMPRESSION``
    (:meth:`Compression.from_env`; PowerSGD resolved there turns
    ``error_feedback`` on). ``Compression.powersgd(r)`` syncs rank-``r``
    factors of each >= 2-D leaf where they are smaller than it, ``Q``
    warm-started in the state (needs ``error_feedback=True``).
    ``error_feedback=True`` keeps what the lossy wire rounded away and
    adds it to the next step's gradient (EF-SGD).
    ``gradient_predivide_factor`` ``f`` (Average, ``none``/``fp16``):
    each gradient is divided by ``f`` before the sum and the sum
    multiplied by ``f / N``.

    ``overlap=True`` (default ``HOROVOD_OVERLAP``; ``bucket_bytes`` alone
    implies it): the exchange runs bucket by bucket
    (:class:`~horovod_tpu_torch.ops.overlap.BucketPlan`, ``bucket_bytes``
    default ``HOROVOD_BUCKET_BYTES``): in allreduce mode one allreduce a
    bucket, error-feedback residuals keyed by bucket; under ZeRO-1 one
    reduce-scatter a bucket, the state's shards per bucket, the update
    shards back through one all-gather per dtype. ``make_train_step``
    launches the buckets from the backward's gradient hooks
    (``exchange``); ``update`` after the backward runs the same buckets.

    ``backward_passes_per_step=k`` accumulates ``k`` gradients and
    exchanges their mean on every ``k``-th update (:func:`multi_steps`).
    ``axis`` is ``None`` (the world's process group) or the host mesh's
    ``(CROSS_AXIS, LOCAL_AXIS)`` pair
    (:func:`~horovod_tpu_torch.parallel.mesh.build_host_mesh`), the JAX
    package's tuple-axis routes: allreduce mode reduces each leaf as
    ``allreduce(g, op, compression=, axis=pair)`` does (two-level while
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` is on, the int8 wire on the cross
    hop only; the leaves grouped, each bit-equal to its own), error
    feedback keeping ``c - decompress(compress(c))``; ZeRO-1 sends a
    quantizable group's chunk-aligned roundtrip through the plain
    reduce-scatter (the int8 exchange needs one axis). ZeRO-3 takes its
    axis from :func:`fsdp_pack_params`. Overlap in allreduce mode,
    PowerSGD and Adasum have no pair route here.

    ``numerics_guard=True`` (default ``HOROVOD_NUMERICS_GUARD``, or any
    ``loss_scale``) wraps the result in
    :func:`~horovod_tpu_torch.resilience.numerics.guard`, outermost: a
    :class:`~horovod_tpu_torch.resilience.numerics.GuardedTransformation`
    whose state is a ``NumericsGuardState`` around this optimizer's
    (:func:`distributed_transform` gives the optimizer inside).
    ``loss_scale`` (``"dynamic"`` or a float) is carried in the guard's
    state; ``make_train_step`` scales the loss by it. The guard does not
    compose with ``shard_params=True``, as in the JAX package.
    """
    pair = axis is not None
    if pair:
        from horovod_tpu_torch.ops import hierarchical as _hier

        _hier.check_pair(axis)
    if shard_optimizer is None:
        shard_optimizer = _env_true("HOROVOD_SHARD_OPTIMIZER")
    if shard_params is None:
        shard_params = _env_true("HOROVOD_SHARD_PARAMS")
    ov_bytes = _ov.resolve_bucket_bytes(overlap, bucket_bytes)
    if compression is None:
        compression = Compression.from_env()
        if getattr(compression, "factorized", False) and not error_feedback:
            error_feedback = True
    op = ReduceOp(op)
    pf = float(gradient_predivide_factor)
    factorized = getattr(compression, "factorized", False)
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
                "shard_params=True: the ZeRO-3 gradient leg is the "
                "parameter gather's transpose — exact full precision by "
                "construction. Compress the parameter GATHER instead "
                "(HOROVOD_FSDP_WIRE=int8)")
        if error_feedback:
            raise ValueError(
                "error_feedback needs a lossy gradient wire; the ZeRO-3 "
                "gradient leg is exact (see shard_params). The int8 "
                "GATHER wire perturbs only forward parameter values — "
                "there is no gradient rounding to feed back")
        if pf != 1.0:
            raise ValueError(
                "gradient_predivide_factor is not supported with "
                "shard_params=True (the reduced shards arrive through "
                "the gather transpose; there is no pre-wire scale point)")
        if shard_optimizer:
            raise ValueError(
                "shard_params=True already shards the optimizer state; "
                "pass shard_optimizer=False")
    if factorized and not error_feedback:
        raise ValueError(
            "PowerSGD compression is biased low-rank truncation; it is "
            "only convergence-safe with error_feedback=True (EF-SGD, "
            "Karimireddy et al. 2019)")
    if factorized and op not in (Average, Sum):
        raise ValueError("PowerSGD compression supports op=Average/Sum only")
    if (factorized or quantized) and pf != 1.0:
        raise ValueError(
            "gradient_predivide_factor is a headroom trick for plain "
            "16-bit casts; blockwise int8 scaling / PowerSGD factors "
            "normalize per block and do not support it")
    if error_feedback and compression is Compression.none:
        raise ValueError(
            "error_feedback=True needs a lossy compression "
            "(e.g. Compression.fp16); with Compression.none there is no "
            "rounding error to feed back")
    if error_feedback and op == Adasum:
        raise ValueError("error_feedback is not supported with op=Adasum")
    if quantized and op == Adasum:
        raise ValueError(
            "quantized compression is not supported with op=Adasum (the "
            "scalar projections have no low-bit reduction formulation)")
    if shard_optimizer and op == Adasum:
        raise ValueError(
            "shard_optimizer=True is not supported with op=Adasum (the "
            "pairwise projections have no reduce-scatter formulation)")
    if (quantized or shard_optimizer) and op not in (Average, Sum, Adasum):
        raise ValueError(
            f"op={op!r}: the reduce-scatter paths (quantized compression, "
            "shard_optimizer) support Average/Sum only")
    if ov_bytes and factorized:
        raise ValueError(
            "overlap/bucket_bytes is not supported with PowerSGD "
            "compression: the rank-r P/Q factors are per-leaf matrices "
            "that bucket packing would mix; use the int8/fp16 wire with "
            "overlap, or PowerSGD without it")
    if ov_bytes and op == Adasum:
        raise ValueError(
            "overlap/bucket_bytes is not supported with op=Adasum (the "
            "pairwise projections are per-tensor scalars; bucket packing "
            "would mix them)")
    if pair and op == Adasum:
        raise ValueError(
            "Adasum does not support hierarchical (tuple) axes; the VHDD "
            "butterfly needs one flat rank ordering — pass a single-axis "
            "mesh or an explicit axis")
    if pair and factorized:
        raise ValueError("PowerSGD has no (cross, local) axis-pair route "
                         "in the port: pass axis=None")
    if pair and ov_bytes and not (shard_optimizer or shard_params):
        raise ValueError("overlap in allreduce mode has no (cross, local) "
                         "axis-pair route in the port: pass axis=None, or "
                         "shard_optimizer=True")
    if numerics_guard is None:
        numerics_guard = (_env_true("HOROVOD_NUMERICS_GUARD")
                          or loss_scale is not None)
    elif not numerics_guard and loss_scale is not None:
        raise ValueError(
            "loss_scale is carried in the numerics guard's state (the "
            "guard unscales the gradients and backs the scale off on bad "
            "steps); numerics_guard=False with loss_scale set would "
            "silently train UNSCALED — drop loss_scale or the explicit "
            "numerics_guard=False")
    if numerics_guard and shard_params:
        raise ValueError(
            "numerics_guard does not compose with shard_params=True yet: "
            "the guard's fused global-norm/finiteness reduction assumes "
            "full (or ZeRO-1 replicated) gradients, and per-rank verdicts "
            "over FsdpParams shards could diverge. Guard ZeRO-1 "
            "(shard_optimizer=True) instead, or train ZeRO-3 unguarded")
    if int(backward_passes_per_step) < 1:
        raise ValueError("backward_passes_per_step must be >= 1, got "
                         f"{backward_passes_per_step}")

    def _roundtrip(g):
        """What ``g`` contributes through the wire: with a predivide the
        wire carries ``compress(g / f)``, scaled back by ``f``."""
        if op == Average and pf != 1.0:
            wire = compression.decompress(*compression.compress(
                _ov._predivide(g, pf)))
            return wire * torch.tensor(pf, dtype=wire.dtype, device=wire.device)
        return compression.decompress(*compression.compress(g))

    def _reduce(grads, residuals=False):
        """The reduced tree (and with ``residuals`` each leaf's ``g -
        roundtrip(g)``, from the exchange's own quantize pass where there
        is no predivide): one int8 exchange per quantizable dtype and one
        flat ``all_reduce`` per other dtype a step, or Adasum's
        butterfly."""
        keys = tree_keys(grads)
        if op == Adasum:
            return _adasum_tree(grads, compression), None
        leaves = [grads[k] for k in keys]
        if pair:
            # the JAX package's per-leaf allreduce on the pair; its error
            # feedback measures each leaf's own compress/decompress
            res = None
            if residuals:
                res = ([g - _roundtrip(g) for g in leaves] if pf != 1.0
                       else _C._roundtrip_residuals(leaves, compression))
            if op == Average and pf != 1.0:
                outs = _C._pair_grouped_allreduce(
                    [_ov._predivide(g, pf) for g in leaves], Sum, compression)
                outs = [o * torch.tensor(pf / basics.size(), dtype=o.dtype,
                                         device=o.device) for o in outs]
            else:
                outs = _C._pair_grouped_allreduce(leaves, op, compression)
        elif op == Average and pf != 1.0:
            res = [g - _roundtrip(g) for g in leaves] if residuals else None
            outs = _ov.predivided_average(leaves, compression, pf)
        else:
            outs, res = _C._grouped_allreduce(leaves, op, compression,
                                              residuals=residuals)
        return dict(zip(keys, outs)), (dict(zip(keys, res)) if residuals
                                       else None)

    def _ar_plan(grads):
        return _ov.plan_for([grads[k] for k in tree_keys(grads)], 1, ov_bytes)

    def init(params):
        if shard_params:
            return _fsdp_init(optimizer, params, ov_bytes)
        if shard_optimizer:
            return _zero_init(optimizer, params, basics.size(), basics.rank(),
                              error_feedback=error_feedback,
                              compression=compression, bucket_bytes=ov_bytes)
        inner = optimizer.init(params)
        if factorized:
            return {"inner": inner,
                    "residual": {k: torch.zeros_like(p)
                                 for k, p in params.items()},
                    "q": _powersgd_q_init(params, compression)}
        if error_feedback:
            if ov_bytes:
                residual = {b.key: torch.zeros(
                    b.L, dtype=getattr(torch, b.dtype),
                    device=next(iter(params.values())).device)
                    for b in _ar_plan(params).buckets}
            else:
                residual = {k: torch.zeros(p.shape, dtype=p.dtype,
                                           device=p.device)
                            for k, p in params.items()}
            return {"inner": inner, "residual": residual}
        return inner

    def _bucket_runner(state, groups):
        """``run(key, flat)``: the exchange of one bucket of this step,
        allreduce mode or ZeRO-1."""
        residual = state.get("residual") if error_feedback else None
        if shard_optimizer:
            n = state["shard"]["size"]

            def run(key, flat):
                return _zero_bucket(flat, key, groups[key],
                                    residual=residual, n=n, op=op,
                                    compression=compression, predivide=pf,
                                    roundtrip=_roundtrip, pair=pair)
        else:
            def run(key, flat):
                return _ov.allreduce_bucket(
                    flat, op, compression, predivide=pf,
                    residual=None if residual is None else residual[key],
                    roundtrip=_roundtrip)
        return run

    def _groups(leaves, state):
        if shard_optimizer:
            return _zero_groups(leaves, state["shard"]["size"], ov_bytes)
        return _ov.plan_for(leaves, 1, ov_bytes).groups

    def exchange(state, params):
        """A :class:`BucketExchange` for this step's gradients (shaped as
        ``params``), to be fed from the backward."""
        keys = tree_keys(params)
        groups = _groups([params[k] for k in keys], state)
        return BucketExchange(groups, len(keys), _bucket_runner(state, groups))

    def _bucketed(grads, state, started):
        """The reduced tree and new residuals of allreduce mode's buckets,
        from ``started`` or run now."""
        keys = tree_keys(grads)
        leaves = [grads[k] for k in keys]
        groups = _groups(leaves, state)
        if started is None:
            run = _bucket_runner(state, groups)
            done = {key: run(key, _ov.pack_group(leaves, b))
                    for key, b in groups.items()}
        else:
            done = started.results()
        out = _ov.assemble({k: v[0] for k, v in done.items()}, groups,
                           [tuple(l.shape) for l in leaves],
                           [l.dtype for l in leaves])
        return dict(zip(keys, out)), {k: v[1] for k, v in done.items()}

    def update(grads, state, params=None, *, started=None):
        if started is not None and not ov_bytes:
            raise ValueError("started= is the bucketed exchange: build the "
                             "optimizer with overlap=True")
        _record_traffic(grads, state, shard_optimizer=shard_optimizer,
                        shard_params=shard_params, compression=compression,
                        op=op, ov_bytes=ov_bytes)
        if shard_params:
            return _fsdp_update(grads, state, params, optimizer=optimizer,
                                op=op)
        if shard_optimizer:
            return _zero_update(
                grads, state, params, optimizer=optimizer,
                compression=compression, error_feedback=error_feedback,
                op=op, predivide=pf, roundtrip=_roundtrip,
                bucket_bytes=ov_bytes, pair=pair,
                started=None if started is None else started.results())
        if factorized:
            return _powersgd_update(grads, state, params, optimizer=optimizer,
                                    compression=compression, op=op)
        if ov_bytes:
            reduced, residual = _bucketed(grads, state, started)
            if error_feedback:
                updates, inner = optimizer.update(reduced, state["inner"],
                                                  params)
                return updates, {"inner": inner, "residual": residual}
            return optimizer.update(reduced, state, params)
        if error_feedback:
            corrected = {k: grads[k] + state["residual"][k]
                         for k in tree_keys(grads)}
            # the residual is what the wire rounds away: the exchange
            # quantizes `corrected` once, for the wire and the residual
            reduced, residual = _reduce(corrected, residuals=True)
            updates, inner = optimizer.update(reduced, state["inner"], params)
            return updates, {"inner": inner, "residual": residual}
        return optimizer.update(_reduce(grads)[0], state, params)

    k = int(backward_passes_per_step)
    if k > 1:
        tx = multi_steps(Transform(init, update), k)
        tx = DistributedTransform(tx.init, tx.update, bool(shard_optimizer),
                                  bool(shard_params), ov_bytes, None,
                                  tuple(axis) if pair else None)
    else:
        tx = DistributedTransform(init, update, bool(shard_optimizer),
                                  bool(shard_params), ov_bytes,
                                  exchange if ov_bytes and not shard_params
                                  else None, tuple(axis) if pair else None)
    if numerics_guard:
        # outermost, so a BAD verdict freezes everything this optimizer
        # owns: moments, EF residuals, PowerSGD's Q, the accumulator
        tx = _numerics.guard(tx, loss_scale=loss_scale)
    return tx


def distributed_transform(tx) -> Optional[DistributedTransform]:
    """The :class:`DistributedTransform` that ``tx`` is, or that a
    numerics guard wraps (``tx.inner``); None for a plain optimizer."""
    if _numerics.is_guarded(tx):
        tx = tx.inner
    return tx if isinstance(tx, DistributedTransform) else None


class DistributedGradientTape:
    """Wrap a function that returns gradients (a flat dict of tensors) or
    ``(scalar loss, gradients)`` so its gradients come back combined
    across ranks: one grouped exchange
    (:func:`~horovod_tpu_torch.ops.collective.grouped_allreduce`'s, with
    ``compression``), or Adasum's butterfly. A 2-tuple counts as
    ``(loss, gradients)`` only when its first element is a 0-d tensor;
    ``has_aux_value`` decides where that guess would not."""

    def __init__(self, grad_fn: Callable, *, op: ReduceOp = Average,
                 compression=Compression.none,
                 has_aux_value: Optional[bool] = None):
        self._fn = grad_fn
        self._op = ReduceOp(op)
        self._compression = compression
        self._has_aux_value = has_aux_value

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        has_value = self._has_aux_value
        if has_value is None:
            has_value = (isinstance(out, tuple) and len(out) == 2
                         and not isinstance(out[0], (list, dict))
                         and getattr(out[0], "ndim", None) == 0)
        value, grads = out if has_value else (None, out)
        keys = tree_keys(grads)
        if self._op == Adasum:
            grads = _adasum_tree(grads, self._compression)
        else:
            outs = _C._grouped_allreduce([grads[k] for k in keys], self._op,
                                         self._compression)[0]
            grads = dict(zip(keys, outs))
        if _metrics.enabled():
            _metrics.counter(
                "tape_steps", help="DistributedGradientTape gradient exchanges"
            ).inc()
            _metrics.counter(
                "tape_grad_bytes", help="gradient bytes exchanged by the tape"
            ).inc(sum(grads[k].numel() * grads[k].element_size()
                      for k in keys))
        return (value, grads) if has_value else grads


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


def _is_sharded_state(x) -> bool:
    """Is ``x`` a ZeRO-1 state (``{"shard": {"rank", "size"}, ...}``, or
    its consolidated view)? Such a state is per-rank data, at whatever
    depth it sits (inside ``MultiStepsState.inner_opt_state`` or a guard's
    ``inner``): the JAX package tests each leaf for its sharding
    (``is_sharded_state_leaf``) for the same reason."""
    return isinstance(x, dict) and isinstance(x.get("shard"), dict) \
        and "size" in x["shard"]


def broadcast_optimizer_state(state, root_rank: int = 0):
    """``root_rank``'s optimizer state on every rank, as the JAX package
    maps it: tensors through :func:`broadcast`, every other leaf (ints,
    floats, strings, ``None``, ...) through :func:`broadcast_object`, so
    it arrives exact. A ZeRO-1 state is left as it is, at any depth of
    the tree: each rank's shard is its own authoritative state, and
    broadcasting root's row would corrupt the others."""

    def walk(x):
        if _is_sharded_state(x):
            return x
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            items = [walk(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
        if isinstance(x, torch.Tensor):
            return _C.broadcast(x, root_rank)
        return _C.broadcast_object(x, root_rank)

    return walk(state)
