"""The data-parallel training step.

Counterpart of ``horovod_tpu/training.py``'s per-rank step
(``make_shardmap_train_step``): forward and backward on this rank's
batch, the gradient exchange, the optimizer update, BatchNorm running
stats and the loss averaged across ranks. The same step trains the
ResNets (``softmax_xent``) and the TransformerLM (``loss_fn=lm_xent``),
with the parameters replicated or, under ZeRO-3 (``shard_params=True``),
sharded and gathered on use.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics, pytree
from horovod_tpu_torch.models.layers import torch_params
from horovod_tpu_torch.ops import overlap as _ov
from horovod_tpu_torch.ops.collective import Average, allreduce
from horovod_tpu_torch.optim import (
    FsdpParams, distributed_transform, fsdp_gather_params, fsdp_pack_params,
    tree_keys,
)
from horovod_tpu_torch.resilience import numerics as _numerics


def softmax_xent(logits, labels):
    """Cross entropy with integer labels (mean over the batch)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def lm_xent(logits, targets):
    """Next-token cross entropy: log-softmax in f32, the target's entry,
    mean over ``[B, T]`` (the JAX LM benchmark's loss)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def token_xent(logits, targets):
    """The JAX package's name for :func:`lm_xent` (``training.token_xent``):
    next-token cross entropy over ``[B, T, V]`` logits and integer
    targets, log-softmax in f32, mean over every token."""
    return lm_xent(logits, targets)


@torch.no_grad()
def _average_stats(stats: dict, keys: list) -> None:
    """Keep the running stats replicated: one flat Average allreduce."""
    if not keys:
        return
    flat = allreduce(torch.cat([stats[k].reshape(-1) for k in keys]), Average)
    off = 0
    for k in keys:
        n = stats[k].numel()
        stats[k].copy_(flat[off:off + n].view(stats[k].shape))
        off += n


def make_train_step(model, tx, *, shard_optimizer: bool = False,
                    shard_params: bool = False, params=None,
                    compression=None, reduce_op=Average,
                    loss_fn: Callable = softmax_xent,
                    on_phase: Optional[Callable[[str], None]] = None,
                    overlap: Optional[bool] = None,
                    bucket_bytes: Optional[int] = None):
    """Build ``step(opt_state, images, labels) -> (opt_state, loss)``.

    ``model`` exposes ``jax_params()``/``jax_grads()``/
    ``jax_batch_stats()`` (the flax-keyed views the optimizer packs, see
    :class:`~horovod_tpu_torch.models.resnet.ResNet`). The step updates
    the model's parameters and BatchNorm running stats IN PLACE under
    ``torch.no_grad()`` (where the JAX step returns new trees); it
    returns the new optimizer state and the rank-averaged loss.

    ``tx`` a :func:`~horovod_tpu_torch.optim.DistributedOptimizer`: the
    optimizer exchanges the gradients (``shard_optimizer`` must match
    how it was built). ``tx`` a plain optimizer: the step allreduces each
    gradient itself with ``reduce_op``/``compression``, as the reference
    step does. Build ``opt_state = tx.init(model.jax_params())``.

    ``shard_params=True`` (ZeRO-3, ``tx = DistributedOptimizer(...,
    shard_params=True)``): the parameters are this rank's shards,
    ``params`` (an :class:`~horovod_tpu_torch.optim.FsdpParams`; default
    ``fsdp_pack_params(model.jax_params())`` at the optimizer's
    ``bucket_bytes`` and ``axis``: one gather a bucket), exposed as
    ``step.params``; build ``opt_state = tx.init(step.params)``. The
    model's own parameters are emptied: between steps no full-size
    parameter storage is held. Each step gathers the tree
    (``fsdp_gather_params``, ``HOROVOD_FSDP_WIRE``) and runs the forward
    through ``torch.func.functional_call`` under activation
    checkpointing, so the backward gathers it again rather than holding
    it (the wire runs twice a step, as under the reference's
    ``jax.checkpoint``); the gather's backward yields the gradient shards,
    and the update shards are added to the shards in place.

    Bucketed overlap: with a plain ``tx``, ``overlap=True`` (default
    ``HOROVOD_OVERLAP``; ``bucket_bytes`` alone implies it) makes the
    step's exchange :func:`~horovod_tpu_torch.ops.overlap.bucketed_allreduce`.
    With ``tx = DistributedOptimizer(..., overlap=True)`` (allreduce mode
    or ZeRO-1) the optimizer owns the buckets and these kwargs change
    nothing: the step launches each bucket's exchange from the backward,
    a ``register_post_accumulate_grad_hook`` on every parameter handing
    each leaf's gradient (the view ``jax_grads()`` gives) to the step's
    :class:`~horovod_tpu_torch.optim.BucketExchange`, which starts a
    bucket once its leaves are ready, in plan order; after the backward
    the rest start (a parameter with no gradient as zeros) and
    ``tx.update(..., started=)`` waits for them. The update is bit-equal
    to ``tx.update`` after the backward. ``step.hooks`` holds the hooks'
    handles, and ``step.last_exchange`` the last step's exchange (its
    ``in_backward`` counts the buckets started from the backward).

    ``on_phase(name)``, if given, is called as each part of the step
    ends: ``"forward"`` (forward and loss), ``"backward"`` (and, with a
    plain ``tx``, the gradient allreduce), ``"optimizer"`` (the update,
    the exchange inside a DistributedOptimizer, the running stats) and
    ``"loss"`` (the loss allreduce). A hook that synchronises the device
    and reads a clock splits the step's time.

    A numerics-guarded ``tx`` (``DistributedOptimizer(numerics_guard=
    True)`` or ``loss_scale=``) is seen through for all of the above and
    detected, as the JAX step detects it: the loss is multiplied by the
    guard's loss scale (:func:`~horovod_tpu_torch.resilience.numerics
    .current_scale`, a device tensor) before the backward, the update
    gets this rank's loss (``loss=``, unscaled: the scaled loss divided
    by the scale) so a non-finite loss marks the step BAD, and the step
    returns the unscaled, rank-averaged loss."""
    dtx = distributed_transform(tx)
    distributed = dtx is not None
    guarded = _numerics.is_guarded(tx)
    mark = on_phase or (lambda name: None)
    if shard_optimizer and not (distributed and dtx.shard_optimizer):
        raise ValueError(
            "shard_optimizer=True needs tx = DistributedOptimizer(..., "
            "shard_optimizer=True)")
    if distributed and dtx.shard_optimizer != shard_optimizer:
        raise ValueError("tx was built with shard_optimizer="
                         f"{dtx.shard_optimizer}; pass the same here")
    if shard_params != (distributed and dtx.shard_params):
        raise ValueError(
            "shard_params=True and tx = DistributedOptimizer(..., "
            "shard_params=True) go together")
    if shard_params:
        return _fsdp_step(model, tx, params, loss_fn, mark)
    if params is not None:
        raise ValueError("params= is the ZeRO-3 shards: pass shard_params=True")
    params = model.jax_params()
    keys = tree_keys(params)
    stats = model.jax_batch_stats()
    stat_keys = tree_keys(stats)
    ov_bytes = None if distributed else _ov.resolve_bucket_bytes(
        overlap, bucket_bytes)
    hooked = distributed and tx.exchange is not None
    live: dict = {"ex": None}
    hooks = _grad_hooks(model, params, keys, live) if hooked else []

    def step(opt_state, images, labels):
        model.train()
        for p in model.parameters():
            p.grad = None
        loss = loss_fn(model(images), labels)
        scale = _numerics.current_scale(opt_state) if guarded else None
        if scale is not None:
            # scaled where it is differentiated: the backward runs at the
            # scaled magnitude; the guard unscales the gradients
            loss = loss * scale
        mark("forward")
        ex = live["ex"] = tx.exchange(opt_state, params) if hooked else None
        try:
            loss.backward()
        finally:
            live["ex"] = None
        if scale is not None:
            loss = loss.detach() / scale
        grads = model.jax_grads()
        if ex is not None:
            ex.flush([grads[k] if grads[k] is not None
                      else torch.zeros_like(params[k]) for k in keys])
            step.last_exchange = ex
        elif ov_bytes:
            grads = _ov.bucketed_allreduce(grads, reduce_op,
                                           compression=compression,
                                           bucket_bytes=ov_bytes)[0]
        elif not distributed:
            grads = {k: allreduce(grads[k], reduce_op, compression=compression)
                     for k in tree_keys(grads)}
        mark("backward")
        with torch.no_grad():
            kw = {"loss": loss.detach()} if guarded else {}
            if ex is not None:
                kw["started"] = ex
            updates, opt_state = tx.update(grads, opt_state, params, **kw)
            for k, u in updates.items():
                params[k].add_(u)
            _average_stats(stats, stat_keys)
        mark("optimizer")
        loss = allreduce(loss.detach(), Average)
        mark("loss")
        return opt_state, loss

    step.hooks = hooks
    step.last_exchange = None
    return step


def _grad_hooks(model, params: dict, keys: list, live: dict) -> list:
    """One ``register_post_accumulate_grad_hook`` a parameter that backs a
    leaf of ``params``: when the parameter's gradient is final, each of
    its leaves' gradient — the parameter's ``.grad`` through the leaf's
    own permutation of the dims (a conv kernel's HWIO, a Dense kernel's
    transpose) — goes to the step's exchange (``live["ex"]``, set only
    while the step's backward runs). A leaf that is not a permutation of
    its parameter is left to the exchange's ``flush``."""
    owners: dict = {}
    for p in model.parameters():
        owners[p.untyped_storage().data_ptr()] = (p, [])
    for i, k in enumerate(keys):
        v = params[k]
        owner = owners.get(v.untyped_storage().data_ptr())
        if owner is not None:
            perm = _view_perm(owner[0], v)
            if perm is not None:
                owner[1].append((i, perm))
    handles = []
    for p, leaves in owners.values():
        if not leaves:
            continue

        def hook(p, leaves=leaves):
            ex = live["ex"]
            if ex is None or p.grad is None:
                return
            for i, perm in leaves:
                ex.ready(i, p.grad.permute(perm))

        handles.append(p.register_post_accumulate_grad_hook(hook))
    return handles


def _view_perm(p, v):
    """The dims permutation ``perm`` with ``p.permute(perm)`` the view
    ``v`` of ``p``, or ``None`` when ``v`` is not one."""
    if v.numel() != p.numel() or v.dim() != p.dim() \
            or v.storage_offset() != p.storage_offset():
        return None
    perm, used = [], set()
    for size, stride in zip(v.shape, v.stride()):
        d = next((d for d in range(p.dim()) if d not in used
                  and p.shape[d] == size and p.stride(d) == stride), None)
        if d is None:
            return None
        perm.append(d)
        used.add(d)
    return tuple(perm)


def _fsdp_step(model, tx, fp, loss_fn, mark):
    """The ZeRO-3 step of :func:`make_train_step` (the reference's
    ``fsdp_step``)."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    if fp is None:
        dtx = distributed_transform(tx)
        fp = fsdp_pack_params(model.jax_params(), axis=dtx.axis,
                              bucket_bytes=dtx.bucket_bytes)
    elif not isinstance(fp, FsdpParams):
        raise TypeError(f"params must be FsdpParams, got {type(fp).__name__}")
    keys = sorted(fp.shards)
    shards = [fp.shards[k].requires_grad_() for k in keys]
    with torch.no_grad():                     # the shards are the parameters
        for p in model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    stats = model.jax_batch_stats()
    stat_keys = tree_keys(stats)
    buffers = dict(model.named_buffers())

    def step(opt_state, images, labels):
        model.train()
        runs = []

        def loss_of(*flat_shards):
            tree = fsdp_gather_params(
                FsdpParams(dict(zip(keys, flat_shards)), fp.meta))
            # the backward re-runs this forward (activation checkpointing):
            # its BatchNorms update copies, so the running stats move once
            bufs = buffers if not runs else {k: b.clone()
                                             for k, b in buffers.items()}
            runs.append(None)
            out = functional_call(model, {**torch_params(model, tree), **bufs},
                                  (images,), strict=True)
            return loss_fn(out, labels)

        loss = checkpoint(loss_of, *shards, use_reentrant=False,
                          preserve_rng_state=False)
        mark("forward")
        gshards = torch.autograd.grad(loss, shards)
        mark("backward")
        with torch.no_grad():
            updates, opt_state = tx.update(
                FsdpParams(dict(zip(keys, gshards)), fp.meta), opt_state, fp)
            for k, s in zip(keys, shards):
                s.add_(updates.shards[k])
            _average_stats(stats, stat_keys)
        mark("optimizer")
        loss = allreduce(loss.detach(), Average)
        mark("loss")
        return opt_state, loss

    step.params = fp
    return step


#: what a bf16 leaf is on the host: numpy has no bf16, and the JAX
#: package's ``np.savez`` of one writes its two bytes as ``V2``
BF16_ON_HOST = np.dtype("V2")


def host_array(x) -> np.ndarray:
    """An owned, C-ordered host copy of a tensor (a bf16 tensor as its
    2-byte ``|V2`` bits, what the JAX package's checkpoints hold for
    bf16), an ``np.ndarray`` or an ``np.generic`` (a 0-d array)."""
    if not isinstance(x, torch.Tensor):
        return np.array(x, order="C")
    t = x.detach()
    t = t.contiguous().cpu() if t.device.type != "cpu" else t.contiguous().clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_ON_HOST)
    return t.numpy()


def host_tensor(a) -> torch.Tensor:
    """The inverse of :func:`host_array`: a CPU tensor of a host array's
    values, a bf16 one for ``|V2`` bits (or ``ml_dtypes``' bfloat16)."""
    a = np.array(a, order="C")
    if a.dtype == BF16_ON_HOST or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def host_snapshot(tree):
    """Host copy of a state tree: every tensor, ``np.ndarray`` and
    ``np.generic`` leaf becomes an owned ``np.ndarray``
    (:func:`host_array`); other leaves pass through. The copy is taken at
    the call, so later in-place steps do not reach it (the asynchronous
    checkpoint writes it on a thread)."""
    leaves, treedef = pytree.flatten(tree)
    return pytree.unflatten(treedef, [
        host_array(x) if isinstance(x, (torch.Tensor, np.ndarray, np.generic))
        else x for x in leaves])


def shard_batch(batch: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows ``r*B/N : (r+1)*B/N`` of a global batch
    (the layout ``P(data)`` gives rank r in the JAX package)."""
    r, n = basics.rank(), basics.size()
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"global batch {b} is not divisible by world size {n}")
    per = b // n
    return batch[r * per:(r + 1) * per]
