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

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics, pytree
from horovod_tpu_torch.analysis import sanitizer as _sanitizer
from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import regression as _regression
from horovod_tpu_torch.observability import slo as _slo
from horovod_tpu_torch.observability import straggler as _straggler
from horovod_tpu_torch.observability import trace as _trace
from horovod_tpu_torch.models.layers import torch_params
from horovod_tpu_torch.ops import overlap as _ov
from horovod_tpu_torch.ops.collective import Average, allreduce
from horovod_tpu_torch.optim import (
    FsdpParams, distributed_transform, fsdp_gather_params, fsdp_pack_params,
    tree_keys,
)
from horovod_tpu_torch.resilience import health as _health
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


class InstrumentedStep:
    """Wrap a step callable so every call opens its step's observability
    boundary and feeds the metrics registry (the JAX package's
    ``InstrumentedStep``):

    - before the call: the straggler correlation scope and the schedule
      sanitizer (:func:`~horovod_tpu_torch.analysis.sanitizer.set_step`:
      the finished step's record is published and cross-checked), the
      flight ring's step boundary (progress for the hang watchdog) and
      the numerics fingerprint boundary;
    - around it, a ``step`` span in the host trace (``HOROVOD_TIMELINE``);
    - after it: the guard's verdict read from the returned state
      (:func:`~horovod_tpu_torch.resilience.numerics.maybe_note_output`),
      a health beat, and with metrics on ``<name>_steps``/
      ``<name>_examples`` counters, the ``<name>_step_seconds``
      histogram of the call-to-call interval, ``<name>_examples_per_sec``
      and ``<name>_mfu`` (against
      :func:`~horovod_tpu_torch.profiler.device_peak_flops` times the
      world size; not set on an untabled device or without
      ``flops_per_step``), the SLO plane's ``step_time`` and the
      regression sentinel.

    It changes nothing the step computes. Attribute access delegates to
    the wrapped step (``.hooks``, ``.last_exchange``)."""

    def __init__(self, fn, *, batch_arg: Optional[int] = None,
                 examples_per_step: Optional[int] = None,
                 flops_per_step: Optional[float] = None,
                 name: str = "train"):
        self._fn = fn
        self._batch_arg = batch_arg
        self._examples = examples_per_step
        self._flops = flops_per_step
        self._name = name
        self._last_t: Optional[float] = None
        self._step_idx = 0
        self._peak_total: Optional[float] = None  # world * peak, lazy

    def _peak(self) -> Optional[float]:
        if self._peak_total is None:
            from horovod_tpu_torch import profiler

            peak = profiler.device_peak_flops()
            n = basics.size() if basics.is_initialized() else 1
            self._peak_total = (peak or 0.0) * n
        return self._peak_total or None

    def __call__(self, *args, **kwargs):
        idx = self._step_idx
        _straggler.set_step(idx)
        _sanitizer.set_step(idx)
        _flight.step_boundary(idx)
        _numerics.set_step(idx)
        self._step_idx += 1
        with _trace.span("step", f"{self._name} step {idx}", step=idx):
            out = self._fn(*args, **kwargs)
        _numerics.maybe_note_output(idx, out)
        _health.beat()
        if not _metrics.enabled():
            return out
        now = time.perf_counter()
        name = self._name
        examples = self._examples
        if examples is None and self._batch_arg is not None:
            try:
                examples = int(args[self._batch_arg].shape[0])
            except (IndexError, AttributeError, TypeError):
                examples = None
        _metrics.counter(f"{name}_steps", help="train steps dispatched").inc()
        if examples:
            _metrics.counter(
                f"{name}_examples", help="examples trained on").inc(examples)
        if self._last_t is not None:
            dt = now - self._last_t
            if dt > 0:
                _metrics.histogram(
                    f"{name}_step_seconds",
                    help="inter-dispatch step interval").observe(dt)
                if examples:
                    _metrics.gauge(
                        f"{name}_examples_per_sec",
                        help="throughput over the last step interval",
                    ).set(examples / dt)
                if self._flops:
                    peak = self._peak()
                    if peak:
                        _metrics.gauge(
                            f"{name}_mfu",
                            help="model FLOP utilization vs device peak",
                        ).set(self._flops / dt / peak)
                _slo.observe("step_time", dt)
                _slo.sample_gauges()
                _regression.track(f"{name}_step_seconds", dt)
                if examples:
                    _regression.track(
                        f"{name}_examples_per_sec", examples / dt)
                wait = _metrics.value("data_wait_seconds_recent")
                if isinstance(wait, (int, float)):
                    _regression.track("data_wait_seconds", float(wait))
        self._last_t = now
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


def instrument_step(fn, *, batch_arg: Optional[int] = None,
                    examples_per_step: Optional[int] = None,
                    flops_per_step: Optional[float] = None,
                    name: str = "train") -> InstrumentedStep:
    """Wrap a step in :class:`InstrumentedStep`. The port's builders
    return the plain step; wrap it to instrument it (``batch_arg=1`` for
    :func:`make_train_step`'s images)."""
    return InstrumentedStep(
        fn, batch_arg=batch_arg, examples_per_step=examples_per_step,
        flops_per_step=flops_per_step, name=name)


def make_loader_step(step_fn: Callable, loader) -> Callable:
    """Adapt a batch-consuming step to the ``(state, i) -> state`` shape
    :func:`horovod_tpu_torch.resilience.run` / ``elastic.run`` drive,
    drawing each step's batch from a
    :class:`~horovod_tpu_torch.data.ResumableLoader`::

        stepped = make_loader_step(
            lambda state, batch, i: train(state, *batch), loader)
        final = resilience.run(stepped, state, num_steps=N)

    The loader's **cursor** — not the loop index — decides what each step
    consumes: a checkpoint resume, an elastic rollback, or a numerics
    replay moves the cursor (with the replay salt folded in), so the
    adapted step re-draws exactly the batches the recovery semantics
    promise. ``step_fn(state, batch, i)`` receives the placed batch (a
    tuple for multi-array sources)."""

    def stepped(state, i):
        batch = loader.next_batch()
        return step_fn(state, batch, i)

    return stepped


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


#: every gradient hook :func:`make_train_step` registered and not yet
#: released, in order (the elastic driver releases a rebuilt step's:
#: those appended while its builder ran)
_step_hooks: list = []


def release_hook(handle) -> None:
    """Remove one gradient hook a step registered."""
    handle.remove()
    if handle in _step_hooks:
        _step_hooks.remove(handle)


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
    _step_hooks.extend(handles)
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


# --------------------------------------------------------------------------
# sequence and pipeline parallelism


def _present(axis: str) -> bool:
    """Whether the process mesh has ``axis`` at a size above 1 (an axis
    of one rank reduces nothing)."""
    from horovod_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return axis in mesh.shape and mesh.shape[axis] > 1


def make_sp_train_step(model, tx, *, data_axis: Optional[str] = None,
                       seq_axis: str = "seq"):
    """Sequence-parallel causal-LM step over the process mesh's
    ``(data, seq)`` axes (:func:`~horovod_tpu_torch.parallel.mesh.
    build_mesh`): ``step(opt_state, tokens, targets) -> (opt_state,
    loss)`` on this rank's ``[B/data, T/seq]`` shard of the tokens and of
    the targets (rolled globally before sharding).

    Build the model with an attention over the ``seq`` axis
    (``functools.partial(ring_attention, axis_name=seq_axis)`` or
    :func:`~horovod_tpu_torch.parallel.ulysses_attention`). The step
    passes each shard's global ``positions`` (``seq_index * T_local +
    arange``), takes :func:`token_xent` of the shard, and averages the
    gradients and the loss over ``data`` (``data_axis``, default
    ``"data"``; absent means one) and then over ``seq``: one flat
    all-reduce per axis and dtype. The parameters (``model.jax_params()``)
    are updated in place, as :func:`make_train_step` does; ``tx`` is a
    plain optimizer (``opt_state = tx.init(model.jax_params())``)."""
    from horovod_tpu_torch.ops.collective import grouped_allreduce
    from horovod_tpu_torch.parallel import spmd

    dax = data_axis or "data"
    params = model.jax_params()
    keys = tree_keys(params)

    def step(opt_state, tokens, targets):
        model.train()
        for p in model.parameters():
            p.grad = None
        t_local = tokens.shape[1]
        positions = (spmd.axis_index(seq_axis) * t_local + torch.arange(
            t_local, device=tokens.device))[None, :]
        loss = token_xent(model(tokens, positions), targets)
        loss.backward()
        grads = model.jax_grads()
        flat = [grads[k] if grads[k] is not None
                else torch.zeros_like(params[k]) for k in keys]
        flat.append(loss.detach())
        for ax in (dax, seq_axis):
            if _present(ax):
                flat = grouped_allreduce(flat, Average, axis=ax)
        with torch.no_grad():
            updates, opt_state = tx.update(dict(zip(keys, flat[:-1])),
                                           opt_state, params)
            for k, u in updates.items():
                params[k].add_(u)
        return opt_state, flat[-1]

    return step


def _pp_apply(interleaved: bool):
    from horovod_tpu_torch.parallel import pipeline

    return (pipeline.pipeline_apply_interleaved if interleaved
            else pipeline.pipeline_apply)


def _with_grad(tree: dict) -> dict:
    return {k: v.requires_grad_(True) for k, v in tree.items()}


def make_pp_train_step(stage_fn: Callable, tx, *,
                       loss_fn: Optional[Callable] = None,
                       interleaved: bool = False,
                       axis: Optional[str] = None):
    """Pipeline-parallel step over the ``pipe`` axis: ``step(stacked,
    opt_state, x_micro, y_micro) -> (stacked, opt_state, loss)``.

    ``stacked`` is this rank's slice of the stage-stacked parameters, a
    flat dict of ``[1, ...]`` leaves (``[1, v, ...]`` with
    ``interleaved=True``): what ``shard_map`` hands a device of the
    ``P("pipe")``-sharded :func:`~horovod_tpu_torch.parallel.
    make_stage_params` (or :func:`~horovod_tpu_torch.parallel.
    make_interleaved_stage_params`) tree; ``stage_fn(params, activation)``
    gets the dict with the leading dim taken off. ``opt_state =
    tx.init(stacked)``. ``x_micro``/``y_micro`` ``[n_micro, mb, ...]`` are
    replicated; ``loss_fn`` defaults to the mean squared error.

    The loss is computed on every rank from the ``psum`` of the pipeline's
    output; psum's backward is a psum, so each rank's stage gradient
    over-counts by the pipe size and is divided by it before the update,
    as in the JAX package. ``stacked`` is updated in place and returned."""
    from horovod_tpu_torch.parallel import spmd

    if loss_fn is None:
        loss_fn = lambda out, y: torch.mean((out - y) ** 2)  # noqa: E731
    ax = axis or "pipe"
    apply_fn = _pp_apply(interleaved)

    def step(stacked, opt_state, xm, ym):
        keys = tree_keys(stacked)
        stacked = _with_grad(stacked)
        out = apply_fn(stage_fn, {k: v[0] for k, v in stacked.items()}, xm,
                       axis_name=ax)
        loss = loss_fn(spmd.psum(out, ax), ym)  # valid on the last stage only
        grads = torch.autograd.grad(loss, [stacked[k] for k in keys])
        k_size = spmd.axis_size(ax)
        with torch.no_grad():
            updates, opt_state = tx.update(
                {k: g / k_size for k, g in zip(keys, grads)}, opt_state,
                stacked)
            for k, u in updates.items():
                stacked[k].add_(u)
        return stacked, opt_state, loss.detach()

    return step


def split_transformer_for_pp(model, params: dict, n_stages: int, *,
                             interleaved_v: int = 1) -> dict:
    """Split a TransformerLM's flax-keyed parameters (``model.jax_params()``)
    for pipeline parallelism: ``depth`` blocks grouped into ``n_stages *
    interleaved_v`` stages (stage s holds blocks ``s*per .. s*per+per-1``
    as ``b0 .. b{per-1}``), stacked ``[S, ...]`` (GPipe) or ``[S, v, ...]``
    round-robin (interleaved), and the replicated embedding and head
    apart. Returns ``{"embed": {...}, "stages": {...}, "head": {...}}``,
    flat dicts; rank r of the pipe axis takes ``stages[k][r:r+1]``."""
    from horovod_tpu_torch.parallel.pipeline import (
        make_interleaved_stage_params, make_stage_params,
    )

    n_total = n_stages * interleaved_v
    if model.depth % n_total != 0:
        raise ValueError(
            f"depth {model.depth} not divisible by n_stages*v = {n_total}"
        )
    if model.use_rope:
        raise ValueError(
            "PP transformer currently supports pos_embedding='learned' "
            "(positions resolve at embed time; rope would need per-stage "
            "position plumbing)"
        )
    per = model.depth // n_total
    stage_trees = []
    for s in range(n_total):
        tree = {}
        for j in range(per):
            pre = f"block{s * per + j}/"
            tree.update({f"b{j}/{k[len(pre):]}": v for k, v in params.items()
                         if k.startswith(pre)})
        stage_trees.append(tree)
    stacked = (make_interleaved_stage_params(stage_trees, n_stages)
               if interleaved_v > 1 else make_stage_params(stage_trees))
    embed = {k: params[k] for k in ("tok_embed/embedding", "pos_embed")}
    head = {k: v for k, v in params.items()
            if k.startswith(("ln_f/", "lm_head/"))}
    return {"embed": embed, "stages": stacked, "head": head}


def make_transformer_pp_train_step(model, tx, *, interleaved_v: int = 1,
                                   axis: Optional[str] = None):
    """Pipeline-parallel causal-LM step for a TransformerLM (learned
    positions): embedding, blocks and head all trained.
    ``step(params, opt_state, tokens_micro, targets_micro) -> (params,
    opt_state, loss)``; ``params`` is :func:`split_transformer_for_pp`'s
    split (same ``interleaved_v``) with ``stages`` cut to this rank's
    ``[1, ...]`` slice, ``opt_state = {part: tx.init(params[part])}``,
    tokens and targets ``[n_micro, mb, T]`` replicated. The parameters
    are updated in place.

    The stages run the port's :class:`~horovod_tpu_torch.models.
    transformer.TransformerBlock` (the model's attention function: on
    CUDA tensors ``flash_attention``'s kernel), the head its
    ``LayerNorm`` and ``Dense``, through ``torch.func.functional_call``.
    Gradient bookkeeping over the pipe axis, as the JAX package's:
    stages divided by S (psum's backward over-counts), the embedding
    psum-ed over the axis and divided by S (only stage 0 reads it), the
    head pmean-ed (its per-rank gradient is the true one); the embedding
    and head in one flat all-reduce per dtype."""
    from torch.func import functional_call

    from horovod_tpu_torch.models.layers import Dense, LayerNorm
    from horovod_tpu_torch.models.transformer import TransformerBlock
    from horovod_tpu_torch.ops.collective import Sum, grouped_allreduce
    from horovod_tpu_torch.parallel import spmd

    ax = axis or "pipe"
    n_stages = spmd.axis_size(ax)
    if model.depth % (n_stages * interleaved_v) != 0:
        raise ValueError(
            f"depth {model.depth} not divisible by n_stages*v = "
            f"{n_stages * interleaved_v}; pass the same interleaved_v used "
            f"in split_transformer_for_pp"
        )
    per = model.depth // (n_stages * interleaved_v)
    apply_fn = _pp_apply(interleaved_v > 1)
    b0 = model.block0
    dim, vocab = b0.dim, model.lm_head.weight.shape[0]
    block = TransformerBlock(
        dim, b0.heads, b0.mlp_up.weight.shape[0] // dim, dtype=model.dtype,
        attention_fn=b0.attention_fn,
        kv_heads=None if b0.h_kv == b0.heads else b0.h_kv, device="meta")
    ln_f = LayerNorm(dim, dtype=model.dtype, device="meta")
    lm_head = Dense(dim, vocab, bias=False, dtype=model.dtype, device="meta")

    def call(module, tree: dict, x):
        if hasattr(module, "from_jax"):     # a layer: its own leaves
            tp = {k: v.contiguous()
                  for k, v in module.from_jax(tree.__getitem__).items()}
        else:
            tp = torch_params(module, tree)
        return functional_call(module, tp, (x,))

    def embed_fn(ep, tokens):
        # the JAX package's order: take the f32 rows, then cast (so the
        # table's gradient accumulates in f32)
        t = tokens.shape[-1]
        x = torch.nn.functional.embedding(
            tokens.long(), ep["tok_embed/embedding"]).to(model.dtype)
        return x + ep["pos_embed"][:t].to(model.dtype)

    def stage_fn(sp, h):
        for j in range(per):
            pre = f"b{j}/"
            h = call(block, {k[len(pre):]: v for k, v in sp.items()
                             if k.startswith(pre)}, h)
        return h

    def head_fn(hp, x):
        x = call(ln_f, {k[len("ln_f/"):]: v for k, v in hp.items()
                        if k.startswith("ln_f/")}, x)
        return call(lm_head, {"kernel": hp["lm_head/kernel"]}, x).float()

    def step(params, opt_state, toks_m, tgts_m):
        parts = {p: _with_grad(params[p]) for p in ("embed", "stages", "head")}
        keys = {p: tree_keys(parts[p]) for p in parts}
        h = embed_fn(parts["embed"], toks_m)
        out = apply_fn(stage_fn, {k: v[0] for k, v in parts["stages"].items()},
                       h, axis_name=ax)
        loss = token_xent(head_fn(parts["head"], spmd.psum(out, ax)), tgts_m)
        flat = [parts[p][k] for p in parts for k in keys[p]]
        grads = dict(zip([(p, k) for p in parts for k in keys[p]],
                         torch.autograd.grad(loss, flat)))
        S = n_stages
        g = {"stages": {k: grads["stages", k] / S for k in keys["stages"]}}
        # the embedding: psum / S; the head: pmean (psum / S too)
        eh = [(p, k) for p in ("embed", "head") for k in keys[p]]
        red = [grads[pk] for pk in eh]
        if S > 1:
            red = grouped_allreduce(red, Sum, axis=ax)
        for (p, k), r in zip(eh, red):
            g.setdefault(p, {})[k] = r / S
        new_opt = {}
        with torch.no_grad():
            for p in ("stages", "embed", "head"):
                updates, new_opt[p] = tx.update(g[p], opt_state[p], parts[p])
                for k, u in updates.items():
                    parts[p][k].add_(u)
        return parts, new_opt, loss.detach()

    return step
