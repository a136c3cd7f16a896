"""The data-parallel training step.

Counterpart of ``horovod_tpu/training.py``'s per-rank step
(``make_shardmap_train_step``): forward and backward on this rank's
batch, the gradient exchange, the optimizer update, BatchNorm running
stats and the loss averaged across ranks. The same step trains the
ResNets (``softmax_xent``) and the TransformerLM (``loss_fn=lm_xent``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops.collective import Average, allreduce
from horovod_tpu_torch.optim import DistributedTransform, tree_keys


def softmax_xent(logits, labels):
    """Cross entropy with integer labels (mean over the batch)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def lm_xent(logits, targets):
    """Next-token cross entropy: log-softmax in f32, the target's entry,
    mean over ``[B, T]`` (the JAX LM benchmark's loss)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def make_train_step(model, tx, *, shard_optimizer: bool = False,
                    compression=None, reduce_op=Average,
                    loss_fn: Callable = softmax_xent,
                    on_phase: Optional[Callable[[str], None]] = None):
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

    ``on_phase(name)``, if given, is called as each part of the step
    ends: ``"forward"`` (forward and loss), ``"backward"`` (and, with a
    plain ``tx``, the gradient allreduce), ``"optimizer"`` (the update,
    the exchange inside a DistributedOptimizer, the running stats) and
    ``"loss"`` (the loss allreduce). A hook that synchronises the device
    and reads a clock splits the step's time."""
    distributed = isinstance(tx, DistributedTransform)
    mark = on_phase or (lambda name: None)
    if shard_optimizer and not (distributed and tx.shard_optimizer):
        raise ValueError(
            "shard_optimizer=True needs tx = DistributedOptimizer(..., "
            "shard_optimizer=True)")
    if distributed and tx.shard_optimizer != shard_optimizer:
        raise ValueError("tx was built with shard_optimizer="
                         f"{tx.shard_optimizer}; pass the same here")
    params = model.jax_params()
    stats = model.jax_batch_stats()
    stat_keys = tree_keys(stats)

    def step(opt_state, images, labels):
        model.train()
        for p in model.parameters():
            p.grad = None
        loss = loss_fn(model(images), labels)
        mark("forward")
        loss.backward()
        grads = model.jax_grads()
        if not distributed:
            grads = {k: allreduce(grads[k], reduce_op, compression=compression)
                     for k in tree_keys(grads)}
        mark("backward")
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            for k, u in updates.items():
                params[k].add_(u)
            if stat_keys:
                # keep the running stats replicated: one flat allreduce
                flat = torch.cat([stats[k].reshape(-1) for k in stat_keys])
                flat = allreduce(flat, Average)
                off = 0
                for k in stat_keys:
                    n = stats[k].numel()
                    stats[k].copy_(flat[off:off + n].view(stats[k].shape))
                    off += n
        mark("optimizer")
        loss = allreduce(loss.detach(), Average)
        mark("loss")
        return opt_state, loss

    return step


def shard_batch(batch: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows ``r*B/N : (r+1)*B/N`` of a global batch
    (the layout ``P(data)`` gives rank r in the JAX package)."""
    r, n = basics.rank(), basics.size()
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"global batch {b} is not divisible by world size {n}")
    per = b // n
    return batch[r * per:(r + 1) * per]
