"""Pipeline parallelism over the ``pipe`` mesh axis: GPipe and the
interleaved (circular) schedule.

Counterpart of ``horovod_tpu/parallel/pipeline.py``, whose tick loop is a
``lax.scan`` inside ``shard_map``. Every rank runs the same tick loop:
each tick it applies its stage to the activation it holds and hands the
result to the next stage with ONE :func:`~horovod_tpu_torch.parallel.
spmd.ppermute` (a cyclic shift; its backward is the reverse shift, so
autograd through the loop is the mirrored backward schedule). The last
tick's shift is left out: nothing reads what it would deliver.

Bubble ticks run the stage on what the rank holds (zeros, or a clamped
micro-batch), as the JAX scan does: every rank then builds the same
autograd graph, so the backward's shifts meet in the same order on every
rank (a rank that skipped a tick would leave its peer's shift without a
partner). Host flags enter the graph as 0-d boolean tensors of
``torch.where``, as ``jnp.where`` takes the traced ones. A stage thus
runs ``n_ticks`` times a call: ``M + S - 1`` for GPipe, ``M*v + L`` for
the interleaved schedule.

The interleaved schedule's ``meta`` carry (drain-first greedy: a rank
prefers the activation it received over injecting a fresh micro-batch)
is simulated on the host, tick for tick as the JAX scan computes it
(:func:`interleaved_schedule`).

Outputs are valid on the last stage and zero elsewhere (a ``psum`` over
the axis finalizes them).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from horovod_tpu_torch import pytree
from horovod_tpu_torch.parallel import spmd
from horovod_tpu_torch.parallel.mesh import PIPELINE_AXIS


def _tree_map(fn, *trees):
    leaves, treedef = pytree.flatten(trees[0])
    rest = [pytree.flatten(t)[0] for t in trees[1:]]
    return pytree.unflatten(treedef, [fn(*xs) for xs in zip(leaves, *rest)])


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(bool(value), device=like.device)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, *,
                   axis_name: str = PIPELINE_AXIS):
    """Run micro-batches through the GPipe schedule.

    ``stage_fn(stage_params, activation) -> activation`` (same shape) is
    applied by every rank to its own stage; ``stage_params`` are this
    rank's stage's parameters; ``x_micro`` ``[n_micro, mb, ...]`` is
    replicated over the axis (stage 0 reads micro-batch t at tick t).
    Returns ``[n_micro, mb, ...]``, valid on the last stage and zero
    elsewhere. ``n_micro + S - 1`` ticks, ``n_micro + S - 2`` shifts."""
    n_stages = spmd.axis_size(axis_name)
    idx = spmd.axis_index(axis_name)
    n_micro = x_micro.shape[0]
    n_ticks = n_micro + n_stages - 1
    shift = tuple((i, (i + 1) % n_stages) for i in range(n_stages))
    first = _flag(idx == 0, x_micro)
    acts = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                       device=x_micro.device)
    outs = []
    for t in range(n_ticks):
        # stage 0 ingests micro-batch t (clamped; its output unused once
        # t >= n_micro)
        acts = torch.where(first, x_micro[min(t, n_micro - 1)], acts)
        out = stage_fn(stage_params, acts)
        outs.append(out)
        if t < n_ticks - 1:
            acts = spmd.ppermute(out, axis_name, shift)
    # the last stage produced micro-batch m at tick m + S - 1; zeros
    # elsewhere, through the graph, so a psum of the result has a
    # backward on every rank
    take = torch.stack(outs[n_stages - 1:])
    return torch.where(_flag(idx == n_stages - 1, take), take,
                       torch.zeros_like(take))


def make_stage_params(params_list):
    """Stack per-stage parameter trees into one ``[n_stages, ...]`` tree
    (rank s of the pipe axis takes index s)."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *params_list)


def make_interleaved_stage_params(params_list, n_devices: int):
    """Stack ``L = n_devices * v`` per-stage trees for the interleaved
    schedule: stage ``k`` lives on device ``k % n_devices`` at wrap level
    ``k // n_devices``. Returns a ``[n_devices, v, ...]`` tree; rank d of
    the pipe axis takes index d, its ``[v, ...]`` local stack."""
    L = len(params_list)
    if L % n_devices != 0:
        raise ValueError(
            f"interleaved pipeline needs stages ({L}) divisible by devices "
            f"({n_devices})"
        )
    v = L // n_devices
    by_device = [params_list[w * n_devices + d]
                 for d in range(n_devices) for w in range(v)]
    return _tree_map(
        lambda *leaves: torch.stack(leaves).reshape(
            (n_devices, v) + tuple(leaves[0].shape)), *by_device)


class Tick(NamedTuple):
    """One device's tick of the interleaved schedule: ``held`` (it holds
    a received activation), ``feed`` (the micro-batch it would inject),
    ``w`` (the wrap level whose stage it applies), ``mb`` (the
    micro-batch), ``active`` (it holds or injects real work), ``final``
    (its output is micro-batch ``mb``'s last stage's) and ``recv`` (what
    arrives for the next tick is valid)."""

    held: bool
    feed: int
    w: int
    mb: int
    active: bool
    final: bool
    recv: bool


def interleaved_schedule(n_devices: int, v: int, n_micro: int) -> list:
    """The JAX scan's drain-first schedule, simulated on the host:
    ``ticks[t][d]`` is device d's :class:`Tick` at tick t, over the
    ``M*v + L`` ticks of the scan (the greedy make-span is ``M*v + S -
    1``; the slack is idle). A device holds at most one activation: it
    applies a held one, else device 0 injects the next micro-batch."""
    S, M = n_devices, n_micro
    L = S * v
    n_ticks = M * v + L
    meta = [(False, 0, 0)] * S  # (valid, wrap, mb) arriving this tick
    injected = [0] * S
    ticks = []
    for _ in range(n_ticks):
        row, sent = [], []
        for d in range(S):
            held, w_in, mb_in = meta[d]
            can_inject = d == 0 and not held and injected[d] < M
            w = w_in if held else 0
            mb = mb_in if held else injected[d]
            active = held or can_inject
            final = active and w * S + d == L - 1
            sent.append((active and not final,
                         w + (1 if d == S - 1 else 0), mb))
            row.append([held, min(injected[d], M - 1), w, mb, active, final])
            injected[d] += int(can_inject)
        meta = [sent[(d - 1) % S] if sent[(d - 1) % S][0] else (False, 0, 0)
                for d in range(S)]
        ticks.append([Tick(*r, recv=meta[d][0]) for d, r in enumerate(row)])
    return ticks


def pipeline_apply_interleaved(stage_fn: Callable, stage_params, x_micro, *,
                               axis_name: str = PIPELINE_AXIS):
    """Interleaved (circular) pipeline: each rank holds ``v``
    non-adjacent stages (``stage_params``: its ``[v, ...]`` stack from
    :func:`make_interleaved_stage_params`) and activations loop ``v``
    times around the ring; the bubble fraction falls to ``(S-1)/(M*v +
    S-1)``. Every tick is one shift, as in GPipe. Returns ``[n_micro,
    mb, ...]``, valid on the last rank and zero elsewhere."""
    S = spmd.axis_size(axis_name)
    idx = spmd.axis_index(axis_name)
    v = pytree.flatten(stage_params)[0][0].shape[0]
    M = x_micro.shape[0]
    ticks = interleaved_schedule(S, v, M)
    shift = tuple((i, (i + 1) % S) for i in range(S))
    on, off = _flag(True, x_micro), _flag(False, x_micro)
    slot = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                       device=x_micro.device)
    outs = []
    for t, row in enumerate(ticks):
        tick = row[idx]
        act = torch.where(on if tick.held else off, slot, x_micro[tick.feed])
        out = stage_fn(_tree_map(lambda p: p[tick.w], stage_params), act)
        outs.append(out)
        if t < len(ticks) - 1:
            # a valid slot is always consumed the tick it arrives, so the
            # next slot is whatever arrived (or empty)
            recv = spmd.ppermute(out, axis_name, shift)
            slot = torch.where(on if tick.recv else off, recv,
                               torch.zeros_like(recv))
    # scatter the completed micro-batches into place; every other tick
    # adds zeros (through the graph, as in GPipe)
    outs = torch.stack(outs)
    final = torch.tensor([row[idx].final for row in ticks],
                         device=outs.device).view((-1,) + (1,) * (outs.dim() - 1))
    contrib = torch.where(final, outs, torch.zeros_like(outs))
    # (an idle tick's micro-batch index may run past the end: its zeros
    # go to the last slot, where JAX's scatter drops them)
    mbs = torch.tensor([min(row[idx].mb, M - 1) for row in ticks],
                       device=outs.device)
    return outs.new_zeros((M,) + tuple(outs.shape[1:])).index_add(
        0, mbs, contrib)
