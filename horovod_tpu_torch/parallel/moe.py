"""Expert parallelism (Mixture-of-Experts) over the ``expert`` mesh axis.

Counterpart of ``horovod_tpu/parallel/moe.py``, in the GShard/Switch
formulation: routing as one-hot einsum dispatch and combine (dense f32
products), the token exchange as one tiled
:func:`~horovod_tpu_torch.parallel.spmd.all_to_all` per direction over
the axis's sub-group. Top-1 (Switch) or top-2 (GShard) routing with a
static capacity ``ceil(T * factor / E_total)``: tokens beyond an
expert's capacity are dropped (their output is zero). Dispatch and
combine are each other's transpose, so the layer is differentiable end
to end, router included.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from horovod_tpu_torch import pytree
from horovod_tpu_torch.parallel import spmd
from horovod_tpu_torch.parallel.mesh import EXPERT_AXIS


def _one_hot(idx, n: int):
    return F.one_hot(idx.long(), n).float()


def _build_dispatch(onehot, pos, gate, capacity):
    """``[T, E, C]`` 0/1 dispatch and gate-weighted combine for one routing
    choice: token t lands in expert e's buffer slot ``pos[t]`` when it
    fits."""
    keep = (pos < capacity).float()
    # a position past the buffer has no slot: its one-hot row is zero,
    # as jax.nn.one_hot gives for an index out of range
    pos_oh = _one_hot(torch.clamp(pos, max=capacity), capacity + 1)[:, :capacity]
    d = onehot[:, :, None] * pos_oh[:, None, :] * keep[:, None, None]
    return d, d * gate[:, None, None]


def top1_dispatch(gates_logits, capacity: int):
    """Switch-style top-1 routing: ``gates_logits`` ``[T, E]`` router logits;
    returns ``(dispatch [T, E, C] 0/1, combine [T, E, C] gate-weighted,
    aux)``, aux the Switch load-balancing loss."""
    e = gates_logits.shape[1]
    gates = torch.softmax(gates_logits.float(), dim=-1)
    onehot = _one_hot(torch.argmax(gates, dim=-1), e)        # [T, E]
    # position of each token within its expert's buffer (masked to the
    # selected expert before summing)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot       # [T, E]
    pos_in_expert = pos.sum(dim=-1)                          # [T]
    gate_val = (gates * onehot).sum(dim=-1)                  # [T]
    dispatch, combine = _build_dispatch(onehot, pos_in_expert, gate_val,
                                        capacity)
    density = onehot.mean(dim=0)
    density_proxy = gates.mean(dim=0)
    aux = (density * density_proxy).sum() * e
    return dispatch, combine, aux


def top2_dispatch(gates_logits, capacity: int):
    """GShard-style top-2 routing: each token goes to its two best experts
    with combine weights renormalized over the pair; second choices take
    buffer positions after ALL first choices of their expert, so under
    pressure they drop first. Same contract as :func:`top1_dispatch`."""
    e = gates_logits.shape[1]
    gates = torch.softmax(gates_logits.float(), dim=-1)
    oh1 = _one_hot(torch.argmax(gates, dim=-1), e)
    gates2 = gates * (1.0 - oh1)                             # mask choice 1
    oh2 = _one_hot(torch.argmax(gates2, dim=-1), e)

    g1 = (gates * oh1).sum(dim=-1)
    g2 = (gates * oh2).sum(dim=-1)
    denom = torch.clamp_min(g1 + g2, 1e-9)
    g1, g2 = g1 / denom, g2 / denom

    pos1 = ((torch.cumsum(oh1, dim=0) - 1.0) * oh1).sum(dim=-1)
    count1 = oh1.sum(dim=0)                                  # [E]
    pos2_e = (torch.cumsum(oh2, dim=0) - 1.0) * oh2 + count1[None, :] * oh2
    pos2 = pos2_e.sum(dim=-1)

    d1, c1 = _build_dispatch(oh1, pos1, g1, capacity)
    d2, c2 = _build_dispatch(oh2, pos2, g2, capacity)
    density = oh1.mean(dim=0)
    density_proxy = gates.mean(dim=0)
    aux = (density * density_proxy).sum() * e
    return d1 + d2, c1 + c2, aux


def moe_capacity(tokens: int, e_total: int, capacity_factor: float) -> int:
    """The static per-expert capacity ``ceil(T * factor / E_total)``,
    at least 1 (the JAX package's expression)."""
    return max(int(-(-tokens * capacity_factor // e_total)), 1)


def expert_parallel_moe(router_params, expert_params, x, expert_fn: Callable,
                        *, axis_name: str = EXPERT_AXIS,
                        capacity_factor: float = 2.0,
                        routing: str = "top1"):
    """An expert-parallel MoE FFN on this rank's tokens.

    ``router_params`` ``[D, E_total]`` (replicated); ``expert_params``
    this rank's experts' parameters, leading dim ``E_local = E_total /
    axis size`` (rank k holds experts ``[k*E_local, (k+1)*E_local)``);
    ``x`` this rank's tokens ``[T, D]``; ``expert_fn(one_expert_params,
    tokens [C', D]) -> [C', D]``, applied to each local expert. Returns
    ``(y [T, D] in x's dtype, aux)``, aux averaged over the axis."""
    n = spmd.axis_size(axis_name)
    t = x.shape[0]
    leaves, treedef = pytree.flatten(expert_params)
    e_local = leaves[0].shape[0]
    e_total = e_local * n
    capacity = moe_capacity(t, e_total, capacity_factor)
    try:
        dispatch_fn = {"top1": top1_dispatch, "top2": top2_dispatch}[routing]
    except KeyError:
        raise ValueError(
            f"routing must be 'top1' or 'top2', got {routing!r}"
        ) from None

    logits = x.float() @ router_params                       # [T, E_total]
    dispatch, combine, aux = dispatch_fn(logits, capacity)
    # my tokens into per-expert buffers [E_total, C, D], block k of
    # E_local experts belonging to rank k
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())
    # rank k receives ITS experts' buffers from every rank, stacked on the
    # capacity axis: [E_local, n*C, D]
    expert_in = spmd.all_to_all(expert_in, axis_name, split_axis=0,
                                concat_axis=1)
    out = torch.stack([
        expert_fn(pytree.unflatten(treedef, [p[i] for p in leaves]),
                  expert_in[i])
        for i in range(e_local)])
    # inverse exchange: my C slots back from every expert, [E_total, C, D]
    out = spmd.all_to_all(out, axis_name, split_axis=1, concat_axis=0)
    y = torch.einsum("tec,ecd->td", combine, out)
    return y.to(x.dtype), spmd.pmean(aux, axis_name)
