"""Carry weights and optimizer state across from the JAX package.

The JAX package's ``params`` / ``batch_stats`` are nested dicts keyed by
flax module names; the port keys the same leaves by their ``/``-joined
path (:meth:`ResNet.jax_params`), as views in flax's layouts, so loading
is a copy through those views. Arrays arrive as numpy (the two
frameworks exchange data only through numpy). :func:`port_model` builds
the port's counterpart of a flax model of the JAX package (ResNet, VGG,
Inception V3, MLP, MNIST CNN; the TransformerLM's configuration is
mapped by hand, its attention function being a choice of the port's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def port_model(flax_model, *, seed: int = 0, device=None, **inferred):
    """The port's model of the same configuration as ``flax_model``, a
    flax module of the JAX package, built from its fields (read, never
    imported). ``inferred`` gives what flax infers at init from the
    input: VGG's and the MNIST CNN's ``input_size``, the MLP's
    ``in_features``. Load the weights with :func:`load_flax_variables`."""
    from horovod_tpu_torch import models as M

    f, name = flax_model, type(flax_model).__name__
    kw = dict(seed=seed, device=device, **inferred)
    dtype = getattr(torch, np.dtype(getattr(f, "dtype", None) or
                                    np.float32).name)
    if name == "ResNet":
        block = {"BottleneckBlock": M.BottleneckBlock,
                 "ResNetBlock": M.ResNetBlock}[f.block_cls.__name__]
        return M.ResNet(list(f.stage_sizes), block, num_classes=f.num_classes,
                        num_filters=f.num_filters, dtype=dtype, **kw)
    if name == "VGG":
        return M.VGG(tuple(map(tuple, f.stages)), num_classes=f.num_classes,
                     hidden_dim=f.hidden_dim, use_bn=f.use_bn, dtype=dtype,
                     **kw)
    if name == "InceptionV3":
        return M.InceptionV3(num_classes=f.num_classes, dtype=dtype, **kw)
    if name == "MLP":
        return M.MLP(tuple(f.features), **kw)
    if name == "MnistCNN":
        return M.MnistCNN(f.num_classes, **kw)
    raise ValueError(f"no port model for {name}")


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` → nested dict."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@torch.no_grad()
def _copy_into(views: dict, src: dict, what: str) -> None:
    src = flatten_tree(src)
    if set(src) != set(views):
        missing = sorted(set(views) - set(src))[:5]
        extra = sorted(set(src) - set(views))[:5]
        raise KeyError(f"{what} do not match the model: missing {missing}, "
                       f"unexpected {extra}")
    for k, view in views.items():
        a = np.asarray(src[k])
        if tuple(a.shape) != tuple(view.shape):
            raise ValueError(
                f"{what} {k}: shape {a.shape} != model's {tuple(view.shape)}")
        view.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def load_flax_variables(model, params: dict,
                        batch_stats: Optional[dict] = None) -> None:
    """Overwrite ``model``'s parameters (and BatchNorm running stats) with
    the JAX package's ``params`` (``batch_stats``), numpy leaves."""
    _copy_into(model.jax_params(), params, "params")
    if batch_stats is not None:
        _copy_into(model.jax_batch_stats(), batch_stats, "batch_stats")


def torch_weights(model, params: dict, device) -> dict:
    """``params`` (the JAX package's nested tree, or flat ``a/b/c`` keys;
    numpy or tensor leaves, in flax's layouts) as ``{parameter name:
    tensor}`` in ``model``'s layouts on ``device``, what
    ``torch.func.functional_call(model, ...)`` takes. Leaves already on
    ``device`` are not copied before the layout change."""
    from horovod_tpu_torch.models.layers import torch_params
    from horovod_tpu_torch.training import host_tensor

    def dev(v):
        t = v if isinstance(v, torch.Tensor) else host_tensor(v)
        return t.to(device)

    return torch_params(model, {k: dev(v)
                                for k, v in flatten_tree(params).items()})


def flax_params(model) -> dict:
    """The model's parameters as the JAX package's nested numpy tree."""
    return unflatten_tree({k: v.detach().cpu().numpy().copy()
                           for k, v in model.jax_params().items()})


def zero1_state_from_jax(count, mu: dict, nu: dict, rank: int, *,
                         residual: Optional[dict] = None) -> dict:
    """One rank's port ZeRO-1 state from the JAX package's ``[N, shard]``
    Adam state: ``count`` ``[N]``, ``mu``/``nu`` ``{dtype: [N, s]}`` and,
    with error feedback, ``residual`` ``{dtype: [N, Lp]}`` (numpy)."""
    count = np.asarray(count)
    n = int(count.shape[0])
    t = lambda a: _rows_tensor(np.asarray(a)[rank])  # noqa: E731
    state = {
        "shard": {"rank": int(rank), "size": n},
        "inner": {"count": int(count[rank]),
                  "mu": {k: t(v) for k, v in mu.items()},
                  "nu": {k: t(v) for k, v in nu.items()}},
    }
    if residual is not None:
        state["residual"] = {k: t(v) for k, v in residual.items()}
    return state


def _rows_tensor(a) -> torch.Tensor:
    # numpy has no bf16 of its own: ml_dtypes' bfloat16, or the |V2 bits a
    # checkpoint restores
    from horovod_tpu_torch.training import host_tensor

    return host_tensor(a)


def fsdp_params_from_jax(shards: dict, like: dict, rank: int):
    """One rank's port :class:`~horovod_tpu_torch.optim.FsdpParams` from
    the JAX package's ZeRO-3 rows ``{group: [N, s]}`` (numpy): row
    ``rank`` of each group. ``like`` is the parameter tree the rows were
    packed from (e.g. ``model.jax_params()``; only its keys, shapes and
    dtypes are read)."""
    from horovod_tpu_torch.optim import (
        FsdpParams, _fsdp_meta, tree_keys,
    )

    keys = tree_keys(like)
    n = int(np.shape(next(iter(shards.values())))[0])
    meta = _fsdp_meta(keys, [like[k].shape for k in keys],
                      [like[k].dtype for k in keys], rank, n)
    groups = meta.groups
    if set(groups) != set(shards):
        raise KeyError(f"groups {sorted(shards)} != the tree's {sorted(groups)}")
    for k, g in groups.items():
        if tuple(np.shape(shards[k])) != (n, g.Lp // n):
            raise ValueError(f"group {k}: rows {np.shape(shards[k])} != "
                             f"{(n, g.Lp // n)}")
    return FsdpParams({k: _rows_tensor(v[rank]) for k, v in shards.items()},
                      meta)


def _adam_from_jax(inner):
    """optax Adam's ``(ScaleByAdamState(count, mu, nu), EmptyState, ...)``
    as the port's ``{"count", "mu", "nu"}`` (a 0-d count as an int, a
    ZeRO-1 ``[N]`` count as it is); ``None`` for any other state."""
    if not isinstance(inner, tuple) or hasattr(inner, "_fields"):
        return None
    names = [type(s).__name__ for s in inner]
    if names.count("ScaleByAdamState") != 1 or any(
            n not in ("ScaleByAdamState", "EmptyState") for n in names):
        return None
    a = inner[names.index("ScaleByAdamState")]
    count = a.count
    if np.ndim(count) == 0:
        count = int(np.asarray(count))
    return {"count": count, "mu": flatten_tree(dict(a.mu)),
            "nu": flatten_tree(dict(a.nu))}


def _sgd_from_jax(inner):
    """optax SGD's ``(TraceState(trace), EmptyState)`` as the port's
    ``{"trace"}``, ``(EmptyState, EmptyState)`` (no momentum) as ``{}``;
    ``None`` for any other state."""
    if not isinstance(inner, tuple) or hasattr(inner, "_fields"):
        return None
    names = [type(s).__name__ for s in inner]
    if any(n not in ("TraceState", "EmptyState") for n in names) or \
            names.count("TraceState") > 1 or not names:
        return None
    if "TraceState" not in names:
        return {}
    return {"trace": flatten_tree(dict(
        inner[names.index("TraceState")].trace))}


def opt_state_from_jax(state):
    """A JAX package optimizer state (as ``checkpoint.restore`` gives it)
    in the port's layout; a state of another kind comes back as it is.

    - optax Adam → ``{"count", "mu", "nu"}`` (trees flattened to the
      port's ``/``-joined keys); optax SGD → ``{"trace"}`` (``{}`` without
      momentum);
    - optax ``inject_hyperparams`` → ``{"count", "hyperparams": {name:
      float}, "inner_state"}`` (:func:`~horovod_tpu_torch.optim.
      inject_hyperparams`'s), its inner state converted;
    - ``_EFState(inner, residual)`` → ``{"inner", "residual"}``;
    - ``_PowerSGDState(inner, residual, q)`` → ``{"inner", "residual",
      "q"}``, ``q`` with ``None`` for the leaves that do not factorize;
    - ZeRO-1 (Adam's ``count`` is ``[N]``) → the same with ``"shard":
      {"size": N}``: the consolidated view
      ``checkpoint.consolidate_opt_state`` re-packs for each rank;
    - optax ``MultiStepsState`` → the port's (``optim.MultiStepsState``),
      its inner state converted;
    - ``NumericsGuardState`` (the numerics guard's; the port's class has
      the JAX package's name) → the same, its ``inner`` converted and its
      scalars as they are."""
    name = type(state).__name__
    if name in ("InjectHyperparamsState", "InjectStatefulHyperparamsState"):
        return {"count": int(np.asarray(state.count)),
                "hyperparams": {k: float(np.asarray(v))
                                for k, v in dict(state.hyperparams).items()},
                "inner_state": opt_state_from_jax(state.inner_state)}
    if name == "NumericsGuardState":
        return state._replace(inner=opt_state_from_jax(state.inner))
    if name == "MultiStepsState":
        from horovod_tpu_torch.optim import MultiStepsState

        return MultiStepsState(state.mini_step, state.gradient_step,
                               opt_state_from_jax(state.inner_opt_state),
                               flatten_tree(dict(state.acc_grads)),
                               state.skip_state)
    parts = {"_EFState": ("inner", "residual"),
             "_PowerSGDState": ("inner", "residual", "q")}.get(name)
    if parts is None:
        adam = _adam_from_jax(state)
        if adam is None:
            sgd = _sgd_from_jax(state)
            return state if sgd is None else sgd
        if np.ndim(adam["count"]) == 1:     # a bare ZeRO-1 Adam state
            return {"shard": {"size": int(np.shape(adam["count"])[0])},
                    "inner": adam}
        return adam
    adam = _adam_from_jax(state.inner)
    out = {"inner": state.inner if adam is None else adam}
    for part in parts[1:]:
        out[part] = flatten_tree(dict(getattr(state, part)))
    if adam is not None and np.ndim(adam["count"]) == 1:
        out["shard"] = {"size": int(np.shape(adam["count"])[0])}
    return out


def powersgd_q_from_jax(q: dict, rank: Optional[int] = None) -> dict:
    """The port's ``Q`` of a JAX package PowerSGD state: its ``q`` tree
    flattened to the port's keys, as tensors; ``rank`` takes that row of
    a ZeRO-1 state's ``[N, m, r]`` tiles. The JAX package draws its
    initial ``Q`` from ``jax.random`` and the port from its own
    generator, so a run that is to follow the JAX package's carries its
    ``Q`` over with this."""
    out = {}
    for k, v in flatten_tree(dict(q)).items():
        if v is not None:
            v = np.asarray(v)
            v = torch.from_numpy(np.array(v if rank is None else v[rank]))
        out[k] = v
    return out
