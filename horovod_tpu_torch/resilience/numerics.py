"""Numerics guard: gradient anomaly detection, skip, loss scaling, gates.

Counterpart of ``horovod_tpu/resilience/numerics.py``:

1. **The per-step guard** — :func:`guard` wraps an optimizer (typically a
   :func:`horovod_tpu_torch.optim.DistributedOptimizer`, which applies it
   outermost) so every update first computes the gradients' per-dtype
   square sums in f32 (each leaf's norm from one multi-tensor reduction,
   squared), agreed across ranks by ONE small collective, and
   the finiteness of the norm and of the step's loss. A non-finite value
   or a norm above ``spike_factor`` times the EWMA of good steps marks
   the step **BAD**: the inner update still runs (the collective schedule
   never depends on the verdict), and its outputs are discarded by a
   ``torch.where`` selection — parameters (updates of ``-0.0``),
   optimizer moments, error-feedback residuals, PowerSGD's ``Q`` and the
   ``backward_passes_per_step`` accumulator all keep their pre-step bits.
   The verdict is a 0-d tensor on the parameters' device: nothing inside
   the update reads it on the host, except under
   ``backward_passes_per_step > 1``, whose step counters live on the host
   (``multi_steps`` decides there whether a micro-step emits): there the
   guard reads the verdict once an update to keep them on a BAD step.
2. **Dynamic loss scaling** — ``loss_scale=`` keeps a grow/backoff scale
   in the state: :func:`~horovod_tpu_torch.training.make_train_step`
   multiplies the loss by :func:`current_scale` before the backward, the
   guard multiplies the gradients by its inverse before anything else
   sees them, a BAD step halves the scale and ``growth_interval``
   consecutive good steps double it (clamped).
3. **Verdict readers** — :func:`verdict` / :func:`note_step` read the
   state's scalars at a step boundary (one batched device-to-host copy)
   and consume a fired chaos charge; :func:`stage_verdict` /
   :func:`note_step_staged` read them one boundary late.
4. **The gate** — :func:`tree_finite` and :func:`publish_gate_reason`.

The rank route is the JAX package's bound-axis route (its guard inside
``shard_map``): each rank holds its local gradients, the norm is the
square root of the MEAN over ranks of the local per-dtype square sums,
and ``rank_norms`` holds each rank's local norm (-1 for a non-finite
rank). Both come from one ``all_gather`` of each rank's small vector
(the square sums, and the loss's finiteness), summed in rank order on
every rank, so every rank reaches the same verdict. Outside a world
(before ``hvd.init``) the guard is the JAX package's unbound route.

Chaos: ``HOROVOD_CHAOS=grad_nan_at_step=K`` / ``grad_spike_at_step=K:s``
multiply the gradients by NaN / ``s`` on the guard's K-th update.

5. **The skip/replay policy** — :class:`NumericsRollback`: the elastic
   driver (:mod:`horovod_tpu_torch.resilience.elastic`) raises it after
   :func:`max_consecutive_bad` BAD steps in a row and replays from its
   last committed snapshot with :func:`replay_epoch` bumped (data
   pipelines fold it into batch selection: :func:`horovod_tpu_torch.data.
   sampler.mix_seed`), at most :func:`max_rollbacks` times a run, then
   :class:`NumericsError` with the health machine FATAL.

The verdict readers set the JAX package's ``numerics_*`` gauges.

6. **The fingerprint plane** (``HOROVOD_NUMERICS_FINGERPRINT=1``, or the
   ``grad_corrupt_rank=<r>:<step>`` chaos charge): at each step boundary
   every rank publishes its gradient fingerprint (finiteness, its own
   pre-reduction norm from the guard's all-gathered vector, per-dtype
   norms) to the rendezvous KV under ``/numerics/<step>/<rank>``; rank 0
   cross-checks the family (:func:`cross_check_fingerprints`) and
   quarantines a rank whose record is non-finite or an outlier of the
   median. The quarantine closes :func:`publish_gate_reason` and feeds
   the elastic driver's eviction (:func:`take_corrupt_ranks`).
   ``InstrumentedStep`` drives the boundary (:func:`set_step`,
   :func:`maybe_note_output`) unless the elastic driver claimed it
   (:func:`claim_boundary`); :func:`flush_staged` drains the last step's
   lagged verdict at shutdown.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import threading
import json
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from horovod_tpu_torch import basics, pytree
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.resilience import chaos as _chaos

__all__ = [
    "NumericsGuardState",
    "GuardedTransformation",
    "NumericsRollback",
    "NumericsError",
    "max_consecutive_bad",
    "max_rollbacks",
    "replay_epoch",
    "bump_replay_epoch",
    "reset",
    "guard",
    "is_guarded",
    "current_scale",
    "find_guard_states",
    "verdict",
    "note_step",
    "stage_verdict",
    "note_step_staged",
    "array_finite",
    "tree_finite",
    "checkpoint_finite_check_enabled",
    "publish_gate_reason",
    "configure",
    "maybe_note_output",
    "flush_staged",
    "fingerprint_enabled",
    "fingerprint_key",
    "publish_fingerprint",
    "cross_check_fingerprints",
    "last_corruption",
    "take_corrupt_ranks",
    "requeue_corrupt_ranks",
    "quarantine_pending",
    "clear_quarantine",
    "claim_boundary",
    "release_boundary",
    "set_step",
    "boundary",
]

logger = logging.getLogger("horovod_tpu_torch.resilience.numerics")

SPIKE_FACTOR_ENV = "HOROVOD_NUMERICS_SPIKE_FACTOR"
EWMA_ALPHA_ENV = "HOROVOD_NUMERICS_EWMA_ALPHA"
WARMUP_ENV = "HOROVOD_NUMERICS_WARMUP"
MAX_BAD_ENV = "HOROVOD_NUMERICS_MAX_BAD"
MAX_ROLLBACKS_ENV = "HOROVOD_NUMERICS_MAX_ROLLBACKS"
OUTLIER_ENV = "HOROVOD_NUMERICS_OUTLIER_FACTOR"
FINGERPRINT_ENV = "HOROVOD_NUMERICS_FINGERPRINT"
SCALE_INIT_ENV = "HOROVOD_NUMERICS_SCALE_INIT"
SCALE_GROWTH_ENV = "HOROVOD_NUMERICS_SCALE_GROWTH_INTERVAL"
GATE_ENV = "HOROVOD_PUBLISH_NUMERICS_GATE"
CKPT_FINITE_ENV = "HOROVOD_CHECKPOINT_FINITE_CHECK"

#: loss-scale dynamics (NVIDIA AMP conventions): halve on a bad step,
#: double after `growth_interval` consecutive good ones, clamped
SCALE_BACKOFF = 0.5
SCALE_GROWTH = 2.0
SCALE_MIN = 1.0
SCALE_MAX = float(2 ** 24)

#: the guard's state, under the JAX package's name (a checkpoint of either
#: package reads it). Every field but ``inner`` is a 0-d tensor on the
#: parameters' device (``norms`` a dict of them keyed by the JAX dtype
#: names, ``rank_norms`` f32 ``[N]``): ``ewma``/``last_norm``/
#: ``loss_scale`` f32; ``count`` (updates seen, the chaos clock),
#: ``bad_count``, ``bad_streak``, ``last_bad``, ``last_finite``,
#: ``good_streak`` and ``chaos_fired`` (1 = grad_nan fired this update,
#: 2 = grad_spike) int32
NumericsGuardState = pytree._stand_in(
    "horovod_tpu.resilience.numerics", "NumericsGuardState",
    pytree._NAMEDTUPLE_FIELDS[("horovod_tpu", "NumericsGuardState")])


class GuardedTransformation(NamedTuple):
    """A :func:`guard`-wrapped optimizer: ``init``/``update`` as any
    optimizer's (``update(grads, state, params=None, *, loss=None,
    started=None)``), the wrapped one as ``inner``, and ``exchange`` the
    guarded hook route of an inner ``DistributedOptimizer`` that has one.
    ``shard_optimizer``, ``shard_params`` and ``bucket_bytes`` read the
    inner optimizer's, so the step builders see through the guard."""

    init: Callable
    update: Callable
    inner: Any
    exchange: Optional[Callable] = None

    @property
    def shard_optimizer(self) -> bool:
        return bool(getattr(self.inner, "shard_optimizer", False))

    @property
    def shard_params(self) -> bool:
        return bool(getattr(self.inner, "shard_params", False))

    @property
    def bucket_bytes(self):
        return getattr(self.inner, "bucket_bytes", None)


class NumericsRollback(Exception):
    """Control flow: the guard saw ``max_consecutive_bad`` bad steps in a
    row; the elastic driver unwinds the inner loop and replays from the
    last committed snapshot with :func:`replay_epoch` bumped."""

    def __init__(self, step: int, streak: int):
        self.step = step
        self.streak = streak
        super().__init__(
            f"{streak} consecutive bad steps at step {step}; rolling back"
        )


class NumericsError(RuntimeError):
    """The rollback budget is exhausted: the run cannot make numerically
    sound progress (bad data shard, persistent SDC). The health machine
    was marked FATAL before this raised."""


_lock = threading.Lock()
_replay_epoch = 0
_kv = None  # explicit KV override; falls back to the sanitizer's store
_quarantine: set = set()
_fp_override: Optional[bool] = None
_last_record: Optional[dict] = None  # fingerprint of the last noted step
_last_corruption: Optional[dict] = None
_perturbed_steps: Dict[int, int] = {}  # step -> victim rank (sticky chaos)
_warned_impossible_charge = False  # one loud warning per armed bad charge
_last_boundary: Optional[int] = None
#: steps whose cross-check found some peers' records missing, with the
#: re-check attempts left
_pending_checks: Dict[int, int] = {}
PENDING_CHECK_ATTEMPTS = 8
#: (step, rank) findings already reported (a re-check must not repeat)
_flagged: set = set()
#: a driver owns the fingerprint boundary (:func:`claim_boundary`)
_external_boundary = False
#: the standalone hook's lagged verdict (:func:`maybe_note_output`)
_standalone_staged: Optional[tuple] = None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def max_consecutive_bad() -> int:
    """Bad steps in a row before the skip policy escalates to a rollback
    (``HOROVOD_NUMERICS_MAX_BAD``, default 3)."""
    return max(1, _env_int(MAX_BAD_ENV, 3))


def max_rollbacks() -> int:
    """Numerics rollbacks tolerated per run before FATAL
    (``HOROVOD_NUMERICS_MAX_ROLLBACKS``, default 3)."""
    return max(1, _env_int(MAX_ROLLBACKS_ENV, 3))


def replay_epoch() -> int:
    """Bumped on every numerics rollback. Data pipelines that fold this
    into their batch selection draw FRESH batches for the replayed steps
    instead of re-serving the batch that went bad."""
    return _replay_epoch


def bump_replay_epoch() -> int:
    global _replay_epoch
    with _lock:
        _replay_epoch += 1
        return _replay_epoch


def configure(*, kv=None, fingerprint: Optional[bool] = None) -> None:
    """Programmatic setup: wire a KV store for the fingerprint plane or
    force the fingerprint publication on/off (None = env/chaos-driven)."""
    global _kv, _fp_override
    with _lock:
        if kv is not None:
            _kv = kv
        if fingerprint is not None:
            _fp_override = bool(fingerprint)


def reset() -> None:
    """Back to env-driven config, a replay epoch of 0 and an empty
    quarantine (tests)."""
    global _kv, _fp_override, _replay_epoch, _last_record, _last_corruption
    global _step, _last_boundary, _external_boundary
    global _warned_impossible_charge, _standalone_staged
    with _lock:
        _warned_impossible_charge = False
        _kv = None
        _fp_override = None
        _replay_epoch = 0
        _last_record = None
        _last_corruption = None
        _last_boundary = None
        _external_boundary = False
        _standalone_staged = None
        _perturbed_steps.clear()
        _pending_checks.clear()
        _flagged.clear()
        _quarantine.clear()
        _step = 0


def _keys(tree: dict) -> list:
    """A flat dict's keys in JAX's flatten order (``optim.tree_keys``)."""
    return sorted(tree, key=lambda k: tuple(k.split("/")))


def _float_key(x) -> Optional[str]:
    """The JAX name of a float tensor's dtype, None for other leaves."""
    if isinstance(x, torch.Tensor) and x.dtype.is_floating_point:
        return str(x.dtype).replace("torch.", "")
    return None


def find_guard_states(tree) -> List[Any]:
    """Every :class:`NumericsGuardState` in ``tree``, outermost first."""
    out = []

    def visit(x):
        if isinstance(x, NumericsGuardState):
            out.append(x)
            visit(x.inner)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    return out


def is_guarded(tx) -> bool:
    """Is ``tx`` a :func:`guard`-wrapped optimizer? The step builders use
    this to scale the loss and pass it to the update."""
    return isinstance(tx, GuardedTransformation)


def current_scale(opt_state):
    """The dynamic loss scale carried in ``opt_state``'s guard state (a
    0-d f32 tensor on the device; 1.0 when unguarded). No host read."""
    states = find_guard_states(opt_state)
    if not states:
        return 1.0
    return states[0].loss_scale


# --------------------------------------------------------------------------
# the guard


def _device_of(tree) -> torch.device:
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return basics.device() if basics.is_initialized() else torch.device("cpu")


def _on_device(state, dev):
    """``state`` with every Adam step count that is a Python int (a fresh
    inner state, or one restored from a checkpoint) as a 0-d int32 tensor
    on ``dev``, as the JAX package's count is: the select of a BAD step
    then keeps it on the device, and Adam takes its bias corrections
    there."""
    if isinstance(state, dict):
        return type(state)(
            (k, torch.full((), v, dtype=torch.int32, device=dev)
             if k == "count" and type(v) is int else _on_device(v, dev))
            for k, v in state.items())
    if isinstance(state, (list, tuple)):
        items = [_on_device(v, dev) for v in state]
        return type(state)(*items) if hasattr(state, "_fields") \
            else type(state)(items)
    return state


def _storage_base(t):
    """The whole storage under ``t`` as one flat tensor of ``t``'s dtype."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.new_empty(0).set_(t.untyped_storage(), 0, (n,))


def _where_many(bad, olds, news) -> list:
    """``[torch.where(bad, o, n) for o, n in zip(olds, news)]``, the
    results of the ``news`` that are views of one storage (a fused
    update's outputs are views of one flat buffer) again views of one
    storage at the same places: one ``where`` over the whole storage when
    their ``olds`` are laid out the same in one storage (the previous
    step's result) or are one 0-d tensor, else one a leaf into that
    layout (the first step), so the next step's ``olds`` are. Same
    values either way."""
    out = list(news)
    groups: dict = {}
    for i, (o, n) in enumerate(zip(olds, news)):
        if o is not n:
            groups.setdefault((n.untyped_storage().data_ptr(), n.dtype,
                               n.device), []).append(i)

    def view(t, like):
        return t.as_strided(like.shape, like.stride(), like.storage_offset())

    for idxs in groups.values():
        if len(idxs) == 1:
            out[idxs[0]] = torch.where(bad, olds[idxs[0]], news[idxs[0]])
            continue
        n0, o0 = news[idxs[0]], olds[idxs[0]]
        base = _storage_base(n0)
        if o0.dim() == 0 and all(olds[i] is o0 for i in idxs):
            sel = torch.where(bad, o0, base)
        elif all(olds[i].dtype == n0.dtype and olds[i].device == n0.device
                 and olds[i].untyped_storage().data_ptr()
                 == o0.untyped_storage().data_ptr()
                 and olds[i].untyped_storage().nbytes()
                 == n0.untyped_storage().nbytes()
                 and olds[i].storage_offset() == news[i].storage_offset()
                 and olds[i].shape == news[i].shape
                 and olds[i].stride() == news[i].stride() for i in idxs):
            sel = torch.where(bad, _storage_base(o0), base)
        else:
            sel = torch.empty_like(base)
            for i in idxs:
                torch.where(bad, olds[i], news[i], out=view(sel, news[i]))
        for i in idxs:
            out[i] = view(sel, news[i])
    return out


def _select(bad, old, new):
    """``new`` where the step was good, ``old`` where it was BAD, leaf by
    leaf over two trees of one structure: the tensors on ``bad``'s device
    through :func:`_where_many`, no host read; an unchanged leaf as it
    is. A leaf the update changed that lives on the host (a Python
    number, a CPU tensor off a CUDA ``bad``: ``multi_steps``' counters,
    which it branches on) is picked on the host, after ONE read of the
    verdict: the only host sync in the guard's update, and only where the
    inner state holds such a leaf (``backward_passes_per_step > 1``)."""
    (lo, tdo), (ln, tdn) = pytree.flatten(old), pytree.flatten(new)
    if tdo != tdn:
        raise ValueError("the inner update changed its state's structure")
    here = [i for i, n in enumerate(ln)
            if isinstance(n, torch.Tensor) and n.device == bad.device]
    out = list(ln)
    olds = [lo[i] if lo[i].device == bad.device else lo[i].to(bad.device)
            for i in here]
    for i, t in zip(here, _where_many(bad, olds, [ln[i] for i in here])):
        out[i] = t
    on_host = set(here)
    host = [i for i, (o, n) in enumerate(zip(lo, ln)) if i not in on_host
            and (o is not n if isinstance(n, torch.Tensor) else o != n)]
    if host:
        keep = bool(bad)                    # the one device-to-host read
        for i in host:
            out[i] = lo[i] if keep else ln[i]
    return pytree.unflatten(tdn, out)


def _square_sums(leaves, keys):
    """``(per-dtype square sums [len(keys)] f32, the rest's sum)`` of the
    float leaves: each leaf's norm accumulated in f32 (one multi-tensor
    ``_foreach_norm`` a dtype, whatever the leaf count), squared and
    summed."""
    groups: dict = {}
    for g in leaves:
        k = _float_key(g)
        if k is not None and g.numel():
            groups.setdefault(k if k in keys else None, []).append(g)
    dev = next((g.device for gs in groups.values() for g in gs),
               None) or _device_of(leaves)

    def sq(gs):
        if not gs:
            return torch.zeros((), dtype=torch.float32, device=dev)
        norms = torch.stack(torch._foreach_norm(gs, 2, dtype=torch.float32))
        return torch.sum(norms * norms)

    return [sq(groups.get(k, [])) for k in keys], sq(groups.get(None, []))


def _prepare_one(g, mults):
    """A gradient multiplied by each of ``mults`` (0-d f32 tensors) in
    its own dtype; a gradient that is not float as it is."""
    if _float_key(g) is None:
        return g
    for m in mults:
        g = g * m.to(g.dtype)
    return g


def _prepare_all(grads: dict, mults) -> dict:
    """:func:`_prepare_one` of every gradient, the same multiplies in one
    multi-tensor launch a dtype."""
    by_dtype: dict = {}
    for k, g in grads.items():
        if _float_key(g) is not None:
            by_dtype.setdefault(g.dtype, []).append(k)
    out = dict(grads)
    for dt, keys in by_dtype.items():
        gs = [grads[k] for k in keys]
        for m in mults:
            gs = torch._foreach_mul(gs, m.to(dt))
        out.update(zip(keys, gs))
    return out


def guard(tx, *, spike_factor: Optional[float] = None,
          ewma_alpha: Optional[float] = None, warmup: Optional[int] = None,
          loss_scale=None, growth_interval: Optional[int] = None, axis=None):
    """Wrap ``tx`` so every update is guarded per the module docstring.

    - ``spike_factor`` (env ``HOROVOD_NUMERICS_SPIKE_FACTOR``, default 10):
      a step whose norm exceeds ``spike_factor`` x the EWMA after
      ``warmup`` good steps is BAD; only good steps feed the EWMA
      (``ewma_alpha``, env ``HOROVOD_NUMERICS_EWMA_ALPHA``, default 0.1),
      which seeds on the first good norm.
    - ``warmup`` (env ``HOROVOD_NUMERICS_WARMUP``, default 5): good steps
      before the spike check arms (finiteness is checked from step 0).
    - ``loss_scale``: ``None`` leaves the scale at 1; ``"dynamic"`` or
      ``True`` starts at ``HOROVOD_NUMERICS_SCALE_INIT`` (default 2^15), a
      float there; growth after ``growth_interval`` (env
      ``HOROVOD_NUMERICS_SCALE_GROWTH_INTERVAL``, default 200) good steps.
    - ``axis`` must be ``None``: the port's collectives run on the world.

    Apply outermost (after ``DistributedOptimizer`` and
    ``backward_passes_per_step``), so a BAD step freezes everything the
    optimizer owns. With a bucketed ``DistributedOptimizer`` whose
    exchange starts from the backward's hooks, the guard's ``exchange``
    hands each gradient to the buckets already multiplied by the chaos
    factor and unscaled, as the gradients that :meth:`update` takes
    after the backward are."""
    if axis is not None:
        raise ValueError(
            f"axis={axis!r}: the port's collectives run on the world's "
            "process group; there are no mesh axes to name")
    sf = float(spike_factor if spike_factor is not None
               else _env_float(SPIKE_FACTOR_ENV, 10.0))
    alpha = float(ewma_alpha if ewma_alpha is not None
                  else _env_float(EWMA_ALPHA_ENV, 0.1))
    warm = int(warmup if warmup is not None else _env_int(WARMUP_ENV, 5))
    grow_n = int(growth_interval if growth_interval is not None
                 else _env_int(SCALE_GROWTH_ENV, 200))
    scaling = loss_scale is not None
    if loss_scale is True or loss_scale == "dynamic":
        scale0 = _env_float(SCALE_INIT_ENV, float(2 ** 15))
    elif scaling:
        scale0 = float(loss_scale)
    else:
        scale0 = 1.0

    def init(params):
        dev = _device_of(params)
        keys = []
        for name in _keys(params):
            k = _float_key(params[name])
            if k is not None and k not in keys:
                keys.append(k)
        world = basics.size() if basics.is_initialized() else 1

        def z(dtype):
            return torch.zeros((), dtype=dtype, device=dev)

        return NumericsGuardState(
            inner=_on_device(tx.init(params), dev),
            ewma=z(torch.float32), count=z(torch.int32),
            bad_count=z(torch.int32), bad_streak=z(torch.int32),
            last_bad=z(torch.int32),
            last_finite=torch.ones((), dtype=torch.int32, device=dev),
            last_norm=z(torch.float32),
            norms={k: z(torch.float32) for k in keys},
            loss_scale=torch.full((), scale0, dtype=torch.float32, device=dev),
            good_streak=z(torch.int32), chaos_fired=z(torch.int32),
            rank_norms=torch.zeros((world,), dtype=torch.float32, device=dev))

    def factors(state):
        """``(multipliers, fired)``: what every float gradient is
        multiplied by, in order, before the rest of the update (the chaos
        factor, then the unscale ``1/scale``; 0-d f32 tensors, empty when
        there is nothing to do), and the chaos bits this update fires."""
        nan_k = _chaos.grad_nan_step() if _chaos.enabled() else None
        spike = _chaos.grad_spike() if _chaos.enabled() else None
        fired = torch.zeros_like(state.count)
        mults = []
        if nan_k is not None or spike is not None:
            factor = torch.ones_like(state.ewma)
            if nan_k is not None:
                hit = state.count == nan_k
                factor = torch.where(hit, math.nan, factor)
                fired = fired | hit.to(torch.int32)
            if spike is not None:
                hit = state.count == spike[0]
                # composes with a NaN charge at the same step
                factor = torch.where(hit, factor * spike[1], factor)
                fired = fired | (2 * hit.to(torch.int32))
            mults.append(factor)
        if scaling:
            mults.append(torch.ones_like(state.loss_scale) / state.loss_scale)
        return mults, fired

    def verdict_of(leaves, state, loss):
        """What the verdict is made of, from the prepared gradients:
        ``(finite, norm, per-dtype square sums [K], rank_norms)``, every
        value a tensor on the device, agreed across ranks by one
        all-gather."""
        keys = list(state.norms)
        sums, extra = _square_sums(leaves, keys)
        dev = state.ewma.device
        loss_ok = torch.zeros((), dtype=torch.float32, device=dev)
        if loss is not None:
            lv = torch.as_tensor(loss).detach().to(dev, torch.float32)
            loss_ok = torch.where(torch.isfinite(lv).all(), 0.0, math.nan)
        vec = torch.stack([*(s.to(dev) for s in sums), extra.to(dev),
                           loss_ok])
        n_ranks = int(state.rank_norms.shape[0]) \
            if state.rank_norms.dim() else 1
        if basics.is_initialized():
            from horovod_tpu_torch.ops import collective as _C

            rows = _C.allgather(vec[None])          # [N, K + 2]
            totals = rows[:, :-1].sum(dim=1)       # each rank's local sum
            gathered = torch.where(torch.isfinite(totals), torch.sqrt(totals),
                                   -1.0)
            if gathered.shape[0] != n_ranks:
                gathered = gathered.repeat(-(-n_ranks // gathered.shape[0])
                                           )[:n_ranks]
            acc = rows[0]
            for r in range(1, rows.shape[0]):      # rank order, every rank
                acc = acc + rows[r]
            # the mean as lax.pmean takes it (a fill, not a host copy)
            vec = acc / torch.full((), float(rows.shape[0]),
                                   dtype=torch.float32, device=dev)
            rank_norms = gathered
        per_dtype = vec[:-2]
        total = torch.sum(vec[:-1])
        norm = torch.sqrt(total)
        if not basics.is_initialized():
            rank_norms = torch.where(torch.isfinite(norm), norm,
                                     -1.0).expand(n_ranks).clone()
        finite = torch.isfinite(norm) & torch.isfinite(vec[-1])
        return finite, norm, per_dtype, rank_norms

    def _update(grads, state, params=None, *, loss=None, started=None):
        dev = state.ewma.device
        inner_state = _on_device(state.inner, dev)
        mults, fired = factors(state)
        if started is not None:
            # the hook route: the buckets ran on the prepared leaves
            grads = dict(zip(_keys(grads), started.leaves))
        elif mults:
            grads = _prepare_all(grads, mults)
        finite, norm, per_dtype, rank_norms = verdict_of(
            [grads[k] for k in _keys(grads)], state, loss)
        warmed = (state.count - state.bad_count) >= warm
        spike = warmed & finite & (norm > sf * state.ewma) & (state.ewma > 0)
        bad = ~finite | spike

        # the inner update runs whatever the verdict (its collectives are
        # every rank's schedule); its outputs are then selected away
        extra = {} if started is None else {"started": started}
        updates, new_inner = tx.update(grads, inner_state, params, **extra)
        new_inner = _select(bad, inner_state, new_inner)
        # discard with NEGATIVE zero: p + (-0.0) is p for every p, where
        # p + (+0.0) turns a -0.0 parameter into +0.0
        keys = list(updates)
        neg0 = {u.dtype: torch.full((), -0.0, dtype=u.dtype, device=u.device)
                for u in updates.values()}
        updates = dict(zip(keys, _where_many(
            bad, [neg0[updates[k].dtype] for k in keys],
            [updates[k] for k in keys])))

        norms = {k: torch.where(torch.isfinite(per_dtype[i]),
                                torch.sqrt(per_dtype[i]), 0.0)
                 for i, k in enumerate(state.norms)}
        # seeded on the FIRST GOOD norm, not at count 0
        new_ewma = torch.where(
            bad, state.ewma,
            torch.where(state.ewma == 0, norm,
                        (1.0 - alpha) * state.ewma + alpha * norm))
        if scaling:
            grown = ~bad & (state.good_streak + 1 >= grow_n)
            new_scale = torch.where(
                bad, torch.clamp_min(state.loss_scale * SCALE_BACKOFF,
                                     SCALE_MIN),
                torch.where(grown, torch.clamp_max(
                    state.loss_scale * SCALE_GROWTH, SCALE_MAX),
                    state.loss_scale))
            new_good = torch.where(bad | grown, 0, state.good_streak + 1)
        else:
            new_scale, new_good = state.loss_scale, state.good_streak
        bad_i = bad.to(torch.int32)
        return updates, NumericsGuardState(
            inner=new_inner, ewma=new_ewma, count=state.count + 1,
            bad_count=state.bad_count + bad_i,
            bad_streak=torch.where(bad, state.bad_streak + 1, 0),
            last_bad=bad_i, last_finite=finite.to(torch.int32),
            last_norm=torch.where(finite, norm, 0.0), norms=norms,
            loss_scale=new_scale, good_streak=new_good.to(torch.int32),
            # which chaos injections ran in THIS update (not sticky)
            chaos_fired=fired, rank_norms=rank_norms)

    def update(grads, state, params=None, *, loss=None, started=None):
        with torch.no_grad():
            return _update(grads, state, params, loss=loss, started=started)

    exchange = None
    if getattr(tx, "exchange", None) is not None:
        def exchange(state, params):
            """The inner optimizer's bucket exchange for this step, fed
            the prepared gradients (see :func:`guard`)."""
            ex = tx.exchange(_on_device(state.inner, state.ewma.device),
                             params)
            mults = factors(state)[0]
            if mults:
                ex.prepare = functools.partial(_prepare_one, mults=mults)
            return ex

    return GuardedTransformation(init, update, tx, exchange)


# --------------------------------------------------------------------------
# host-side verdict readers


def _verdict_leaves(g):
    """(keys, tensors) of every scalar the verdict needs, in the order
    :func:`_verdict_from` unpacks them."""
    keys = sorted(g.norms or {})
    return keys, [g.count, g.bad_count, g.bad_streak, g.last_bad,
                  g.last_finite, g.last_norm, g.ewma, g.loss_scale,
                  g.chaos_fired, *[g.norms[k] for k in keys], g.rank_norms]


def _fetch(tensors) -> list:
    """The values of small tensors on the host in one copy a dtype group
    (a host array or number passes as it is)."""
    out = []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            out.append(t.detach().to("cpu", torch.float64).numpy())
        else:
            out.append(np.asarray(t, np.float64))
    return out


def verdict(state_tree) -> Optional[dict]:
    """Host-readable view of the (first) guard state in ``state_tree``, or
    None when there is none. Reading waits for the step: call it at step
    boundaries, not inside the step (or stage it with
    :func:`stage_verdict`)."""
    states = find_guard_states(state_tree)
    if not states:
        return None
    keys, leaves = _verdict_leaves(states[0])
    return _verdict_from(keys, _batched(leaves))


def _batched(leaves) -> list:
    """``leaves`` on the host, the device ones through one copy: they are
    concatenated as f64 on the device first (one device-to-host read)."""
    dev = [x for x in leaves if isinstance(x, torch.Tensor)
           and x.device.type != "cpu"]
    if not dev:
        return _fetch(leaves)
    flat = torch.cat([x.detach().reshape(-1).double() for x in dev]).cpu()
    out, at = [], 0
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            n = x.numel()
            out.append(flat[at:at + n].numpy().reshape(x.shape))
            at += n
        else:
            out.append(_fetch([x])[0])
    return out


def _verdict_from(keys, fetched) -> dict:
    (count, bad_count, bad_streak, last_bad, last_finite, last_norm,
     ewma, loss_scale, chaos_fired, *rest) = fetched
    per_dtype_vals, rank_norms = rest[:-1], rest[-1]
    return {
        "count": int(count),
        "bad_count": int(bad_count),
        "bad_streak": int(bad_streak),
        "last_bad": bool(last_bad),
        "last_finite": bool(last_finite),
        "last_norm": float(last_norm),
        "ewma": float(ewma),
        "loss_scale": float(loss_scale),
        "chaos_fired": int(chaos_fired),
        "per_dtype": {k: float(v) for k, v in zip(keys, per_dtype_vals)},
        "rank_norms": [float(x) for x in np.asarray(rank_norms).reshape(-1)],
    }


def note_step(step: int, state_tree) -> Optional[dict]:
    """Step-boundary bookkeeping: read the verdict from the carried state
    and consume any chaos charge whose injection this step reports
    (``chaos_fired``). Returns the verdict (None without a guard)."""
    v = verdict(state_tree)
    if v is None:
        return None
    return _note_verdict(step, v)


def stage_verdict(state_tree):
    """Snapshot the guard's scalars without waiting for the step: an
    on-device copy (new buffers, so the next step's state does not
    overwrite them). Feed it to :func:`note_step_staged` one boundary
    later, when the read no longer stalls. None without a guard."""
    states = find_guard_states(state_tree)
    if not states:
        return None
    keys, leaves = _verdict_leaves(states[0])
    return keys, [x.detach().clone() if isinstance(x, torch.Tensor) else x
                  for x in leaves]


def note_step_staged(step: int, staged) -> Optional[dict]:
    """:func:`note_step` for a verdict captured by :func:`stage_verdict`
    at an earlier boundary."""
    if staged is None:
        return None
    keys, leaves = staged
    return _note_verdict(step, _verdict_from(keys, _batched(leaves)))


def _note_verdict(step: int, v: dict) -> dict:
    global _last_record
    if _metrics.enabled():
        _metrics.gauge(
            "numerics_guard_bad_steps",
            help="total steps the numerics guard marked BAD and skipped",
        ).set(v["bad_count"])
        _metrics.gauge(
            "numerics_guard_bad_streak",
            help="consecutive BAD steps (the rollback trigger)",
        ).set(v["bad_streak"])
        _metrics.gauge(
            "numerics_guard_grad_norm",
            help="global gradient norm of the last guarded step",
        ).set(v["last_norm"])
        _metrics.gauge(
            "numerics_guard_grad_norm_ewma",
            help="EWMA of the global gradient norm over good steps",
        ).set(v["ewma"])
        _metrics.gauge(
            "numerics_loss_scale",
            help="current dynamic loss scale (1 when scaling is off)",
        ).set(v["loss_scale"])
    with _lock:
        _last_record = {
            "step": int(step),
            "finite": int(v["last_finite"]),
            "norm": v["last_norm"],
            "per_dtype": v["per_dtype"],
            "rank_norms": v["rank_norms"],
        }
    if _chaos.enabled():
        # consume a charge ONLY when the step recorded its injection: a
        # restored state whose counter is already past K never injects
        if v["chaos_fired"] & 1 and _chaos.grad_nan_step() is not None:
            _chaos.consume_grad_nan()
        if v["chaos_fired"] & 2 and _chaos.grad_spike() is not None:
            _chaos.consume_grad_spike()
    return v


def maybe_note_output(step: int, out_tree) -> Optional[dict]:
    """:class:`~horovod_tpu_torch.training.InstrumentedStep`'s standalone hook (the elastic
    wrapper claims the boundary and runs :func:`note_step` itself).

    Fingerprint plane on: read the verdict from the step's RETURNED
    state synchronously so the record published at the next boundary
    carries real data instead of the default — one device→host read a
    step, the documented cost of the opt-in plane.

    Plane off but a guard present: the troubleshooting contract is that
    ``HOROVOD_NUMERICS_GUARD=1`` *alone* feeds the ``numerics_guard_*``
    gauges and consumes fired chaos charges — but a synchronous read
    here would wait for every step. So the verdict is STAGED
    (:func:`stage_verdict`, an on-device copy the next step does not
    overwrite) and noted one boundary late, keeping the host ahead; :func:`flush_staged` drains the final step's."""
    global _standalone_staged
    with _lock:
        if _external_boundary:
            return None
    if fingerprint_enabled():
        with _lock:
            _standalone_staged = None
        return note_step(step, out_tree)
    if not (_metrics.enabled() or _chaos.enabled()):
        return None
    staged = stage_verdict(out_tree)
    if staged is None:
        return None
    with _lock:
        pending, _standalone_staged = _standalone_staged, (step, staged)
    if pending is not None:
        return note_step_staged(pending[0], pending[1])
    return None


def flush_staged() -> Optional[dict]:
    """Drain the lagged standalone verdict (the LAST step of a loop has
    no next boundary to read it at) — called from ``basics.shutdown``;
    harmless when nothing is pending."""
    global _standalone_staged
    with _lock:
        pending, _standalone_staged = _standalone_staged, None
    if pending is None:
        return None
    return note_step_staged(pending[0], pending[1])


# --------------------------------------------------------------------------
# fingerprint plane: publish + cross-check + quarantine


def fingerprint_enabled() -> bool:
    """Fingerprint publication is on when forced via :func:`configure`,
    the ``HOROVOD_NUMERICS_FINGERPRINT`` env is truthy, or the
    ``grad_corrupt_rank`` chaos charge is armed (the drill implies the
    plane it drills)."""
    if _fp_override is not None:
        return _fp_override
    env = os.environ.get(FINGERPRINT_ENV, "")
    if env:
        return env.lower() not in ("0", "false", "off")
    return _chaos.enabled() and _chaos.grad_corrupt() is not None


def fingerprint_key(step: int, rank: int) -> str:
    return f"/numerics/{int(step)}/{int(rank)}"


def _store():
    """The fingerprint KV: an explicit :func:`configure` override, else
    the schedule sanitizer's store — fingerprints land beside the
    sanitizer records, on the launcher KV when one is wired up and the
    in-process store otherwise."""
    with _lock:
        if _kv is not None:
            return _kv
    from horovod_tpu_torch.analysis import sanitizer as _sanitizer

    return _sanitizer._store()


def _identity():
    """(world, process_rank, process_size); a pre-init process is its own
    1-rank world (mirrors the sanitizer)."""
    try:
        from horovod_tpu_torch import basics as _basics

        if _basics.is_initialized():
            return (
                _basics.size(), _basics.process_rank(),
                _basics.process_size()
            )
    except Exception as e:
        logger.debug("numerics identity probe failed: %s", e)
    return 1, 0, 1


def _default_record(step: int) -> dict:
    with _lock:
        if _last_record is not None:
            rec = dict(_last_record)
            rec["step"] = int(step)
            return rec
    return {"step": int(step), "finite": 1, "norm": 0.0, "per_dtype": {}}


def _corrupt_record(rec: dict) -> dict:
    """The chaos perturbation: what a rank with a silently corrupted
    gradient would publish — a non-finite fingerprint."""
    out = dict(rec)
    out["finite"] = 0
    out["norm"] = None
    return out


def publish_fingerprint(step: int, record: Optional[dict] = None) -> None:
    """Publish `step`'s gradient fingerprint to the KV. Single-controller
    writes one record for EVERY rank (the dispatching process computed
    them all), except a rank named by an armed ``grad_corrupt_rank``
    charge, whose copy is perturbed; multi-process ranks publish only
    their own (the matching process perturbs). The charge is consumed
    ONLY by the process that perturbs — a 1-rank world leaves it armed."""
    rec = record if record is not None else _default_record(step)
    world, prank, psize = _identity()
    store = _store()
    ttl = _env_float("HOROVOD_SANITIZE_TTL", 120.0)
    # sticky per-step perturbation: a step can be published from MORE
    # than one boundary hook (InstrumentedStep + the elastic wrapper);
    # once the charge perturbed a step, every republication of that step
    # keeps the perturbed record instead of overwriting it clean
    # device-rank ownership: with several devices per process (a 2-host
    # × 4-chip topology) each process owns `world // psize` consecutive
    # DEVICE ranks — `rank_norms` is indexed by device rank, so keying
    # the published record by process rank would misattribute a corrupt
    # chip to the wrong rank. Heterogeneous worlds (world % psize != 0)
    # fall back to one record per process.
    local = world // psize if psize > 1 and world % psize == 0 else 1
    with _lock:
        victim = _perturbed_steps.get(int(step))
    gc = _chaos.grad_corrupt() if _chaos.enabled() else None
    if victim is None and gc is not None and step >= gc[1]:
        r = gc[0]
        if world > 1 and not (0 < r < world):
            # fail loudly, not silently inject nothing: this charge can
            # NEVER fire in this world (rank 0 is the driver; r >= world
            # does not exist). A 1-rank world legitimately stays armed —
            # the drill may be aimed at a later multi-rank phase.
            global _warned_impossible_charge
            with _lock:
                warned = _warned_impossible_charge
                _warned_impossible_charge = True
            if not warned:
                logger.warning(
                    "chaos: grad_corrupt_rank=%d can never fire in a "
                    "%d-rank world (valid victims are 1..%d); the charge "
                    "stays armed", r, world, world - 1)
        elif psize > 1:
            # guarded by the invalid-rank branch above: rank 0 (the
            # driver, un-evictable) is never perturbed multi-process
            # either — it would gate publication forever
            if prank == r // local:
                _chaos.consume_grad_corrupt()
                victim = r
        elif 0 < r < world:
            victim = r
            _chaos.consume_grad_corrupt()
        if victim is not None:
            with _lock:
                _perturbed_steps[int(step)] = victim
    def _rank_record(r: int) -> dict:
        """Rank `r`'s own record: its PRE-reduction local norm when the
        guard gathered one (-1 = that rank's gradients were non-finite),
        else the shared record — localization needs the per-rank view,
        NOT the globally-agreed verdict every rank shares."""
        out = dict(rec)
        rns = rec.get("rank_norms") or []
        if len(rns) > r:
            rn = float(rns[r])
            out["norm"] = None if rn < 0 else rn
            out["finite"] = 0 if rn < 0 else 1
        out.pop("rank_norms", None)
        return out

    if psize > 1:
        for r in range(prank * local, prank * local + local):
            one = _corrupt_record(_rank_record(r)) \
                if r == victim else _rank_record(r)
            store.put(
                fingerprint_key(step, r),
                json.dumps(one, separators=(",", ":")).encode(), ttl=ttl)
        return
    for r in range(max(1, world)):
        one = _corrupt_record(_rank_record(r)) \
            if r == victim else _rank_record(r)
        store.put(
            fingerprint_key(step, r),
            json.dumps(one, separators=(",", ":")).encode(),
            ttl=ttl,
        )
    # bound the sticky map: steps far behind can no longer republish
    with _lock:
        for s in [s for s in _perturbed_steps if s < step - 64]:
            _perturbed_steps.pop(s, None)


def _schedule_diverged(step: int, rank: int) -> bool:
    """Did the schedule sanitizer already name (step, rank) as a SCHEDULE
    divergence? Then the anomaly is a control-flow bug, not data
    corruption — the numerics verdict defers to it."""
    try:
        from horovod_tpu_torch.analysis import sanitizer as _sanitizer

        d = _sanitizer.last_divergence()
    except Exception as e:
        logger.debug("sanitizer divergence probe failed: %s", e)
        return False
    return (
        d is not None
        and d.get("step") == step
        and d.get("rank") == rank
    )


def cross_check_fingerprints(step: int) -> Optional[List[dict]]:
    """Rank 0: compare every rank's published fingerprint for `step`.
    A rank whose record is non-finite — or whose norm exceeds
    ``HOROVOD_NUMERICS_OUTLIER_FACTOR`` (default 100) times the median of
    the finite family — while its collective schedule matches is flagged:
    quarantined, counted (``numerics_corrupt_ranks{rank=}``), and fed to
    :func:`health.record_numeric_corruption` (SUSPECT with the rank
    named). Returns the list of corruption findings, or None."""
    global _last_corruption
    world, prank, psize = _identity()
    if prank != 0:
        return None
    store = _store()
    # records are keyed by DEVICE rank whenever the world divides evenly
    # over the processes (each process publishes its owned device ranks);
    # only a heterogeneous world falls back to per-process records
    n = world if psize == 1 or world % psize == 0 else psize
    records: Dict[int, dict] = {}
    missing = False
    for r in range(max(1, n)):
        blob = store.get(fingerprint_key(step, r))
        if blob is None:
            missing = True  # not published yet: defer, don't drop
            continue
        try:
            records[r] = json.loads(blob)
        except ValueError:
            # an unparseable blob is a VERDICT, not an absence: garbled
            # bytes often come from the exact corrupt host this plane
            # hunts, and dropping the record would count the step as
            # fully checked with the most-broken rank never examined.
            # Judge it like a non-finite fingerprint.
            records[r] = {"step": int(step), "finite": 0, "norm": None}
    deferred = False
    with _lock:
        if missing and records:
            # a peer's put has not landed (the corrupt rank is often the
            # SLOW one): remember the step and re-check at the next
            # boundaries instead of silently marking it done
            left = _pending_checks.get(step, PENDING_CHECK_ATTEMPTS) - 1
            if left > 0:
                _pending_checks[step] = left
                deferred = True
            else:
                _pending_checks.pop(step, None)
        else:
            _pending_checks.pop(step, None)
    if not records:
        return None
    if _metrics.enabled() and not deferred:
        # counted once per step, when the check COMPLETES (all records
        # present, or the retry budget exhausted) — a deferred step's
        # rechecks would otherwise inflate "steps checked" several-fold
        _metrics.counter(
            "numerics_fingerprints_checked",
            help="steps whose cross-rank gradient fingerprints rank 0 "
                 "compared",
        ).inc()
    finite_norms = [
        float(rec["norm"])
        for rec in records.values()
        if rec.get("finite", 1) and rec.get("norm") is not None
        and math.isfinite(float(rec["norm"]))
    ]
    med = float(np.median(finite_norms)) if finite_norms else 0.0
    factor = _env_float(OUTLIER_ENV, 100.0)
    # corruption is a MINORITY deviation from a healthy family: when the
    # finite ranks are not a strict majority, the step went bad globally
    # (a poisoned batch — the guard's skip already handled it) and naming
    # "corrupt ranks" would mass-quarantine the fleet (8→1) for one
    # skippable step
    if 2 * len(finite_norms) <= len(records):
        return None
    # a family missing members — mid-deferral OR at retry-budget
    # exhaustion — gets no norm-relative verdicts: 2 records of 8 would
    # otherwise form a 2-rank "majority" whose partial median can indict
    # a healthy rank. Non-finite records are corrupt regardless of
    # family, so those are still judged below.
    partial = deferred or len(records) < max(1, n)
    findings: List[dict] = []
    for r, rec in sorted(records.items()):
        if _schedule_diverged(step, r):
            continue
        with _lock:
            if (int(step), int(r)) in _flagged:
                continue  # already reported on an earlier recheck
        norm = rec.get("norm")
        corrupt = not rec.get("finite", 1) or (
            norm is not None and not math.isfinite(float(norm)))
        if not corrupt and partial:
            # the family is incomplete: a median over a partial record set
            # can indict a HEALTHY rank (2 of 8 landed, one corrupt at 600
            # and one healthy at 0.5 → median 300 puts the healthy rank
            # below med/factor) and _flagged would then mute the real
            # culprit forever. Non-finite records are corrupt regardless
            # of family, so those were judged above; the norm-relative
            # verdict requires every expected record — even at deferral-
            # budget exhaustion a sliver of the family convicts nobody.
            continue
        if not corrupt and norm is not None and med > 0:
            # symmetric family test: a rank blowing up (>factor×median)
            # OR collapsing (stuck-at-zero SDC, <median/factor) is
            # outside the fleet's family. norm == 0.0 exactly is the
            # no-signal sentinel the default record publishes — never a
            # verdict on its own. (`nv`, not `n`: the outer `n` is the
            # expected-record count)
            nv = float(norm)
            corrupt = nv > factor * med or (0.0 < nv < med / factor)
        if not corrupt:
            continue
        finding = {
            "step": int(step),
            "rank": int(r),
            "norm": norm,
            "finite": bool(rec.get("finite", 1)),
            "median_norm": med,
        }
        findings.append(finding)
        with _lock:
            _quarantine.add(int(r))
            _flagged.add((int(step), int(r)))
            # bound the memory: findings far behind can't recur
            for key in [x for x in _flagged if x[0] < step - 256]:
                _flagged.discard(key)
        _last_corruption = finding
        if _metrics.enabled():
            _metrics.counter(
                "numerics_corrupt_ranks",
                help="corrupt-gradient fingerprints attributed per rank",
                rank=int(r),
            ).inc()
        from horovod_tpu_torch.resilience import health as _health

        _health.record_numeric_corruption(int(r), step=int(step))
        logger.warning(
            "numerics: rank %d published a corrupt gradient fingerprint "
            "at step %d (norm=%s, fleet median %.3g) — quarantined",
            r, step, norm, med,
        )
    return findings or None


def last_corruption() -> Optional[dict]:
    """The most recent corruption finding this process detected, or None."""
    return _last_corruption


def take_corrupt_ranks() -> List[int]:
    """Pop the quarantine set — the elastic coordinator's eviction feed
    (each returned rank is tombstoned on the next membership sweep)."""
    with _lock:
        out = sorted(_quarantine)
        _quarantine.clear()
    return out


def requeue_corrupt_ranks(ranks) -> None:
    """Put corrupt ranks the coordinator could NOT evict back in the
    quarantine set (rank 0 is the single-controller driver and cannot
    tombstone itself). The publish gate keys on :func:`quarantine_pending`
    — silently draining an un-evictable rank would re-open publication
    of a corrupt trainer's weights. No metrics here: the finding was
    already counted when it was flagged."""
    with _lock:
        _quarantine.update(int(r) for r in ranks)


def quarantine_pending() -> bool:
    with _lock:
        return bool(_quarantine)


def clear_quarantine() -> None:
    """Drop pending quarantine verdicts without evicting (operator
    override / non-elastic deployments)."""
    with _lock:
        _quarantine.clear()


_step = 0


def claim_boundary() -> None:
    """A driver with authoritative step numbering (the elastic wrapper)
    takes ownership of the fingerprint boundary; ``InstrumentedStep``'s
    generic :func:`set_step` hook stands down. Without a single owner,
    the two hooks' counters diverge after a step-fn rebuild (resize,
    rollback, resume) and every step is published twice under different
    keys. Sticky for the process; :func:`reset` clears it."""
    global _external_boundary
    with _lock:
        _external_boundary = True


def release_boundary() -> None:
    """Undo :func:`claim_boundary` when the owning driver's run ends: a
    later standalone ``InstrumentedStep`` loop in the same process must
    be able to publish again (a claim pinned until the test-only
    :func:`reset` would silently disable its fingerprint plane)."""
    global _external_boundary
    with _lock:
        _external_boundary = False


def set_step(step: int) -> None:
    """Open step `step`'s fingerprint scope: the step that just finished
    is published and (rank 0) cross-checked — the same boundary protocol
    as the schedule sanitizer. ``InstrumentedStep`` calls this per
    dispatched train step; explicit loops call :func:`boundary`. A no-op
    once a driver :func:`claim_boundary`-ed the protocol."""
    global _step
    prev = _step
    _step = int(step)
    if not fingerprint_enabled() or _external_boundary:
        return
    if prev == _step:
        # first call of a run (set_step(0) BEFORE step 0 executes): no
        # step has finished — publishing here would emit a premature
        # default record for step 0 whose boundary dedupe then suppresses
        # the REAL record
        return
    boundary(prev)


def boundary(step: int) -> Optional[List[dict]]:
    """Publish + cross-check `step`'s fingerprint (no-op when the plane
    is disabled). Consecutive duplicate calls for the same step are
    deduplicated — an instrumented step inside the elastic wrapper
    otherwise drives the boundary twice per step (double publish, double
    cross-check). A rollback legitimately revisits EARLIER steps, which
    never look like consecutive duplicates. Returns the corruption
    findings, if any."""
    global _last_boundary
    if not fingerprint_enabled():
        return None
    with _lock:
        dup = _last_boundary == int(step)
        _last_boundary = int(step)
        pending = sorted(_pending_checks)
    out: Optional[List[dict]] = None
    # re-check earlier steps whose peers had not published yet (the slow
    # rank — often the corrupt one — publishes late; its step must not
    # be silently dropped)
    for p in pending:
        if p != int(step):
            out = cross_check_fingerprints(p) or out
    if dup:
        return out
    publish_fingerprint(step)
    return cross_check_fingerprints(step) or out


# --------------------------------------------------------------------------
# finiteness + publish gate


# --------------------------------------------------------------------------
# finiteness + publish gate


def array_finite(a) -> bool:
    """Is this host array free of NaN/Inf? Integer, bool and object
    arrays, and dtypes numpy cannot judge (bf16 as ``|V2``), pass. The
    one float-poison predicate: :func:`tree_finite` and the checkpoint
    validator share it."""
    try:
        a = np.asarray(a)
        if a.dtype.kind in "fc" or "float" in str(a.dtype):
            return bool(np.isfinite(a).all())
    except (TypeError, ValueError) as e:
        logger.debug("finiteness probe skipped an array: %s", e)
    return True


def checkpoint_finite_check_enabled() -> bool:
    """The checkpoint-poison sweep's opt-out,
    ``HOROVOD_CHECKPOINT_FINITE_CHECK=0``, for states that legitimately
    hold non-finite leaves (an additive ``-inf`` mask buffer, a best-loss
    tracker at ``inf``)."""
    return os.environ.get(CKPT_FINITE_ENV, "1").lower() not in (
        "0", "false", "off")


def tree_finite(tree) -> bool:
    """Host-side finiteness sweep over the float array leaves of ``tree``
    (tensors, numpy arrays; other leaves and integer arrays pass)."""
    leaves, _ = pytree.flatten(tree)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype.is_floating_point and not bool(
                    torch.isfinite(leaf).all()):
                return False
        elif isinstance(leaf, (np.ndarray, np.generic)):
            if not array_finite(leaf):
                return False
    return True


def publish_gate_reason(state, tree) -> Optional[str]:
    """Why a weight publication of ``tree`` (taken from the training
    ``state``) must be refused, or None when it is safe:

    - ``"quarantine"`` — a corrupt rank was flagged by the fingerprint
      cross-check and not yet evicted (:func:`quarantine_pending`);
    - ``"bad_step"`` — the trainer's most recent guarded steps were BAD;
    - ``"nonfinite"`` — ``tree`` itself carries NaN/Inf.

    Disabled with ``HOROVOD_PUBLISH_NUMERICS_GATE=0``."""
    if os.environ.get(GATE_ENV, "1").lower() in ("0", "false", "off"):
        return None
    if quarantine_pending():
        return "quarantine"
    try:
        v = verdict(state) if state is not None else None
    except Exception as e:
        logger.debug("publish gate verdict read failed: %s", e)
        v = None
    if v is not None and v["bad_streak"] > 0:
        return "bad_step"
    if not tree_finite(tree):
        return "nonfinite"
    return None
