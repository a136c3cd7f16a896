"""PyTorch frontend: ``import horovod_tpu_torch.torch as hvd``.

Counterpart of ``horovod_tpu/torch/__init__.py``, name for name, and of
the reference's ``horovod/torch/__init__.py`` (0.19.2): a
``DistributedOptimizer`` that wraps a ``torch.optim`` optimizer and
allreduces each gradient as the backward accumulates it (per-parameter
hooks and ``backward_passes_per_step`` delay counters, reference
``torch/__init__.py:67-222``), so the exchange overlaps the rest of the
backward; ``broadcast_parameters`` / ``broadcast_optimizer_state`` /
``broadcast_object`` (``torch/__init__.py:451-648``); functional sync,
async and in-place collectives (:mod:`.mpi_ops`); fp16 compression
(:mod:`.compression`); and ``SyncBatchNorm`` (:mod:`.sync_batch_norm`).

The data plane is the port's own: NCCL on the card, gloo on the CPU,
over the tensors where they lie. With ``hvd.init(native_core=True)``
every named gradient is negotiated by the native core and fused with
the others ready in the same cycle into one collective
(:mod:`horovod_tpu_torch.core`).
"""

from __future__ import annotations

import collections
import contextlib

import torch

from horovod_tpu_torch.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size, process_rank, process_size, is_homogeneous,
    mpi_threads_supported, mpi_enabled, gloo_enabled,
    num_rank_is_power_2, gpu_available,
    nccl_built, mpi_built, gloo_built, ccl_built,
    ddl_built, xla_built,
)
from horovod_tpu_torch.torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    Adasum, Average, ReduceOp, Sum,
    allreduce, allreduce_, allreduce_async, allreduce_async_,
    grouped_allreduce, grouped_allreduce_,
    allgather, allgather_async,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    alltoall, alltoall_async,
    reducescatter, reducescatter_async,
    synchronize, poll, join,
)
from horovod_tpu_torch.torch.sync_batch_norm import SyncBatchNorm  # noqa: F401
from horovod_tpu_torch.ops.collective import (
    allgather_object,  # noqa: F401
    broadcast_object as _broadcast_object_impl,
)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Gradient-allreducing optimizer wrapper (reference
    ``torch/__init__.py:67-222``): a hook on every parameter fires when its
    gradient is fully accumulated, launches an async allreduce, and
    ``step()`` synchronizes all handles before applying the update."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, op=Average,
                 error_feedback=False):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.backward_passes_per_step = backward_passes_per_step
        if error_feedback and compression is Compression.none:
            raise ValueError(
                "error_feedback=True needs a lossy compression "
                "(e.g. Compression.fp16)"
            )
        self._error_feedback = error_feedback
        self._ef_residual = {}  # param -> rounding error kept back (EF-SGD)

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}", v)
                for i, pg in enumerate(self.param_groups)
                for v in pg["params"]
            ]
        # names must be unique and cover all parameters
        # (reference torch/__init__.py:82-110)
        all_names = [name for name, _ in named_parameters]
        if len(set(all_names)) < len(all_names):
            raise ValueError(
                "named_parameters should map parameter names to unique names"
            )
        named_set = {p for _, p in named_parameters}
        unnamed = [
            p for pg in self.param_groups for p in pg["params"]
            if p not in named_set
        ]
        if unnamed:
            raise ValueError(
                "named_parameters was specified, but one or more model "
                "parameters were not named"
            )
        self._parameter_names = {v: k for k, v in named_parameters}
        self._handles = {}
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay = {}
        if size() > 1:
            self._register_hooks()

    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    p.register_post_accumulate_grad_hook(self._make_post_hook(p))

    def _allreduce_grad_async(self, p):
        name = self._parameter_names.get(p)
        tensor = p.grad
        if self._error_feedback:
            # fold back what compression rounded away last step; keep this
            # step's rounding error for the next (as the functional
            # optimizer's error_feedback does). Residuals live in
            # their own dict — NOT self.state[p], which must stay empty
            # until the inner optimizer's lazy init (Adam-family checks
            # `len(state) == 0`) — and ride state_dict() via the explicit
            # hooks below.
            with torch.no_grad():
                if p not in self._ef_residual:
                    self._ef_residual[p] = torch.zeros_like(tensor)
                tensor = tensor + self._ef_residual[p]
                tensor_compressed, ctx = self._compression.compress(tensor)
                sent = self._compression.decompress(tensor_compressed, ctx)
                self._ef_residual[p] = tensor - sent
        else:
            tensor_compressed, ctx = self._compression.compress(tensor)
        handle = allreduce_async_(
            tensor_compressed, name=f"allreduce.{name}", op=self.op
        )
        return handle, (tensor_compressed, ctx)

    def _make_post_hook(self, p):
        def hook(param):
            self._do_hook(p)

        return hook

    def _do_hook(self, p):
        if p in self._handles and self._handles[p][0] is not None:
            if self._allreduce_delay[p] <= 0:
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to step(). "
                    "Increase backward_passes_per_step to accumulate "
                    "gradients locally."
                )
        if p.grad is not None and p.grad.requires_grad:
            raise AssertionError(
                "attempting to allreduce a gradient that requires grad"
            )
        handle, ctx = None, None
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            handle, ctx = self._allreduce_grad_async(p)
        self._handles[p] = (handle, ctx)

    def synchronize(self):
        """Wait for all outstanding gradient allreduces and write the reduced
        gradients back (reference ``torch/__init__.py:165-215``)."""
        # in parameter order: without the native core every rank must
        # launch its collectives in one order (a set's order follows the
        # tensors' addresses, which differ between processes)
        missing_p = [p for pg in self.param_groups for p in pg["params"]
                     if p in self._requires_update and p not in self._handles]
        for p in missing_p:
            if p.grad is None:
                p.grad = p.data.new(p.size()).zero_()
            self._handles[p] = self._allreduce_grad_async(p)

        for p, (handle, ctx) in self._handles.items():
            if handle is None:
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in list(self._handles.items()):
            output = synchronize(handle)
            self._allreduce_delay[p] = self.backward_passes_per_step
            _, comp_ctx = ctx
            with torch.no_grad():
                p.grad.copy_(
                    self._compression.decompress(output, comp_ctx).to(
                        p.grad.dtype
                    )
                )
        self._handles.clear()
        self._synchronized = True

    def state_dict(self, *args, **kwargs):
        """Inner optimizer state plus the error-feedback residuals (stored
        under their own key, indexed like torch's param ordering, so
        checkpoint/resume preserves not-yet-transmitted gradient mass)."""
        d = super(self.__class__, self).state_dict(*args, **kwargs)
        if self._error_feedback and self._ef_residual:
            index = {
                p: i
                for i, p in enumerate(
                    p for pg in self.param_groups for p in pg["params"]
                )
            }
            d["ef_residual"] = {
                index[p]: t.clone() for p, t in self._ef_residual.items()
            }
        return d

    def load_state_dict(self, state_dict, *args, **kwargs):
        state_dict = dict(state_dict)
        resid = state_dict.pop("ef_residual", None)
        super(self.__class__, self).load_state_dict(
            state_dict, *args, **kwargs
        )
        if resid is not None:
            params = [p for pg in self.param_groups for p in pg["params"]]
            # cast like torch does for per-param state: a CPU-loaded
            # checkpoint must land on each param's device/dtype
            # .clone(): Tensor.to returns self when device/dtype already
            # match, which would alias the caller's state_dict tensors
            self._ef_residual = {
                params[i]: t.to(params[i].device, params[i].dtype).clone()
                for i, t in resid.items()
            }

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Inside this context ``step()`` will not synchronize — for use
        after an explicit ``synchronize()`` call (reference
        ``torch/__init__.py:189-203``)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                import warnings

                warnings.warn(
                    "optimizer.step() called without "
                    "optimizer.skip_synchronize() context after "
                    "optimizer.synchronize(). This can cause training "
                    "slowdown. You may want to consider using "
                    "optimizer.skip_synchronize() context if you use "
                    "optimizer.synchronize() in your code."
                )
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This is "
                "prohibited as it can cause a race condition."
            )
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """Delta-style Adasum optimizer (reference ``torch/__init__.py:225-394``).

    Instead of allreducing *gradients*, each rank applies its local optimizer
    update to produce a parameter *delta* and the deltas are combined with
    the Adasum VHDD reduction, which preserves update magnitude regardless of
    worker count:

        start  = p                       (stashed per parameter)
        step() -> p = start - lr * f(g)  (local optimizer logic)
        delta  = p - start
        delta  = adasum_allreduce(delta)
        p      = start + delta
    """

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}", v)
                for i, pg in enumerate(self.param_groups)
                for v in pg["params"]
            ]
        all_names = [name for name, _ in named_parameters]
        if len(set(all_names)) < len(all_names):
            raise ValueError(
                "named_parameters should map parameter names to unique names"
            )
        named_set = {p for _, p in named_parameters}
        unnamed = [
            p for pg in self.param_groups for p in pg["params"]
            if p not in named_set
        ]
        if unnamed:
            raise ValueError(
                "named_parameters was specified, but one or more model "
                "parameters were not named"
            )
        self._parameter_names = {v: k for k, v in named_parameters}
        self._handles = {}
        self._requires_update = set()
        self._allreduce_delay = {}
        # per-parameter stash of the pre-step value; the reduced delta is
        # applied on top of it in step()
        self._starting_models = {
            p: torch.zeros_like(p, requires_grad=False)
            for _, p in named_parameters
        }
        self._register_hooks()

    def set_backward_passes_per_step(self, passes):
        self.backward_passes_per_step = passes
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = passes

    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    p.register_post_accumulate_grad_hook(self._make_post_hook(p))

    def _allreduce_delta_async(self, p):
        """Run the wrapped optimizer on `p` alone, turn the result into a
        delta, and launch its Adasum allreduce."""
        name = self._parameter_names.get(p)
        start = self._starting_models[p]

        # restrict the underlying step() to just this parameter
        stashed = []
        for group in self.param_groups:
            stashed.append(group["params"])
            group["params"] = [p] if any(p is v for v in group["params"]) else []
        start.data.copy_(p.data)
        super(self.__class__, self).step()
        for prev, group in zip(stashed, self.param_groups):
            group["params"] = prev

        with torch.no_grad():
            p.data.sub_(start)  # p now holds the local delta
        tensor_compressed, ctx = self._compression.compress(p.data)
        handle = allreduce_async_(
            tensor_compressed, name=f"adasum.{name}", op=Adasum
        )
        return handle, ctx

    def _make_post_hook(self, p):
        def hook(*ignore):
            if p in self._handles and self._handles[p][0] is not None:
                if self._allreduce_delay[p] <= 0:
                    raise AssertionError(
                        "Gradients were computed more than "
                        "backward_passes_per_step times before call to "
                        "step(). Increase backward_passes_per_step to "
                        "accumulate gradients locally."
                    )
            handle, ctx = None, None
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                handle, ctx = self._allreduce_delta_async(p)
            self._handles[p] = (handle, ctx)

        return hook

    def synchronize(self):
        """No-op: Adasum synchronization happens inside step() (reference
        ``torch/__init__.py:357-359``)."""

    @contextlib.contextmanager
    def skip_synchronize(self):
        raise AssertionError(
            "Skipping synchronization is not supported when using Adasum "
            "optimizer."
        )

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        missing_p = [p for pg in self.param_groups for p in pg["params"]
                     if p in self._requires_update and p not in self._handles]
        for p in missing_p:
            self._handles[p] = self._allreduce_delta_async(p)
        for p, (handle, ctx) in list(self._handles.items()):
            if handle is None:  # step() before backward_passes_per_step done
                handle, ctx = self._allreduce_delta_async(p)
            delta = synchronize(handle)
            delta = self._compression.decompress(delta, ctx)
            start = self._starting_models[p]
            with torch.no_grad():
                start.data.add_(delta)
                p.data.copy_(start)
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._handles.clear()
        return loss

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step(). This is prohibited as it can cause "
                "a race condition."
            )
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average,
                         error_feedback=False):
    """Wrap a ``torch.optim.Optimizer`` so gradients are allreduced across
    ranks during ``backward()`` (reference ``torch/__init__.py:397-448``).
    With ``op=Adasum`` the wrapper switches to the delta-style
    :class:`_DistributedAdasumOptimizer`. ``error_feedback=True`` (beyond
    the reference) keeps each rank's compression rounding error and folds it
    into the next step's gradient — see ``docs/performance.md``."""
    impl = _DistributedAdasumOptimizer if op == Adasum else _DistributedOptimizer
    cls = type(
        optimizer.__class__.__name__,
        (optimizer.__class__,),
        dict(impl.__dict__),
    )
    if op == Adasum:
        if error_feedback:
            raise ValueError("error_feedback is not supported with op=Adasum")
        return cls(
            optimizer.param_groups, named_parameters, compression,
            backward_passes_per_step,
        )
    return cls(
        optimizer.param_groups, named_parameters, compression,
        backward_passes_per_step, op, error_feedback,
    )


def broadcast_parameters(params, root_rank=0):
    """Broadcast parameters from `root_rank` to all ranks — the
    start-of-training sync (reference ``torch/__init__.py:451-478``). Accepts
    a ``state_dict()`` or an iterable of ``(name, tensor)``."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif isinstance(params, collections.abc.Iterable):
        params = list(params)
    else:
        raise ValueError("invalid params of type: %s" % type(params))

    handles = []
    for name, p in params:
        if p is None:
            continue
        handles.append(broadcast_async_(p, root_rank, name=f"bcastparam.{name}"))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcast an optimizer's state (momenta, step counters, param-group
    hyperparameters) from `root_rank` (reference
    ``torch/__init__.py:481-607``): tensor state is broadcast tensor-wise,
    scalar state is wrapped into tensors, non-numeric options ride
    ``broadcast_object``."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()

    if not state_dict["state"]:
        # Newly constructed optimizers have no state: run a dummy
        # zero-gradient step to materialize it so all ranks agree on the
        # schema (reference torch/__init__.py:497-508). This must run on
        # EVERY rank — with a DistributedOptimizer the step allreduces, and
        # a root-only step would deadlock the other ranks.
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = p.data.new(p.size()).zero_()
        optimizer.step()
        state_dict = optimizer.state_dict()

    # scalars (lr, momentum, step counts, ...) and structure go by object
    # broadcast; tensor state goes tensor-wise so large momenta do not get
    # pickled.
    tensors = {}
    meta = {"param_groups": [], "state": {}}
    for i, group in enumerate(state_dict["param_groups"]):
        meta["param_groups"].append(
            {k: v for k, v in group.items() if k != "params"}
        )
    for pid, pstate in state_dict["state"].items():
        meta_p = {}
        for k, v in pstate.items():
            if torch.is_tensor(v):
                tensors[f"{pid}/{k}"] = v
                meta_p[k] = "__tensor__"
            else:
                meta_p[k] = v
        meta["state"][pid] = meta_p
    meta = broadcast_object(meta, root_rank, name="opt_state_meta")

    for i, g_meta in enumerate(meta["param_groups"]):
        state_dict["param_groups"][i].update(g_meta)
    for pid, meta_p in meta["state"].items():
        pstate = state_dict["state"].setdefault(pid, {})
        for k, v in meta_p.items():
            if v == "__tensor__":
                t = tensors.get(f"{pid}/{k}")
                if t is None:
                    raise ValueError(
                        f"rank {rank()} missing optimizer state tensor "
                        f"{pid}/{k} present on root {root_rank}"
                    )
                broadcast_(t, root_rank, name=f"optstate.{pid}.{k}")
                pstate[k] = t
            else:
                pstate[k] = v
    optimizer.load_state_dict(state_dict)


def broadcast_object(obj, root_rank=0, name=None):
    """Broadcast an arbitrary picklable object (reference
    ``torch/__init__.py:609-648``)."""
    del name
    return _broadcast_object_impl(obj, root_rank)
