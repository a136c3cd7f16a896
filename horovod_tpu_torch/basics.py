"""Process-group bootstrap and identity queries.

Counterpart of ``horovod_tpu/basics.py``. The JAX package makes one
process own a mesh of chips; the port follows Horovod itself: one process
per GPU, ``rank``/``size`` are the ``torch.distributed`` rank and world
size, and every collective runs over the one process group
:func:`init` creates.

Identity comes from the environment, first ``HOROVOD_RANK`` /
``HOROVOD_SIZE`` / ``HOROVOD_LOCAL_RANK`` / ``HOROVOD_LOCAL_SIZE`` (what
``horovod_tpu_torch.run`` exports), then torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; with neither the world is this one
process. A multi-process world rendezvous at ``init_method`` (default
``env://``, i.e. ``MASTER_ADDR``/``MASTER_PORT``).

``init(native_core=True)`` (or ``HOROVOD_NATIVE_CORE=1``) also attaches
the native control-plane core (:mod:`horovod_tpu_torch.core`): named
async collectives are then negotiated across ranks and fused before they
run. It is off by default, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class _State:
    initialized: bool = False
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    device: Optional[torch.device] = None
    core: Optional[object] = None
    #: the host mesh of :func:`horovod_tpu_torch.parallel.mesh.build_host_mesh`
    host_mesh: Optional[object] = None
    #: the named-axis mesh of :func:`horovod_tpu_torch.parallel.mesh.build_mesh`
    mesh: Optional[object] = None
    #: the rendezvous store the process group was formed over (the elastic
    #: driver re-forms its generations under prefixes of it)
    store: Optional[dist.Store] = None
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


_state = _State()

logger = logging.getLogger("horovod_tpu_torch")


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def init(device=None, *, init_method: Optional[str] = None,
         rank: Optional[int] = None, size: Optional[int] = None,
         local_rank: Optional[int] = None,
         native_core: Optional[bool] = None,
         store: Optional[dist.Store] = None) -> None:
    """Initialize the framework (``hvd.init()``).

    With no ``device`` the process takes ``cuda:<local_rank>`` and the
    NCCL backend, and raises if CUDA is unavailable: the port never
    carries on on the CPU unasked. ``device="cpu"`` selects the CPU and
    the gloo backend (what the CPU tests use). ``rank``/``size``/
    ``local_rank`` override the environment. ``store`` is a rendezvous
    store to join instead of ``init_method`` (a ``TCPStore`` client of a
    server that already listens: :func:`horovod_tpu_torch.testing.
    run_world` serves one). Calling ``init`` again before :func:`shutdown`
    is a no-op, as in the reference.

    ``native_core`` (default ``HOROVOD_NATIVE_CORE=1``) attaches the
    native core, built at first use; across processes its coordinator is
    rank 0 at ``HVD_CORE_COORD_ADDR``:``HVD_CORE_COORD_PORT`` (default
    ``MASTER_PORT`` + 1: the process group's store holds ``MASTER_PORT``
    itself). A core that cannot be built or started raises."""
    with _state.lock:
        if _state.initialized:
            return
        from horovod_tpu_torch import compat

        compat.warn_if_unsupported()
        r = rank if rank is not None else _env_int("HOROVOD_RANK", "RANK")
        n = size if size is not None else _env_int("HOROVOD_SIZE", "WORLD_SIZE")
        lr = local_rank if local_rank is not None else _env_int(
            "HOROVOD_LOCAL_RANK", "LOCAL_RANK")
        # the launched slot's host-local size; a world the caller sizes
        # itself (``size=``, the elastic re-formations) derives its own
        ls = _env_int("HOROVOD_LOCAL_SIZE", "LOCAL_WORLD_SIZE") \
            if size is None else None
        r, n = (r or 0), (n or 1)
        lr = lr if lr is not None else r
        if not 0 <= r < n:
            raise ValueError(f"rank {r} out of range for world size {n}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init(): CUDA is not available; pass "
                    "device='cpu' to run on the CPU deliberately")
            gpus = torch.cuda.device_count()
            slots = ls if ls is not None else lr + 1
            if slots > gpus:
                raise RuntimeError(
                    f"horovod_tpu_torch.init(): {slots} local slots on this "
                    f"host but {gpus} visible GPUs: one process drives one "
                    f"GPU, so launch at most {gpus} slots a host (two ranks "
                    f"on one GPU would fail later inside NCCL)")
            dev = torch.device("cuda", lr % gpus)
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"unsupported device {dev}")
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = dev
        if store is not None:
            kw["store"] = store
        elif n == 1 and init_method is None:
            # a world of one needs no rendezvous: an in-process store
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = init_method or "env://"
        dist.init_process_group(backend, rank=r, world_size=n, **kw)
        _state.store = kw.get("store")
        if _state.store is None:
            _state.store = dist.distributed_c10d._get_default_store()
        _state.rank, _state.size = r, n
        _state.local_rank = lr
        _state.local_size = ls if ls is not None else (
            min(n, torch.cuda.device_count()) if dev.type == "cuda" else n)
        _state.device = dev
        use_core = native_core
        if use_core is None:
            use_core = os.environ.get("HOROVOD_NATIVE_CORE", "0") == "1"
        if use_core:
            from horovod_tpu_torch.core import NativeCore

            try:
                _state.core = NativeCore(
                    rank=r, size=n, device=dev,
                    coordinator_host=os.environ.get("HVD_CORE_COORD_ADDR"),
                    coordinator_port=_coordinator_port(n))
            except BaseException:
                dist.destroy_process_group()
                _state.store = None
                raise
        _state.initialized = True
    _observability_up(r)


def _observability_up(rank: int) -> None:
    """Every rank records host spans for the fleet merge
    (``HOROVOD_TRACE_ALL_RANKS=0``: rank 0 only); rank 0 serves the
    metrics endpoint when ``HOROVOD_METRICS_PORT`` is set; the hang
    watchdog is armed when ``HOROVOD_HANG_TIMEOUT`` > 0. Observability
    never fails ``init``, but says why it is missing."""
    try:
        from horovod_tpu_torch.observability import exporters, flight, trace

        all_ranks = os.environ.get(
            "HOROVOD_TRACE_ALL_RANKS", "1").lower() not in ("0", "false")
        trace.set_recording(rank == 0 or all_ranks)
        if rank == 0:
            exporters.maybe_start_http_server()
        flight.maybe_arm_watchdog()
    except Exception as e:
        logger.debug("observability bring-up skipped: %s", e)


def flush_timeline() -> None:
    """Flush the host trace ring: rank 0 merges it into the
    ``HOROVOD_TIMELINE`` file (the one the native core wrote, when it is
    attached); every other rank writes its sidecar
    ``<HOROVOD_TIMELINE>.rank<r>.json`` for the skew-corrected fleet merge
    (:func:`~horovod_tpu_torch.observability.clock.merge_rank_traces`).
    :func:`shutdown` and the preemption drain call it."""
    from horovod_tpu_torch.observability import trace

    if _state.rank == 0:
        trace.flush()
    else:
        base = os.environ.get("HOROVOD_TIMELINE")
        if base:
            trace.flush(f"{base}.rank{_state.rank}.json")


def _coordinator_port(n: int) -> int:
    """The core's coordinator port: ``HVD_CORE_COORD_PORT``, else the
    port above ``MASTER_PORT`` (which rank 0's rendezvous store already
    binds under ``env://``). A world of one negotiates alone and needs
    none; a larger one with neither variable set raises."""
    if "HVD_CORE_COORD_PORT" in os.environ:
        return int(os.environ["HVD_CORE_COORD_PORT"])
    if "MASTER_PORT" in os.environ:
        return int(os.environ["MASTER_PORT"]) + 1
    if n > 1:
        raise ValueError(
            "the native core's coordinator needs a port: set "
            "HVD_CORE_COORD_PORT (or MASTER_PORT, whose next port it takes)")
    return 0


def shutdown() -> None:
    """Shut the native core down (if attached), then tear the process
    group down; a later :func:`init` starts afresh, over another store and
    world size too (the elastic resize): the meshes and their sub-groups
    go with the group, and the outstanding async-collective names are
    forgotten (an op left in flight when a world ended must not poison the
    next one with a duplicate name)."""
    with _state.lock:
        if not _state.initialized:
            return
        if _state.core is not None:
            _state.core.shutdown()
            _state.core = None
        _observability_down()
        _state.host_mesh = None
        _state.mesh = None
        from horovod_tpu_torch.ops import collective as _C

        _C.clear_outstanding_names()
        dist.destroy_process_group()
        _state.initialized = False
        _state.device = None
        _state.store = None


def _observability_down() -> None:
    """At shutdown, after the native core closed its timeline: merge the
    host spans into it, disarm the hang watchdog and flush the flight
    ring, and publish the last step's sanitizer record and the guard's
    lagged verdict (the final step has no next boundary)."""
    from horovod_tpu_torch.analysis import sanitizer
    from horovod_tpu_torch.observability import flight
    from horovod_tpu_torch.resilience import numerics

    for what, fn in (("timeline", flush_timeline),
                     ("flight", lambda: (flight.disarm_watchdog(),
                                         flight.flush())),
                     ("sanitizer", sanitizer.flush),
                     ("numerics", numerics.flush_staged)):
        try:
            fn()
        except Exception as e:
            logger.debug("%s flush at shutdown failed: %s", what, e)


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> None:
    if not _state.initialized:
        raise RuntimeError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")


def rank() -> int:
    _require_init()
    return _state.rank


def size() -> int:
    _require_init()
    return _state.size


def local_rank() -> int:
    _require_init()
    return _state.local_rank


def local_size() -> int:
    _require_init()
    return _state.local_size


def cross_rank() -> int:
    """This process's host among the hosts (``rank // local_size``)."""
    _require_init()
    return _state.rank // _state.local_size


def cross_size() -> int:
    """The number of hosts (``size // local_size``, at least 1)."""
    _require_init()
    return max(_state.size // _state.local_size, 1)


def process_rank() -> int:
    """One process per rank: the rank."""
    return rank()


def process_size() -> int:
    """One process per rank: the world size."""
    return size()


def is_homogeneous() -> bool:
    """Every host runs ``local_size`` ranks."""
    _require_init()
    return _state.size % _state.local_size == 0


def core():
    """The attached native core, or None (``init(native_core=True)``
    attaches it)."""
    _require_init()
    return _state.core


def health_state():
    """This process's :class:`~horovod_tpu_torch.resilience.HealthState`
    (``HEALTHY → SUSPECT → DEGRADED → FATAL``), fed by the native core's
    cycle/stall signals and the retry layer. Readable before :func:`init`
    (always ``HEALTHY`` until something feeds the monitor)."""
    from horovod_tpu_torch.resilience import health as _health

    return _health.health_state()


def health() -> dict:
    """JSON-able health snapshot (state, reason, strike count, last-beat
    age), what the JAX package's rank-0 metrics endpoint serves at
    ``/health``."""
    from horovod_tpu_torch.resilience import health as _health

    return _health.snapshot()


def device() -> torch.device:
    """The device this process computes on (``cuda:<local_rank>`` or cpu)."""
    _require_init()
    return _state.device


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else this
    process's (:func:`device`) once :func:`init` has run, else
    ``cuda:0``; raises when that needs CUDA and there is none (pass
    ``device="cpu"`` to run on the CPU deliberately)."""
    if device is not None:
        return torch.device(device)
    if _state.initialized:
        return _state.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU "
            "deliberately")
    return torch.device("cuda", 0)


def num_rank_is_power_2(num: int) -> bool:
    """Is ``num`` a power of two? The Adasum precondition user scripts
    check before opting into ``op=hvd.Adasum``."""
    return num != 0 and (num & (num - 1)) == 0


# --- build and availability flags, for this installation


def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    """The port never runs over MPI."""
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def xla_built() -> bool:
    """The port's data plane is PyTorch, not XLA."""
    return False


def gpu_available(ext_base_name: str = None, verbose: bool = False) -> bool:
    """Is a CUDA device visible to this process?"""
    del ext_base_name, verbose
    return torch.cuda.is_available()


def mpi_enabled() -> bool:
    return False


def gloo_enabled() -> bool:
    """Does the process group run on gloo (the CPU backend)?"""
    _require_init()
    return dist.get_backend() == "gloo"
