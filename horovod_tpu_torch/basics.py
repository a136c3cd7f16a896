"""Process-group bootstrap and identity queries.

Counterpart of ``horovod_tpu/basics.py``. The JAX package makes one
process own a mesh of chips; the port follows Horovod itself: one process
per GPU, ``rank``/``size`` are the ``torch.distributed`` rank and world
size, and every collective runs over the one process group
:func:`init` creates.

Identity comes from the environment, first ``HOROVOD_RANK`` /
``HOROVOD_SIZE`` / ``HOROVOD_LOCAL_RANK`` / ``HOROVOD_LOCAL_SIZE`` (what
``horovod_tpu.run`` exports), then torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; with neither the world is this one
process. A multi-process world rendezvous at ``init_method`` (default
``env://``, i.e. ``MASTER_ADDR``/``MASTER_PORT``).
"""

from __future__ import annotations

import dataclasses
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
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


_state = _State()


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def init(device=None, *, init_method: Optional[str] = None,
         rank: Optional[int] = None, size: Optional[int] = None,
         local_rank: Optional[int] = None) -> None:
    """Initialize the framework (``hvd.init()``).

    With no ``device`` the process takes ``cuda:<local_rank>`` and the
    NCCL backend, and raises if CUDA is unavailable: the port never
    carries on on the CPU unasked. ``device="cpu"`` selects the CPU and
    the gloo backend (what the CPU tests use). ``rank``/``size``/
    ``local_rank`` override the environment. Calling ``init`` again
    before :func:`shutdown` is a no-op, as in the reference."""
    with _state.lock:
        if _state.initialized:
            return
        r = rank if rank is not None else _env_int("HOROVOD_RANK", "RANK")
        n = size if size is not None else _env_int("HOROVOD_SIZE", "WORLD_SIZE")
        lr = local_rank if local_rank is not None else _env_int(
            "HOROVOD_LOCAL_RANK", "LOCAL_RANK")
        ls = _env_int("HOROVOD_LOCAL_SIZE", "LOCAL_WORLD_SIZE")
        r, n = (r or 0), (n or 1)
        lr = lr if lr is not None else r
        if not 0 <= r < n:
            raise ValueError(f"rank {r} out of range for world size {n}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init(): CUDA is not available; pass "
                    "device='cpu' to run on the CPU deliberately")
            dev = torch.device("cuda", lr % torch.cuda.device_count())
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
        if n == 1 and init_method is None:
            # a world of one needs no rendezvous: an in-process store
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = init_method or "env://"
        dist.init_process_group(backend, rank=r, world_size=n, **kw)
        _state.rank, _state.size = r, n
        _state.local_rank = lr
        _state.local_size = ls if ls is not None else (
            min(n, torch.cuda.device_count()) if dev.type == "cuda" else n)
        _state.device = dev
        _state.initialized = True


def shutdown() -> None:
    """Tear the process group down; a later :func:`init` starts afresh."""
    with _state.lock:
        if not _state.initialized:
            return
        dist.destroy_process_group()
        _state.initialized = False
        _state.device = None


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


def device() -> torch.device:
    """The device this process computes on (``cuda:<local_rank>`` or cpu)."""
    _require_init()
    return _state.device


def num_rank_is_power_2(num: int) -> bool:
    """Is ``num`` a power of two? The Adasum precondition user scripts
    check before opting into ``op=hvd.Adasum``."""
    return num != 0 and (num & (num - 1)) == 0
