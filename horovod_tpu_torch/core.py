"""ctypes bridge to the native control-plane core.

Counterpart of ``horovod_tpu/core.py``, class for class. The core is the
framework-free C++ of the repository's ``csrc/`` (built by
:func:`horovod_tpu_torch.ops._build.core_library` into the package's
``_build/``): a background thread with the tensor queue, the
coordinator's negotiation (TCP across processes), the response cache,
fusion bin-packing, stall detection and the timeline. It never sees a
tensor's bytes. Each cycle it calls back with a fused execution plan
(tensor names and op parameters), and :meth:`NativeCore._execute_one`
runs that plan as **one** collective of :mod:`horovod_tpu_torch.ops.
collective` over the entries' tensors: allreduce and Adasum through
``grouped_allreduce``, allgather through ``grouped_allgather``, the
others entry by entry.

The rules that keep it right on the card:

- streams: :meth:`NativeCore.enqueue` records a CUDA event on the
  caller's current stream (the reference's ReadyEvent). The core's
  thread runs every plan on a stream of its own, which first waits on
  the entries' ready events; after the collective it records a
  completion event. :meth:`CoreHandle.wait` makes the caller's stream
  wait on that event, and :meth:`CoreHandle.done` queries it. No
  tensor is staged through the host.
- communicators: the core issues its collectives on a process group of
  its own (``dist.new_group`` over every rank, made when it attaches).
  While it is attached it is the only thread of the process that issues
  collectives of :mod:`horovod_tpu_torch.ops.collective`'s public ops:
  an op from any other thread, named or not, sync or async, is queued to
  it (an unnamed one as ``<op>.noname.<k>``, :meth:`NativeCore.
  auto_name`), so every rank issues them in the one negotiated order.
  Two threads issuing on two NCCL communicators, each in an order of its
  own, can deadlock the card: a hook's unnamed allreduce on the default
  group beside the core's plans did, across four GPUs.
- the tuned hierarchical toggles: the tail of each cycle's response list
  carries the coordinator's hierarchical allreduce / allgather choice
  (-1 = never tuned); each cycle applies it to
  :mod:`horovod_tpu_torch.ops.hierarchical` before running its plans
  (:meth:`NativeCore._apply_hier_toggles`), and :meth:`NativeCore.
  shutdown` restores what the process had before.

The JAX package's ``_Buckets`` are not carried over: they exist to keep
compiled XLA launch signatures fixed, and an eager NCCL call has none.
A tensor's result does not depend on which fused response it rode in.

Knobs, as in the reference: ``HOROVOD_FUSION_THRESHOLD`` (bytes),
``HOROVOD_CYCLE_TIME`` (ms), ``HOROVOD_CACHE_CAPACITY``,
``HOROVOD_TIMELINE``, ``HOROVOD_STALL_CHECK_TIME_SECONDS``,
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import logging
import os
import struct
import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.observability import trace as _trace
from horovod_tpu_torch.resilience import health as _health

logger = logging.getLogger("horovod_tpu_torch.core")

REQUEST_ALLREDUCE = 0
REQUEST_ALLGATHER = 1
REQUEST_BROADCAST = 2
REQUEST_JOIN = 3
REQUEST_ADASUM = 4
REQUEST_ALLTOALL = 5
REQUEST_REDUCESCATTER = 6
REQUEST_BARRIER = 7

RESPONSE_ERROR = 8

#: the name JOIN responses carry (csrc ``kJoinTensorName``)
JOIN_TENSOR_NAME = "__hvd_join__"

# mirror of csrc/include/hvd/common.h DataType
_DTYPE_TO_TAG = {
    torch.uint8: 0,
    torch.int8: 1,
    torch.int16: 3,
    torch.int32: 4,
    torch.int64: 5,
    torch.float16: 6,
    torch.bfloat16: 7,
    torch.float32: 8,
    torch.float64: 9,
    torch.bool: 10,
}
_TAG_TO_DTYPE = {t: d for d, t in _DTYPE_TO_TAG.items()}


def _dtype_tag(dtype) -> int:
    try:
        return _DTYPE_TO_TAG[dtype]
    except KeyError:
        raise ValueError(f"the native core carries no {dtype}") from None


def _tag_dtype(tag: int):
    """Inverse of :func:`_dtype_tag` (a joined rank's zero backfill builds
    its tensors from the response alone)."""
    try:
        return _TAG_TO_DTYPE[tag]
    except KeyError:
        raise ValueError(f"unknown dtype tag {tag}") from None


class Response:
    """Decoded execution plan (mirror of ``hvd::Response``)."""

    __slots__ = (
        "response_type",
        "tensor_names",
        "error_message",
        "tensor_sizes",
        "tensor_dtypes",
        "tensor_output_elements",
        "tensor_shapes",
        "tensor_type",
        "root_rank",
        "reduce_op",
        "axis_name",
        "prescale_factor",
        "postscale_factor",
    )


def _parse_response_list(buf: bytes) -> tuple:
    """``(responses, hier_allreduce, hier_allgather)`` of one serialized
    ``hvd::ResponseList``. The header (shutdown flag, tuned cycle time,
    fusion threshold, cache toggle) is applied inside the C loop; the
    tail's hierarchical pair (-1 = never tuned, absent on an older core)
    is the Python data plane's to apply."""
    off = 0

    def take(fmt):
        nonlocal off
        (v,) = struct.unpack_from(fmt, buf, off)
        off += struct.calcsize(fmt)
        return v

    def s():
        nonlocal off
        n = take("<I")
        v = buf[off:off + n].decode()
        off += n
        return v

    off = struct.calcsize("<B") + struct.calcsize("<d") + \
        struct.calcsize("<q") + struct.calcsize("<i")
    out = []
    for _ in range(take("<I")):
        r = Response()
        r.response_type = take("<i")
        r.tensor_names = [s() for _ in range(take("<I"))]
        r.error_message = s()
        r.tensor_sizes = [take("<q") for _ in range(take("<I"))]
        r.tensor_dtypes = [take("<i") for _ in range(take("<I"))]
        r.tensor_output_elements = [take("<q") for _ in range(take("<I"))]
        r.tensor_shapes = [tuple(take("<q") for _ in range(take("<I")))
                           for _ in range(take("<I"))]
        r.tensor_type = take("<i")
        r.root_rank = take("<i")
        r.reduce_op = take("<i")
        r.axis_name = s() or None
        r.prescale_factor = take("<d")
        r.postscale_factor = take("<d")
        out.append(r)
    hier_ar = hier_ag = -1
    if off + 8 <= len(buf):
        hier_ar, hier_ag = take("<i"), take("<i")
    return out, hier_ar, hier_ag


#: what a generated name calls each request type (:meth:`NativeCore.auto_name`)
_KIND = {REQUEST_ALLREDUCE: "allreduce", REQUEST_ALLGATHER: "allgather",
         REQUEST_BROADCAST: "broadcast", REQUEST_ADASUM: "adasum",
         REQUEST_ALLTOALL: "alltoall", REQUEST_REDUCESCATTER: "reducescatter"}


class CoreHandle:
    """Completion handle for a core-negotiated collective. On the card it
    carries the ReadyEvent recorded at enqueue and the completion event
    the core's stream records after the collective."""

    __slots__ = ("name", "event", "result", "error", "ready", "finished",
                 "on_wait")

    def __init__(self, name: str, ready=None):
        self.name = name
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.ready = ready
        self.finished = None
        #: called once the op has completed and is waited on
        self.on_wait = None

    def done(self) -> bool:
        """Has the collective completed (on the card: its completion
        event, queried)?"""
        if not self.event.is_set():
            return False
        return self.finished is None or self.finished.query()

    def wait(self, timeout: Optional[float] = None):
        """The result, once the core has run the plan; on the card the
        caller's current stream then waits on the completion event."""
        if not self.event.wait(timeout):
            # attributable from the exception alone: which tensor, and what
            # the process-wide health machine thinks right now
            _health.record_timeout(self.name)
            state = _health.health_state()
            reason = _health.MONITOR.reason()
            err = TimeoutError(
                f"collective '{self.name}' did not complete within "
                f"{timeout}s (health: {state.name}"
                + (f", {reason}" if reason else "") + ")")
            err.tensor_name = self.name
            err.health_state = state
            raise err
        if self.on_wait is not None:
            self.on_wait()
            self.on_wait = None
        if self.error is not None:
            raise RuntimeError(self.error)
        if self.finished is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.finished)
            for t in _tensors(self.result):
                t.record_stream(stream)
        return self.result


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


def _reduce(arrays, op):
    """One fused reduction of a plan's tensors: ``grouped_allreduce``
    (Average, Sum, Adasum), or its flat buffer for Min and Max, which
    ``grouped_allreduce`` sums as the JAX package's does."""
    from horovod_tpu_torch.ops import collective as C

    if op in (C.Min, C.Max):
        return C._grouped_flat_allreduce(arrays, op)
    return C.grouped_allreduce(arrays, op)


# POINTER(c_char), not c_char_p: the payload is binary
_EXEC_CB_T = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_char), ctypes.c_int,
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int)
_LOG_CB_T = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p)


class NativeCore:
    """The loaded core, the registry of pending entries, and the stream
    and process group the core's collectives run on."""

    def __init__(self, rank: int = 0, size: int = 1,
                 coordinator_host: Optional[str] = None,
                 coordinator_port: int = 0, device=None):
        if size > 1 and not coordinator_host:
            raise ValueError(
                "multi-process native core requires a coordinator: set "
                "HVD_CORE_COORD_ADDR (and optionally HVD_CORE_COORD_PORT) or "
                "pass coordinator_host; otherwise each process would "
                "negotiate alone and launch mismatched collectives")
        from horovod_tpu_torch.ops import _build

        self._lib = ctypes.CDLL(_build.core_library())
        self._configure_signatures()
        self._device = torch.device(device or "cpu")
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        # the core's own communicator over every rank (see the module doc)
        self._group = dist.new_group(ranks=list(range(size))) \
            if dist.is_initialized() else None
        self._pending: Dict[int, tuple] = {}
        self._pending_mu = threading.Lock()
        self._next_handle = 0
        self._noname = itertools.count()
        #: the tuned hierarchical pair last applied, and the toggles the
        #: process had before the first one (restored at shutdown)
        self._hier_applied = (-1, -1)
        self._hier_saved = None
        #: plans run as collectives since the core attached, and by
        #: request type (``REQUEST_ALLREDUCE``, ``REQUEST_ADASUM``, ...)
        self.responses = 0
        self.plan_counts: Dict[int, int] = {}

        # keep the callback objects alive for the library's lifetime
        self._exec_cb = _EXEC_CB_T(self._on_execute)
        self._log_cb = _LOG_CB_T(self._on_log)
        self._lib.hvd_core_set_exec_callback(self._exec_cb)
        self._lib.hvd_core_set_log_callback(self._log_cb)

        env = os.environ
        if env.get("HOROVOD_TIMELINE"):
            # the host recorder's ts=0 is the native timeline's t0
            # (hvd_core_init runs next): one load of the merged file
            # shows both on one timebase
            _trace.set_epoch()
        rc = self._lib.hvd_core_init(
            rank,
            size,
            (coordinator_host or "").encode(),
            coordinator_port,
            float(env.get("HOROVOD_CYCLE_TIME", "5")),
            int(env.get("HOROVOD_FUSION_THRESHOLD", str(64 * 1024 * 1024))),
            int(env.get("HOROVOD_CACHE_CAPACITY", "1024")),
            float(env.get("HOROVOD_STALL_CHECK_TIME_SECONDS", "60")),
            float(env.get("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "0")),
            env.get("HOROVOD_TIMELINE", "").encode(),
        )
        if rc != 0:
            raise RuntimeError("native core initialization failed")

    def _configure_signatures(self):
        lib = self._lib
        lib.hvd_core_init.restype = ctypes.c_int
        lib.hvd_core_init.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_char_p,
        ]
        lib.hvd_core_enqueue.restype = ctypes.c_int
        lib.hvd_core_enqueue.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
            ctypes.c_char_p,
        ]
        lib.hvd_core_set_exec_callback.argtypes = [_EXEC_CB_T]
        lib.hvd_core_set_log_callback.argtypes = [_LOG_CB_T]
        lib.hvd_core_cycle_time_ms.restype = ctypes.c_double
        lib.hvd_core_set_cycle_time_ms.argtypes = [ctypes.c_double]
        lib.hvd_core_fusion_threshold.restype = ctypes.c_int64
        lib.hvd_core_set_fusion_threshold.argtypes = [ctypes.c_int64]
        lib.hvd_core_cache_hit_count.restype = ctypes.c_uint64
        lib.hvd_core_hier_allreduce.restype = ctypes.c_int
        lib.hvd_core_hier_allgather.restype = ctypes.c_int
        lib.hvd_core_set_autotuned_params.argtypes = [
            ctypes.c_double, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]

    # ------------------------------------------------------------- callbacks

    def _on_log(self, level: int, msg: bytes):
        text = msg.decode(errors="replace")
        logger.log({0: logging.DEBUG, 1: logging.INFO,
                    2: logging.WARNING}.get(level, logging.ERROR),
                   "%s", text)
        if level >= 2 and text.startswith("Stalled collective:"):
            # the stall inspector's warning (csrc stall_inspector.h:
            # "Stalled collective: NAME waited Xs; missing ranks: ...")
            # feeds the health state machine
            try:
                rest = text[len("Stalled collective:"):].strip()
                name, _, tail = rest.partition(" waited ")
                seconds = float(tail.split("s", 1)[0]) if tail else 0.0
                _health.record_stall(name, seconds)
            except ValueError:  # the log text must never crash the callback
                _health.record_stall(text)

    def _on_execute(self, payload, length, handles_ptr, n_handles):
        """Runs on the core's background thread (ctypes holds the GIL)."""
        from horovod_tpu_torch.ops import collective as C

        try:
            buf = ctypes.string_at(payload, length)
            responses, hier_ar, hier_ag = _parse_response_list(buf)
            self._apply_hier_toggles(hier_ar, hier_ag)
            handles = [handles_ptr[i] for i in range(n_handles)]
            stream = contextlib.nullcontext()
            if self._stream is not None:
                torch.cuda.set_device(self._device)
                stream = torch.cuda.stream(self._stream)
            with C.on_group(self._group), stream, torch.no_grad(), \
                    _trace.span("cycle", "EXECUTE_PLAN"):
                for resp in responses:
                    self._execute_one(resp, handles)
            if responses:
                # a cycle that launched negotiated plans is progress; empty
                # cycles are not (they keep firing while a tensor stalls,
                # and must not reset the stall strikes)
                _health.beat()
        except Exception:  # never let an exception escape into C
            logger.exception("execution callback failed")
            with self._pending_mu:
                items = list(self._pending.values())
                self._pending.clear()
            for h, _, _ in items:
                h.error = "internal execution failure"
                h.event.set()

    def _apply_hier_toggles(self, hier_ar: int, hier_ag: int):
        """Apply the coordinator's tuned hierarchical strategies at this
        cycle's boundary, before its plans run (the JAX package's
        ``_apply_hier_toggles``). -1 leaves the process's own choice
        (``set_hierarchical`` or the env); the toggles before the first
        tuned value are kept for :meth:`shutdown`."""
        if (hier_ar, hier_ag) == self._hier_applied:
            return
        from horovod_tpu_torch.ops import hierarchical

        if self._hier_saved is None and (hier_ar >= 0 or hier_ag >= 0):
            self._hier_saved = (hierarchical._forced,
                                hierarchical._forced_allgather)
        if hier_ar >= 0:
            hierarchical.set_hierarchical(bool(hier_ar))
        if hier_ag >= 0:
            hierarchical.set_hierarchical_allgather(bool(hier_ag))
        self._hier_applied = (hier_ar, hier_ag)

    def _finish(self, entries, outs):
        """Hand each live entry its result; on the card after recording
        the completion event on the core's stream."""
        self.responses += 1
        finished = None
        if self._stream is not None:
            finished = torch.cuda.Event()
            finished.record(self._stream)
            for t in _tensors(outs):
                t.record_stream(self._stream)
        for (handle, _, _), out in zip(entries, outs):
            handle.result = out
            handle.finished = finished
            handle.event.set()

    def _wait_ready(self, entries):
        """The core's stream waits until the enqueuing streams have
        written each entry's tensor."""
        if self._stream is None:
            return
        for handle, t, _ in entries:
            if handle.ready is not None:
                self._stream.wait_event(handle.ready)
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(self._stream)

    def _execute_one(self, resp: Response, handles: List[int]):
        entries = []
        with self._pending_mu:
            for h in handles:
                entries.append(self._pending.pop(h, None))
        live = [e for e in entries if e is not None]
        if resp.response_type == RESPONSE_ERROR:
            for handle, _, _ in live:
                handle.error = resp.error_message or "collective failed"
                handle.event.set()
            return
        if resp.response_type == REQUEST_JOIN:
            # the whole job joined: the result is the last rank to join
            for handle, _, _ in live:
                handle.result = resp.root_rank
                handle.event.set()
            return
        if (resp.response_type in (REQUEST_ALLREDUCE, REQUEST_ADASUM)
                and len(handles) == len(resp.tensor_names)
                and any(e is None for e in entries)):
            # this process join()ed: the tensors it never enqueued still
            # need its part in the collective, as zeros
            self._execute_backfilled(resp, entries)
            return
        if not live:
            return
        from horovod_tpu_torch.ops import collective as C

        try:
            self._wait_ready(live)
            arrays = [t for _, t, _ in live]
            op = live[0][2]["op"]
            pre, post = resp.prescale_factor, resp.postscale_factor
            if pre != 1.0:
                arrays = [a * pre for a in arrays]
            rtype = resp.response_type
            if rtype in (REQUEST_ALLREDUCE, REQUEST_ADASUM):
                outs = _reduce(arrays,
                               C.Adasum if rtype == REQUEST_ADASUM else op)
            elif rtype == REQUEST_ALLGATHER:
                outs = C.grouped_allgather(arrays)
            elif rtype == REQUEST_BROADCAST:
                outs = [C.broadcast(a, resp.root_rank) for a in arrays]
            elif rtype == REQUEST_ALLTOALL:
                outs = [C.alltoall(a) for a in arrays]
            elif rtype == REQUEST_REDUCESCATTER:
                outs = [C.reducescatter(a, op) for a in arrays]
            else:  # BARRIER
                outs = arrays
            if post != 1.0:
                outs = [o * post for o in outs]
            self.plan_counts[rtype] = self.plan_counts.get(rtype, 0) + 1
            self._finish(live, outs)
        except Exception as e:
            for handle, _, _ in live:
                if not handle.event.is_set():
                    handle.error = str(e)
                    handle.event.set()

    def _execute_backfilled(self, resp: Response, entries: List):
        """Run a reduction this joined process enqueued only in part (or
        not at all), with zeros for the missing tensors; everything is
        flattened so shapes agree whatever the live ranks enqueued."""
        from horovod_tpu_torch.ops import collective as C

        live = [e for e in entries if e is not None]
        try:
            self._wait_ready(live)
            dtags = resp.tensor_dtypes or [resp.tensor_type] * len(
                resp.tensor_sizes)
            op = (live[0][2]["op"] if live and live[0][2]["op"] is not None
                  else C.ReduceOp(resp.reduce_op))
            if resp.response_type == REQUEST_ADASUM:
                op = C.Adasum
            arrays = []
            for e, n, dtag in zip(entries, resp.tensor_sizes, dtags):
                if e is None:
                    arrays.append(torch.zeros(int(n), dtype=_tag_dtype(dtag),
                                              device=self._device))
                else:
                    arrays.append(e[1].reshape(-1))
            if resp.prescale_factor != 1.0:
                arrays = [a * resp.prescale_factor for a in arrays]
            outs = _reduce(arrays, op)
            if resp.postscale_factor != 1.0:
                outs = [o * resp.postscale_factor for o in outs]
            mine = [(e, o.view(e[1].shape)) for e, o in zip(entries, outs)
                    if e is not None]
            self.plan_counts[resp.response_type] = self.plan_counts.get(
                resp.response_type, 0) + 1
            self._finish([e for e, _ in mine], [o for _, o in mine])
        except Exception as e:
            for handle, _, _ in live:
                if not handle.event.is_set():
                    handle.error = str(e)
                    handle.event.set()

    # --------------------------------------------------------------- enqueue

    def auto_name(self, request_type: int) -> str:
        """The next generated name of an op queued without one,
        ``<op>.noname.<k>``, ``k`` counted from 0 for this core: every
        rank issues its unnamed ops in the same order, so their names
        agree."""
        return f"{_KIND[request_type]}.noname.{next(self._noname)}"

    def enqueue(self, name: str, tensor, request_type: int, *, op=None,
                root_rank: int = -1, prescale: float = 1.0,
                postscale: float = 1.0) -> CoreHandle:
        """Queue ``tensor`` under ``name`` for negotiation; a duplicate
        outstanding name raises ``ValueError``."""
        ready = None
        if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(tensor.device))
        handle = CoreHandle(name, ready)
        with self._pending_mu:
            hid = self._next_handle
            self._next_handle += 1
            self._pending[hid] = (handle, tensor, {"op": op})
        shape = tuple(tensor.shape)
        dims = (ctypes.c_int64 * len(shape))(*shape)
        rc = self._lib.hvd_core_enqueue(
            name.encode(), request_type, _dtype_tag(tensor.dtype), dims,
            len(shape), root_rank, int(op) if op is not None else 0,
            prescale, postscale, hid, b"")
        if rc != 0:
            with self._pending_mu:
                self._pending.pop(hid, None)
            if rc == 1:
                raise ValueError(
                    f"Duplicate tensor name '{name}' in outstanding collective "
                    "(reference DUPLICATE_NAME_ERROR).")
            raise RuntimeError(f"enqueue failed for '{name}' (rc={rc})")
        return handle

    def pending_count(self) -> int:
        """Ops queued to the core and not run yet (the preemption loop's
        drain waits for 0)."""
        with self._pending_mu:
            return len(self._pending)

    # ----------------------------------------------------------------- knobs

    @property
    def cycle_time_ms(self) -> float:
        return self._lib.hvd_core_cycle_time_ms()

    @cycle_time_ms.setter
    def cycle_time_ms(self, ms: float):
        self._lib.hvd_core_set_cycle_time_ms(ms)

    @property
    def fusion_threshold(self) -> int:
        return self._lib.hvd_core_fusion_threshold()

    @fusion_threshold.setter
    def fusion_threshold(self, b: int):
        self._lib.hvd_core_set_fusion_threshold(b)

    def cache_hit_count(self) -> int:
        """Globally agreed response-cache hits this process proposed."""
        return self._lib.hvd_core_cache_hit_count()

    def hier_allreduce(self) -> int:
        """The hierarchical-allreduce strategy the job applied this cycle
        (-1 never tuned, 0 flat, 1 hierarchical)."""
        return self._lib.hvd_core_hier_allreduce()

    def hier_allgather(self) -> int:
        return self._lib.hvd_core_hier_allgather()

    def set_autotuned_params(self, *, cycle_ms: float = 0.0,
                             fusion_bytes: int = -1, cache_enabled: int = -1,
                             hier_allreduce: int = -1,
                             hier_allgather: int = -1):
        """The coordinator's manual retune: the values ride the next
        cycle's broadcast and every rank applies them at the same cycle
        boundary (what the autotuner does). No-op on the other ranks."""
        self._lib.hvd_core_set_autotuned_params(
            cycle_ms, fusion_bytes, cache_enabled, hier_allreduce,
            hier_allgather)

    def shutdown(self):
        """Stop the background thread; every entry it still held fails
        with the core's shutdown error. The core's process group is
        destroyed with the default one."""
        self._lib.hvd_core_shutdown()
        if self._hier_saved is not None:
            from horovod_tpu_torch.ops import hierarchical

            hierarchical.set_hierarchical(self._hier_saved[0])
            hierarchical.set_hierarchical_allgather(self._hier_saved[1])
            self._hier_saved = None
            self._hier_applied = (-1, -1)
        with self._pending_mu:
            items = list(self._pending.values())
            self._pending.clear()
        for handle, _, _ in items:
            if not handle.event.is_set():
                handle.error = "core shut down with queued tensors"
                handle.event.set()
