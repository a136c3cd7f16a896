"""Collective-schedule recording: the ordered collectives of one step.

Counterpart of ``horovod_tpu/analysis/schedule.py``. The JAX module walks
a step's jaxpr: every rank runs the same program, so the ordered
collective primitives in it are the schedule every rank issues. An eager
PyTorch step has no program to walk, so the port *records* the schedule:
:func:`collective_schedule` runs the step once while
:func:`~horovod_tpu_torch.testing.watching_calls` reports every
``torch.distributed`` collective it makes, and each call becomes one
:class:`CollectiveSig` under the JAX primitive it stands for
(:data:`PRIMITIVE_OF`): ``all_reduce`` is ``psum``, the all-gathers
``all_gather``, the reduce-scatters ``reduce_scatter`` (XLA's name for a
``psum_scatter``), the all-to-alls ``all_to_all``, point-to-point
exchanges ``ppermute`` and ``broadcast`` itself. Shapes are the
input's on this rank, dtypes numpy's names, axes ``("data",)`` for the
world's group and ``("group<k>",)`` for a sub-group of ``k`` ranks, so
:meth:`Schedule.fingerprint` hashes the same JSON as the JAX module.

Recording is a collective run of the step: every rank calls it. It sees
only the calls made through the ``torch.distributed`` module's
attributes at call time (the port's ops never bind them at import).
Static branch analysis (the JAX module's ``cond``/``while`` issues) has
no eager counterpart; the runtime sanitizer
(:mod:`~horovod_tpu_torch.analysis.sanitizer`) covers divergence across
ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Tuple

import torch.distributed as dist

__all__ = [
    "PRIMITIVE_OF",
    "CollectiveSig",
    "Schedule",
    "ScheduleDivergence",
    "collective_schedule",
    "recording",
    "assert_same_schedule",
    "diff_schedules",
]

#: ``torch.distributed`` call -> (JAX primitive, index of its input
#: argument; ``None`` = a list of per-rank inputs stacked on a new axis)
PRIMITIVE_OF = {
    "all_reduce": ("psum", 0),
    "all_gather": ("all_gather", 1),
    "all_gather_single": ("all_gather", 1),
    "all_gather_into_tensor": ("all_gather", 1),
    "reduce_scatter": ("reduce_scatter", None),
    "reduce_scatter_single": ("reduce_scatter", 1),
    "reduce_scatter_tensor": ("reduce_scatter", 1),
    "all_to_all_single": ("all_to_all", 1),
    "all_to_all": ("all_to_all", None),
    "broadcast": ("broadcast", 0),
    "batch_isend_irecv": ("ppermute", None),
}


class ScheduleDivergence(AssertionError):
    """Two schedules (or two cond branches) disagree on the collective
    sequence; carries the first divergent index and both signatures."""

    def __init__(self, message: str, index: Optional[int] = None,
                 left: Optional["CollectiveSig"] = None,
                 right: Optional["CollectiveSig"] = None):
        super().__init__(message)
        self.index = index
        self.left = left
        self.right = right


@dataclasses.dataclass(frozen=True)
class CollectiveSig:
    """One collective's canonical signature inside a schedule."""

    primitive: str
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str
    context: Tuple[str, ...] = ()

    def key(self) -> tuple:
        """Equality key for schedule comparison — context included: a
        collective that moved into/out of a scan body is a different
        schedule even if its signature matches."""
        return (self.primitive, self.axes, self.shape, self.dtype,
                self.context)

    def describe(self) -> str:
        ctx = "/".join(self.context) or "top"
        ax = ",".join(self.axes) or "?"
        shp = "x".join(str(d) for d in self.shape) or "scalar"
        return f"{self.primitive}[{ax}] {self.dtype}:{shp} @{ctx}"

    def to_json(self) -> list:
        return [self.primitive, list(self.axes), list(self.shape),
                self.dtype, list(self.context)]


@dataclasses.dataclass
class Schedule:
    """Ordered collective signature sequence of one traced program."""

    ops: List[CollectiveSig]
    issues: List[str] = dataclasses.field(default_factory=list)

    def fingerprint(self) -> str:
        """Canonical SHA-256 over the ordered signature sequence (issues
        excluded: two programs with the same schedule and different
        warnings are schedule-equivalent)."""
        blob = json.dumps(
            [op.to_json() for op in self.ops], separators=(",", ":")
        ).encode()
        return hashlib.sha256(blob).hexdigest()

    def signature(self) -> Tuple[tuple, ...]:
        return tuple(op.key() for op in self.ops)

    def __len__(self) -> int:
        return len(self.ops)

    def counts(self) -> dict:
        out: dict = {}
        for op in self.ops:
            out[op.primitive] = out.get(op.primitive, 0) + 1
        return out

    def describe(self) -> str:
        lines = [op.describe() for op in self.ops]
        lines.extend(f"warning: {i}" for i in self.issues)
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "fingerprint": self.fingerprint(),
            "ops": [op.to_json() for op in self.ops],
            "issues": list(self.issues),
        }


def _axes(group) -> Tuple[str, ...]:
    if group is None or dist.get_world_size(group) == dist.get_world_size():
        return ("data",)
    return (f"group{dist.get_world_size(group)}",)


def _sig(name: str, args, kw) -> CollectiveSig:
    prim, at = PRIMITIVE_OF[name]
    if name == "batch_isend_irecv":
        ops = args[0] if args else kw["p2p_op_list"]
        t = ops[0].tensor
        shape, dtype = tuple(t.shape), t.dtype
        group = getattr(ops[0], "group", None)
    else:
        if at is None:
            items = args[1] if len(args) > 1 else kw.get("input_list")
            shape = (len(items),) + tuple(items[0].shape)
            dtype = items[0].dtype
        else:
            t = args[at] if len(args) > at else next(
                v for k, v in kw.items() if k in ("tensor", "input",
                                                  "input_tensor"))
            shape, dtype = tuple(t.shape), t.dtype
        group = kw.get("group")
    return CollectiveSig(primitive=prim, axes=_axes(group),
                         shape=tuple(int(d) for d in shape),
                         dtype=str(dtype).replace("torch.", ""))


class recording:
    """``with recording() as sched:`` -- every ``torch.distributed``
    collective of :data:`PRIMITIVE_OF` called inside is appended to
    ``sched.ops``."""

    def __init__(self):
        self.schedule = Schedule(ops=[])
        self._cm = None

    def __enter__(self) -> "Schedule":
        from horovod_tpu_torch.testing import watching_calls

        def on_call(name, args, kw):
            self.schedule.ops.append(_sig(name, args, kw))

        self._cm = watching_calls(dist, tuple(PRIMITIVE_OF), on_call)
        self._cm.__enter__()
        return self.schedule

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def collective_schedule(fn, *args, **kwargs) -> Schedule:
    """Run ``fn(*args, **kwargs)`` once and return its collective
    schedule (the result is dropped: run it on state you can spend). A
    collective call: every rank runs it."""
    with recording() as sched:
        fn(*args, **kwargs)
    return sched


def diff_schedules(a: Schedule, b: Schedule) -> Optional[dict]:
    """First divergence between two schedules, or None when equivalent.

    Returns ``{"index", "left", "right", "reason"}`` where left/right are
    the differing :class:`CollectiveSig` (None past the shorter
    schedule's end)."""
    for i, (sa, sb) in enumerate(zip(a.ops, b.ops)):
        if sa.key() != sb.key():
            return {
                "index": i,
                "left": sa,
                "right": sb,
                "reason": f"op {i} differs: {sa.describe()} vs "
                          f"{sb.describe()}",
            }
    if len(a.ops) != len(b.ops):
        longer, which = (a, "left") if len(a.ops) > len(b.ops) else (b,
                                                                     "right")
        i = min(len(a.ops), len(b.ops))
        extra = longer.ops[i]
        return {
            "index": i,
            "left": extra if which == "left" else None,
            "right": extra if which == "right" else None,
            "reason": f"{which} schedule has {abs(len(a) - len(b))} extra "
                      f"collective(s) from op {i} ({extra.describe()})",
        }
    return None


def assert_same_schedule(a, b, *args, **kwargs) -> None:
    """Assert two step fns (or two recorded :class:`Schedule`\\ s) issue
    the identical collective sequence; raises :class:`ScheduleDivergence`
    naming the first divergent op otherwise.

    Call as ``assert_same_schedule(sched_a, sched_b)`` or
    ``assert_same_schedule(fn_a, fn_b, *args)`` (each fn run once on the
    same arguments: a collective call, every rank calls it)."""
    if not isinstance(a, Schedule):
        a = collective_schedule(a, *args, **kwargs)
    if not isinstance(b, Schedule):
        b = collective_schedule(b, *args, **kwargs)
    d = diff_schedules(a, b)
    if d is not None:
        raise ScheduleDivergence(
            f"collective schedules diverge: {d['reason']}",
            index=d["index"], left=d["left"], right=d["right"],
        )
