"""AST rule engine: static checks for collective-schedule and threading
discipline (``HVD0xx`` rules).

The coordinator layer Horovod carries (negotiate readiness, stall-check,
response cache — PAPER.md L4) is a *runtime* defense against ranks issuing
different collective schedules. These rules are the *static* half: they run
over plain Python source (no imports of the linted code, no JAX) and flag
the patterns that produce divergent schedules, host-sync stalls, thread
races, and swallowed failures before a job ever reaches a GPU.

Rule catalog:

- **HVD001** — collective call under rank-dependent control flow
  (``if hvd.rank() == 0: allreduce(...)``) or after a rank-dependent early
  return: some ranks dispatch, others don't → deadlock.
- **HVD002** — collective inside a data-dependent Python loop (``while``
  on a non-constant predicate, or ``for`` over a host-synced bound): trip
  counts can differ across ranks, desynchronizing the schedule.
- **HVD003** — host sync on a traced value inside a compiled/traced fn
  (``.item()``, ``float()``/``int()``/``bool()``, ``np.asarray``): a
  graph break and a device round-trip per call under ``torch.compile``, a
  constant baked in (or an error) under ``torch.jit.trace``/``script``.
- **HVD004** — wall-clock / host RNG inside a traced fn (``time.time()``,
  ``random.*``, ``np.random.*``): bakes a trace-time constant into the
  compiled program, different per rank/compile.

Counterpart of ``horovod_tpu/analysis/lint.py``. HVD001, HVD002, HVD005
and HVD006 are the reference's rules unchanged (the collective names add
``torch.distributed``'s). HVD003 and HVD004 are about tracing: in the
JAX package their scope is the bodies that ``jax.jit``/``shard_map``/
``lax.scan`` and the like trace; here it is the bodies that
``torch.compile``, ``torch.jit.script``/``trace`` and ``torch.export``
trace (:data:`TRACING_FNS`), as a decorator or called on a function
name.
- **HVD005** — write to module-level mutable state from a function
  reachable from a ``threading.Thread``/``Timer`` target without a held
  lock (lock inference: ``with <lock>`` ancestors, ``*_locked`` helper
  convention).
- **HVD006** — bare ``except:`` or a swallowed handler (body is only
  ``pass``): hides real failures, deadliest in retry/KV paths.

Waivers — intentional cases are *declared*, not silenced:

- inline, on the finding line or the line above::

      risky_call()  # hvdlint: waive=HVD006 server teardown is best-effort

- a central file (:func:`load_waivers`), one per line::

      HVD005 horovod_tpu_torch/observability/straggler.py  caches are benign races

  (``<rule> <path-glob>[:<line>] <reason>``; the reason is mandatory —
  a waiver without a why rots.)

stdlib-only by design: run it as ``python -m horovod_tpu_torch.analysis.lint
<paths>`` (or :func:`lint_paths`); it imports nothing it lints.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import os
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "Waiver",
    "RULES",
    "lint_source",
    "lint_file",
    "lint_paths",
    "load_waivers",
]

#: rule id -> (summary, fix hint)
RULES: Dict[str, Tuple[str, str]] = {
    "HVD001": (
        "collective call under rank-dependent control flow",
        "every rank must issue the same collective sequence; hoist the "
        "collective out of the rank guard (broadcast the result instead of "
        "gating the call)",
    ),
    "HVD002": (
        "collective inside a data-dependent Python loop",
        "make the trip count static, or synchronize the predicate first "
        "(allreduce the stop condition so every rank loops the same "
        "number of times)",
    ),
    "HVD003": (
        "host sync on a traced value inside a jitted function",
        "keep the value on device (jnp ops) or move the read outside jit; "
        ".item()/float()/np.asarray on a tracer blocks or fails the trace",
    ),
    "HVD004": (
        "wall-clock or host RNG inside a traced function",
        "pass timestamps/keys in as arguments (jax.random with an explicit "
        "key); host time/RNG is baked in at trace time, differently per "
        "rank and per compile",
    ),
    "HVD005": (
        "module-level mutable state written from a thread-reachable "
        "function without a held lock",
        "guard the write with the module lock (`with _lock:`) or move it "
        "into a `*_locked` helper called under one",
    ),
    "HVD006": (
        "bare or swallowed except",
        "catch the narrow exception and at least log it "
        "(logging.debug(...)); a silent `except: pass` in a retry/KV path "
        "turns real failures into hangs",
    ),
}

#: Horovod-level + lax-level collective call names (HVD001/HVD002 targets)
COLLECTIVE_FNS: Set[str] = {
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async",
    "allgather", "grouped_allgather", "allgather_async", "allgather_object",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "broadcast_object", "broadcast_parameters", "broadcast_variables",
    "broadcast_optimizer_state",
    "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "quantized_reducescatter",
    "quantized_psum_scatter",
    "hier_allreduce", "hier_allgather",
    "hierarchical_allreduce", "hierarchical_allgather",
    "adasum_allreduce", "grouped_adasum_allreduce",
    "psum", "pmean", "pmax", "pmin", "ppermute", "pbroadcast",
    "all_gather", "all_to_all", "psum_scatter",
    "barrier", "join",
    # torch.distributed's
    "all_reduce", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv",
    "all_gather_object", "broadcast_object_list",
}

#: calls whose result is a rank identity (HVD001 predicate markers)
RANK_FNS: Set[str] = {
    "rank", "local_rank", "cross_rank", "process_rank", "process_index",
    "axis_index", "_flat_axis_index", "flat_axis_index",
}

#: transforms that trace their function argument (HVD003/HVD004 scope):
#: ``torch.compile``, ``torch.jit.script``/``trace``/``trace_module`` and
#: ``torch.export.export``
TRACING_FNS: Set[str] = {
    "compile", "script", "trace", "trace_module", "export",
}

#: host-sync markers inside traced fns (HVD003)
HOST_SYNC_NP_FNS = {"asarray", "array", "copy"}

#: mutating method names on module-level containers (HVD005)
MUTATOR_METHODS: Set[str] = {
    "append", "appendleft", "add", "update", "pop", "popitem", "clear",
    "extend", "extendleft", "remove", "discard", "insert", "setdefault",
}

#: with-context name fragments treated as a held lock (HVD005 inference)
LOCK_NAME_FRAGMENTS = ("lock", "_cv", "cond", "mutex")


@dataclasses.dataclass
class Finding:
    """One rule violation: id, location, message, and a fix hint."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.message} (fix: {self.hint})"
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Waiver:
    """One central-file waiver: rule + path glob (+ optional line) + why."""

    rule: str
    path_glob: str
    line: Optional[int]
    reason: str

    def matches(self, finding: Finding) -> bool:
        if self.rule != finding.rule and self.rule != "*":
            return False
        norm = finding.path.replace(os.sep, "/")
        if not (
            fnmatch.fnmatch(norm, self.path_glob)
            or fnmatch.fnmatch(norm, "*/" + self.path_glob)
            or norm.endswith("/" + self.path_glob)
            or norm == self.path_glob
        ):
            return False
        return self.line is None or self.line == finding.line


def load_waivers(path: str) -> List[Waiver]:
    """Parse the central waivers file; blank lines and ``#`` comments are
    skipped. A waiver line without a reason raises — waivers document
    intent, and intent needs words."""
    waivers: List[Waiver] = []
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 2)
            if len(parts) < 3:
                raise ValueError(
                    f"{path}:{lineno}: waiver needs '<rule> <path>[:line] "
                    f"<reason>', got {line!r} (the reason is mandatory)"
                )
            rule, target, reason = parts
            if rule != "*" and rule not in RULES:
                raise ValueError(
                    f"{path}:{lineno}: unknown rule {rule!r} "
                    f"(known: {', '.join(sorted(RULES))})"
                )
            line_no: Optional[int] = None
            if ":" in target:
                target, _, tail = target.rpartition(":")
                line_no = int(tail)
            waivers.append(Waiver(rule, target, line_no, reason))
    return waivers


# --------------------------------------------------------------------------
# inline waivers


def _inline_waivers(source: str) -> Dict[int, Set[str]]:
    """line -> set of waived rule ids, from ``# hvdlint: waive=HVD00x[,..]``
    comments (``disable=`` accepted as an alias). A waiver on line L covers
    findings on L-1, L and L+1: a comment above the construct, trailing on
    the finding line, or on a handler's body line all work."""
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            text = tok.string
            marker = "hvdlint:"
            idx = text.find(marker)
            if idx < 0:
                continue
            spec = text[idx + len(marker):].strip()
            for prefix in ("waive=", "disable="):
                if spec.startswith(prefix):
                    spec = spec[len(prefix):]
                    break
            else:
                continue
            rules = {
                r.strip() for r in spec.split()[0].split(",") if r.strip()
            }
            line = tok.start[0]
            for covered in (line - 1, line, line + 1):
                out.setdefault(covered, set()).update(rules)
    except tokenize.TokenError:
        pass
    return out


# --------------------------------------------------------------------------
# AST helpers


def _call_name(node: ast.AST) -> Optional[str]:
    """Bare name of a call target: ``allreduce(...)`` and
    ``hvd.allreduce(...)`` both -> ``"allreduce"``."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _attr_root(node: ast.AST) -> Optional[str]:
    """Leftmost name of an attribute chain (``np.random.rand`` -> ``np``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _contains_rank_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _call_name(sub) in RANK_FNS:
            return True
        # `rank == 0` where rank was bound from a rank call is invisible
        # statically; the literal env spellings are not:
        if isinstance(sub, ast.Attribute) and sub.attr in (
            "process_index", "process_rank",
        ):
            return True
    return False


def _collective_calls(node: ast.AST) -> List[ast.Call]:
    return [
        sub
        for sub in ast.walk(node)
        if isinstance(sub, ast.Call) and _call_name(sub) in COLLECTIVE_FNS
    ]


def _is_host_synced_bound(node: ast.AST) -> bool:
    """Does this expression derive from a host sync (``.item()``,
    ``float(...)``, ``np.asarray``)? Marks a loop bound as data-dependent."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Attribute) and fn.attr == "item":
                return True
            name = _call_name(sub)
            if name in ("float", "int") and sub.args and not isinstance(
                sub.args[0], ast.Constant
            ):
                return True
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in HOST_SYNC_NP_FNS
                and _attr_root(fn) in ("np", "numpy", "onp", "jnp")
            ):
                return True
    return False


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    """Does this block unconditionally leave the enclosing function/loop?"""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _is_lockish(expr: ast.AST, module_locks: Set[str]) -> bool:
    """Is a with-context expression a lock? Either a module-level
    ``threading.Lock()`` name, or any name/attr whose last segment smells
    like a lock (``self._lock``, ``_attr_lock``, ``cv``)."""
    target = expr
    if isinstance(target, ast.Call):  # lock.acquire_timeout() style
        target = target.func
    name = None
    if isinstance(target, ast.Attribute):
        name = target.attr
    elif isinstance(target, ast.Name):
        name = target.id
    if name is None:
        return False
    if name in module_locks:
        return True
    low = name.lower()
    return any(frag in low for frag in LOCK_NAME_FRAGMENTS)


# --------------------------------------------------------------------------
# module context (pass 1)


class _ModuleContext:
    """Everything the rules need to know about the module as a whole."""

    def __init__(self, tree: ast.Module):
        self.module_globals: Set[str] = set()
        self.module_locks: Set[str] = set()
        self.thread_targets: Set[str] = set()
        self.traced_fns: Set[str] = set()
        self.func_defs: Dict[str, List[ast.FunctionDef]] = {}
        self.call_graph: Dict[str, Set[str]] = {}
        self._collect(tree)

    def _collect(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            for target in self._assign_names(stmt):
                self.module_globals.add(target)
                value = getattr(stmt, "value", None)
                if isinstance(value, ast.Call) and _call_name(value) in (
                    "Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore",
                ):
                    self.module_locks.add(target)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.func_defs.setdefault(node.name, []).append(node)
                self.call_graph[node.name] = {
                    _call_name(sub)
                    for sub in ast.walk(node)
                    if isinstance(sub, ast.Call) and _call_name(sub)
                }
                for deco in node.decorator_list:
                    d = deco
                    if isinstance(d, ast.Call):
                        d = d.func
                    name = (
                        d.id if isinstance(d, ast.Name)
                        else d.attr if isinstance(d, ast.Attribute) else None
                    )
                    if name in TRACING_FNS:
                        self.traced_fns.add(node.name)
            if isinstance(node, ast.Call):
                callee = _call_name(node)
                if callee in ("Thread", "Timer"):
                    self._note_thread_target(node, callee)
                if callee in TRACING_FNS:
                    for arg in node.args:
                        if isinstance(arg, ast.Name):
                            self.traced_fns.add(arg.id)
                    for kw in node.keywords:
                        if kw.arg in ("fun", "f", "fn", "body_fun",
                                      "cond_fun") and isinstance(
                                          kw.value, ast.Name):
                            self.traced_fns.add(kw.value.id)

    @staticmethod
    def _assign_names(stmt: ast.stmt) -> List[str]:
        names: List[str] = []
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                names.extend(
                    e.id for e in t.elts if isinstance(e, ast.Name)
                )
        return names

    def _note_thread_target(self, node: ast.Call, callee: str) -> None:
        target: Optional[ast.AST] = None
        for kw in node.keywords:
            if kw.arg in ("target", "function"):
                target = kw.value
        if target is None and callee == "Timer" and len(node.args) >= 2:
            target = node.args[1]
        if target is None and callee == "Thread" and node.args:
            target = node.args[0]
        if isinstance(target, ast.Name):
            self.thread_targets.add(target.id)
        elif isinstance(target, ast.Attribute):
            self.thread_targets.add(target.attr)
        elif isinstance(target, ast.Lambda):
            for sub in ast.walk(target.body):
                if isinstance(sub, ast.Call) and _call_name(sub):
                    self.thread_targets.add(_call_name(sub))

    def thread_reachable(self) -> Set[str]:
        """Function names reachable (same-module call graph) from any
        thread/timer entry point."""
        seen: Set[str] = set()
        frontier = [t for t in self.thread_targets if t in self.func_defs]
        while frontier:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            for callee in self.call_graph.get(name, ()):
                if callee in self.func_defs and callee not in seen:
                    frontier.append(callee)
        return seen


# --------------------------------------------------------------------------
# rule passes (pass 2)


class _Linter:
    def __init__(self, tree: ast.Module, path: str, source: str):
        self.tree = tree
        self.path = path
        self.ctx = _ModuleContext(tree)
        self.findings: List[Finding] = []
        self._inline = _inline_waivers(source)

    def run(self) -> List[Finding]:
        self._rule_rank_divergence()
        self._rule_data_dependent_loops()
        self._rule_traced_host_syncs()
        self._rule_thread_state()
        self._rule_swallowed_except()
        self.findings = [
            f for f in self.findings
            if f.rule not in self._inline.get(f.line, ())
        ]
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    def _emit(self, rule: str, node: ast.AST, detail: str = "") -> None:
        summary, hint = RULES[rule]
        message = f"{summary}{': ' + detail if detail else ''}"
        self.findings.append(
            Finding(
                rule=rule,
                path=self.path,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                message=message,
                hint=hint,
            )
        )

    # ------------------------------------------------------------- HVD001

    def _rule_rank_divergence(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.If, ast.IfExp)):
                if not _contains_rank_call(node.test):
                    continue
                branches = (
                    [node.body, node.orelse]
                    if isinstance(node, ast.If)
                    else [[ast.Expr(node.body)], [ast.Expr(node.orelse)]]
                )
                for branch in branches:
                    for stmt in branch:
                        for call in _collective_calls(stmt):
                            self._emit(
                                "HVD001", call,
                                f"'{_call_name(call)}' guarded by a "
                                f"rank test at line {node.test.lineno}",
                            )
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._rank_divergent_flow(node)

    def _rank_divergent_flow(self, fn: ast.AST) -> None:
        """``if rank() != 0: return`` followed by a collective later in
        the same function: the early-returning ranks never dispatch it."""
        divergent_at: Optional[int] = None
        for stmt in fn.body:
            if divergent_at is not None:
                for call in _collective_calls(stmt):
                    if self._in_nested_def(stmt, call):
                        continue  # a nested def has its own flow
                    self._emit(
                        "HVD001", call,
                        f"'{_call_name(call)}' is only reached by ranks "
                        f"that passed the rank-dependent early exit at "
                        f"line {divergent_at}",
                    )
            if (
                isinstance(stmt, ast.If)
                and _contains_rank_call(stmt.test)
                and _terminates(stmt.body)
                and not stmt.orelse
            ):
                divergent_at = stmt.lineno

    @staticmethod
    def _in_nested_def(stmt: ast.stmt, call: ast.Call) -> bool:
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                if any(c is call for c in ast.walk(sub)):
                    return True
        return False

    # ------------------------------------------------------------- HVD002

    def _rule_data_dependent_loops(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.While):
                test = node.test
                if isinstance(test, ast.Constant):
                    continue  # `while True:` — static
                if not (_is_host_synced_bound(test)
                        or _contains_rank_call(test)
                        or isinstance(test, ast.Compare)):
                    continue
                for call in _collective_calls(node):
                    self._emit(
                        "HVD002", call,
                        f"'{_call_name(call)}' inside `while` with a "
                        f"non-static predicate at line {node.lineno}",
                    )
            elif isinstance(node, ast.For):
                if _is_host_synced_bound(node.iter):
                    for call in _collective_calls(node):
                        self._emit(
                            "HVD002", call,
                            f"'{_call_name(call)}' inside `for` whose "
                            f"bound is host-synced at line {node.lineno}",
                        )

    # ------------------------------------------------------- HVD003 / 004

    def _rule_traced_host_syncs(self) -> None:
        for name in sorted(self.ctx.traced_fns):
            for fn in self.ctx.func_defs.get(name, ()):
                self._scan_traced(fn)

    def _scan_traced(self, fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # HVD003: host syncs
            if isinstance(f, ast.Attribute) and f.attr == "item":
                self._emit("HVD003", node, ".item() on a traced value")
            elif (
                isinstance(f, ast.Attribute)
                and f.attr in HOST_SYNC_NP_FNS
                and _attr_root(f) in ("np", "numpy", "onp")
            ):
                self._emit(
                    "HVD003", node,
                    f"np.{f.attr}() materializes the traced value on host",
                )
            elif (
                isinstance(f, ast.Name)
                and f.id in ("float", "int", "bool")
                and node.args
                and not isinstance(node.args[0], ast.Constant)
            ):
                self._emit(
                    "HVD003", node, f"{f.id}() forces a host readback"
                )
            # HVD004: wall clock / host RNG
            root = _attr_root(f) if isinstance(f, ast.Attribute) else None
            if root == "time" and isinstance(f, ast.Attribute) and f.attr in (
                "time", "monotonic", "perf_counter", "process_time",
                "time_ns", "monotonic_ns",
            ):
                self._emit("HVD004", node, f"time.{f.attr}() at trace time")
            elif root == "random" and isinstance(f, ast.Attribute):
                self._emit(
                    "HVD004", node, f"random.{f.attr}() at trace time"
                )
            elif (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Attribute)
                and f.value.attr == "random"
                and _attr_root(f) in ("np", "numpy", "onp")
            ):
                self._emit(
                    "HVD004", node, f"np.random.{f.attr}() at trace time"
                )

    # ------------------------------------------------------------- HVD005

    def _rule_thread_state(self) -> None:
        reachable = self.ctx.thread_reachable()
        for name in sorted(reachable):
            for fn in self.ctx.func_defs.get(name, ()):
                if fn.name.endswith("_locked"):
                    continue  # convention: caller holds the lock
                self._scan_thread_fn(fn)

    def _scan_thread_fn(self, fn: ast.AST) -> None:
        declared_global: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                declared_global.update(node.names)

        def visit(node: ast.AST, lock_held: bool) -> None:
            if isinstance(node, ast.With):
                held = lock_held or any(
                    _is_lockish(item.context_expr, self.ctx.module_locks)
                    for item in node.items
                )
                for child in node.body:
                    visit(child, held)
                return
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return  # nested defs: separate reachability question
            if not lock_held:
                self._check_unlocked_write(node, declared_global)
            for child in ast.iter_child_nodes(node):
                visit(child, lock_held)

        for stmt in fn.body:
            visit(stmt, False)

    def _check_unlocked_write(
        self, node: ast.AST, declared_global: Set[str]
    ) -> None:
        mg = self.ctx.module_globals
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Name) and t.id in declared_global \
                        and t.id in mg:
                    self._emit(
                        "HVD005", node,
                        f"unguarded write to module global '{t.id}'",
                    )
                elif isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name
                ) and t.value.id in mg:
                    self._emit(
                        "HVD005", node,
                        f"unguarded item-write to module global "
                        f"'{t.value.id}'",
                    )
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in MUTATOR_METHODS
                and isinstance(f.value, ast.Name)
                and f.value.id in mg
            ):
                self._emit(
                    "HVD005", node,
                    f"unguarded '{f.value.id}.{f.attr}()' on module "
                    f"global",
                )

    # ------------------------------------------------------------- HVD006

    def _rule_swallowed_except(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                self._emit(
                    "HVD006", node,
                    "bare `except:` catches SystemExit/KeyboardInterrupt "
                    "too",
                )
            elif (
                len(node.body) == 1
                and isinstance(node.body[0], ast.Pass)
                and self._catches_broadly(node.type)
            ):
                exc = (
                    ast.unparse(node.type)
                    if hasattr(ast, "unparse") else "Exception"
                )
                self._emit(
                    "HVD006", node,
                    f"`except {exc}: pass` swallows every failure "
                    f"silently",
                )

    @staticmethod
    def _catches_broadly(exc_type: ast.AST) -> bool:
        """Only broad swallows are findings: `except OSError: pass` is an
        explicit, narrow decision; `except Exception: pass` hides
        everything including the bugs this package exists to catch."""
        types = (
            exc_type.elts if isinstance(exc_type, ast.Tuple) else [exc_type]
        )
        for t in types:
            name = (
                t.id if isinstance(t, ast.Name)
                else t.attr if isinstance(t, ast.Attribute) else None
            )
            if name in ("Exception", "BaseException"):
                return True
        return False


# --------------------------------------------------------------------------
# public entry points


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string; inline waivers applied, central waivers
    not (the caller owns those)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Finding(
                rule="HVD000",
                path=path,
                line=e.lineno or 0,
                col=e.offset or 0,
                message=f"syntax error: {e.msg}",
                hint="fix the syntax error; nothing else was checked",
            )
        ]
    return _Linter(tree, path, source).run()


def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def _iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [
                d for d in dirs
                if d not in ("__pycache__", ".git", ".pytest_cache")
            ]
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_paths(
    paths: Iterable[str],
    waivers: Optional[Sequence[Waiver]] = None,
) -> List[Finding]:
    """Lint every ``*.py`` under `paths`; central + inline waivers
    applied. Returns the surviving findings, sorted."""
    waivers = list(waivers or ())
    findings: List[Finding] = []
    for path in _iter_py_files(paths):
        for f in lint_file(path):
            if not any(w.matches(f) for w in waivers):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m horovod_tpu_torch.analysis.lint [--waivers FILE]
    PATH...``: print each finding; exit 1 when there is one."""
    import argparse

    ap = argparse.ArgumentParser(prog="hvdlint")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--waivers", default=None)
    args = ap.parse_args(argv)
    waivers = load_waivers(args.waivers) if args.waivers else None
    findings = lint_paths(args.paths, waivers)
    for f in findings:
        print(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
