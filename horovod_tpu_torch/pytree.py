"""Trees of state in JAX's flatten order, and JAX's pickled treedef.

A checkpoint of the JAX package stores its structure as a pickled
``jax.tree_util`` treedef. This module reads and writes that pickle
without JAX: :class:`PyTreeDef` stands in for ``jaxlib``'s class, whose
pickle is ``NEWOBJ`` of ``jaxlib._jax.pytree.PyTreeDef``, then ``BUILD``
with ``(jax._src.tree_util.default_registry, nodes)``. ``nodes`` lists
the tree's nodes in post-order, each ``(kind, arity, node_data, custom,
num_leaves, num_nodes)``:

====  ==========  ==========================================
kind  node        node_data
====  ==========  ==========================================
0     leaf        None
1     ``None``    None (a node with no leaf)
2     tuple       None
3     namedtuple  the class
4     list        None
5     dict        its keys, sorted
====  ==========  ==========================================

Kind 6 (a custom node registered with JAX) has no meaning without JAX's
registry and raises. Namedtuple classes of the JAX package's optimizer
states (optax's ``ScaleByAdamState``, ``EmptyState``, ...,
``horovod_tpu.optim._EFState``) are read as tuple subclasses that keep
the dotted name and the field names (``.mu``, ``.count`` work), and are
written back under that name.
"""

from __future__ import annotations

import collections
import copyreg
import pickle
from typing import Any

LEAF, NONE, TUPLE, NAMEDTUPLE, LIST, DICT = range(6)

#: the namedtuples of the JAX package's optimizer states, by class name
#: (optax moves them between its private modules; the module read is
#: kept and written back)
_NAMEDTUPLE_FIELDS = {
    ("optax", "ScaleByAdamState"): ("count", "mu", "nu"),
    ("optax", "EmptyState"): (),
    ("optax", "ScaleByScheduleState"): ("count",),
    ("optax", "TraceState"): ("trace",),
    ("optax", "ScaleByRmsState"): ("nu",),
    ("optax", "ScaleState"): (),
    ("optax", "AddDecayedWeightsState"): (),
    ("optax", "MultiStepsState"): ("mini_step", "gradient_step",
                                   "inner_opt_state", "acc_grads",
                                   "skip_state"),
    ("horovod_tpu", "_EFState"): ("inner", "residual"),
    ("horovod_tpu", "_PowerSGDState"): ("inner", "residual", "q"),
    ("horovod_tpu", "NumericsGuardState"): (
        "inner", "ewma", "count", "bad_count", "bad_streak", "last_bad",
        "last_finite", "last_norm", "norms", "loss_scale", "good_streak",
        "chaos_fired", "rank_norms"),
}
#: packages whose classes are not read any other way: importing them
#: would import JAX (or a package the port does not have)
_FOREIGN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu", "ml_dtypes")
_stand_ins: dict = {}


class _Registry:
    """Stands in for ``jax._src.tree_util.default_registry``."""

    _jax_global = ("jax._src.tree_util", "default_registry")

    def __reduce__(self):
        return "default_registry"


REGISTRY = _Registry()


class PyTreeDef:
    """A tree's structure: JAX's node list (see the module docstring).
    Pickles as ``jaxlib._jax.pytree.PyTreeDef`` and unpickles from it."""

    _jax_global = ("jaxlib._jax.pytree", "PyTreeDef")

    def __init__(self, nodes=()):
        self.nodes = [tuple(n) for n in nodes]

    def __setstate__(self, state):
        _registry, nodes = state
        self.nodes = [tuple(n) for n in nodes]

    def __reduce_ex__(self, protocol):
        return copyreg.__newobj__, (PyTreeDef,), (REGISTRY, list(self.nodes))

    @property
    def num_leaves(self) -> int:
        return self.nodes[-1][4] if self.nodes else 0

    def __eq__(self, other):
        return isinstance(other, PyTreeDef) and self.nodes == other.nodes

    def __repr__(self):
        return f"PyTreeDef({len(self.nodes)} nodes, {self.num_leaves} leaves)"


def _stand_in(module: str, name: str, fields) -> type:
    """A namedtuple class that pickles as ``module.name``."""
    key = (module, name)
    if key not in _stand_ins:
        cls = collections.namedtuple(name, fields)
        _stand_ins[key] = type(name, (cls,), {"__slots__": (),
                                              "_jax_global": key})
    return _stand_ins[key]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree) -> tuple:
    """``(leaves, PyTreeDef)`` in ``jax.tree_util.tree_flatten``'s order:
    a dict's keys sorted, lists and tuples in order, ``None`` a node with
    no leaf. Exact dicts, lists, tuples and namedtuples are nodes; every
    other object is a leaf, except dict subclasses, which JAX flattens
    through its registry and which raise."""
    leaves, nodes = [], []

    def visit(x):
        t = type(x)
        if x is None:
            nodes.append((NONE, 0, None, None, 0, 1))
            return
        if t is dict:
            keys = sorted(x)
            kids, data, kind = [x[k] for k in keys], keys, DICT
        elif t is list:
            kids, data, kind = x, None, LIST
        elif t is tuple:
            kids, data, kind = x, None, TUPLE
        elif _is_namedtuple(x):
            kids, data, kind = list(x), t, NAMEDTUPLE
        elif isinstance(x, dict):
            raise TypeError(f"{t.__module__}.{t.__qualname__}: a dict "
                            "subclass has no node of its own here")
        else:
            leaves.append(x)
            nodes.append((LEAF, 0, None, None, 1, 1))
            return
        n0, l0 = len(nodes), len(leaves)
        for k in kids:
            visit(k)
        nodes.append((kind, len(kids), data, None, len(leaves) - l0,
                      len(nodes) - n0 + 1))

    visit(tree)
    return leaves, PyTreeDef(nodes)


def unflatten(treedef: PyTreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{treedef!r} takes {treedef.num_leaves} leaves, "
                         f"got {len(leaves)}")
    it = iter(leaves)
    stack: list = []
    for kind, arity, data, _custom, _nl, _nn in treedef.nodes:
        kids = stack[len(stack) - arity:] if arity else []
        if arity:
            del stack[len(stack) - arity:]
        if kind == LEAF:
            stack.append(next(it))
        elif kind == NONE:
            stack.append(None)
        elif kind == TUPLE:
            stack.append(tuple(kids))
        elif kind == LIST:
            stack.append(list(kids))
        elif kind == DICT:
            stack.append(dict(zip(data, kids)))
        elif kind == NAMEDTUPLE:
            stack.append(data(*kids))
        else:
            raise ValueError(
                f"treedef node of kind {kind} (a custom pytree node "
                f"registered with JAX: {data!r}) has no meaning without JAX")
    if len(stack) != 1:
        raise ValueError(f"malformed treedef: {len(stack)} roots")
    return stack[0]


class Unpickler(pickle.Unpickler):
    """Reads a pickle that names JAX's treedef, its registry and the
    optimizer states' namedtuples, without importing them. Any other
    class of JAX, flax, optax, ``ml_dtypes`` or the JAX package raises
    and names the class."""

    def find_class(self, module, name):
        if name == "PyTreeDef" and module.endswith("pytree"):
            return PyTreeDef
        if (module, name) == REGISTRY._jax_global:
            return REGISTRY
        root = module.split(".")[0]
        fields = _NAMEDTUPLE_FIELDS.get((root, name))
        if fields is not None:
            return _stand_in(module, name, fields)
        if root in _FOREIGN:
            raise pickle.UnpicklingError(
                f"checkpoint names class {module}.{name}, which cannot be "
                "read without JAX")
        return super().find_class(module, name)


class Pickler(pickle._Pickler):  # the Python pickler: save_global is ours
    """Writes :class:`PyTreeDef`, its registry and the stand-in
    namedtuples under JAX's names, so the JAX package unpickles them."""

    def save_global(self, obj, name=None):
        where = obj.__dict__.get("_jax_global") if isinstance(obj, type) \
            else getattr(obj, "_jax_global", None)
        if where is None:
            return super().save_global(obj, name)
        module, qualname = where
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


def dump(obj, file) -> None:
    Pickler(file, pickle.DEFAULT_PROTOCOL).dump(obj)


def load(file) -> Any:
    return Unpickler(file).load()
