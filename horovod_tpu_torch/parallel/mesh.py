"""Process meshes: the named-axis mesh and the host mesh.

Counterpart of ``horovod_tpu/parallel/mesh.py``. The JAX package names
the axes of a ``jax.sharding.Mesh`` and runs a strategy inside
``shard_map`` over them; the port, one process a GPU, makes each line of
ranks along an axis a ``torch.distributed`` sub-group:

- :func:`build_mesh` lays the world out row-major over named axes
  (``AXIS_ORDER``'s names first, then custom ones; at most one ``-1``
  fills) and records the process's :class:`Mesh`, whose ``group(name)``
  the per-axis primitives of :mod:`horovod_tpu_torch.parallel.spmd` and
  the collectives' ``axis=<name>`` run on. :class:`MeshConfig` is the
  declarative ``("data", "fsdp", "tp")`` spec;
- :func:`build_host_mesh` makes Horovod's LOCAL and CROSS communicators.

Horovod splits the job
along the host boundary into LOCAL (the ranks of one host) and CROSS
(the ranks of one local rank, one on each host) communicators (reference
``common/common.h:111-115``, ``gloo_context.cc:143-156``). The JAX
package names them as the axes of a ``(cross, local)`` device mesh; the
port, one process a GPU, makes them ``torch.distributed`` sub-groups:

- the world is ``cross x local`` ranks in the JAX mesh's row-major
  order, global rank = ``cross_index * L + local_index``;
- LOCAL is the ranks with this rank's cross index, CROSS the ranks with
  its local index.

:func:`build_host_mesh` makes every group of the split on every rank, in
one fixed order (``dist.new_group`` is collective, also for the groups a
rank is not in), and records the result as the process's host mesh,
which :func:`horovod_tpu_torch.ops.collective.allreduce` /
``allgather`` read when given ``axis=(CROSS_AXIS, LOCAL_AXIS)``.
:func:`horovod_tpu_torch.shutdown` forgets it with the process group.

Every rank makes every group of a mesh, in one fixed order, because
``dist.new_group`` is collective also for the groups a rank is not in.
:func:`horovod_tpu_torch.shutdown` forgets both meshes with the process
group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch.distributed as dist

from horovod_tpu_torch import basics

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPELINE_AXIS = "pipe"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"
#: parameter-sharding (FSDP / ZeRO-3) axis
FSDP_AXIS = "fsdp"
#: tensor-parallel axis
TP_AXIS = "tp"
#: host-hierarchy axes (Horovod's CROSS/LOCAL communicators):
#: ``cross`` = across hosts, ``local`` = inside a host
CROSS_AXIS = "cross"
LOCAL_AXIS = "local"

#: the JAX package's outer-to-inner axis order of multi-axis meshes
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, EXPERT_AXIS, PIPELINE_AXIS,
              SEQUENCE_AXIS, MODEL_AXIS, TP_AXIS)


class HostMesh(NamedTuple):
    """This rank's place in a ``cross x local`` split of the world and
    its two sub-groups. ``local_ranks``/``cross_ranks`` are the global
    ranks of its LOCAL and CROSS groups, in group-rank order."""

    cross: int
    local: int
    cross_index: int
    local_index: int
    local_group: object
    cross_group: object
    local_ranks: Tuple[int, ...]
    cross_ranks: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        """``{"cross": C, "local": L}``, as a JAX mesh's ``shape``."""
        return {CROSS_AXIS: self.cross, LOCAL_AXIS: self.local}


def build_host_mesh(local: Optional[int] = None) -> HostMesh:
    """Split the world into ``cross x local`` (``local`` defaults to
    :func:`~horovod_tpu_torch.basics.local_size`; ``cross`` fills the
    rest) and make it the process's host mesh. Collective: every rank
    calls it with the same ``local``. Every LOCAL group is made, then
    every CROSS group, on every rank."""
    basics._require_init()
    n, r = basics.size(), basics.rank()
    L = int(local) if local is not None else basics.local_size()
    if L <= 0 or n % L:
        raise ValueError(
            f"device count {n} not divisible by fixed axes product {L}")
    C = n // L
    mine = {}
    for c in range(C):
        ranks = tuple(c * L + l for l in range(L))
        g = dist.new_group(ranks=list(ranks))
        if r in ranks:
            mine["local"] = (g, ranks)
    for l in range(L):
        ranks = tuple(c * L + l for c in range(C))
        g = dist.new_group(ranks=list(ranks))
        if r in ranks:
            mine["cross"] = (g, ranks)
    mesh = HostMesh(cross=C, local=L, cross_index=r // L, local_index=r % L,
                    local_group=mine["local"][0], cross_group=mine["cross"][0],
                    local_ranks=mine["local"][1], cross_ranks=mine["cross"][1])
    basics._state.host_mesh = mesh
    return mesh


def host_mesh() -> Optional[HostMesh]:
    """The process's host mesh (:func:`build_host_mesh`), or None."""
    basics._require_init()
    return basics._state.host_mesh


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative ``("data", "fsdp", "tp")`` mesh spec: axis lengths
    multiply to the world size (one may be ``-1`` to fill), unused axes
    stay at length 1. ``build()`` lowers through :func:`build_mesh`."""

    axis_lengths: Tuple[int, ...]
    axis_names: Tuple[str, ...] = (DATA_AXIS, FSDP_AXIS, TP_AXIS)

    def __post_init__(self):
        if len(self.axis_lengths) != len(self.axis_names):
            raise ValueError(
                f"axis_lengths {self.axis_lengths} and axis_names "
                f"{self.axis_names} must have equal rank"
            )
        for name, length in zip(self.axis_names, self.axis_lengths):
            if length != -1 and length <= 0:
                raise ValueError(
                    f"axis {name!r} must have positive length (or -1 to "
                    f"fill), got {length}"
                )

    @property
    def axes(self) -> dict:
        return dict(zip(self.axis_names, self.axis_lengths))

    def build(self) -> "Mesh":
        return build_mesh(axes=self.axes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a named-axis layout of the world: ``shape``
    maps each axis (outer to inner) to its size, ``coords`` to this
    rank's index along it; ``groups``/``line_ranks`` hold, for each axis,
    the sub-group of the ranks that differ from this one only along it
    and their global ranks in axis order."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    line_ranks: Dict[str, Tuple[int, ...]]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def _check(self, name: str) -> None:
        if name not in self.shape:
            raise ValueError(f"no mesh axis {name!r}; the mesh has "
                             f"{self.axis_names}")

    def axis_index(self, name: str) -> int:
        self._check(name)
        return self.coords[name]

    def axis_size(self, name: str) -> int:
        self._check(name)
        return self.shape[name]

    def group(self, name: str):
        self._check(name)
        return self.groups[name]

    def ranks(self, name: str) -> Tuple[int, ...]:
        self._check(name)
        return self.line_ranks[name]


def build_mesh(axes: Optional[dict] = None) -> Mesh:
    """Lay the world out over named axes and make it the process's mesh.

    ``axes`` maps axis name to size; at most one size may be ``-1`` (it
    fills with the remaining ranks). Default ``{"data": -1}``: one axis
    over every rank, the Horovod topology. Names in :data:`AXIS_ORDER`
    come first, in that order, then custom axes; ranks are laid out
    row-major (the last axis innermost), as the JAX package reshapes its
    device list. Collective: every rank calls it with the same ``axes``,
    and every rank makes every line's group, axis by axis."""
    basics._require_init()
    n, r = basics.size(), basics.rank()
    if axes is None:
        axes = {DATA_AXIS: -1}
    names = [a for a in AXIS_ORDER if a in axes]
    names += [a for a in axes if a not in names]  # user-custom axes last
    sizes = [axes[a] for a in names]
    n_wild = sum(1 for s in sizes if s == -1)
    if n_wild > 1:
        raise ValueError(f"at most one axis size may be -1, got {axes}")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if n_wild == 1:
        if n % fixed != 0:
            raise ValueError(
                f"device count {n} not divisible by fixed axes product {fixed}"
            )
        sizes = [n // fixed if s == -1 else s for s in sizes]
    elif fixed != n:
        raise ValueError(f"axes product {fixed} != device count {n}")
    layout = np.arange(n).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(r, sizes))))
    groups, line_ranks = {}, {}
    for i, name in enumerate(names):
        moved = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
        for line in moved:
            ranks = tuple(int(x) for x in line)
            g = dist.new_group(ranks=list(ranks))
            if r in ranks:
                groups[name], line_ranks[name] = g, ranks
    mesh = Mesh(shape=dict(zip(names, sizes)), coords=coords, groups=groups,
                line_ranks=line_ranks)
    basics._state.mesh = mesh
    return mesh


def axis_collectives(axis_name: str) -> Mesh:
    """The process's mesh, for a collective over ``axis_name``'s sub-group.
    Refused while the native core is attached: the core issues every
    collective from its own thread in the negotiated order, and one
    issued on a mesh axis's communicator from the caller's thread beside
    the core's plans can deadlock the ranks, which may order the two
    differently."""
    if basics._state.core is not None:
        raise RuntimeError(
            f"collectives over the mesh axis {axis_name!r} do not go through "
            "the native core: call hvd.init() without native_core to use "
            "mesh axes")
    return current_mesh()


def current_mesh() -> Mesh:
    """The process's mesh (:func:`build_mesh`); raises if there is none."""
    basics._require_init()
    m = basics._state.mesh
    if m is None:
        raise RuntimeError("no mesh: call horovod_tpu_torch.parallel."
                           "build_mesh(axes) on every rank first")
    return m
