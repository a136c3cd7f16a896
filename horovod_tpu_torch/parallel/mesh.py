"""The host mesh: Horovod's LOCAL and CROSS communicators.

Counterpart of ``horovod_tpu/parallel/mesh.py``. Horovod splits the job
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

``MeshConfig`` and ``build_mesh`` over ``data``/``fsdp``/``tp`` come with
tensor parallelism.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
