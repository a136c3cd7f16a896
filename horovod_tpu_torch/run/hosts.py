"""Host parsing and slot allocation.

Counterpart of ``horovod_tpu/run/hosts.py``, copied whole: a slot is one
worker process, and in the port one process drives one GPU.

Reference: ``horovod/run/gloo_run.py:54-112`` (``_allocate``: rank /
local_rank / cross_rank / sizes per slot) and host-list parsing in
``horovod/run/runner.py:551-568`` (``-H h1:4,h2:4`` / ``--hostfile``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class HostSlots:
    """One launched process (reference ``SlotInfo``)."""

    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """Parse ``h1:4,h2:4`` (slots default to 1)."""
    out: List[HostInfo] = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^([\w.\-\[\]:]+?)(?::(\d+))?$", part)
        if m is None:
            raise ValueError(f"bad host spec: {part!r}")
        out.append(HostInfo(m.group(1), int(m.group(2) or 1)))
    return out


def parse_hostfile(path: str) -> List[HostInfo]:
    """Hostfile lines: ``hostname slots=N`` (reference runner.py hostfile
    handling; mpirun-style)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=", 1)[1])
            out.append(HostInfo(parts[0], slots))
    return out


def allocate(hosts: List[HostInfo], np: int) -> List[HostSlots]:
    """Assign `np` process slots over `hosts` rank-major, computing the
    GLOBAL/LOCAL/CROSS coordinates (reference ``gloo_run.py:54-112``; the
    communicator triple ``common/common.h:111-115``)."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested -np {np} exceeds available slots {total} "
            f"across {len(hosts)} host(s)"
        )
    slots: List[HostSlots] = []
    rank = 0
    for h in hosts:
        for local_rank in range(h.slots):
            if rank >= np:
                break
            slots.append(
                HostSlots(
                    hostname=h.hostname,
                    rank=rank,
                    size=np,
                    local_rank=local_rank,
                    local_size=0,  # filled below
                    cross_rank=0,
                    cross_size=0,
                )
            )
            rank += 1
    # local_size = processes on the same host
    by_host: dict = {}
    for s in slots:
        by_host.setdefault(s.hostname, []).append(s)
    for host_slots in by_host.values():
        for s in host_slots:
            s.local_size = len(host_slots)
    # cross_rank = index of this host among hosts having this local_rank;
    # cross_size = number of such hosts (reference gloo_run.py:95-112)
    by_local_rank: dict = {}
    for s in slots:
        by_local_rank.setdefault(s.local_rank, []).append(s)
    for group in by_local_rank.values():
        group.sort(key=lambda s: s.rank)
        for i, s in enumerate(group):
            s.cross_rank = i
            s.cross_size = len(group)
    return slots


def slot_env(slot: HostSlots) -> dict:
    """Identity env for one process (reference ``gloo_run.py:152-157``
    ``HOROVOD_RANK/SIZE/...``)."""
    return {
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        # the JAX package's multi-host names, kept so that both packages
        # give a slot the same identity
        "HVD_PROCESS_ID": str(slot.rank),
        "HVD_NUM_PROCESSES": str(slot.size),
    }


def hosts_from_scheduler_env(environ=None) -> Optional[List[HostInfo]]:
    """Default host list from a cluster scheduler's environment, the analog
    of the reference's LSF support (``run/util/lsf.py``, ``run/js_run.py``:
    ``horovodrun`` with no ``-H`` inside an LSF allocation reads the job's
    hosts). Recognized:

    - LSF: ``LSB_DJOB_HOSTFILE`` (one hostname per line, one per slot) or
      ``LSB_HOSTS`` (space-separated, repeated per slot);
    - SLURM: ``SLURM_JOB_NODELIST``/``SLURM_NODELIST`` in the simple
      comma/bracket form (``n[1-3],m5``) with ``SLURM_NTASKS_PER_NODE``.
    """
    import collections
    import os

    env = environ if environ is not None else os.environ

    def counted(hostnames) -> List[HostInfo]:
        counts = collections.Counter(hostnames)  # insertion-ordered
        return [HostInfo(h, n) for h, n in counts.items()]

    # LSF: first host is the launch node and runs rank 0. An unreadable
    # hostfile falls through to LSB_HOSTS (same list, env-borne).
    if env.get("LSB_DJOB_HOSTFILE"):
        try:
            with open(env["LSB_DJOB_HOSTFILE"]) as f:
                names = [line.strip() for line in f if line.strip()]
            if names:
                return counted(names)
        except OSError:
            pass
    if env.get("LSB_HOSTS"):
        return counted(env["LSB_HOSTS"].split())

    nodelist = env.get("SLURM_JOB_NODELIST") or env.get("SLURM_NODELIST")
    if nodelist:
        names: List[str] = []
        for part in re.split(r",(?![^\[]*\])", nodelist):
            m = re.match(r"^(.*)\[([\d,\-]+)\]$", part)
            if not m:
                names.append(part)
                continue
            prefix, ranges = m.groups()
            for r in ranges.split(","):
                if "-" in r:
                    lo, hi = r.split("-")
                    width = len(lo)
                    names += [
                        f"{prefix}{i:0{width}d}"
                        for i in range(int(lo), int(hi) + 1)
                    ]
                else:
                    names.append(f"{prefix}{r}")
        # SLURM_TASKS_PER_NODE is always set for a job ("2(x3),1" = 2 tasks
        # on each of 3 nodes, then 1); SLURM_NTASKS_PER_NODE only with an
        # explicit --ntasks-per-node.
        tasks_spec = (env.get("SLURM_NTASKS_PER_NODE")
                      or env.get("SLURM_TASKS_PER_NODE"))
        slot_list: List[int] = []
        if tasks_spec:
            for piece in str(tasks_spec).split(","):
                m = re.match(r"^(\d+)(?:\(x(\d+)\))?$", piece.strip())
                if not m:
                    slot_list = []
                    break
                slot_list += [int(m.group(1))] * int(m.group(2) or 1)
        if len(slot_list) == len(names):
            return [HostInfo(n, s) for n, s in zip(names, slot_list)]
        slots = slot_list[0] if slot_list else 1
        return [HostInfo(n, slots) for n in names]
    return None


def get_host_assignments(
    hosts: Optional[str],
    hostfile: Optional[str],
    np: int,
) -> List[HostSlots]:
    if hosts and hostfile:
        raise ValueError("pass either hosts or hostfile, not both")
    if hostfile:
        infos = parse_hostfile(hostfile)
    elif hosts:
        infos = parse_hosts(hosts)
    else:
        infos = hosts_from_scheduler_env() or [HostInfo("localhost", np)]
    return allocate(infos, np)
