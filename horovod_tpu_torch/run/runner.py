"""Launcher orchestration: CLI parsing, process fan-out, result collection.

Counterpart of ``horovod_tpu/run/runner.py`` (reference
``horovod/run/runner.py`` and ``horovod/run/gloo_run.py``). The JAX
launcher starts one process per TPU host; this one starts **one process
per GPU slot**, as Horovod does: ``-np`` is the number of GPUs, and each
slot's process takes ``cuda:<local_rank>`` in ``hvd.init()``. Local slots
spawn directly, remote slots over ssh.

Each slot's environment (:func:`worker_env`, shared with
:func:`horovod_tpu_torch.testing.run_world`) carries its identity
(:func:`~horovod_tpu_torch.run.hosts.slot_env`), what
``torch.distributed``'s ``env://`` rendezvous needs (``MASTER_ADDR``/
``MASTER_PORT`` of a ``TCPStore`` the launcher serves, and
``TORCHELASTIC_USE_AGENT_STORE=True``, which makes every rank a client of
it), the native core's coordinator (``HVD_CORE_COORD_ADDR``/
``HVD_CORE_COORD_PORT``) and the rendezvous KV store's endpoints
(``HVD_RUN_KV_*``). No port is chosen, released and bound again: the
world's store is served on a port the kernel picks as it binds (one store
a restart attempt, so a restarted world never meets the keys of the one
before), the KV store likewise, and the core's port stays reserved
(bound, not listening) while the job runs.

A SIGTERM to the launcher is forwarded, once, to every worker's process
group: each rank drains, writes its emergency checkpoint and exits 75
(:data:`~horovod_tpu_torch.resilience.loop.RESUMABLE_EXIT_CODE`), and the
job exits 75.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import pickle
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

from horovod_tpu_torch.run import config_parser, hosts as hosts_mod
from horovod_tpu_torch.run.hosts import HostSlots
from horovod_tpu_torch.run.rendezvous import (
    ADDRS_ENV,
    KVStoreServer,
    SECRET_ENV,
    format_endpoints,
    make_secret,
)
from horovod_tpu_torch.run import replication as _replication
from horovod_tpu_torch.run import safe_exec
from horovod_tpu_torch.resilience import retry as _retry
from horovod_tpu_torch.resilience.loop import RESUMABLE_EXIT_CODE
from horovod_tpu_torch.observability import metrics as _metrics


class HostStrikes:
    """Per-host failed-restart strikes with blacklisting (the launcher-level
    analog of the strike-pruning the core's fusion buckets already do for
    absent tensors): a host whose *restarted* workers keep dying again
    stops receiving restarts, so a flapping machine cannot burn the whole
    restart budget. First failures and preemptions never strike — see the
    restart loop in :func:`launch_job`. Limit via
    ``HOROVOD_HOST_STRIKE_LIMIT`` (default 3).

    **Re-admission** (elastic): strikes older than ``decay_s``
    (``HOROVOD_HOST_STRIKE_DECAY``, seconds; default 0 = strikes are
    permanent) are forgotten, so a host blacklisted during a bad stretch —
    a flapping NIC, a kernel that needed a reboot — becomes eligible for
    restarts again once it has stayed quiet for the decay window, instead
    of being dead to the job forever."""

    def __init__(self, limit: Optional[int] = None,
                 decay_s: Optional[float] = None):
        if limit is None:
            limit = int(os.environ.get("HOROVOD_HOST_STRIKE_LIMIT", "3"))
        if decay_s is None:
            decay_s = float(os.environ.get("HOROVOD_HOST_STRIKE_DECAY", "0"))
        self.limit = limit
        self.decay_s = decay_s
        self._strikes: dict = {}  # host -> [monotonic strike times]
        self._lock = threading.Lock()

    def _fresh_locked(self, host: str) -> list:
        times = self._strikes.get(host, [])
        if self.decay_s > 0:
            cutoff = time.monotonic() - self.decay_s
            times = [t for t in times if t > cutoff]
            if times:
                self._strikes[host] = times
            else:
                self._strikes.pop(host, None)
        return times

    def strike(self, host: str) -> int:
        with self._lock:
            times = self._fresh_locked(host)
            times = times + [time.monotonic()]
            self._strikes[host] = times
            return len(times)

    def forgive(self, host: str) -> None:
        """A worker that came back up clears its host's record."""
        with self._lock:
            self._strikes.pop(host, None)

    def blacklisted(self, host: str) -> bool:
        with self._lock:
            return len(self._fresh_locked(host)) >= self.limit


def parse_args(argv: Optional[Sequence[str]] = None):
    """CLI surface (reference ``runner.py:221-453``; the MPI flags are
    absent — the port's data plane is ``torch.distributed``)."""
    p = argparse.ArgumentParser(
        prog="hvdrun_torch",
        description="Launch a horovod_tpu_torch training job: one process "
        "per GPU slot, wired up through torch.distributed's env:// "
        "rendezvous + the native control-plane coordinator.",
    )
    p.add_argument("-v", "--version", action="store_true", help="print version")
    p.add_argument("-cb", "--check-build", action="store_true",
                   dest="check_build",
                   help="print available frontends/controllers/operations "
                        "and exit (reference horovodrun --check-build)")
    # migration-compat controller flags (reference horovodrun --gloo/--mpi).
    # The single controller here fills the no-MPI role the reference calls
    # gloo mode, so --gloo is an accepted no-op; --mpi errors clearly.
    p.add_argument("--gloo", action="store_true", dest="use_gloo",
                   help="accepted for horovodrun compatibility (the TCP "
                        "controller already fills this role)")
    p.add_argument("--mpi", action="store_true", dest="use_mpi",
                   help="not supported: no MPI exists in this framework")
    p.add_argument("-np", "--num-proc", type=int, dest="np", default=None,
                   help="number of processes (one per GPU)")
    p.add_argument("-H", "--hosts", dest="hosts", default=None,
                   help="host list, e.g. host1:4,host2:4 (GPU slots per "
                        "host)")
    p.add_argument("--hostfile", dest="hostfile", default=None,
                   help="hostfile with lines 'hostname slots=N'")
    p.add_argument("--ssh-port", type=int, dest="ssh_port", default=None)
    p.add_argument("--start-timeout", type=int, dest="start_timeout",
                   default=int(os.environ.get("HOROVOD_START_TIMEOUT", "30")),
                   help="seconds the world's store waits on a worker, "
                        "beyond a 300 s floor")
    p.add_argument("--max-restarts", type=int, dest="max_restarts",
                   default=None,
                   help="restart a failed worker in place up to N times "
                        "(preempted workers exit resumable and resume from "
                        "their emergency checkpoint; default "
                        "HOROVOD_MAX_RESTARTS or 0)")
    p.add_argument("--min-workers", type=int, dest="min_workers",
                   default=None,
                   help="elastic floor: a permanently failed slot no longer "
                        "kills the job while the surviving worker count "
                        "stays >= this (default "
                        "HOROVOD_ELASTIC_MIN_WORKERS, else 0 = rigid: any "
                        "failure kills the job)")
    p.add_argument("--max-workers", type=int, dest="max_workers",
                   default=None,
                   help="elastic ceiling exported to workers as "
                        "HOROVOD_ELASTIC_MAX_WORKERS (default: the launched "
                        "slot count)")
    p.add_argument("--kv-standbys", type=int, dest="kv_standbys",
                   default=None,
                   help="warm standby KV servers for control-plane HA: "
                        "the primary rendezvous store runs as a process of "
                        "its own and replicates every write to them, and "
                        "workers get the full endpoint list "
                        "(HVD_RUN_KV_ADDRS) for automatic failover "
                        "(default HOROVOD_KV_REPLICAS, else 0 = one KV "
                        "server in the launcher)")
    p.add_argument("--kv-standby-hosts", dest="kv_standby_hosts",
                   default=None,
                   help="comma-separated hosts to run the standbys on "
                        "over ssh (python -m horovod_tpu_torch.run."
                        "replication); default: in the launcher process — "
                        "standbys on other hosts survive a launcher-host "
                        "loss")
    p.add_argument("--output-filename", dest="output_filename", default=None,
                   help="per-rank stdout/stderr capture directory "
                        "(reference gloo_run per-rank dirs)")
    p.add_argument("--verbose", action="store_true", dest="verbose")
    p.add_argument("--config-file", dest="config_file", default=None)
    # perf knobs (reference config_parser.py)
    p.add_argument("--fusion-threshold-mb", type=float,
                   dest="fusion_threshold_mb", default=None)
    p.add_argument("--cycle-time-ms", type=float, dest="cycle_time_ms",
                   default=None)
    p.add_argument("--cache-capacity", type=int, dest="cache_capacity",
                   default=None)
    hier_ar = p.add_mutually_exclusive_group()
    hier_ar.add_argument("--hierarchical-allreduce", action="store_true",
                         dest="hierarchical_allreduce", default=None,
                         help="two-level (cross x local) allreduce for "
                              "tuple-axis ops (reference "
                              "HOROVOD_HIERARCHICAL_ALLREDUCE)")
    hier_ar.add_argument("--no-hierarchical-allreduce", action="store_false",
                         dest="hierarchical_allreduce", default=None)
    hier_ag = p.add_mutually_exclusive_group()
    hier_ag.add_argument("--hierarchical-allgather", action="store_true",
                         dest="hierarchical_allgather", default=None,
                         help="two-level (cross x local) allgather")
    hier_ag.add_argument("--no-hierarchical-allgather", action="store_false",
                         dest="hierarchical_allgather", default=None)
    p.add_argument("--native-core", action="store_true", dest="native_core",
                   help="route named async collectives through the native "
                        "control-plane core (fusion/cache/stall/timeline)")
    p.add_argument("--timeline-filename", dest="timeline_filename",
                   default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true",
                   dest="timeline_mark_cycles")
    p.add_argument("--no-stall-check", action="store_true",
                   dest="no_stall_check")
    p.add_argument("--stall-check-warning-time-seconds", type=float,
                   dest="stall_check_warning_time_seconds", default=None)
    p.add_argument("--stall-check-shutdown-time-seconds", type=float,
                   dest="stall_check_shutdown_time_seconds", default=None)
    p.add_argument("--autotune", action="store_true", dest="autotune")
    p.add_argument("--autotune-log-file", dest="autotune_log_file",
                   default=None)
    p.add_argument("--autotune-warmup-samples", type=int,
                   dest="autotune_warmup_samples", default=None)
    p.add_argument("--autotune-steps-per-sample", type=int,
                   dest="autotune_steps_per_sample", default=None)
    p.add_argument("--log-level", dest="log_level", default=None,
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                            "FATAL"])
    p.add_argument("--log-hide-timestamp", action="store_true",
                   dest="log_hide_timestamp")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command, e.g. python train.py")

    args = p.parse_args(argv)

    if args.config_file:
        # config overrides defaults but not explicit flags
        explicit = _explicit_dests(p, argv if argv is not None else sys.argv[1:])
        cfg = config_parser.parse_config_file(args.config_file)
        config_parser.override_args(args, cfg, explicit)
    config_parser.validate_config_args(args)
    return args


def _explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dest names the user actually passed on the CLI. Stops at the start of
    the training command so its own flags (which may collide with hvdrun
    option names) are not miscounted."""
    explicit = set()
    opt_to_action = {}
    for action in parser._actions:
        for opt in action.option_strings:
            opt_to_action[opt] = action
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--":
            break
        key = tok.split("=", 1)[0]
        action = opt_to_action.get(key)
        if action is None:
            break  # first non-hvdrun token = the training command
        explicit.add(action.dest)
        takes_value = (
            action.nargs != 0
            and not isinstance(
                action, (argparse._StoreTrueAction, argparse._StoreFalseAction)
            )
        )
        if takes_value and "=" not in tok:
            i += 1  # skip the option's value token
        i += 1
    return explicit


def _free_port() -> int:
    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def reserve_port() -> socket.socket:
    """A socket bound to a port the kernel picks, with ``SO_REUSEADDR``
    and not listening: while it is open the kernel hands the port to no
    other ``bind`` to port 0, and a listener that also sets
    ``SO_REUSEADDR`` (the native core's coordinator does) can still bind
    and listen on it. Close it once that listener is up."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("0.0.0.0", 0))
    return s


def _local_ip() -> str:
    return socket.gethostbyname(socket.gethostname())


def _is_local(hostname: str) -> bool:
    return hostname in ("localhost", "127.0.0.1", socket.gethostname(),
                        socket.getfqdn(), _safe_local_ip())


def _safe_local_ip():
    try:
        return _local_ip()
    except OSError:
        return "127.0.0.1"


def worker_env(slot: HostSlots, env: dict, *, store_addr: str,
               store_port: int, core_addr: Optional[str] = None,
               core_port: Optional[int] = None) -> dict:
    """One slot's environment: ``env`` plus its identity
    (:func:`~horovod_tpu_torch.run.hosts.slot_env`), the ``env://``
    rendezvous at ``store_addr:store_port`` (a ``TCPStore`` that is
    already served: ``TORCHELASTIC_USE_AGENT_STORE=True`` makes every
    rank, rank 0 included, a client of it) and, when given, the native
    core's coordinator. The launcher and
    :func:`horovod_tpu_torch.testing.run_world` both build a slot's
    environment here."""
    out = dict(env)
    out.update(hosts_mod.slot_env(slot))
    out["MASTER_ADDR"] = store_addr
    out["MASTER_PORT"] = str(store_port)
    out["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    if core_port is not None:
        out["HVD_CORE_COORD_ADDR"] = core_addr or store_addr
        out["HVD_CORE_COORD_PORT"] = str(core_port)
    return out


#: environment prefixes a remote slot's ssh command exports
REMOTE_ENV_PREFIXES = ("HOROVOD_", "HVD_", "PYTHON", "PATH", "MASTER_",
                       "TORCHELASTIC_", "CUDA_", "NCCL_", "CUBLAS_")


def build_command_for_slot(
    slot: HostSlots,
    command: Sequence[str],
    env: dict,
    coordinator_addr: str,
    store_port: int,
    core_port: int,
    ssh_port: Optional[int] = None,
    store_addr: Optional[str] = None,
) -> tuple:
    """(argv, env) for one slot; remote slots get an ssh wrapper with env
    inlined (reference ``gloo_run.py:143-163`` ssh + exported env). The
    world's store is at ``store_addr`` (default ``coordinator_addr``), the
    native core's coordinator, in rank 0, at ``coordinator_addr``."""
    slot_env = worker_env(
        slot, env, store_addr=store_addr or coordinator_addr,
        store_port=store_port, core_addr=coordinator_addr,
        core_port=core_port)
    if _is_local(slot.hostname):
        return list(command), slot_env
    exports = " ".join(
        f"{k}={shlex.quote(v)}"
        for k, v in sorted(slot_env.items())
        if k.startswith(REMOTE_ENV_PREFIXES)
    )
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    remote = f"cd {shlex.quote(os.getcwd())} > /dev/null 2>&1 ; " \
             f"env {exports} {' '.join(shlex.quote(c) for c in command)}"
    return ssh + [slot.hostname, remote], env


class _WorldStores:
    """The ``TCPStore`` each restart attempt's world meets at, served by
    the launcher on a port the kernel picks (port 0) when the first slot
    of that attempt starts. A fresh store an attempt: a restarted world
    must not read the addresses its dead predecessor left there."""

    def __init__(self, addr: str, timeout_s: float):
        self._addr = addr
        self._timeout = datetime.timedelta(seconds=timeout_s)
        self._stores: dict = {}
        self._lock = threading.Lock()

    def port(self, attempt: int) -> int:
        import torch.distributed as dist

        with self._lock:
            store = self._stores.get(attempt)
            if store is None:
                store = self._stores[attempt] = dist.TCPStore(
                    self._addr, 0, None, is_master=True,
                    wait_for_workers=False, timeout=self._timeout)
            return store.port

    def close(self) -> None:
        with self._lock:
            self._stores.clear()


def launch_job(
    slots: List[HostSlots],
    command: Sequence[str],
    env: Optional[dict] = None,
    *,
    output_filename: Optional[str] = None,
    verbose: bool = False,
    ssh_port: Optional[int] = None,
    timeout_s: Optional[float] = None,
    start_timeout: Optional[int] = None,
    max_restarts: Optional[int] = None,
    min_workers: Optional[int] = None,
    max_workers: Optional[int] = None,
    preempt: Optional[threading.Event] = None,
) -> List[int]:
    """Spawn every slot, stream rank-tagged output, kill all on first
    *unrecoverable* failure (reference ``gloo_run.launch_gloo``: one nonzero
    exit terminates the job, ``gloo_run.py:294-304``). Returns per-rank exit
    codes.

    With ``max_restarts > 0`` (or ``HOROVOD_MAX_RESTARTS``), a slot that
    exits nonzero — a preempted worker exits
    :data:`~horovod_tpu_torch.resilience.loop.RESUMABLE_EXIT_CODE` and
    resumes from its emergency checkpoint — is restarted in place with the
    shared backoff policy (``HOROVOD_RETRY_WORKER_RESTART_*``), bounded per
    slot and per host: a host that keeps striking out is blacklisted
    (:class:`HostStrikes`) and stops receiving restarts. Restart attempt
    ``k`` of every slot meets at the ``k``-th world store.

    Restart-in-place assumes the whole job cycles together (every rank
    gets SIGTERM, every rank exits 75, every slot restarts into a fresh
    rendezvous). A single rank of a still-running multi-rank job that dies
    alone cannot re-enter its peers' process group, so by default a
    lone-crash job still ends via the kill-on-failure path — after the
    restart budget instead of immediately.

    With ``min_workers > 0`` (``--min-workers`` /
    ``HOROVOD_ELASTIC_MIN_WORKERS``) the launcher stops treating a
    permanently failed slot (restarts exhausted or host blacklisted) as
    fatal while the surviving slot count stays >= ``min_workers``: the
    slot is abandoned and the survivors keep running; they re-form
    without it in-process (:mod:`horovod_tpu_torch.resilience.elastic`).

    ``preempt``, once set, sends every worker's process group one SIGTERM
    (the launcher's own SIGTERM, :func:`run_commandline`): the workers
    drain and exit 75 on their own, within ``HOROVOD_PREEMPT_DRAIN_TIMEOUT``
    of the first of them."""
    env = dict(env if env is not None else os.environ)
    if max_restarts is None:
        max_restarts = int(os.environ.get("HOROVOD_MAX_RESTARTS", "0"))
    if min_workers is None:
        min_workers = int(os.environ.get("HOROVOD_ELASTIC_MIN_WORKERS", "0"))
    if min_workers:
        env["HOROVOD_ELASTIC_MIN_WORKERS"] = str(min_workers)
    if max_workers:
        env["HOROVOD_ELASTIC_MAX_WORKERS"] = str(max_workers)
    else:
        # default to the launched slot count, but never clobber an
        # operator-exported cap (symmetric with MIN_WORKERS above)
        env.setdefault("HOROVOD_ELASTIC_MAX_WORKERS", str(len(slots)))
    abandoned = {"n": 0}
    abandon_lock = threading.Lock()
    strikes = HostStrikes()
    # HOROVOD_RETRY_WORKER_RESTART_* tunes the backoff shape only; the
    # restart COUNT is --max-restarts/HOROVOD_MAX_RESTARTS, pinned after
    # the env so a stray MAX_ATTEMPTS override can neither add restarts
    # nor starve the delays() schedule below the restart budget
    restart_policy = dataclasses.replace(
        _retry.policy_from_env(
            "worker_restart", base_delay=0.5, max_delay=10.0,
        ),
        max_attempts=max_restarts + 1,
    )
    env.setdefault("PYTHONUNBUFFERED", "1")
    # the world's store lives in this process, the native core's
    # coordinator in rank 0's: loopback only when the whole job is local
    all_local = all(_is_local(s.hostname) for s in slots)
    if all_local:
        coordinator_addr = store_addr = "127.0.0.1"
    else:
        store_addr = _safe_local_ip()
        coordinator_addr = (store_addr if _is_local(slots[0].hostname)
                            else slots[0].hostname)
    # the core's port: held here (bound, not listening) while rank 0 is
    # local; a remote rank 0 gets a random high port, free in practice
    held = reserve_port() if _is_local(slots[0].hostname) else None
    core_port = held.getsockname()[1] if held is not None else _free_port()
    stores = _WorldStores(store_addr, float(start_timeout or 0) + 300.0)

    stop = threading.Event()
    codes: List[Optional[int]] = [None] * len(slots)
    threads = []
    out_dir = None
    if output_filename:
        out_dir = output_filename
        os.makedirs(out_dir, exist_ok=True)

    def run_slot(i: int, slot: HostSlots):
        sinks = []
        if out_dir:
            # "w": fresh files per launch_job invocation; in-job restarts
            # keep appending through these same open handles
            fo = open(os.path.join(out_dir, f"rank.{slot.rank}.out"), "w")
            fe = open(os.path.join(out_dir, f"rank.{slot.rank}.err"), "w")
            sinks = [fo, fe]

            def out_h(line, _f=fo):
                _f.write(line)
                _f.flush()

            def err_h(line, _f=fe):
                _f.write(line)
                _f.flush()
        else:
            def out_h(line, _r=slot.rank):
                sys.stdout.write(f"[{_r}]<stdout> {line}")

            def err_h(line, _r=slot.rank):
                sys.stderr.write(f"[{_r}]<stderr> {line}")

        delays = restart_policy.delays()
        attempt = 0
        while True:
            argv, slot_env = build_command_for_slot(
                slot, command, env, coordinator_addr, stores.port(attempt),
                core_port, ssh_port, store_addr=store_addr,
            )
            rc = safe_exec.execute(
                argv, env=slot_env, stdout_handler=out_h,
                stderr_handler=err_h, event=stop, signal_event=preempt,
            )
            if rc == 0:
                strikes.forgive(slot.hostname)
                break
            if stop.is_set():
                break  # killed as part of job teardown, not a failure here
            if rc != RESUMABLE_EXIT_CODE and attempt > 0:
                # only a RESTARTED slot failing again strikes its host:
                # preemptions (exit 75) are the healthy path, and a single
                # correlated crash (one rank dies, every peer's collectives
                # abort nonzero) would otherwise land one strike per slot
                # and insta-blacklist any host running >= limit slots
                strikes.strike(slot.hostname)
            if attempt >= max_restarts or (
                    preempt is not None and preempt.is_set()):
                break
            if rc != RESUMABLE_EXIT_CODE and strikes.blacklisted(
                slot.hostname
            ):
                sys.stderr.write(
                    f"hvdrun: host {slot.hostname} blacklisted "
                    f"({strikes.limit} failed restarts); not restarting "
                    f"rank {slot.rank}\n"
                )
                break
            attempt += 1
            kind = (
                "preempted (resumable)" if rc == RESUMABLE_EXIT_CODE
                else f"exit {rc}"
            )
            delay = next(delays, restart_policy.max_delay)
            sys.stderr.write(
                f"hvdrun: rank {slot.rank} on {slot.hostname} {kind}; "
                f"restart {attempt}/{max_restarts} in {delay:.1f}s\n"
            )
            if _metrics.enabled():
                _metrics.counter(
                    "resilience_worker_restarts",
                    help="worker processes restarted by the launcher",
                    host=slot.hostname,
                ).inc()
            if stop.wait(delay):
                break
        for f in sinks:
            f.close()
        codes[i] = rc
        if rc != 0 and not stop.is_set():
            if rc != RESUMABLE_EXIT_CODE and min_workers:
                # elastic tolerance: abandon this slot instead of killing
                # the job, as long as the floor holds — the survivors
                # re-form at the smaller world size (preemptions stay on
                # the whole-job path: every rank got SIGTERM anyway)
                with abandon_lock:
                    abandoned["n"] += 1
                    surviving = len(slots) - abandoned["n"]
                if surviving >= min_workers:
                    sys.stderr.write(
                        f"hvdrun: rank {slot.rank} on {slot.hostname} "
                        f"abandoned (exit {rc}); continuing with "
                        f"{surviving} worker(s) >= min-workers "
                        f"{min_workers}\n"
                    )
                    if _metrics.enabled():
                        _metrics.counter(
                            "resilience_elastic_slots_abandoned",
                            help="permanently failed slots tolerated by "
                                 "the elastic floor",
                            host=slot.hostname,
                        ).inc()
                    return
                sys.stderr.write(
                    f"hvdrun: rank {slot.rank} failure drops the job below "
                    f"min-workers {min_workers}; tearing down\n"
                )
            if rc == RESUMABLE_EXIT_CODE:
                # a preempted rank's exit must not SIGKILL its peers out of
                # their own drain-and-checkpoint window (teardown escalates
                # to SIGKILL after ~5s; the drain budget is 30s): in a real
                # preemption every rank got SIGTERM and will exit 75 on its
                # own — give them the drain budget before the kill-all
                grace = float(os.environ.get(
                    "HOROVOD_PREEMPT_DRAIN_TIMEOUT", "30"
                )) + 5.0
                t0 = time.monotonic()
                while time.monotonic() - t0 < grace:
                    if all(c is not None for c in codes):
                        break  # everyone already down on their own
                    if stop.wait(0.1):
                        break
            stop.set()  # kill the rest of the job

    try:
        for i, slot in enumerate(slots):
            t = threading.Thread(target=run_slot, args=(i, slot))
            t.start()
            threads.append(t)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        for t in threads:
            t.join(
                timeout=None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
        if any(t.is_alive() for t in threads):
            stop.set()  # job exceeded its deadline: kill every process tree
            for t in threads:
                t.join(timeout=safe_exec.GRACEFUL_TERMINATION_TIME_S + 5)
    finally:
        if held is not None:
            held.close()
        stores.close()
    return [c if c is not None else -1 for c in codes]


def _check_build_summary() -> str:
    """Availability summary (reference ``check_build``, ``runner.py:115-151``
    — same shape, the port's content: NCCL and gloo from
    ``torch.distributed``, whether ``nvcc`` is found, and whether the CUDA
    kernels and the native core are built in this checkout)."""
    import importlib.util

    def have(mod):
        return "X" if importlib.util.find_spec(mod) is not None else " "

    def flag(b):
        return "X" if b else " "

    version, nvcc, kernels, core = "?", " ", " ", " "
    nccl = gloo = " "
    try:
        import torch.distributed as dist

        from horovod_tpu_torch import __version__
        from horovod_tpu_torch.ops import _build

        version = __version__
        nccl = flag(dist.is_nccl_available())
        gloo = flag(dist.is_gloo_available())
        try:
            nvcc = flag(_build.nvcc())
        except RuntimeError:
            nvcc = " "
        kernels = flag(all(os.path.exists(_build._lib_path(n))
                           for n in _build.SOURCES))
        core = flag(os.path.exists(_build._core_path()))
    except Exception as e:
        import logging

        logging.getLogger("horovod_tpu_torch.run").debug(
            "build-info probe incomplete: %s", e)
    return (
        f"horovod_tpu_torch v{version}:\n\n"
        "Available Frontends:\n"
        f"    [{have('torch')}] PyTorch\n\n"
        "Available Controllers:\n"
        f"    [{core}] TCP (native core built)\n"
        "    [ ] MPI\n"
        f"    [{gloo}] Gloo\n\n"
        "Available Tensor Operations:\n"
        f"    [{nccl}] NCCL\n"
        "    [ ] DDL\n"
        "    [ ] CCL\n"
        "    [ ] MPI\n"
        f"    [{gloo}] Gloo\n\n"
        "CUDA kernels:\n"
        f"    [{nvcc}] nvcc found\n"
        f"    [{kernels}] kernels built"
    )


def _spawn_primary(secret: str, replicas: list, advertise: str,
                   timeout: float = 60.0):
    """The primary KV store as a process of its own
    (``python -m horovod_tpu_torch.run.replication --role primary``),
    shipping to ``replicas``; returns ``(process, port)`` once it prints
    its ready line (the port it bound: the kernel picked it)."""
    env = dict(os.environ, **{SECRET_ENV: secret})
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run.replication",
         "--role", "primary", "--port", "0",
         "--replicas", format_endpoints(replicas),
         "--advertise", advertise],
        stdout=subprocess.PIPE, text=True, env=env)
    ready = {}

    def read():
        ready["line"] = proc.stdout.readline().strip()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    line = ready.get("line", "")
    if not line.startswith("KV primary ready on port "):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"the primary KV store did not start: {line!r}")
    return proc, int(line.rsplit(" ", 1)[1])


def _launch_control_plane(args, env: dict, slots) -> Callable:
    """The rendezvous KV store the workers' observability planes meet at,
    its endpoints exported as ``HVD_RUN_KV_ADDR``/``HVD_RUN_KV_PORT``/
    ``HVD_RUN_SECRET``. Without standbys it is one server in this process.
    With ``--kv-standbys N`` it is the HA control plane: N warm standbys
    (in this process, or on ``--kv-standby-hosts`` over ssh), the primary
    as a process of its own replicating to them (a failure domain apart
    from the launcher: its loss is survivable, the launcher's is not), a
    :class:`~horovod_tpu_torch.run.replication.FailoverMonitor` on each
    local standby, and the full endpoint list exported as
    ``HVD_RUN_KV_ADDRS`` so the workers' clients fail over. Returns a
    ``close()`` callable."""
    n = (args.kv_standbys if args.kv_standbys is not None
         else int(os.environ.get(_replication.REPLICAS_ENV, "0")))
    secret = env.get(SECRET_ENV) or make_secret()
    addr = (
        "127.0.0.1"
        if all(_is_local(s.hostname) for s in slots)
        else _safe_local_ip()
    )
    env[SECRET_ENV] = secret
    env["HVD_RUN_KV_ADDR"] = addr
    if n <= 0:
        server = KVStoreServer(secret=secret)
        env["HVD_RUN_KV_PORT"] = str(server.start())
        env.pop(ADDRS_ENV, None)
        return server.close
    standby_hosts = [
        h.strip() for h in (args.kv_standby_hosts or "").split(",")
        if h.strip()
    ]
    standbys, procs, replicas = [], [], []
    local, remote_plan = [], []
    for i in range(n):
        host = standby_hosts[i % len(standby_hosts)] if standby_hosts \
            else None
        if host is None or _is_local(host):
            s = KVStoreServer(secret=secret, role="standby")
            s.start()
            standbys.append(s)
            local.append((i, s))
            replicas.append((addr, s.port))
        else:
            # remote standby: random high port, same convention as a
            # remote rank-0 coordinator (free in practice)
            port = _free_port()
            remote_plan.append((i, host, port))
            replicas.append((host, port))
    try:
        primary, pport = _spawn_primary(secret, replicas, addr)
    except BaseException:
        for s in standbys:
            s.close()
        raise
    # remote standbys launch once the FULL endpoint list is known: every
    # FailoverMonitor needs its election peers (--peers), or on a primary
    # loss each remote standby would promote itself at the same time
    peers = format_endpoints(replicas)
    for i, host, port in remote_plan:
        remote = (
            f"env {SECRET_ENV}={shlex.quote(secret)} "
            f"{shlex.quote(sys.executable)} -m "
            f"horovod_tpu_torch.run.replication --role standby "
            f"--port {port} --primary {addr}:{pport} "
            f"--peers {shlex.quote(peers)} "
            f"--index {i} --advertise {shlex.quote(host)}"
        )
        ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
        if args.ssh_port:
            ssh += ["-p", str(args.ssh_port)]
        procs.append(subprocess.Popen(ssh + [host, remote]))
    monitors = []
    for i, s in local:
        # index by overall standby position (not local-list position) so
        # mixed local/remote deployments keep election precedence unique
        m = _replication.FailoverMonitor(
            s, (addr, pport), peers=replicas, index=i, secret=secret)
        m.start()
        monitors.append(m)
    env["HVD_RUN_KV_PORT"] = str(pport)
    env[ADDRS_ENV] = format_endpoints([(addr, pport)] + replicas)

    def close():
        for m in monitors:
            m.stop()
        for p in [primary] + procs:
            if p.poll() is None:
                p.terminate()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if primary.stdout is not None:
            primary.stdout.close()
        for s in standbys:
            s.close()

    return close


def run_commandline(argv: Optional[Sequence[str]] = None) -> int:
    """``hvdrun_torch`` entry point (reference ``run_commandline``). On the
    main thread, a SIGTERM or SIGINT to the launcher is forwarded to the
    workers as a preemption (:func:`launch_job`'s ``preempt``)."""
    args = parse_args(argv)
    if args.version:
        from horovod_tpu_torch import __version__

        print(__version__)
        return 0
    if args.check_build:
        print(_check_build_summary())
        return 0
    if args.use_mpi:
        print(
            "error: --mpi is not supported — this framework has no MPI by "
            "design; torch.distributed (NCCL, gloo) + the TCP controller "
            "cover that role (see docs/migrating.md)",
            file=sys.stderr,
        )
        return 2
    if not args.command:
        print("error: no training command given", file=sys.stderr)
        return 2
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    np = args.np or 1
    slots = hosts_mod.get_host_assignments(args.hosts, args.hostfile, np)
    env = dict(os.environ)
    config_parser.set_env_from_args(env, args)
    preempt = threading.Event()
    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, lambda *_: preempt.set())
    cp_close = _launch_control_plane(args, env, slots)
    try:
        codes = launch_job(
            slots,
            command,
            env,
            output_filename=args.output_filename,
            verbose=args.verbose,
            ssh_port=args.ssh_port,
            start_timeout=args.start_timeout,
            max_restarts=args.max_restarts,
            min_workers=args.min_workers,
            max_workers=args.max_workers,
            preempt=preempt,
        )
    finally:
        cp_close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    min_workers = args.min_workers or int(
        os.environ.get("HOROVOD_ELASTIC_MIN_WORKERS", "0"))
    bad = [(i, c) for i, c in enumerate(codes) if c != 0]
    if (
        bad
        and min_workers
        and len(codes) - len(bad) >= min_workers
        and all(c != RESUMABLE_EXIT_CODE for _, c in bad)
    ):
        print(
            f"hvdrun: {len(bad)}/{len(codes)} slot(s) abandoned; job "
            f"completed elastically with {len(codes) - len(bad)} worker(s)",
            file=sys.stderr,
        )
        return 0
    if bad:
        print(
            f"hvdrun: {len(bad)}/{len(codes)} processes failed: "
            + ", ".join(
                f"rank {i} "
                + ("preempted (restarts exhausted)"
                   if c == RESUMABLE_EXIT_CODE else f"exit {c}")
                for i, c in bad
            ),
            file=sys.stderr,
        )
        # A preempted job is itself resumable: a supervisor that relaunches
        # on EX_TEMPFAIL gets a clean resume from the emergency checkpoints.
        # The first rank to exit 75 triggers the kill-all teardown, so its
        # peers — mid-drain on the same preemption — are reaped as -SIGTERM;
        # count those as preemption, not failure.
        preemptish = all(
            c in (RESUMABLE_EXIT_CODE, -signal.SIGTERM) for _, c in bad
        )
        if preemptish and any(c == RESUMABLE_EXIT_CODE for _, c in bad):
            return RESUMABLE_EXIT_CODE
        return 1
    return 0


def main():
    sys.exit(run_commandline())


# --------------------------------------------------------------------------
# programmatic API: horovod_tpu_torch.run.run(fn, ...) (reference
# runner.py:632-653, 726+: cloudpickled fn shipped via KV store, per-rank
# results collected)

_WORKER_SNIPPET = """\
import os, pickle, sys
from horovod_tpu_torch.run.rendezvous import kv_client_from_env
timeout = float(os.environ.get("HVD_RUN_TIMEOUT", "300"))
# prefers the HVD_RUN_KV_ADDRS endpoint list (control-plane HA: the client
# fails over to a promoted standby) over the single ADDR/PORT pair
client = kv_client_from_env()
if client is None:
    raise RuntimeError("no KV endpoint in env (HVD_RUN_KV_ADDRS or "
                       "HVD_RUN_KV_ADDR/HVD_RUN_KV_PORT)")
fn, fn_args, fn_kwargs = pickle.loads(client.wait_for("func", timeout=timeout))
rank = int(os.environ["HOROVOD_RANK"])
try:
    result = fn(*fn_args, **fn_kwargs)
    client.put(f"result_{rank}", pickle.dumps(("ok", result)))
except BaseException as e:  # ship the failure back, then fail the rank
    import traceback
    client.put(f"result_{rank}",
               pickle.dumps(("error", f"{e}\\n{traceback.format_exc()}")))
    sys.exit(1)
"""


def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    np: int = 1,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    env: Optional[dict] = None,
    use_native_core: bool = False,
    verbose: bool = False,
    timeout_s: float = 300.0,
    kv_standbys: int = 0,
) -> list:
    """Run ``fn(*args, **kwargs)`` on `np` launched processes (one a GPU
    slot); returns the list of per-rank return values, rank-ordered
    (reference ``horovod.run.run``). ``fn`` calls ``hvd.init()`` itself:
    the slot's environment forms its world. With ``kv_standbys > 0`` the
    rendezvous KV gets that many warm in-process standbys with replication
    + failover monitors attached, and the workers' clients receive the
    full endpoint list (``HVD_RUN_KV_ADDRS``) — the programmatic spelling
    of ``hvdrun --kv-standbys``."""
    try:
        import cloudpickle as pickler
    except ImportError:  # pragma: no cover
        pickler = pickle
    kwargs = kwargs or {}
    secret = make_secret()
    server = KVStoreServer(secret=secret)
    server.start()
    server.put("func", pickler.dumps((fn, args, kwargs)))
    slots = hosts_mod.get_host_assignments(hosts, hostfile, np)
    job_env = dict(env if env is not None else os.environ)
    kv_addr = (
        "127.0.0.1"
        if all(_is_local(s.hostname) for s in slots)
        else _safe_local_ip()
    )
    job_env["HVD_RUN_KV_ADDR"] = kv_addr
    job_env["HVD_RUN_KV_PORT"] = str(server.port)
    job_env["HVD_RUN_TIMEOUT"] = str(timeout_s)
    job_env[SECRET_ENV] = secret
    standbys, monitors, sender = [], [], None
    if kv_standbys > 0:
        standbys = _replication.spawn_local_standbys(
            kv_standbys, secret=secret)
        endpoints = [(kv_addr, server.port)] + [
            (kv_addr, s.port) for s in standbys]
        sender = _replication.ReplicationSender(
            endpoints[1:], secret=secret,
            primary_hint=f"{kv_addr}:{server.port}")
        server.attach_replicator(sender)
        for i, s in enumerate(standbys):
            m = _replication.FailoverMonitor(
                s, (kv_addr, server.port), peers=endpoints[1:], index=i,
                secret=secret)
            m.start()
            monitors.append(m)
        job_env[ADDRS_ENV] = format_endpoints(endpoints)
    if use_native_core:
        job_env["HOROVOD_NATIVE_CORE"] = "1"

    def _result_store():
        """Where the ranks' results actually landed: the server holding
        the newest primary regime — a standby promoted mid-job (highest
        fencing epoch) outranks the original primary."""
        primaries = [
            s for s in [server] + standbys if s.role == "primary"]
        if not primaries:
            return server
        return max(primaries, key=lambda s: s.fencing_epoch)

    try:
        codes = launch_job(
            slots, [sys.executable, "-c", _WORKER_SNIPPET], job_env,
            verbose=verbose, timeout_s=timeout_s,
        )
        store = _result_store()
        results = []
        for r in range(np):
            blob = store.get(f"result_{r}")
            if blob is None:
                raise RuntimeError(
                    f"rank {r} produced no result (exit code {codes[r]})"
                )
            status, value = pickle.loads(blob)
            if status == "error":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
        return results
    finally:
        for m in monitors:
            m.stop()
        if sender is not None:
            sender.close()
        for s in standbys:
            s.close()
        server.stop()

