"""Safe subprocess execution with process-tree cleanup.

Counterpart of ``horovod_tpu/run/safe_exec.py``, copied whole, with a
``signal_event`` that forwards a SIGTERM to the child's process group
(the launcher's preemption path).

Reference: ``horovod/run/common/util/safe_shell_exec.py`` — spawn each rank in
its own process group; on interrupt/failure/parent-death, kill the *whole
tree* (GRACEFUL_TERMINATION_TIME grace, then SIGKILL). The reference uses a
middleman process; here a monitor thread + ``os.killpg`` on a
``start_new_session`` child achieves the same tree-kill semantics without the
extra fork.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from typing import Callable, Optional, Sequence

GRACEFUL_TERMINATION_TIME_S = 5  # reference safe_shell_exec.py


def terminate_tree(proc: subprocess.Popen, grace: float = GRACEFUL_TERMINATION_TIME_S):
    """SIGTERM the child's process group, then SIGKILL survivors."""
    # start_new_session made the child its own group leader, so pgid == pid
    # and stays valid for killpg even after the leader is reaped (surviving
    # grandchildren keep the group alive).
    pgid = proc.pid
    try:
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def execute(
    command: Sequence[str] | str,
    env: Optional[dict] = None,
    stdout_handler: Optional[Callable[[str], None]] = None,
    stderr_handler: Optional[Callable[[str], None]] = None,
    event: Optional[threading.Event] = None,
    shell: bool = False,
    signal_event: Optional[threading.Event] = None,
) -> int:
    """Run `command` in its own session; if `event` fires first, kill the whole
    process tree and return -SIGTERM (reference ``safe_shell_exec.execute``).
    If `signal_event` fires, the child's process group gets one SIGTERM and
    no kill: the child drains and exits with its own code (a preempted
    worker's 75).

    `stdout_handler`/`stderr_handler` receive decoded lines as they arrive
    (the per-rank prefix tagging lives in the caller, reference
    ``gloo_run.py:189-232``).
    """
    proc = subprocess.Popen(
        command,
        env=env,
        shell=shell,
        stdout=subprocess.PIPE if stdout_handler else None,
        stderr=subprocess.PIPE if stderr_handler else None,
        start_new_session=True,
        text=True if (stdout_handler or stderr_handler) else None,
    )

    pumps = []

    def pump(stream, handler):
        for line in stream:
            handler(line)
        stream.close()

    for stream, handler in (
        (proc.stdout, stdout_handler),
        (proc.stderr, stderr_handler),
    ):
        if stream is not None and handler is not None:
            t = threading.Thread(target=pump, args=(stream, handler), daemon=True)
            t.start()
            pumps.append(t)

    killed = threading.Event()
    watcher = None
    if event is not None or signal_event is not None:
        quiet = event if event is not None else threading.Event()

        def watch():
            signalled = False
            while proc.poll() is None:
                if not signalled and signal_event is not None \
                        and signal_event.is_set():
                    signalled = True
                    try:
                        os.killpg(proc.pid, signal.SIGTERM)
                    except (ProcessLookupError, PermissionError):
                        pass
                if quiet.wait(0.1):
                    killed.set()
                    terminate_tree(proc)
                    return

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()

    proc.wait()
    for t in pumps:
        t.join(timeout=5)
    if watcher is not None:
        watcher.join(timeout=GRACEFUL_TERMINATION_TIME_S + 2)
    # sweep stragglers in the group even on normal exit
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    if killed.is_set():
        return -signal.SIGTERM
    return proc.returncode
