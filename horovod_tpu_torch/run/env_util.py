"""Environment hygiene for spawned worker processes.

Counterpart of ``horovod_tpu/run/env_util.py``. The JAX module's
``scrub_plugin_hooks`` strips a TPU plugin's ``sitecustomize`` entries
from a CPU-pinned child's ``PYTHONPATH``; the port's workers load no TPU
plugin, so it has no counterpart here and the launcher passes
``PYTHONPATH`` through as it is. :func:`install_sigterm_exit` is ported.
"""

from __future__ import annotations

import signal
import sys


def install_sigterm_exit() -> None:
    """Convert SIGTERM into ``SystemExit(143)`` so finalizers actually run.

    CPython leaves SIGTERM at the kernel default (immediate termination, no
    ``finally`` blocks, no atexit, no process-group shutdown), so a parent
    watchdog's SIGTERM-before-SIGKILL escalation buys nothing unless the
    child opts in. Tool children call this at startup: a merely-slow child
    killed by its watchdog then leaves through its ``finally`` blocks
    (``hvd.shutdown()`` tears down the process group and the native core)
    instead of dying in the middle of a collective. Only installs on the
    main thread; no-op elsewhere."""
    try:
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    except ValueError:  # not the main thread
        pass
