"""Supported framework version floors.

Counterpart of ``horovod_tpu/compat.py``: the oldest versions whose APIs
this package relies on, checked at ``hvd.init()`` (a warning, never an
error: an untested-but-newer stack should not be bricked). The port's
floors are torch's and numpy's in place of jax, flax and optax.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

#: minimum supported versions and the API each floor is anchored to.
MIN_VERSIONS: Dict[str, Tuple[str, str]] = {
    # torch.distributed.init_process_group(device_id=...), the
    # post-accumulate-grad hooks, TCPStore(wait_for_workers=...)
    "torch": ("2.4.0", "init_process_group device_id, "
                       "register_post_accumulate_grad_hook"),
    "numpy": ("1.24.0", "dtype promotion rules the oracles assume"),
}


def _parse(v: str) -> List[int]:
    parts = []
    for tok in v.split("+")[0].split(".")[:3]:
        num = ""
        for ch in tok:
            if ch.isdigit():
                num += ch
            else:
                break
        parts.append(int(num or 0))
    while len(parts) < 3:
        parts.append(0)
    return parts


def check_versions(frameworks: Dict[str, str]) -> List[str]:
    """Return a list of floor violations for the given {name: version}."""
    problems = []
    for name, version in frameworks.items():
        if name not in MIN_VERSIONS or version is None:
            continue
        floor, why = MIN_VERSIONS[name]
        if _parse(version) < _parse(floor):
            problems.append(
                f"{name} {version} is below the supported floor {floor} "
                f"({why})"
            )
    return problems


def installed_versions() -> Dict[str, str]:
    """Versions of the already-imported frameworks (never imports
    anything)."""
    import sys

    out = {}
    for name in MIN_VERSIONS:
        mod = sys.modules.get(name)
        v = getattr(mod, "__version__", None) if mod is not None else None
        if v is not None:
            out[name] = str(v)
    return out


def warn_if_unsupported() -> None:
    for msg in check_versions(installed_versions()):
        warnings.warn(f"horovod_tpu_torch: {msg}", RuntimeWarning,
                      stacklevel=3)
