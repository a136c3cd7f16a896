"""Compiler-flag presets: gated in the port.

Counterpart of ``horovod_tpu/tuning.py``, which only appends XLA flags
(``XLA_FLAGS``: the latency-hiding scheduler and async collectives of the
overlap preset) before a JAX backend starts. The port runs eager PyTorch
with NCCL and compiles no program through XLA, so no flag of those
presets has anything to act on. The same entry points are kept, so
scripts and launchers that call them still run; they change nothing and
return ``([], [])`` with the reason logged.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

__all__ = [
    "PRESET_ENV",
    "PRESETS",
    "apply_xla_flags",
    "maybe_apply_from_env",
    "backend_initialized",
]

log = logging.getLogger("horovod_tpu_torch.tuning")

PRESET_ENV = "HOROVOD_XLA_FLAGS_PRESET"

#: the JAX package's preset names; the port applies none of their flags
PRESETS = {"overlap": (), "none": ()}

REASON = ("XLA flag presets act on XLA-compiled programs; horovod_tpu_torch "
          "runs eager PyTorch with NCCL, so none is applied")


def backend_initialized() -> bool:
    """Always False: there is no XLA backend in the port."""
    return False


def apply_xla_flags(preset: Optional[str] = None, *, env=None,
                    platform: Optional[str] = None,
                    warn_if_late: bool = True
                    ) -> Tuple[List[str], List[str]]:
    """``([], [])`` after checking the preset's name: nothing is added to
    ``XLA_FLAGS`` (:data:`REASON` is logged)."""
    env = os.environ if env is None else env
    preset = preset or env.get(PRESET_ENV) or "overlap"
    if preset not in PRESETS:
        raise ValueError(f"unknown XLA flags preset {preset!r}; known: "
                         f"{sorted(PRESETS)}")
    log.info("tuning: preset %r not applied: %s", preset, REASON)
    return [], list(PRESETS[preset])


def maybe_apply_from_env(env=None) -> Tuple[List[str], List[str]]:
    """:func:`apply_xla_flags` of ``HOROVOD_XLA_FLAGS_PRESET`` when it is
    set; ``([], [])`` otherwise."""
    env = os.environ if env is None else env
    if not env.get(PRESET_ENV):
        return [], []
    return apply_xla_flags(env.get(PRESET_ENV), env=env)
