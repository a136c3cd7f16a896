"""Static analysis and runtime sanitization of collective schedules.

Counterpart of ``horovod_tpu/analysis``. Ranks issuing *different*
collective schedules is the first failure of collective training (a
silent deadlock or a corruption); three layers defend against it:

- :mod:`~horovod_tpu_torch.analysis.lint` — the AST rule engine
  (``HVD001``–``HVD006``) over any Python source: collectives under
  rank-dependent control flow or data-dependent loops, host syncs and
  host clocks inside ``torch.compile``/``torch.jit`` bodies, unguarded
  thread-shared state, swallowed exceptions. CLI: ``python -m
  horovod_tpu_torch.analysis.lint PATH...``.
- :mod:`~horovod_tpu_torch.analysis.schedule` — one step's collective
  schedule, recorded from its ``torch.distributed`` calls under the JAX
  primitives' names, with the JAX module's fingerprint and comparison.
- :mod:`~horovod_tpu_torch.analysis.sanitizer` — the runtime cross-rank
  sanitizer (``HOROVOD_SANITIZE=1``): each eager collective's signature
  joins a per-step rolling hash published to the rendezvous KV, and rank
  0 names the first divergent op and rank.

Everything loads lazily: the eager collectives import the sanitizer on
every ``import horovod_tpu_torch``, so the rule engine and the recorder
cost nothing until used.
"""

from __future__ import annotations

__all__ = [
    "Finding",
    "RULES",
    "lint_file",
    "lint_paths",
    "lint_source",
    "load_waivers",
    "collective_schedule",
    "recording",
    "assert_same_schedule",
    "diff_schedules",
    "Schedule",
    "ScheduleDivergence",
    "sanitizer",
]

#: lazy attributes -> providing submodule
_LAZY = {
    "Finding": "lint",
    "RULES": "lint",
    "lint_file": "lint",
    "lint_paths": "lint",
    "lint_source": "lint",
    "load_waivers": "lint",
    "collective_schedule": "schedule",
    "recording": "schedule",
    "assert_same_schedule": "schedule",
    "diff_schedules": "schedule",
    "Schedule": "schedule",
    "ScheduleDivergence": "schedule",
    "sanitizer": "sanitizer",
}


def __getattr__(name: str):
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod if name == mod_name else getattr(mod, name)
