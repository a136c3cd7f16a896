"""YAML config file + CLI-flag → environment plumbing.

Counterpart of ``horovod_tpu/run/config_parser.py``, copied whole.

Reference: ``horovod/run/common/util/config_parser.py`` — a YAML config file
overrides argparse defaults, and ``set_env_from_args`` exports the resulting
knobs as ``HOROVOD_*`` environment variables read once by the core at init
(SURVEY.md §5.6; env catalog ``common/common.h:61-88``).
"""

from __future__ import annotations

from typing import Optional


# config file keys -> argparse dest (reference config_parser.py:2-34)
_PARAMS_SCHEMA = {
    "fusion_threshold_mb": "fusion_threshold_mb",
    "cycle_time_ms": "cycle_time_ms",
    "cache_capacity": "cache_capacity",
    "native_core": "native_core",
    "hierarchical_allreduce": "hierarchical_allreduce",
    "hierarchical_allgather": "hierarchical_allgather",
    "timeline": {
        "filename": "timeline_filename",
        "mark_cycles": "timeline_mark_cycles",
    },
    "stall_check": {
        "disable": "no_stall_check",
        "warning_time_seconds": "stall_check_warning_time_seconds",
        "shutdown_time_seconds": "stall_check_shutdown_time_seconds",
    },
    "autotune": {
        "enable": "autotune",
        "log_file": "autotune_log_file",
        "warmup_samples": "autotune_warmup_samples",
        "steps_per_sample": "autotune_steps_per_sample",
    },
    "library_options": {
        "log_level": "log_level",
        "hide_timestamp": "log_hide_timestamp",
    },
}


def parse_config_file(path: str) -> dict:
    """Load the YAML config into a flat {argparse-dest: value} dict."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    flat = {}

    def walk(schema, node, ctx):
        for key, dest in schema.items():
            if key not in node:
                continue
            val = node[key]
            if isinstance(dest, dict):
                if not isinstance(val, dict):
                    raise ValueError(f"config key '{ctx}{key}' must be a mapping")
                walk(dest, val, ctx + key + ".")
            else:
                flat[dest] = val

    walk(_PARAMS_SCHEMA, data, "")
    unknown = set(data) - set(_PARAMS_SCHEMA)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return flat


def override_args(args, config: dict, explicit_dests: set):
    """Config values override argparse *defaults* but not explicitly-passed
    CLI flags (reference config_parser.py:107-139 override semantics)."""
    for dest, val in config.items():
        if dest not in explicit_dests and hasattr(args, dest):
            setattr(args, dest, val)
    return args


def set_env_from_args(env: dict, args) -> dict:
    """Export knobs as HOROVOD_* env (reference config_parser.py:141-166)."""

    def setif(name, value, transform=str):
        if value is not None:
            env[name] = transform(value)

    if getattr(args, "fusion_threshold_mb", None) is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024)
        )
    setif("HOROVOD_CYCLE_TIME", getattr(args, "cycle_time_ms", None))
    setif("HOROVOD_CACHE_CAPACITY", getattr(args, "cache_capacity", None))
    # tri-state: None = leave unset (ops-layer default off)
    for flag, var in (
        ("hierarchical_allreduce", "HOROVOD_HIERARCHICAL_ALLREDUCE"),
        ("hierarchical_allgather", "HOROVOD_HIERARCHICAL_ALLGATHER"),
    ):
        val = getattr(args, flag, None)
        if val is not None:
            env[var] = "1" if val else "0"
    setif("HOROVOD_TIMELINE", getattr(args, "timeline_filename", None))
    if getattr(args, "timeline_mark_cycles", False):
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if getattr(args, "no_stall_check", False):
        env["HOROVOD_STALL_CHECK_DISABLE"] = "1"
    else:
        setif(
            "HOROVOD_STALL_CHECK_TIME_SECONDS",
            getattr(args, "stall_check_warning_time_seconds", None),
        )
        setif(
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
            getattr(args, "stall_check_shutdown_time_seconds", None),
        )
    if getattr(args, "autotune", False):
        env["HOROVOD_AUTOTUNE"] = "1"
        setif("HOROVOD_AUTOTUNE_LOG", getattr(args, "autotune_log_file", None))
        setif(
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
            getattr(args, "autotune_warmup_samples", None),
        )
        setif(
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
            getattr(args, "autotune_steps_per_sample", None),
        )
    setif("HOROVOD_LOG_LEVEL", getattr(args, "log_level", None))
    if getattr(args, "log_hide_timestamp", False):
        env["HOROVOD_LOG_HIDE_TIME"] = "1"
    if getattr(args, "native_core", False):
        env["HOROVOD_NATIVE_CORE"] = "1"
    return env


def validate_config_args(args):
    """Sanity checks (reference config_parser.py:168-182)."""
    ft = getattr(args, "fusion_threshold_mb", None)
    if ft is not None and ft < 0:
        raise ValueError("--fusion-threshold-mb must be >= 0")
    ct = getattr(args, "cycle_time_ms", None)
    if ct is not None and ct <= 0:
        raise ValueError("--cycle-time-ms must be > 0")
    cc = getattr(args, "cache_capacity", None)
    if cc is not None and cc < 0:
        raise ValueError("--cache-capacity must be >= 0")
