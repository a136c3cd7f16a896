"""Build the package's CUDA kernels with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes).
The library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded. Libraries
land in ``horovod_tpu_torch/ops/_build/`` (git-ignored). Several
processes may build at once (one per rank): a file lock per library
serializes them and the library is renamed into place only when
complete.

:func:`build_all` starts one ``nvcc`` per source, all together, and
waits for them; :func:`library` builds (if needed) and loads one.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("int8_wire", "fused_adam", "flash_attention", "adasum")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    d = os.path.join(_HERE, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of horovod_tpu_torch cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):  # the .cu and every shared header
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start building one library unless it exists. Returns ``(path,
    lock_fd, proc)``; ``proc`` is None when nothing had to be built."""
    path = _lib_path(name)
    fd = os.open(os.path.join(build_dir(), f".{name}.lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    if os.path.exists(path):
        return path, fd, None
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return path, fd, proc


def _finish(name: str, path: str, fd: int, proc) -> None:
    try:
        if proc is None:
            return
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (rc {proc.returncode}):\n{out}")
        with open(f"{path}.log", "w") as fh:  # ptxas: registers, spills
            fh.write(out)
        os.replace(proc.tmp, path)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _read(path: str) -> str:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return ""


def build_all(names: Iterable[str] = SOURCES) -> dict:
    """Build every named library that is missing, one ``nvcc`` each, all
    started together. Returns ``{name: {"path", "seconds", "log"}}``
    (seconds since the call began, when that library was ready; ``log``
    what nvcc and ptxas printed when it was built)."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    report = {}
    for n, (path, fd, proc) in started.items():
        _finish(n, path, fd, proc)
        report[n] = {"path": path, "seconds": time.perf_counter() - t0,
                     "log": _read(f"{path}.log")}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
