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

:func:`core_library` builds the native control-plane core from the
framework-free C++ in the repository's ``csrc/`` with ``g++`` (one
compiler per source, started together, then one link), under the same
kind of lock, into ``_build/libhvd_core-<hash>.so``. It reads ``csrc/``
and writes nothing there.
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
#: the native core's sources (the repository's ``csrc/``) and flags
CORE_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "csrc")
CORE_SOURCES = ("message", "tensor_queue", "response_cache", "controller",
                "tcp_controller", "timeline", "parameter_manager", "c_api")
CORE_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")
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


def gxx() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("g++") or ""):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError(
        "g++ not found ($CXX, PATH): the native core of horovod_tpu_torch "
        "cannot be built")


def _core_path() -> str:
    h = hashlib.sha256()
    inc = os.path.join(CORE_SRC, "include", "hvd")
    files = [os.path.join(CORE_SRC, "src", f"{n}.cc") for n in CORE_SOURCES]
    files += [os.path.join(inc, f) for f in sorted(os.listdir(inc))]
    for f in files:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + b"\0" + fh.read())
    h.update(" ".join(CORE_FLAGS).encode())
    return os.path.join(build_dir(), f"libhvd_core-{h.hexdigest()[:16]}.so")


def core_library() -> str:
    """The path of the native core's shared library, built first if it
    is missing: ``g++ -c`` of every source at once, then ``g++ -shared``;
    the library is renamed into place when complete. Raises if a compile
    fails."""
    path = _core_path()
    if os.path.exists(path):
        return path
    fd = os.open(os.path.join(build_dir(), ".libhvd_core.lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.d"
        os.makedirs(tmp, exist_ok=True)
        try:
            _compile_core(tmp, path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return path
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _compile_core(tmp: str, path: str) -> None:
    cxx, inc = gxx(), os.path.join(CORE_SRC, "include")
    objs = [os.path.join(tmp, f"{n}.o") for n in CORE_SOURCES]
    procs = [subprocess.Popen(
        [cxx, *CORE_FLAGS, "-I", inc, "-c", "-o", o,
         os.path.join(CORE_SRC, "src", f"{n}.cc")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, o in zip(CORE_SOURCES, objs)]
    runs = [(n, *p.communicate()[:1], p.returncode)
            for n, p in zip(CORE_SOURCES, procs)]
    if all(rc == 0 for _, _, rc in runs):
        link = subprocess.run(
            [cxx, "-shared", "-pthread", "-o", os.path.join(tmp, "lib.so"),
             *objs], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        runs.append(("link", link.stdout, link.returncode))
    bad = [f"{n} (rc {rc}):\n{out}" for n, out, rc in runs if rc != 0]
    if bad:
        raise RuntimeError("g++ failed building the native core: "
                           + "\n".join(bad))
    os.replace(os.path.join(tmp, "lib.so"), path)
