"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``_build/lib<name>-<hash>.so`` (a directory git ignores), keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads what is there. A file lock per kernel serialises its
build across processes (pytest workers) and a thread lock per kernel
across threads (the HTTP dispatcher), so the first users of a kernel
build it once, while different kernels build side by side
(``load_libraries``).

The libraries have a plain C interface and are loaded with ``ctypes``;
nothing here includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict = {}
_locks: dict = {}
_locks_guard = threading.Lock()
# name -> (seconds spent building, nvcc output) for builds made by this process
build_log: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        BUILD_DIR.mkdir(exist_ok=True)
        with open(BUILD_DIR / f".lock-{name}", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            if not so.exists():
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
                build_log[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


def load_libraries(names) -> dict:
    """Build (one nvcc per source, all started together) and load the
    given kernels: name -> library."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
