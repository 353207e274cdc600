"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``_build/lib<name>-<hash>.so`` (a directory git ignores), keyed by a
hash of the source, of every header it includes from ``csrc`` (followed
through their own includes) and of the flags, so an edited source or
header rebuilds and an unchanged one loads what is there. A file lock per kernel serialises its
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
import re
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


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_digest(src: Path) -> str:
    """Hash of src, of the headers it includes with quotes (resolved beside
    the including file), recursively, and of NVCC_FLAGS."""
    h = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.add(f)
        text = f.read_bytes()
        h.update(f.name.encode() + b"\0" + text)
        todo += [f.parent / m for m in _INCLUDE.findall(text.decode()) if (f.parent / m).is_file()]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        so = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
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
