"""ctypes binding of the port's host CSV parser (``csrc/csv_etl.cpp``).

Port of ``hyperbolic_vae_tpu/data/native.py`` over the port's own copy of
the C++ source. At first use the source is compiled with ``g++ -O3
-std=c++17 -fPIC -pthread -shared`` into the git-ignored ``_build/``,
keyed by a hash of the source and the flags (as the CUDA kernels are,
``ops/_build.py``); a file lock there serialises the build across
processes (pytest workers start together). When the library cannot be
built (no ``g++``), ``is_available()`` is False and the log says why,
with the compiler's stderr; the readers then fall back to pandas.

This is host code, not a device kernel: it runs on the machine's CPU
cores on the card's host too.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "csv_etl.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None  # why the build failed (once a process)
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcsv_etl-{h}.so"


def _build(so: Path) -> Optional[str]:
    """Compile the source into ``so`` under the build lock; the error text,
    or None on success."""
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock-csv_etl", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so.exists():  # another process built it meanwhile
            return None
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"{cxx}: {e}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"{cxx} exited {proc.returncode}:\n{proc.stderr}"
        os.replace(tmp, so)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        so = library_path()
        err = None if so.exists() else _build(so)
        if err is not None:
            _failed = err
            logger.warning("the native CSV parser could not be built (%s); the readers use "
                           "pandas", err)
            return None
        lib = ctypes.CDLL(str(so))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.hvae_csv_shape.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i64p, i64p]
        lib.hvae_csv_shape.restype = ctypes.c_int
        lib.hvae_csv_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, f32p,
                                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.hvae_csv_read_f32.restype = ctypes.c_int
        lib.hvae_zscore_columns.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int]
        lib.hvae_zscore_columns.restype = ctypes.c_int
        _lib = lib
        return lib


def is_available() -> bool:
    """True when the library is built (building it now if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built (None when it was, or was not tried)."""
    return _failed


# the C entry points' error codes: a malformed file fails loudly, since a
# silent mis-parse would poison every downstream result
_READ_ERRORS = {
    1: "cannot read file",
    2: "fewer lines than expected (rows + header)",
    3: "ragged row: a row has fewer index columns than skip_cols",
    4: "ragged row: a row has FEWER value fields than the first data row",
    5: "ragged row: a row has MORE fields than the first data row "
       "(trailing delimiter or unquoted comma?)",
    6: "unterminated quote in a row (embedded newline in a quoted "
       "field? use the pandas reader for such files)",
}


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native CSV parser is not built: {_failed}")
    return lib


def read_csv_matrix(path, skip_header: int = 1, skip_cols: int = 1,
                    n_threads: int = 0) -> np.ndarray:
    """A numeric CSV as a float32 (rows, cols) array, skipping
    ``skip_header`` lines and ``skip_cols`` leading (index) columns: the
    TPM layout. ``n_threads`` 0: one thread a core.

    RFC-4180 quoted fields (embedded commas, doubled quotes) and CRLF line
    ends parse as pandas reads them; unparseable values ("NA", "", junk)
    become NaN; a ragged row raises RuntimeError with its code
    (``_READ_ERRORS``), as does a row with an odd number of quotes (a
    quoted field with an embedded newline, which pandas accepts: read such
    files with pandas)."""
    lib = _require()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.hvae_csv_shape(str(path).encode(), skip_header, skip_cols,
                            ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise RuntimeError(f"hvae_csv_shape failed for {path}: "
                           f"{_READ_ERRORS.get(rc, 'unknown error')} (code {rc})")
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    rc = lib.hvae_csv_read_f32(str(path).encode(), skip_header, skip_cols,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               rows.value, cols.value, n_threads)
    if rc != 0:
        raise RuntimeError(f"hvae_csv_read_f32 failed for {path}: "
                           f"{_READ_ERRORS.get(rc, 'unknown error')} (code {rc})")
    return out


def zscore_columns(x: np.ndarray, ddof: int = 1, n_threads: int = 0) -> np.ndarray:
    """Standardise each column of a C-contiguous float32 matrix in place
    (statistics in float64); returns ``x``."""
    lib = _require()
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError("zscore_columns needs a C-contiguous float32 array")
    rc = lib.hvae_zscore_columns(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 x.shape[0], x.shape[1], ddof, n_threads)
    if rc != 0:
        raise RuntimeError(f"hvae_zscore_columns failed with code {rc}")
    return x
