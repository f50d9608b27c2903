"""ctypes binding of the native C++ ``.ts`` parser (``native/ts_parser.cpp``).

Counterpart of the JAX package's ``data/native.py``, with its API:
``native_available()`` and ``load_from_tsfile_native(path)``.  The library
is built at first use with ``g++`` and the flags of ``native/Makefile``
into ``build/native/`` at the repository root, never into ``native/``.
Its file name carries a hash of the source, of the flags and of the host's
name and architecture (``-march=native`` makes a build belong to one
machine, and a copy of the tree may move to another), and the build writes
to a temporary name and renames it, so concurrent first uses do not see a
half-written library.  Without the toolchain ``native_available()`` is
false and ``data/ts_parser.py`` serves every file with the Python parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "ts_parser.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")  # native/Makefile's

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*CXX_FLAGS, platform.node(), platform.machine())).encode())
    return BUILD_DIR / f"libtsparse_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
        lib.ts_parse.restype = ctypes.c_void_p
        lib.ts_parse.argtypes = [ctypes.c_char_p]
        lib.ts_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
        lib.ts_values.restype = ctypes.POINTER(ctypes.c_float)
        lib.ts_values.argtypes = [ctypes.c_void_p]
        lib.ts_label.restype = ctypes.c_char_p
        lib.ts_label.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.ts_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def load_from_tsfile_native(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(X[N, C, T] float32, y[N] str) through the C++ parser."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ts parser unavailable")
    handle = lib.ts_parse(path.encode())
    if not handle:
        raise ValueError(f"failed to parse {path}")
    try:
        dims = (ctypes.c_long * 3)()
        lib.ts_dims(handle, dims)
        n, c, t = dims[0], dims[1], dims[2]
        buf = np.ctypeslib.as_array(lib.ts_values(handle), shape=(n * c * t,))
        x = np.array(buf, np.float32).reshape(n, c, t)  # copy before free
        y = np.asarray([lib.ts_label(handle, i).decode() for i in range(n)])
        return x, y
    finally:
        lib.ts_free(handle)
