"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the repository root, at
first use, and loaded with ``ctypes``.  The library's file name carries a
hash of the source, of every shared header ``csrc/*.cuh`` and of the flags,
so an edited source or header is rebuilt, and the build writes to a temporary name and renames it, so concurrent first uses
do not see a half-written library.  ``ptxas -v`` (registers, shared memory,
spills per kernel) is kept beside the library as ``<lib>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: cannot build the kernels")
    return str(candidate)


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``<csrc>/<name>.cu``, every ``<csrc>/*.cuh`` (any of them may
    be included) and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source was already built."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{source_digest(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
    out.with_name(out.name + ".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
