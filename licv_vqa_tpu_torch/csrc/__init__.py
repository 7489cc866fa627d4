"""CUDA C++ sources of the port and their build.

Each ``*.cu`` here has a plain C interface.  ``load_library`` compiles one
with ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (listed
in ``.gitignore``) on first use and loads it with ``ctypes``.  The library's
file name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{SRC_DIR} on first use"
        )
    return found


def build(source: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` if its library is missing.  Returns
    ``(library path, seconds spent building (0.0 if it existed), nvcc log)``."""
    src = SRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stderr


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    lib, _, _ = build(source)
    return ctypes.CDLL(str(lib))
