"""Build and load the package's CUDA kernels at first use.

Each kernel source ``csrc/<name>.cu`` has a plain C interface and may include
the shared headers ``csrc/*.cuh``. It is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``_build/`` (listed in
``.gitignore``), named with a hash of the source, the headers and the flags,
and loaded with ``ctypes``. A changed source or header builds a new library;
an unchanged one is reused. Nothing here runs at import time, so the CPU-only
test environment can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no multiply-add contraction, so kernels round every operation
# like their plain PyTorch twins. Never --use_fast_math (IEEE sqrt/div).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the package's kernels")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    of ``csrc/`` (``*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed. Raises
    if the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{BUILD_LOGS[name]}")
        os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
